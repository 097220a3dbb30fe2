// Batched float64 tropical (min-plus) product with first-argmin, for Hopper
// (sm_90a).
//
//   val[b, m, n] = min_k a[b, m, k] + bm[b, k, n]
//   idx[b, m, n] = the first k that attains the minimum (int32; 0 when every
//                  a[b, m, k] + bm[b, k, n] is +inf)
//
// Replaces the TPU kernel src/repro/kernels/minplus.py:_minplus_kernel (the
// Pallas tropical matmul that the DFTS tour relaxation calls once per stage).
//
// Semantics.  Each thread walks k in ascending order from val = +inf,
// idx = 0 and takes a candidate only when it is strictly smaller, so ties
// keep the lowest k and an all-+inf column keeps idx 0: the argmin
// convention the NumPy oracle relies on.  The only arithmetic is one IEEE
// add per k (no multiply, so no FMA contraction can change a bit), and min
// is exact, so the result is bit-identical to the plain PyTorch version.
//
// Bound.  Memory: the product reads each input once and writes val and idx,
// 8*B*(M*K + K*N) + 12*B*M*N bytes at 3.35 TB/s.  It does 2*B*M*N*K fp64
// operations (add, compare), far below the card's fp64 rate.  At the
// planner's shapes (M = 1, K = N <= 16, B <= 1024) the byte time is under a
// microsecond, so a launch costs its fixed overhead of a few microseconds.
//
// Design.  A min-plus product is not a (+, x) product, so tensor cores
// (wgmma, mma.sync) cannot compute it; it runs on the CUDA cores.  One
// thread owns one output (b, m, n), and consecutive threads take
// consecutive n, so the loads of bm[b, k, :] are coalesced and a[b, m, k] is
// a broadcast within the row.  A block of 256 threads covers 256 / (M*N)
// batch elements (4 to 256 instances at the planner's M*N = Sp in 1..16).  The whole
// product is one launch on the caller's stream; fusing the K-1 stage steps
// of a tour into one kernel is left for later.
#include <cuda_runtime.h>

#include <climits>

namespace {

__global__ void minplus_kernel(const double* __restrict__ a,
                               const double* __restrict__ bm,
                               double* __restrict__ val,
                               int* __restrict__ idx, long long total, int M,
                               int K, int N) {
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int n = static_cast<int>(t % N);
  const long long row = t / N;  // flat (b, m)
  const long long b = row / M;
  const double* arow = a + row * K;
  const double* bcol = bm + b * K * N + n;
  double best = __longlong_as_double(0x7ff0000000000000ULL);  // +inf
  int arg = 0;
  for (int k = 0; k < K; ++k) {
    const double cand = arow[k] + bcol[static_cast<long long>(k) * N];
    if (cand < best) {  // strict: the first minimum wins
      best = cand;
      arg = k;
    }
  }
  val[t] = best;
  idx[t] = arg;
}

}  // namespace

// Plain C entry point, bound with ctypes.  All tensors are contiguous
// float64: a (batch, M, K), bm (batch, K, N), val (batch, M, N), and idx
// (batch, M, N) int32.  Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int minplus_f64(const void* a, const void* bm, void* val, void* idx,
                           long long batch, int M, int K, int N,
                           void* stream) {
  const long long total = batch * M * N;
  if (total > 0) {
    const int threads = 256;
    const long long blocks = (total + threads - 1) / threads;
    if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
    minplus_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const double*>(a), static_cast<const double*>(bm),
        static_cast<double*>(val), static_cast<int*>(idx), total, M, K, N);
  }
  return static_cast<int>(cudaGetLastError());
}
