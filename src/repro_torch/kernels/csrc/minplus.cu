// Float64 tropical (min-plus) kernels with first-argmin, for Hopper (sm_90a):
// the batched product, and the fused DFTS tour scan built on the same step.
//
// minplus_f64, the product:
//
//   val[b, m, n] = min_k a[b, m, k] + bm[b, k, n]
//   idx[b, m, n] = the first k that attains the minimum (int32; 0 when every
//                  a[b, m, k] + bm[b, k, n] is +inf)
//
// minplus_scan_f64, the whole relaxation of N DFTS tours in one launch:
//
//   best_0[n]     = comp[t, 0, n]
//   best_{k+1}[n] = min_j (best_k[j] + D[t, k, j, n]) + comp[t, k + 1, n]
//   srcs[k, t, n] = the first j of that minimum (int32)
//   total[t]      = min_n (best_{K-1}[n] + tail[t, n]), tail_src[t] its first
//                   n (int64; 0 for an all-+inf row)
//
// Replaces the TPU kernel src/repro/kernels/minplus.py:_minplus_kernel (the
// Pallas tropical matmul) and, with the scan, the jitted lax.scan around it
// (src/repro/core/jax_solvers.py: dfts_scan with use_pallas=True).
//
// Semantics.  Every minimum walks its candidates in ascending order from
// +inf with index 0 and takes a candidate only when it is strictly smaller
// (first_min below, the one step both kernels share), so ties keep the
// lowest index and an all-+inf column keeps 0: the argmin convention the
// NumPy oracle relies on.  The only arithmetic is IEEE adds (no multiply,
// so no FMA contraction can change a bit) and min is exact, so the results
// are bit-identical to the plain PyTorch versions.  The scan's last
// reduction in the block variant runs as a tree over (value, index) pairs
// compared lexicographically, which gives the first minimum in any tree
// order.  The planner never makes a NaN (its costs are sums of non-negative
// numbers and +inf); a NaN operand is not handled.
//
// Bound.  Memory: each input read once and each output written once.  The
// product moves 8*B*(M*K + K*N) + 12*B*M*N bytes; the scan
// 8*N*(K*S + (K-1)*S*S + S) in and 16*N + 4*(K-1)*N*S out.  The fp64 adds
// and compares (2 per candidate) are far below the card's fp64 rate.  At
// the planner's shapes (S <= 16, K <= 8, N <= 512) the byte time is under a
// microsecond, so a launch costs its fixed overhead and its round trips to
// device memory, a few microseconds: the design spends launches and round
// trips, not bytes.
//
// Design.  A min-plus product is not a (+, x) product, so tensor cores
// (wgmma, mma.sync) cannot compute it; it runs on the CUDA cores.
//  * Product: one thread owns one output (b, m, n); consecutive threads take
//    consecutive n, so the loads of bm[b, k, :] are coalesced.
//  * Scan, S <= 32 with a warp's operands within kStageBytes (the
//    planner's case): one warp runs 32 / S tours, lane (tour, n).  The warp
//    first stages its tours' comp, D and tail in shared memory, one
//    coalesced sweep with every load in flight at once (a step's loads do
//    not depend on the frontier, but each step would otherwise wait out its
//    own round trip to device memory: the launch is latency-bound, not
//    byte-bound).  A tour's frontier `best` stays in registers from step to
//    step; step k reads best[j] from lane j of the tour by a shuffle and
//    D[t, k, j, n] coalesced along n.  The last min and first argmin is the
//    same step over shuffled values.  No block barrier: warps whose tours
//    are all past N return at once.
//  * Scan, any other shape (S > 32, or a warp's stage past kStageBytes):
//    one block per tour, threads over n, `best` in two buffers of shared
//    memory swapped behind one __syncthreads a step.
// Any N >= 0, K >= 1 and S >= 1 (up to the shared memory of one block for
// the block variant) are taken; at K = 1 the scan reads no D and writes no
// srcs.  The whole scan is one launch on the caller's stream.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
// warp variant: the shared memory a block stages its warps' operands in
// (the default limit; a larger stage goes to the block variant)
constexpr size_t kStageBytes = 48 * 1024;

__device__ __forceinline__ double inf64() {
  return __longlong_as_double(0x7ff0000000000000ULL);
}

// The min-plus step: min over k in [0, K) of cand(k), walked in ascending
// order with a strict <, so the first minimum wins and an all-+inf walk keeps
// index 0.  Every kernel of this file takes its minima through it.
template <class Cand>
__device__ __forceinline__ double first_min(Cand cand, int K, int& arg) {
  double best = inf64();
  arg = 0;
  for (int k = 0; k < K; ++k) {
    const double c = cand(k);
    if (c < best) {  // strict: the first minimum wins
      best = c;
      arg = k;
    }
  }
  return best;
}

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
  int arg;
  val[t] = first_min(
      [&](int k) { return arow[k] + bcol[static_cast<long long>(k) * N]; }, K,
      arg);
  idx[t] = arg;
}

// Scan, S <= 32: lanes [tl * S, tl * S + S) of a warp run tour
// warp * per_warp + tl; lanes past per_warp * S, and lanes of tours past N,
// follow along on tour 0's operands (so that every lane takes part in each
// shuffle) and write nothing.  The warp first copies its tours' comp, D and
// tail into its part of shared memory (each a contiguous run of device
// memory, copied coalesced by cp.async, all in flight at once), so the
// steps wait for one round trip to device memory, not one a step.
__global__ void minplus_scan_warp_kernel(
    const double* __restrict__ comp, const double* __restrict__ D,
    const double* __restrict__ tail, double* __restrict__ total,
    long long* __restrict__ tail_src, int* __restrict__ srcs, long long N,
    int K, int S, int per_warp) {
  extern __shared__ double staged[];
  const int lane = threadIdx.x & 31;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const long long first = warp * per_warp;
  if (first >= N) return;  // warp-uniform
  const int tl = lane / S;
  const int n = lane - tl * S;
  const long long tour = first + tl;
  const bool active = tl < per_warp && tour < N;
  const int base = active ? tl * S : 0;
  const int d_len = (K - 1) * S * S, c_len = K * S;  // a tour's D, comp
  const int here = static_cast<int>(
      N - first < per_warp ? N - first : per_warp);  // tours of the warp
  double* sd = staged + (threadIdx.x >> 5) * per_warp * (d_len + c_len + S);
  double* sc = sd + per_warp * d_len;
  double* st = sc + per_warp * c_len;
  const double* gd = D + first * d_len;
  const double* gc = comp + first * c_len;
  const double* gt = tail + first * S;
  // cp.async: no register waits on a load, so every copy is in flight
  // before the one wait
  for (int e = lane; e < here * d_len; e += 32)
    __pipeline_memcpy_async(sd + e, gd + e, sizeof(double));
  for (int e = lane; e < here * c_len; e += 32)
    __pipeline_memcpy_async(sc + e, gc + e, sizeof(double));
  for (int e = lane; e < here * S; e += 32)
    __pipeline_memcpy_async(st + e, gt + e, sizeof(double));
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncwarp();
  const int tw = active ? tl : 0;  // the tour within the warp's stage
  const double* c = sc + tw * c_len + n;
  const double* d0 = sd + tw * d_len + n;
  const double* tl_row = st + tw * S + n;
  double best = c[0];
  for (int k = 0; k < K - 1; ++k) {
    const double* d = d0 + k * S * S;  // column n of D_k
    int arg;
    const double v = first_min(
        [&](int j) { return __shfl_sync(kFullMask, best, base + j) + d[j * S]; },
        S, arg);
    best = v + c[(k + 1) * S];
    if (active) srcs[(k * N + tour) * S + n] = arg;
  }
  const double tot = best + tl_row[0];
  int arg;
  const double m = first_min(
      [&](int j) { return __shfl_sync(kFullMask, tot, base + j); }, S, arg);
  if (active && n == 0) {
    total[tour] = m;
    tail_src[tour] = arg;
  }
}

// (v, i) takes (w, j) when (w, j) is lexicographically smaller: the first
// minimum whatever order the pairs meet in.
__device__ __forceinline__ void take_first_min(double& v, int& i, double w,
                                               int j) {
  if (w < v || (w == v && j < i)) {
    v = w;
    i = j;
  }
}

// Scan, any other shape: block `tour`, thread n0 runs n = n0, n0 + blockDim.x, ...;
// dynamic shared memory holds the frontier twice (2 * S doubles).
__global__ void minplus_scan_block_kernel(
    const double* __restrict__ comp, const double* __restrict__ D,
    const double* __restrict__ tail, double* __restrict__ total,
    long long* __restrict__ tail_src, int* __restrict__ srcs, long long N,
    int K, int S) {
  extern __shared__ double frontier[];
  __shared__ double warp_v[32];
  __shared__ int warp_i[32];
  const long long tour = blockIdx.x;
  const double* c = comp + tour * K * S;
  double* cur = frontier;
  double* nxt = frontier + S;
  for (int n = threadIdx.x; n < S; n += blockDim.x) cur[n] = c[n];
  __syncthreads();
  for (int k = 0; k < K - 1; ++k) {
    const double* d = D + (tour * (K - 1) + k) * S * S;
    for (int n = threadIdx.x; n < S; n += blockDim.x) {
      int arg;
      const double v = first_min(
          [&](int j) { return cur[j] + d[static_cast<long long>(j) * S + n]; },
          S, arg);
      nxt[n] = v + c[(k + 1) * S + n];
      srcs[(k * N + tour) * S + n] = arg;
    }
    __syncthreads();  // every read of cur is done before it becomes nxt
    double* done = cur;
    cur = nxt;
    nxt = done;
  }
  double v = inf64();
  int i = S;  // no index yet: loses every tie
  for (int n = threadIdx.x; n < S; n += blockDim.x)
    take_first_min(v, i, cur[n] + tail[tour * S + n], n);
  for (int off = 16; off > 0; off >>= 1)
    take_first_min(v, i, __shfl_xor_sync(kFullMask, v, off),
                   __shfl_xor_sync(kFullMask, i, off));
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    warp_v[warp] = v;
    warp_i[warp] = i;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < static_cast<int>(blockDim.x >> 5); ++w)
      take_first_min(v, i, warp_v[w], warp_i[w]);
    total[tour] = v;
    tail_src[tour] = i;
  }
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

// Plain C entry point, bound with ctypes: the fused DFTS scan of N tours.
// Contiguous tensors: comp (N, K, S), D (N, K-1, S, S) (unread at K = 1),
// tail (N, S), all float64; total (N,) float64, tail_src (N,) int64, srcs
// (K-1, N, S) int32 (unwritten at K = 1).  One launch on ``stream``, none
// when N is 0.  Returns cudaGetLastError() after the launch (0 on success),
// or cudaErrorInvalidValue for a shape it does not take.
extern "C" int minplus_scan_f64(const void* comp, const void* D,
                                const void* tail, void* total, void* tail_src,
                                void* srcs, long long N, int K, int S,
                                void* stream) {
  if (N < 0 || K < 1 || S < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return static_cast<int>(cudaGetLastError());
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const double*>(comp);
  const auto* d = static_cast<const double*>(D);
  const auto* tl = static_cast<const double*>(tail);
  auto* tot = static_cast<double*>(total);
  auto* ts = static_cast<long long*>(tail_src);
  auto* sr = static_cast<int*>(srcs);
  const int per_warp = S <= 32 ? 32 / S : 1;
  // a warp's stage: its tours' D, comp and tail
  const size_t warp_bytes =
      sizeof(double) * per_warp *
      (static_cast<size_t>(K - 1) * S * S + static_cast<size_t>(K) * S + S);
  if (S <= 32 && warp_bytes <= kStageBytes) {
    const long long warps = (N + per_warp - 1) / per_warp;
    const int warps_per_block = static_cast<int>(
        kStageBytes / warp_bytes < 8 ? kStageBytes / warp_bytes : 8);
    const long long blocks = (warps + warps_per_block - 1) / warps_per_block;
    if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
    minplus_scan_warp_kernel<<<static_cast<unsigned>(blocks),
                               32 * warps_per_block,
                               warps_per_block * warp_bytes, s>>>(
        c, d, tl, tot, ts, sr, N, K, S, per_warp);
  } else {
    if (N > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
    const int threads = S >= 1024 ? 1024 : (S + 31) / 32 * 32;
    const size_t smem = 2 * static_cast<size_t>(S) * sizeof(double);
    if (smem > 48 * 1024) {
      int device, most;
      cudaGetDevice(&device);
      cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device);
      if (smem + 32 * (sizeof(double) + sizeof(int)) >
          static_cast<size_t>(most))
        return static_cast<int>(cudaErrorInvalidValue);
      const cudaError_t err = cudaFuncSetAttribute(
          minplus_scan_block_kernel,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    minplus_scan_block_kernel<<<static_cast<unsigned>(N), threads, smem, s>>>(
        c, d, tl, tot, ts, sr, N, K, S);
  }
  return static_cast<int>(cudaGetLastError());
}
