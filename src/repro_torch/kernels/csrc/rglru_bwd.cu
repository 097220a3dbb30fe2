// Backward of the RG-LRU linear recurrence h_t = a_t h_{t-1} + b_t (h_0 = 0)
// for the port, in CUDA C++ for sm_90a.
//
// Replaces: no TPU kernel of its own.  It is the gradient of
// src/repro/kernels/rglru.py's `_rglru_kernel` (B5, `pl.pallas_call` at :59),
// which the JAX package differentiates through its associative scan
// (`models/layers.py` `rglru_scan`); the port's forward is csrc/rglru.cu, and
// autograd would stop at it without this.
// Wrapper here: src/repro_torch/kernels/rglru.py::rglru_scan_bwd, which holds
// the plain version `reference_rglru_scan_bwd` beside it.
//
// a, h, g (B, S, W) float32, contiguous: the decays, the forward's output and
// its cotangent.  Every channel (b, w) on its own:
//   lambda_t = g_t + a_{t+1} lambda_{t+1}    (lambda_{S+1} = 0, a reverse scan
//                                             with a shifted by one)
//   db_t = lambda_t,   da_t = lambda_t h_{t-1}   (h_0 = 0)
//
// What bounds it on the H100: bytes.  Each step reads a_t, h_{t-1} and g_t
// once and writes da_t and db_t once, 20 bytes for 4 flops: at the RG-LRU
// path's shape (recurrentgemma-9b, B 1, S 4096, W 4096) 335.5 MB, 100 us at
// 3.35 TB/s.
//
// Design: the forward's two-launch chunked scan (csrc/rglru.cu), run from
// the end of the sequence.  One thread per (channel, chunk of CHUNK steps):
//   1. each thread scans its chunk backwards from a zero carry, keeping the
//      carry it would hand the chunk before, H_c = a_{t0} lambda'_{t0}, and
//      the product of its a's, A_c (the carry out is H_c + A_c L for a carry
//      L coming in);
//   2. each thread folds the summaries of the chunks after its own into its
//      incoming carry (L = A_c' L + H_c', c' descending, at most S / CHUNK
//      steps), then scans its chunk backwards again from that carry and
//      writes da and db.
// Consecutive threads take consecutive channels, so every load and store of
// a step is coalesced along W; the loads of UNROLL steps are issued before
// their dependent multiply-adds.  Within a chunk the arithmetic is that of
// the sequential reverse recurrence; only the carry into a chunk is formed
// through the chunk products.  a and g are read twice (the second read
// partly from L2), so the kernel moves about 470 MB at the path's shape,
// 1.4x its bound.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK = 128;  // steps per (channel, chunk) thread
constexpr int UNROLL = 8;

// Scan steps [t0, t1) of one channel backwards (a, h, g, da and db advanced
// to it, W apart from one step to the next) from the carry a_{t1}
// lambda_{t1}; writes da_t and db_t when WRITE.  Returns the carry
// a_{t0} lambda_{t0} and the product of the a's.
template <bool WRITE>
__device__ inline float2 rscan_steps(const float* __restrict__ a,
                                     const float* __restrict__ h,
                                     const float* __restrict__ g,
                                     float* __restrict__ da,
                                     float* __restrict__ db, int W, int t0,
                                     int t1, float carry) {
  float p = 1.f;
  int t = t1;
  for (; t - UNROLL >= t0; t -= UNROLL) {
    float av[UNROLL], gv[UNROLL], hv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int s = t - 1 - u;
      av[u] = a[size_t(s) * W];
      gv[u] = g[size_t(s) * W];
      if (WRITE) hv[u] = s > 0 ? h[size_t(s - 1) * W] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int s = t - 1 - u;
      const float lam = gv[u] + carry;
      if (WRITE) {
        db[size_t(s) * W] = lam;
        da[size_t(s) * W] = lam * hv[u];
      }
      carry = av[u] * lam;
      p *= av[u];
    }
  }
  for (; t > t0; --t) {
    const int s = t - 1;
    const float av = a[size_t(s) * W];
    const float lam = g[size_t(s) * W] + carry;
    if (WRITE) {
      db[size_t(s) * W] = lam;
      da[size_t(s) * W] = s > 0 ? lam * h[size_t(s - 1) * W] : 0.f;
    }
    carry = av * lam;
    p *= av;
  }
  return make_float2(carry, p);
}

__global__ void __launch_bounds__(THREADS)
rglru_bwd_summaries(const float* __restrict__ a, const float* __restrict__ g,
                    float* __restrict__ A, float* __restrict__ H, int S,
                    int W) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  const int c = blockIdx.y;
  const int bi = blockIdx.z;
  if (w >= W) return;
  const int nc = gridDim.y;
  const size_t off = size_t(bi) * S * W + w;
  const float2 cp = rscan_steps<false>(a + off, nullptr, g + off, nullptr,
                                       nullptr, W, c * CHUNK,
                                       min(S, (c + 1) * CHUNK), 0.f);
  const size_t s = (size_t(bi) * nc + c) * W + w;
  H[s] = cp.x;
  A[s] = cp.y;
}

__global__ void __launch_bounds__(THREADS)
rglru_bwd_scan(const float* __restrict__ a, const float* __restrict__ h,
               const float* __restrict__ g, const float* __restrict__ A,
               const float* __restrict__ H, float* __restrict__ da,
               float* __restrict__ db, int S, int W) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  const int c = blockIdx.y;
  const int bi = blockIdx.z;
  if (w >= W) return;
  const int nc = gridDim.y;
  float carry = 0.f;
  for (int cp = nc - 1; cp > c; --cp) {
    const size_t s = (size_t(bi) * nc + cp) * W + w;
    carry = A[s] * carry + H[s];
  }
  const size_t off = size_t(bi) * S * W + w;
  rscan_steps<true>(a + off, h + off, g + off, da + off, db + off, W,
                    c * CHUNK, min(S, (c + 1) * CHUNK), carry);
}

}  // namespace

// The number of chunks of a sequence of S steps: the wrapper allocates the
// two (B, chunks, W) float32 summaries.
extern "C" int rglru_bwd_chunks(int S) { return (S + CHUNK - 1) / CHUNK; }

// da and db of h = rglru_scan(a, b) for the cotangent g of h, from a and h.
// Returns the CUDA error of the launches (0 when both were accepted).  A and
// H are scratch of (B, rglru_bwd_chunks(S), W) float32 each.
extern "C" int rglru_scan_bwd_f32(const void* a, const void* h, const void* g,
                                  void* da, void* db, void* A, void* H, int B,
                                  int S, int W, void* stream) {
  if (B < 1 || S < 1 || W < 1) return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((W + THREADS - 1) / THREADS, rglru_bwd_chunks(S), B);
  const float* af = static_cast<const float*>(a);
  const float* gf = static_cast<const float*>(g);
  rglru_bwd_summaries<<<grid, THREADS, 0, s>>>(
      af, gf, static_cast<float*>(A), static_cast<float*>(H), S, W);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  rglru_bwd_scan<<<grid, THREADS, 0, s>>>(
      af, static_cast<const float*>(h), gf, static_cast<const float*>(A),
      static_cast<const float*>(H), static_cast<float*>(da),
      static_cast<float*>(db), S, W);
  return int(cudaGetLastError());
}
