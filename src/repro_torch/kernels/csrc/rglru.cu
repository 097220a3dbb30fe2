// RG-LRU linear recurrence h_t = a_t h_{t-1} + b_t (h_0 = 0) for the port,
// in CUDA C++ for sm_90a.
//
// Replaces: src/repro/kernels/rglru.py, the Pallas TPU kernel `_rglru_kernel`
// (wrapper `rglru_scan`, `pl.pallas_call` at :59).
// Wrapper here: src/repro_torch/kernels/rglru.py::rglru_scan, which holds the
// plain version `reference_rglru_scan` beside it.
//
// a, b, h (B, S, W) float32, contiguous; every channel (b, w) is an
// independent recurrence over S with an fp32 state.
//
// What bounds it on the H100: bytes.  Each output reads a_t and b_t once and
// writes h_t once, 12 bytes for 2 flops: at the RG-LRU path's shape
// (recurrentgemma-9b, B 1, S 4096, W 4096) 201 MB, 60 us at 3.35 TB/s.
//
// Design: the TPU kernel walks S sequentially per channel block, carrying h
// in VMEM across its sequential grid.  Blocks here run in parallel, and at
// the path's shape one thread per channel would be 4,096 threads (16 blocks
// on 132 SMs) with 4,096 dependent steps each.  So the sequence is cut into
// chunks of CHUNK steps, one thread per (channel, chunk), and the scan runs
// in two launches:
//   1. each thread scans its chunk from h = 0, keeping the chunk's end state
//      H_c and the product of its a's, A_c;
//   2. each thread folds the summaries of the chunks before its own into its
//      incoming state (carry = A_c' carry + H_c', c' ascending, at most
//      S / CHUNK steps), then scans its chunk again from that state and
//      writes h.
// Consecutive threads take consecutive channels, so every load and store of
// a step is coalesced along W.  The loads of UNROLL steps are issued before
// their dependent multiply-adds.  Within a chunk the arithmetic is that of
// the sequential recurrence; only the carry into a chunk is formed through
// the chunk products.  a and b are read twice (the second read partly from
// L2), so the kernel moves about 335 MB at the path's shape, 1.7x its bound.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK = 128;  // steps per (channel, chunk) thread
constexpr int UNROLL = 8;

// Scan steps [t0, t1) of one channel (a, b and out advanced to it, W apart
// from one step to the next) from state h; writes h_t when WRITE.  Returns
// the end state and the product of the a's.
template <bool WRITE>
__device__ inline float2 scan_steps(const float* __restrict__ a,
                                    const float* __restrict__ b,
                                    float* __restrict__ out, int W, int t0,
                                    int t1, float h) {
  float p = 1.f;
  int t = t0;
  for (; t + UNROLL <= t1; t += UNROLL) {
    float av[UNROLL], bv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      av[u] = a[size_t(t + u) * W];
      bv[u] = b[size_t(t + u) * W];
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      h = av[u] * h + bv[u];
      p *= av[u];
      if (WRITE) out[size_t(t + u) * W] = h;
    }
  }
  for (; t < t1; ++t) {
    const float av = a[size_t(t) * W];
    h = av * h + b[size_t(t) * W];
    p *= av;
    if (WRITE) out[size_t(t) * W] = h;
  }
  return make_float2(h, p);
}

__global__ void __launch_bounds__(THREADS)
rglru_chunk_summaries(const float* __restrict__ a,
                      const float* __restrict__ b, float* __restrict__ A,
                      float* __restrict__ H, int S, int W) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  const int c = blockIdx.y;
  const int bi = blockIdx.z;
  if (w >= W) return;
  const int nc = gridDim.y;
  const size_t off = size_t(bi) * S * W + w;
  const float2 hp = scan_steps<false>(a + off, b + off, nullptr, W, c * CHUNK,
                                      min(S, (c + 1) * CHUNK), 0.f);
  const size_t s = (size_t(bi) * nc + c) * W + w;
  A[s] = hp.y;
  H[s] = hp.x;
}

__global__ void __launch_bounds__(THREADS)
rglru_chunk_scan(const float* __restrict__ a, const float* __restrict__ b,
                 const float* __restrict__ A, const float* __restrict__ H,
                 float* __restrict__ out, int S, int W) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  const int c = blockIdx.y;
  const int bi = blockIdx.z;
  if (w >= W) return;
  const int nc = gridDim.y;
  float carry = 0.f;
  for (int cp = 0; cp < c; ++cp) {
    const size_t s = (size_t(bi) * nc + cp) * W + w;
    carry = A[s] * carry + H[s];
  }
  const size_t off = size_t(bi) * S * W + w;
  scan_steps<true>(a + off, b + off, out + off, W, c * CHUNK,
                   min(S, (c + 1) * CHUNK), carry);
}

}  // namespace

// The number of chunks of a sequence of S steps: the wrapper allocates the
// two (B, chunks, W) float32 summaries.
extern "C" int rglru_chunks(int S) { return (S + CHUNK - 1) / CHUNK; }

// Returns the CUDA error of the launches (0 when both were accepted).  A and
// H are scratch of (B, rglru_chunks(S), W) float32 each.
extern "C" int rglru_scan_f32(const void* a, const void* b, void* out, void* A,
                              void* H, int B, int S, int W, void* stream) {
  if (B < 1 || S < 1 || W < 1) return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((W + THREADS - 1) / THREADS, rglru_chunks(S), B);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  rglru_chunk_summaries<<<grid, THREADS, 0, s>>>(
      af, bf, static_cast<float*>(A), static_cast<float*>(H), S, W);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  rglru_chunk_scan<<<grid, THREADS, 0, s>>>(
      af, bf, static_cast<const float*>(A), static_cast<const float*>(H),
      static_cast<float*>(out), S, W);
  return int(cudaGetLastError());
}
