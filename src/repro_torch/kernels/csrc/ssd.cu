// Mamba-2 SSD intra-chunk terms for the port, in CUDA C++ for sm_90a.
//
// Replaces: src/repro/kernels/ssd.py, the Pallas TPU kernel `_ssd_kernel`
// (wrapper `ssd_intra_chunk`, `pl.pallas_call` at :64).
// Wrapper here: src/repro_torch/kernels/ssd.py::ssd_intra_chunk, which holds
// the plain version `reference_ssd_intra_chunk` beside it.
//
// Per (batch b, chunk c, head h), with Q positions, state width N and head
// width P, all fp32:
//   cum = cumsum(-A[h] * dt)                                    (Q,)
//   y   = ((C B^T) o exp(cum_q - cum_k)|causal o dt_k) x        (Q, P)
//   hc  = (B o exp(cum_end - cum) o dt)^T x                     (N, P)
//   dec = exp(cum)                                              (Q,)
// x (B, nc, H, Q, P); B and C (B, nc, Q, N), shared by the heads; dt
// (B, nc, H, Q); A (H,) > 0.  The causal mask is applied to the exponent
// (exp of -inf is 0): non-causal deltas are positive and would overflow.
//
// What bounds it on the H100: at the path's shape (B 2, nc 8, H 32, Q 256,
// P 64, N 128) the least work is ~4.4 GFLOP of fp32 (C B^T once per (b, c),
// causal pairs only) against ~89 MB of bytes: 66 us at the 67 TFLOP/s of
// fp32 outside the tensor cores against 27 us of bytes, so arithmetic sets
// the bound.  (Counted per head, as the TPU kernel computes it, C B^T alone
// is 4.3 GFLOP more.)
//
// Design: right and simple first.  The TPU kernel holds the whole Q x Q score
// tile (256 KB of fp32 at Q 256) in VMEM; a block here has at most 227 KB of
// shared memory, so one block of 256 threads per (b, c, h) walks the score
// matrix in 64 x 64 tiles, causal tiles only, like a causal attention without
// the softmax: a C tile (queries) against each B tile (keys) gives 4 x 4
// register tiles of scores per thread, weighted by the masked decay and dt_k
// and written transposed to shared memory, then multiplied into a 64 x P
// accumulator with the x tile of those keys.  C B^T is recomputed for every
// head, as on the TPU.  The chunk state is a second pass over 64-row tiles of
// (B o exp(cum_end - cum) o dt) and x.  The cumulative sum is a warp scan.
// 105 KB of shared memory at the path's shape: two blocks fit on an SM.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int T = 64;  // rows and columns of a tile of the Q x Q scores
constexpr int THREADS = 256;
constexpr int PAD = 4;
constexpr int LDT = T + PAD;
constexpr int MAX_N = 128;

__host__ __device__ inline int round_up(int n, int m) { return (n + m - 1) / m * m; }

__host__ __device__ inline int b_buffer_floats(int N) {
  const int transposed = N * LDT;     // B tile as [N][LDT] for the scores
  const int rows = T * (N + PAD);     // B tile as [T][N + PAD] for the state
  return transposed > rows ? transposed : rows;
}

template <int P>
__global__ void __launch_bounds__(THREADS)
ssd_intra_chunk_kernel(const float* __restrict__ x, const float* __restrict__ Bm,
                       const float* __restrict__ Cm, const float* __restrict__ dt,
                       const float* __restrict__ A, float* __restrict__ y,
                       float* __restrict__ hc, float* __restrict__ dec, int H,
                       int Q, int N) {
  constexpr int CW = P / 16;  // output columns per thread
  const int Qp = round_up(Q, T);
  extern __shared__ float4 smem4[];
  float* cum = reinterpret_cast<float*>(smem4);  // [Qp]
  float* dts = cum + Qp;                         // [Qp]
  float* Ct = dts + Qp;                          // [N][LDT]
  float* Bb = Ct + N * LDT;                      // see b_buffer_floats
  float* Xs = Bb + b_buffer_floats(N);           // [T][P]
  float* Wt = Xs + T * P;                        // [T][LDT]

  const int bch = blockIdx.x;  // (b * nc + c) * H + h
  const int h = bch % H;
  const int bc = bch / H;      // b * nc + c
  const float* xb = x + size_t(bch) * Q * P;
  const float* Bc = Bm + size_t(bc) * Q * N;
  const float* Cc = Cm + size_t(bc) * Q * N;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const float a = A[h];

  for (int i = tid; i < Qp; i += THREADS) dts[i] = i < Q ? dt[size_t(bch) * Q + i] : 0.f;
  __syncthreads();
  if (tid < 32) {  // cumsum of -a * dt: each lane a run of Qp / 32, then a warp scan
    const int run = Qp / 32;
    float sum = 0.f;
    for (int i = 0; i < run; ++i) {
      sum += dts[tid * run + i] * (-a);
      cum[tid * run + i] = sum;
    }
    float incl = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, incl, off);
      if (tid >= off) incl += up;
    }
    const float before = incl - sum;
    for (int i = 0; i < run; ++i) cum[tid * run + i] += before;
  }
  __syncthreads();
  for (int i = tid; i < Q; i += THREADS) dec[size_t(bch) * Q + i] = expf(cum[i]);

  // ---- y: causal tiles of the scores, query tile by query tile
  for (int q0 = 0; q0 < Q; q0 += T) {
    for (int e = tid; e < T * N; e += THREADS) {
      const int r = e / N, n = e % N;
      Ct[n * LDT + r] = q0 + r < Q ? Cc[size_t(q0 + r) * N + n] : 0.f;
    }
    float acc[4][CW];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < CW; ++c) acc[i][c] = 0.f;

    for (int k0 = 0; k0 <= q0; k0 += T) {
      __syncthreads();  // the last tile's products are done with Bb, Xs, Wt
      for (int e = tid; e < T * N; e += THREADS) {
        const int r = e / N, n = e % N;
        Bb[n * LDT + r] = k0 + r < Q ? Bc[size_t(k0 + r) * N + n] : 0.f;
      }
      for (int e = tid; e < T * P; e += THREADS) {
        const int r = e / P;
        Xs[e] = k0 + r < Q ? xb[size_t(k0) * P + e] : 0.f;
      }
      __syncthreads();

      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
      for (int n = 0; n < N; ++n) {
        const float4 cq = *reinterpret_cast<const float4*>(Ct + n * LDT + ty * 4);
        const float4 bk = *reinterpret_cast<const float4*>(Bb + n * LDT + tx * 4);
        const float cv[4] = {cq.x, cq.y, cq.z, cq.w};
        const float bv[4] = {bk.x, bk.y, bk.z, bk.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(cv[i], bv[j], s[i][j]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx * 4 + j;
        float w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qi = q0 + ty * 4 + i;
          const float decay = expf(qi >= kj ? cum[qi] - cum[kj] : -INFINITY);
          w[i] = s[i][j] * decay * dts[kj];
        }
        *reinterpret_cast<float4*>(Wt + (tx * 4 + j) * LDT + ty * 4) =
            make_float4(w[0], w[1], w[2], w[3]);
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < T; ++kk) {
        const float4 wq = *reinterpret_cast<const float4*>(Wt + kk * LDT + ty * 4);
        const float wv[4] = {wq.x, wq.y, wq.z, wq.w};
#pragma unroll
        for (int c = 0; c < CW; ++c) {
          const float xv = Xs[kk * P + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(wv[i], xv, acc[i][c]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      if (qi >= Q) continue;
#pragma unroll
      for (int c = 0; c < CW; ++c) y[(size_t(bch) * Q + qi) * P + tx + 16 * c] = acc[i][c];
    }
    __syncthreads();  // every thread is done with Ct before the next tile
  }

  // ---- hc: (B o exp(cum_end - cum) o dt)^T x, rows n = ty * RN + i
  constexpr int RN = MAX_N / 16;
  const int rn = (N + 15) / 16;
  const int ldb = N + PAD;
  const float cum_end = cum[Q - 1];
  float st[RN][CW];
#pragma unroll
  for (int i = 0; i < RN; ++i)
#pragma unroll
    for (int c = 0; c < CW; ++c) st[i][c] = 0.f;
  for (int k0 = 0; k0 < Q; k0 += T) {
    __syncthreads();
    for (int e = tid; e < T * N; e += THREADS) {
      const int r = e / N, n = e % N;
      float val = 0.f;
      if (k0 + r < Q) {
        const float ed = expf(cum_end - cum[k0 + r]) * dts[k0 + r];
        val = Bc[size_t(k0 + r) * N + n] * ed;
      }
      Bb[r * ldb + n] = val;
    }
    for (int e = tid; e < T * P; e += THREADS) {
      const int r = e / P;
      Xs[e] = k0 + r < Q ? xb[size_t(k0) * P + e] : 0.f;
    }
    __syncthreads();
    for (int r = 0; r < T; ++r) {
      float xv[CW];
#pragma unroll
      for (int c = 0; c < CW; ++c) xv[c] = Xs[r * P + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < RN; ++i) {
        if (i < rn) {
          const int n = ty * rn + i;
          const float bn = n < N ? Bb[r * ldb + n] : 0.f;
#pragma unroll
          for (int c = 0; c < CW; ++c) st[i][c] = fmaf(bn, xv[c], st[i][c]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RN; ++i) {
    const int n = ty * rn + i;
    if (i >= rn || n >= N) continue;
#pragma unroll
    for (int c = 0; c < CW; ++c) hc[(size_t(bch) * N + n) * P + tx + 16 * c] = st[i][c];
  }
}

template <int P>
int launch(const void* x, const void* Bm, const void* Cm, const void* dt,
           const void* A, void* y, void* hc, void* dec, int Bsz, int nc, int H,
           int Q, int N, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (2 * round_up(Q, T) + N * LDT + b_buffer_floats(N) + T * P + T * LDT);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_intra_chunk_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  const unsigned blocks = unsigned(Bsz) * unsigned(nc) * unsigned(H);
  ssd_intra_chunk_kernel<P><<<blocks, THREADS, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<float*>(y),
      static_cast<float*>(hc), static_cast<float*>(dec), H, Q, N);
  return int(cudaGetLastError());
}

}  // namespace

// Returns the CUDA error of the launch (0 when it was accepted).  P must be
// 16, 32 or 64 and N at most 128.
extern "C" int ssd_intra_chunk_f32(const void* x, const void* Bm, const void* Cm,
                                   const void* dt, const void* A, void* y,
                                   void* hc, void* dec, int Bsz, int nc, int H,
                                   int Q, int P, int N, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N < 1 || N > MAX_N || Q < 1) return int(cudaErrorInvalidValue);
  switch (P) {
    case 16:
      return launch<16>(x, Bm, Cm, dt, A, y, hc, dec, Bsz, nc, H, Q, N, s);
    case 32:
      return launch<32>(x, Bm, Cm, dt, A, y, hc, dec, Bsz, nc, H, Q, N, s);
    case 64:
      return launch<64>(x, Bm, Cm, dt, A, y, hc, dec, Bsz, nc, H, Q, N, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}
