// Mamba-2 SSD intra-chunk terms, backward, for the port, in CUDA C++ for
// sm_90a, float32.
//
// Replaces: the gradient of src/repro/kernels/ssd.py's Pallas TPU kernel
// `_ssd_kernel` (wrapper `ssd_intra_chunk`, `pl.pallas_call` at :64), which
// has no VJP of its own: the JAX package differentiates its model's `jnp`
// `_ssd_chunked` instead.  Wrapper here:
// src/repro_torch/kernels/ssd.py::ssd_intra_chunk_bwd, beside its plain
// version `reference_ssd_intra_chunk_bwd` (autograd through
// `reference_ssd_intra_chunk`); the autograd Function `_SSDIntraChunk`
// calls it.
//
// Per (batch b, chunk c, head h), the forward (csrc/ssd.cu) is, with
// cum = cumsum(-A dt), S = C B^T (shared by the heads), L_qk =
// exp(cum_q - cum_k) for k <= q (else 0) and W = S o L o dt_k:
//   y = W x,   hc = (B o ed)^T x with ed_k = exp(cum_end - cum_k) dt_k,
//   dec = exp(cum).
// Given the cotangents gy (Q, P), ghc (N, P) and gdec (Q,), with
// G = gy x^T, M = G o W, dS = G o L o dt_k and E_k = B_k . (ghc x_k):
//   dx_k  = sum_q W_qk gy_q + ed_k (ghc^T B_k)
//   dC_q  = sum_h sum_k dS_qk B_k,   dB_k = sum_h (sum_q dS_qk C_q + ed_k ghc x_k)
//   dcum  = rowsum(M) - colsum(M) + gdec o exp(cum) - E o ed
//           (+ sum_k E_k ed_k at the chunk's last position)
//   da    = reverse cumsum of dcum over the chunk      (a = -A dt)
//   ddt_k = sum_q G_qk S_qk L_qk + E_k exp(cum_end - cum_k) - A da_k
//   dA    = -sum_{b, c, k} dt_k da_k
// x (B, nc, H, Q, P), B and C (B, nc, Q, N), dt (B, nc, H, Q), A (H,), all
// fp32 and contiguous, P in {16, 32, 64}, N <= 128, any Q.
//
// What bounds it on the H100: at mamba2-370m's shape (B 2, nc 8, H 32, Q 256,
// P 64, N 128) the least work counted as chip_smoke._ssd_work counts the
// forward's (C B^T once per (b, c), causal pairs only) is about 2.4 times
// the forward's: its products are C B^T, G = gy x^T, W^T gy, dS B, dS^T C
// and the two of the chunk-state term.  This first version recomputes C B^T
// for every head and does every product in plain fp32 SIMT (PERF.md has its
// time beside the bound): the tensor cores, and C B^T shared across heads as
// the forward shares it, are later work.
//
// Design: everything is written once by one thread, and every sum is taken
// in a fixed order, so two launches give the same bits (no atomics):
//   0. ssd_bwd_cum_kernel: cum for each (b, c, h), one thread each, in order.
//   1. ssd_bwd_tile_kernel, one block per (tile t of T = 64 positions, head, (b, c)):
//      pass A takes tile t's rows as queries and walks the key tiles <= t:
//      dC (this head's part) and rowsum(M); pass B takes them as keys and
//      walks the query tiles >= t: dB (this head's part), dx, colsum(M) and
//      the direct ddt; then the chunk-state term for tile t's keys.  It
//      writes dcum and the direct ddt per position, E o ed, dx, and dB and
//      dC per head into scratch.  Tiles sit in shared memory as fp32 rows
//      padded by one word; 256 threads each own a 4 x (width / 16) block of
//      each product, rows and columns strided by 16.
//   2. ssd_bwd_scan_kernel, one thread per (b, c, h): the end term, the reverse
//      cumsum, ddt, and the chunk's part of dA.
//   3. ssd_bwd_heads_kernel: dB and dC summed over the heads, in head order.
//   4. ssd_bwd_da_kernel: dA summed over (b, c), in order.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int T = 64;          // positions of a tile
constexpr int THREADS = 256;
constexpr int MAX_N = 128;
constexpr int R = T / 16;      // a thread's rows of a tile product
constexpr int RN = MAX_N / 16; // a thread's columns of a T x N product
constexpr int PN = MAX_N + 1;  // pitch of a T x N tile
constexpr int PT = T + 1;      // pitch of a T x T tile

template <int P>
struct Cfg {
  static constexpr int PP = P + 1;  // pitch of a T x P tile and of ghc (N x P)
  static constexpr int RP = P / 16;
  static constexpr size_t FLOATS =
      2 * T * PN + 2 * T * PP + 2 * T * PT + MAX_N * PP + 8 * T;
  static constexpr size_t SMEM = sizeof(float) * FLOATS;
};

// acc[r][c] += sum_{kk < K} a(ty + 16 r, kk) * b(kk, tx + 16 c), with
// a(i, kk) = A[i * lda + kk] and b(kk, j) = Bm[kk * ldb + j] (Bm[j * ldb + kk]
// when TB), from shared memory.
template <int RM, int RC, bool TB>
__device__ __forceinline__ void mm(float (&acc)[RM][RC], const float* A, int lda,
                                   const float* Bm, int ldb, int K, int ty, int tx) {
#pragma unroll 4
  for (int kk = 0; kk < K; ++kk) {
    float a[RM], b[RC];
#pragma unroll
    for (int r = 0; r < RM; ++r) a[r] = A[(ty + 16 * r) * lda + kk];
#pragma unroll
    for (int c = 0; c < RC; ++c) {
      const int j = tx + 16 * c;
      b[c] = TB ? Bm[j * ldb + kk] : Bm[kk * ldb + j];
    }
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int c = 0; c < RC; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
  }
}

template <int RM, int RC>
__device__ __forceinline__ void zero(float (&acc)[RM][RC]) {
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int c = 0; c < RC; ++c) acc[r][c] = 0.f;
}

// Rows [s0, s0 + T) of a (rows, width) fp32 matrix into a tile of pitch
// `pitch`, zero past `rows` and past `width` up to `cols` columns.
__device__ __forceinline__ void load_rows(float* dst, int pitch, const float* src, int s0,
                                          int rows, int width, int cols) {
  for (int idx = threadIdx.x; idx < T * cols; idx += THREADS) {
    const int r = idx / cols, c = idx % cols;
    const int s = s0 + r;
    dst[r * pitch + c] = (s < rows && c < width) ? src[size_t(s) * width + c] : 0.f;
  }
}

// Sum of v over the 16 threads of a row of the thread grid (tx = lane % 16).
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 1; off < 16; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void ssd_bwd_cum_kernel(const float* __restrict__ dt, const float* __restrict__ A,
                           float* __restrict__ cum, int BNC, int H, int Q) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= BNC * H) return;
  const float a = -A[idx % H];
  const float* d = dt + size_t(idx) * Q;
  float* out = cum + size_t(idx) * Q;
  float acc = 0.f;
  for (int t = 0; t < Q; ++t) {
    acc += d[t] * a;
    out[t] = acc;
  }
}

template <int P>
__global__ void __launch_bounds__(THREADS, 1)
ssd_bwd_tile_kernel(const float* __restrict__ x, const float* __restrict__ Bm,
            const float* __restrict__ Cm, const float* __restrict__ dt,
            const float* __restrict__ cum, const float* __restrict__ gy,
            const float* __restrict__ ghc, const float* __restrict__ gdec,
            float* __restrict__ dx, float* __restrict__ dBh, float* __restrict__ dCh,
            float* __restrict__ dcum, float* __restrict__ ddt_dir,
            float* __restrict__ eed, int H, int Q, int N) {
  using C = Cfg<P>;
  constexpr int PP = C::PP, RP = C::RP;
  extern __shared__ float smem[];
  float* Cs = smem;             // T x N: C rows (queries)
  float* Bs = Cs + T * PN;      // T x N: B rows (keys)
  float* gys = Bs + T * PN;     // T x P: gy rows (queries)
  float* xs = gys + T * PP;     // T x P: x rows (keys)
  float* Ws = xs + T * PP;      // T x T
  float* dSs = Ws + T * PT;     // T x T
  float* ghs = dSs + T * PT;    // N x P
  float* cumq = ghs + MAX_N * PP;
  float* dtq = cumq + T;
  float* cumk = dtq + T;
  float* dtk = cumk + T;
  float* rowM = dtk + T;
  float* colM = rowM + T;
  float* colD = colM + T;
  float* Ek = colD + T;

  const int t = blockIdx.x, h = blockIdx.y, bc = blockIdx.z;
  const int nt = (Q + T - 1) / T;
  const int t0 = t * T;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const size_t head = size_t(bc) * H + h;  // (b, c, h)
  const float* x_h = x + head * Q * P;
  const float* gy_h = gy + head * Q * P;
  const float* B_c = Bm + size_t(bc) * Q * N;
  const float* C_c = Cm + size_t(bc) * Q * N;
  const float* dt_h = dt + head * Q;
  const float* cum_h = cum + head * Q;
  const float cum_end = cum_h[Q - 1];
  auto load_scan = [&](float* c, float* d, int s0) {
    for (int r = tid; r < T; r += THREADS) {
      const int s = s0 + r;
      c[r] = s < Q ? cum_h[s] : 0.f;
      d[r] = s < Q ? dt_h[s] : 0.f;
    }
  };

  // ---------------------------------------------- pass A: queries of tile t
  load_rows(Cs, PN, C_c, t0, Q, N, MAX_N);
  load_rows(gys, PP, gy_h, t0, Q, P, P);
  load_scan(cumq, dtq, t0);
  for (int r = tid; r < T; r += THREADS) rowM[r] = 0.f;
  {
    float dC[R][RN];
    zero(dC);
    for (int kt = 0; kt <= t; ++kt) {
      const int k0 = kt * T;
      __syncthreads();  // the last key tile's products are done
      load_rows(Bs, PN, B_c, k0, Q, N, MAX_N);
      load_rows(xs, PP, x_h, k0, Q, P, P);
      load_scan(cumk, dtk, k0);
      __syncthreads();
      float s[R][R], g[R][R];
      zero(s);
      zero(g);
      mm<R, R, true>(s, Cs, PN, Bs, PN, N, ty, tx);
      mm<R, R, true>(g, gys, PP, xs, PP, P, ty, tx);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int il = ty + 16 * r, q = t0 + il;
        float m = 0.f;
#pragma unroll
        for (int c = 0; c < R; ++c) {
          const int jl = tx + 16 * c, k = k0 + jl;
          const bool valid = q < Q && k <= q;
          const float L = valid ? expf(cumq[il] - cumk[jl]) : 0.f;
          const float gl = g[r][c] * L * dtk[jl];
          dSs[il * PT + jl] = gl;
          m += gl * s[r][c];
        }
        m = row_sum(m);
        if (tx == 0) rowM[il] += m;
      }
      __syncthreads();
      mm<R, RN, false>(dC, dSs, PT, Bs, PN, T, ty, tx);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int q = t0 + ty + 16 * r;
      if (q >= Q) continue;
#pragma unroll
      for (int c = 0; c < RN; ++c) {
        const int n = tx + 16 * c;
        if (n < N) dCh[(head * Q + q) * N + n] = dC[r][c];
      }
    }
  }

  // ------------------------------------------------- pass B: keys of tile t
  __syncthreads();
  load_rows(Bs, PN, B_c, t0, Q, N, MAX_N);
  load_rows(xs, PP, x_h, t0, Q, P, P);
  load_scan(cumk, dtk, t0);
  for (int r = tid; r < T; r += THREADS) {
    colM[r] = 0.f;
    colD[r] = 0.f;
  }
  float dB[R][RN], dxa[R][RP];
  zero(dB);
  zero(dxa);
  for (int qt = t; qt < nt; ++qt) {
    const int q0 = qt * T;
    __syncthreads();
    load_rows(Cs, PN, C_c, q0, Q, N, MAX_N);
    load_rows(gys, PP, gy_h, q0, Q, P, P);
    load_scan(cumq, dtq, q0);
    __syncthreads();
    // transposed tiles: rows are this tile's keys j, columns the queries i
    float s[R][R], g[R][R];
    zero(s);
    zero(g);
    mm<R, R, true>(s, Bs, PN, Cs, PN, N, ty, tx);
    mm<R, R, true>(g, xs, PP, gys, PP, P, ty, tx);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int jl = ty + 16 * r, k = t0 + jl;
      float m = 0.f, d = 0.f;
#pragma unroll
      for (int c = 0; c < R; ++c) {
        const int il = tx + 16 * c, q = q0 + il;
        const bool valid = q < Q && k <= q;
        const float L = valid ? expf(cumq[il] - cumk[jl]) : 0.f;
        const float sl = s[r][c] * L;
        const float w = sl * dtk[jl];
        Ws[jl * PT + il] = w;
        dSs[jl * PT + il] = g[r][c] * L * dtk[jl];
        m += g[r][c] * w;
        d += g[r][c] * sl;
      }
      m = row_sum(m);
      d = row_sum(d);
      if (tx == 0) {
        colM[jl] += m;
        colD[jl] += d;
      }
    }
    __syncthreads();
    mm<R, RN, false>(dB, dSs, PT, Cs, PN, T, ty, tx);
    mm<R, RP, false>(dxa, Ws, PT, gys, PP, T, ty, tx);
  }

  // ------------------------------- the chunk-state term of tile t's keys
  __syncthreads();
  const float* ghc_h = ghc + head * N * P;
  for (int idx = tid; idx < MAX_N * P; idx += THREADS) {
    const int n = idx / P, p = idx % P;
    ghs[n * PP + p] = n < N ? ghc_h[n * P + p] : 0.f;
  }
  __syncthreads();
  {
    float u[R][RP];  // u_k = ghc^T B_k: (T, P)
    zero(u);
    mm<R, RP, false>(u, Bs, PN, ghs, PP, N, ty, tx);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int jl = ty + 16 * r, k = t0 + jl;
      const float ed = k < Q ? expf(cum_end - cumk[jl]) * dtk[jl] : 0.f;
      float e = 0.f;
#pragma unroll
      for (int c = 0; c < RP; ++c) {
        dxa[r][c] += ed * u[r][c];
        e += u[r][c] * xs[jl * PP + tx + 16 * c];
      }
      e = row_sum(e);
      if (tx == 0) Ek[jl] = e;
    }
  }
  {
    float w[R][RN];  // ghc x_k: (T, N)
    zero(w);
    mm<R, RN, true>(w, xs, PP, ghs, PP, P, ty, tx);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int jl = ty + 16 * r, k = t0 + jl;
      const float ed = k < Q ? expf(cum_end - cumk[jl]) * dtk[jl] : 0.f;
#pragma unroll
      for (int c = 0; c < RN; ++c) dB[r][c] += ed * w[r][c];
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int k = t0 + ty + 16 * r;
    if (k >= Q) continue;
#pragma unroll
    for (int c = 0; c < RN; ++c) {
      const int n = tx + 16 * c;
      if (n < N) dBh[(head * Q + k) * N + n] = dB[r][c];
    }
#pragma unroll
    for (int c = 0; c < RP; ++c) dx[(head * Q + k) * P + tx + 16 * c] = dxa[r][c];
  }
  __syncthreads();
  for (int r = tid; r < T; r += THREADS) {
    const int k = t0 + r;
    if (k >= Q) continue;
    const float ek = expf(cum_end - cumk[r]);
    const float e = Ek[r] * ek * dtk[r];
    dcum[head * Q + k] = rowM[r] - colM[r] + gdec[head * Q + k] * expf(cumk[r]) - e;
    ddt_dir[head * Q + k] = colD[r] + Ek[r] * ek;
    eed[head * Q + k] = e;
  }
}

__global__ void ssd_bwd_scan_kernel(const float* __restrict__ dt, const float* __restrict__ A,
                            const float* __restrict__ dcum,
                            const float* __restrict__ ddt_dir,
                            const float* __restrict__ eed, float* __restrict__ ddt,
                            float* __restrict__ da_part, int BNC, int H, int Q) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= BNC * H) return;
  const size_t base = size_t(idx) * Q;
  const float a = A[idx % H];
  float end = 0.f;
  for (int k = 0; k < Q; ++k) end += eed[base + k];
  float da = 0.f, dA = 0.f;
  for (int k = Q - 1; k >= 0; --k) {
    da += dcum[base + k] + (k == Q - 1 ? end : 0.f);
    ddt[base + k] = ddt_dir[base + k] - a * da;
    dA -= dt[base + k] * da;
  }
  da_part[idx] = dA;
}

__global__ void ssd_bwd_heads_kernel(const float* __restrict__ dBh, const float* __restrict__ dCh,
                             float* __restrict__ dB, float* __restrict__ dC, int BNC,
                             int H, int QN) {
  const size_t total = size_t(BNC) * QN;
  for (size_t e = blockIdx.x * size_t(blockDim.x) + threadIdx.x; e < total;
       e += size_t(gridDim.x) * blockDim.x) {
    const size_t bc = e / QN, rest = e % QN;
    float sb = 0.f, sc = 0.f;
    for (int h = 0; h < H; ++h) {
      sb += dBh[(bc * H + h) * QN + rest];
      sc += dCh[(bc * H + h) * QN + rest];
    }
    dB[e] = sb;
    dC[e] = sc;
  }
}

__global__ void ssd_bwd_da_kernel(const float* __restrict__ da_part, float* __restrict__ dA,
                          int BNC, int H) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= H) return;
  float s = 0.f;
  for (int bc = 0; bc < BNC; ++bc) s += da_part[size_t(bc) * H + h];
  dA[h] = s;
}

template <int P>
int launch(const float* x, const float* Bm, const float* Cm, const float* dt,
           const float* A, const float* gy, const float* ghc, const float* gdec, float* dx,
           float* dB, float* dC, float* ddt, float* dA, float* scratch, int BNC, int H,
           int Q, int N, cudaStream_t stream) {
  using C = Cfg<P>;
  const size_t heads = size_t(BNC) * H;
  float* cum = scratch;
  float* dcum = cum + heads * Q;
  float* ddt_dir = dcum + heads * Q;
  float* eed = ddt_dir + heads * Q;
  float* da_part = eed + heads * Q;
  float* dBh = da_part + heads;
  float* dCh = dBh + heads * Q * N;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_tile_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(C::SMEM));
  if (err != cudaSuccess) return int(err);
  if (H > 65535 || BNC > 65535) return int(cudaErrorInvalidConfiguration);
  const unsigned per = unsigned((heads + 127) / 128);
  ssd_bwd_cum_kernel<<<per, 128, 0, stream>>>(dt, A, cum, BNC, H, Q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  ssd_bwd_tile_kernel<P><<<dim3((Q + T - 1) / T, H, BNC), THREADS, C::SMEM, stream>>>(
      x, Bm, Cm, dt, cum, gy, ghc, gdec, dx, dBh, dCh, dcum, ddt_dir, eed, H, Q, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  ssd_bwd_scan_kernel<<<per, 128, 0, stream>>>(dt, A, dcum, ddt_dir, eed, ddt, da_part, BNC, H, Q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  ssd_bwd_heads_kernel<<<1024, 256, 0, stream>>>(dBh, dCh, dB, dC, BNC, H, Q * N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  ssd_bwd_da_kernel<<<(H + 127) / 128, 128, 0, stream>>>(da_part, dA, BNC, H);
  return int(cudaGetLastError());
}

}  // namespace

// The floats of scratch ssd_intra_chunk_bwd_f32 needs.
extern "C" long long ssd_bwd_scratch_floats(int Bsz, int nc, int H, int Q, int N) {
  const long long heads = (long long)Bsz * nc * H;
  return heads * (4LL * Q + 1) + 2LL * heads * Q * N;
}

// Returns the CUDA error of the launches (0 when all were accepted).  gy, ghc
// (B, nc, H, N, P) and gdec are the cotangents of y, the chunk states and the
// decay; dx, dB, dC, ddt and dA receive the gradients; scratch holds
// ssd_bwd_scratch_floats(...) floats.
extern "C" int ssd_intra_chunk_bwd_f32(const void* x, const void* Bm, const void* Cm,
                                       const void* dt, const void* A, const void* gy,
                                       const void* ghc, const void* gdec, void* dx,
                                       void* dB, void* dC, void* ddt, void* dA,
                                       void* scratch, int Bsz, int nc, int H, int Q,
                                       int P, int N, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N < 1 || N > MAX_N || Q < 1 || H < 1) return int(cudaErrorInvalidValue);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto w = [](void* p) { return static_cast<float*>(p); };
  const int BNC = Bsz * nc;
  switch (P) {
    case 16:
      return launch<16>(f(x), f(Bm), f(Cm), f(dt), f(A), f(gy), f(ghc), f(gdec), w(dx),
                        w(dB), w(dC), w(ddt), w(dA), w(scratch), BNC, H, Q, N, s);
    case 32:
      return launch<32>(f(x), f(Bm), f(Cm), f(dt), f(A), f(gy), f(ghc), f(gdec), w(dx),
                        w(dB), w(dC), w(ddt), w(dA), w(scratch), BNC, H, Q, N, s);
    case 64:
      return launch<64>(f(x), f(Bm), f(Cm), f(dt), f(A), f(gy), f(ghc), f(gdec), w(dx),
                        w(dB), w(dC), w(ddt), w(dA), w(scratch), BNC, H, Q, N, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}
