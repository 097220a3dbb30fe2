// Flash attention backward (GQA, causal, sliding window, tanh softcap) for
// the port, in CUDA C++ for sm_90a.
//
// Replaces: the gradient of src/repro/kernels/flash_attention.py's Pallas
// TPU kernel `_flash_kernel` (wrapper `flash_attention`, `pl.pallas_call`
// at :111), which has no VJP of its own: the JAX package differentiates its
// model's `jnp` attention instead.  Wrapper here:
// src/repro_torch/kernels/flash_attention.py::flash_attention_bwd, beside
// its plain version `reference_attention_bwd` (autograd through
// `reference_attention`); the autograd Function `_FlashAttention` calls it.
//
// The function differentiated is the forward's with fp32 probabilities (the
// TPU kernel's and the plain version's):
//   s   = (q . k) * scale, then softcap * tanh(s / softcap) when softcap > 0
//   p   = softmax over the keys of s, where the causal mask (i >= j, top-left
//         aligned) and the window (i - j < window) leave the key; a row that
//         sees no key averages v over all Skv keys (the oracle's softmax of
//         equal -1e30 scores)
//   o   = p . v
// With lse the forward's per-row log-sum-exp of s (natural log, fp32, from
// csrc/flash_attention.cu) and D_i = sum_j p_ij (dO_i . v_j):
//   p_ij  = exp(s_ij - lse_i) where (i, j) is seen, 0 elsewhere, and 1 / Skv
//           on a row that sees no key
//   dV_j  = sum_i p_ij dO_i             (over the G query heads of kv head j)
//   dS_ij = p_ij (dO_i . v_j - D_i) (1 - tanh^2) where seen, else 0
//   dQ_i  = scale sum_j dS_ij k_j,  dK_j = scale sum_i dS_ij q_i (over G too)
// q, k, v and dO are bf16 (B, S, H, hd), hd in {32, 64, 128, 256}; dQ, dK
// and dV come out in bf16, every sum fp32.  D is summed from the fp32 p
// and dP by a sweep of its own, not taken as dO . O from the bf16 output as
// FlashAttention-2 does: on qwen2-1.5b's recorded operands that shortcut
// put dQ 1.2e-2 of its largest magnitude from the plain version (the
// rounding of O is amplified where dP - D cancels), against 3.4e-3 on
// random operands (PERF.md).
//
// What bounds it on the H100: five products against the forward's two, 2.5
// times its operations: 64.5 GFLOP at qwen2-1.5b's shape (B 2, S 2048, Hq 12,
// Hkv 2, hd 128, causal), 65 us at 989 TFLOP/s of bf16 tensor cores.  This
// first version is plain SIMT in fp32 (67 TFLOP/s outside the tensor cores
// would bound it at 0.96 ms) and does seven products where five would do
// (D's sweep recomputes S and dP), so it is far from that bound (PERF.md):
// `wgmma` and TMA are later work.
//
// Design: two kernels, each output element written once by one thread, in a
// fixed order of sums: no atomics, the same bits at every launch.
//   1. flash_bwd_dq_kernel, one block per (query tile of BT rows, query head, batch):
//      two walks over the key tiles its rows can see, S and dP recomputed
//      in each: the first sums D for its rows (written to a scratch row
//      (B, Hq, Sq) for kernel 2), the second forms dS and dQ += dS . K.
//   2. flash_bwd_dkdv_kernel, one block per (key tile of BT keys, kv head, batch):
//      the walk over its G query heads and, for each, the query tiles that
//      can see its keys (and the tiles of rows that see no key, which give
//      dV their 1 / Skv): S, dP, P, dS recomputed, dV += P^T dO, dK += dS^T Q;
//      the sum over the G heads stays in the block.
//   Tiles are staged in shared memory as fp32 rows padded by one word (no
//   bank conflicts in either orientation); 256 threads each own a
//   (BT/16) x (width/16) block of every product, rows and columns strided
//   by 16.  BT is 64, 32 at hd 256, so that four tiles fit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

template <int HD>
struct Cfg {
  static constexpr int BT = HD == 256 ? 32 : 64;  // rows of a query or key tile
  static constexpr int R = BT / 16;               // a thread's rows (and columns) of a BT x BT tile
  static constexpr int RD = HD / 16;              // a thread's columns of a BT x HD tile
  static constexpr int PD = HD + 1;               // pitch of a BT x HD tile, floats
  static constexpr int PT = BT + 1;               // pitch of a BT x BT tile
  static constexpr size_t SMEM = sizeof(float) * (4 * BT * PD + 2 * BT * PT + 2 * BT);
};

// acc[r][c] += sum_{kk < K} a(ty + 16 r, kk) * b(kk, tx + 16 c), with
// a(i, kk) = A[i * lda + kk] (A[kk * lda + i] when TA) and
// b(kk, j) = Bm[kk * ldb + j] (Bm[j * ldb + kk] when TB), from shared memory.
template <int RM, int RN, bool TA, bool TB>
__device__ __forceinline__ void mm(float (&acc)[RM][RN], const float* A, int lda,
                                   const float* Bm, int ldb, int K, int ty, int tx) {
#pragma unroll 4
  for (int kk = 0; kk < K; ++kk) {
    float a[RM], b[RN];
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const int i = ty + 16 * r;
      a[r] = TA ? A[kk * lda + i] : A[i * lda + kk];
    }
#pragma unroll
    for (int c = 0; c < RN; ++c) {
      const int j = tx + 16 * c;
      b[c] = TB ? Bm[j * ldb + kk] : Bm[kk * ldb + j];
    }
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int c = 0; c < RN; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
  }
}

template <int RM, int RN>
__device__ __forceinline__ void zero(float (&acc)[RM][RN]) {
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int c = 0; c < RN; ++c) acc[r][c] = 0.f;
}

// Rows [s0, s0 + BT) of head h of batch b of a bf16 (B, S, H, HD) tensor
// into a BT x HD fp32 tile of pitch HD + 1, zero past S.
template <int HD, int BT>
__device__ __forceinline__ void load_tile(float* dst, const __nv_bfloat16* src, int b,
                                          int s0, int S, int H, int h) {
  for (int idx = threadIdx.x; idx < BT * HD; idx += THREADS) {
    const int r = idx / HD, d = idx % HD;
    const int s = s0 + r;
    dst[r * (HD + 1) + d] =
        s < S ? __bfloat162float(src[((size_t(b) * S + s) * H + h) * HD + d]) : 0.f;
  }
}

struct Mask {
  int Sq, Skv, causal, window;
  __device__ __forceinline__ bool seen(int i, int j) const {
    return i < Sq && j < Skv && (!causal || i >= j) && (window <= 0 || i - j < window);
  }
  // the row sees no key at all (only with a window: rows past Skv + window - 2)
  __device__ __forceinline__ bool blind(int i) const {
    return window > 0 && i < Sq && i >= Skv + window - 1;
  }
};

// The score s of a raw dot product and the softcap's derivative ds/d(raw).
__device__ __forceinline__ float score(float dot, float scale, float softcap, float* dcap) {
  const float raw = dot * scale;
  if (softcap > 0.f) {
    const float t = tanhf(raw / softcap);
    *dcap = 1.f - t * t;
    return softcap * t;
  }
  *dcap = 1.f;
  return raw;
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
          const __nv_bfloat16* __restrict__ v,
          const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
          float* __restrict__ dsum, __nv_bfloat16* __restrict__ dq, int Sq, int Skv,
          int Hq, int Hkv, float scale, Mask mask, float softcap) {
  using C = Cfg<HD>;
  constexpr int BT = C::BT, R = C::R, RD = C::RD, PD = C::PD, PT = C::PT;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BT * PD;
  float* Ks = dOs + BT * PD;
  float* Vs = Ks + BT * PD;
  float* dSs = Vs + BT * PD;
  float* lse_s = dSs + 2 * BT * PT;  // (the P tile's room is unused here)
  float* D_s = lse_s + BT;

  const int q0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const size_t row_base = (size_t(b) * Hq + h) * Sq;

  load_tile<HD, BT>(Qs, q, b, q0, Sq, Hq, h);
  load_tile<HD, BT>(dOs, dout, b, q0, Sq, Hq, h);
  for (int r = tid; r < BT; r += THREADS) lse_s[r] = q0 + r < Sq ? lse[row_base + q0 + r] : 0.f;

  // the keys any row of the tile sees: [lo, hi)
  const int q_last = min(q0 + BT, Sq) - 1;
  const int lo = mask.window > 0 ? max(0, q0 - mask.window + 1) : 0;
  const int hi = mask.causal ? min(Skv, q_last + 1) : Skv;

  // walk 1: D_i = sum_j p_ij dP_ij over the keys row i sees (a row that
  // sees none has no dS, so its D is never read)
  float part[R];
#pragma unroll
  for (int r = 0; r < R; ++r) part[r] = 0.f;
  for (int k0 = (lo / BT) * BT; k0 < hi; k0 += BT) {
    __syncthreads();  // the last tile's products are done with Ks and Vs
    load_tile<HD, BT>(Ks, k, b, k0, Skv, Hkv, hk);
    load_tile<HD, BT>(Vs, v, b, k0, Skv, Hkv, hk);
    __syncthreads();
    float s[R][R], dp[R][R];
    zero(s);
    zero(dp);
    mm<R, R, false, true>(s, Qs, PD, Ks, PD, HD, ty, tx);
    mm<R, R, false, true>(dp, dOs, PD, Vs, PD, HD, ty, tx);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int il = ty + 16 * r;
#pragma unroll
      for (int c = 0; c < R; ++c) {
        float dcap;
        const float sv = score(s[r][c], scale, softcap, &dcap);
        if (mask.seen(q0 + il, k0 + tx + 16 * c))
          part[r] += expf(sv - lse_s[il]) * dp[r][c];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float d = part[r];
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
    const int il = ty + 16 * r;
    if (tx == 0) {
      D_s[il] = d;
      if (q0 + il < Sq) dsum[row_base + q0 + il] = d;
    }
  }

  // walk 2: dS and dQ
  float acc[R][RD];
  zero(acc);
  for (int k0 = (lo / BT) * BT; k0 < hi; k0 += BT) {
    __syncthreads();  // the last tile's products are done with Ks and dSs
    load_tile<HD, BT>(Ks, k, b, k0, Skv, Hkv, hk);
    load_tile<HD, BT>(Vs, v, b, k0, Skv, Hkv, hk);
    __syncthreads();
    float s[R][R], dp[R][R];
    zero(s);
    zero(dp);
    mm<R, R, false, true>(s, Qs, PD, Ks, PD, HD, ty, tx);
    mm<R, R, false, true>(dp, dOs, PD, Vs, PD, HD, ty, tx);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int il = ty + 16 * r, i = q0 + il;
#pragma unroll
      for (int c = 0; c < R; ++c) {
        const int jl = tx + 16 * c, j = k0 + jl;
        float dcap;
        const float sv = score(s[r][c], scale, softcap, &dcap);
        float ds = 0.f;
        if (mask.seen(i, j)) ds = expf(sv - lse_s[il]) * (dp[r][c] - D_s[il]) * dcap;
        dSs[il * PT + jl] = ds;
      }
    }
    __syncthreads();
    mm<R, RD, false, false>(acc, dSs, PT, Ks, PD, BT, ty, tx);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = q0 + ty + 16 * r;
    if (i >= Sq) continue;
#pragma unroll
    for (int c = 0; c < RD; ++c)
      dq[((size_t(b) * Sq + i) * Hq + h) * HD + tx + 16 * c] =
          __float2bfloat16(acc[r][c] * scale);
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkdv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
            const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ dsum,
            __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int Sq,
            int Skv, int Hq, int Hkv, float scale, Mask mask, float softcap) {
  using C = Cfg<HD>;
  constexpr int BT = C::BT, R = C::R, RD = C::RD, PD = C::PD, PT = C::PT;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BT * PD;
  float* Qs = Vs + BT * PD;
  float* dOs = Qs + BT * PD;
  float* Ps = dOs + BT * PD;
  float* dSs = Ps + BT * PT;
  float* lse_s = dSs + BT * PT;
  float* D_s = lse_s + BT;

  const int k0 = blockIdx.x * BT, hk = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const float uniform = 1.f / float(Skv);

  load_tile<HD, BT>(Ks, k, b, k0, Skv, Hkv, hk);
  load_tile<HD, BT>(Vs, v, b, k0, Skv, Hkv, hk);

  // the rows that see any of the tile's keys, [i_lo, i_hi), and the rows
  // that see no key at all, [blind_lo, Sq)
  const int k_last = min(k0 + BT, Skv) - 1;
  const int i_lo = mask.causal ? k0 : 0;
  const int i_hi = mask.window > 0 ? min(Sq, k_last + mask.window) : Sq;
  const int blind_lo = mask.window > 0 ? Skv + mask.window - 1 : Sq;

  float acc_dk[R][RD], acc_dv[R][RD];
  zero(acc_dk);
  zero(acc_dv);
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const size_t row_base = (size_t(b) * Hq + h) * Sq;
    for (int q0 = 0; q0 < Sq; q0 += BT) {
      const bool sees = q0 < i_hi && q0 + BT > i_lo;
      const bool blind = q0 + BT > blind_lo && blind_lo < Sq;
      if (!sees && !blind) continue;
      __syncthreads();  // the last tile's products are done with Qs, dOs, Ps, dSs
      load_tile<HD, BT>(Qs, q, b, q0, Sq, Hq, h);
      load_tile<HD, BT>(dOs, dout, b, q0, Sq, Hq, h);
      for (int r = tid; r < BT; r += THREADS) {
        const int i = q0 + r;
        lse_s[r] = i < Sq ? lse[row_base + i] : 0.f;
        D_s[r] = i < Sq ? dsum[row_base + i] : 0.f;
      }
      __syncthreads();
      float s[R][R], dp[R][R];
      zero(s);
      zero(dp);
      mm<R, R, false, true>(s, Qs, PD, Ks, PD, HD, ty, tx);
      mm<R, R, false, true>(dp, dOs, PD, Vs, PD, HD, ty, tx);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int il = ty + 16 * r, i = q0 + il;
#pragma unroll
        for (int c = 0; c < R; ++c) {
          const int jl = tx + 16 * c, j = k0 + jl;
          float dcap;
          const float sv = score(s[r][c], scale, softcap, &dcap);
          float p = 0.f, ds = 0.f;
          if (mask.seen(i, j)) {
            p = expf(sv - lse_s[il]);
            ds = p * (dp[r][c] - D_s[il]) * dcap;
          } else if (mask.blind(i) && j < Skv) {
            p = uniform;
          }
          Ps[il * PT + jl] = p;
          dSs[il * PT + jl] = ds;
        }
      }
      __syncthreads();
      mm<R, RD, true, false>(acc_dv, Ps, PT, dOs, PD, BT, ty, tx);
      mm<R, RD, true, false>(acc_dk, dSs, PT, Qs, PD, BT, ty, tx);
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int j = k0 + ty + 16 * r;
    if (j >= Skv) continue;
#pragma unroll
    for (int c = 0; c < RD; ++c) {
      const size_t at = ((size_t(b) * Skv + j) * Hkv + hk) * HD + tx + 16 * c;
      dk[at] = __float2bfloat16(acc_dk[r][c] * scale);
      dv[at] = __float2bfloat16(acc_dv[r][c]);
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, float* dsum, void* dq, void* dk, void* dv, int B, int Sq,
           int Skv, int Hq, int Hkv, float scale, int causal, int window, float softcap,
           cudaStream_t stream) {
  using C = Cfg<HD>;
  constexpr int BT = C::BT;
  const Mask mask{Sq, Skv, causal, window};
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(C::SMEM));
  if (err != cudaSuccess) return int(err);
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(C::SMEM));
  if (err != cudaSuccess) return int(err);
  if (Hq > 65535 || Hkv > 65535 || B > 65535) return int(cudaErrorInvalidConfiguration);
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  const auto* db = static_cast<const __nv_bfloat16*>(dout);
  flash_bwd_dq_kernel<HD><<<dim3((Sq + BT - 1) / BT, Hq, B), THREADS, C::SMEM, stream>>>(
      qb, kb, vb, db, lse, dsum, static_cast<__nv_bfloat16*>(dq), Sq, Skv, Hq, Hkv,
      scale, mask, softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  flash_bwd_dkdv_kernel<HD><<<dim3((Skv + BT - 1) / BT, Hkv, B), THREADS, C::SMEM, stream>>>(
      qb, kb, vb, db, lse, dsum, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), Sq, Skv, Hq, Hkv, scale, mask, softcap);
  return int(cudaGetLastError());
}

}  // namespace

// Returns the CUDA error of the launches (0 when both were accepted).
// window <= 0 and softcap <= 0 mean none; hd must be 32, 64, 128 or 256.
// lse (B, Hq, Sq) fp32 is the forward's; dsum (B, Hq, Sq) fp32 is scratch.
extern "C" int flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                        const void* dout, const void* lse,
                                        void* dsum, void* dq, void* dk, void* dv, int B,
                                        int Sq, int Skv, int Hq, int Hkv, int hd,
                                        float scale, int causal, int window,
                                        float softcap, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* l = static_cast<const float*>(lse);
  auto* ds = static_cast<float*>(dsum);
  if (Hkv < 1 || Hq % Hkv != 0) return int(cudaErrorInvalidValue);
  switch (hd) {
    case 32:
      return launch<32>(q, k, v, dout, l, ds, dq, dk, dv, B, Sq, Skv, Hq, Hkv, scale,
                        causal, window, softcap, s);
    case 64:
      return launch<64>(q, k, v, dout, l, ds, dq, dk, dv, B, Sq, Skv, Hq, Hkv, scale,
                        causal, window, softcap, s);
    case 128:
      return launch<128>(q, k, v, dout, l, ds, dq, dk, dv, B, Sq, Skv, Hq, Hkv, scale,
                         causal, window, softcap, s);
    case 256:
      return launch<256>(q, k, v, dout, l, ds, dq, dk, dv, B, Sq, Skv, Hq, Hkv, scale,
                         causal, window, softcap, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}
