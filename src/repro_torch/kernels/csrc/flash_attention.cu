// Flash attention forward (GQA, causal, sliding window, tanh softcap) for
// the port, in CUDA C++ for sm_90a.
//
// Replaces: src/repro/kernels/flash_attention.py, the Pallas TPU kernel
// `_flash_kernel` (wrapper `flash_attention`, `pl.pallas_call` at :111).
// Wrapper here: src/repro_torch/kernels/flash_attention.py::flash_attention,
// which holds the plain version `reference_attention` beside it.
//
// Semantics (those of the TPU kernel and of its oracle):
//   q (B, Sq, Hq, hd), k and v (B, Skv, Hkv, hd), bf16, contiguous; query
//   head h reads kv head h / (Hq / Hkv).  s = (q . k) * scale, then
//   softcap * tanh(s / softcap) when softcap > 0, then every (i, j) that the
//   causal mask (i >= j) or the window (i - j < window) excludes is set to
//   -1e30 (finite, as on the TPU).  The softmax is online in fp32 (running
//   max m, normaliser l, accumulator acc), the probabilities p stay fp32 for
//   the product with v (the TPU kernel does the same), a zero normaliser
//   gives the denominator 1, and the output is rounded to bf16 once.
//   Keys past Skv do not exist: they get -inf, so they add nothing even to a
//   row whose every real key is masked (that row then averages v over all
//   Skv keys, as the oracle's softmax of equal scores does).  Query rows past
//   Sq are computed on zeros and never written.
//
// What bounds it on the H100: at the path's shape (B 2, S 2048, Hq 12,
// Hkv 2, hd 128, causal) the work is 4 * B * Hq * hd * S (S + 1) / 2 =
// 25.8 GFLOP against ~29 MB of bytes, so the card's arithmetic sets the
// bound (26 us at the bf16 tensor-core rate; 385 us at the 67 TFLOP/s of
// fp32 outside the tensor cores, which is what this kernel uses).
//
// Design: this first version is right and simple; it computes in fp32 on
// the CUDA cores, so it runs far from the tensor-core bound (wgmma and TMA
// are later work).  One block of 256 threads owns a 64-row query tile of
// one (batch, head) and walks the 64-key tiles that any of its rows can
// see (tiles wholly in the causal future or before every row's window are
// skipped; a tile whose last row sees no key at all walks every tile, so
// that its fully masked rows match the oracle).  The tiles live in shared
// memory as fp32: Q and K transposed (so each thread reads a float4 of 4
// rows and a float4 of 4 keys for a 4 x 4 register tile of scores), then V
// over the buffer K used, and the probabilities transposed.  Each row's 16
// threads reduce max and sum with warp shuffles.  Blocks take the longest
// causal query tiles first, so the last wave is the shortest.  87 KB of
// shared memory at hd 128: two blocks fit on an SM; 153 KB at hd 256 (64
// fp32 accumulators a thread), one block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // keys per tile
constexpr int THREADS = 256;
constexpr int PAD = 4;       // row padding of the transposed tiles (floats)
constexpr int LDQ = BQ + PAD;
constexpr int LDK = BK + PAD;
constexpr float MASKED = -1e30f;

template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       __nv_bfloat16* __restrict__ o,
                       int Sq, int Skv, int Hq, int Hkv, float scale,
                       int causal, int window, float softcap) {
  constexpr int CW = HD / 16;  // output columns per thread
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);  // [HD][LDQ]
  float* KV = Qt + HD * LDQ;   // K as [HD][LDK], then V as [BK][HD]
  float* Pt = KV + HD * LDK;   // [BK][LDQ]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int ty = tid / 16;  // score rows ty*4 + i, output rows the same
  const int tx = tid % 16;  // score cols tx*4 + j, output cols tx + 16*c

  for (int e = tid; e < BQ * HD / 2; e += THREADS) {
    const int r = e / (HD / 2);
    const int d = 2 * (e % (HD / 2));
    float2 val = make_float2(0.f, 0.f);
    if (q0 + r < Sq) {
      val = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
          q + ((size_t(b) * Sq + q0 + r) * Hq + h) * HD + d));
    }
    Qt[d * LDQ + r] = val.x;
    Qt[(d + 1) * LDQ + r] = val.y;
  }

  // The keys any row of this tile can see: [lo of the first row, hi of the
  // last row); every key when the last row sees none.
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int lo_last = window > 0 ? max(q_last - window + 1, 0) : 0;
  const int hi_last = causal ? min(q_last + 1, Skv) : Skv;
  int k_begin = window > 0 ? max(q0 - window + 1, 0) : 0;
  int k_end = hi_last;
  if (lo_last >= hi_last) {
    k_begin = 0;
    k_end = Skv;
  }
  k_begin = (k_begin / BK) * BK;

  float m[4], l[4], acc[4][CW];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = MASKED;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[i][c] = 0.f;
  }

  const size_t kv_row = size_t(Hkv) * HD;  // elements between two keys
  const __nv_bfloat16* kb = k + size_t(b) * Skv * kv_row + size_t(hk) * HD;
  const __nv_bfloat16* vb = v + size_t(b) * Skv * kv_row + size_t(hk) * HD;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // the last tile's P.V is done with KV and Pt
    for (int e = tid; e < BK * HD / 2; e += THREADS) {
      const int c = e / (HD / 2);
      const int d = 2 * (e % (HD / 2));
      float2 val = make_float2(0.f, 0.f);
      if (k0 + c < Skv) {
        val = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            kb + size_t(k0 + c) * kv_row + d));
      }
      KV[d * LDK + c] = val.x;
      KV[(d + 1) * LDK + c] = val.y;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(Qt + d * LDQ + ty * 4);
      const float4 c = *reinterpret_cast<const float4*>(KV + d * LDK + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx * 4 + j;
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        const bool seen = (!causal || qi >= kj) && (window <= 0 || qi - kj < window);
        x = kj >= Skv ? -INFINITY : (seen ? x : MASKED);
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = corr * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CW; ++c) acc[i][c] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<float4*>(Pt + (tx * 4 + j) * LDQ + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncthreads();  // every thread is done reading K

    for (int e = tid; e < BK * HD / 2; e += THREADS) {
      const int c = e / (HD / 2);
      const int d = 2 * (e % (HD / 2));
      float2 val = make_float2(0.f, 0.f);
      if (k0 + c < Skv) {
        val = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            vb + size_t(k0 + c) * kv_row + d));
      }
      KV[c * HD + d] = val.x;
      KV[c * HD + d + 1] = val.y;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float4 p = *reinterpret_cast<const float4*>(Pt + kk * LDQ + ty * 4);
      const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        const float vv = KV[kk * HD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= Sq) continue;
    const float denom = l[i] == 0.f ? 1.f : l[i];
    __nv_bfloat16* row = o + ((size_t(b) * Sq + qi) * Hq + h) * HD;
#pragma unroll
    for (int c = 0; c < CW; ++c) row[tx + 16 * c] = __float2bfloat16(acc[i][c] / denom);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
           int Skv, int Hq, int Hkv, float scale, int causal, int window,
           float softcap, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (HD * LDQ + HD * LDK + BK * LDQ);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  flash_attention_kernel<HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), Sq,
      Skv, Hq, Hkv, scale, causal, window, softcap);
  return int(cudaGetLastError());
}

}  // namespace

// Returns the CUDA error of the launch (0 when it was accepted).  window <= 0
// and softcap <= 0 mean none; hd must be 32, 64, 128 or 256.
extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v,
                                    void* o, int B, int Sq, int Skv, int Hq,
                                    int Hkv, int hd, float scale, int causal,
                                    int window, float softcap, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:
      return launch<32>(q, k, v, o, B, Sq, Skv, Hq, Hkv, scale, causal, window, softcap, s);
    case 64:
      return launch<64>(q, k, v, o, B, Sq, Skv, Hq, Hkv, scale, causal, window, softcap, s);
    case 128:
      return launch<128>(q, k, v, o, B, Sq, Skv, Hq, Hkv, scale, causal, window, softcap, s);
    case 256:
      return launch<256>(q, k, v, o, B, Sq, Skv, Hq, Hkv, scale, causal, window, softcap, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}
