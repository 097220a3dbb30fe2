// Flash attention forward (GQA, causal, sliding window, tanh softcap) for
// the port, in CUDA C++ for sm_90a, on Hopper's tensor cores.
//
// Replaces: src/repro/kernels/flash_attention.py, the Pallas TPU kernel
// `_flash_kernel` (wrapper `flash_attention`, `pl.pallas_call` at :111).
// Wrapper here: src/repro_torch/kernels/flash_attention.py::flash_attention,
// which holds the plain version `reference_attention` beside it.
//
// Semantics (those of the TPU kernel and of its oracle):
//   q (B, Sq, Hq, hd), k and v (B, Skv, Hkv, hd), bf16, contiguous, hd in
//   {32, 64, 128, 256}; query head h reads kv head h / (Hq / Hkv).
//   s = (q . k) * scale, then softcap * tanh(s / softcap) when softcap > 0,
//   then every (i, j) that the causal mask (i >= j, top-left aligned) or the
//   window (i - j < window) excludes is set to the finite -1e30, as on the
//   TPU.  Keys past Skv do not exist: they get -inf, so they add nothing even
//   to a row whose every real key is masked (that row then averages v over
//   all Skv keys, as the oracle's softmax of equal scores does).  The
//   softmax is online with an fp32 running max m, normaliser l and
//   accumulator; a zero normaliser gives the denominator 1; the output is
//   rounded to bf16 once.  Query rows past Sq are computed on zeros and
//   never written.
//
// The one numerical change from the TPU kernel: p is rounded to bf16 before
// the product with v (the TPU kernel keeps it fp32), so that P.V runs on the
// bf16 tensor cores with p straight from registers.  The JAX model path the
// port is held against rounds p the same way: `blocked_attention`,
// src/repro/models/layers.py:222, `jax.nn.softmax(s).astype(v.dtype)`.
// Against `reference_attention` (fp32 p), measured by chip_smoke.py on an
// NVIDIA H100 80GB HBM3: the worst (batch, query, head) row within 4.9e-3 of
// its norm and the largest error 5.2e-3 of the largest |output|, inside
// FLASH_TOL (1e-2 and 2^-6); with fp32 p the worst row was 2.2e-3.  The
// scores are exact bf16 products summed in fp32, in another order.
//
// What bounds it on the H100: the work is 4 * B * Hq * hd * (visible
// pairs), 25.8 GFLOP at qwen2-1.5b's shape (B 2, S 2048, Hq 12, Hkv 2,
// hd 128, causal) against ~29 MB of bytes, so the tensor cores' rate bounds
// it (26 us at 989 TFLOP/s bf16).  On that card it reaches ~350-370
// TFLOP/s at hd 128 and ~550 at hd 256 (PERF.md): the softmax between a
// warpgroup's two products does not overlap them, only the other
// warpgroup's.
//
// Design (FlashAttention-3's shape, without its ping-pong scheduling):
//   - One block of three warpgroups owns a 128-row query tile of one
//     (batch, head); blocks take the longest causal tiles first.  Warpgroups
//     0 and 1 consume, 64 query rows each; one thread of warpgroup 2
//     produces.  `setmaxnreg` gives the consumers 232 registers and the
//     producer 40.
//   - The producer loads the Q tile once and the K and V tiles (BK = 64
//     keys) by TMA into a ring of NS stages (4; 2 at hd 256), each stage
//     with full barriers for K and V (the TMA's byte count) and one empty
//     barrier (every consumer thread arrives after its P.V), so the next
//     tiles' loads overlap this tile's products.  The tensor maps cover the
//     (B, S, H, hd) layout with the kv head from the GQA map; TMA zero-fills
//     rows past Sq or Skv and clips the output's rows past Sq.
//   - Tiles live in shared memory as TMA wrote them: 128-byte swizzled rows
//     of 64 columns (64-byte swizzle and 32 columns at hd 32), a tile wider
//     than one swizzle atom split into column blocks.  The wgmma
//     descriptors read that layout directly.
//   - S = Q.K^T by `wgmma` m64n64k16, both operands K-major from shared
//     memory, hd / 16 steps.
//   - Softmax in registers: scale * log2(e) folded into one multiply and
//     exp2f; each row's max and sum over the four threads that hold it in
//     the accumulator layout; the mask built only on tiles that cut the
//     causal diagonal, the window's edge or Skv, and tiles wholly outside
//     every row's view never walked.  A tile whose last row sees no key
//     walks every tile, so that its fully masked rows match the oracle.
//     Every masked entry gets the same -1e30 in the exp2 domain, so a fully
//     masked row gets equal weights.
//   - O += P.V by `wgmma` m64n{hd}k16 with P from registers (the S
//     accumulator's layout is the A fragment's, as in FlashAttention-3) and
//     V from shared memory, MN-major through the transpose bit; O stays fp32
//     in registers and is rescaled by each tile's correction.
//   - Epilogue: O / l in bf16 into the warpgroup's own Q rows (the same
//     swizzle), then one TMA store per column block.  Only when the caller
//     passes an lse buffer (the training path), each row's log-sum-exp
//     (m + log2 l) ln 2 goes there for the backward
//     (csrc/flash_attention_bwd.cu); the inference paths pass none.
//   - No atomics: two launches on the same operands give the same bits.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;       // query rows per block: two consumer warpgroups
constexpr int BK = 64;        // keys per tile (chip_smoke.py's FLASH_TILE)
constexpr int THREADS = 384;  // warpgroups 0 and 1 consume, 2 produces
constexpr int CONSUMERS = 256;
constexpr float MASKED = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int HD>
struct Cfg {
  static constexpr int SW = HD >= 64 ? 128 : 64;  // swizzle span = row pitch, bytes
  static constexpr int AW = SW / 2;               // columns of one swizzle atom
  static constexpr int NCB = HD / AW;             // column blocks of a tile
  static constexpr int SPA = SW / 32;             // k16 steps in one atom row
  static constexpr int NS = HD == 256 ? 2 : 4;    // ring stages
  static constexpr uint32_t Q_BYTES = BQ * HD * 2;
  static constexpr uint32_t KV_BYTES = BK * HD * 2;
  static constexpr uint64_t LAYOUT = SW == 128 ? 1 : 2;  // wgmma: B128 or B64
  // tiles, 1024 bytes of alignment slack, then the barriers
  static constexpr size_t SMEM = Q_BYTES + 2 * NS * KV_BYTES + 1024 + 8 * (1 + 3 * NS);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A wgmma shared-memory descriptor: start address, leading and stride byte
// offsets, swizzle layout.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(sbo >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait for the completion of the barrier's phase of this parity.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accesses to accumulators across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// D (64 x 64, fp32) (+)= A (64 x 16, shared) . B (16 x 64, shared), both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D (64 x 32, fp32) += A (64 x 16, bf16 registers) . B (16 x 32, shared, MN-major).
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D (64 x 64, fp32) += A (64 x 16, bf16 registers) . B (16 x 64, shared, MN-major).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D (64 x 128, fp32) += A (64 x 16, bf16 registers) . B (16 x 128, shared, MN-major).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D (64 x 256, fp32) += A (64 x 16, bf16 registers) . B (16 x 256, shared, MN-major).
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&o)[HD / 2], const uint32_t (&a)[4],
                                         uint64_t b) {
  if constexpr (HD == 32) {
    wgmma_rs_n32(o, a, b);
  } else if constexpr (HD == 64) {
    wgmma_rs_n64(o, a, b);
  } else if constexpr (HD == 128) {
    wgmma_rs_n128(o, a, b);
  } else {
    wgmma_rs_n256(o, a, b);
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       const __grid_constant__ CUtensorMap o_map, int B, int Sq,
                       int Skv, int Hq, int Hkv, float scale, int causal,
                       int window, float softcap, float* __restrict__ lse) {
  using C = Cfg<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sq = (raw + 1023u) & ~1023u;  // Q: NCB blocks of [BQ][AW]
  const uint32_t sk = sq + C::Q_BYTES;         // K of stage s: + s * KV_BYTES
  const uint32_t sv = sk + C::NS * C::KV_BYTES;  // V likewise
  const uint32_t bars = sv + C::NS * C::KV_BYTES;
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8u * (1 + s); };
  auto v_full = [&](int s) { return bars + 8u * (1 + C::NS + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + 2 * C::NS + s); };

  const int heads = Hq * B;
  const int n_qt = (Sq + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - int(blockIdx.x) / heads) * BQ;  // longest first
  const int h = int(blockIdx.x) % heads % Hq;
  const int b = int(blockIdx.x) % heads / Hq;
  const int hk = h / (Hq / Hkv);

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
  const int n_tiles = (k_end - k_begin + BK - 1) / BK;

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < C::NS; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == 2) {
    // ---------------------------------------------------------- producer --
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 2 * 128) {
      mbar_expect_tx(q_full, C::Q_BYTES);
      for (int cb = 0; cb < C::NCB; ++cb)
        tma_load(sq + cb * BQ * C::SW, &q_map, q_full, cb * C::AW, h, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % C::NS;
        const int k0 = k_begin + t * BK;
        mbar_wait(empty(s), ((t / C::NS) & 1) ^ 1);
        mbar_expect_tx(k_full(s), C::KV_BYTES);
        for (int cb = 0; cb < C::NCB; ++cb)
          tma_load(sk + s * C::KV_BYTES + cb * BK * C::SW, &k_map, k_full(s),
                   cb * C::AW, hk, k0, b);
        mbar_expect_tx(v_full(s), C::KV_BYTES);
        for (int cb = 0; cb < C::NCB; ++cb)
          tma_load(sv + s * C::KV_BYTES + cb * BK * C::SW, &v_map, v_full(s),
                   cb * C::AW, hk, k0, b);
      }
    }
  } else {
    // --------------------------------------------------------- consumers --
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int warp = (tid % 128) / 32;
    const int lane = tid % 32;
    const int first = q0 + wg * 64;        // this warpgroup's rows
    const int last = first + 63;
    const int row0 = first + warp * 16 + lane / 4;  // and row0 + 8
    const int col0 = 2 * (lane % 4);       // and col0 + 1, in each 8 columns
    const bool capped = softcap > 0.f;
    const float mul = capped ? scale / softcap : scale * LOG2E;
    const float cap = softcap * LOG2E;

    // Q and K: K-major, 8-row groups 8 * SW bytes apart (LBO unused).
    // V: MN-major, 8-key groups 8 * SW apart, column blocks BK * SW apart.
    const uint64_t q_desc = make_desc(sq + wg * 64 * C::SW, 16, 8 * C::SW, C::LAYOUT);
    const uint64_t k_desc = make_desc(sk, 16, 8 * C::SW, C::LAYOUT);
    const uint64_t v_desc = make_desc(sv, BK * C::SW, 8 * C::SW, C::LAYOUT);

    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    float m0 = MASKED, m1 = MASKED, l0 = 0.f, l1 = 0.f;

    mbar_wait(q_full, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % C::NS;
      const uint32_t phase = (t / C::NS) & 1;
      const int k0 = k_begin + t * BK;

      // S = Q . K^T, 64 x BK fp32
      float sc[BK / 2];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
      mbar_wait(k_full(s), phase);
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t col = (kk % C::SPA) * 32u;  // bytes into the atom row
        const uint32_t q_off = (kk / C::SPA) * BQ * C::SW + col;
        const uint32_t k_off = s * C::KV_BYTES + (kk / C::SPA) * BK * C::SW + col;
        wgmma_ss_n64(sc, q_desc + (q_off >> 4), k_desc + (k_off >> 4), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // scores in the exp2 domain, masked where a row cannot see a key
      if (capped) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) sc[i] = cap * tanhf(sc[i] * mul);
      } else {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) sc[i] *= mul;
      }
      const bool edge = k0 + BK > Skv || (causal && k0 + BK - 1 > first) ||
                        (window > 0 && k0 <= last - window);
      if (edge) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const int row = row0 + ((i & 2) ? 8 : 0);
          const int key = k0 + 8 * (i / 4) + col0 + (i & 1);
          const bool seen = (!causal || row >= key) && (window <= 0 || row - key < window);
          sc[i] = key >= Skv ? -INFINITY : (seen ? sc[i] : MASKED);
        }
      }

      // online softmax: rows row0 (sc[4j], sc[4j + 1]) and row0 + 8
      // (sc[4j + 2], sc[4j + 3]), each shared by four lanes
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float corr0 = exp2f(m0 - mx0), corr1 = exp2f(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      float r0 = 0.f, r1 = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        sc[4 * j] = exp2f(sc[4 * j] - mx0);
        sc[4 * j + 1] = exp2f(sc[4 * j + 1] - mx0);
        sc[4 * j + 2] = exp2f(sc[4 * j + 2] - mx1);
        sc[4 * j + 3] = exp2f(sc[4 * j + 3] - mx1);
        r0 += sc[4 * j] + sc[4 * j + 1];
        r1 += sc[4 * j + 2] + sc[4 * j + 3];
      }
      l0 = l0 * corr0 + r0;  // this lane's part; the four are summed at the end
      l1 = l1 * corr1 + r1;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        o[4 * j] *= corr0;
        o[4 * j + 1] *= corr0;
        o[4 * j + 2] *= corr1;
        o[4 * j + 3] *= corr1;
      }
      // P in bf16 as wgmma's A fragments: k16 step kk holds keys
      // 16 kk .. 16 kk + 15, which are sc[8 kk .. 8 kk + 7]
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);

      // O += P . V
      mbar_wait(v_full(s), phase);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_pv<HD>(o, pa[kk], v_desc + ((s * C::KV_BYTES + kk * 16 * C::SW) >> 4));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      mbar_arrive(empty(s));
    }

    // epilogue: O / l in bf16 over this warpgroup's Q rows, then TMA stores
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = 1.f / (l0 == 0.f ? 1.f : l0);
    const float inv1 = 1.f / (l1 == 0.f ? 1.f : l1);
    if (lse != nullptr && lane % 4 == 0) {
      // each row's log-sum-exp of s, natural log, for the backward (m is in
      // the exp2 domain); a row that sees no key keeps the masked score
      float* row = lse + (size_t(b) * Hq + h) * Sq;
      if (row0 < Sq) row[row0] = m0 == MASKED ? MASKED : (m0 + log2f(l0)) * LN2;
      if (row0 + 8 < Sq) row[row0 + 8] = m1 == MASKED ? MASKED : (m1 + log2f(l1)) * LN2;
    }
    named_barrier(1 + wg, 128);  // the warpgroup's products no longer read Q
    const uint32_t ob = sq + wg * 64 * C::SW;
    const int r = warp * 16 + lane / 4;  // and r + 8: the same swizzle
    const uint32_t swz = C::SW == 128 ? (r & 7) : ((r >> 1) & 3);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const uint32_t chunk = j % (C::AW / 8);
      const uint32_t at = ob + (j / (C::AW / 8)) * BQ * C::SW + r * C::SW +
                          ((chunk ^ swz) << 4) + 2 * col0;
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at),
                   "r"(pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0)));
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at + 8 * C::SW),
                   "r"(pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1)));
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    named_barrier(1 + wg, 128);
    if (tid % 128 == 0) {
      for (int cb = 0; cb < C::NCB; ++cb)
        tma_store(&o_map, ob + cb * BQ * C::SW, cb * C::AW, h, first, b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, without linking libcuda.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return EncodeTiled(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A TMA map of the contiguous bf16 tensor (B, S, H, hd) at ptr whose box is
// `rows` rows of one head and `cols` columns, swizzled by `sw` bytes.
bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int H, int hd,
              int cols, int rows, int sw) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {cuuint64_t(hd), cuuint64_t(H), cuuint64_t(S),
                              cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(hd) * 2, cuuint64_t(H) * hd * 2,
                                 cuuint64_t(S) * H * hd * 2};
  const cuuint32_t box[4] = {cuuint32_t(cols), 1, cuuint32_t(rows), 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                sw == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
           int Skv, int Hq, int Hkv, float scale, int causal, int window,
           float softcap, float* lse, cudaStream_t stream) {
  using C = Cfg<HD>;
  CUtensorMap q_map, k_map, v_map, o_map;
  if (!make_map(&q_map, q, B, Sq, Hq, HD, C::AW, BQ, C::SW) ||
      !make_map(&k_map, k, B, Skv, Hkv, HD, C::AW, BK, C::SW) ||
      !make_map(&v_map, v, B, Skv, Hkv, HD, C::AW, BK, C::SW) ||
      !make_map(&o_map, o, B, Sq, Hq, HD, C::AW, 64, C::SW))
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(C::SMEM));
  if (err != cudaSuccess) return int(err);
  const long long blocks = (long long)((Sq + BQ - 1) / BQ) * Hq * B;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidConfiguration);
  flash_attention_kernel<HD><<<unsigned(blocks), THREADS, C::SMEM, stream>>>(
      q_map, k_map, v_map, o_map, B, Sq, Skv, Hq, Hkv, scale, causal, window,
      softcap, lse);
  return int(cudaGetLastError());
}

}  // namespace

// Returns the CUDA error of the launch (0 when it was accepted).  window <= 0
// and softcap <= 0 mean none; hd must be 32, 64, 128 or 256, and every
// pointer 16-byte aligned (the TMA's rule).  lse, when not null, receives
// each row's log-sum-exp of the scores, fp32 (B, Hq, Sq): the backward's.
extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v,
                                    void* o, int B, int Sq, int Skv, int Hq,
                                    int Hkv, int hd, float scale, int causal,
                                    int window, float softcap, void* lse_out,
                                    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse = static_cast<float*>(lse_out);
  switch (hd) {
    case 32:
      return launch<32>(q, k, v, o, B, Sq, Skv, Hq, Hkv, scale, causal, window, softcap, lse, s);
    case 64:
      return launch<64>(q, k, v, o, B, Sq, Skv, Hq, Hkv, scale, causal, window, softcap, lse, s);
    case 128:
      return launch<128>(q, k, v, o, B, Sq, Skv, Hq, Hkv, scale, causal, window, softcap, lse, s);
    case 256:
      return launch<256>(q, k, v, o, B, Sq, Skv, Hq, Hkv, scale, causal, window, softcap, lse, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}
