// Flash attention backward (GQA, causal, sliding window, tanh softcap) for
// the port, in CUDA C++ for sm_90a, on Hopper's tensor cores.
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
// q, k, v and dO are bf16 (B, S, H, hd), hd in {16, 32, 64, 128, 256}, 16-byte
// aligned (TMA); dQ, dK and dV come out in bf16, every sum fp32.  D is
// summed from the fp32 p and dP by a walk of its own, not taken as dO . O
// from the bf16 output as FlashAttention-2 does: on qwen2-1.5b's recorded
// operands that shortcut put dQ 1.2e-2 of its largest magnitude from the
// plain version (the rounding of O is amplified where dP - D cancels).
//
// The numerical change from the plain version: P and dS are rounded to bf16
// as the A operands of the products dV += P^T dO, dK += dS^T Q and
// dQ += dS K (FlashAttention's choice), where the plain version keeps them
// fp32.  Each is rounded once, after dP - D is formed, so the rounding is
// not amplified by that cancellation.  S and dP are exact bf16 products
// summed in fp32, as before; D stays exact.  On qwen2-1.5b's recorded path
// operands (chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W) dQ, dK and dV
// lay within 3.0e-3, 3.4e-3 and 3.7e-3 of their largest magnitudes from the
// plain version, against FLASH_BWD_TOL 2^-6; against the plain version run
// in float64 the kernel lay 2.5e-3 to 3.7e-3 off, the fp32 plain version
// 1.6e-6 to 6.3e-6.  So bf16 dS passed the gate, and dS is not split into
// hi and lo operands.
//
// What bounds it on the H100: five products against the forward's two, 2.5
// times its operations: 64.5 GFLOP at qwen2-1.5b's shape (B 2, S 2048, Hq 12,
// Hkv 2, hd 128, causal), 65.2 us at 989 TFLOP/s of bf16 tensor cores
// (chip_smoke._flash_bwd_bound).  This design does nine products where five
// would do: D's walk recomputes S and dP, and the dK/dV kernel recomputes
// them again, the price of writing every element once without atomics.  So
// it can reach at most 5/9 of the bound.  Measured by chip_smoke.py on an
// NVIDIA H100 80GB HBM3 at 700.00 W: 0.282-0.287 ms a launch (22.7-23.1 % of
// the bound; the first version, fp32 SIMT, 9.13 ms), 1.22-1.25x
// scaled_dot_product_attention's backward; the dK/dV kernel 0.160 ms of it
// (scripts/flash_bwd_timing.py), held back by the causal triangle: its 128
// blocks fit one wave of the 132 SMs, so the key tiles with the longest
// walks set its time.
//
// Design: two kernels, each output element written once, in a fixed order
// of sums: no atomics, the same bits at every launch.  Each block has three
// warpgroups: warpgroups 0 and 1 consume (`setmaxnreg` 232), warpgroup 2
// produces (40): TMA loads of 64-row tiles into a ring of stages with full
// and empty mbarriers, so the next tile's loads overlap this tile's
// products.  Tiles live in shared memory as TMA wrote them, 128-byte
// swizzled rows of 64 columns (64-byte and 32 at hd 32, 32-byte and 16 at
// hd 16), as in
// csrc/flash_attention.cu, and every product is a `wgmma` read from there.
//   1. flash_bwd_dq_kernel, a block per 128 query rows (64 a consumer) of one
//      (batch, head), the longest causal tiles first.  Q and dO are loaded
//      once; the ring holds K and V tiles of 64 keys, for two walks over
//      the key tiles the rows can see.  Walk 1: S = Q K^T and dP = dO V^T
//      (both operands K-major from shared memory), D_i += p_ij dP_ij in
//      registers; D goes to a scratch row (B, Hq, Sq) for kernel 2.  Walk
//      2: S and dP again, dS in registers, then dQ += dS K with dS as the A
//      fragments straight from the accumulators (as the forward's P) and K
//      MN-major through the transpose bit.
//   2. flash_bwd_dkdv_kernel, a block per 64 keys of one (batch, kv head).
//      K and V are loaded once; the ring holds the Q and dO tiles (64 rows)
//      of each (query head g < G, query tile) that can see the keys, and the
//      tiles of rows that see no key (which give dV their 1 / Skv), with the
//      rows' lse and D, which the producer warpgroup copies beside them.
//      Consumer w takes the steps of parity w, each with its own
//      accumulators: S^T = K Q^T and dP^T = V dO^T with the key rows in the
//      warpgroup (FlashAttention-3's arrangement), so P^T and dS^T are A
//      fragments in registers for dV += P^T dO and dK += dS^T Q, with dO
//      and Q MN-major.  At the end warpgroup 1 hands its dK and dV to
//      warpgroup 0 through shared memory, which adds them (0's + 1's) and
//      writes; the sum over the G heads stays in the block.
//   At hd 256 a warpgroup's dK and dV accumulators of 64 x 256 would not fit
//   its registers, so each block writes DN = 128 columns of its gradients
//   and two blocks split the columns (each recomputing S and dP); at hd 256
//   the dQ kernel's ring has one stage (Q and dO take 128 KB).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 384;   // warpgroups 0 and 1 consume, 2 produces
constexpr int CONSUMERS = 256;
constexpr int BQ = 128;        // query rows of a dQ block
constexpr int BT = 64;         // rows of a ring tile, keys of a dK/dV block
constexpr float LOG2E = 1.4426950408889634f;

template <int HD>
struct Cfg {
  static constexpr int SW = HD >= 64 ? 128 : HD * 2;  // swizzle span = row pitch, bytes
  static constexpr int AW = SW / 2;               // columns of one swizzle atom
  static constexpr int NCB = HD / AW;             // column blocks of a tile
  static constexpr int SPA = SW / 32;             // k16 steps in one atom row
  static constexpr int DN = HD > 128 ? 128 : HD;  // gradient columns a block writes
  static constexpr int NSPLIT = HD / DN;          // blocks sharing a tile's columns
  static constexpr uint64_t LAYOUT = SW == 128 ? 1 : SW == 64 ? 2 : 3;  // wgmma: B128, B64, B32
  static constexpr uint32_t T_BYTES = BT * HD * 2;       // a 64-row tile
  // dQ kernel: Q and dO of 128 rows, then a ring of NSQ stages of K and V
  static constexpr int NSQ = HD == 256 ? 1 : 4;
  static constexpr size_t SMEM_DQ = 4 * T_BYTES + 2 * NSQ * T_BYTES + 1024 + 8 * (1 + 3 * NSQ);
  // dK/dV kernel: K and V, then a ring of NSK stages of Q, dO and the rows'
  // lse and D; NSK is even, so each stage serves one consumer
  static constexpr int NSK = HD == 256 ? 2 : 4;
  static constexpr size_t SMEM_DKDV =
      2 * T_BYTES + 2 * NSK * T_BYTES + 2 * NSK * BT * 4 + 1024 + 8 * (1 + 3 * NSK);
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

// A tile of `rows` rows of head h from row s0 of batch b: NCB column blocks
// of rows x AW, each `rows` * SW bytes.
template <int HD>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int rows, int h, int s0,
                                         int b) {
  using C = Cfg<HD>;
#pragma unroll
  for (int cb = 0; cb < C::NCB; ++cb)
    tma_load(dst + cb * rows * C::SW, map, bar, cb * C::AW, h, s0, b);
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

// D (64 x 16, fp32) += A (64 x 16, bf16 registers) . B (16 x 16, shared, MN-major).
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
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

// D (64 x DN) += A (64 x 16, registers) . B (16 x DN, shared, MN-major).
template <int DN>
__device__ __forceinline__ void wgmma_rs(float (&d)[DN / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (DN == 16) {
    wgmma_rs_n16(d, a, b);
  } else if constexpr (DN == 32) {
    wgmma_rs_n32(d, a, b);
  } else if constexpr (DN == 64) {
    wgmma_rs_n64(d, a, b);
  } else {
    wgmma_rs_n128(d, a, b);
  }
}

// The 64 x 64 fp32 accumulator of a thread of a warpgroup: element i lies in
// row row0 + 8 * ((i >> 1) & 1) and column 8 * (i >> 2) + col0 + (i & 1).
__device__ __forceinline__ int acc_row(int row0, int i) { return row0 + ((i & 2) ? 8 : 0); }
__device__ __forceinline__ int acc_col(int col0, int i) { return 8 * (i >> 2) + col0 + (i & 1); }

// The 64 x 64 accumulator as wgmma's bf16 A fragments of four k16 steps:
// step kk holds columns 16 kk .. 16 kk + 15, elements 8 kk .. 8 kk + 7.
__device__ __forceinline__ void a_fragments(uint32_t (&a)[4][4], const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

// s = A1 B1^T and t = A2 B2^T over the head width, 64 x 64 each, every
// operand K-major in shared memory: A's column blocks a_rows * SW bytes
// apart, B's (a 64-row tile) BT * SW.
template <int HD>
__device__ __forceinline__ void two_products(float (&s)[32], float (&t)[32], uint64_t a1,
                                             uint64_t a2, uint64_t b1, uint64_t b2,
                                             int a_rows) {
  using C = Cfg<HD>;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = t[i] = 0.f;
  fence_regs(s);
  fence_regs(t);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t col = (kk % C::SPA) * 32u;  // bytes into the atom row
    const uint32_t a_off = ((kk / C::SPA) * a_rows * C::SW + col) >> 4;
    const uint32_t b_off = ((kk / C::SPA) * BT * C::SW + col) >> 4;
    wgmma_ss_n64(s, a1 + a_off, b1 + b_off, kk > 0);
    wgmma_ss_n64(t, a2 + a_off, b2 + b_off, kk > 0);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(s);
  fence_regs(t);
}

// The mask, written without branches (bitwise & and |): a branch around
// each element of a tile would serialise the elements' dependent chains.
struct Mask {
  int Sq, Skv, causal, window;
  __device__ __forceinline__ bool seen(int i, int j) const {
    return (i < Sq) & (j < Skv) & (!causal | (i >= j)) & ((window <= 0) | (i - j < window));
  }
  // the row sees no key at all (only with a window: rows past Skv + window - 2)
  __device__ __forceinline__ bool blind(int i) const {
    return (window > 0) & (i < Sq) & (i >= Skv + window - 1);
  }
  // every row of [i0, i0 + 64) sees every key of [j0, j0 + 64): the tile
  // needs no mask
  __device__ __forceinline__ bool all_seen(int i0, int j0) const {
    return i0 + 63 < Sq && j0 + 63 < Skv && (!causal || i0 >= j0 + 63) &&
           (window <= 0 || i0 + 63 - j0 < window);
  }
};

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// p = exp(s - lse) of a raw dot product, from lse2 = lse log2(e), and the
// softcap's derivative ds/d(raw) in dcap; CAP: the scores are softcapped.
// Computed for every element, seen or not (the caller selects), so that the
// 32 elements of a thread run without branches.
template <bool CAP>
__device__ __forceinline__ float prob(float dot, float scale, float softcap, float lse2,
                                      float& dcap) {
  if constexpr (CAP) {
    const float t = tanhf(dot * scale / softcap);
    dcap = 1.f - t * t;
    return fast_exp2(softcap * LOG2E * t - lse2);
  } else {
    dcap = 1.f;
    return fast_exp2(dot * (scale * LOG2E) - lse2);
  }
}

// f(std::false_type) on a tile that needs no mask, else f(std::true_type):
// the elementwise loops are compiled both ways, and the interior tiles run
// without the mask's integer work.
template <typename F>
__device__ __forceinline__ void masked_if(bool edge, F&& f) {
  if (edge)
    f(std::true_type{});
  else
    f(std::false_type{});
}

template <int HD, bool CAP>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap do_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    const float* __restrict__ lse, float* __restrict__ dsum,
                    __nv_bfloat16* __restrict__ dq, int B, int Sq, int Skv, int Hq,
                    int Hkv, float scale, Mask mask, float softcap) {
  using C = Cfg<HD>;
  constexpr int DN = C::DN, SW = C::SW;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;  // Q: NCB blocks of [BQ][AW]
  const uint32_t sdo = sq + 2 * C::T_BYTES;                     // dO likewise
  const uint32_t sk = sdo + 2 * C::T_BYTES;  // K of stage s: + s * T_BYTES
  const uint32_t sv = sk + C::NSQ * C::T_BYTES;  // V likewise
  const uint32_t bars = sv + C::NSQ * C::T_BYTES;
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8u * (1 + s); };
  auto v_full = [&](int s) { return bars + 8u * (1 + C::NSQ + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + 2 * C::NSQ + s); };

  // block -> (query tile, longest first; column split; head; batch)
  const int per_tile = C::NSPLIT * Hq * B;
  const int n_qt = (Sq + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - int(blockIdx.x) / per_tile) * BQ;
  const int rest = int(blockIdx.x) % per_tile;
  const int split = rest % C::NSPLIT;
  const int h = rest / C::NSPLIT % Hq, b = rest / C::NSPLIT / Hq;
  const int hk = h / (Hq / Hkv);

  // the keys any row of the tile sees: [lo, hi), walked in tiles of BT
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int lo = mask.window > 0 ? max(0, q0 - mask.window + 1) : 0;
  const int hi = mask.causal ? min(Skv, q_last + 1) : Skv;
  const int k_begin = (lo / BT) * BT;
  const int n_tiles = hi > lo ? (hi - k_begin + BT - 1) / BT : 0;

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < C::NSQ; ++s) {
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
      mbar_expect_tx(q_full, 4 * C::T_BYTES);
      tma_tile<HD>(sq, &q_map, q_full, BQ, h, q0, b);
      tma_tile<HD>(sdo, &do_map, q_full, BQ, h, q0, b);
      // walk 1 then walk 2 over the same key tiles
      for (int t = 0; t < 2 * n_tiles; ++t) {
        const int s = t % C::NSQ;
        const int k0 = k_begin + (t % n_tiles) * BT;
        mbar_wait(empty(s), ((t / C::NSQ) & 1) ^ 1);
        mbar_expect_tx(k_full(s), C::T_BYTES);
        tma_tile<HD>(sk + s * C::T_BYTES, &k_map, k_full(s), BT, hk, k0, b);
        mbar_expect_tx(v_full(s), C::T_BYTES);
        tma_tile<HD>(sv + s * C::T_BYTES, &v_map, v_full(s), BT, hk, k0, b);
      }
    }
    return;
  }
  // ----------------------------------------------------------- consumers --
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int row0 = q0 + wg * 64 + warp * 16 + lane / 4;  // and row0 + 8
  const int col0 = 2 * (lane % 4);
  const size_t row_base = (size_t(b) * Hq + h) * Sq;
  const float lse0 = row0 < Sq ? lse[row_base + row0] * LOG2E : 0.f;
  const float lse1 = row0 + 8 < Sq ? lse[row_base + row0 + 8] * LOG2E : 0.f;
  const int first = q0 + wg * 64;  // this warpgroup's first row

  // Q, dO, K and V K-major (8-row groups 8 * SW bytes apart); K MN-major
  // for dQ += dS K (8-key groups 8 * SW apart, column blocks BT * SW apart),
  // from this block's first column
  const uint64_t q_desc = make_desc(sq + wg * 64 * SW, 16, 8 * SW, C::LAYOUT);
  const uint64_t do_desc = make_desc(sdo + wg * 64 * SW, 16, 8 * SW, C::LAYOUT);
  const uint64_t k_desc = make_desc(sk, 16, 8 * SW, C::LAYOUT);
  const uint64_t v_desc = make_desc(sv, 16, 8 * SW, C::LAYOUT);
  const uint64_t kmn_desc =
      make_desc(sk + split * (DN / C::AW) * BT * SW, BT * SW, 8 * SW, C::LAYOUT);

  // S = Q K^T and dP = dO V^T of the key tile in stage s
  float sc[32], dp[32];
  auto products = [&](int s, uint32_t phase) {
    mbar_wait(k_full(s), phase);
    mbar_wait(v_full(s), phase);
    const uint32_t at = (s * C::T_BYTES) >> 4;
    two_products<HD>(sc, dp, q_desc, do_desc, k_desc + at, v_desc + at, BQ);
  };

  mbar_wait(q_full, 0);
  // walk 1: D_i = sum_j p_ij dP_ij over the keys row i sees (a row that
  // sees none has no dS, so its D, 0, is never read)
  float d0 = 0.f, d1 = 0.f;
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % C::NSQ;
    const int k0 = k_begin + t * BT;
    products(s, (t / C::NSQ) & 1);
    mbar_arrive(empty(s));
    masked_if(!mask.all_seen(first, k0), [&](auto masked) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int row = acc_row(row0, i), key = k0 + acc_col(col0, i);
        float dcap;
        const float p = prob<CAP>(sc[i], scale, softcap, (i & 2) ? lse1 : lse0, dcap);
        const float pd = !decltype(masked)::value || mask.seen(row, key) ? p * dp[i] : 0.f;
        if (i & 2)
          d1 += pd;
        else
          d0 += pd;
      }
    });
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    d0 += __shfl_xor_sync(0xffffffffu, d0, off);
    d1 += __shfl_xor_sync(0xffffffffu, d1, off);
  }
  if (split == 0 && lane % 4 == 0) {
    if (row0 < Sq) dsum[row_base + row0] = d0;
    if (row0 + 8 < Sq) dsum[row_base + row0 + 8] = d1;
  }

  // walk 2: dS, then dQ += dS K
  float acc[DN / 2];
#pragma unroll
  for (int i = 0; i < DN / 2; ++i) acc[i] = 0.f;
  for (int t = n_tiles; t < 2 * n_tiles; ++t) {
    const int s = t % C::NSQ;
    const int k0 = k_begin + (t - n_tiles) * BT;
    products(s, (t / C::NSQ) & 1);
    masked_if(!mask.all_seen(first, k0), [&](auto masked) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int row = acc_row(row0, i), key = k0 + acc_col(col0, i);
        float dcap;
        const float p = prob<CAP>(sc[i], scale, softcap, (i & 2) ? lse1 : lse0, dcap);
        const float ds = p * (dp[i] - ((i & 2) ? d1 : d0)) * dcap;
        sc[i] = !decltype(masked)::value || mask.seen(row, key) ? ds : 0.f;
      }
    });
    uint32_t dsa[4][4];
    a_fragments(dsa, sc);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk)
      wgmma_rs<DN>(acc, dsa[kk], kmn_desc + ((s * C::T_BYTES + kk * 16 * SW) >> 4));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    mbar_arrive(empty(s));
  }

  // dQ = scale * acc in bf16, this block's DN columns
#pragma unroll
  for (int j = 0; j < DN / 8; ++j) {
    const int col = split * DN + 8 * j + col0;
    if (row0 < Sq)
      *reinterpret_cast<uint32_t*>(dq + ((size_t(b) * Sq + row0) * Hq + h) * HD + col) =
          pack_bf16(acc[4 * j] * scale, acc[4 * j + 1] * scale);
    if (row0 + 8 < Sq)
      *reinterpret_cast<uint32_t*>(dq + ((size_t(b) * Sq + row0 + 8) * Hq + h) * HD + col) =
          pack_bf16(acc[4 * j + 2] * scale, acc[4 * j + 3] * scale);
  }
}

// The query tiles a dK/dV block walks for each of its G heads: those that
// can see its keys, [a0, a0 + na), then those of rows that see no key and
// are not among the first, [b0, b0 + nb).
struct Walk {
  int a0, na, b0, nb;
  __device__ __forceinline__ int tile(int u) const { return u < na ? a0 + u : b0 + u - na; }
};

template <int HD, bool CAP>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap do_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map,
                      const float* __restrict__ lse, const float* __restrict__ dsum,
                      __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                      int B, int Sq, int Skv, int Hq, int Hkv, float scale, Mask mask,
                      float softcap) {
  using C = Cfg<HD>;
  constexpr int DN = C::DN, SW = C::SW, NS = C::NSK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sk = (raw + 1023u) & ~1023u;  // K: NCB blocks of [BT][AW]
  const uint32_t sv = sk + C::T_BYTES;         // V likewise
  const uint32_t sq = sv + C::T_BYTES;         // Q of stage s: + s * T_BYTES
  const uint32_t sdo = sq + NS * C::T_BYTES;   // dO likewise
  const uint32_t stats = sdo + NS * C::T_BYTES;  // stage s: lse[BT], then D[BT]
  const uint32_t bars = stats + 2 * NS * BT * 4;
  float* stats_f = reinterpret_cast<float*>(smem_raw + (stats - raw));
  const uint32_t kv_full = bars;
  auto q_full = [&](int s) { return bars + 8u * (1 + s); };
  auto do_full = [&](int s) { return bars + 8u * (1 + NS + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + 2 * NS + s); };

  // block -> (key tile, the longest causal walks first; column split; kv
  // head; batch)
  const int per_tile = C::NSPLIT * Hkv * B;
  const int k0 = int(blockIdx.x) / per_tile * BT;
  const int rest = int(blockIdx.x) % per_tile;
  const int split = rest % C::NSPLIT;
  const int hk = rest / C::NSPLIT % Hkv, b = rest / C::NSPLIT / Hkv;
  const int G = Hq / Hkv;

  // the rows that see any of the tile's keys, [i_lo, i_hi), and the rows
  // that see no key at all, [blind_lo, Sq)
  const int k_last = min(k0 + BT, Skv) - 1;
  const int i_lo = mask.causal ? k0 : 0;
  const int i_hi = mask.window > 0 ? min(Sq, k_last + mask.window) : Sq;
  const int blind_lo = mask.window > 0 ? Skv + mask.window - 1 : Sq;
  const int n_qt = (Sq + BT - 1) / BT;
  Walk walk{0, 0, 0, 0};
  if (i_lo < i_hi) {
    walk.a0 = i_lo / BT;
    walk.na = (i_hi + BT - 1) / BT - walk.a0;
  }
  walk.b0 = blind_lo < Sq ? max(blind_lo / BT, walk.a0 + walk.na) : n_qt;
  walk.nb = max(0, n_qt - walk.b0);
  const int per_head = walk.na + walk.nb;
  const int n_steps = G * per_head;

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(q_full(s), 1);
      mbar_init(do_full(s), 1 + 128);  // the TMA's arrival and the producers'
      mbar_init(empty(s), 128);        // one consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == 2) {
    // ---------------------------------------------------------- producer --
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    const int ptid = tid - 2 * 128;
    if (ptid == 0) {
      mbar_expect_tx(kv_full, 2 * C::T_BYTES);
      tma_tile<HD>(sk, &k_map, kv_full, BT, hk, k0, b);
      tma_tile<HD>(sv, &v_map, kv_full, BT, hk, k0, b);
    }
    for (int t = 0; t < n_steps; ++t) {
      const int s = t % NS;
      const int h = hk * G + t / per_head;
      const int q0 = walk.tile(t % per_head) * BT;
      mbar_wait(empty(s), ((t / NS) & 1) ^ 1);
      if (ptid == 0) {
        mbar_expect_tx(q_full(s), C::T_BYTES);
        tma_tile<HD>(sq + s * C::T_BYTES, &q_map, q_full(s), BT, h, q0, b);
        mbar_expect_tx(do_full(s), C::T_BYTES);
        tma_tile<HD>(sdo + s * C::T_BYTES, &do_map, do_full(s), BT, h, q0, b);
      }
      // the rows' lse log2(e) (threads 0..63) and D (64..127)
      const int i = q0 + (ptid % BT);
      const size_t at = (size_t(b) * Hq + h) * Sq + i;
      stats_f[(2 * s + ptid / BT) * BT + ptid % BT] =
          i >= Sq ? 0.f : ptid < BT ? lse[at] * LOG2E : dsum[at];
      mbar_arrive(do_full(s));
    }
    return;
  }
  // ----------------------------------------------------------- consumers --
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int row0 = warp * 16 + lane / 4;  // key rows row0 and row0 + 8 of the tile
  const int col0 = 2 * (lane % 4);
  const float uniform = 1.f / float(Skv);

  // K, V, Q and dO K-major for S^T and dP^T; Q and dO MN-major for the
  // gradients (8-row groups 8 * SW apart, column blocks BT * SW apart),
  // from this block's first column
  const uint64_t k_desc = make_desc(sk, 16, 8 * SW, C::LAYOUT);
  const uint64_t v_desc = make_desc(sv, 16, 8 * SW, C::LAYOUT);
  const uint64_t q_desc = make_desc(sq, 16, 8 * SW, C::LAYOUT);
  const uint64_t do_desc = make_desc(sdo, 16, 8 * SW, C::LAYOUT);
  const uint32_t first_col = split * (DN / C::AW) * BT * SW;
  const uint64_t qmn_desc = make_desc(sq + first_col, BT * SW, 8 * SW, C::LAYOUT);
  const uint64_t domn_desc = make_desc(sdo + first_col, BT * SW, 8 * SW, C::LAYOUT);

  float acc_dk[DN / 2], acc_dv[DN / 2];
#pragma unroll
  for (int i = 0; i < DN / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;

  mbar_wait(kv_full, 0);
  for (int t = wg; t < n_steps; t += 2) {
    const int s = t % NS;
    const uint32_t phase = (t / NS) & 1;
    const int q0 = walk.tile(t % per_head) * BT;

    // S^T = K Q^T and dP^T = V dO^T: rows are keys, columns queries
    float st[32], dpt[32];
    mbar_wait(q_full(s), phase);
    mbar_wait(do_full(s), phase);
    const uint32_t at = (s * C::T_BYTES) >> 4;
    two_products<HD>(st, dpt, k_desc, v_desc, q_desc + at, do_desc + at, BT);

    // P^T and dS^T in place
    const float* lse_s = stats_f + 2 * s * BT;
    const float* d_s = lse_s + BT;
    masked_if(!mask.all_seen(q0, k0), [&](auto masked) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = k0 + acc_row(row0, i);
        const int il = acc_col(col0, i), qi = q0 + il;
        float dcap;
        const float p = prob<CAP>(st[i], scale, softcap, lse_s[il], dcap);
        const float ds = p * (dpt[i] - d_s[il]) * dcap;
        if constexpr (decltype(masked)::value) {
          const bool seen = mask.seen(qi, key);
          st[i] = seen ? p : mask.blind(qi) & (key < Skv) ? uniform : 0.f;
          dpt[i] = seen ? ds : 0.f;
        } else {
          st[i] = p;
          dpt[i] = ds;
        }
      }
    });
    uint32_t pa[4][4], dsa[4][4];
    a_fragments(pa, st);
    a_fragments(dsa, dpt);

    // dV += P^T dO and dK += dS^T Q
    fence_regs(acc_dv);
    fence_regs(acc_dk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) {
      const uint32_t off = (s * C::T_BYTES + kk * 16 * SW) >> 4;
      wgmma_rs<DN>(acc_dv, pa[kk], domn_desc + off);
      wgmma_rs<DN>(acc_dk, dsa[kk], qmn_desc + off);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc_dv);
    fence_regs(acc_dk);
    mbar_arrive(empty(s));
  }

  // warpgroup 1 hands its sums to warpgroup 0 through the ring (both are
  // done with it), which adds them, 0's + 1's, and writes
  float* red = reinterpret_cast<float*>(smem_raw + (sq - raw));
  const int ctid = tid % 128;
  named_barrier(1, CONSUMERS);
  if (wg == 1) {
#pragma unroll
    for (int i = 0; i < DN / 2; ++i) {
      red[i * 128 + ctid] = acc_dk[i];
      red[(DN / 2 + i) * 128 + ctid] = acc_dv[i];
    }
  }
  named_barrier(1, CONSUMERS);
  if (wg == 1) return;
#pragma unroll
  for (int j = 0; j < DN / 8; ++j) {
    const int col = split * DN + 8 * j + col0;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int key = k0 + row0 + 8 * half;
      const int i0 = 4 * j + 2 * half;
      if (key >= Skv) continue;
      const size_t at = ((size_t(b) * Skv + key) * Hkv + hk) * HD + col;
      const float k_lo = acc_dk[i0] + red[i0 * 128 + ctid];
      const float k_hi = acc_dk[i0 + 1] + red[(i0 + 1) * 128 + ctid];
      const float v_lo = acc_dv[i0] + red[(DN / 2 + i0) * 128 + ctid];
      const float v_hi = acc_dv[i0 + 1] + red[(DN / 2 + i0 + 1) * 128 + ctid];
      *reinterpret_cast<uint32_t*>(dk + at) = pack_bf16(k_lo * scale, k_hi * scale);
      *reinterpret_cast<uint32_t*>(dv + at) = pack_bf16(v_lo, v_hi);
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
                sw == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                : sw == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                           : CU_TENSOR_MAP_SWIZZLE_32B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, bool CAP>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, float* dsum, void* dq, void* dk, void* dv, int B, int Sq,
           int Skv, int Hq, int Hkv, float scale, int causal, int window, float softcap,
           cudaStream_t stream) {
  using C = Cfg<HD>;
  const Mask mask{Sq, Skv, causal, window};
  CUtensorMap q128, do128, q64, do64, k64, v64;
  if (!make_map(&q128, q, B, Sq, Hq, HD, C::AW, BQ, C::SW) ||
      !make_map(&do128, dout, B, Sq, Hq, HD, C::AW, BQ, C::SW) ||
      !make_map(&q64, q, B, Sq, Hq, HD, C::AW, BT, C::SW) ||
      !make_map(&do64, dout, B, Sq, Hq, HD, C::AW, BT, C::SW) ||
      !make_map(&k64, k, B, Skv, Hkv, HD, C::AW, BT, C::SW) ||
      !make_map(&v64, v, B, Skv, Hkv, HD, C::AW, BT, C::SW))
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<HD, CAP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(C::SMEM_DQ));
  if (err != cudaSuccess) return int(err);
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<HD, CAP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, int(C::SMEM_DKDV));
  if (err != cudaSuccess) return int(err);
  const long long dq_blocks = (long long)((Sq + BQ - 1) / BQ) * C::NSPLIT * Hq * B;
  const long long dkdv_blocks = (long long)((Skv + BT - 1) / BT) * C::NSPLIT * Hkv * B;
  if (dq_blocks > 0x7fffffffLL || dkdv_blocks > 0x7fffffffLL)
    return int(cudaErrorInvalidConfiguration);
  auto* db = static_cast<__nv_bfloat16*>(dq);
  flash_bwd_dq_kernel<HD, CAP><<<unsigned(dq_blocks), THREADS, C::SMEM_DQ, stream>>>(
      q128, do128, k64, v64, lse, dsum, db, B, Sq, Skv, Hq, Hkv, scale, mask, softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  flash_bwd_dkdv_kernel<HD, CAP><<<unsigned(dkdv_blocks), THREADS, C::SMEM_DKDV, stream>>>(
      q64, do64, k64, v64, lse, dsum, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), B, Sq, Skv, Hq, Hkv, scale, mask, softcap);
  return int(cudaGetLastError());
}

}  // namespace

// Returns the CUDA error of the launches (0 when both were accepted).
// window <= 0 and softcap <= 0 mean none; hd must be 16, 32, 64, 128 or 256, and
// q, k, v and dout 16-byte aligned (the TMA's rule).  lse (B, Hq, Sq) fp32 is
// the forward's; dsum (B, Hq, Sq) fp32 is scratch.
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
  // the kernels for the width, with or without the softcap
  const bool cap = softcap > 0.f;
  decltype(&launch<32, true>) fn = nullptr;
  switch (hd) {
    case 16:
      fn = cap ? launch<16, true> : launch<16, false>;
      break;
    case 32:
      fn = cap ? launch<32, true> : launch<32, false>;
      break;
    case 64:
      fn = cap ? launch<64, true> : launch<64, false>;
      break;
    case 128:
      fn = cap ? launch<128, true> : launch<128, false>;
      break;
    case 256:
      fn = cap ? launch<256, true> : launch<256, false>;
      break;
    default:
      return int(cudaErrorInvalidValue);
  }
  return fn(q, k, v, dout, l, ds, dq, dk, dv, B, Sq, Skv, Hq, Hkv, scale, causal, window,
            softcap, s);
}
