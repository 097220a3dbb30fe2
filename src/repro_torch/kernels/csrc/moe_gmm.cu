// Per-expert (grouped) matmul with a fused activation for the port's MoE
// FFN, in CUDA C++ for sm_90a, on Hopper's tensor cores.
//
// Replaces: src/repro/kernels/moe_gmm.py, the Pallas TPU kernel `_gmm_kernel`
// (wrapper `expert_matmul`, `pl.pallas_call` at :61).
// Wrapper here: src/repro_torch/kernels/moe_gmm.py::expert_matmul, which holds
// the plain version `reference_expert_matmul` beside it.
//
// Semantics (those of the TPU kernel and of its oracle):
//   x (E, C, D), w (E, D, F), bf16, contiguous; out (E, C, F) bf16 with
//   out[e] = act(x[e] @ w[e]), the products summed in fp32 over D, the
//   activation (none, silu = v * sigmoid(v), or gelu in its tanh form)
//   applied to the fp32 sum, which is rounded to bf16 once.  A product of two
//   bf16 values is exact in fp32, so this differs from the TPU kernel (which
//   casts both operands to fp32 and dots them) only in the order of the sums.
//   The kernel takes D and F that are multiples of 8 (TMA's 16-byte row
//   pitch) and 16-byte aligned pointers; the wrapper pads a ragged D or F
//   with zeros, which add exact zeros to the sums, and slices the output.
//
// What bounds it on the H100: at the MoE path's shapes (qwen3-moe-30b-a3b,
// E 128, C 320 = 4 token groups x capacity 80; D 2048, F 768 for the gate
// and up products, D 768, F 2048 for the down product) one launch does
// 2 E C D F = 128.8 GFLOP against 633 MB of device memory (x and w read
// once, out written once): 130 us at the 989 TFLOP/s of the bf16 tensor
// cores against 189 us at 3.35 TB/s, so bytes set the bound; the 403 MB of
// expert weights dominate.
//
// Design (a warp-specialised TMA + wgmma GEMM, one output tile per block):
//   - A block of three warpgroups owns a BM 128 x BN 256 output tile of one
//     expert.  Warpgroups 0 and 1 consume, 64 rows each; one thread of
//     warpgroup 2 produces.  `setmaxnreg` gives the consumers 232 registers
//     (the 64 x 256 fp32 accumulator is 128 of them) and the producer 40.
//   - The producer walks D in BK 64 steps (one 128-byte swizzle atom of
//     bf16; chip_smoke.py's GMM_TILE) and loads the x tile (BM x BK) and the
//     w tile (BK x BN, four 64-column blocks) by TMA into a ring of NS 4
//     stages of 48 KB.  Each stage has a full barrier, armed with the TMA's
//     byte count, and an empty barrier on which every active consumer thread
//     arrives once its products have read the stage.
//   - The tensor maps are 3-D: (D, C, E) for x, (F, D, E) for w and (F, C,
//     E) for out, so a box never crosses into the next expert: TMA
//     zero-fills rows past C, depths past D and columns past F, and the
//     output store clips rows past C and columns past F.
//   - Products by `wgmma` m64n256k16, bf16 x bf16 with fp32 sums, both
//     operands from shared memory as TMA wrote them (128-byte swizzle): x
//     K-major for A (8-row groups 1,024 B apart, k16 steps 32 B); w, D x F
//     with F contiguous, MN-major for B through the transpose bit (64-column
//     blocks BK x 128 B apart, 8-depth groups 1,024 B apart, k16 steps
//     2,048 B), the descriptor flash_attention.cu builds for V.  One group of
//     products stays in flight: a stage is released when the next stage's
//     products have been issued and the group before them is done.
//   - Epilogue: the activation on the fp32 accumulator, one rounding to
//     bf16, written in the 128-byte swizzle into the warpgroup's own x rows
//     of the four stages (no load is left in flight by then, and the other
//     warpgroup reads only its own rows and the w tiles), then four TMA
//     stores of 64 x 64.  The activation is a template argument: an
//     epilogue that carried all three, unrolled over the 128 accumulators,
//     ran past the instruction cache and cost more than a 12-step tile's
//     products (PERF.md, section 6).
//   - Under grad (KEEP_Z, a template argument beside the activation) the
//     epilogue also writes Z, the bf16 rounding of the fp32 sum before the
//     activation, to a second (E, C, F) output: the backward
//     (csrc/moe_gmm_bwd.cu) reads act'(Z) from it instead of recomputing
//     the product.  Z is staged in the warpgroup's own w tile of one stage
//     (stage 0 for warpgroup 0, stage 1 for warpgroup 1), once both
//     warpgroups have passed a named barrier after their last products (the
//     other warpgroup may still read those w tiles until then), and stored
//     by four more TMA boxes.  It adds 2 E C F bytes written, 63 MB at the
//     gate product (0.015-0.019 ms more a launch on an H100, PERF.md,
//     section 6); the kernel without it is the launch without grad,
//     unchanged.
//   - No atomics: two launches on the same operands give the same bits.
//
// Tile reckoning at the path's shapes:
//   - Tensor work: C 320 is two full 128-row tiles and one with 64 rows; in
//     that block the second consumer warpgroup, whose rows all lie past C,
//     issues nothing and leaves at once, so the card issues the 128.8 GFLOP
//     that are needed (a whole third tile would issue 154.6).
//   - Bytes from L2 into the SMs: each block reads its x rows once per N
//     tile and its w tile once per M tile: E C D 2 * ceil(F / 256) +
//     E D F 2 * ceil(C / 128) = 503 + 1,208 MB = 1.71 GB a launch (both
//     products alike), about 2.7 times the device-memory bytes.  A cluster
//     of the three M tiles of one (expert, N tile) with the w tile multicast
//     by TMA would read each w tile from L2 once (0.9 GB); it was built and
//     measured, and ran slower (PERF.md, section 6), so the blocks stand alone.
//   - Device memory: blocks run in index order, with the expert outermost,
//     then the N tile, then the M tile, so the tiles of one expert run side
//     by side and share x[e] and w[e] in L2: each is read from device memory
//     about once.
//   - 1,152 blocks (gate, up) or 3,072 (down), one per SM at a time (193 KB
//     of shared memory): 8.7 and 23.3 waves over 132 SMs.  A persistent
//     grid (one block per SM walking its tiles) was measured too, and ran
//     slower.
//   On an H100 it takes 0.26-0.29 ms a launch at the three path launches,
//   0.96-1.18 times torch.bmm with the activation and 65-72 % of the bound
//   (PERF.md, section 6).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;       // rows (C) per block: two consumer warpgroups
constexpr int BN = 256;       // columns (F) per block
constexpr int BK = 64;        // depth (D) per stage (chip_smoke.py's GMM_TILE)
constexpr int NS = 4;         // ring stages
constexpr int THREADS = 384;  // warpgroups 0 and 1 consume, 2 produces
constexpr int ATOM = 64;      // bf16 columns of one 128-byte swizzle atom
constexpr uint32_t ROW = 128;                // bytes of one swizzled row
constexpr uint32_t X_BYTES = BM * BK * 2;    // 16 KB
constexpr uint32_t W_BLOCK = BK * ATOM * 2;  // 8 KB: one 64-column block of w
constexpr uint32_t W_BYTES = BK * BN * 2;    // 32 KB
constexpr uint32_t STAGE = X_BYTES + W_BYTES;
constexpr uint32_t WG_ROWS = 64 * ROW;       // a warpgroup's rows of an x tile
// the ring, 1,024 bytes of alignment slack, then the barriers
constexpr size_t SMEM = NS * STAGE + 1024 + 8 * 2 * NS;
static_assert(NS * ATOM == BN, "the epilogue stages a warpgroup's 64 x BN "
              "output in its x rows of the NS stages, one column block each");
static_assert(W_BLOCK == WG_ROWS && NS >= 2, "KEEP_Z stages a warpgroup's "
              "64 x BN Z in the w tile of its own stage");

enum Activation { kNone = 0, kSilu = 1, kGelu = 2 };

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A wgmma shared-memory descriptor: start address, leading and stride byte
// offsets, swizzle layout (1: 128-byte).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(sbo >> 4) << 32) | (uint64_t(1) << 62);
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
                                         uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
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

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
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

// D (64 x 256, fp32) += A (64 x 16, shared, K-major) . B (16 x 256, shared,
// MN-major).
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
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
      : "l"(a), "l"(b), "r"(1));
}

// The activation, a template argument so that each kernel's epilogue holds
// only its own: silu v sigmoid(v), and gelu's tanh form 0.5 v (1 + tanh(u)),
// u = sqrt(2 / pi) (v + 0.044715 v^3), as v sigmoid(2 u), the same function
// (1 + tanh(u) = 2 sigmoid(2 u)).  Fast exponential and division: their
// relative error, a few fp32 ulps, is far below the one rounding to bf16
// (exp(-k) = inf gives v / inf = 0, the limit).
template <int ACT>
__device__ __forceinline__ float activate(float v) {
  if constexpr (ACT == kSilu) {
    return __fdividef(v, 1.f + __expf(-v));
  } else if constexpr (ACT == kGelu) {
    const float c2 = 1.5957691216057308f;  // 2 sqrt(2 / pi)
    return __fdividef(v, 1.f + __expf(-c2 * (v + 0.044715f * v * v * v)));
  } else {
    return v;
  }
}

// KEEP_Z: also store the pre-activation sum in bf16 through z_map (unused
// otherwise).
template <int ACT, bool KEEP_Z>
__global__ void __launch_bounds__(THREADS, 1)
expert_matmul_kernel(const __grid_constant__ CUtensorMap x_map,
                     const __grid_constant__ CUtensorMap w_map,
                     const __grid_constant__ CUtensorMap o_map,
                     const __grid_constant__ CUtensorMap z_map, int C, int D,
                     int F) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  auto xs = [&](int s) { return ring + s * STAGE; };  // [BM][BK], swizzled
  auto ws = [&](int s) { return ring + s * STAGE + X_BYTES; };  // [BN/64][BK][64]
  const uint32_t bars = ring + NS * STAGE;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (NS + s); };

  // expert outermost, then the N tile, then the M tile
  const int m_tiles = (C + BM - 1) / BM;
  const int n_tiles = (F + BN - 1) / BN;
  const int m0 = int(blockIdx.x) % m_tiles * BM;
  const int n0 = int(blockIdx.x) / m_tiles % n_tiles * BN;
  const int e = int(blockIdx.x) / (m_tiles * n_tiles);
  const int k_steps = (D + BK - 1) / BK;
  // consumer warpgroups with a row below C: 1 or 2
  const int active = C - m0 > 64 ? 2 : 1;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 128 * active);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == 2) {
    // ---------------------------------------------------------- producer --
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 2 * 128) {
      for (int t = 0; t < k_steps; ++t) {
        const int s = t % NS;
        mbar_wait(empty(s), ((t / NS) & 1) ^ 1);
        mbar_expect_tx(full(s), STAGE);
        tma_load(xs(s), &x_map, full(s), t * BK, m0, e);
        for (int cb = 0; cb < BN / ATOM; ++cb)
          tma_load(ws(s) + cb * W_BLOCK, &w_map, full(s), n0 + cb * ATOM, t * BK, e);
      }
    }
  } else {
    // --------------------------------------------------------- consumers --
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    if (wg < active) {
      // x: K-major, 8-row groups 1,024 B apart (LBO unused); w: MN-major,
      // 8-depth groups 1,024 B apart, 64-column blocks W_BLOCK apart
      const uint64_t a_desc = make_desc(xs(0) + wg * WG_ROWS, 16, 8 * ROW);
      const uint64_t b_desc = make_desc(ws(0), W_BLOCK, 8 * ROW);

      float acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      for (int t = 0; t < k_steps; ++t) {
        const int s = t % NS;
        mbar_wait(full(s), (t / NS) & 1);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_n256(acc, a_desc + ((s * STAGE + kk * 32) >> 4),
                     b_desc + ((s * STAGE + kk * 16 * ROW) >> 4));
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products are done
        fence_regs(acc);
        if (t > 0) mbar_arrive(empty((t - 1) % NS));
      }
      wgmma_wait<0>();
      fence_regs(acc);

      // epilogue: act(acc) in bf16 over this warpgroup's x rows of the NS
      // stages (stage cb holds output columns 64 cb .. 64 cb + 63), then TMA;
      // acc[4j], acc[4j + 1]: row r, columns 8j + 2 (lane % 4) and the next;
      // acc[4j + 2], acc[4j + 3]: row r + 8.  With KEEP_Z, acc itself in
      // bf16 over the w tile of stage wg (column block cb at cb W_BLOCK),
      // after every active consumer has passed barrier 3: their products,
      // which read the w tiles, are done by then.
      if constexpr (KEEP_Z) named_barrier(3, 128 * active);
      const int warp = (tid % 128) / 32;
      const int lane = tid % 32;
      const int r = warp * 16 + lane / 4;  // and r + 8: the same swizzle
      const uint32_t swz = r & 7;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const uint32_t in_block = r * ROW + (((j % (ATOM / 8)) ^ swz) << 4) +
                                  4 * (lane % 4);
        const uint32_t at = xs(j / (ATOM / 8)) + wg * WG_ROWS + in_block;
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at),
                     "r"(pack_bf16(activate<ACT>(acc[4 * j]),
                                   activate<ACT>(acc[4 * j + 1]))));
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at + 8 * ROW),
                     "r"(pack_bf16(activate<ACT>(acc[4 * j + 2]),
                                   activate<ACT>(acc[4 * j + 3]))));
        if constexpr (KEEP_Z) {
          const uint32_t zt = ws(wg) + (j / (ATOM / 8)) * W_BLOCK + in_block;
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(zt),
                       "r"(pack_bf16(acc[4 * j], acc[4 * j + 1])));
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(zt + 8 * ROW),
                       "r"(pack_bf16(acc[4 * j + 2], acc[4 * j + 3])));
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      named_barrier(1 + wg, 128);
      if (tid % 128 == 0) {
        for (int cb = 0; cb < BN / ATOM; ++cb)
          tma_store(&o_map, xs(cb) + wg * WG_ROWS, n0 + cb * ATOM, m0 + wg * 64, e);
        if constexpr (KEEP_Z) {
          for (int cb = 0; cb < BN / ATOM; ++cb)
            tma_store(&z_map, ws(wg) + cb * W_BLOCK, n0 + cb * ATOM, m0 + wg * 64, e);
        }
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      }
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

// A TMA map of the contiguous bf16 tensor (n, rows, cols) at ptr whose box is
// `box_rows` rows of one matrix and 64 columns (one 128-byte swizzle atom).
bool make_map(CUtensorMap* map, const void* ptr, int n, int rows, int cols,
              int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {cuuint64_t(cols), cuuint64_t(rows), cuuint64_t(n)};
  const cuuint64_t strides[2] = {cuuint64_t(cols) * 2,
                                 cuuint64_t(rows) * cuuint64_t(cols) * 2};
  const cuuint32_t box[3] = {cuuint32_t(ATOM), cuuint32_t(box_rows), 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
                dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int ACT, bool KEEP_Z>
int launch(const CUtensorMap& x_map, const CUtensorMap& w_map,
           const CUtensorMap& o_map, const CUtensorMap& z_map, int E, int C,
           int D, int F, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      expert_matmul_kernel<ACT, KEEP_Z>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM));
  if (err != cudaSuccess) return int(err);
  const long long blocks =
      (long long)E * ((C + BM - 1) / BM) * ((F + BN - 1) / BN);
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidConfiguration);
  expert_matmul_kernel<ACT, KEEP_Z><<<unsigned(blocks), THREADS, SMEM, stream>>>(
      x_map, w_map, o_map, z_map, C, D, F);
  return int(cudaGetLastError());
}

template <bool KEEP_Z>
int launch_act(int act, const CUtensorMap& x_map, const CUtensorMap& w_map,
               const CUtensorMap& o_map, const CUtensorMap& z_map, int E,
               int C, int D, int F, cudaStream_t stream) {
  switch (act) {
    case kNone:
      return launch<kNone, KEEP_Z>(x_map, w_map, o_map, z_map, E, C, D, F, stream);
    case kSilu:
      return launch<kSilu, KEEP_Z>(x_map, w_map, o_map, z_map, E, C, D, F, stream);
    case kGelu:
      return launch<kGelu, KEEP_Z>(x_map, w_map, o_map, z_map, E, C, D, F, stream);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// Returns the CUDA error of the launch (0 when it was accepted).  act: 0 none,
// 1 silu, 2 gelu (tanh form).  z: null, or an (E, C, F) bf16 output for the
// pre-activation sum (the backward's Z), written by the KEEP_Z kernel.  D
// and F must be multiples of 8 and every pointer 16-byte aligned (the TMA's
// rules).
extern "C" int expert_matmul_bf16(const void* x, const void* w, void* out,
                                  void* z, int E, int C, int D, int F, int act,
                                  void* stream) {
  if (E < 1 || C < 1 || D < 1 || F < 1 || D % 8 || F % 8)
    return int(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
       reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(z)) % 16)
    return int(cudaErrorMisalignedAddress);
  CUtensorMap x_map, w_map, o_map, z_map;
  if (!make_map(&x_map, x, E, C, D, BM) || !make_map(&w_map, w, E, D, F, BK) ||
      !make_map(&o_map, out, E, C, F, 64) ||
      (z != nullptr && !make_map(&z_map, z, E, C, F, 64)))
    return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (z != nullptr)
    return launch_act<true>(act, x_map, w_map, o_map, z_map, E, C, D, F, s);
  return launch_act<false>(act, x_map, w_map, o_map, o_map, E, C, D, F, s);
}
