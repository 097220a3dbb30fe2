// Backward of the per-expert (grouped) matmul with a fused activation for the
// port's MoE FFN, in CUDA C++ for sm_90a, on Hopper's tensor cores.
//
// Replaces: no TPU kernel of its own.  It is the gradient of
// src/repro/kernels/moe_gmm.py's `_gmm_kernel` (B3, `pl.pallas_call` at :61),
// which the JAX package differentiates through its jnp code; the port's
// forward is csrc/moe_gmm.cu, and autograd would stop at it without this.
// Wrapper here: src/repro_torch/kernels/moe_gmm.py::expert_matmul_bwd, which
// holds the plain version `reference_expert_matmul_bwd` (dZ from the given
// Z, then the two products, in float32) beside it.
//
// Semantics: the forward is Y = act(Z), Z[e] = X[e] W[e], X (E, C, D) and W
// (E, D, F) bf16, fp32 sums, act none, silu or gelu (tanh form).  For the
// cotangent dY (E, C, F) bf16 and, with an activation, the forward's Z (E,
// C, F) bf16 (csrc/moe_gmm.cu writes it under grad: the bf16 rounding of
// the fp32 sum before the activation):
//   dZ = dY * act'(Z)      (dZ = dY where act is none)
//   dX = dZ W^T            (E, C, F) . (E, F, D) -> (E, C, D) bf16
//   dW = X^T dZ            (E, D, C) . (E, C, F) -> (E, D, F) bf16
// every product summed in fp32 and rounded to bf16 once.  dZ is a bf16
// operand of the two products (the plain version keeps it fp32), and act'
// reads Z in bf16: each rounding, 2^-9 of an element at most, adds terms of
// random sign, so each gradient lies a fraction of a bf16 ulp of its largest
// magnitude further from the float64 values than the plain version's own
// rounding (chip_smoke.py's GMM_BWD_TOL and GMM_BWD_WITNESS hold both).
// Like B3, the kernels take D and F in multiples of 8 and 16-byte aligned
// operands; the wrapper pads a ragged D or F with zeros (zero cotangent
// columns, zero depths) and slices the gradients back.
//
// Why Z is kept: without it a third product recomputes Z = X W, re-reading
// X and W (570 MB at the path's gate product), 0.38 ms of a 0.97 ms
// backward on an H100 (PERF.md, section 6).  The port's train mode
// checkpoints each repetition (models/transformer.py), so a kept Z lives
// only while one repetition is recomputed and back-propagated: 63 MB per
// activated product at qwen3-moe-30b-a3b's shapes.
//
// What bounds it on the H100: at qwen3-moe-30b-a3b's gate product (E 128,
// C 320, D 2048, F 768, silu) the two products do 2 x 2 E C D F = 257.7
// GFLOP, 261 us at the 989 TFLOP/s of the bf16 tensor cores, against 1.27
// GB of device memory (x, w, dY and Z read once, dX and dW written once)
// at 3.35 TB/s, 378 us: bytes set the bound, with or without the
// activation (without it, 1.20 GB and 359 us).  The 403 MB of expert
// weights and as many of their gradient dominate the bytes.
//
// Design, three launches (two without an activation):
//   - dZ = dY act'(Z) (silu, gelu): one elementwise pass, 16-byte loads of
//     eight bf16 of dY and of Z a thread, act' in fp32, dZ stored once in
//     bf16 (189 MB moved at the gate product, 56 us at the memory's rate).
//   - dX = dZ W^T and dW = X^T dZ: a persistent warp-specialised TMA +
//     wgmma GEMM each.  One block of three warpgroups per SM walks a tile
//     list in expert-major order (the expert outermost, then the N tile,
//     then the M tile: the tiles in flight share W's or X's slice in L2);
//     a tile is 128 x 256 fp32, two consumer warpgroups of 64 rows each,
//     `wgmma` m64n256k16 with the 128-byte swizzle everywhere.  One
//     producer thread walks every tile's depth in BK 64 steps through a
//     ring of 48 KB stages, without a pause between tiles: it loads the
//     next tile's first stages while the consumers run the current tile's
//     epilogue.  A consumer warpgroup whose rows of a tile all lie past M
//     (the half-empty third tile of C 320) passes its stages on without
//     products.
//   - The operands' major-ness is a template argument.  dX: A is dZ,
//     K-major; B is W read K-major: W[e] (D, F) with F contiguous is W^T's
//     K-major layout, one TMA box of 256 rows of D by 64 of F a stage.  dW:
//     A is X read M-major through the transpose bit, per consumer
//     warpgroup one TMA box of 64 depths (C) by 64 rows (D), D contiguous;
//     B is dZ read N-major as B3 reads W.
//   - Epilogue: each consumer warpgroup rounds its 64 x 256 to bf16 into a
//     buffer of its own (not the ring, which already holds the next tile's
//     loads) and stores it by TMA, which clips rows and columns past the
//     output's edges; it waits for that buffer's previous store to have
//     read it only when it writes the buffer again.  TMA zero-fills every
//     load past an edge.
//   - The stage count and the epilogue's passes are template arguments, as
//     measured at the path's shapes (PERF.md, section 6): dX takes 3
//     stages and 32 KB buffers (208 KB of shared memory); dW, whose depth
//     is C (5 stages a tile at C 320), takes 4 stages and stores its output
//     in two passes of 128 columns through 16 KB buffers (224 KB), so that
//     the producer holds most of the next tile while a tile's epilogue
//     runs: 0.243 against 0.264 ms with 3 stages at the up product on an
//     H100.  dX with 4 stages ran slower there (0.308 against 0.259 ms).
//   - No atomics: two launches on the same operands give the same bits.
// Its times against its bound and torch.bmm (dX and dW from the plain dZ)
// at the MoE path's shapes are in PERF.md, section 6.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;       // output rows per tile: two consumer warpgroups
constexpr int BN = 256;       // output columns per tile
constexpr int BK = 64;        // depth per stage (one 128-byte swizzle atom)
constexpr int THREADS = 384;  // warpgroups 0 and 1 consume, 2 produces
constexpr int CONSUMERS = 256;  // threads of the two consumer warpgroups
constexpr int ATOM = 64;      // bf16 columns of one 128-byte swizzle atom
constexpr uint32_t ROW = 128;                // bytes of one swizzled row
constexpr uint32_t A_BYTES = BM * BK * 2;    // 16 KB
constexpr uint32_t A_BLOCK = BK * ATOM * 2;  // 8 KB: a warpgroup's 64 rows
constexpr uint32_t B_BLOCK = BK * ATOM * 2;  // 8 KB: one 64-column block of B
constexpr uint32_t B_BYTES = BK * BN * 2;    // 32 KB
constexpr uint32_t STAGE = A_BYTES + B_BYTES;
constexpr uint32_t O_BLOCK = 64 * ATOM * 2;  // 8 KB: 64 rows of one column block
constexpr uint32_t EPI = 64 * BN * 2;        // 32 KB: a warpgroup's output
// A GEMM's ring of NS stages, the two consumer warpgroups' epilogue buffers
// (each 64 x BN / PASSES: the output goes out in PASSES column slices),
// 1,024 bytes of alignment slack, then the barriers.
template <int NS, int PASSES>
constexpr size_t smem_bytes() {
  return NS * STAGE + 2 * (EPI / PASSES) + 1024 + 8 * 2 * NS;
}
static_assert(A_BLOCK == 64 * ROW, "a warpgroup's A rows are one 8 KB block "
              "in either major-ness");
constexpr int DZ_THREADS = 256;

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

// D (64 x 256, fp32) += A (64 x 16, shared) . B (16 x 256, shared); TA 1
// reads A M-major (transposed), TB 1 reads B N-major (transposed), 0 each
// K-major.
template <int TA, int TB>
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
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
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
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
}

// act'(z) for the dZ pass: silu' = s (1 + z (1 - s)), s = sigmoid(z);
// gelu's tanh form 0.5 z (1 + tanh(u)), u = c (z + 0.044715 z^3), c =
// sqrt(2 / pi), has the derivative s2 + 2 z s2 (1 - s2) c (1 + 0.134145 z^2)
// with s2 = sigmoid(2 u) (1 + tanh(u) = 2 s2, 1 - tanh(u)^2 = 4 s2 (1 - s2)).
// exp(-z) = inf gives s = 0 and the limit 0.
template <int ACT>
__device__ __forceinline__ float dact(float z) {
  if constexpr (ACT == kSilu) {
    const float s = 1.f / (1.f + __expf(-z));
    return s * (1.f + z * (1.f - s));
  } else {
    const float c = 0.7978845608028654f;  // sqrt(2 / pi)
    const float s2 = 1.f / (1.f + __expf(-2.f * c * (z + 0.044715f * z * z * z)));
    return s2 + 2.f * z * s2 * (1.f - s2) * c * (1.f + 0.134145f * z * z);
  }
}

// Two bf16 of a 32-bit word as an fp32 pair.
__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// dZ = dY act'(Z), eight elements a thread and step, over n 16-byte words.
template <int ACT>
__global__ void __launch_bounds__(DZ_THREADS)
gmm_bwd_dz_kernel(const uint4* __restrict__ dy, const uint4* __restrict__ z,
          uint4* __restrict__ dz, long long n) {
  for (long long i = (long long)blockIdx.x * DZ_THREADS + threadIdx.x; i < n;
       i += (long long)gridDim.x * DZ_THREADS) {
    const uint4 g = __ldg(dy + i);
    const uint4 v = __ldg(z + i);
    const uint32_t gs[4] = {g.x, g.y, g.z, g.w};
    const uint32_t zs[4] = {v.x, v.y, v.z, v.w};
    uint32_t out[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 gf = unpack_bf16(gs[k]), zf = unpack_bf16(zs[k]);
      out[k] = pack_bf16(gf.x * dact<ACT>(zf.x), gf.y * dact<ACT>(zf.y));
    }
    dz[i] = make_uint4(out[0], out[1], out[2], out[3]);
  }
}

// out[e] = A[e] . B[e] (M x N, depth K), persistent: block b takes tiles b,
// b + gridDim.x, ... of the E ceil(M / BM) ceil(N / BN) tiles of 128 x 256,
// numbered with the expert outermost, then the N tile, then the M tile.
// A_MN: A is read M-major (its K x M matrix in memory, M contiguous), else
// K-major (M x K, K contiguous); B_K: B is read K-major (its N x K matrix, K
// contiguous), else N-major (K x N, N contiguous).  NS ring stages; the
// epilogue stores a warpgroup's output in PASSES column slices through a
// buffer of 64 x BN / PASSES.
template <bool A_MN, bool B_K, int NS, int PASSES>
__global__ void __launch_bounds__(THREADS, 1)
gmm_bwd_kernel(const __grid_constant__ CUtensorMap a_map,
               const __grid_constant__ CUtensorMap b_map,
               const __grid_constant__ CUtensorMap o_map, int E, int M, int N,
               int K) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  auto as = [&](int s) { return ring + s * STAGE; };
  auto bs = [&](int s) { return ring + s * STAGE + A_BYTES; };
  constexpr uint32_t EPI_P = EPI / PASSES;        // a warpgroup's buffer
  constexpr int J_P = BN / 8 / PASSES;             // accumulator quads a pass
  constexpr int CB_P = BN / ATOM / PASSES;         // column blocks a pass
  static_assert(J_P % (ATOM / 8) == 0, "a pass stores whole column blocks");
  const uint32_t epi = ring + NS * STAGE;  // [warpgroup][CB_P][64][64]
  const uint32_t bars = epi + 2 * EPI_P;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (NS + s); };

  const int m_tiles = (M + BM - 1) / BM;
  const int n_tiles = (N + BN - 1) / BN;
  const int tiles = E * m_tiles * n_tiles;
  const int k_steps = (K + BK - 1) / BK;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMERS);  // every consumer, active or not
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == 2) {
    // ---------------------------------------------------------- producer --
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 2 * 128) {
      int it = 0;  // stages loaded so far, over every tile of this block
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile % m_tiles * BM;
        const int n0 = tile / m_tiles % n_tiles * BN;
        const int e = tile / (m_tiles * n_tiles);
        for (int t = 0; t < k_steps; ++t, ++it) {
          const int s = it % NS;
          mbar_wait(empty(s), ((it / NS) & 1) ^ 1);
          mbar_expect_tx(full(s), STAGE);
          if constexpr (A_MN) {
            for (int blk = 0; blk < 2; ++blk)
              tma_load(as(s) + blk * A_BLOCK, &a_map, full(s), m0 + blk * ATOM,
                       t * BK, e);
          } else {
            tma_load(as(s), &a_map, full(s), t * BK, m0, e);
          }
          if constexpr (B_K) {
            tma_load(bs(s), &b_map, full(s), t * BK, n0, e);
          } else {
            for (int cb = 0; cb < BN / ATOM; ++cb)
              tma_load(bs(s) + cb * B_BLOCK, &b_map, full(s), n0 + cb * ATOM,
                       t * BK, e);
          }
        }
      }
    }
  } else {
    // --------------------------------------------------------- consumers --
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    // K-major: 8-row groups 1,024 B apart, k16 steps 32 B along the row;
    // M- or N-major: 8-depth groups 1,024 B apart, 64-column blocks
    // A_BLOCK / B_BLOCK apart, k16 steps 2,048 B
    const uint64_t a_desc = A_MN ? make_desc(as(0) + wg * A_BLOCK, A_BLOCK, 8 * ROW)
                                 : make_desc(as(0) + wg * A_BLOCK, 16, 8 * ROW);
    const uint64_t b_desc = B_K ? make_desc(bs(0), 16, 8 * ROW)
                                : make_desc(bs(0), B_BLOCK, 8 * ROW);
    constexpr uint32_t a_step = A_MN ? 16 * ROW : 32;
    constexpr uint32_t b_step = B_K ? 32 : 16 * ROW;
    // the epilogue's place of acc[4j], acc[4j + 1]: row r, columns 8j + 2
    // (lane % 4) and the next; acc[4j + 2], acc[4j + 3]: row r + 8
    const int warp = (tid % 128) / 32;
    const int lane = tid % 32;
    const int r = warp * 16 + lane / 4;  // and r + 8: the same swizzle
    const uint32_t swz = r & 7;
    const uint32_t out = epi + wg * EPI_P + r * ROW + 4 * (lane % 4);

    int it = 0;  // stages consumed so far, over every tile of this block
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = tile % m_tiles * BM;
      const int n0 = tile / m_tiles % n_tiles * BN;
      const int e = tile / (m_tiles * n_tiles);
      if (M - m0 <= 64 * wg) {
        // every row of this warpgroup lies past M: hand the stages back
        for (int t = 0; t < k_steps; ++t, ++it) {
          mbar_wait(full(it % NS), (it / NS) & 1);
          mbar_arrive(empty(it % NS));
        }
        continue;
      }
      float acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      for (int t = 0; t < k_steps; ++t, ++it) {
        const int s = it % NS;
        mbar_wait(full(s), (it / NS) & 1);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_n256<A_MN ? 1 : 0, B_K ? 0 : 1>(
              acc, a_desc + ((s * STAGE + kk * a_step) >> 4),
              b_desc + ((s * STAGE + kk * b_step) >> 4));
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products are done
        fence_regs(acc);
        if (t > 0) mbar_arrive(empty((it - 1) % NS));
      }
      wgmma_wait<0>();
      fence_regs(acc);
      // the tile's last stage: the producer goes on into the next tile
      mbar_arrive(empty((it - 1) % NS));

      // epilogue: acc in bf16 over this warpgroup's buffer (column block cb
      // of the pass at cb O_BLOCK), once the buffer's last store has read
      // it, then TMA; pass h holds output columns BN / PASSES h onwards
#pragma unroll
      for (int h = 0; h < PASSES; ++h) {
        if (tid % 128 == 0)
          asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        named_barrier(1 + wg, 128);
#pragma unroll
        for (int jj = 0; jj < J_P; ++jj) {
          const int j = h * J_P + jj;
          const uint32_t at = out + (jj / (ATOM / 8)) * O_BLOCK +
                              (((jj % (ATOM / 8)) ^ swz) << 4);
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at),
                       "r"(pack_bf16(acc[4 * j], acc[4 * j + 1])));
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at + 8 * ROW),
                       "r"(pack_bf16(acc[4 * j + 2], acc[4 * j + 3])));
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        named_barrier(1 + wg, 128);
        if (tid % 128 == 0) {
          for (int cb = 0; cb < CB_P; ++cb)
            tma_store(&o_map, epi + wg * EPI_P + cb * O_BLOCK,
                      n0 + (h * CB_P + cb) * ATOM, m0 + wg * 64, e);
          asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        }
      }
    }
    if (tid % 128 == 0)
      asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
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

// The current device's SMs, 0 where the query fails.
int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return n;
}

template <bool A_MN, bool B_K, int NS, int PASSES>
int launch(const CUtensorMap& a_map, const CUtensorMap& b_map,
           const CUtensorMap& o_map, int E, int M, int N, int K,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<NS, PASSES>();
  static_assert(smem <= 232448, "past the 227 KB a block can use");
  const cudaError_t err = cudaFuncSetAttribute(
      gmm_bwd_kernel<A_MN, B_K, NS, PASSES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const long long tiles =
      (long long)E * ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  const int sms = sm_count();
  if (sms < 1) return int(cudaErrorInvalidDevice);
  if (tiles > 0x7fffffffLL) return int(cudaErrorInvalidConfiguration);
  const unsigned blocks = unsigned(tiles < sms ? tiles : sms);
  gmm_bwd_kernel<A_MN, B_K, NS, PASSES><<<blocks, THREADS, smem, stream>>>(
      a_map, b_map, o_map, E, M, N, K);
  return int(cudaGetLastError());
}

template <int ACT>
int launch_dz(const void* dy, const void* z, void* dz, long long n,
              cudaStream_t stream) {
  const int sms = sm_count();
  if (sms < 1) return int(cudaErrorInvalidDevice);
  const long long want = (n + DZ_THREADS - 1) / DZ_THREADS;
  const long long most = 8LL * sms;  // a grid-stride loop past that
  gmm_bwd_dz_kernel<ACT><<<unsigned(want < most ? want : most), DZ_THREADS, 0, stream>>>(
      static_cast<const uint4*>(dy), static_cast<const uint4*>(z),
      static_cast<uint4*>(dz), n);
  return int(cudaGetLastError());
}

}  // namespace

// dX (E, C, D) and dW (E, D, F) of out = act(x @ w) for the cotangent dy
// (E, C, F), all bf16.  z is the forward's pre-activation (E, C, F) bf16
// and dz scratch of its shape for dY act'(Z), both needed where act is not
// 0 and unused (they may be null) where it is: dZ is dy then.  Returns the
// CUDA error of the launches (0 when every one was accepted).  act: 0 none,
// 1 silu, 2 gelu (tanh form).  D and F must be multiples of 8 and every
// pointer 16-byte aligned (the TMA's rules).
extern "C" int expert_matmul_bwd_bf16(const void* x, const void* w, const void* dy,
                                      const void* z, void* dz, void* dx, void* dw,
                                      int E, int C, int D, int F, int act,
                                      void* stream) {
  if (E < 1 || C < 1 || D < 1 || F < 1 || D % 8 || F % 8 || act < kNone ||
      act > kGelu || (act != kNone && (z == nullptr || dz == nullptr)))
    return int(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
       reinterpret_cast<uintptr_t>(dy) | reinterpret_cast<uintptr_t>(z) |
       reinterpret_cast<uintptr_t>(dz) | reinterpret_cast<uintptr_t>(dx) |
       reinterpret_cast<uintptr_t>(dw)) % 16)
    return int(cudaErrorMisalignedAddress);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* g = act == kNone ? dy : dz;
  int err = 0;
  if (act != kNone) {
    // dZ = dY act'(Z): E C F / 8 words of eight (F is a multiple of 8)
    const long long n = (long long)E * C * F / 8;
    err = act == kSilu ? launch_dz<kSilu>(dy, z, dz, n, s)
                       : launch_dz<kGelu>(dy, z, dz, n, s);
    if (err != 0) return err;
  }
  {
    // dX = dZ W^T: dZ K-major (depth F), W K-major (rows D, depth F)
    CUtensorMap z_map, w_map, o_map;
    if (!make_map(&z_map, g, E, C, F, BM) || !make_map(&w_map, w, E, D, F, BN) ||
        !make_map(&o_map, dx, E, C, D, 64))
      return int(cudaErrorInvalidValue);
    err = launch<false, true, 3, 1>(z_map, w_map, o_map, E, C, D, F, s);
    if (err != 0) return err;
  }
  // dW = X^T dZ: X M-major (rows C of depth, D contiguous), dZ N-major
  CUtensorMap x_map, z_map, o_map;
  if (!make_map(&x_map, x, E, C, D, BK) || !make_map(&z_map, g, E, C, F, BK) ||
      !make_map(&o_map, dw, E, D, F, 64))
    return int(cudaErrorInvalidValue);
  return launch<true, false, 4, 2>(x_map, z_map, o_map, E, D, F, C, s);
}
