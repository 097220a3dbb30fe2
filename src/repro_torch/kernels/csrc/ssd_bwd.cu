// Mamba-2 SSD intra-chunk terms, backward, for the port, in CUDA C++ for
// sm_90a, float32, on Hopper's tensor cores.
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
// fp32 and contiguous, P in {16, 32, 64}, N <= 128 and a multiple of 4
// (TMA's 16-byte rows: the wrapper pads B, C and ghc with zeros), any Q.
//
// What bounds it on the H100: at mamba2-370m's shape (B 2, nc 8, H 32, Q 256,
// P 64, N 128) the least work, counted as chip_smoke._ssd_work counts the
// forward's (causal pairs; the head-free C B^T, (sum_h dS) B and
// (sum_h dS)^T C once per (b, c)), is 9.01 GFLOP: 54.6 us as three TF32
// passes at 495 TFLOP/s, against 127 MB of bytes (38 us).
//
// Measured (scripts/ssd_bwd_timing.py, NVIDIA H100 80GB HBM3, 700.00 W, a
// launch at that shape on a held stream): 0.683-0.689 ms, 8.0 % of the
// bound (the first, plain SIMT version 2.17 ms; the plain version 2.75 ms);
// the tile blocks 0.667 ms of it, the group sums 0.017, the scans 0.006.
// Head groups of 2 instead of 4: 0.826-0.833 ms in the same call.  The
// steps that got it there, each timed against the one before: the three
// sides (1.17 ms); ghc by TMA instead of loads from global memory in the
// fragments (1.10); shared-space loads (LDS, not generic loads with 64-bit
// addresses), TF32 rounding in two integer operations and an even number
// of k8 steps in every product, which let ptxas keep a batch's products in
// flight (0.86); ex2.approx for the decay (0.80); ldmatrix for the row
// fragments and per-thread fragment offsets (0.687).  What holds it back,
// from clock64 sums over a block's phases: an m64n32k8 TF32 product costs
// 75-115 cycles a warpgroup in these loops, about 40 % of the tensor rate
// (an m64n64 variant of C B^T cost no less a FLOP), and the phases between
// products (the elementwise pass, the splits, the TMA waits, the set-up)
// take about 45 % of a block's time, with nothing to overlap them: no
// producer warpgroup, one block an SM (227 KB of shared memory).  ptxas
// (-Xptxas -v, CUDA 12.8) gives ssd_bwd_tiles_kernel 255, 255 and 251
// registers at P 64, 32 and 16, with 16 bytes of spill stores and 40 of
// spill loads at P 64 and none at the others; the scan and sum kernels 32
// registers each.
//
// Design: one launch of tile blocks, then two small launches; every output
// element is written once and every sum is taken in a fixed order, so two
// launches give the same bits (no atomics).
//   1. ssd_bwd_tiles_kernel: a block per (b, c, group of G <= 4 heads, tile
//      of 64 positions, side), launched with the longest walks first.  A
//      block fixes a tile and walks the tiles it pairs with causally, the
//      walked positions as the rows of every score-side tile:
//      - the dB side fixes keys and walks the query tiles at or after them:
//        S = C_j B_t^T and G = gy_j x_t^T, then dS summed over the group's
//        heads in registers before the one product (C_j)^T (sum_h dS) that
//        gives the group's part of dB, and colsum(M) and the direct ddt;
//        then the chunk-state term sum_h ghc_h (x_h o ed_h)^T, summed into
//        the same accumulators;
//      - the dC side fixes queries and walks the key tiles at or before
//        them: B_k C_j^T and x_k gy_j^T, dS summed over the heads, the
//        group's part of dC as (B_k)^T (sum_h dS)^T, and rowsum(M);
//      - the dx side fixes keys: S = C_j B_t^T and W per head, dx^T +=
//        (gy_j)^T W per head; then dx += ed o (ghc^T B_t) and E per head.
//      So each causal C B^T tile is computed three times per (b, c, group)
//      (once a side), G twice per head, and each of dB's, dC's and dx's
//      products once per tile pair (dB and dC once per group, not per head).
//      The dx side is its own block because dx of four heads (64 registers
//      a thread) beside dB's accumulators left no registers for the rest:
//      with both in one block the kernel ran at 255 registers with 5 KB of
//      spills and took 2.16 ms.  The alternative to the dC side, dC as
//      per-key-tile partials in scratch, was not built: its scratch grows
//      with the number of tiles (groups x tiles x Q x N floats) and at Q 500
//      outgrows the per-head dB/dC scratch that this design removes.
//   2. ssd_bwd_scan_kernel: a warp per (b, c, h): dcum from the sides'
//      per-position sums, its reverse cumsum by warp scans over 64-position
//      chunks in order, ddt, and the chunk's part of dA.
//   3. ssd_bwd_sum_kernel: dB and dC summed over the groups in group order,
//      dA summed over (b, c) in order.
//   The scratch holds the groups' dB and dC parts (G times smaller than the
//   per-head parts of the first, plain SIMT version), five vectors per (b,
//   c, h, position) and dA's parts; its size comes from one definition,
//   Scratch, which ssd_bwd_scratch_floats reports to the wrapper.
//
// Inside a tile block: two warpgroups, each owning 32 of the fixed tile's 64
// columns, every product a `wgmma` m64n32k8 in TF32 with fp32 accuracy
// ("3xTF32", as csrc/ssd.cu: v = hi + lo, lo.hi + hi.lo + hi.hi).  TF32
// `wgmma` takes only K-major operands, so:
//   - the walked tiles (C_j or B_k, and gy or x of the walked tile) are A
//     operands only: TMA loads them raw, with the 128-byte swizzle, and the
//     warps build their fragments from there, by rows for S and G and by
//     columns (transposed) for dB, dC and dx;
//   - the fixed tiles are B operands: B_t or C_j is split into hi and lo
//     K-major tiles once per block; x_t or gy_j of a head is split at each
//     step (four heads' would not fit beside the rest);
//   - W and sum_h dS leave the accumulators as the B operands of dx and dB
//     or dC, written by each warpgroup into its own half of a K-major tile,
//     the walked positions of each 8-step in the order (0, 2, 4, 6, 1, 3,
//     5, 7), which the transposed A fragments read without bank conflicts.
//   cum is computed inside the blocks, a tile at a time (a warp's sum of the
//   positions before it, then a warp scan), the same bits in every block.
//   The 64-column sums (colsum(M), the direct ddt, E, rowsum(M)) are reduced
//   across a warp's rows by shuffles each step and across its warps once at
//   the end.  TMA loads are issued as soon as their buffer is free; the
//   walked x or gy is double-buffered.  Each product is a loop at run time,
//   two batches of k8 steps a turn, so that the fragments' addresses are not
//   held in registers across the walk.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int T = 64;            // positions of a tile
constexpr int THREADS = 256;     // two warpgroups
constexpr int MAX_N = 128;
constexpr int MAX_G = 4;         // heads of a group
constexpr int BOX = 32;          // columns of one TMA box (128 bytes)
constexpr int BOX_FLOATS = T * BOX;
constexpr int KB = 2;            // k8 steps of a batch of products in flight
constexpr float LOG2E = 1.4426950408889634f;

__host__ __device__ inline int round_up(int n, int m) { return (n + m - 1) / m * m; }
__host__ __device__ inline int max2(int a, int b) { return a > b ? a : b; }

// Shared memory, in floats from a 1024-byte aligned base: the raw walked tile
// (V: C or B, pn columns, also the fixed tile's raw copy before the walk),
// the raw fixed head tile (Xf: x or gy), two raw walked head tiles (Xv), the
// split fixed tile (F), the split fixed head tile, the staged W or sum_h dS
// (hi and lo each), then per head the scans of the fixed and the walked tile
// and ed, cum_end, each thread's two column sums per head, and six
// mbarriers (V, Xf, Xv 0, Xv 1, ghc 0, ghc 1).  The key sides' ghc of the
// even heads goes into Xs (the dx side, which splits no head tile) or the Xv
// buffers (the dB side, once its walk is done with them), of the odd heads
// into St.
struct Layout {
  int pn, vb, xb;
  int v, xf, xv, fs, xs, st, scan, sums, bars;
  __host__ __device__ Layout(int N, int P) {
    pn = round_up(N, 16);  // an even number of k8 steps
    vb = (pn + BOX - 1) / BOX;
    xb = (P + BOX - 1) / BOX;
    v = 0;
    xf = v + vb * BOX_FLOATS;
    xv = xf + xb * BOX_FLOATS;
    fs = xv + 2 * xb * BOX_FLOATS;
    xs = fs + 2 * T * pn;
    st = xs + max2(2 * T * P, 2 * xb * BOX_FLOATS);  // also ghc (the dx side)
    scan = st + 2 * T * T;
    sums = scan + round_up(5 * MAX_G * T + MAX_G, 4);
    bars = sums + MAX_G * 2 * THREADS;
  }
  __host__ __device__ size_t bytes() const { return sizeof(float) * size_t(bars + 12) + 1024; }
};

// The scratch, in floats: the groups' dB and dC parts (BNC, groups, Q, N),
// then per (b, c, h, position) the dB side's dcum and ddt parts, the dx
// side's E o ed and E exp(cum_end - cum), the dC side's rowsum(M), then per
// (b, c, h) the chunk's part of dA.
struct Scratch {
  long long db, dc, part1, part2, eed, eek, rowm, da, total;
  Scratch(long long BNC, long long H, long long Q, long long N) {
    const long long groups = (H + MAX_G - 1) / MAX_G;
    const long long heads = BNC * H;
    db = 0;
    dc = db + BNC * groups * Q * N;
    part1 = dc + BNC * groups * Q * N;
    part2 = part1 + heads * Q;
    eed = part2 + heads * Q;
    eek = eed + heads * Q;
    rowm = eek + heads * Q;
    da = rowm + heads * Q;
    total = da + heads;
  }
};

// Element (r, c) of a tile of T rows stored as TMA writes boxes of BOX
// columns with the 128-byte swizzle: the box, the row, the 16-byte chunk
// XORed with the row.
__device__ __forceinline__ int swz(int r, int c) {
  return (c / BOX) * BOX_FLOATS + r * BOX + ((((c % BOX) >> 2) ^ (r & 7)) << 2) + (c & 3);
}

// Element (k, f) of a K-major B operand of 64 columns f without a swizzle:
// 8-column core matrices of 4 k (16 bytes a row), 128 bytes apart along f,
// 1024 bytes apart along k.
__device__ __forceinline__ int bop(int k, int f) { return (k >> 2) * (T * 4) + f * 4 + (k & 3); }

// A walked position r (its 8-step's place r & 7) in the K order of the
// staged B operands: (0, 2, 4, 6, 1, 3, 5, 7).
__device__ __forceinline__ int kslot(int r) {
  return (r & ~7) | ((r & 1) << 2) | ((r & 7) >> 1);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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

__device__ __forceinline__ void tma_load(float* dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// A tile of T rows from row0 of slice `outer`, `boxes` boxes of BOX columns,
// into dst; zero past the tensor.
__device__ __forceinline__ void load_tile(float* dst, const CUtensorMap* map, uint32_t bar,
                                          int boxes, int row0, int outer) {
  mbar_expect_tx(bar, boxes * BOX_FLOATS * 4);
  for (int b = 0; b < boxes; ++b) tma_load(dst + b * BOX_FLOATS, map, bar, BOX * b, row0, outer);
}

// v = hi + lo exactly, hi = v rounded to TF32 (to nearest, ties away from
// zero: cvt.rna.tf32.f32's bits for finite v, in two integer operations);
// the tensor cores read lo's top 11 bits, so v is carried to 2^-22 of itself.
__device__ inline void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// Four 8 x 8 b16 matrices from shared memory, lane L giving the 16-byte
// row of matrix L / 8: as TF32, matrix i's element (row r, column c < 4)
// lands in lane 4 r + c's r[i], the layout of a TF32 A fragment.
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// A wgmma shared-memory descriptor without a swizzle: start address, the
// byte offsets between core matrices along K (leading) and along M or N
// (stride).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Every committed group of products but the last N has completed.
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

// D (64 x 32) += A (64 x 8, tf32 registers) . B (8 x 32, shared, K-major).
__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint32_t a0, uint32_t a1,
                                          uint32_t a2, uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

// d += A . B in fp32 accuracy: lo.hi, hi.lo, then hi.hi.
__device__ __forceinline__ void wgmma3(float (&d)[16], const uint32_t (&ahi)[4],
                                       const uint32_t (&alo)[4], uint64_t bhi,
                                       uint64_t blo) {
  wgmma_n32(d, alo[0], alo[1], alo[2], alo[3], bhi);
  wgmma_n32(d, ahi[0], ahi[1], ahi[2], ahi[3], blo);
  wgmma_n32(d, ahi[0], ahi[1], ahi[2], ahi[3], bhi);
}

// d (64 x 32) += A . B over `ksteps` k8 steps (a multiple of KB), B the
// K-major operand at descriptors bhi / blo (k8 steps 2048 bytes apart), A's
// fragments of a batch of KB k8 steps built by build(batch, hi, lo) while
// the batch before runs.  A loop at run time, two batches a turn: the fragments' addresses
// are computed as the batches come, not held across the caller's loops.
template <class Build>
__device__ __forceinline__ void mma(float (&d)[16], int ksteps, uint64_t bhi, uint64_t blo,
                                    Build build) {
  uint32_t ahi[2][KB][4], alo[2][KB][4];
  const int nb = ksteps / KB;
  auto issue = [&](int b, const uint32_t (&hi)[KB][4], const uint32_t (&lo)[KB][4]) {
    wgmma_fence();
#pragma unroll
    for (int u = 0; u < KB; ++u) {
      const uint64_t off = uint64_t((b * KB + u) * 2048) >> 4;
      wgmma3(d, hi[u], lo[u], bhi + off, blo + off);
    }
    wgmma_commit();
    wgmma_wait<1>();
  };
  build(0, ahi[0], alo[0]);
  fence_regs(d);
#pragma unroll 1
  for (int b = 0; b < nb; b += 2) {
    issue(b, ahi[0], alo[0]);
    if (b + 1 < nb) {
      build(b + 1, ahi[1], alo[1]);
      issue(b + 1, ahi[1], alo[1]);
      if (b + 2 < nb) build(b + 2, ahi[0], alo[0]);
    }
  }
  wgmma_wait<0>();
  fence_regs(d);
}

// Rows 0..63 of a raw tile (K columns from the swizzled boxes), scaled by
// scale[row] where given, into a K-major B operand of 64 columns: hi at dst,
// lo at dst + 64 K.  All threads of the block take part.
__device__ inline void split_rows(const float* raw, float* dst, int K, const float* scale) {
  const int chunks = T * K / 4;
  for (int e = threadIdx.x; e < chunks; e += THREADS) {
    const int f = e & (T - 1), kq = e / T;
    float4 v = *reinterpret_cast<const float4*>(raw + swz(f, 4 * kq));
    if (scale != nullptr) {
      const float s = scale[f];
      v.x *= s;
      v.y *= s;
      v.z *= s;
      v.w *= s;
    }
    uint4 hi, lo;
    split(v.x, hi.x, lo.x);
    split(v.y, hi.y, lo.y);
    split(v.z, hi.z, lo.z);
    split(v.w, hi.w, lo.w);
    const int at = kq * (T * 4) + f * 4;
    *reinterpret_cast<uint4*>(dst + at) = hi;
    *reinterpret_cast<uint4*>(dst + T * K + at) = lo;
  }
  fence_async_smem();  // the products read these through the async proxy
}

// The 8 column partials v[2 i + b] of a thread (lane = 4 g + t4) summed over
// the warp's 8 values of g; lane g keeps column index g (i = g / 2, b = g & 1).
__device__ __forceinline__ float reduce_scatter8(const float (&v)[8], int lane) {
  const bool h2 = lane & 16, h1 = lane & 8, h0 = lane & 4;
  float u[4], w[2];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const float send = h2 ? v[m] : v[m + 4];
    const float keep = h2 ? v[m + 4] : v[m];
    u[m] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
  }
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const float send = h1 ? u[m] : u[m + 2];
    const float keep = h1 ? u[m + 2] : u[m];
    w[m] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
  }
  const float send = h0 ? w[0] : w[1];
  const float keep = h0 ? w[1] : w[0];
  return keep + __shfl_xor_sync(0xffffffffu, send, 4);
}

// 2^x by the special function unit (ex2.approx: a relative error of about
// 2^-22, far inside the gradients' tolerance; 0 for x = -inf).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The lane that holds column c (< 32) of a warpgroup's half after
// reduce_scatter8.
__device__ __forceinline__ int lane_of_col(int c) {
  const int g = 2 * (c / 8) + (c & 1);
  return 4 * g + (c % 8) / 2;
}

// cum and dt of the positions tile * T ... tile * T + 63 of one head, by one
// warp: the sum of -a dt over the positions before the tile (each lane's
// strided run, then a butterfly), then a scan of the tile (two positions a
// lane).  The same bits in every block that asks, which the sides need:
// rowsum(M) (the dC side) and colsum(M) (the dB side) nearly cancel in da,
// and a prefix carried along each side's walk instead put dA 2.1e-4 of its
// largest magnitude from the plain version.  Past Q, dt is 0 and cum keeps
// its last value.
__device__ inline void tile_cum(const float* dt, float a, int tile, int Q, float* cum_out,
                                float* dt_out, int lane) {
  float pre = 0.f;
  for (int q = lane; q < tile * T; q += 32) pre += dt[q] * (-a);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) pre += __shfl_xor_sync(0xffffffffu, pre, off);
  const int q0 = tile * T + 2 * lane;
  const float d0 = q0 < Q ? dt[q0] : 0.f;
  const float d1 = q0 + 1 < Q ? dt[q0 + 1] : 0.f;
  const float v0 = d0 * (-a);
  const float v1 = v0 + d1 * (-a);
  float incl = v1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += up;
  }
  float before = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) before = 0.f;
  cum_out[2 * lane] = pre + (before + v0);
  cum_out[2 * lane + 1] = pre + (before + v1);
  dt_out[2 * lane] = d0;
  dt_out[2 * lane + 1] = d1;
}

struct Maps {
  // x, gy (P, Q, B nc H); B, C (N, Q, B nc); ghc (P, N, B nc H)
  const CUtensorMap *x, *gy, *b, *c, *ghc;
};

struct Args {
  const float *x, *dt, *A, *ghc, *gdec;
  float *dx, *dbp, *dcp, *part1, *part2, *eed, *eek, *rowm;
  int H, Q, N, G;
};

// The sides of a tile block (see the design note).
enum Side { DX_SIDE, DB_SIDE, DC_SIDE };

// One tile block of side SIDE.
template <int P, int SIDE>
__device__ __forceinline__ void tile_block(const Maps& m, const Args& g_, float* base, int bc,
                                           int grp, int f) {
  constexpr bool DX = SIDE == DX_SIDE, DB = SIDE == DB_SIDE, DC = SIDE == DC_SIDE;
  constexpr bool KEYS = !DC;  // the fixed tile holds keys
  const int H = g_.H, Q = g_.Q, N = g_.N, G = g_.G;
  const Layout L(N, P);
  const int pn = L.pn, nt = (Q + T - 1) / T;
  float* const bufV = base + L.v;
  float* const bufXf = base + L.xf;
  float* const bufXv0 = base + L.xv;
  float* const Fs = base + L.fs;
  float* const Xs = base + L.xs;
  float* const St = base + L.st;
  float* const cumF = base + L.scan;    // [MAX_G][T]
  float* const dtF = cumF + MAX_G * T;
  float* const cumV = dtF + MAX_G * T;
  float* const dtV = cumV + MAX_G * T;
  float* const edF = dtV + MAX_G * T;   // ed of the fixed keys
  float* const cumEnd = edF + MAX_G * T;
  // this thread's column sums: colsum(M) or rowsum(M) (E on the dx side),
  // and the direct ddt, per head, [head][2][warp][lane]
  float* const colS = base + L.sums;
  const uint32_t bars = smem_u32(base + L.bars);  // V, Xf, Xv 0, Xv 1, ghc 0, ghc 1
  const uint32_t bV = bars, bXf = bars + 8;

  const int groups = (H + G - 1) / G;
  const int h_first = grp * G;
  const int gh = min(G, H - h_first);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wg = warp >> 2;
  const int gq = lane >> 2, t4 = lane & 3;
  const int R0 = 16 * (warp & 3) + gq;  // fragment rows R0, R0 + 8
  const int steps = KEYS ? nt - f : f + 1;
  const int total_xv = steps * gh;
  // the fixed head tile: x of the fixed keys (the dB side: G, then the
  // chunk-state term) or gy of the fixed queries (the dC side: G)
  const int total_xf = DX ? 0 : total_xv + (DB ? gh : 0);
  const CUtensorMap* mapF = KEYS ? m.b : m.c;
  const CUtensorMap* mapV = KEYS ? m.c : m.b;
  const CUtensorMap* mapXf = KEYS ? m.x : m.gy;
  const CUtensorMap* mapXv = KEYS ? m.gy : m.x;
  const int head0 = bc * H + h_first;  // the group's first (b, c, h)
  auto walked = [&](int s) { return KEYS ? f + s : s; };
  auto bufXv = [&](int n) { return bufXv0 + (n & 1) * L.xb * BOX_FLOATS; };
  auto load_xv = [&](int n) {  // n = s * gh + head
    load_tile(bufXv(n), mapXv, bars + 16 + 8 * (n & 1), L.xb, walked(n / gh) * T,
              head0 + n % gh);
  };
  // the next fixed head tile, once bufXf is free
  auto next_xf = [&](int n) {
    if (tid == 0 && n + 1 < total_xf)
      load_tile(bufXf, mapXf, bXf, L.xb, f * T, head0 + (n + 1) % gh);
  };
  // the key sides' ghc of head hh (rows n, in 64-row boxes of xb column
  // boxes), by TMA, two heads in flight: even heads into Xs (the dx side,
  // from the start) or the Xv buffers (the dB side, from its last step's dB
  // product), odd heads into St after the walk
  const int nrb = (pn + T - 1) / T;
  auto gbuf = [&](int hh) { return hh & 1 ? St : DX ? Xs : bufXv0; };
  auto load_ghc = [&](int hh) {
    const uint32_t bar = bars + 32 + 8 * (hh & 1);
    mbar_expect_tx(bar, nrb * L.xb * BOX_FLOATS * 4);
    for (int rb = 0; rb < nrb; ++rb)
      for (int cb = 0; cb < L.xb; ++cb)
        tma_load(gbuf(hh) + (rb * L.xb + cb) * BOX_FLOATS, m.ghc, bar, BOX * cb, T * rb,
                 head0 + hh);
  };

  if (tid == 0) {
    for (int i = 0; i < 6; ++i) mbar_init(bars + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    load_tile(bufV, mapF, bV, L.vb, f * T, bc);  // the fixed tile, raw
    if (total_xf > 0) load_tile(bufXf, mapXf, bXf, L.xb, f * T, head0);
    load_xv(0);
    if (DX) load_ghc(0);
  }
  if (warp < gh) {
    const float* dth = g_.dt + size_t(head0 + warp) * Q;
    const float a = g_.A[h_first + warp];
    if (KEYS) {
      tile_cum(dth, a, nt - 1, Q, cumV + warp * T, dtV + warp * T, lane);
      __syncwarp();
      if (lane == 0) cumEnd[warp] = cumV[warp * T + (Q - 1) % T];
    }
    tile_cum(dth, a, f, Q, cumF + warp * T, dtF + warp * T, lane);
  }
  __syncthreads();
  if (KEYS) {
    for (int i = tid; i < gh * T; i += THREADS) {
      const int hh = i / T, c = i % T;
      edF[i] = f * T + c < Q ? expf(cumEnd[hh] - cumF[i]) * dtF[i] : 0.f;
    }
  }
  mbar_wait(bV, 0);
  split_rows(bufV, Fs, pn, nullptr);
  __syncthreads();  // F split, bufV free
  if (tid == 0) load_tile(bufV, mapV, bV, L.vb, walked(0) * T, bc);

  // descriptors of this warpgroup's 32 columns of each B operand
  const uint32_t col_off = wg * 4 * 128;
  const uint64_t fs_hi = make_desc(smem_u32(Fs) + col_off, 1024, 128);
  const uint64_t fs_lo = make_desc(smem_u32(Fs + T * pn) + col_off, 1024, 128);
  const uint64_t xs_hi = make_desc(smem_u32(Xs) + col_off, 1024, 128);
  const uint64_t xs_lo = make_desc(smem_u32(Xs + T * P) + col_off, 1024, 128);
  const uint64_t st_hi = make_desc(smem_u32(St) + col_off, 1024, 128);
  const uint64_t st_lo = make_desc(smem_u32(St + T * T) + col_off, 1024, 128);

  // A fragments of rows R0, R0 + 8 of a raw tile (K = its columns): one
  // ldmatrix a k8 step, lane L giving row 16 (warp & 3) + L % 16 at the
  // 16-byte chunk 2 s + L / 16 (swizzled as swz places it)
  const int lm_row = 16 * (warp & 3) + (lane & 15);
  auto rows_of = [&](const float* raw) {
    const uint32_t at = smem_u32(raw) + 4 * (lm_row * BOX);
    return [=](int b, uint32_t (&hi)[KB][4], uint32_t (&lo)[KB][4]) {
#pragma unroll
      for (int u = 0; u < KB; ++u) {
        const int chunk = 2 * (b * KB + u) + (lane >> 4);
        uint32_t r[4];
        ldsm_x4(at + 4 * ((chunk >> 3) * BOX_FLOATS + (((chunk & 7) ^ (lane & 7)) << 2)), r);
#pragma unroll
        for (int i = 0; i < 4; ++i) split(__uint_as_float(r[i]), hi[u][i], lo[u][i]);
      }
    };
  };
  // A fragments of columns 64 mt + R0, + 8 of a raw tile (K = its rows in
  // kslot order: rows 8 s + 2 t4 and + 1), zero at or past `lim` columns;
  // swz of (8 s + 2 t4 + j, c) is 256 s plus a constant of the thread
  auto cols_of = [&](const float* raw, int mt, int lim) {
    int at[2][2];
    bool ok[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = 64 * mt + R0 + 8 * h;
      ok[h] = c < lim;
#pragma unroll
      for (int j = 0; j < 2; ++j)
        at[h][j] = (c / BOX) * BOX_FLOATS + (2 * t4 + j) * BOX +
                   ((((c % BOX) >> 2) ^ (2 * t4 + j)) << 2) + (c & 3);
    }
    return [=](int b, uint32_t (&hi)[KB][4], uint32_t (&lo)[KB][4]) {
#pragma unroll
      for (int u = 0; u < KB; ++u) {
        const float* r = raw + 8 * BOX * (b * KB + u);
        split(ok[0] ? r[at[0][0]] : 0.f, hi[u][0], lo[u][0]);
        split(ok[1] ? r[at[1][0]] : 0.f, hi[u][1], lo[u][1]);
        split(ok[0] ? r[at[0][1]] : 0.f, hi[u][2], lo[u][2]);
        split(ok[1] ? r[at[1][1]] : 0.f, hi[u][3], lo[u][3]);
      }
    };
  };
  // this thread's accumulator elements into the staged B operand
  auto stage = [&](const float (&acc)[16]) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = R0 + 8 * (e >> 1);
        const int c = 32 * wg + 8 * i + 2 * t4 + (e & 1);
        uint32_t hi, lo;
        split(acc[4 * i + e], hi, lo);
        const int at = bop(kslot(r), c);
        reinterpret_cast<uint32_t*>(St)[at] = hi;
        reinterpret_cast<uint32_t*>(St)[T * T + at] = lo;
      }
    fence_async_smem();
    named_sync(1 + wg, 128);
  };

  const int MT = pn > T ? 2 : 1;  // 64-row tiles of the N-wide product
  float o1[2][16] = {};           // dB^T or dC^T (the dB and dC sides)
  float dx[MAX_G][16] = {};       // dx^T per head (the dx side)
  float colE[MAX_G] = {};         // E per head (the dx side)
  for (int i = tid; i < MAX_G * 2 * THREADS; i += THREADS) colS[i] = 0.f;

  for (int s = 0; s < steps; ++s) {
    const int v = walked(s);
    if (warp < gh)
      tile_cum(g_.dt + size_t(head0 + warp) * Q, g_.A[h_first + warp], v, Q,
               cumV + warp * T, dtV + warp * T, lane);
    __syncthreads();
    mbar_wait(bV, (1 + s) & 1);
    float sacc[16] = {};
    mma(sacc, pn / 8, fs_hi, fs_lo, rows_of(bufV));
    float dss[16] = {};
    // the head's walked tile, and the decay L of element (i, e), 0 off the
    // causal pairs
    auto walked_head = [&](int hh) {
      const int n = s * gh + hh;
      mbar_wait(bars + 16 + 8 * (n & 1), (n >> 1) & 1);
      if (tid == 0 && n + 1 < total_xv) load_xv(n + 1);
      return bufXv(n);
    };
    auto decay = [&](int hh, int i, int e) {
      const int r = R0 + 8 * (e >> 1);
      const int c = 32 * wg + 8 * i + 2 * t4 + (e & 1);
      const float ex = exp2_approx((KEYS ? cumV[hh * T + r] - cumF[hh * T + c]
                                         : cumF[hh * T + c] - cumV[hh * T + r]) * LOG2E);
      const int pr = v * T + r, pc = f * T + c;  // walked, fixed positions
      const int q = KEYS ? pr : pc, k = KEYS ? pc : pr;
      return q < Q && k <= q ? ex : 0.f;
    };
    if constexpr (DX) {
#pragma unroll
      for (int hh = 0; hh < MAX_G; ++hh) {
        if (hh >= gh) break;
        const float* xv = walked_head(hh);
        float w[16];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            w[4 * i + e] = sacc[4 * i + e] * decay(hh, i, e) *
                           dtF[hh * T + 32 * wg + 8 * i + 2 * t4 + (e & 1)];
        stage(w);  // W
        mma(dx[hh], T / 8, st_hi, st_lo, cols_of(xv, 0, P));
        __syncthreads();  // bufXv(n) and St free
      }
    } else {
#pragma unroll 1
      for (int hh = 0; hh < gh; ++hh) {
        const int n = s * gh + hh;
        const float* xv = walked_head(hh);
        mbar_wait(bXf, n & 1);
        split_rows(bufXf, Xs, P, nullptr);
        __syncthreads();  // Xf split, bufXf free
        next_xf(n);
        float gacc[16] = {};
        mma(gacc, P / 8, xs_hi, xs_lo, rows_of(xv));
        // dS summed over the heads, and the column sums of this head
        float pm[8] = {}, pd[8] = {};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float lq = decay(hh, i, e);
            const float dtk = KEYS ? dtF[hh * T + 32 * wg + 8 * i + 2 * t4 + (e & 1)]
                                   : dtV[hh * T + R0 + 8 * (e >> 1)];
            const float sl = sacc[4 * i + e] * lq;
            const float gg = gacc[4 * i + e];
            dss[4 * i + e] += gg * lq * dtk;
            pm[2 * i + (e & 1)] += gg * (sl * dtk);
            pd[2 * i + (e & 1)] += gg * sl;
          }
        float* mine = colS + hh * 2 * THREADS + tid;
        mine[0] += reduce_scatter8(pm, lane);
        if constexpr (DB) mine[THREADS] += reduce_scatter8(pd, lane);
        __syncthreads();  // bufXv(n) and Xs free
      }
    }
    if constexpr (!DX) {
      if (DB && tid == 0 && s + 1 == steps) load_ghc(0);  // the Xv buffers are free
      stage(dss);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        if (mt < MT) mma(o1[mt], T / 8, st_hi, st_lo, cols_of(bufV, mt, pn));
      __syncthreads();  // St free
    }
    if (tid == 0 && s + 1 < steps) load_tile(bufV, mapV, bV, L.vb, walked(s + 1) * T, bc);
  }

  // the chunk-state terms of the fixed keys: A fragments of ghc^T (rows p,
  // K = n) and of ghc (rows 64 mt + n, K = p), from its buffer
  // (n, p) lies at (n / 64) xb boxes + swz(n % 64, p); for n = 8 s + t4 +
  // 4 j that is (s / 8) xb boxes + 256 (s % 8) plus a constant of the thread
  auto ghc_t = [&](const float* g) {
    int at[2][2];
    bool ok[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = R0 + 8 * h;
      ok[h] = p < P;
#pragma unroll
      for (int j = 0; j < 2; ++j)
        at[h][j] = (p / BOX) * BOX_FLOATS + (t4 + 4 * j) * BOX +
                   ((((p % BOX) >> 2) ^ (t4 + 4 * j)) << 2) + (p & 3);
    }
    const int rbox = L.xb * BOX_FLOATS;
    return [=](int b, uint32_t (&hi)[KB][4], uint32_t (&lo)[KB][4]) {
#pragma unroll
      for (int u = 0; u < KB; ++u) {
        const int ks = b * KB + u;
        const float* r = g + (ks >> 3) * rbox + 8 * BOX * (ks & 7);
        split(ok[0] ? r[at[0][0]] : 0.f, hi[u][0], lo[u][0]);
        split(ok[1] ? r[at[1][0]] : 0.f, hi[u][1], lo[u][1]);
        split(ok[0] ? r[at[0][1]] : 0.f, hi[u][2], lo[u][2]);
        split(ok[1] ? r[at[1][1]] : 0.f, hi[u][3], lo[u][3]);
      }
    };
  };
  // rows 64 mt ... of ghc form a raw tile of their own
  auto ghc_rows = [&](const float* g, int mt) { return rows_of(g + mt * L.xb * BOX_FLOATS); };
  if (KEYS && tid == 0 && gh > 1) load_ghc(1);  // St is free after the walk
  if constexpr (DX) {
    // u^T = ghc^T B_t^T (rows p); dx += ed o u, E = sum_p x o u with x of
    // this thread's elements loaded before the product
#pragma unroll
    for (int hh = 0; hh < MAX_G; ++hh) {
      if (hh >= gh) break;
      const float* ed = edF + hh * T;
      const float* x_h = g_.x + size_t(head0 + hh) * Q * P;
      float xk[16];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = R0 + 8 * (e >> 1);
          const int pos = f * T + 32 * wg + 8 * i + 2 * t4 + (e & 1);
          xk[4 * i + e] = p < P && pos < Q ? __ldg(x_h + size_t(pos) * P + p) : 0.f;
        }
      mbar_wait(bars + 32 + 8 * (hh & 1), (hh >> 1) & 1);
      float u[16] = {};
      mma(u, pn / 8, fs_hi, fs_lo, ghc_t(gbuf(hh)));
      float pe[8] = {};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 32 * wg + 8 * i + 2 * t4 + (e & 1);
          dx[hh][4 * i + e] += ed[c] * u[4 * i + e];
          pe[2 * i + (e & 1)] += u[4 * i + e] * xk[4 * i + e];
        }
      colE[hh] = reduce_scatter8(pe, lane);
      __syncthreads();  // this head's ghc buffer free
      if (tid == 0 && hh + 2 < gh) load_ghc(hh + 2);
    }
  } else if constexpr (DB) {
    // dB^T += ghc (x o ed)^T (rows n, K = p)
#pragma unroll 1
    for (int hh = 0; hh < gh; ++hh) {
      const int n = total_xv + hh;
      mbar_wait(bars + 32 + 8 * (hh & 1), (hh >> 1) & 1);
      mbar_wait(bXf, n & 1);
      split_rows(bufXf, Xs, P, edF + hh * T);
      __syncthreads();  // Xs ready, bufXf free
      next_xf(n);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        if (mt < MT) mma(o1[mt], P / 8, xs_hi, xs_lo, ghc_rows(gbuf(hh), mt));
      __syncthreads();  // Xs and this head's ghc buffer free
      if (tid == 0 && hh + 2 < gh) load_ghc(hh + 2);
    }
  }

  // ---- the outputs: dx, or the group's dB or dC part; the column sums
  float* part = (DB ? g_.dbp : g_.dcp) + (size_t(bc) * groups + grp) * Q * N;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = R0 + 8 * (e >> 1);
      const int pos = f * T + 32 * wg + 8 * i + 2 * t4 + (e & 1);
      if (pos >= Q) continue;
      if constexpr (DX) {
#pragma unroll
        for (int hh = 0; hh < MAX_G; ++hh)
          if (hh < gh && r < P) g_.dx[(size_t(head0 + hh) * Q + pos) * P + r] = dx[hh][4 * i + e];
      } else {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          if (mt < MT && 64 * mt + r < N) part[size_t(pos) * N + 64 * mt + r] = o1[mt][4 * i + e];
      }
    }
  if constexpr (DX) {
#pragma unroll
    for (int hh = 0; hh < MAX_G; ++hh)
      if (hh < gh) colS[hh * 2 * THREADS + tid] = colE[hh];
  }
  __syncthreads();
  for (int i = tid; i < gh * T; i += THREADS) {
    const int hh = i / T, c = i % T, pos = f * T + c;
    if (pos >= Q) continue;
    const int half = c / 32, ln = lane_of_col(c % 32);
    float sums[2];
#pragma unroll
    for (int qn = 0; qn < 2; ++qn) {  // the warps of the column's warpgroup, in order
      const float* at = colS + (hh * 2 + qn) * THREADS + 4 * half * 32 + ln;
      sums[qn] = ((at[0] + at[32]) + at[64]) + at[96];
    }
    const size_t at = size_t(head0 + hh) * Q + pos;
    if constexpr (DX) {  // sums[0] is E
      const float ek = expf(cumEnd[hh] - cumF[i]);
      g_.eed[at] = sums[0] * ek * dtF[i];
      g_.eek[at] = sums[0] * ek;
    } else if constexpr (DB) {
      g_.part1[at] = g_.gdec[at] * expf(cumF[i]) - sums[0];
      g_.part2[at] = sums[1];
    } else {
      g_.rowm[at] = sums[0];
    }
  }
}

// Blocks in order of walk length, longest first: level l holds the key
// sides' blocks of key tile l and the dC side's of query tile nt - 1 - l.
template <int P>
__global__ void __launch_bounds__(THREADS, 1)
ssd_bwd_tiles_kernel(const __grid_constant__ CUtensorMap x_map,
                     const __grid_constant__ CUtensorMap gy_map,
                     const __grid_constant__ CUtensorMap b_map,
                     const __grid_constant__ CUtensorMap c_map,
                     const __grid_constant__ CUtensorMap ghc_map, const Args args, int BNC) {
  // aligned to 1024 bytes by pointer arithmetic on the shared array, so that
  // the compiler keeps every pointer in the shared space (LDS and STS, not
  // generic loads with 64-bit addresses)
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  float* const base = smem + ((1024u - (smem_u32(smem) & 1023u)) & 1023u) / 4;
  const int groups = (args.H + args.G - 1) / args.G;
  const int nt = (args.Q + T - 1) / T;
  const int per_level = BNC * groups;
  const int level = blockIdx.x / (3 * per_level);
  int idx = blockIdx.x % (3 * per_level);
  const int side = idx / per_level;
  idx %= per_level;
  const Maps m{&x_map, &gy_map, &b_map, &c_map, &ghc_map};
  const int bc = idx / groups, grp = idx % groups;
  if (side == 0)
    tile_block<P, DB_SIDE>(m, args, base, bc, grp, level);
  else if (side == 1)
    tile_block<P, DC_SIDE>(m, args, base, bc, grp, nt - 1 - level);
  else
    tile_block<P, DX_SIDE>(m, args, base, bc, grp, level);
}

// A warp per (b, c, h): dcum = the dB side's part + rowsum(M) - E o ed
// (+ sum E ed at the last position), its reverse cumsum da in 64-position
// chunks from the end, ddt = the direct parts - A da, and -sum dt da.
__global__ void ssd_bwd_scan_kernel(const float* __restrict__ dt, const float* __restrict__ A,
                                    const float* __restrict__ part1,
                                    const float* __restrict__ part2,
                                    const float* __restrict__ eed,
                                    const float* __restrict__ eek,
                                    const float* __restrict__ rowm, float* __restrict__ ddt,
                                    float* __restrict__ da_part, int heads, int H, int Q) {
  const int head = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (head >= heads) return;
  const size_t base = size_t(head) * Q;
  const float a = A[head % H];
  float end = 0.f;
  for (int k = lane; k < Q; k += 32) end += eed[base + k];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) end += __shfl_xor_sync(0xffffffffu, end, off);
  auto dcum = [&](int k) {
    return k < Q ? (part1[base + k] + rowm[base + k]) - eed[base + k] + (k == Q - 1 ? end : 0.f)
                 : 0.f;
  };
  float carry = 0.f, dA = 0.f;
  for (int chunk = (Q - 1) / T; chunk >= 0; --chunk) {
    const int k0 = chunk * T + 2 * lane, k1 = k0 + 1;
    const float c0 = dcum(k0), c1 = dcum(k1);
    const float pair = c0 + c1;
    float suffix = pair;  // over lanes >= this one
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float down = __shfl_down_sync(0xffffffffu, suffix, off);
      if (lane + off < 32) suffix += down;
    }
    float after = __shfl_down_sync(0xffffffffu, suffix, 1);
    if (lane == 31) after = 0.f;
    const float da1 = carry + (after + c1);
    const float da0 = da1 + c0;
    if (k0 < Q) {
      ddt[base + k0] = (part2[base + k0] + eek[base + k0]) - a * da0;
      dA -= dt[base + k0] * da0;
    }
    if (k1 < Q) {
      ddt[base + k1] = (part2[base + k1] + eek[base + k1]) - a * da1;
      dA -= dt[base + k1] * da1;
    }
    carry += __shfl_sync(0xffffffffu, suffix, 0);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) dA += __shfl_xor_sync(0xffffffffu, dA, off);
  if (lane == 0) da_part[head] = dA;
}

// dB and dC summed over the groups in group order; dA over (b, c) in order.
__global__ void ssd_bwd_sum_kernel(const float* __restrict__ dbp, const float* __restrict__ dcp,
                                   const float* __restrict__ da_part, float* __restrict__ dB,
                                   float* __restrict__ dC, float* __restrict__ dA, int BNC,
                                   int groups, int H, int QN) {
  const size_t total = size_t(BNC) * QN;
  for (size_t e = blockIdx.x * size_t(blockDim.x) + threadIdx.x; e < total;
       e += size_t(gridDim.x) * blockDim.x) {
    const size_t bc = e / QN, rest = e % QN;
    float sb = 0.f, sc = 0.f;
    for (int g = 0; g < groups; ++g) {
      sb += dbp[(bc * groups + g) * QN + rest];
      sc += dcp[(bc * groups + g) * QN + rest];
    }
    dB[e] = sb;
    dC[e] = sc;
  }
  if (blockIdx.x == 0) {
    for (int h = threadIdx.x; h < H; h += blockDim.x) {
      float s = 0.f;
      for (int bc = 0; bc < BNC; ++bc) s += da_part[size_t(bc) * H + h];
      dA[h] = s;
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's entry-point query, without
// linking libcuda.
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

// A TMA map of the contiguous float32 tensor (outer, rows, cols) at ptr
// whose box is T rows of BOX columns of one outer index, with the 128-byte
// swizzle; zero past the tensor.
bool make_map(CUtensorMap* map, const void* ptr, int outer, int rows, int cols) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {cuuint64_t(cols), cuuint64_t(rows), cuuint64_t(outer)};
  const cuuint64_t strides[2] = {cuuint64_t(cols) * 4, cuuint64_t(rows) * cols * 4};
  const cuuint32_t box[3] = {cuuint32_t(BOX), cuuint32_t(T), 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr),
                dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int P>
int launch(const float* x, const float* Bm, const float* Cm, const float* dt, const float* A,
           const float* gy, const float* ghc, const float* gdec, float* dx, float* dB,
           float* dC, float* ddt, float* dA, float* scratch, int Bsz, int nc, int H, int Q,
           int N, cudaStream_t stream) {
  int device = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return int(err);
  const size_t smem = Layout(N, P).bytes();
  if (smem > size_t(max_smem)) return int(cudaErrorInvalidValue);
  const int BNC = Bsz * nc;
  const int G = H < MAX_G ? H : MAX_G;
  const int groups = (H + G - 1) / G;
  const int nt = (Q + T - 1) / T;
  CUtensorMap x_map, gy_map, b_map, c_map, ghc_map;
  if (!make_map(&x_map, x, BNC * H, Q, P) || !make_map(&gy_map, gy, BNC * H, Q, P) ||
      !make_map(&b_map, Bm, BNC, Q, N) || !make_map(&c_map, Cm, BNC, Q, N) ||
      !make_map(&ghc_map, ghc, BNC * H, N, P))
    return int(cudaErrorInvalidValue);
  const Scratch sc(BNC, H, Q, N);
  const Args args{x, dt, A, ghc, gdec, dx, scratch + sc.db, scratch + sc.dc,
                  scratch + sc.part1, scratch + sc.part2, scratch + sc.eed,
                  scratch + sc.eek, scratch + sc.rowm, H, Q, N, G};
  err = cudaFuncSetAttribute(ssd_bwd_tiles_kernel<P>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const long long blocks = 3LL * nt * BNC * groups;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidConfiguration);
  ssd_bwd_tiles_kernel<P><<<unsigned(blocks), THREADS, smem, stream>>>(
      x_map, gy_map, b_map, c_map, ghc_map, args, BNC);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const int heads = BNC * H;
  ssd_bwd_scan_kernel<<<(heads + 7) / 8, 256, 0, stream>>>(
      dt, A, scratch + sc.part1, scratch + sc.part2, scratch + sc.eed, scratch + sc.eek,
      scratch + sc.rowm, ddt, scratch + sc.da, heads, H, Q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  ssd_bwd_sum_kernel<<<1024, 256, 0, stream>>>(scratch + sc.db, scratch + sc.dc,
                                               scratch + sc.da, dB, dC, dA, BNC, groups, H,
                                               Q * N);
  return int(cudaGetLastError());
}

}  // namespace

// Writes the floats of scratch ssd_intra_chunk_bwd_f32 needs to *out; returns
// a CUDA error code (0, or invalid value for a shape it does not take).
extern "C" int ssd_bwd_scratch_floats(int Bsz, int nc, int H, int Q, int N, long long* out) {
  if (Bsz < 0 || nc < 0 || H < 1 || Q < 1 || N < 1) return int(cudaErrorInvalidValue);
  *out = Scratch((long long)Bsz * nc, H, Q, N).total;
  return 0;
}

// Returns the CUDA error of the launches (0 when all were accepted).  gy, ghc
// (B, nc, H, N, P) and gdec are the cotangents of y, the chunk states and the
// decay; dx, dB, dC, ddt and dA receive the gradients; scratch holds
// ssd_bwd_scratch_floats(...) floats.  P must be 16, 32 or 64, N at most 128
// and a multiple of 4.
extern "C" int ssd_intra_chunk_bwd_f32(const void* x, const void* Bm, const void* Cm,
                                       const void* dt, const void* A, const void* gy,
                                       const void* ghc, const void* gdec, void* dx,
                                       void* dB, void* dC, void* ddt, void* dA,
                                       void* scratch, int Bsz, int nc, int H, int Q,
                                       int P, int N, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N < 1 || N > MAX_N || N % 4 != 0 || Q < 1 || H < 1) return int(cudaErrorInvalidValue);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto w = [](void* p) { return static_cast<float*>(p); };
  switch (P) {
    case 16:
      return launch<16>(f(x), f(Bm), f(Cm), f(dt), f(A), f(gy), f(ghc), f(gdec), w(dx),
                        w(dB), w(dC), w(ddt), w(dA), w(scratch), Bsz, nc, H, Q, N, s);
    case 32:
      return launch<32>(f(x), f(Bm), f(Cm), f(dt), f(A), f(gy), f(ghc), f(gdec), w(dx),
                        w(dB), w(dC), w(ddt), w(dA), w(scratch), Bsz, nc, H, Q, N, s);
    case 64:
      return launch<64>(f(x), f(Bm), f(Cm), f(dt), f(A), f(gy), f(ghc), f(gdec), w(dx),
                        w(dB), w(dC), w(ddt), w(dA), w(scratch), Bsz, nc, H, Q, N, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}
