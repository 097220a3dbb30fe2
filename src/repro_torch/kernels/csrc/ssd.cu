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
// P 64, N 128) the least work is 4.44 GFLOP (C B^T once per (b, c), causal
// pairs only) against 89 MB of bytes: 66 us at the 67 TFLOP/s of fp32
// outside the tensor cores, 27 us of bytes.  Done as three TF32 products
// per fp32 product on the tensor cores (below), it is 13.3 GFLOP at 495
// TFLOP/s, 27 us: bytes and operations then bound it alike.
//
// Design.
//   - B and C do not depend on the head, so the score tiles C B^T are
//     shared: one block per (b, c, group of G <= 4 heads) computes each
//     causal 64 x 64 score tile once and applies it to every head of the
//     group (C B^T 8 times per (b, c) at 32 heads instead of 32; 128 blocks,
//     one wave on 132 SMs).  Nothing crosses blocks: no atomics, the same
//     bits at every launch.
//   - The per-head scans (cum, dt) sit in shared memory beside the tiles
//     where they fit (Q up to 448 at P 64 and 4 heads).  A longer chunk
//     takes the kernel's other instantiation, which keeps them in global
//     memory: cum in the decay output, turned into exp(cum) at the end, dt
//     where it lies.  Both give the same bits.
//   - Products on the tensor cores: `wgmma` m64nNk8 in TF32, A in
//     registers, B in shared memory, K-major, in the layout without a
//     swizzle (8-row core matrices of 16 bytes).  fp32 accuracy from TF32
//     ("3xTF32"): each operand is split as hi = tf32(v), lo = v - hi, and
//     each product is lo.hi + hi.lo + hi.hi in fp32, 22 bits of each
//     operand instead of 11.  One pass alone keeps about 3 decimal digits,
//     too few for the port's tolerances.
//   - Scores: each consumer warpgroup takes 32 of the tile's 64 keys, A = C,
//     B = the key tile of B, in two steps of 64 columns of N.  y: for each
//     key tile, warpgroup w applies the scores to heads w and 2 + w in turn,
//     A = W = S o decay o dt_k built in registers from the scores, B = x^T;
//     y of both heads stays in registers across the query tile's key tiles.
//     Chunk states, head by head: warpgroup w takes rows 64 w ... of N, A =
//     (B o exp(cum_end - cum) o dt)^T, B = x^T.
//   - The keys of each 8-key k-step are taken in the order (0, 2, 4, 6, 1,
//     3, 5, 7): the score accumulators then hold W's A fragments as they
//     are, and x^T is written in the same order.
//   - Warp-specialised: a producer warpgroup walks the block's steps
//     (scores, y per head pair, states) ahead of the two consumer
//     warpgroups, through two slots of shared memory.  Its thread 0 loads
//     the tiles by TMA (B and C in boxes of 32 columns with the 128-byte
//     swizzle, zero past N and Q): what the producer splits two steps
//     ahead into raw buffers, what the consumers read as it is (C, and B
//     for the states) into the slot once the consumers have released it.
//     The producer then splits B's key tile and x^T (x transposed) into
//     the slot's hi and lo B operands.  The consumers build each batch of
//     A fragments while the batch before runs.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int T = 64;             // rows and columns of a tile of the Q x Q scores
constexpr int CONSUMERS = 256;    // warpgroups 0 and 1
constexpr int PRODUCERS = 128;    // warpgroup 2
constexpr int THREADS = CONSUMERS + PRODUCERS;
constexpr int MAX_N = 128;
constexpr int MAX_G = 4;          // heads of a block: two pairs
constexpr int NH = 64;            // columns of B and C in one score step
constexpr int BOX = 32;           // columns of B and C in one TMA box (128 B)
constexpr int BOX_FLOATS = T * BOX;
constexpr int LDS = T + 8;        // score row pitch, 8 mod 32 (float2 reads)
constexpr int KB = 2;             // k8 steps of a batch of products in flight
// named barriers (0 is __syncthreads): a slot filled, a slot emptied, the
// consumers alone, the producer alone
constexpr int BAR_FULL = 1, BAR_EMPTY = 3, BAR_CONS = 5, BAR_PROD = 6;

__host__ __device__ inline int round_up(int n, int m) { return (n + m - 1) / m * m; }
__host__ __device__ inline int max3(int a, int b, int c) {
  return a > b ? (a > c ? a : c) : (b > c ? b : c);
}

// Shared memory, in floats, after alignment to 1024 bytes: two slots the
// consumers read (raw tiles as TMA wrote them, split B operands), two raw
// buffers the producer splits, one score tile, the per-head scans (where
// they are kept in shared memory), four mbarriers (a buffer's and a slot's
// TMA loads).
struct Layout {
  int Qp, pn, slot, rb, scores, scan;
  __host__ __device__ Layout(int Q, int N, int P, int G, bool shared_scan) {
    Qp = round_up(Q, T);
    pn = round_up(N, 16);  // B and C columns in use, zero past N
    slot = max3(2 * BOX_FLOATS + 2 * T * NH,  // C half raw, B half split
                4 * T * P,                    // x^T of two heads, split
                4 * BOX_FLOATS + 2 * T * P);  // B raw, x^T of one head
    rb = 2 * (BOX_FLOATS > T * P ? BOX_FLOATS : T * P);  // B half, x of 2 heads
    scores = T * LDS;
    scan = shared_scan ? 2 * G * Qp : 0;  // cum, dt
  }
  __host__ __device__ size_t bytes() const {
    return sizeof(float) * size_t(2 * slot + 2 * rb + scores + scan) + 32 + 1024;
  }
};

// Element (r, c) of a tile of T rows stored as TMA writes boxes of BOX
// columns with the 128-byte swizzle: the box, the row, the 16-byte chunk
// XORed with the row.
__device__ __forceinline__ int swz(int r, int c) {
  return (c / BOX) * BOX_FLOATS + r * BOX + ((((c % BOX) >> 2) ^ (r & 7)) << 2) + (c & 3);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
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

__device__ inline uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// v = hi + lo exactly; the tensor cores read lo's top 11 bits, so v is
// carried to 2^-22 of itself.
__device__ inline void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(v);
  lo = __float_as_uint(v - __uint_as_float(hi));
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

// D (64 x 16) += A (64 x 8, tf32 registers) . B (8 x 16, shared, K-major).
__device__ __forceinline__ void wgmma_n16(float (&d)[8], uint32_t a0, uint32_t a1,
                                          uint32_t a2, uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
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

// D (64 x 64) += A (64 x 8, tf32 registers) . B (8 x 64, shared, K-major).
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint32_t a0, uint32_t a1,
                                          uint32_t a2, uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

// d += A . B for one k8 step of a 64 x N product, N = 2 * ND.
template <int ND>
__device__ __forceinline__ void wgmma_k8(float (&d)[ND], const uint32_t (&a)[4],
                                         uint64_t b) {
  if constexpr (ND == 8) wgmma_n16(d, a[0], a[1], a[2], a[3], b);
  else if constexpr (ND == 16) wgmma_n32(d, a[0], a[1], a[2], a[3], b);
  else wgmma_n64(d, a[0], a[1], a[2], a[3], b);
}

// d += A . B in fp32 accuracy: lo.hi, hi.lo, then hi.hi.
template <int ND>
__device__ __forceinline__ void wgmma3(float (&d)[ND], const uint32_t (&ahi)[4],
                                       const uint32_t (&alo)[4], uint64_t bhi,
                                       uint64_t blo) {
  wgmma_k8(d, alo, bhi);
  wgmma_k8(d, ahi, blo);
  wgmma_k8(d, ahi, bhi);
}

// One step of a block's walk (see the design note): its kind and where.
enum StepKind { SCORES, WX, STATE, END };

struct Step {
  int kind, j, k, i;  // query tile, key tile; column half, first head of
                      // the pair, or head
};

__device__ inline Step next_step(const Step& s, int nqt, int gh, int halves) {
  if (s.kind == SCORES) {
    if (s.i + 1 < halves) return {SCORES, s.j, s.k, s.i + 1};
    return {WX, s.j, s.k, 0};
  }
  if (s.kind == WX) {
    if (s.i + 2 < gh) return {WX, s.j, s.k, s.i + 2};
    if (s.k < s.j) return {SCORES, s.j, s.k + 1, 0};
    if (s.j + 1 < nqt) return {SCORES, s.j + 1, 0, 0};
    return {STATE, 0, 0, 0};
  }
  if (s.kind == STATE) {
    if (s.k + 1 < nqt) return {STATE, 0, s.k + 1, s.i};
    if (s.i + 1 < gh) return {STATE, 0, 0, s.i + 1};
  }
  return {END, 0, 0, 0};
}

struct Maps {
  const CUtensorMap *x, *b, *c;  // x (P, Q, B nc H); B, C (N, Q, B nc)
};

struct Where {
  int bc, bch, pn;  // (b, c), the block's first (b, c, h), N rounded to 16
};

// TMA loads of step `s` that the producer splits, into its raw buffer: a
// column half of B's key tile, x of the step's heads.
__device__ inline void load_raw(const Step& s, float* rb, uint32_t bar,
                                const Maps& m, const Where& w, int P, int gh) {
  if (s.kind == SCORES) {
    const int boxes = min(2, (w.pn - NH * s.i + BOX - 1) / BOX);
    mbar_expect_tx(bar, boxes * BOX_FLOATS * 4);
    for (int b = 0; b < boxes; ++b)
      tma_load(rb + b * BOX_FLOATS, m.b, bar, NH * s.i + BOX * b, s.k * T, w.bc);
  } else if (s.kind == WX || s.kind == STATE) {
    const int heads = s.kind == WX ? min(2, gh - s.i) : 1;
    mbar_expect_tx(bar, heads * T * P * 4);
    for (int h = 0; h < heads; ++h)
      tma_load(rb + h * T * P, m.x, bar, 0, s.k * T, w.bch + s.i + h);
  }
}

// TMA loads of step `s` that the consumers read as they are, into the
// slot: the score step's column half of C, the state step's B (an arrival
// alone for the other steps).
__device__ inline void load_slot(const Step& s, float* slot, uint32_t bar,
                                 const Maps& m, const Where& w) {
  if (s.kind == SCORES) {
    const int boxes = min(2, (w.pn - NH * s.i + BOX - 1) / BOX);
    mbar_expect_tx(bar, boxes * BOX_FLOATS * 4);
    for (int b = 0; b < boxes; ++b)
      tma_load(slot + b * BOX_FLOATS, m.c, bar, NH * s.i + BOX * b, s.j * T, w.bc);
  } else if (s.kind == STATE) {
    const int boxes = (w.pn + BOX - 1) / BOX;
    mbar_expect_tx(bar, boxes * BOX_FLOATS * 4);
    for (int b = 0; b < boxes; ++b)
      tma_load(slot + b * BOX_FLOATS, m.b, bar, BOX * b, s.k * T, w.bc);
  } else {
    mbar_expect_tx(bar, 0);
  }
}

// x^T of `heads` heads from rb (x as TMA wrote it, (key, p) at key * P +
// p) into dst, split: (p, k) at ((k / 4) * (P / 8) + p / 8) * 32 + (p % 8)
// * 4 + k % 4, hi then lo, k the key's place in the order of the design
// note.
template <int P>
__device__ inline void split_x(const float* rb, float* dst, int heads, int t) {
  constexpr int PER_HEAD = 16 * P / PRODUCERS;  // float4 of x^T a thread makes
  for (int i = 0; i < heads; ++i) {
#pragma unroll
    for (int n = 0; n < PER_HEAD; ++n) {
      const int r = t + n * PRODUCERS;
      const int p = r % P, lq = r / P;  // x^T row, quad of k
      const float* xr = rb + i * T * P + p;
      const int key0 = 8 * (lq / 2) + (lq & 1);  // keys key0 + 2m
      uint4 hi, lo;
      split(xr[key0 * P], hi.x, lo.x);
      split(xr[(key0 + 2) * P], hi.y, lo.y);
      split(xr[(key0 + 4) * P], hi.z, lo.z);
      split(xr[(key0 + 6) * P], hi.w, lo.w);
      float* d = dst + i * 2 * T * P;
      const int at = (lq * (P / 8) + p / 8) * 32 + (p % 8) * 4;
      *reinterpret_cast<uint4*>(d + at) = hi;
      *reinterpret_cast<uint4*>(d + T * P + at) = lo;
    }
  }
}

// The producer's split of step `s` into its slot: the B half of a score
// step, (key, n) at ((n / 4) * 8 + key / 8) * 32 + (key % 8) * 4 + n % 4,
// hi then lo, after the raw C half; x^T of the step's heads.
template <int P>
__device__ inline void split_step(const Step& s, const float* rb, float* slot,
                                  int gh, int t) {
  if (s.kind == SCORES) {
    float* hi_part = slot + 2 * BOX_FLOATS;
#pragma unroll
    for (int n = 0; n < T * NH / 4 / PRODUCERS; ++n) {
      const int e = t + n * PRODUCERS;
      const int key = e & (T - 1), nq = e / T;
      const float4 v = *reinterpret_cast<const float4*>(rb + swz(key, 4 * nq));
      uint4 hi, lo;
      split(v.x, hi.x, lo.x);
      split(v.y, hi.y, lo.y);
      split(v.z, hi.z, lo.z);
      split(v.w, hi.w, lo.w);
      const int at = (nq * 8 + key / 8) * 32 + (key % 8) * 4;
      *reinterpret_cast<uint4*>(hi_part + at) = hi;
      *reinterpret_cast<uint4*>(hi_part + T * NH + at) = lo;
    }
  } else if (s.kind == WX) {
    split_x<P>(rb, slot, min(2, gh - s.i), t);
  } else if (s.kind == STATE) {
    split_x<P>(rb, slot + 4 * BOX_FLOATS, 1, t);
  }
  // the consumers' products read these through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// SHARED_SCAN: the scans in shared memory, else in global memory (above).
template <int P, bool SHARED_SCAN>
__global__ void __launch_bounds__(THREADS, 1)
ssd_intra_chunk_kernel(const __grid_constant__ CUtensorMap x_map,
                       const __grid_constant__ CUtensorMap b_map,
                       const __grid_constant__ CUtensorMap c_map,
                       const float* __restrict__ dt, const float* __restrict__ A,
                       float* __restrict__ y, float* __restrict__ hc,
                       float* __restrict__ dec, int H, int Q, int N, int G) {
  constexpr int ND = P / 2;  // accumulators of a 64 x P product per thread
  const Layout L(Q, N, P, G, SHARED_SCAN);
  const int Qp = L.Qp, pn = L.pn;
  const int nqt = Qp / T, halves = pn > NH ? 2 : 1;
  extern __shared__ float4 smem4[];
  float* const slot0 = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem4) + 1023) & ~uintptr_t(1023));
  float* const rb0 = slot0 + 2 * L.slot;  // raw buffers 0, 1
  float* S = rb0 + 2 * L.rb;   // [T][LDS]
  float* cum = S + L.scores;   // [G][Qp] where SHARED_SCAN
  float* dts = cum + G * Qp;   // [G][Qp] where SHARED_SCAN
  // mbarriers: raw buffer 0, 1, then slot 0, 1
  const uint32_t bars = smem_u32(cum + L.scan);

  const int groups = (H + G - 1) / G;
  const int bc = blockIdx.x / groups;  // b * nc + c
  const int h_first = (blockIdx.x % groups) * G;
  const int gh = min(G, H - h_first);  // heads of this block
  const Maps m{&x_map, &b_map, &c_map};
  const Where w{bc, bc * H + h_first, pn};
  const size_t head0 = size_t(bc) * H + h_first;  // the block's first head
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wg = warp >> 2;  // warpgroup
  if (tid == 0) {
    for (int i = 0; i < 4; ++i) mbar_init(bars + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // ---- the producer: TMA loads, then the split
    const int t = tid - CONSUMERS;
    // step i's raw tiles are loaded two steps ahead, its slot tiles as soon
    // as the consumers have released the slot (step i - 2)
    Step s{SCORES, 0, 0, 0};
    Step nxt = next_step(s, nqt, gh, halves);
    if (t == 0) {
      load_raw(s, rb0, bars, m, w, P, gh);
      load_slot(s, slot0, bars + 16, m, w);
      if (nxt.kind != END) load_raw(nxt, rb0 + L.rb, bars + 8, m, w, P, gh);
    }
    int i = 0;
    for (; s.kind != END; ++i) {
      float* slot = slot0 + (i & 1) * L.slot;
      float* rb = rb0 + (i & 1) * L.rb;
      mbar_wait(bars + 8 * (i & 1), (i >> 1) & 1);  // step i's raw tiles
      split_step<P>(s, rb, slot, gh, t);
      __threadfence_block();
      named_arrive(BAR_FULL + (i & 1), THREADS);
      named_sync(BAR_PROD, PRODUCERS);  // the raw buffer is free again
      const Step after = next_step(nxt, nqt, gh, halves);
      if (t == 0 && after.kind != END)
        load_raw(after, rb, bars + 8 * (i & 1), m, w, P, gh);
      if (nxt.kind != END) {
        if (i >= 1)  // the slot of step i + 1 is free
          named_sync(BAR_EMPTY + ((i + 1) & 1), THREADS);
        if (t == 0)
          load_slot(nxt, slot0 + ((i + 1) & 1) * L.slot,
                    bars + 16 + 8 * ((i + 1) & 1), m, w);
      }
      s = nxt;
      nxt = after;
    }
    // the consumers' releases of the last two steps
    for (int r = i >= 2 ? i - 2 : 0; r < i; ++r)
      named_sync(BAR_EMPTY + (r & 1), THREADS);
    return;
  }

  // ---- the consumers
  const int g = lane >> 2, t4 = lane & 3;  // fragment row and column
  const int row = 16 * (warp & 3) + g;     // fragment rows row, row + 8

  // head hh's scans, and their value at q < Qp (past Q, cum keeps its last
  // value and dt is 0, as the shared copies hold them)
  auto cum_of = [&](int hh) -> float* {
    if constexpr (SHARED_SCAN) return cum + hh * Qp;
    else return dec + (head0 + hh) * Q;
  };
  auto dt_of = [&](int hh) -> const float* {
    if constexpr (SHARED_SCAN) return dts + hh * Qp;
    else return dt + (head0 + hh) * Q;
  };
  auto cum_at = [&](const float* c, int q) -> float {
    if constexpr (SHARED_SCAN) return c[q];
    else return c[min(q, Q - 1)];
  };
  auto dt_at = [&](const float* d, int q) -> float {
    if constexpr (SHARED_SCAN) return d[q];
    else return q < Q ? d[q] : 0.f;
  };

  // per head: dt, cum (a warp scan), dec
  if constexpr (SHARED_SCAN) {
    for (int i = tid; i < G * Qp; i += CONSUMERS) {
      const int hh = i / Qp, q = i % Qp;
      dts[i] = hh < gh && q < Q ? dt[(head0 + hh) * Q + q] : 0.f;
    }
    named_sync(BAR_CONS, CONSUMERS);
  }
  if (warp < gh) {
    const float a = A[h_first + warp];
    float* c = cum_of(warp);
    const float* d = dt_of(warp);
    const int run = Qp / 32;
    float sum = 0.f;
    for (int i = 0; i < run; ++i) {
      const int q = lane * run + i;
      sum += dt_at(d, q) * (-a);
      if (SHARED_SCAN || q < Q) c[q] = sum;
    }
    float incl = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += up;
    }
    const float before = incl - sum;
    for (int i = 0; i < run; ++i) {
      const int q = lane * run + i;
      if (SHARED_SCAN || q < Q) c[q] += before;
    }
  }
  named_sync(BAR_CONS, CONSUMERS);
  if constexpr (SHARED_SCAN) {
    for (int i = tid; i < gh * Qp; i += CONSUMERS) {
      const int hh = i / Qp, q = i % Qp;
      if (q < Q) dec[(head0 + hh) * Q + q] = expf(cum[i]);
    }
  }

  int it = 0;  // steps taken
  auto acquire = [&]() -> float* {
    named_sync(BAR_FULL + (it & 1), THREADS);
    mbar_wait(bars + 16 + 8 * (it & 1), (it >> 1) & 1);  // its TMA tiles
    return slot0 + (it & 1) * L.slot;
  };
  auto release = [&]() {
    named_arrive(BAR_EMPTY + (it & 1), THREADS);
    ++it;
  };

  // y, query tile by query tile; warpgroup wg keeps y of heads wg and 2 + wg
  // in registers across the key tiles.  Each product runs in NB batches of
  // KB k8 steps: batch b + 1's A fragments are built while batch b runs.
  constexpr int NB = T / 8 / KB;
  for (int j = 0; j < nqt; ++j) {
    const int qa = j * T + row, qb = qa + 8;
    float yacc[2][ND] = {};
    for (int k = 0; k <= j; ++k) {
      // scores of key tile k: warpgroup wg takes keys 32 wg ..., NH columns
      // of B and C a step
      float sacc[16] = {};
      for (int hf = 0; hf < halves; ++hf) {
        const float* slot = acquire();
        const uint32_t b_at = smem_u32(slot + 2 * BOX_FLOATS) + wg * 4 * 128;
        const uint64_t b_hi = make_desc(b_at, 8 * 128, 128);
        const uint64_t b_lo = make_desc(b_at + T * NH * 4, 8 * 128, 128);
        const int ksteps = min(NH, pn - NH * hf) / 8;
        uint32_t ahi[2][KB][4], alo[2][KB][4];
        auto build = [&](int b, uint32_t (&h)[KB][4], uint32_t (&l)[KB][4]) {
#pragma unroll
          for (int u = 0; u < KB; ++u) {
            const int c = 8 * min(b * KB + u, ksteps - 1) + t4;
            split(slot[swz(row, c)], h[u][0], l[u][0]);
            split(slot[swz(row + 8, c)], h[u][1], l[u][1]);
            split(slot[swz(row, c + 4)], h[u][2], l[u][2]);
            split(slot[swz(row + 8, c + 4)], h[u][3], l[u][3]);
          }
        };
        build(0, ahi[0], alo[0]);
        fence_regs(sacc);
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          if (b * KB >= ksteps) break;
          wgmma_fence();
#pragma unroll
          for (int u = 0; u < KB; ++u) {
            if (b * KB + u < ksteps) {
              const uint64_t off = uint64_t((b * KB + u) * 2 * 8 * 128) >> 4;
              wgmma3(sacc, ahi[b & 1][u], alo[b & 1][u], b_hi + off, b_lo + off);
            }
          }
          wgmma_commit();
          wgmma_wait<1>();
          if (b + 1 < NB) build(b + 1, ahi[(b + 1) & 1], alo[(b + 1) & 1]);
        }
        wgmma_wait<0>();
        fence_regs(sacc);
        release();
      }
      named_sync(BAR_CONS, CONSUMERS);  // the last products are done with S
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float* s = S + row * LDS + 32 * wg + 8 * i + 2 * t4;
        *reinterpret_cast<float2*>(s) = make_float2(sacc[4 * i], sacc[4 * i + 1]);
        *reinterpret_cast<float2*>(s + 8 * LDS) =
            make_float2(sacc[4 * i + 2], sacc[4 * i + 3]);
      }
      named_sync(BAR_CONS, CONSUMERS);
#pragma unroll
      for (int pr = 0; pr < 2; ++pr) {  // heads 2 pr + wg
        if (2 * pr >= gh) break;
        const float* slot = acquire();
        const int hh = 2 * pr + wg;
        if (hh < gh) {
          const uint32_t x_at = smem_u32(slot) + wg * 8 * T * P;
          const uint32_t x_lbo = (P / 8) * 128;
          const uint64_t x_hi = make_desc(x_at, x_lbo, 128);
          const uint64_t x_lo = make_desc(x_at + T * P * 4, x_lbo, 128);
          const float* ch = cum_of(hh);
          const float* dh = dt_of(hh);
          const float cqa = cum_at(ch, qa), cqb = cum_at(ch, qb);
          const float* srow = S + row * LDS;
          uint32_t ahi[2][KB][4], alo[2][KB][4];
          // W = S o exp(cum_q - cum_k)|causal o dt_k for keys kl, kl + 1
          auto build = [&](int b, uint32_t (&h)[KB][4], uint32_t (&l)[KB][4]) {
#pragma unroll
            for (int u = 0; u < KB; ++u) {
              const int kl = 8 * (b * KB + u) + 2 * t4;
              const int key = k * T + kl;
              const float2 sa = *reinterpret_cast<const float2*>(srow + kl);
              const float2 sb = *reinterpret_cast<const float2*>(srow + 8 * LDS + kl);
              const float c0 = cum_at(ch, key), c1 = cum_at(ch, key + 1);
              const float d0 = dt_at(dh, key), d1 = dt_at(dh, key + 1);
              split(sa.x * expf(qa >= key ? cqa - c0 : -INFINITY) * d0, h[u][0], l[u][0]);
              split(sb.x * expf(qb >= key ? cqb - c0 : -INFINITY) * d0, h[u][1], l[u][1]);
              split(sa.y * expf(qa >= key + 1 ? cqa - c1 : -INFINITY) * d1, h[u][2], l[u][2]);
              split(sb.y * expf(qb >= key + 1 ? cqb - c1 : -INFINITY) * d1, h[u][3], l[u][3]);
            }
          };
          build(0, ahi[0], alo[0]);
          fence_regs(yacc[pr]);
#pragma unroll
          for (int b = 0; b < NB; ++b) {
            wgmma_fence();
#pragma unroll
            for (int u = 0; u < KB; ++u) {
              const uint64_t off = uint64_t((b * KB + u) * 2 * x_lbo) >> 4;
              wgmma3(yacc[pr], ahi[b & 1][u], alo[b & 1][u], x_hi + off, x_lo + off);
            }
            wgmma_commit();
            wgmma_wait<1>();
            if (b + 1 < NB) build(b + 1, ahi[(b + 1) & 1], alo[(b + 1) & 1]);
          }
          wgmma_wait<0>();
          fence_regs(yacc[pr]);
        }
        release();
      }
    }
#pragma unroll
    for (int pr = 0; pr < 2; ++pr) {
      const int hh = 2 * pr + wg;
      if (hh >= gh) continue;
      float* yh = y + (size_t(bc) * H + h_first + hh) * Q * P;
#pragma unroll
      for (int i = 0; i < ND / 4; ++i) {
        const int col = 8 * i + 2 * t4;
        if (qa < Q)
          *reinterpret_cast<float2*>(yh + size_t(qa) * P + col) =
              make_float2(yacc[pr][4 * i], yacc[pr][4 * i + 1]);
        if (qb < Q)
          *reinterpret_cast<float2*>(yh + size_t(qb) * P + col) =
              make_float2(yacc[pr][4 * i + 2], yacc[pr][4 * i + 3]);
      }
    }
  }

  // chunk states, head by head: warpgroup wg takes rows 64 wg ... of N
  const bool rows_here = T * wg < pn;
  for (int hh = 0; hh < gh; ++hh) {
    const float* ch = cum_of(hh);
    const float* dh = dt_of(hh);
    const float cum_end = ch[Q - 1];
    float hacc[ND] = {};
    for (int kt = 0; kt < nqt; ++kt) {
      const float* slot = acquire();
      if (rows_here) {
        const uint32_t x_at = smem_u32(slot + 4 * BOX_FLOATS);
        const uint32_t x_lbo = (P / 8) * 128;
        const uint64_t x_hi = make_desc(x_at, x_lbo, 128);
        const uint64_t x_lo = make_desc(x_at + T * P * 4, x_lbo, 128);
        const int n = T * wg + row;
        uint32_t ahi[2][KB][4], alo[2][KB][4];
        // (B o exp(cum_end - cum) o dt)^T for keys kl, kl + 1
        auto build = [&](int b, uint32_t (&h)[KB][4], uint32_t (&l)[KB][4]) {
#pragma unroll
          for (int u = 0; u < KB; ++u) {
            const int kl = 8 * (b * KB + u) + 2 * t4;
            const int key = kt * T + kl;
            const float e0 = expf(cum_end - cum_at(ch, key)) * dt_at(dh, key);
            const float e1 =
                expf(cum_end - cum_at(ch, key + 1)) * dt_at(dh, key + 1);
            split(slot[swz(kl, n)] * e0, h[u][0], l[u][0]);
            split(slot[swz(kl, n + 8)] * e0, h[u][1], l[u][1]);
            split(slot[swz(kl + 1, n)] * e1, h[u][2], l[u][2]);
            split(slot[swz(kl + 1, n + 8)] * e1, h[u][3], l[u][3]);
          }
        };
        build(0, ahi[0], alo[0]);
        fence_regs(hacc);
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          wgmma_fence();
#pragma unroll
          for (int u = 0; u < KB; ++u) {
            const uint64_t off = uint64_t((b * KB + u) * 2 * x_lbo) >> 4;
            wgmma3(hacc, ahi[b & 1][u], alo[b & 1][u], x_hi + off, x_lo + off);
          }
          wgmma_commit();
          wgmma_wait<1>();
          if (b + 1 < NB) build(b + 1, ahi[(b + 1) & 1], alo[(b + 1) & 1]);
        }
        wgmma_wait<0>();
        fence_regs(hacc);
      }
      release();
    }
    if (rows_here) {
      float* out = hc + (size_t(bc) * H + h_first + hh) * N * P;
#pragma unroll
      for (int i = 0; i < ND / 4; ++i) {
        const int n = T * wg + row, col = 8 * i + 2 * t4;
        if (n < N)
          *reinterpret_cast<float2*>(out + size_t(n) * P + col) =
              make_float2(hacc[4 * i], hacc[4 * i + 1]);
        if (n + 8 < N)
          *reinterpret_cast<float2*>(out + size_t(n + 8) * P + col) =
              make_float2(hacc[4 * i + 2], hacc[4 * i + 3]);
      }
    }
  }
  if constexpr (!SHARED_SCAN) {  // the decay, in place of the scans
    named_sync(BAR_CONS, CONSUMERS);
    float* d = dec + head0 * Q;
    for (int i = tid; i < gh * Q; i += CONSUMERS) d[i] = expf(d[i]);
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
// whose box is T rows of `box_cols` columns of one outer index; zero past
// the tensor.
bool make_map(CUtensorMap* map, const void* ptr, int outer, int rows, int cols,
              int box_cols, bool swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {cuuint64_t(cols), cuuint64_t(rows), cuuint64_t(outer)};
  const cuuint64_t strides[2] = {cuuint64_t(cols) * 4, cuuint64_t(rows) * cols * 4};
  const cuuint32_t box[3] = {cuuint32_t(box_cols), cuuint32_t(T), 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr),
                dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int P>
int launch(const void* x, const void* Bm, const void* Cm, const void* dt,
           const void* A, void* y, void* hc, void* dec, int Bsz, int nc, int H,
           int Q, int N, cudaStream_t stream) {
  int device = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return int(err);
  const int G = H < MAX_G ? H : MAX_G;
  // the scans stay in shared memory where they fit beside the tiles
  const bool shared_scan =
      Layout(Q, N, P, G, true).bytes() <= size_t(max_smem);
  const size_t smem = Layout(Q, N, P, G, shared_scan).bytes();
  if (smem > size_t(max_smem)) return int(cudaErrorInvalidValue);
  const auto kernel = shared_scan ? ssd_intra_chunk_kernel<P, true>
                                  : ssd_intra_chunk_kernel<P, false>;
  CUtensorMap x_map, b_map, c_map;
  if (!make_map(&x_map, x, Bsz * nc * H, Q, P, P, false) ||
      !make_map(&b_map, Bm, Bsz * nc, Q, N, BOX, true) ||
      !make_map(&c_map, Cm, Bsz * nc, Q, N, BOX, true))
    return int(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem));
  if (err != cudaSuccess) return int(err);
  const unsigned blocks =
      unsigned(Bsz) * unsigned(nc) * unsigned((H + G - 1) / G);
  kernel<<<blocks, THREADS, smem, stream>>>(
      x_map, b_map, c_map, static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<float*>(y),
      static_cast<float*>(hc), static_cast<float*>(dec), H, Q, N, G);
  return int(cudaGetLastError());
}

}  // namespace

// Returns the CUDA error of the launch (0 when it was accepted).  P must be
// 16, 32 or 64, N at most 128 and a multiple of 4 (TMA's 16-byte rows); Q
// and H any.
extern "C" int ssd_intra_chunk_f32(const void* x, const void* Bm, const void* Cm,
                                   const void* dt, const void* A, void* y,
                                   void* hc, void* dec, int Bsz, int nc, int H,
                                   int Q, int P, int N, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N < 1 || N > MAX_N || N % 4 != 0 || Q < 1 || H < 1)
    return int(cudaErrorInvalidValue);
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
