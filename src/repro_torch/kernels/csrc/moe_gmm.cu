// Per-expert (grouped) matmul with a fused activation for the port's MoE
// FFN, in CUDA C++ for sm_90a.
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
//
// What bounds it on the H100: at the MoE path's shape (qwen3-moe-30b-a3b,
// E 128, C 320 = 4 token groups x capacity 80, D 2048, F 768) one launch
// does 2 E C D F = 128.8 GFLOP against 633 MB of bytes (x and w read once,
// out written once): 130 us at the 989 TFLOP/s of the bf16 tensor cores
// against 189 us at 3.35 TB/s, so bytes set the bound: the 403 MB of
// expert weights dominate.
//
// Design: right and simple first, on the tensor cores through mma.sync
// (m16n8k16, bf16 in, fp32 accumulate); wgmma and TMA are later work.  One
// block of 256 threads (8 warps, 2 x 4, each a 32 x 32 sub-tile) owns a
// 64-row x 128-column output tile of one expert and walks D in 32-wide
// steps: the x tile (64 x 32) and the w tile (32 x 128) are staged in
// shared memory (rows padded by 16 bytes, so ldmatrix reads are free of
// bank conflicts), with the next step's tiles loaded into registers while
// the tensor cores work on this one.  Fragments come from ldmatrix (x
// row-major, w with .trans).  Rows past C, depths past D and columns past F
// are zero-filled; 16-byte loads where D (for x) or F (for w) is a multiple
// of 8, element loads otherwise.  Each expert's weights are read once per
// 64-row tile of its C rows (5 times at C 320, mostly from L2).  15 KB of
// shared memory per block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;    // rows (C) per block
constexpr int BN = 128;   // columns (F) per block
constexpr int BK = 32;    // depth (D) per step
constexpr int THREADS = 256;
constexpr int LDA = BK + 8;  // bf16 elements per row of the x tile
constexpr int LDB = BN + 8;  // bf16 elements per row of the w tile
constexpr int A_CHUNKS = BM * BK / 8 / THREADS;  // 16-byte chunks per thread: 1
constexpr int B_CHUNKS = BK * BN / 8 / THREADS;  // 2

enum Activation { kNone = 0, kSilu = 1, kGelu = 2 };

__device__ inline uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 8 consecutive bf16 of a row [r][c0, c0 + 8) of a (rows, cols) matrix,
// zero past its edges.
__device__ inline uint4 load8(const __nv_bfloat16* __restrict__ m, int rows,
                              int cols, int r, int c0, bool vec) {
  if (r < rows && vec && c0 + 8 <= cols) {
    return *reinterpret_cast<const uint4*>(m + size_t(r) * cols + c0);
  }
  uint4 out = make_uint4(0u, 0u, 0u, 0u);
  unsigned short* h = reinterpret_cast<unsigned short*>(&out);
  if (r < rows) {
    const unsigned short* src =
        reinterpret_cast<const unsigned short*>(m + size_t(r) * cols);
    for (int i = 0; i < 8; ++i)
      if (c0 + i < cols) h[i] = src[c0 + i];
  }
  return out;
}

__device__ inline float activate(float v, int act) {
  if (act == kSilu) return v / (1.f + expf(-v));
  if (act == kGelu) {
    const float c = 0.7978845608028654f;  // sqrt(2 / pi)
    return 0.5f * v * (1.f + tanhf(c * (v + 0.044715f * v * v * v)));
  }
  return v;
}

__global__ void __launch_bounds__(THREADS)
expert_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ w,
                     __nv_bfloat16* __restrict__ out, int C, int D, int F,
                     int act) {
  __shared__ __align__(16) __nv_bfloat16 As[BM * LDA];
  __shared__ __align__(16) __nv_bfloat16 Bs[BK * LDB];

  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int e = blockIdx.z;
  const __nv_bfloat16* xe = x + size_t(e) * C * D;
  const __nv_bfloat16* we = w + size_t(e) * D * F;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int wm = (warp / 4) * 32;  // the warp's rows within the tile
  const int wn = (warp % 4) * 32;  // and columns
  const bool vec_x = D % 8 == 0;
  const bool vec_w = F % 8 == 0;

  // x tile: 64 rows x 4 chunks; w tile: 32 rows x 16 chunks
  uint4 ra[A_CHUNKS], rb[B_CHUNKS];
  auto load_tiles = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      const int c = tid + i * THREADS;
      ra[i] = load8(xe, C, D, m0 + c / (BK / 8), k0 + (c % (BK / 8)) * 8, vec_x);
    }
#pragma unroll
    for (int i = 0; i < B_CHUNKS; ++i) {
      const int c = tid + i * THREADS;
      rb[i] = load8(we, D, F, k0 + c / (BN / 8), n0 + (c % (BN / 8)) * 8, vec_w);
    }
  };
  auto store_tiles = [&]() {
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      const int c = tid + i * THREADS;
      *reinterpret_cast<uint4*>(As + (c / (BK / 8)) * LDA + (c % (BK / 8)) * 8) = ra[i];
    }
#pragma unroll
    for (int i = 0; i < B_CHUNKS; ++i) {
      const int c = tid + i * THREADS;
      *reinterpret_cast<uint4*>(Bs + (c / (BN / 8)) * LDB + (c % (BN / 8)) * 8) = rb[i];
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  load_tiles(0);
  for (int k0 = 0; k0 < D; k0 += BK) {
    __syncthreads();  // every warp is done with the last step's tiles
    store_tiles();
    __syncthreads();
    if (k0 + BK < D) load_tiles(k0 + BK);  // in flight during the products

#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const __nv_bfloat16* p =
            As + (wm + i * 16 + lane % 16) * LDA + kk + (lane / 16) * 8;
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
            : "=r"(a[i][0]), "=r"(a[i][1]), "=r"(a[i][2]), "=r"(a[i][3])
            : "r"(smem_addr(p)));
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {  // two 16-column halves of the warp's 32
        const __nv_bfloat16* p =
            Bs + (kk + lane % 16) * LDB + wn + j * 16 + (lane / 16) * 8;
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
            : "=r"(b[2 * j][0]), "=r"(b[2 * j][1]), "=r"(b[2 * j + 1][0]),
              "=r"(b[2 * j + 1][1])
            : "r"(smem_addr(p)));
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          asm volatile(
              "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
              "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
              "{%0, %1, %2, %3};\n"
              : "+f"(acc[i][j][0]), "+f"(acc[i][j][1]), "+f"(acc[i][j][2]),
                "+f"(acc[i][j][3])
              : "r"(a[i][0]), "r"(a[i][1]), "r"(a[i][2]), "r"(a[i][3]),
                "r"(b[j][0]), "r"(b[j][1]));
    }
  }

  // acc[i][j]: rows wm + 16 i + lane / 4 (+ 8 for elements 2, 3), columns
  // wn + 8 j + 2 (lane % 4) (+ 1 for elements 1, 3)
  __nv_bfloat16* oe = out + size_t(e) * C * F;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = m0 + wm + i * 16 + lane / 4 + (r / 2) * 8;
        const int col = n0 + wn + j * 8 + 2 * (lane % 4) + r % 2;
        if (row < C && col < F)
          oe[size_t(row) * F + col] = __float2bfloat16(activate(acc[i][j][r], act));
      }
}

}  // namespace

// Returns the CUDA error of the launch (0 when it was accepted).  act: 0 none,
// 1 silu, 2 gelu (tanh form).
extern "C" int expert_matmul_bf16(const void* x, const void* w, void* out,
                                  int E, int C, int D, int F, int act,
                                  void* stream) {
  if (E < 1 || C < 1 || D < 1 || F < 1 || act < kNone || act > kGelu)
    return int(cudaErrorInvalidValue);
  const dim3 grid((F + BN - 1) / BN, (C + BM - 1) / BM, E);
  expert_matmul_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<__nv_bfloat16*>(out), C, D, F, act);
  return int(cudaGetLastError());
}
