// RG-LRU linear recurrence h_t = a_t h_{t-1} + b_t (h_0 = 0) for the port,
// in CUDA C++ for sm_90a.
//
// Replaces: src/repro/kernels/rglru.py, the Pallas TPU kernel `_rglru_kernel`
// (wrapper `rglru_scan`, `pl.pallas_call` at :59).
// Wrapper here: src/repro_torch/kernels/rglru.py::rglru_scan, which holds the
// plain version `reference_rglru_scan` beside it.
//
// a, b, h (B, S, W) float32, contiguous; every channel (b, w) is an
// independent recurrence over S with an fp32 state.
//
// What bounds it on the H100: bytes.  Each output reads a_t and b_t once and
// writes h_t once, 12 bytes for 2 flops: at the RG-LRU path's shape
// (recurrentgemma-9b, B 1, S 4096, W 4096) 201 MB, 60 us at 3.35 TB/s.
//
// Design: one pass, as the TPU kernel streams each (Bs, Bw) tile through
// VMEM once and keeps h in scratch.  A block owns one batch row's slab of
// WB channels and walks the whole sequence:
//   - A producer warp keeps a ring of NS stages in shared memory filled, each
//     SB steps x WB channels of a and of b, with a full and an empty
//     mbarrier per stage.
//   - One consumer lane per channel (WB / 32 consumer warps, one for WB <=
//     32) runs h = a h + b step by step from the stage, the loads of UNROLL
//     steps issued before their dependent multiply-adds.  The arithmetic is
//     the sequential recurrence itself: two launches give the same bits.
//   - Two instantiations, chosen by the wrapper from the shape and the
//     pointers:
//       TMA (W a multiple of 4 and every base 16-byte aligned, the tensor
//       maps' rules): one lane of the producer loads a stage as two boxes of
//       a 3-D tensor map of (W, S, B) (TMA zero-fills steps past S and
//       channels past W), completion counted on the full barrier in bytes.
//       The consumers write h into one of NO output stages, which one lane
//       stores by TMA (clipped at S and W) while the next stage is scanned.
//       Any other W or base: the producer warp copies a stage with 4-byte
//       `cp.async`s, each lane arriving on the full barrier when its copies
//       land (`cp.async.mbarrier.arrive.noinc`), and the consumers store h
//       straight from registers, a warp's stores of a step one coalesced
//       row.
// Sizing at the path's shape (1, 4096, 4096), from a sweep on an H100
// (scripts/rglru_timing.py --config; PERF.md, section 6): WB 64 channels
// (256-byte rows, two consumer warps) and SB 128 steps, so that each box of
// a or b is 32 KB, with NS 2 stages and NO 2 output stages (192 KB of
// shared memory), gives 64 blocks that run at 1.02-1.03 times
// torch.add(a, b, out=h), which moves the same bytes.  128-byte rows (WB
// 32, 128 blocks) ran 6-11 % slower at every stage length and count tried
// (WB 16 slower still), and more stages of smaller boxes were no faster.
// The serial chain of 4,096 multiply-adds a lane hides under the loads.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WB = 64;      // channels of a block (its slab)
constexpr int SB = 128;     // steps of a ring stage
constexpr int NS = 2;       // stages in the ring
constexpr int NO = 2;       // output stages (TMA instantiation)
constexpr int UNROLL = 16;  // steps whose loads are issued together
constexpr int CONSUMERS = WB > 32 ? WB / 32 : 1;  // consumer warps
constexpr int THREADS = 32 * (CONSUMERS + 1);     // and the producer warp
constexpr int STAGE = SB * WB;  // floats of a (and of b) in a stage
static_assert(WB % 16 == 0 && (WB <= 32 || WB % 32 == 0),
              "a slab is 16 or 32 channels, or whole warps of them");
static_assert(SB % UNROLL == 0 && SB <= 256, "a stage is whole unrolled "
              "groups of steps and at most a TMA box of 256 rows");

// Shared memory: the ring (a, b per stage), the output stages, the barriers,
// and 128 bytes to align the ring for TMA.
constexpr size_t smem_bytes(bool tma) {
  return (size_t(NS) * 2 * STAGE + (tma ? size_t(NO) * STAGE : 0)) * 4 +
         2 * NS * 8 + 128;
}
static_assert(smem_bytes(true) <= 232448, "past a block's shared memory");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// The consumers' own barrier (the producer warp never joins it).
__device__ __forceinline__ void consumers_sync() {
  if constexpr (CONSUMERS == 1) {
    __syncwarp();
  } else {
    asm volatile("bar.sync 1, %0;\n" ::"n"(32 * CONSUMERS) : "memory");
  }
}

// Steps [0, rows) of one channel from state h: a_s and b_s point at its
// column of the stage (WB floats from one step to the next); each h_t goes
// to put(r, h).  FULL: rows is SB, unrolled whole.
template <bool FULL, typename Put>
__device__ __forceinline__ float scan_stage(const float* a_s, const float* b_s,
                                            int rows, float h, Put put) {
  if constexpr (FULL) {
#pragma unroll
    for (int r0 = 0; r0 < SB; r0 += UNROLL) {
      float av[UNROLL], bv[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        av[u] = a_s[(r0 + u) * WB];
        bv[u] = b_s[(r0 + u) * WB];
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        h = fmaf(av[u], h, bv[u]);
        put(r0 + u, h);
      }
    }
  } else {
    for (int r = 0; r < rows; ++r) {
      h = fmaf(a_s[r * WB], h, b_s[r * WB]);
      put(r, h);
    }
  }
  return h;
}

// One block per (batch row, slab of WB channels), blockIdx.x = row * slabs +
// slab.  TMA: a, b and h through the maps (the pointers unused); else
// through the pointers (the maps unused).
template <bool TMA>
__global__ void __launch_bounds__(THREADS)
rglru_scan_kernel(const __grid_constant__ CUtensorMap a_map,
                  const __grid_constant__ CUtensorMap b_map,
                  const __grid_constant__ CUtensorMap h_map,
                  const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ out, int S, int W) {
  extern __shared__ float4 smem4[];
  float* const ring = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(smem4) +
      ((128u - (smem_u32(smem4) & 127u)) & 127u));
  float* const outs = ring + NS * 2 * STAGE;  // NO output stages (TMA)
  const uint32_t bars = smem_u32(outs + (TMA ? NO * STAGE : 0));
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (NS + s); };

  const int slabs = (W + WB - 1) / WB;
  const int bi = int(blockIdx.x) / slabs;
  const int w0 = int(blockIdx.x) % slabs * WB;
  const int stages = (S + SB - 1) / SB;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full(s), TMA ? 1 : 32);
      mbar_init(empty(s), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMERS) {
    // ------------------------------------------------------------ producer --
    for (int k = 0; k < stages; ++k) {
      const int s = k % NS;
      float* const a_s = ring + s * 2 * STAGE;
      if constexpr (TMA) {
        if (lane == 0) {
          mbar_wait(empty(s), ((k / NS) & 1) ^ 1);
          mbar_expect_tx(full(s), 2 * STAGE * 4);
          tma_load(smem_u32(a_s), &a_map, full(s), w0, k * SB, bi);
          tma_load(smem_u32(a_s + STAGE), &b_map, full(s), w0, k * SB, bi);
        }
      } else {
        mbar_wait(empty(s), ((k / NS) & 1) ^ 1);
        const int rows = min(SB, S - k * SB);
        const size_t row0 = (size_t(bi) * S + size_t(k) * SB) * W + w0;
        for (int i = lane; i < rows * WB; i += 32) {
          const int r = i / WB, c = i % WB;
          if (w0 + c < W) {
            const size_t g = row0 + size_t(r) * W + c;
            cp_async4(smem_u32(a_s + i), a + g);
            cp_async4(smem_u32(a_s + STAGE + i), b + g);
          }
        }
        asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
                     ::"r"(full(s)) : "memory");
      }
    }
  } else {
    // ----------------------------------------------------------- consumers --
    const int c = warp * 32 + lane;  // this lane's channel in the slab
    const bool live = c < WB;
    const bool stores = threadIdx.x == 0;  // the lane that stores by TMA
    float* const h_g = out + size_t(bi) * S * W + w0 + c;
    const bool in_w = w0 + c < W;
    float h = 0.f;
    for (int k = 0; k < stages; ++k) {
      const int s = k % NS;
      const int rows = min(SB, S - k * SB);
      const float* const a_s = ring + s * 2 * STAGE + c;
      const float* const b_s = a_s + STAGE;
      float* const o_s = outs + (k % NO) * STAGE + c;
      if constexpr (TMA) {
        // the store of stage k - NO has read this output stage
        if (stores)
          asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(NO - 1)
                       : "memory");
        consumers_sync();
      }
      mbar_wait(full(s), (k / NS) & 1);
      if (live) {
        if constexpr (TMA) {
          auto put = [&](int r, float v) { o_s[r * WB] = v; };
          h = rows == SB ? scan_stage<true>(a_s, b_s, rows, h, put)
                         : scan_stage<false>(a_s, b_s, rows, h, put);
        } else {
          float* const h_k = h_g + size_t(k) * SB * W;
          auto put = [&](int r, float v) {
            if (in_w) h_k[size_t(r) * W] = v;
          };
          h = rows == SB ? scan_stage<true>(a_s, b_s, rows, h, put)
                         : scan_stage<false>(a_s, b_s, rows, h, put);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
      if constexpr (TMA) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        consumers_sync();
        if (stores) {
          tma_store(&h_map, smem_u32(outs + (k % NO) * STAGE), w0, k * SB, bi);
          asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        }
      }
    }
    if (TMA && stores)
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

// A TMA map of the contiguous float32 tensor (B, S, W) at ptr whose box is
// one stage of one slab: SB steps x WB channels.  Each row of a box is WB * 4
// bytes, so the L2 promotion is no wider than that.
bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int W) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {cuuint64_t(W), cuuint64_t(S), cuuint64_t(B)};
  const cuuint64_t strides[2] = {cuuint64_t(W) * 4,
                                 cuuint64_t(S) * cuuint64_t(W) * 4};
  const cuuint32_t box[3] = {cuuint32_t(WB), cuuint32_t(SB), 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUtensorMapL2promotion promotion =
      WB * 4 >= 256 ? CU_TENSOR_MAP_L2_PROMOTION_L2_256B
      : WB * 4 >= 128 ? CU_TENSOR_MAP_L2_PROMOTION_L2_128B
                      : CU_TENSOR_MAP_L2_PROMOTION_L2_64B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr),
                dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE, promotion,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool TMA>
int launch(const CUtensorMap& a_map, const CUtensorMap& b_map,
           const CUtensorMap& h_map, const float* a, const float* b,
           float* out, int B, int S, int W, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      rglru_scan_kernel<TMA>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem_bytes(TMA)));
  if (err != cudaSuccess) return int(err);
  const long long blocks = (long long)B * ((W + WB - 1) / WB);
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidConfiguration);
  rglru_scan_kernel<TMA><<<unsigned(blocks), THREADS, smem_bytes(TMA),
                           stream>>>(a_map, b_map, h_map, a, b, out, S, W);
  return int(cudaGetLastError());
}

}  // namespace

// Returns the CUDA error of the launch (0 when it was accepted).  tma: 1 for
// the TMA instantiation, which needs W a multiple of 4 and every pointer
// 16-byte aligned (else the error is cudaErrorMisalignedAddress); 0 for the
// cp.async one, which takes any W and any float-aligned pointer.
extern "C" int rglru_scan_f32(const void* a, const void* b, void* out, int B,
                              int S, int W, int tma, void* stream) {
  if (B < 1 || S < 1 || W < 1) return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  float* of = static_cast<float*>(out);
  CUtensorMap maps[3] = {};
  if (!tma) return launch<false>(maps[0], maps[1], maps[2], af, bf, of, B, S, W, s);
  if (W % 4 || (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
                reinterpret_cast<uintptr_t>(out)) % 16)
    return int(cudaErrorMisalignedAddress);
  if (!make_map(&maps[0], a, B, S, W) || !make_map(&maps[1], b, B, S, W) ||
      !make_map(&maps[2], out, B, S, W))
    return int(cudaErrorInvalidValue);
  return launch<true>(maps[0], maps[1], maps[2], af, bf, of, B, S, W, s);
}
