// The dW stage of the wide gradient sequence (nerf_wide_chain.cuh) for the
// bf16 compute dtype, on Hopper's warpgroup tensor cores (wgmma) fed by the
// Tensor Memory Accelerator (TMA):
//
//   C[z][m][n] = sum over the rows r of partial z of H[r][m] * Dz[r][n]
//
// H is the layer's input and Dz the bf16 copy of its output's d_z (the
// rounding plan's rnd(d_z), written beside the f32 d_z by its producers:
// composite_kernel and the d_h GEMM's kEpiMask epilogue), both (rows, ld)
// row-major; m < M and n < N are columns, the rows are the sum.  Partial z
// covers rows [z * kRowChunk, (z + 1) * kRowChunk), as the kEpiPartial
// call of gemm_mma_kernel that this replaces did, and sum_partials adds the
// partials in z order after it.
//
// What bounds it on this card: device memory.  At the flagship's 2,097,152
// rows x 256 x 256 a layer reads H and Dz once (2 x 1.07 GB of bf16) and
// writes 256 partials (67 MB): 0.66 ms at 3.35 TB/s, against 0.28 ms of
// bf16 tensor-core work.
//
// The design:
//   * a block computes 128 x 128 outputs of one partial: two consumer
//     warpgroups, each a 64 x 128 half (wgmma m64n128k16), and one producer
//     warp whose lane 0 issues the TMA copies;
//   * both operands are MN-major in device memory (m or n contiguous, the
//     row index strided), which wgmma takes for 16-bit types through its
//     transpose bits: TMA copies 32-row x 64-column boxes, 128-byte swizzled,
//     two per operand per stage, into a ring of kDwStages stages guarded by
//     full / empty mbarriers, so no thread scatters or converts a value;
//   * one stage is one 32-row k-step: two wgmma into a fresh accumulator set
//     (scale-d 0 on the first), then IEEE f32 adds into the running sum.
//     This is gemm_mma_kernel's promotion every 32 rows: the tensor core's
//     own accumulation truncates, and over the 8192 rows of a partial that
//     moved a flagship leaf by 3e-2 of its largest entry;
//   * ragged edges (the last partial's rows, layer 0's kc = 40 columns) are
//     zero-filled by TMA's out-of-bounds fill; a block whose second 64
//     columns of H lie past M skips that half (its second box of Dz past
//     N: that box, whose stale columns are never stored);
//   * grid (output tiles, partials) with the tile index fastest, so the
//     tiles of one partial run side by side and each operand box comes from
//     device memory about once and from L2 the second time.
// Every output is one thread's fixed sequence of k-steps: repeat launches
// are bit-identical.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is found at run time
#include <cstdint>

#include "mbarrier.cuh"
#include "nerf_wide_gemm.cuh"

namespace wide {
namespace {

constexpr int kDwBM = 128, kDwBN = 128;  // outputs per block
constexpr int kDwBK = 32;                // rows per k-step (stage)
constexpr int kDwBox = 64;               // columns per TMA box: 128 bytes of bf16
constexpr int kDwStages = 8;
constexpr int kDwBoxBytes = kDwBK * kDwBox * 2;  // 4 KB
constexpr int kDwStageBytes = 4 * kDwBoxBytes;   // H: 2 boxes, Dz: 2 boxes
constexpr int kDwThreads = 2 * 128 + 32;         // 2 consumer warpgroups + 1 producer warp

using mbar::mbar_arrive;
using mbar::mbar_expect_tx;
using mbar::mbar_init;
using mbar::mbar_wait;
using mbar::smem_u32;

// the box at (column c0, row c1) of `map` into dst, completing on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// wgmma descriptor of an MN-major operand in the 128-byte swizzle: atoms of
// 8 rows x 64 columns (1024 bytes), 64-column atoms `lbo` bytes apart (the
// leading byte offset), 8-row groups 1024 bytes apart (the stride byte
// offset).  Addresses and offsets in 16-byte units; layout type 1 = B128.
__device__ __forceinline__ uint64_t mn_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 | static_cast<uint64_t>(1024 >> 4) << 32 |
         static_cast<uint64_t>(1) << 62;
}

#define DW_R8(i)                                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),      \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (+)= A (64 x 16) B (16 x 128), A MN-major with kTransA 1 (the dW stage)
// or K-major with 0 (nerf_wide_mlp.cuh, nerf_wide_layer_gemm.cuh), B
// MN-major with kTransB 1 or K-major with 0 (the d_h GEMM's W^T); scale_d 0
// ignores d's old values
template <int kTransA, int kTransB = 1>
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : DW_R8(0), DW_R8(8), DW_R8(16), DW_R8(24), DW_R8(32), DW_R8(40), DW_R8(48),
        DW_R8(56)
      : "l"(da), "l"(db), "r"(scale_d), "n"(kTransA), "n"(kTransB));
}
#undef DW_R8

// keeps the compiler from moving reads or writes of d across an
// asynchronous wgmma's issue and its wait
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// grid (tiles_m * tiles_n, partials), block kDwThreads, dynamic shared
// memory for the ring of kStages stages and its 1024-byte alignment; a
// template only so that a source which includes this header and never
// launches it does not compile it
template <int kStages>
__global__ void __launch_bounds__(kDwThreads, 1)
dw_wgmma_kernel(const __grid_constant__ CUtensorMap tm_h,
                const __grid_constant__ CUtensorMap tm_d, int M, int N, int rows, int tiles_n,
                float* __restrict__ part) {
  extern __shared__ uint8_t dw_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  // the ring starts at a shared-memory address that is a multiple of 1024
  uint8_t* ring = dw_raw + ((1024 - (smem_u32(dw_raw) & 1023)) & 1023);
  const int m0 = blockIdx.x / tiles_n * kDwBM, n0 = blockIdx.x % tiles_n * kDwBN;
  const int z = blockIdx.y, r0 = z * kRowChunk;
  const int n_k = (min(rows - r0, kRowChunk) + kDwBK - 1) / kDwBK;
  // whether the tile's second 64 columns of H (of Dz) hold data
  const bool two_m = m0 + kDwBox < M, two_n = n0 + kDwBox < N;
  const int wg = threadIdx.x >> 7;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // the producer warp: lane 0 keeps the ring full
    if (threadIdx.x == 256) {
      const uint32_t bytes = (2 + two_m + two_n) * kDwBoxBytes;
      for (int i = 0; i < n_k; ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(&empty[s], ((i / kStages) - 1) & 1);
        uint8_t* a = ring + s * kDwStageBytes;
        uint8_t* b = a + 2 * kDwBoxBytes;
        const int row = r0 + i * kDwBK;
        mbar_expect_tx(&full[s], bytes);
        tma_load(a, &tm_h, m0, row, &full[s]);
        if (two_m) tma_load(a + kDwBoxBytes, &tm_h, m0 + kDwBox, row, &full[s]);
        tma_load(b, &tm_d, n0, row, &full[s]);
        if (two_n) tma_load(b + kDwBoxBytes, &tm_d, n0 + kDwBox, row, &full[s]);
      }
    }
    return;
  }

  // consumer warpgroup wg: outputs m0 + 64 wg .. + 63, n0 .. n0 + 127
  const bool active = wg == 0 || two_m;
  float acc[64], kstep[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = kstep[i] = 0.0f;
  for (int i = 0; i < n_k; ++i) {
    const int s = i % kStages;
    mbar_wait(&full[s], (i / kStages) & 1);
    if (active) {
      const uint32_t a = smem_u32(ring + s * kDwStageBytes + wg * kDwBoxBytes);
      const uint32_t b = smem_u32(ring + s * kDwStageBytes + 2 * kDwBoxBytes);
      fence_regs(kstep);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
      // rows 0-15, then 16-31 of the stage: 2 x 1024 bytes further
      wgmma_m64n128<1>(kstep, mn_desc(a, kDwBoxBytes), mn_desc(b, kDwBoxBytes), 0);
      wgmma_m64n128<1>(kstep, mn_desc(a + 2048, kDwBoxBytes), mn_desc(b + 2048, kDwBoxBytes), 1);
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      fence_regs(kstep);
    }
    if ((threadIdx.x & 127) == 0) mbar_arrive(&empty[s]);  // the stage is free again
    if (active) {
#pragma unroll
      for (int j = 0; j < 64; ++j) acc[j] += kstep[j];
    }
  }
  if (!active) return;

  // the m64n128 accumulator layout: warp w of the group holds rows 16 w ..
  // 16 w + 15; register 4 j + q is row lane / 4 (+ 8 for q >= 2), column
  // 8 j + 2 (lane % 4) (+ 1 for odd q)
  const int t = threadIdx.x & 127, lane = t & 31;
  const int m = m0 + wg * 64 + (t >> 5) * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int n = n0 + j * 8 + (lane & 3) * 2;
    if (n >= N) continue;
    if (m < M) {
      *reinterpret_cast<float2*>(part + (static_cast<size_t>(z) * M + m) * N + n) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
    }
    if (m + 8 < M) {
      *reinterpret_cast<float2*>(part + (static_cast<size_t>(z) * M + m + 8) * N + n) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled through the runtime (no -lcuda), or null
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The TMA map of the first `cols` columns of a (rows, ld) row-major matrix
// of bf16 (or, with f32, float) in boxes of box_rows rows x box_cols
// columns, 128-byte swizzled (a box row is 128 bytes); reads past `cols`
// or `rows` fill zeros, writes there are dropped.
inline cudaError_t tile_map(CUtensorMap* map, const void* X, bool f32, int cols, int rows,
                            int ld, int box_cols, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * (f32 ? 4 : 2)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult res = encode(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                              2, const_cast<void*>(X), dims, strides, box, steps,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The TMA map of the first `cols` columns of a (rows, ld) bf16 matrix, in
// boxes of kDwBK rows x kDwBox columns (tile_map).
inline cudaError_t dw_map(CUtensorMap* map, const __nv_bfloat16* X, int cols, int rows,
                          int ld) {
  return tile_map(map, X, false, cols, rows, ld, kDwBox, kDwBK);
}

// part[z][m][n] (z < ceil(rows / kRowChunk), m < M, n < N) from H and Dz,
// (rows, ld) bf16 row-major, 16-byte aligned, ld a multiple of 8
template <int kStages = kDwStages>
cudaError_t dw_gemm(const __nv_bfloat16* H, const __nv_bfloat16* Dz, int ld, int M, int N,
                    int rows, float* part, cudaStream_t stream) {
  const int n_parts = (rows + kRowChunk - 1) / kRowChunk;
  if (rows <= 0 || M <= 0 || N <= 0 || M > ld || N > ld || ld % 8 != 0 || N % 2 != 0 ||
      n_parts > 65535 || reinterpret_cast<uintptr_t>(H) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(Dz) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  constexpr int smem = kStages * kDwStageBytes + 1024;
  static_assert(smem <= 227 * 1024, "the ring exceeds a block's shared memory");
  CUtensorMap tm_h, tm_d;
  cudaError_t err = dw_map(&tm_h, H, M, rows, ld);
  if (err == cudaSuccess) err = dw_map(&tm_d, Dz, N, rows, ld);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(dw_wgmma_kernel<kStages>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }
  if (err != cudaSuccess) return err;
  const int tiles_n = (N + kDwBN - 1) / kDwBN;
  const int tiles = (M + kDwBM - 1) / kDwBM * tiles_n;
  dw_wgmma_kernel<kStages><<<dim3(tiles, n_parts), kDwThreads, smem, stream>>>(
      tm_h, tm_d, M, N, rows, tiles_n, part);
  return cudaGetLastError();
}

}  // namespace
}  // namespace wide
