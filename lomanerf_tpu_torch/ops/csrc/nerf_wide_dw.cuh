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
// What bounds it on this card: arithmetic at 1024 wide, device memory at
// 256.  An 8x1024 gradient chunk's hidden layer, 598,784 rows x 1024 x
// 1024, is 1.28 TFLOP (1.30 ms at the bf16 peak) against 2.45 GB of H and
// Dz and 0.31 GB of partials (0.82 ms at 3.35 TB/s).  At the flagship's
// 2,097,152 rows x 256 x 256 a layer reads H and Dz once (2 x 1.07 GB) and
// writes 256 partials (67 MB): 0.66 ms, against 0.28 ms of tensor-core work.
//
// The sums: each 32-row set of a partial is summed by the tensor core (two
// wgmma m64n128k16, scale-d 0 on the first), and the set is added to the
// partial's f32 running sum by IEEE adds, the sets in ascending rows.  This
// is gemm_mma_kernel's promotion every 32 rows, bit for bit.  The tensor
// core's own accumulation truncates: over the 8192 rows of a partial it
// moved a flagship leaf by 3e-2 of its largest entry, and 64-row sets would
// move every digest of the gradient entries (chip_smoke.py), so the
// interval stays 32 rows.
//
// The design:
//   * a work item is one partial's output tile of 128 rows (m) x 256
//     columns (n); min(items, SMs) persistent blocks walk them, the tile
//     index fastest, so that the tiles of one partial run side by side and
//     read each operand box from device memory about once and from L2 the
//     other times;
//   * two consumer warpgroups, each owning 64 rows of the tile as two
//     halves of 128 columns (wgmma m64n128k16), and a producer warpgroup
//     whose first thread issues the TMA copies and whose registers
//     setmaxnreg hands to the consumers (40 and 232); the producer runs
//     ahead across work items, so an item's first stages fill under the
//     last item's products;
//   * both operands are MN-major in device memory (m or n contiguous, the
//     row index strided), which wgmma takes for 16-bit types through its
//     transpose bits: TMA copies 32-row x 64-column boxes, 128-byte swizzled,
//     two of H and four of Dz per stage, into a ring of kDwStages stages
//     guarded by full / empty mbarriers, so no thread scatters or converts
//     a value;
//   * a stage is one 32-row set: for each half, its two k16 steps into the
//     fresh accumulator set as one commit group, and once that has finished
//     (wait_group 0) IEEE adds into the half's running sum (three sets of
//     64 registers: two running sums, one fresh set; the second half's
//     commit frees the stage, one arrival a warp).  The warpgroups do not
//     wait for each other, so one's adds and its epilogue (stores straight
//     from registers) run under the other's products;
//   * where 256-column tiles would leave SMs idle, 128-column ones: dw_gemm
//     takes the walk with fewer rounds of the SMs, a round of 128 columns
//     weighed as 3/5 of one of 256 (the published NeRF's passes: 32 or 96
//     partials of 256 x 256, 1 round against 1, 3 against 2);
//   * ragged edges (the last partial's rows, layer 0's kc = 40 columns) are
//     zero-filled by TMA's out-of-bounds fill; a box of H or Dz whose 64
//     columns lie past M or N is not copied, and the outputs computed from
//     whatever that part of the stage holds (the second warpgroup's where
//     M ends in the tile's first 64 rows, a half's last 64 columns) are
//     never stored.
// What scripts/dw_variants measured on an H100 (an 8x1024 chunk's layer, in
// turns; the 128 x 128 kernel this replaces 3.87-4.02 ms, this one
// 2.74-2.86; the flagship's 0.89 -> 0.74): 128 x 128 tiles with two fresh
// sets, each added under the next set's products (wait_group 1), 3.62 ms:
// 16 KB of operands a stage for 128 x 128 x 32 products, the feed the
// limit; 256-column tiles cut the operand bytes a product by a quarter but
// leave no registers for a second fresh set.  The warpgroups taking turns
// to issue (nerf_wide_mlp.cuh's named barriers) 3.03 ms; a cluster of two
// blocks that multicasts Dz 3.69; 64-row stages and twelve stages no gain;
// the second warpgroup skipping its products where the tile's rows end in
// its first 64 (layer 0) 3.04; each partial's tiles started one further
// on, so that the ragged ones spread over the blocks, 2.80 (its gain on the
// published NeRF's ragged calls smaller than its loss on the rest).  Taken
// out one at a time, the waits for data, the products or the adds each
// leave 2.3-2.6 ms: the feed and the issue of products and adds are both
// near the kernel's time.
// Every output is one thread's fixed sequence of wgmma and adds: repeat
// launches are bit-identical.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is found at run time

#include <algorithm>
#include <climits>
#include <cstdint>

#include "mbarrier.cuh"
#include "nerf_wide_gemm.cuh"

namespace wide {
namespace {

constexpr int kDwBM = 128, kDwBN = 256;  // outputs per work item, at most
constexpr int kDwBK = 32;                // rows per stage: one set, one promotion
constexpr int kDwBox = 64;               // columns per TMA box: 128 bytes of bf16
constexpr int kDwBoxBytes = kDwBK * kDwBox * 2;  // 4 KB
constexpr int kDwStageBytes = 6 * kDwBoxBytes;   // H: 2 boxes, Dz: 4 boxes
constexpr int kDwStages = 8;
constexpr int kDwThreads = 3 * 128;              // 2 consumer warpgroups + the producer's

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

// A work item: rows [r0, r0 + kRowChunk) of the partial, n_sets sets, the
// output tile at (m0, n0) of kDwBM rows x bn columns; the tile index is
// fastest, the column tile fastest within it
struct DwItem {
  int r0, m0, n0, n_sets;
};
__device__ __forceinline__ DwItem dw_item(int item, int tiles, int tiles_n, int bn, int rows) {
  const int tile = item % tiles, r0 = item / tiles * kRowChunk;
  return {r0, tile / tiles_n * kDwBM, tile % tiles_n * bn,
          (min(rows - r0, kRowChunk) + kDwBK - 1) / kDwBK};
}

// grid min(items, SMs), block kDwThreads, dynamic shared memory for the
// ring of kStages stages and its 1024-byte alignment; tiles of bn (128 or
// 256) columns, tiles_n of them across N; a template only so that a source
// which includes this header and never launches it does not compile it
template <int kStages>
__global__ void __launch_bounds__(kDwThreads, 1)
dw_wgmma_kernel(const __grid_constant__ CUtensorMap tm_h,
                const __grid_constant__ CUtensorMap tm_d, int M, int N, int rows, int bn,
                int tiles_n, int tiles, int items, float* __restrict__ part) {
  extern __shared__ uint8_t dw_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  // the ring starts at a shared-memory address that is a multiple of 1024
  uint8_t* ring = dw_raw + ((1024 - (smem_u32(dw_raw) & 1023)) & 1023);
  const int wg = threadIdx.x >> 7;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // the roles never reconverge, so that setmaxnreg moves the producer's
  // registers to the consumers: 128 x 40 + 256 x 232 = 384 x 168
  if (wg == 2) {  // the producer warpgroup: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (threadIdx.x == 256) {
      int it = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const DwItem w = dw_item(item, tiles, tiles_n, bn, rows);
        // the boxes of the tile's 64-column blocks of H (of Dz) that hold data
        const int boxes_m = min(2, (M - w.m0 + kDwBox - 1) / kDwBox);
        const int boxes_n = min(bn / kDwBox, (N - w.n0 + kDwBox - 1) / kDwBox);
        const uint32_t bytes = (boxes_m + boxes_n) * kDwBoxBytes;
        for (int st = 0; st < w.n_sets; ++st, ++it) {
          const int s = it % kStages;
          if (it >= kStages) mbar_wait(&empty[s], ((it / kStages) - 1) & 1);
          uint8_t* a = ring + s * kDwStageBytes;
          uint8_t* b = a + 2 * kDwBoxBytes;
          const int row = w.r0 + st * kDwBK;
          mbar_expect_tx(&full[s], bytes);
          for (int j = 0; j < boxes_m; ++j) {
            tma_load(a + j * kDwBoxBytes, &tm_h, w.m0 + j * kDwBox, row, &full[s]);
          }
          for (int j = 0; j < boxes_n; ++j) {
            tma_load(b + j * kDwBoxBytes, &tm_d, w.n0 + j * kDwBox, row, &full[s]);
          }
        }
      }
    }
  } else {  // consumer warpgroup wg: outputs m0 + 64 wg .. + 63, n0 .. n0 + bn - 1
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
    const int t = threadIdx.x & 127, lane = t & 31;
    const uint32_t ring_s = smem_u32(ring);
    // the running sums of the tile's two 128-column halves, the fresh set
    float acc0[64], acc1[64], ks[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) ks[i] = 0.0f;
    int it = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const DwItem w = dw_item(item, tiles, tiles_n, bn, rows);
      // whether the tile's second half holds data
      const bool two_halves = bn > kDwBN / 2 && w.n0 + kDwBN / 2 < N;
#pragma unroll
      for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0.0f;
      // a half's set: its two k16 steps (rows 0-15, then 16-31: 2 x 1024
      // bytes further) of the warpgroup's 64 columns of H and the half's
      // 128 columns of Dz, one commit group; once it has finished, the
      // thread adds it to the half's running sum while the other
      // warpgroup's set runs.  The last half of a stage frees the stage
      // (one arrival a warp).  Where the tile's rows end in the first 64
      // (layer 0), the second warpgroup computes from whatever its box of
      // the stage holds and stores nothing: skipping its products saved
      // 0.02 ms at an 8x1024 chunk's layer 0 but cost 0.3 at its hidden
      // layers, whose loop the branch slowed
      auto half = [&](float(&sum)[64], uint32_t a, uint32_t b, int s, bool last) {
        fence_regs(ks);
        asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
        wgmma_m64n128<1>(ks, mn_desc(a, kDwBoxBytes), mn_desc(b, kDwBoxBytes), 0);
        wgmma_m64n128<1>(ks, mn_desc(a + 2048, kDwBoxBytes), mn_desc(b + 2048, kDwBoxBytes), 1);
        asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
        fence_regs(ks);
        if (last && lane == 0) mbar_arrive(&empty[s]);
#pragma unroll
        for (int q = 0; q < 64; ++q) sum[q] += ks[q];
      };
      for (int st = 0; st < w.n_sets; ++st, ++it) {
        const int s = it % kStages;
        const uint32_t a = ring_s + s * kDwStageBytes + wg * kDwBoxBytes;
        const uint32_t b = ring_s + s * kDwStageBytes + 2 * kDwBoxBytes;
        mbar_wait(&full[s], (it / kStages) & 1);
        half(acc0, a, b, s, !two_halves);
        if (two_halves) half(acc1, a, b + 2 * kDwBoxBytes, s, true);
      }

      // the epilogue, straight from registers: the m64n128 accumulator
      // layout puts rows lane / 4 (+ 8 for q >= 2) of warp w's 16 in
      // register 4 j + q, column 8 j + 2 (lane % 4) (+ 1 for odd q); rows
      // past M (all of the second warpgroup's where M ends in the first 64)
      // and columns past N or the tile are not stored
      const int m = w.m0 + wg * 64 + (t >> 5) * 16 + (lane >> 2);
      float* out = part + static_cast<size_t>(w.r0 / kRowChunk) * M * N;
      auto store = [&](const float(&sum)[64], int nh) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int n = nh + j * 8 + (lane & 3) * 2;
          if (n >= N) continue;
          if (m < M) {
            *reinterpret_cast<float2*>(out + static_cast<size_t>(m) * N + n) =
                make_float2(sum[4 * j], sum[4 * j + 1]);
          }
          if (m + 8 < M) {
            *reinterpret_cast<float2*>(out + static_cast<size_t>(m + 8) * N + n) =
                make_float2(sum[4 * j + 2], sum[4 * j + 3]);
          }
        }
      };
      store(acc0, w.n0);
      if (two_halves) store(acc1, w.n0 + kDwBN / 2);
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
  if (rows <= 0 || M <= 0 || N <= 0 || M > ld || N > ld || ld % 8 != 0 || N % 2 != 0 ||
      reinterpret_cast<uintptr_t>(H) % 16 != 0 || reinterpret_cast<uintptr_t>(Dz) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  constexpr int smem = kStages * kDwStageBytes + 1024;
  static_assert(smem + 16 * kStages <= 227 * 1024, "the ring exceeds a block's shared memory");
  auto* kernel = dw_wgmma_kernel<kStages>;
  CUtensorMap tm_h, tm_d;
  cudaError_t err = tile_map(&tm_h, H, false, M, rows, ld, kDwBox, kDwBK);
  if (err == cudaSuccess) err = tile_map(&tm_d, Dz, false, N, rows, ld, kDwBox, kDwBK);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // The tiles' width: 256 columns, or 128 where that walk takes fewer
  // rounds of the SMs, a round of 128-column tiles counting 3/5 of one of
  // 256.  On an H100 (scripts/dw_variants) an item takes 0.65-0.79 times as
  // long at 128 columns as at 256; the published NeRF's passes, 32 and 96
  // partials of 256 x 256, are 21% faster on 1 round of 128 than on 1 of
  // 256 and even on 3 rounds of 128 against 2 of 256, the flagship's 256
  // partials 31% slower on 8 rounds than on 4
  const long long parts = (rows + kRowChunk - 1) / kRowChunk, tiles_m = (M + kDwBM - 1) / kDwBM;
  auto items_of = [&](int bn) { return parts * tiles_m * ((N + bn - 1) / bn); };
  auto rounds = [&](int bn) { return (items_of(bn) + sms - 1) / sms; };
  const int bn = 3 * rounds(kDwBN / 2) < 5 * rounds(kDwBN) ? kDwBN / 2 : kDwBN;
  const int tiles_n = (N + bn - 1) / bn;
  const long long items = items_of(bn);
  if (items > INT_MAX) return cudaErrorInvalidValue;
  kernel<<<static_cast<int>(std::min<long long>(items, sms)), kDwThreads, smem, stream>>>(
      tm_h, tm_d, M, N, rows, bn, tiles_n, static_cast<int>(tiles_m * tiles_n),
      static_cast<int>(items), part);
  return cudaGetLastError();
}

}  // namespace
}  // namespace wide
