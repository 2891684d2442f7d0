// Grid-overhead probe for Hopper (sm_90a): the sum of the first
// n_tiles * block columns of an (8, cols) f32 array, n_tiles = cols / block,
// in one launch of n_tiles blocks.
//
// Replaces the TPU kernel `kernel` of scripts/tpu_grid_overhead.py:36 (in
// main.make; its pallas_call at :56): a grid of n_tiles sequential steps,
// each adding one streamed (8, block) tile into a (1, 1) accumulator in
// VMEM, step 0 also zeroing the accumulator and 0 or 2 dummy (3, 40, 40)
// outputs.  The script sweeps the block size at constant bytes to price a
// grid step; lomanerf_tpu_torch/scripts/grid_overhead.py does the same for
// a block of this launch, and for a launch.
//
// What bounds it on this card: device memory.  Each value is read once,
// 4 B: 251.7 MB for (8, 7,864,320) (262,144 rays x 30 samples per row), at
// least 75.1 us at 3.35 TB/s; one add per value.
//
// The design: one block per tile, as one grid step per tile on the TPU.  A
// block cannot carry a running sum to the next one as a grid step does
// (blocks run in parallel, in no order), so each block writes its tile's
// sum to partials[tile]: every thread adds its float4s (scalars where the
// array is not 16-byte aligned) in a fixed order, then a shuffle tree per
// warp and one over the warps' sums.  A second kernel adds the partials in
// a fixed order (block_sum.cuh), so repeat launches are bit-identical.
// Block 0 zeroes the dummy outputs.

#include <cstdint>

#include "block_sum.cuh"

namespace {

constexpr int kThreads = 512;                // threads per tile's block
constexpr int kDummyFloats = 3 * 40 * 40;   // one dummy output
constexpr unsigned kFull = 0xffffffffu;

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
tile_sum_kernel(const float* __restrict__ x, long long ld, int block,
                float* __restrict__ partials, float* __restrict__ dummies,
                int n_dummy) {
  const int tile = blockIdx.x, tid = threadIdx.x;
  if (tile == 0) {
    for (int i = tid; i < n_dummy * kDummyFloats; i += kThreads) dummies[i] = 0.0f;
  }
  const float* base = x + static_cast<size_t>(tile) * block;
  float acc = 0.0f;
  // each step loads one column's 8 rows before adding them, so 8 loads
  // (128 B with float4) are in flight per thread
  if (kVec) {
    for (int i = tid; i < block / 4; i += kThreads) {
      float4 v[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) v[r] = reinterpret_cast<const float4*>(base + r * ld)[i];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        acc += v[r].x;
        acc += v[r].y;
        acc += v[r].z;
        acc += v[r].w;
      }
    }
  } else {
    for (int i = tid; i < block; i += kThreads) {
      float v[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) v[r] = base[r * ld + i];
#pragma unroll
      for (int r = 0; r < 8; ++r) acc += v[r];
    }
  }
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(kFull, acc, off);
  __shared__ float warp_sums[kThreads / 32];
  const int lane = tid & 31, warp = tid >> 5;
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    float s = lane < kThreads / 32 ? warp_sums[lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(kFull, s, off);
    if (lane == 0) partials[tile] = s;
  }
}

}  // namespace

// C entry point, bound with ctypes.  x: an (8, cols) f32 array with a row
// stride of ld floats; sums its first (cols / block) * block columns into
// out[0].  partials: cols / block floats of scratch; dummies: n_dummy * 4800
// floats that block 0 zeroes.  Returns the launches' cudaGetLastError() (0
// on success); does not synchronise.
extern "C" int grid_sum(const float* x, long long ld, int cols, int block,
                        float* partials, float* out, float* dummies,
                        int n_dummy, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (block <= 0 || cols < 0 || ld < cols || n_dummy < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_tiles = cols / block;
  if (n_tiles == 0) {
    cudaError_t err = cudaMemsetAsync(out, 0, sizeof(float), st);
    if (err == cudaSuccess && n_dummy > 0) {
      err = cudaMemsetAsync(dummies, 0, sizeof(float) * n_dummy * kDummyFloats, st);
    }
    return static_cast<int>(err);
  }
  const bool vec = ld % 4 == 0 && block % 4 == 0 &&
                   reinterpret_cast<std::uintptr_t>(x) % 16 == 0;
  if (vec) {
    tile_sum_kernel<true><<<n_tiles, kThreads, 0, st>>>(x, ld, block, partials,
                                                       dummies, n_dummy);
  } else {
    tile_sum_kernel<false><<<n_tiles, kThreads, 0, st>>>(x, ld, block, partials,
                                                        dummies, n_dummy);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_block_partials<<<1, kSumWarps * 32, 0, st>>>(partials, n_tiles, 1, out);
  return static_cast<int>(cudaGetLastError());
}
