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
// a block (one tile) of this launch, and for a launch.
//
// What bounds it on this card: device memory.  Each value is read once,
// 4 B: 251.7 MB for (8, 7,864,320) (262,144 rays x 30 samples per row), at
// least 75.1 us at 3.35 TB/s; one add per value.
//
// The design: one block per tile, as one grid step per tile on the TPU.  A
// block cannot carry a running sum to the next one as a grid step does
// (blocks run in parallel, in no order), so each block writes its tile's
// sum to partials[tile]: every thread adds its columns (float4s, scalars
// where the array is not 16-byte aligned) in column order, 16 loads of a
// pair of columns in flight at a time, then a shuffle tree per warp and one
// over the warps' sums.  The last block to finish (a ticket counter, reset
// by that block for the next launch) adds the partials in a fixed order:
// one launch a call, and the order of every sum depends on the tile count
// only, never on which block finishes last, so repeat launches are
// bit-identical.  Block 0 zeroes the dummy outputs.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;               // threads per tile's block
constexpr int kWarps = kThreads / 32;
constexpr int kDummyFloats = 3 * 40 * 40;   // one dummy output
constexpr unsigned kFull = 0xffffffffu;

// the block's sum of one value per thread: a shuffle tree in each warp
// (lane l adds lane l + 16, then + 8, ...), then the same tree over the
// warps' sums in warp 0; the result in thread 0.  Ends with a barrier, so
// `red` may be reused at once.
__device__ __forceinline__ float block_total(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? red[lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
  }
  __syncthreads();
  return v;
}

__device__ __forceinline__ void add4(float& acc, const float4& v) {
  acc += v.x;
  acc += v.y;
  acc += v.z;
  acc += v.w;
}

// thread tid's share of a tile: columns tid, tid + kThreads, ... in order
// (float4 columns with kVec), each column's 8 rows in order
template <bool kVec>
__device__ __forceinline__ float thread_sum(const float* __restrict__ base, long long ld,
                                            int block) {
  float acc = 0.0f;
  if (kVec) {
    const int n4 = block / 4;
    int i = threadIdx.x;
    for (; i + kThreads < n4; i += 2 * kThreads) {
      float4 v[8], w[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        v[r] = reinterpret_cast<const float4*>(base + r * ld)[i];
        w[r] = reinterpret_cast<const float4*>(base + r * ld)[i + kThreads];
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) add4(acc, v[r]);
#pragma unroll
      for (int r = 0; r < 8; ++r) add4(acc, w[r]);
    }
    if (i < n4) {
      float4 v[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) v[r] = reinterpret_cast<const float4*>(base + r * ld)[i];
#pragma unroll
      for (int r = 0; r < 8; ++r) add4(acc, v[r]);
    }
  } else {
    for (int i = threadIdx.x; i < block; i += kThreads) {
      float v[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) v[r] = base[r * ld + i];
#pragma unroll
      for (int r = 0; r < 8; ++r) acc += v[r];
    }
  }
  return acc;
}

// scratch: [0] the ticket counter (zero between launches), then n_tiles
// partials
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
grid_sum_kernel(const float* __restrict__ x, long long ld, int block, int n_tiles,
                unsigned* __restrict__ scratch, float* __restrict__ out,
                float* __restrict__ dummies, int n_dummy) {
  __shared__ float red[kWarps];
  __shared__ bool last;
  const int tile = blockIdx.x, tid = threadIdx.x;
  float* partials = reinterpret_cast<float*>(scratch + 1);
  if (tile == 0) {
    for (int i = tid; i < n_dummy * kDummyFloats; i += kThreads) dummies[i] = 0.0f;
  }
  const float s = block_total(
      thread_sum<kVec>(x + static_cast<size_t>(tile) * block, ld, block), red);
  if (tid == 0) {
    partials[tile] = s;
    __threadfence();  // the partial is visible before the ticket is taken
    last = atomicAdd(scratch, 1u) == static_cast<unsigned>(n_tiles - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // partials tid, tid + kThreads, ... in order, loaded 8 at a time (from
  // L2: other blocks wrote them) before they are added
  float acc = 0.0f;
  for (int p0 = tid; p0 < n_tiles; p0 += 8 * kThreads) {
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int p = p0 + j * kThreads;
      v[j] = p < n_tiles ? __ldcg(partials + p) : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (p0 + j * kThreads < n_tiles) acc += v[j];
    }
  }
  acc = block_total(acc, red);
  if (tid == 0) {
    *out = acc;
    *scratch = 0u;  // ready for the next launch
  }
}

}  // namespace

// C entry point, bound with ctypes.  x: an (8, cols) f32 array with a row
// stride of ld floats; sums its first (cols / block) * block columns into
// out[0].  scratch: 1 + cols / block 32-bit words, the first of them zero
// (the kernel leaves it zero again); dummies: n_dummy * 4800 floats that
// block 0 zeroes (null when n_dummy is 0).  Returns the launch's
// cudaGetLastError() (0 on success); does not synchronise.
extern "C" int grid_sum(const float* x, long long ld, int cols, int block, void* scratch,
                        float* out, float* dummies, int n_dummy, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (block <= 0 || cols < 0 || ld < cols || n_dummy < 0 || (n_dummy > 0 && !dummies)) {
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
  unsigned* words = static_cast<unsigned*>(scratch);
  const bool vec = ld % 4 == 0 && block % 4 == 0 &&
                   reinterpret_cast<std::uintptr_t>(x) % 16 == 0;
  if (vec) {
    grid_sum_kernel<true><<<n_tiles, kThreads, 0, st>>>(x, ld, block, n_tiles, words, out,
                                                        dummies, n_dummy);
  } else {
    grid_sum_kernel<false><<<n_tiles, kThreads, 0, st>>>(x, ld, block, n_tiles, words, out,
                                                         dummies, n_dummy);
  }
  return static_cast<int>(cudaGetLastError());
}
