// Segmented scans for Hopper (sm_90a): the inclusive cumulative product,
// the suffix sum or the shift down with fill, over an f32 column of R * S
// values in segments of S (ray-major: a ray's S samples contiguous).
//
// Replaces the TPU kernel `k` of tests/test_pallas_kernels.py:46 (its
// pallas_call at :49), which runs lomanerf_tpu/ops/pallas_utils.py's
// seg_inclusive_cumprod, seg_suffix_sum or seg_shift_down on an (R*S, 1)
// column inside a kernel, so that pltpu.roll is legal there.
//
// What bounds it on this card: device memory.  Each value is read once and
// written once, 8 B: 62.9 MB for the 262,144-ray x 30-sample column, at
// least 18.8 us at 3.35 TB/s; the work is one dependent operation a value.
// A thread that walks its own segment straight from device memory (the
// direct walk below) touches addresses S floats apart across a warp: one
// 32-B sector a thread and access, far from the memory's rate.
//
// The design: a warp owns a run of 32 whole segments, 32 S floats
// contiguous in memory.
// - It stages the run into its own tile of shared memory with coalesced
//   copies: cp.async of 4 B a lane, 128 B a warp instruction, the whole run
//   in flight at once and no register round trip.  4-B copies need no more
//   alignment than the f32 itself, so a column at any storage offset and a
//   ragged last run (fewer than 32 segments) take the same path.
// - Each lane walks its segment in place with seg_scan.cuh's functions: the
//   same IEEE operations in the same order as the NeRF kernels' scans and
//   the direct walk, so every output bit is theirs.
// - The warp writes the run back with coalesced 4-B stores.
// Banks: segment r of the run sits at r * P in the tile, P = S | 1 (odd), so
// lane t reading sample s hits bank (t P + s) mod 32, distinct over the
// warp: the walk is free of bank conflicts at every S (at P = S an even S
// conflicts 2-way at S = 30 and 32-way at S = 64).  Bytes in flight: up to
// kWarps warps a block, each with its own tile and no block barrier; at
// S = 30 a block takes 15.9 KB and 13 blocks (52 warps, ~200 KB of copies
// in flight) fit an SM, where ~20 KB an SM fill the memory's pipe.
// An S whose 32-segment run does not fit a block's shared memory
// (S > 1815) takes the direct walk, chosen by S alone.  The host mirror of
// this choice is lomanerf_tpu_torch/ops/scans.py:scan_plan.

#include <algorithm>

#include "seg_scan.cuh"

namespace {

constexpr int kWarps = 4;          // warps (32-segment runs) a block, at most
constexpr int kSmemMax = 232448;   // dynamic shared memory a block may take
constexpr int kSmemDefault = 49152;  // above it, after cudaFuncSetAttribute
constexpr int kWalkThreads = 256;  // segments a block of the direct walk

enum Op { kCumprod = 0, kSuffix = 1, kShift = 2 };

template <int kOp>
__device__ __forceinline__ void walk(const float* x, float* out, int S, float fill) {
  if (kOp == kCumprod) seg::inclusive_cumprod(x, out, S);
  if (kOp == kSuffix) seg::suffix_sum(x, out, S);
  if (kOp == kShift) seg::shift_down(x, out, S, fill);
}

__device__ __forceinline__ void copy4_async(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

// The staged scan: warp w of block b owns segments [32 (b kWarps' + w), +32)
// (kWarps' = blockDim.x / 32), tile stride P = S | 1.  Value g of the run
// (segment r = g / S, sample s = g % S) sits at tile[r P + s] = tile[g + r
// (P - S)]; a lane steps g by 32 and carries (r, s) along, one division a
// lane and run.
template <int kOp>
__global__ void __launch_bounds__(32 * kWarps)
seg_scan_staged(const float* __restrict__ x, float* __restrict__ out, int n_seg,
                int S, int P, float fill) {
  extern __shared__ float tiles[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long seg0 = (static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp) * 32;
  if (seg0 >= n_seg) return;
  const int n = static_cast<int>(min(32LL, n_seg - seg0));
  const int E = n * S;
  const int skew = P - S, q = 32 / S, rem = 32 - q * S;
  const size_t base = static_cast<size_t>(seg0) * S;
  float* tile = tiles + warp * 32 * P;
  const int r0 = lane / S, s0 = lane - r0 * S;

  int r = r0, s = s0;
#pragma unroll 4
  for (int g = lane; g < E; g += 32) {
    copy4_async(tile + g + r * skew, x + base + g);
    r += q;
    s += rem;
    if (s >= S) s -= S, ++r;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();
  if (lane < n) walk<kOp>(tile + lane * P, tile + lane * P, S, fill);
  __syncwarp();
  r = r0, s = s0;
#pragma unroll 4
  for (int g = lane; g < E; g += 32) {
    out[base + g] = tile[g + r * skew];
    r += q;
    s += rem;
    if (s >= S) s -= S, ++r;
  }
}

// The direct walk: one thread a segment, straight from device memory.
template <int kOp>
__global__ void __launch_bounds__(kWalkThreads)
seg_scan_direct(const float* __restrict__ x, float* __restrict__ out, int n_seg, int S,
                float fill) {
  const int r = blockIdx.x * kWalkThreads + threadIdx.x;
  if (r >= n_seg) return;
  const size_t base = static_cast<size_t>(r) * S;
  walk<kOp>(x + base, out + base, S, fill);
}

template <int kOp>
cudaError_t launch(const float* x, float* out, int n_seg, int S, float fill,
                   cudaStream_t st) {
  const int P = S | 1;
  const long long run_bytes = 32LL * P * static_cast<long long>(sizeof(float));
  const int warps = static_cast<int>(std::min<long long>(kWarps, kSmemMax / run_bytes));
  if (warps == 0) {
    seg_scan_direct<kOp><<<(n_seg + kWalkThreads - 1) / kWalkThreads, kWalkThreads, 0,
                           st>>>(x, out, n_seg, S, fill);
    return cudaGetLastError();
  }
  const int smem = warps * static_cast<int>(run_bytes);
  if (smem > kSmemDefault) {
    const cudaError_t err = cudaFuncSetAttribute(
        seg_scan_staged<kOp>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const int per_block = 32 * warps;
  seg_scan_staged<kOp><<<(n_seg + per_block - 1) / per_block, per_block, smem, st>>>(
      x, out, n_seg, S, P, fill);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes.  x and out: n_rows f32 values, n_rows a
// multiple of S; op 0 the inclusive cumprod, 1 the suffix sum, 2 the shift
// down (out[0] = fill per segment).  Returns the launch's
// cudaGetLastError() (0 on success); does not synchronise.
extern "C" int seg_scans(const float* x, float* out, int n_rows, int S, int op,
                         float fill, void* stream) {
  if (S <= 0 || n_rows < 0 || n_rows % S != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_seg = n_rows / S;
  if (n_seg == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (op) {
    case kCumprod: return static_cast<int>(launch<kCumprod>(x, out, n_seg, S, fill, st));
    case kSuffix: return static_cast<int>(launch<kSuffix>(x, out, n_seg, S, fill, st));
    case kShift: return static_cast<int>(launch<kShift>(x, out, n_seg, S, fill, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
