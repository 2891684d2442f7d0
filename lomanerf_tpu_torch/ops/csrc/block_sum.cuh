// The fixed-order sum of per-block partials shared by the gradient kernels
// (nerf_grad.cuh, field_bwd.cu): adding the blocks' partials in the same
// order every launch is what makes two launches on the same inputs give
// bit-identical gradients.

#pragma once

#include <cuda_runtime.h>

namespace {  // each kernel source gets its own copy

constexpr int kSumWarps = 32;  // block of the partials' sum

// out[p] = sum over blocks b of part[b * P + p], in a fixed order: warp w
// sums blocks w, w + kSumWarps, ... in turn, then warp 0 adds the warps'
// sums in order.  32 consecutive entries per block, so loads coalesce.
// Launch with (P + 31) / 32 blocks of kSumWarps * 32 threads.
__global__ void __launch_bounds__(kSumWarps * 32)
sum_block_partials(const float* __restrict__ part, int n_blocks, int P,
                   float* __restrict__ out) {
  __shared__ float red[kSumWarps][33];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int p = blockIdx.x * 32 + lane;
  float s = 0.0f;
  if (p < P) {
    for (int b = warp; b < n_blocks; b += kSumWarps) {
      s += part[static_cast<size_t>(b) * P + p];
    }
  }
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && p < P) {
    float total = 0.0f;
    for (int w = 0; w < kSumWarps; ++w) total += red[w][lane];
    out[p] = total;
  }
}

}  // namespace
