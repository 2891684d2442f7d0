// The segmented scans of NeRF compositing, over one segment (one ray's S
// samples), walked by one thread in order: the counterparts of the TPU
// helpers lomanerf_tpu/ops/pallas_utils.py:seg_inclusive_cumprod,
// seg_suffix_sum and seg_shift_down, which scan a whole tile at once by
// masked rolls (Hillis-Steele).
//
// The step functions are what the NeRF kernels call inside their
// per-sample loops: the running product of the transmittance
// (nerf_common.cuh:transmittance, nerf_wide_common.cuh:composite_kernel)
// and the adjoint's suffix sum (nerf_grad.cuh, composite_kernel).  The
// segment functions below are built from the same steps, and seg_scans.cu
// exposes them, so the scans every ray composites with are tested alone.
//
// Exactness: each step is one IEEE operation in the order written, with
// nothing for the compiler to contract: the product P * c, and the suffix
// sum's acc + a * b as one fmaf (the adjoint's d_P * P_s term).  A plain
// suffix sum is the same step with b = 1: a * 1 is exact, so the fused form
// rounds once, as acc + a does.

#pragma once

#include <cuda_runtime.h>

namespace seg {
namespace {  // each kernel source gets its own copy

// One step of the inclusive running product: P <- P * c; returns the new P.
__device__ __forceinline__ float cumprod_step(float& P, float c) {
  P *= c;
  return P;
}

// One step of a suffix sum walked from the segment's end:
// acc <- acc + a * b, rounded once; returns the new acc.
__device__ __forceinline__ float suffix_step(float& acc, float a,
                                             float b = 1.0f) {
  acc = fmaf(a, b, acc);
  return acc;
}

// out[s] = x[0] * ... * x[s]
__device__ inline void inclusive_cumprod(const float* x, float* out, int S) {
  float P = 1.0f;
  for (int s = 0; s < S; ++s) out[s] = cumprod_step(P, x[s]);
}

// out[s] = x[s] + x[s + 1] + ... + x[S - 1], added from the end
__device__ inline void suffix_sum(const float* x, float* out, int S) {
  float acc = 0.0f;
  for (int s = S - 1; s >= 0; --s) out[s] = suffix_step(acc, x[s]);
}

// out[0] = fill, out[s] = x[s - 1]: the exclusive shift of standard-mode
// transmittance (walked from the end, so out may alias x)
__device__ inline void shift_down(const float* x, float* out, int S,
                                  float fill) {
  for (int s = S - 1; s >= 1; --s) out[s] = x[s - 1];
  if (S > 0) out[0] = fill;
}

}  // namespace
}  // namespace seg
