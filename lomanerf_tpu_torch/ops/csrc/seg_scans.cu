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
// written once, 8 B: 62.9 MB for the 262,144-ray x 30-sample column of the
// main path, at least 18.8 us at 3.35 TB/s; the work is one operation per
// value.
//
// The design: one thread per segment walks it in order with the step
// functions the NeRF kernels composite with (seg_scan.cuh), so this entry
// point tests those scans alone.  A simple first kernel: across a warp the
// loads and stores are S floats apart (one 32-B sector per thread and
// access, reused from L1 over 8 samples), not coalesced.

#include "seg_scan.cuh"

namespace {

constexpr int kThreads = 256;  // segments per block

enum Op { kCumprod = 0, kSuffix = 1, kShift = 2 };

template <int kOp>
__global__ void __launch_bounds__(kThreads)
seg_scan_kernel(const float* __restrict__ x, float* __restrict__ out,
                int n_seg, int S, float fill) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= n_seg) return;
  const size_t base = static_cast<size_t>(r) * S;
  if (kOp == kCumprod) seg::inclusive_cumprod(x + base, out + base, S);
  if (kOp == kSuffix) seg::suffix_sum(x + base, out + base, S);
  if (kOp == kShift) seg::shift_down(x + base, out + base, S, fill);
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
  const int blocks = (n_seg + kThreads - 1) / kThreads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (op) {
    case kCumprod:
      seg_scan_kernel<kCumprod><<<blocks, kThreads, 0, st>>>(x, out, n_seg, S, fill);
      break;
    case kSuffix:
      seg_scan_kernel<kSuffix><<<blocks, kThreads, 0, st>>>(x, out, n_seg, S, fill);
      break;
    case kShift:
      seg_scan_kernel<kShift><<<blocks, kThreads, 0, st>>>(x, out, n_seg, S, fill);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
