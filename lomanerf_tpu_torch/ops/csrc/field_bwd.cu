// 2D image-field backward for Hopper (sm_90a): dW/db from an output
// cotangent.
//
// Replaces the TPU kernel lomanerf_tpu/ops/fused_mlp.py:_bwd_kernel: per
// pixel, the forward again (remat, as the TPU kernel does), the head's
// d_z = dout * y (1 - y), then per layer from the top dW_l += h_l^T d_z,
// db_l += sum d_z and d_z <- (d_z W_l^T) masked by h_l > 0, with dW/db
// summed over every pixel.  The coords get no gradient.
//
// What bounds it on this card: f32 arithmetic.  108,160 FMAs per pixel for
// the hires field (the forward, dW, and d_h of layers 1-3): 226.8 GFLOP for
// a 1024^2 image, at least 3.39 ms at the 67 TFLOP/s f32 peak.  Device
// memory carries 20 B per pixel, plus the per-block partials.
//
// What the design does about it (field_common.cuh):
//   * a tile of 64 pixels per 256-thread block keeps all L + 1 activations
//     of the tile in shared memory (109 KB at hires widths) beside one
//     layer's weights (66 KB); d_z of each layer overwrites that layer's
//     output in place, so the walk down needs no more;
//   * the TPU's grid carries dW in VMEM from one step to the next; here a
//     grid of as many blocks as fit on the card at once strides over the
//     tiles, and each block adds its tiles' dW/db into its own partial in
//     device memory (zeroed first; each entry owned by one thread, so no
//     atomics; 152 KB per block at hires widths, L2-resident), rather than
//     one partial per tile (2 GB at 1024^2);
//   * a second kernel sums the partials in a fixed order (block_sum.cuh),
//     so two launches on the same inputs give bit-identical gradients, like
//     the TPU's sequential grid;
//   * the three products (forward, dW, d_h) are register-tiled as in the
//     forward (8 x 8 outputs per thread for the 128 x 128 dW).

#include "block_sum.cuh"
#include "field_common.cuh"

namespace {

template <int H>
cudaError_t resident_blocks(const field::Dims& d, int* blocks) {
  cudaError_t err = field::allow_smem<H, true>(d);
  if (err != cudaSuccess) return err;
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, field::field_kernel<H, true>, field::kThreads, d.smem_bytes());
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  *blocks = per_sm * sms;
  return err;
}

}  // namespace

// C entry point, bound with ctypes: how many blocks of the gradient kernel
// the current card holds at once for these shapes (its grid's upper bound;
// a partial of G floats each).  Returns that count, or minus the CUDA error.
extern "C" int field_bwd_blocks(int L, int in_dim, int width, int num_functions,
                                int out_ch) {
  const field::Dims d{L, in_dim, width, num_functions, out_ch};
  int blocks = 0;
  cudaError_t err;
  switch (width) {
    case 16: err = resident_blocks<16>(d, &blocks); break;
    case 32: err = resident_blocks<32>(d, &blocks); break;
    case 64: err = resident_blocks<64>(d, &blocks); break;
    case 128: err = resident_blocks<128>(d, &blocks); break;
    default: err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return -static_cast<int>(err);
  return blocks;
}

// C entry point, bound with ctypes.  pk: the packed parameters, G the
// floats of their weights and biases (field_common.cuh); coords (n, 2) and
// dout (n, out_ch) f32; partials n_blocks * G floats of scratch, n_blocks
// at most field_bwd_blocks(...) and at most the tiles of 64 pixels; out
// receives the G gradient floats.  Returns the launches' cudaGetLastError()
// (0 on success); does not synchronise.
extern "C" int field_bwd(const float* pk, int G, const float* coords,
                         const float* dout, float* partials, int n_blocks,
                         float* out, int n, int L, int in_dim, int width,
                         int num_functions, int out_ch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || n_blocks <= 0) {
    return static_cast<int>(cudaMemsetAsync(out, 0, sizeof(float) * G, st));
  }
  cudaError_t err = cudaMemsetAsync(
      partials, 0, sizeof(float) * static_cast<size_t>(n_blocks) * G, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const field::Dims d{L, in_dim, width, num_functions, out_ch};
  err = field::launch_width<true>(width, pk, coords, dout, partials, G, n, d,
                                  n_blocks, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_block_partials<<<(G + 31) / 32, kSumWarps * 32, 0, st>>>(
      partials, n_blocks, G, out);
  return static_cast<int>(cudaGetLastError());
}
