// 2D image-field backward for Hopper (sm_90a): dW/db from an output
// cotangent.
//
// Replaces the TPU kernel lomanerf_tpu/ops/fused_mlp.py:_bwd_kernel: per
// pixel, the forward again (remat, as the TPU kernel does), the head's
// d_z = dout * y (1 - y), then per layer from the top dW_l += h_l^T d_z,
// db_l += sum d_z and d_z <- (d_z W_l^T) masked by h_l > 0, with dW/db
// summed over every pixel.  The coords get no gradient.
//
// What bounds it on this card: arithmetic.  108,160 multiply-adds per
// pixel for the hires field (the forward, dW, and d_h of layers 1-3): 226.8
// GFLOP for a 1024^2 image, 3.39 ms at the 67 TFLOP/s f32 peak, 1.37 ms as
// three TF32 passes at the tensor cores' 495 TFLOP/s.  Device memory
// carries 20 B per pixel, plus the per-block partials.
//
// What the design does about it (field_common.cuh):
//   * the three products (forward, dW, d_h) on the tensor cores in split
//     TF32 (mma.sync.m16n8k8, 3xTF32: f32-level accuracy), or as f32 FMAs
//     for the "highest" tier (exact != 0), the weights in
//     shared memory, streamed through two slots by the Tensor Memory
//     Accelerator, the next layer's copy in flight during this layer's
//     products;
//   * a tile of 32 pixels per 512-thread block keeps all L + 1 activations
//     of the tile in shared memory; d_z of each layer overwrites that
//     layer's input in place, so the walk down needs no more;
//   * the TPU's grid carries dW in VMEM from one step to the next; here a
//     grid of as many blocks as fit on the card at once strides over the
//     tiles, and each block adds its tiles' dW/db into its own partial in
//     device memory (zeroed first) by fire-and-forget reductions, each entry
//     owned by one thread, which adds its tiles in order;
//   * a second kernel sums the partials in a fixed order (block_sum.cuh),
//     so two launches on the same inputs give bit-identical gradients, like
//     the TPU's sequential grid.

#include "block_sum.cuh"
#include "field_common.cuh"

// C entry point, bound with ctypes: how many blocks of the gradient kernel
// the current card holds at once for these shapes (its grid's upper bound;
// a partial of G floats each; exact as for field_bwd).  Returns that
// count, or minus the CUDA error.
extern "C" int field_bwd_blocks(int L, int in_dim, int width, int num_functions,
                                int out_ch, int exact) {
  return field::resident_blocks<true>(L, in_dim, width, num_functions, out_ch, exact);
}

// C entry point, bound with ctypes.  ws: the staged parameters; G the
// floats of the weights and biases in the gradient layout
// (field_common.cuh); coords (n, 2) and dout (n, out_ch) f32; partials
// n_blocks * G floats of scratch, n_blocks at most field_bwd_blocks(...) and
// at most the tiles of 32 pixels; out receives the G gradient floats;
// exact != 0 the f32 FMA products ("highest"), 0 3xTF32.  Returns the
// launches' cudaGetLastError() (0 on success); does not synchronise.
extern "C" int field_bwd(const float* ws, int G, const float* coords, const float* dout,
                         float* partials, int n_blocks, float* out, int n, int L,
                         int in_dim, int width, int num_functions, int out_ch, int exact,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || n_blocks <= 0) {
    return static_cast<int>(cudaMemsetAsync(out, 0, sizeof(float) * G, st));
  }
  field::Dims d;
  cudaError_t err = field::plan(L, in_dim, width, num_functions, out_ch, &d);
  if (err == cudaSuccess) {
    err = cudaMemsetAsync(partials, 0, sizeof(float) * static_cast<size_t>(n_blocks) * G, st);
  }
  if (err == cudaSuccess) {
    err = field::launch_tiles<true>(ws, coords, dout, partials, G, n, d, n_blocks, exact, st);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_block_partials<<<(G + 31) / 32, kSumWarps * 32, 0, st>>>(partials, n_blocks, G, out);
  return static_cast<int>(cudaGetLastError());
}
