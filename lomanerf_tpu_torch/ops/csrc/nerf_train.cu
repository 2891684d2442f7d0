// Narrow NeRF train step for Hopper (sm_90a): loss and parameter gradients
// in one call.
//
// Replaces the TPU kernel lomanerf_tpu/ops/fused_nerf.py:_nerf_train_kernel_S
// (with its backward helper _bwd_from_dcol_T; S depths shared by every ray;
// nerf_train_rays.cu is the per-ray instance): per ray, the render forward of
// nerf_render_fwd.cu, the masked sum-MSE against the (N, 3) targets (rays at
// or past the runtime n_rays add nothing), the colour cotangent 2(col - tgt),
// the compositing adjoint and the MLP backward, with dW/db summed over every
// valid ray and sample.  Writes G gradient floats (the packed parameter
// layout of nerf_common.cuh) and then the loss.
//
// What bounds it on this card: arithmetic and shared memory.  Per ray and
// sample it runs the forward twice (pass 1, then the remat of pass 2), the
// backward d_h = d_z W^T, and its share of dW += h^T d_z: about 4x the
// forward's FMAs, ~265 K per ray for the 3x30 model at S = 30.  Every
// weight operand comes from shared memory (a broadcast float4 per 4 FMAs
// of a row); device memory carries only 36 B per ray plus one (G+1)-float
// partial per block.
//
// What the design does about it (nerf_grad.cuh):
//   * one thread per ray, 64 rays per block, weights in shared memory as in
//     the render forward; the TPU's s-major rows, roll scans and suffix-sum
//     gather become scalars carried along the ray (P_s kept per sample, the
//     suffix sum carried in reverse); both passes run in one loop over one
//     inlined forward, so that the code fits the instruction cache better;
//   * dW/db are reduced without atomics: each sample's layer inputs and d_z
//     rows are staged in shared memory, then each thread takes a register
//     tile of entries (4 x 4 of a hidden layer at W = 32), reading 4 rays of
//     a row as one float4, and adds each entry's sum over the block's rays
//     into the block's accumulator; a second kernel sums the blocks'
//     partials in a fixed order, so the result is deterministic like the
//     TPU's sequential grid;
//   * pad threads of the ragged last block run every barrier with zeros.
// Shared memory: about 70 KB per block for the 3x30 model at S = 30 (three
// blocks per SM), about 213 KB for the 4x64 model at S = 64 (one).

#include "nerf_grad.cuh"

// C entry point, bound with ctypes.  width is the padded hidden width (32 or
// 64); pk 16-byte aligned with pk_floats a multiple of 4, G the floats of
// its weights and biases, the S shared depths at its end; partials holds
// ceil(n_rays / 64) * (G + 1) floats of scratch; out receives G gradient
// floats, then the loss.  Returns the launches' cudaGetLastError() (0 on
// success); does not synchronise.
extern "C" int nerf_train(const float* pk, int pk_floats, int G,
                          const float* origins, const float* directions,
                          const float* target, float* partials, float* out,
                          int n_rays, int S, int L, int in_dim,
                          int num_functions, int width, int loma,
                          void* stream) {
  return nerf::dispatch_grad<true, false>(
      pk, pk_floats, G, nullptr, nullptr, origins, directions, target,
      partials, out, n_rays, S, L, in_dim, num_functions, width, loma, stream);
}
