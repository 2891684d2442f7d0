// Wide NeRF render backward for Hopper (sm_90a): parameter gradients from a
// per-ray colour cotangent.
//
// Replaces the TPU kernel lomanerf_tpu/ops/fused_nerf.py:_nerf_backward_kernel_W
// (the remat backward of _nerf_forward_kernel_W, wired through
// pallas_utils.render_vjp): the forward again, saving each layer's input,
// then the compositing adjoint and the MLP backward from the given (N, 3)
// cotangent, dW/db summed over rays and samples.
//
// What bounds it on this card, and the design: those of nerf_wide_train.cu,
// whose sequence it shares (nerf_wide_chain.cuh) — arithmetic in the
// layer GEMMs, the saved activations in device memory, fixed-order sums.
// Only the cotangent differs: it is read, not computed from a target, and
// the loss slot is 0.

#include "nerf_wide_chain.cuh"

// C entry point, bound with ctypes.  Arguments as nerf_wide_train's, with
// the (N, 3) colour cotangent dcol in place of the targets (ray_loss is not
// read).
extern "C" int nerf_wide_render_bwd(const void* W, const float* b,
                                    const float* ts, const float* ds,
                                    const float* origins,
                                    const float* directions, const float* dcol,
                                    void* acts, float* dz, float* dz_head,
                                    float* partials, long long n_parts,
                                    float* ray_loss, float* dW, float* db,
                                    float* loss, int n_rays, int chunk_rays,
                                    int S, int L, int pw, int kc,
                                    int num_functions, int loma, int bf16,
                                    void* stream) {
  if (L < 2 || pw % 4 != 0 || kc > pw || chunk_rays <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const wide::Net net{W, b, ts, ds, S, L, pw, kc, num_functions, loma};
  const wide::GradScratch sc{acts, dz, dz_head, partials,
                             static_cast<size_t>(n_parts), ray_loss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return static_cast<int>(wide::grad_sequence<__nv_bfloat16, 2>(
        net, origins, directions, dcol, sc, dW, db, loss, n_rays, chunk_rays, st));
  }
  return static_cast<int>(wide::grad_sequence<float, 2>(
      net, origins, directions, dcol, sc, dW, db, loss, n_rays, chunk_rays, st));
}
