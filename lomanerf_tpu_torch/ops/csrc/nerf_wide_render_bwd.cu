// Wide NeRF render backward for Hopper (sm_90a): parameter gradients from a
// per-ray colour cotangent.
//
// Replaces the TPU kernels lomanerf_tpu/ops/fused_nerf.py:_nerf_backward_kernel_W
// (the remat backward of _nerf_forward_kernel_W, wired through
// pallas_utils.render_vjp) and, through nerf_wide_render_bwd_rays,
// _nerf_backward_kernel (the same on per-ray (N, S) depths): the forward
// again, saving each layer's input, then the compositing adjoint and the
// MLP backward from the given (N, 3) cotangent, dW/db summed over rays and
// samples.
//
// What bounds it on this card, and the design: those of nerf_wide_train.cu,
// whose sequence it shares (nerf_wide_chain.cuh) — arithmetic in the
// layer GEMMs, the saved activations in device memory, fixed-order sums.
// Only the cotangent differs: it is read, not computed from a target, and
// the loss slot is 0.

#include "nerf_wide_chain.cuh"

// C entry points, bound with ctypes.  Arguments as nerf_wide_train's, with
// the (N, 3) colour cotangent dcol in place of the targets (ray_loss is not
// read).
extern "C" int nerf_wide_render_bwd(const void* W, const float* b,
                                    const float* ts, const float* ds,
                                    const float* origins,
                                    const float* directions, const float* dcol,
                                    void* acts, float* dz, void* dzb, float* db_part,
                                    long long n_db_part, float* dz_head,
                                    float* partials, long long n_parts,
                                    float* ray_loss, float* dW, float* db,
                                    float* loss, int n_rays, int chunk_rays,
                                    int S, int L, int pw, int kc,
                                    int num_functions, int loma, int bf16,
                                    void* stream) {
  return wide::grad_entry<2>(
      false, W, b, ts, ds, origins, directions, dcol, acts, dz, dzb, db_part, n_db_part,
      dz_head, partials, n_parts, ray_loss, dW, db, loss, n_rays, chunk_rays, S, L,
      pw, kc, num_functions, loma, bf16, stream);
}

// nerf_wide_render_bwd_rays: ts, ds per-ray (N, S) f32, row-major (the
// counterpart of _nerf_backward_kernel).
extern "C" int nerf_wide_render_bwd_rays(const void* W, const float* b,
                                         const float* ts, const float* ds,
                                         const float* origins,
                                         const float* directions,
                                         const float* dcol, void* acts,
                                         float* dz, void* dzb, float* db_part,
                                         long long n_db_part, float* dz_head,
                                         float* partials, long long n_parts,
                                         float* ray_loss, float* dW, float* db,
                                         float* loss, int n_rays,
                                         int chunk_rays, int S, int L, int pw,
                                         int kc, int num_functions, int loma,
                                         int bf16, void* stream) {
  return wide::grad_entry<2>(
      true, W, b, ts, ds, origins, directions, dcol, acts, dz, dzb, db_part, n_db_part,
      dz_head, partials, n_parts, ray_loss, dW, db, loss, n_rays, chunk_rays, S, L,
      pw, kc, num_functions, loma, bf16, stream);
}
