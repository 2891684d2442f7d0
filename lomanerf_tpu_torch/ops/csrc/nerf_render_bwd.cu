// Narrow NeRF render backward for Hopper (sm_90a): parameter gradients from
// a per-ray colour cotangent.
//
// Replaces the TPU kernel lomanerf_tpu/ops/fused_nerf.py:_nerf_backward_kernel_S
// (the remat backward of _nerf_forward_kernel_S, wired through
// pallas_utils.render_vjp; nerf_render_bwd_rays.cu is the per-ray instance):
// per ray, the render forward again, then the compositing adjoint and the MLP backward
// from the given (N, 3) cotangent dcol, with dW/db summed over rays and
// samples.  Writes G gradient floats (the packed parameter layout of
// nerf_common.cuh) and a zero loss slot.
//
// What bounds it on this card, and the design: the same as nerf_train.cu,
// whose reverse walk it shares (nerf_grad.cuh) — arithmetic and shared
// memory, one thread per ray, a fixed-order reduction of dW/db in shared
// memory and then across blocks, deterministic, with pad threads running
// every barrier.  Only the cotangent differs: it is read, not computed from
// a target, and there is no loss.

#include "nerf_grad.cuh"

// C entry point, bound with ctypes.  Arguments as nerf_train's, with the
// (N, 3) colour cotangent dcol in place of the targets.
extern "C" int nerf_render_bwd(const float* pk, int pk_floats, int G,
                               const float* origins, const float* directions,
                               const float* dcol, float* partials, float* out,
                               int n_rays, int S, int L, int in_dim,
                               int num_functions, int width, int loma,
                               void* stream) {
  return nerf::dispatch_grad<false, false>(
      pk, pk_floats, G, nullptr, nullptr, origins, directions, dcol, partials,
      out, n_rays, S, L, in_dim, num_functions, width, loma, stream);
}
