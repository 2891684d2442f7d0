// Narrow NeRF render backward on per-ray (N, S) depths for Hopper (sm_90a).
//
// Replaces the TPU kernel lomanerf_tpu/ops/fused_nerf.py:_nerf_backward_kernel_T
// (the remat backward of _nerf_forward_kernel_T, on per-ray depths).  The
// reverse walk of nerf_render_bwd.cu (nerf_grad.cuh) with kPerRay: each ray
// reads its depths t[ray, s] and steps dist[ray, s] from device memory (S
// floats apart across a warp, uncoalesced) instead of the packed buffer's
// shared tail.  A ray's arithmetic is the same, so depths broadcast from
// (S,) give nerf_render_bwd's results bit for bit.  A source of its own so
// that nvcc builds it beside nerf_render_bwd.cu.

#include "nerf_grad.cuh"

// C entry point, bound with ctypes.  Arguments as nerf_train_rays', with the
// (N, 3) colour cotangent dcol in place of the targets.
extern "C" int nerf_render_bwd_rays(const float* pk, int pk_floats, int G,
                                    const float* t, const float* dist,
                                    const float* origins,
                                    const float* directions, const float* dcol,
                                    float* partials, float* out, int n_rays,
                                    int S, int L, int in_dim,
                                    int num_functions, int width, int loma,
                                    void* stream) {
  return nerf::dispatch_grad<false, true>(
      pk, pk_floats, G, t, dist, origins, directions, dcol, partials, out,
      n_rays, S, L, in_dim, num_functions, width, loma, stream);
}
