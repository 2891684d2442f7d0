// Narrow NeRF train step on per-ray (N, S) depths for Hopper (sm_90a).
//
// Replaces the TPU kernel lomanerf_tpu/ops/fused_nerf.py:_nerf_train_kernel_T
// (the ray-major Pallas train step on per-ray depths, the stratified case).
// The reverse walk of nerf_train.cu (nerf_grad.cuh) with kPerRay: each ray
// reads its depths t[ray, s] and steps dist[ray, s] from device memory (S
// floats apart across a warp, uncoalesced) instead of the packed buffer's
// shared tail.  A ray's arithmetic is the same, so depths broadcast from
// (S,) give nerf_train's results bit for bit.  A source of its own so that
// nvcc builds it beside nerf_train.cu.

#include "nerf_grad.cuh"

// C entry point, bound with ctypes.  Arguments as nerf_train's, with the
// per-ray (N, S) depths t and steps dist (row-major f32) after G; pk has no
// depth tail.
extern "C" int nerf_train_rays(const float* pk, int pk_floats, int G,
                               const float* t, const float* dist,
                               const float* origins, const float* directions,
                               const float* target, float* partials,
                               float* out, int n_rays, int S, int L,
                               int in_dim, int num_functions, int width,
                               int loma, void* stream) {
  return nerf::dispatch_grad<true, true>(
      pk, pk_floats, G, t, dist, origins, directions, target, partials, out,
      n_rays, S, L, in_dim, num_functions, width, loma, stream);
}
