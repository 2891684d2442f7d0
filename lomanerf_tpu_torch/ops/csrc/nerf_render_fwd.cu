// Narrow NeRF render forward for Hopper (sm_90a).
//
// Replaces the TPU kernels lomanerf_tpu/ops/fused_nerf.py:_nerf_forward_kernel_S
// (the s-major Pallas render forward, S depths shared by every ray) and,
// through nerf_render_fwd_rays, _nerf_forward_kernel_T (the ray-major one on
// per-ray (N, S) depths, the stratified case): per ray, sample points
// o + d*t[s] (t[ray, s] per-ray), positional encoding (n octaves, block layout
// [x | sin 2^0 x | cos 2^0 x | ...]), an L-layer MLP (ReLU hidden layers,
// rgba head: sigmoid rgb, ReLU density on channel 3), and front-to-back
// compositing in loma mode (T[0] = 1, inclusive transmittance after) or
// standard mode (exclusive), writing the (N, 3) colour.
//
// What bounds it on this card: arithmetic, not memory.  A ray reads 24 B
// and writes 12 B, but costs S * (in*W + (L-2)*W*W + 4*W) f32 FMAs plus
// 3n sincosf and S expf — about 66 K FMAs per ray for the 3x30 model at
// S = 30.  The weights (8-44 KB) are read once per sample per FMA, so the
// risk is the shared-memory read port, not device memory.
//
// What the design does about it:
//   * one thread per ray walks its S samples in order and carries the
//     transmittance and the colour as scalars: the TPU's (8, R) sublane
//     blocks, s-major row order, stride-R lane-roll scans and suffix-sum
//     gather are not carried over; the segmented cumprod is a running
//     product;
//   * all weights, biases and shared depths/steps sit in shared memory
//     (per-ray depths are read from device memory, S floats apart across a
//     warp: uncoalesced, a later PR may stage them); every
//     thread of a warp reads the same weight at the same time (a broadcast,
//     no bank conflicts), four at a time as float4;
//   * activations are register arrays templated on the padded width W (32 or
//     64); layers loop at run time;
//   * layer 0 is fed straight from the encoding, one feature at a time, so
//     the (in_dim)-wide encoded vector is never stored;
//   * the last layer computes only the four rgba channels the render reads.
// The per-sample MLP and compositing step live in nerf_common.cuh, shared
// with the backward kernels (nerf_render_bwd.cu, nerf_train.cu).

#include "nerf_common.cuh"

namespace {

constexpr int kThreads = 128;

template <int W, bool kPerRay>
__global__ void __launch_bounds__(kThreads)
nerf_render_fwd_kernel(const float* __restrict__ pk, int pk_floats,
                       const float* __restrict__ t_rays,
                       const float* __restrict__ d_rays,
                       const float* __restrict__ origins,
                       const float* __restrict__ directions,
                       float* __restrict__ out, int n_rays, int S, int L,
                       int in_dim, int nf, int loma) {
  extern __shared__ __align__(16) float smem[];
  {
    const float4* src = reinterpret_cast<const float4*>(pk);
    float4* dst = reinterpret_cast<float4*>(smem);
    for (int i = threadIdx.x; i < pk_floats / 4; i += blockDim.x) dst[i] = src[i];
  }
  __syncthreads();

  // ragged last block: no barrier follows, so pad threads may leave
  const int ray = blockIdx.x * kThreads + threadIdx.x;
  if (ray >= n_rays) return;

  const nerf::Layout lay(smem, L, W, in_dim, nf, S);
  const float *ts, *ds;
  nerf::ray_depths<kPerRay>(lay, t_rays, d_rays, ray, &ts, &ds);
  const float o[3] = {origins[3 * ray], origins[3 * ray + 1], origins[3 * ray + 2]};
  const float d[3] = {directions[3 * ray], directions[3 * ray + 1],
                      directions[3 * ray + 2]};

  float P = 1.0f;  // running product of c over the samples seen so far
  float acc[3] = {0.0f, 0.0f, 0.0f};
  for (int s = 0; s < S; ++s) {
    float p[3];
    nerf::sample_point(o, d, ts[s], p);
    float rgba[nerf::kHead];
    nerf::mlp_rgba<W, false>(p, lay, rgba, nullptr, 0);
    float alpha, c;
    nerf::sample_alpha(rgba[3], ds[s], &alpha, &c);
    const float wgt = alpha * nerf::transmittance(&P, c, s, loma);
#pragma unroll
    for (int k = 0; k < 3; ++k) acc[k] = fmaf(wgt, nerf::sigmoidf(rgba[k]), acc[k]);
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) out[3 * ray + k] = acc[k];
}

template <int W, bool kPerRay>
cudaError_t launch(const float* pk, int pk_floats, const float* t_rays,
                   const float* d_rays, const float* origins,
                   const float* directions, float* out, int n_rays, int S,
                   int L, int in_dim, int nf, int loma, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(pk_floats) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        nerf_render_fwd_kernel<W, kPerRay>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  nerf_render_fwd_kernel<W, kPerRay><<<blocks, kThreads, smem, stream>>>(
      pk, pk_floats, t_rays, d_rays, origins, directions, out, n_rays, S, L,
      in_dim, nf, loma);
  return cudaGetLastError();
}

template <bool kPerRay>
int dispatch(const float* pk, int pk_floats, const float* t_rays,
             const float* d_rays, const float* origins,
             const float* directions, float* out, int n_rays, int S, int L,
             int in_dim, int nf, int width, int loma, void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 32:
      return static_cast<int>(launch<32, kPerRay>(pk, pk_floats, t_rays, d_rays,
                                                  origins, directions, out,
                                                  n_rays, S, L, in_dim, nf,
                                                  loma, st));
    case 64:
      return static_cast<int>(launch<64, kPerRay>(pk, pk_floats, t_rays, d_rays,
                                                  origins, directions, out,
                                                  n_rays, S, L, in_dim, nf,
                                                  loma, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// C entry points, bound with ctypes.  width is the padded hidden width (32
// or 64); pk_floats a multiple of 4; pk 16-byte aligned.  Return the
// launch's cudaGetLastError() (0 on success); do not synchronise.
//
// nerf_render_fwd: the S depths shared by every ray at the end of pk.
extern "C" int nerf_render_fwd(const float* pk, int pk_floats,
                               const float* origins, const float* directions,
                               float* out, int n_rays, int S, int L,
                               int in_dim, int num_functions, int width,
                               int loma, void* stream) {
  return dispatch<false>(pk, pk_floats, nullptr, nullptr, origins, directions,
                         out, n_rays, S, L, in_dim, num_functions, width, loma,
                         stream);
}

// nerf_render_fwd_rays: per-ray (N, S) depths t and steps dist, row-major
// f32 (the counterpart of _nerf_forward_kernel_T); pk has no depth tail.
extern "C" int nerf_render_fwd_rays(const float* pk, int pk_floats,
                                    const float* t, const float* dist,
                                    const float* origins,
                                    const float* directions, float* out,
                                    int n_rays, int S, int L, int in_dim,
                                    int num_functions, int width, int loma,
                                    void* stream) {
  return dispatch<true>(pk, pk_floats, t, dist, origins, directions, out,
                        n_rays, S, L, in_dim, num_functions, width, loma,
                        stream);
}
