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
// (and 8 S per-ray) and writes 12 B, but costs S * (in*W + (L-2)*W*W + 4*W)
// f32 FMAs plus 3n sincosf and S expf — about 66 K FMAs per ray for the
// 3x30 model at S = 30.  The weights (8-44 KB) sit in shared memory, read
// as broadcast float4s: one sample a read gives 4 FMAs a 16-byte load, and
// the shared-memory pipe, not the FMA pipes, then sets the pace.
//
// What the design does about it:
//   * one thread per ray walks its S samples in groups of kGroup = 2
//     (nerf_render_mlp.cuh): the group's MLPs run together, so each
//     broadcast float4 weight feeds 8 FMAs; the group's rgba are then
//     composited in sample order with the running product P (the segmented
//     cumprod as a running product) and the colour as scalars.  The last
//     group of an odd S repeats sample S-1 in its pad slot and composites
//     only its real one;
//   * each layer's sums stay in registers (kGroup x W), its input sits in
//     the thread's slice of a shared-memory stage, so the loop over inputs
//     rolls and the code stays small (the instruction cache: unrolled whole
//     it takes a quarter longer, PERF.md); at W = 32 four blocks of 128
//     threads an SM;
//   * all weights, biases and shared depths/steps sit in shared memory;
//     per-ray depths and steps are staged there too, the block's rows read
//     with coalesced loads before the walk (row stride S | 1: odd, so a
//     warp's reads down its rows hit 32 banks);
//   * layer 0 is fed straight from the encoding, one feature at a time, so
//     the (in_dim)-wide encoded vector is never stored; the last layer
//     computes only the four rgba channels the render reads.
// Bits: each sample's arithmetic is the train walk's forward (mlp_rgba,
// nerf_common.cuh) in its order, and the compositing step is
// nerf_common.cuh's, so the colours are those of one sample a thread.

#include "nerf_render_mlp.cuh"

namespace {

constexpr int kThreads = 128;

// Dynamic shared memory of a block, in floats: the packed parameters (with
// the shared depths' tail), the activation stage (kGroup x W a thread), and
// for per-ray depths the block's rows of t and dist (stride S | 1).
// Mirrored by fused_nerf.render_smem_bytes.
__host__ __device__ inline size_t render_smem_floats(int pk_floats, int S, int W, int group,
                                                     bool per_ray) {
  return static_cast<size_t>(pk_floats) + static_cast<size_t>(kThreads) * group * W +
         (per_ray ? 2 * static_cast<size_t>(kThreads) * (S | 1) : 0);
}

template <int W, bool kPerRay>
__global__ void __launch_bounds__(kThreads, nerf::RenderPlan<W>::kMinBlocks)
nerf_render_fwd_kernel(const float* __restrict__ pk, int pk_floats,
                       const float* __restrict__ t_rays,
                       const float* __restrict__ d_rays,
                       const float* __restrict__ origins,
                       const float* __restrict__ directions,
                       float* __restrict__ out, int n_rays, int S, int L,
                       int in_dim, int nf, int loma) {
  constexpr int K = nerf::RenderPlan<W>::kGroup;
  extern __shared__ __align__(16) float smem[];
  float* stage = smem + pk_floats;  // pk_floats a multiple of 4
  const int ray0 = blockIdx.x * kThreads;
  const int rays = min(kThreads, n_rays - ray0);
  const int SS = S | 1;
  float* t_st = stage + kThreads * K * W;
  float* d_st = t_st + kThreads * SS;
  {
    const float4* src = reinterpret_cast<const float4*>(pk);
    float4* dst = reinterpret_cast<float4*>(smem);
    for (int i = threadIdx.x; i < pk_floats / 4; i += kThreads) dst[i] = src[i];
    if (kPerRay) {  // the block's rows, consecutive floats a warp
      const size_t base = static_cast<size_t>(ray0) * S;
      for (int i = threadIdx.x; i < rays * S; i += kThreads) {
        const int r = i / S, s = i - r * S;
        t_st[r * SS + s] = t_rays[base + i];
        d_st[r * SS + s] = d_rays[base + i];
      }
    }
  }
  __syncthreads();

  // ragged last block: no barrier follows, so pad threads may leave
  if (static_cast<int>(threadIdx.x) >= rays) return;
  const int ray = ray0 + threadIdx.x;

  const nerf::Layout lay(smem, L, W, in_dim, nf, S);
  const float* ts = kPerRay ? t_st + threadIdx.x * SS : lay.ts;
  const float* ds = kPerRay ? d_st + threadIdx.x * SS : lay.ds;
  const nerf::Stage st{stage + threadIdx.x * K, kThreads * K};
  const float o[3] = {origins[3 * ray], origins[3 * ray + 1], origins[3 * ray + 2]};
  const float d[3] = {directions[3 * ray], directions[3 * ray + 1],
                      directions[3 * ray + 2]};

  float P = 1.0f;  // running product of c over the samples seen so far
  float acc[3] = {0.0f, 0.0f, 0.0f};
  for (int s0 = 0; s0 < S; s0 += K) {
    float p[K][3];
#pragma unroll
    for (int j = 0; j < K; ++j) nerf::sample_point(o, d, ts[min(s0 + j, S - 1)], p[j]);
    float rgba[K][nerf::kHead];
    nerf::mlp_rgba_group<W>(p, lay, st, rgba);
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int s = s0 + j;
      if (s >= S) break;
      float alpha, c;
      nerf::sample_alpha(rgba[j][3], ds[s], &alpha, &c);
      const float wgt = alpha * nerf::transmittance(&P, c, s, loma);
#pragma unroll
      for (int k = 0; k < 3; ++k) acc[k] = fmaf(wgt, nerf::sigmoidf(rgba[j][k]), acc[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) out[3 * ray + k] = acc[k];
}

template <int W, bool kPerRay>
cudaError_t launch(const float* pk, int pk_floats, const float* t_rays,
                   const float* d_rays, const float* origins,
                   const float* directions, float* out, int n_rays, int S,
                   int L, int in_dim, int nf, int loma, cudaStream_t stream) {
  const size_t smem =
      render_smem_floats(pk_floats, S, W, nerf::RenderPlan<W>::kGroup, kPerRay) * sizeof(float);
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
