// Narrow NeRF render forward for Hopper (sm_90a).
//
// Replaces the TPU kernel lomanerf_tpu/ops/fused_nerf.py:_nerf_forward_kernel_S
// (the s-major Pallas render forward): per ray, sample points o + d*t[s] at S
// shared depths, positional encoding (n octaves, block layout
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
//   * all weights, biases and the S depths/steps sit in shared memory; every
//     thread of a warp reads the same weight at the same time (a broadcast,
//     no bank conflicts), four at a time as float4;
//   * activations are register arrays templated on the padded width W (32 or
//     64); layers loop at run time;
//   * layer 0 is fed straight from the encoding, one feature at a time, so
//     the (in_dim)-wide encoded vector is never stored;
//   * the last layer computes only the four rgba channels the render reads.
// Built without fast-math: expf and sincosf stay IEEE-accurate, the 1e-10
// epsilon in c = e + 1e-10 is kept, and sigma = 0 against the 1e8 far
// sentinel gives exp(-0) = 1, alpha = 0 exactly.  The point o + d*t and the
// product sigma*dist are rounded as the reference rounds them (no FMA
// contraction), since the encoding amplifies the point's error by 2^(n-1).
//
// Packed parameter buffer (floats, built by ops/fused_nerf.py), per layer l:
//   W_l padded to (rows_l, cols_l) row-major, then b_l padded to cols_l,
// where rows_0 = in_dim, rows_l = W for l >= 1, cols_l = W for l < L-1 and
// cols_{L-1} = 4; then t[0..S) and dist[0..S).  Every block is a multiple of
// 4 floats, so each layer starts 16-byte aligned.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kHead = 4;  // rgba channels the render reads

// z[0..OUT) += a * w[0..OUT), w 16-byte aligned in shared memory
template <int OUT, int N>
__device__ __forceinline__ void axpy(float a, const float* __restrict__ w,
                                     float (&z)[N]) {
  const float4* w4 = reinterpret_cast<const float4*>(w);
#pragma unroll
  for (int j = 0; j < OUT / 4; ++j) {
    const float4 v = w4[j];
    z[4 * j + 0] = fmaf(a, v.x, z[4 * j + 0]);
    z[4 * j + 1] = fmaf(a, v.y, z[4 * j + 1]);
    z[4 * j + 2] = fmaf(a, v.z, z[4 * j + 2]);
    z[4 * j + 3] = fmaf(a, v.w, z[4 * j + 3]);
  }
}

template <int OUT, int N>
__device__ __forceinline__ void load_bias(const float* __restrict__ b,
                                          float (&z)[N]) {
#pragma unroll
  for (int j = 0; j < OUT; ++j) z[j] = b[j];
}

// Layer 0 straight from the encoding of point p: z = enc(p) @ W0 + b0.
// Encoded row of sin(2^i p_c) is 3 + 6i + c, of cos(2^i p_c) 6 + 6i + c.
template <int OUT, int N>
__device__ __forceinline__ void encode_layer(const float (&p)[3], int nf,
                                             const float* __restrict__ w,
                                             int in_dim, float (&z)[N]) {
  load_bias<OUT>(w + in_dim * OUT, z);
#pragma unroll
  for (int c = 0; c < 3; ++c) axpy<OUT>(p[c], w + c * OUT, z);
  for (int i = 0; i < nf; ++i) {
    const float scale = ldexpf(1.0f, i);  // 2^i, exact
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float sn, cs;
      sincosf(__fmul_rn(scale, p[c]), &sn, &cs);
      axpy<OUT>(sn, w + (3 + 6 * i + c) * OUT, z);
      axpy<OUT>(cs, w + (6 + 6 * i + c) * OUT, z);
    }
  }
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

template <int W>
__global__ void __launch_bounds__(kThreads)
nerf_render_fwd_kernel(const float* __restrict__ pk, int pk_floats,
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

  const int ray = blockIdx.x * kThreads + threadIdx.x;
  if (ray >= n_rays) return;  // ragged last block

  // per-layer offsets into smem
  const int l0_cols = (L == 1) ? kHead : W;
  const float* w_first = smem;
  const float* w_hidden = w_first + in_dim * l0_cols + l0_cols;
  const float* w_head = w_hidden + (L >= 2 ? (L - 2) * (W * W + W) : 0);
  const float* ts = (L == 1) ? w_hidden : w_head + W * kHead + kHead;
  const float* ds = ts + S;

  const float o[3] = {origins[3 * ray], origins[3 * ray + 1], origins[3 * ray + 2]};
  const float d[3] = {directions[3 * ray], directions[3 * ray + 1],
                      directions[3 * ray + 2]};

  float P = 1.0f;  // running product of c over the samples seen so far
  float acc[3] = {0.0f, 0.0f, 0.0f};
  for (int s = 0; s < S; ++s) {
    const float t = ts[s];
    float p[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) p[c] = __fadd_rn(o[c], __fmul_rn(d[c], t));

    float rgba[kHead];
    if (L == 1) {
      encode_layer<kHead>(p, nf, w_first, in_dim, rgba);
    } else {
      float z[W];
      float h[W];
      encode_layer<W>(p, nf, w_first, in_dim, z);
#pragma unroll
      for (int j = 0; j < W; ++j) h[j] = fmaxf(z[j], 0.0f);
      const float* w = w_hidden;
      for (int l = 1; l < L - 1; ++l, w += W * W + W) {
        load_bias<W>(w + W * W, z);
#pragma unroll
        for (int k = 0; k < W; ++k) axpy<W>(h[k], w + k * W, z);
#pragma unroll
        for (int j = 0; j < W; ++j) h[j] = fmaxf(z[j], 0.0f);
      }
      load_bias<kHead>(w_head + W * kHead, rgba);
#pragma unroll
      for (int k = 0; k < W; ++k) axpy<kHead>(h[k], w_head + k * kHead, rgba);
    }

    const float sigma = fmaxf(rgba[3], 0.0f);
    const float e = expf(__fmul_rn(-sigma, ds[s]));
    const float alpha = 1.0f - e;
    const float c = e + 1e-10f;
    float T;
    if (loma) {
      P *= c;
      T = (s == 0) ? 1.0f : P;
    } else {
      T = P;
      P *= c;
    }
    const float wgt = alpha * T;
#pragma unroll
    for (int k = 0; k < 3; ++k) acc[k] = fmaf(wgt, sigmoidf(rgba[k]), acc[k]);
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) out[3 * ray + k] = acc[k];
}

template <int W>
cudaError_t launch(const float* pk, int pk_floats, const float* origins,
                   const float* directions, float* out, int n_rays, int S,
                   int L, int in_dim, int nf, int loma, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(pk_floats) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        nerf_render_fwd_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  nerf_render_fwd_kernel<W><<<blocks, kThreads, smem, stream>>>(
      pk, pk_floats, origins, directions, out, n_rays, S, L, in_dim, nf, loma);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes.  width is the padded hidden width (32 or
// 64); pk_floats a multiple of 4; pk 16-byte aligned.  Returns the launch's
// cudaGetLastError() (0 on success); does not synchronise.
extern "C" int nerf_render_fwd(const float* pk, int pk_floats,
                               const float* origins, const float* directions,
                               float* out, int n_rays, int S, int L,
                               int in_dim, int num_functions, int width,
                               int loma, void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 32:
      return static_cast<int>(launch<32>(pk, pk_floats, origins, directions,
                                         out, n_rays, S, L, in_dim,
                                         num_functions, loma, st));
    case 64:
      return static_cast<int>(launch<64>(pk, pk_floats, origins, directions,
                                         out, n_rays, S, L, in_dim,
                                         num_functions, loma, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
