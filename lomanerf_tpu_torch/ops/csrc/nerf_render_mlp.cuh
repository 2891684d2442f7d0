// The narrow render forward's per-thread MLP over a group of samples
// (nerf_render_fwd.cu): one thread runs the MLPs of kGroup (2) samples of
// its ray together, so that each broadcast float4 weight read from shared
// memory feeds 4 * kGroup FMAs where nerf_common.cuh's mlp_rgba (the train
// walk's forward, one sample at a time) feeds 4.
//
// Bits: each sample's arithmetic is mlp_rgba's, in its order: a unit's sum
// starts at its bias and takes the encoded features (x, y, z, then per
// octave sin and cos of each coordinate), then the previous layer's units,
// in order, one fmaf each; h = max(z, 0).  The samples of a group only
// share the weight loads.
//
// Where the activations live: a layer's kGroup x W sums are registers
// (compile-time indices: every loop over units unrolls); its input, the
// previous layer's ReLU output, is staged in this thread's slice of a
// shared-memory buffer (Stage), unit k of the kGroup samples one vector of
// kGroup floats, the vectors of a unit for the block's threads side by side
// (a warp's reads are conflict-free).  So the loop over a layer's inputs
// can roll (the instruction cache: unrolled whole, the kernel's code no
// longer fits it), and the group needs kGroup x W registers where holding
// its inputs too would need twice as many.

#pragma once

#include "nerf_common.cuh"

namespace nerf {
namespace {  // each kernel source gets its own copy

// Samples a thread runs together (its sums are kGroup x W registers), and
// the blocks an SM the kernel at padded width W is built for (at W = 32,
// four of 128 threads: at most 128 registers a thread).  Both chosen by
// scripts/render_variants.py's measurements (PERF.md): groups of 4 need
// ~210 registers and run 8 warps an SM, slower than groups of 2 at 16.
template <int W>
struct RenderPlan {
  static constexpr int kGroup = 2;
  static constexpr int kMinBlocks = W == 32 ? 4 : 1;
};

// kGroup consecutive floats at p (a vector load where they align)
template <int K>
__device__ __forceinline__ void load_group(const float* p, float (&a)[K]) {
  if constexpr (K == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    a[0] = v.x, a[1] = v.y, a[2] = v.z, a[3] = v.w;
  } else if constexpr (K == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    a[0] = v.x, a[1] = v.y;
  } else {
#pragma unroll
    for (int s = 0; s < K; ++s) a[s] = p[s];
  }
}

template <int K>
__device__ __forceinline__ void store_group(float* p, const float (&a)[K]) {
  if constexpr (K == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
  } else if constexpr (K == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(a[0], a[1]);
  } else {
#pragma unroll
    for (int s = 0; s < K; ++s) p[s] = a[s];
  }
}

// z[s][0..OUT) += a[s] * w[0..OUT) for the group's samples, w 16-byte
// aligned in shared memory: one float4 load a 4 K FMAs
template <int OUT, int K, int N>
__device__ __forceinline__ void axpy_group(const float (&a)[K], const float* __restrict__ w,
                                           float (&z)[K][N]) {
  const float4* w4 = reinterpret_cast<const float4*>(w);
#pragma unroll
  for (int j = 0; j < OUT / 4; ++j) {
    const float4 v = w4[j];
#pragma unroll
    for (int s = 0; s < K; ++s) {
      z[s][4 * j + 0] = fmaf(a[s], v.x, z[s][4 * j + 0]);
      z[s][4 * j + 1] = fmaf(a[s], v.y, z[s][4 * j + 1]);
      z[s][4 * j + 2] = fmaf(a[s], v.z, z[s][4 * j + 2]);
      z[s][4 * j + 3] = fmaf(a[s], v.w, z[s][4 * j + 3]);
    }
  }
}

template <int OUT, int K, int N>
__device__ __forceinline__ void bias_group(const float* __restrict__ b, float (&z)[K][N]) {
  const float4* b4 = reinterpret_cast<const float4*>(b);
#pragma unroll
  for (int j = 0; j < OUT / 4; ++j) {
    const float4 v = b4[j];
#pragma unroll
    for (int s = 0; s < K; ++s) {
      z[s][4 * j + 0] = v.x, z[s][4 * j + 1] = v.y;
      z[s][4 * j + 2] = v.z, z[s][4 * j + 3] = v.w;
    }
  }
}

// This thread's slice of the activation buffer: unit k of its kGroup
// samples at h + k * stride (stride = kGroup x the block's threads)
struct Stage {
  float* h;
  int stride;
  __device__ float* unit(int k) const { return h + k * stride; }
};

// Layer 0 straight from the encoding of the group's points, as
// encode_layer (nerf_common.cuh) for each sample: bias, x, y, z, then per
// octave i and coordinate c, sin(2^i p_c) then cos(2^i p_c).
template <int OUT, int K, int N>
__device__ __forceinline__ void encode_group(const float (&p)[K][3], int nf,
                                             const float* __restrict__ w, int in_dim,
                                             float (&z)[K][N]) {
  bias_group<OUT>(w + in_dim * OUT, z);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float a[K];
#pragma unroll
    for (int s = 0; s < K; ++s) a[s] = p[s][c];
    axpy_group<OUT>(a, w + c * OUT, z);
  }
  for (int i = 0; i < nf; ++i) {
    const float scale = ldexpf(1.0f, i);  // 2^i, exact
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float sn[K], cs[K];
#pragma unroll
      for (int s = 0; s < K; ++s) sincosf(__fmul_rn(scale, p[s][c]), &sn[s], &cs[s]);
      axpy_group<OUT>(sn, w + (3 + 6 * i + c) * OUT, z);
      axpy_group<OUT>(cs, w + (6 + 6 * i + c) * OUT, z);
    }
  }
}

// h = max(z, 0) of the group into the stage, unit by unit
template <int W, int K>
__device__ __forceinline__ void stage_relu(const float (&z)[K][W], const Stage& st) {
#pragma unroll
  for (int j = 0; j < W; ++j) {
    float h[K];
#pragma unroll
    for (int s = 0; s < K; ++s) h[s] = fmaxf(z[s][j], 0.0f);
    store_group(st.unit(j), h);
  }
}

// z = b + h @ w over the W staged inputs, in order (the loop rolls, two
// inputs an iteration)
template <int OUT, int W, int K, int N>
__device__ __forceinline__ void layer_group(const Stage& st, const float* __restrict__ w,
                                            float (&z)[K][N]) {
  bias_group<OUT>(w + W * OUT, z);
#pragma unroll 2
  for (int k = 0; k < W; ++k) {
    float a[K];
    load_group(st.unit(k), a);
    axpy_group<OUT>(a, w + k * OUT, z);
  }
}

// The MLP at the group's points: raw head outputs rgba[s][0..4) (before
// sigmoid / ReLU), each sample's bits those of mlp_rgba.
template <int W, int K>
__device__ __forceinline__ void mlp_rgba_group(const float (&p)[K][3], const Layout& lay,
                                               const Stage& st, float (&rgba)[K][kHead]) {
  if (lay.L == 1) {
    encode_group<kHead>(p, lay.nf, lay.w_first, lay.in_dim, rgba);
    return;
  }
  float z[K][W];
  encode_group<W>(p, lay.nf, lay.w_first, lay.in_dim, z);
  stage_relu(z, st);
  const float* w = lay.w_hidden;
  for (int l = 1; l < lay.L - 1; ++l, w += W * W + W) {
    layer_group<W, W>(st, w, z);
    stage_relu(z, st);
  }
  layer_group<kHead, W>(st, lay.w_head, rgba);
}

}  // namespace
}  // namespace nerf
