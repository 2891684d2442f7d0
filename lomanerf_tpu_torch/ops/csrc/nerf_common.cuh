// Device code shared by the narrow NeRF kernels (render forward, render
// backward, train step), so that all three compute the forward identically.
//
// Packed parameter buffer (floats, built by ops/fused_nerf.py), per layer l:
//   W_l padded to (rows_l, cols_l) row-major, then b_l padded to cols_l,
// where rows_0 = in_dim, rows_l = W for l >= 1, cols_l = W for l < L-1 and
// cols_{L-1} = 4; then, for depths shared by every ray, t[0..S) and
// dist[0..S); padded to a multiple of 4 floats.  Every block is a multiple
// of 4 floats, so each layer starts 16-byte aligned.  The gradient buffers
// the backward kernels write use the same per-layer layout without t/dist
// (G floats), followed by the loss.
//
// Depth source (template flag kPerRay of every kernel): shared depths come
// from the packed buffer's tail (Layout::ts/ds); per-ray depths from row
// `ray` of two (N, S) f32 arrays in device memory (ray_depths), and the
// packed buffer then has no tail.  Only the source differs: a ray's
// arithmetic is the same either way.
//
// Exactness: built without fast-math, so expf and sincosf stay IEEE-accurate;
// the 1e-10 epsilon in c = e + 1e-10 is kept, and sigma = 0 against the 1e8
// far sentinel gives exp(-0) = 1, alpha = 0 exactly.  The point o + d*t and
// the product sigma*dist are rounded as the reference rounds them (no FMA
// contraction), since the encoding amplifies the point's error by 2^(n-1).

#pragma once

#include <cuda_runtime.h>

#include "seg_scan.cuh"

namespace nerf {
namespace {  // each kernel source gets its own copy

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

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// Offsets of the packed buffer once it sits in shared memory at `base`.
struct Layout {
  int L, W, in_dim, nf, S;
  const float* w_first;   // layer 0: (in_dim, l0_cols) then bias
  const float* w_hidden;  // layers 1..L-2: (W, W) then bias, each
  const float* w_head;    // layer L-1 (L >= 2): (W, 4) then bias
  const float* ts;        // shared t[0..S) (past the weights; absent per-ray)
  const float* ds;        // shared dist[0..S)

  __device__ Layout(const float* base, int L_, int W_, int in_dim_, int nf_,
                    int S_)
      : L(L_), W(W_), in_dim(in_dim_), nf(nf_), S(S_) {
    const int l0_cols = (L == 1) ? kHead : W;
    w_first = base;
    w_hidden = w_first + in_dim * l0_cols + l0_cols;
    w_head = w_hidden + (L >= 2 ? (L - 2) * (W * W + W) : 0);
    ts = (L == 1) ? w_hidden : w_head + W * kHead + kHead;
    ds = ts + S;
  }

  // packed weight block of layer l (its bias follows rows(l) * cols(l))
  __device__ const float* weights(int l) const {
    if (l == 0) return w_first;
    if (l == L - 1) return w_head;
    return w_hidden + (l - 1) * (W * W + W);
  }
  __device__ int rows(int l) const { return l == 0 ? in_dim : W; }
  __device__ int cols(int l) const { return l == L - 1 ? kHead : W; }
};

// The depths and steps one ray reads: the shared ones of the packed buffer,
// or row `ray` of the (N, S) arrays t_rays / d_rays (a stride of S floats
// across a warp: uncoalesced, read once per sample and pass).
template <bool kPerRay>
__device__ __forceinline__ void ray_depths(const Layout& lay,
                                           const float* __restrict__ t_rays,
                                           const float* __restrict__ d_rays,
                                           int ray, const float** ts,
                                           const float** ds) {
  if (kPerRay) {
    const size_t row = static_cast<size_t>(ray) * lay.S;
    *ts = t_rays + row;
    *ds = d_rays + row;
  } else {
    *ts = lay.ts;
    *ds = lay.ds;
  }
}

// The sample point o + d*t, rounded as the reference rounds it.
__device__ __forceinline__ void sample_point(const float (&o)[3],
                                             const float (&d)[3], float t,
                                             float (&p)[3]) {
#pragma unroll
  for (int c = 0; c < 3; ++c) p[c] = __fadd_rn(o[c], __fmul_rn(d[c], t));
}

// Layer 0 straight from the encoding of point p: z = enc(p) @ W0 + b0.
// Encoded row of sin(2^i p_c) is 3 + 6i + c, of cos(2^i p_c) 6 + 6i + c.
// With kStage, feature f is also stored at col[f * stride] (the backward's
// activation staging; the arithmetic is the same either way).
template <int OUT, int N, bool kStage>
__device__ __forceinline__ void encode_layer(const float (&p)[3], int nf,
                                             const float* __restrict__ w,
                                             int in_dim, float (&z)[N],
                                             float* col, int stride) {
  load_bias<OUT>(w + in_dim * OUT, z);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    axpy<OUT>(p[c], w + c * OUT, z);
    if (kStage) col[c * stride] = p[c];
  }
  for (int i = 0; i < nf; ++i) {
    const float scale = ldexpf(1.0f, i);  // 2^i, exact
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float sn, cs;
      sincosf(__fmul_rn(scale, p[c]), &sn, &cs);
      axpy<OUT>(sn, w + (3 + 6 * i + c) * OUT, z);
      axpy<OUT>(cs, w + (6 + 6 * i + c) * OUT, z);
      if (kStage) {
        col[(3 + 6 * i + c) * stride] = sn;
        col[(6 + 6 * i + c) * stride] = cs;
      }
    }
  }
}

// The MLP at point p: raw head outputs rgba[0..4) (before sigmoid / ReLU).
// With kStage, the input of every layer (the encoding, then each hidden
// activation) is stored down the column `col` with row stride `stride`:
// rows [0, in_dim) the encoding, rows in_dim + (l-1)*W + [0, W) the input
// of layer l >= 1.
template <int W, bool kStage>
__device__ __forceinline__ void mlp_rgba(const float (&p)[3], const Layout& lay,
                                         float (&rgba)[kHead], float* col,
                                         int stride) {
  if (lay.L == 1) {
    encode_layer<kHead, kHead, kStage>(p, lay.nf, lay.w_first, lay.in_dim,
                                       rgba, col, stride);
    return;
  }
  float z[W];
  float h[W];
  encode_layer<W, W, kStage>(p, lay.nf, lay.w_first, lay.in_dim, z, col,
                             stride);
  float* hcol = kStage ? col + lay.in_dim * stride : nullptr;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    h[j] = fmaxf(z[j], 0.0f);
    if (kStage) hcol[j * stride] = h[j];
  }
  const float* w = lay.w_hidden;
  for (int l = 1; l < lay.L - 1; ++l, w += W * W + W) {
    load_bias<W>(w + W * W, z);
#pragma unroll
    for (int k = 0; k < W; ++k) axpy<W>(h[k], w + k * W, z);
    if (kStage) hcol += W * stride;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      h[j] = fmaxf(z[j], 0.0f);
      if (kStage) hcol[j * stride] = h[j];
    }
  }
  load_bias<kHead>(lay.w_head + W * kHead, rgba);
#pragma unroll
  for (int k = 0; k < W; ++k) axpy<kHead>(h[k], lay.w_head + k * kHead, rgba);
}

// One compositing step from the raw density: alpha = 1 - e and
// c = e + 1e-10 with e = exp(-sigma * dist), sigma = ReLU(raw).
__device__ __forceinline__ void sample_alpha(float raw_sigma, float dist,
                                             float* alpha, float* c) {
  const float sigma = fmaxf(raw_sigma, 0.0f);
  const float e = expf(__fmul_rn(-sigma, dist));
  *alpha = 1.0f - e;
  *c = e + 1e-10f;
}

// Advance the running product P of c over the samples seen so far (the
// inclusive cumprod's step, seg_scan.cuh) and return this sample's
// transmittance: loma mode T[0] = 1 and T[s] = P after the multiply
// (inclusive); standard mode T[s] = P before it (the shift down, fill 1).
__device__ __forceinline__ float transmittance(float* P, float c, int s,
                                               int loma) {
  if (loma) {
    seg::cumprod_step(*P, c);
    return (s == 0) ? 1.0f : *P;
  }
  const float T = *P;
  seg::cumprod_step(*P, c);
  return T;
}

}  // namespace
}  // namespace nerf
