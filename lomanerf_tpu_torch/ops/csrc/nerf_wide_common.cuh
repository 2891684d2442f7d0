// Per-sample device code shared by the wide NeRF kernels (render forward,
// render backward, train step): element types and rounding, the encoding,
// the rgba head and the compositing forward and adjoint.
//
// Layouts (built by ops/fused_nerf.py:pack_wide_params and the wrappers):
//   W stack (L, pw, pw) in the compute dtype CDT, row-major, layer l's
//     (in, out) weight zero-padded to (pw, pw); b stack (L, pw) f32;
//   activations (rows, pw) in CDT, row = ray * S + s (ray-major: a ray's
//     samples are contiguous, so one warp composites one ray); the encoding
//     fills columns [0, kc) of its buffer (kc: the encoded width padded to
//     8, at most pw), the rest is never read;
//   d_z buffers (rows, pw): f32 (rounded to CDT where a product reads them,
//     summed unrounded for db) or, for bf16, only the rounded copy (the
//     operand of dW, nerf_wide_dw.cuh, and of the next d_h), beside rows of
//     column partials of the unrounded d_z (db's), one per ray here and one
//     per 128-row tile in the d_h GEMM; the head's d_z (rows, 4) f32;
//   depths and steps (template flag kPerRay): (S,) f32 shared by every ray,
//     or per-ray (N, S) f32 row-major, read at [ray * S + s] (the pointers
//     start at the chunk's first ray).  Only the source differs: a row's
//     arithmetic is the same either way.
//
// Rounding plan (the TPU kernels' _mlp_forward / _bwd_from_dcol): the
// encoding, each weight, each stored activation, the rgba head output and
// every d_z entering a product are rounded to CDT; products accumulate in
// f32; biases, compositing and db stay f32.  Built without fast-math, so
// expf and sincosf stay IEEE-accurate; the point o + d*t and sigma*dist are
// rounded without FMA contraction, as in nerf_common.cuh.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "seg_scan.cuh"

namespace wide {
namespace {  // each kernel source gets its own copy

constexpr int kHead = 4;       // rgba channels the render reads
constexpr int kRowChunk = 8192;  // rows per split-K partial of dW / db
constexpr int kCompWarps = 4;  // rays (one warp each) per compositing block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to the compute dtype and back to f32 (identity for f32)
template <typename CDT>
__device__ __forceinline__ float rnd(float x) {
  return to_f32(from_f32<CDT>(x));
}

// four consecutive entries p[0..4) as f32 (p 8-byte aligned for bf16,
// 16-byte for f32)
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
  v[0] = __low2float(a), v[1] = __high2float(a);
  v[2] = __low2float(b), v[3] = __high2float(b);
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// Encoding of the sample point o + d*t for row `row` (ray row / S, sample
// row % S; t = ts[row] per-ray, ts[row % S] shared):
// [p | sin 2^0 p | cos 2^0 p | ... | sin 2^(nf-1) p | cos ...], zeros up to
// kc, rounded to CDT.  One thread per row.
template <typename CDT, bool kPerRay>
__global__ void __launch_bounds__(256)
encode_kernel(const float* __restrict__ origins,
              const float* __restrict__ directions,
              const float* __restrict__ ts, CDT* __restrict__ enc, int rows,
              int S, int pw, int kc, int nf) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  const int ray = row / S, s = row - ray * S;
  const float t = ts[kPerRay ? row : s];
  float p[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    p[c] = __fadd_rn(origins[3 * ray + c], __fmul_rn(directions[3 * ray + c], t));
  }
  CDT* out = enc + static_cast<size_t>(row) * pw;
#pragma unroll
  for (int c = 0; c < 3; ++c) out[c] = from_f32<CDT>(p[c]);
  int f = 3;
  for (int i = 0; i < nf; ++i) {
    const float scale = ldexpf(1.0f, i);  // 2^i, exact
    float sn[3], cs[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) sincosf(__fmul_rn(scale, p[c]), &sn[c], &cs[c]);
#pragma unroll
    for (int c = 0; c < 3; ++c) out[f + c] = from_f32<CDT>(sn[c]);
#pragma unroll
    for (int c = 0; c < 3; ++c) out[f + 3 + c] = from_f32<CDT>(cs[c]);
    f += 6;
  }
  for (; f < kc; ++f) out[f] = from_f32<CDT>(0.0f);
}

// Lane 0's walk of one ray's S samples in order, over a warp's
// shared-memory arrays: the rounded rgb (rgb0-2), alpha (alp) and c = e +
// 1e-10 (cc).  The inclusive product P_s of c (the scans' step,
// seg_scan.cuh) into Pp; w_s = alpha_s T_s, T_s the product before s
// (standard) or through s and 1 at s = 0 (loma); col += w_s rgb_s; w_s to
// weights[s] where given.
__device__ __forceinline__ void composite_walk(const float* rgb0, const float* rgb1,
                                               const float* rgb2, const float* alp,
                                               const float* cc, float* Pp, int S, int loma,
                                               float* weights, float (&col)[3]) {
  float P = 1.0f;
  for (int s = 0; s < S; ++s) {
    float T;
    if (loma) {
      seg::cumprod_step(P, cc[s]);
      T = (s == 0) ? 1.0f : P;
    } else {
      T = P;
      seg::cumprod_step(P, cc[s]);
    }
    Pp[s] = P;
    const float w = alp[s] * T;
    if (weights != nullptr) weights[s] = w;
    col[0] = fmaf(w, rgb0[s], col[0]);
    col[1] = fmaf(w, rgb1[s], col[1]);
    col[2] = fmaf(w, rgb2[s], col[2]);
  }
}

// The colour's cotangent of every lane, from lane 0's colour: kMode 1 (train,
// cot = the ray's target) dcol = 2 (col - target) and the ray's squared
// error returned; kMode 2 (render backward) dcol = cot.
template <int kMode>
__device__ __forceinline__ float colour_adjoint(float (&col)[3], const float* cot,
                                                float (&dcol)[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) col[k] = __shfl_sync(0xffffffffu, col[k], 0);
  float loss = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (kMode == 1) {
      const float diff = col[k] - cot[k];
      loss = fmaf(diff, diff, loss);
      dcol[k] = 2.0f * diff;
    } else {
      dcol[k] = cot[k];
    }
  }
  return loss;
}

// Lane 0's reverse walk, the adjoint of composite_walk from dcol: the
// suffix sum as a scalar (d_c = suf / c, never a later P divided by c);
// d_sigma_s (before the density's ReLU mask) into aux, and w_s over alp
// (alpha_s is read only here).  dr: the ray's steps.
__device__ __forceinline__ void adjoint_walk(const float (&dcol)[3], const float* rgb0,
                                             const float* rgb1, const float* rgb2, float* alp,
                                             const float* cc, const float* Pp,
                                             const float* dr, float* aux, int S, int loma) {
  float suf = 0.0f;    // sum_{s' >= s} d_P_s' P_s'
  float carry = 0.0f;  // standard mode: d_w_{s+1} alpha_{s+1}
  for (int s = S - 1; s >= 0; --s) {
    const float alpha = alp[s];
    const float Ts = (s == 0) ? 1.0f : (loma ? Pp[s] : Pp[s - 1]);
    float d_w = dcol[0] * rgb0[s];
    d_w = fmaf(dcol[1], rgb1[s], d_w);
    d_w = fmaf(dcol[2], rgb2[s], d_w);
    float d_P;
    if (loma) {
      d_P = (s >= 1) ? d_w * alpha : 0.0f;
    } else {
      d_P = (s < S - 1) ? carry : 0.0f;
      carry = d_w * alpha;
    }
    seg::suffix_step(suf, d_P, Pp[s]);
    const float d_alpha = d_w * Ts - suf / cc[s];
    aux[s] = d_alpha * dr[s] * (1.0f - alpha);  // d_sigma
    alp[s] = alpha * Ts;
  }
}

// The compositing step of one ray, one warp per ray.  kMode: 0 render
// (writes the colour), 1 train (cot = targets; writes the ray's squared
// error and runs the adjoint from 2(col - tgt)), 2 render backward (cot =
// the colour cotangent; runs the adjoint).
//
// Lanes work on samples s = lane, lane + 32, ...: the rgba head
// (h_{L-1} . W_head + b_head, 4 columns, rounded to CDT after sigmoid /
// ReLU), alpha and c = exp(-sigma dist) + 1e-10.  Lane 0 then walks the
// samples in order (the running product P_s kept per sample, the colour
// sum) and, for the adjoint, in reverse (the suffix sum as a scalar:
// d_c = suf / c, never a later P divided by c).  Lanes again, per sample:
// the head's d_z (sigmoid' from the rounded rgb, the density's ReLU mask
// from the rounded density).  Then the warp walks the samples, lanes
// across the columns: d_z of layer L-2's output, (rnd(d_z_head) .
// W_head^T) masked by h_{L-1} > 0, written in f32 where dz_prev is given
// and rounded to CDT where dzc_prev is; where db_part is given, each lane
// also sums its columns of the unrounded d_z over the samples in order and
// writes them as the ray's row of db_part ((n, pw) f32).
//
// Shared memory: the head weights (pw x 4, rounded), 8 floats per sample
// per warp and, with db_part, pw floats per warp.  ds: the (S,) shared
// steps, or with kPerRay the chunk's (n, S).  The head reads the first hc
// columns of each row of H (row stride pw): pw after a hidden layer, the
// encoded width kc for a one-layer MLP, whose head reads the encoding.
// Without dz_prev and dzc_prev (a one-layer MLP: no layer below the head)
// the adjoint stops at the head's d_z.
template <typename CDT, int kMode, bool kPerRay>
__global__ void __launch_bounds__(kCompWarps * 32)
composite_kernel(const CDT* __restrict__ H, const CDT* __restrict__ w_head,
                 const float* __restrict__ b_head, const float* __restrict__ ds,
                 const float* __restrict__ cot,
                 float* __restrict__ out, float* __restrict__ dz_head,
                 float* __restrict__ dz_prev, CDT* __restrict__ dzc_prev,
                 float* __restrict__ db_part, int n_rays, int S, int pw, int hc,
                 int loma) {
  extern __shared__ __align__(16) float smem[];
  float4* wh = reinterpret_cast<float4*>(smem);  // pw rows of 4 columns
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* base = smem + 4 * pw + warp * 8 * S;
  float* rgb0 = base;
  float* rgb1 = base + S;
  float* rgb2 = base + 2 * S;
  float* sig = base + 3 * S;    // rounded density
  float* alp = base + 4 * S;    // alpha
  float* cc = base + 5 * S;     // c = e + 1e-10
  float* Pp = base + 6 * S;     // inclusive product P_s
  float* aux = base + 7 * S;    // adjoint: d_sigma; render: unused
  for (int j = threadIdx.x; j < hc; j += blockDim.x) {
    const CDT* w = w_head + static_cast<size_t>(j) * pw;
    wh[j] = make_float4(to_f32(w[0]), to_f32(w[1]), to_f32(w[2]), to_f32(w[3]));
  }
  __syncthreads();
  const int ray = blockIdx.x * kCompWarps + warp;
  if (ray >= n_rays) return;  // no block-wide barrier follows
  const float* dr = kPerRay ? ds + static_cast<size_t>(ray) * S : ds;

  for (int s = lane; s < S; s += 32) {
    const CDT* h = H + (static_cast<size_t>(ray) * S + s) * pw;
    float z[kHead] = {b_head[0], b_head[1], b_head[2], b_head[3]};
    for (int j = 0; j < hc; j += 4) {
      float v[4];
      load4(h + j, v);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 w = wh[j + q];
        z[0] = fmaf(v[q], w.x, z[0]);
        z[1] = fmaf(v[q], w.y, z[1]);
        z[2] = fmaf(v[q], w.z, z[2]);
        z[3] = fmaf(v[q], w.w, z[3]);
      }
    }
    rgb0[s] = rnd<CDT>(sigmoidf(z[0]));
    rgb1[s] = rnd<CDT>(sigmoidf(z[1]));
    rgb2[s] = rnd<CDT>(sigmoidf(z[2]));
    const float sigma = rnd<CDT>(fmaxf(z[3], 0.0f));
    sig[s] = sigma;
    const float e = expf(__fmul_rn(-sigma, dr[s]));
    alp[s] = 1.0f - e;
    cc[s] = e + 1e-10f;
  }
  __syncwarp();

  float col[3] = {0.0f, 0.0f, 0.0f};
  if (lane == 0) composite_walk(rgb0, rgb1, rgb2, alp, cc, Pp, S, loma, nullptr, col);
  if (kMode == 0) {
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < 3; ++k) out[3 * ray + k] = col[k];
    }
    return;
  }
  float dcol[3];
  const float loss = colour_adjoint<kMode>(col, cot + 3 * ray, dcol);
  if (lane == 0) {
    if (kMode == 1) out[ray] = loss;
    adjoint_walk(dcol, rgb0, rgb1, rgb2, alp, cc, Pp, dr, aux, S, loma);
  }
  __syncwarp();

  for (int s = lane; s < S; s += 32) {
    const size_t row = static_cast<size_t>(ray) * S + s;
    const float w = alp[s];
    const float r[3] = {rgb0[s], rgb1[s], rgb2[s]};
    float dz[kHead];
#pragma unroll
    for (int k = 0; k < 3; ++k) dz[k] = dcol[k] * w * r[k] * (1.0f - r[k]);
    dz[3] = sig[s] > 0.0f ? aux[s] : 0.0f;
    *reinterpret_cast<float4*>(dz_head + row * kHead) =
        make_float4(dz[0], dz[1], dz[2], dz[3]);
    // the rounded d_z for the product below, in this sample's slots (read
    // above for the last time)
    rgb0[s] = rnd<CDT>(dz[0]);
    rgb1[s] = rnd<CDT>(dz[1]);
    rgb2[s] = rnd<CDT>(dz[2]);
    sig[s] = rnd<CDT>(dz[3]);
  }
  __syncwarp();
  if (dz_prev == nullptr && dzc_prev == nullptr) return;

  // the samples in turn, a row's columns across the lanes (coalesced)
  float* sums = smem + 4 * pw + kCompWarps * 8 * S + warp * pw;  // with db_part
  if (db_part != nullptr) {
    for (int j = lane; j < pw; j += 32) sums[j] = 0.0f;
  }
  for (int s = 0; s < S; ++s) {
    const size_t row = static_cast<size_t>(ray) * S + s;
    const float dzc[kHead] = {rgb0[s], rgb1[s], rgb2[s], sig[s]};
    const CDT* h = H + row * pw;
    float* g = dz_prev != nullptr ? dz_prev + row * pw : nullptr;
    CDT* gc = dzc_prev != nullptr ? dzc_prev + row * pw : nullptr;
    for (int j = lane; j < pw; j += 32) {
      const float4 wq = wh[j];
      float dh = dzc[0] * wq.x;
      dh = fmaf(dzc[1], wq.y, dh);
      dh = fmaf(dzc[2], wq.z, dh);
      dh = fmaf(dzc[3], wq.w, dh);
      const float o = to_f32(h[j]) > 0.0f ? dh : 0.0f;
      if (g != nullptr) g[j] = o;
      if (gc != nullptr) gc[j] = from_f32<CDT>(o);
      if (db_part != nullptr) sums[j] += o;
    }
  }
  if (db_part != nullptr) {
    for (int j = lane; j < pw; j += 32) db_part[static_cast<size_t>(ray) * pw + j] = sums[j];
  }
}

}  // namespace
}  // namespace wide
