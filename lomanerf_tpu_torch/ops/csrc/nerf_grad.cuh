// The reverse walk shared by the train kernel (nerf_train.cu) and the render
// backward (nerf_render_bwd.cu), and by their per-ray depth instances
// (nerf_train_rays.cu, nerf_render_bwd_rays.cu): per ray, the forward, then
// the compositing adjoint and the MLP backward sample by sample in reverse,
// with dW/db reduced across the block's rays in shared memory and across
// blocks by a second, fixed-order kernel.
//
// Per ray (one thread), from the colour cotangent dcol (train: 2(col - tgt)
// for valid rays; render backward: the given (N, 3) cotangent):
//   pass 1, s = 0..S-1: the forward; keeps the inclusive product
//     P_s = prod_{k<=s} c_k of every sample in shared memory, since
//     dividing it back out of a later P is wrong where c = 1e-10 and P
//     underflows;
//   pass 2, s = S-1..0: recomputes the sample's MLP forward (remat, as the
//     TPU backward does), staging each layer's input in shared memory; then
//       d_w = dcol . rgb_s
//       loma:     d_P_s = [s >= 1] d_w_s alpha_s
//       standard: d_P_s = [s < S-1] d_w_{s+1} alpha_{s+1}   (carried)
//       suf += d_P_s P_s;   d_c = suf / c_s   (the suffix sum, a scalar)
//       d_alpha = d_w T_s - d_c;   d_sigma = d_alpha dist_s (1 - alpha_s)
//     the head's sigmoid' / ReLU' give d_z of the last layer, and
//     d_h = d_z W^T masked by h > 0 gives d_z of each layer below; d_z rows
//     are staged beside the activations.
//   After each sample, a barrier, then the dW stage adds the sample's
//   dW/db over the block's rays (sum_r h_l[i][r] d_z_l[j][r]) into the
//   block's shared-memory accumulator, and a barrier again.
//
// Code size is the walk's other cost (the instruction cache): so the two
// passes are one loop over 2S steps with one inlined forward (walk_forward;
// pass 1 stages its activations too, pass 2 writes over them), and at
// W = 64 the forward's hidden layers and head read their inputs back from
// the staged column in a rolled loop, and d_h's loop over units rolls.
//
// The dW stage's tile plan (DwTile): a layer of R input rows, then its bias
// (a row of ones), and C columns (W, or kHead for the head) is cut into
// kCG = min(C, 8) column groups and kRG = 64 / kCG row groups.  Thread
// t = rg * kCG + cg owns
//   * a main tile: rows rg + kRG*a (a < kTR = W / kRG) below R, columns
//     cg + kCG*b (b < kTC = C / kCG): 4 x 4 entries of a W = 32 layer, 8 x 8
//     at W = 64, 2 x 1 (W = 32) or 4 x 1 (W = 64) of the head.  Its
//     per-sample sums are kTR x kTC registers (16 or 2 at W = 32, 64 or 4
//     at W = 64);
//   * the remainder, entry by entry: the rows [min(R, W), R] (the bias row
//     last), entry e of them (row-major) to thread e % 64: at 33 inputs,
//     layer 0's row 32 and every bias row.
// The staging rows have a stride of 68 floats (kStride, a multiple of 4 and
// 4 mod 32), so the stage reads 4 rays of a row as one float4: per 4 rays a
// main tile loads kTR + kTC float4s (8 at W = 32) for 4 kTR kTC FMAs (64),
// where the walk's one-entry loop read 2 floats per FMA; the walk's own
// stores and reads down its column stay free of bank conflicts.  The plan's
// host mirror is fused_nerf.grad_tile_plan.
//
// Bits: every sum has the order it had before the tiles (the kernel's
// digests pin it): an entry's per-sample sum starts at 0 and takes the rays
// r = 0..63 in turn (a bias: sum += d_z), then adds into the accumulator
// once; the samples come in the order s = S-1..0; the blocks' partials are
// summed in a fixed order.  So two launches on the same inputs give
// bit-identical gradients and loss.
// Pad rays (ray >= n_rays) run every loop and barrier with zero rays and a
// zero cotangent, so they add exact zeros: no thread leaves early.  With
// per-ray depths (kPerRay) they read ray 0's row, never one past n_rays.

#pragma once

#include "block_sum.cuh"
#include "nerf_common.cuh"

namespace nerf {
namespace {  // each kernel source gets its own copy

constexpr int kGradThreads = 64;           // rays per block
constexpr int kStride = kGradThreads + 4;  // staging row stride: 4 rays of a
                                           // row are one aligned float4

// Dynamic shared memory of the gradient kernel, in floats: the packed
// parameters, the dW/db accumulator, P_s per sample and ray, the staged
// layer inputs and d_z rows, and the per-ray losses.
__host__ __device__ inline size_t grad_smem_floats(int pk_floats, int G, int S,
                                                   int L, int in_dim, int W) {
  return static_cast<size_t>(pk_floats) + G + S * kGradThreads +
         static_cast<size_t>(in_dim + (L - 1) * W) * kStride +
         static_cast<size_t>((L - 1) * W + kHead) * kStride + kGradThreads;
}

// The MLP at point p for the walk: raw head outputs rgba[0..4), the input of
// every layer stored down this ray's column `col` of the staging (rows
// [0, in_dim) the encoding, rows in_dim + (l-1)*W + [0, W) the input of
// layer l >= 1).  At W = 32 it is mlp_rgba (nerf_common.cuh), its
// activations in registers and its loops over inputs unrolled.  At W = 64
// (a compile-time choice: unrolled, a layer is 4,096 FMAs of code) the
// arithmetic is the same, but each hidden layer and the head read their
// inputs back from the staged column in a loop that rolls 4 inputs an
// iteration.
template <int W>
__device__ __forceinline__ void walk_forward(const float (&p)[3],
                                             const Layout& lay,
                                             float (&rgba)[kHead],
                                             float* col) {
  if constexpr (W == 32) {
    mlp_rgba<W, true>(p, lay, rgba, col, kStride);
    return;
  }
  if (lay.L == 1) {
    encode_layer<kHead, kHead, true>(p, lay.nf, lay.w_first, lay.in_dim, rgba,
                                     col, kStride);
    return;
  }
  float z[W];
  encode_layer<W, W, true>(p, lay.nf, lay.w_first, lay.in_dim, z, col,
                           kStride);
  float* hcol = col + lay.in_dim * kStride;
#pragma unroll
  for (int j = 0; j < W; ++j) hcol[j * kStride] = fmaxf(z[j], 0.0f);
  const float* w = lay.w_hidden;
  for (int l = 1; l < lay.L - 1; ++l, w += W * W + W) {
    load_bias<W>(w + W * W, z);
#pragma unroll 4
    for (int k = 0; k < W; ++k) axpy<W>(hcol[k * kStride], w + k * W, z);
    hcol += W * kStride;
#pragma unroll
    for (int j = 0; j < W; ++j) hcol[j * kStride] = fmaxf(z[j], 0.0f);
  }
  load_bias<kHead>(lay.w_head + W * kHead, rgba);
#pragma unroll 4
  for (int k = 0; k < W; ++k) {
    axpy<kHead>(hcol[k * kStride], lay.w_head + k * kHead, rgba);
  }
}

// From the head's d_z, d_z of every layer below, written down this ray's
// column of the d_z staging (layer l at rows l*W).  my_act is this ray's
// column of the staged layer inputs.  d_h = d_z W^T is one fmaf chain per
// unit over the layer's outputs in order.  At W = 32 the loops over units
// are unrolled and d_z stays in registers from layer to layer (the compiler
// interleaves the chains); at W = 64 (a compile-time choice, as
// walk_forward's) each layer reads its d_z back from the column and the
// loop over units rolls, kChains units an iteration written side by side so
// that their chains interleave.
constexpr int kChains = 8;

template <int W>
__device__ __forceinline__ void backprop_hidden(const Layout& lay,
                                                const float (&dz_head)[kHead],
                                                const float* my_act,
                                                float* my_dz) {
  const float* h = my_act + (lay.in_dim + (lay.L - 2) * W) * kStride;
  float* out = my_dz + (lay.L - 2) * W * kStride;
  const float4* head = reinterpret_cast<const float4*>(lay.w_head);
  if constexpr (W == 32) {
    float g[W];
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const float4 w = head[i];
      float dh = dz_head[0] * w.x;
      dh = fmaf(dz_head[1], w.y, dh);
      dh = fmaf(dz_head[2], w.z, dh);
      dh = fmaf(dz_head[3], w.w, dh);
      g[i] = h[i * kStride] > 0.0f ? dh : 0.0f;
      out[i * kStride] = g[i];
    }
    for (int l = lay.L - 2; l >= 1; --l) {
      const float4* wl = reinterpret_cast<const float4*>(lay.weights(l));
      const float* hl = my_act + (lay.in_dim + (l - 1) * W) * kStride;
      out -= W * kStride;
      float ng[W];
#pragma unroll
      for (int i = 0; i < W; ++i) {
        float dh = 0.0f;
#pragma unroll
        for (int j = 0; j < W / 4; ++j) {
          const float4 v = wl[i * (W / 4) + j];
          dh = fmaf(g[4 * j + 0], v.x, dh);
          dh = fmaf(g[4 * j + 1], v.y, dh);
          dh = fmaf(g[4 * j + 2], v.z, dh);
          dh = fmaf(g[4 * j + 3], v.w, dh);
        }
        ng[i] = hl[i * kStride] > 0.0f ? dh : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < W; ++i) {
        g[i] = ng[i];
        out[i * kStride] = g[i];
      }
    }
  } else {
#pragma unroll 8
    for (int i = 0; i < W; ++i) {
      const float4 w = head[i];
      float dh = dz_head[0] * w.x;
      dh = fmaf(dz_head[1], w.y, dh);
      dh = fmaf(dz_head[2], w.z, dh);
      dh = fmaf(dz_head[3], w.w, dh);
      out[i * kStride] = h[i * kStride] > 0.0f ? dh : 0.0f;
    }
    for (int l = lay.L - 2; l >= 1; --l) {
      float g[W];  // d_z of layer l
#pragma unroll
      for (int j = 0; j < W; ++j) g[j] = out[j * kStride];
      const float4* wl = reinterpret_cast<const float4*>(lay.weights(l));
      const float* hl = my_act + (lay.in_dim + (l - 1) * W) * kStride;
      out -= W * kStride;
      for (int i0 = 0; i0 < W; i0 += kChains) {
        float dh[kChains];
#pragma unroll
        for (int q = 0; q < kChains; ++q) dh[q] = 0.0f;
#pragma unroll
        for (int j = 0; j < W / 4; ++j) {
#pragma unroll
          for (int q = 0; q < kChains; ++q) {
            const float4 v = wl[(i0 + q) * (W / 4) + j];
            dh[q] = fmaf(g[4 * j + 0], v.x, dh[q]);
            dh[q] = fmaf(g[4 * j + 1], v.y, dh[q]);
            dh[q] = fmaf(g[4 * j + 2], v.z, dh[q]);
            dh[q] = fmaf(g[4 * j + 3], v.w, dh[q]);
          }
        }
#pragma unroll
        for (int q = 0; q < kChains; ++q) {
          const int i = i0 + q;
          out[i * kStride] = hl[i * kStride] > 0.0f ? dh[q] : 0.0f;
        }
      }
    }
  }
}

// The dW stage's plan of a layer with C columns (the header's tile plan).
template <int W, int C>
struct DwTile {
  static constexpr int kCG = C < 8 ? C : 8;         // column groups
  static constexpr int kRG = kGradThreads / kCG;    // row groups
  static constexpr int kTC = C / kCG;               // a main tile's columns
  static constexpr int kTR = W / kRG;               // and rows
};

__device__ __forceinline__ float4 ray4(const float* row, int r) {
  return *reinterpret_cast<const float4*>(row + r);
}

// acc_l += this sample's dW/db of one layer (R input rows, C columns) over
// the block's rays: hrows its staged input rows, zrows its staged d_z rows.
// The main tile spans rows [0, W) whatever R, so its r loop runs without a
// branch: a row at or past R (layer 0 with fewer inputs than W) reads row
// R - 1 again and its sums are dropped.
template <int W, int C>
__device__ __forceinline__ void layer_dw(const float* hrows, const float* zrows,
                                         int R, float* acc_l, int tid) {
  using P = DwTile<W, C>;
  const int rg = tid / P::kCG, cg = tid - rg * P::kCG;
  const float* hr[P::kTR];  // row rg + kRG*a
#pragma unroll
  for (int a = 0; a < P::kTR; ++a) hr[a] = hrows + min(rg + a * P::kRG, R - 1) * kStride;
  const float* zc = zrows + cg * kStride;  // column cg + kCG*b: + b*kCG*kStride
  float sum[P::kTR][P::kTC];
#pragma unroll
  for (int a = 0; a < P::kTR; ++a) {
#pragma unroll
    for (int b = 0; b < P::kTC; ++b) sum[a][b] = 0.0f;
  }
#pragma unroll 2
  for (int r = 0; r < kGradThreads; r += 4) {
    float4 z[P::kTC];
#pragma unroll
    for (int b = 0; b < P::kTC; ++b) z[b] = ray4(zc + b * P::kCG * kStride, r);
#pragma unroll
    for (int a = 0; a < P::kTR; ++a) {
      const float4 h = ray4(hr[a], r);
#pragma unroll
      for (int b = 0; b < P::kTC; ++b) {
        sum[a][b] = fmaf(h.x, z[b].x, sum[a][b]);
        sum[a][b] = fmaf(h.y, z[b].y, sum[a][b]);
        sum[a][b] = fmaf(h.z, z[b].z, sum[a][b]);
        sum[a][b] = fmaf(h.w, z[b].w, sum[a][b]);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < P::kTR; ++a) {
    const int i = rg + a * P::kRG;
    if (i < R) {
#pragma unroll
      for (int b = 0; b < P::kTC; ++b) acc_l[i * C + cg + b * P::kCG] += sum[a][b];
    }
  }
  // the rows past the main tile's, then the bias row (index R: it follows
  // the weights)
  const int r0 = min(R, W);
  const int n = (R + 1 - r0) * C;
  for (int e = tid; e < n; e += kGradThreads) {
    const int i = r0 + e / C, j = e - (e / C) * C;
    const float* zr = zrows + j * kStride;
    float s = 0.0f;
    if (i < R) {
      const float* h = hrows + i * kStride;
#pragma unroll 4
      for (int r = 0; r < kGradThreads; r += 4) {
        const float4 hv = ray4(h, r), zv = ray4(zr, r);
        s = fmaf(hv.x, zv.x, s);
        s = fmaf(hv.y, zv.y, s);
        s = fmaf(hv.z, zv.z, s);
        s = fmaf(hv.w, zv.w, s);
      }
    } else {
#pragma unroll 4
      for (int r = 0; r < kGradThreads; r += 4) {
        const float4 zv = ray4(zr, r);
        s += zv.x;
        s += zv.y;
        s += zv.z;
        s += zv.w;
      }
    }
    acc_l[i * C + j] += s;
  }
}

// acc += this sample's dW/db over the block's rays, layer by layer.
template <int W>
__device__ __forceinline__ void accumulate_block(const Layout& lay,
                                                 const float* act,
                                                 const float* dz, float* acc,
                                                 int tid) {
  int arow = 0;
  for (int l = 0; l < lay.L; ++l) {
    const int R = lay.rows(l);
    float* acc_l = acc + (lay.weights(l) - lay.w_first);
    const float* hrows = act + arow * kStride;
    const float* zrows = dz + l * W * kStride;
    if (l == lay.L - 1) {
      layer_dw<W, kHead>(hrows, zrows, R, acc_l, tid);
    } else {
      layer_dw<W, W>(hrows, zrows, R, acc_l, tid);
    }
    arow += R;
  }
}

// kTrain: `cot` holds (N, 3) targets, the cotangent is 2(col - tgt) and the
// masked sum-MSE is the loss.  Otherwise `cot` is the (N, 3) colour
// cotangent and the loss slot is 0.  Writes this block's G gradient floats
// and its loss to partials[blockIdx.x * (G + 1) ...].
template <int W, bool kTrain, bool kPerRay>
__global__ void __launch_bounds__(kGradThreads)
nerf_grad_kernel(const float* __restrict__ pk, int pk_floats, int G,
                 const float* __restrict__ t_rays,
                 const float* __restrict__ d_rays,
                 const float* __restrict__ origins,
                 const float* __restrict__ directions,
                 const float* __restrict__ cot, float* __restrict__ partials,
                 int n_rays, int S, int L, int in_dim, int nf, int loma) {
  extern __shared__ __align__(16) float smem[];
  float* acc = smem + pk_floats;
  float* pbuf = acc + G;
  float* act = pbuf + S * kGradThreads;
  float* dz = act + (in_dim + (L - 1) * W) * kStride;
  float* lossbuf = dz + ((L - 1) * W + kHead) * kStride;
  const int tid = threadIdx.x;
  {
    const float4* src = reinterpret_cast<const float4*>(pk);
    float4* dst = reinterpret_cast<float4*>(smem);
    for (int i = tid; i < pk_floats / 4; i += kGradThreads) dst[i] = src[i];
    for (int i = tid; i < G; i += kGradThreads) acc[i] = 0.0f;
  }
  __syncthreads();

  const Layout lay(smem, L, W, in_dim, nf, S);
  const int ray = blockIdx.x * kGradThreads + tid;
  const bool valid = ray < n_rays;  // the runtime ray count masks pad rays
  const float *ts, *ds;
  ray_depths<kPerRay>(lay, t_rays, d_rays, valid ? ray : 0, &ts, &ds);
  float o[3] = {0.0f, 0.0f, 0.0f}, d[3] = {0.0f, 0.0f, 0.0f};
  float y[3] = {0.0f, 0.0f, 0.0f};
  if (valid) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      o[k] = origins[3 * ray + k];
      d[k] = directions[3 * ray + k];
      y[k] = cot[3 * ray + k];
    }
  }

  // The two passes run as one loop over 2S steps, so that the forward (most
  // of the kernel's code) is inlined once: step it < S is pass 1 at s = it,
  // the others pass 2 at s = 2S-1-it.  Pass 1 stages its activations too
  // (pass 2 writes over them); the arithmetic is the same either way.
  float* my_act = act + tid;
  float* my_dz = dz + tid;
  float P = 1.0f;
  float col[3] = {0.0f, 0.0f, 0.0f};
  float dcol[3] = {0.0f, 0.0f, 0.0f};
  float loss = 0.0f;
  float suf = 0.0f;    // sum_{s' >= s} d_P_s' P_s'
  float carry = 0.0f;  // standard mode: d_w_{s+1} alpha_{s+1}
  for (int it = 0; it < 2 * S; ++it) {
    const bool pass1 = it < S;
    const int s = pass1 ? it : 2 * S - 1 - it;
    float p[3];
    sample_point(o, d, ts[s], p);
    float raw[kHead];
    walk_forward<W>(p, lay, raw, my_act);
    float alpha, c;
    sample_alpha(raw[3], ds[s], &alpha, &c);
    if (pass1) {
      const float wgt = alpha * transmittance(&P, c, s, loma);
      pbuf[s * kGradThreads + tid] = P;
#pragma unroll
      for (int k = 0; k < 3; ++k) col[k] = fmaf(wgt, sigmoidf(raw[k]), col[k]);
      if (s == S - 1) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          if (kTrain) {
            const float diff = valid ? col[k] - y[k] : 0.0f;
            loss = fmaf(diff, diff, loss);
            dcol[k] = 2.0f * diff;
          } else {
            dcol[k] = y[k];
          }
        }
      }
      continue;
    }
    const float Ps = pbuf[s * kGradThreads + tid];
    const float Ts = (s == 0) ? 1.0f
                     : loma   ? Ps
                              : pbuf[(s - 1) * kGradThreads + tid];
    const float w = alpha * Ts;
    float rgb[3];
    float d_w = 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      rgb[k] = sigmoidf(raw[k]);
      d_w = fmaf(dcol[k], rgb[k], d_w);
    }
    float d_P;
    if (loma) {
      d_P = (s >= 1) ? d_w * alpha : 0.0f;
    } else {
      d_P = (s < S - 1) ? carry : 0.0f;
      carry = d_w * alpha;
    }
    seg::suffix_step(suf, d_P, Ps);  // the suffix sum's step (seg_scan.cuh)
    const float d_c = suf / c;
    const float d_alpha = d_w * Ts - d_c;
    const float d_sigma = d_alpha * ds[s] * (1.0f - alpha);

    float dz_head[kHead];
#pragma unroll
    for (int k = 0; k < 3; ++k) dz_head[k] = dcol[k] * w * rgb[k] * (1.0f - rgb[k]);
    dz_head[3] = raw[3] > 0.0f ? d_sigma : 0.0f;
    float* head_dz = my_dz + (L - 1) * W * kStride;
#pragma unroll
    for (int k = 0; k < kHead; ++k) head_dz[k * kStride] = dz_head[k];
    if (L >= 2) backprop_hidden<W>(lay, dz_head, my_act, my_dz);

    __syncthreads();
    accumulate_block<W>(lay, act, dz, acc, tid);
    __syncthreads();
  }

  lossbuf[tid] = loss;
  __syncthreads();
  float* part = partials + static_cast<size_t>(blockIdx.x) * (G + 1);
  for (int e = tid; e < G; e += kGradThreads) part[e] = acc[e];
  if (tid == 0) {
    float total = 0.0f;
    for (int r = 0; r < kGradThreads; ++r) total += lossbuf[r];
    part[G] = total;
  }
}

// The gradient kernel, then the fixed-order sum of its partials into
// out[0..G] (G gradient floats, then the loss), both on `stream`.
template <int W, bool kTrain, bool kPerRay>
cudaError_t launch_grad(const float* pk, int pk_floats, int G,
                        const float* t_rays, const float* d_rays,
                        const float* origins, const float* directions,
                        const float* cot, float* partials, float* out,
                        int n_rays, int S, int L, int in_dim, int nf, int loma,
                        cudaStream_t stream) {
  if (n_rays <= 0) {
    return cudaMemsetAsync(out, 0, sizeof(float) * (G + 1), stream);
  }
  const size_t smem =
      grad_smem_floats(pk_floats, G, S, L, in_dim, W) * sizeof(float);
  if (smem > 48 * 1024) {  // above 227 KB this refuses with an error
    cudaError_t err = cudaFuncSetAttribute(
        nerf_grad_kernel<W, kTrain, kPerRay>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int blocks = (n_rays + kGradThreads - 1) / kGradThreads;
  nerf_grad_kernel<W, kTrain, kPerRay><<<blocks, kGradThreads, smem, stream>>>(
      pk, pk_floats, G, t_rays, d_rays, origins, directions, cot, partials,
      n_rays, S, L, in_dim, nf, loma);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int P = G + 1;
  sum_block_partials<<<(P + 31) / 32, kSumWarps * 32, 0, stream>>>(
      partials, blocks, P, out);
  return cudaGetLastError();
}

// t_rays / d_rays: the (N, S) per-ray depths and steps with kPerRay, else
// unread (the shared ones travel at the end of pk).
template <bool kTrain, bool kPerRay>
int dispatch_grad(const float* pk, int pk_floats, int G, const float* t_rays,
                  const float* d_rays, const float* origins,
                  const float* directions, const float* cot, float* partials,
                  float* out, int n_rays, int S, int L, int in_dim, int nf,
                  int width, int loma, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 32:
      return static_cast<int>(launch_grad<32, kTrain, kPerRay>(
          pk, pk_floats, G, t_rays, d_rays, origins, directions, cot,
          partials, out, n_rays, S, L, in_dim, nf, loma, st));
    case 64:
      return static_cast<int>(launch_grad<64, kTrain, kPerRay>(
          pk, pk_floats, G, t_rays, d_rays, origins, directions, cot,
          partials, out, n_rays, S, L, in_dim, nf, loma, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace nerf
