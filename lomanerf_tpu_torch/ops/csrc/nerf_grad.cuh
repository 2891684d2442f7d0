// The reverse walk shared by the train kernel (nerf_train.cu) and the render
// backward (nerf_render_bwd.cu), and by their per-ray depth instances
// (nerf_train_rays.cu, nerf_render_bwd_rays.cu): per ray, the forward, then
// the compositing adjoint and the MLP backward sample by sample in reverse,
// with dW/db reduced across the block's rays in shared memory and across
// blocks by a second, fixed-order kernel.
//
// Per ray (one thread), from the colour cotangent dcol (train: 2(col - tgt)
// for valid rays; render backward: the given (N, 3) cotangent):
//   pass 1, s = 0..S-1: the forward (nerf_common.cuh); keeps the inclusive
//     product P_s = prod_{k<=s} c_k of every sample in shared memory, since
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
//   After each sample, a barrier, then every thread adds a fixed subset of
//   the dW/db entries over the block's rays (sum_r h_l[i][r] d_z_l[j][r])
//   into the block's shared-memory accumulator, and a barrier again.
// Pad rays (ray >= n_rays) run every loop and barrier with zero rays and a
// zero cotangent, so they add exact zeros: no thread leaves early.  With
// per-ray depths (kPerRay) they read ray 0's row, never one past n_rays.
// Every sum has a fixed order, so two launches on the same inputs give
// bit-identical gradients and loss.

#pragma once

#include "block_sum.cuh"
#include "nerf_common.cuh"

namespace nerf {
namespace {  // each kernel source gets its own copy

constexpr int kGradThreads = 64;           // rays per block
constexpr int kStride = kGradThreads + 1;  // staging row stride: rows j and
                                           // j+1 land in different banks

// Dynamic shared memory of the gradient kernel, in floats: the packed
// parameters, the dW/db accumulator, P_s per sample and ray, the staged
// layer inputs and d_z rows, and the per-ray losses.
__host__ __device__ inline size_t grad_smem_floats(int pk_floats, int G, int S,
                                                   int L, int in_dim, int W) {
  return static_cast<size_t>(pk_floats) + G + S * kGradThreads +
         static_cast<size_t>(in_dim + (L - 1) * W) * kStride +
         static_cast<size_t>((L - 1) * W + kHead) * kStride + kGradThreads;
}

// From the head's d_z, d_z of every layer below, written down this ray's
// column of the d_z staging (layer l at rows l*W).  my_act is this ray's
// column of the staged layer inputs.
template <int W>
__device__ __forceinline__ void backprop_hidden(const Layout& lay,
                                                const float (&dz_head)[kHead],
                                                const float* my_act,
                                                float* my_dz) {
  float g[W];
  const float* h = my_act + (lay.in_dim + (lay.L - 2) * W) * kStride;
  const float4* head = reinterpret_cast<const float4*>(lay.w_head);
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const float4 w = head[i];
    float dh = dz_head[0] * w.x;
    dh = fmaf(dz_head[1], w.y, dh);
    dh = fmaf(dz_head[2], w.z, dh);
    dh = fmaf(dz_head[3], w.w, dh);
    g[i] = h[i * kStride] > 0.0f ? dh : 0.0f;
    my_dz[((lay.L - 2) * W + i) * kStride] = g[i];
  }
  for (int l = lay.L - 2; l >= 1; --l) {
    const float4* wl = reinterpret_cast<const float4*>(lay.weights(l));
    const float* hl = my_act + (lay.in_dim + (l - 1) * W) * kStride;
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
      my_dz[((l - 1) * W + i) * kStride] = g[i];
    }
  }
}

// acc += this sample's dW/db over the block's rays.  Entry e = i*C + j of
// layer l goes to thread e % kGradThreads; C divides kGradThreads, so a
// thread keeps one column j and a warp reads one h row (a broadcast) and
// 32 d_z rows (distinct banks through kStride).
template <int W>
__device__ __forceinline__ void accumulate_block(const Layout& lay,
                                                 const float* act,
                                                 const float* dz, float* acc,
                                                 int tid) {
  int arow = 0;
  for (int l = 0; l < lay.L; ++l) {
    const int R = lay.rows(l), C = lay.cols(l);
    const int off = static_cast<int>(lay.weights(l) - lay.w_first);
    const float* hrows = act + arow * kStride;
    const float* zrows = dz + l * W * kStride;
    for (int e = tid; e < R * C; e += kGradThreads) {
      const int i = e / C, j = e - i * C;
      const float* hr = hrows + i * kStride;
      const float* zr = zrows + j * kStride;
      float sum = 0.0f;
#pragma unroll 16
      for (int r = 0; r < kGradThreads; ++r) sum = fmaf(hr[r], zr[r], sum);
      acc[off + e] += sum;
    }
    if (tid < C) {
      const float* zr = zrows + tid * kStride;
      float sum = 0.0f;
#pragma unroll 16
      for (int r = 0; r < kGradThreads; ++r) sum += zr[r];
      acc[off + R * C + tid] += sum;
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

  // pass 1: the forward, keeping P_s
  float P = 1.0f;
  float col[3] = {0.0f, 0.0f, 0.0f};
  for (int s = 0; s < S; ++s) {
    float p[3];
    sample_point(o, d, ts[s], p);
    float rgba[kHead];
    mlp_rgba<W, false>(p, lay, rgba, nullptr, 0);
    float alpha, c;
    sample_alpha(rgba[3], ds[s], &alpha, &c);
    const float wgt = alpha * transmittance(&P, c, s, loma);
    pbuf[s * kGradThreads + tid] = P;
#pragma unroll
    for (int k = 0; k < 3; ++k) col[k] = fmaf(wgt, sigmoidf(rgba[k]), col[k]);
  }
  float dcol[3];
  float loss = 0.0f;
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

  // pass 2: the reverse walk
  float* my_act = act + tid;
  float* my_dz = dz + tid;
  float suf = 0.0f;    // sum_{s' >= s} d_P_s' P_s'
  float carry = 0.0f;  // standard mode: d_w_{s+1} alpha_{s+1}
  for (int s = S - 1; s >= 0; --s) {
    float p[3];
    sample_point(o, d, ts[s], p);
    float raw[kHead];
    mlp_rgba<W, true>(p, lay, raw, my_act, kStride);
    float alpha, c;
    sample_alpha(raw[3], ds[s], &alpha, &c);
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
