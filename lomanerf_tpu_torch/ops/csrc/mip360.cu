// mip-NeRF 360 (Barron et al., CVPR 2022, arXiv 2111.12077) on Hopper
// (sm_90a), bf16 products with f32 sums: the proposal network, the NeRF
// MLP, the interval resampler, the frustum -> contraction -> integrated
// positional encoding and the three losses.  The wrapper
// (ops/mip360.py) runs one train step as
//
//   resample (one bin -> 64) . encode . proposal forward      round 1
//   resample (64 -> 64)      . encode . proposal forward      round 2
//   resample (64 -> 32)      . encode . NeRF forward
//   losses (Charbonnier, distortion, two interlevel terms) and their cotangents
//   NeRF backward, proposal backward (round 2, round 1)
//
// with the per-ray intervals in s-space, s = (g(t) - g(t_n)) / (g(t_f) -
// g(t_n)), g(x) = 1/x (eq. 11).  The JAX package has no such model, so no
// TPU kernel is replaced here.
//
// The networks (models/nerf.py NeRFConfig.mipnerf360(); packed by
// ops/mip360.py):
//   proposal  4 ReLU layers of 256 on the IPE (96 inputs), a density head
//             256 -> 1 (run inside the compositing kernel); every buffer
//             (rows, kPLd = 256) bf16, the IPE in columns [0, 96)
//   NeRF      layers 0-7 the trunk, 8 ReLU layers of 1024: layer 0 reads
//             the IPE, layer 5 reads [h_5 | IPE] (1120); 8 F, linear:
//             [bottleneck (256) | sigma_raw (1) | zeros to 264]; 9 the view
//             layer, ReLU([bottleneck | gamma(d)] W + b), 283 -> 128; 10 the
//             rgb head 128 -> 3 (stored 4 wide), inside the compositing
//             kernel.  Every buffer (rows, kNLd = 1120) bf16 (nerf_paper.cu's
//             layout at width 1024): X holds h_5 in [0, 1024) and the IPE in
//             [1024, 1120); V holds F's output and gamma(d) in [264, 291).
//
// What bounds it on this card: the NeRF MLP's 1024-wide GEMMs (~9.4 M MACs
// a row forward, 524,288 rows a step) and the proposal's 256-wide ones (2 x
// 1,048,576 rows), on the wide chain's kernels: the layer GEMM and d_h
// (nerf_wide_layer_gemm.cuh, a K other than N for the skip layer's 1120
// inputs), dW (nerf_wide_dw.cuh), the heads' dW (gemm_mma_kernel) and the
// column sums.  The kernels here are memory- or latency-bound: the encode
// writes 192 B a row, the resampler searches a 65-entry CDF per endpoint.
//
// Activations as mip-NeRF defines them: density softplus(sigma_raw - 1),
// colour (1 + 2 eps) sigmoid(z) - eps with eps = 0.001.  Compositing over
// intervals (multinerf's compute_alpha_weights): x_i = density_i (t_{i+1} -
// t_i) |d|, alpha_i = 1 - exp(-x_i), T_i = exp(-sum_{k<i} x_k), w_i = alpha_i
// T_i; its adjoint from a weight cotangent g_i (the colour's folded in):
// d x_i = g_i exp(-x_i) T_i - sum_{j>i} g_j w_j, no division.
// Rounding plan: the wide chain's; the IPE and gamma(d) rounded to bf16 as
// stored, sigma_raw as F's output; the proposal's sigma_raw and the rgb
// head's outputs stay f32.  Every sum has a fixed order: repeat launches
// are bit-identical.

#include "nerf_wide_chain.cuh"

namespace wide {
namespace {

using bf16 = __nv_bfloat16;

// ---- the NeRF MLP ----
constexpr int kNLd = 1120;     // row stride of its activation and d_z buffers
constexpr int kMWidth = 1024;  // the trunk's width
constexpr int kMView = 128;    // the view layer's width
constexpr int kIpe = 96;       // IPE features: sin and cos of 3 coordinates at L = 16
constexpr int kMEncCol = 1024;  // the IPE's first column in X
constexpr int kMSigCol = 256;   // sigma_raw's column in V
constexpr int kMDirEnc = 27;    // gamma(d) at L = 4 with d itself (then zeros to 32)
constexpr int kMFN = 264;       // F's outputs: the bottleneck, sigma_raw, zeros
constexpr int kMDbLd = 136;     // a ray's row of column partials: the view layer's 128, sigma's
constexpr int kMLayers = 11;
constexpr int kMSkip = 5;
constexpr int kMRows[kMLayers] = {96, 1024, 1024, 1024, 1024, 1120, 1024, 1024, 1024, 296, 128};
constexpr int kMCols[kMLayers] = {1024, 1024, 1024, 1024, 1024, 1024, 1024, 1024, 264, 128, 4};
constexpr int kMBias[kMLayers] = {1024, 1024, 1024, 1024, 1024, 1024, 1024, 1024, 264, 128, 8};

// ---- the proposal MLP ----
constexpr int kPLd = 256;  // row stride of its buffers; the trunk's width
constexpr int kPLayers = 4;
constexpr int kPRows[kPLayers + 1] = {96, 256, 256, 256, 256};  // the head last
constexpr int kPCols[kPLayers + 1] = {256, 256, 256, 256, 4};
constexpr int kPBias[kPLayers + 1] = {256, 256, 256, 256, 8};

constexpr int kMaxBins = 128;  // intervals a ray's resampler and losses take
constexpr float kRgbPad = 0.001f;
constexpr float kCharbEps = 0.001f;
constexpr float kF32Eps = 1.1920928955078125e-07f;

template <int N>
constexpr size_t off_of(const int (&rows)[N], const int (&cols)[N], int l) {
  size_t off = 0;
  for (int i = 0; i < l; ++i) off += static_cast<size_t>(rows[i]) * cols[i];
  return off;
}
template <int N>
constexpr size_t boff_of(const int (&len)[N], int l) {
  size_t off = 0;
  for (int i = 0; i < l; ++i) off += len[i];
  return off;
}
constexpr size_t mw_off(int l) { return off_of(kMRows, kMCols, l); }
constexpr size_t mb_off(int l) { return boff_of(kMBias, l); }
constexpr size_t pw_off(int l) { return off_of(kPRows, kPCols, l); }
constexpr size_t pb_off(int l) { return boff_of(kPBias, l); }

// t of s: 1 / t = (1 - s) / t_n + s / t_f
__device__ __forceinline__ float s_to_t(float s, float inv_n, float inv_f) {
  return 1.0f / ((1.0f - s) * inv_n + s * inv_f);
}

__device__ __forceinline__ float softplusf(float x) {
  return x > 20.0f ? x : log1pf(expf(x));
}

// The mean and the covariance's diagonal of the Gaussian of the conical
// frustum of [t0, t1] along o + d t, radius `radius` at t = 1 (mip-NeRF eqs.
// 7-8, the stable form: Sigma = t_var d d^T + r_var (I - d d^T / |d|^2)),
// mapped by contract(x) = (2 - 1/|x|) x / |x| where |x| > 1 and linearised
// there (eq. 9) when `contract`.  With u = x / |x|, the Jacobian is J = a (I
// - u u^T) + u u^T / |x|^2, a = (2|x| - 1) / |x|^2, so J Sigma J^T = (t_var -
// r_var / |d|^2) (J d)(J d)^T + r_var J J^T with J d = a d + b u (u . d), b =
// 2 (1 - |x|) / |x|^2, and (J J^T)_cc = a^2 (1 - u_c^2) + u_c^2 / |x|^4: far
// out the radial and tangential factors differ by 2|x|, and the expanded
// sum of J's terms would cancel to a millionth of its parts.
__device__ __forceinline__ void frustum_gaussian(const float (&o)[3], const float (&d)[3],
                                                 float t0, float t1, float radius,
                                                 bool contract, float (&mean)[3],
                                                 float (&var)[3]) {
  const float mu = 0.5f * (t0 + t1), hw = 0.5f * (t1 - t0);
  const float mu2 = mu * mu, hw2 = hw * hw;
  const float den = 3.0f * mu2 + hw2;
  const float t_mean = mu + 2.0f * mu * hw2 / den;
  const float t_var = hw2 / 3.0f - (4.0f / 15.0f) * (hw2 * hw2 * (12.0f * mu2 - hw2)) /
                                       (den * den);
  const float r_var = radius * radius *
                      (mu2 / 4.0f + (5.0f / 12.0f) * hw2 - (4.0f / 15.0f) * (hw2 * hw2) / den);
  const float dd = fmaxf(1e-10f, d[0] * d[0] + d[1] * d[1] + d[2] * d[2]);
  float x[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) x[c] = o[c] + d[c] * t_mean;
  const float xx = x[0] * x[0] + x[1] * x[1] + x[2] * x[2];
  if (!contract || xx <= 1.0f) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      mean[c] = x[c];
      var[c] = t_var * d[c] * d[c] + r_var * (1.0f - d[c] * d[c] / dd);
    }
    return;
  }
  const float r = sqrtf(xx);
  const float a = (2.0f * r - 1.0f) / xx, b = 2.0f * (1.0f - r) / xx;
  const float u[3] = {x[0] / r, x[1] / r, x[2] / r};
  const float ud = u[0] * d[0] + u[1] * d[1] + u[2] * d[2];
  const float along = t_var - r_var / dd;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float jd = a * d[c] + b * u[c] * ud;
    const float jj = a * a * (1.0f - u[c] * u[c]) + u[c] * u[c] / (xx * xx);
    mean[c] = a * x[c];
    var[c] = along * jd * jd + r_var * jj;
  }
}

// Entry f of [d | sin 2^0 d | cos 2^0 d | ... | cos 2^3 d] of the unit
// direction (nerf_paper.cu's order)
__device__ __forceinline__ float dir_encoded(const float (&v)[3], int f) {
  if (f < 3) return v[f];
  const int k = f - 3, r = k % 6;
  const float x = __fmul_rn(ldexpf(1.0f, k / 6), v[r % 3]);
  return r < 3 ? sinf(x) : cosf(x);
}

constexpr int kEncThreads = kIpe + 32;  // threads a row: the IPE's 96, gamma(d)'s 32

// The IPE of every interval of n rays (rows = n S) into X (row stride ldx,
// from column colx): feature f = 6 l + r, l < 16, of coordinate c = r % 3,
// exp(-4^l var_c / 2) sin(2^l mean_c) for r < 3, cos for r >= 3 (the
// expected sine and cosine under the Gaussian).  Where V is given, thread
// 96 + j writes gamma(d / |d|)'s entry j into V's column colv + j (zeros past
// 27).  `contract` maps the Gaussians by the contraction; without
// `variance` the features are plain sin and cos of the means.  Rounded to
// bf16.
__global__ void __launch_bounds__(256)
mip_encode_kernel(const float* __restrict__ origins, const float* __restrict__ directions,
                  const float* __restrict__ sdist, float radius, float inv_n, float inv_f,
                  bf16* __restrict__ X, int ldx, int colx, bf16* __restrict__ V, int ldv,
                  int colv, int rows, int S, int contract, int variance) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(rows) * kEncThreads) return;
  const int row = static_cast<int>(i / kEncThreads), j = static_cast<int>(i % kEncThreads);
  const int ray = row / S, s = row - ray * S;
  float d[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) d[c] = directions[3 * ray + c];
  if (j < kIpe) {
    float o[3], mean[3], var[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) o[c] = origins[3 * ray + c];
    const float* sr = sdist + static_cast<size_t>(ray) * (S + 1);
    const float t0 = s_to_t(sr[s], inv_n, inv_f), t1 = s_to_t(sr[s + 1], inv_n, inv_f);
    frustum_gaussian(o, d, t0, t1, radius, contract != 0, mean, var);
    const int l = j / 6, r = j % 6, c = r % 3;
    const float x = ldexpf(mean[c], l);
    const float damp = variance ? expf(-0.5f * ldexpf(var[c], 2 * l)) : 1.0f;
    X[static_cast<size_t>(row) * ldx + colx + j] =
        __float2bfloat16_rn(damp * (r < 3 ? sinf(x) : cosf(x)));
  } else if (V != nullptr) {
    const int f = j - kIpe;
    const float norm = sqrtf(__fadd_rn(__fadd_rn(__fmul_rn(d[0], d[0]), __fmul_rn(d[1], d[1])),
                                       __fmul_rn(d[2], d[2])));
    float v[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) v[c] = __fdiv_rn(d[c], norm);
    V[static_cast<size_t>(row) * ldv + colv + f] =
        __float2bfloat16_rn(f < kMDirEnc ? dir_encoded(v, f) : 0.0f);
  }
}

// The resampler, one warp per ray (multinerf's stepfun.sample_intervals):
// the step histogram of the ray's n_in intervals (endpoints s_in (n_in + 1),
// weights w_in; n_in = 1 with null pointers: the one bin [0, 1]) as the CDF
// cw = [0, min(1, cumsum(w / sum w)[:-1]), 1] (uniform where sum w is not
// positive); n_out centres at u_j = u0 + j du + xi jit (xi the ray's jitter,
// 0 without xi), each the inverse of the piecewise-linear CDF, s_k + (u -
// cw_k) / (cw_{k+1} - cw_k) (s_{k+1} - s_k) for the last k with cw_k <= u;
// then the n_out + 1 endpoints: the midpoints of the centres and the outer
// two reflected, clipped to [0, 1].
__global__ void __launch_bounds__(128)
mip_resample_kernel(const float* __restrict__ s_in, const float* __restrict__ w_in, int n_in,
                    const float* __restrict__ xi, float u0, float du, float jit,
                    float* __restrict__ s_out, int n_out, int n_rays) {
  __shared__ float cw_s[4][kMaxBins + 1], sv_s[4][kMaxBins + 1], ctr_s[4][kMaxBins];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ray = blockIdx.x * 4 + warp;
  if (ray >= n_rays) return;
  float* cw = cw_s[warp];
  float* sv = sv_s[warp];
  float* ctr = ctr_s[warp];
  if (s_in == nullptr) {
    if (lane == 0) cw[0] = 0.0f, cw[1] = 1.0f, sv[0] = 0.0f, sv[1] = 1.0f;
  } else {
    const float* sr = s_in + static_cast<size_t>(ray) * (n_in + 1);
    for (int k = lane; k <= n_in; k += 32) sv[k] = sr[k];
    if (lane == 0) {
      const float* wr = w_in + static_cast<size_t>(ray) * n_in;
      float total = 0.0f;
      for (int k = 0; k < n_in; ++k) total += wr[k];
      const bool ok = total > 0.0f && isfinite(total);
      float acc = 0.0f;
      cw[0] = 0.0f;
      for (int k = 1; k < n_in; ++k) {
        acc += ok ? wr[k - 1] / total : 1.0f / n_in;
        cw[k] = fminf(1.0f, acc);
      }
      cw[n_in] = 1.0f;
    }
  }
  __syncwarp();
  const float jitter = xi != nullptr ? xi[ray] * jit : 0.0f;
  for (int j = lane; j < n_out; j += 32) {
    const float u = u0 + static_cast<float>(j) * du + jitter;
    int lo = 0, hi = n_in;  // the last k in [0, n_in) with cw[k] <= u
    while (lo + 1 < hi) {
      const int mid = (lo + hi) >> 1;
      if (cw[mid] <= u) lo = mid; else hi = mid;
    }
    const float span = cw[lo + 1] - cw[lo];
    float frac = span > 0.0f ? (u - cw[lo]) / span : 0.0f;
    frac = fminf(fmaxf(frac, 0.0f), 1.0f);
    ctr[j] = sv[lo] + frac * (sv[lo + 1] - sv[lo]);
  }
  __syncwarp();
  float* out = s_out + static_cast<size_t>(ray) * (n_out + 1);
  for (int e = lane; e <= n_out; e += 32) {
    float v;
    if (e == 0) {
      v = fmaxf(0.0f, 2.0f * ctr[0] - 0.5f * (ctr[0] + ctr[1]));
    } else if (e == n_out) {
      v = fminf(1.0f, 2.0f * ctr[n_out - 1] - 0.5f * (ctr[n_out - 2] + ctr[n_out - 1]));
    } else {
      v = 0.5f * (ctr[e - 1] + ctr[e]);
    }
    out[e] = v;
  }
}

// Lane 0's walk of a ray's intervals: from x (x_i = density_i delta_i) the
// weights w_i = (1 - exp(-x_i)) exp(-sum_{k<i} x_k) into w, T_i into tr.
__device__ __forceinline__ void interval_walk(const float* x, float* w, float* tr, int S) {
  float acc = 0.0f;
  for (int s = 0; s < S; ++s) {
    const float T = expf(-acc);
    tr[s] = T;
    w[s] = (1.0f - expf(-x[s])) * T;
    acc += x[s];
  }
}

// Lane 0's reverse walk: d x_i = g_i exp(-x_i) T_i - sum_{j>i} g_j w_j from
// the weights' cotangent g (overwritten by d x).
__device__ __forceinline__ void interval_adjoint(const float* x, const float* w,
                                                 const float* tr, float* g, int S) {
  float suf = 0.0f;
  for (int s = S - 1; s >= 0; --s) {
    const float gs = g[s];
    g[s] = gs * expf(-x[s]) * tr[s] - suf;
    suf = fmaf(gs, w[s], suf);
  }
}

// The proposal's density head and compositing, one warp per ray; kMode 0
// writes the weights (n, S), kMode 1 runs the adjoint from their cotangent
// dw (n, S): the head's d_z (rows, 4) f32 (column 0, zeros after), the top
// layer's d_z (rnd(d_z_head) w_head^T masked by H > 0) bf16 at row stride
// kPLd, and the ray's column partials of that d_z (n, kPLd) f32.
// Shared memory: w_head (256 rounded), 6 floats per sample per warp and
// kPLd floats per warp.
template <int kMode>
__global__ void __launch_bounds__(kCompWarps * 32)
mip_prop_composite_kernel(const bf16* __restrict__ H, const bf16* __restrict__ w_head,
                          const float* __restrict__ b_head, const float* __restrict__ sdist,
                          const float* __restrict__ directions, float inv_n, float inv_f,
                          float* __restrict__ weights, const float* __restrict__ dw,
                          float* __restrict__ dz_head, bf16* __restrict__ dz_top,
                          float* __restrict__ db_part, int n_rays, int S) {
  extern __shared__ __align__(16) float smem[];
  float* wh = smem;  // kPLd
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* base = smem + kPLd + warp * 6 * S;
  float* xs = base;           // x_s = density delta
  float* ws = base + S;       // w_s
  float* tr = base + 2 * S;   // T_s
  float* raw = base + 3 * S;  // sigma_raw
  float* dl = base + 4 * S;   // delta_s
  float* g = base + 5 * S;    // the adjoint
  for (int j = threadIdx.x; j < kPLd; j += blockDim.x) wh[j] = to_f32(w_head[j * kHead]);
  __syncthreads();
  const int ray = blockIdx.x * kCompWarps + warp;
  if (ray >= n_rays) return;
  const float* dr = directions + 3 * ray;
  const float dn = sqrtf(dr[0] * dr[0] + dr[1] * dr[1] + dr[2] * dr[2]);
  const float* sr = sdist + static_cast<size_t>(ray) * (S + 1);
  for (int s = lane; s < S; s += 32) {
    const bf16* h = H + (static_cast<size_t>(ray) * S + s) * kPLd;
    float z = b_head[0];
    for (int j = 0; j < kPLd; j += 4) {
      float v[4];
      load4(h + j, v);
#pragma unroll
      for (int q = 0; q < 4; ++q) z = fmaf(v[q], wh[j + q], z);
    }
    raw[s] = z;
    const float delta = (s_to_t(sr[s + 1], inv_n, inv_f) - s_to_t(sr[s], inv_n, inv_f)) * dn;
    dl[s] = delta;
    xs[s] = softplusf(z - 1.0f) * delta;
  }
  __syncwarp();
  if (lane == 0) interval_walk(xs, ws, tr, S);
  __syncwarp();
  if (kMode == 0) {
    for (int s = lane; s < S; s += 32) weights[static_cast<size_t>(ray) * S + s] = ws[s];
    return;
  }
  for (int s = lane; s < S; s += 32) g[s] = dw[static_cast<size_t>(ray) * S + s];
  __syncwarp();
  if (lane == 0) interval_adjoint(xs, ws, tr, g, S);
  __syncwarp();
  for (int s = lane; s < S; s += 32) {
    const size_t row = static_cast<size_t>(ray) * S + s;
    const float dz = g[s] * dl[s] * sigmoidf(raw[s] - 1.0f);
    *reinterpret_cast<float4*>(dz_head + row * kHead) = make_float4(dz, 0.0f, 0.0f, 0.0f);
    g[s] = rnd<bf16>(dz);
  }
  __syncwarp();
  float* sums = smem + kPLd + kCompWarps * 6 * S + warp * kPLd;
  for (int j = lane; j < kPLd; j += 32) sums[j] = 0.0f;
  for (int s = 0; s < S; ++s) {
    const size_t row = static_cast<size_t>(ray) * S + s;
    const bf16* h = H + row * kPLd;
    bf16* gc = dz_top + row * kPLd;
    const float dzs = g[s];
    for (int j = lane; j < kPLd; j += 32) {
      const float o = to_f32(h[j]) > 0.0f ? dzs * wh[j] : 0.0f;
      gc[j] = __float2bfloat16_rn(o);
      sums[j] += o;
    }
  }
  float* dbp = db_part + static_cast<size_t>(ray) * kPLd;
  for (int j = lane; j < kPLd; j += 32) dbp[j] = sums[j];
}

// The NeRF's rgb head, compositing and, for kMode 1, the adjoint from the
// colour's cotangent dcol (n, 3) and the weights' dw (n, S); one warp per
// ray (nerf_paper.cu's paper_composite_kernel with mip-NeRF's activations
// and intervals).  kMode 0 writes the colours (n, 3) and the weights (n, S).
// kMode 1 writes the head's d_z (rows, 4) f32, rnd(d_z) of sigma_raw at
// dz_sig[row * kNLd] and zeros in the 7 columns past it, the view layer's
// rnd(d_z) ((rnd(d_z_head) . W_rgb^T) masked by V2 > 0) at dz_view (rows,
// kNLd), and the ray's column partials (n, kMDbLd): the view layer's 128,
// then sigma_raw's.  Shared memory: W_rgb (128 rows of 4, rounded), 9
// floats per sample per warp and 128 floats per warp.
template <int kMode>
__global__ void __launch_bounds__(kCompWarps * 32)
mip_composite_kernel(const bf16* __restrict__ V2, const bf16* __restrict__ w_rgb,
                     const float* __restrict__ b_rgb, const bf16* __restrict__ V,
                     const float* __restrict__ sdist, const float* __restrict__ directions,
                     float inv_n, float inv_f, float* __restrict__ out,
                     float* __restrict__ weights, const float* __restrict__ dcol_in,
                     const float* __restrict__ dw, float* __restrict__ dz_head,
                     bf16* __restrict__ dz_view, bf16* __restrict__ dz_sig,
                     float* __restrict__ db_part, int n_rays, int S) {
  extern __shared__ __align__(16) float smem[];
  float4* wh = reinterpret_cast<float4*>(smem);  // kMView rows of 4 columns
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* base = smem + 4 * kMView + warp * 9 * S;
  float* sg0 = base;          // sigmoid of the rgb head's outputs
  float* sg1 = base + S;
  float* sg2 = base + 2 * S;
  float* xs = base + 3 * S;   // x_s
  float* ws = base + 4 * S;   // w_s
  float* tr = base + 5 * S;   // T_s
  float* raw = base + 6 * S;  // sigma_raw (bf16)
  float* dl = base + 7 * S;   // delta_s
  float* g = base + 8 * S;    // the adjoint
  for (int j = threadIdx.x; j < kMView; j += blockDim.x) {
    const bf16* w = w_rgb + static_cast<size_t>(j) * kHead;
    wh[j] = make_float4(to_f32(w[0]), to_f32(w[1]), to_f32(w[2]), to_f32(w[3]));
  }
  __syncthreads();
  const int ray = blockIdx.x * kCompWarps + warp;
  if (ray >= n_rays) return;
  const float* dr = directions + 3 * ray;
  const float dn = sqrtf(dr[0] * dr[0] + dr[1] * dr[1] + dr[2] * dr[2]);
  const float* sr = sdist + static_cast<size_t>(ray) * (S + 1);
  for (int s = lane; s < S; s += 32) {
    const size_t row = static_cast<size_t>(ray) * S + s;
    const bf16* h = V2 + row * kNLd;
    float z[3] = {b_rgb[0], b_rgb[1], b_rgb[2]};
    for (int j = 0; j < kMView; j += 4) {
      float v[4];
      load4(h + j, v);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 w = wh[j + q];
        z[0] = fmaf(v[q], w.x, z[0]);
        z[1] = fmaf(v[q], w.y, z[1]);
        z[2] = fmaf(v[q], w.z, z[2]);
      }
    }
    sg0[s] = sigmoidf(z[0]);
    sg1[s] = sigmoidf(z[1]);
    sg2[s] = sigmoidf(z[2]);
    const float r = to_f32(V[row * kNLd + kMSigCol]);
    raw[s] = r;
    const float delta = (s_to_t(sr[s + 1], inv_n, inv_f) - s_to_t(sr[s], inv_n, inv_f)) * dn;
    dl[s] = delta;
    xs[s] = softplusf(r - 1.0f) * delta;
  }
  __syncwarp();
  constexpr float kScale = 1.0f + 2.0f * kRgbPad;
  if (lane == 0) interval_walk(xs, ws, tr, S);
  __syncwarp();
  if (kMode == 0) {
    if (lane == 0) {
      float col[3] = {0.0f, 0.0f, 0.0f};
      for (int s = 0; s < S; ++s) {
        col[0] = fmaf(ws[s], kScale * sg0[s] - kRgbPad, col[0]);
        col[1] = fmaf(ws[s], kScale * sg1[s] - kRgbPad, col[1]);
        col[2] = fmaf(ws[s], kScale * sg2[s] - kRgbPad, col[2]);
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) out[3 * ray + k] = col[k];
    }
    if (weights != nullptr) {
      for (int s = lane; s < S; s += 32) weights[static_cast<size_t>(ray) * S + s] = ws[s];
    }
    return;
  }
  const float dcol[3] = {dcol_in[3 * ray], dcol_in[3 * ray + 1], dcol_in[3 * ray + 2]};
  for (int s = lane; s < S; s += 32) {
    float gs = dw[static_cast<size_t>(ray) * S + s];
    gs = fmaf(dcol[0], kScale * sg0[s] - kRgbPad, gs);
    gs = fmaf(dcol[1], kScale * sg1[s] - kRgbPad, gs);
    gs = fmaf(dcol[2], kScale * sg2[s] - kRgbPad, gs);
    g[s] = gs;
  }
  __syncwarp();
  if (lane == 0) interval_adjoint(xs, ws, tr, g, S);
  __syncwarp();
  float sig_sum = 0.0f;  // lane 0: sigma_raw's column partial of the ray
  for (int s = lane; s < S; s += 32) {
    const size_t row = static_cast<size_t>(ray) * S + s;
    const float dsig = g[s] * dl[s] * sigmoidf(raw[s] - 1.0f);
    g[s] = dsig;
    const float sgv[3] = {sg0[s], sg1[s], sg2[s]};
    float dz[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) dz[k] = dcol[k] * ws[s] * kScale * sgv[k] * (1.0f - sgv[k]);
    *reinterpret_cast<float4*>(dz_head + row * kHead) = make_float4(dz[0], dz[1], dz[2], 0.0f);
    for (int k = 0; k < kMFN - kMSigCol; ++k) {
      dz_sig[row * kNLd + k] = __float2bfloat16_rn(k == 0 ? dsig : 0.0f);
    }
    sg0[s] = rnd<bf16>(dz[0]);  // the rounded d_z for the product below
    sg1[s] = rnd<bf16>(dz[1]);
    sg2[s] = rnd<bf16>(dz[2]);
  }
  __syncwarp();
  if (lane == 0) {
    for (int s = 0; s < S; ++s) sig_sum += g[s];
  }
  float* sums = smem + 4 * kMView + kCompWarps * 9 * S + warp * kMView;
  for (int j = lane; j < kMView; j += 32) sums[j] = 0.0f;
  for (int s = 0; s < S; ++s) {
    const size_t row = static_cast<size_t>(ray) * S + s;
    const float dzc[3] = {sg0[s], sg1[s], sg2[s]};
    const bf16* h = V2 + row * kNLd;
    bf16* gc = dz_view + row * kNLd;
    for (int j = lane; j < kMView; j += 32) {
      const float4 wq = wh[j];
      float dh = dzc[0] * wq.x;
      dh = fmaf(dzc[1], wq.y, dh);
      dh = fmaf(dzc[2], wq.z, dh);
      const float o = to_f32(h[j]) > 0.0f ? dh : 0.0f;
      gc[j] = __float2bfloat16_rn(o);
      sums[j] += o;
    }
  }
  float* dbp = db_part + static_cast<size_t>(ray) * kMDbLd;
  for (int j = lane; j < kMView; j += 32) dbp[j] = sums[j];
  if (lane == 0) dbp[kMView] = sig_sum;
}

// idx_lo: the last i in [0, n] with a[i] <= v (0 if none); idx_hi: the
// first i with a[i] > v (n if none) (multinerf's stepfun.searchsorted over
// n + 1 endpoints)
__device__ __forceinline__ int idx_lo(const float* a, int n, float v) {
  int k = 0;
  for (int i = 0; i <= n; ++i) k = a[i] <= v ? i : k;
  return k;
}
__device__ __forceinline__ int idx_hi(const float* a, int n, float v) {
  for (int i = 0; i <= n; ++i) {
    if (a[i] > v) return i;
  }
  return n;
}

// One interlevel term of a ray (eqs. 13-14; multinerf's lossfun_outer): the
// NeRF's intervals (t (S + 1), w (S)) against the proposal's (te (Se + 1),
// we (Se)): sum_j max(0, w_j - bound_j)^2 / (w_j + eps), bound_j the
// proposal weight on the intervals that overlap j; d/d we (scaled by c) into
// dwe.  Returns the term.
__device__ float interlevel(const float* t, const float* w, int S, const float* te,
                            const float* we, int Se, float c, float* dwe) {
  float cy[kMaxBins + 1], diff[kMaxBins + 1];
  cy[0] = 0.0f;
  for (int i = 0; i < Se; ++i) cy[i + 1] = cy[i] + we[i], diff[i] = 0.0f;
  diff[Se] = 0.0f;
  float loss = 0.0f;
  for (int j = 0; j < S; ++j) {
    const int lo = idx_lo(te, Se, t[j]), hi = idx_hi(te, Se, t[j + 1]);
    const float bound = cy[hi] - cy[lo];
    const float gap = fmaxf(0.0f, w[j] - bound);
    const float den = w[j] + kF32Eps;
    loss += gap * gap / den;
    const float q = -2.0f * gap / den;
    diff[lo] += q;
    diff[hi] -= q;
  }
  float run = 0.0f;
  for (int i = 0; i < Se; ++i) {
    run += diff[i];
    dwe[i] = c * run;
  }
  return loss;
}

// The three losses of n rays and their cotangents, one thread per ray:
// Charbonnier sum_c sqrt((C - C*)^2 + eps^2) (times c_data), the
// distortion of the NeRF's (s, w) (eq. 15 in O(S) by prefix sums, times
// c_dist) and one interlevel term per proposal round (times c_inter).  Each
// ray's four terms go to terms (4, n); dcol (n, 3), dw (n, S), dw1 and dw2
// (n, Sp) their cotangents.
__global__ void __launch_bounds__(128)
mip_loss_kernel(const float* __restrict__ col, const float* __restrict__ tgt,
                const float* __restrict__ s3, const float* __restrict__ w3, int S,
                const float* __restrict__ s1, const float* __restrict__ w1,
                const float* __restrict__ s2, const float* __restrict__ w2, int Sp,
                float c_data, float c_dist, float c_inter, float* __restrict__ terms,
                float* __restrict__ dcol, float* __restrict__ dw, float* __restrict__ dw1,
                float* __restrict__ dw2, int n_rays) {
  const int ray = blockIdx.x * blockDim.x + threadIdx.x;
  if (ray >= n_rays) return;
  float data = 0.0f;
  for (int k = 0; k < 3; ++k) {
    const float diff = col[3 * ray + k] - tgt[3 * ray + k];
    const float root = sqrtf(diff * diff + kCharbEps * kCharbEps);
    data += root;
    dcol[3 * ray + k] = c_data * diff / root;
  }
  const float* t = s3 + static_cast<size_t>(ray) * (S + 1);
  const float* w = w3 + static_cast<size_t>(ray) * S;
  float* g = dw + static_cast<size_t>(ray) * S;
  float a_tot = 0.0f, b_tot = 0.0f;
  for (int i = 0; i < S; ++i) {
    a_tot += w[i];
    b_tot += w[i] * 0.5f * (t[i] + t[i + 1]);
  }
  float a = 0.0f, b = 0.0f, inter = 0.0f, intra = 0.0f;
  for (int i = 0; i < S; ++i) {  // a, b: the sums of w and w m before i
    const float m = 0.5f * (t[i] + t[i + 1]), dt = t[i + 1] - t[i], wi = w[i];
    inter += wi * (m * a - b);
    intra += wi * wi * dt;
    const float after_a = a_tot - a - wi, after_b = b_tot - b - wi * m;
    g[i] = c_dist * (2.0f * (m * a - b + after_b - m * after_a) + (2.0f / 3.0f) * wi * dt);
    a += wi;
    b += wi * m;
  }
  const float dist = 2.0f * inter + intra / 3.0f;
  const float i1 = interlevel(t, w, S, s1 + static_cast<size_t>(ray) * (Sp + 1),
                              w1 + static_cast<size_t>(ray) * Sp, Sp, c_inter,
                              dw1 + static_cast<size_t>(ray) * Sp);
  const float i2 = interlevel(t, w, S, s2 + static_cast<size_t>(ray) * (Sp + 1),
                              w2 + static_cast<size_t>(ray) * Sp, Sp, c_inter,
                              dw2 + static_cast<size_t>(ray) * Sp);
  terms[ray] = c_data * data;
  terms[n_rays + ray] = c_dist * dist;
  terms[2 * n_rays + ray] = c_inter * i1;
  terms[3 * n_rays + ray] = c_inter * i2;
}

// out[r] = the sum of row r of x (rows, n): one block a row, 256 threads
// each summing every 256th entry in order, then thread 0 in order.
__global__ void __launch_bounds__(256)
mip_rows_sum_kernel(const float* __restrict__ x, int n, float* __restrict__ out) {
  __shared__ float red[256];
  const float* xr = x + static_cast<size_t>(blockIdx.x) * n;
  float s = 0.0f;
  for (int i = threadIdx.x; i < n; i += 256) s += xr[i];
  red[threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.0f;
    for (int q = 0; q < 256; ++q) total += red[q];
    out[blockIdx.x] = total;
  }
}

template <typename K>
cudaError_t smem_attr(K kernel, size_t smem) {
  if (smem > 48 * 1024) {  // above 227 KB this refuses with an error
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem));
  }
  return cudaSuccess;
}

// dW_l += H^T rnd(d_z) over the partials (row stride ld)
cudaError_t mip_dw(const bf16* H, const bf16* dz, int ld, int M, int N, int rows,
                   float* partials, float* dW_l, int ldo, cudaStream_t stream) {
  WIDE_TRY(dw_gemm(H, dz, ld, M, N, rows, partials, stream));
  return sum_partials(partials, (rows + kRowChunk - 1) / kRowChunk, M, N, dW_l, ldo, stream);
}

// The NeRF's buffers: X, V, V2, then the inputs of layers 1-4 and 6-8
struct MipActs {
  bf16 *X, *V, *V2;
  bf16* in[kMLayers];
  bf16* out(int l) const { return l == kMSkip - 1 ? X : in[l + 1]; }
};

MipActs mip_acts(bf16* base, size_t rows) {
  auto slot = [&](int i) { return base + static_cast<size_t>(i) * rows * kNLd; };
  MipActs a;
  a.X = slot(0);
  a.V = slot(1);
  a.V2 = slot(2);
  a.in[0] = a.X + kMEncCol;
  a.in[kMSkip] = a.X;
  int next = 3;
  for (int l = 1; l <= 8; ++l) {
    if (l != kMSkip) a.in[l] = slot(next++);
  }
  a.in[9] = a.V;
  a.in[10] = a.V2;
  return a;
}

// The proposal's buffers: the IPE (slot 0), then the outputs of layers 0-3
inline bf16* prop_slot(bf16* base, size_t rows, int i) {
  return base + static_cast<size_t>(i) * rows * kPLd;
}

}  // namespace
}  // namespace wide

using namespace wide;

// The IPE of n_rays rays' S intervals (endpoints sdist (n, S + 1) in
// s-space between near and far) into X (row stride ldx, from column colx)
// and, where V is given, gamma(d) into V (row stride ldv, from column
// colv); flags: 1 contract the Gaussians, 2 damp by their variance.
extern "C" int mip_encode(const float* origins, const float* directions, const float* sdist,
                          float radius, float near, float far, void* X, int ldx, int colx,
                          void* V, int ldv, int colv, int n_rays, int S, int flags,
                          void* stream) {
  const long long threads = static_cast<long long>(n_rays) * S * kEncThreads;
  if (n_rays <= 0 || S <= 0 || threads / 256 >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  mip_encode_kernel<<<static_cast<int>((threads + 255) / 256), 256, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      origins, directions, sdist, radius, 1.0f / near, 1.0f / far, static_cast<bf16*>(X), ldx,
      colx, static_cast<bf16*>(V), ldv, colv, n_rays * S, S, flags & 1, (flags >> 1) & 1);
  return static_cast<int>(cudaGetLastError());
}

// n_out + 1 endpoints a ray (s_out (n, n_out + 1)) drawn from the step
// histogram of (s_in (n, n_in + 1), w_in (n, n_in)), or of the one bin [0,
// 1] where s_in is null (n_in 1); u_j = u0 + j du + xi[ray] jit (xi may be
// null).
extern "C" int mip_resample(const float* s_in, const float* w_in, int n_in, const float* xi,
                            float u0, float du, float jit, float* s_out, int n_out,
                            int n_rays, void* stream) {
  if (n_rays <= 0 || n_in < 1 || n_in > kMaxBins || n_out < 2 || n_out > kMaxBins ||
      (s_in == nullptr) != (n_in == 1 && w_in == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  mip_resample_kernel<<<(n_rays + 3) / 4, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      s_in, w_in, n_in, xi, u0, du, jit, s_out, n_out, n_rays);
  return static_cast<int>(cudaGetLastError());
}

// The proposal forward of n_rays rays at S intervals: acts holds 5 slots of
// (n S, 256) bf16 (the IPE in slot 0, written by mip_encode; the layers'
// outputs after it); the compositing weights (n, S) f32 to weights.
extern "C" int mip_prop_forward(const void* W, const float* b, const float* sdist,
                                const float* directions, void* acts, float* weights,
                                int n_rays, int S, float near, float far, void* stream) {
  if (n_rays <= 0 || S <= 0 || S > kMaxBins) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* w = static_cast<const bf16*>(W);
  bf16* base = static_cast<bf16*>(acts);
  const size_t rows = static_cast<size_t>(n_rays) * S;
  for (int l = 0; l < kPLayers; ++l) {
    const cudaError_t err = layer_gemm<kEpiBiasRelu>(
        prop_slot(base, rows, l), kPLd, w + pw_off(l), kPCols[l], static_cast<int>(rows),
        kPLd, kPRows[l], b + pb_off(l), nullptr, prop_slot(base, rows, l + 1), kPLd, nullptr,
        st, nullptr);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const size_t smem = sizeof(float) * (kPLd + static_cast<size_t>(kCompWarps) * 6 * S);
  cudaError_t err = smem_attr(mip_prop_composite_kernel<0>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  mip_prop_composite_kernel<0><<<(n_rays + kCompWarps - 1) / kCompWarps, kCompWarps * 32,
                                 smem, st>>>(
      prop_slot(base, rows, kPLayers), w + pw_off(kPLayers), b + pb_off(kPLayers), sdist,
      directions, 1.0f / near, 1.0f / far, weights, nullptr, nullptr, nullptr, nullptr, n_rays,
      S);
  return static_cast<int>(cudaGetLastError());
}

// The proposal backward of one round from the weights' cotangent dw (n,
// S): dW and db (the packed layout, f32) += the round's gradients.  acts as
// mip_prop_forward left them.  Scratch: dz 2 * n S * 256 bf16, dz_head n S
// * 4 f32, db_part n * 256 f32, tile_part ceil(n S / 128) * 256 f32,
// partials ceil(n S / 8192) * 256 * 256 f32.
extern "C" int mip_prop_backward(const void* W, const float* b, const float* sdist,
                                 const float* directions, void* acts, const float* dw,
                                 void* dz, float* dz_head, float* db_part, float* tile_part,
                                 float* partials, float* dW, float* db, int n_rays, int S,
                                 float near, float far, void* stream) {
  if (n_rays <= 0 || S <= 0 || S > kMaxBins) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* w = static_cast<const bf16*>(W);
  bf16* base = static_cast<bf16*>(acts);
  const size_t rows_z = static_cast<size_t>(n_rays) * S;
  const int rows = static_cast<int>(rows_z);
  bf16* cur = static_cast<bf16*>(dz);
  bf16* nxt = cur + rows_z * kPLd;
  const size_t smem = sizeof(float) * (kPLd + static_cast<size_t>(kCompWarps) * 6 * S +
                                       kCompWarps * kPLd);
  WIDE_TRY(smem_attr(mip_prop_composite_kernel<1>, smem));
  bf16* top = prop_slot(base, rows_z, kPLayers);
  mip_prop_composite_kernel<1><<<(n_rays + kCompWarps - 1) / kCompWarps, kCompWarps * 32,
                                 smem, st>>>(
      top, w + pw_off(kPLayers), b + pb_off(kPLayers), sdist, directions, 1.0f / near,
      1.0f / far, nullptr, dw, dz_head, cur, db_part, n_rays, S);
  WIDE_TRY(cudaGetLastError());
  // the density head: dW from the f32 d_z on gemm_mma_kernel, as the wide
  // chain's head; db its column sums
  WIDE_TRY((gemm<bf16, float, bf16, true, false, kEpiPartial>(
      top, kPLd, dz_head, kHead, kPLd, kHead, rows, kRowChunk, nullptr, nullptr, partials,
      kHead, st)));
  WIDE_TRY(sum_partials(partials, (rows + kRowChunk - 1) / kRowChunk, kPLd, kHead,
                        dW + pw_off(kPLayers), kHead, st));
  WIDE_TRY(column_sums(dz_head, kHead, rows, kHead, kRowChunk, partials, db + pb_off(kPLayers),
                       st));
  const int ray_group = std::max(1, kRowChunk / S);
  const int tiles = (rows + kLgBM - 1) / kLgBM, tile_group = kRowChunk / kLgBM;
  for (int l = kPLayers - 1; l >= 0; --l) {
    if (l == kPLayers - 1) {
      WIDE_TRY(column_sums(db_part, kPLd, n_rays, kPLd, ray_group, partials, db + pb_off(l),
                           st));
    } else {
      WIDE_TRY(column_sums(tile_part, kPLd, tiles, kPLd, tile_group, partials, db + pb_off(l),
                           st));
    }
    bf16* in = prop_slot(base, rows_z, l);
    WIDE_TRY(mip_dw(in, cur, kPLd, kPRows[l], kPLd, rows, partials, dW + pw_off(l), kPCols[l],
                    st));
    if (l >= 1) {
      WIDE_TRY(layer_gemm<kEpiMask>(cur, kPLd, w + pw_off(l), kPCols[l], rows, kPLd, kPLd,
                                    nullptr, in, nullptr, kPLd, nxt, st, tile_part));
      std::swap(cur, nxt);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// The NeRF forward of n_rays rays at S intervals: acts holds 10 slots of
// (n S, 1120) bf16 (mip_acts; the IPE in X's columns [1024, 1120) and
// gamma(d) in V's [264, 296), written by mip_encode); the colours (n, 3)
// to out and, where weights is not null, the weights (n, S).
extern "C" int mip_nerf_forward(const void* W, const float* b, const float* sdist,
                                const float* directions, void* acts, float* out,
                                float* weights, int n_rays, int S, float near, float far,
                                void* stream) {
  if (n_rays <= 0 || S <= 0 || S > kMaxBins) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* w = static_cast<const bf16*>(W);
  const size_t rows_z = static_cast<size_t>(n_rays) * S;
  const int rows = static_cast<int>(rows_z);
  const MipActs a = mip_acts(static_cast<bf16*>(acts), rows_z);
  for (int l = 0; l < 8; ++l) {
    WIDE_TRY(layer_gemm<kEpiBiasRelu>(a.in[l], kNLd, w + mw_off(l), kMCols[l], rows, kMWidth,
                                      kMRows[l], b + mb_off(l), nullptr, a.out(l), kNLd,
                                      nullptr, st, nullptr));
  }
  WIDE_TRY((layer_gemm<kEpiBiasRelu, true>(a.in[8], kNLd, w + mw_off(8), kMCols[8], rows, kMFN,
                                           kMRows[8], b + mb_off(8), nullptr, a.V, kNLd,
                                           nullptr, st, nullptr)));
  WIDE_TRY(layer_gemm<kEpiBiasRelu>(a.V, kNLd, w + mw_off(9), kMCols[9], rows, kMView,
                                    kMRows[9], b + mb_off(9), nullptr, a.V2, kNLd, nullptr, st,
                                    nullptr));
  const size_t smem = sizeof(float) * (4 * kMView + static_cast<size_t>(kCompWarps) * 9 * S);
  WIDE_TRY(smem_attr(mip_composite_kernel<0>, smem));
  mip_composite_kernel<0><<<(n_rays + kCompWarps - 1) / kCompWarps, kCompWarps * 32, smem,
                            st>>>(
      a.V2, w + mw_off(10), b + mb_off(10), a.V, sdist, directions, 1.0f / near, 1.0f / far,
      out, weights, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, n_rays, S);
  return static_cast<int>(cudaGetLastError());
}

// The NeRF backward from the colours' cotangent dcol (n, 3) and the
// weights' dw (n, S): dW and db (the packed layout, f32) += the gradients.
// acts as mip_nerf_forward left them.  Scratch: dz 2 * n S * 1120 bf16,
// dz_head n S * 4 f32, db_part n * 136 f32, tile_part ceil(n S / 128) *
// 1024 f32, partials ceil(n S / 8192) * 1120 * 1024 f32.
extern "C" int mip_nerf_backward(const void* W, const float* b, const float* sdist,
                                 const float* directions, void* acts, const float* dcol,
                                 const float* dw, void* dz, float* dz_head, float* db_part,
                                 float* tile_part, float* partials, float* dW, float* db,
                                 int n_rays, int S, float near, float far, void* stream) {
  if (n_rays <= 0 || S <= 0 || S > kMaxBins) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* w = static_cast<const bf16*>(W);
  const size_t rows_z = static_cast<size_t>(n_rays) * S;
  const int rows = static_cast<int>(rows_z);
  const MipActs a = mip_acts(static_cast<bf16*>(acts), rows_z);
  bf16* dza = static_cast<bf16*>(dz);
  bf16* dzb = dza + rows_z * kNLd;
  const int tiles = (rows + kLgBM - 1) / kLgBM, tile_group = kRowChunk / kLgBM;
  const int ray_group = std::max(1, kRowChunk / S);
  // the rgb head, compositing and its adjoint: d_z of the head, of
  // sigma_raw (F's column 256, in dzb) and of the view layer (dza)
  const size_t smem = sizeof(float) * (4 * kMView + static_cast<size_t>(kCompWarps) * 9 * S +
                                       kCompWarps * kMView);
  WIDE_TRY(smem_attr(mip_composite_kernel<1>, smem));
  mip_composite_kernel<1><<<(n_rays + kCompWarps - 1) / kCompWarps, kCompWarps * 32, smem,
                            st>>>(
      a.V2, w + mw_off(10), b + mb_off(10), a.V, sdist, directions, 1.0f / near, 1.0f / far,
      nullptr, nullptr, dcol, dw, dz_head, dza, dzb + kMSigCol, db_part, n_rays, S);
  WIDE_TRY(cudaGetLastError());
  WIDE_TRY((gemm<bf16, float, bf16, true, false, kEpiPartial>(
      a.V2, kNLd, dz_head, kHead, kMView, kHead, rows, kRowChunk, nullptr, nullptr, partials,
      kHead, st)));
  WIDE_TRY(sum_partials(partials, (rows + kRowChunk - 1) / kRowChunk, kMView, kHead,
                        dW + mw_off(10), kHead, st));
  WIDE_TRY(column_sums(dz_head, kHead, rows, kHead, kRowChunk, partials, db + mb_off(10), st));
  // the view layer; its d_h onto the bottleneck (no mask: F is linear)
  WIDE_TRY(mip_dw(a.V, dza, kNLd, kMRows[9], kMView, rows, partials, dW + mw_off(9),
                  kMCols[9], st));
  WIDE_TRY(column_sums(db_part, kMDbLd, n_rays, kMView, ray_group, partials, db + mb_off(9),
                       st));
  WIDE_TRY((layer_gemm<kEpiMask, true>(dza, kNLd, w + mw_off(9), kMCols[9], rows, 256, kMView,
                                       nullptr, nullptr, nullptr, kNLd, dzb, st, tile_part)));
  // F, then its d_h onto h_8
  WIDE_TRY(mip_dw(a.in[8], dzb, kNLd, kMWidth, kMFN, rows, partials, dW + mw_off(8), kMCols[8],
                  st));
  WIDE_TRY(column_sums(tile_part, 256, tiles, 256, tile_group, partials, db + mb_off(8), st));
  WIDE_TRY(column_sums(db_part + kMView, kMDbLd, n_rays, 1, ray_group, partials,
                       db + mb_off(8) + kMSigCol, st));
  WIDE_TRY(layer_gemm<kEpiMask>(dzb, kNLd, w + mw_off(8), kMCols[8], rows, kMWidth, kMFN,
                                nullptr, a.in[8], nullptr, kNLd, dza, st, tile_part));
  // the trunk, layer 7 down to 0: d_z of layer l's output in cur, its
  // column partials in tile_part
  bf16 *cur = dza, *nxt = dzb;
  for (int l = 7; l >= 0; --l) {
    WIDE_TRY(mip_dw(a.in[l], cur, kNLd, kMRows[l], kMWidth, rows, partials, dW + mw_off(l),
                    kMCols[l], st));
    WIDE_TRY(column_sums(tile_part, kMWidth, tiles, kMWidth, tile_group, partials,
                         db + mb_off(l), st));
    if (l >= 1) {  // d_h onto h_l (the skip layer: its first 1024 rows, h_5's)
      WIDE_TRY(layer_gemm<kEpiMask>(cur, kNLd, w + mw_off(l), kMCols[l], rows, kMWidth,
                                    kMWidth, nullptr, a.in[l], nullptr, kNLd, nxt, st,
                                    tile_part));
      std::swap(cur, nxt);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// The three losses of n_rays rays and their cotangents (mip_loss_kernel):
// per-ray terms (4, n) and their sums terms4 (4,): data, distortion, the
// round-1 and round-2 interlevel terms, each already scaled.
extern "C" int mip_losses(const float* col, const float* tgt, const float* s3,
                          const float* w3, int S, const float* s1, const float* w1,
                          const float* s2, const float* w2, int Sp, float c_data, float c_dist,
                          float c_inter, float* ray_terms, float* terms4, float* dcol,
                          float* dw, float* dw1, float* dw2, int n_rays, void* stream) {
  if (n_rays <= 0 || S <= 0 || S > kMaxBins || Sp <= 0 || Sp > kMaxBins) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  mip_loss_kernel<<<(n_rays + 127) / 128, 128, 0, st>>>(
      col, tgt, s3, w3, S, s1, w1, s2, w2, Sp, c_data, c_dist, c_inter, ray_terms, dcol, dw,
      dw1, dw2, n_rays);
  WIDE_TRY(cudaGetLastError());
  mip_rows_sum_kernel<<<4, 256, 0, st>>>(ray_terms, n_rays, terms4);
  return static_cast<int>(cudaGetLastError());
}
