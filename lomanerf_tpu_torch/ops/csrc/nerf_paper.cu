// The published NeRF (Mildenhall et al., ECCV 2020, arXiv 2003.08934) on
// Hopper (sm_90a), bf16 products with f32 sums: one network of the coarse
// and fine pair per call, on per-ray (N, S) depths.  nerf_paper_render
// composites the colours (and the compositing weights, for the sampler);
// nerf_paper_train also takes the sum-MSE against the targets and every
// parameter's gradient.  Between the coarse and the fine call the wrapper
// draws the fine depths from the coarse weights on the card
// (core/rays.py:sample_pdf); the JAX package has no such model, so no TPU
// kernel is replaced here.
//
// The network (models/nerf.py NeRFConfig.paper(); packed by
// ops/fused_nerf.py:pack_paper_params), eleven GEMM layers:
//   0-7   the trunk, 8 ReLU layers of 256: layer 0 reads γ(x) (63 inputs,
//         L = 10), layer 5 reads [h_5 | γ(x)] (319: NeRF's skips=[4]);
//   8     F, linear: [feature (256) | σ_raw (1)] from h_8;
//   9     the view layer, ReLU([feature | γ(d)] W + b): 283 -> 128, γ(d) of
//         the unit direction at L = 4 (27 inputs);
//   10    the rgb head, sigmoid: 128 -> 3 (stored 4 wide, column 3 zero),
//         run inside the compositing kernel as the wide chain runs its head.
//
// What bounds it on this card: the trunk's GEMMs, as in the wide chain
// (nerf_wide_chain.cuh), whose kernels this sequence runs: the layer GEMM
// and d_h on wgmma (nerf_wide_layer_gemm.cuh), dW on wgmma
// (nerf_wide_dw.cuh), the head's dW and the sums.  About 593k MACs a row
// forward; a 4096-ray step of 64 + 192 samples is ~3.7 TFLOP.
//
// The design: every activation and d_z buffer is (rows, kLd) bf16 at one
// row stride (row = ray * S + s), so that a layer's output and the encoding
// it is concatenated with share a buffer and no concatenation is copied:
//   X  h_5 in columns [0, 256), γ(x) in [256, 319), zero at 319: layer 0
//      reads X + 256 (64 columns), the skip layer reads X (320);
//   V  F's output: the feature in [0, 256), σ_raw at 256, F's zero columns
//      257-263, γ(d) in [264, 291), zeros to 296: the view layer reads 296
//      columns, its stored weight's rows 256-263 and 291-295 zero.
// Every extent a product reads or writes is a multiple of 8 columns, its
// padding zero in device memory: TMA moves 16-byte runs, and a store's
// edge inside one (F at 258 columns) overwrote the columns past it.
// The other buffers are the inputs of layers 1-4, 6-8 (H) and the view
// layer's output V2.  F runs the layer GEMM without its ReLU, and the d_h
// of the view layer onto the feature without a mask (kLinear); σ_raw's
// d_z is written into its column of F's d_z by the compositing kernel.
// The ray's rgb head, compositing, loss and adjoint run one warp per ray
// (paper_composite_kernel, after composite_kernel in nerf_wide_common.cuh),
// which also writes the weights w_s = alpha_s T_s the sampler reads.
// Rounding plan: as the wide chain's (nerf_wide_common.cuh), with σ_raw
// rounded to bf16 as F's output (ReLU at compositing) and the unit
// direction rounded once, as its encoding.  Every sum has a fixed order:
// repeat launches are bit-identical.

#include "nerf_wide_chain.cuh"

namespace wide {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kLd = 320;      // row stride of every activation and d_z buffer
constexpr int kWidth = 256;   // the trunk's width
constexpr int kView = 128;    // the view layer's width
constexpr int kPosL = 10, kDirL = 4;  // the encodings' frequencies
constexpr int kPosEnc = 3 * (1 + 2 * kPosL);  // 63
constexpr int kDirEnc = 3 * (1 + 2 * kDirL);  // 27
constexpr int kEncCol = 256;  // γ(x)'s first column in X
constexpr int kSigCol = 256;  // σ_raw's column in V
constexpr int kDirCol = 264;  // γ(d)'s first column in V
constexpr int kDirPad = 32;   // γ(d)'s columns and their zeros
constexpr int kFN = 264;      // F's outputs: the feature, σ_raw, zero columns
constexpr int kDbLd = 136;    // a ray's row of column partials: the view layer's 128, σ_raw
constexpr int kLayers = 11;
constexpr int kSkip = 5;      // the layer that reads [h_5 | γ(x)]
constexpr int kRows[kLayers] = {64, 256, 256, 256, 256, 320, 256, 256, 256, 296, 128};
constexpr int kCols[kLayers] = {256, 256, 256, 256, 256, 256, 256, 256, 264, 128, 4};
constexpr int kK[kLayers] = {kPosEnc + 1, 256, 256, 256, 256, kWidth + kPosEnc + 1, 256, 256,
                             256, kDirCol + kDirPad, kView};
constexpr int kBiasLd[kLayers] = {256, 256, 256, 256, 256, 256, 256, 256, 264, 128, 8};

// offsets of layer l's weight (bf16, in W) and bias (f32, in b) in the
// packed layout; dW and db share them
constexpr size_t w_off(int l) {
  size_t off = 0;
  for (int i = 0; i < l; ++i) off += static_cast<size_t>(kRows[i]) * kCols[i];
  return off;
}
constexpr size_t b_off(int l) {
  size_t off = 0;
  for (int i = 0; i < l; ++i) off += kBiasLd[i];
  return off;
}

// Entry f of [v | sin 2^0 v | cos 2^0 v | ... | cos 2^(nf-1) v] of a
// 3-vector: v itself, then per frequency i the sines, then the cosines, of
// 2^i v (the product exact)
__device__ __forceinline__ float encoded(const float (&v)[3], int f) {
  if (f < 3) return v[f];
  const int k = f - 3, r = k % 6;
  const float x = __fmul_rn(ldexpf(1.0f, k / 6), v[r % 3]);
  return r < 3 ? sinf(x) : cosf(x);
}

constexpr int kEncThreads = 96;  // threads a row: γ(x) and its zero, γ(d) and zeros

// Both encodings of the chunk's rows (ray row / S), one thread per value:
// thread j < 64 of a row writes γ(o + d t)'s entry j into X's column 256 + j
// (a zero at 319), thread 64 + j γ(d / |d|)'s entry j into V's column 264 +
// j (zeros past 27), rounded to bf16, so that each warp stores 64
// contiguous bytes of one row.  |d|^2 is summed x, y, z in order without
// FMA contraction.
__global__ void __launch_bounds__(256)
paper_encode_kernel(const float* __restrict__ origins, const float* __restrict__ directions,
                    const float* __restrict__ ts, bf16* __restrict__ X, bf16* __restrict__ V,
                    int rows, int S) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(rows) * kEncThreads) return;
  const int row = static_cast<int>(i / kEncThreads), j = static_cast<int>(i % kEncThreads);
  const int ray = row / S;
  float d[3], v[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) d[c] = directions[3 * ray + c];
  if (j < kEncThreads - kDirPad) {  // a warp holds one side only
    const float t = ts[row];
#pragma unroll
    for (int c = 0; c < 3; ++c) v[c] = __fadd_rn(origins[3 * ray + c], __fmul_rn(d[c], t));
    X[static_cast<size_t>(row) * kLd + kEncCol + j] =
        __float2bfloat16_rn(j < kPosEnc ? encoded(v, j) : 0.0f);
  } else {
    const int f = j - (kEncThreads - kDirPad);
    const float norm = sqrtf(__fadd_rn(__fadd_rn(__fmul_rn(d[0], d[0]), __fmul_rn(d[1], d[1])),
                                       __fmul_rn(d[2], d[2])));
#pragma unroll
    for (int c = 0; c < 3; ++c) v[c] = __fdiv_rn(d[c], norm);
    V[static_cast<size_t>(row) * kLd + kDirCol + f] =
        __float2bfloat16_rn(f < kDirEnc ? encoded(v, f) : 0.0f);
  }
}

// The rgb head, compositing and, for kMode 1 (train: cot = targets), the
// loss and its adjoint of one ray, one warp per ray; kMode 0 renders.
// As composite_kernel (nerf_wide_common.cuh: the lanes take samples, lane 0
// walks them in order and, for the adjoint, in reverse, by the same
// composite_walk and adjoint_walk), with the density
// read from V's σ_raw column (ReLU here, its mask σ_raw > 0) and the head
// reading V2 (the view layer's 128 columns).  Writes the colour (kMode 0)
// or the ray's squared error (kMode 1) to out, and w_s = alpha_s T_s to
// weights ((n, S) f32) where given.  The adjoint writes: the head's d_z
// (rows, 4) f32 (rgb, then 0); rnd(d_z) of σ_raw at dz_sig[row * kLd] and
// zeros in the 7 columns past it (F's d_z, whose feature columns the view
// layer's d_h writes); rnd(d_z) of the view layer, (rnd(d_z_head) . W_rgb^T) masked by
// V2 > 0, at dz_view (rows, kLd); and the ray's row of column partials of
// the unrounded values at db_part (n, kDbLd): the view layer's 128 columns
// summed over the samples in order, then σ_raw's.
//
// Shared memory: W_rgb (128 rows of 4, rounded), 8 floats per sample per
// warp and 128 floats per warp.
template <int kMode>
__global__ void __launch_bounds__(kCompWarps * 32)
paper_composite_kernel(const bf16* __restrict__ V2, const bf16* __restrict__ w_rgb,
                       const float* __restrict__ b_rgb, const bf16* __restrict__ V,
                       const float* __restrict__ ds, const float* __restrict__ cot,
                       float* __restrict__ out, float* __restrict__ weights,
                       float* __restrict__ dz_head, bf16* __restrict__ dz_view,
                       bf16* __restrict__ dz_sig, float* __restrict__ db_part, int n_rays,
                       int S) {
  extern __shared__ __align__(16) float smem[];
  float4* wh = reinterpret_cast<float4*>(smem);  // kView rows of 4 columns
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* base = smem + 4 * kView + warp * 8 * S;
  float* rgb0 = base;
  float* rgb1 = base + S;
  float* rgb2 = base + 2 * S;
  float* sig = base + 3 * S;  // σ_raw (bf16)
  float* alp = base + 4 * S;  // alpha, then w
  float* cc = base + 5 * S;   // c = e + 1e-10
  float* Pp = base + 6 * S;   // inclusive product P_s
  float* aux = base + 7 * S;  // the adjoint's d_sigma
  for (int j = threadIdx.x; j < kView; j += blockDim.x) {
    const bf16* w = w_rgb + static_cast<size_t>(j) * kHead;
    wh[j] = make_float4(to_f32(w[0]), to_f32(w[1]), to_f32(w[2]), to_f32(w[3]));
  }
  __syncthreads();
  const int ray = blockIdx.x * kCompWarps + warp;
  if (ray >= n_rays) return;  // no block-wide barrier follows
  const float* dr = ds + static_cast<size_t>(ray) * S;

  for (int s = lane; s < S; s += 32) {
    const size_t row = static_cast<size_t>(ray) * S + s;
    const bf16* h = V2 + row * kLd;
    float z[3] = {b_rgb[0], b_rgb[1], b_rgb[2]};
    for (int j = 0; j < kView; j += 4) {
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
    rgb0[s] = rnd<bf16>(sigmoidf(z[0]));
    rgb1[s] = rnd<bf16>(sigmoidf(z[1]));
    rgb2[s] = rnd<bf16>(sigmoidf(z[2]));
    const float raw = to_f32(V[row * kLd + kSigCol]);
    sig[s] = raw;
    const float e = expf(__fmul_rn(-fmaxf(raw, 0.0f), dr[s]));
    alp[s] = 1.0f - e;
    cc[s] = e + 1e-10f;
  }
  __syncwarp();

  float col[3] = {0.0f, 0.0f, 0.0f};
  if (lane == 0) {  // standard compositing: T_s the product of c before s
    composite_walk(rgb0, rgb1, rgb2, alp, cc, Pp, S, 0,
                   weights != nullptr ? weights + static_cast<size_t>(ray) * S : nullptr, col);
  }
  if (kMode == 0) {
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < 3; ++k) out[3 * ray + k] = col[k];
    }
    return;
  }
  float dcol[3];
  const float loss = colour_adjoint<1>(col, cot + 3 * ray, dcol);
  float sig_sum = 0.0f;  // lane 0: σ_raw's column partial of the ray
  if (lane == 0) {
    out[ray] = loss;
    adjoint_walk(dcol, rgb0, rgb1, rgb2, alp, cc, Pp, dr, aux, S, 0);
    for (int s = 0; s < S; ++s) {  // σ_raw's ReLU mask
      aux[s] = sig[s] > 0.0f ? aux[s] : 0.0f;
      sig_sum += aux[s];
    }
  }
  __syncwarp();

  for (int s = lane; s < S; s += 32) {
    const size_t row = static_cast<size_t>(ray) * S + s;
    const float w = alp[s];
    const float r[3] = {rgb0[s], rgb1[s], rgb2[s]};
    float dz[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) dz[k] = dcol[k] * w * r[k] * (1.0f - r[k]);
    *reinterpret_cast<float4*>(dz_head + row * kHead) = make_float4(dz[0], dz[1], dz[2], 0.0f);
    for (int k = 0; k < kFN - kSigCol; ++k) {
      dz_sig[row * kLd + k] = __float2bfloat16_rn(k == 0 ? aux[s] : 0.0f);
    }
    // the rounded d_z for the product below, in this sample's slots (read
    // above for the last time)
    rgb0[s] = rnd<bf16>(dz[0]);
    rgb1[s] = rnd<bf16>(dz[1]);
    rgb2[s] = rnd<bf16>(dz[2]);
  }
  __syncwarp();

  // the samples in turn, the view layer's columns across the lanes
  float* sums = smem + 4 * kView + kCompWarps * 8 * S + warp * kView;
  for (int j = lane; j < kView; j += 32) sums[j] = 0.0f;
  for (int s = 0; s < S; ++s) {
    const size_t row = static_cast<size_t>(ray) * S + s;
    const float dzc[3] = {rgb0[s], rgb1[s], rgb2[s]};
    const bf16* h = V2 + row * kLd;
    bf16* gc = dz_view + row * kLd;
    for (int j = lane; j < kView; j += 32) {
      const float4 wq = wh[j];
      float dh = dzc[0] * wq.x;
      dh = fmaf(dzc[1], wq.y, dh);
      dh = fmaf(dzc[2], wq.z, dh);
      const float o = to_f32(h[j]) > 0.0f ? dh : 0.0f;
      gc[j] = __float2bfloat16_rn(o);
      sums[j] += o;
    }
  }
  float* dbp = db_part + static_cast<size_t>(ray) * kDbLd;
  for (int j = lane; j < kView; j += 32) dbp[j] = sums[j];
  if (lane == 0) dbp[kView] = sig_sum;
}

template <int kMode>
cudaError_t paper_composite(const bf16* V2, const bf16* W, const float* b, const bf16* V,
                            const float* ds, const float* cot, float* out, float* weights,
                            float* dz_head, bf16* dz_view, bf16* dz_sig, float* db_part,
                            int n, int S, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (4 * kView + static_cast<size_t>(kCompWarps) * 8 * S +
                                       kCompWarps * kView);
  if (smem > 48 * 1024) {  // above 227 KB this refuses with an error
    WIDE_TRY(cudaFuncSetAttribute(paper_composite_kernel<kMode>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(smem)));
  }
  paper_composite_kernel<kMode><<<(n + kCompWarps - 1) / kCompWarps, kCompWarps * 32, smem,
                                  stream>>>(
      V2, W + w_off(10), b + b_off(10), V, ds, cot, out, weights, dz_head, dz_view, dz_sig,
      db_part, n, S);
  return cudaGetLastError();
}

// The buffers of one ray chunk's forward: X, V, V2 and the inputs of layers
// 1-4 and 6-8 (in[l], l the layer); out(l) is where layer l writes.
struct Acts {
  bf16 *X, *V, *V2;
  bf16* in[kLayers];
  bf16* out(int l) const { return l == kSkip - 1 ? X : in[l + 1]; }
};

// slot pointers: train keeps every layer's input (ten slots), render
// alternates the trunk's between two (five slots)
Acts acts_of(bf16* base, size_t chunk_rows, bool keep) {
  auto slot = [&](int i) { return base + static_cast<size_t>(i) * chunk_rows * kLd; };
  Acts a;
  a.X = slot(0);
  a.V = slot(1);
  a.V2 = slot(2);
  a.in[0] = a.X + kEncCol;
  a.in[kSkip] = a.X;
  int next = 3;
  for (int l = 1; l <= 8; ++l) {
    if (l == kSkip) continue;
    a.in[l] = keep ? slot(next++) : slot(3 + (l & 1));
  }
  a.in[9] = a.V;
  a.in[10] = a.V2;
  return a;
}

// The encodings and the ten GEMM layers of n rays (rows = n S) into a.
cudaError_t paper_forward(const bf16* W, const float* b, const float* ts,
                          const float* origins, const float* directions, const Acts& a,
                          int n, int S, cudaStream_t stream) {
  const int rows = n * S;
  const long long threads = static_cast<long long>(rows) * kEncThreads;
  paper_encode_kernel<<<static_cast<int>((threads + 255) / 256), 256, 0, stream>>>(
      origins, directions, ts, a.X, a.V, rows, S);
  WIDE_TRY(cudaGetLastError());
  for (int l = 0; l < 8; ++l) {
    WIDE_TRY(layer_gemm<kEpiBiasRelu>(a.in[l], kLd, W + w_off(l), kCols[l], rows, kWidth,
                                      kK[l], b + b_off(l), nullptr, a.out(l), kLd, nullptr,
                                      stream, nullptr));
  }
  WIDE_TRY((layer_gemm<kEpiBiasRelu, true>(a.in[8], kLd, W + w_off(8), kCols[8], rows, kFN,
                                           kK[8], b + b_off(8), nullptr, a.V, kLd, nullptr,
                                           stream, nullptr)));
  return layer_gemm<kEpiBiasRelu>(a.V, kLd, W + w_off(9), kCols[9], rows, kView, kK[9],
                                  b + b_off(9), nullptr, a.V2, kLd, nullptr, stream, nullptr);
}

// dW_l += in_l^T rnd(d_z) (M columns of in_l, N of d_z) over the partials
cudaError_t paper_dw(const bf16* H, const bf16* dz, int M, int N, int rows, float* partials,
                     float* dW_l, int ldo, cudaStream_t stream) {
  WIDE_TRY(dw_gemm(H, dz, kLd, M, N, rows, partials, stream));
  return sum_partials(partials, (rows + kRowChunk - 1) / kRowChunk, M, N, dW_l, ldo, stream);
}

}  // namespace
}  // namespace wide

using namespace wide;

// Forward of n_rays rays at per-ray (N, S) depths ts / steps ds: colours
// (N, 3) f32 to out and, where weights is not null, the compositing weights
// (N, S) f32.  W (the packed weights, bf16) and b (f32) as
// pack_paper_params lays them out; acts 5 * n_rays * S * kLd bf16.
extern "C" int nerf_paper_render(const void* W, const float* b, const float* ts,
                                 const float* ds, const float* origins,
                                 const float* directions, float* out, float* weights,
                                 void* acts, int n_rays, int S, void* stream) {
  if (n_rays <= 0 || S <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* w = static_cast<const bf16*>(W);
  const Acts a = acts_of(static_cast<bf16*>(acts), static_cast<size_t>(n_rays) * S, false);
  cudaError_t err = paper_forward(w, b, ts, origins, directions, a, n_rays, S, st);
  if (err == cudaSuccess) {
    err = paper_composite<0>(a.V2, w, b, a.V, ds, nullptr, out, weights, nullptr, nullptr,
                             nullptr, nullptr, n_rays, S, st);
  }
  return static_cast<int>(err);
}

// The train call: the sum-MSE of n_rays rays against the (N, 3) targets to
// loss (one float), dW and db (the packed layout, f32) and, where weights
// is not null, the compositing weights (N, S), over ray chunks of
// chunk_rays.  Scratch: acts 10 * chunk_rays * S * kLd bf16, dz 2 *
// chunk_rays * S * kLd bf16, dz_head chunk_rays * S * 4 f32, db_part
// chunk_rays * kDbLd f32, tile_part ceil(chunk_rays * S / 128) * 256 f32,
// partials n_parts f32 (at least ceil(chunk_rays * S / 8192) * 319 * 256),
// ray_loss n_rays f32.
extern "C" int nerf_paper_train(const void* W, const float* b, const float* ts,
                                const float* ds, const float* origins,
                                const float* directions, const float* target,
                                float* weights, void* acts, void* dz, float* dz_head,
                                float* db_part, float* tile_part, float* partials,
                                long long n_parts, float* ray_loss, float* dW, float* db,
                                float* loss, int n_rays, int chunk_rays, int S, void* stream) {
  const size_t chunk_rows = static_cast<size_t>(chunk_rays) * S;
  if (n_rays <= 0 || S <= 0 || chunk_rays <= 0 ||
      n_parts < static_cast<long long>((chunk_rows + kRowChunk - 1) / kRowChunk) *
                    kK[kSkip] * kWidth) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* w = static_cast<const bf16*>(W);
  const Acts a = acts_of(static_cast<bf16*>(acts), chunk_rows, true);
  bf16* dza = static_cast<bf16*>(dz);
  bf16* dzb = dza + chunk_rows * kLd;
  const int tile_group = kRowChunk / kLgBM;
  WIDE_TRY(cudaMemsetAsync(dW, 0, sizeof(float) * w_off(kLayers), st));
  WIDE_TRY(cudaMemsetAsync(db, 0, sizeof(float) * b_off(kLayers), st));
  for (int r0 = 0; r0 < n_rays; r0 += chunk_rays) {
    const int n = std::min(chunk_rays, n_rays - r0);
    const int rows = n * S, tiles = (rows + kLgBM - 1) / kLgBM;
    const int ray_group = std::max(1, kRowChunk / S);
    const size_t at = static_cast<size_t>(r0) * S;
    WIDE_TRY(paper_forward(w, b, ts + at, origins + 3 * r0, directions + 3 * r0, a, n, S,
                               st));
    // the head, compositing, the loss and its adjoint: d_z of the head,
    // of σ_raw (F's column 256, in dzb) and of the view layer (dza)
    WIDE_TRY(paper_composite<1>(a.V2, w, b, a.V, ds + at, target + 3 * r0, ray_loss + r0,
                                    weights != nullptr ? weights + at : nullptr, dz_head, dza,
                                    dzb + kSigCol, db_part, n, S, st));
    // the rgb head: dW from the f32 d_z on gemm_mma_kernel, as the wide
    // chain's head
    WIDE_TRY((gemm<bf16, float, bf16, true, false, kEpiPartial>(
        a.V2, kLd, dz_head, kHead, kView, kHead, rows, kRowChunk, nullptr, nullptr, partials,
        kHead, st)));
    WIDE_TRY(sum_partials(partials, (rows + kRowChunk - 1) / kRowChunk, kView, kHead,
                              dW + w_off(10), kHead, st));
    WIDE_TRY(column_sums(dz_head, kHead, rows, kHead, kRowChunk, partials, db + b_off(10),
                             st));
    // the view layer; its d_h onto the feature (no mask: F is linear)
    WIDE_TRY(paper_dw(a.V, dza, kK[9], kView, rows, partials, dW + w_off(9), kCols[9], st));
    WIDE_TRY(column_sums(db_part, kDbLd, n, kView, ray_group, partials, db + b_off(9), st));
    WIDE_TRY((layer_gemm<kEpiMask, true>(dza, kLd, w + w_off(9), kCols[9], rows, kWidth,
                                             kView, nullptr, nullptr, nullptr, kLd, dzb, st,
                                             tile_part)));
    // F, then its d_h onto h_8
    WIDE_TRY(paper_dw(a.in[8], dzb, kWidth, kFN, rows, partials, dW + w_off(8), kCols[8],
                          st));
    WIDE_TRY(column_sums(tile_part, kWidth, tiles, kWidth, tile_group, partials,
                             db + b_off(8), st));
    WIDE_TRY(column_sums(db_part + kView, kDbLd, n, 1, ray_group, partials,
                             db + b_off(8) + kSigCol, st));
    WIDE_TRY(layer_gemm<kEpiMask>(dzb, kLd, w + w_off(8), kCols[8], rows, kWidth, kFN,
                                      nullptr, a.in[8], nullptr, kLd, dza, st, tile_part));
    // the trunk, layer 7 down to 0: d_z of layer l's output in cur, its
    // column partials in tile_part
    bf16 *cur = dza, *nxt = dzb;
    for (int l = 7; l >= 0; --l) {
      WIDE_TRY(paper_dw(a.in[l], cur, kK[l], kWidth, rows, partials, dW + w_off(l),
                            kCols[l], st));
      WIDE_TRY(column_sums(tile_part, kWidth, tiles, kWidth, tile_group, partials,
                               db + b_off(l), st));
      if (l >= 1) {  // d_h onto h_l (the skip layer: its first 256 rows, h_5's)
        WIDE_TRY(layer_gemm<kEpiMask>(cur, kLd, w + w_off(l), kCols[l], rows, kWidth,
                                          kWidth, nullptr, a.in[l], nullptr, kLd, nxt, st,
                                          tile_part));
        std::swap(cur, nxt);
      }
    }
  }
  loss_sum_kernel<<<1, 256, 0, st>>>(ray_loss, n_rays, loss);
  return static_cast<int>(cudaGetLastError());
}
