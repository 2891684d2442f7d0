// The launch sequences of the wide NeRF kernels, on one stream, over ray
// chunks: the render forward, the forward layers (encoding, then one GEMM +
// bias + ReLU per hidden layer) and the gradient sequence shared by the
// train step (nerf_wide_train.cu) and the render backward
// (nerf_wide_render_bwd.cu), with the body of their entry points
// (grad_entry).
//
// Render forward per ray chunk: for bf16 at pw 128 or 256 with a hidden
// layer, the fused MLP (nerf_wide_mlp.cuh: the encoding and every hidden
// layer of a 128-row tile in one persistent wgmma/TMA kernel, only H_{L-1}
// written), then composite_kernel (the head, compositing, the colour sum).
// For f32, for bf16 past pw 256 (two 128-row activation buffers of a wider
// tile alone would exceed a block's shared memory) or with no hidden layer,
// and for the chain the fused MLP replaced (nerf_wide_render_fwd_layers, kept
// as the reference of the card's check of the fused MLP), the forward layers on two ping-pong buffers, then
// composite_kernel.  For bf16 the forward layers and the d_h GEMMs run on
// wgmma fed by TMA (nerf_wide_layer_gemm.cuh, through gemm()).
//
// A one-layer MLP (L = 1) is the encoding and the head: the head reads the
// first kc columns of the encoded slot, and the gradient sequence ends with
// the head's dW.
//
// Gradient sequence per ray chunk (rows = chunk rays * S):
//   1. the forward layers, saving every layer's input H_0..H_{L-1} in CDT
//      (bf16: layer_gemm, wgmma/TMA);
//   2. composite_kernel: the head, compositing, the loss (train) and its
//      adjoint, writing the head's d_z (rows, 4) and d_z of layer L-2;
//   3. layer by layer in reverse, l = L-1 .. 0:
//        dW_l += H_l^T rnd(d_z_l)     split-K over kRowChunk rows, partials
//                                     added in a fixed order; for bf16 the
//                                     hidden layers' on wgmma/TMA
//                                     (nerf_wide_dw.cuh) from the bf16 copy
//                                     of d_z its producers write
//        db_l += colsum(d_z_l)        the unrounded d_z summed in a fixed
//                                     order: f32 over the f32 d_z in
//                                     kRowChunk rows, then those partials;
//                                     bf16 over the column partials its
//                                     producers write instead of an f32 d_z
//                                     (a row per ray from composite_kernel,
//                                     per 128-row tile from layer_gemm), in
//                                     groups of kRowChunk rows of d_z, then
//                                     those partials
//        d_z_{l-1} = (rnd(d_z_l) W_l^T) masked by H_l > 0   (l >= 1; for
//                                     bf16 on layer_gemm from the copy,
//                                     writing the next copy and its column
//                                     partials)
// dW/db are zeroed once, then every chunk adds to them in chunk order, so
// that chunks of kRowChunk rows give one call's bits (db's groups too); the
// loss is the fixed-order sum of the per-ray squared errors.  Nothing is
// allocated here: the wrapper passes every buffer.

#pragma once

#include <algorithm>
#include <type_traits>
#include <utility>

#include "nerf_wide_f32_gemm.cuh"
#include "nerf_wide_layer_gemm.cuh"

namespace wide {
namespace {

#define WIDE_TRY(expr)                         \
  do {                                         \
    const cudaError_t err_ = (expr);           \
    if (err_ != cudaSuccess) return err_;      \
  } while (0)

struct Net {
  const void* W;  // (L, pw, pw) CDT
  const float* b;  // (L, pw) f32
  const float* ts;  // depths: (S,) shared, or (N, S) with per_ray
  const float* ds;  // steps, as ts
  int S, L, pw, kc, nf, loma;
  bool per_ray;

  // the net as a chunk starting at ray r0 sees it: per-ray depths offset
  Net from_ray(int r0) const {
    Net net = *this;
    if (per_ray) {
      net.ts += static_cast<size_t>(r0) * S;
      net.ds += static_cast<size_t>(r0) * S;
    }
    return net;
  }
};

// The encoding and the hidden layers of rays [0, n) of this chunk.  Slot l
// of `acts` (chunk_rows x pw CDT each) receives H_l; with pingpong the
// slots alternate between two buffers (nothing is saved).  Returns
// H_{L-1}'s slot.
template <typename CDT>
cudaError_t forward_layers(const Net& net, const float* origins,
                           const float* directions, int n, CDT* acts,
                           size_t chunk_rows, bool pingpong, CDT** last,
                           cudaStream_t stream) {
  const int rows = n * net.S, pw = net.pw;
  const CDT* W = static_cast<const CDT*>(net.W);
  auto slot = [&](int l) {
    return acts + static_cast<size_t>(pingpong ? (l & 1) : l) * chunk_rows * pw;
  };
  const int blocks = (rows + 255) / 256;
  if (net.per_ray) {
    encode_kernel<CDT, true><<<blocks, 256, 0, stream>>>(
        origins, directions, net.ts, slot(0), rows, net.S, pw, net.kc, net.nf);
  } else {
    encode_kernel<CDT, false><<<blocks, 256, 0, stream>>>(
        origins, directions, net.ts, slot(0), rows, net.S, pw, net.kc, net.nf);
  }
  WIDE_TRY(cudaGetLastError());
  for (int l = 0; l < net.L - 1; ++l) {
    WIDE_TRY((gemm<CDT, CDT, CDT, false, false, kEpiBiasRelu>(
        slot(l), pw, W + static_cast<size_t>(l) * pw * pw, pw, rows, pw,
        l == 0 ? net.kc : pw, l == 0 ? net.kc : pw, net.b + l * pw, nullptr,
        slot(l + 1), pw, stream)));
  }
  *last = slot(net.L - 1);
  return cudaSuccess;
}

// columns of the head's input: H_{L-1} after a hidden layer, else the
// encoding
inline int head_cols(const Net& net) { return net.L == 1 ? net.kc : net.pw; }

// the fused bf16 MLP takes pw 128 and 256 and at least one hidden layer
constexpr int kFusedMaxPW = 256;
inline bool fused_mlp_takes(const Net& net) {
  return net.L >= 2 && net.pw <= kFusedMaxPW;
}

template <typename CDT, int kMode, bool kPerRay>
cudaError_t composite_as(const Net& net, const CDT* H, const float* cot,
                         float* out, float* dz_head, float* dz_prev,
                         CDT* dzc_prev, float* db_part, int n, cudaStream_t stream) {
  const int L = net.L, pw = net.pw;
  const size_t smem = sizeof(float) * (4 * static_cast<size_t>(pw) +
                                       static_cast<size_t>(kCompWarps) * 8 * net.S +
                                       (db_part != nullptr ? kCompWarps * pw : 0));
  if (smem > 48 * 1024) {  // above 227 KB this refuses with an error
    WIDE_TRY(cudaFuncSetAttribute(composite_kernel<CDT, kMode, kPerRay>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(smem)));
  }
  composite_kernel<CDT, kMode, kPerRay><<<(n + kCompWarps - 1) / kCompWarps,
                                          kCompWarps * 32, smem, stream>>>(
      H, static_cast<const CDT*>(net.W) + static_cast<size_t>(L - 1) * pw * pw,
      net.b + (L - 1) * pw, net.ds, cot, out, dz_head, dz_prev, dzc_prev, db_part, n,
      net.S, pw, head_cols(net), net.loma);
  return cudaGetLastError();
}

template <typename CDT, int kMode>
cudaError_t composite(const Net& net, const CDT* H, const float* cot,
                      float* out, float* dz_head, float* dz_prev,
                      CDT* dzc_prev, float* db_part, int n, cudaStream_t stream) {
  return net.per_ray
             ? composite_as<CDT, kMode, true>(net, H, cot, out, dz_head,
                                              dz_prev, dzc_prev, db_part, n, stream)
             : composite_as<CDT, kMode, false>(net, H, cot, out, dz_head,
                                               dz_prev, dzc_prev, db_part, n, stream);
}

// Render forward of n rays in chunks of chunk_rays.  bf16: the fused MLP
// writes H_{L-1} into acts (one chunk-sized slot) where it takes the net
// (fused_mlp_takes), else, or with layerwise, the layer chain runs on two
// slots; f32: the forward layers on two slots.
template <typename CDT>
cudaError_t render_forward(const Net& net, const float* origins,
                           const float* directions, float* out, CDT* acts,
                           int n_rays, int chunk_rays, bool layerwise,
                           cudaStream_t stream) {
  const size_t chunk_rows = static_cast<size_t>(chunk_rays) * net.S;
  for (int r0 = 0; r0 < n_rays; r0 += chunk_rays) {
    const int n = std::min(chunk_rays, n_rays - r0);
    const Net cn = net.from_ray(r0);
    CDT* H = acts;
    if constexpr (std::is_same<CDT, __nv_bfloat16>::value) {
      if (!layerwise) {  // the caller sets layerwise where the fused MLP does not take the net
        WIDE_TRY(mlp_forward(cn.W, cn.b, cn.ts, origins + 3 * r0, directions + 3 * r0,
                             acts, n, cn.S, cn.L, cn.pw, cn.kc, cn.nf, cn.per_ray,
                             stream));
      }
    }
    if (layerwise || !std::is_same<CDT, __nv_bfloat16>::value) {
      WIDE_TRY(forward_layers<CDT>(cn, origins + 3 * r0, directions + 3 * r0, n,
                                   acts, chunk_rows, true, &H, stream));
    }
    WIDE_TRY((composite<CDT, 0>(cn, H, nullptr, out + 3 * r0, nullptr,
                                nullptr, nullptr, nullptr, n, stream)));
  }
  return cudaSuccess;
}

// Scratch the gradient sequence reads and writes (f32 unless noted):
struct GradScratch {
  void* acts;       // L slots of chunk_rows x pw, CDT
  float* dz;        // f32 only: 2 x chunk_rows x pw
  void* dzb;        // bf16 only: 2 x chunk_rows x pw bf16, d_z rounded
  float* db_part;   // bf16 only: n_db_part floats, >= db_parts_needed(...)
  size_t n_db_part;
  float* dz_head;   // chunk_rows x 4
  float* partials;  // n_parts floats, n_parts >= parts_needed(...)
  size_t n_parts;
  float* ray_loss;  // n_rays (train)
};

inline size_t parts_needed(int chunk_rays, int S, int pw) {
  const size_t rows = static_cast<size_t>(chunk_rays) * S;
  return (rows + kRowChunk - 1) / kRowChunk * static_cast<size_t>(pw) * pw;
}

// bf16: rows of d_z's column partials, a row per ray (composite_kernel) or
// per kLgBM-row tile (layer_gemm), whichever a chunk has more of
inline size_t db_parts_needed(int chunk_rays, int S, int pw) {
  const size_t tiles = (static_cast<size_t>(chunk_rays) * S + kLgBM - 1) / kLgBM;
  return std::max<size_t>(chunk_rays, tiles) * pw;
}

// kMode 1: train (cot = targets, loss = the masked sum-MSE); 2: render
// backward (cot = the colour cotangent, loss = 0).  dW (L, pw, pw) and db
// (L, pw) receive the gradients.
template <typename CDT, int kMode>
cudaError_t grad_sequence(const Net& net, const float* origins,
                          const float* directions, const float* cot,
                          const GradScratch& sc, float* dW, float* db,
                          float* loss, int n_rays, int chunk_rays,
                          cudaStream_t stream) {
  constexpr bool kBf16 = std::is_same<CDT, __nv_bfloat16>::value;
  const int L = net.L, pw = net.pw;
  if (sc.n_parts < parts_needed(chunk_rays, net.S, pw) ||
      (kBf16 ? sc.dzb == nullptr || sc.db_part == nullptr ||
                   sc.n_db_part < db_parts_needed(chunk_rays, net.S, pw)
             : sc.dz == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const CDT* W = static_cast<const CDT*>(net.W);
  const size_t chunk_rows = static_cast<size_t>(chunk_rays) * net.S;
  CDT* acts = static_cast<CDT*>(sc.acts);
  WIDE_TRY(cudaMemsetAsync(dW, 0, sizeof(float) * L * pw * pw, stream));
  WIDE_TRY(cudaMemsetAsync(db, 0, sizeof(float) * L * pw, stream));
  for (int r0 = 0; r0 < n_rays; r0 += chunk_rays) {
    const int n = std::min(chunk_rays, n_rays - r0);
    const int rows = n * net.S;
    const int n_rc = (rows + kRowChunk - 1) / kRowChunk;
    const Net cn = net.from_ray(r0);
    CDT* H;
    WIDE_TRY(forward_layers<CDT>(cn, origins + 3 * r0, directions + 3 * r0, n,
                                 acts, chunk_rows, false, &H, stream));
    auto slot = [&](int l) { return acts + static_cast<size_t>(l) * chunk_rows * pw; };
    // f32: d_z of the current layer's output; bf16: its copy, and the rows
    // of its column partials (a row per ray, then per tile)
    float* dz = kBf16 ? nullptr : sc.dz;
    float* dz_next = kBf16 ? nullptr : sc.dz + chunk_rows * pw;
    CDT* dzb = kBf16 ? static_cast<CDT*>(sc.dzb) : nullptr;
    CDT* dzb_next = kBf16 ? dzb + chunk_rows * pw : nullptr;
    int db_rows = n, db_group = std::max(1, kRowChunk / net.S);
    WIDE_TRY((composite<CDT, kMode>(cn, H, cot + 3 * r0,
                                    kMode == 1 ? sc.ray_loss + r0 : nullptr,
                                    sc.dz_head, L >= 2 ? dz : nullptr,
                                    L >= 2 ? dzb : nullptr,
                                    L >= 2 && kBf16 ? sc.db_part : nullptr, n, stream)));
    // the head: dW_{L-1} (hc x 4) and db_{L-1} from the head's d_z
    const int hc = head_cols(net);
    WIDE_TRY((gemm<CDT, float, CDT, true, false, kEpiPartial>(
        H, pw, sc.dz_head, kHead, hc, kHead, rows, kRowChunk, nullptr, nullptr,
        sc.partials, kHead, stream)));
    WIDE_TRY(sum_partials(sc.partials, n_rc, hc, kHead,
                          dW + static_cast<size_t>(L - 1) * pw * pw, pw, stream));
    WIDE_TRY(column_sums(sc.dz_head, kHead, rows, kHead, kRowChunk, sc.partials,
                         db + (L - 1) * pw, stream));
    for (int l = L - 2; l >= 0; --l) {
      const int in_cols = l == 0 ? net.kc : pw;
      if constexpr (kBf16) {
        WIDE_TRY(dw_gemm(slot(l), dzb, pw, in_cols, pw, rows, sc.partials, stream));
      } else {
        WIDE_TRY((gemm<CDT, float, CDT, true, false, kEpiPartial>(
            slot(l), pw, dz, pw, in_cols, pw, rows, kRowChunk, nullptr, nullptr,
            sc.partials, pw, stream)));
      }
      WIDE_TRY(sum_partials(sc.partials, n_rc, in_cols, pw,
                            dW + static_cast<size_t>(l) * pw * pw, pw, stream));
      if constexpr (kBf16) {  // before the next d_h overwrites the partials
        WIDE_TRY(column_sums(sc.db_part, pw, db_rows, pw, db_group, sc.partials,
                             db + l * pw, stream));
      } else {
        WIDE_TRY(column_sums(dz, pw, rows, pw, kRowChunk, sc.partials, db + l * pw, stream));
      }
      if (l >= 1) {
        const CDT* Wl = W + static_cast<size_t>(l) * pw * pw;
        if constexpr (kBf16) {  // rnd(d_z) read from its copy; the next copy written
          WIDE_TRY((gemm<CDT, CDT, CDT, false, true, kEpiMask>(
              dzb, pw, Wl, pw, rows, pw, pw, pw, nullptr, slot(l), nullptr, pw,
              stream, dzb_next, sc.db_part)));
          db_rows = (rows + kLgBM - 1) / kLgBM;
          db_group = kRowChunk / kLgBM;
        } else {
          WIDE_TRY((gemm<float, CDT, CDT, false, true, kEpiMask>(
              dz, pw, Wl, pw, rows, pw, pw, pw, nullptr, slot(l), dz_next, pw,
              stream)));
        }
        std::swap(dz, dz_next);
        std::swap(dzb, dzb_next);
      }
    }
  }
  if (kMode == 1) {
    loss_sum_kernel<<<1, 256, 0, stream>>>(sc.ray_loss, n_rays, loss);
    return cudaGetLastError();
  }
  return cudaMemsetAsync(loss, 0, sizeof(float), stream);
}

// The body of the gradient entry points (kMode as grad_sequence's): checks
// the arguments, then runs the sequence in the compute dtype; ts/ds are
// (S,) shared or, with per_ray, (N, S) row-major.
template <int kMode>
int grad_entry(bool per_ray, const void* W, const float* b, const float* ts,
               const float* ds, const float* origins, const float* directions,
               const float* cot, void* acts, float* dz, void* dzb, float* db_part,
               long long n_db_part, float* dz_head, float* partials, long long n_parts,
               float* ray_loss, float* dW, float* db, float* loss, int n_rays,
               int chunk_rays, int S, int L, int pw, int kc, int num_functions, int loma,
               int bf16, void* stream) {
  if (L < 1 || pw % 4 != 0 || kc > pw || chunk_rays <= 0 || n_db_part < 0 || n_parts < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Net net{W, b, ts, ds, S, L, pw, kc, num_functions, loma, per_ray};
  const GradScratch sc{acts,    dz,       dzb, db_part, static_cast<size_t>(n_db_part),
                       dz_head, partials, static_cast<size_t>(n_parts), ray_loss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return static_cast<int>(grad_sequence<__nv_bfloat16, kMode>(
        net, origins, directions, cot, sc, dW, db, loss, n_rays, chunk_rays,
        st));
  }
  return static_cast<int>(grad_sequence<float, kMode>(
      net, origins, directions, cot, sc, dW, db, loss, n_rays, chunk_rays, st));
}

}  // namespace
}  // namespace wide
