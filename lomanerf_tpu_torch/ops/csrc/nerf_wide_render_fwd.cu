// Wide NeRF render forward for Hopper (sm_90a).
//
// Replaces the TPU kernels lomanerf_tpu/ops/fused_nerf.py:_nerf_forward_kernel_W
// (the s-major row-major Pallas render for hidden widths above 64, e.g. the
// 8x256 flagship NeRFConfig.full(), S depths shared by every ray) and,
// through nerf_wide_render_fwd_rays, _nerf_forward_kernel (the packed
// row-major one on per-ray (N, S) depths, the stratified case): per ray, the
// points o + d*t[s] (t[ray, s] per-ray), the n-octave encoding, the MLP in
// the compute dtype (f32 or bf16, f32 accumulation, activations rounded to
// it), the rgba head and front-to-back compositing (loma or standard),
// writing the (N, 3) colour.
//
// What bounds it on this card: arithmetic.  The flagship does 402,688 MACs
// per sample (33*256 + 6*256^2 + 256*4); an 800x800 frame at S = 128 is
// about 66 TFLOP (67 ms at the bf16 peak).  The TPU kernel keeps all L+1
// activations of a tile in VMEM.
//
// What the design does about it (nerf_wide_chain.cuh:render_forward), per
// ray chunk:
//   * bf16 (the flagship): one persistent kernel computes the encoding and
//     every hidden layer of each 128-row tile on the tensor cores (wgmma,
//     the weights streamed by TMA), the activations kept on the SM, and
//     writes only H_{L-1} (nerf_wide_mlp.cuh).  Past pw 256 (a tile's
//     accumulator and activations would exceed a thread's registers), and
//     in nerf_wide_render_fwd_layers for comparison, the layer chain:
//     encode_kernel, then one GEMM per hidden layer through device memory
//     (nerf_wide_layer_gemm.cuh: wgmma fed by TMA; the mma.sync GEMM of
//     nerf_wide_gemm.cuh before it, whose bits it keeps); the fused MLP and
//     the chain group each f32 sum otherwise and store the same bf16 values
//     off near ties;
//   * f32: the encoding kernel, then one tiled FMA GEMM per hidden layer
//     (nerf_wide_f32_gemm.cuh: 128x128 tiles staged by cp.async) with the bias,
//     ReLU and rounding in the epilogue, activations through device memory
//     in two ping-pong buffers of one ray chunk;
//   * then the 4-wide head, the compositing and the colour sum, one warp per
//     ray (nerf_wide_common.cuh:composite_kernel), reading H_{L-1}.

#include "nerf_wide_chain.cuh"

namespace {

int render_fwd(bool per_ray, const void* W, const float* b, const float* ts,
               const float* ds, const float* origins, const float* directions,
               float* out, void* acts, int n_rays, int chunk_rays, int S, int L,
               int pw, int kc, int num_functions, int loma, int bf16,
               bool layerwise, void* stream) {
  if (L < 1 || pw % 4 != 0 || kc > pw || chunk_rays <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const wide::Net net{W, b, ts, ds, S, L, pw, kc, num_functions, loma, per_ray};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return static_cast<int>(wide::render_forward<__nv_bfloat16>(
        net, origins, directions, out, static_cast<__nv_bfloat16*>(acts),
        n_rays, chunk_rays, layerwise || !wide::fused_mlp_takes(net), st));
  }
  return static_cast<int>(wide::render_forward<float>(
      net, origins, directions, out, static_cast<float*>(acts), n_rays,
      chunk_rays, true, st));
}

}  // namespace

// C entry points, bound with ctypes.  W: the (L, pw, pw) weight stack in the
// compute dtype (bf16 != 0: bfloat16, else f32), L >= 1, pw a multiple of
// 128; b: (L, pw) f32; acts: chunk_rays * S * pw elements of scratch in the
// compute dtype for bf16 where the fused MLP takes the net (pw 128 or 256,
// L >= 2: H_{L-1} of a chunk), twice that otherwise and for
// nerf_wide_render_fwd_layers; kc: the encoded width padded to 8 (<= pw).
// Return the first failing launch's cudaError (0 on success); do not
// synchronise.
//
// nerf_wide_render_fwd: ts, ds the (S,) f32 depths and steps every ray shares.
extern "C" int nerf_wide_render_fwd(const void* W, const float* b,
                                    const float* ts, const float* ds,
                                    const float* origins,
                                    const float* directions, float* out,
                                    void* acts, int n_rays, int chunk_rays,
                                    int S, int L, int pw, int kc,
                                    int num_functions, int loma, int bf16,
                                    void* stream) {
  return render_fwd(false, W, b, ts, ds, origins, directions, out, acts,
                    n_rays, chunk_rays, S, L, pw, kc, num_functions, loma,
                    bf16, false, stream);
}

// nerf_wide_render_fwd_rays: ts, ds per-ray (N, S) f32, row-major (the
// counterpart of _nerf_forward_kernel).
extern "C" int nerf_wide_render_fwd_rays(const void* W, const float* b,
                                         const float* ts, const float* ds,
                                         const float* origins,
                                         const float* directions, float* out,
                                         void* acts, int n_rays,
                                         int chunk_rays, int S, int L, int pw,
                                         int kc, int num_functions, int loma,
                                         int bf16, void* stream) {
  return render_fwd(true, W, b, ts, ds, origins, directions, out, acts,
                    n_rays, chunk_rays, S, L, pw, kc, num_functions, loma,
                    bf16, false, stream);
}

// nerf_wide_render_fwd_layers: the bf16 render on the layer chain the fused
// MLP replaced (encode_kernel, one layer GEMM per hidden layer, two acts
// slots), ts, ds (S,) or, with per_ray, (N, S); for comparison only.
extern "C" int nerf_wide_render_fwd_layers(const void* W, const float* b,
                                        const float* ts, const float* ds,
                                        const float* origins,
                                        const float* directions, float* out,
                                        void* acts, int n_rays, int chunk_rays,
                                        int S, int L, int pw, int kc,
                                        int num_functions, int loma,
                                        int per_ray, void* stream) {
  return render_fwd(per_ray != 0, W, b, ts, ds, origins, directions, out,
                    acts, n_rays, chunk_rays, S, L, pw, kc, num_functions,
                    loma, 1, true, stream);
}

// nerf_wide_mlp: the fused MLP alone, one launch for all n_rays: H_{L-1}
// (n_rays * S, pw) bf16 row-major into out; ts (S,) or, with per_ray, (N, S).
extern "C" int nerf_wide_mlp(const void* W, const float* b, const float* ts,
                             const float* origins, const float* directions,
                             void* out, int n_rays, int S, int L, int pw,
                             int kc, int num_functions, int per_ray,
                             void* stream) {
  return static_cast<int>(wide::mlp_forward(
      W, b, ts, origins, directions, static_cast<__nv_bfloat16*>(out), n_rays,
      S, L, pw, kc, num_functions, per_ray != 0,
      static_cast<cudaStream_t>(stream)));
}
