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
// about 66 TFLOP, against ~0.5 GB per 65,536-ray chunk of activations
// moved per layer.  The TPU kernel keeps all L+1 activations of a tile in
// VMEM; here a 128-row bf16 tile of nine 256-wide activations (590 KB) and
// the 1 MB weight stack both exceed a block's 227 KB of shared memory.
//
// What the design does about it: the MLP runs layer by layer as tiled GEMMs
// (nerf_wide_gemm.cuh: 128x128 tiles staged in shared memory; bf16 on the
// tensor cores through mma.sync m16n8k16, f32 as 8x8 FMAs per thread) with
// the bias, ReLU and the rounding to the compute dtype fused into the
// epilogue; activations go through device memory in two ping-pong buffers
// of one ray chunk, nothing saved.  The encoding is one kernel before
// layer 0; the 4-wide head, the compositing and the colour sum are one warp
// per ray (nerf_wide_common.cuh:composite_kernel).  wgmma and TMA are not
// used yet: the GEMMs run far below the tensor cores' peak.

#include "nerf_wide_chain.cuh"

namespace {

int render_fwd(bool per_ray, const void* W, const float* b, const float* ts,
               const float* ds, const float* origins, const float* directions,
               float* out, void* acts, int n_rays, int chunk_rays, int S, int L,
               int pw, int kc, int num_functions, int loma, int bf16,
               void* stream) {
  if (L < 2 || pw % 4 != 0 || kc > pw || chunk_rays <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const wide::Net net{W, b, ts, ds, S, L, pw, kc, num_functions, loma, per_ray};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return static_cast<int>(wide::render_forward<__nv_bfloat16>(
        net, origins, directions, out, static_cast<__nv_bfloat16*>(acts),
        n_rays, chunk_rays, st));
  }
  return static_cast<int>(wide::render_forward<float>(
      net, origins, directions, out, static_cast<float*>(acts), n_rays,
      chunk_rays, st));
}

}  // namespace

// C entry points, bound with ctypes.  W: the (L, pw, pw) weight stack in the
// compute dtype (bf16 != 0: bfloat16, else f32); b: (L, pw) f32; acts:
// 2 * chunk_rays * S * pw elements of scratch in the compute dtype; kc: the
// encoded width padded to 8 (<= pw).  Return the first failing launch's
// cudaError (0 on success); do not synchronise.
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
                    bf16, stream);
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
                    bf16, stream);
}
