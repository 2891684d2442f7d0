// Wide NeRF train step for Hopper (sm_90a): loss and parameter gradients in
// one call.
//
// Replaces the TPU kernels lomanerf_tpu/ops/fused_nerf.py:_nerf_train_kernel_W
// (the s-major single-pass Pallas train step for hidden widths above 64,
// with its backward _bwd_from_dcol; S depths shared by every ray) and,
// through nerf_wide_train_rays, _nerf_train_kernel (the packed row-major one
// on per-ray (N, S) depths, the stratified case): the render forward of
// nerf_wide_render_fwd.cu, the sum-MSE against the (N, 3) targets over the
// runtime n_rays, the colour cotangent 2(col - tgt), the compositing
// adjoint and the MLP backward, dW/db summed over every ray and sample.
//
// What bounds it on this card: arithmetic, then memory.  A step does about
// 1.2 M MACs per sample for the flagship (forward, d_h = d_z W^T and
// dW = h^T d_z): about 5.0 TFLOP for 16,384 rays x 128 samples.  The TPU's
// single pass keeps every activation of a tile in VMEM; that does not fit
// a Hopper block (see nerf_wide_render_fwd.cu), so the saved activations
// live in device memory: 16,384 x 128 x 256 x 2 B = 1.07 GB per layer in
// bf16, ~7.5 GB for the flagship's seven hidden layers.
//
// What the design does about it (nerf_wide_chain.cuh): the forward's
// GEMMs save each layer's input in the compute dtype; one warp per ray
// runs the head, compositing, the loss and its adjoint and the head's
// backward; then, layer by layer in reverse, a split-K GEMM for dW (per
// 8192-row partials, added in a fixed order; for bf16 on wgmma fed by TMA,
// nerf_wide_dw.cuh, from a bf16 copy of d_z) with db from the unrounded
// d_z, and a GEMM for d_h with the ReLU mask from the stored activation in
// its epilogue; for bf16 the forward's and d_h's GEMMs run on wgmma fed by
// TMA (nerf_wide_layer_gemm.cuh), and d_z is kept only as that bf16 copy:
// d_h's epilogue and the compositing write it beside db's column partials
// of the unrounded values, so no f32 d_z crosses device memory.
// Every sum has a fixed order: repeat launches are bit-identical.

#include "nerf_wide_chain.cuh"

// C entry points, bound with ctypes.  Arguments as nerf_wide_render_fwd's,
// with the (N, 3) targets and the scratch of the gradient sequence: acts
// (L * chunk_rays * S * pw, compute dtype), dz (f32 only, else null: 2 *
// chunk_rays * S * pw f32), dzb (bf16 only, else null: 2 * chunk_rays * S *
// pw bf16), db_part (bf16 only, else null: n_db_part f32, at least
// max(chunk_rays, ceil(chunk_rays * S / 128)) * pw), dz_head (chunk_rays * S
// * 4 f32), partials (n_parts f32, at least ceil(chunk_rays * S / 8192) * pw
// * pw), ray_loss (n_rays f32).  Writes dW (L, pw, pw), db (L, pw) and the
// loss (one float).
extern "C" int nerf_wide_train(const void* W, const float* b, const float* ts,
                               const float* ds, const float* origins,
                               const float* directions, const float* target,
                               void* acts, float* dz, void* dzb, float* db_part,
                               long long n_db_part, float* dz_head, float* partials,
                               long long n_parts, float* ray_loss, float* dW, float* db,
                               float* loss, int n_rays, int chunk_rays, int S,
                               int L, int pw, int kc, int num_functions,
                               int loma, int bf16, void* stream) {
  return wide::grad_entry<1>(
      false, W, b, ts, ds, origins, directions, target, acts, dz, dzb, db_part, n_db_part,
      dz_head, partials, n_parts, ray_loss, dW, db, loss, n_rays, chunk_rays, S, L,
      pw, kc, num_functions, loma, bf16, stream);
}

// nerf_wide_train_rays: ts, ds per-ray (N, S) f32, row-major (the
// counterpart of _nerf_train_kernel).
extern "C" int nerf_wide_train_rays(const void* W, const float* b,
                                    const float* ts, const float* ds,
                                    const float* origins,
                                    const float* directions,
                                    const float* target, void* acts, float* dz, void* dzb,
                                    float* db_part, long long n_db_part,
                                    float* dz_head, float* partials,
                                    long long n_parts, float* ray_loss,
                                    float* dW, float* db, float* loss,
                                    int n_rays, int chunk_rays, int S, int L,
                                    int pw, int kc, int num_functions, int loma,
                                    int bf16, void* stream) {
  return wide::grad_entry<1>(
      true, W, b, ts, ds, origins, directions, target, acts, dz, dzb, db_part, n_db_part,
      dz_head, partials, n_parts, ray_loss, dW, db, loss, n_rays, chunk_rays, S, L,
      pw, kc, num_functions, loma, bf16, stream);
}

// The dW stage alone, bf16: part[z][m][n] = the sum over the rows of
// partial z (8192 each) of H[r][m] * Dz[r][n], m < M, n < N, for H and Dz
// (rows, ld) row-major; part holds ceil(rows / 8192) * M * N floats.
// It runs the wgmma/TMA kernel of the gradient sequence (nerf_wide_dw.cuh)
// on a bf16 Dz.
extern "C" int wide_dw_gemm(const void* H, const void* Dz, int ld, int M, int N,
                            int rows, float* part, void* stream) {
  return static_cast<int>(wide::dw_gemm(static_cast<const __nv_bfloat16*>(H),
                                        static_cast<const __nv_bfloat16*>(Dz), ld, M,
                                        N, rows, part, static_cast<cudaStream_t>(stream)));
}

// The bf16 layer GEMM alone, on (rows, pw) operands of row stride pw and a
// (pw, pw) W (one layer of the stack), the first K <= pw columns of A read:
//   dh 0, the forward layer: C (rows, pw) bf16 = bf16(ReLU(A W[:K] + b)),
//     b (pw,) f32 (mask, Cb, part unused);
//   dh 1, d_h: C (rows, pw) f32 = mask > 0 ? A W[:, :K]^T : 0, Cb (rows,
//     pw) bf16 = bf16(C) and part (ceil(rows / 128), pw) f32 = C's column
//     sums over each 128-row tile, mask (rows, pw) bf16 (b unused); C and
//     part may be null (the gradient sequence passes no C).
// It runs the wgmma/TMA kernel of the wide chain (nerf_wide_layer_gemm.cuh).
extern "C" int wide_layer_gemm(const void* A, const void* W, const float* b, const void* mask,
                               void* C, void* Cb, float* part, int rows, int pw, int K,
                               int dh, void* stream) {
  const auto* a = static_cast<const __nv_bfloat16*>(A);
  const auto* w = static_cast<const __nv_bfloat16*>(W);
  const auto* m = static_cast<const __nv_bfloat16*>(mask);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dh ? wide::layer_gemm<wide::kEpiMask>(a, pw, w, pw, rows, pw, K, nullptr, m, C, pw,
                                            static_cast<__nv_bfloat16*>(Cb), st, part)
         : wide::layer_gemm<wide::kEpiBiasRelu>(a, pw, w, pw, rows, pw, K, b, nullptr, C, pw,
                                                nullptr, st, nullptr));
}
