// The wide chain's f32 GEMM alone (nerf_wide_f32_gemm.cuh).  It is not on
// a TPU kernel's path by itself: this entry point exists to test and
// measure the GEMM that the wide NeRF kernels at f32 compute
// (nerf_wide_chain.cuh) and the wide field route's "highest" tier
// (field_wide.cu) run for every product.

#include "nerf_wide_f32_gemm.cuh"

namespace {

// the forms of the entry point, by `form`
constexpr int kFormForward = 0, kFormDh = 1, kFormDw = 2, kFormHead = 3, kFormHeadGrad = 4;

}  // namespace

// C = the f32 GEMM of `form` (as nerf_wide_gemm.cuh names its epilogues):
//   0 forward layer  C (M, N) = ReLU(A[:, :K] B[:K] + bias), A (M, lda) [m][k],
//                    B (K, ldb) [k][n], bias (N,)
//   1 d_h            C (M, N) = mask > 0 ? A[:, :K] B^T : 0, A (M, lda), B (N,
//                    ldb) [n][k], mask (M, ldc)
//   2 dW             C (parts, M, N) = A^T B over k chunks of k_chunk rows,
//                    A (K, lda) [k][m], B (K, ldb) [k][n]; ldc unused
//   3 head           C (M, N) = sigmoid(A[:, :K] B[:K] + bias)
//   4 head's d_z     C (M, N) = mask y (1 - y), y = the head's, mask (M, ldc)
// C's rows ldc apart.  Returns the launch's cudaError (0 on success); does
// not synchronise.
extern "C" int wide_f32_gemm(const float* A, int lda, const float* B, int ldb,
                             const float* bias, const float* mask, float* C, int ldc, int M,
                             int N, int K, int k_chunk, int form, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (form) {
    case kFormForward:
      err = wide::f32_gemm<false, false, wide::kEpiBiasRelu>(A, lda, B, ldb, M, N, K, K, bias,
                                                             mask, C, ldc, st);
      break;
    case kFormDh:
      err = wide::f32_gemm<false, true, wide::kEpiMask>(A, lda, B, ldb, M, N, K, K, bias, mask,
                                                        C, ldc, st);
      break;
    case kFormDw:
      err = wide::f32_gemm<true, false, wide::kEpiPartial>(A, lda, B, ldb, M, N, K, k_chunk,
                                                           bias, mask, C, ldc, st);
      break;
    case kFormHead:
      err = wide::f32_gemm<false, false, wide::kEpiSigmoid>(A, lda, B, ldb, M, N, K, K, bias,
                                                            mask, C, ldc, st);
      break;
    case kFormHeadGrad:
      err = wide::f32_gemm<false, false, wide::kEpiSigmoidGrad>(A, lda, B, ldb, M, N, K, K,
                                                                bias, mask, C, ldc, st);
      break;
    default:
      break;
  }
  return static_cast<int>(err);
}
