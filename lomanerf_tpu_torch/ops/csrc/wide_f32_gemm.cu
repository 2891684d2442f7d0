// The wide chain's f32 GEMM alone (nerf_wide_f32_gemm.cuh), and the FMA
// kernel it replaced (nerf_wide_gemm.cuh:gemm_kernel) on the same inputs,
// kept so that the card can compare the two bit for bit and time them.
// Neither is on a TPU kernel's path by itself: these entry points exist to
// test and measure the GEMM that the wide NeRF kernels at f32 compute
// (nerf_wide_chain.cuh) and the wide field route's "highest" tier
// (field_wide.cu) run for every product.

#include "nerf_wide_f32_gemm.cuh"

namespace {

// the forms of the entry points, by `form`
constexpr int kFormForward = 0, kFormDh = 1, kFormDw = 2, kFormHead = 3, kFormHeadGrad = 4;

template <bool kAT, bool kBT, int kEpi>
cudaError_t run(bool fma, const float* A, int lda, const float* B, int ldb, const float* bias,
                const float* mask, float* C, int ldc, int M, int N, int K, int k_chunk,
                cudaStream_t stream) {
  if (fma) {
    if (M <= 0 || N <= 0 || K <= 0 || k_chunk <= 0) return cudaErrorInvalidValue;
    return wide::gemm_fma<float, float, float, kAT, kBT, kEpi>(A, lda, B, ldb, M, N, K, k_chunk,
                                                               bias, mask, C, ldc, stream);
  }
  return wide::f32_gemm<kAT, kBT, kEpi>(A, lda, B, ldb, M, N, K, k_chunk, bias, mask, C, ldc,
                                        stream);
}

int entry(bool fma, const float* A, int lda, const float* B, int ldb, const float* bias,
          const float* mask, float* C, int ldc, int M, int N, int K, int k_chunk, int form,
          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (form) {
    case kFormForward:
      err = run<false, false, wide::kEpiBiasRelu>(fma, A, lda, B, ldb, bias, mask, C, ldc, M, N,
                                                  K, K, st);
      break;
    case kFormDh:
      err = run<false, true, wide::kEpiMask>(fma, A, lda, B, ldb, bias, mask, C, ldc, M, N, K,
                                             K, st);
      break;
    case kFormDw:
      err = run<true, false, wide::kEpiPartial>(fma, A, lda, B, ldb, bias, mask, C, ldc, M, N,
                                                K, k_chunk, st);
      break;
    case kFormHead:
      err = run<false, false, wide::kEpiSigmoid>(fma, A, lda, B, ldb, bias, mask, C, ldc, M, N,
                                                 K, K, st);
      break;
    case kFormHeadGrad:
      err = run<false, false, wide::kEpiSigmoidGrad>(fma, A, lda, B, ldb, bias, mask, C, ldc, M,
                                                     N, K, K, st);
      break;
    default:
      break;
  }
  return static_cast<int>(err);
}

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
// C's rows ldc apart.  wide_f32_gemm runs nerf_wide_f32_gemm.cuh's kernel,
// wide_f32_gemm_fma gemm_kernel.  Returns the launch's cudaError (0 on
// success); does not synchronise.
extern "C" int wide_f32_gemm(const float* A, int lda, const float* B, int ldb,
                             const float* bias, const float* mask, float* C, int ldc, int M,
                             int N, int K, int k_chunk, int form, void* stream) {
  return entry(false, A, lda, B, ldb, bias, mask, C, ldc, M, N, K, k_chunk, form, stream);
}

extern "C" int wide_f32_gemm_fma(const float* A, int lda, const float* B, int ldb,
                                 const float* bias, const float* mask, float* C, int ldc,
                                 int M, int N, int K, int k_chunk, int form, void* stream) {
  return entry(true, A, lda, B, ldb, bias, mask, C, ldc, M, N, K, k_chunk, form, stream);
}
