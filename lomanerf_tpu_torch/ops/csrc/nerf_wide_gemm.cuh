// A hand-written tiled GEMM for the wide NeRF kernels, with f32
// accumulation and the three epilogues the wide MLP needs, plus the
// deterministic reductions around it (column sums, fixed-order sums of
// split-K partials, the loss sum).
//
//   C(m, n) = sum_k rnd(A(m, k)) * rnd(B(k, n))       (rnd: to CDT and back)
//   A(m, k) = kAT ? A[k * lda + m] : A[m * lda + k]
//   B(k, n) = kBT ? B[n * ldb + k] : B[k * ldb + n]
//
// Epilogues:
//   kEpiBiasRelu  C = CDT(ReLU(acc + bias[n]))            the forward layer
//   kEpiMask      C = f32(mask[m, n] > 0 ? acc : 0)       d_h = d_z W^T (h > 0);
//                 mask (CDT) has C's row stride ldc; bf16 only, where Cb
//                 is given, also Cb = bf16(C) (the copy the dW stage reads),
//                 and on layer_gemm C optional and the 128-row column
//                 partials of C in part (db's)
//   kEpiPartial   C[z][m][n] = acc over rows chunk z       dW = h^T d_z, split-K
//   kEpiSigmoid   C = f32(sigmoid(acc + bias[n]))          a field's head (f32 only)
//   kEpiSigmoidGrad  C = mask[m, n] * y * (1 - y),         its d_z from the output
//                 y = sigmoid(acc + bias[n]); mask (the    cotangent (f32 only)
//                 cotangent) has C's row stride ldc
//
// Four kernels, chosen in gemm(): for bf16 the forward layer and d_h on
// wgmma/TMA (layer_gemm, nerf_wide_layer_gemm.cuh) and the other forms on
// gemm_mma_kernel (below); for f32 every form on f32_gemm
// (nerf_wide_f32_gemm.cuh: FMAs on k-tiles staged by cp.async through a
// ring).  gemm_kernel, the f32 kernel it replaced, stays as its twin
// (gemm_fma): 128 x 128 outputs per block of 256 threads, 8 x 8 per thread,
// k-steps of 8 staged in shared memory as f32 (already rounded to CDT), so
// the inner loop is plain f32 FMAs.  Every load of gemm_kernel is
// bounds-checked (zero fill) and every store guarded, so M, N and K are
// arbitrary.
//
// Determinism: each output is one thread's sequential sum over its k
// range; split-K partials and column sums are added in a fixed order by
// sum_partials_kernel, so repeat launches are bit-identical.

#pragma once

#include <type_traits>

#include "nerf_wide_common.cuh"

namespace wide {
namespace {

constexpr int kBM = 128, kBN = 128, kBK = 8, kGemmThreads = 256;
constexpr int kEpiBiasRelu = 0, kEpiMask = 1, kEpiPartial = 2, kEpiSigmoid = 3,
              kEpiSigmoidGrad = 4;

template <typename TA, typename TB, typename CDT, bool kAT, bool kBT, int kEpi>
__global__ void __launch_bounds__(kGemmThreads)
gemm_kernel(const TA* __restrict__ A, int lda, const TB* __restrict__ B,
            int ldb, int M, int N, int K, int k_chunk,
            const float* __restrict__ bias, const CDT* __restrict__ mask,
            void* __restrict__ C, int ldc) {
  __shared__ __align__(16) float As[kBK][kBM];
  __shared__ __align__(16) float Bs[kBK][kBN];
  const int t = threadIdx.x;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int kbeg = blockIdx.z * k_chunk;
  const int kend = min(K, kbeg + k_chunk);
  const int ty = t >> 4, tx = t & 15;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int k0 = kbeg; k0 < kend; k0 += kBK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int m, k;
      if (kAT) {
        k = t >> 5, m = (t & 31) * 4 + i;
      } else {
        m = t >> 1, k = (t & 1) * 4 + i;
      }
      const int gm = m0 + m, gk = k0 + k;
      float v = 0.0f;
      if (gm < M && gk < kend) {
        v = rnd<CDT>(to_f32(kAT ? A[static_cast<size_t>(gk) * lda + gm]
                                : A[static_cast<size_t>(gm) * lda + gk]));
      }
      As[k][m] = v;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int n, k;
      if (kBT) {
        n = t >> 1, k = (t & 1) * 4 + i;
      } else {
        k = t >> 5, n = (t & 31) * 4 + i;
      }
      const int gn = n0 + n, gk = k0 + k;
      float v = 0.0f;
      if (gn < N && gk < kend) {
        v = rnd<CDT>(to_f32(kBT ? B[static_cast<size_t>(gn) * ldb + gk]
                                : B[static_cast<size_t>(gk) * ldb + gn]));
      }
      Bs[k][n] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 8]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][ty * 8 + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 8]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 8 + 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + ty * 8 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + tx * 8 + j;
      if (n >= N) continue;
      if (kEpi == kEpiBiasRelu) {
        static_cast<CDT*>(C)[static_cast<size_t>(m) * ldc + n] =
            from_f32<CDT>(fmaxf(acc[i][j] + bias[n], 0.0f));
      } else if (kEpi == kEpiMask) {
        const float h = to_f32(mask[static_cast<size_t>(m) * ldc + n]);
        static_cast<float*>(C)[static_cast<size_t>(m) * ldc + n] =
            h > 0.0f ? acc[i][j] : 0.0f;
      } else if (kEpi == kEpiSigmoid) {
        static_cast<float*>(C)[static_cast<size_t>(m) * ldc + n] =
            sigmoidf(acc[i][j] + bias[n]);
      } else if (kEpi == kEpiSigmoidGrad) {
        const size_t at = static_cast<size_t>(m) * ldc + n;
        const float y = sigmoidf(acc[i][j] + bias[n]);
        static_cast<float*>(C)[at] = to_f32(mask[at]) * y * (1.0f - y);
      } else {
        static_cast<float*>(C)[(static_cast<size_t>(blockIdx.z) * M + m) * N + n] =
            acc[i][j];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 tensor cores: mma.sync m16n8k16 (bf16 x bf16 -> f32).
//
// Block tile 128 x 128, k-steps of 32, 8 warps each owning a 64 x 32
// sub-tile (4 x 4 mma tiles, 64 f32 accumulators a thread).  Shared memory
// holds the tile as bf16 in the mma operand order, A as [m][k] and B as
// [n][k], rows padded to 40 elements (80 bytes) so that the fragment loads
// of a warp hit 32 distinct banks.  Global loads move 4 elements a thread
// (8 bytes of bf16 or 16 of f32, rounded to bf16 on the way: the rounding
// plan's rnd), into registers for the next k-step while the current one
// multiplies.  Operands stored k-major in device memory (A for the head's
// dW = h^T d_z, B for every forward layer's W and the head's d_z) are
// scattered into the [m][k] / [n][k] order as they are stored (the hidden
// layers' dW runs on nerf_wide_dw.cuh); the mapping of vectors to
// lanes puts a warp's 32 lanes on 32 different k, so those stores do not
// conflict.  Needs M and N (the contiguous dims) and K-chunk edges at
// multiples of 4, 8-byte aligned rows.  The products of two bf16 values
// are exact; each 32-deep k-step is summed by the mma, and the k-steps by
// f32 adds (see below).  The order of every sum is fixed, so repeat
// launches stay bit-identical.
constexpr int kMK = 32, kMLd = kMK + 8;

__device__ __forceinline__ uint2 load_bf16x4(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint2*>(p);
}
__device__ __forceinline__ uint2 load_bf16x4(const float* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  return make_uint2(*reinterpret_cast<const unsigned*>(&a),
                    *reinterpret_cast<const unsigned*>(&b));
}

// Vector i (of 4) of this thread's share of a 128 x 32 operand tile:
// (row r of the tile's 128, k index) and whether the 4 elements run along
// k (contiguous in k) or along r.
template <bool kKMajor>
__device__ __forceinline__ void tile_vec(int t, int i, int* r, int* k) {
  const int v = t + 256 * i;
  if (kKMajor) {  // memory [k][r]: 4 consecutive r; lanes on distinct k
    *k = v & 31, *r = (v >> 5) * 4;
  } else {  // memory [r][k]: 4 consecutive k
    *r = v >> 3, *k = (v & 7) * 4;
  }
}

template <typename T, bool kKMajor>
__device__ __forceinline__ void load_tile(const T* __restrict__ X, int ld,
                                          int r0, int R, int k0, int kend,
                                          int t, uint2 (&reg)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int r, k;
    tile_vec<kKMajor>(t, i, &r, &k);
    const int gr = r0 + r, gk = k0 + k;
    reg[i] = make_uint2(0u, 0u);
    if (gr < R && gk < kend) {
      reg[i] = load_bf16x4(kKMajor ? X + static_cast<size_t>(gk) * ld + gr
                                   : X + static_cast<size_t>(gr) * ld + gk);
    }
  }
}

template <bool kKMajor>
__device__ __forceinline__ void store_tile(__nv_bfloat16 (*S)[kMLd], int t,
                                           const uint2 (&reg)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int r, k;
    tile_vec<kKMajor>(t, i, &r, &k);
    if (kKMajor) {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&reg[i]);
#pragma unroll
      for (int q = 0; q < 4; ++q) S[r + q][k] = e[q];
    } else {
      *reinterpret_cast<uint2*>(&S[r][k]) = reg[i];
    }
  }
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename TA, typename TB, bool kAT, bool kBT, int kEpi>
__global__ void __launch_bounds__(kGemmThreads)
gemm_mma_kernel(const TA* __restrict__ A, int lda, const TB* __restrict__ B,
                int ldb, int M, int N, int K, int k_chunk,
                const float* __restrict__ bias,
                const __nv_bfloat16* __restrict__ mask, void* __restrict__ C,
                int ldc, __nv_bfloat16* __restrict__ Cb) {
  __shared__ __align__(16) __nv_bfloat16 As[kBM][kMLd];
  __shared__ __align__(16) __nv_bfloat16 Bs[kBN][kMLd];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int kbeg = blockIdx.z * k_chunk;
  const int kend = min(K, kbeg + k_chunk);

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0.0f;

  uint2 ra[4], rb[4];
  load_tile<TA, kAT>(A, lda, m0, M, kbeg, kend, t, ra);
  load_tile<TB, !kBT>(B, ldb, n0, N, kbeg, kend, t, rb);
  for (int k0 = kbeg; k0 < kend; k0 += kMK) {
    store_tile<kAT>(As, t, ra);
    store_tile<!kBT>(Bs, t, rb);
    __syncthreads();
    if (k0 + kMK < kend) {  // the next k-step's loads overlap this one's mma
      load_tile<TA, kAT>(A, lda, m0, M, k0 + kMK, kend, t, ra);
      load_tile<TB, !kBT>(B, ldb, n0, N, k0 + kMK, kend, t, rb);
    }
    // this k-step's products go into a fresh tile, then into the running
    // sum by IEEE f32 adds (round to nearest): the mma's own accumulation
    // truncates, and over a dW chain of 8192 rows that bias alone moved a
    // flagship leaf's gradient by 3e-2 of its largest entry
    float part[4][4][4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r) part[mi][ni][r] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < kMK; ks += 16) {
      unsigned a[4][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int row = wm + mi * 16 + g;
        a[mi][0] = *reinterpret_cast<const unsigned*>(&As[row][ks + tig * 2]);
        a[mi][1] = *reinterpret_cast<const unsigned*>(&As[row + 8][ks + tig * 2]);
        a[mi][2] = *reinterpret_cast<const unsigned*>(&As[row][ks + tig * 2 + 8]);
        a[mi][3] = *reinterpret_cast<const unsigned*>(&As[row + 8][ks + tig * 2 + 8]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = wn + ni * 8 + g;
        b[ni][0] = *reinterpret_cast<const unsigned*>(&Bs[col][ks + tig * 2]);
        b[ni][1] = *reinterpret_cast<const unsigned*>(&Bs[col][ks + tig * 2 + 8]);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(part[mi][ni], a[mi], b[ni]);
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[mi][ni][r] += part[mi][ni][r];
    __syncthreads();
  }

  // each thread holds column pairs (n, n + 1), n even: rows g and g + 8 of
  // every mma tile; N is a multiple of 4, so n < N covers n + 1
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int m = m0 + wm + mi * 16 + g + hr * 8;
        const int n = n0 + wn + ni * 8 + tig * 2;
        if (m >= M || n >= N) continue;
        const float v0 = acc[mi][ni][2 * hr], v1 = acc[mi][ni][2 * hr + 1];
        const size_t at = static_cast<size_t>(m) * ldc + n;
        if (kEpi == kEpiBiasRelu) {
          *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(C) + at) =
              __floats2bfloat162_rn(fmaxf(v0 + bias[n], 0.0f), fmaxf(v1 + bias[n + 1], 0.0f));
        } else if (kEpi == kEpiMask) {
          const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(mask + at);
          const float o0 = __low2float(h) > 0.0f ? v0 : 0.0f;
          const float o1 = __high2float(h) > 0.0f ? v1 : 0.0f;
          *reinterpret_cast<float2*>(static_cast<float*>(C) + at) = make_float2(o0, o1);
          if (Cb != nullptr) {
            *reinterpret_cast<__nv_bfloat162*>(Cb + at) = __floats2bfloat162_rn(o0, o1);
          }
        } else {
          *reinterpret_cast<float2*>(static_cast<float*>(C) +
                                     (static_cast<size_t>(blockIdx.z) * M + m) * N + n) =
              make_float2(v0, v1);
        }
      }
    }
  }
}

// gemm_mma_kernel's launch, in any of its forms (gemm() takes it for bf16
// where layer_gemm does not apply; the *_mma entry points call it directly
// to compare with the kernels that replaced it)
template <typename TA, typename TB, bool kAT, bool kBT, int kEpi>
cudaError_t gemm_mma(const TA* A, int lda, const TB* B, int ldb, int M, int N, int K,
                     int k_chunk, const float* bias, const __nv_bfloat16* mask, void* C,
                     int ldc, cudaStream_t stream, __nv_bfloat16* Cb = nullptr) {
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN, (K + k_chunk - 1) / k_chunk);
  gemm_mma_kernel<TA, TB, kAT, kBT, kEpi><<<grid, kGemmThreads, 0, stream>>>(
      A, lda, B, ldb, M, N, K, k_chunk, bias, mask, C, ldc, Cb);
  return cudaGetLastError();
}

// gemm_kernel's launch, in any of its forms (the *_fma entry points call it
// directly to compare with the kernel that replaced it)
template <typename TA, typename TB, typename CDT, bool kAT, bool kBT, int kEpi>
cudaError_t gemm_fma(const TA* A, int lda, const TB* B, int ldb, int M, int N, int K,
                     int k_chunk, const float* bias, const CDT* mask, void* C, int ldc,
                     cudaStream_t stream) {
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN, (K + k_chunk - 1) / k_chunk);
  gemm_kernel<TA, TB, CDT, kAT, kBT, kEpi><<<grid, kGemmThreads, 0, stream>>>(
      A, lda, B, ldb, M, N, K, k_chunk, bias, mask, C, ldc);
  return cudaGetLastError();
}

// The bf16 forward layer and d_h on wgmma fed by TMA, defined in
// nerf_wide_layer_gemm.cuh, and the f32 GEMM, defined in
// nerf_wide_f32_gemm.cuh (both need this header's epilogue names).
template <int kEpi, bool kLinear = false>
cudaError_t layer_gemm(const __nv_bfloat16* A, int lda, const __nv_bfloat16* B, int ldb,
                       int M, int N, int K, const float* bias, const __nv_bfloat16* mask,
                       void* C, int ldc, __nv_bfloat16* Cb, cudaStream_t stream,
                       float* part);
template <bool kAT, bool kBT, int kEpi>
cudaError_t f32_gemm(const float* A, int lda, const float* B, int ldb, int M, int N, int K,
                     int k_chunk, const float* bias, const float* mask, void* C, int ldc,
                     cudaStream_t stream);

// C = the GEMM of the form the template arguments give (k_chunk = K but for
// kEpiPartial).  bf16: the forward layer (kEpiBiasRelu, [k][n] B) and d_h
// from the bf16 d_z copy (kEpiMask, [n][k] B, with its column partials in
// part) on layer_gemm, every other form on gemm_mma_kernel; f32: f32_gemm.
template <typename TA, typename TB, typename CDT, bool kAT, bool kBT, int kEpi>
cudaError_t gemm(const TA* A, int lda, const TB* B, int ldb, int M, int N,
                 int K, int k_chunk, const float* bias, const CDT* mask,
                 void* C, int ldc, cudaStream_t stream,
                 __nv_bfloat16* Cb = nullptr, float* part = nullptr) {
  if constexpr (std::is_same<CDT, __nv_bfloat16>::value) {
    constexpr bool kLayer =
        std::is_same<TA, __nv_bfloat16>::value && std::is_same<TB, __nv_bfloat16>::value &&
        !kAT && ((kEpi == kEpiBiasRelu && !kBT) || (kEpi == kEpiMask && kBT));
    if constexpr (kLayer) {
      return layer_gemm<kEpi>(A, lda, B, ldb, M, N, K, bias, mask, C, ldc, Cb, stream, part);
    } else {
      return gemm_mma<TA, TB, kAT, kBT, kEpi>(A, lda, B, ldb, M, N, K, k_chunk, bias, mask,
                                              C, ldc, stream, Cb);
    }
  } else {
    static_assert(std::is_same<TA, float>::value && std::is_same<TB, float>::value,
                  "f32 compute takes f32 operands");
    return f32_gemm<kAT, kBT, kEpi>(A, lda, B, ldb, M, N, K, k_chunk, bias, mask, C, ldc,
                                    stream);
  }
}

// part[z][n] = sum of Z[row * ldz + n] over the rows of chunk z (chunk rows
// each), n < N: 32 columns per block, 8 row lanes each summing every 8th row
// in order (eight rows' loads in flight, then added in order), then lane 0
// adds the 8 lane sums in order.
__global__ void __launch_bounds__(256)
colsum_kernel(const float* __restrict__ Z, int ldz, int rows, int N, int chunk,
              float* __restrict__ part) {
  __shared__ float red[8][33];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int n = blockIdx.y * 32 + tx;
  const int r0 = blockIdx.x * chunk;
  const int r1 = min(rows, r0 + chunk);
  float s = 0.0f;
  if (n < N) {
    int r = r0 + ty;
    for (; r + 56 < r1; r += 64) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = Z[static_cast<size_t>(r + 8 * u) * ldz + n];
#pragma unroll
      for (int u = 0; u < 8; ++u) s += v[u];
    }
    for (; r < r1; r += 8) s += Z[static_cast<size_t>(r) * ldz + n];
  }
  red[ty][tx] = s;
  __syncthreads();
  if (ty == 0 && n < N) {
    float total = 0.0f;
    for (int q = 0; q < 8; ++q) total += red[q][tx];
    part[static_cast<size_t>(blockIdx.x) * N + n] = total;
  }
}

// out[m * ldo + n] += sum over z < n_parts of part[z][m][n], in z order.
__global__ void __launch_bounds__(256)
sum_partials_kernel(const float* __restrict__ part, int n_parts, int M, int N,
                    float* __restrict__ out, int ldo) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= M * N) return;
  float s = 0.0f;
  for (int z = 0; z < n_parts; ++z) s += part[static_cast<size_t>(z) * M * N + e];
  const int m = e / N, n = e - m * N;
  out[static_cast<size_t>(m) * ldo + n] += s;
}

cudaError_t sum_partials(const float* part, int n_parts, int M, int N,
                         float* out, int ldo, cudaStream_t stream) {
  sum_partials_kernel<<<(M * N + 255) / 256, 256, 0, stream>>>(part, n_parts, M,
                                                               N, out, ldo);
  return cudaGetLastError();
}

// db += the column sums of Z (rows, N) with row stride ldz, through the
// partials of each chunk of `chunk` rows in `part` and their fixed-order
// sum.  Z is a d_z (chunk = kRowChunk) or, for bf16, the rows of column
// partials that d_z's producer wrote (chunk = as many as cover kRowChunk
// rows of d_z, so that a ray chunk of kRowChunk rows sums as in one call).
cudaError_t column_sums(const float* Z, int ldz, int rows, int N, int chunk, float* part,
                        float* db, cudaStream_t stream) {
  const int n_parts = (rows + chunk - 1) / chunk;
  colsum_kernel<<<dim3(n_parts, (N + 31) / 32), 256, 0, stream>>>(Z, ldz, rows,
                                                                   N, chunk, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return sum_partials(part, n_parts, 1, N, db, N, stream);
}

// *loss = sum of x[0..n): 256 threads each sum every 256th entry in order,
// then thread 0 adds the 256 sums in order.
__global__ void __launch_bounds__(256)
loss_sum_kernel(const float* __restrict__ x, int n, float* __restrict__ loss) {
  __shared__ float red[256];
  float s = 0.0f;
  for (int i = threadIdx.x; i < n; i += 256) s += x[i];
  red[threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.0f;
    for (int q = 0; q < 256; ++q) total += red[q];
    *loss = total;
  }
}

}  // namespace
}  // namespace wide
