// A 3xTF32 tensor-core GEMM for the wide image-field route (field_wide.cu)
// on Hopper (sm_90a): the products of the JAX package's "high" and
// "default" tiers.  The "highest" tier runs nerf_wide_f32_gemm.cuh's
// f32_gemm (exact f32 FMAs).
//
//   out(m, n) = sum_k A(m, k) B(k, n)                    (3xTF32)
//   A(m, k) = kAT ? A[k * lda + m] : A[m * lda + k]
//   B(k, n) = kBT ? B[n * ldb + k] : B[k * ldb + n]
//
// with nerf_wide_gemm.cuh's epilogues on f32:
//   kEpiBiasRelu     C = ReLU(out + bias[n])               a hidden layer
//   kEpiSigmoid      C = sigmoid(out + bias[n])            the head
//   kEpiSigmoidGrad  C = mask[m, n] y (1 - y),             the head's d_z
//                    y = sigmoid(out + bias[n])            (mask: the cotangent)
//   kEpiMask         C = mask[m, n] > 0 ? out : 0          d_h = d_z W^T (h > 0)
//   kEpiPartial      C[z][m][n] = out over k chunk z       dW = h^T d_z, split-K
// the mask at its own row stride ldm.
//
// The arithmetic is the tile kernels' (field_common.cuh: split, mma_tf32,
// warp_gemm), so that the wide route meets the same bounds: each operand x
// = hi + lo, hi = x rounded to TF32 (rna), lo = x - hi; per 8-deep k-step,
// mma.sync.m16n8k8 adds a_hi b_hi into one f32 accumulator and a_lo b_hi,
// then a_hi b_lo, into a second; out = the first + the second.  The
// k-steps run in order from the start of the block's k range; a k-step
// wholly past K is skipped (its products are zero).  Each output is one
// fixed sum, so repeat launches are bit-identical.
//
// Layout.  A block of kWM x kWN warps owns a BM x BN output tile, each
// warp (16 kMI) x (8 kNI) of it: the big tile is 128 x 64, four warps of
// 64 x 32 (128 accumulators a thread, two blocks an SM, so that one
// block's epilogue runs beside the other's products); a narrow one 128 x
// 16 (eight warps) takes N <= 16 (a head of up to 16 channels), and 64 x
// 64 the dW of a layer with at most 64 inputs (the encoding).  The
// k-tiles (32 deep) of both operands are staged by 16-B cp.async
// (cp.async.cg, zero-filled element by element past the operand's
// extents) into a kStages-deep ring in dynamic shared memory, in
// field_common.cuh:swz's swizzle: an operand stored with k contiguous as
// [rows][32], read through ldmatrix (RowA, RowB); one stored with m or n
// contiguous as [32][BM or BN], read by scalar loads (ColA, ColB).  Every
// fragment read of a warp hits 32 banks.  One __syncthreads a k-tile; the
// next tiles' copies fly during this one's products, and a whole k-tile's
// four k-steps run branch-free.  The epilogue goes through shared memory
// (the ring, free by then): each thread loads its four-column groups'
// mask and bias at once, then applies the epilogue and stores 16 B a
// group, so rows leave coalesced.  Needs lda and ldb multiples of 4 and A
// and B 16-B aligned.

#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "field_common.cuh"
#include "nerf_wide_gemm.cuh"

namespace wide3 {
namespace {

using field::ColA;
using field::ColB;
using field::mma_tf32;
using field::RowA;
using field::RowB;
using field::split;
using field::swz;

constexpr int kBK = 32, kStages = 3;

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int kPending>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// kRows x kCols floats of the row-major operand X (row stride ld) from
// (r0, c0) into S at swz(r, c, kCols), zero past row rmax and column cmax;
// kThreads threads, 16 B each a copy
template <int kRows, int kCols, int kThreads>
__device__ __forceinline__ void stage(float* S, const float* __restrict__ X, int ld, int r0,
                                      int rmax, int c0, int cmax) {
  constexpr int kPerRow = kCols / 4, kChunks = kRows * kPerRow;
#pragma unroll
  for (int i = 0; i < (kChunks + kThreads - 1) / kThreads; ++i) {
    const int id = static_cast<int>(threadIdx.x) + i * kThreads;
    if (kChunks % kThreads != 0 && id >= kChunks) break;
    const int r = id / kPerRow, c = id % kPerRow * 4;
    const int gr = r0 + r, gc = c0 + c;
    const int valid = gr < rmax ? min(max(cmax - gc, 0), 4) : 0;
    const float* src = valid > 0 ? X + static_cast<size_t>(gr) * ld + gc : X;
    cp_async16(S + swz(r, c, kCols), src, 4 * valid);
  }
}

// The epilogue's operands of four outputs (m, n..n+3): the bias and the
// mask, zero where the epilogue takes none and past column N; with vec
// (16-B aligned rows of C, mask and bias) and four columns in range, one
// 16-B load each.
template <int kEpi>
__device__ __forceinline__ void operands4(int m, int n, int N, bool vec,
                                          const float* __restrict__ bias,
                                          const float* __restrict__ mask, int ldm, float4& b,
                                          float4& k) {
  constexpr bool kBias = kEpi == wide::kEpiBiasRelu || kEpi == wide::kEpiSigmoid ||
                         kEpi == wide::kEpiSigmoidGrad;
  constexpr bool kMask = kEpi == wide::kEpiSigmoidGrad || kEpi == wide::kEpiMask;
  b = k = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (vec && n + 3 < N) {
    if (kBias) b = *reinterpret_cast<const float4*>(bias + n);
    if (kMask) k = *reinterpret_cast<const float4*>(mask + static_cast<size_t>(m) * ldm + n);
    return;
  }
  float* bf = reinterpret_cast<float*>(&b);
  float* kf = reinterpret_cast<float*>(&k);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (n + e < N) {
      if (kBias) bf[e] = bias[n + e];
      if (kMask) kf[e] = mask[static_cast<size_t>(m) * ldm + n + e];
    }
  }
}

// The epilogue of those four outputs, out = v, into C[at..at+3] (one 16-B
// store as above).
template <int kEpi>
__device__ __forceinline__ void epilogue4(float4 v, float4 b4, float4 k4, int n, int N,
                                          bool vec, float* __restrict__ C, size_t at) {
  float o[4] = {v.x, v.y, v.z, v.w};
  const float b[4] = {b4.x, b4.y, b4.z, b4.w}, k[4] = {k4.x, k4.y, k4.z, k4.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (kEpi == wide::kEpiBiasRelu) {
      o[e] = fmaxf(o[e] + b[e], 0.0f);
    } else if (kEpi == wide::kEpiSigmoid) {
      o[e] = wide::sigmoidf(o[e] + b[e]);
    } else if (kEpi == wide::kEpiSigmoidGrad) {
      const float y = wide::sigmoidf(o[e] + b[e]);
      o[e] = k[e] * y * (1.0f - y);
    } else if (kEpi == wide::kEpiMask) {
      o[e] = k[e] > 0.0f ? o[e] : 0.0f;
    }
  }
  if (vec && n + 3 < N) {
    *reinterpret_cast<float4*>(C + at) = make_float4(o[0], o[1], o[2], o[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (n + e < N) C[at + e] = o[e];
    }
  }
}

template <int kMI, int kNI, int kWM, int kWN, bool kAT, bool kBT, int kEpi>
__global__ void __launch_bounds__(kWM * kWN * 32, 256 / (kWM * kWN * 32))
gemm3_kernel(const float* __restrict__ A, int lda, const float* __restrict__ B, int ldb,
             int M, int N, int K, int k_chunk, int tiles_n, const float* __restrict__ bias,
             const float* __restrict__ mask, int ldm, float* __restrict__ C, int ldc,
             bool vec) {
  static_assert(kNI % 2 == 0, "n8 tiles in pairs");
  constexpr int kThreads = kWM * kWN * 32;
  constexpr int BM = kWM * kMI * 16, BN = kWN * kNI * 8;
  constexpr int kAF = BM * kBK, kStageF = (BM + BN) * kBK;
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x / tiles_n * BM, n0 = blockIdx.x % tiles_n * BN;
  const int wm = warp / kWN * (kMI * 16), wn = warp % kWN * (kNI * 8);
  const int kbeg = blockIdx.y * k_chunk, kend = min(K, kbeg + k_chunk);
  const int n_kt = (kend - kbeg + kBK - 1) / kBK;

  auto load = [&](int kt) {
    float* As = smem + (kt % kStages) * kStageF;
    float* Bs = As + kAF;
    const int k0 = kbeg + kt * kBK;
    if (kAT) {
      stage<kBK, BM, kThreads>(As, A, lda, k0, kend, m0, M);  // [k][m]
    } else {
      stage<BM, kBK, kThreads>(As, A, lda, m0, M, k0, kend);  // [m][k]
    }
    if (kBT) {
      stage<BN, kBK, kThreads>(Bs, B, ldb, n0, N, k0, kend);  // [n][k]
    } else {
      stage<kBK, BN, kThreads>(Bs, B, ldb, k0, kend, n0, N);  // [k][n]
    }
  };

  float big[kMI][kNI][4], small[kMI][kNI][4];
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) big[mi][ni][r] = small[mi][ni][r] = 0.0f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_kt) load(s);
    cp_commit();
  }
  for (int kt = 0; kt < n_kt; ++kt) {
    cp_wait<kStages - 2>();  // k-tile kt has landed (this thread's copies) ...
    __syncthreads();         // ... every thread's; k-tile kt - 1 is read
    if (kt + kStages - 1 < n_kt) load(kt + kStages - 1);
    cp_commit();
    const float* As = smem + (kt % kStages) * kStageF;
    const float* Bs = As + kAF;
    // one 8-deep k-step: every fragment read and split, then the a_hi b_hi
    // products, then a_lo b_hi, then a_hi b_lo (each accumulator's order
    // is warp_gemm's; the tiles interleave)
    auto step = [&](int kk) {
      uint32_t ah[kMI][4], al[kMI][4], bh[kNI][2], bl[kNI][2];
#pragma unroll
      for (int j = 0; j < kNI / 2; ++j) {
        uint32_t v[2][2];
        if (kBT) {
          RowB{Bs, kBK}(kk, wn + 16 * j, v);
        } else {
          ColB{Bs, BN}(kk, wn + 16 * j, v);
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          split(v[e][0], bh[2 * j + e][0], bl[2 * j + e][0]);
          split(v[e][1], bh[2 * j + e][1], bl[2 * j + e][1]);
        }
      }
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi) {
        uint32_t av[4];
        if (kAT) {
          ColA{As, BM}(wm + 16 * mi, kk, av);
        } else {
          RowA{As, kBK}(wm + 16 * mi, kk, av);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) split(av[e], ah[mi][e], al[mi][e]);
      }
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
        for (int ni = 0; ni < kNI; ++ni) mma_tf32(big[mi][ni], ah[mi], bh[ni]);
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
        for (int ni = 0; ni < kNI; ++ni) mma_tf32(small[mi][ni], al[mi], bh[ni]);
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
        for (int ni = 0; ni < kNI; ++ni) mma_tf32(small[mi][ni], ah[mi], bl[ni]);
    };
    const int k0 = kbeg + kt * kBK;
    if (k0 + kBK <= kend) {  // a whole k-tile, branch-free
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 8) step(kk);
    } else {  // the ragged last one: its k-steps that reach K
      for (int kk = 0; k0 + kk < kend; kk += 8) step(kk);
    }
  }
  cp_wait<0>();
  __syncthreads();  // every warp is done with the ring: it holds the outputs now

  // out = the first + the second accumulator, through shared memory (rows
  // kLdT floats apart: the float2 stores of a warp's 16 lanes hit 32 banks)
  // to the epilogue, four consecutive outputs a thread, rows coalesced
  constexpr int kLdT = BN + 8;
  float* T = smem;
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi) {
#pragma unroll
    for (int ni = 0; ni < kNI; ++ni) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = wm + 16 * mi + g + 8 * hr, c = wn + 8 * ni + 2 * t;
        *reinterpret_cast<float2*>(T + r * kLdT + c) =
            make_float2(big[mi][ni][2 * hr] + small[mi][ni][2 * hr],
                        big[mi][ni][2 * hr + 1] + small[mi][ni][2 * hr + 1]);
      }
    }
  }
  __syncthreads();
  // this thread's quads: their operands' loads first, all in flight at
  // once, then the epilogues and stores
  constexpr int kQuads = BM * BN / 4, kIters = (kQuads + kThreads - 1) / kThreads;
  float4 bq[kIters], kq[kIters];
#pragma unroll
  for (int i = 0; i < kIters; ++i) {
    const int id = static_cast<int>(threadIdx.x) + i * kThreads;
    const int r = id / (BN / 4), c = id % (BN / 4) * 4;
    if ((kQuads % kThreads == 0 || id < kQuads) && m0 + r < M && n0 + c < N) {
      operands4<kEpi>(m0 + r, n0 + c, N, vec, bias, mask, ldm, bq[i], kq[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < kIters; ++i) {
    const int id = static_cast<int>(threadIdx.x) + i * kThreads;
    const int r = id / (BN / 4), c = id % (BN / 4) * 4;
    const int m = m0 + r, n = n0 + c;
    if ((kQuads % kThreads != 0 && id >= kQuads) || m >= M || n >= N) continue;
    const size_t at = kEpi == wide::kEpiPartial
                          ? (static_cast<size_t>(blockIdx.y) * M + m) * N + n
                          : static_cast<size_t>(m) * ldc + n;
    epilogue4<kEpi>(*reinterpret_cast<const float4*>(T + r * kLdT + c), bq[i], kq[i], n, N,
                    vec, C, at);
  }
}

template <int kMI, int kNI, int kWM, int kWN, bool kAT, bool kBT, int kEpi>
cudaError_t launch(const float* A, int lda, const float* B, int ldb, int M, int N, int K,
                   int k_chunk, const float* bias, const float* mask, int ldm, float* C,
                   int ldc, cudaStream_t stream) {
  constexpr int BM = kWM * kMI * 16, BN = kWN * kNI * 8;
  constexpr int smem = static_cast<int>(sizeof(float)) * kStages * (BM + BN) * kBK;
  static_assert(BM * (BN + 8) <= kStages * (BM + BN) * kBK, "the epilogue's tile fits the ring");
  auto* kernel = gemm3_kernel<kMI, kNI, kWM, kWN, kAT, kBT, kEpi>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int tiles_n = (N + BN - 1) / BN;
  const long long blocks = static_cast<long long>((M + BM - 1) / BM) * tiles_n;
  const int parts = (K + k_chunk - 1) / k_chunk;
  if (blocks > INT_MAX || parts > 65535) return cudaErrorInvalidConfiguration;
  // 16-B epilogue accesses where every row of C, the mask and the bias is
  // 16-B aligned
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vec = aligned(C) && (kEpi == wide::kEpiPartial ? N % 4 == 0 : ldc % 4 == 0) &&
                   (mask == nullptr || (aligned(mask) && ldm % 4 == 0)) &&
                   (bias == nullptr || aligned(bias));
  kernel<<<dim3(static_cast<unsigned>(blocks), parts), kWM * kWN * 32, smem, stream>>>(
      A, lda, B, ldb, M, N, K, k_chunk, tiles_n, bias, mask, ldm, C, ldc, vec);
  return cudaGetLastError();
}

// C = epi(A B) in 3xTF32 (see the top of this file); k chunks of k_chunk
// (one partial each with kEpiPartial).  The block tile by the shape: N <=
// 16 the narrow 128 x 16, a dW of at most 64 rows 64 x 64, else 128 x 64.
template <bool kAT, bool kBT, int kEpi>
cudaError_t gemm(const float* A, int lda, const float* B, int ldb, int M, int N, int K,
                 int k_chunk, const float* bias, const float* mask, int ldm, float* C,
                 int ldc, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0 || k_chunk <= 0 || lda % 4 || ldb % 4 ||
      reinterpret_cast<uintptr_t>(A) % 16 || reinterpret_cast<uintptr_t>(B) % 16) {
    return cudaErrorInvalidValue;
  }
  if (N <= 16) {
    return launch<1, 2, 8, 1, kAT, kBT, kEpi>(A, lda, B, ldb, M, N, K, k_chunk, bias, mask,
                                              ldm, C, ldc, stream);
  }
  if constexpr (kEpi == wide::kEpiPartial) {
    if (M <= 64) {
      return launch<2, 4, 2, 2, kAT, kBT, kEpi>(A, lda, B, ldb, M, N, K, k_chunk, bias, mask,
                                                ldm, C, ldc, stream);
    }
  }
  return launch<4, 4, 2, 2, kAT, kBT, kEpi>(A, lda, B, ldb, M, N, K, k_chunk, bias, mask,
                                            ldm, C, ldc, stream);
}

}  // namespace
}  // namespace wide3
