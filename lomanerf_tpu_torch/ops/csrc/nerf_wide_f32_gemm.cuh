// The exact f32 GEMM of the wide NeRF chain (nerf_wide_chain.cuh, compute
// dtype f32) and of the wide image-field route's "highest" tier
// (field_wide.cu), on Hopper's FMA pipes (sm_90a): gemm()'s f32 branch
// (nerf_wide_gemm.cuh) in every form it takes.
//
//   C(m, n) = epi(sum_k A(m, k) B(k, n))                 (exact f32 FMAs)
//   A(m, k) = kAT ? A[k * lda + m] : A[m * lda + k]
//   B(k, n) = kBT ? B[n * ldb + k] : B[k * ldb + n]
//
// with nerf_wide_gemm.cuh's epilogues (kEpiBiasRelu, kEpiMask, kEpiPartial,
// kEpiSigmoid, kEpiSigmoidGrad; the mask at C's row stride ldc), any M, N,
// K, lda, ldb and ldc, and split-K by the caller's k_chunk.
//
// These are the layer products of the TPU kernels' _mlp_forward and
// _bwd_from_dcol (lomanerf_tpu/ops/fused_nerf.py:79, :168) inside
// _nerf_train_kernel_W (:1477), _nerf_forward_kernel_W (:1515),
// _nerf_backward_kernel_W (:1537) and their per-ray twins (:140, :223,
// :248) at f32 compute, and of _forward_acts (lomanerf_tpu/ops/
// fused_mlp.py:35) inside _fwd_kernel (:45) and _bwd_kernel (:51) at
// precision "highest".
//
// What bounds it on this card: f32 arithmetic outside the tensor cores
// (67 TFLOP/s).  Exact f32 products cannot use them (3xTF32 is the "high"
// tier, another result).  One hidden layer of the 4x256 field at 512x512,
// 262,144 x 256 . 256 x 256, is 34.4 GFLOP (0.513 ms) against 0.54 GB of
// operands and output (0.16 ms); one f32 8x1024 gradient chunk's layer,
// 419,200 x 1024 . 1024 x 1024, 879 GFLOP (13.1 ms).  An SM issues one
// warp instruction a cycle per scheduler, so the FFMAs must leave few issue
// slots to loads, addresses and barriers.
//
// The design:
//   * a block of 256 threads (64 for a head's dW) owns a BM x BN output
//     tile, each thread TM x TN outputs in 4 x 4 groups (rows ty*4 + r and, for TM = 8, 4*TY
//     further; columns likewise), so that a warp's fragment reads are
//     contiguous 16-B vectors and its float4 stores leave in 128-B rows:
//     128 x 128 (8 x 8 a thread: 64 FFMAs to 4 LDS.128 a k), 64 x 64 (4 x
//     4, four blocks an SM) for a split-K dW whose 128 x 128 grid would
//     leave more than a quarter of the SMs idle (the encoding's 34 or 40
//     rows), and 256 x 16 (4 x 4) for N <= 16 (the heads, whose 3 columns
//     would leave a 128-column tile nearly idle; their dW 64 x 16, so
//     that a 256-wide layer still spreads over 4 blocks a k-chunk);
//   * k-tiles of kFK = 32 of both operands are staged by cp.async through
//     a kFStages-deep ring in dynamic shared memory, with one barrier a
//     k-tile: the next two tiles' copies fly while this one multiplies.
//     Where the operand's rows are 16-B aligned (ld a multiple of 4, base
//     aligned, the k-chunk edges on multiples of 4 along a contiguous k)
//     each copy moves 16 B, zero-filled past the edges by its src-size;
//     elsewhere 4 B (the heads' row stride of 3);
//   * each operand stays in shared memory in the order its source holds it,
//     so no thread transposes: one with m or n contiguous ([k][x]) as is,
//     read by LDS.128 along x; one with k contiguous ([x][k]) in rows of 32
//     whose 16-B units are XOR-swizzled by (x >> 2) & 7, read by LDS.128
//     along k (four k of one row), so a warp's reads of 4 or 8 rows 4
//     apart hit distinct banks.  The inner loop takes four k at a time:
//     B's 4 x TN values in registers, then A row by row ([m][k]) or k by k
//     ([k][m]);
//   * the epilogue goes through shared memory (the ring, free by then):
//     each thread takes four-column groups down the tile's rows, loads all
//     their mask entries at once (d_h and the head's d_z read one), applies
//     the epilogue's arithmetic and stores 16 B a group where C's rows
//     (and the mask's and bias's) are 16-B aligned, so rows leave
//     coalesced.
//
// Bits.  Each output is one thread's fmaf chain from +0 over ascending k in
// [kbeg, kend), then zero terms (+0 x +0) up to the next multiple of 8
// from kbeg: full k-tiles run all 32 k, the last one its k up to that
// multiple of 8 (a zero term turns a -0 sum into +0, so no more and no
// fewer are added: chip_smoke.py's F32_DIGESTS pin these bits).  The tile
// shape, the staging and the thread of an output do not enter the sum:
// repeat launches are bit-identical.

#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "nerf_wide_gemm.cuh"

namespace wide {
namespace {

constexpr int kFK = 32, kFStages = 3;

__device__ __forceinline__ uint32_t smem_addr(const float* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 B (src_bytes of them read, the rest zero-filled) and 4 B (0 or 4)
__device__ __forceinline__ void async_copy16(float* dst, const float* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void async_copy4(float* dst, const float* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int kPending>
__device__ __forceinline__ void async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Where element (x, k) of a staged operand tile lies: [k][x] as is
// (kXMajor false: x contiguous in memory), or [x][k] in rows of kFK with
// the 16-B units of 4 k swizzled by (x >> 2) & 7.
template <int BX, bool kXMajor>
__device__ __forceinline__ int tile_at(int x, int k) {
  return kXMajor ? x * kFK + ((((k >> 2) ^ (x >> 2)) & 7) << 2) + (k & 3) : k * BX + x;
}

// The BX x kFK tile of operand X at (x0, k0) into S: X holds (x, k) at
// X[x * ld + k] (kXMajor) or X[k * ld + x]; zero past x = xmax and k =
// kend.  vec: 16-B copies of 4 elements along the contiguous dimension,
// else 4-B ones.
template <int BX, bool kXMajor, int kThreads>
__device__ __forceinline__ void stage_tile(float* S, const float* __restrict__ X, int ld, int x0,
                                           int xmax, int k0, int kend, bool vec) {
  const int t = threadIdx.x;
  if (vec) {
    constexpr int kRun = kXMajor ? kFK / 4 : BX / 4, kChunks = BX * kFK / 4;
#pragma unroll
    for (int i = 0; i < (kChunks + kThreads - 1) / kThreads; ++i) {
      const int id = t + i * kThreads;
      if (kChunks % kThreads != 0 && id >= kChunks) break;
      const int a = id / kRun, b = id % kRun * 4;  // (x, k) or (k, x) of the first element
      const int x = kXMajor ? a : b, k = kXMajor ? b : a;
      const int gx = x0 + x, gk = k0 + k;
      const int valid = kXMajor ? (gx < xmax ? min(max(kend - gk, 0), 4) : 0)
                                : (gk < kend ? min(max(xmax - gx, 0), 4) : 0);
      const float* src = kXMajor ? X + static_cast<size_t>(gx) * ld + gk
                                 : X + static_cast<size_t>(gk) * ld + gx;
      async_copy16(S + tile_at<BX, kXMajor>(x, k), valid > 0 ? src : X, 4 * valid);
    }
  } else {
    constexpr int kElems = BX * kFK;
#pragma unroll 4
    for (int i = 0; i < kElems / kThreads; ++i) {
      const int id = t + i * kThreads;
      const int x = kXMajor ? id / kFK : id % BX, k = kXMajor ? id % kFK : id / BX;
      const int gx = x0 + x, gk = k0 + k;
      const bool ok = gx < xmax && gk < kend;
      const float* src = kXMajor ? X + static_cast<size_t>(gx) * ld + gk
                                 : X + static_cast<size_t>(gk) * ld + gx;
      async_copy4(S + tile_at<BX, kXMajor>(x, k), ok ? src : X, ok ? 4 : 0);
    }
  }
}

// The thread's i-th row (or column) of the block tile: 4 x 4 groups, group
// g at 4 * T g, ty * 4 within it.
template <int T>
__device__ __forceinline__ int own(int ty, int i) {
  return (i >> 2) * 4 * T + ty * 4 + (i & 3);
}

// Four k (k-tile columns 4q .. 4q + 3) into the thread's TM x TN sums, in
// ascending k for every output.  A [x][k] operand's rows of the thread all
// share one swizzle, t & 7 for its ty or tx (own(t, i) >> 2 is t plus a
// multiple of 8), so unit q of each lies at the same offset.
template <int BM, int BN, int TM, int TN, bool kAT, bool kBT>
__device__ __forceinline__ void four_k(const float* As, const float* Bs, int q, int ty, int tx,
                                       float (&acc)[TM][TN]) {
  constexpr int TY = BM / TM, TX = BN / TN;
  static_assert((TM == 4 || TY % 8 == 0) && (TN == 4 || TX % 8 == 0), "one swizzle a thread");
  const int ua = (q ^ (ty & 7)) << 2, ub = (q ^ (tx & 7)) << 2;
  if (kAT && !kBT) {  // both [k][x]: k by k, TM + TN values a k
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int k = 4 * q + kk;
      float a[TM], b[TN];
#pragma unroll
      for (int g = 0; g < TM / 4; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(As + k * BM + own<TY>(ty, 4 * g));
        a[4 * g] = v.x, a[4 * g + 1] = v.y, a[4 * g + 2] = v.z, a[4 * g + 3] = v.w;
      }
#pragma unroll
      for (int g = 0; g < TN / 4; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(Bs + k * BN + own<TX>(tx, 4 * g));
        b[4 * g] = v.x, b[4 * g + 1] = v.y, b[4 * g + 2] = v.z, b[4 * g + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    return;
  }
  // B's four k of the thread's TN columns, then A's rows (or k) against them
  float b[4][TN];
  if (kBT) {
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const float4 v = *reinterpret_cast<const float4*>(Bs + own<TX>(tx, j) * kFK + ub);
      b[0][j] = v.x, b[1][j] = v.y, b[2][j] = v.z, b[3][j] = v.w;
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int g = 0; g < TN / 4; ++g) {
        const float4 v =
            *reinterpret_cast<const float4*>(Bs + (4 * q + kk) * BN + own<TX>(tx, 4 * g));
        b[kk][4 * g] = v.x, b[kk][4 * g + 1] = v.y, b[kk][4 * g + 2] = v.z,
        b[kk][4 * g + 3] = v.w;
      }
  }
  if (kAT) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float a[TM];
#pragma unroll
      for (int g = 0; g < TM / 4; ++g) {
        const float4 v =
            *reinterpret_cast<const float4*>(As + (4 * q + kk) * BM + own<TY>(ty, 4 * g));
        a[4 * g] = v.x, a[4 * g + 1] = v.y, a[4 * g + 2] = v.z, a[4 * g + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[kk][j], acc[i][j]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(As + own<TY>(ty, i) * kFK + ua);
      const float a[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[kk], b[kk][j], acc[i][j]);
    }
  }
}

// flags of the launch: 16-B copies of A, of B; 16-B epilogue accesses
constexpr int kVecA = 1, kVecB = 2, kVecC = 4;

template <int BM, int BN, int TM, int TN, bool kAT, bool kBT, int kEpi>
// eight blocks an SM at 64 x 16 (64 threads), four at 64 x 64; at 128 x 128
// two (96 KB of ring each) for the forward forms, one for d_h and dW, whose
// 8 x 8 tiles need more than 128 registers without spilling (measured: d_h
// 9-12% and dW 4% faster so)
__global__ void __launch_bounds__((BM / TM) * (BN / TN),
                                  (BM / TM) * (BN / TN) == 64 ? 8
                                  : (BM + BN) * kFK * kFStages * 4 <= 56 * 1024
                                      ? 4 : (BM == 128 && (kAT || kBT) ? 1 : 2))
gemm_f32_kernel(const float* __restrict__ A, int lda, const float* __restrict__ B, int ldb,
                int M, int N, int K, int k_chunk, int tiles_n, const float* __restrict__ bias,
                const float* __restrict__ mask, float* __restrict__ C, int ldc, int flags) {
  constexpr int TY = BM / TM, TX = BN / TN;
  constexpr int kThreads = TY * TX;
  static_assert(kThreads % 32 == 0 && TM % 4 == 0 && TN % 4 == 0, "whole warps of 4x4 groups");
  constexpr int WX = TX < 8 ? TX : 8, WY = 32 / WX;  // a warp: WY x WX threads
  constexpr int kAF = BM * kFK, kStageF = (BM + BN) * kFK;
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ty = warp / (TX / WX) * WY + lane / WX, tx = warp % (TX / WX) * WX + lane % WX;
  const int m0 = blockIdx.x / tiles_n * BM, n0 = blockIdx.x % tiles_n * BN;
  const int kbeg = blockIdx.y * k_chunk, kend = min(K, kbeg + k_chunk);
  const int n_kt = (kend - kbeg + kFK - 1) / kFK;

  auto load = [&](int kt) {
    float* As = smem + (kt % kFStages) * kStageF;
    const int k0 = kbeg + kt * kFK;
    stage_tile<BM, !kAT, kThreads>(As, A, lda, m0, M, k0, kend, flags & kVecA);
    stage_tile<BN, kBT, kThreads>(As + kAF, B, ldb, n0, N, k0, kend, flags & kVecB);
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

#pragma unroll
  for (int s = 0; s < kFStages - 1; ++s) {
    if (s < n_kt) load(s);
    async_commit();
  }
  for (int kt = 0; kt < n_kt; ++kt) {
    async_wait<kFStages - 2>();  // k-tile kt has landed (this thread's copies) ...
    __syncthreads();             // ... every thread's; k-tile kt - 1 is read
    if (kt + kFStages - 1 < n_kt) load(kt + kFStages - 1);
    async_commit();
    const float* As = smem + (kt % kFStages) * kStageF;
    const float* Bs = As + kAF;
    const int k0 = kbeg + kt * kFK;
    if (k0 + kFK <= kend) {
#pragma unroll
      for (int q = 0; q < kFK / 4; ++q) four_k<BM, BN, TM, TN, kAT, kBT>(As, Bs, q, ty, tx, acc);
    } else {  // the last k-tile: its k up to the next multiple of 8 from kbeg
      const int nq = (kend - k0 + 7) / 8 * 2;
      for (int q = 0; q < nq; ++q) four_k<BM, BN, TM, TN, kAT, kBT>(As, Bs, q, ty, tx, acc);
    }
  }

  // the epilogue through shared memory (the ring, free once every warp is
  // past its last k-tile): each thread's sums into the BM x BN tile, then
  // each thread takes four-column groups of rows in order (one group's
  // columns are the same in every row it takes), their mask loads all in
  // flight before any is used, and stores 16 B a group where it can
  constexpr int kLdT = BN < 32 ? BN + 4 : BN;  // the narrow tile's rows 5 units apart
  constexpr int kGroups = BM * BN / 4, kIters = kGroups / kThreads;
  static_assert(BM * kLdT <= kFStages * (BM + BN) * kFK && kGroups % kThreads == 0,
                "the tile fits the ring, whole groups a thread");
  async_wait<0>();
  __syncthreads();
  float* T = smem;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int g = 0; g < TN / 4; ++g) {
      *reinterpret_cast<float4*>(T + own<TY>(ty, i) * kLdT + own<TX>(tx, 4 * g)) =
          make_float4(acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2], acc[i][4 * g + 3]);
    }
  __syncthreads();

  constexpr bool kBias = kEpi == kEpiBiasRelu || kEpi == kEpiSigmoid || kEpi == kEpiSigmoidGrad;
  constexpr bool kMask = kEpi == kEpiMask || kEpi == kEpiSigmoidGrad;
  const bool vec = flags & kVecC;
  const int c = threadIdx.x % (BN / 4) * 4, r0 = threadIdx.x / (BN / 4);
  constexpr int kRowStep = kThreads / (BN / 4);
  const int n = n0 + c;
  const bool v4 = vec && n + 3 < N;
  float bv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (kBias && n < N) {
    if (v4) {
      load4(bias + n, bv);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) bv[e] = n + e < N ? bias[n + e] : 0.0f;
    }
  }
  auto at_of = [&](int m) {
    return kEpi == kEpiPartial ? (static_cast<size_t>(blockIdx.y) * M + m) * N + n
                               : static_cast<size_t>(m) * ldc + n;
  };
  float mv[kMask ? kIters : 1][4];
  if (kMask) {
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int m = m0 + r0 + it * kRowStep;
      mv[it][0] = mv[it][1] = mv[it][2] = mv[it][3] = 0.0f;
      if (m >= M || n >= N) continue;
      if (v4) {
        load4(mask + at_of(m), mv[it]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (n + e < N) mv[it][e] = mask[at_of(m) + e];
        }
      }
    }
  }
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int r = r0 + it * kRowStep, m = m0 + r;
    if (m >= M || n >= N) continue;
    const float4 t4 = *reinterpret_cast<const float4*>(T + r * kLdT + c);
    float o[4] = {t4.x, t4.y, t4.z, t4.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (kEpi == kEpiBiasRelu) {
        o[e] = fmaxf(o[e] + bv[e], 0.0f);
      } else if (kEpi == kEpiMask) {
        o[e] = mv[kMask ? it : 0][e] > 0.0f ? o[e] : 0.0f;
      } else if (kEpi == kEpiSigmoid) {
        o[e] = sigmoidf(o[e] + bv[e]);
      } else if (kEpi == kEpiSigmoidGrad) {
        const float y = sigmoidf(o[e] + bv[e]);
        o[e] = mv[kMask ? it : 0][e] * y * (1.0f - y);
      }
    }
    const size_t at = at_of(m);
    if (v4) {
      *reinterpret_cast<float4*>(C + at) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (n + e < N) C[at + e] = o[e];
      }
    }
  }
}

template <int BM, int BN, int TM, int TN, bool kAT, bool kBT, int kEpi>
cudaError_t f32_launch(const float* A, int lda, const float* B, int ldb, int M, int N, int K,
                       int k_chunk, const float* bias, const float* mask, float* C, int ldc,
                       cudaStream_t stream) {
  constexpr int smem = static_cast<int>(sizeof(float)) * kFStages * (BM + BN) * kFK;
  auto* kernel = gemm_f32_kernel<BM, BN, TM, TN, kAT, kBT, kEpi>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  if (err != cudaSuccess) return err;
  const int tiles_n = (N + BN - 1) / BN;
  const long long blocks = static_cast<long long>((M + BM - 1) / BM) * tiles_n;
  const int parts = (K + k_chunk - 1) / k_chunk;
  if (blocks > INT_MAX || parts > 65535) return cudaErrorInvalidConfiguration;
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  // 16-B copies where every row start of the tile is 16-B aligned: along k
  // ([x][k] operands) the k-chunk edges must be too
  const bool k_edges = parts == 1 || k_chunk % 4 == 0;
  int flags = 0;
  if (aligned(A) && lda % 4 == 0 && (kAT || k_edges)) flags |= kVecA;
  if (aligned(B) && ldb % 4 == 0 && (!kBT || k_edges)) flags |= kVecB;
  if (aligned(C) && (kEpi == kEpiPartial ? N % 4 == 0 : ldc % 4 == 0) &&
      (mask == nullptr || aligned(mask)) && (bias == nullptr || aligned(bias))) {
    flags |= kVecC;
  }
  kernel<<<dim3(static_cast<unsigned>(blocks), parts), (BM / TM) * (BN / TN), smem, stream>>>(
      A, lda, B, ldb, M, N, K, k_chunk, tiles_n, bias, mask, C, ldc, flags);
  return cudaGetLastError();
}

// The block tile by the shape (see the top of this file): N <= 16 the
// narrow 256 x 16 (a head's dW 64 x 16 of 64 threads); a split-K dW whose
// 128 x 128 grid would leave more than a quarter of the SMs idle, 64 x 64;
// else 128 x 128.
template <bool kAT, bool kBT, int kEpi>
cudaError_t f32_gemm(const float* A, int lda, const float* B, int ldb, int M, int N, int K,
                     int k_chunk, const float* bias, const float* mask, void* C, int ldc,
                     cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0 || k_chunk <= 0) return cudaErrorInvalidValue;
  float* out = static_cast<float*>(C);
  if (N <= 16) {
    if constexpr (kEpi == kEpiPartial) {  // M is a layer's width: 64 rows a block
      return f32_launch<64, 16, 4, 4, kAT, kBT, kEpi>(A, lda, B, ldb, M, N, K, k_chunk, bias,
                                                      mask, out, ldc, stream);
    }
    return f32_launch<256, 16, 4, 4, kAT, kBT, kEpi>(A, lda, B, ldb, M, N, K, k_chunk, bias,
                                                     mask, out, ldc, stream);
  }
  if constexpr (kEpi == kEpiPartial) {
    static int sms = 0;
    if (sms == 0) {
      int dev = 0;
      cudaError_t err = cudaGetDevice(&dev);
      if (err == cudaSuccess) {
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      }
      if (err != cudaSuccess) return err;
    }
    const long long big = static_cast<long long>((M + 127) / 128) * ((N + 127) / 128) *
                          ((K + k_chunk - 1) / k_chunk);
    if (4 * big < 3LL * sms) {
      return f32_launch<64, 64, 4, 4, kAT, kBT, kEpi>(A, lda, B, ldb, M, N, K, k_chunk, bias,
                                                      mask, out, ldc, stream);
    }
  }
  return f32_launch<128, 128, 8, 8, kAT, kBT, kEpi>(A, lda, B, ldb, M, N, K, k_chunk, bias,
                                                    mask, out, ldc, stream);
}

}  // namespace
}  // namespace wide
