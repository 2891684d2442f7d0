// The bf16 wide render's MLP in one persistent kernel per ray chunk, on
// Hopper's warpgroup tensor cores (wgmma) with the weights fed by TMA: the
// encoding and every hidden layer of a 128-row tile, the activations kept
// in shared memory, only the last hidden layer's output H_{L-1} written to
// device memory (row-major (rows, pw) bf16, what composite_kernel reads).
//
// Replaces, for the bf16 compute dtype, the layer-by-layer forward of the
// render (nerf_wide_chain.cuh:forward_layers: encode_kernel, then one
// gemm_mma_kernel per hidden layer with every activation through device
// memory): the counterpart of the TPU kernels' _mlp_forward on values in
// VMEM (lomanerf_tpu/ops/fused_nerf.py:_nerf_forward_kernel_W and, with
// kPerRay, _nerf_forward_kernel).
//
// What bounds it on this card: arithmetic.  The flagship's 33 -> 256 x 7
// MLP is 401,664 MACs a sample, 66 TFLOP an 800x800 frame at S = 128: 67 ms
// at the bf16 peak, against 42 GB of H_{L-1} written (13 ms at 3.35 TB/s).
// The layer-by-layer chain moved ~600 GB a frame through device memory
// before any arithmetic.  This kernel runs at ~28% of that peak on an H100
// (chip_smoke.py phase 9): each consumer warpgroup waits for every wgmma
// group before its f32 promotion adds, and the tensor cores idle meanwhile.
//
// The design:
//   * one block per SM, striding over 128-row tiles (row = ray * S + s of
//     the chunk); two consumer warpgroups, each owning 64 rows of the tile,
//     and a producer warpgroup whose first thread issues the TMA copies and
//     whose registers setmaxnreg hands to the consumers (40 and 232);
//   * two activation buffers of 128 rows x pw bf16 in shared memory (2 x 64
//     KB at pw = 256), K-major ([row][k]) in the 128-byte swizzle: 64-column
//     blocks of 128 rows, 16-byte chunk c of row r stored at chunk c ^ (r &
//     7), the wgmma A layout.  The consumers write them with plain stores
//     (the encoding, then each layer's epilogue into the other buffer), then
//     fence.proxy.async and a barrier of the warpgroup before any wgmma
//     reads them;
//   * the weights W_l, (pw, pw) row-major [k][n] in the stack: an MN-major
//     B operand, streamed by TMA in 32-row x 128-column k-slices (two 32 x
//     64 boxes, the 128-byte swizzle) through a ring of kMlpStages stages
//     with full / empty mbarriers; both consumer warpgroups read every
//     stage, and each consumer warp releases it after its own wait.  Layer
//     0's map has kc rows, so TMA's zero fill gives the rows past kc, as
//     gemm_mma_kernel's guarded loads did; all L - 1 hidden weight matrices
//     (896 KB for the flagship) stay in L2 across tiles;
//   * the two consumer warpgroups take turns to issue their products (named
//     barriers), so that one's wgmma run while the other adds its k-steps
//     into f32 (in step, both would add while the tensor cores idle);
//   * each consumer computes its 64 rows x pw outputs in passes of 128
//     columns (wgmma m64n128k16: 64 f32 accumulators and two sets of 64 for
//     k-steps), the k-slices of a pass in ascending k;
//   * every 32-deep k-step is two wgmma into a fresh set (scale-d 0 on the
//     first); two k-steps go into one wgmma group, one wait, then IEEE f32
//     adds of each set into the running sum in turn: gemm_mma_kernel's
//     promotion and order (nerf_wide_gemm.cuh) and the dW stage's
//     (nerf_wide_dw.cuh), so each pre-activation keeps its bits; the
//     epilogue is the same ops in the same order, bf16(ReLU(acc + b[n]));
//   * the encoding is encode_kernel's arithmetic (nerf_wide_common.cuh: the
//     point by __fadd_rn / __fmul_rn, IEEE sincosf, the same columns), two
//     threads a row, zeros up to the end of layer 0's last k-step; rows past
//     the chunk are encoded as zeros and their stores guarded.
// Every output is one thread's fixed sequence of k-steps: repeat launches
// are bit-identical, and so is the output to the chain it replaces.

#pragma once

#include <algorithm>
#include <type_traits>

#include "nerf_wide_dw.cuh"

namespace wide {
namespace {

constexpr int kMlpRows = 128;  // rows per tile: two consumer warpgroups of 64
constexpr int kMlpBK = 32;     // weight rows per stage: one promotion step
constexpr int kMlpBN = 128;    // output columns per pass
constexpr int kMlpStages = 4;  // of 2 to 8 stages, 4 ran quickest on an H100
constexpr int kMlpStageBytes = kMlpBK * kMlpBN * 2;  // two 32 x 64 boxes: 8 KB
constexpr int kMlpThreads = 3 * 128;  // 2 consumer warpgroups + the producer's
static_assert(kMlpStages >= 2, "a wgmma group holds two k-steps' stages");

template <int kPW>
constexpr int mlp_smem_bytes() {  // two activation buffers, the ring, alignment
  return 2 * kMlpRows * kPW * 2 + kMlpStages * kMlpStageBytes + 1024;
}

// byte offset of (row r < 128, column k) in an activation buffer
__device__ __forceinline__ uint32_t act_at(int r, int k) {
  return (k >> 6) * (kMlpRows * 128) + r * 128 + ((((k & 63) >> 3) ^ (r & 7)) << 4) +
         (k & 7) * 2;
}

// wgmma descriptor of a K-major operand in the 128-byte swizzle: 8-row
// groups 1024 bytes apart (the stride byte offset); the leading offset is
// unused for a 16-deep k-step inside one 128-byte row.  A k-offset inside
// the row is added to the start address, the swizzle applied on top.
__device__ __forceinline__ uint64_t k_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | static_cast<uint64_t>(1) << 16 |
         static_cast<uint64_t>(1024 >> 4) << 32 | static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// barrier of the 128 threads of consumer warpgroup wg (ids 1, 2; 0 is
// __syncthreads')
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;" ::"r"(wg + 1) : "memory");
}

// The two consumer warpgroups take turns to issue their wgmma (ids 3, 4):
// warpgroup wg waits for its turn, issues, then hands the turn over, so that
// one warpgroup's products run on the tensor cores while the other adds.
__device__ __forceinline__ void wait_turn(int wg) {
  asm volatile("bar.sync %0, 256;" ::"r"(wg + 3) : "memory");
}
__device__ __forceinline__ void pass_turn(int wg) {
  asm volatile("bar.arrive %0, 256;" ::"r"((wg ^ 1) + 3) : "memory");
}

// The encoding of the warpgroup's 64 rows of the tile starting at chunk row
// tile_row into buf, columns [0, cols): two threads a row (t even: the point
// and the even octaves; t odd: the odd octaves; the zeros alternate).
template <bool kPerRay>
__device__ __forceinline__ void encode_rows(uint8_t* buf, int wg, int t, int tile_row,
                                            int rows, int S, const float* origins,
                                            const float* directions, const float* ts,
                                            int nf, int cols) {
  const int r = wg * 64 + (t >> 1), half = t & 1;
  const int row = tile_row + r;
  auto put = [&](int k, float v) {
    *reinterpret_cast<__nv_bfloat16*>(buf + act_at(r, k)) = __float2bfloat16_rn(v);
  };
  int zeros = 3 + 6 * nf;
  if (row < rows) {
    const int ray = row / S, s = row - ray * S;
    const float t_s = ts[kPerRay ? row : s];
    float p[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      p[c] = __fadd_rn(origins[3 * ray + c], __fmul_rn(directions[3 * ray + c], t_s));
    }
    if (half == 0) {
#pragma unroll
      for (int c = 0; c < 3; ++c) put(c, p[c]);
    }
    for (int i = half; i < nf; i += 2) {
      const float scale = ldexpf(1.0f, i);  // 2^i, exact
      float sn[3], cs[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) sincosf(__fmul_rn(scale, p[c]), &sn[c], &cs[c]);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        put(3 + 6 * i + c, sn[c]);
        put(6 + 6 * i + c, cs[c]);
      }
    }
  } else {
    zeros = 0;  // a row past the chunk: zeros throughout
  }
  for (int k = zeros + half; k < cols; k += 2) put(k, 0.0f);
}

// grid min(tiles, SMs), block kMlpThreads, dynamic shared memory
// mlp_smem_bytes<kPW>(); tm_w0 maps W_0's first kc rows, tm_w the whole
// (L * kPW, kPW) stack, both in 32 x 64 boxes (dw_map)
template <int kPW, bool kPerRay>
__global__ void __launch_bounds__(kMlpThreads, 1)
mlp_wgmma_kernel(const __grid_constant__ CUtensorMap tm_w0,
                 const __grid_constant__ CUtensorMap tm_w, const float* __restrict__ bias,
                 const float* __restrict__ origins, const float* __restrict__ directions,
                 const float* __restrict__ ts, __nv_bfloat16* __restrict__ out, int rows,
                 int S, int L, int kc, int nf) {
  constexpr int kActBytes = kMlpRows * kPW * 2;
  constexpr int kPasses = kPW / kMlpBN;
  extern __shared__ uint8_t mlp_raw[];
  __shared__ __align__(8) uint64_t full[kMlpStages], empty[kMlpStages];
  // the buffers and the ring start at a shared-memory address that is a
  // multiple of 1024: act[0], act[1], then the stages
  uint8_t* act = mlp_raw + ((1024 - (smem_u32(mlp_raw) & 1023)) & 1023);
  uint8_t* ring = act + 2 * kActBytes;
  const int n_tiles = (rows + kMlpRows - 1) / kMlpRows;
  const int n_k0 = (kc + kMlpBK - 1) / kMlpBK;  // layer 0's k-steps
  const int wg = threadIdx.x >> 7;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kMlpStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // the roles never reconverge, so that setmaxnreg moves the producer's
  // registers to the consumers: 128 x 40 + 256 x 232 = 384 x 168
  if (wg == 2) {  // the producer warpgroup: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (threadIdx.x == 256) {
      int it = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        for (int l = 0; l < L - 1; ++l) {
          const CUtensorMap* map = l == 0 ? &tm_w0 : &tm_w;
          const int n_k = l == 0 ? n_k0 : kPW / kMlpBK;
          for (int pass = 0; pass < kPasses; ++pass) {
            for (int k = 0; k < n_k; ++k, ++it) {
              const int s = it % kMlpStages;
              if (it >= kMlpStages) mbar_wait(&empty[s], ((it / kMlpStages) - 1) & 1);
              uint8_t* st = ring + s * kMlpStageBytes;
              const int row = l * kPW + k * kMlpBK;  // layer 0: rows of its own map
              mbar_expect_tx(&full[s], kMlpStageBytes);
              tma_load(st, map, pass * kMlpBN, row, &full[s]);
              tma_load(st + kMlpStageBytes / 2, map, pass * kMlpBN + 64, row, &full[s]);
            }
          }
        }
      }
    }
  } else {  // consumer warpgroup wg: rows 64 wg .. 64 wg + 63 of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
    const int t = threadIdx.x & 127, lane = t & 31;
    // the m64n128 accumulator layout: warp w of the group holds rows 16 w ..
    // 16 w + 15; register 4 j + q is row lane / 4 (+ 8 for q >= 2), column
    // 8 j + 2 (lane % 4) (+ 1 for odd q)
    const int r = wg * 64 + (t >> 5) * 16 + (lane >> 2);
    const uint32_t act_s = smem_u32(act), ring_s = smem_u32(ring);
    float acc[64], ks0[64], ks1[64];  // the running sum, two fresh k-step sets
#pragma unroll
    for (int i = 0; i < 64; ++i) ks0[i] = ks1[i] = 0.0f;
    if (wg == 1) pass_turn(wg);  // warpgroup 0 issues first
    int it = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int tile_row = tile * kMlpRows;
      encode_rows<kPerRay>(act, wg, t, tile_row, rows, S, origins, directions, ts, nf,
                           n_k0 * kMlpBK);
      fence_async_smem();
      warpgroup_sync(wg);
      for (int l = 0; l < L - 1; ++l) {
        // this warpgroup's rows of the layer's input, and the other buffer
        const uint32_t in = act_s + (l & 1) * kActBytes + wg * 64 * 128;
        uint8_t* nxt = act + ((l + 1) & 1) * kActBytes;
        const int n_k = l == 0 ? n_k0 : kPW / kMlpBK;
        const bool last = l == L - 2;
        const float* bl = bias + l * kPW;
        // k-step k's two wgmma (weight rows 0-15, then 16-31 of its stage,
        // 2 x 1024 bytes further; columns 32 k .. 32 k + 31 of the input:
        // 64-column block k / 2, byte 64 (k % 2)) into the fresh set ks
        auto issue = [&](float (&ks)[64], int k) {
          const int s = (it + k) % kMlpStages;
          mbar_wait(&full[s], ((it + k) / kMlpStages) & 1);
          const uint32_t a = in + (k >> 1) * (kMlpRows * 128) + (k & 1) * 64;
          const uint32_t b = ring_s + s * kMlpStageBytes;
          wgmma_m64n128<0>(ks, k_desc(a), mn_desc(b, kMlpStageBytes / 2), 0);
          wgmma_m64n128<0>(ks, k_desc(a + 32), mn_desc(b + 2048, kMlpStageBytes / 2), 1);
        };
        // k-step k is summed: its stage is free again (one arrival a warp)
        auto release = [&](int k) {
          if (lane == 0) mbar_arrive(&empty[(it + k) % kMlpStages]);
        };
        for (int pass = 0; pass < kPasses; ++pass) {
#pragma unroll
          for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
          // two k-steps a wait: both sets in one wgmma group, then the f32
          // adds in ascending k (a lone last k-step alone)
          for (int k = 0; k < n_k; k += 2) {
            const bool two = k + 1 < n_k;
            fence_regs(ks0);
            fence_regs(ks1);
            wait_turn(wg);
            asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
            issue(ks0, k);
            if (two) issue(ks1, k + 1);
            asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
            pass_turn(wg);
            asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
            fence_regs(ks0);
            fence_regs(ks1);
            release(k);
#pragma unroll
            for (int q = 0; q < 64; ++q) acc[q] += ks0[q];
            if (two) {
              release(k + 1);
#pragma unroll
              for (int q = 0; q < 64; ++q) acc[q] += ks1[q];
            }
          }
          it += n_k;
          // the epilogue: bf16(ReLU(acc + b[n])), column pairs (n, n + 1)
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int n = pass * kMlpBN + j * 8 + (lane & 3) * 2;
            const float2 bn = *reinterpret_cast<const float2*>(bl + n);
            const __nv_bfloat162 lo = __floats2bfloat162_rn(fmaxf(acc[4 * j] + bn.x, 0.0f),
                                                            fmaxf(acc[4 * j + 1] + bn.y, 0.0f));
            const __nv_bfloat162 hi = __floats2bfloat162_rn(
                fmaxf(acc[4 * j + 2] + bn.x, 0.0f), fmaxf(acc[4 * j + 3] + bn.y, 0.0f));
            if (!last) {
              *reinterpret_cast<__nv_bfloat162*>(nxt + act_at(r, n)) = lo;
              *reinterpret_cast<__nv_bfloat162*>(nxt + act_at(r + 8, n)) = hi;
            } else {
              const int g = tile_row + r;
              if (g < rows) {
                *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(g) * kPW + n) = lo;
              }
              if (g + 8 < rows) {
                *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(g + 8) * kPW + n) =
                    hi;
              }
            }
          }
        }
        // the layer's output is visible to the next layer's wgmma, and this
        // layer's input is free for the one after
        fence_async_smem();
        warpgroup_sync(wg);
      }
    }
  }
}

template <int kPW, bool kPerRay>
cudaError_t mlp_launch(const __nv_bfloat16* W, const float* b, const float* ts,
                       const float* origins, const float* directions, __nv_bfloat16* out,
                       int rows, int S, int L, int kc, int nf, cudaStream_t stream) {
  constexpr int smem = mlp_smem_bytes<kPW>();
  static_assert(smem <= 227 * 1024, "the buffers and the ring exceed a block's shared memory");
  CUtensorMap tm_w0, tm_w;
  cudaError_t err = dw_map(&tm_w0, W, kPW, kc, kPW);
  if (err == cudaSuccess) err = dw_map(&tm_w, W, kPW, L * kPW, kPW);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(mlp_wgmma_kernel<kPW, kPerRay>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int tiles = (rows + kMlpRows - 1) / kMlpRows;
  mlp_wgmma_kernel<kPW, kPerRay><<<std::min(tiles, sms), kMlpThreads, smem, stream>>>(
      tm_w0, tm_w, b, origins, directions, ts, out, rows, S, L, kc, nf);
  return cudaGetLastError();
}

// H_{L-1} (n * S, pw) bf16 row-major into out for the n rays of a chunk:
// W the (L, pw, pw) bf16 stack (16-byte aligned), b (L, pw) f32, ts the
// (S,) shared depths or, with per_ray, the chunk's (n, S); pw 128 or 256,
// kc (layer 0's rows, a multiple of 8) holding the 3 + 6 nf encoded
// columns.  Anything else is refused with cudaErrorInvalidValue.  A
// template (T: bf16) only so that a source which includes this header and
// never calls it does not compile the kernels.
template <typename T>
cudaError_t mlp_forward(const void* W, const float* b, const float* ts, const float* origins,
                        const float* directions, T* out, int n, int S, int L, int pw, int kc,
                        int nf, bool per_ray, cudaStream_t stream) {
  static_assert(std::is_same<T, __nv_bfloat16>::value, "the fused MLP is bf16 only");
  const auto* w = static_cast<const __nv_bfloat16*>(W);
  if (n <= 0 || S <= 0 || L < 2 || kc <= 0 || kc > pw || kc % 8 != 0 || nf < 0 ||
      3 + 6 * nf > kc || reinterpret_cast<uintptr_t>(W) % 16 != 0 ||
      static_cast<long long>(n) * S > (1LL << 31) - kMlpRows) {
    return cudaErrorInvalidValue;
  }
  const int rows = n * S;
  if (pw == 256) {
    return per_ray ? mlp_launch<256, true>(w, b, ts, origins, directions, out, rows, S, L, kc, nf, stream)
                   : mlp_launch<256, false>(w, b, ts, origins, directions, out, rows, S, L, kc, nf, stream);
  }
  if (pw == 128) {
    return per_ray ? mlp_launch<128, true>(w, b, ts, origins, directions, out, rows, S, L, kc, nf, stream)
                   : mlp_launch<128, false>(w, b, ts, origins, directions, out, rows, S, L, kc, nf, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace wide
