// The bf16 layer GEMM of the wide NeRF chain (nerf_wide_chain.cuh) on
// Hopper's warpgroup tensor cores (wgmma), its operands fed by the Tensor
// Memory Accelerator (TMA), in the two forms the chain runs:
//
//   kEpiBiasRelu  C = bf16(ReLU(A[:, :K] B[:K] + bias))     the forward layer:
//                 A = H_l (M, lda) bf16, B = W_l [k][n] (K, ldb) bf16, an
//                 MN-major operand; C (M, N) bf16, row stride ldc
//   kEpiMask      D = mask > 0 ? A[:, :K] B^T : 0 in f32,   d_h of layer l:
//                 Cb = bf16(D), part[i][n] = the sum of       A = the bf16 copy
//                 D[128 i .. 128 i + 127][n]; C = D where     of d_z (M, lda),
//                 C is given                                  B = W_l [n][k]
//                 (N, ldb) bf16, a K-major operand (W_l^T); mask = H_l (M,
//                 ldc) bf16; Cb (M, N) bf16, the dW stage's operand, and C
//                 (M, N) f32, both at row stride ldc; part (ceil(M / 128), N)
//                 f32, the column partials db is summed from (nerf_wide_chain.cuh)
//   kLinear       either form without its nonlinearity: the forward without
//                 the ReLU, d_h without the mask (the published NeRF's linear
//                 feature layer, nerf_paper.cu)
//
// Replaces, for the bf16 compute dtype, gemm_mma_kernel (nerf_wide_gemm.cuh:
// mma.sync m16n8k16, operands staged through registers, one k-step in
// flight, W scattered into shared memory by 2-byte stores) in those two
// forms: every forward layer of the gradient sequence and of the render
// past the fused MLP's pw 256, and every d_h.  Those are the layer products
// of the TPU kernels' _mlp_forward and _bwd_from_dcol
// (lomanerf_tpu/ops/fused_nerf.py:79, :168) inside _nerf_train_kernel_W
// (:1477), _nerf_forward_kernel_W (:1515) and their siblings.
//
// What bounds it on this card: arithmetic past pw 256, memory below.  One
// 8x1024 gradient chunk's hidden layer, 598,784 x 1024 . 1024 x 1024, is
// 1.26 TFLOP (1.27 ms at the bf16 peak) against 2.5 GB of bf16 operands and
// output (0.75 ms at 3.35 TB/s); the flagship's 2,097,152 x 256 . 256 x 256
// moves 2.1 GB (0.64 ms) for 0.28 TFLOP (0.28 ms).
//
// The design:
//   * one block per SM walks 128 x 128 output tiles (the column tile
//     fastest, so the blocks that share a row tile of A run side by side
//     and read it from L2); two consumer warpgroups, each owning 64 rows x
//     128 columns (wgmma m64n128k16), and a producer warpgroup whose first
//     thread issues the TMA copies and whose registers setmaxnreg hands to
//     the consumers (40 and 232), as nerf_wide_mlp.cuh does;
//   * a ring of 64-deep k-slices, as many stages as a block's 227 KB hold
//     beside the output buffers, at most four (lg_stages), guarded by full
//     and empty mbarriers: A's 128 rows x 64 columns in one box, B's 64 x
//     128 in one box ([n][k], K-major) or two ([k][n], MN-major, 64 columns
//     each), all 128-byte swizzled, so no thread stages or converts an
//     operand; the producer runs ahead across tiles;
//   * f32 sums promoted a stage at a time: each 64-deep stage's four k16
//     steps go into a fresh accumulator set (scale-d 0 on the first), and
//     the set is added to the running sum by IEEE f32 adds, the stages in
//     ascending k.  The tensor core's own accumulation truncates: summed
//     over a whole K of 1024 in it, 5 to 14 times as many outputs of an
//     8x1024 chunk's layer took the other side of the ReLU from f64 as when
//     promoted every 32 deep, as gemm_mma_kernel did; promoted every 64 deep
//     they stay as near f64 (scripts/gemm_variants);
//   * the two sets take turns, a stage each, and each stage is a commit
//     group: once the next stage's group is issued, wait_group 1 shows that
//     a stage has finished, and the thread frees it and adds its set while
//     the next one's products run (three sets of 64 registers: the running
//     sum and the two fresh ones).  The loop takes the stages in pairs, so
//     that ptxas sees which set is in flight where each add reads the other
//     (else it serializes every wgmma of the kernel, C7514, and an 8x1024
//     layer ran about 1.8 times as long);
//   * the two consumer warpgroups take turns to issue a stage (named
//     barriers, nerf_wide_mlp.cuh's wait_turn / pass_turn), and each waits
//     and adds outside its turn, so that one's adds and epilogue run under
//     the other's products;
//   * the epilogue writes its 64 x 128 outputs into shared memory in the
//     128-byte swizzle (no bank conflicts for bf16 pairs) and one thread
//     stores them by TMA, which completes behind the next products;
//     kEpiMask's mask tile is loaded by TMA into the bf16 output buffer when
//     the tile starts, so its loads are in flight through the whole k-loop,
//     and each thread overwrites its mask entries with its Cb entries; the
//     f32 C, where given, goes from registers to device memory;
//   * kEpiMask's column partials, from the unrounded f32 outputs in a fixed
//     order: each thread adds its two rows of a column pair, a shuffle adds
//     the pair of the next row (lanes 4 apart), and both lanes stage the
//     sums of those four rows in shared memory (16 row quads x 128 columns
//     a warpgroup, quad g's 8-column groups XOR g % 4: no bank conflicts);
//     thread t of a warpgroup adds column t's row quads, a warp's four in
//     order and then the four warps in order, and warpgroup 1 adds its sum
//     to warpgroup 0's and stores the tile's row of partials; warpgroup 0's
//     sums go through two slots handed over by named barriers (ids 5-8), so
//     that it runs a tile ahead, with no branch on the warpgroup
//     (bar_sync_id);
//   * ragged edges (rows past M, columns past N, layer 0's K = kc = 40
//     columns) are zero-filled by TMA's out-of-bounds fill and dropped by
//     its stores.
// Every output is one thread's fixed sequence of wgmma and adds: repeat
// launches are bit-identical; so are the partials.

#pragma once

#include <algorithm>

#include "nerf_wide_mlp.cuh"

namespace wide {
namespace {

constexpr int kLgBM = 128, kLgBN = 128;     // outputs per tile
constexpr int kLgBK = 64;                   // k per stage: two 32-deep k-steps
constexpr int kLgBox = 64 * 128;            // a 64-row x 128-byte box: 8 KB
constexpr int kLgStageBytes = (kLgBM + kLgBN) * kLgBK * 2;  // A 16 KB + B 16 KB
constexpr int kLgOut = 2 * kLgBox;          // a consumer warpgroup's 64 x 128 bf16
constexpr int kLgThreads = 3 * 128;         // 2 consumer warpgroups + the producer's
constexpr int kLgSmem = 227 * 1024;         // a block's shared memory on the H100
constexpr int kLgStatic = 256;              // room for the static mbarriers
constexpr int kLgMaxStages = 4;

// kEpiMask's column sums: each consumer warpgroup's 16 row quads x 128
// columns, then two slots of warpgroup 0's 128 and warpgroup 1's unread row
constexpr int kLgSumBytes = (2 * 16 * kLgBN + 3 * kLgBN) * 4;

// the output buffers, the sums, alignment
template <int kEpi>
constexpr int lg_fixed_bytes() {
  return 2 * kLgOut + (kEpi == kEpiMask ? kLgSumBytes : 0) + 1024;
}
template <int kEpi>
constexpr int lg_stages() {
  return std::min(kLgMaxStages, (kLgSmem - kLgStatic - lg_fixed_bytes<kEpi>()) / kLgStageBytes);
}
template <int kEpi>
constexpr int lg_smem_bytes() {
  return lg_stages<kEpi>() * kLgStageBytes + lg_fixed_bytes<kEpi>();
}

// byte offset of (row r < 64, column n < 128) bf16 in a run of 128-byte
// swizzled boxes of 64 rows x 64 columns
__device__ __forceinline__ uint32_t box_at(int r, int n) {
  return (n >> 6) * kLgBox + r * 128 + ((((n & 63) >> 3) ^ (r & 7)) << 4) + (n & 7) * 2;
}

// kEpiMask's hand-over of column sums between the consumer warpgroups (256
// threads): barrier 5 + p, warpgroup 0's sums are in slot p; 7 + p,
// warpgroup 1 has read slot p.  Both warpgroups run the same instructions,
// with the barrier's id in a register (as wait_turn and pass_turn): a
// barrier under a branch or a predicate on the warpgroup makes ptxas
// serialize the wgmma of the whole kernel (C7520), and the d_h k-loop at K =
// 1024 then ran 1.6 times as long on an H100.
__device__ __forceinline__ void bar_arrive_id(int id) {
  asm volatile("bar.arrive %0, 256;" ::"r"(id) : "memory");
}
__device__ __forceinline__ void bar_sync_id(int id) {
  asm volatile("bar.sync %0, 256;" ::"r"(id) : "memory");
}

// grid min(tiles, SMs), block kLgThreads, dynamic shared memory
// lg_smem_bytes<kEpi>(); tm_a (K, M) boxes 64 x 128, tm_b (N, K) boxes 64 x
// 64 ([k][n]) or (K, N) boxes 64 x 128 ([n][k], kEpiMask), tm_c the bf16
// output (N, M) in 64 x 64 boxes (kEpiMask: Cb), tm_m (kEpiMask) the mask as
// tm_c; c32 (kEpiMask, or null) the f32 C and part (kEpiMask, or null)
// (ceil(M / 128), N) f32, both of row stride ldc and N; kLinear: the
// forward without its ReLU, d_h without its mask (tm_m not read)
template <int kEpi, int kStages, bool kLinear = false>
__global__ void __launch_bounds__(kLgThreads, 1)
layer_wgmma_kernel(const __grid_constant__ CUtensorMap tm_a,
                   const __grid_constant__ CUtensorMap tm_b,
                   const __grid_constant__ CUtensorMap tm_c,
                   const __grid_constant__ CUtensorMap tm_m, const float* __restrict__ bias,
                   float* __restrict__ c32, float* __restrict__ part, int M, int N, int K,
                   int ldc) {
  constexpr bool kMask = kEpi == kEpiMask;
  constexpr bool kReadMask = kMask && !kLinear;
  extern __shared__ uint8_t lg_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages], mask_full[2];
  // the ring and the output buffers start at a multiple of 1024 bytes
  uint8_t* ring = lg_raw + ((1024 - (smem_u32(lg_raw) & 1023)) & 1023);
  uint8_t* outs = ring + kStages * kLgStageBytes;
  // kEpiMask: the warpgroups' staged column sums, then warpgroup 0's slots
  float* sums = reinterpret_cast<float*>(outs + 2 * kLgOut);
  const int tiles_n = (N + kLgBN - 1) / kLgBN;
  const int n_tiles = (M + kLgBM - 1) / kLgBM * tiles_n;
  const int n_st = (K + kLgBK - 1) / kLgBK;
  const int wg = threadIdx.x >> 7;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_init(&mask_full[0], 1);
    mbar_init(&mask_full[1], 1);
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
        const int m0 = tile / tiles_n * kLgBM, n0 = tile % tiles_n * kLgBN;
        for (int st = 0; st < n_st; ++st, ++it) {
          const int s = it % kStages;
          if (it >= kStages) mbar_wait(&empty[s], ((it / kStages) - 1) & 1);
          uint8_t* a = ring + s * kLgStageBytes;
          uint8_t* b = a + kLgBM * kLgBK * 2;
          const int k0 = st * kLgBK;
          mbar_expect_tx(&full[s], kLgStageBytes);
          tma_load(a, &tm_a, k0, m0, &full[s]);
          if (kMask) {
            tma_load(b, &tm_b, k0, n0, &full[s]);
          } else {
            tma_load(b, &tm_b, n0, k0, &full[s]);
            tma_load(b + kLgBox, &tm_b, n0 + 64, k0, &full[s]);
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
    const int r = (t >> 5) * 16 + (lane >> 2);
    uint8_t* out = outs + wg * kLgOut;  // the bf16 boxes (kEpiMask: the mask's, first)
    // kEpiMask: row quad g = (t / 32) * 4 + lane / 8, its 8-column groups
    // XOR g % 4
    float* stage = sums + wg * 16 * kLgBN;
    const int quad = (t >> 5) * 4 + (lane >> 3);
    const uint32_t ring_s = smem_u32(ring);
    float acc[64], ks0[64], ks1[64];  // the running sum, two fresh stage sets
#pragma unroll
    for (int i = 0; i < 64; ++i) ks0[i] = ks1[i] = 0.0f;
    if (wg == 1) {
      pass_turn(wg);  // warpgroup 0 issues first
      if (kMask) {    // and finds both slots of sums free
        bar_arrive_id(7);
        bar_arrive_id(8);
      }
    }
    int it = 0, local = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++local) {
      const int m0 = tile / tiles_n * kLgBM + wg * 64, n0 = tile % tiles_n * kLgBN;
      if (t == 0) {
        bulk_wait_read();  // the last tile's stores have read the output buffer
        if (kReadMask) {  // this tile's mask, in flight through the k-loop
          mbar_expect_tx(&mask_full[wg], 2 * kLgBox);
          tma_load(out, &tm_m, n0, m0, &mask_full[wg]);
          tma_load(out + kLgBox, &tm_m, n0 + 64, m0, &mask_full[wg]);
        }
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
      // the k-loop, a stage at a time: issue() puts its four k16 steps (A's
      // columns 16 j, 32 bytes a step in the swizzled row; B's rows 16 j,
      // [k][n]: 2048 bytes a step, or columns 16 j, [n][k]) into a fresh set
      // as one commit group; once the next stage's group is issued,
      // wait_group 1 shows that it has finished, and add() frees its stage
      // (one arrival a warp) and adds its set to the running sum.  ks0 and
      // ks1 take turns, so that at the top of the loop ks0's group is the
      // one in flight: ptxas then sees which set each add may read
      // (otherwise it serializes every wgmma, C7514)
      auto issue = [&](float(&ks)[64]) {
        const int s = it % kStages;
        const uint32_t a = ring_s + s * kLgStageBytes + wg * kLgBox;
        const uint32_t b = ring_s + s * kLgStageBytes + kLgBM * kLgBK * 2;
        fence_acc(ks);
        wait_turn(wg);
        mbar_wait(&full[s], (it / kStages) & 1);
        asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
        for (int j = 0; j < kLgBK / 16; ++j) {
          if constexpr (kMask) {
            wgmma_m64n128<0, 0>(ks, k_desc(a + 32 * j), k_desc(b + 32 * j), j > 0);
          } else {
            wgmma_m64n128<0, 1>(ks, k_desc(a + 32 * j), mn_desc(b + 2048 * j, kLgBox), j > 0);
          }
        }
        asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
        pass_turn(wg);
        ++it;
      };
      auto add = [&](float(&ks)[64], int stage_it) {
        fence_acc(ks);
        if (lane == 0) mbar_arrive(&empty[stage_it % kStages]);
#pragma unroll
        for (int q = 0; q < 64; ++q) acc[q] += ks[q];
        fence_acc(ks);
      };
      issue(ks0);
      int st = 1;
      for (; st + 1 < n_st; st += 2) {
        issue(ks1);
        asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
        add(ks0, it - 2);
        issue(ks0);
        asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
        add(ks1, it - 2);
      }
      if (st < n_st) {  // an even count of stages: the last one into ks1
        issue(ks1);
        asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
        add(ks0, it - 2);
        asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
        add(ks1, it - 1);
      } else {
        asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
        add(ks0, it - 1);
      }

      // the epilogue: column pairs (n, n + 1) of rows r and r + 8 into the
      // output buffer, then one thread's TMA stores
      warpgroup_sync(wg);  // the buffer is free (thread 0's wait above)
      if (kReadMask) mbar_wait(&mask_full[wg], local & 1);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int n = j * 8 + (lane & 3) * 2;
        float2 pair;  // kEpiMask: columns n and n + 1 of rows r and r + 8, then r ^ 1 too
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int rr = r + 8 * hr;
          const float v0 = acc[4 * j + 2 * hr], v1 = acc[4 * j + 2 * hr + 1];
          auto* pb = reinterpret_cast<__nv_bfloat162*>(out + box_at(rr, n));
          if constexpr (kMask) {
            float o0 = v0, o1 = v1;
            if constexpr (kReadMask) {  // the mask, loaded into the buffer
              const __nv_bfloat162 m = *pb;
              o0 = __low2float(m) > 0.0f ? v0 : 0.0f;
              o1 = __high2float(m) > 0.0f ? v1 : 0.0f;
            }
            if (c32 != nullptr && m0 + rr < M && n0 + n < N) {
              *reinterpret_cast<float2*>(c32 + static_cast<size_t>(m0 + rr) * ldc + n0 + n) =
                  make_float2(o0, o1);
            }
            *pb = __floats2bfloat162_rn(o0, o1);
            if (hr == 0) {
              pair = make_float2(o0, o1);
            } else {
              pair.x += o0;
              pair.y += o1;
            }
          } else {
            const int gn = n0 + n;
            const float2 bn = gn < N ? *reinterpret_cast<const float2*>(bias + gn)
                                     : make_float2(0.0f, 0.0f);
            if constexpr (kLinear) {
              *pb = __floats2bfloat162_rn(v0 + bn.x, v1 + bn.y);
            } else {
              *pb = __floats2bfloat162_rn(fmaxf(v0 + bn.x, 0.0f), fmaxf(v1 + bn.y, 0.0f));
            }
          }
        }
        if constexpr (kMask) {  // both lanes of a quad store the same sums
          pair.x += __shfl_xor_sync(0xffffffffu, pair.x, 4);
          pair.y += __shfl_xor_sync(0xffffffffu, pair.y, 4);
          *reinterpret_cast<float2*>(stage + quad * kLgBN + (n ^ ((quad & 3) << 3))) = pair;
        }
      }
      fence_async_smem();
      warpgroup_sync(wg);
      if (t == 0) {
        tma_store(&tm_c, out, n0, m0);
        tma_store(&tm_c, out + kLgBox, n0 + 64, m0);
        bulk_commit();
      }
      if constexpr (kMask) {  // the tile's column partials, while the stores run
        // column t over the warpgroup's row quads (the barrier above made
        // them visible): a warp's four in order, then the warps in order
        auto col = [&](int g) { return stage[g * kLgBN + (t ^ ((g & 3) << 3))]; };
        float w4[4];
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          w4[w] = col(4 * w);
#pragma unroll
          for (int g = 1; g < 4; ++g) w4[w] += col(4 * w + g);
        }
        const float mine = ((w4[0] + w4[1]) + w4[2]) + w4[3];
        // warpgroup 0: wait for slot p free, fill it, mark it full;
        // warpgroup 1: wait for it full, write a row nobody reads, add slot
        // p to its own sum, mark the slot free, store the total
        const int slot = local & 1;
        float* hand = sums + 2 * 16 * kLgBN;
        bar_sync_id(wg == 0 ? 7 + slot : 5 + slot);
        hand[(wg == 0 ? slot : 2) * kLgBN + t] = mine;
        const float total = hand[slot * kLgBN + t] + mine;
        bar_arrive_id(wg == 0 ? 5 + slot : 7 + slot);
        if (part != nullptr && wg == 1 && n0 + t < N) {
          part[static_cast<size_t>(tile / tiles_n) * N + n0 + t] = total;
        }
      }
    }
    if (t == 0) bulk_wait();
  }
}

// layer_gemm's tensor maps and launch, its arguments checked; kLinear as the
// kernel's
template <int kEpi, bool kLinear>
cudaError_t launch_layer_gemm(const __nv_bfloat16* A, int lda, const __nv_bfloat16* B,
                              int ldb, int M, int N, int K, const float* bias,
                              const __nv_bfloat16* mask, void* C, int ldc,
                              __nv_bfloat16* Cb, cudaStream_t stream, float* part) {
  constexpr bool kMask = kEpi == kEpiMask;
  constexpr int kStages = lg_stages<kEpi>();
  constexpr int smem = lg_smem_bytes<kEpi>();
  static_assert(kStages >= 3, "the ring needs a stage in flight and one filling");
  static_assert(smem + 8 * (2 * kStages + 2) <= kLgSmem,
                "the ring and the output buffers exceed shared memory");
  auto* kernel = layer_wgmma_kernel<kEpi, kStages, kLinear>;
  CUtensorMap tm_a, tm_b, tm_c, tm_m;
  cudaError_t err = tile_map(&tm_a, A, false, K, M, lda, 64, kLgBM);
  if (err == cudaSuccess) {
    err = kMask ? tile_map(&tm_b, B, false, K, N, ldb, 64, kLgBN)
                : tile_map(&tm_b, B, false, N, K, ldb, 64, 64);
  }
  if (err == cudaSuccess) err = tile_map(&tm_c, kMask ? Cb : C, false, N, M, ldc, 64, 64);
  tm_m = tm_c;  // not read but by kEpiMask with its mask
  if (err == cudaSuccess && kMask && !kLinear) {
    err = tile_map(&tm_m, mask, false, N, M, ldc, 64, 64);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long tiles = static_cast<long long>((M + kLgBM - 1) / kLgBM) *
                          ((N + kLgBN - 1) / kLgBN);
  kernel<<<static_cast<int>(std::min<long long>(tiles, sms)), kLgThreads, smem, stream>>>(
      tm_a, tm_b, tm_c, tm_m, bias, kMask ? static_cast<float*>(C) : nullptr, part, M, N, K,
      ldc);
  return cudaGetLastError();
}

// C (and, for kEpiMask, Cb and part) of the forms above; B's ld is ldb.
// Every pointer 16-byte aligned, lda, ldb and ldc multiples of 8, N even;
// bias (N f32) read for kEpiBiasRelu; mask and Cb for kEpiMask, where C (the
// f32 d_h) and part may be null.  kLinear: the forward layer without its
// ReLU, or d_h without a mask (mask may be null; the published NeRF's
// feature layer, nerf_paper.cuh).  Anything else is refused with
// cudaErrorInvalidValue.
template <int kEpi, bool kLinear>
cudaError_t layer_gemm(const __nv_bfloat16* A, int lda, const __nv_bfloat16* B, int ldb,
                       int M, int N, int K, const float* bias, const __nv_bfloat16* mask,
                       void* C, int ldc, __nv_bfloat16* Cb, cudaStream_t stream,
                       float* part) {
  static_assert(kEpi == kEpiBiasRelu || kEpi == kEpiMask, "the forward or the d_h form");
  constexpr bool kMask = kEpi == kEpiMask;
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (M <= 0 || N <= 0 || K <= 0 || K > lda || N > ldc || N % 2 != 0 || lda % 8 != 0 ||
      ldb % 8 != 0 || ldc % 8 != 0 || (kMask ? K : N) > ldb || !aligned(A) || !aligned(B) ||
      !aligned(C) || (kMask ? (!kLinear && mask == nullptr) || Cb == nullptr || !aligned(mask) ||
                                  !aligned(Cb) || reinterpret_cast<uintptr_t>(part) % 4
                            : C == nullptr || bias == nullptr ||
                                  reinterpret_cast<uintptr_t>(bias) % 8)) {
    return cudaErrorInvalidValue;
  }
  return launch_layer_gemm<kEpi, kLinear>(A, lda, B, ldb, M, N, K, bias, mask, C, ldc, Cb,
                                          stream, part);
}

}  // namespace
}  // namespace wide
