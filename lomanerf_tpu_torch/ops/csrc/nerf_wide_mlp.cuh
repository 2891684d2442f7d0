// The bf16 wide render's MLP in one persistent kernel per ray chunk, on
// Hopper's warpgroup tensor cores (wgmma) with the weights fed by TMA: the
// encoding and every hidden layer of a 128-row tile, the activations kept
// in registers (the encoding and H_{L-1} pass through one shared buffer),
// only the last hidden layer's output H_{L-1} written to device memory
// (row-major (rows, pw) bf16, what composite_kernel reads).
//
// Replaces, for the bf16 compute dtype, the layer-by-layer forward of the
// render (nerf_wide_chain.cuh:forward_layers: encode_kernel, then one
// layer GEMM per hidden layer with every activation through device
// memory): the counterpart of the TPU kernels' _mlp_forward on values in
// VMEM (lomanerf_tpu/ops/fused_nerf.py:_nerf_forward_kernel_W and, with
// kPerRay, _nerf_forward_kernel).
//
// What bounds it on this card: arithmetic.  The flagship's 33 -> 256 x 7
// MLP is 401,664 MACs a sample, 66 TFLOP an 800x800 frame at S = 128: 67 ms
// at the bf16 peak, against 42 GB of H_{L-1} written (13 ms at 3.35 TB/s).
// The layer-by-layer chain moved ~600 GB a frame through device memory
// before any arithmetic.  This kernel runs at ~65% of the peak (10.1-10.5
// ms a 65,536-ray chunk on an H100 at 700 W, chip_smoke.py phase 9): no
// warpgroup adds k-steps behind its products, and one warpgroup's epilogue
// runs under the other's products.  What is left:
// each weight byte, read from L2, feeds the 128 rows of a tile, 128 FLOP a
// byte, so the weights stream at ~5 TB/s of L2; the encoding (sincosf) of
// a tile runs in front of its first products (~8%); the waits for weights
// (~3%).  A cluster of two blocks that multicast each stage halves the L2
// bytes, but both blocks then wait for the slower of four warpgroups at
// every stage of a ring this shallow: 2.5 times as slow.
//
// The design:
//   * one block per SM, striding over 128-row tiles (row = ray * S + s of
//     the chunk); two consumer warpgroups, each owning 64 rows of the tile,
//     and a producer warpgroup whose first thread issues the TMA copies and
//     whose registers setmaxnreg hands to the consumers (40 and 232);
//   * one f32 accumulator a layer: each consumer computes its 64 rows x pw
//     outputs in one pass (wgmma m64n256k16 at pw 256, 128 registers;
//     m64n128k16 at pw 128), summing the layer's whole K in the tensor
//     core's accumulator (scale-d 0 on the first k16 only), the k-slices in
//     ascending k; one commit group a stage, released when wait_group 1
//     shows that the group that read it has finished, so a stage's products
//     are in flight while the next is issued;
//   * the activations stay in registers: the epilogue, bf16(ReLU(acc +
//     b[n])), packs each layer's output into the bf16 pairs that are this
//     thread's A fragment of the next layer's wgmma (the accumulator's
//     layout is the A fragment's: rows lane / 4 and + 8, columns 2 (lane %
//     4), + 1 of each 8), 64 registers at pw 256 beside the 128 of the sum;
//   * one activation buffer of 128 rows x pw bf16 in shared memory (64 KB
//     at pw = 256), K-major ([row][k]) in the 128-byte swizzle: 64-column
//     blocks of 128 rows, 16-byte chunk c of row r stored at chunk c ^ (r &
//     7), the wgmma A layout.  A warpgroup writes only its own 64 rows: the
//     encoding, which layer 0 reads from there, and H_{L-1}, stored by
//     stmatrix and sent out by TMA (its stores drop the rows past the
//     chunk); fence.proxy.async and a barrier of the warpgroup before the
//     async proxy reads them;
//   * the weights W_l, (pw, pw) row-major [k][n] in the stack: an MN-major
//     B operand, streamed by TMA in 32-row x pw k-slices (pw / 64 boxes of
//     32 x 64, the 128-byte swizzle) through a ring of kMlpStages stages
//     with full / empty mbarriers; both consumer warpgroups read every
//     stage, half a layer apart, so the ring holds a whole layer at pw 256
//     (8 stages) and two more in flight.  Layer 0's map has kc rows, so
//     TMA's zero fill gives the rows past kc; all L - 1 hidden weight
//     matrices (896 KB for the flagship) stay in L2 across tiles;
//   * ping-pong at layer granularity: the two consumer warpgroups take turns
//     to issue a whole layer's products (named barriers, both warpgroups at
//     every one, its id in a register), so that one's wgmma run while the
//     other waits for its last group and runs its epilogue and, after its
//     last layer, stores H_{L-1} and encodes its next tile (without the
//     turns a chunk takes 8% longer);
//   * the encoding is encode_kernel's arithmetic (nerf_wide_common.cuh: the
//     point by __fadd_rn / __fmul_rn, IEEE sincosf, the same columns), two
//     threads a row, zeros up to the end of layer 0's last k-slice; rows
//     past the chunk are encoded as zeros.
// Every output is one thread's fixed sequence of wgmma: repeat launches are
// bit-identical.  The f32 sum is grouped otherwise than the layer chain's
// (nerf_wide_layer_gemm.cuh promotes every 64-deep stage by IEEE adds; the
// tensor core's accumulator truncates), so an output whose exact sum lies
// within the sums' rounding of a bf16 rounding boundary may store the
// adjacent bf16 value: a near tie (wide_mlp.tied_rows), on ~6% of the
// flagship's rows.

#pragma once

#include <algorithm>
#include <type_traits>

#include "nerf_wide_dw.cuh"

namespace wide {
namespace {

constexpr int kMlpRows = 128;   // rows per tile: two consumer warpgroups of 64
constexpr int kMlpBK = 32;      // weight rows per stage: two 16-deep wgmma k-steps
constexpr int kMlpStages = 10;  // a layer's 8 at pw 256 (both warpgroups read them), and 2
constexpr int kMlpThreads = 3 * 128;  // 2 consumer warpgroups + the producer's

template <int kPW>
__host__ __device__ constexpr int mlp_stage_bytes() {  // pw / 64 boxes of 32 x 64
  return kMlpBK * kPW * 2;
}
template <int kPW>
constexpr int mlp_smem_bytes() {  // the activation buffer, the ring, alignment
  return kMlpRows * kPW * 2 + kMlpStages * mlp_stage_bytes<kPW>() + 1024;
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

// the tile box at (column c0, row c1) of `map` from shared memory src
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int c0,
                                          int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];"
               ::"l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0), "r"(c1)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
// this thread's committed stores have read their shared memory (.read) or
// completed
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

#define MLP_R8(i)                                                                  \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),      \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (+)= A (64 x 16) B (16 x 256), A K-major, B MN-major; scale_d 0
// ignores d's old values
__device__ __forceinline__ void wgmma_m64n256(float (&d)[128], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : MLP_R8(0), MLP_R8(8), MLP_R8(16), MLP_R8(24), MLP_R8(32), MLP_R8(40), MLP_R8(48),
        MLP_R8(56), MLP_R8(64), MLP_R8(72), MLP_R8(80), MLP_R8(88), MLP_R8(96), MLP_R8(104),
        MLP_R8(112), MLP_R8(120)
      : "l"(da), "l"(db), "r"(scale_d));
}
// d (+)= A (64 x 16, bf16 pairs in registers: this thread's rows lane / 4
// and + 8 of columns 2 (lane % 4), + 1, then the same 8 columns on) B (16 x
// 256), B MN-major; scale_d 0 ignores d's old values
__device__ __forceinline__ void wgmma_m64n256_rs(float (&d)[128], const uint32_t* a,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n"
      "}\n"
      : MLP_R8(0), MLP_R8(8), MLP_R8(16), MLP_R8(24), MLP_R8(32), MLP_R8(40), MLP_R8(48),
        MLP_R8(56), MLP_R8(64), MLP_R8(72), MLP_R8(80), MLP_R8(88), MLP_R8(96), MLP_R8(104),
        MLP_R8(112), MLP_R8(120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// the same at pw 128: B 16 x 128
__device__ __forceinline__ void wgmma_m64n128_rs(float (&d)[64], const uint32_t* a,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : MLP_R8(0), MLP_R8(8), MLP_R8(16), MLP_R8(24), MLP_R8(32), MLP_R8(40), MLP_R8(48),
        MLP_R8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}
#undef MLP_R8

// a warpgroup's 64 x kPW products of one 16-deep k-step into acc, A from
// shared memory (da) or from registers (a)
template <int kPW>
__device__ __forceinline__ void mlp_mma(float (&acc)[kPW / 2], uint64_t da, uint64_t db,
                                        int scale_d) {
  if constexpr (kPW == 256) {
    wgmma_m64n256(acc, da, db, scale_d);
  } else {
    wgmma_m64n128<0>(acc, da, db, scale_d);
  }
}
template <int kPW>
__device__ __forceinline__ void mlp_mma(float (&acc)[kPW / 2], const uint32_t* a, uint64_t db,
                                        int scale_d) {
  if constexpr (kPW == 256) {
    wgmma_m64n256_rs(acc, a, db, scale_d);
  } else {
    wgmma_m64n128_rs(acc, a, db, scale_d);
  }
}

// keep the compiler from moving reads or writes of d across an asynchronous
// wgmma's issue and its wait, and from reusing registers a wgmma still reads
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_acc(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// four 8 x 8 bf16 matrices from registers into shared memory: lane l gives
// the address of row l % 8 of matrix l / 8, each register a row pair of
// this lane's fragment (row lane / 4, columns 2 (lane % 4), + 1)
__device__ __forceinline__ void stmatrix_x4(uint32_t addr, uint32_t r0, uint32_t r1,
                                            uint32_t r2, uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};" ::"r"(addr),
               "r"(r0), "r"(r1), "r"(r2), "r"(r3)
               : "memory");
}

// bf16(ReLU(x + b)) of a column pair, packed as stmatrix takes it
__device__ __forceinline__ uint32_t relu_pair(float x0, float x1, float2 b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(fmaxf(x0 + b.x, 0.0f), fmaxf(x1 + b.y, 0.0f));
  return *reinterpret_cast<const uint32_t*>(&v);
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
// (L * kPW, kPW) stack, both in 32 x 64 boxes (dw_map); tm_out the (rows,
// kPW) output in 64 x 64 boxes
template <int kPW, bool kPerRay>
__global__ void __launch_bounds__(kMlpThreads, 1)
mlp_wgmma_kernel(const __grid_constant__ CUtensorMap tm_w0,
                 const __grid_constant__ CUtensorMap tm_w,
                 const __grid_constant__ CUtensorMap tm_out, const float* __restrict__ bias,
                 const float* __restrict__ origins, const float* __restrict__ directions,
                 const float* __restrict__ ts, int rows, int S, int L, int kc, int nf) {
  constexpr int kStageBytes = mlp_stage_bytes<kPW>();
  constexpr int kBoxes = kPW / 64;                // boxes a stage, 64-column blocks a row
  constexpr int kBoxBytes = kStageBytes / kBoxes;  // 32 rows x 128 bytes
  static_assert(kMlpStages * kMlpBK >= kPW, "the ring holds a layer for both warpgroups");
  extern __shared__ uint8_t mlp_raw[];
  __shared__ __align__(8) uint64_t full[kMlpStages], empty[kMlpStages];
  // the buffer and the ring start at a shared-memory address that is a
  // multiple of 1024: the activations, then the stages
  uint8_t* act = mlp_raw + ((1024 - (smem_u32(mlp_raw) & 1023)) & 1023);
  uint8_t* ring = act + kMlpRows * kPW * 2;
  const int n_tiles = (rows + kMlpRows - 1) / kMlpRows;
  const int n_st0 = (kc + kMlpBK - 1) / kMlpBK;  // layer 0's stages
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
          const int n_st = l == 0 ? n_st0 : kPW / kMlpBK;
          for (int st = 0; st < n_st; ++st, ++it) {
            const int s = it % kMlpStages;
            if (it >= kMlpStages) mbar_wait(&empty[s], ((it / kMlpStages) - 1) & 1);
            uint8_t* dst = ring + s * kStageBytes;
            const int row = l * kPW + st * kMlpBK;  // layer 0: rows of its own map
            mbar_expect_tx(&full[s], kStageBytes);
            for (int c = 0; c < kBoxes; ++c) {
              tma_load(dst + c * kBoxBytes, map, 64 * c, row, &full[s]);
            }
          }
        }
      }
    }
  } else {  // consumer warpgroup wg: rows 64 wg .. 64 wg + 63 of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
    const int t = threadIdx.x & 127, lane = t & 31;
    // the accumulator layout (m64nN): warp w of the group holds rows 16 w ..
    // 16 w + 15; register 4 j + q is row lane / 4 (+ 8 for q >= 2), column
    // 8 j + 2 (lane % 4) (+ 1 for odd q).  stmatrix: this lane gives the
    // address of row st_r, in column group j + st_j
    const int st_r = wg * 64 + (t >> 5) * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
    const int st_j = lane >> 4;
    const uint32_t act_s = smem_u32(act), ring_s = smem_u32(ring);
    const uint32_t in = act_s + wg * 64 * 128;  // this warpgroup's rows of column block 0
    float acc[kPW / 2];
    // the last layer's output, bf16 pairs: h[4 kk .. 4 kk + 3] are this
    // thread's A fragment of the next layer's k16 step kk (the accumulator's
    // column groups 2 kk and 2 kk + 1, rows r and r + 8)
    uint32_t h[kPW / 4];
#pragma unroll
    for (int i = 0; i < kPW / 2; ++i) acc[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < kPW / 4; ++i) h[i] = 0;
    if (wg == 1) pass_turn(wg);  // warpgroup 0 issues first
    int it = 0;
    // stage st of the layer: wait for its weights, issue its two k16 steps
    // (mma(k, b): the weight rows 0-15, then 16-31, 2 x 1024 bytes further)
    // as one group, and free the stage before it once its group has read it
    // (one arrival a warp)
    auto stage = [&](int st, auto&& mma) {
      const int s = (it + st) % kMlpStages;
      mbar_wait(&full[s], ((it + st) / kMlpStages) & 1);
      const uint32_t b = ring_s + s * kStageBytes;
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
      mma(2 * st, mn_desc(b, kBoxBytes));
      mma(2 * st + 1, mn_desc(b + 2048, kBoxBytes));
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
      if (lane == 0 && st > 0) mbar_arrive(&empty[(it + st - 1) % kMlpStages]);
    };
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int tile_row = tile * kMlpRows;
      if (t == 0) bulk_wait_read();  // the last tile's H_{L-1} stores have read the rows
      warpgroup_sync(wg);
      encode_rows<kPerRay>(act, wg, t, tile_row, rows, S, origins, directions, ts, nf,
                           n_st0 * kMlpBK);
      fence_async_smem();
      warpgroup_sync(wg);
      for (int l = 0; l < L - 1; ++l) {
        const int n_st = l == 0 ? n_st0 : kPW / kMlpBK;
        fence_acc(acc);
        fence_acc(h);
        wait_turn(wg);
        if (l == 0) {  // the encoding, from this warpgroup's rows in shared memory
          for (int st = 0; st < n_st0; ++st) {
            stage(st, [&](int k, uint64_t db) {  // input columns 16 k: block k / 4, byte 32 (k % 4)
              mlp_mma<kPW>(acc, k_desc(in + (k >> 2) * (kMlpRows * 128) + (k & 3) * 32), db, k > 0);
            });
          }
        } else {  // the last layer's output, from registers
#pragma unroll
          for (int st = 0; st < kPW / kMlpBK; ++st) {
            stage(st, [&](int k, uint64_t db) { mlp_mma<kPW>(acc, h + 4 * k, db, k > 0); });
          }
        }
        pass_turn(wg);
        asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
        fence_acc(acc);
        fence_acc(h);
        if (lane == 0) mbar_arrive(&empty[(it + n_st - 1) % kMlpStages]);
        it += n_st;
        // the epilogue: bf16(ReLU(acc + b[n])), column groups j and j + 1
        // (rows r and r + 8 of each) in four registers: into h for the next
        // layer, or, after the last, by stmatrix into this warpgroup's rows
        const float* bl = bias + l * kPW;
        const bool last = l == L - 2;
#pragma unroll
        for (int j = 0; j < kPW / 8; j += 2) {
          const int n = j * 8 + (lane & 3) * 2;
          const float2 b0 = __ldg(reinterpret_cast<const float2*>(bl + n));
          const float2 b1 = __ldg(reinterpret_cast<const float2*>(bl + n + 8));
          h[2 * j] = relu_pair(acc[4 * j], acc[4 * j + 1], b0);
          h[2 * j + 1] = relu_pair(acc[4 * j + 2], acc[4 * j + 3], b0);
          h[2 * j + 2] = relu_pair(acc[4 * j + 4], acc[4 * j + 5], b1);
          h[2 * j + 3] = relu_pair(acc[4 * j + 6], acc[4 * j + 7], b1);
          if (last) {
            stmatrix_x4(act_s + act_at(st_r, (j + st_j) * 8), h[2 * j], h[2 * j + 1],
                        h[2 * j + 2], h[2 * j + 3]);
          }
        }
        if (last) {  // H_{L-1} out by TMA: the warpgroup's rows, one box a column block
          fence_async_smem();
          warpgroup_sync(wg);
          if (t == 0) {
            for (int c = 0; c < kBoxes; ++c) {
              tma_store(&tm_out, act + c * (kMlpRows * 128) + wg * 64 * 128, 64 * c,
                        tile_row + wg * 64);
            }
            bulk_commit();
          }
        }
      }
    }
    if (t == 0) bulk_wait();
  }
}

template <int kPW, bool kPerRay>
cudaError_t mlp_launch(const __nv_bfloat16* W, const float* b, const float* ts,
                       const float* origins, const float* directions, __nv_bfloat16* out,
                       int rows, int S, int L, int kc, int nf, cudaStream_t stream) {
  constexpr int smem = mlp_smem_bytes<kPW>();
  static_assert(smem + 2 * kMlpStages * 8 <= 227 * 1024,
                "the buffer and the ring exceed a block's shared memory");
  CUtensorMap tm_w0, tm_w, tm_out;
  cudaError_t err = dw_map(&tm_w0, W, kPW, kc, kPW);
  if (err == cudaSuccess) err = dw_map(&tm_w, W, kPW, L * kPW, kPW);
  if (err == cudaSuccess) err = tile_map(&tm_out, out, false, kPW, rows, kPW, 64, 64);
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
      tm_w0, tm_w, tm_out, b, origins, directions, ts, rows, S, L, kc, nf);
  return cudaGetLastError();
}

// H_{L-1} (n * S, pw) bf16 row-major into out (16-byte aligned) for the n
// rays of a chunk: W the (L, pw, pw) bf16 stack (16-byte aligned), b (L, pw) f32, ts the
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
      reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
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
