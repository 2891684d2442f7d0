// Device code shared by the 2D image-field kernels (field_fwd.cu, the
// forward; field_bwd.cu, the parameter gradient from an output cotangent),
// so that both compute the forward identically.
//
// The field: coords (N, 2) -> encoding [x y | sin x, sin y | cos x, cos y |
// sin 2x, sin 2y | ...] (K0 = 2 (1 + 2 nf) features) -> L layers, ReLU on
// the hidden ones and a sigmoid on every output channel of the last.
//
// Two layouts of the parameters (both built by ops/fused_mlp.py):
//   * the gradient layout (floats, fused_nerf.pack_params), per layer l:
//     W_l zero-padded to (rows_l, cols_l) row-major, then b_l padded to
//     cols_l, where rows_0 = K0, rows_l = H for l >= 1, cols_l = H for
//     l < L-1 and cols_{L-1} = 4 (kHead); H is the padded hidden width (16,
//     32, 64 or 128).  The gradients (G floats) come out in it;
//   * the staged layout (fused_mlp.pack_field_params), the image of shared
//     memory, so that one bulk copy brings a layer in: per layer W_l as
//     (krows_l, kcols_l) in the swizzle of swz() (krows_0 = K0 rounded up to
//     8 for the 8-deep k-steps, kcols_l = cols_l), then b_l in kcols_l
//     floats, the block padded to 16 bytes.
//
// A block of kThreads threads (16 warps) walks over tiles of kTile pixels
// (persistent: the grid holds as many blocks as the card runs at once).
// Shared memory holds the weights and every layer's input for the tile
// (act(l), kTile rows of act_cols(l) floats, swizzled; act(L) holds the
// head's d_z in the gradient), with d_z of each layer written over its
// input on the way down.  The weights stream through two layer slots: each
// use of a layer is one bulk copy, issued by thread 0 as soon as the slot's
// previous layer is done with (the barrier after its product), so that the
// next layer's copy flies during this layer's products.  A tile uses layers
// 0..L-1 (the forward), then L-2..1 (d_h; the head's d_h reads the
// forward's copy).  The copies complete on mbarriers (mbarrier.cuh); no
// thread moves a weight.
//
// The three products of the hidden layers (forward H W, dW = H^T d_z, d_h
// = d_z W^T) take one of two routes, a compile-time flag (kExact) of the
// kernel: the JAX package's "highest" tier runs them as f32 FMAs (kExact:
// each output one fmaf chain over the sum in order, from 0, and db as
// column sums in pixel order, as the kernels before the tensor cores
// computed them); its "high" and "default" tiers run them on the tensor
// cores: mma.sync.m16n8k8 with TF32 operands
// and f32 accumulators, in split TF32 (3xTF32): each operand x = hi + lo,
// hi = x rounded to TF32 (cvt.rna's rounding, in two integer operations)
// and lo = x - hi (exact in f32, read by the tensor core as TF32), and
// out = a_hi b_hi + (a_lo b_hi + a_hi b_lo) (lo lo dropped): a few 2^-21 of
// each product where one f32 FMA keeps 2^-24, more exact than the JAX
// package's default tier ("high", bf16x3: ~2^-16).  Each warp owns blocks
// of 16 x 16 outputs; mma.sync reads its fragments from shared memory in
// any layout (ldmatrix for row-wise reads, scalar loads for column-wise
// ones), so one swizzle serves all three products (see swz()).  The head
// (4 columns) runs on the FMA pipes, spread over every thread.  The dW of
// a tile goes into the block's partial in device memory by
// fire-and-forget float2 reductions (red.global.add): each entry has one
// owner thread, which adds its tiles in order, so repeat launches are
// bit-identical; the partials are summed in a fixed order after the launch
// (block_sum.cuh).  db: the column sums of d_z, on the tensor cores too, an
// n8 tile of columns a warp (add_db).
//
// Exactness elsewhere: built without fast-math, so expf and sincosf stay
// IEEE; the octave scale 2^i x is exact.  cos is sincosf's own cos, as the
// plain version's torch.cos, where the TPU kernel takes sin(x + pi/2).

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "mbarrier.cuh"

namespace field {
namespace {  // each kernel source gets its own copy

using mbar::mbar_expect_tx;
using mbar::mbar_init;
using mbar::mbar_wait;
using mbar::smem_u32;

constexpr int kThreads = 512;  // threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;   // pixels per tile
constexpr int kHead = 4;    // head columns (out_channels <= 4, zero-padded)
constexpr int kSmemLimit = 232448;  // dynamic shared memory of one Hopper block
static_assert(kThreads == 4 * kTile * kHead, "head_forward: four lanes an output");

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Element (r, c) of a row-major (., cols) matrix in shared memory.  Rows of
// 32 or more floats (a multiple of 32) have bits 2-4 of the column XORed
// with f(r) = (r & 3) << 3 | (r & 4), so that both fragment reads of
// mma.m16n8k8 hit 32 distinct banks: 8 rows x 4 columns (A of the forward
// and of d_h, Wt as B of d_h: f(r) takes 8 values in bits 2-4) and 4 rows
// x 8 columns (W as B of the forward, Ht as A and d_z as B of dW: f(r) takes
// 4 values in bits 3-4 over r0 + 0..3 and over r0 + 4..7).  Narrower rows
// (16 or 8 floats) are not swizzled.  Columns 2j and 2j + 1 stay adjacent.
__host__ __device__ inline int swz(int r, int c, int cols) {
  const int f = ((r & 3) << 3) | (r & 4);
  return r * cols + (cols >= 32 ? (c ^ f) : c);
}

// Run-time shapes: L layers, K0 encoded inputs, padded hidden width H, nf
// octaves, out_ch output channels read by the caller.
struct Dims {
  int L, K0, H, nf, out_ch;

  // the gradient layout
  __host__ __device__ int rows(int l) const { return l == 0 ? K0 : H; }
  __host__ __device__ int cols(int l) const { return l == L - 1 ? kHead : H; }
  __host__ __device__ int offset(int l) const {
    int off = 0;
    for (int m = 0; m < l; ++m) off += rows(m) * cols(m) + cols(m);
    return off;
  }
  // the products' shapes: layer l is (krows, kcols), K0 rounded up to 8
  __host__ __device__ int krows(int l) const { return l == 0 ? round_up(K0, 8) : H; }
  __host__ __device__ int kcols(int l) const { return l == L - 1 ? kHead : H; }
  // the staged layout: W_l (krows, kcols) swizzled, then kcols of bias
  __host__ __device__ int stage_floats(int l) const {
    return round_up(krows(l) * kcols(l) + kcols(l), 4);
  }
  __host__ __device__ int stage_offset(int l) const {
    int off = 0;
    for (int m = 0; m < l; ++m) off += stage_floats(m);
    return off;
  }
  __host__ __device__ int slot_floats() const {
    int most = 0;
    for (int l = 0; l < L; ++l) most = stage_floats(l) > most ? stage_floats(l) : most;
    return most;
  }
  __host__ __device__ int wbuf_floats() const { return 2 * slot_floats(); }
  // act(l): the tile's input of layer l (l = L: the head's d_z); act(0)
  // padded with zeros to a multiple of 32 columns
  __host__ __device__ int act_cols(int l) const {
    return l == 0 ? round_up(K0, 32) : kcols(l - 1);
  }
  __host__ __device__ int act_offset(int l) const {
    int off = 0;
    for (int m = 0; m < l; ++m) off += kTile * act_cols(m);
    return off;
  }
  // the gradient's second d_z buffer (kTile x H), after act(L)
  __host__ __device__ int spare_floats() const { return L >= 2 ? kTile * H : 0; }
  // dynamic shared memory of a block: two barriers, the two weight slots,
  // act(0..L), the spare d_z buffer and the tile's coords
  __host__ __device__ size_t smem_bytes() const {
    return 16 + sizeof(float) * static_cast<size_t>(wbuf_floats() + act_offset(L + 1) +
                                                    spare_floats() + 2 * kTile);
  }
};

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// x = hi + lo: hi = x rounded to TF32 (cvt.rna.tf32.f32, for finite x: add
// half of TF32's last place to the magnitude, clear the 13 bits below it)
// and lo = x - hi, exact in f32, which the tensor core reads as TF32 (its
// top 19 bits)
__device__ __forceinline__ void split(uint32_t x, uint32_t& hi, uint32_t& lo) {
  hi = (x + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(__fsub_rn(__uint_as_float(x), __uint_as_float(hi)));
}

// d += a b on one m16n8k8 tile: TF32 operands, f32 accumulators
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// four 8 x 4 blocks of 32-bit values (rows r.., columns c..; each lane
// names one block row) into the fragment registers, one ldmatrix
__device__ __forceinline__ void ldmatrix_x4(const float* p, uint32_t (&v)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
               : "r"(smem_u32(p)));
}

// The operand readers of warp_gemm, over a row-major (., cols) matrix X in
// shared memory (swz), cols a multiple of 8 from 16 on.  Row-wise reads
// (blocks of 8 rows x 4 columns) go through ldmatrix; column-wise ones (4
// rows x 8 columns) are scalar loads whose rows advance by whole swizzle
// periods (k0 a multiple of 8), so each load's XOR is fixed per thread.
// A(m, k) = X[m][k]: the m16k8 fragment at (m0, k0).
struct RowA {
  const float* X;
  int cols;
  __device__ __forceinline__ void operator()(int m0, int k0, uint32_t (&v)[4]) const {
    const int lane = threadIdx.x & 31;
    ldmatrix_x4(X + swz(m0 + (lane & 7) + 8 * ((lane >> 3) & 1), k0 + 4 * (lane >> 4), cols),
                v);
  }
  __device__ __forceinline__ float at(int m, int k) const { return X[swz(m, k, cols)]; }
};
// A(m, k) = X[k][m]: a transposed read
struct ColA {
  const float* X;
  int cols;
  __device__ __forceinline__ void operator()(int m0, int k0, uint32_t (&v)[4]) const {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const float* x = X + k0 * cols;
    v[0] = __float_as_uint(x[swz(t, m0 + g, cols)]);
    v[1] = __float_as_uint(x[swz(t, m0 + g + 8, cols)]);
    v[2] = __float_as_uint(x[swz(t + 4, m0 + g, cols)]);
    v[3] = __float_as_uint(x[swz(t + 4, m0 + g + 8, cols)]);
  }
  __device__ __forceinline__ float at(int m, int k) const { return X[swz(k, m, cols)]; }
};
// B(k, n) = X[k][n]: the two k8n8 fragments at (k0, n0) and (k0, n0 + 8)
struct ColB {
  const float* X;
  int cols;
  __device__ __forceinline__ void operator()(int k0, int n0, uint32_t (&v)[2][2]) const {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const float* x = X + k0 * cols;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      v[j][0] = __float_as_uint(x[swz(t, n0 + 8 * j + g, cols)]);
      v[j][1] = __float_as_uint(x[swz(t + 4, n0 + 8 * j + g, cols)]);
    }
  }
  __device__ __forceinline__ float at(int k, int n) const { return X[swz(k, n, cols)]; }
};
// B(k, n) = X[n][k]: a transposed read, through ldmatrix
struct RowB {
  const float* X;
  int cols;
  __device__ __forceinline__ void operator()(int k0, int n0, uint32_t (&v)[2][2]) const {
    const int lane = threadIdx.x & 31;
    uint32_t r[4];
    ldmatrix_x4(X + swz(n0 + (lane & 7) + 8 * (lane >> 4), k0 + 4 * ((lane >> 3) & 1), cols),
                r);
    v[0][0] = r[0], v[0][1] = r[1], v[1][0] = r[2], v[1][1] = r[3];
  }
  __device__ __forceinline__ float at(int k, int n) const { return X[swz(n, k, cols)]; }
};

// out(m, n) = sum_{k < K} A(m, k) B(k, n) for m < M, n < N in 3xTF32,
// handed on by n8 tile as epi(m, n, v) with v = out(m, n), out(m, n + 1),
// out(m + 8, n), out(m + 8, n + 1) (the tile's fragment: m = m0 + lane / 4,
// n = n0 + 2 (lane % 4)), every lane of the warp together.  M a
// multiple of 16, N of 16 and K of 8.  The output is cut into blocks of
// 16 x 16 (one m16 by two n8 tiles), block i taken by warp i % kWarps; per
// 8-deep k-step a warp reads its fragments and splits them, then adds
// a_hi b_hi into one accumulator and a_lo b_hi, a_hi b_lo into a second
// (lo lo dropped), in that order: two short chains a tile instead of one
// long one; out = the first + the second.  With kExact, each lane sums the
// same eight outputs as f32 FMAs instead, reading its operands one element
// at a time (the readers' at()).  A fixed order per output.
template <bool kExact, class A, class B, class Epi>
__device__ __forceinline__ void warp_gemm(int M, int N, int K, const A& a, const B& b,
                                          Epi&& epi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bn = N / 16, blocks = M / 16 * bn;
  for (int blk = warp; blk < blocks; blk += kWarps) {
    const int m0 = blk / bn * 16, n0 = blk % bn * 16;
    if constexpr (kExact) {
      float acc[2][4] = {};
#pragma unroll 2
      for (int k = 0; k < K; ++k) {
        const float a0 = a.at(m0 + g, k), a1 = a.at(m0 + g + 8, k);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float y = b.at(k, n0 + 8 * j + 2 * t + e);
            acc[j][e] = fmaf(a0, y, acc[j][e]);
            acc[j][2 + e] = fmaf(a1, y, acc[j][2 + e]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) epi(m0 + g, n0 + 8 * j + 2 * t, acc[j]);
      continue;
    }
    float big[2][4] = {}, small[2][4] = {};
#pragma unroll 4
    for (int k0 = 0; k0 < K; k0 += 8) {
      uint32_t av[4], ah[4], al[4], bv[2][2], bh[2][2], bl[2][2];
      b(k0, n0, bv);
      a(m0, k0, av);
#pragma unroll
      for (int e = 0; e < 4; ++e) split(av[e], ah[e], al[e]);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        split(bv[j][0], bh[j][0], bl[j][0]);
        split(bv[j][1], bh[j][1], bl[j][1]);
        mma_tf32(big[j], ah, bh[j]);
        mma_tf32(small[j], al, bh[j]);
        mma_tf32(small[j], ah, bl[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float v[4] = {big[j][0] + small[j][0], big[j][1] + small[j][1],
                          big[j][2] + small[j][2], big[j][3] + small[j][3]};
      epi(m0 + g, n0 + 8 * j + 2 * t, v);
    }
  }
}

// db += the column sums of d_z (kTile x N, swizzled) on the tensor cores:
// warp w sums the n8 tile of columns 8w.. as (all ones) x d_z, d_z split
// into hi + lo (ones are exact in TF32; lo then hi into one accumulator),
// its lanes of row 0 adding columns 2t, 2t + 1 into pb by a float2
// reduction.  With kExact: thread c sums column c in f32, pixel by pixel.
template <bool kExact>
__device__ __forceinline__ void add_db(const float* dz, int N, float* pb) {
  if constexpr (kExact) {
    if (threadIdx.x < N) {
      float s = 0.0f;
      for (int p = 0; p < kTile; ++p) s += dz[swz(p, threadIdx.x, N)];
      atomicAdd(pb + threadIdx.x, s);
    }
    return;
  }
  const int lane = threadIdx.x & 31, n0 = 8 * (threadIdx.x >> 5);
  if (n0 >= N) return;
  const uint32_t ones[4] = {0x3f800000u, 0x3f800000u, 0x3f800000u, 0x3f800000u};
  float acc[4] = {};
#pragma unroll
  for (int k0 = 0; k0 < kTile; k0 += 8) {
    const int g = lane >> 2, t = lane & 3;
    uint32_t v[2], hi[2], lo[2];
    v[0] = __float_as_uint(dz[swz(k0 + t, n0 + g, N)]);
    v[1] = __float_as_uint(dz[swz(k0 + t + 4, n0 + g, N)]);
    split(v[0], hi[0], lo[0]);
    split(v[1], hi[1], lo[1]);
    mma_tf32(acc, ones, lo);
    mma_tf32(acc, ones, hi);
  }
  if (lane < 4) {
    atomicAdd(reinterpret_cast<float2*>(pb + n0 + 2 * lane), make_float2(acc[0], acc[1]));
  }
}

// The head (C = kHead output columns) on the FMA pipes, spread over every
// thread, each sum a fixed order of fmaf chains.
// z(p, c) = sum_{k < K} h[p][k] W[k][c] + b[c] for the tile's pixels, each
// sum by four lanes, lane q over k = q mod 4 (so that the four read other
// banks), added (q0 + q1) + (q2 + q3): head(p, c, z) from the first lane
template <class Head>
__device__ __forceinline__ void head_forward(const float* h, int hc, const float* w, int K,
                                             Head&& head) {
  const int o = threadIdx.x >> 2, q = threadIdx.x & 3;  // kTile * kHead outputs
  const int p = o / kHead, c = o % kHead;
  float s = 0.0f;
  for (int k = q; k < K; k += 4) s = fmaf(h[swz(p, k, hc)], w[k * kHead + c], s);
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  if (q == 0) head(p, c, s + w[K * kHead + c]);
}

// dW(r, c) += sum over the tile's pixels p of h[p][r] dz[p][c] for r < R,
// c < kHead, two columns a thread, into pw (R x kHead) by float2
// reductions; db(c) += the column sums of dz, one thread a column
__device__ __forceinline__ void head_grads(const float* h, int hc, const float* dz, int R,
                                           float* pw) {
  for (int o = threadIdx.x; o < R * (kHead / 2); o += kThreads) {
    const int r = o / (kHead / 2), c = 2 * (o % (kHead / 2));
    float s0 = 0.0f, s1 = 0.0f;
    for (int p = 0; p < kTile; ++p) {
      const float x = h[swz(p, r, hc)];
      s0 = fmaf(x, dz[p * kHead + c], s0);
      s1 = fmaf(x, dz[p * kHead + c + 1], s1);
    }
    atomicAdd(reinterpret_cast<float2*>(pw + r * kHead + c), make_float2(s0, s1));
  }
  if (threadIdx.x < kHead) {
    float s = 0.0f;
    for (int p = 0; p < kTile; ++p) s += dz[p * kHead + threadIdx.x];
    atomicAdd(pw + R * kHead + threadIdx.x, s);
  }
}

// d_h of the head: out[p][r] = (sum_c dz[p][c] W[r][c]) masked by
// h[p][r] > 0, for r < R, two units a thread (a row of dz and of W one
// float4 each)
__device__ __forceinline__ void head_dh(const float* dz, const float* w, int R, const float* h,
                                        float* out, int hc) {
  for (int o = threadIdx.x; o < kTile * (R / 2); o += kThreads) {
    const int p = o / (R / 2), r = 2 * (o % (R / 2));
    const float4 g = *reinterpret_cast<const float4*>(dz + p * kHead);
    const float4 w0 = *reinterpret_cast<const float4*>(w + r * kHead);
    const float4 w1 = *reinterpret_cast<const float4*>(w + (r + 1) * kHead);
    const float s0 = fmaf(g.w, w0.w, fmaf(g.z, w0.z, fmaf(g.y, w0.y, g.x * w0.x)));
    const float s1 = fmaf(g.w, w1.w, fmaf(g.z, w1.z, fmaf(g.y, w1.y, g.x * w1.x)));
    const float2 m = *reinterpret_cast<const float2*>(h + swz(p, r, hc));
    *reinterpret_cast<float2*>(out + swz(p, r, hc)) =
        make_float2(m.x > 0.0f ? s0 : 0.0f, m.y > 0.0f ? s1 : 0.0f);
  }
}

// the encoding of the tile's coords xy (kTile x 2) into act(0) (its pad
// columns K0.. stay as zeroed before the first tile)
__device__ __forceinline__ void encode_tile(const float* xy, const Dims& d, float* h0) {
  const int S = d.act_cols(0), per_px = 2 + 2 * d.nf;
  for (int e = threadIdx.x; e < kTile * per_px; e += kThreads) {
    const int p = e / per_px, rem = e - p * per_px;
    if (rem < 2) {
      h0[swz(p, rem, S)] = xy[2 * p + rem];
      continue;
    }
    const int i = (rem - 2) >> 1, k = rem & 1;
    const float x = xy[2 * p + k];
    float sn, cs;
    sincosf(__fmul_rn(ldexpf(1.0f, i), x), &sn, &cs);
    h0[swz(p, 2 + 4 * i + k, S)] = sn;
    h0[swz(p, 4 + 4 * i + k, S)] = cs;
  }
}

// The forward (kBwd = false: write sigmoid outputs to out (n, out_ch)) or
// the gradient of one block (kBwd = true: add dW/db of its tiles for the
// (n, out_ch) cotangent dout into its G-float partial, zeroed before the
// launch).  ws: the staged parameters.  Blocks stride over the tiles
// (gridDim.x <= n_tiles); pad pixels and pad columns add nothing (their
// cotangent is zero).  kExact: the hidden layers' products as f32 FMAs
// ("highest"), else in 3xTF32 on the tensor cores.
template <bool kBwd, bool kExact>
__global__ void __launch_bounds__(kThreads, 1)
field_kernel(const float* __restrict__ ws, const float* __restrict__ coords,
             const float* __restrict__ dout, float* __restrict__ out, int G, int n,
             int n_tiles, Dims dims) {
  const Dims d = dims;  // a copy the lambdas below can hold by reference in registers
  extern __shared__ __align__(16) float smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);  // 2 barriers
  float* wbuf = smem + 4;
  float* acts = wbuf + d.wbuf_floats();
  float* part = out + static_cast<size_t>(blockIdx.x) * G;
  const int L = d.L, slot = d.slot_floats();
  // the layers a tile uses in order, and this block's copies
  const int per_tile = kBwd ? L + (L > 2 ? L - 2 : 0) : L;
  const int loads = (n_tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x *
                    per_tile;
  auto issue = [&](int j) {  // copy j: its layer's staged block into slot j & 1, in bulk
    const int u = j % per_tile, l = u < L ? u : 2 * L - 2 - u;
    uint64_t* bar = &bars[j & 1];
    mbar_expect_tx(bar, 4u * d.stage_floats(l));
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];" ::"r"(smem_u32(wbuf + (j & 1) * slot)),
        "l"(ws + d.stage_offset(l)), "r"(4u * d.stage_floats(l)), "r"(smem_u32(bar))
        : "memory");
  };
  if (threadIdx.x == 0) {
    mbar_init(&bars[0], 1);
    mbar_init(&bars[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    issue(0);
    if (loads > 1) issue(1);
  }
  // act(0)'s pad columns: zero for every tile
  for (int e = threadIdx.x; e < kTile * (d.act_cols(0) - d.K0); e += kThreads) {
    const int p = e / (d.act_cols(0) - d.K0), c = d.K0 + e % (d.act_cols(0) - d.K0);
    acts[swz(p, c, d.act_cols(0))] = 0.0f;
  }
  __syncthreads();
  int want = 0, done = 0;  // the next copy to wait for, to give back
  auto acquire = [&]() -> const float* {  // the next use's layer
    const int j = want++;
    mbar_wait(&bars[j & 1], (j >> 1) & 1);
    return wbuf + (j & 1) * slot;
  };
  auto release = [&]() {  // after the barrier that ends a copy's last use
    const int j = done++;
    if (threadIdx.x == 0 && j + 2 < loads) issue(j + 2);
  };

  // Device memory is read ahead: during each tile, the first 2 kTile
  // threads load the block's next tile's coords (pad pixels 0), which they
  // stage in shared memory (xy) at the next tile's start, and the threads
  // of the head's outputs their cotangent entries of it
  float* xy = acts + d.act_offset(L + 1) + d.spare_floats();
  auto coord_of = [&](int tile) {
    const int q = tile * 2 * kTile + threadIdx.x;
    return threadIdx.x < 2 * kTile && tile < n_tiles && q < 2 * n ? coords[q] : 0.0f;
  };
  auto cot_of = [&](int tile) {
    const int o = threadIdx.x >> 2, p = tile * kTile + o / kHead, c = o % kHead;
    const bool real = (threadIdx.x & 3) == 0 && tile < n_tiles && c < d.out_ch && p < n;
    return kBwd && real ? dout[p * d.out_ch + c] : 0.0f;
  };
  float xy_next = coord_of(blockIdx.x), cot_next = cot_of(blockIdx.x);

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int p0 = tile * kTile;
    if (threadIdx.x < 2 * kTile) xy[threadIdx.x] = xy_next;  // read last by the encoding
    const float cot = cot_next;
    xy_next = coord_of(tile + gridDim.x);
    cot_next = cot_of(tile + gridDim.x);
    __syncthreads();  // the previous tile is done with act(0); xy written
    encode_tile(xy, d, acts);
    __syncthreads();
    // the forward, layer by layer, ReLU into act(l + 1); the head's
    // pre-sigmoid value to the output (forward) or its d_z = dout y (1 - y)
    // into act(L) (gradient)
    const float* w_head = nullptr;
    for (int l = 0; l < L; ++l) {
      const float* w = acquire();
      const int K = d.krows(l), C = d.kcols(l), ci = d.act_cols(l);
      const float* bias = w + K * C;
      const float* hin = acts + d.act_offset(l);
      float* hout = acts + d.act_offset(l + 1);
      if (l < L - 1) {
        warp_gemm<kExact>(kTile, C, K, RowA{hin, ci}, ColB{w, C},
                  [&](int r, int c, const float (&v)[4]) {
                    const float b0 = bias[c], b1 = bias[c + 1];
                    *reinterpret_cast<float2*>(hout + swz(r, c, C)) =
                        make_float2(fmaxf(v[0] + b0, 0.0f), fmaxf(v[1] + b1, 0.0f));
                    *reinterpret_cast<float2*>(hout + swz(r + 8, c, C)) =
                        make_float2(fmaxf(v[2] + b0, 0.0f), fmaxf(v[3] + b1, 0.0f));
                  });
      } else {
        head_forward(hin, ci, w, K, [&](int r, int c, float z) {
          const bool real = c < d.out_ch && p0 + r < n;
          const float y = sigmoidf(z);
          if (!kBwd) {
            if (real) out[(p0 + r) * d.out_ch + c] = y;
          } else {
            hout[r * kHead + c] = cot * y * (1.0f - y);  // cot: this thread's entry
          }
        });
        w_head = w;
      }
      __syncthreads();  // act(l + 1) written; layer l's weights read
      if (!kBwd || l < L - 1 || L == 1) release();  // the gradient keeps the head for d_h
    }
    if constexpr (kBwd) {
      // walk the layers down: dz holds d_z of layer l (the head's in
      // act(L)); d_h writes d_z of layer l-1 into the other of two buffers
      // (the spare one and act(L-1), free once layer L-1 is done), so that
      // it runs beside dW_l, which still reads act(l)
      const float* dz = acts + d.act_offset(L);
      float* spare = acts + d.act_offset(L + 1);
      float* nxt = spare;
      for (int l = L - 1; l >= 0; --l) {
        const int R = d.rows(l), C = d.kcols(l), ci = d.act_cols(l);
        const float* h = acts + d.act_offset(l);
        float* pw = part + d.offset(l);
        // dW_l += act(l)^T d_z, rows < R into the partial; db_l += sum d_z
        if (l == L - 1) {
          head_grads(h, ci, dz, R, pw);
        } else {
          warp_gemm<kExact>(round_up(R, 16), C, kTile, ColA{h, ci}, ColB{dz, C},
                    [&](int r, int c, const float (&v)[4]) {
                      for (int e = 0; e < 2; ++e) {
                        if (r + 8 * e < R) {
                          atomicAdd(reinterpret_cast<float2*>(pw + (r + 8 * e) * C + c),
                                    make_float2(v[2 * e], v[2 * e + 1]));
                        }
                      }
                    });
          add_db<kExact>(dz, C, pw + R * C);
        }
        if (l == 0) break;
        // d_z_{l-1} = (d_z W_l^T) masked by act(l) > 0
        const float* w = l == L - 1 ? w_head : acquire();
        if (l == L - 1) {
          head_dh(dz, w, R, h, nxt, ci);
        } else {
          warp_gemm<kExact>(kTile, R, C, RowA{dz, C}, RowB{w, C},
                    [&](int p, int r, const float (&v)[4]) {
                      for (int e = 0; e < 2; ++e) {
                        const int at = swz(p + 8 * e, r, ci);
                        const float2 m = *reinterpret_cast<const float2*>(h + at);
                        *reinterpret_cast<float2*>(nxt + at) =
                            make_float2(m.x > 0.0f ? v[2 * e] : 0.0f,
                                        m.y > 0.0f ? v[2 * e + 1] : 0.0f);
                      }
                    });
        }
        __syncthreads();  // d_z of layer l-1 written; act(l), d_z and layer l's weights read
        release();
        dz = nxt;
        nxt = nxt == spare ? acts + d.act_offset(L - 1) : spare;
      }
    }
  }
}

// Dynamic shared memory above 48 KB needs the kernel's opt-in.
template <bool kBwd, bool kExact>
cudaError_t allow_smem(const Dims& d) {
  const size_t smem = d.smem_bytes();
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(field_kernel<kBwd, kExact>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// The dims of a launch, or an error for a width no kernel takes or a
// block past shared memory.
inline cudaError_t plan(int L, int K0, int width, int nf, int out_ch, Dims* d) {
  if (width != 16 && width != 32 && width != 64 && width != 128) return cudaErrorInvalidValue;
  *d = Dims{L, K0, width, nf, out_ch};
  return d->smem_bytes() > kSmemLimit ? cudaErrorInvalidValue : cudaSuccess;
}

// Blocks of the kernel the current card holds at once for these shapes
// (the upper bound of its persistent grid), or minus the CUDA error.
template <bool kBwd, bool kExact>
int resident_blocks(int L, int K0, int width, int nf, int out_ch) {
  Dims d;
  cudaError_t err = plan(L, K0, width, nf, out_ch, &d);
  if (err == cudaSuccess) err = allow_smem<kBwd, kExact>(d);
  int per_sm = 0, dev = 0, sms = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, field_kernel<kBwd, kExact>,
                                                        kThreads, d.smem_bytes());
  }
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return err == cudaSuccess ? per_sm * sms : -static_cast<int>(err);
}

// One launch over the tiles of n pixels, at most `blocks` blocks (a
// gradient's further partials stay zero).
template <bool kBwd, bool kExact>
cudaError_t launch_tiles(const float* ws, const float* coords, const float* dout, float* out,
                         int G, int n, const Dims& d, int blocks, cudaStream_t stream) {
  cudaError_t err = allow_smem<kBwd, kExact>(d);
  if (err != cudaSuccess) return err;
  const int n_tiles = (n + kTile - 1) / kTile;
  // a block with no tile would leave its first copy in flight
  blocks = blocks < n_tiles ? blocks : n_tiles;
  field_kernel<kBwd, kExact><<<blocks, kThreads, d.smem_bytes(), stream>>>(
      ws, coords, dout, out, G, n, n_tiles, d);
  return cudaGetLastError();
}

// The same two on the run-time tier: exact != 0 the f32 FMA route.
template <bool kBwd>
int resident_blocks(int L, int K0, int width, int nf, int out_ch, int exact) {
  return exact ? resident_blocks<kBwd, true>(L, K0, width, nf, out_ch)
               : resident_blocks<kBwd, false>(L, K0, width, nf, out_ch);
}

template <bool kBwd>
cudaError_t launch_tiles(const float* ws, const float* coords, const float* dout, float* out,
                         int G, int n, const Dims& d, int blocks, int exact,
                         cudaStream_t stream) {
  return exact ? launch_tiles<kBwd, true>(ws, coords, dout, out, G, n, d, blocks, stream)
               : launch_tiles<kBwd, false>(ws, coords, dout, out, G, n, d, blocks, stream);
}

}  // namespace
}  // namespace field
