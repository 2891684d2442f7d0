// Device code shared by the 2D image-field kernels (field_fwd.cu, the
// forward; field_bwd.cu, the parameter gradient from an output cotangent),
// so that both compute the forward identically.
//
// The field: coords (N, 2) -> encoding [x y | sin x, sin y | cos x, cos y |
// sin 2x, sin 2y | ...] (K0 = 2 (1 + 2 nf) features) -> L layers, ReLU on
// the hidden ones and a sigmoid on every output channel of the last.
//
// Packed parameter buffer (floats, built by ops/fused_mlp.py), per layer l:
//   W_l zero-padded to (rows_l, cols_l) row-major, then b_l padded to cols_l,
// where rows_0 = K0, rows_l = H for l >= 1, cols_l = H for l < L-1 and
// cols_{L-1} = 4.  H is the padded hidden width, a template parameter (16,
// 32, 64 or 128).  The gradient buffers use the same layout (G floats).
//
// A block of kThreads threads owns a tile of kTile pixels.  Shared memory
// holds one layer's weights at a time (row stride cols + 1) and every
// layer's input for the tile (act(l), row stride features + 1), the last
// buffer act(L) holding the head's output.  The odd strides keep the
// column reads of the three products below free of bank conflicts.  The
// products are register-tiled: each thread owns an RM x CM block of the
// output (rows strided by TR, columns by TC), reads RM + CM operands per
// step of the sum and does RM * CM FMAs, in f32, in a fixed order.
//
// Exactness: built without fast-math, so expf and sincosf stay IEEE; the
// octave scale 2^i x is exact.  Every precision tier of the JAX package
// ("highest", "high" = bf16x3, "default") is computed in these f32 FMAs,
// at least as exact as bf16x3.  cos is sincosf's own cos, as the plain
// version's torch.cos, where the TPU kernel takes sin(x + pi/2).

#pragma once

#include <cuda_runtime.h>

namespace field {
namespace {  // each kernel source gets its own copy

constexpr int kThreads = 256;  // threads per block
constexpr int kTile = 64;      // pixels per tile
constexpr int kHead = 4;       // head columns (out_channels <= 4, zero-padded)

// Output block per thread: (RM, CM) for a (kTile x H) product, (GRM, GCM)
// for the (H x H) dW product; both cover the output with kThreads threads.
template <int H> struct Tiles;
template <> struct Tiles<16> { static constexpr int RM = 1, CM = 4, GRM = 1, GCM = 1; };
template <> struct Tiles<32> { static constexpr int RM = 2, CM = 4, GRM = 1, GCM = 4; };
template <> struct Tiles<64> { static constexpr int RM = 2, CM = 8, GRM = 2, GCM = 8; };
template <> struct Tiles<128> { static constexpr int RM = 4, CM = 8, GRM = 8, GCM = 8; };

// Run-time shapes: L layers, K0 encoded inputs, padded hidden width H, nf
// octaves, out_ch output channels read by the caller.
struct Dims {
  int L, K0, H, nf, out_ch;

  __host__ __device__ int rows(int l) const { return l == 0 ? K0 : H; }
  __host__ __device__ int cols(int l) const { return l == L - 1 ? kHead : H; }
  // layer l's block in the packed parameters and the gradients
  __host__ __device__ int offset(int l) const {
    int off = 0;
    for (int m = 0; m < l; ++m) off += rows(m) * cols(m) + cols(m);
    return off;
  }
  // act(l): the tile's input of layer l (l = L: the head's output)
  __host__ __device__ int act_stride(int l) const {
    return (l == 0 ? K0 : cols(l - 1)) + 1;
  }
  __host__ __device__ int act_offset(int l) const {
    int off = 0;
    for (int m = 0; m < l; ++m) off += kTile * act_stride(m);
    return off;
  }
  __host__ __device__ int wbuf_floats() const {
    int most = 0;
    for (int l = 0; l < L; ++l) {
      const int f = rows(l) * (cols(l) + 1) + cols(l);
      most = f > most ? f : most;
    }
    return most;
  }
  // dynamic shared memory of a block: one layer's weights, then act(0..L)
  __host__ __device__ size_t smem_bytes() const {
    return sizeof(float) * static_cast<size_t>(wbuf_floats() + act_offset(L + 1));
  }
};

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// out(r, c) = sum_{i < K} X[r*xr + i*xi] * Y[i*yi + c*yc] for r < R, c < C,
// handed to epi(r, c, value).  C % CM == 0.  Thread t owns rows
// r0 + a*TR (a < RM) and columns tc + b*TC (b < CM) with TC = C / CM,
// TR = kThreads / TC; rows past R are computed on zeros and not handed on.
template <int RM, int CM, class Epi>
__device__ __forceinline__ void tile_gemm(int R, int C, int K,
                                          const float* __restrict__ X, int xr,
                                          int xi, const float* __restrict__ Y,
                                          int yi, int yc, Epi&& epi) {
  const int TC = C / CM;
  const int TR = kThreads / TC;
  const int tid = threadIdx.x;
  if (tid >= TR * TC) return;
  const int tc = tid % TC, tr = tid / TC;
  for (int r0 = tr; r0 < R; r0 += TR * RM) {
    float acc[RM][CM];
#pragma unroll
    for (int a = 0; a < RM; ++a)
#pragma unroll
      for (int b = 0; b < CM; ++b) acc[a][b] = 0.0f;
#pragma unroll 4
    for (int i = 0; i < K; ++i) {
      float x[RM], y[CM];
#pragma unroll
      for (int a = 0; a < RM; ++a) {
        const int r = r0 + a * TR;
        x[a] = r < R ? X[r * xr + i * xi] : 0.0f;
      }
#pragma unroll
      for (int b = 0; b < CM; ++b) y[b] = Y[i * yi + (tc + b * TC) * yc];
#pragma unroll
      for (int a = 0; a < RM; ++a)
#pragma unroll
        for (int b = 0; b < CM; ++b) acc[a][b] = fmaf(x[a], y[b], acc[a][b]);
    }
#pragma unroll
    for (int a = 0; a < RM; ++a) {
      const int r = r0 + a * TR;
      if (r < R) {
#pragma unroll
        for (int b = 0; b < CM; ++b) epi(r, tc + b * TC, acc[a][b]);
      }
    }
  }
}

// W_l (row stride cols + 1) and then b_l into wbuf.
__device__ __forceinline__ void load_layer(const float* __restrict__ pk,
                                           const Dims& d, int l, float* wbuf) {
  const int R = d.rows(l), C = d.cols(l);
  const float* src = pk + d.offset(l);
  for (int e = threadIdx.x; e < R * C; e += kThreads) {
    const int r = e / C, c = e - r * C;
    wbuf[r * (C + 1) + c] = src[e];
  }
  for (int c = threadIdx.x; c < C; c += kThreads) wbuf[R * (C + 1) + c] = src[R * C + c];
}

// The encoding of pixels p0 .. p0 + kTile into act(0); pad pixels
// (p0 + p >= n) get coords 0.
__device__ __forceinline__ void encode_tile(const float* __restrict__ coords,
                                            int n, int p0, const Dims& d,
                                            float* h0) {
  const int S = d.K0 + 1;
  for (int e = threadIdx.x; e < kTile * 2; e += kThreads) {
    const int p = e >> 1, k = e & 1;
    h0[p * S + k] = p0 + p < n ? coords[2 * (p0 + p) + k] : 0.0f;
  }
  const int per_px = 2 * d.nf;
  for (int e = threadIdx.x; e < kTile * per_px; e += kThreads) {
    const int p = e / per_px, rem = e - p * per_px;
    const int i = rem >> 1, k = rem & 1;
    const float x = p0 + p < n ? coords[2 * (p0 + p) + k] : 0.0f;
    float sn, cs;
    sincosf(__fmul_rn(ldexpf(1.0f, i), x), &sn, &cs);
    h0[p * S + 2 + 4 * i + k] = sn;
    h0[p * S + 4 + 4 * i + k] = cs;
  }
}

// The forward of the tile starting at pixel p0: encode, then layer by layer
// (weights loaded into wbuf in turn), ReLU into act(l + 1); the head's
// pre-sigmoid value goes to head(r, c, z) for r < kTile, c < 4.  Leaves
// W_{L-1} in wbuf.
template <int H, class Head>
__device__ __forceinline__ void tile_forward(const float* __restrict__ pk,
                                             const float* __restrict__ coords,
                                             int n, int p0, const Dims& d,
                                             float* wbuf, float* acts,
                                             Head&& head) {
  encode_tile(coords, n, p0, d, acts);
  for (int l = 0; l < d.L; ++l) {
    __syncthreads();  // wbuf free, act(l) written
    load_layer(pk, d, l, wbuf);
    __syncthreads();
    const int K = d.rows(l), C = d.cols(l), ws = C + 1;
    const float* bias = wbuf + K * ws;
    const float* hin = acts + d.act_offset(l);
    const int sin_ = d.act_stride(l);
    if (l < d.L - 1) {
      float* hout = acts + d.act_offset(l + 1);
      const int so = d.act_stride(l + 1);
      tile_gemm<Tiles<H>::RM, Tiles<H>::CM>(
          kTile, C, K, hin, sin_, 1, wbuf, ws, 1,
          [&](int r, int c, float acc) { hout[r * so + c] = fmaxf(acc + bias[c], 0.0f); });
    } else {
      tile_gemm<1, 1>(kTile, C, K, hin, sin_, 1, wbuf, ws, 1,
                      [&](int r, int c, float acc) { head(r, c, acc + bias[c]); });
    }
  }
}

// The forward (kBwd = false: write sigmoid outputs to out (n, out_ch)) or
// the gradient of one block (kBwd = true: add dW/db of its tiles for the
// (n, out_ch) cotangent dout into its G-float partial, zeroed before the
// launch).  Blocks stride over the tiles; pad pixels and pad columns add
// nothing (their cotangent is zero).
template <int H, bool kBwd>
__global__ void __launch_bounds__(kThreads)
field_kernel(const float* __restrict__ pk, const float* __restrict__ coords,
             const float* __restrict__ dout, float* __restrict__ out, int G,
             int n, int n_tiles, Dims d) {
  extern __shared__ __align__(16) float smem[];
  float* wbuf = smem;
  float* acts = smem + d.wbuf_floats();
  float* part = out + static_cast<size_t>(blockIdx.x) * G;
  const int L = d.L;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int p0 = tile * kTile;
    __syncthreads();  // the previous tile is done with act(0)
    if (!kBwd) {
      tile_forward<H>(pk, coords, n, p0, d, wbuf, acts, [&](int r, int c, float z) {
        if (c < d.out_ch && p0 + r < n) out[(p0 + r) * d.out_ch + c] = sigmoidf(z);
      });
      continue;
    }
    // the head's d_z = dout * y (1 - y) into act(L)
    float* dz_head = acts + d.act_offset(L);
    const int sh = d.act_stride(L);
    tile_forward<H>(pk, coords, n, p0, d, wbuf, acts, [&](int r, int c, float z) {
      const float y = sigmoidf(z);
      const bool real = c < d.out_ch && p0 + r < n;
      const float g = real ? dout[(p0 + r) * d.out_ch + c] : 0.0f;
      dz_head[r * sh + c] = g * y * (1.0f - y);
    });
    // walk the layers down: act(l + 1) holds d_z of layer l
    for (int l = L - 1; l >= 0; --l) {
      __syncthreads();  // d_z of layer l written
      if (l < L - 1) {
        load_layer(pk, d, l, wbuf);
        __syncthreads();
      }
      const int R = d.rows(l), C = d.cols(l), ws = C + 1;
      float* h = acts + d.act_offset(l);
      const float* dz = acts + d.act_offset(l + 1);
      const int s0 = d.act_stride(l), s1 = d.act_stride(l + 1);
      float* pw = part + d.offset(l);
      auto add_dw = [&](int r, int c, float acc) { pw[r * C + c] += acc; };
      // dW_l += act(l)^T d_z
      if (l == L - 1) {
        tile_gemm<2, 1>(R, C, kTile, h, 1, s0, dz, s1, 1, add_dw);
      } else if (l == 0) {
        tile_gemm<Tiles<H>::RM, Tiles<H>::CM>(R, C, kTile, h, 1, s0, dz, s1, 1, add_dw);
      } else {
        tile_gemm<Tiles<H>::GRM, Tiles<H>::GCM>(R, C, kTile, h, 1, s0, dz, s1, 1, add_dw);
      }
      // db_l += the column sums of d_z, over the tile's pixels in order
      for (int c = threadIdx.x; c < C; c += kThreads) {
        float s = 0.0f;
        for (int p = 0; p < kTile; ++p) s += dz[p * s1 + c];
        pw[R * C + c] += s;
      }
      if (l > 0) {
        __syncthreads();  // act(l) read; now overwrite it with d_z of layer l-1
        // d_z_{l-1} = (d_z W_l^T) masked by act(l) > 0, in place
        tile_gemm<Tiles<H>::RM, Tiles<H>::CM>(
            kTile, R, C, dz, s1, 1, wbuf, 1, ws, [&](int r, int c, float acc) {
              h[r * s0 + c] = h[r * s0 + c] > 0.0f ? acc : 0.0f;
            });
      }
    }
  }
}

// Dynamic shared memory above 48 KB needs the kernel's opt-in (refused with
// an error above 227 KB).
template <int H, bool kBwd>
cudaError_t allow_smem(const Dims& d) {
  const size_t smem = d.smem_bytes();
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(field_kernel<H, kBwd>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int H, bool kBwd>
cudaError_t launch_tiles(const float* pk, const float* coords,
                         const float* dout, float* out, int G, int n,
                         const Dims& d, int blocks, cudaStream_t stream) {
  cudaError_t err = allow_smem<H, kBwd>(d);
  if (err != cudaSuccess) return err;
  const int n_tiles = (n + kTile - 1) / kTile;
  field_kernel<H, kBwd><<<blocks, kThreads, d.smem_bytes(), stream>>>(
      pk, coords, dout, out, G, n, n_tiles, d);
  return cudaGetLastError();
}

// launch_tiles for the padded width; an error for a width no instance takes.
template <bool kBwd>
cudaError_t launch_width(int width, const float* pk, const float* coords,
                         const float* dout, float* out, int G, int n,
                         const Dims& d, int blocks, cudaStream_t stream) {
  switch (width) {
    case 16: return launch_tiles<16, kBwd>(pk, coords, dout, out, G, n, d, blocks, stream);
    case 32: return launch_tiles<32, kBwd>(pk, coords, dout, out, G, n, d, blocks, stream);
    case 64: return launch_tiles<64, kBwd>(pk, coords, dout, out, G, n, d, blocks, stream);
    case 128: return launch_tiles<128, kBwd>(pk, coords, dout, out, G, n, d, blocks, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace field
