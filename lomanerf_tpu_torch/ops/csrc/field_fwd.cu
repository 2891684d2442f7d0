// 2D image-field forward for Hopper (sm_90a).
//
// Replaces the TPU kernel lomanerf_tpu/ops/fused_mlp.py:_fwd_kernel: per
// pixel, the positional encoding of its (x, y) coords, an L-layer MLP with
// ReLU hidden layers and a sigmoid on every output channel, writing the
// (N, out_ch) output.  The TPU kernel pads every width to 128 lanes, keeps
// all activations of a 1024-row tile in VMEM and writes 128 lanes per
// pixel; here each layer keeps its own padded width and only the out_ch
// channels the caller reads leave the chip.
//
// What bounds it on this card: f32 arithmetic.  A pixel reads 8 B and
// writes 12 B but costs K0*H + (L-2)*H^2 + 4H FMAs: 37,504 for the hires
// field (34 -> 128 -> 128 -> 128 -> 3), so a 1024^2 render is 78.7 GFLOP,
// at least 1.17 ms at the 67 TFLOP/s f32 peak, against ~6 us of bytes.
//
// What the design does about it (field_common.cuh): tiles of 64 pixels
// per 256-thread block; the tile's activations stay in shared memory
// between layers; each layer's weights are loaded into shared memory in
// turn (64 KB at width 128); each thread computes a 4 x 8 block of a
// layer's output (at width 128) from 12 shared-memory reads per 32 FMAs.
// Simple first: the weight loads are not overlapped with the products, and
// the 176 KB of shared memory of the hires field leave one block per SM.

#include "field_common.cuh"

// C entry point, bound with ctypes.  pk: the packed parameters
// (field_common.cuh); coords (n, 2) and out (n, out_ch) f32; width the
// padded hidden width (16, 32, 64 or 128); in_dim the encoded width K0.
// Returns the launch's cudaGetLastError() (0 on success); does not
// synchronise.
extern "C" int field_fwd(const float* pk, const float* coords, float* out,
                         int n, int L, int in_dim, int width,
                         int num_functions, int out_ch, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const field::Dims d{L, in_dim, width, num_functions, out_ch};
  const int n_tiles = (n + field::kTile - 1) / field::kTile;
  return static_cast<int>(field::launch_width<false>(
      width, pk, coords, nullptr, out, 0, n, d, n_tiles,
      static_cast<cudaStream_t>(stream)));
}
