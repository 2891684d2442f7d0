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
// What bounds it on this card: arithmetic.  A pixel reads 8 B and writes
// 12 B but costs K0*H + (L-2)*H^2 + 4H multiply-adds: 37,504 for the hires
// field (34 -> 128 -> 128 -> 128 -> 3), so a 1024^2 render is 78.7 GFLOP:
// 1.17 ms at the 67 TFLOP/s f32 peak, 0.48 ms as three TF32 passes at the
// 495 TFLOP/s of the tensor cores, against ~6 us of bytes.
//
// What the design does about it (field_common.cuh): the products on the
// tensor cores in split TF32 (3xTF32, f32-level accuracy); a persistent
// grid whose blocks take the weights into shared memory through two slots,
// copied in by the Tensor Memory Accelerator, the next layer's copy in
// flight during this layer's products; tiles of 32 pixels per 512-thread
// block, the activations kept in shared memory between layers.

#include "field_common.cuh"

// C entry point, bound with ctypes: how many blocks of the forward kernel
// the current card holds at once for these shapes (its grid's upper
// bound).  Returns that count, or minus the CUDA error.
extern "C" int field_fwd_blocks(int L, int in_dim, int width, int num_functions, int out_ch) {
  return field::resident_blocks<false>(L, in_dim, width, num_functions, out_ch);
}

// C entry point, bound with ctypes.  ws: the staged parameters
// (field_common.cuh); coords (n, 2) and out (n, out_ch) f32; n_blocks the
// grid, at most field_fwd_blocks(...) (cut to the tiles of 32 pixels);
// width the padded hidden width (16, 32, 64 or 128); in_dim the encoded
// width K0.  Returns the launch's cudaGetLastError() (0 on success); does
// not synchronise.
extern "C" int field_fwd(const float* ws, const float* coords, float* out, int n_blocks, int n,
                         int L, int in_dim, int width, int num_functions, int out_ch,
                         void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (n_blocks <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  field::Dims d;
  cudaError_t err = field::plan(L, in_dim, width, num_functions, out_ch, &d);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(field::launch_tiles<false>(ws, coords, nullptr, out, 0, n, d,
                                                    n_blocks,
                                                    static_cast<cudaStream_t>(stream)));
}
