// Image fields too large for one block's tile, for Hopper (sm_90a): forward
// and parameter gradient with the activations in device memory.
//
// Replaces the TPU kernels lomanerf_tpu/ops/fused_mlp.py:_fwd_kernel and
// _bwd_kernel at the shapes the tile kernels (field_fwd.cu, field_bwd.cu)
// do not take: hidden widths above 128, more layers than a 32-pixel tile
// holds beside two weight slots (5+ at width 128), heads of 5 to 128
// channels, and coordinates of any dimension D.  Per pixel: the encoding
// of its (D,) coords, the ReLU MLP, the sigmoid head on the first out_ch
// channels; the backward from the (N, out_ch) output cotangent.
//
// What bounds it on this card: tensor-core arithmetic.  A 4x256 field (the
// image-regression network of Fourier-feature MLPs, n = 8 encoding) does
// 34*256 + 2*256^2 + 256*3 = 140,544 MACs a pixel forward, about 0.074
// TFLOP for a 512x512 image; its gradient about three times that (the
// forward again, dW, d_h).  The "high" tier's products take three TF32
// passes on the tensor cores (0.45 ms forward at the 495 TFLOP/s TF32
// peak).  The TPU kernel keeps a tile's activations in VMEM; one Hopper
// block's 227 KB holds a 32-pixel tile of at most about five 128-wide
// layers beside the weights, so here the activations live in device
// memory, as on the wide NeRF path, and each product is a GEMM over all
// the chunk's pixels.
//
// What the design does about it, per chunk of pixel rows (field_forward in
// ops/fused_mlp.py sizes the chunks; rows are pixels):
//   1. encode_kernel: the reference's block layout [x | sin 2^0 x |
//      cos 2^0 x | ...] (blocks of D), one thread a coordinate and octave,
//      sincosf(2^i x) as field_common.cuh computes it (where the TPU
//      kernel takes cos as sin(. + pi/2));
//   2. each layer a GEMM by the JAX precision tier (`exact`, as the tile
//      kernels take it): "high" and "default" on the tensor cores in
//      3xTF32 (field_wide_gemm.cuh: mma.sync with the tile kernels' split
//      arithmetic, 128x64 block tiles staged by cp.async through a
//      three-stage ring), "highest" as exact f32 FMAs
//      (nerf_wide_f32_gemm.cuh); hidden layers with bias + ReLU in
//      the epilogue, the head (through the same GEMM as the hidden layers,
//      a narrow block tile: 128x16 in 3xTF32, 256x16 in FMAs) with bias +
//      sigmoid (kEpiSigmoid) on out_ch
//      columns, or, in the backward, d_z = dout * y * (1 - y)
//      (kEpiSigmoidGrad);
//   3. backward, layer by layer in reverse: dW_l as split-K partials over
//      8192-row chunks (kEpiPartial) added in a fixed order
//      (sum_partials), db_l the fixed-order column sums of d_z
//      (nerf_wide_gemm.cuh:column_sums), and d_h = d_z W_l^T masked by
//      the stored input h_l > 0 (kEpiMask).
//      dW/db are zeroed once; every chunk adds to them in chunk order, so
//      repeat launches are bit-identical on either tier.
// The backward takes the forward's activations where the forward kept
// them (one chunk under autograd), else recomputes them, as the TPU kernel
// does.

#include <algorithm>
#include <utility>

#include "field_wide_gemm.cuh"
#include "nerf_wide_f32_gemm.cuh"
#include "nerf_wide_gemm.cuh"

namespace {

#define FIELD_TRY(expr)                        \
  do {                                         \
    const cudaError_t err_ = (expr);           \
    if (err_ != cudaSuccess) return err_;      \
  } while (0)

// enc[row][.] (row stride ld): thread (row, b, k) for b <= nf writes
// coordinate k's identity lane (b = 0), or sin and cos of 2^(b-1) x at
// lanes (2b - 1) D + k and 2b D + k.  The octave scale is exact; sincosf
// is IEEE-accurate (no fast-math).
__global__ void __launch_bounds__(256)
encode_kernel(const float* __restrict__ coords, float* __restrict__ enc, int rows,
              int D, int nf, int ld) {
  const int per_row = D * (1 + nf);
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(rows) * per_row) return;
  const int row = static_cast<int>(idx / per_row), t = static_cast<int>(idx % per_row);
  const int b = t / D, k = t % D;
  const float x = coords[static_cast<size_t>(row) * D + k];
  float* out = enc + static_cast<size_t>(row) * ld;
  if (b == 0) {
    out[k] = x;
    return;
  }
  float sn, cs;
  sincosf(__fmul_rn(ldexpf(1.0f, b - 1), x), &sn, &cs);
  out[(2 * b - 1) * D + k] = sn;
  out[2 * b * D + k] = cs;
}

struct Field {
  const float* W;  // (L, pw, pw) f32, layer l's (in_l, out_l) zero-padded
  const float* b;  // (L, pw) f32
  int L, D, nf, enc, hidden, out_ch, pw;  // enc = D (1 + 2 nf)

  int in_cols(int l) const { return l == 0 ? enc : hidden; }
  int out_cols(int l) const { return l == L - 1 ? out_ch : hidden; }
  const float* Wl(int l) const { return W + static_cast<size_t>(l) * pw * pw; }
  const float* bl(int l) const { return b + static_cast<size_t>(l) * pw; }
};

// One product of the route, C = epi(A B): exact f32 FMAs for the
// "highest" tier (nerf_wide_gemm.cuh:gemm, on nerf_wide_f32_gemm.cuh, which
// reads the mask at C's row stride), else 3xTF32 on the tensor cores
// (field_wide_gemm.cuh).
template <bool kAT, bool kBT, int kEpi>
cudaError_t product(bool exact, const float* A, int lda, const float* B, int ldb, int M, int N,
                    int K, int k_chunk, const float* bias, const float* mask, int ldm,
                    float* C, int ldc, cudaStream_t stream) {
  if (exact) {
    return wide::gemm<float, float, float, kAT, kBT, kEpi>(A, lda, B, ldb, M, N, K, k_chunk,
                                                           bias, mask, C, ldc, stream);
  }
  return wide3::gemm<kAT, kBT, kEpi>(A, lda, B, ldb, M, N, K, k_chunk, bias, mask, ldm, C, ldc,
                                     stream);
}

// The encoding and the hidden layers of `rows` pixels: slot l (rows x pw,
// `slot_stride` floats apart) receives layer l's input; with pingpong the
// slots alternate between two.  Returns the head's input slot.
cudaError_t forward_layers(const Field& f, bool exact, const float* coords, int rows,
                           float* acts, size_t slot_stride, bool pingpong,
                           float** last, cudaStream_t stream) {
  auto slot = [&](int l) { return acts + (pingpong ? (l & 1) : l) * slot_stride; };
  const long long threads = static_cast<long long>(rows) * f.D * (1 + f.nf);
  encode_kernel<<<static_cast<unsigned>((threads + 255) / 256), 256, 0, stream>>>(
      coords, slot(0), rows, f.D, f.nf, f.pw);
  FIELD_TRY(cudaGetLastError());
  for (int l = 0; l < f.L - 1; ++l) {
    FIELD_TRY((product<false, false, wide::kEpiBiasRelu>(
        exact, slot(l), f.pw, f.Wl(l), f.pw, rows, f.hidden, f.in_cols(l), f.in_cols(l),
        f.bl(l), nullptr, 0, slot(l + 1), f.pw, stream)));
  }
  *last = slot(f.L - 1);
  return cudaSuccess;
}

bool dims_ok(const Field& f, int n, int chunk) {
  return f.L >= 1 && f.D >= 1 && f.nf >= 0 && f.out_ch >= 1 && n >= 0 && chunk > 0 &&
         f.enc <= f.pw && f.hidden <= f.pw && f.out_ch <= f.pw &&
         (f.L == 1 || f.hidden >= 1);
}

}  // namespace

// C entry points, bound with ctypes.  W (L, pw, pw) and b (L, pw) f32, layer
// l's weight zero-padded (in_l = enc for l = 0, else hidden; out_l = hidden,
// out_ch for the head), enc = D (1 + 2 nf) for nf octaves; coords (n, D)
// f32.  Pixels run in chunks of `chunk`.  exact != 0 runs the products as
// f32 FMAs (the "highest" tier), 0 in 3xTF32.  Return the first failing
// launch's cudaError (0 on success); do not synchronise.
//
// field_wide_fwd: out (n, out_ch) f32; acts 2 * chunk * pw floats, or with
// keep (one chunk: n <= chunk) L * chunk * pw, left holding every layer's
// input for field_wide_bwd's `kept`.
extern "C" int field_wide_fwd(const float* W, const float* b, const float* coords,
                              float* out, float* acts, int n, int chunk, int L, int D,
                              int nf, int hidden, int out_ch, int pw, int exact, int keep,
                              void* stream) {
  const Field f{W, b, L, D, nf, D * (1 + 2 * nf), hidden, out_ch, pw};
  if (!dims_ok(f, n, chunk) || (keep && n > chunk)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t slot_stride = static_cast<size_t>(chunk) * pw;
  for (int r0 = 0; r0 < n; r0 += chunk) {
    const int rows = std::min(chunk, n - r0);
    float* H;
    cudaError_t err = forward_layers(f, exact, coords + static_cast<size_t>(r0) * D, rows,
                                     acts, slot_stride, !keep, &H, st);
    if (err == cudaSuccess) {
      err = product<false, false, wide::kEpiSigmoid>(
          exact, H, pw, f.Wl(L - 1), pw, rows, out_ch, f.in_cols(L - 1), f.in_cols(L - 1),
          f.bl(L - 1), nullptr, 0, out + static_cast<size_t>(r0) * out_ch, out_ch, st);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// field_wide_bwd: dout (n, out_ch) f32, the output cotangent; acts
// L * chunk * pw floats, with kept (one chunk) as field_wide_fwd's keep
// left them (the same bits the recomputed forward gives), else recomputed;
// dz 2 * chunk * pw; partials n_parts floats, at least ceil(chunk / 8192)
// * pw * pw.  Writes dW (L, pw, pw) and db (L, pw).
extern "C" int field_wide_bwd(const float* W, const float* b, const float* coords,
                              const float* dout, float* acts, float* dz, float* partials,
                              long long n_parts, float* dW, float* db, int n, int chunk,
                              int L, int D, int nf, int hidden, int out_ch, int pw,
                              int exact, int kept, void* stream) {
  const Field f{W, b, L, D, nf, D * (1 + 2 * nf), hidden, out_ch, pw};
  const long long need = (static_cast<long long>(chunk) + wide::kRowChunk - 1) /
                         wide::kRowChunk * pw * pw;
  if (!dims_ok(f, n, chunk) || n_parts < need || (kept && n > chunk)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t slot_stride = static_cast<size_t>(chunk) * pw;
  // the head's d_z at row stride out_ch (the FMA GEMM reads the cotangent
  // at its output's stride), or out_ch rounded up to 4 (the 3xTF32 GEMM's
  // 16-B copies)
  const int ld_head = exact ? out_ch : (out_ch + 3) / 4 * 4;
  auto run = [&]() -> cudaError_t {
    FIELD_TRY(cudaMemsetAsync(dW, 0, sizeof(float) * L * pw * pw, st));
    FIELD_TRY(cudaMemsetAsync(db, 0, sizeof(float) * L * pw, st));
    for (int r0 = 0; r0 < n; r0 += chunk) {
      const int rows = std::min(chunk, n - r0);
      const int n_rc = (rows + wide::kRowChunk - 1) / wide::kRowChunk;
      float* H = acts + (L - 1) * slot_stride;
      if (!kept) {
        FIELD_TRY(forward_layers(f, exact, coords + static_cast<size_t>(r0) * D, rows, acts,
                                 slot_stride, false, &H, st));
      }
      float* g = dz;
      float* g_next = dz + slot_stride;
      int ldg = ld_head;
      FIELD_TRY((product<false, false, wide::kEpiSigmoidGrad>(
          exact, H, pw, f.Wl(L - 1), pw, rows, out_ch, f.in_cols(L - 1), f.in_cols(L - 1),
          f.bl(L - 1), dout + static_cast<size_t>(r0) * out_ch, out_ch, g, ldg, st)));
      for (int l = L - 1; l >= 0; --l) {
        const float* h = acts + l * slot_stride;
        const int M = f.in_cols(l), N = f.out_cols(l);
        FIELD_TRY((product<true, false, wide::kEpiPartial>(
            exact, h, pw, g, ldg, M, N, rows, wide::kRowChunk, nullptr, nullptr, 0, partials,
            N, st)));
        FIELD_TRY(wide::sum_partials(partials, n_rc, M, N,
                                     dW + static_cast<size_t>(l) * pw * pw, pw, st));
        FIELD_TRY(wide::column_sums(g, ldg, rows, N, wide::kRowChunk, partials,
                                     db + static_cast<size_t>(l) * pw, st));
        if (l >= 1) {  // d_h = d_z W_l^T, masked by h_l > 0, at row stride pw
          FIELD_TRY((product<false, true, wide::kEpiMask>(
              exact, g, ldg, f.Wl(l), pw, rows, M, N, N, nullptr, h, pw, g_next, pw, st)));
          std::swap(g, g_next);
          ldg = pw;
        }
      }
    }
    return cudaSuccess;
  };
  return static_cast<int>(run());
}
