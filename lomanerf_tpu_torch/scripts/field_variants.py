"""What each part of the 2D field kernels costs on the card: variants of
``ops/csrc/field_common.cuh``, each with one piece taken out, timed in turns
on one ``field_bwd`` call and one ``field_fwd`` call of the ``hires`` field
(34 -> 128 -> 128 -> 128 -> 3, n = 8) over the whole 1024 x 1024 image
(``chip_smoke.py``'s numpy seed-0 params, a seed-1 cotangent).

Each variant is the header with the textual edits of ``VARIANTS`` (every
edit must match the source exactly as often as it names), built by
``scripts/variants.py`` into a library of its own under
``build/field_variants/<hash>/`` from the C entry points of ``field_fwd.cu``
and ``field_bwd.cu``.  Those of ``WHOLE`` (the same arithmetic) must give
the production kernels' bits; the others compute something else and are
timed only.  For each, the SASS of the gradient kernel is counted (all
instructions, ``HMMA``, ``FFMA``, shared-memory loads and stores, barriers)
and its registers and spills read from ``ptxas -v``.

``--parent DIR`` also builds the variants of ``PARENT_VARIANTS`` from the
``csrc`` directory of a checkout of the field kernels before their
tensor-core redesign (f32 FMAs, weights loaded per 64-pixel tile) and times
them in the same turns, each table with its own packing of the parameters.

Also: a micro-benchmark of the two product routes on this card, with no
memory traffic: warps that issue ``mma.sync.aligned.m16n8k8.row.col.f32.
tf32.tf32.f32`` on eight independent accumulator sets, and warps that issue
FFMA on eight independent chains, at 1 to 16 warps on every SM.

Needs a card and the CUDA toolkit.  Run:

    python -m lomanerf_tpu_torch.scripts.field_variants [--parent DIR]

The last line is one JSON object with the numbers.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
from pathlib import Path

import numpy as np
import torch

from lomanerf_tpu_torch.ops import build
from lomanerf_tpu_torch.scripts import variants

HEADER = "field_common.cuh"
ROUNDS = 3  # rounds of turns: each call is timed 2 * ROUNDS times
SIZE = 1024  # the hires image
# the gradient kernel (at the hires width before the redesign), by its
# mangled name: before the redesign, and as the source stands
_PARENT_KERNEL = "field_kernelILi128ELb1E"
_KERNEL = "field_kernelILb1ELb0E"
OUT = build.BUILD_ROOT.parent / "field_variants"

# the kernels before their redesign: f32 FMAs in register tiles, each
# layer's weights copied into shared memory per 64-pixel tile
PARENT_VARIANTS = {
    "as is": [],
    # each layer loaded for the block's first tile only (barriers stay)
    "weights once per block": [("load_layer(pk, d, l, wbuf);",
                                "if (p0 == static_cast<int>(blockIdx.x) * kTile) "
                                "load_layer(pk, d, l, wbuf);", 2)],
    # every product's loop over the sum (its operand loads and FMAs)
    "no products": [("    for (int i = 0; i < K; ++i) {",
                     "    for (int i = 0; i < 0; ++i) {", 1)],
    # the encoding's IEEE sincosf
    "no sincosf": [("    sincosf(__fmul_rn(ldexpf(1.0f, i), x), &sn, &cs);",
                    "    sn = __fmul_rn(ldexpf(1.0f, i), x);\n    cs = 0.5f * sn;", 1)],
    # dW's read-modify-write of the partial, summed into a register instead
    "dW update to a register": [
        ("  float* part = out + static_cast<size_t>(blockIdx.x) * G;\n",
         "  float* part = out + static_cast<size_t>(blockIdx.x) * G;\n  float sink = 0.0f;\n", 1),
        ("auto add_dw = [&](int r, int c, float acc) { pw[r * C + c] += acc; };",
         "auto add_dw = [&](int r, int c, float acc) { sink += acc; };", 1),
        ("  }\n}\n\n// Dynamic shared memory",
         "  }\n  if (sink == 1.2345f) part[0] = sink;\n}\n\n// Dynamic shared memory", 1)],
    # db's column sums
    "no db sums": [("      for (int c = threadIdx.x; c < C; c += kThreads) {\n"
                    "        float s = 0.0f;\n"
                    "        for (int p = 0; p < kTile; ++p) s += dz[p * s1 + c];\n"
                    "        pw[R * C + c] += s;\n      }\n", "", 1)],
    # d_h = d_z W^T of every layer but the first (and its barrier)
    "no d_h": [("      if (l > 0) {\n        __syncthreads();  // act(l) read",
                "      if (false) {\n        __syncthreads();  // act(l) read", 1)],
    # the barrier pair around each forward weight load
    "no forward barriers": [
        ("    __syncthreads();  // wbuf free, act(l) written\n"
         "    load_layer(pk, d, l, wbuf);\n    __syncthreads();\n",
         "    load_layer(pk, d, l, wbuf);\n", 1)],
    # the barrier pair around each backward weight load
    "no backward barriers": [
        ("      __syncthreads();  // d_z of layer l written\n      if (l < L - 1) {\n"
         "        load_layer(pk, d, l, wbuf);\n        __syncthreads();\n      }\n",
         "      if (l < L - 1) {\n        load_layer(pk, d, l, wbuf);\n      }\n", 1)],
    # the tile's first barrier and the one before d_h
    "no tile and d_h barriers": [
        ("    __syncthreads();  // the previous tile is done with act(0)\n", "", 1),
        ("        __syncthreads();  // act(l) read; now overwrite it with d_z of layer l-1\n",
         "", 1)],
}

# the variants that leave the arithmetic whole: they must give the bits of
# the production kernels (of the parent's own "as is", for its table)
WHOLE = ("as is", "k-loop unrolled by 2")
_SINCOSF = PARENT_VARIANTS["no sincosf"]
_SINK_AT = [("  float* part = out + static_cast<size_t>(blockIdx.x) * G;\n",
             "  float* part = out + static_cast<size_t>(blockIdx.x) * G;\n  float sink = 0.0f;\n",
             1),
            ("    }\n  }\n}\n\n// Dynamic shared memory",
             "    }\n  }\n  if (sink == 1.2345f) part[0] = sink;\n}\n\n"
             "// Dynamic shared memory", 1)]
# the source as it stands: 3xTF32 products on mma.sync, weights streamed by
# the TMA through two slots, dW by reductions into the partial
VARIANTS = {
    "as is": [],
    # every tensor-core product's k-loop (its operand loads, splits and mma)
    "no products": [("    for (int k0 = 0; k0 < K; k0 += 8) {",
                     "    for (int k0 = 0; k0 < 0; k0 += 8) {", 1)],
    # one TF32 pass, a_hi b_hi (the lo operands' splits go with them)
    "one TF32 pass": [("        mma_tf32(small[j], al, bh[j]);\n"
                       "        mma_tf32(small[j], ah, bl[j]);\n", "", 1)],
    # the a_lo b_hi and a_hi b_lo terms in accumulators of their own (three
    # chains a tile; other bits)
    "three accumulators": [
        ("    float big[2][4] = {}, small[2][4] = {};",
         "    float big[2][4] = {}, small[2][4] = {}, small2[2][4] = {};", 1),
        ("        mma_tf32(small[j], ah, bl[j]);", "        mma_tf32(small2[j], ah, bl[j]);", 1),
        ("      const float v[4] = {big[j][0] + small[j][0], big[j][1] + small[j][1],\n"
         "                          big[j][2] + small[j][2], big[j][3] + small[j][3]};",
         "      float v[4];\n"
         "      for (int e = 0; e < 4; ++e) v[e] = big[j][e] + (small[j][e] + small2[j][e]);",
         1)],
    # the k-loop unrolled by 2 instead of 4 (the same bits)
    "k-loop unrolled by 2": [("#pragma unroll 4\n    for (int k0 = 0; k0 < K; k0 += 8) {",
                              "#pragma unroll 2\n    for (int k0 = 0; k0 < K; k0 += 8) {", 1)],
    # the head's forward sums on the FMA pipes
    "no head forward": [("  for (int k = q; k < K; k += 4) s = fmaf(h[swz(p, k, hc)], "
                         "w[k * kHead + c], s);\n", "", 1)],
    # the encoding (act(0) left as the previous tile's)
    "no encoding": [("    encode_tile(xy, d, acts);\n    __syncthreads();\n",
                     "    __syncthreads();\n", 1)],
    # the operands' splits (three mma on the raw f32 bits)
    "no operand splits": [("  hi = (x + 0x1000u) & 0xffffe000u;\n"
                           "  lo = __float_as_uint(__fsub_rn(__uint_as_float(x), "
                           "__uint_as_float(hi)));", "  hi = x;\n  lo = x;", 1)],
    # the encoding's IEEE sincosf
    "no sincosf": _SINCOSF,
    # the hidden layers' dW reductions into the partial, summed into a
    # register instead
    "dW reductions to a register": _SINK_AT + [
        ("                          atomicAdd(reinterpret_cast<float2*>("
         "pw + (r + 8 * e) * C + c),\n"
         "                                    make_float2(v[2 * e], v[2 * e + 1]));",
         "                          sink += v[2 * e] + v[2 * e + 1];", 1)],
    # the hidden layers' db column sums on the tensor cores (their
    # reductions stay)
    "no db sums": [("    mma_tf32(acc, ones, lo);\n    mma_tf32(acc, ones, hi);\n", "", 1)],
    # d_h = d_z W^T of the hidden layers (the head's on FMAs, the copies and
    # barriers stay)
    "no d_h": [("          warp_gemm<kExact>(kTile, R, C, RowA{dz, C}, RowB{w, C},",
                "          if (false) warp_gemm<kExact>(kTile, R, C, RowA{dz, C}, RowB{w, C},",
                1)],
    # the tile's two barriers (before and after the encoding)
    "no tile barriers": [
        ("    __syncthreads();  // the previous tile is done with act(0); xy written\n", "", 1),
        ("    encode_tile(xy, d, acts);\n    __syncthreads();\n",
         "    encode_tile(xy, d, acts);\n", 1)],
    # (the barrier after each layer's dW and d_h stays: without it thread 0
    # could refill a slot whose copy a slower warp has not waited for yet,
    # and that warp would wait a phase too late)
}


def _entry(csrc: Path) -> str:
    """The C entry points of a checkout's field sources, to be compiled
    beside a patched header (each source's own includes would find the
    unpatched one in its own directory)."""
    return "\n".join((csrc / f).read_text() for f in ("field_fwd.cu", "field_bwd.cu"))


def patched(table: dict, csrc: Path = build.CSRC) -> dict:
    """name -> {header: text} of each variant of ``table`` on ``csrc``."""
    return {name: {HEADER: variants.patch(csrc / HEADER, edits, "field_variants")}
            for name, edits in table.items()}


_MICRO = r"""
#include <cstdint>
#include <cuda_runtime.h>

// eight independent m16n8k8 TF32 products a step, `iters` steps a warp
__global__ void mma_loop(float* out, int iters, float seed) {
  const uint32_t a = __float_as_uint(seed + threadIdx.x), b = __float_as_uint(seed);
  float acc[8][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
          "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
          : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]), "+f"(acc[j][3])
          : "r"(a), "r"(a), "r"(a), "r"(a), "r"(b), "r"(b));
    }
  }
  float s = 0.0f;
  for (int j = 0; j < 8; ++j) s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// eight independent FFMA chains a thread, `iters` steps
__global__ void ffma_loop(float* out, int iters, float seed) {
  const float x = seed + threadIdx.x;
  float acc[8];
  for (int j = 0; j < 8; ++j) acc[j] = j;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = fmaf(acc[j], x, 0.5f);
  }
  float s = 0.0f;
  for (int j = 0; j < 8; ++j) s += acc[j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int micro(int which, float* out, int blocks, int threads, int iters,
                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (which == 0) {
    mma_loop<<<blocks, threads, 0, st>>>(out, iters, 1.0f);
  } else {
    ffma_loop<<<blocks, threads, 0, st>>>(out, iters, 1.0f);
  }
  return static_cast<int>(cudaGetLastError());
}
"""


def micro_bench() -> dict:
    """TFLOP/s of the mma.sync TF32 loop and of the FFMA loop at 1, 2, 4, 8
    and 16 warps on every SM (one block a SM), and of one warp alone."""
    lib = ctypes.CDLL(str(variants.compile_all({"micro": {}}, _MICRO, OUT,
                                               "field_variants")["micro"]))
    lib.micro.argtypes = [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    lib.micro.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(sms * 16 * 32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    iters = 4096
    res = {}
    for which, name, flop in ((0, "mma.sync m16n8k8 tf32", 8 * 2 * 16 * 8 * 8),
                              (1, "ffma", 8 * 2 * 32)):
        for blocks, warps in ((1, 1), *((sms, w) for w in (1, 2, 4, 8, 16))):
            def call(blocks=blocks, warps=warps):
                err = lib.micro(which, out.data_ptr(), blocks, warps * 32, iters, stream)
                if err:
                    raise RuntimeError(f"micro-benchmark launch failed: cudaError {err}")
            call()
            ms = statistics.median(variants.timed_turns({"c": call}, 3)["c"])
            rate = blocks * warps * iters * flop / ms / 1e9
            res[f"{name}, {blocks} blocks x {warps} warps"] = {"ms": ms, "tflops": rate}
    return res


def hires_inputs():
    """The hires field's params (numpy seed 0, as ``chip_smoke.seeded_params``),
    the 1024^2 grid coords and a seed-1 cotangent, on the card."""
    from lomanerf_tpu_torch.models import ImageFieldConfig, image_grid_coords

    cfg = ImageFieldConfig.hires()
    rng = np.random.default_rng(0)
    sizes = [cfg.in_channels] + [cfg.filter_size] * (cfg.num_layers - 1) + [cfg.out_channels]
    params = {"w": [], "b": []}
    for fi, fo in zip(sizes[:-1], sizes[1:]):
        params["w"].append(torch.tensor(rng.standard_normal((fi, fo)) * np.sqrt(2.0 / fi),
                                        dtype=torch.float32, device="cuda"))
        params["b"].append(torch.tensor(rng.standard_normal(fo) * 0.5, dtype=torch.float32,
                                        device="cuda"))
    coords = image_grid_coords(SIZE, "cuda")
    cot = torch.tensor(np.random.default_rng(1).standard_normal((SIZE * SIZE, 3)),
                       dtype=torch.float32, device="cuda")
    return cfg, params, coords, cot


def parent_pack(params, width):
    """The packing of the kernels before their redesign: ``pack_params``'s
    layout (per layer W zero-padded to (rows, cols), then b)."""
    from lomanerf_tpu_torch.ops import fused_nerf

    empty = params["w"][0].new_zeros(0)
    return fused_nerf.pack_params(params, empty, empty, width)


class _OlderField:
    """A library built before the field entry points took their precision
    route (``exact``, the argument before the stream; they ran 3xTF32 or,
    before the tensor cores, f32 FMAs), and, ``gridless``, before
    ``field_fwd`` took its grid (no ``field_fwd_blocks``; its forward sizes
    its own grid), under this tree's C ABI: the calls drop the arguments it
    does not take (``exact`` must be 0)."""

    def __init__(self, lib, gridless: bool):
        self._lib, self._gridless = lib, gridless

    def __getattr__(self, name):
        return getattr(self._lib, name)

    @staticmethod
    def _tier(args):
        *rest, exact, stream = args
        if exact:
            raise SystemExit("field_variants: an older library has no exact f32 route")
        return (*rest, stream)

    def field_fwd_blocks(self, *dims):
        blocks = self._lib.field_bwd_blocks if self._gridless else self._lib.field_fwd_blocks
        return blocks(*dims[:-1])

    def field_bwd_blocks(self, *dims):
        return self._lib.field_bwd_blocks(*dims[:-1])

    def field_fwd(self, ws, coords, out, n_blocks, *rest):
        grid = () if self._gridless else (n_blocks,)
        return self._lib.field_fwd(ws, coords, out, *grid, *self._tier(rest))

    def field_bwd(self, *args):
        return self._lib.field_bwd(*self._tier(args))


def takes_tier(csrc: Path) -> bool:
    """Whether the field entry points of the ``csrc`` directory take their
    precision route (``exact``), as this tree's do."""
    return "int exact" in (csrc / "field_fwd.cu").read_text()


def bind_field(lib, tier: bool = True):
    """``lib`` with its field entry points' signatures set, under this tree's
    C ABI (an older library, built from sources without the precision route
    (``tier`` False), wrapped in :class:`_OlderField`)."""
    gridless = not hasattr(lib, "field_fwd_blocks")
    for name, argtypes in build.SIGNATURES.items():
        if not name.startswith("field_") or (gridless and name == "field_fwd_blocks"):
            continue
        if not tier:  # no exact argument: before the stream, or the last
            argtypes = argtypes[:-1] if name.endswith("_blocks") else argtypes[:-2] + [
                argtypes[-1]]
        if name == "field_fwd" and gridless:
            argtypes = argtypes[:3] + argtypes[4:]
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return lib if tier else _OlderField(lib, gridless)


def field_calls(lib, pk, G, coords, cot, dims, tile):
    """``(fwd, bwd)``: one ``field_fwd`` call and one ``field_bwd`` call of
    ``lib`` (:func:`bind_field`) on a packed buffer ``pk``, each grid at most
    the tiles of ``tile`` pixels."""
    n = coords.shape[0]

    def grid(entry):
        blocks = getattr(lib, f"{entry}_blocks")(*dims)
        if blocks <= 0:
            raise SystemExit(f"field_variants: {entry}_blocks gave {blocks}")
        return min(blocks, -(-n // tile))
    blocks, fwd_blocks = grid("field_bwd"), grid("field_fwd")
    out = torch.empty((n, dims[-1]), device="cuda")
    partials = torch.empty(blocks * G, device="cuda")
    grads = torch.empty(G, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def check(err, what):
        if err:
            raise RuntimeError(f"{what} launch failed: cudaError {err}")

    def fwd():
        check(lib.field_fwd(pk.data_ptr(), coords.data_ptr(), out.data_ptr(), fwd_blocks, n,
                            *dims, stream), "field_fwd")
        return out

    def bwd():
        check(lib.field_bwd(pk.data_ptr(), G, coords.data_ptr(), cot.data_ptr(),
                            partials.data_ptr(), blocks, grads.data_ptr(), n, *dims, stream),
              "field_bwd")
        return grads
    return fwd, bwd


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=None,
                    help="csrc directory of the field kernels before their redesign")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("field_variants: needs a CUDA card")
    from lomanerf_tpu_torch.ops import fused_mlp

    cfg, params, coords, cot = hires_inputs()
    nf = cfg.num_encoding_functions
    width = fused_mlp.kernel_width(params, 2, nf, 3)
    dims = (cfg.num_layers, cfg.in_channels, width, nf, 3, 0)  # the 3xTF32 route
    G = fused_mlp.grad_floats(params, width)
    tables = {"": (VARIANTS, build.CSRC, fused_mlp.pack_field_params(params, width),
                   fused_mlp.TILE, _KERNEL)}
    if args.parent is not None:
        tables["parent: "] = (PARENT_VARIANTS, args.parent, parent_pack(params, width), 64,
                               _PARENT_KERNEL)
    calls, libs, whole, kernel = {}, {}, {}, {}
    for prefix, (table, csrc, pk, tile, kname) in tables.items():
        built = variants.compile_all(patched(table, csrc), _entry(csrc), OUT,
                                     "field_variants", csrc)
        for name, path in built.items():
            libs[prefix + name] = path
            whole[prefix + name] = name in WHOLE
            kernel[prefix + name] = kname
            lib = bind_field(ctypes.CDLL(str(path)), takes_tier(csrc))
            calls[prefix + name] = field_calls(lib, pk, G, coords, cot, dims, tile)
    want = (fused_mlp._launch_fwd(tables[""][2], coords, *dims).clone(),
            fused_mlp._launch_bwd(tables[""][2], G, coords, cot, *dims).clone())
    same = {}
    for name, (fwd, bwd) in calls.items():
        got = (fwd().clone(), bwd().clone())
        again = (fwd().clone(), bwd().clone())
        same[name] = all(torch.equal(a, b) for a, b in zip(got, want))
        if whole[name] and not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise SystemExit(f"field_variants: {name!r}: repeat launches differ")
        if whole[name] and not name.startswith("parent") and not same[name]:
            raise SystemExit(f"field_variants: {name!r} leaves the arithmetic whole but its "
                             "outputs differ from the production kernels'")
    timed = {}
    for k, (fwd, bwd) in calls.items():
        timed[f"{k} | bwd"], timed[f"{k} | fwd"] = bwd, fwd
    ms = variants.timed_turns(timed, ROUNDS)
    smi = variants.card()
    print(f"field kernel variants, one hires field_bwd and one field_fwd call at "
          f"{SIZE}x{SIZE} px, {2 * ROUNDS} calls each in turns, on {smi}:")
    res = {}
    for name in calls:
        b, f = (statistics.median(ms[f"{name} | {w}"]) for w in ("bwd", "fwd"))
        res[name] = {"bwd_ms": b, "fwd_ms": f, "bits_equal_production": same[name],
                     "sass": variants.sass_counts(libs[name], kernel[name],
                                                  ("HMMA", "FFMA", "LDS", "STS", "BAR",
                                                   "RED", "MUFU")),
                     "ptxas": variants.ptxas(libs[name], kernel[name])}
        print(f"  {name:36s} field_bwd {b:8.3f} ms  field_fwd {f:8.3f} ms  bits equal "
              f"production: {same[name]}, SASS {res[name]['sass']}, ptxas "
              f"{res[name]['ptxas']}")
    micro = micro_bench()
    print("product routes, no memory traffic (TFLOP/s; data sheet: TF32 495, f32 67):")
    for k, v in micro.items():
        print(f"  {k:44s} {v['tflops']:9.2f} TFLOP/s ({v['ms']:.3f} ms)")
    out = {"what": "field_variants", "device": smi, "pixels": SIZE * SIZE, "variants": res,
           "micro": micro}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
