"""What each part of the narrow render forward costs on the card: variants of
``ops/csrc/nerf_render_fwd.cu`` and the headers it includes, each with one
piece taken out or one number changed, timed in turns on two calls:

* #1, ``nerf_render_fwd``: one 800x800 ``small`` frame (640,000 rays x 30
  samples at shared depths: the trained fixture's params and the rays of
  its second pose, as ``chip_smoke.py`` phase 3 renders it);
* #4, ``nerf_render_fwd_rays``: one 262,144-ray ``small`` call on per-ray
  ``(N, S)`` depths (``bench.py``'s rays and ``chip_smoke.py``'s seed-0
  params, as ``grad_variants``; depths from ``NeRFModel.sample``, seed 3).

Each variant is the sources with the textual edits of its table (every edit
must match its file exactly as often as it names), built by
``scripts/variants.py`` into a library of its own under
``build/render_variants/<hash>/``: the kernel's source is compiled as a
header beside the patched headers, so its C entry points are the
production ones.  The variants that leave the arithmetic whole must give
the production kernel's bits (``fused_nerf._launch``); the others compute
something else and are timed only.  For each, the SASS of the two kernel
instances at W = 32 is counted (all instructions, ``FFMA``, shared-memory
loads, ``MUFU``) and their registers and spills read from ``ptxas -v``.

``--parent DIR`` also builds the variants of ``PARENT_VARIANTS`` from the
``csrc`` directory of a checkout of the render before its redesign (one
sample a thread) and times them in the same turns; its "as is" must give
the production bits too (the redesign keeps every bit).

Also: a micro-benchmark of the shared-memory loads the render issues, with
no other traffic (a broadcast float4, a float4 a lane, a broadcast float).

Needs a card and the CUDA toolkit.  Run:

    python -m lomanerf_tpu_torch.scripts.render_variants [--parent DIR]

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

ROUNDS = 5  # rounds of turns: each call is timed 2 * ROUNDS times
SIZE = 800  # the served frame
RAYS = 262144  # bench.py's small batch
OUT = build.BUILD_ROOT.parent / "render_variants"
_SRC, _C = "nerf_render_fwd.cu", "nerf_common.cuh"
_KERNEL = "nerf_render_fwd_kernel"
# the two instances at the small width, by their mangled template arguments
INSTANCES = {"nerf_render_fwd": "ILi32ELb0E", "nerf_render_fwd_rays": "ILi32ELb1E"}
FIXTURE = Path(__file__).resolve().parents[2] / "tests" / "data" / "convergence_64_step5000.npz"

_CONST4 = "make_float4(0.5f, 0.25f, 0.125f, 0.0625f)"
_NO_SINCOSF = (_C, "      sincosf(__fmul_rn(scale, p[c]), &sn, &cs);",
               "      sn = __fmul_rn(scale, p[c]);\n      cs = 0.5f * sn;", 1)
# every ray reads ray 0's depth row (cached, one line a warp): the per-ray
# depth reads' cost, S floats apart across a warp
_NO_RAY_ROWS = (_C, "    *ts = t_rays + row;\n    *ds = d_rays + row;",
                "    *ts = t_rays;\n    *ds = d_rays;", 1)

# the render before its redesign: one thread a ray walks its samples one at
# a time through nerf_common.cuh's mlp_rgba (the train walk's forward)
PARENT_FILES = (_SRC, _C)
PARENT_VARIANTS = {
    "as is": ([], True),
    # every float4 weight load of the MLP from a constant
    "no weight loads": ([(_C, "    const float4 v = w4[j];",
                          f"    const float4 v = {_CONST4};", 1)], False),
    # the encoding's IEEE sincosf
    "no sincosf": ([_NO_SINCOSF], False),
    # alpha's expf, the rgb sigmoids and the compositing step (the head's
    # outputs still feed the colour, so the MLP stays)
    "no expf, sigmoid, compositing": ([(
        _SRC,
        "    float alpha, c;\n"
        "    nerf::sample_alpha(rgba[3], ds[s], &alpha, &c);\n"
        "    const float wgt = alpha * nerf::transmittance(&P, c, s, loma);\n"
        "#pragma unroll\n"
        "    for (int k = 0; k < 3; ++k) acc[k] = fmaf(wgt, nerf::sigmoidf(rgba[k]), acc[k]);",
        "    for (int k = 0; k < 3; ++k) acc[k] = fmaf(rgba[k], ds[s], acc[k] + rgba[3]);",
        1)], False),
    "no per-ray depth rows": ([_NO_RAY_ROWS], False),
    # 256 threads a block (the same arithmetic a ray)
    "256 threads": ([(_SRC, "constexpr int kThreads = 128;", "constexpr int kThreads = 256;", 1)],
                    True),
}

_M = "nerf_render_mlp.cuh"
_COMPOSITE = (
    "      float alpha, c;\n"
    "      nerf::sample_alpha(rgba[j][3], ds[s], &alpha, &c);\n"
    "      const float wgt = alpha * nerf::transmittance(&P, c, s, loma);\n"
    "#pragma unroll\n"
    "      for (int k = 0; k < 3; ++k) acc[k] = fmaf(wgt, nerf::sigmoidf(rgba[j][k]), acc[k]);")


def _plan(group=None, blocks=None):
    """Edits of RenderPlan at W = 32: the group, the blocks an SM the kernel
    is built for (the same bits)."""
    edits = []
    if group is not None:
        edits.append((_M, "  static constexpr int kGroup = 2;",
                      f"  static constexpr int kGroup = W == 32 ? {group} : 2;", 1))
    if blocks is not None:
        edits.append((_M, "  static constexpr int kMinBlocks = W == 32 ? 4 : 1;",
                      f"  static constexpr int kMinBlocks = W == 32 ? {blocks} : 1;", 1))
    return edits


def _threads(n):
    return [(_SRC, "constexpr int kThreads = 128;", f"constexpr int kThreads = {n};", 1)]


def _unroll(n):
    return [(_M, "#pragma unroll 2\n  for (int k = 0; k < W; ++k) {",
             f"#pragma unroll{n}\n  for (int k = 0; k < W; ++k) {{", 1)]


_UNSTAGED_DEPTHS = [
    (_SRC, "    if (kPerRay) {  // the block's rows", "    if (false) {  // the block's rows", 1),
    (_SRC, "  const float* ts = kPerRay ? t_st + threadIdx.x * SS : lay.ts;\n"
           "  const float* ds = kPerRay ? d_st + threadIdx.x * SS : lay.ds;",
     "  const float* ts = kPerRay ? t_rays + static_cast<size_t>(ray) * S : lay.ts;\n"
     "  const float* ds = kPerRay ? d_rays + static_cast<size_t>(ray) * S : lay.ds;", 1)]

# the render as the source stands: a thread's samples in pairs
# (nerf_render_mlp.cuh), each layer's input staged in shared memory, per-ray
# depths staged by the block
FILES = (_SRC, _C, _M)
VARIANTS = {
    "as is": ([], True),
    # every float4 weight load of the group's MLP from a constant (the
    # biases stay)
    "no weight loads": ([(_M, "    const float4 v = w4[j];",
                          f"    const float4 v = {_CONST4};", 1)], False),
    # the encoding's IEEE sincosf
    "no sincosf": ([(_M, "      for (int s = 0; s < K; ++s) sincosf(__fmul_rn(scale, p[s][c]), "
                         "&sn[s], &cs[s]);",
                     "      for (int s = 0; s < K; ++s) {\n"
                     "        sn[s] = __fmul_rn(scale, p[s][c]);\n        cs[s] = 0.5f * sn[s];\n"
                     "      }", 1)], False),
    "no expf, sigmoid, compositing": ([(
        _SRC, _COMPOSITE,
        "      for (int k = 0; k < 3; ++k) acc[k] = fmaf(rgba[j][k], ds[s], acc[k] + rgba[j][3]);",
        1)], False),
    # per-ray depths read from device memory, S floats apart across a warp,
    # instead of the block's staged rows (the staging loop skipped)
    "depths unstaged": (_UNSTAGED_DEPTHS, True),
    # one sample a thread, or four (the same bits: a sample's arithmetic
    # does not depend on its group)
    "group of 1": (_plan(group=1), True),
    "group of 4": (_plan(group=4, blocks=1), True),
    # no bound on the registers (3 blocks an SM at 130), or five blocks
    "no blocks-an-SM bound": (_plan(blocks=1), True),
    "5 blocks an SM": (_plan(blocks=5), True),
    # the loop over a layer's staged inputs not unrolled, unrolled by 4 or
    # whole, not by 2
    "input loop rolled": (_unroll(" 1"), True),
    "input loop unrolled by 4": (_unroll(" 4"), True),
    "input loop unrolled whole": (_unroll(""), True),
    "256 threads": (_threads(256) + _plan(blocks=2), True),
}

_ENTRY = '#include "render_entry.cuh"\n'  # the kernel's source, patched, as a header


_MICRO = r"""
#include <cuda_runtime.h>

// `iters` x 8 shared-memory loads a thread, each consumed by one FADD:
// mode 0 a float4 every lane of the warp reads (a broadcast), 1 a float4 of
// its own (16 B apart across the warp), 2 a broadcast float
__global__ void lds_loop(float* out, int iters, int mode) {
  __shared__ __align__(16) float buf[8 * 32 * 4];
  for (int i = threadIdx.x; i < 8 * 32 * 4; i += blockDim.x) buf[i] = i;
  __syncthreads();
  const unsigned base = static_cast<unsigned>(__cvta_generic_to_shared(buf));
  const unsigned lane = threadIdx.x & 31;
  float acc = 0.0f;
  for (int i = 0; i < iters; ++i) {
    float x[8];  // eight loads in flight, then their sum
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const unsigned slot = (i + j) & 7;
      float y, z, w;
      if (mode == 0) {
        asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
                     : "=f"(x[j]), "=f"(y), "=f"(z), "=f"(w) : "r"(base + slot * 512));
      } else if (mode == 1) {
        asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
                     : "=f"(x[j]), "=f"(y), "=f"(z), "=f"(w)
                     : "r"(base + slot * 512 + lane * 16));
      } else {
        asm volatile("ld.shared.f32 %0, [%1];" : "=f"(x[j]) : "r"(base + slot * 512));
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) acc += x[j];  // the asm is volatile: each load stays whole
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}

extern "C" int micro(int mode, float* out, int blocks, int threads, int iters, void* stream) {
  lds_loop<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(out, iters, mode);
  return static_cast<int>(cudaGetLastError());
}
"""


def micro_bench() -> dict:
    """Shared-memory loads a second per SM on this card, with no other
    traffic: broadcast float4s (the render's weight reads), a float4 a lane
    (its stage reads at a group of 4) and broadcast floats, at 4, 8 and 16
    warps on every SM (one block a SM); the bytes they bring into registers
    a clock-free rate (GB/s per SM)."""
    lib = ctypes.CDLL(str(variants.compile_all({"micro": {}}, _MICRO, OUT,
                                               "render_variants")["micro"]))
    lib.micro.argtypes = [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.micro.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(sms * 16 * 32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    iters, res = 4096, {}
    for mode, name, nbytes in ((0, "LDS.128 broadcast", 16), (1, "LDS.128 a lane", 16),
                               (2, "LDS.32 broadcast", 4)):
        for warps in (4, 8, 16):
            def call(mode=mode, warps=warps):
                err = lib.micro(mode, out.data_ptr(), sms, warps * 32, iters, stream)
                if err:
                    raise RuntimeError(f"micro-benchmark launch failed: cudaError {err}")
            call()
            ms = statistics.median(variants.timed_turns({"c": call}, 3)["c"])
            loads = warps * iters * 8 / (ms * 1e-3)  # warp-wide loads a second per SM
            res[f"{name}, {warps} warps an SM"] = {
                "ms": ms, "g_warp_loads_per_s_per_sm": loads / 1e9,
                "gb_per_s_per_sm_into_registers": loads * 32 * nbytes / 1e9}
    return res


def patched(table: dict, files, csrc: Path = build.CSRC) -> dict:
    """name -> {file: text} of each variant of ``table`` on the sources of
    ``csrc`` (the kernel's source under the name ``render_entry.cuh``)."""
    out = {}
    for name, (edits, _) in table.items():
        texts = {f: variants.patch(csrc / f, [e[1:] for e in edits if e[0] == f],
                                   "render_variants") for f in files}
        texts["render_entry.cuh"] = texts.pop(_SRC)
        out[name] = texts
    return out


def frame_inputs():
    """The 800x800 frame of ``chip_smoke.py`` phase 3 on the card: ``(cfg,
    params, (o, d, t, dists))``, the trained fixture's ``small`` params and
    the rays of its second pose at the uniform depths."""
    from lomanerf_tpu_torch.core import normalized_intrinsics, rays
    from lomanerf_tpu_torch.models import NeRFConfig
    from lomanerf_tpu_torch.train.checkpoint import load_params_npz

    cfg = NeRFConfig.small()
    fx = np.load(FIXTURE)
    p = load_params_npz(FIXTURE)
    params = {k: [torch.as_tensor(x, dtype=torch.float32, device="cuda") for x in v]
              for k, v in p.items()}
    K = normalized_intrinsics(float(fx["focal"]), device="cuda")
    o, d = rays.get_rays(SIZE, SIZE, K, torch.from_numpy(fx["poses"][1]).cuda())
    t, dists = rays.uniform_depths(cfg.near, cfg.far, cfg.num_samples, "cuda")
    return cfg, params, (o.contiguous(), d.contiguous(), t, dists)


def rays_inputs():
    """The 262,144-ray call on per-ray depths: ``(cfg, params, (o, d, tj,
    dj))``, ``grad_variants.small_call_inputs``'s rays and params and depths
    from ``NeRFModel.sample`` (seed 3)."""
    from lomanerf_tpu_torch.models import NeRFModel
    from lomanerf_tpu_torch.scripts.grad_variants import small_call_inputs

    cfg, params, _, _, (o, d, _, _, _) = small_call_inputs(RAYS)
    _, tj, dj = NeRFModel(cfg).sample(o, d, generator=torch.Generator("cuda").manual_seed(3))
    return cfg, params, (o, d, tj.contiguous(), dj.contiguous())


def bound_lib(path: Path) -> ctypes.CDLL:
    """A variant's library with the two render entry points' signatures."""
    lib = ctypes.CDLL(str(path))
    for name in INSTANCES:
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = build.SIGNATURES[name], ctypes.c_int
    return lib


def render_call(lib, cfg, params, batch, width: int = 32):
    """One launch of ``lib``'s render forward on ``batch`` (``(o, d, t,
    dists)``: ``nerf_render_fwd_rays`` for ``(N, S)`` depths), through
    ``fused_nerf._launch`` bound to ``lib``; returns a callable giving the
    colours."""
    from lomanerf_tpu_torch.ops import fused_nerf

    o, d, t, dists = batch
    pk = fused_nerf.pack_params(params, t, dists, width)
    load = build.load

    def call():
        build.load = lambda: lib
        try:
            return fused_nerf._launch(pk, t, dists, o, d, cfg, len(params["w"]), width)
        finally:
            build.load = load
    return call


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=None,
                    help="csrc directory of the render before its redesign")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("render_variants: needs a CUDA card")
    tables = {"": (VARIANTS, FILES, build.CSRC)}
    if args.parent is not None:
        tables["parent: "] = (PARENT_VARIANTS, PARENT_FILES, args.parent)
    libs, whole = {}, {}
    for prefix, (table, files, csrc) in tables.items():
        built = variants.compile_all(patched(table, files, csrc), _ENTRY, OUT,
                                     "render_variants", csrc)
        libs.update({prefix + k: v for k, v in built.items()})
        whole.update({prefix + k: w for k, (_, w) in table.items()})
    inputs = {"nerf_render_fwd": frame_inputs(), "nerf_render_fwd_rays": rays_inputs()}
    want = {e: render_call(build.load(), *inp)() for e, inp in inputs.items()}
    calls, same = {}, {}
    for name, path in libs.items():
        lib = bound_lib(path)
        for entry, inp in inputs.items():
            call = render_call(lib, *inp)
            calls[f"{name} | {entry}"] = call
            same[f"{name} | {entry}"] = bool(torch.equal(call(), want[entry]))
    for key, ok in same.items():
        if whole[key.split(" | ")[0]] and not ok:
            raise SystemExit(f"render_variants: {key!r} leaves the arithmetic whole but its "
                             "colours differ from the production kernel's")
    ms = variants.timed_turns(calls, ROUNDS)
    smi = variants.card()
    print(f"narrow render variants, one {SIZE}x{SIZE} small frame (#1, {SIZE * SIZE} rays) "
          f"and one {RAYS}-ray per-ray-depth call (#4), {2 * ROUNDS} calls each in turns, on "
          f"{smi}:")
    res = {}
    for name, path in libs.items():
        res[name] = {}
        for entry, inst in INSTANCES.items():
            key = f"{name} | {entry}"
            med = statistics.median(ms[key])
            kernel = _KERNEL + inst
            res[name][entry] = {
                "ms": med, "min_ms": min(ms[key]), "bits_equal_production": same[key],
                "sass": variants.sass_counts(path, kernel, ("FFMA", "LDS", "STS", "MUFU")),
                "ptxas": variants.ptxas(path, kernel)}
            print(f"  {name:32s} {entry:21s} median {med:8.3f} ms (min {min(ms[key]):8.3f}), "
                  f"bits equal production: {same[key]}, SASS {res[name][entry]['sass']}, "
                  f"ptxas {res[name][entry]['ptxas']}")
    micro = micro_bench()
    print("shared-memory loads, no other traffic (per SM):")
    for k, v in micro.items():
        print(f"  {k:34s} {v['g_warp_loads_per_s_per_sm']:7.3f} G warp-loads/s, "
              f"{v['gb_per_s_per_sm_into_registers']:8.1f} GB/s into registers ({v['ms']:.3f} ms)")
    out = {"what": "render_variants", "device": smi, "variants": res, "micro": micro}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
