"""What each part of the narrow gradient walk costs on the card: variants of
``ops/csrc/nerf_grad.cuh`` (and of ``nerf_common.cuh``, whose forward it
runs), each with one piece taken out or one number changed, timed in turns
on one 262,144-ray ``small`` ``nerf_train`` call (``bench.py``'s batch and
``chip_smoke.py``'s params, numpy seed 0): 7,864,320 ray-sample rows.

Each variant is the headers with the textual edits of ``VARIANTS`` (every
edit must match its source exactly as often as it names), built by
``scripts/variants.py`` into a library of its own under
``build/grad_variants/<hash>/`` and launched through a C entry that calls
``launch_grad<32, true, false>`` (``nerf_train``'s instance at the
``small`` width, with its fixed-order block sum).  The variants that leave
the arithmetic whole must give the production kernel's bits (the loss and
dW/db of ``fused_nerf._launch_grad``); the others compute something else
and are timed only.  For each, the SASS of ``nerf_grad_kernel`` is counted
(all instructions, ``FFMA``, shared-memory loads and stores, barriers) and
its registers and spills read from ``ptxas -v``.

``--parent DIR`` also builds the variants of ``PARENT_VARIANTS`` from the
``csrc`` directory of a checkout of the walk before its register-tile
redesign, and times them in the same turns (their "as is" must give the
production bits too: the redesign keeps every bit).

Needs a card and the CUDA toolkit.  Run:

    python -m lomanerf_tpu_torch.scripts.grad_variants [--parent DIR]

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

HEADERS = ("nerf_grad.cuh", "nerf_common.cuh")
ROUNDS = 5  # rounds of turns: each variant is timed 2 * ROUNDS times
RAYS = 262144  # bench.py's small batch
_KERNEL = "nerf_grad_kernel"
OUT = build.BUILD_ROOT.parent / "grad_variants"
_G, _C = HEADERS

_CONST4 = "make_float4(0.5f, 0.25f, 0.125f, 0.0625f)"
_DW = "    accumulate_block<W>(lay, act, dz, acc, tid);\n"
_NO_DW = (_G, _DW, "", 1)
_NO_D_H = (_G, "    if (L >= 2) backprop_hidden<W>(lay, dz_head, my_act, my_dz);\n", "", 1)
_NO_BARRIER = (_G, _DW + "    __syncthreads();\n", _DW, 1)
_NO_FWD_LOADS = (_C, "    const float4 v = w4[j];", f"    const float4 v = {_CONST4};", 1)
_NO_SINCOSF = (_C, "      sincosf(__fmul_rn(scale, p[c]), &sn, &cs);",
               "      sn = __fmul_rn(scale, p[c]);\n      cs = 0.5f * sn;", 1)
_128 = (_G, "constexpr int kGradThreads = 64;", "constexpr int kGradThreads = 128;", 1)

# name -> (edits (file, old, new, times), whether the arithmetic is whole)
VARIANTS = {
    "as is": ([], True),
    # the per-sample block reduction of dW/db (its barriers stay)
    "no dW stage": ([_NO_DW], False),
    # pass 1's MLP (the rgba from the point instead; compositing stays)
    "no pass-1 MLP": ([(_G, "    walk_forward<W>(p, lay, raw, my_act);",
                        "    if (pass1) {\n"
                        "      for (int k = 0; k < kHead; ++k) raw[k] = p[k % 3];\n"
                        "    } else {\n"
                        "      walk_forward<W>(p, lay, raw, my_act);\n"
                        "    }", 1)], False),
    # d_h = d_z W^T of every layer below the head (d_z rows left unwritten)
    "no backprop_hidden": ([_NO_D_H], False),
    # the barrier after the dW stage (a race: timing only)
    "no second barrier": ([_NO_BARRIER], False),
    # every float4 weight load of the forwards and of d_h from a constant
    "no weight loads": ([_NO_FWD_LOADS,
                         (_G, "      const float4 w = head[i];",
                          f"      const float4 w = {_CONST4};", 2),
                         (_G, "          const float4 v = wl[i * (W / 4) + j];",
                          f"          const float4 v = {_CONST4};", 1),
                         (_G, "            const float4 v = wl[(i0 + q) * (W / 4) + j];",
                          f"            const float4 v = {_CONST4};", 1)], False),
    # the encoding's IEEE sincosf, in both passes
    "no sincosf": ([_NO_SINCOSF], False),
    # 128 rays a block (other partials: other bits)
    "128 threads": ([_128], False),
}

# the same pieces of the walk before its redesign (one dW entry at a time,
# a forward inlined for each pass, d_h unrolled over every unit)
PARENT_VARIANTS = {
    "as is": ([], True),
    "no dW stage": ([_NO_DW], False),
    "no pass-1 MLP": ([(_G, "    mlp_rgba<W, false>(p, lay, rgba, nullptr, 0);",
                        "    for (int k = 0; k < kHead; ++k) rgba[k] = p[k % 3];", 1)], False),
    "no backprop_hidden": ([_NO_D_H], False),
    "no second barrier": ([_NO_BARRIER], False),
    "no weight loads": ([_NO_FWD_LOADS,
                         (_G, "    const float4 w = head[i];",
                          f"    const float4 w = {_CONST4};", 1),
                         (_G, "        const float4 v = wl[i * (W / 4) + j];",
                          f"        const float4 v = {_CONST4};", 1)], False),
    "no sincosf": ([_NO_SINCOSF], False),
    "128 threads": ([_128], False),
}

_ENTRY = r"""
#include "nerf_grad.cuh"

extern "C" int variant_train(const float* pk, int pk_floats, int G,
                             const float* origins, const float* directions,
                             const float* target, float* partials, float* out,
                             int n_rays, int S, int L, int in_dim, int nf,
                             int loma, void* stream) {
  return static_cast<int>(nerf::launch_grad<32, true, false>(
      pk, pk_floats, G, nullptr, nullptr, origins, directions, target,
      partials, out, n_rays, S, L, in_dim, nf, loma,
      static_cast<cudaStream_t>(stream)));
}
"""


def patched(table: dict, csrc: Path = build.CSRC) -> dict:
    """name -> {header: text} of each variant of ``table`` on the headers of
    ``csrc``."""
    return {name: {h: variants.patch(csrc / h, [e[1:] for e in edits if e[0] == h],
                                     "grad_variants") for h in HEADERS}
            for name, (edits, _) in table.items()}


def small_call_inputs(n: int = RAYS):
    """The packed ``small`` params (chip_smoke's numpy seed-0 draw) and
    bench.py's first batch (seed 0) on the card: ``(cfg, params, pk, G,
    (o, d, t, dists, tgt))``."""
    from lomanerf_tpu_torch.core import rays
    from lomanerf_tpu_torch.models import NeRFConfig
    from lomanerf_tpu_torch.ops import fused_nerf

    cfg = NeRFConfig.small()
    rng = np.random.default_rng(0)
    sizes = [cfg.in_channels] + [cfg.filter_size] * (cfg.num_layers - 1) + [cfg.out_channels]
    params = {"w": [], "b": []}
    for fi, fo in zip(sizes[:-1], sizes[1:]):
        params["w"].append(torch.tensor(rng.standard_normal((fi, fo)) * np.sqrt(2.0 / fi),
                                        dtype=torch.float32, device="cuda"))
        params["b"].append(torch.tensor(rng.standard_normal(fo) * 0.5, dtype=torch.float32,
                                        device="cuda"))
    rng = np.random.default_rng(0)
    o, d = (torch.tensor(rng.standard_normal((n, 3)), dtype=torch.float32, device="cuda")
            for _ in range(2))
    t, dists = rays.uniform_depths(cfg.near, cfg.far, cfg.num_samples, "cuda")
    tgt = torch.tensor(rng.random((n, 3)), dtype=torch.float32, device="cuda")
    pk = fused_nerf.pack_params(params, t, dists, 32)
    return cfg, params, pk, fused_nerf.grad_floats(params, 32), (o, d, t, dists, tgt)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=None,
                    help="csrc directory of the walk before its redesign")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("grad_variants: needs a CUDA card")
    from lomanerf_tpu_torch.ops import fused_nerf

    tables = {"": (VARIANTS, build.CSRC)}
    if args.parent is not None:
        tables["parent: "] = (PARENT_VARIANTS, args.parent)
    libs, whole = {}, {}
    for prefix, (table, csrc) in tables.items():
        built = variants.compile_all(patched(table, csrc), _ENTRY, OUT, "grad_variants", csrc)
        libs.update({prefix + k: v for k, v in built.items()})
        whole.update({prefix + k: w for k, (_, w) in table.items()})
    cfg, params, pk, G, (o, d, t, dists, tgt) = small_call_inputs()
    L, S, nf = cfg.num_layers, cfg.num_samples, cfg.num_encoding_functions
    want = fused_nerf._launch_grad("nerf_train", pk, G, t, dists, o, d, tgt, cfg, L, 32)
    partials = torch.empty((-(-RAYS // 64), G + 1), dtype=torch.float32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    calls = {}
    for name, path in libs.items():
        fn = ctypes.CDLL(str(path)).variant_train
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 5 \
            + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        out = torch.empty_like(want)

        def call(fn=fn, out=out):
            err = fn(pk.data_ptr(), pk.numel(), G, o.data_ptr(), d.data_ptr(), tgt.data_ptr(),
                     partials.data_ptr(), out.data_ptr(), RAYS, S, L, cfg.in_channels, nf,
                     int(cfg.mode == "loma"), stream)
            if err:
                raise RuntimeError(f"variant launch failed: cudaError {err}")
            return out
        calls[name] = call
    same = {name: bool(torch.equal(call(), want)) for name, call in calls.items()}
    for name, ok in same.items():
        if whole[name] and not ok:
            raise SystemExit(f"grad_variants: {name!r} leaves the arithmetic whole but its "
                             "loss and dW/db differ from the production kernel's")
    ms = variants.timed_turns(calls, ROUNDS)
    smi = variants.card()
    print(f"narrow gradient walk variants, one {RAYS}-ray small nerf_train call "
          f"({RAYS * S} rows), {2 * ROUNDS} calls each in turns, on {smi}:")
    res = {}
    for name in calls:
        med = statistics.median(ms[name])
        res[name] = {"ms": med, "min_ms": min(ms[name]), "bits_equal_production": same[name],
                     "sass": variants.sass_counts(libs[name], _KERNEL,
                                                  ("FFMA", "LDS", "STS", "BAR", "MUFU")),
                     "ptxas": variants.ptxas(libs[name], _KERNEL)}
        print(f"  {name:32s} median {med:8.3f} ms (min {min(ms[name]):8.3f}), bits equal "
              f"production: {same[name]}, SASS {res[name]['sass']}, ptxas {res[name]['ptxas']}")
    out = {"what": "grad_variants", "device": smi, "rows": RAYS * S, "variants": res}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
