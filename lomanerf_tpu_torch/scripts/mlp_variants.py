"""What each part of the fused MLP's layer costs on the card: variants of
``ops/csrc/nerf_wide_mlp.cuh``, each with one piece taken out, timed in
turns on one 65,536-ray ``full`` chunk (8,388,608
rows, the size of ``chip_smoke.py``'s phase-9 chunk).

Each variant is the header with the textual edits of ``VARIANTS`` (every
edit must match the source exactly as often as it names, so a changed
source fails here rather than timing something else), compiled by ``nvcc``
with the port's flags into a library of its own under
``build/mlp_variants/<hash>/``, all compiled at once, and launched through
a C entry that calls ``mlp_launch<256, false>`` (the flagship's instance).
The variants that leave the arithmetic whole must give the production
kernel's bits (``wide_mlp.wide_mlp``); the others compute something else
and are timed only.  For each, the SASS of its kernel is counted by
``cuobjdump`` (all instructions, the bf16 conversions ``F2FP`` and the
``HGMMA``) and its registers and spills read from ``ptxas -v``: where an
edit lets the compiler drop work beside the piece it takes out, the counts
show it.

Needs a card and the CUDA toolkit.  Run:

    python -m lomanerf_tpu_torch.scripts.mlp_variants

The last line is one JSON object with the numbers.
"""

from __future__ import annotations

import ctypes
import json
import statistics

import torch

from lomanerf_tpu_torch.ops import build
from lomanerf_tpu_torch.scripts import variants

HEADER = build.CSRC / "nerf_wide_mlp.cuh"
ROUNDS = 5  # rounds of turns: each variant is timed 2 * ROUNDS times
_KERNEL = "mlp_wgmma_kernel"
OUT = build.BUILD_ROOT.parent / "mlp_variants"

_WAIT_FULL = "mbar_wait(&full[s], ((it + st) / kMlpStages) & 1);"
_REFILL = "if (it >= kMlpStages) mbar_wait(&empty[s], ((it / kMlpStages) - 1) & 1);"
_STORE = "stmatrix_x4(act_s + act_at(st_r, (j + st_j) * 8),"
_ENCODE = """      encode_rows<kPerRay>(act, wg, t, tile_row, rows, S, origins, directions, ts, nf,
                           n_st0 * kMlpBK);
"""

# name -> (edits (old, new, times), whether the arithmetic is whole)
VARIANTS = {
    "as is": ([], True),
    # the stmatrix of H_{L-1} into shared memory (the hidden layers' outputs
    # stay in registers), its arithmetic kept (the stores sit behind a
    # condition that never holds; the TMA stores then send what rows hold)
    "no epilogue stores": ([(_STORE, "if (rows < 0) " + _STORE, 1)], False),
    # the weights never keep a consumer waiting: the producer fills the ring
    # once and copies nothing more, and the consumers wait only for that
    # first fill (later stages compute with whatever the ring holds): what
    # the waits for weights from L2 cost
    "no weight waits": ([(_REFILL, "if (it >= kMlpStages) continue;", 1),
                         (_WAIT_FULL, "if (it + st < kMlpStages) mbar_wait(&full[s], 0);", 1)],
                        False),
    # the encoding of each tile (its sincosf): layer 0 reads what the rows hold
    "no encoding": ([(_ENCODE, "", 1)], False),
    # the two consumer warpgroups issue when they like, not a layer each in turn
    "no ping-pong": ([('asm volatile("bar.sync %0, 256;" ::"r"(wg + 3) : "memory");', "", 1),
                      ('asm volatile("bar.arrive %0, 256;" ::"r"((wg ^ 1) + 3) : "memory");', "",
                       1)], True),
}

_ENTRY = r"""
#include "nerf_wide_mlp.cuh"

extern "C" int variant_mlp(const void* W, const float* b, const float* ts,
                           const float* origins, const float* directions,
                           void* out, int n, int S, int L, int kc, int nf,
                           void* stream) {
  return static_cast<int>(wide::mlp_launch<256, false>(
      static_cast<const __nv_bfloat16*>(W), b, ts, origins, directions,
      static_cast<__nv_bfloat16*>(out), n * S, S, L, kc, nf,
      static_cast<cudaStream_t>(stream)));
}
"""


def patched(edits) -> str:
    return variants.patch(HEADER, edits, "mlp_variants")


def main() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("mlp_variants: needs a CUDA card")
    from lomanerf_tpu_torch.core import uniform_depths
    from lomanerf_tpu_torch.models import NeRFConfig, NeRFModel
    from lomanerf_tpu_torch.ops import fused_nerf, wide_mlp

    libs = variants.compile_all(
        {name: {HEADER.name: patched(edits)} for name, (edits, _) in VARIANTS.items()},
        _ENTRY, OUT, "mlp_variants")
    cfg = NeRFConfig.full()
    model = NeRFModel(cfg, device="cuda")
    model.init(torch.Generator().manual_seed(0))
    W, b = fused_nerf.pack_wide_params(model.params, 256, cfg.compute_dtype)
    n = fused_nerf.wide_chunk_rays(cfg, 256)
    g = torch.Generator("cuda").manual_seed(3)
    o, d = (torch.randn((n, 3), generator=g, device="cuda") for _ in range(2))
    t, _ = uniform_depths(cfg.near, cfg.far, cfg.num_samples, "cuda")
    S, L = cfg.num_samples, cfg.num_layers
    kc, nf = fused_nerf._wide_args(cfg, 256, L)[3:5]
    want = wide_mlp.wide_mlp(W, b, t, o, d, cfg)
    stream = torch.cuda.current_stream().cuda_stream
    calls = {}
    for name, path in libs.items():
        fn = ctypes.CDLL(str(path)).variant_mlp
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        out = torch.empty_like(want)

        def call(fn=fn, out=out):
            err = fn(W.data_ptr(), b.data_ptr(), t.data_ptr(), o.data_ptr(), d.data_ptr(),
                     out.data_ptr(), n, S, L, kc, nf, stream)
            if err:
                raise RuntimeError(f"variant launch failed: cudaError {err}")
            return out
        calls[name] = call
    print(f"mlp_variants: {len(libs)} variants compiled", flush=True)
    same = {}
    for name, call in calls.items():  # one at a time, so that a variant that hangs is named
        print(f"mlp_variants: checking {name!r}", flush=True)
        same[name] = bool(torch.equal(call(), want))
    for name, (_, whole) in VARIANTS.items():
        if whole and not same[name]:
            raise SystemExit(f"mlp_variants: {name!r} leaves the arithmetic whole but its "
                             "H_{L-1} differs from the production kernel's")
    ms = variants.timed_turns(calls, ROUNDS)
    flops = 2.0 * n * S * (cfg.in_channels * 256 + (L - 2) * 256 * 256)
    smi = variants.card()
    print(f"fused MLP variants, one {n}-ray full chunk ({n * S} rows, {flops / 1e12:.2f} TFLOP), "
          f"{2 * ROUNDS} calls each in turns, on {smi}:")
    res = {}
    for name in calls:
        med = statistics.median(ms[name])
        res[name] = {"ms": med, "min_ms": min(ms[name]), "tflops": flops / med / 1e9,
                     "bits_equal_production": same[name],
                     "sass": variants.sass_counts(libs[name], _KERNEL, ("F2FP", "HGMMA")),
                     "ptxas": variants.ptxas(libs[name], _KERNEL)}
        print(f"  {name:32s} median {med:8.3f} ms (min {min(ms[name]):8.3f}), "
              f"{flops / med / 1e9:7.2f} TFLOP/s, bits equal production: {same[name]}, "
              f"SASS {res[name]['sass']}, ptxas {res[name]['ptxas']}")
    out = {"what": "mlp_variants", "device": smi, "rows": n * S, "variants": res}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
