"""What each part of the fused MLP's k-step costs on the card: variants of
``ops/csrc/nerf_wide_mlp.cuh``, each with one piece taken out or one
number changed, timed in turns on one 65,536-ray ``full`` chunk (8,388,608
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

_WAIT_FULL = "mbar_wait(&full[s], ((it + k) / kMlpStages) & 1);"
_LOADS = """              mbar_expect_tx(&full[s], kMlpStageBytes);
              tma_load(st, map, pass * kMlpBN, row, &full[s]);
              tma_load(st + kMlpStageBytes / 2, map, pass * kMlpBN + 64, row, &full[s]);"""
_STORES = """              *reinterpret_cast<__nv_bfloat162*>(nxt + act_at(r, n)) = lo;
              *reinterpret_cast<__nv_bfloat162*>(nxt + act_at(r + 8, n)) = hi;"""
_STAGES = "constexpr int kMlpStages = 4;"
_REFILL = "if (it >= kMlpStages) mbar_wait(&empty[s], ((it / kMlpStages) - 1) & 1);"
_REFILL_AFTER_COPY = ("if (it >= kMlpStages) {\n"
                      "mbar_wait(&empty[s], ((it / kMlpStages) - 1) & 1);\n"
                      "mbar_wait(&full[s], ((it / kMlpStages) - 1) & 1);\n}")
_PRODUCER_END = "      }\n    }\n  } else {  // consumer warpgroup"
_PRODUCER_DRAINS = ("      }\n"
                    "      for (int j = it > kMlpStages ? it - kMlpStages : 0; j < it; ++j) {\n"
                    "        mbar_wait(&full[j % kMlpStages], (j / kMlpStages) & 1);\n"
                    "      }\n    }\n  } else {  // consumer warpgroup")


def _stages(n: int):
    return [(_STAGES, f"constexpr int kMlpStages = {n};", 1)]


# name -> (edits (old, new, times), whether the arithmetic is whole)
VARIANTS = {
    "as is": ([], True),
    # the consumers never wait for a weight slice to land (they read what the
    # stage holds): what their waits on the weights cost.  The producer waits
    # instead, for a stage's last copy before it refills the stage and for
    # the last copies before it exits, so the barriers stay in phase
    "no weight waits": ([(_WAIT_FULL, "", 1), (_REFILL, _REFILL_AFTER_COPY, 1),
                         (_PRODUCER_END, _PRODUCER_DRAINS, 1)], False),
    # the producer arrives on the full barrier without a copy: the waits and
    # the ring's turns stay, no weight byte moves (the L2's share)
    "no weight loads": ([(_LOADS, "              mbar_arrive(&full[s]);", 1)], False),
    # the f32 promotion adds of each k-step into the running sum
    "no promotion adds": ([("for (int q = 0; q < 64; ++q) acc[q] += ks0[q];", "", 1),
                           ("for (int q = 0; q < 64; ++q) acc[q] += ks1[q];", "", 1)], False),
    # the epilogue's stores of a layer's output into shared memory, its
    # arithmetic kept (the stores sit behind a condition that never holds)
    "no activation stores, math kept": ([(_STORES, "if (rows < 0) {\n" + _STORES + "\n}", 1)],
                                        False),
    # the stores and, with nothing to read it, the epilogue's arithmetic of
    # every layer but the last (the compiler drops it)
    "no activation stores": ([(_STORES, "", 1)], False),
    # the two consumer warpgroups issue when they like
    "no turns": ([('asm volatile("bar.sync %0, 256;" ::"r"(wg + 3) : "memory");', "", 1),
                  ('asm volatile("bar.arrive %0, 256;" ::"r"((wg ^ 1) + 3) : "memory");', "",
                   1)], True),
    "2 stages": (_stages(2), True),
    "3 stages": (_stages(3), True),
    "6 stages": (_stages(6), True),
    "8 stages": (_stages(8), True),
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
    same = {name: bool(torch.equal(call(), want)) for name, call in calls.items()}
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
