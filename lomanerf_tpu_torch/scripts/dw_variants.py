"""What each part of the bf16 dW stage costs on the card, and which tile
width its walk should take: variants of ``ops/csrc/nerf_wide_dw.cuh``,
each with one piece taken out or one choice forced, timed in turns on the
dW calls of one gradient pass (``SHAPES``: one layer of the 8x1024 MLP's
chunk, 598,784 rows at S = 128, and of the flagship's, 2,097,152 x 256 x
256; the ten dW calls of the published NeRF's coarse and fine passes,
262,144 and 786,432 rows at row stride 320; the four of one mip-NeRF 360
proposal round, 1,048,576 rows).

Each variant is the header with the textual edits of ``VARIANTS`` (every
edit must match the source exactly as often as it names, so a changed
source fails here rather than timing something else), compiled by
``nvcc`` with the port's flags into a library of its own under
``build/dw_variants/<hash>/`` (``scripts/variants``), and launched through
a C entry with ``wide_dw_gemm``'s arguments.  The variants that leave the
arithmetic whole must give the production kernel's partials bit for bit;
the others compute something else and are timed only.  ``--parent DIR``
(a checkout of another commit, e.g. the parent unpacked by ``git
archive`` under ``build/``) also builds that tree's library and times its
``wide_dw_gemm`` in the same turns, and says whether its bits equal this
tree's.  For each variant the SASS of its kernel is counted (all
instructions, the ``HGMMA``, the ``FADD``) and its registers and spills
read from ``ptxas -v``; each build log, the production library's too, is
searched for ptxas's note that it serialized a kernel's wgmma (C7514,
C7520).  The production partials are held to f64 (``wide_dw.f64_gap``).

Needs a card and the CUDA toolkit.  Run:

    python -m lomanerf_tpu_torch.scripts.dw_variants [--shape 8x1024,flagship] \
        [--parent build/parent]

The last line is one JSON object with the numbers.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics

import torch

from lomanerf_tpu_torch.ops import build, wide_dw
from lomanerf_tpu_torch.scripts import variants

HEADER = build.CSRC / "nerf_wide_dw.cuh"
ROUNDS = 5  # rounds of turns: each call is timed 2 * ROUNDS times
_KERNEL = "dw_wgmma_kernel"
OUT = build.BUILD_ROOT.parent / "dw_variants"
# the published NeRF's dW calls of one pass (nerf_paper.cu), (M, N): the
# view layer, F, then the trunk from layer 7 down to 0 (the skip layer 5)
_PAPER = ((296, 128), (256, 264), (256, 256), (256, 256), (320, 256), (256, 256),
          (256, 256), (256, 256), (256, 256), (64, 256))
# (rows, row stride, the dW calls (M, N) of one pass)
SHAPES = {"8x1024": (598_784, 1024, ((1024, 1024),)),
          "8x1024_layer0": (598_784, 1024, ((40, 1024),)),
          "flagship": (2_097_152, 256, ((256, 256),)),
          "paper_coarse": (262_144, 320, _PAPER), "paper_fine": (786_432, 320, _PAPER),
          "mip_proposal": (1_048_576, 256, ((256, 256),) * 3 + ((96, 256),))}

_SERIALIZED = "wgmma.mma_async instructions are serialized"  # ptxas's C75xx notes

_ADD = "#pragma unroll\n        for (int q = 0; q < 64; ++q) sum[q] += ks[q];\n"
_WGMMA0 = "wgmma_m64n128<1>(ks, mn_desc(a, kDwBoxBytes), mn_desc(b, kDwBoxBytes), 0);"
_WGMMA1 = "wgmma_m64n128<1>(ks, mn_desc(a + 2048, kDwBoxBytes), mn_desc(b + 2048, kDwBoxBytes), 1);"
_REFILL = "if (it >= kStages) mbar_wait(&empty[s], ((it / kStages) - 1) & 1);"
_WAIT_FULL = "mbar_wait(&full[s], (it / kStages) & 1);"
_WIDTH = "const int bn = 3 * rounds(kDwBN / 2) < 5 * rounds(kDwBN) ? kDwBN / 2 : kDwBN;"

# name -> (edits (old, new, times), whether the arithmetic is whole)
VARIANTS = {
    "as is": ([], True),
    # the tile width forced, whatever the walk's rounds
    "always 256 wide": ([(_WIDTH, "const int bn = kDwBN;", 1)], True),
    "always 128 wide": ([(_WIDTH, "const int bn = kDwBN / 2;", 1)], True),
    # a block for each work item, not min(items, SMs) blocks walking them
    "a block an item": ([("<<<static_cast<int>(std::min<long long>(items, sms)), kDwThreads",
                          "<<<static_cast<int>(items), kDwThreads", 1)], True),
    # the promotion adds gone (the partials are zeros): what the adds cost
    "no promotion adds": ([(_ADD, "", 1)], False),
    # the tensor-core products gone: what the rest of the loop costs
    "no products": ([(_WGMMA0, "", 1), (_WGMMA1, "", 1)], False),
    # the data never keeps a consumer waiting: the producer fills the ring
    # once, and the consumers wait only for that fill (later sets read
    # whatever the ring holds): what the feed from L2 and device memory costs
    "no waits for data": ([(_REFILL, "if (it >= kStages) continue;", 1),
                           (_WAIT_FULL, "if (it < kStages) mbar_wait(&full[s], 0);", 1)], False),
}

_ENTRY = r"""
#include "nerf_wide_dw.cuh"

extern "C" int variant_dw(const void* H, const void* Dz, int ld, int M, int N, int rows,
                          float* part, void* stream) {
  return static_cast<int>(wide::dw_gemm(static_cast<const __nv_bfloat16*>(H),
                                        static_cast<const __nv_bfloat16*>(Dz), ld, M, N, rows,
                                        part, static_cast<cudaStream_t>(stream)));
}
"""


def patched(edits) -> str:
    return variants.patch(HEADER, edits, "dw_variants")


def _caller(fn, h, db, layers, parts):
    """A call that runs fn on each of the pass's dW calls, into parts."""
    rows, ld = db.shape
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        for (M, N), part in zip(layers, parts):
            err = fn(h.data_ptr(), db.data_ptr(), ld, M, N, rows, part.data_ptr(), stream)
            if err:
                raise RuntimeError(f"dw_variants: launch failed, cudaError {err}")
        return parts
    return call


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="dw_variants")
    ap.add_argument("--shape", default="8x1024,flagship",
                    help="comma-separated, of " + ", ".join(SHAPES))
    ap.add_argument("--parent", default=None,
                    help="a checkout of another commit whose wide_dw_gemm is timed too")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("dw_variants: needs a CUDA card")
    libs = variants.compile_all({name: {HEADER.name: patched(edits)}
                                 for name, (edits, _) in VARIANTS.items()},
                                _ENTRY, OUT, "dw_variants")
    fns = {}
    for name, path in libs.items():
        fn = ctypes.CDLL(str(path)).variant_dw
        fn.argtypes, fn.restype = build.SIGNATURES["wide_dw_gemm"], ctypes.c_int
        fns[name] = fn
    production = build.load().wide_dw_gemm
    logs = {name: path.with_name("build.log").read_text() for name, path in libs.items()}
    logs["production"] = (build.build().parent / "build.log").read_text()
    serialized = {name: _SERIALIZED in log for name, log in logs.items()}
    print(f"dw_variants: ptxas serialized wgmma (C75xx): {serialized}", flush=True)
    if args.parent:
        from lomanerf_tpu_torch.scripts.card_probe import parent_library

        fns["parent"] = parent_library(args.parent).wide_dw_gemm
    print(f"dw_variants: {len(libs)} variants compiled", flush=True)
    smi = variants.card()
    res = {}
    for shape in args.shape.split(","):
        rows, ld, layers = SHAPES[shape]
        h, db = wide_dw.operands(rows, ld)
        n = wide_dw.n_partials(rows)
        want = [torch.empty((n, M, N), device="cuda") for M, N in layers]
        _caller(production, h, db, layers, want)()
        gap = max(wide_dw.f64_gap(h, db, M, N, w) for (M, N), w in zip(layers, want))
        same = {}
        for name, fn in fns.items():  # one at a time, so that one that hangs is named
            print(f"dw_variants: checking {name!r} {shape}", flush=True)
            got = _caller(fn, h, db, layers,
                          [torch.full_like(w, float("nan")) for w in want])()
            same[name] = all(torch.equal(g, w) for g, w in zip(got, want))
            del got
        wrong = [name for name, (_, whole) in VARIANTS.items() if whole and not same[name]]
        if wrong:
            raise SystemExit(f"dw_variants: {wrong} leave the arithmetic whole but their "
                             f"partials at {shape} differ from the production kernel's")
        # each dW call of the pass timed alone, the variants in turns call by call;
        # the card's work only (a coarse-pass call is shorter than its launch)
        outs = [torch.empty_like(w) for w in want]
        calls = {(name, i): _caller(fn, h, db, layers[i:i + 1], outs[i:i + 1])
                 for i in range(len(layers)) for name, fn in fns.items()}
        ms = variants.device_turns(calls, ROUNDS)
        flops = 2.0 * rows * sum(M * N for M, N in layers)
        print(f"dW stage variants at {shape} ({rows} rows, {n} partials, (M, N) {layers}, "
              f"{flops / 1e12:.3f} TFLOP; production |got - f64| {gap:.3e} of the sum of "
              f"|products|), each call {2 * ROUNDS} times in turns, on {smi}:")
        for name in fns:
            per = [statistics.median(ms[name, i]) for i in range(len(layers))]
            med = sum(per)
            entry = {"ms": med, "per_call_ms": per, "tflops": flops / med / 1e9,
                     "bits_equal_production": same[name]}
            if name in libs:
                entry["sass"] = variants.sass_counts(libs[name], _KERNEL, ("HGMMA", "FADD"))
                entry["ptxas"] = variants.ptxas(libs[name], _KERNEL)
            res[f"{shape} {name}"] = entry
            print(f"  {name:24s} {med:7.3f} ms ({flops / med / 1e9:6.1f} TFLOP/s; calls "
                  + " ".join(f"{t:.4f}" for t in per) + f"), bits equal production: "
                  f"{same[name]}, SASS {entry.get('sass')}, ptxas {entry.get('ptxas')}",
                  flush=True)
        res[f"{shape} f64_gap"] = gap
        del h, db, want, outs, calls
        torch.cuda.empty_cache()
    out = {"what": "dw_variants", "device": smi, "wgmma_serialized": serialized, "variants": res}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
