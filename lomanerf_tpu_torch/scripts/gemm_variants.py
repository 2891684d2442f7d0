"""What each part of the bf16 layer GEMM's k-loop costs on the card:
variants of ``ops/csrc/nerf_wide_layer_gemm.cuh``, each with one piece
taken out, timed in turns on one layer of a gradient chunk (by default the
8x1024 MLP's: 598,784 x 1024 . 1024 x 1024, the rows of
``fused_nerf.wide_grad_chunk_rays`` at S = 128), in both forms: the forward
(bias + ReLU, bf16 out) and the gradient chain's ``d_h`` (mask, bf16 Cb and
the column partials, no f32 C).

Each variant is the header with the textual edits of ``VARIANTS`` (every
edit must match the source exactly as often as it names, so a changed
source fails here rather than timing something else), compiled by ``nvcc``
with the port's flags into a library of its own under
``build/gemm_variants/<hash>/``, all compiled at once, and launched through
a C entry with ``wide_layer_gemm``'s arguments.  The variants that leave
the arithmetic whole must give the production kernel's bits (``wide_gemm``:
the forward's output, ``d_h``'s f32 C, Cb and partials); the others compute
something else and are timed only.  ``--parent DIR`` (a checkout of another
commit, e.g. the parent unpacked by ``git archive`` under ``build/``) also
builds that tree's library and times its ``wide_layer_gemm`` in the same
turns, and says whether its bits equal this tree's.  For each variant the
SASS of its kernels is counted by ``cuobjdump`` (all instructions, the
``HGMMA``, the ``FADD``) and its registers and spills read from ``ptxas -v``;
each build log, the production library's too, is searched for ptxas's
note that it serialized a kernel's wgmma (C7514, C7520).  Each call's outputs are also held
to f64 (``_f64_gaps``): the forward's share of outputs off the correctly
rounded value and its ReLU decisions other than f64's, d_h's largest gap
and its share of Cb off f64.

Needs a card and the CUDA toolkit.  Run:

    python -m lomanerf_tpu_torch.scripts.gemm_variants [--shape 8x1024,flagship] \
        [--parent build/parent]

The last line is one JSON object with the numbers.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics

import torch

from lomanerf_tpu_torch.ops import build
from lomanerf_tpu_torch.scripts import variants

HEADER = build.CSRC / "nerf_wide_layer_gemm.cuh"
ROUNDS = 5  # rounds of turns: each call is timed 2 * ROUNDS times
_KERNEL = "layer_wgmma_kernel"
OUT = build.BUILD_ROOT.parent / "gemm_variants"
# (rows, pw = K): one layer of a gradient chunk of each MLP
SHAPES = {"8x1024": (598_784, 1024), "flagship": (2_391_296, 256),
          "pw384": (262_144, 384), "pw128": (598_784, 128)}

_WAIT1 = 'asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");'
_WAIT0 = 'asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");'

_FWD = "(ks, k_desc(a + 32 * j), mn_desc(b + 2048 * j, kLgBox), j > 0);"
_DH = "(ks, k_desc(a + 32 * j), k_desc(b + 32 * j), j > 0);"
_ADD = "#pragma unroll\n        for (int q = 0; q < 64; ++q) acc[q] += ks[q];\n"
_FIRST = "        const uint32_t a = ring_s + s * kLgStageBytes + wg * kLgBox;\n"
_SERIALIZED = "wgmma.mma_async instructions are serialized"  # ptxas's C75xx notes

# name -> (edits (old, new, times), whether the arithmetic is whole)
VARIANTS = {
    "as is": ([], True),
    # each stage's products finished before the thread adds the stage before:
    # no products in flight under the promotion adds
    "no products in flight": ([(_WAIT1, _WAIT0, 3)], True),
    # the two consumer warpgroups issue when they like, not a stage each in turn
    "no ping-pong": ([("        wait_turn(wg);\n", "", 1),
                      ("        pass_turn(wg);\n", "", 1)], True),
    # a fifth stage in the ring (as many as d_h's shared memory holds)
    "five stages": ([("constexpr int kLgMaxStages = 4;", "constexpr int kLgMaxStages = 5;", 1)],
                    True),
    # no promotion: the whole K in the tensor core's accumulator, the fresh
    # sets' adds gone (the sums' grouping changes, so do the bits)
    "whole K in the accumulator": ([
        (_FIRST, _FIRST + "        const int first = it == first_it ? 0 : 1;\n", 1),
        ("      auto issue = [&]", "      const int first_it = it;\n      auto issue = [&]", 1),
        (_FWD, _FWD.replace("(ks,", "(acc,").replace("j > 0)", "first || j > 0)"), 1),
        (_DH, _DH.replace("(ks,", "(acc,").replace("j > 0)", "first || j > 0)"), 1),
        (_ADD, "", 1),
        ("      // the epilogue: column pairs", "      fence_acc(acc);\n"
         "      // the epilogue: column pairs", 1)], False),
}

_ENTRY = r"""
#include "nerf_wide_layer_gemm.cuh"

extern "C" int variant_gemm(const void* A, const void* W, const float* b, const void* mask,
                            void* C, void* Cb, float* part, int rows, int pw, int K, int dh,
                            void* stream) {
  const auto* a = static_cast<const __nv_bfloat16*>(A);
  const auto* w = static_cast<const __nv_bfloat16*>(W);
  const auto* m = static_cast<const __nv_bfloat16*>(mask);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dh ? wide::layer_gemm<wide::kEpiMask>(a, pw, w, pw, rows, pw, K, nullptr, m, C, pw,
                                            static_cast<__nv_bfloat16*>(Cb), st, part)
         : wide::layer_gemm<wide::kEpiBiasRelu>(a, pw, w, pw, rows, pw, K, b, nullptr, C, pw,
                                                nullptr, st, nullptr));
}
"""
_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def patched(edits) -> str:
    return variants.patch(HEADER, edits, "gemm_variants")


def _bind(fn):
    fn.argtypes, fn.restype = _ARGS, ctypes.c_int
    return fn


def _operands(rows: int, pw: int, seed: int = 5):
    g = torch.Generator("cuda").manual_seed(seed)
    a = torch.randn((rows, pw), generator=g, device="cuda").to(torch.bfloat16)
    W = (torch.randn((pw, pw), generator=g, device="cuda") / pw ** 0.5).to(torch.bfloat16)
    b = torch.randn(pw, generator=g, device="cuda") * 0.1
    mask = torch.randn((rows, pw), generator=g, device="cuda").to(torch.bfloat16)
    return a, W, b, mask


def _outputs(rows: int, pw: int, dh: bool, f32: bool):
    """(C, Cb, part) of a call: the forward's bf16 C; d_h's f32 C (with
    ``f32``, else None), Cb and partials."""
    if not dh:
        return torch.empty((rows, pw), dtype=torch.bfloat16, device="cuda"), None, None
    return (torch.empty((rows, pw), device="cuda") if f32 else None,
            torch.empty((rows, pw), dtype=torch.bfloat16, device="cuda"),
            torch.empty((-(-rows // 128), pw), device="cuda"))


def _caller(fn, ops, outs, rows, pw, dh):
    a, W, b, mask = ops
    stream = torch.cuda.current_stream().cuda_stream
    ptr = [None if x is None else x.data_ptr() for x in outs]

    def call():
        err = fn(a.data_ptr(), W.data_ptr(), None if dh else b.data_ptr(),
                 mask.data_ptr() if dh else None, *ptr, rows, pw, pw, int(dh), stream)
        if err:
            raise RuntimeError(f"gemm_variants: launch failed, cudaError {err}")
        return outs
    return call


def _equal(x, y) -> bool:
    return all((p is None and q is None) or torch.equal(p, q) for p, q in zip(x, y))


def _f64_gaps(form: str, ops, got) -> dict:
    """How far a call's outputs lie from f64: the forward's share of bf16
    outputs other than bf16(ReLU(f64)) and its count of ReLU decisions other
    than f64's (what moves a mask downstream); d_h's largest f32 gap over its
    largest entry and its share of Cb other than bf16(f64)."""
    a, W, b, mask = ops
    if form == "forward":
        pre = a.double() @ W.double() + b.double()
        return {"share_off_f64": (got[0] != torch.relu(pre).to(torch.bfloat16)).double()
                .mean().item(),
                "relu_flips": int(((got[0] > 0) != (pre > 0)).sum().item())}
    exact = torch.where(mask > 0, a.double() @ W.double().T, 0.0)
    return {"gap_over_max": ((got[0].double() - exact).abs().max() / exact.abs().max()).item(),
            "cb_share_off_f64": (got[1] != exact.to(torch.bfloat16)).double().mean().item()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="gemm_variants")
    ap.add_argument("--shape", default="8x1024",
                    help="comma-separated, of " + ", ".join(SHAPES))
    ap.add_argument("--parent", default=None,
                    help="a checkout of another commit whose wide_layer_gemm is timed too")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("gemm_variants: needs a CUDA card")
    libs = variants.compile_all(
        {name: {HEADER.name: patched(edits)} for name, (edits, _) in VARIANTS.items()},
        _ENTRY, OUT, "gemm_variants")
    fns = {name: _bind(ctypes.CDLL(str(path)).variant_gemm) for name, path in libs.items()}
    production = build.load().wide_layer_gemm
    logs = {name: path.with_name("build.log").read_text() for name, path in libs.items()}
    logs["production"] = (build.build().parent / "build.log").read_text()
    serialized = {name: _SERIALIZED in log for name, log in logs.items()}
    print(f"gemm_variants: ptxas serialized wgmma (C75xx): {serialized}", flush=True)
    if args.parent:
        from lomanerf_tpu_torch.scripts.card_probe import parent_library

        fns["parent"] = parent_library(args.parent).wide_layer_gemm
    print(f"gemm_variants: {len(libs)} variants compiled", flush=True)
    smi = variants.card()
    res = {}
    for shape in args.shape.split(","):
        rows, pw = SHAPES[shape]
        ops = _operands(rows, pw)
        flops = 2.0 * rows * pw * pw
        for form, dh in (("forward", False), ("d_h", True)):
            # the bits: with d_h's f32 C, against the production library
            want = _caller(production, ops, _outputs(rows, pw, dh, True), rows, pw, dh)()
            same, gaps = {}, {}
            for name, fn in fns.items():  # one at a time, so that one that hangs is named
                print(f"gemm_variants: checking {name!r} {shape} {form}", flush=True)
                got = _caller(fn, ops, _outputs(rows, pw, dh, True), rows, pw, dh)()
                same[name] = _equal(got, want)
                gaps[name] = _f64_gaps(form, ops, got)
                if dh:  # the chain's form, without the f32 C, gives the same Cb and partials
                    bare = _caller(fn, ops, _outputs(rows, pw, dh, False), rows, pw, dh)()
                    same[name] = same[name] and _equal(bare[1:], want[1:])
            for name, (_, whole) in VARIANTS.items():
                if whole and not same[name]:
                    raise SystemExit(f"gemm_variants: {name!r} leaves the arithmetic whole but "
                                     f"its {form} bits differ from the production kernel's")
            calls = {name: _caller(fn, ops, _outputs(rows, pw, dh, False), rows, pw, dh)
                     for name, fn in fns.items()}
            ms = variants.timed_turns(calls, ROUNDS)
            print(f"layer GEMM variants, {form} at {shape} ({rows} x {pw} . {pw} x {pw}, "
                  f"{flops / 1e12:.3f} TFLOP), {2 * ROUNDS} calls each in turns, on {smi}:")
            for name in calls:
                med = statistics.median(ms[name])
                entry = {"ms": med, "min_ms": min(ms[name]), "tflops": flops / med / 1e9,
                         "bits_equal_production": same[name], "f64": gaps[name]}
                if name in libs:
                    entry["sass"] = variants.sass_counts(libs[name], _KERNEL, ("HGMMA", "FADD"))
                    entry["ptxas"] = variants.ptxas(libs[name], _KERNEL)
                res[f"{shape} {form} {name}"] = entry
                print(f"  {name:28s} median {med:7.3f} ms (min {min(ms[name]):7.3f}), "
                      f"{flops / med / 1e9:6.1f} TFLOP/s, bits equal production: {same[name]}, "
                      f"against f64 {gaps[name]}, "
                      f"SASS {entry.get('sass')}, ptxas {entry.get('ptxas')}", flush=True)
        del ops
        torch.cuda.empty_cache()
    out = {"what": "gemm_variants", "device": smi, "wgmma_serialized": serialized, "variants": res}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
