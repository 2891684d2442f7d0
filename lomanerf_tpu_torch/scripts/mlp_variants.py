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
import hashlib
import json
import re
import statistics
import subprocess
from pathlib import Path

import torch

from lomanerf_tpu_torch.ops import build

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
    src = HEADER.read_text()
    for old, new, times in edits:
        if src.count(old) != times:
            raise SystemExit(f"mlp_variants: {old!r} occurs {src.count(old)} times in "
                             f"{HEADER.name}, not {times}: the variant is out of date")
        src = src.replace(old, new)
    return src


def sass_counts(lib: Path) -> dict | None:
    """Instruction counts of the library's fused-MLP kernel, or None where
    the toolkit has no cuobjdump."""
    tool = Path(build._nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return None
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True).stdout
    body = next((f for f in sass.split("Function : ") if _KERNEL in f.split("\n", 1)[0]), "")
    ins = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", body)
    return {"instructions": len(ins),
            "F2FP": sum(i.startswith("F2FP") for i in ins),
            "HGMMA": sum(i.startswith("HGMMA") for i in ins)}


def ptxas(lib: Path) -> dict:
    """Registers a thread and spill stores of the kernel, from the build log."""
    log = lib.with_name("build.log").read_text()
    start = re.search(rf"Compiling entry function '[^']*{_KERNEL}", log)
    part = log[start.start():] if start else ""
    regs, spills = re.search(r"Used (\d+) registers", part), re.search(
        r"(\d+) bytes spill stores", part)
    return {"registers": int(regs.group(1)) if regs else None,
            "spill_stores": int(spills.group(1)) if spills else None}


def compile_all() -> dict:
    """One library per variant (all ``nvcc`` started together); returns
    name -> library path."""
    nvcc = build._nvcc()
    jobs = {}
    for name, (edits, _) in VARIANTS.items():
        src = patched(edits)
        d = OUT / hashlib.sha256((build.source_hash() + src).encode()).hexdigest()[:16]
        proc = None
        if not (d / "libvariant.so").exists():
            d.mkdir(parents=True, exist_ok=True)
            (d / "nerf_wide_mlp.cuh").write_text(src)
            (d / "variant.cu").write_text(_ENTRY)
            cmd = [nvcc, *build.NVCC_FLAGS, "-shared", "-I", str(build.CSRC), "-o",
                   str(d / "tmp.so"), str(d / "variant.cu")]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)
        jobs[name] = (proc, d)
    libs = {}
    for name, (proc, d) in jobs.items():
        if proc is not None:
            log = proc.communicate()[0]
            (d / "build.log").write_text(log)
            if proc.returncode:
                raise SystemExit(f"mlp_variants: nvcc failed on {name!r}:\n{log[-4000:]}")
            (d / "tmp.so").replace(d / "libvariant.so")
        libs[name] = d / "libvariant.so"
    return libs


def main() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("mlp_variants: needs a CUDA card")
    from lomanerf_tpu_torch.core import uniform_depths
    from lomanerf_tpu_torch.models import NeRFConfig, NeRFModel
    from lomanerf_tpu_torch.ops import fused_nerf, wide_mlp

    libs = compile_all()
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
    ms = {name: [] for name in calls}
    order = list(calls.items())
    for _ in range(ROUNDS):
        for name, call in order + order[::-1]:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda.synchronize()
            start.record()
            call()
            end.record()
            torch.cuda.synchronize()
            ms[name].append(start.elapsed_time(end))
    flops = 2.0 * n * S * (cfg.in_channels * 256 + (L - 2) * 256 * 256)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"fused MLP variants, one {n}-ray full chunk ({n * S} rows, {flops / 1e12:.2f} TFLOP), "
          f"{2 * ROUNDS} calls each in turns, on {smi.strip()}:")
    res = {}
    for name in calls:
        med = statistics.median(ms[name])
        res[name] = {"ms": med, "min_ms": min(ms[name]), "tflops": flops / med / 1e9,
                     "bits_equal_production": same[name], "sass": sass_counts(libs[name]),
                     "ptxas": ptxas(libs[name])}
        print(f"  {name:32s} median {med:8.3f} ms (min {min(ms[name]):8.3f}), "
              f"{flops / med / 1e9:7.2f} TFLOP/s, bits equal production: {same[name]}, "
              f"SASS {res[name]['sass']}, ptxas {res[name]['ptxas']}")
    out = {"what": "mlp_variants", "device": smi.strip(), "rows": n * S, "variants": res}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
