"""Measurements on the card that need a process of their own, or that are
run against another checkout of the port to compare two trees.

* ``--what flagship``: device time by kernel family of ``--steps`` flagship
  train steps (``NeRFConfig.full()``, 16,384 rays x 128 samples, Adam 5e-4,
  ``make_single_chip_train_step``, numpy-seeded batches) after two warm-up
  steps, from one ``utils.profiling.trace`` session (``torch.profiler``:
  only the first session of a process records the card's kernels).  Each
  kernel of the trace is put in a family by its name: the dW GEMMs (the
  wgmma/TMA stage, ``dw_wgmma_kernel``, and ``gemm*_kernel`` with the
  ``kEpiPartial`` epilogue), the ``d_h`` GEMMs (``kEpiMask``), the forward
  GEMMs (``kEpiBiasRelu``), compositing, the partials' and column sums, the
  encoding, the loss sum, memsets and copies, and the rest (Adam, the
  parameter packing).  Prints ms per step and the share of the device time.
* ``--what small``: device time by kernel family of ``--steps`` ``small``
  train steps (``NeRFConfig.small()``, bench.py's 262,144 rays x 30
  samples, Adam 5e-4, the same batches and seeds as ``--what flagship``)
  after two warm-up steps, from one trace: the narrow gradient walk
  (``nerf_grad_kernel``), the fixed-order sum of its block partials
  (``sum_block_partials``), Adam (``multi_tensor_apply_kernel``: the
  optimizer's foreach updates) and the rest (the parameter packing, the
  gradients' unpacking, memsets and copies).  Prints ms per step, each
  family's share and the kernels launched per step by name.
* ``--what frame``: device time by kernel family of ``FRAMES`` 800x800
  ``full`` frames (``NeRFModel.render_image``, seeded init, one pose) after
  a warm-up frame, from one trace: the fused MLP (``mlp_wgmma_kernel``),
  compositing and the rest; with ``--path mma``, the same frames on the
  ``mma.sync`` chain the fused MLP replaced (``wide_mlp.render_rays_mma``
  over the same chunks), whose encoding and layer GEMMs are families of
  their own.  Prints ms per frame, each family's share and the kernels
  launched per frame by name.  With ``--preset small``: an 800x800
  ``small`` frame (one launch of the narrow render, ``nerf_render_fwd``)
  split into the render kernel and the rest of the frame by kernel
  (``get_rays``, the parameter packing, ``uniform_depths``, the ``cat``),
  and, from an idle card, the event window and the host time of one
  ``render_image`` call.
* ``--what grid_sum``: one call of ``probe.grid_sum`` on an ``(8,
  7,864,320)`` f32 array in 3,840-column tiles split three ways, beside
  ``torch.sum`` of the same array: the device time of its kernels per call
  over ``--calls`` calls (one trace session, after a warm-up call; the
  calls of ``torch.sum`` follow behind a marker kernel, where the trace is
  split on the card's clock) and its kernels per call; from an idle card, in turns with ``torch.sum``, the
  event window of one call (the host's enqueue and the card's work) and
  the host time of the call alone.
* ``--what walk --parent DIR``: the narrow gradient walk of this tree
  against the one of the checkout at ``DIR`` (its kernels built there), in
  turns in one process: ``fused_nerf`` bound to either library.  At the
  ``small`` bench batch (262,144 rays, ``chip_smoke``'s seed-0 params and
  batch; per-ray depths from ``NeRFModel.sample``, seed 3): #3 and #6
  (``nerf_train[_rays]``) and #2 and #5 (``nerf_render_bwd[_rays]``, a
  seed-1 colour cotangent) alone, each pair's outputs required bit-equal;
  then the ``small`` train step and the ``single64`` step (65,536 rays x
  64, Adam 5e-4, one model per library from one seeded init).
* ``--what render --parent DIR``: the narrow render forward of this tree
  against the one of the checkout at ``DIR`` (built there), in turns in
  one process (``fused_nerf`` bound to either library), each pair's
  colours required bit-equal: #1 (``nerf_render_fwd``) on an 800x800
  ``small`` frame (``scripts/render_variants.frame_inputs``: the trained
  fixture, its second pose), #4 (``nerf_render_fwd_rays``) on 262,144 rays
  at per-ray depths (``render_variants.rays_inputs``), #1 at ``single64``
  (65,536 rays x 64, seeded init), and the whole ``render_image`` frame
  of the fixture through each library.
* ``--what field``: device time by kernel of ``--steps`` ``hires`` image-fit
  steps (``ImageFieldConfig.hires()``, the whole 1024x1024 image a step,
  Adam 1e-3, two numpy-seeded uniform targets cycled, seeded init;
  ``make_image_fit_step``, as ``chip_smoke.py`` phase 12) after two warm-up
  steps, from one trace: the forward kernel (``field_kernel`` without the
  gradient), the gradient kernel, the fixed-order sum of its block
  partials, Adam and the rest (packing, unpacking, the loss, memsets and
  copies).  With ``--parent DIR``, instead: the field kernels of this tree
  against those of the checkout at ``DIR`` (built there), in turns in one
  process, ``fused_mlp`` bound to either library and its packing: one
  ``field_fwd`` and one ``field_bwd`` call at 1024x1024 (``chip_smoke``'s
  seed-0 params, a seed-1 cotangent; the two trees' outputs compared), a
  1024x1024 ``ImageFieldModel.render`` and the ``hires`` fit step (one model
  per library from one seeded init); and each tree's dW/db against autograd
  of the plain version at that image, with the (leaf, columns) that
  ReLU-mask flips move past rtol 1e-3 + 1e-4 of the leaf's largest entry.
* ``--what leaves``: each wide leaf's worst |kernel - plain| of the
  flagship's train-loss gradients, over the leaf's largest entry, on the
  inputs of ``chip_smoke.py`` phase 7 (``full()`` on 1037 rays, numpy seed
  7; the 16,384-ray bench batch, seed 0), and of the render backward's for
  the 1037-ray cotangent.

The last line is one JSON object with the numbers.  Run:

    python -m lomanerf_tpu_torch.scripts.card_probe --what flagship --steps 3
    python -m lomanerf_tpu_torch.scripts.card_probe --what small --steps 5
    python -m lomanerf_tpu_torch.scripts.card_probe --what frame [--path mma]
    python -m lomanerf_tpu_torch.scripts.card_probe --what frame --preset small
    python -m lomanerf_tpu_torch.scripts.card_probe --what render --parent DIR
    python -m lomanerf_tpu_torch.scripts.card_probe --what grid_sum --calls 20
    python -m lomanerf_tpu_torch.scripts.card_probe --what leaves
    python -m lomanerf_tpu_torch.scripts.card_probe --what field [--parent DIR]
    python -m lomanerf_tpu_torch.scripts.card_probe --what walk --parent DIR
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import importlib.util
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

FAMILIES = ("fused MLP", "dW", "d_h", "forward", "compositing", "partial and column sums",
            "encoding", "loss sum", "memset and copy", "other")
_EPILOGUE = {0: "forward", 1: "d_h", 2: "dW"}  # nerf_wide_gemm.cuh's kEpi values
FRAMES = 2  # 800x800 frames traced by --what frame, after a warm-up frame
SMALL_FAMILIES = ("nerf_grad_kernel", "sum_block_partials", "Adam", "other")
WORK_CATS = ("kernel", "gpu_memset", "gpu_memcpy")  # the card's work in a trace
MARKER, MARKER_CYCLES = "spin_kernel", 1000  # torch.cuda._sleep's kernel, between two sets
MARGIN_S = 0.05  # idle host time at both ends of a traced session


def family(name: str, cat: str) -> str:
    """The family of a kernel (or memset / copy) by its trace name."""
    if cat != "kernel":
        return "memset and copy"
    if "mlp_wgmma_kernel" in name:
        return "fused MLP"
    if "dw_wgmma_kernel" in name:
        return "dW"
    gemm = re.search(r"gemm(?:_mma)?_kernel<([^>]*)>", name)
    if gemm:
        return _EPILOGUE[int(gemm.group(1).split(",")[-1])]
    for key, fam in (("composite_kernel", "compositing"), ("sum_partials_kernel",
                     "partial and column sums"), ("colsum_kernel", "partial and column sums"),
                     ("encode_kernel", "encoding"), ("loss_sum_kernel", "loss sum")):
        if key in name:
            return fam
    return "other"


def device_events(run, calls: int, after=None):
    """``[(name, cat, µs, ts)]`` of the card's work over ``calls`` calls of
    ``run`` inside one trace; with ``after``, the work of its calls too
    (after the card is idle, behind a marker kernel), returned second."""
    from lomanerf_tpu_torch.utils import trace

    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        with trace(tmp):
            # the profiler drops the card's work that it places outside its
            # capture window (the card's clock mapped onto the host's): idle
            # margins keep the first and the last kernel well inside it
            time.sleep(MARGIN_S)
            for _ in range(calls):
                run()
            if after is not None:
                torch.cuda.synchronize()
                torch.cuda._sleep(MARKER_CYCLES)
                torch.cuda.synchronize()
                for _ in range(calls):
                    after()
            torch.cuda.synchronize()
            time.sleep(MARGIN_S)
        with open(os.path.join(tmp, "trace.json")) as f:
            events = json.load(f)["traceEvents"]
    return card_work(events, MARKER if after is not None else None)


def card_work(events, marker=None):
    """``[(name, cat, µs, ts)]`` of the card's work in the Chrome trace
    ``events``, in the card's order.  With ``marker``, the name of a kernel
    launched once between two sets of calls, two such lists: the work
    before it and the work after it.  The split reads the card's own clock
    only; the host's clock and the card's are mapped onto each other only
    approximately."""
    work = sorted(((e.get("name", ""), e["cat"], float(e.get("dur", 0.0)), float(e["ts"]))
                   for e in events if e.get("cat") in WORK_CATS), key=lambda w: w[3])
    if marker is None:
        return work
    at = [i for i, w in enumerate(work) if marker in w[0]]
    if len(at) != 1:
        raise RuntimeError(f"{len(at)} {marker} kernels in the trace, need one")
    return work[:at[0]], work[at[0] + 1:]


def train_steps(cfg, n: int, steps: int):
    """The device work of ``steps`` Adam 5e-4 train steps of ``cfg`` on
    ``n`` numpy-seeded rays (two batches cycled, seed 0; seeded init), after
    two warm-up steps, from one trace."""
    from lomanerf_tpu_torch.core import rays
    from lomanerf_tpu_torch.models import NeRFModel
    from lomanerf_tpu_torch.train.steps import make_single_chip_train_step

    rng = np.random.default_rng(0)
    t, dists = rays.uniform_depths(cfg.near, cfg.far, cfg.num_samples, "cuda")
    batches = []
    for _ in range(2):
        o, d = (torch.tensor(rng.standard_normal((n, 3)), dtype=torch.float32,
                             device="cuda") for _ in range(2))
        tgt = torch.tensor(rng.random((n, 3)), dtype=torch.float32, device="cuda")
        batches.append((o, d, t, dists, tgt))
    model = NeRFModel(cfg, device="cuda")
    model.init(torch.Generator().manual_seed(0))
    step = make_single_chip_train_step(cfg, torch.optim.Adam(model.parameters(), lr=5e-4))
    calls = [0]

    def run():
        step(model, *batches[calls[0] % 2])
        calls[0] += 1

    run(), run()  # warm-up
    return device_events(run, steps)


def flagship(steps: int) -> dict:
    from lomanerf_tpu_torch.models import NeRFConfig

    events = train_steps(NeRFConfig.full(), 16384, steps)
    ms = collections.Counter()
    launches = collections.Counter()
    for name, cat, us, _ in events:
        fam = family(name, cat)
        ms[fam] += us / 1e3 / steps
        if fam == "dW":
            launches["dw_wgmma_kernel" if "dw_wgmma_kernel" in name else "gemm kEpiPartial"] += 1
    total = sum(ms.values())
    out = {"what": "flagship", "steps": steps, "device_ms_per_step": total,
           "ms": {k: ms[k] for k in FAMILIES}, "share": {k: ms[k] / total for k in FAMILIES},
           "dw_launches_per_step": {k: v / steps for k, v in launches.items()}}
    print(f"flagship train step, {steps} steps traced: device {total:.3f} ms/step")
    for k in FAMILIES:
        print(f"  {k:24s} {ms[k]:9.3f} ms/step  {ms[k] / total:6.1%}")
    print(f"  dW launches per step: {out['dw_launches_per_step']}")
    return out


def small_family(name: str, cat: str) -> str:
    """The family of a kernel of the ``small`` step by its trace name."""
    if cat == "kernel":
        for key in SMALL_FAMILIES[:2]:
            if key in name:
                return key
        if "multi_tensor_apply_kernel" in name:
            return "Adam"
    return "other"


def small(steps: int) -> dict:
    from lomanerf_tpu_torch.models import NeRFConfig

    events = train_steps(NeRFConfig.small(), 262144, steps)
    ms, launches = collections.Counter(), collections.Counter()
    for name, cat, us, _ in events:
        ms[small_family(name, cat)] += us / 1e3 / steps
        launches[kernel_key(name) if cat == "kernel" else cat] += 1
    total = sum(ms.values())
    out = {"what": "small", "steps": steps, "device_ms_per_step": total,
           "ms": {k: ms[k] for k in SMALL_FAMILIES},
           "share": {k: ms[k] / total for k in SMALL_FAMILIES},
           "launches_per_step": {k: v / steps for k, v in sorted(launches.items())}}
    print(f"small train step, 262144 rays x 30 samples, {steps} steps traced: device "
          f"{total:.3f} ms/step")
    for k in SMALL_FAMILIES:
        print(f"  {k:24s} {ms[k]:9.3f} ms/step  {ms[k] / total:6.1%}")
    print(f"  kernels per step: {out['launches_per_step']}")
    return out


def kernel_key(name: str) -> str:
    """A kernel's short name: the function, with the epilogue of a layer
    GEMM (``gemm_mma_kernel kEpiBiasRelu``)."""
    gemm = re.search(r"(gemm(?:_mma)?_kernel)<([^>]*)>", name)
    if gemm:
        epi = ("kEpiBiasRelu", "kEpiMask", "kEpiPartial")[int(gemm.group(2).split(",")[-1])]
        return f"{gemm.group(1)} {epi}"
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return re.split(r"[<(]", name, maxsplit=1)[0].split("::")[-1]


def small_frame() -> dict:
    """An 800x800 ``small`` frame's device time, the render kernel against
    the rest, and one ``render_image`` call's event window and host time."""
    from lomanerf_tpu_torch.core import normalized_intrinsics
    from lomanerf_tpu_torch.models import NeRFConfig, NeRFModel

    size = 800
    model = NeRFModel(NeRFConfig.small(), device="cuda")
    model.init(torch.Generator().manual_seed(0))
    K = normalized_intrinsics(1.1106, device="cuda")
    pose = torch.eye(4, device="cuda")
    pose[2, 3] = 4.0

    def run():
        return model.render_image(K, pose, size)
    with torch.no_grad():
        run()  # warm-up
        events = device_events(run, FRAMES)
        call = one_call_ms({"render_image": run}, 3)["render_image"]
    ms, launches = collections.Counter(), collections.Counter()
    for name, cat, us, _ in events:
        key = kernel_key(name) if cat == "kernel" else cat
        ms[key] += us / 1e3 / FRAMES
        launches[key] += 1
    kernel = ms["nerf_render_fwd_kernel"]
    total = sum(ms.values())
    out = {"what": "frame", "preset": "small", "frames": FRAMES, "device_ms_per_frame": total,
           "kernel_ms": kernel, "rest_ms": total - kernel, "ms": dict(ms),
           "launches_per_frame": {k: v / FRAMES for k, v in sorted(launches.items())},
           "window_ms": call["window_ms"], "host_ms": call["host_ms"]}
    print(f"800x800 small frame, {FRAMES} frames traced: device {total:.3f} ms/frame, the "
          f"render kernel {kernel:.3f} ({kernel / total:.1%}), the rest {total - kernel:.3f}")
    for k, v in sorted(ms.items(), key=lambda kv: -kv[1]):
        print(f"  {k:40s} {v:9.3f} ms/frame  {v / total:6.1%}  "
              f"({launches[k] / FRAMES:g} a frame)")
    print(f"  one render_image call from an idle card: event window {call['window_ms']:.3f} ms,"
          f" host time {call['host_ms']:.3f} ms")
    return out


def frame(path: str) -> dict:
    from lomanerf_tpu_torch.core import normalized_intrinsics, rays
    from lomanerf_tpu_torch.models import NeRFConfig, NeRFModel
    from lomanerf_tpu_torch.ops import fused_nerf, wide_mlp

    cfg, size = NeRFConfig.full(), 800
    model = NeRFModel(cfg, device="cuda")
    model.init(torch.Generator().manual_seed(0))
    K = normalized_intrinsics(1.1106, device="cuda")
    pose = torch.eye(4, device="cuda")
    pose[2, 3] = 4.0
    chunk = fused_nerf.render_chunk_rays(cfg, model.params)
    if path == "fused":
        def run():
            return model.render_image(K, pose, size)
    else:
        W, b = fused_nerf.pack_wide_params(model.params, 256, cfg.compute_dtype)

        def run():
            o, d = rays.get_rays(size, size, K, pose)
            t, dists = rays.uniform_depths(cfg.near, cfg.far, cfg.num_samples, "cuda")
            return torch.cat([wide_mlp.render_rays_mma(W, b, t, dists, oc, dc, cfg)
                              for oc, dc in zip(o.split(chunk), d.split(chunk))])
    with torch.no_grad():
        run()  # warm-up
        events = device_events(run, FRAMES)
    ms, launches = collections.Counter(), collections.Counter()
    for name, cat, us, _ in events:
        ms[family(name, cat)] += us / 1e3 / FRAMES
        if cat == "kernel":
            launches[kernel_key(name)] += 1
    total = sum(ms.values())
    out = {"what": "frame", "path": path, "frames": FRAMES, "chunks": -(-size * size // chunk),
           "device_ms_per_frame": total, "ms": {k: ms[k] for k in FAMILIES},
           "share": {k: ms[k] / total for k in FAMILIES},
           "launches_per_frame": {k: v / FRAMES for k, v in sorted(launches.items())}}
    print(f"800x800 full frame ({path}), {FRAMES} frames traced, {out['chunks']} chunks of "
          f"{chunk} rays: device {total:.3f} ms/frame")
    for k in FAMILIES:
        if ms[k]:
            print(f"  {k:24s} {ms[k]:9.3f} ms/frame  {ms[k] / total:6.1%}")
    print(f"  kernels per frame: {out['launches_per_frame']}")
    return out


def one_call_ms(fns: dict, rounds: int) -> dict:
    """Per callable, the median ms of one call from an idle card: its event
    window (CUDA events around the call: the host's enqueue and the card's
    work) and its host time (the clock around the call, nothing awaited);
    the callables in turns (a, b, b, a)."""
    window = {k: [] for k in fns}
    host = {k: [] for k in fns}
    order = list(fns.items())
    for _ in range(rounds):
        for name, fn in order + order[::-1]:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            t0 = time.perf_counter()
            fn()
            host[name].append((time.perf_counter() - t0) * 1e3)
            end.record()
            torch.cuda.synchronize()
            window[name].append(start.elapsed_time(end))
    return {k: {"window_ms": statistics.median(window[k]), "host_ms": statistics.median(host[k])}
            for k in fns}


def grid_sum(calls: int) -> dict:
    from lomanerf_tpu_torch.ops import probe

    x = torch.randn((8, 7864320), generator=torch.Generator("cuda").manual_seed(0),
                    device="cuda")
    probe.grid_sum(x, 3840).item()  # warm-up (and the scratch's first allocation)
    torch.sum(x).item()
    # both in one session (the card idle between them): torch.sum's work
    # includes a memset of its own
    events, lib = device_events(lambda: probe.grid_sum(x, 3840), calls,
                                after=lambda: torch.sum(x))
    names = collections.Counter(e[0] for e in events)
    us = sum(e[2] for e in events) / calls
    lib_us = sum(e[2] for e in lib) / calls
    turns = one_call_ms({"grid_sum": lambda: probe.grid_sum(x, 3840),
                         "torch.sum": lambda: torch.sum(x)}, 25)
    out = {"what": "grid_sum", "calls": calls, "device_ms_per_call": us / 1e3,
           "torch_sum_device_ms": lib_us / 1e3,
           "kernels_per_call": {k: v / calls for k, v in names.items()}, **{
               f"{k}_{m}": v for k in ("grid_sum", "torch.sum") for m, v in turns[k].items()}}
    print(f"grid_sum (8, 7864320) in 3840-column tiles, {calls} calls traced: device "
          f"{us / 1e3:.4f} ms/call (torch.sum {lib_us / 1e3:.4f}); kernels per call "
          f"{out['kernels_per_call']}; one call from an idle card, 50 in turns with "
          "torch.sum: " + ", ".join(f"{k} event window {v['window_ms']:.4f} ms, host "
                                     f"{v['host_ms']:.4f} ms" for k, v in turns.items()))
    return out


def seeded_full(rng):
    """``full()``'s params drawn from numpy as ``chip_smoke.seeded_params``
    draws them (``init="nerf"``), on the card."""
    from lomanerf_tpu_torch.models import NeRFConfig

    cfg = NeRFConfig.full()
    sizes = [cfg.in_channels] + [cfg.filter_size] * (cfg.num_layers - 1) + [cfg.out_channels]
    ws = []
    for fi, fo in zip(sizes[:-1], sizes[1:]):
        ws.append(torch.tensor(rng.standard_normal((fi, fo)) * np.sqrt(2.0 / fi),
                               dtype=torch.float32, device="cuda"))
        rng.standard_normal(fo)  # the biases the draw discards for init="nerf"
    bs = [torch.zeros(w.shape[1], device="cuda") for w in ws]
    ws[-1] *= 0.1
    bs[-1][3] = 0.5
    return cfg, {"w": ws, "b": bs}


def leaves() -> dict:
    from lomanerf_tpu_torch.core import rays
    from lomanerf_tpu_torch.ops import fused_nerf

    def batch(rng, cfg, n):
        o, d = (torch.tensor(rng.standard_normal((n, 3)), dtype=torch.float32,
                             device="cuda") for _ in range(2))
        t, dists = rays.uniform_depths(cfg.near, cfg.far, cfg.num_samples, "cuda")
        return o, d, t, dists, torch.tensor(rng.random((n, 3)), dtype=torch.float32,
                                            device="cuda")

    def worst(params, fn):
        lv = [p.requires_grad_(True) for p in [*params["w"], *params["b"]]]
        got = [torch.autograd.grad(f(), lv) for f in fn]
        return [((a - b).abs().max() / b.abs().max()).item() for a, b in zip(*got)]

    out = {}
    rng = np.random.default_rng(7)
    cfg, params = seeded_full(rng)
    o, d, t, dists, tgt = batch(rng, cfg, 1037)
    cot = torch.tensor(rng.standard_normal((1037, 3)), dtype=torch.float32, device="cuda")
    out["train_1037"] = worst(params, [
        lambda f=f: f(params, o, d, t, dists, tgt, cfg)
        for f in (fused_nerf.nerf_train_loss, fused_nerf.nerf_train_loss_reference)])
    out["render_bwd_1037"] = worst(params, [
        lambda f=f: (f(params, o, d, t, dists, cfg) * cot).sum()
        for f in (fused_nerf.render_rays, fused_nerf.render_rays_reference)])
    rng = np.random.default_rng(0)
    cfg, params = seeded_full(rng)
    b = batch(np.random.default_rng(0), cfg, 16384)
    out["train_16384"] = worst(params, [
        lambda f=f: f(params, *b, cfg)
        for f in (fused_nerf.nerf_train_loss, fused_nerf.nerf_train_loss_reference)])
    for k, v in out.items():
        print(f"{k}: worst |kernel-plain| / max|plain| per leaf (dW_0.., db_0..): "
              + " ".join(f"{e:.2e}" for e in v) + f"; max {max(v):.3e}")
    return {"what": "leaves", **out}


def walk(parent: str, rounds: int = 5) -> dict:
    from lomanerf_tpu_torch.core import rays
    from lomanerf_tpu_torch.models import NeRFConfig, NeRFModel
    from lomanerf_tpu_torch.ops import build, fused_nerf
    from lomanerf_tpu_torch.scripts.grad_variants import small_call_inputs
    from lomanerf_tpu_torch.train.steps import make_single_chip_train_step

    libs = {"parent": parent_library(parent), "this tree": build.load()}
    load = build.load

    def on(lib, fn):
        build.load = lambda: libs[lib]
        try:
            return fn()
        finally:
            build.load = load

    def turns(fns):
        ms = one_call_ms(fns, rounds)  # the event window of one call each
        return {k: v["window_ms"] for k, v in ms.items()}

    cfg, params, pk, G, (o, d, t, dists, tgt) = small_call_inputs()
    _, tj, dj = NeRFModel(cfg).sample(o, d, generator=torch.Generator("cuda").manual_seed(3))
    cot = torch.tensor(np.random.default_rng(1).standard_normal((o.shape[0], 3)),
                       dtype=torch.float32, device="cuda")
    out = {"what": "walk", "parent": parent, "rounds": rounds}
    for suffix, (tv, dv) in (("", (t, dists)), ("_rays", (tj, dj))):
        pkv = fused_nerf.pack_params(params, tv, dv, 32)
        for entry, y in (("nerf_train", tgt), ("nerf_render_bwd", cot)):
            fns = {lib: (lambda lib=lib, entry=entry, y=y, tv=tv, dv=dv, pkv=pkv: on(
                lib, lambda: fused_nerf._launch_grad(entry, pkv, G, tv, dv, o, d, y, cfg,
                                                     cfg.num_layers, 32)))
                   for lib in libs}
            if not torch.equal(fns["parent"]().clone(), fns["this tree"]()):
                raise SystemExit(f"card_probe: {entry}{suffix} differs from the parent's")
            out[entry + suffix] = turns(fns)
    for preset, n in (("small", 262144), ("single64", 65536)):
        cfg = NeRFConfig.preset(preset)
        rng = np.random.default_rng(0)
        batch = [torch.tensor(rng.standard_normal((n, 3)), dtype=torch.float32, device="cuda")
                 for _ in range(2)]
        batch += [*rays.uniform_depths(cfg.near, cfg.far, cfg.num_samples, "cuda"),
                  torch.tensor(rng.random((n, 3)), dtype=torch.float32, device="cuda")]
        steps = {}
        for lib in libs:
            model = NeRFModel(cfg, device="cuda")
            model.init(torch.Generator().manual_seed(0))
            step = make_single_chip_train_step(cfg, torch.optim.Adam(model.parameters(), lr=5e-4))
            steps[lib] = (lambda lib=lib, model=model, step=step: on(
                lib, lambda: step(model, *batch)))
            steps[lib]()  # warm-up
        out[preset + " step"] = turns(steps)
    print(f"narrow gradient walk, this tree against {parent}, one call each from an idle "
          f"card, {2 * rounds} in turns (CUDA event window, median ms):")
    for k, v in out.items():
        if isinstance(v, dict):
            print(f"  {k:22s} parent {v['parent']:9.3f}  this tree {v['this tree']:9.3f}  "
                  f"ratio {v['this tree'] / v['parent']:.4f}")
    return out


def render(parent: str, rounds: int = 3) -> dict:
    """This tree's narrow render forward against the parent's, in turns."""
    from lomanerf_tpu_torch.core import normalized_intrinsics, rays
    from lomanerf_tpu_torch.models import NeRFConfig, NeRFModel
    from lomanerf_tpu_torch.ops import build
    from lomanerf_tpu_torch.scripts import render_variants as rv
    from lomanerf_tpu_torch.scripts import variants
    from lomanerf_tpu_torch.scripts.grad_variants import small_call_inputs
    from lomanerf_tpu_torch.train.checkpoint import load_params_npz

    libs = {"parent": parent_library(parent), "this tree": build.load()}
    cfg64 = NeRFConfig.preset("single64")
    m64 = NeRFModel(cfg64, device="cuda")
    m64.init(torch.Generator().manual_seed(0))
    params64 = {k: [x.detach() for x in v] for k, v in m64.params.items()}
    _, _, _, _, (o, d, _, _, _) = small_call_inputs(65536)
    cases = {"nerf_render_fwd 800x800": rv.frame_inputs(),
             "nerf_render_fwd_rays 262144": rv.rays_inputs(),
             "nerf_render_fwd single64 65536": (cfg64, params64, (
                 o, d, *rays.uniform_depths(cfg64.near, cfg64.far, cfg64.num_samples, "cuda")))}
    out = {"what": "render", "parent": parent, "rounds": rounds, "device": variants.card()}
    for name, (cfg, params, batch) in cases.items():
        width = 64 if cfg.filter_size > 32 else 32
        fns = {lib: rv.render_call(libs[lib], cfg, params, batch, width) for lib in libs}
        if not torch.equal(fns["parent"]().clone(), fns["this tree"]()):
            raise SystemExit(f"card_probe: {name} differs from the parent's")
        out[name] = {k: v["window_ms"] for k, v in one_call_ms(fns, rounds).items()}
    # the whole frame through render_image (rays, packing, depths and cat too)
    fx = np.load(rv.FIXTURE)
    p = load_params_npz(rv.FIXTURE)
    model = NeRFModel.from_numpy(NeRFConfig.small(), p["w"], p["b"], device="cuda")
    K = normalized_intrinsics(float(fx["focal"]), device="cuda")
    pose = torch.from_numpy(fx["poses"][1]).cuda()
    load = build.load

    def frame_on(lib):
        build.load = lambda: libs[lib]
        try:
            return model.render_image(K, pose, rv.SIZE)
        finally:
            build.load = load
    with torch.no_grad():
        frames = {lib: (lambda lib=lib: frame_on(lib)) for lib in libs}
        for f in frames.values():
            f()  # warm-up
        out["render_image 800x800"] = {k: v["window_ms"]
                                       for k, v in one_call_ms(frames, rounds).items()}
    print(f"narrow render forward, this tree against {parent}, one call each from an idle "
          f"card, {2 * rounds} in turns (CUDA event window, median ms), on {out['device']}:")
    for k, v in out.items():
        if isinstance(v, dict):
            print(f"  {k:32s} parent {v['parent']:9.3f}  this tree {v['this tree']:9.3f}  "
                  f"ratio {v['this tree'] / v['parent']:.4f}")
    return out


FIELD_FAMILIES = ("field_fwd", "field_bwd", "sum_block_partials", "Adam", "other")


def field_family(name: str, cat: str) -> str:
    """The family of a kernel of the image-fit step by its trace name."""
    if cat == "kernel":
        if "field_kernel" in name:
            return "field_bwd" if re.search(r"field_kernel<[^>]*true", name) else "field_fwd"
        if "sum_block_partials" in name:
            return "sum_block_partials"
        if "multi_tensor_apply_kernel" in name:
            return "Adam"
    return "other"


def hires_fit(lib_name=None, on=None):
    """``(model, step)`` of the ``hires`` image fit: seeded init, Adam 1e-3,
    two numpy seed-0 uniform targets cycled over the 1024^2 grid coords;
    ``on(lib_name, fn)`` runs each step through that library."""
    from lomanerf_tpu_torch.models import ImageFieldConfig, ImageFieldModel, image_grid_coords
    from lomanerf_tpu_torch.train.steps import make_image_fit_step

    cfg = ImageFieldConfig.hires()
    n = cfg.img_size ** 2
    coords = image_grid_coords(cfg.img_size, "cuda")
    rng = np.random.default_rng(0)
    targets = [torch.tensor(rng.random((n, 3)), dtype=torch.float32, device="cuda")
               for _ in range(2)]
    model = ImageFieldModel(cfg, device="cuda")
    model.init(torch.Generator().manual_seed(0))
    fit = make_image_fit_step(cfg, torch.optim.Adam(model.parameters(), lr=1e-3))
    calls = [0]

    def step():
        def go():
            fit(model, coords, targets[calls[0] % 2])
        calls[0] += 1
        return go() if on is None else on(lib_name, go)
    return model, step


def field_split(steps: int) -> dict:
    _, step = hires_fit()
    step(), step()  # warm-up
    events = device_events(step, steps)
    ms, launches = collections.Counter(), collections.Counter()
    for name, cat, us, _ in events:
        fam = field_family(name, cat)
        ms[fam] += us / 1e3 / steps
        launches[fam if fam.startswith("field") else
                 (kernel_key(name) if cat == "kernel" else cat)] += 1
    total = sum(ms.values())
    out = {"what": "field", "steps": steps, "device_ms_per_step": total,
           "ms": {k: ms[k] for k in FIELD_FAMILIES},
           "share": {k: ms[k] / total for k in FIELD_FAMILIES},
           "launches_per_step": {k: v / steps for k, v in sorted(launches.items())}}
    print(f"hires image-fit step, 1024x1024 px, {steps} steps traced: device {total:.3f} "
          "ms/step")
    for k in FIELD_FAMILIES:
        print(f"  {k:24s} {ms[k]:9.3f} ms/step  {ms[k] / total:6.1%}")
    print(f"  kernels per step: {out['launches_per_step']}")
    return out


def parent_library(parent: str):
    """The kernels of the checkout at ``parent``, built there, with every
    entry point's signature set (the field's under this tree's C ABI:
    ``field_variants.bind_field``; the render forward's is the same in
    every tree)."""
    from lomanerf_tpu_torch.ops import build
    from lomanerf_tpu_torch.scripts import field_variants

    built = subprocess.run([sys.executable, "-c", "from lomanerf_tpu_torch.ops import build; "
                            "print(build.build())"], cwd=parent, capture_output=True, text=True)
    if built.returncode:
        raise SystemExit(f"card_probe: the build at {parent} failed:\n{built.stderr[-4000:]}")
    old = ctypes.CDLL(built.stdout.strip().splitlines()[-1])
    for name, argtypes in build.SIGNATURES.items():
        if not name.startswith("field_"):
            fn = getattr(old, name)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
    csrc = Path(parent) / "lomanerf_tpu_torch" / "ops" / "csrc"
    return field_variants.bind_field(old, field_variants.takes_tier(csrc))


def parent_packing(parent: str):
    """The field's parameter packing of the checkout at ``parent``: its own
    ``fused_mlp.pack_field_params``, loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        "parent_fused_mlp", Path(parent) / "lomanerf_tpu_torch" / "ops" / "fused_mlp.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.pack_field_params


def field_against(parent: str, rounds: int = 3) -> dict:
    """This tree's field kernels against the parent's, in turns (under one C
    ABI, ``parent_library``; the packing is each tree's own)."""
    from lomanerf_tpu_torch.ops import build, fused_mlp, fused_nerf
    from lomanerf_tpu_torch.scripts import field_variants

    libs = {"parent": parent_library(parent), "this tree": build.load()}
    # each tree's packing and grid bound (fused_mlp's grid is at most its
    # tiles, far more than the card's blocks at 1024^2 under either tile)
    own = {"parent": parent_packing(parent), "this tree": fused_mlp.pack_field_params}
    saved = (build.load, fused_mlp.pack_field_params, fused_mlp.resident_blocks)

    def on(lib, fn):
        build.load = lambda: libs[lib]
        fused_mlp.pack_field_params = own[lib]
        fused_mlp.resident_blocks = (
            lambda _dev, entry, *dims: getattr(libs[lib], f"{entry}_blocks")(*dims))
        try:
            return fn()
        finally:
            build.load, fused_mlp.pack_field_params, fused_mlp.resident_blocks = saved

    def turns(fns):
        ms = one_call_ms(fns, rounds)  # the event window of one call each
        return {k: v["window_ms"] for k, v in ms.items()}

    cfg, params, coords, cot = field_variants.hires_inputs()
    nf = cfg.num_encoding_functions
    width = fused_mlp.kernel_width(params, 2, nf, 3)
    dims = (cfg.num_layers, cfg.in_channels, width, nf, 3, 0)  # "high": the 3xTF32 route
    G = fused_mlp.grad_floats(params, width)
    out = {"what": "field", "parent": parent, "rounds": rounds}
    for entry in ("field_fwd", "field_bwd"):
        fns = {}
        for lib in libs:
            pk = on(lib, lambda: fused_mlp.pack_field_params(params, width))
            if entry == "field_fwd":
                fns[lib] = (lambda lib=lib, pk=pk: on(
                    lib, lambda: fused_mlp._launch_fwd(pk, coords, *dims)))
            else:
                fns[lib] = (lambda lib=lib, pk=pk: on(
                    lib, lambda: fused_mlp._launch_bwd(pk, G, coords, cot, *dims)))
        a, b = fns["parent"]().clone(), fns["this tree"]()
        rel = ((a - b).abs().max() / a.abs().max()).item()
        out[entry] = {**turns(fns), "max_diff_of_largest": rel}
    # each tree's dW/db against autograd of the plain version at the whole
    # image, as chip_smoke phase 10: the leaves' worst distance over their
    # largest entry, and the (leaf, columns) past rtol 1e-3 + 1e-4 of it
    lv = [p.requires_grad_(True) for p in [*params["w"], *params["b"]]]
    plain = torch.autograd.grad(fused_mlp.field_forward_reference(params, coords, nf), lv, cot)
    for lib in libs:
        got = fused_nerf.unpack_grads(on(lib, lambda: fused_mlp._launch_bwd(
            fused_mlp.pack_field_params(params, width), G, coords, cot, *dims)), params, width)
        out[f"{lib} vs plain"] = {
            "worst_of_largest": max(((a - b).abs().max() / b.abs().max()).item()
                                    for a, b in zip(got, plain)),
            "flips": [(i, sorted(set(torch.nonzero(
                (a - b).abs() > 1e-3 * b.abs() + 1e-4 * b.abs().max())[:, -1].tolist())))
                for i, (a, b) in enumerate(zip(got, plain))]}
        out[f"{lib} vs plain"]["flips"] = [f for f in out[f"{lib} vs plain"]["flips"] if f[1]]
    models = {lib: hires_fit(lib, on) for lib in libs}
    for _, step in models.values():
        step(), step()  # warm-up
    with torch.no_grad():
        out["render"] = turns({lib: (lambda lib=lib: on(lib, models[lib][0].render))
                               for lib in libs})
    out["hires step"] = turns({lib: models[lib][1] for lib in libs})
    print(f"field kernels, this tree against {parent}, one call each from an idle card, "
          f"{2 * rounds} in turns (CUDA event window, median ms):")
    for k, v in out.items():
        if k.endswith("vs plain"):
            print(f"  {k}: dW/db worst |kernel - plain| {v['worst_of_largest']:.3e} of the "
                  f"leaf's largest entry; (leaf, columns) past rtol 1e-3 + 1e-4 of it: "
                  f"{v['flips']}")
        elif isinstance(v, dict):
            print(f"  {k:12s} parent {v['parent']:9.3f}  this tree {v['this tree']:9.3f}  "
                  f"ratio {v['this tree'] / v['parent']:.4f}" + (
                      f"  max|this - parent| / max|parent| {v['max_diff_of_largest']:.3e}"
                      if "max_diff_of_largest" in v else ""))
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--what", choices=("flagship", "small", "frame", "grid_sum", "leaves",
                                       "walk", "field", "render"), required=True)
    ap.add_argument("--parent", help="root of the checkout --what walk, field or render "
                    "compares against")
    ap.add_argument("--preset", choices=("full", "small"), default="full",
                    help="the frame --what frame splits")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--path", choices=("fused", "mma"), default="fused")
    ap.add_argument("--calls", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("card_probe: no CUDA device; it measures the card's kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.what == "leaves":
        out = leaves()
    elif args.what in ("walk", "render"):
        if not args.parent:
            raise SystemExit(f"card_probe: --what {args.what} needs --parent DIR")
        out = (walk if args.what == "walk" else render)(args.parent)
    elif args.what == "field" and args.parent:
        out = field_against(args.parent)
    else:
        out = {"flagship": lambda: flagship(args.steps),
               "small": lambda: small(args.steps),
               "frame": lambda: small_frame() if args.preset == "small" else frame(args.path),
               "grid_sum": lambda: grid_sum(args.calls),
               "field": lambda: field_split(args.steps)}[args.what]()
        if not any(out.get(k) for k in ("device_ms_per_step", "device_ms_per_frame",
                                         "device_ms_per_call")):
            raise SystemExit("card_probe: the trace holds no device time")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
