"""Measurements on the card that need a process of their own, or that are
run against another checkout of the port to compare two trees.

* ``--what flagship``: device time by kernel family of ``--steps`` flagship
  train steps (``NeRFConfig.full()``, 16,384 rays x 128 samples, Adam 5e-4,
  ``make_single_chip_train_step``, numpy-seeded batches) after two warm-up
  steps, from one ``utils.profiling.trace`` session (``torch.profiler``:
  only the first session of a process records the card's kernels).  Each
  kernel of the trace is put in a family by its name: the dW GEMMs (the
  wgmma/TMA stage, ``dw_wgmma_kernel``, and ``gemm_*_kernel`` with the
  ``kEpiPartial`` epilogue), the ``d_h`` GEMMs (``kEpiMask``), the forward
  GEMMs (``kEpiBiasRelu``), compositing, the partials' and column sums, the
  encoding, the loss sum, memsets and copies, and the rest (Adam, the
  parameter packing).  Prints ms per step, the share of the device time and
  the kernels launched per step by name (a layer GEMM with its epilogue:
  ``layer_wgmma_kernel kEpiBiasRelu``).  ``--config c4`` takes the 8x1024
  bf16 MLP (C4: mip-NeRF 360's NeRF MLP, S = 128, standard, init "nerf")
  at the same batch; ``--config c4f32`` the same MLP at f32 compute (the
  ``train_nerf --layers 8 --width 1024`` default, every product on the f32
  GEMM, ``gemm_f32_kernel``) at 4096 rays.  With ``--parent DIR``, instead: the wide kernels of
  this tree against those of the checkout at ``DIR`` (built there), in
  turns in one process at the config's batch: the train call
  (``nerf_wide_train``: loss and dW/db) and the render (``render_rays``),
  each pair's outputs required bit-equal, and the Adam step; then, on this
  tree, the layer GEMM alone (bf16: ``ops/wide_gemm``, the forward form
  beside ``torch.addmm`` + ``relu`` in bf16, and the ``d_h`` form;
  ``c4f32``: ``ops/f32_gemm``, the forward, ``d_h`` and dW forms, beside
  ``torch.addmm`` + ``relu_`` and ``torch.mm`` in f32, TF32 off) at one
  gradient chunk's layer.
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
  compositing and the rest; with ``--path layers``, the same frames on the
  layer chain the fused MLP replaced (``wide_mlp.render_rays_layers`` over
  the same chunks), whose encoding and layer GEMMs are families of their
  own.  Prints ms per frame, each family's share and the kernels
  launched per frame by name.  ``--config c4``: a 128x128 frame (16,384
  rays, the timed batch of chip_smoke's phase 24) of the 8x1024 bf16 MLP,
  whose render runs the layer chain; ``c4f32`` a 64x64 frame (4096 rays) of
  the f32 one.  With ``--preset small``: an 800x800
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
* ``--what field_wide``: device time by kernel of ``--steps`` image-fit
  steps of the wide field route's full-width cell (``chip_smoke.py`` phase
  25: the 4x256 field, n = 8, at 512x512, the whole image a step, Adam
  1e-3, ``ImageFieldConfig``'s "high" tier) after two warm-up steps, from
  one trace, each kernel named by its place in the step
  (:func:`wide_field_label`): the forward's encoding, each layer's GEMM and
  the head; the backward's recomputed encoding and layers, the head's d_z,
  each layer's dW partials, their fixed-order sum, the column sums (db),
  each layer's ``d_h``; Adam and the rest.  ``--tier highest`` fits on the
  "highest" tier (every product on the f32 GEMM, ``gemm_f32_kernel``).
  With ``--parent DIR``, instead: ``field_wide_fwd`` and ``field_wide_bwd``
  of this tree ("high", with and without the kept activations, and
  "highest") and of the checkout at ``DIR`` ("high" and "highest"; built
  there, under this tree's C ABI) at that cell, in turns in one process,
  each tier's outputs required bit-equal across the trees.
* ``--what scans [--parent DIR]``: ``seg_scans`` (#15), each op at the
  262,144 x 30 column, the same values at S = 64 and 128, and 1024 x 128:
  this tree's kernel, the same at tile stride S (bank conflicts at even
  S) and the kernel of the checkout at ``DIR``, in turns in one process,
  outputs required equal to numpy's f32 sequential accumulate bit for
  bit: the card's work of one call by CUDA events behind a spin kernel,
  with the L2 as found and flushed (a 128 MiB read; a 128 MiB write, whose
  dirty lines the call's misses write back), and the kernel's duration
  from one trace.
* ``--what pipeline``: the ``small`` driver step (``train_nerf.main``,
  4096 rays, the 16-view 64x64 synthetic scene, Adam 5e-4) under each ray
  producer, ``--pipeline python``, ``numpy`` and ``native``, ``--steps``
  steps each, one after the other in one trace: from the driver's
  ``train_nerf.step`` spans after ``PIPELINE_WARMUP`` steps, the host's
  ms a step (the spans' window over their count), the card's busy ms a
  step (the union of its kernels, copies and memsets inside that window)
  and its idle share (1 - busy / window).  Each step ends in the loss's
  read, so a step's device work lies inside its span.
* ``--what leaves``: each wide leaf's worst |kernel - plain| of the
  flagship's train-loss gradients, over the leaf's largest entry, on the
  inputs of ``chip_smoke.py`` phase 7 (``full()`` on 1037 rays, numpy seed
  7; the 16,384-ray bench batch, seed 0), and of the render backward's for
  the 1037-ray cotangent.

The last line is one JSON object with the numbers.  Run:

    python -m lomanerf_tpu_torch.scripts.card_probe --what flagship --steps 3 [--config c4|c4f32]
    python -m lomanerf_tpu_torch.scripts.card_probe --what flagship --config c4 --parent DIR
    python -m lomanerf_tpu_torch.scripts.card_probe --what small --steps 5
    python -m lomanerf_tpu_torch.scripts.card_probe --what frame [--path layers] [--config c4|c4f32]
    python -m lomanerf_tpu_torch.scripts.card_probe --what frame --preset small
    python -m lomanerf_tpu_torch.scripts.card_probe --what render --parent DIR
    python -m lomanerf_tpu_torch.scripts.card_probe --what grid_sum --calls 20
    python -m lomanerf_tpu_torch.scripts.card_probe --what leaves
    python -m lomanerf_tpu_torch.scripts.card_probe --what pipeline --steps 60
    python -m lomanerf_tpu_torch.scripts.card_probe --what field [--parent DIR]
    python -m lomanerf_tpu_torch.scripts.card_probe --what field_wide [--tier highest]
    python -m lomanerf_tpu_torch.scripts.card_probe --what field_wide --parent DIR
    python -m lomanerf_tpu_torch.scripts.card_probe --what walk --parent DIR
    python -m lomanerf_tpu_torch.scripts.card_probe --what scans [--parent DIR]
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
# the side of --what frame --config c4 (16,384 rays, phase 24's render) and
# c4f32 (4096 rays), and each config's train batch
FRAME_SIDE = {"full": 800, "c4": 128, "c4f32": 64}
CONFIG_RAYS = {"full": 16384, "c4": 16384, "c4f32": 4096}
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
    epi = layer_epilogue(name)
    if epi is not None:
        return _EPILOGUE[epi]
    for key, fam in (("composite_kernel", "compositing"), ("sum_partials_kernel",
                     "partial and column sums"), ("colsum_kernel", "partial and column sums"),
                     ("encode_kernel", "encoding"), ("loss_sum_kernel", "loss sum")):
        if key in name:
            return fam
    return "other"


def layer_epilogue(name: str):
    """The epilogue (``kEpi``) of a layer GEMM by its trace name: the last
    template argument of ``gemm_mma_kernel``/``gemm_f32_kernel``, the first
    of ``layer_wgmma_kernel``; None for any other kernel."""
    gemm = re.search(r"gemm_(?:mma|f32)_kernel<([^>]*)>", name)
    if gemm:
        return int(gemm.group(1).split(",")[-1])
    layer = re.search(r"layer_wgmma_kernel<(\d+)", name)
    return int(layer.group(1)) if layer else None


def nerf_config(name: str):
    """The NeRF configuration ``--config`` names: ``full`` (the 8x256
    flagship), ``c4`` (8x1024 bf16 at S = 128, standard, init "nerf":
    the NeRF MLP of mip-NeRF 360, Barron et al., CVPR 2022, section 5, with
    the repo's encoding and head; chip_smoke.py phase 24's) or ``c4f32``
    (the same at f32 compute)."""
    from lomanerf_tpu_torch.models import NeRFConfig

    if name in ("c4", "c4f32"):
        return NeRFConfig(num_layers=8, filter_size=1024, num_samples=128, mode="standard",
                          init="nerf",
                          compute_dtype="bfloat16" if name == "c4" else "float32")
    return NeRFConfig.full()


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


def flagship(steps: int, config: str = "full") -> dict:
    n = CONFIG_RAYS[config]
    events = train_steps(nerf_config(config), n, steps)
    ms, launches = collections.Counter(), collections.Counter()
    for name, cat, us, _ in events:
        ms[family(name, cat)] += us / 1e3 / steps
        if cat == "kernel":
            launches[kernel_key(name)] += 1
    total = sum(ms.values())
    out = {"what": "flagship", "config": config, "rays": n, "steps": steps,
           "device_ms_per_step": total,
           "ms": {k: ms[k] for k in FAMILIES}, "share": {k: ms[k] / total for k in FAMILIES},
           "launches_per_step": {k: v / steps for k, v in sorted(launches.items())}}
    print(f"{config} train step, {n} rays, {steps} steps traced: device {total:.3f} ms/step")
    for k in FAMILIES:
        print(f"  {k:24s} {ms[k]:9.3f} ms/step  {ms[k] / total:6.1%}")
    print(f"  kernels per step: {out['launches_per_step']}")
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
    GEMM (``gemm_mma_kernel kEpiBiasRelu``, ``layer_wgmma_kernel kEpiMask``)."""
    epi = layer_epilogue(name)
    if epi is not None:
        fn = re.search(r"(gemm_(?:mma|f32)_kernel|layer_wgmma_kernel)<", name).group(1)
        return f"{fn} {('kEpiBiasRelu', 'kEpiMask', 'kEpiPartial')[epi]}"
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


def frame(path: str, config: str = "full") -> dict:
    from lomanerf_tpu_torch.core import normalized_intrinsics, rays
    from lomanerf_tpu_torch.models import NeRFModel
    from lomanerf_tpu_torch.ops import fused_nerf, wide_mlp

    cfg, size = nerf_config(config), FRAME_SIDE[config]
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
            return torch.cat([wide_mlp.render_rays_layers(W, b, t, dists, oc, dc, cfg)
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
    out = {"what": "frame", "path": path, "config": config, "size": size, "frames": FRAMES,
           "chunks": -(-size * size // chunk),
           "device_ms_per_frame": total, "ms": {k: ms[k] for k in FAMILIES},
           "share": {k: ms[k] / total for k in FAMILIES},
           "launches_per_frame": {k: v / FRAMES for k, v in sorted(launches.items())}}
    print(f"{size}x{size} {config} frame ({path}), {FRAMES} frames traced, {out['chunks']} chunks of "
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


def wide_against(parent: str, config: str, rounds: int = 3) -> dict:
    """This tree's wide kernels against the parent's at ``config``'s
    16,384-ray batch, in turns, and this tree's layer GEMM alone beside
    ``torch.addmm`` (``--what flagship --parent``)."""
    from lomanerf_tpu_torch.core import rays
    from lomanerf_tpu_torch.models import NeRFModel
    from lomanerf_tpu_torch.ops import build, fused_nerf, wide_gemm
    from lomanerf_tpu_torch.scripts import variants
    from lomanerf_tpu_torch.train.steps import make_single_chip_train_step

    libs = {"parent": parent_library(parent), "this tree": build.load()}
    # each tree's own wrappers, which know its C ABI (the train step calls
    # fused_nerf.nerf_train_loss)
    nerf = {"parent": parent_module(parent, "fused_nerf"), "this tree": fused_nerf}
    saved = build.load, fused_nerf.nerf_train_loss

    def on(lib, fn):
        build.load = lambda: libs[lib]
        fused_nerf.nerf_train_loss = nerf[lib].nerf_train_loss
        try:
            return fn()
        finally:
            build.load, fused_nerf.nerf_train_loss = saved

    cfg, n = nerf_config(config), CONFIG_RAYS[config]
    rng = np.random.default_rng(0)
    o, d = (torch.tensor(rng.standard_normal((n, 3)), dtype=torch.float32, device="cuda")
            for _ in range(2))
    tgt = torch.tensor(rng.random((n, 3)), dtype=torch.float32, device="cuda")
    t, dists = rays.uniform_depths(cfg.near, cfg.far, cfg.num_samples, "cuda")
    model = NeRFModel(cfg, device="cuda")
    model.init(torch.Generator().manual_seed(0))
    leaves = list(model.parameters())

    def train(lib):
        loss = nerf[lib].nerf_train_loss(model.params, o, d, t, dists, tgt, cfg)
        return (loss.detach(), *torch.autograd.grad(loss, leaves))

    def render(lib):
        with torch.no_grad():
            return nerf[lib].render_rays(model.params, o, d, t, dists, cfg)

    out = {"what": "flagship", "config": config, "parent": parent, "rounds": rounds,
           "device": variants.card()}
    for what, fn in (("train call", train), ("render", render)):
        fns = {lib: (lambda lib=lib, fn=fn: on(lib, lambda: fn(lib))) for lib in libs}
        a, b = fns["parent"](), fns["this tree"]()
        a, b = (a,) if torch.is_tensor(a) else a, (b,) if torch.is_tensor(b) else b
        # the loss, dW and colours bit for bit; db (the 1-D leaves) may differ
        # in its sum order: its largest gap, relative to the leaf's largest entry
        same = [torch.equal(x, y) for x, y in zip(a, b) if x.ndim != 1]
        if not all(same):
            raise SystemExit(f"card_probe: the {config} {what} differs from the parent's")
        out[what] = {k: v["window_ms"] for k, v in one_call_ms(fns, rounds).items()}
        gaps = [((x - y).abs().max() / y.abs().max().clamp_min(1e-30)).item()
                for x, y in zip(a, b) if x.ndim == 1]
        if gaps:
            out[what]["db_gap"] = max(gaps)
    steps = {}
    for lib in libs:
        m = NeRFModel(cfg, device="cuda")
        m.init(torch.Generator().manual_seed(0))
        step = make_single_chip_train_step(cfg, torch.optim.Adam(m.parameters(), lr=5e-4))
        steps[lib] = (lambda lib=lib, m=m, step=step: on(lib, lambda: step(m, o, d, t, dists,
                                                                           tgt)))
        steps[lib]()  # warm-up
    out["step"] = {k: v["window_ms"] for k, v in one_call_ms(steps, rounds).items()}
    del steps, model, leaves
    torch.cuda.empty_cache()

    # the layer GEMM alone at one gradient chunk's layer of this config
    pw = fused_nerf._round_up(cfg.filter_size, 128)
    rows = fused_nerf.wide_grad_chunk_rays(cfg, pw, cfg.num_layers) * cfg.num_samples
    out.update(f32_gemm_alone(rows, pw, rounds) if cfg.compute_dtype == "float32"
               else layer_gemm_alone(rows, pw, rounds))
    print(f"{config} wide kernels, this tree against {parent}, {n} rays, one call each from "
          f"an idle card, {2 * rounds} in turns (CUDA event window, median ms), on "
          f"{out['device']}:")
    for k in ("train call", "render", "step"):
        v = out[k]
        print(f"  {k:12s} parent {v['parent']:9.3f}  this tree {v['this tree']:9.3f}  "
              f"ratio {v['this tree'] / v['parent']:.4f}"
              + (f"  db apart by {v['db_gap']:.2e} of its largest entry" if "db_gap" in v
                 else ""))
    print(f"  the layer GEMM alone at {rows} x {pw} . {pw} x {pw} "
          f"({'f32' if cfg.compute_dtype == 'float32' else 'bf16, f32 sums'}):")
    for k in [k for k in out if k.startswith("layer gemm")]:
        print(f"  {k:20s} " + "  ".join(f"{lib} {ms:8.3f} ms ({out[k]['tflops'][lib]:.1f} "
                                         "TFLOP/s)" for lib, ms in out[k].items()
                                         if lib != "tflops"))
    return out


def layer_gemm_alone(rows: int, pw: int, rounds: int) -> dict:
    """The bf16 layer GEMM alone (``ops/wide_gemm``) at ``rows`` x ``pw``
    . ``pw`` x ``pw``: both forms, the forward beside ``torch.addmm`` +
    ``relu_``."""
    from lomanerf_tpu_torch.ops import wide_gemm

    g = torch.Generator("cuda").manual_seed(5)
    h = torch.rand((rows, pw), generator=g, device="cuda").to(torch.bfloat16)
    dz = torch.randn((rows, pw), generator=g, device="cuda").to(torch.bfloat16)
    mask = torch.randn((rows, pw), generator=g, device="cuda").to(torch.bfloat16)
    W = (torch.randn((pw, pw), generator=g, device="cuda") / pw ** 0.5).to(torch.bfloat16)
    b = torch.randn(pw, generator=g, device="cuda")
    fwd = {"wgmma": lambda: wide_gemm.wide_layer_gemm(h, W, b, pw),
           "addmm": lambda: torch.addmm(b.to(torch.bfloat16), h, W).relu_()}
    dh = {"wgmma": lambda: wide_gemm.wide_dh_gemm(dz, W, mask, pw)}
    return gemm_turns({"forward": fwd, "d_h": dh}, 2.0 * rows * pw * pw, rounds)


def f32_gemm_alone(rows: int, pw: int, rounds: int) -> dict:
    """The f32 GEMM alone (``ops/f32_gemm``) at ``rows`` x ``pw`` . ``pw`` x
    ``pw``: the forward, ``d_h`` and dW (8192-row partials) forms, beside
    ``torch.addmm`` + ``relu_`` (forward) and ``torch.mm`` (``d_h``; dW over
    the whole rows) in f32 with TF32 off."""
    from lomanerf_tpu_torch.ops import f32_gemm

    g = torch.Generator("cuda").manual_seed(5)
    h = torch.rand((rows, pw), generator=g, device="cuda")
    dz = torch.randn((rows, pw), generator=g, device="cuda")
    mask = torch.randn((rows, pw), generator=g, device="cuda")
    W = torch.randn((pw, pw), generator=g, device="cuda") / pw ** 0.5
    b = torch.randn(pw, generator=g, device="cuda")
    forms = {
        "forward": {"kernel": lambda: f32_gemm.f32_layer_gemm(h, W, b, pw),
                    "addmm": lambda: torch.addmm(b, h, W).relu_()},
        "d_h": {"kernel": lambda: f32_gemm.f32_dh_gemm(dz, W, mask, pw),
                "mm": lambda: torch.mm(dz, W.T)},
        "dW": {"kernel": lambda: f32_gemm.f32_dw_gemm(h, dz, pw, 8192),
               "mm": lambda: torch.mm(h.T, dz)}}
    return gemm_turns(forms, 2.0 * rows * pw * pw, rounds)


def gemm_turns(forms: dict, flop: float, rounds: int) -> dict:
    out = {}
    for form, fns in forms.items():
        key = f"layer gemm {form}"
        out[key] = {k: v["window_ms"] for k, v in one_call_ms(fns, rounds).items()}
        out[key]["tflops"] = {k: flop / v / 1e9 for k, v in out[key].items()}
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
    entry point's signature set as that checkout's ``ops/build.py`` sets
    it (the field's under this tree's C ABI: ``field_variants.bind_field``)."""
    from lomanerf_tpu_torch.scripts import field_variants

    built = subprocess.run([sys.executable, "-c", "from lomanerf_tpu_torch.ops import build; "
                            "print(build.build())"], cwd=parent, capture_output=True, text=True)
    if built.returncode:
        raise SystemExit(f"card_probe: the build at {parent} failed:\n{built.stderr[-4000:]}")
    old = ctypes.CDLL(built.stdout.strip().splitlines()[-1])
    for name, argtypes in parent_module(parent, "build").SIGNATURES.items():
        if not name.startswith("field_") and hasattr(old, name):  # entries it has
            fn = getattr(old, name)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
    csrc = Path(parent) / "lomanerf_tpu_torch" / "ops" / "csrc"
    return field_variants.bind_field(old, field_variants.takes_tier(csrc))


def parent_module(parent: str, name: str):
    """The module ``lomanerf_tpu_torch.ops.<name>`` of the checkout at
    ``parent``, loaded from its file (it imports the rest of the port from
    this tree)."""
    spec = importlib.util.spec_from_file_location(
        "parent_" + name, Path(parent) / "lomanerf_tpu_torch" / "ops" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def parent_packing(parent: str):
    """The field's parameter packing of the checkout at ``parent``: its own
    ``fused_mlp.pack_field_params``."""
    return parent_module(parent, "fused_mlp").pack_field_params


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


WIDE_FIELD_SIZE = 512  # chip_smoke.py phase 25's 4x256 cell
# nerf_wide_gemm.cuh's epilogue codes, the last template argument of both
# GEMMs of the wide field route (gemm_f32_kernel, FMAs; gemm3_kernel, 3xTF32)
_WIDE_EPI = {0: "forward", 1: "d_h", 2: "dW", 3: "head", 4: "head d_z"}


def wide_field_label(name: str, cat: str, state: dict) -> str:
    """The place in a fit step of one kernel of the wide field route, by its
    trace name, the kernels read in the card's order: ``state`` (a dict,
    empty at the first) carries the pass and layer.  An encoding starts the
    forward call or, between the forward's head and the head's d_z, the
    backward's recomputed forward (where the forward kept no activations);
    the hidden layers count up from 0; the head's d_z sets the backward's
    layer to L, each dW partial counts it down, and ``d_h`` belongs to that
    layer; a fixed-order sum after a column sum is the column sums' (db),
    else the dW partials'."""
    if cat != "kernel":
        return "memset and copy"
    gemm = re.search(r"gemm(?:3|_f32)_kernel<([^>]*)>", name)
    if "encode_kernel" in name:  # after the forward's head and before its d_z: a recompute
        state["pass"] = "bwd" if state.get("last") == "head" else "fwd"
        state["layer"], state["last"] = 0, "encode"
        return f"{state['pass']}: encode"
    if gemm:
        epi = state["last"] = _WIDE_EPI[int(gemm.group(1).split(",")[-1])]
        if epi == "forward":
            state["layer"] += 1
            return f"{state['pass']}: layer {state['layer'] - 1}"
        if epi == "head":
            return "fwd: head"
        if epi == "head d_z":
            state["layer"] += 1  # L: the head is layer L - 1
            return "bwd: head d_z"
        if epi == "dW":
            state["layer"] -= 1
        return f"bwd: {epi} layer {state['layer']}"
    if "colsum_kernel" in name:
        state["last"] = "colsum"
        return "bwd: db column sums"
    if "sum_partials_kernel" in name:
        return "bwd: db column sums" if state.get("last") == "colsum" else "bwd: dW partial sums"
    if "multi_tensor_apply_kernel" in name:
        return "Adam"
    return "other"


def wide_field_fit(tier: str = "high"):
    """``(model, step)`` of phase 25's 4x256 fit at 512x512 on the precision
    ``tier``: seeded init, Adam 1e-3, two numpy seed-0 uniform targets
    cycled."""
    from lomanerf_tpu_torch.models import ImageFieldConfig, ImageFieldModel, image_grid_coords
    from lomanerf_tpu_torch.train.steps import make_image_fit_step

    cfg = ImageFieldConfig(num_layers=4, filter_size=256, num_encoding_functions=8,
                           img_size=WIDE_FIELD_SIZE, precision=tier)
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
        fit(model, coords, targets[calls[0] % 2])
        calls[0] += 1
    return model, step


def field_wide_split(steps: int, tier: str = "high") -> dict:
    from lomanerf_tpu_torch.ops import fused_mlp

    model, step = wide_field_fit(tier)
    if fused_mlp.kernel_width(model.params, 2, 8, 3) is not None:
        raise SystemExit("card_probe: the 4x256 field is not on the wide route")
    step(), step()  # warm-up
    events = device_events(step, steps)
    ms, launches, state = collections.Counter(), collections.Counter(), {}
    for name, cat, us, _ in events:
        key = wide_field_label(name, cat, state)
        ms[key] += us / 1e3 / steps
        launches[key] += 1
    total = sum(ms.values())
    out = {"what": "field_wide", "tier": tier, "steps": steps, "device_ms_per_step": total,
           "ms": dict(ms), "share": {k: v / total for k, v in ms.items()},
           "launches_per_step": {k: v / steps for k, v in launches.items()}}
    print(f"4x256 image-fit step, {WIDE_FIELD_SIZE}x{WIDE_FIELD_SIZE} px, \"{tier}\" tier, "
          f"{steps} steps traced: device {total:.3f} ms/step")
    for k, v in ms.items():
        print(f"  {k:28s} {v:9.3f} ms/step  {v / total:6.1%}  "
              f"{launches[k] / steps:g} a step")
    return out


def field_wide_against(parent: str, rounds: int = 3) -> dict:
    """This tree's wide field route against the parent's, in turns (the
    parent under this tree's C ABI)."""
    from lomanerf_tpu_torch.models import image_grid_coords
    from lomanerf_tpu_torch.ops import build, fused_mlp

    old = parent_library(parent)
    for name in ("field_wide_fwd", "field_wide_bwd"):
        fn = getattr(old, name)
        fn.argtypes, fn.restype = build.SIGNATURES[name], ctypes.c_int
    libs = {"parent": old, "this tree": build.load()}
    saved = build.load

    def on(lib, fn):
        build.load = lambda: libs[lib]
        try:
            return fn()
        finally:
            build.load = saved

    params = wide_field_fit()[0].params
    coords = image_grid_coords(WIDE_FIELD_SIZE, "cuda")
    cot = torch.tensor(np.random.default_rng(1).standard_normal((coords.shape[0], 3)),
                       dtype=torch.float32, device="cuda")
    dims = fused_mlp.field_wide_dims(params, 2, 3)
    W, b = fused_mlp.pack_field_wide(params, dims[2], 3)
    # (library, exact, keep): "kept" keeps the forward's activations for the
    # backward, as under autograd
    runs = {"parent": ("parent", 0, False), "this tree high": ("this tree", 0, False),
            "this tree high kept": ("this tree", 0, True),
            "parent highest": ("parent", 1, False),
            "this tree highest": ("this tree", 1, False)}
    kept = on("this tree", lambda: fused_mlp._launch_wide_fwd(W, b, coords, 8, 3, dims, 0,
                                                              True))[1]
    out = {"what": "field_wide", "parent": parent, "rounds": rounds}
    for entry in ("field_wide_fwd", "field_wide_bwd"):
        fns = {}
        for key, (lib, exact, keep) in runs.items():
            if entry == "field_wide_fwd":
                def fn(lib=lib, exact=exact, keep=keep):
                    return on(lib, lambda: fused_mlp._launch_wide_fwd(W, b, coords, 8, 3, dims,
                                                                      exact, keep))
            else:
                def fn(lib=lib, exact=exact, keep=keep):
                    return on(lib, lambda: fused_mlp._launch_wide_bwd(
                        W, b, coords, cot, 8, dims, exact, kept if keep else None))
            fns[key] = fn
        for old, new in (("parent", "this tree high"), ("parent highest", "this tree highest")):
            x, y = fns[old](), fns[new]()
            if not all(torch.equal(p, q) for p, q in zip(x, y) if p is not None):
                raise SystemExit(f"card_probe: {entry} {new} differs from {old}")
        out[entry] = {k: v["window_ms"] for k, v in one_call_ms(fns, rounds).items()}
    print(f"wide field route at 4x256, {WIDE_FIELD_SIZE}x{WIDE_FIELD_SIZE}, this tree against "
          f"{parent}, one call each from an idle card, {2 * rounds} in turns (CUDA event "
          "window, median ms):")
    for entry in ("field_wide_fwd", "field_wide_bwd"):
        v = out[entry]
        print(f"  {entry:15s} " + "  ".join(f"{k} {t:8.3f}" for k, t in v.items())
              + f"  high kept / parent {v['this tree high kept'] / v['parent']:.4f}"
              + f"  highest / parent's {v['this tree highest'] / v['parent highest']:.4f}")
    return out


# the main path's column, the same 7,864,320 values at S = 64 and 128, and
# the 1024 x 128 column of the tests
SCAN_SHAPES = ((262144, 30), (122880, 64), (61440, 128), (1024, 128))
# the staged kernel with its tile stride P = S | 1 edited to P = S: even S
# meets 2-way bank conflicts at S = 30 and 32-way at S = 64 and 128
SCAN_STRIDE_EDIT = ("const int P = S | 1;", "const int P = S;", 1)


def scan_stride_s():
    """``seg_scans.cu`` built with ``SCAN_STRIDE_EDIT`` (under
    ``build/scan_variants/``), its entry point bound."""
    from lomanerf_tpu_torch.ops import build
    from lomanerf_tpu_torch.scripts import variants

    src = variants.patch(build.CSRC / "seg_scans.cu", [SCAN_STRIDE_EDIT], "card_probe")
    path = variants.compile_all({"stride S": {}}, src, build.BUILD_ROOT.parent / "scan_variants",
                                "card_probe")["stride S"]
    lib = ctypes.CDLL(str(path))
    lib.seg_scans.argtypes, lib.seg_scans.restype = build.SIGNATURES["seg_scans"], ctypes.c_int
    return lib


def scans_against(parent: str | None, rounds: int = 3, calls: int = 20) -> dict:
    """``seg_scans`` (#15) of this tree, of this tree at tile stride S
    (:func:`scan_stride_s`) and of the checkout at ``parent`` (built there)
    if given, in turns in one process (``scans`` bound to each library):
    each op at ``SCAN_SHAPES`` on [1e-10, 1] values (numpy seed 29), every
    output required equal to numpy's f32 sequential accumulate bit for
    bit; the card's work of one call (``variants.device_turns``), median
    of ``2 * rounds``, with the L2 as found, flushed by a 128 MiB read and
    flushed by a 128 MiB write before each call; and the kernel's own
    duration in one trace of ``calls`` read-flushed cumprods at 262,144 x
    30 a tree (the parent's after a marker kernel)."""
    from lomanerf_tpu_torch.ops import build, scans
    from lomanerf_tpu_torch.scripts import variants

    libs = {"stride S": scan_stride_s(), "this tree": build.load()}
    if parent:
        libs = {"parent": parent_library(parent), **libs}
    load = build.load

    def on(lib, fn):
        build.load = lambda: libs[lib]
        try:
            return fn()
        finally:
            build.load = load

    fns = {"cumprod": scans.seg_inclusive_cumprod, "suffix": scans.seg_suffix_sum,
           "shift": lambda c, S: scans.seg_shift_down(c, S, 1.0)}
    flushes = {"warm": None, "read-flushed": variants.l2_flush("read"),
               "write-flushed": variants.l2_flush("write")}
    rng = np.random.default_rng(29)
    out = {"what": "scans", "parent": parent, "rounds": rounds, "device": variants.card()}
    for R, S in SCAN_SHAPES:
        x = (10.0 ** (-10.0 * rng.random((R, S)) ** 6)).astype(np.float32)
        col = torch.from_numpy(x).cuda().reshape(-1, 1)
        bits = {"cumprod": np.multiply.accumulate(x, axis=1),
                "suffix": np.add.accumulate(x[:, ::-1], axis=1)[:, ::-1],
                "shift": np.concatenate([np.ones((R, 1), np.float32), x[:, :-1]], axis=1)}
        for op, fn in fns.items():
            run = {lib: (lambda lib=lib, fn=fn: on(lib, lambda: fn(col, S))) for lib in libs}
            for lib, call in run.items():
                got = call().cpu().numpy().reshape(R, S)
                if not np.array_equal(got.view(np.uint32), bits[op].view(np.uint32)):
                    raise SystemExit(f"card_probe: {lib}'s {op} at {R} x {S} differs from "
                                     "numpy's f32 accumulate")
            out[f"{op} {R}x{S}"] = {
                mode: {lib: statistics.median(v)
                       for lib, v in variants.device_turns(run, rounds, fl).items()}
                for mode, fl in flushes.items()}
    # the kernels' own durations from the profiler, beside the events' windows
    R, S = SCAN_SHAPES[0]
    col = torch.from_numpy(np.random.default_rng(29).random((R * S, 1), np.float32)).cuda()
    flush = flushes["read-flushed"]

    def flushed(lib):
        def go():
            flush()
            on(lib, lambda: scans.seg_inclusive_cumprod(col, S))
        return go
    names = ["this tree", *(["parent"] if parent else [])]
    sets = device_events(flushed(names[0]), calls,
                         after=flushed(names[1]) if parent else None)
    sets = sets if parent else (sets,)
    out["traced cumprod"] = {}
    for lib, work in zip(names, sets):
        durs = [w[2] / 1e3 for w in work if "seg_scan" in w[0]]
        if len(durs) != calls:
            raise SystemExit(f"card_probe: {len(durs)} seg_scan kernels traced, need {calls}")
        out["traced cumprod"][lib] = statistics.median(durs)
    print(f"seg_scans (#15), one call each, the card's work by CUDA events behind a spin "
          f"kernel, {2 * rounds} in turns, median ms, on {out['device']}:")
    for k, v in out.items():
        if isinstance(v, dict) and k != "traced cumprod":
            for mode, t in v.items():
                print(f"  {k:17s} {mode:13s} " + "  ".join(f"{lib} {ms:8.4f}"
                                                           for lib, ms in t.items()))
    print(f"  kernel duration (profiler, {calls} read-flushed cumprods at {R}x{S}): "
          + "  ".join(f"{lib} {ms:.4f}" for lib, ms in out["traced cumprod"].items()))
    return out


PIPELINES = ("python", "numpy", "native")
PIPELINE_WARMUP = 10  # driver steps before the measured window (the step-0 eval among them)


def busy_us(intervals, lo: float, hi: float) -> float:
    """Length of the union of ``(start, end)`` intervals clipped to [lo, hi]."""
    total, reach = 0.0, lo
    for a, b in sorted(intervals):
        a, b = max(a, reach), min(b, hi)
        if b > a:
            total += b - a
            reach = b
    return total


def pipeline(steps: int) -> dict:
    """The ``small`` driver step's host ms, device ms and idle share under
    each ray producer (``--what pipeline``)."""
    from lomanerf_tpu_torch.train import train_nerf
    from lomanerf_tpu_torch.utils import trace

    if steps <= PIPELINE_WARMUP:
        raise SystemExit(f"card_probe: --what pipeline needs --steps > {PIPELINE_WARMUP}")
    with tempfile.TemporaryDirectory() as tmp:
        with trace(os.path.join(tmp, "trace")):
            for name in PIPELINES:
                train_nerf.main([
                    "--device", "cuda", "--preset", "small", "--img-size", "64",
                    "--rays-per-batch", "4096", "--steps", str(steps), "--pipeline", name,
                    "--eval-every", str(10 * steps), "--ckpt-every", "0",
                    "--log-dir", os.path.join(tmp, name, "logs"),
                    "--ckpt-dir", os.path.join(tmp, name, "ck")])
        with open(os.path.join(tmp, "trace", "trace.json")) as f:
            events = json.load(f)["traceEvents"]
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                   if e.get("name") == "train_nerf.step" and e.get("cat") == "user_annotation")
    if len(spans) != steps * len(PIPELINES):
        raise SystemExit(f"card_probe: {len(spans)} train_nerf.step spans, need "
                         f"{steps * len(PIPELINES)}")
    work = [(ts, ts + us) for _, _, us, ts in card_work(events)]
    out = {"what": "pipeline", "steps": steps - PIPELINE_WARMUP, "rays": 4096,
           "device": torch.cuda.get_device_name(0), "pipelines": {}}
    print(f"small driver step, 4096 rays, {steps - PIPELINE_WARMUP} steps a producer after "
          f"{PIPELINE_WARMUP}:")
    for i, name in enumerate(PIPELINES):
        mine = spans[i * steps + PIPELINE_WARMUP:(i + 1) * steps]
        lo, hi = mine[0][0], mine[-1][1]
        busy = busy_us(work, lo, hi)
        n = len(mine)
        out["pipelines"][name] = {
            "host_ms_per_step": (hi - lo) / n / 1e3, "device_ms_per_step": busy / n / 1e3,
            "idle_share": 1.0 - busy / (hi - lo),
            "span_ms_median": statistics.median(b - a for a, b in mine) / 1e3}
        r = out["pipelines"][name]
        print(f"  --pipeline {name:6s}: host {r['host_ms_per_step']:.4f} ms/step (span median "
              f"{r['span_ms_median']:.4f}), device {r['device_ms_per_step']:.4f} ms/step, idle "
              f"{r['idle_share']:.1%}")
    if not all(r["device_ms_per_step"] for r in out["pipelines"].values()):
        raise SystemExit("card_probe: the trace holds no device time")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--what", choices=("flagship", "small", "frame", "grid_sum", "leaves",
                                       "walk", "field", "field_wide", "render", "scans",
                                       "pipeline"),
                    required=True)
    ap.add_argument("--parent", help="root of the checkout --what walk, field, field_wide, "
                    "render, scans or flagship compares against")
    ap.add_argument("--config", choices=("full", "c4", "c4f32"), default="full",
                    help="the NeRF MLP --what flagship and frame run")
    ap.add_argument("--preset", choices=("full", "small"), default="full",
                    help="the frame --what frame splits")
    ap.add_argument("--tier", choices=("high", "highest"), default="high",
                    help="the precision tier --what field_wide fits on")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--path", choices=("fused", "layers"), default="fused")
    ap.add_argument("--calls", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("card_probe: no CUDA device; it measures the card's kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.what == "leaves":
        out = leaves()
    elif args.what == "scans":
        out = scans_against(args.parent, calls=args.calls)
    elif args.what in ("walk", "render"):
        if not args.parent:
            raise SystemExit(f"card_probe: --what {args.what} needs --parent DIR")
        out = (walk if args.what == "walk" else render)(args.parent)
    elif args.what == "flagship" and args.parent:
        out = wide_against(args.parent, args.config)
    elif args.what == "field" and args.parent:
        out = field_against(args.parent)
    elif args.what == "field_wide" and args.parent:
        out = field_wide_against(args.parent)
    elif args.what == "pipeline":
        out = pipeline(args.steps)
    else:
        if args.what == "frame" and args.config != "full" and args.path == "layers":
            raise SystemExit("card_probe: the c4 frame has no fused MLP; its path is the "
                             "layer chain (--path fused)")
        out = {"flagship": lambda: flagship(args.steps, args.config),
               "small": lambda: small(args.steps),
               "frame": lambda: (small_frame() if args.preset == "small"
                                 else frame(args.path, args.config)),
               "grid_sum": lambda: grid_sum(args.calls),
               "field": lambda: field_split(args.steps),
               "field_wide": lambda: field_wide_split(args.steps, args.tier)}[args.what]()
        if not any(out.get(k) for k in ("device_ms_per_step", "device_ms_per_frame",
                                         "device_ms_per_call")):
            raise SystemExit("card_probe: the trace holds no device time")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
