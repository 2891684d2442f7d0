"""Smoke run of the PyTorch port on one CUDA card (an NVIDIA H100 here).

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels from ``lomanerf_tpu_torch/ops/csrc`` with nvcc
(sm_90a, one nvcc per source, in parallel), then:

1. holds the render kernel against its plain PyTorch version on the card,
   at the ``small`` (3x30, S=30) and ``single64`` (4x64, S=64) shapes, in
   both compositing modes, on 1037 rays (not a multiple of the block) and
   on one (a thread runs its ray's samples in pairs);
2. renders the trained 3x30 field (``tests/data/convergence_64_step5000.npz``)
   at 64x64 through ``NeRFModel.render_image`` and compares it with the JAX
   package's renders stored in that file, and its PSNR on the eval view with
   the JAX package's PSNR;
3. renders a 4-frame 800x800 orbit with ``render_orbit`` (the serving path),
   then times one frame through the kernel and through the plain version,
   and the kernel's own call and the plain version's on the frame's rays,
   in turns, with CUDA events;
4. holds the train kernel (loss and dW/db) and the render backward against
   autograd of their plain versions at the same shapes and modes, checks
   that repeat launches are bit-identical, and compares the train kernel
   with the plain version at the bench batch (262,144 rays);
5. trains through ``train_nerf.main`` (small preset, 16 in-memory 64x64
   synthetic views, 500 Adam steps of 4096 rays): one train-kernel launch per
   step, eval renders through the render kernel, eval PSNR >= 19 dB after
   500 steps and 8 dB above step 0, then ``--resume`` for 10 steps; and 10
   steps on ``NeRFModel.loss``, whose backward is the render backward kernel;
6. times the train step at the bench's shape (small, 262,144 rays, Adam)
   through the kernel and through the plain backend, in turns, and each
   gradient kernel's own call against its plain version; splits the step's
   device time by kernel family (``card_probe --what small``, a process of
   its own: the narrow walk, its block sum, Adam, the rest);
7. holds the wide kernels (the 8x256 flagship's render forward, train step
   and render backward) against their plain versions on the card, at
   ``full()`` (bf16) and at an f32 4x128/S=32 MLP in both modes on 1037
   rays, with repeat launches bit-identical, and the train kernel at the
   flagship's bench batch (16,384 rays);
8. trains through ``train_nerf.main --preset full`` (300 Adam steps of 4096
   rays on the same scene): one wide train-kernel launch per step, evals
   through the wide render, eval PSNR >= 20 dB after 300 steps and 8 dB
   above step 0; renders a 4-frame 128x128 orbit of the trained flagship;
   10 steps on ``NeRFModel.loss`` through the wide render backward;
9. times the flagship train step (16,384 rays, Adam) and one 800x800
   ``full`` frame through the kernels and the plain version, in turns, and
   each wide entry point's own call against its plain version; splits the
   step's device time by kernel family (``scripts/card_probe.py`` in a
   process of its own: dW, d_h, forward, compositing, sums), with the
   wgmma/TMA dW stage launched once per hidden layer and every forward
   layer and ``d_h`` on the wgmma/TMA layer GEMM (``layer_wgmma_kernel``),
   none on ``gemm_mma_kernel``; holds that stage
   alone (``wide_dw.wide_dw_gemm``) to f64 at the flagship's 2,097,152 x
   256 x 256, at layer 0's 40 columns and at 1037 x 128 ragged rows, and
   times it against ``torch.mm`` and its bound; times the frame also through the
   layer chain that the bf16 render's fused MLP (``nerf_wide_mlp.cuh``)
   replaced, asserting the same bits off near ties (``wide_mlp.tied_rows``),
   the fused MLP alone on one 65,536-ray chunk against its bound and a
   cuBLAS ``addmm`` + ``relu_`` chain, and #10 at 16,384 rays new against
   old (the same rule); splits the frame's
   device time by kernel family on both paths (``card_probe --what frame``:
   the fused kernel once per chunk, no layer GEMM);
10. holds the 2D field's kernels (``field_fwd``, ``field_bwd``) on both
    product routes (the "high" tier's 3xTF32 on the tensor cores, the
    "highest" tier's f32 FMAs) against the plain version and autograd at
    the ``small`` and ``hires`` widths and at 5x128 on 1037 pixels, with
    repeat launches bit-identical and no coords gradient, and at the full
    1024x1024 image at ``hires`` and 5x128, where each block walks hundreds
    of tiles, printing the ReLU-mask flips' leaves and columns per route
    (the exact route may flip no more columns than 3xTF32);
11. fits images through ``fit_image.main`` on the synthetic target: the
    ``small`` field at 256x256, 301 Adam steps (one launch of each kernel
    per step, eval PSNR >= 22 dB at step 300 and 10 dB above step 0), then
    ``--resume``; the ``hires`` field at 1024x1024, 200 steps, within 0.3
    dB of the same run on the plain backend;
12. times the image-fit step (``small`` at 256x256, ``hires`` at
    1024x1024, Adam 1e-3, two uniform targets cycled) through the kernels
    and the plain backend in turns, the device's busy share of the
    ``small`` step (``utils.profiling.trace``), one 1024x1024 ``hires``
    render, and each field kernel's own call against its plain version,
    its f32 bound and its 3xTF32 bound;
13. holds the per-ray (N, S) depth instances of the six NeRF kernels
    (``*_rays``: the counterparts of #4-#6 and #10-#12) against their plain
    versions on jittered depths from ``NeRFModel.sample(generator=...)``,
    at six MLPs (the narrow presets, a one- and a two-layer MLP, ``full()``
    and an f32 4x128) in both modes on 1037 rays and on one, with repeat
    launches bit-identical and (S,) depths broadcast through them
    bit-identical to the shared-depth kernels; then at the timed steps'
    batches (``small`` 262,144 rays, ``single64`` 65,536, ``full``
    16,384); then the wide ones over many ray chunks (scratch budgets cut),
    bit-identical to one chunk where the chunks align with the split-K
    partials;
14. drives the stratified path: the train step on per-ray depths at the
    ``small`` (262,144 rays), ``single64`` (65,536) and ``full`` (16,384)
    rungs, in turns with the same step at shared depths and on the plain
    backend; 500 ``small`` steps of 4096 rays with fresh jittered depths
    (eval PSNR >= 19 dB and 8 dB above step 0) and 30 ``full`` steps; 10
    ``NeRFModel.loss`` steps each for ``small`` and ``full``; and each
    per-ray kernel's own call against the shared-depth kernel and its
    plain version;
15. runs narrow MLPs whose 64-ray block exceeds the narrow kernels' shared
    memory (5x64 and 8x64 at S=64) through ``_route``'s wide f32 route, on
    1037 rays and a 65,536-ray batch, against their plain versions (only
    wide launches), and times the ``single64`` step on its narrow kernel
    and forced through the wide route, in turns;
16. runs ``make_video.main`` end to end (``--params`` with the fixture, 4
    frames at 128x128), then ``--frames`` on numbered PNGs of them, and
    says whether PIL and imageio import here;
17. counts, as a diagnostic, the rays of the ``small`` batch (jittered and
    uniform depths) whose render-backward dW/db misses the f64 plain
    version through the kernel or through the plain version in f32, by
    bisecting ray chunks, and lists their near-zero hidden
    pre-activations;
18. holds ``seg_scans`` (#15) to numpy's f32 sequential accumulate bit
    for bit, and to numpy f64, its plain version and the library call, at
    R=4/S=6, S=128 down to 1e-10 (subnormal products), S=64 and S=30 at a
    ragged R (the latter at an unaligned storage offset), S=2048 (the
    direct walk) and the 262,144 x 30 column, timed there (the card's work
    alone, with the L2 as found and flushed), and checks the SHA-256
    digests of the twelve NeRF entry points' outputs against
    ``KERNEL_DIGESTS``, and of the six wide ones at 3x384 and 8x1024 bf16
    (the layer chain past the fused MLP) against ``C4_DIGESTS``, recorded
    from the tree whose layer GEMM promotes each 64-deep stage, and at 3x384, 4x512
    and 1x(75->4) f32 with the wide field's "highest" outputs and dW/db
    against ``F32_DIGESTS``, recorded from the tree whose f32 products ran
    the FMA GEMM that ``gemm_f32_kernel`` replaced;
19. runs the grid-overhead sweep (#16,
    ``lomanerf_tpu_torch.scripts.grid_overhead``) at 7,864,320 rows, then
    ``grid_sum`` alone against its plain version and ``torch.sum``, and
    splits one call into its event window, its kernel's device time (one
    kernel a call, ``scripts/card_probe.py``) and the wrapper's host time;
20. drives the data-parallel path (``lomanerf_tpu_torch.parallel``) in
    ranks of its own (``parallel.run_ranks``): (a) a one-rank NCCL group's
    step (the train kernel, one flat SUM all-reduce) at the bench shape,
    bit-identical to ``make_single_chip_train_step``'s after 3 Adam steps,
    both timed in turns; (b) two gloo ranks on the one card, each running
    the train kernel on half of the 262,144 rays, at shared (#3) and per-ray
    (#6) depths, their summed loss and gradients against one process's
    kernel and against the plain version (phase 4's bounds); (c) the
    800x800 ``small`` frame sharded over the two ranks, bit-identical to
    ``render_image``'s and within phase 3's tolerance of the plain version
    on the frame's rays; (d) a tensor-parallel step
    (dp=1, tp=2, the plain path) against the single-process plain step;
21. drives the C++ ray-batch prefetcher (``data.native.RayBatchPipeline``,
    built by g++ from ``lomanerf_tpu_torch/data/csrc``): 500 ``train_nerf
    --pipeline native`` steps (small, 4096 rays, the 16-view 64x64 scene)
    at 4 threads and at 1 thread, params bit-identical (batches in batch-id
    order), and 500 ``--pipeline numpy`` steps within a stated bound of
    them, each run's PSNR as phase 5's; the pipeline alone on 100 random
    800x800 views, its batches on the card (copied from a ring of pinned
    buffers while the card is busy) equal to the CPU pipeline's bit for
    bit, and its batches/s at 4096 and 262,144 rays, native against numpy;
    the driver step's host ms, device ms and idle share under ``--pipeline
    python``, ``numpy`` and ``native`` (``card_probe --what pipeline``);
22. runs the loma DSL (``lomanerf_tpu_torch.dsl``) on the card: every
    program of the parity table (``tests/test_torch_dsl_programs.py``)
    compiled for ``cuda`` against ``cpu`` at the table's tolerances, one
    warm call of each timed; an ``@simd`` add and reduce at 65,536 threads
    through the ``torch.func.vmap`` route, and the reduce at 1,024 threads
    through both routes; ``diff_raytrace``'s image and gradient;
23. runs the driver surface (``lomanerf_tpu_torch.entry``): ``entry()``'s
    flagship loss and dW/db (the wide train kernel) against the plain
    version, ``dryrun_multichip(1)`` over NCCL and ``dryrun_multichip(4)``
    over gloo (dp = 2, tp = 2, four ranks on the card), then ``python -m
    lomanerf_tpu_torch.entry 2``;
24. holds the wide kernels at the shapes they took last (C4: hidden widths
    padded to 384, 512 and 1024, f32 and bf16, the bf16 render past pw 256
    on the layer chain; one-layer MLPs; A4: ``small()`` in bf16) against
    their plain versions on 1037 rays at shared and per-ray depths; times
    the 8x1024 bf16 step at 16,384 rays (TFLOP/s, share of the bf16 peak),
    each wide entry point there, and the step in turns with the plain
    version at 4096 rays; runs ``train_nerf --layers 8 --width 1024
    --samples 128 --steps 3``; splits the 8x1024 step's and render's device
    time by kernel family (``card_probe --config c4``: every forward layer
    and ``d_h`` on ``layer_wgmma_kernel``); holds the layer GEMM alone
    (``wide_gemm``, both forms) at one 8x1024 and one flagship gradient
    chunk's layer to its plain version, repeats bit for bit, and times it
    beside that, ``torch.addmm`` + ``relu_`` and its bound; times the
    8x1024 step at f32 compute (every product on the f32 GEMM) at 4096 rays
    in turns with the plain version, and holds the f32 GEMM alone
    (``f32_gemm``: forward, ``d_h``, dW) at one layer of the 4x256 field at
    512x512 and one f32 8x1024 gradient chunk's to its plain version,
    repeats bit for bit, timed beside it, the library call (``torch.addmm``
    + ``relu_``, ``torch.mm``) and its bound;
25. holds the wide field route (``field_wide.cu``, D2) against its plain
    version on both product routes ("high": 3xTF32, "highest": f32 FMAs):
    8x128 and a 3D field with a 16-channel head on 1037 points, the 4x256
    field over the whole 512x512 image; times each kernel on both tiers and
    the fit step there on both tiers against the plain version; fits 200
    ``fit_image`` steps of the 4x256 field at 512x512 on the kernels and
    the plain backend from one init (>= 8 dB above step 0, within 0.3 dB
    of plain);
26. holds the published NeRF (``NeRFConfig.paper()``, ``nerf_paper.cu``:
    skip connection, view branch, coarse and fine networks) against its
    plain version at NeRF's 4096 rays (the benchmark cell's batch) and on
    1037 rays: each pass's train call (loss, weights, every gradient;
    repeats bit-identical) and render call, the fine pass at the depths
    drawn from the coarse weights; times each entry's fine-pass call at
    4096 rays against the plain version's; ``NeRFModel.loss`` and
    ``render_image`` on its two entries only, then 30 Adam steps at 4096
    rays, the last 10 timed; its outputs' digests against ``PAPER_DIGESTS``.

Phases 2-3 (serving), 5 and 8 (training, the render backwards' steps), 11
(the image fit), 14 (the stratified runs), 15 (the wide route), 18 (the
scans' own timed runs at the 262,144 x 30 column: no train step or frame
launches ``seg_scans``), 19 (the sweep), 20 (each rank's data-parallel
steps and sharded frame), 21 (the three pipeline runs), 23 (``entry()``'s
loss and each dry-run rank's steps), 24 (the 8x1024 driver), 25 (the
4x256 fit) and 26 (the model's loss, ``render_image`` and the 30 steps)
are the main paths: each kernel's launch count is reset before its path
and read after it.
The last lines are the card's name and power limit, a JSON line of the
twenty kernels (the sixteen TPU kernels' counterparts, the wide field
route's two and the published NeRF's two entries, which replace no TPU
kernel, with the fine pass's times at 4096 rays and, for the train
entry, the step's beside them; with each one's least time on the card
for its work, ``bound_ms``; #1's ``ms`` is the kernel's own call, with the frames' times
and its share of the bound beside it, #4's with its share; #14's with
phase 10's whole-image leaves and flips per route; #3's also with phase
6's split of the step and phase 21's pipeline summary; #8's also with
phase 9's fused MLP alone, #10 new against old and the frame's split by
kernel family; #7-#9's also with phase 24's 8x1024 times and bounds, #7's
and #8's with the 8x1024 splits and the layer GEMM alone, #7's with the f32
8x1024 step, #7's and the wide field's with the f32 GEMM alone
(``gemm_f32_kernel``), the wide field's with their "highest" times;
#15's ``ms``, ``plain_ms`` and ``library_ms`` the cumprod's
card work with the L2 flushed, with its share and every op's times, as
found and flushed, beside them), and ``{"ok": true,
"device": ...}``.  It exits
non-zero, before printing any result, without a CUDA device or outside a
checkout of the repository; any failing phase raises.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "tests", "data", "convergence_64_step5000.npz")
# kernel vs plain version: both f32, sums taken in another order (MLP dot
# products, the colour sum over samples), encodings through different sin/cos
ATOL, RTOL = 1e-4, 1e-4
PSNR_TOL_DB = 0.05
N_CHECK = 1000 + 37  # not a multiple of the 128- or 64-ray block
SERVE_SIZE, SERVE_FRAMES = 800, 4
# gradient kernels vs autograd: the JAX test's bound for its fused train
# kernel against jax.grad (test_fused_train_loss_and_grads_match_jax_grad),
# rtol 3e-4 and atol 3e-5, with the atol scaled by the leaf's largest entry
# where that is above 1: these sums run over 1037 rays, not the JAX test's 20
GRAD_RTOL, GRAD_ATOL = 3e-4, 3e-5
BENCH_RAYS = 262144  # the bench's train batch (bench.py, small)
TRAIN_STEPS = 500
# the JAX run of the same driver and preset: 9.72 -> 19.31 -> 21.63 dB at
# steps 0, 250, 500 (artifacts/convergence_64/metrics.jsonl)
JAX_CURVE = os.path.join(ROOT, "artifacts", "convergence_64", "metrics.jsonl")
PSNR_FLOOR_DB, PSNR_GAIN_DB = 19.0, 8.0
KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "nerf_render_fwd": ("lomanerf_tpu_torch/ops/csrc/nerf_render_fwd.cu",
                        "lomanerf_tpu/ops/fused_nerf.py:1323"),
    "nerf_train": ("lomanerf_tpu_torch/ops/csrc/nerf_train.cu",
                   "lomanerf_tpu/ops/fused_nerf.py:1108"),
    "nerf_render_bwd": ("lomanerf_tpu_torch/ops/csrc/nerf_render_bwd.cu",
                        "lomanerf_tpu/ops/fused_nerf.py:1339"),
    "nerf_wide_train": ("lomanerf_tpu_torch/ops/csrc/nerf_wide_train.cu",
                        "lomanerf_tpu/ops/fused_nerf.py:1477"),
    "nerf_wide_render_fwd": ("lomanerf_tpu_torch/ops/csrc/nerf_wide_render_fwd.cu",
                             "lomanerf_tpu/ops/fused_nerf.py:1515"),
    "nerf_wide_render_bwd": ("lomanerf_tpu_torch/ops/csrc/nerf_wide_render_bwd.cu",
                             "lomanerf_tpu/ops/fused_nerf.py:1537"),
}
WIDE = ("nerf_wide_train", "nerf_wide_render_fwd", "nerf_wide_render_bwd")
FLAGSHIP_RAYS = 16384  # the flagship rung's train batch (bench.py:334)
# share of rows on which the fused MLP and the layer chain may store
# different H_{L-1} (tests/test_torch_cuda.py's NEAR_TIE_ROWS, and why)
NEAR_TIE_ROWS = 0.16
FLAGSHIP_STEPS = 300
# the JAX run of the flagship driver: 8.08 -> 21.74 -> 24.09 dB at steps 0,
# 100, 300 (artifacts/convergence_full/metrics.jsonl)
JAX_CURVE_FULL = os.path.join(ROOT, "artifacts", "convergence_full", "metrics.jsonl")
FLAGSHIP_PSNR_DB = 20.0
# full(): MACs per sample, forward 33*256 + 6*256^2 + 256*4; a train step
# adds d_h = d_z W^T (6*256^2 + 256*4) and dW = h^T d_z (the forward's)
FULL_MACS_FWD = 402688
FULL_MACS_TRAIN = 2 * FULL_MACS_FWD + 394240
FRAME_ROUNDS = 2  # 800x800 full frames: 1 warm-up, then 2 rounds in turns (4 each)
KERNELS.update({
    "field_fwd": ("lomanerf_tpu_torch/ops/csrc/field_fwd.cu",
                  "lomanerf_tpu/ops/fused_mlp.py:45"),
    "field_bwd": ("lomanerf_tpu_torch/ops/csrc/field_bwd.cu",
                  "lomanerf_tpu/ops/fused_mlp.py:51"),
})
# the card's published peaks (NVIDIA H100 SXM data sheet, dense, 700 W):
# f32 outside the tensor cores, bf16 on them, device memory
PEAK_F32, PEAK_BF16, PEAK_BYTES = 67e12, 989e12, 3.35e12
# TF32 on the tensor cores (dense): the field kernels take their products in
# three TF32 passes (3xTF32), so their least time is 3 x MACs at this rate
PEAK_TF32, TF32_PASSES = 495e12, 3
FIT_STEPS = 301
# the small field's eval PSNR at steps 0, 100, 200, 300 of the same flags:
# the JAX driver on the CPU (PRNGKey(215) init) and the port's --device cpu
# run (torch seed 215)
FIT_JAX_CURVE = (8.30, 17.01, 22.91, 26.21)
FIT_CPU_CURVE = (6.93, 18.43, 23.63, 27.09)
FIT_PSNR_DB, FIT_GAIN_DB = 22.0, 10.0
HIRES_STEPS, HIRES_GAIN_DB, HIRES_PLAIN_DB = 200, 8.0, 0.3
# field_bwd vs autograd at the whole 1024x1024 hires image, of the leaf's
# largest entry: a few ReLU-mask flips (phase 10) above the 1e-4 of phase 4
FIELD_IMAGE_GRAD = 5e-3
# the field's two product routes by the JAX package's tiers: "high" (and
# "default") 3xTF32 on the tensor cores, "highest" exact f32 FMAs
FIELD_TIERS = ("high", "highest")
# the per-ray (N, S) depth instances of the six NeRF kernels (phases 13-14)
_CSRC, _TPU = "lomanerf_tpu_torch/ops/csrc/", "lomanerf_tpu/ops/fused_nerf.py:"
KERNELS.update({
    "nerf_render_fwd_rays": (_CSRC + "nerf_render_fwd.cu", _TPU + "706"),
    "nerf_train_rays": (_CSRC + "nerf_train_rays.cu", _TPU + "474"),
    "nerf_render_bwd_rays": (_CSRC + "nerf_render_bwd_rays.cu", _TPU + "745"),
    "nerf_wide_render_fwd_rays": (_CSRC + "nerf_wide_render_fwd.cu", _TPU + "140"),
    "nerf_wide_train_rays": (_CSRC + "nerf_wide_train.cu", _TPU + "248"),
    "nerf_wide_render_bwd_rays": (_CSRC + "nerf_wide_render_bwd.cu", _TPU + "223"),
})
PERRAY = tuple(name for name in KERNELS if name.endswith("_rays"))
KERNELS.update({  # the last two TPU kernels: the seg-scan harness, the grid-overhead probe
    "seg_scans": (_CSRC + "seg_scans.cu", "tests/test_pallas_kernels.py:46"),
    "grid_sum": (_CSRC + "grid_sum.cu", "scripts/tpu_grid_overhead.py:36"),
})
KERNELS.update({  # fields past the tile kernels (D2): the wide route of #13 and #14
    "field_wide_fwd": (_CSRC + "field_wide.cu", "lomanerf_tpu/ops/fused_mlp.py:45"),
    "field_wide_bwd": (_CSRC + "field_wide.cu", "lomanerf_tpu/ops/fused_mlp.py:51"),
})
KERNELS.update({  # the published NeRF's two entries: the JAX package has no such model
    "nerf_paper_train": (_CSRC + "nerf_paper.cu", None),
    "nerf_paper_render": (_CSRC + "nerf_paper.cu", None),
})
SINGLE64_RAYS = 65536  # the bench's single64 rung (bench.py:334)
STRAT_STEPS, STRAT_FULL_STEPS = 500, 30


def seeded_params(rng, cfg):
    """He-scaled numpy params of ``cfg``'s MLP, as CUDA tensors; with
    ``cfg.init == "nerf"`` the biases are zero and the head is scaled by 0.1
    with a +0.5 density bias, as ``init_mlp(init="nerf")`` draws them."""
    sizes = [cfg.in_channels] + [cfg.filter_size] * (cfg.num_layers - 1) \
        + [cfg.out_channels]
    params = {"w": [], "b": []}
    for fi, fo in zip(sizes[:-1], sizes[1:]):
        params["w"].append(torch.tensor(
            rng.standard_normal((fi, fo)) * np.sqrt(2.0 / fi),
            dtype=torch.float32, device="cuda"))
        params["b"].append(torch.tensor(
            rng.standard_normal(fo) * 0.5, dtype=torch.float32, device="cuda"))
    if cfg.init == "nerf":
        params["b"] = [torch.zeros_like(b) for b in params["b"]]
        params["w"][-1] *= 0.1
        params["b"][-1][3] = 0.5
    return params


def seeded_rays(rng, n):
    """``(origins, directions)`` of ``n`` standard-normal rays on the card."""
    return tuple(torch.tensor(rng.standard_normal((n, 3)), dtype=torch.float32,
                              device="cuda") for _ in range(2))


def uniform_depths(cfg):
    from lomanerf_tpu_torch.core import rays

    return rays.uniform_depths(cfg.near, cfg.far, cfg.num_samples, "cuda")


def phase_kernel_vs_plain(fused_nerf, NeRFConfig, seed=0):
    """Phase 1: numpy-seeded params and rays through the kernel and the plain
    version on the card, on 1037 rays (a ragged block) and on one."""
    rng = np.random.default_rng(seed)
    worst = 0.0
    for name in ("small", "single64"):
        for mode in ("loma", "standard"):
            for n in (N_CHECK, 1):
                cfg = dataclasses.replace(NeRFConfig.preset(name), mode=mode)
                params = seeded_params(rng, cfg)
                o, d = seeded_rays(rng, n)
                t, dists = uniform_depths(cfg)
                got = fused_nerf.render_rays(params, o, d, t, dists, cfg)
                want = fused_nerf.render_rays_reference(params, o, d, t, dists, cfg)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                worst = max(worst, err)
                print(f"phase 1 {name:8s} {mode:8s} N={n}: max|kernel-plain| = {err:.3e}")
                torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)
    return worst


def phase_trained_field(fx, model, normalized_intrinsics, psnr):
    """Phase 2: the trained 3x30 field at 64x64 against the JAX renders."""
    size = fx["jax_renders"].shape[1]
    K = normalized_intrinsics(float(fx["focal"]), device="cuda")
    worst = 0.0
    with torch.no_grad():
        for i, pose in enumerate(fx["poses"]):
            img = model.render_image(K, pose, size)
            want = torch.from_numpy(fx["jax_renders"][i]).cuda()
            err = (img - want).abs().max().item()
            worst = max(worst, err)
            torch.testing.assert_close(img, want, atol=ATOL, rtol=0.0)
        Ke = normalized_intrinsics(float(fx["eval_focal"]), device="cuda")
        img = model.render_image(Ke, fx["eval_pose"], size)
    target = torch.from_numpy(fx["eval_target"]).cuda()
    got_psnr = psnr(target, img).item()
    jax_psnr = float(fx["eval_jax_psnr"])
    print(f"phase 2 trained 3x30 field, {len(fx['poses'])} poses at {size}x{size}: "
          f"max|torch-jax| = {worst:.3e} (atol {ATOL}); eval-view PSNR "
          f"{got_psnr:.4f} dB (JAX {jax_psnr:.4f} dB)")
    if not np.isfinite(got_psnr) or abs(got_psnr - jax_psnr) > PSNR_TOL_DB:
        raise AssertionError(f"PSNR {got_psnr} vs JAX {jax_psnr}: off by more "
                             f"than {PSNR_TOL_DB} dB")
    return worst


def leaves_of(params):
    return [p.requires_grad_(True) for p in [*params["w"], *params["b"]]]


def cast_params(params, leaves, dt):
    """``(params, leaves)`` in ``dt``: the f32 originals, or detached copies."""
    if dt == torch.float32:
        return params, leaves
    prm = {k: [x.detach().to(dt) for x in v] for k, v in params.items()}
    return prm, leaves_of(prm)


def grads_close(got, want, what, rtol, atol_of):
    """Max |got - want| over the leaves, after asserting each leaf within
    rtol and ``atol_of(want_leaf)``."""
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        worst = max(worst, (g - w).abs().max().item())
        torch.testing.assert_close(g, w, rtol=rtol, atol=atol_of(w),
                                   msg=lambda m, i=i: f"{what}, leaf {i}: {m}")
    return worst


def grad_atol(want):
    return GRAD_ATOL * max(1.0, want.abs().max().item())


def phase_grad_kernels(fused_nerf, NeRFConfig, seed=2):
    """Phase 4: the train kernel (#3) and the render backward (#2) against
    their plain versions (PyTorch autograd on the card), at the small and
    single64 shapes in both modes on 1037 rays; two calls on the same inputs
    must agree bit for bit.  Returns the worst |kernel - plain| per kernel."""
    rng = np.random.default_rng(seed)
    worst = {"nerf_train": 0.0, "nerf_render_bwd": 0.0}
    for name in ("small", "single64"):
        for mode in ("loma", "standard"):
            cfg = dataclasses.replace(NeRFConfig.preset(name), mode=mode)
            params = seeded_params(rng, cfg)
            leaves = leaves_of(params)
            o, d = seeded_rays(rng, N_CHECK)
            t, dists = uniform_depths(cfg)
            tgt = torch.tensor(rng.random((N_CHECK, 3)), dtype=torch.float32, device="cuda")
            cot = torch.tensor(rng.standard_normal((N_CHECK, 3)), dtype=torch.float32,
                               device="cuda")

            def train(loss_fn):
                loss = loss_fn(params, o, d, t, dists, tgt, cfg)
                return (loss.detach(), *torch.autograd.grad(loss, leaves))

            def render_bwd(render_fn):
                out = render_fn(params, o, d, t, dists, cfg)
                return torch.autograd.grad((out * cot).sum(), leaves)

            k1, k2 = train(fused_nerf.nerf_train_loss), train(fused_nerf.nerf_train_loss)
            p = train(fused_nerf.nerf_train_loss_reference)
            b1, b2 = render_bwd(fused_nerf.render_rays), render_bwd(fused_nerf.render_rays)
            q = render_bwd(fused_nerf.render_rays_reference)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(k1 + b1, k2 + b2)):
                raise AssertionError(f"{name} {mode}: repeat launches differ")
            loss_err = abs(k1[0].item() - p[0].item())
            torch.testing.assert_close(k1[0], p[0], rtol=1e-5, atol=0.0)
            e3 = grads_close(k1[1:], p[1:], f"nerf_train {name} {mode}", GRAD_RTOL,
                             grad_atol)
            e2 = grads_close(b1, q, f"nerf_render_bwd {name} {mode}", GRAD_RTOL,
                             grad_atol)
            worst["nerf_train"] = max(worst["nerf_train"], e3, loss_err)
            worst["nerf_render_bwd"] = max(worst["nerf_render_bwd"], e2)
            print(f"phase 4 {name:8s} {mode:8s} N={N_CHECK}: loss {k1[0].item():.6e} "
                  f"(|kernel-plain| {loss_err:.3e}); max|dW,db kernel-plain| train "
                  f"{e3:.3e}, render bwd {e2:.3e}; repeat launches bit-identical")
    return worst


def bench_batch(rng, cfg, n):
    """A train batch as bench.py makes it: standard-normal origins and
    directions, the (S,) uniform depths, uniform [0, 1) targets."""
    o, d = seeded_rays(rng, n)
    t, dists = uniform_depths(cfg)
    tgt = torch.tensor(rng.random((n, 3)), dtype=torch.float32, device="cuda")
    return o, d, t, dists, tgt


def phase_bench_batch_grads(fused_nerf, NeRFConfig):
    """Phase 4, last check: fused against plain loss and gradients at the
    bench batch (262,144 rays x 30 samples, small).  Both sum 7.9 M f32
    terms, in other orders: loss rtol 1e-4; each leaf rtol 1e-3 with atol
    1e-4 of the leaf's largest plain entry."""
    cfg = NeRFConfig.small()
    params = seeded_params(np.random.default_rng(0), cfg)
    leaves = leaves_of(params)
    batch = bench_batch(np.random.default_rng(0), cfg, BENCH_RAYS)
    out = []
    for fn in (fused_nerf.nerf_train_loss, fused_nerf.nerf_train_loss_reference):
        loss = fn(params, *batch, cfg)
        out.append((loss.detach(), *torch.autograd.grad(loss, leaves)))
    (k, p) = out
    torch.testing.assert_close(k[0], p[0], rtol=1e-4, atol=0.0)
    rel = max(((a - b).abs().max() / b.abs().max()).item() for a, b in zip(k[1:], p[1:]))
    worst = grads_close(k[1:], p[1:], "nerf_train at the bench batch", 1e-3,
                        lambda w: 1e-4 * w.abs().max().item())
    print(f"phase 4 bench batch ({BENCH_RAYS} rays): loss kernel {k[0].item():.6e} plain "
          f"{p[0].item():.6e}; max|dW,db kernel-plain| {worst:.3e} "
          f"({rel:.3e} of the leaf's largest entry)")


def phase_train_driver(train_nerf, fused_nerf, CheckpointManager, NeRFModel,
                       NeRFConfig, synthetic_views, normalized_intrinsics, psnr, tmp):
    """Phase 5: the train slice through its entry point,
    ``train_nerf.main``, on the card: the small preset on the 16-view 64x64
    synthetic scene (in memory), 500 Adam steps of 4096 rays; then 10 more
    steps with ``--resume``.  Returns the train kernel's launches in the
    500-step run."""
    flags = ["--device", "cuda", "--data", "synthetic", "--preset", "small",
             "--img-size", "64", "--rays-per-batch", "4096", "--eval-every", "250",
             "--optimizer", "adam", "--lr", "5e-4", "--log-dir", os.path.join(tmp, "logs"),
             "--ckpt-dir", os.path.join(tmp, "ck"), "--ckpt-every", "0"]
    reset_launches(fused_nerf)
    t0 = time.perf_counter()
    out = train_nerf.main([*flags, "--steps", str(TRAIN_STEPS)])
    train_s = time.perf_counter() - t0
    counts = dict(fused_nerf.launches)
    if counts["nerf_train"] != TRAIN_STEPS:
        raise AssertionError(f"train kernel launched {counts['nerf_train']} times in "
                             f"{TRAIN_STEPS} steps")
    if counts["nerf_render_fwd"] < 1:
        raise AssertionError("the evals made no render kernel launch")
    if not np.all(np.isfinite(out["losses"])) or len(out["losses"]) != TRAIN_STEPS:
        raise AssertionError("the run stopped or its loss is not finite")
    # PSNR after the 500th step: the eval view rendered from the checkpoint
    # the run wrote at its end (a round trip through CheckpointManager)
    images, poses, focal = synthetic_views(16, 64, device="cuda")
    model = NeRFModel(NeRFConfig.small(), device="cuda")
    step = CheckpointManager(os.path.join(tmp, "ck")).restore(model)
    with torch.no_grad():
        img = model.render_image(normalized_intrinsics(focal, device="cuda"), poses[2], 64)
    curve = dict(out["psnr"])
    curve[step] = psnr(images[2], img).item()
    with open(JAX_CURVE) as f:
        jax_curve = {r["step"]: r["psnr"] for r in map(json.loads, f) if r["step"] <= step}
    with open(os.path.join(tmp, "logs", "metrics.jsonl")) as f:
        stamps = {r["step"]: r["time"] for r in map(json.loads, f)}
    between = sorted(stamps)[:2]  # the evals at steps 0 and 250
    step_ms = (stamps[between[1]] - stamps[between[0]]) / (between[1] - between[0]) * 1e3
    print(f"phase 5 train_nerf --preset small: {TRAIN_STEPS} steps x 4096 rays in "
          f"{train_s:.2f} s host time (evals, checkpoint and data set-up included; "
          f"{step_ms:.3f} ms/step between the evals at steps {between[0]} and "
          f"{between[1]}); launches {counts}; final loss {out['losses'][-1]:.4f}")
    print("  eval PSNR dB, port (this run) | JAX (artifacts/convergence_64, another "
          "init): " + ", ".join(f"step {k}: {curve[k]:.2f} | {jax_curve.get(k, float('nan')):.2f}"
                                for k in sorted(curve)))
    if step != TRAIN_STEPS or curve[step] < PSNR_FLOOR_DB or curve[step] < curve[0] + PSNR_GAIN_DB:
        raise AssertionError(f"PSNR {curve} after {step} steps: need >= {PSNR_FLOOR_DB} dB "
                             f"and {PSNR_GAIN_DB} dB above step 0")
    reset_launches(fused_nerf)
    more = train_nerf.main([*flags, "--steps", str(TRAIN_STEPS + 10), "--resume"])
    if fused_nerf.launches["nerf_train"] != 10 or len(more["losses"]) != 10 \
            or not np.all(np.isfinite(more["losses"])):
        raise AssertionError(f"--resume took {len(more['losses'])} steps, "
                             f"{fused_nerf.launches['nerf_train']} train launches")
    print(f"phase 5 --resume: 10 more steps from step {step}, loss "
          f"{more['losses'][-1]:.4f}")
    return counts["nerf_train"]


def phase_render_loss_steps(fused_nerf, NeRFConfig, NeRFModel, synthetic_views,
                            normalized_intrinsics, rays):
    """Phase 5, the render-backward path: 10 Adam steps on
    ``NeRFModel.loss`` (render, sum-MSE, backward through the render) over
    the eval view's 4096 rays.  Returns the render backward's launches."""
    images, poses, focal = synthetic_views(16, 64, device="cuda")
    cfg = NeRFConfig.small()
    model = NeRFModel(cfg, device="cuda")
    model.init(torch.Generator().manual_seed(0))
    opt = torch.optim.Adam(model.parameters(), lr=5e-4)
    o, d = rays.get_rays(64, 64, normalized_intrinsics(focal, device="cuda"), poses[2])
    t, dists = rays.uniform_depths(cfg.near, cfg.far, cfg.num_samples, "cuda")
    tgt = images[2].reshape(-1, 3)
    losses = []
    reset_launches(fused_nerf)
    for _ in range(10):
        opt.zero_grad(set_to_none=True)
        loss = model.loss(o, d, t, dists, tgt)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    n = fused_nerf.launches["nerf_render_bwd"]
    if n != 10 or not np.all(np.isfinite(losses)) or losses[-1] >= losses[0]:
        raise AssertionError(f"render-loss steps: {n} backward launches, losses {losses}")
    print(f"phase 5 NeRFModel.loss: 10 steps, loss {losses[0]:.3f} -> {losses[-1]:.3f}; "
          f"launches {dict(fused_nerf.launches)}")
    return n


def phase_bench_step(fused_nerf, NeRFConfig, NeRFModel, make_single_chip_train_step, smi):
    """Phase 6: the train step at the bench's shape (small, 262,144 rays,
    Adam 5e-4, bench.py's numpy-seeded batches, two cycled): 3 warm-up
    steps, then 20 steps each through the kernel and the plain backend, in
    turns, by CUDA events; then each gradient kernel's own call against its
    plain version (10 calls each).  Returns ``{kernel: (ms, plain_ms)}``."""
    cfg = NeRFConfig.small()
    rng = np.random.default_rng(0)
    batches = [bench_batch(rng, cfg, BENCH_RAYS) for _ in range(2)]
    steps = {}
    for backend in ("auto", "plain"):
        model = NeRFModel(cfg, device="cuda")
        model.init(torch.Generator().manual_seed(0))
        opt = torch.optim.Adam(model.parameters(), lr=5e-4)
        steps[backend] = (model, make_single_chip_train_step(cfg, opt, backend))
    times = {"auto": [], "plain": []}
    losses = {"auto": [], "plain": []}

    def run(backend, i, record=True):
        model, step = steps[backend]
        ms, loss = cuda_ms(lambda: step(model, *batches[i % 2]))
        losses[backend].append(loss.item())
        if record:
            times[backend].append(ms)

    for i in range(3):
        run("auto", i, False)
        run("plain", i, False)
    for i in range(10):  # plain, kernel, kernel, plain
        for backend in ("plain", "auto", "auto", "plain"):
            run(backend, i)
    if not all(np.all(np.isfinite(v)) for v in losses.values()):
        raise AssertionError(f"non-finite loss at the bench shape: {losses}")
    rel = abs(losses["auto"][0] - losses["plain"][0]) / losses["plain"][0]
    print(f"phase 6 train step, small, {BENCH_RAYS} rays x {cfg.num_samples} samples, "
          f"Adam 5e-4, on {smi} (first-step loss kernel {losses['auto'][0]:.6e} plain "
          f"{losses['plain'][0]:.6e}, rel diff {rel:.2e}):")
    for backend, name in (("auto", "kernel"), ("plain", "plain ")):
        ts = times[backend]
        med = statistics.median(ts)
        print(f"  {name}: median {med:.3f} ms/step (min {min(ts):.3f}, max {max(ts):.3f}, "
              f"n={len(ts)}), {BENCH_RAYS / med * 1e3:.4e} rays/s")

    # each gradient kernel's own call (kernel + fixed-order block sum) at the
    # bench batch, against the plain version of the same work
    params = seeded_params(np.random.default_rng(0), cfg)
    o, d, t, dists, tgt = batches[0]
    pk = fused_nerf.pack_params(params, t, dists, 32)
    G = fused_nerf.grad_floats(params, 32)
    cot = torch.tensor(np.random.default_rng(1).standard_normal((BENCH_RAYS, 3)),
                       dtype=torch.float32, device="cuda")
    lv = leaves_of(params)
    plain_out = fused_nerf.render_rays_reference(params, o, d, t, dists, cfg)
    calls = {
        "nerf_train": (
            lambda: fused_nerf._launch_grad("nerf_train", pk, G, t, dists, o, d, tgt, cfg,
                                            3, 32),
            lambda: torch.autograd.grad(fused_nerf.nerf_train_loss_reference(
                params, o, d, t, dists, tgt, cfg), lv)),
        "nerf_render_bwd": (
            lambda: fused_nerf._launch_grad("nerf_render_bwd", pk, G, t, dists, o, d, cot,
                                            cfg, 3, 32),
            lambda: torch.autograd.grad(plain_out, lv, cot, retain_graph=True)),
    }
    out = {}
    for name, (kernel, plain) in calls.items():
        kernel(), plain()  # warm-up
        k = [cuda_ms(kernel)[0] for _ in range(10)]
        pl = [cuda_ms(plain)[0] for _ in range(10)]
        out[name] = (statistics.median(k), statistics.median(pl))
        what = ("loss + dW/db" if name == "nerf_train"
                else "dW/db from a colour cotangent (plain: the backward pass only)")
        print(f"  {name} alone, {what}: median {out[name][0]:.3f} ms (min {min(k):.3f}, "
              f"max {max(k):.3f}) vs plain {out[name][1]:.3f} ms (min {min(pl):.3f}, "
              f"max {max(pl):.3f}), n=10")
    return out


def phase_small_split():
    """Phase 6, the ``small`` step's device time by kernel family (5 traced
    steps, ``card_probe --what small``, a process of its own): the narrow
    walk (``nerf_grad_kernel``) and the sum of its block partials must run
    once a step.  Returns the split."""
    split = card_probe("small", "--steps", "5")
    per = split["launches_per_step"]
    if per.get("nerf_grad_kernel") != 1.0 or per.get("sum_block_partials") != 1.0:
        raise AssertionError(f"small step: kernels per step {per}, need one nerf_grad_kernel "
                             "and one sum_block_partials")
    print("phase 6 small step split (utils.profiling.trace, 5 steps): device "
          f"{split['device_ms_per_step']:.3f} ms/step; " + ", ".join(
              f"{k} {v:.3f} ms ({split['share'][k]:.1%})" for k, v in split["ms"].items()))
    return {"device_ms_per_step": split["device_ms_per_step"], "ms": split["ms"]}


def wide_tolerances(cfg):
    """(colour atol, loss rtol, grad bound of the leaf's largest entry) of a
    wide kernel against its plain version.  f32: the narrow kernels' bounds.
    bf16: both sides round the same values at the same places, but a sum in
    another order (here the tensor cores' 64-deep stages) can move a value
    across a bf16 rounding boundary and the flip propagates;
    tests/test_torch_wide.py measured such flips between the plain version
    and the JAX kernels up to 5.5e-4 on colours, 1.75e-5 on the loss and
    1.1e-2 of a leaf's largest gradient entry at 20 rays.  The first card
    runs of full() at 1037 rays gave 5.9e-5, 5.9e-7 and 1.5e-3."""
    if cfg.compute_dtype == "bfloat16":
        return 2e-3, 1e-4, 1e-2
    return ATOL, 1e-5, None


def wide_grads_close(got, want, what, cfg):
    _, _, rel = wide_tolerances(cfg)
    if rel is None:
        return grads_close(got, want, what, GRAD_RTOL, grad_atol)
    return grads_close(got, want, what, 0.0, lambda w: rel * w.abs().max().item())


def phase_wide_kernels(fused_nerf, NeRFConfig, seed=7):
    """Phase 7: the wide kernels (#7-#9) against their plain versions on the
    card: ``full()`` exactly (8x256, S=128, bf16, standard) and an f32
    4x128/S=32 MLP in both modes, on 1037 rays; the render forward, the train
    loss and dW/db and the render backward against autograd of the plain
    version; repeat launches bit-identical; then the train kernel against
    the plain version at the flagship's bench batch (16,384 rays).  Returns
    the worst |kernel - plain| per entry point."""
    rng = np.random.default_rng(seed)
    worst = dict.fromkeys(WIDE, 0.0)
    f32 = NeRFConfig(num_layers=4, filter_size=128, num_samples=32)
    for cfg in (NeRFConfig.full(), dataclasses.replace(f32, mode="loma"),
                dataclasses.replace(f32, mode="standard")):
        params = seeded_params(rng, cfg)
        leaves = leaves_of(params)
        o, d, t, dists, tgt = bench_batch(rng, cfg, N_CHECK)
        cot = torch.tensor(rng.standard_normal((N_CHECK, 3)), dtype=torch.float32,
                           device="cuda")
        col_atol, loss_rtol, _ = wide_tolerances(cfg)
        what = f"{cfg.num_layers}x{cfg.filter_size} S={cfg.num_samples} " \
               f"{cfg.compute_dtype} {cfg.mode}"

        def train(loss_fn):
            loss = loss_fn(params, o, d, t, dists, tgt, cfg)
            return (loss.detach(), *torch.autograd.grad(loss, leaves))

        def render_bwd(render_fn):
            out = render_fn(params, o, d, t, dists, cfg)
            return torch.autograd.grad((out * cot).sum(), leaves)

        with torch.no_grad():
            c1 = fused_nerf.render_rays(params, o, d, t, dists, cfg)
            c2 = fused_nerf.render_rays(params, o, d, t, dists, cfg)
            cp = fused_nerf.render_rays_reference(params, o, d, t, dists, cfg)
        k1, k2 = train(fused_nerf.nerf_train_loss), train(fused_nerf.nerf_train_loss)
        p = train(fused_nerf.nerf_train_loss_reference)
        b1, b2 = render_bwd(fused_nerf.render_rays), render_bwd(fused_nerf.render_rays)
        q = render_bwd(fused_nerf.render_rays_reference)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip((c1, *k1, *b1), (c2, *k2, *b2))):
            raise AssertionError(f"{what}: repeat launches differ")
        e_fwd = (c1 - cp).abs().max().item()
        torch.testing.assert_close(c1, cp, atol=col_atol, rtol=RTOL)
        loss_err = abs(k1[0].item() - p[0].item())
        torch.testing.assert_close(k1[0], p[0], rtol=loss_rtol, atol=0.0)
        e_tr = wide_grads_close(k1[1:], p[1:], f"nerf_wide_train {what}", cfg)
        e_bw = wide_grads_close(b1, q, f"nerf_wide_render_bwd {what}", cfg)
        worst["nerf_wide_render_fwd"] = max(worst["nerf_wide_render_fwd"], e_fwd)
        worst["nerf_wide_train"] = max(worst["nerf_wide_train"], e_tr, loss_err)
        worst["nerf_wide_render_bwd"] = max(worst["nerf_wide_render_bwd"], e_bw)
        print(f"phase 7 {what} N={N_CHECK}: max|kernel-plain| render {e_fwd:.3e}; loss "
              f"{k1[0].item():.6e} (|kernel-plain| {loss_err:.3e}); dW,db train "
              f"{e_tr:.3e}, render bwd {e_bw:.3e}; repeat launches bit-identical")
        if cfg.compute_dtype == "bfloat16":
            print(f"  per leaf (dW_0.., db_0..), |kernel-plain| / max|plain|: train "
                  f"{leaf_errors(k1[1:], p[1:])}; render bwd {leaf_errors(b1, q)}")

    cfg = NeRFConfig.full()
    params = seeded_params(np.random.default_rng(0), cfg)
    leaves = leaves_of(params)
    batch = bench_batch(np.random.default_rng(0), cfg, FLAGSHIP_RAYS)
    out = []
    for fn in (fused_nerf.nerf_train_loss, fused_nerf.nerf_train_loss_reference):
        loss = fn(params, *batch, cfg)
        out.append((loss.detach(), *torch.autograd.grad(loss, leaves)))
    (k, p) = out
    _, loss_rtol, rel = wide_tolerances(cfg)
    torch.testing.assert_close(k[0], p[0], rtol=loss_rtol, atol=0.0)
    e = max(((a - b).abs().max() / b.abs().max()).item() for a, b in zip(k[1:], p[1:]))
    wide_grads_close(k[1:], p[1:], "nerf_wide_train at the flagship bench batch", cfg)
    print(f"phase 7 flagship bench batch ({FLAGSHIP_RAYS} rays): loss kernel "
          f"{k[0].item():.6e} plain {p[0].item():.6e}; max|dW,db kernel-plain| "
          f"{e:.3e} of the leaf's largest entry (bound {rel}); per leaf "
          f"{leaf_errors(k[1:], p[1:])}")
    return worst


def leaf_errors(got, want):
    """Each leaf's worst |got - want| over its largest |want|, as text."""
    return " ".join(f"{((a - b).abs().max() / b.abs().max()).item():.2e}"
                    for a, b in zip(got, want))


def phase_flagship_driver(train_nerf, fused_nerf, CheckpointManager, NeRFModel,
                          NeRFConfig, synthetic_views, normalized_intrinsics, psnr,
                          render_orbit, rays, tmp):
    """Phase 8: the flagship's main paths.  ``train_nerf.main --preset full``
    (300 Adam steps of 4096 rays on the 16-view 64x64 synthetic scene, evals
    every 50 steps through the wide render); the eval PSNR after the last
    step from the checkpoint the run wrote; ``render_orbit`` of the trained
    model (4 frames at 128x128); 10 Adam steps on ``NeRFModel.loss`` (the
    wide render backward).  Returns each wide kernel's launches on these
    paths."""
    flags = ["--device", "cuda", "--data", "synthetic", "--preset", "full",
             "--img-size", "64", "--rays-per-batch", "4096", "--eval-every", "50",
             "--optimizer", "adam", "--lr", "5e-4", "--log-dir", os.path.join(tmp, "logs_full"),
             "--ckpt-dir", os.path.join(tmp, "ck_full"), "--ckpt-every", "0",
             "--steps", str(FLAGSHIP_STEPS)]
    reset_launches(fused_nerf)
    t0 = time.perf_counter()
    out = train_nerf.main(flags)
    train_s = time.perf_counter() - t0
    counts = dict(fused_nerf.launches)
    if counts["nerf_wide_train"] != FLAGSHIP_STEPS:
        raise AssertionError(f"wide train kernel launched {counts['nerf_wide_train']} "
                             f"times in {FLAGSHIP_STEPS} steps")
    if counts["nerf_wide_render_fwd"] < 1:
        raise AssertionError("the evals made no wide render kernel launch")
    if not np.all(np.isfinite(out["losses"])) or len(out["losses"]) != FLAGSHIP_STEPS:
        raise AssertionError("the run stopped or its loss is not finite")
    images, poses, focal = synthetic_views(16, 64, device="cuda")
    K = normalized_intrinsics(focal, device="cuda")
    model = NeRFModel(NeRFConfig.full(), device="cuda")
    step = CheckpointManager(os.path.join(tmp, "ck_full")).restore(model)
    with torch.no_grad():
        img = model.render_image(K, poses[2], 64)
    curve = dict(out["psnr"])
    curve[step] = psnr(images[2], img).item()
    with open(JAX_CURVE_FULL) as f:
        jax_curve = {r["step"]: r["psnr"] for r in map(json.loads, f) if r["step"] <= step}
    with open(os.path.join(tmp, "logs_full", "metrics.jsonl")) as f:
        stamps = {r["step"]: r["time"] for r in map(json.loads, f)}
    a, b = sorted(stamps)[1:3]  # the evals at steps 50 and 100
    step_ms = (stamps[b] - stamps[a]) / (b - a) * 1e3
    print(f"phase 8 train_nerf --preset full: {FLAGSHIP_STEPS} steps x 4096 rays in "
          f"{train_s:.2f} s host time (evals, checkpoint and set-up included; "
          f"{step_ms:.3f} ms/step between the evals at steps {a} and {b}); launches "
          f"{counts}; final loss {out['losses'][-1]:.4f}")
    print("  eval PSNR dB, port (this run) | JAX (artifacts/convergence_full, another "
          "init): " + ", ".join(f"step {k}: {curve[k]:.2f} | "
                                f"{jax_curve.get(k, float('nan')):.2f}" for k in sorted(curve)))
    if step != FLAGSHIP_STEPS or curve[step] < FLAGSHIP_PSNR_DB \
            or curve[step] < curve[0] + PSNR_GAIN_DB:
        raise AssertionError(f"PSNR {curve} after {step} steps: need >= {FLAGSHIP_PSNR_DB} "
                             f"dB and {PSNR_GAIN_DB} dB above step 0")
    launches = {"nerf_wide_train": counts["nerf_wide_train"]}

    before = fused_nerf.launches["nerf_wide_render_fwd"]
    t0 = time.perf_counter()
    frames = render_orbit(model, focal, 4.0, 4, 128)
    orbit_s = time.perf_counter() - t0
    launches["nerf_wide_render_fwd"] = fused_nerf.launches["nerf_wide_render_fwd"]
    if launches["nerf_wide_render_fwd"] <= before:
        raise AssertionError("render_orbit made no wide render kernel launch")
    if frames.shape != (4, 128, 128, 3) or frames.dtype != np.uint8 or frames.std() < 1.0:
        raise AssertionError(f"orbit frames {frames.shape} {frames.dtype} blank or malformed")
    print(f"phase 8 render_orbit of the trained flagship: 4 frames at 128x128 in "
          f"{orbit_s:.2f} s host time; wide render launches on the train and serve "
          f"paths: {launches['nerf_wide_render_fwd']}")

    opt = torch.optim.Adam(model.parameters(), lr=5e-4)
    cfg = model.config
    o, d = rays.get_rays(64, 64, K, poses[5])
    t, dists = rays.uniform_depths(cfg.near, cfg.far, cfg.num_samples, "cuda")
    tgt = images[5].reshape(-1, 3)
    losses = []
    reset_launches(fused_nerf)
    for _ in range(10):
        opt.zero_grad(set_to_none=True)
        loss = model.loss(o, d, t, dists, tgt)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    launches["nerf_wide_render_bwd"] = fused_nerf.launches["nerf_wide_render_bwd"]
    if launches["nerf_wide_render_bwd"] != 10 or not np.all(np.isfinite(losses)) \
            or losses[-1] >= losses[0]:
        raise AssertionError(f"flagship render-loss steps: "
                             f"{launches['nerf_wide_render_bwd']} backward launches, "
                             f"losses {losses}")
    print(f"phase 8 NeRFModel.loss (full): 10 steps on view 5, loss {losses[0]:.3f} -> "
          f"{losses[-1]:.3f}; launches {dict(fused_nerf.launches)}")
    return launches


def timed_turns(fns, rounds):
    """``{name: [ms...]}`` of CUDA-event timings over the named callables in
    turns: each round runs them in order, then in reverse (a, b, b, a)."""
    times = {name: [] for name in fns}
    order = list(fns.items())
    for _ in range(rounds):
        for name, fn in order + order[::-1]:
            times[name].append(cuda_ms(fn)[0])
    return times


def spread(ts):
    return f"median {statistics.median(ts):.3f} ms (min {min(ts):.3f}, max " \
           f"{max(ts):.3f}, n={len(ts)})"


def bound(macs, peak, nbytes):
    """(ms, "operations" or "bytes"): the least time the card could take for
    ``macs`` multiply-adds at ``peak`` FLOP/s and ``nbytes`` of device
    memory traffic (each input read once, each output written once)."""
    ops_ms, bytes_ms = 2.0 * macs / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def mlp_macs(sizes):
    """(forward, backward) multiply-adds of one MLP row with layer
    ``sizes``: the backward is the forward again (its activations), dW (the
    forward's count) and d_h of every layer but the first."""
    fwd = sum(fi * fo for fi, fo in sizes)
    return fwd, 2 * fwd + sum(fi * fo for fi, fo in sizes[1:])


def frame_ties(fused_nerf, wide_mlp, cfg, model, rays, K, pose, img_k, img_m):
    """The fused MLP's frame ``img_k`` against the layer chain's ``img_m``:
    ``wide_mlp.tied_rows`` over the frame's rays in chunks of
    ``FLAGSHIP_RAYS``: every value where the two part is a near tie, at most
    ``NEAR_TIE_ROWS`` of the rows tied, H_{L-1} equal off them and the
    pixels of the rays without a tied row bit-identical.  Returns (the
    share of rows tied, the pixels with one)."""
    o, d = rays.get_rays(SERVE_SIZE, SERVE_SIZE, K, pose)
    tv, dists = rays.uniform_depths(cfg.near, cfg.far, cfg.num_samples, "cuda")
    W, b = fused_nerf.pack_wide_params(model.params, 256, cfg.compute_dtype)
    far, tied = 0, []
    for oc, dc in zip(o.split(FLAGSHIP_RAYS), d.split(FLAGSHIP_RAYS)):
        t_c, far_c, hf, hc = wide_mlp.tied_rows(W, b, tv, dists, oc, dc, cfg)
        if not torch.equal(hf[~t_c], hc[~t_c]):
            raise AssertionError("frame: H_{L-1} of the fused MLP and the layer chain differ "
                                 "on a row without a near tie")
        far += far_c
        tied.append(t_c)
        del hf, hc
    tied = torch.cat(tied)
    share = tied.float().mean().item()
    clear = ~tied.view(-1, cfg.num_samples).any(1).view(SERVE_SIZE, SERVE_SIZE)
    if far or share > NEAR_TIE_ROWS or not torch.equal(img_k[clear], img_m[clear]):
        raise AssertionError(f"frame against the layer chain: {far} values apart past a near "
                             f"tie, {share:.2%} of the rows tied, untied pixels apart: "
                             f"{int((img_k[clear] != img_m[clear]).sum())}")
    return share, int((~clear).sum())


def phase_flagship_timing(fused_nerf, wide_mlp, NeRFConfig, NeRFModel,
                          make_single_chip_train_step, normalized_intrinsics, rays,
                          smi):
    """Phase 9: timing by CUDA events, median with min/max, kernel and plain
    in turns.  The flagship train step (``full``, 16,384 rays, Adam 5e-4,
    bench.py's numpy-seeded batches); one 800x800 ``full`` frame through the
    fused MLP (the main path), through the layer chain it replaced
    (``wide_mlp.render_rays_layers``: the same frame off near ties,
    :func:`frame_ties`) and through the plain version, each chunked as the
    kernel path is; each wide entry
    point's own call against its plain version.  Returns ``{kernel: (ms,
    plain_ms)}``."""
    cfg = NeRFConfig.full()
    rng = np.random.default_rng(0)
    batches = [bench_batch(rng, cfg, FLAGSHIP_RAYS) for _ in range(2)]
    steps, losses, calls = {}, {"auto": [], "plain": []}, {"auto": 0, "plain": 0}
    for backend in ("auto", "plain"):
        model = NeRFModel(cfg, device="cuda")
        model.init(torch.Generator().manual_seed(0))
        opt = torch.optim.Adam(model.parameters(), lr=5e-4)
        steps[backend] = (model, make_single_chip_train_step(cfg, opt, backend))

    def run(backend):
        model, step = steps[backend]
        loss = step(model, *batches[calls[backend] % 2])
        calls[backend] += 1
        losses[backend].append(loss)
        return loss

    run("auto"), run("plain")  # warm-up
    times = timed_turns({"plain": lambda: run("plain"), "auto": lambda: run("auto")}, 3)
    losses = {k: [x.item() for x in v] for k, v in losses.items()}
    if not all(np.all(np.isfinite(v)) for v in losses.values()):
        raise AssertionError(f"non-finite loss at the flagship shape: {losses}")
    rel = abs(losses["auto"][0] - losses["plain"][0]) / losses["plain"][0]
    flops = FLAGSHIP_RAYS * cfg.num_samples * FULL_MACS_TRAIN * 2
    print(f"phase 9 flagship train step, full, {FLAGSHIP_RAYS} rays x {cfg.num_samples} "
          f"samples, Adam 5e-4, on {smi} (first-step loss kernel {losses['auto'][0]:.6e} "
          f"plain {losses['plain'][0]:.6e}, rel diff {rel:.2e}; {flops / 1e12:.2f} TFLOP "
          "per step):")
    for backend, name in (("auto", "kernel"), ("plain", "plain ")):
        med = statistics.median(times[backend])
        print(f"  {name}: {spread(times[backend])}/step, {FLAGSHIP_RAYS / med * 1e3:.4e} "
              f"rays/s, {flops / med / 1e9:.2f} TFLOP/s")
    out = {"nerf_wide_train": statistics.median(times["auto"])}

    # one 800x800 frame: the kernel path (render_image) against the plain
    # version over the same 65,536-ray chunks
    model = steps["auto"][0]
    K = normalized_intrinsics(1.1106, device="cuda")
    pose = torch.eye(4, device="cuda")
    pose[2, 3] = 4.0
    chunk = fused_nerf.render_chunk_rays(cfg, model.params)

    def plain_frame():
        o, d = rays.get_rays(SERVE_SIZE, SERVE_SIZE, K, pose)
        tv, dists = rays.uniform_depths(cfg.near, cfg.far, cfg.num_samples, "cuda")
        return torch.cat([fused_nerf.render_rays_reference(model.params, oc, dc, tv,
                                                           dists, cfg)
                          for oc, dc in zip(o.split(chunk), d.split(chunk))]
                         ).reshape(SERVE_SIZE, SERVE_SIZE, 3)

    def kernel_frame():
        return model.render_image(K, pose, SERVE_SIZE)

    def layers_frame():
        o, d = rays.get_rays(SERVE_SIZE, SERVE_SIZE, K, pose)
        tv, dists = rays.uniform_depths(cfg.near, cfg.far, cfg.num_samples, "cuda")
        W, b = fused_nerf.pack_wide_params(model.params, 256, cfg.compute_dtype)
        return torch.cat([wide_mlp.render_rays_layers(W, b, tv, dists, oc, dc, cfg)
                          for oc, dc in zip(o.split(chunk), d.split(chunk))]
                         ).reshape(SERVE_SIZE, SERVE_SIZE, 3)

    with torch.no_grad():
        _, img_k = cuda_ms(kernel_frame)  # warm-up
        _, img_m = cuda_ms(layers_frame)
        _, img_p = cuda_ms(plain_frame)
        err = (img_k - img_p).abs().max().item()
        if not torch.isfinite(img_k).all():
            raise AssertionError("non-finite pixels")
        tied_share, tied_px = frame_ties(fused_nerf, wide_mlp, cfg, model, rays, K, pose, img_k,
                                         img_m)
        torch.testing.assert_close(img_k, img_p, atol=wide_tolerances(cfg)[0], rtol=RTOL)
        # the plain frame takes ~3 s: one round of it, more of the two kernels
        frame = timed_turns({"plain": plain_frame, "layers": layers_frame,
                             "kernel": kernel_frame}, 1)
        for name, ts in timed_turns({"layers": layers_frame, "kernel": kernel_frame},
                                    FRAME_ROUNDS).items():
            frame[name] += ts
    n_rays = SERVE_SIZE * SERVE_SIZE
    flops = n_rays * cfg.num_samples * FULL_MACS_FWD * 2
    print(f"phase 9 800x800 full frame ({n_rays} rays x {cfg.num_samples} samples, "
          f"{flops / 1e12:.2f} TFLOP, chunks of {chunk} rays), max|kernel-plain| = "
          f"{err:.3e}; the fused MLP's frame equals the layer chain's off near ties "
          f"({tied_share:.3%} of the rows tied, {tied_px} pixels); on {smi}:")
    for name, what in (("kernel", "fused MLP"), ("layers", "layer chain"), ("plain", "plain")):
        med = statistics.median(frame[name])
        print(f"  {what:14s}: {spread(frame[name])}/frame, {n_rays / med * 1e3:.4e} rays/s, "
              f"{flops / med / 1e9:.2f} TFLOP/s")
    out["nerf_wide_render_fwd"] = statistics.median(frame["kernel"])
    plain = {"nerf_wide_train": statistics.median(times["plain"]),
             "nerf_wide_render_fwd": statistics.median(frame["plain"])}

    # each wide entry point's own call against its plain version
    params = seeded_params(np.random.default_rng(0), cfg)
    lv = leaves_of(params)
    o, d, t, dists, tgt = batches[0]
    W, b = fused_nerf.pack_wide_params(params, 256, cfg.compute_dtype)
    cot = torch.tensor(np.random.default_rng(1).standard_normal((FLAGSHIP_RAYS, 3)),
                       dtype=torch.float32, device="cuda")
    o64, d64 = seeded_rays(np.random.default_rng(2), chunk)
    plain_out = fused_nerf.render_rays_reference(params, o, d, t, dists, cfg)
    alone = {
        "nerf_wide_train": (
            lambda: fused_nerf._launch_wide_grad("nerf_wide_train", W, b, t, dists, o, d,
                                                 tgt, cfg),
            lambda: torch.autograd.grad(fused_nerf.nerf_train_loss_reference(
                params, o, d, t, dists, tgt, cfg), lv),
            f"loss + dW/db, {FLAGSHIP_RAYS} rays"),
        "nerf_wide_render_bwd": (
            lambda: fused_nerf._launch_wide_grad("nerf_wide_render_bwd", W, b, t, dists,
                                                 o, d, cot, cfg),
            lambda: torch.autograd.grad(plain_out, lv, cot, retain_graph=True),
            f"dW/db from a colour cotangent, {FLAGSHIP_RAYS} rays (plain: the "
            "backward pass only)"),
        "nerf_wide_render_fwd": (
            lambda: fused_nerf._launch_wide_render(W, b, t, dists, o64, d64, cfg),
            lambda: fused_nerf.render_rays_reference(params, o64, d64, t, dists, cfg),
            f"one {chunk}-ray render chunk"),
    }
    for name, (kernel, plain_fn, what) in alone.items():
        with torch.no_grad() if name == "nerf_wide_render_fwd" else contextlib.nullcontext():
            kernel(), plain_fn()  # warm-up
            ts = timed_turns({"plain": plain_fn, "kernel": kernel}, 2)
        print(f"  {name} alone, {what}: kernel {spread(ts['kernel'])} vs plain "
              f"{spread(ts['plain'])}")
        if name == "nerf_wide_render_bwd":
            out[name] = statistics.median(ts["kernel"])
            plain[name] = statistics.median(ts["plain"])
    del plain_out
    return {k: (out[k], plain[k]) for k in out}


def card_probe(what, *args):
    """The JSON result of ``lomanerf_tpu_torch.scripts.card_probe --what
    <what>`` run in a process of its own (the profiler records the card's
    kernels in a process's first session only), its other lines echoed."""
    torch.cuda.empty_cache()
    r = subprocess.run([sys.executable, "-m", "lomanerf_tpu_torch.scripts.card_probe",
                        "--what", what, *args], cwd=ROOT, capture_output=True, text=True,
                       timeout=600)
    if r.returncode != 0:
        raise AssertionError(f"card_probe --what {what} exited {r.returncode}:\n"
                             f"{r.stdout[-2000:]}\n{r.stderr[-4000:]}")
    lines = r.stdout.strip().splitlines()
    for line in lines[:-1]:
        print("  " + line)
    return json.loads(lines[-1])


def phase_flagship_split(NeRFConfig):
    """Phase 9, the flagship step's device time by kernel family (3 traced
    steps, ``card_probe --what flagship``): the dW GEMMs must be the
    wgmma/TMA stage once per hidden layer and the head's ``mma.sync`` one
    once per step.  Returns the split."""
    cfg = NeRFConfig.full()
    split = card_probe("flagship", "--steps", "3")
    per = split["launches_per_step"]
    dw = {k: per.get(k) for k in ("dw_wgmma_kernel", "gemm_mma_kernel kEpiPartial")}
    if dw != {"dw_wgmma_kernel": cfg.num_layers - 1, "gemm_mma_kernel kEpiPartial": 1}:
        raise AssertionError(f"flagship step: dW launches per step {dw}, need "
                             f"{cfg.num_layers - 1} of dw_wgmma_kernel and the head's one")
    layer_gemm_launches(per, cfg, 1, "flagship step")
    print("phase 9 flagship step split (utils.profiling.trace, 3 steps): device "
          f"{split['device_ms_per_step']:.3f} ms/step; " + ", ".join(
              f"{k} {split['ms'][k]:.3f} ms ({split['share'][k]:.1%})"
              for k in ("dW", "d_h", "forward", "compositing", "partial and column sums"))
          + f"; dW launches per step {dw}")
    return split


def layer_gemm_launches(per, cfg, chunks, what, train=True):
    """Raise unless the kernels per step or frame ``per`` (``card_probe``'s
    ``kernel_key`` names) run every bf16 forward layer (L - 1 a chunk) and,
    for a train step, every ``d_h`` (L - 2 a chunk) on the wgmma/TMA layer
    GEMM, and none on ``gemm_mma_kernel``."""
    want = {"layer_wgmma_kernel kEpiBiasRelu": (cfg.num_layers - 1) * chunks,
            "layer_wgmma_kernel kEpiMask": (cfg.num_layers - 2) * chunks if train else 0}
    got = {k: per.get(k, 0) for k in want}
    old = {k: v for k, v in per.items() if k.startswith("gemm_mma_kernel kEpi")
           and not k.endswith("kEpiPartial")}
    if got != want or old:
        raise AssertionError(f"{what}: layer GEMMs {got} and {old}, need {want} and none on "
                             "gemm_mma_kernel")


DW_ROWS = FLAGSHIP_RAYS * 128  # one flagship gradient chunk: 2,097,152 rows
DW_RTOL = 1e-6  # of the f64 sum of |products|: f32 sums of exact products


def phase_dw_stage(wide_dw, smi):
    """Phase 9, the dW stage alone: ``wide_dw.wide_dw_gemm`` (the
    wgmma/TMA kernel #7, #9, #11 and #12 run for each hidden layer) at the
    flagship's 2,097,152 x 256 x 256, at layer 0's 40 columns and at 1037 x
    128 rows (a ragged last partial), on ReLU'd normal activations and
    normal d_z x 1e-3 rounded to bf16: within ``DW_RTOL`` of the f64 sum of
    |products| of the f64 product of the rounded operands, repeats
    bit-identical.  Then the kernel and ``torch.mm`` of the same bf16
    operands (one 2,097,152-deep product: a yardstick, never called by the
    port) in turns, beside the stage's bound.  Returns ``{"ms", "mm_ms",
    "bound_ms"}``."""
    g = torch.Generator("cuda").manual_seed(31)
    out = {}
    for rows, M, what in ((DW_ROWS, 256, "the flagship"), (DW_ROWS, 40, "layer 0's 40 columns"),
                          (1037 * 128, 256, "1037 x 128 rows (a ragged last partial)")):
        h = torch.relu(torch.randn((rows, 256), generator=g, device="cuda")).to(torch.bfloat16)
        db = (torch.randn((rows, 256), generator=g, device="cuda") * 1e-3).to(torch.bfloat16)
        new, again = wide_dw.wide_dw_gemm(h, db, M), wide_dw.wide_dw_gemm(h, db, M)
        n = new.shape[0]
        hp = h.new_zeros((n * wide_dw.ROW_CHUNK, M), dtype=torch.float64)
        dp = h.new_zeros((n * wide_dw.ROW_CHUNK, 256), dtype=torch.float64)
        hp[:rows], dp[:rows] = h[:, :M].double(), db.double()
        h3, d3 = hp.view(n, -1, M).transpose(1, 2), dp.view(n, -1, 256)
        ref, scale = torch.bmm(h3, d3), torch.bmm(h3.abs(), d3.abs()).clamp_min(1e-30)
        del hp, dp, h3, d3
        e_new = ((new.double() - ref) / scale).abs().max().item()
        if not torch.equal(new, again):
            raise AssertionError(f"wide_dw_gemm at {what}: repeat launches differ")
        if e_new > DW_RTOL or not torch.isfinite(new).all():
            raise AssertionError(f"wide_dw_gemm at {what}: {e_new:.3e} off f64, of the sum of "
                                 "|products|")
        print(f"phase 9 dW stage alone at {what} ({rows} x {M} x 256, {n} partials): "
              f"|wgmma - f64| {e_new:.3e} of the f64 sum of |products| (bound {DW_RTOL}); "
              "repeats bit-identical")
        del ref, scale, new, again
        if rows == DW_ROWS and M == 256:
            fns = {"wgmma": lambda: wide_dw.wide_dw_gemm(h, db, 256),
                   "torch.mm": lambda: torch.mm(h.t(), db)}
            for fn in fns.values():
                fn()
            ts = timed_turns(fns, 3)
            kb = bound(rows * 256 * 256, PEAK_BF16,
                       2 * h.numel() + 2 * db.numel() + 4 * n * 256 * 256)
            out = {"ms": statistics.median(ts["wgmma"]),
                   "mm_ms": statistics.median(ts["torch.mm"]), "bound_ms": kb[0]}
            print(f"phase 9 dW stage alone at the flagship, on {smi}: wgmma/TMA "
                  f"{spread(ts['wgmma'])}, torch.mm {spread(ts['torch.mm'])}; bound {kb[0]:.4f} ms ({kb[1]}: H, the bf16 d_z "
                  f"and the partials), the wgmma kernel at {kb[0] / out['ms']:.1%} of it")
        del h, db
    torch.cuda.empty_cache()
    return out


FULL_MACS_MLP = FULL_MACS_FWD - 256 * 4  # the hidden layers: the fused kernel's work


def phase_fused_mlp(fused_nerf, wide_mlp, NeRFConfig, NeRFModel, smi):
    """Phase 9, the fused MLP (``nerf_wide_mlp.cuh``) alone and #10 new
    against old.  The MLP of one 65,536-ray ``full`` chunk (8,388,608 rows)
    through ``wide_mlp.wide_mlp`` (repeats bit-identical, finite, the
    padded nothing: 256 of 256 columns) against its bound and a yardstick
    the port never calls: the same seven layers as a cuBLAS chain of
    ``torch.addmm`` + ``relu_`` in bf16 from the same stored encoding, in
    turns; its H_{L-1} against the chain's on the first 1,024 rays (a
    diagnostic: cuBLAS sums in another order).  Then #10, the per-ray
    render, at the 16,384-ray flagship batch on jittered depths: the fused
    MLP's H_{L-1} equals the layer chain's on every row without a near tie
    (``wide_mlp.tied_rows``: each value where they part a near tie, at most
    ``NEAR_TIE_ROWS`` of the rows), and so do the colours of the rays
    without one, timed in turns.
    Returns ``{"ms", "cublas_ms", "bound_ms", "tied_rows", "rays10_ms",
    "rays10_layers_ms"}``."""
    from lomanerf_tpu_torch.core import positional_encoding

    cfg = NeRFConfig.full()
    params = seeded_params(np.random.default_rng(0), cfg)
    W, b = fused_nerf.pack_wide_params(params, 256, cfg.compute_dtype)
    n = fused_nerf.wide_chunk_rays(cfg, 256)
    o, d = seeded_rays(np.random.default_rng(3), n)
    t, _ = uniform_depths(cfg)
    h1, h2 = wide_mlp.wide_mlp(W, b, t, o, d, cfg), wide_mlp.wide_mlp(W, b, t, o, d, cfg)
    rows, kc = h1.shape[0], fused_nerf._round_up(cfg.in_channels, 8)
    if not torch.equal(h1, h2) or not torch.isfinite(h1.float()).all():
        raise AssertionError("nerf_wide_mlp: repeat launches differ or H_{L-1} is not finite")
    del h2
    # the cuBLAS chain's input: the kernels' bf16 encoding of the same rows
    pts = (o[:, None, :] + d[:, None, :] * t[:, None]).reshape(rows, 3)
    enc = torch.zeros((rows, kc), dtype=torch.bfloat16, device="cuda")
    enc[:, :cfg.in_channels] = positional_encoding(pts, cfg.num_encoding_functions)
    del pts
    ws = [W[0, :kc]] + [W[l] for l in range(1, cfg.num_layers - 1)]
    bs = [b[l].to(torch.bfloat16) for l in range(cfg.num_layers - 1)]

    def cublas():
        h = enc
        for w, bl in zip(ws, bs):
            h = torch.addmm(bl, h, w).relu_()
        return h

    with torch.no_grad():
        hc = cublas()
        apart = (h1[:1024 * 128] != hc[:1024 * 128]).float().mean().item()
        e = (h1[:1024 * 128].float() - hc[:1024 * 128].float()).abs().max().item()
        del hc
        fns = {"cublas": cublas, "fused": lambda: wide_mlp.wide_mlp(W, b, t, o, d, cfg)}
        ts = timed_turns(fns, 3)
    kb = bound(rows * FULL_MACS_MLP, PEAK_BF16, n * 24 + rows * 256 * 2)
    med = {k: statistics.median(v) for k, v in ts.items()}
    flops = 2.0 * rows * FULL_MACS_MLP
    print(f"phase 9 fused MLP alone, one {n}-ray full chunk ({rows} rows, {flops / 1e12:.2f} "
          f"TFLOP), on {smi}: nerf_wide_mlp {spread(ts['fused'])} ({flops / med['fused'] / 1e9:.2f}"
          f" TFLOP/s, {kb[0] / med['fused']:.1%} of the {kb[0]:.4f} ms bound, {kb[1]}); cuBLAS "
          f"chain of addmm + relu_ (a yardstick) {spread(ts['cublas'])} "
          f"({flops / med['cublas'] / 1e9:.2f} TFLOP/s); H_{{L-1}} of the first 1024 rays vs the "
          f"chain: max|diff| {e:.3e}, {apart:.2e} of the values apart; repeats bit-identical")
    del h1, enc
    torch.cuda.empty_cache()

    o, d, _, _, _ = bench_batch(np.random.default_rng(0), cfg, FLAGSHIP_RAYS)
    tj, dj = stratified_depths(NeRFModel(cfg), o, d, 3)
    with torch.no_grad():
        new = fused_nerf._launch_wide_render(W, b, tj, dj, o, d, cfg)
        old = wide_mlp.render_rays_layers(W, b, tj, dj, o, d, cfg)
        tied, far, hf, hc = wide_mlp.tied_rows(W, b, tj, dj, o, d, cfg)
        share = tied.float().mean().item()
        clear = ~tied.view(FLAGSHIP_RAYS, cfg.num_samples).any(1)
        if far or share > NEAR_TIE_ROWS or not torch.equal(hf[~tied], hc[~tied]) or \
                not torch.equal(new[clear], old[clear]):
            raise AssertionError(f"#10 at the flagship batch against the layer chain: {far} values "
                                 f"apart past a near tie, {share:.2%} of the rows tied, colours "
                                 f"of untied rays apart: {int((new[clear] != old[clear]).sum())}")
        del hf, hc
        r10 = timed_turns({"layers": lambda: wide_mlp.render_rays_layers(W, b, tj, dj, o, d,
                                                                         cfg),
                           "fused": lambda: fused_nerf._launch_wide_render(W, b, tj, dj, o, d,
                                                                           cfg)}, 3)
    print(f"phase 9 #10 nerf_wide_render_fwd_rays, {FLAGSHIP_RAYS} rays x 128 jittered samples, "
          f"on {smi}: fused MLP {spread(r10['fused'])}, layer chain {spread(r10['layers'])}; "
          f"H_{{L-1}} equal to the chain's off near ties ({share:.3%} of the rows tied, "
          f"{int((~clear).sum())} rays), the other rays' colours bit-identical")
    return {"ms": med["fused"], "cublas_ms": med["cublas"], "bound_ms": kb[0],
            "tied_rows": share, "rays10_ms": statistics.median(r10["fused"]),
            "rays10_layers_ms": statistics.median(r10["layers"])}


def phase_frame_split(NeRFConfig):
    """Phase 9, an 800x800 ``full`` frame's device time by kernel family
    (``card_probe --what frame``, a process of its own), on the fused MLP
    and on the layer chain it replaced: the main path launches
    ``mlp_wgmma_kernel`` once per chunk and no layer GEMM (``kEpiBiasRelu``
    on ``layer_wgmma_kernel`` or ``gemm_mma_kernel``), the layer chain every
    forward layer on ``layer_wgmma_kernel``.  Returns both splits."""
    out = {}
    for path in ("fused", "layers"):
        split = card_probe("frame", "--path", path)
        per = split["launches_per_frame"]
        out[path] = split
        if path == "fused" and (per.get("mlp_wgmma_kernel") != split["chunks"] or any(
                k.endswith("kEpiBiasRelu") for k in per)):
            raise AssertionError(f"frame: kernels per frame {per}, need mlp_wgmma_kernel once "
                                 f"per chunk ({split['chunks']}) and no layer GEMM")
        if path == "layers":
            layer_gemm_launches(per, NeRFConfig.full(), split["chunks"], "layer-chain frame",
                                train=False)
        print(f"phase 9 frame split ({path}, utils.profiling.trace, {split['frames']} frames): device "
              f"{split['device_ms_per_frame']:.3f} ms/frame; " + ", ".join(
                  f"{k} {v:.3f} ms ({split['share'][k]:.1%})"
                  for k, v in split["ms"].items() if v))
    return out


def field_configs(ImageFieldConfig):
    return {"small": ImageFieldConfig.small(), "hires": ImageFieldConfig.hires()}


def field_grads(fn, params, coords, cot, nf):
    """``(out, dW/db, coords gradient)`` of ``(fn(params, coords) * cot).sum()``."""
    leaves = leaves_of(params)
    c = coords.clone().requires_grad_(True)
    out = fn(params, c, nf)
    grads = torch.autograd.grad((out * cot).sum(), [*leaves, c], allow_unused=True)
    return out.detach(), grads[:-1], grads[-1]


def phase_field_kernels(fused_mlp, ImageFieldConfig, image_grid_coords, seed=11):
    """Phase 10: the field kernels (#13 forward, #14 backward) against the
    plain version and autograd of it on the card, on both product routes
    (``FIELD_TIERS``: "high", 3xTF32 on the tensor cores; "highest", f32
    FMAs), at the ``small`` and ``hires`` widths and at 5 x 128 on 1037
    pixels (the f32 bounds of phases 1 and 4), repeat launches
    bit-identical, no coords gradient; then the whole 1024x1024 image at
    ``hires`` and 5 x 128 (each block of the persistent grid walks hundreds
    of tiles, through every copy of the weights' two-slot schedule), where
    both sides sum 1 M pixels in other orders: dW/db within
    ``FIELD_IMAGE_GRAD`` of each leaf's largest entry, repeat launches
    bit-identical, and the (leaf, columns) that ReLU-mask flips move printed
    per route; the exact route may flip no more columns than 3xTF32.
    Returns the worst |kernel - plain| per kernel and, per image and route,
    the worst leaf and the flipped columns."""
    rng = np.random.default_rng(seed)
    worst = {"field_fwd": 0.0, "field_bwd": 0.0}
    configs = {**field_configs(ImageFieldConfig), "5x128": ImageFieldConfig(
        num_layers=5, filter_size=128, num_encoding_functions=8)}

    def kernel(tier):
        return lambda params, coords, nf: fused_mlp.field_forward(params, coords, nf,
                                                                  precision=tier)
    for name, cfg in configs.items():
        nf = cfg.num_encoding_functions
        params = seeded_params(rng, cfg)
        coords = torch.tensor(rng.random((N_CHECK, 2)), dtype=torch.float32, device="cuda")
        cot = torch.tensor(rng.standard_normal((N_CHECK, 3)), dtype=torch.float32,
                           device="cuda")
        p = field_grads(fused_mlp.field_forward_reference, params, coords, cot, nf)
        for tier in FIELD_TIERS:
            k1 = field_grads(kernel(tier), params, coords, cot, nf)
            k2 = field_grads(kernel(tier), params, coords, cot, nf)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip((k1[0], *k1[1]), (k2[0], *k2[1]))):
                raise AssertionError(f"field {name} {tier}: repeat launches differ")
            if k1[2] is not None:
                raise AssertionError(f"field {name}: the coords got a gradient")
            e_f = (k1[0] - p[0]).abs().max().item()
            torch.testing.assert_close(k1[0], p[0], atol=ATOL, rtol=RTOL)
            e_b = grads_close(k1[1], p[1], f"field_bwd {name} {tier}", GRAD_RTOL, grad_atol)
            worst["field_fwd"] = max(worst["field_fwd"], e_f)
            worst["field_bwd"] = max(worst["field_bwd"], e_b)
            widths = [cfg.in_channels] + [cfg.filter_size] * (cfg.num_layers - 1) + [3]
            print(f"phase 10 field {name} ({'->'.join(map(str, widths))}, n={nf}) "
                  f"{tier:7s} N={N_CHECK}: max|kernel-plain| forward {e_f:.3e}, dW/db "
                  f"{e_b:.3e}; repeat launches bit-identical; coords gradient None")

    image = {}
    for name in ("hires", "5x128"):
        cfg = configs[name]
        size = ImageFieldConfig.hires().img_size
        n_px = size ** 2
        nf = cfg.num_encoding_functions
        params = seeded_params(np.random.default_rng(0), cfg)
        coords = image_grid_coords(size, "cuda")
        cot = torch.tensor(np.random.default_rng(1).standard_normal((n_px, 3)),
                           dtype=torch.float32, device="cuda")
        p = field_grads(fused_mlp.field_forward_reference, params, coords, cot, nf)
        for tier in FIELD_TIERS:
            k = field_grads(kernel(tier), params, coords, cot, nf)
            k2 = field_grads(kernel(tier), params, coords, cot, nf)
            if not all(torch.equal(a, b) for a, b in zip((k[0], *k[1]), (k2[0], *k2[1]))):
                raise AssertionError(f"field {name} {tier} at {size}x{size}: repeat "
                                     "launches differ")
            del k2
            e_f = (k[0] - p[0]).abs().max().item()
            torch.testing.assert_close(k[0], p[0], atol=ATOL, rtol=RTOL)
            rel = max(((a - b).abs().max() / b.abs().max()).item()
                      for a, b in zip(k[1], p[1]))
            # where a hidden pre-activation lies within f32 rounding of 0, the
            # two sums can take the ReLU mask apart and move that pixel's
            # whole term out of one unit's dW/db column (one flip measured
            # 9e-4 of the leaf's largest entry at this image); list the
            # columns beyond phase 4's bound
            flips = [(i, sorted(set(torch.nonzero(
                (a - b).abs() > 1e-3 * b.abs() + 1e-4 * b.abs().max())[:, -1].tolist())))
                for i, (a, b) in enumerate(zip(k[1], p[1]))]
            flips = [f for f in flips if f[1]]
            grads_close(k[1], p[1], f"field_bwd {name} {tier} at {size}x{size}", 0.0,
                        lambda w: FIELD_IMAGE_GRAD * w.abs().max().item())
            worst["field_fwd"] = max(worst["field_fwd"], e_f)
            exact = fused_mlp.exact_tier(tier)
            blocks = fused_mlp.resident_blocks(0, "field_bwd", cfg.num_layers,
                                               cfg.in_channels, cfg.filter_size, nf, 3, exact)
            image[f"{name} {tier}"] = {"worst_of_largest": rel, "flips": flips,
                                       "flipped_columns": sum(len(c) for _, c in flips)}
            print(f"phase 10 field {name} {tier}, the whole {size}x{size} image ({blocks} "
                  f"blocks, up to {-(-n_px // fused_mlp.TILE // blocks)} tiles each): "
                  f"max|kernel-plain| forward {e_f:.3e}; max|dW,db kernel-plain| {rel:.3e} "
                  f"of the leaf's largest entry (bound {FIELD_IMAGE_GRAD}); repeat launches "
                  f"bit-identical; (leaf, columns) beyond rtol 1e-3 + 1e-4 of the largest "
                  f"entry: {flips}")
            del k
        high, highest = (image[f"{name} {t}"]["flipped_columns"] for t in FIELD_TIERS)
        if highest > high:
            raise AssertionError(f"field {name} at {size}x{size}: the exact route flips "
                                 f"{highest} columns, 3xTF32 {high}")
        del p
    return worst, image


def phase_field_driver(fit_image, fused_mlp, tmp):
    """Phase 11: the image-fit path through its entry point,
    ``fit_image.main``, on the synthetic target.  The ``small`` field at
    256x256, 301 Adam steps at lr 3e-3, an eval every 100 steps; then 10
    more steps with ``--resume``; then the ``hires`` field at 1024x1024,
    200 Adam steps at lr 1e-3, on the kernels and on the plain backend from
    the same init.  Returns each field kernel's launches in the 301-step
    run."""
    base = ["--device", "cuda", "--img", "synthetic", "--optimizer", "adam",
            "--ckpt-every", "0"]
    logs = os.path.join(tmp, "logs_fit")
    small = [*base, "--img-size", "256", "--lr", "3e-3", "--log-every", "100",
             "--log-dir", logs, "--ckpt-dir", os.path.join(tmp, "ck_fit")]
    reset_launches(fused_mlp)
    t0 = time.perf_counter()
    out = fit_image.main([*small, "--steps", str(FIT_STEPS)])
    fit_s = time.perf_counter() - t0
    counts = dict(fused_mlp.launches)
    if counts["field_bwd"] != FIT_STEPS or counts["field_fwd"] < FIT_STEPS:
        raise AssertionError(f"field kernels launched {counts} times in {FIT_STEPS} steps")
    if len(out["losses"]) != FIT_STEPS or not np.all(np.isfinite(out["losses"])):
        raise AssertionError("the fit stopped or its loss is not finite")
    if not os.path.exists(os.path.join(logs, f"iter_{FIT_STEPS}.png")):
        raise AssertionError("the fit wrote no final image")
    with open(os.path.join(logs, "metrics.jsonl")) as f:
        stamps = {r["step"]: r["time"] for r in map(json.loads, f)}
    step_ms = (stamps[199] - stamps[150]) / 49 * 1e3  # no eval in between
    curve = out["psnr"]
    last = FIT_STEPS - 1
    print(f"phase 11 fit_image small, 256x256, {FIT_STEPS} Adam steps (lr 3e-3): "
          f"{fit_s:.2f} s host time (evals, PNGs and set-up included; {step_ms:.3f} ms/step "
          f"between steps 150 and 199); launches {counts}; final loss {out['losses'][-1]:.4f}")
    print("  eval PSNR dB, port on the card (torch seed 215) | port --device cpu | JAX on "
          "the CPU (PRNGKey(215)): " + ", ".join(
              f"step {s}: {curve[s]:.2f} | {c:.2f} | {j:.2f}"
              for s, c, j in zip(sorted(curve), FIT_CPU_CURVE, FIT_JAX_CURVE)))
    if curve[last] < FIT_PSNR_DB or curve[last] < curve[0] + FIT_GAIN_DB:
        raise AssertionError(f"PSNR {curve}: need >= {FIT_PSNR_DB} dB at step {last} and "
                             f"{FIT_GAIN_DB} dB above step 0")
    reset_launches(fused_mlp)
    more = fit_image.main([*small, "--steps", str(FIT_STEPS + 10), "--resume"])
    if fused_mlp.launches["field_bwd"] != 10 or len(more["losses"]) != 10 \
            or not np.all(np.isfinite(more["losses"])):
        raise AssertionError(f"--resume took {len(more['losses'])} steps, launches "
                             f"{fused_mlp.launches}")
    print(f"phase 11 --resume: 10 more steps from step {FIT_STEPS}, loss "
          f"{more['losses'][-1]:.4f}, PSNR {more['final_psnr']:.2f} dB")

    hires = [*base, "--img-size", "1024", "--layers", "4", "--width", "128",
             "--enc-functions", "8", "--lr", "1e-3", "--log-every", "50",
             "--steps", str(HIRES_STEPS)]
    runs = {}
    for backend in ("auto", "plain"):
        reset_launches(fused_mlp)
        t0 = time.perf_counter()
        runs[backend] = fit_image.main([
            *hires, "--backend", backend, "--log-dir", os.path.join(tmp, f"logs_{backend}"),
            "--ckpt-dir", os.path.join(tmp, f"ck_{backend}")])
        secs = time.perf_counter() - t0
        n = dict(fused_mlp.launches)
        if backend == "auto" and n["field_bwd"] != HIRES_STEPS:
            raise AssertionError(f"hires fit: launches {n} in {HIRES_STEPS} steps")
        if backend == "plain" and any(n.values()):
            raise AssertionError(f"the plain backend launched kernels: {n}")
        r = runs[backend]
        print(f"phase 11 fit_image hires, 1024x1024, {HIRES_STEPS} Adam steps (lr 1e-3), "
              f"backend {backend}: {secs:.2f} s host time; launches {n}; eval PSNR dB "
              + ", ".join(f"step {s}: {v:.2f}" for s, v in sorted(r["psnr"].items()))
              + f", final {r['final_psnr']:.2f}")
    k, p = runs["auto"], runs["plain"]
    gain = k["final_psnr"] - k["psnr"][0]
    diff = abs(k["final_psnr"] - p["final_psnr"])
    print(f"  hires: {gain:.2f} dB above step 0; final PSNR kernel - plain = "
          f"{k['final_psnr'] - p['final_psnr']:+.4f} dB")
    if gain < HIRES_GAIN_DB or diff > HIRES_PLAIN_DB:
        raise AssertionError(f"hires fit: gain {gain:.2f} dB (need {HIRES_GAIN_DB}), "
                             f"|kernel - plain| {diff:.3f} dB (need <= {HIRES_PLAIN_DB})")
    return counts


def device_ms_per_call(trace, fn, log_dir, calls=20):
    """Device time per call of ``fn`` over ``calls`` calls, from the Chrome
    trace ``utils.profiling.trace`` writes (torch.profiler: the sum of the
    kernels', memsets' and copies' device times), or None where the trace
    holds no device time.  The run's only profiler session: a second one in
    the same process recorded no kernels on the card."""
    torch.cuda.synchronize()
    with trace(log_dir):
        for _ in range(calls):
            fn()
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    total = sum(e.get("dur", 0.0) for e in events
                if e.get("cat") in ("kernel", "gpu_memset", "gpu_memcpy"))
    return total / calls / 1e3 if total > 0 else None


def phase_field_timing(fused_mlp, ImageFieldConfig, ImageFieldModel, image_grid_coords,
                       make_image_fit_step, mlp_layer_sizes, trace, smi, tmp):
    """Phase 12: timing by CUDA events, median with min/max, kernel and plain
    backend in turns, in the shape of the JAX bench's fit rungs
    (``bench.py:116-178``): the whole image per step, ``Adam(1e-3)``, two
    uniform numpy-``default_rng(0)`` targets cycled; ``small`` at 256x256
    (with the device's busy share of its step, from the trace of
    ``utils.profiling.trace``) and ``hires`` at 1024x1024; then one
    1024x1024 ``hires`` render and each field kernel's own call against its
    plain version at that image, each against its f32 bound and its 3xTF32
    bound (three TF32 passes at the tensor cores' peak: the operations the
    kernels do).  Returns ``{kernel: (ms, plain_ms, bound_ms, bound_by)}``,
    with the 3xTF32 bound (the f32 one is printed)."""
    out = {}
    for name, cfg in field_configs(ImageFieldConfig).items():
        size, nf = cfg.img_size, cfg.num_encoding_functions
        n_px = size * size
        coords = image_grid_coords(size, "cuda")
        rng = np.random.default_rng(0)
        targets = [torch.tensor(rng.random((n_px, 3)), dtype=torch.float32, device="cuda")
                   for _ in range(2)]
        steps, calls, losses = {}, {"auto": 0, "plain": 0}, {"auto": [], "plain": []}
        for backend in ("auto", "plain"):
            model = ImageFieldModel(cfg, device="cuda", backend=backend)
            model.init(torch.Generator().manual_seed(0))
            opt = torch.optim.Adam(model.parameters(), lr=1e-3)
            steps[backend] = (model, make_image_fit_step(cfg, opt, backend))

        def run(backend):
            model, step = steps[backend]
            losses[backend].append(step(model, coords, targets[calls[backend] % 2]))
            calls[backend] += 1

        for _ in range(2):  # warm-up
            run("auto"), run("plain")
        times = timed_turns({"plain": lambda: run("plain"), "auto": lambda: run("auto")},
                            10 if name == "small" else 3)
        first = {k: v[0].item() for k, v in losses.items()}
        if not all(np.isfinite([x.item() for v in losses.values() for x in v])):
            raise AssertionError(f"non-finite loss in the {name} fit step")
        fwd, bwd = mlp_macs(mlp_layer_sizes(cfg.in_channels, cfg.out_channels,
                                            cfg.num_layers, cfg.filter_size))
        macs = n_px * (fwd + bwd)
        step_bound, by = bound(macs, PEAK_F32, n_px * 4 * (2 + 3 + 3))
        tf32_step = bound(TF32_PASSES * macs, PEAK_TF32, n_px * 4 * (2 + 3 + 3))[0]
        print(f"phase 12 image-fit step, {name} ({fwd + bwd} MACs/px: one field_fwd and one "
              f"field_bwd launch), {size}x{size} = {n_px} px, Adam 1e-3, on {smi} "
              f"(first-step loss kernel {first['auto']:.6e} plain {first['plain']:.6e}); "
              f"bound {step_bound:.4f} ms ({by}, f32 peak), "
              f"3xTF32 bound {tf32_step:.4f} ms:")
        for backend, label in (("auto", "kernel"), ("plain", "plain ")):
            med = statistics.median(times[backend])
            print(f"  {label}: {spread(times[backend])}/step, {n_px / med * 1e3:.4e} px/s, "
                  f"{2 * macs / med / 1e9:.3f} TFLOP/s, {step_bound / med:.1%} of the f32 bound")
        if name == "small":
            busy = device_ms_per_call(trace, lambda: run("auto"), os.path.join(tmp, "trace"))
            med = statistics.median(times["auto"])
            print("  kernel step, device busy (utils.profiling.trace, 20 steps): " + (
                "not measured (the profiler saw no device time)" if busy is None else
                f"{busy:.4f} ms/step, {busy / med:.1%} of the median step"))
            continue

        # one 1024x1024 render of the trained hires model, kernel vs plain
        model = steps["auto"][0]
        n_fwd = n_px * fwd
        fwd_bound = bound(n_fwd, PEAK_F32, n_px * 4 * (2 + 3))

        def plain_render():
            return fused_mlp.field_forward_reference(model.params, coords, nf).reshape(
                size, size, 3)

        with torch.no_grad():
            img_k, img_p = model.render(), plain_render()
            err = (img_k - img_p).abs().max().item()
            torch.testing.assert_close(img_k, img_p, atol=ATOL, rtol=RTOL)
            frame = timed_turns({"plain": plain_render, "kernel": model.render}, 3)
        print(f"phase 12 hires {size}x{size} render (ImageFieldModel.render, {n_fwd * 2 / 1e9:.2f} "
              f"GFLOP, bound {fwd_bound[0]:.4f} ms), max|kernel-plain| {err:.3e}:")
        for label in ("kernel", "plain"):
            med = statistics.median(frame[label])
            print(f"  {label:6s}: {spread(frame[label])}/render, {n_px / med * 1e3:.4e} px/s, "
                  f"{2 * n_fwd / med / 1e9:.3f} TFLOP/s, {fwd_bound[0] / med:.1%} of the f32 bound")

        # each kernel's own call at the whole image, against its plain version
        params = seeded_params(np.random.default_rng(0), cfg)
        lv = leaves_of(params)
        width = fused_mlp.kernel_width(params, 2, nf, 3)
        pk = fused_mlp.pack_field_params(params, width)
        G = fused_mlp.grad_floats(params, width)
        dims = (cfg.num_layers, cfg.in_channels, width, nf, 3, 0)  # "high": 3xTF32
        cot = torch.tensor(np.random.default_rng(1).standard_normal((n_px, 3)),
                           dtype=torch.float32, device="cuda")
        plain_out = fused_mlp.field_forward_reference(params, coords, nf)
        alone = {
            "field_fwd": (lambda: fused_mlp._launch_fwd(pk, coords, *dims),
                          lambda: fused_mlp.field_forward_reference(params, coords, nf),
                          n_px * fwd, n_px * 4 * (2 + 3), "the forward"),
            "field_bwd": (lambda: fused_mlp._launch_bwd(pk, G, coords, cot, *dims),
                          lambda: torch.autograd.grad(plain_out, lv, cot, retain_graph=True),
                          n_px * bwd, n_px * 4 * (2 + 3) + 4 * G,
                          "dW/db from a cotangent (plain: the backward pass only)"),
        }
        for kname, (kernel, plain_fn, kmacs, kbytes, what) in alone.items():
            with torch.no_grad() if kname == "field_fwd" else contextlib.nullcontext():
                kernel(), plain_fn()  # warm-up
                ts = timed_turns({"plain": plain_fn, "kernel": kernel}, 3)
            med = statistics.median(ts["kernel"])
            f32_bound = bound(kmacs, PEAK_F32, kbytes)
            tf32_bound = bound(TF32_PASSES * kmacs, PEAK_TF32, kbytes)
            out[kname] = (med, statistics.median(ts["plain"]), *tf32_bound)
            print(f"  {kname} alone, {what}, {n_px} px: kernel {spread(ts['kernel'])} vs plain "
                  f"{spread(ts['plain'])}; {2 * kmacs / med / 1e9:.3f} TFLOP/s; f32 bound "
                  f"{f32_bound[0]:.4f} ms ({f32_bound[1]}, {f32_bound[0] / med:.1%} of it); "
                  f"3xTF32 bound {tf32_bound[0]:.4f} ms ({tf32_bound[1]}, "
                  f"{tf32_bound[0] / med:.1%} of it)")
        del plain_out
    return out


# ---------------------------------------------------------------------------
# Phases 13-14: per-ray (N, S) depths, the stratified sampler's
# ---------------------------------------------------------------------------


def perray_configs(NeRFConfig):
    """Phase 13's MLPs: the narrow presets, a one- and a two-layer narrow
    MLP, the flagship and an f32 4x128 wide MLP."""
    f32 = NeRFConfig(num_layers=4, filter_size=128, num_samples=32)
    return {"small": NeRFConfig.small(), "single64": NeRFConfig.single_view_64(),
            "1x(33->4)": NeRFConfig(num_layers=1), "2x48": NeRFConfig(num_layers=2,
                                                                     filter_size=48),
            "full": NeRFConfig.full(), "4x128 f32": f32}


def either_grads_close(got, want, want64, what, cfg, rtol=GRAD_RTOL, atol_of=grad_atol):
    """``(worst |got - reference|, [(leaf, |got - f64|, |want - f64|), ...])``
    for phase 13, each leaf's reference being the one it is held to, the
    last two of the leaf's largest f64 entry, for each leaf held to the f64
    version.  Wide
    (``want64`` None): phase 7's bound against ``want`` (the wide plain
    version follows the kernels' rounding plan, in f32 only).  Narrow:
    ``rtol`` and ``atol_of`` (phase 4's bound by default) against the plain
    version in f32 (``want``) or, for a leaf that misses it, in f64 (the
    leaves ``want64()`` returns, computed once and only then).  Where a
    hidden pre-activation lies within f32 rounding of 0, two f32
    evaluations that sum in other orders can mask it apart and move that
    sample's whole term (the forward barely moves); this is the inferred
    cause of the misses at single64 on 1037 rays x 64 samples, where the
    kernel then agrees with the f64 version."""
    if want64 is None:
        return wide_grads_close(got, want, what, cfg), []
    worst, by64, leaves64 = 0.0, [], []
    for i, (g, w) in enumerate(zip(got, want)):
        if not torch.allclose(g, w, rtol=rtol, atol=atol_of(w)):
            if not leaves64:
                leaves64 = list(want64())
            w64 = leaves64[i].float()
            scale = w64.abs().max().item()
            by64.append((i, (g - w64).abs().max().item() / scale,
                         (w - w64).abs().max().item() / scale))
            w = w64
            torch.testing.assert_close(g, w, rtol=rtol, atol=atol_of(w),
                                       msg=lambda m, i=i: f"{what}, leaf {i} (against the "
                                       f"plain version in f32, then in f64): {m}")
        worst = max(worst, (g - w).abs().max().item())
    return worst, by64


def f64_note(kind, by64):
    """The phase-13 line's account of the leaves held to the f64 version:
    each one's max |kernel - f64| and |plain f32 - f64|, of the leaf's
    largest entry."""
    if not by64:
        return ""
    return (f"; {kind} leaves held to the plain version in f64 (leaf: |kernel-f64|, "
            f"|plain f32-f64| of its largest entry): "
            + ", ".join(f"{i}: {a:.2e}, {b:.2e}" for i, a, b in by64))


def stratified_depths(model, o, d, seed):
    """Per-bin jittered (N, S) depths and steps from ``NeRFModel.sample``
    with a CUDA generator."""
    _, t, dists = model.sample(o, d, generator=torch.Generator("cuda").manual_seed(seed))
    S = model.config.num_samples
    if t.shape != (o.shape[0], S) or dists.shape != t.shape or not t.is_cuda:
        raise AssertionError(f"sample gave depths {tuple(t.shape)} {t.device}")
    return t, dists


def phase_perray_kernels(fused_nerf, NeRFConfig, NeRFModel, seed=13):
    """Phase 13: the six ``*_rays`` entry points (#4-#6, #10-#12) against
    autograd of their plain versions on jittered (N, S) depths from
    ``NeRFModel.sample``, at every ``perray_configs`` MLP in both modes on
    1037 rays and on one ray: the colours, the train loss and dW/db, and
    the render backward's dW/db for a random colour cotangent, at phases 1,
    4 and 7's bounds; repeat launches bit-identical; (S,) depths broadcast
    to (N, S) through the ``*_rays`` kernels bit-identical to the
    shared-depth kernels.  A narrow dW/db leaf is held to the plain version
    in f32 or, if it misses that, in f64 (``either_grads_close``).
    Returns the worst |kernel - plain| per entry point, each leaf against
    the version it is held to."""
    rng = np.random.default_rng(seed)
    worst = dict.fromkeys(PERRAY, 0.0)
    reset_launches(fused_nerf)
    for name, base in perray_configs(NeRFConfig).items():
        for mode in ("loma", "standard"):
            cfg = dataclasses.replace(base, mode=mode)
            params = seeded_params(rng, cfg)
            leaves = leaves_of(params)
            model = NeRFModel(cfg)
            wide = fused_nerf._route(cfg, params)[0] == "wide"
            col_atol, loss_rtol, _ = wide_tolerances(cfg) if wide else (ATOL, 1e-5, None)
            pre = "nerf_wide_" if wide else "nerf_"
            for n in (N_CHECK, 1):
                o, d = seeded_rays(rng, n)
                t, dists = stratified_depths(model, o, d, int(rng.integers(1 << 30)))
                tgt = torch.tensor(rng.random((n, 3)), dtype=torch.float32, device="cuda")
                cot = torch.tensor(rng.standard_normal((n, 3)), dtype=torch.float32,
                                   device="cuda")

                def run(render, train, tv, dv, dt=torch.float32):
                    """(colours, (loss, *dW/db), render-backward dW/db) from
                    params and inputs in ``dt``."""
                    prm, lv = cast_params(params, leaves, dt)
                    o_, d_, tv, dv, tgt_, cot_ = (x.to(dt) for x in (o, d, tv, dv, tgt, cot))
                    with torch.no_grad():
                        col = render(prm, o_, d_, tv, dv, cfg)
                    loss = train(prm, o_, d_, tv, dv, tgt_, cfg)
                    k = (loss.detach(), *torch.autograd.grad(loss, lv))
                    b = torch.autograd.grad((render(prm, o_, d_, tv, dv, cfg) * cot_).sum(), lv)
                    return col, k, b

                kernel = (fused_nerf.render_rays, fused_nerf.nerf_train_loss)
                plain = (fused_nerf.render_rays_reference, fused_nerf.nerf_train_loss_reference)
                c1, k1, b1 = run(*kernel, t, dists)
                c2, k2, b2 = run(*kernel, t, dists)
                cp, kp, bp = run(*plain, t, dists)
                kp64 = bp64 = None  # the wide plain version: f32/bf16 rounding plan only
                if not wide:
                    kp64 = lambda: run(*plain, t, dists, torch.float64)[1][1:]
                    bp64 = lambda: run(*plain, t, dists, torch.float64)[2]
                torch.cuda.synchronize()
                what = f"{name} {cfg.compute_dtype} {mode} S={cfg.num_samples} N={n}"
                if not all(torch.equal(x, y) for x, y in zip((c1, *k1, *b1), (c2, *k2, *b2))):
                    raise AssertionError(f"{what}: repeat launches differ")
                e_fwd = (c1 - cp).abs().max().item()
                torch.testing.assert_close(c1, cp, atol=col_atol, rtol=RTOL)
                loss_err = abs(k1[0].item() - kp[0].item())
                torch.testing.assert_close(k1[0], kp[0], rtol=loss_rtol, atol=0.0)
                e_tr, f_tr = either_grads_close(k1[1:], kp[1:], kp64,
                                                f"{pre}train_rays {what}", cfg)
                e_bw, f_bw = either_grads_close(b1, bp, bp64, f"{pre}render_bwd_rays {what}",
                                                cfg)

                # broadcast (S,) depths: the *_rays kernels against the shared ones
                tu, du = uniform_depths(cfg)
                shared = run(*kernel, tu, du)
                bcast = run(*kernel, tu.expand(n, -1), du.expand(n, -1))
                torch.cuda.synchronize()
                shared, bcast = ((r[0], *r[1], *r[2]) for r in (shared, bcast))
                if not all(torch.equal(x, y) for x, y in zip(shared, bcast)):
                    diff = max((x - y).abs().max().item() for x, y in zip(shared, bcast))
                    raise AssertionError(f"{what}: broadcast depths through the *_rays "
                                         f"kernels differ from the shared-depth kernels "
                                         f"by {diff:.3e}")
                for k, e in (("render_fwd_rays", e_fwd), ("train_rays", max(e_tr, loss_err)),
                             ("render_bwd_rays", e_bw)):
                    worst[pre + k] = max(worst[pre + k], e)
                flips = f64_note("train", f_tr) + f64_note("render bwd", f_bw)
                print(f"phase 13 {what}: max|kernel-plain| render {e_fwd:.3e}; loss "
                      f"{k1[0].item():.6e} (|kernel-plain| {loss_err:.3e}); dW,db train "
                      f"{e_tr:.3e}, render bwd {e_bw:.3e}; repeats and broadcast (S,) "
                      f"depths vs the shared-depth kernels bit-identical{flips}")
    moved = {k: fused_nerf.launches[k] for k in PERRAY}
    if not all(moved.values()):
        raise AssertionError(f"phase 13: a per-ray kernel was not launched: {moved}")
    print(f"phase 13 per-ray launches: {moved}")
    return worst


def phase_perray_batches(fused_nerf, NeRFConfig, NeRFModel):
    """Phase 13 at the timed steps' batches: the six ``*_rays`` entry points
    on jittered depths from ``NeRFModel.sample`` and bench.py-style rays
    and targets, ``small`` at 262,144 rays, ``single64`` at 65,536 and
    ``full`` at 16,384, against autograd of their plain versions: the
    colours (phases 1/7's bounds), the train loss and dW/db, and the render
    backward's dW/db under the sum-MSE loss, as ``NeRFModel.loss`` runs it
    (``nerf_loss``: the render forward, then the render backward with the
    loss's colour cotangent), against the same plain gradient.  Narrow:
    phase 4's bench-batch bounds (loss rtol 1e-4; each leaf rtol 1e-3 with
    atol 1e-4 of the leaf's largest plain entry), a leaf that misses against
    the plain version in f32 held to it in f64 (``either_grads_close``);
    wide: phase 7's.  Phase 13's random colour cotangent stays at 1037
    rays: over millions of samples its random signs cancel each dW entry
    to a small part of its terms, and one sample whose hidden
    pre-activation lies within f32 rounding of 0, masked apart by two f32
    evaluations, moves an entry by that sample's whole term, more than a
    bound relative to the cancelled leaf allows.  Returns the worst
    |kernel - plain| per entry point."""
    worst = dict.fromkeys(PERRAY, 0.0)
    for name, n in (("small", BENCH_RAYS), ("single64", SINGLE64_RAYS),
                    ("full", FLAGSHIP_RAYS)):
        cfg = NeRFConfig.preset(name)
        params = seeded_params(np.random.default_rng(0), cfg)
        leaves = leaves_of(params)
        o, d, _, _, tgt = bench_batch(np.random.default_rng(0), cfg, n)
        t, dists = stratified_depths(NeRFModel(cfg), o, d, 21)
        wide = fused_nerf._route(cfg, params)[0] == "wide"
        col_atol, loss_rtol, _ = wide_tolerances(cfg) if wide else (ATOL, 1e-4, None)

        def loss_grads(loss_fn, dt=torch.float32):
            """(loss, *dW/db) of ``loss_fn`` on the batch, in ``dt``."""
            prm, lv = cast_params(params, leaves, dt)
            loss = loss_fn(prm, *(x.to(dt) for x in (o, d, t, dists, tgt)), cfg)
            return (loss.detach(), *torch.autograd.grad(loss, lv))

        with torch.no_grad():
            ck = fused_nerf.render_rays(params, o, d, t, dists, cfg)
            cp = fused_nerf.render_rays_reference(params, o, d, t, dists, cfg)
        kk = loss_grads(fused_nerf.nerf_train_loss)
        bk = loss_grads(fused_nerf.nerf_loss)
        kp = loss_grads(fused_nerf.nerf_train_loss_reference)
        kp64 = None
        if not wide:
            kp64 = lambda: loss_grads(fused_nerf.nerf_train_loss_reference, torch.float64)[1:]
        torch.cuda.synchronize()
        what = f"{name} at {n} rays x {cfg.num_samples} jittered samples"
        e_fwd = (ck - cp).abs().max().item()
        torch.testing.assert_close(ck, cp, atol=col_atol, rtol=RTOL)
        loss_err = abs(kk[0].item() - kp[0].item())
        torch.testing.assert_close(kk[0], kp[0], rtol=loss_rtol, atol=0.0)
        torch.testing.assert_close(bk[0], kp[0], rtol=loss_rtol, atol=0.0)
        bounds = (1e-3, lambda w: 1e-4 * w.abs().max().item())
        pre = "nerf_wide_" if wide else "nerf_"
        e_tr, f_tr = either_grads_close(kk[1:], kp[1:], kp64, f"{pre}train_rays, {what}",
                                        cfg, *bounds)
        e_bw, f_bw = either_grads_close(bk[1:], kp[1:], kp64,
                                        f"{pre}render_bwd_rays (loss cotangent), {what}", cfg,
                                        *bounds)
        rel = max(((a - b).abs().max() / b.abs().max()).item()
                  for a, b in zip((*kk[1:], *bk[1:]), (*kp[1:], *kp[1:])))
        for k, e in (("render_fwd_rays", e_fwd), ("train_rays", max(e_tr, loss_err)),
                     ("render_bwd_rays", e_bw)):
            worst[pre + k] = max(worst[pre + k], e)
        flips = f64_note("train", f_tr) + f64_note("render bwd", f_bw)
        print(f"phase 13 {what}: max|kernel-plain| render {e_fwd:.3e}; loss kernel "
              f"{kk[0].item():.6e} plain {kp[0].item():.6e}; max|dW,db kernel-plain| train "
              f"{e_tr:.3e}, render bwd under the loss {e_bw:.3e} (against the f32 plain "
              f"version, {rel:.3e} of the leaf's largest entry at most){flips}")
        del ck, cp, kk, bk, kp
    return worst


def phase_perray_wide_chunks(fused_nerf, NeRFConfig, NeRFModel, seed=17):
    """Phase 13, the wide chain's ray chunks (``Net::from_ray`` offsets the
    per-ray depths by each chunk's first ray): ``full()`` and the f32 4x128
    MLP on 1037 jittered rays, with ``wide_chunk_rays`` and
    ``wide_grad_chunk_rays`` cut so that one call walks many chunks.
    Render chunks of 100 rays with gradient chunks of 8192 / S rays (one
    split-K partial each, so the fixed-order sums add the same terms in the
    same order) are bit-identical to the one-chunk calls; gradient chunks
    of 300 rays (partials split at other rows) meet phase 7's bounds
    against the plain version."""
    rng = np.random.default_rng(seed)
    for cfg in (NeRFConfig.full(), NeRFConfig(num_layers=4, filter_size=128,
                                              num_samples=32)):
        params = seeded_params(rng, cfg)
        leaves = leaves_of(params)
        o, d = seeded_rays(rng, N_CHECK)
        t, dists = stratified_depths(NeRFModel(cfg), o, d, int(rng.integers(1 << 30)))
        tgt = torch.tensor(rng.random((N_CHECK, 3)), dtype=torch.float32, device="cuda")
        cot = torch.tensor(rng.standard_normal((N_CHECK, 3)), dtype=torch.float32,
                           device="cuda")

        def run(render, train):
            """(colours, loss, *dW/db, *render-backward dW/db)."""
            with torch.no_grad():
                col = render(params, o, d, t, dists, cfg)
            loss = train(params, o, d, t, dists, tgt, cfg)
            k = (loss.detach(), *torch.autograd.grad(loss, leaves))
            return (col, *k, *torch.autograd.grad(
                (render(params, o, d, t, dists, cfg) * cot).sum(), leaves))

        kernel = (fused_nerf.render_rays, fused_nerf.nerf_train_loss)
        whole = run(*kernel)
        aligned = fused_nerf.WIDE_ROW_CHUNK // cfg.num_samples
        saved = fused_nerf.wide_chunk_rays, fused_nerf.wide_grad_chunk_rays
        chunked = {}
        try:
            fused_nerf.wide_chunk_rays = lambda config, pw: 100
            for rays in (aligned, 300):
                fused_nerf.wide_grad_chunk_rays = lambda config, pw, L, r=rays: r
                chunked[rays] = run(*kernel)
        finally:
            fused_nerf.wide_chunk_rays, fused_nerf.wide_grad_chunk_rays = saved
        plain = run(fused_nerf.render_rays_reference, fused_nerf.nerf_train_loss_reference)
        torch.cuda.synchronize()
        what = (f"{cfg.num_layers}x{cfg.filter_size} {cfg.compute_dtype} S={cfg.num_samples} "
                f"N={N_CHECK}")
        if not all(torch.equal(x, y) for x, y in zip(whole, chunked[aligned])):
            diff = max((x - y).abs().max().item() for x, y in zip(whole, chunked[aligned]))
            raise AssertionError(f"{what}: render chunks of 100 rays and gradient chunks of "
                                 f"{aligned} differ from one chunk by {diff:.3e}")
        ragged = chunked[300]
        if not torch.equal(ragged[0], whole[0]):
            raise AssertionError(f"{what}: render chunks of 100 rays differ from one chunk")
        _, loss_rtol, _ = wide_tolerances(cfg)
        torch.testing.assert_close(ragged[1], plain[1], rtol=loss_rtol, atol=0.0)
        nl = len(leaves)  # (colours, loss, train dW/db, render-backward dW/db)
        e_tr = wide_grads_close(ragged[2:2 + nl], plain[2:2 + nl],
                                f"nerf_wide_train_rays, {what}, chunks of 300 rays", cfg)
        e_bw = wide_grads_close(ragged[2 + nl:], plain[2 + nl:],
                                f"nerf_wide_render_bwd_rays, {what}, chunks of 300 rays", cfg)
        print(f"phase 13 wide ray chunks, {what}: render chunks of 100 rays and gradient "
              f"chunks of {aligned} rays ({-(-N_CHECK // aligned)} chunks) bit-identical to "
              f"one chunk; gradient chunks of 300 rays vs plain: loss |kernel-plain| "
              f"{abs(ragged[1].item() - plain[1].item()):.3e}, max|dW,db kernel-plain| train "
              f"{e_tr:.3e}, render bwd {e_bw:.3e}")


def phase_stratified_steps(fused_nerf, NeRFConfig, NeRFModel,
                           make_single_chip_train_step, smi):
    """Phase 14, the timed steps: ``make_single_chip_train_step`` (Adam
    5e-4) at the bench's rungs, ``small`` 262,144 rays x 30, ``single64``
    65,536 x 64 and ``full`` 16,384 x 128, on bench.py-style numpy-seeded
    rays and targets (two batches cycled), in turns: per-ray jittered
    depths from ``NeRFModel.sample`` through the ``*_rays`` kernels, the
    same rays at (S,) shared depths through the shared-depth kernels, and
    the per-ray batch on the plain backend; each from the same init.  The
    depths are drawn before the timing (one ``sample`` call is timed on its
    own).  Returns ``{preset: per-ray train-kernel launches}``."""
    launches = {}
    for name, n, rounds in (("small", BENCH_RAYS, 5), ("single64", SINGLE64_RAYS, 3),
                            ("full", FLAGSHIP_RAYS, 2)):
        cfg = NeRFConfig.preset(name)
        rng = np.random.default_rng(0)
        sampler = NeRFModel(cfg)
        batches = {"perray": [], "shared": []}
        for i in range(2):
            o, d, t, dists, tgt = bench_batch(rng, cfg, n)
            batches["shared"].append((o, d, t, dists, tgt))
            batches["perray"].append((o, d, *stratified_depths(sampler, o, d, i), tgt))
        sample_ms, _ = cuda_ms(lambda: sampler.sample(
            o, d, generator=torch.Generator("cuda").manual_seed(9)))
        steps, losses, calls = {}, {}, {}
        for kind, backend in (("perray", "auto"), ("shared", "auto"), ("plain", "plain")):
            model = NeRFModel(cfg)
            model.init(torch.Generator().manual_seed(0))
            opt = torch.optim.Adam(model.parameters(), lr=5e-4)
            steps[kind] = (model, make_single_chip_train_step(cfg, opt, backend),
                           batches["shared" if kind == "shared" else "perray"])
            losses[kind], calls[kind] = [], 0

        def run(kind):
            model, step, bs = steps[kind]
            loss = step(model, *bs[calls[kind] % 2])
            calls[kind] += 1
            losses[kind].append(loss)

        for kind in steps:  # warm-up
            run(kind)
        reset_launches(fused_nerf)
        times = timed_turns({k: (lambda k=k: run(k)) for k in steps}, rounds)
        train = ("nerf_wide_train" if cfg.filter_size > 64 else "nerf_train") + "_rays"
        launches[name] = fused_nerf.launches[train]
        if launches[name] != 2 * rounds or fused_nerf.launches[train[:-5]] != 2 * rounds:
            raise AssertionError(f"{name}: launches {dict(fused_nerf.launches)} in "
                                 f"{2 * rounds} steps per backend")
        lv = {k: [x.item() for x in v] for k, v in losses.items()}
        if not all(np.all(np.isfinite(v)) for v in lv.values()):
            raise AssertionError(f"non-finite loss in the {name} stratified step: {lv}")
        rel = abs(lv["perray"][0] - lv["plain"][0]) / lv["plain"][0]
        # the first step's loss against the kernels' plain version (for full,
        # its bf16 rounding plan; the plain backend runs the f32 pipeline)
        init = NeRFModel(cfg)
        init.init(torch.Generator().manual_seed(0))
        with torch.no_grad():
            want = fused_nerf.nerf_train_loss_reference(init.params, *batches["perray"][0],
                                                        cfg).item()
        loss_rtol = wide_tolerances(cfg)[1] if cfg.filter_size > 64 else 1e-4
        ref_rel = abs(lv["perray"][0] - want) / want
        if ref_rel > loss_rtol:
            raise AssertionError(f"{name}: first-step loss {lv['perray'][0]} against the "
                                 f"plain version's {want}: rel {ref_rel:.2e} > {loss_rtol}")
        med = {k: statistics.median(v) for k, v in times.items()}
        print(f"phase 14 train step, {name}, {n} rays x {cfg.num_samples} samples, Adam "
              f"5e-4, on {smi} (first-step loss per-ray kernel {lv['perray'][0]:.6e}, plain "
              f"version {want:.6e}, rel diff {ref_rel:.2e} (bound {loss_rtol}); plain "
              f"backend {lv['plain'][0]:.6e}, rel diff {rel:.2e}; one NeRFModel.sample of "
              f"the batch {sample_ms:.3f} ms, not in the step):")
        for kind, label in (("perray", "per-ray (N, S), *_rays kernel"),
                            ("shared", "shared (S,), shared-depth kernel"),
                            ("plain", "per-ray (N, S), plain backend")):
            print(f"  {label}: {spread(times[kind])}/step, {n / med[kind] * 1e3:.4e} rays/s")
        print(f"  per-ray / shared = {med['perray'] / med['shared']:.4f}")
    return launches


def stratified_run(fused_nerf, NeRFModel, NeRFConfig, make_single_chip_train_step,
                   synthetic_views, normalized_intrinsics, psnr, rays, preset, n_steps,
                   eval_every):
    """A training loop on stratified depths, as ``train_nerf.main`` runs one
    (16 in-memory 64x64 synthetic views, 4096 rays per step drawn from
    ``default_rng(215)``, Adam 5e-4, torch seed 215), with fresh per-bin
    jittered (N, S) depths from ``NeRFModel.sample`` every step; the eval
    view rendered unjittered (``render_image``) every ``eval_every`` steps
    and after the last.  Returns ``(losses, {step: PSNR dB}, seconds)``."""
    images, poses, focal = synthetic_views(16, 64, device="cuda")
    K = normalized_intrinsics(focal, device="cuda")
    all_rays = [rays.get_rays(64, 64, K, p) for p in poses]
    all_o = torch.stack([o for o, _ in all_rays])
    all_d = torch.stack([d for _, d in all_rays])
    all_t = images.reshape(16, -1, 3)
    model = NeRFModel(NeRFConfig.preset(preset))
    model.init(torch.Generator().manual_seed(215))
    step = make_single_chip_train_step(model.config,
                                       torch.optim.Adam(model.parameters(), lr=5e-4))
    rng = np.random.default_rng(215)
    gen = torch.Generator("cuda").manual_seed(215)
    losses, curve = [], {}

    def evaluate(i):
        with torch.no_grad():
            curve[i] = psnr(images[2], model.render_image(K, poses[2], 64)).item()

    t0 = time.perf_counter()
    for i in range(n_steps):
        v = int(rng.integers(16))
        idx = torch.from_numpy(rng.integers(64 * 64, size=4096)).cuda()
        o, d = all_o[v, idx], all_d[v, idx]
        _, t, dists = model.sample(o, d, generator=gen)
        losses.append(float(step(model, o, d, t, dists, all_t[v, idx])))
        if i % eval_every == 0:
            evaluate(i)
    evaluate(n_steps)
    return losses, curve, time.perf_counter() - t0


def phase_stratified_paths(fused_nerf, NeRFConfig, NeRFModel, make_single_chip_train_step,
                           synthetic_views, normalized_intrinsics, psnr, rays):
    """Phase 14, the main paths on per-ray depths (every count reset just
    before its path, read just after): 500 ``small`` steps of
    ``stratified_run`` (one ``nerf_train_rays`` launch per step; eval PSNR
    >= 19 dB and 8 dB above step 0, phase 5's floors); 30 ``full`` steps
    (one ``nerf_wide_train_rays`` launch per step, the loss falling); 10
    Adam steps on ``NeRFModel.loss`` for ``small`` and for ``full`` over
    one view's 4096 rays at jittered depths (the ``*_rays`` render forward
    and backward, the loss falling).  Returns each per-ray kernel's
    launches on these paths."""
    args = (fused_nerf, NeRFModel, NeRFConfig, make_single_chip_train_step,
            synthetic_views, normalized_intrinsics, psnr, rays)
    launches = {}
    reset_launches(fused_nerf)
    losses, curve, secs = stratified_run(*args, "small", STRAT_STEPS, 250)
    launches["nerf_train_rays"] = fused_nerf.launches["nerf_train_rays"]
    print(f"phase 14 stratified small run: {STRAT_STEPS} steps x 4096 rays in {secs:.2f} s "
          f"host time (evals included); launches {dict(fused_nerf.launches)}; final loss "
          f"{losses[-1]:.4f}; eval PSNR dB (unjittered render): "
          + ", ".join(f"step {k}: {v:.2f}" for k, v in sorted(curve.items())))
    if launches["nerf_train_rays"] != STRAT_STEPS or not np.all(np.isfinite(losses)):
        raise AssertionError(f"stratified run: {launches} launches in {STRAT_STEPS} steps")
    if curve[STRAT_STEPS] < PSNR_FLOOR_DB or curve[STRAT_STEPS] < curve[0] + PSNR_GAIN_DB:
        raise AssertionError(f"stratified PSNR {curve}: need >= {PSNR_FLOOR_DB} dB and "
                             f"{PSNR_GAIN_DB} dB above step 0")

    reset_launches(fused_nerf)
    losses, curve, secs = stratified_run(*args, "full", STRAT_FULL_STEPS, STRAT_FULL_STEPS)
    launches["nerf_wide_train_rays"] = fused_nerf.launches["nerf_wide_train_rays"]
    head, tail = np.mean(losses[:5]), np.mean(losses[-5:])
    print(f"phase 14 stratified full run: {STRAT_FULL_STEPS} steps x 4096 rays in "
          f"{secs:.2f} s host time; launches {dict(fused_nerf.launches)}; mean loss of the "
          f"first 5 steps {head:.4f}, last 5 {tail:.4f}; eval PSNR dB "
          + ", ".join(f"step {k}: {v:.2f}" for k, v in sorted(curve.items())))
    if launches["nerf_wide_train_rays"] != STRAT_FULL_STEPS or not tail < head:
        raise AssertionError(f"stratified full run: launches {launches}, loss {head} -> {tail}")

    images, poses, focal = synthetic_views(16, 64, device="cuda")
    o, d = rays.get_rays(64, 64, normalized_intrinsics(focal, device="cuda"), poses[2])
    for preset in ("small", "full"):
        model = NeRFModel(NeRFConfig.preset(preset))
        model.init(torch.Generator().manual_seed(0))
        opt = torch.optim.Adam(model.parameters(), lr=5e-4)
        gen = torch.Generator("cuda").manual_seed(1)
        losses = []
        reset_launches(fused_nerf)
        for _ in range(10):
            _, t, dists = model.sample(o, d, generator=gen)
            opt.zero_grad(set_to_none=True)
            loss = model.loss(o, d, t, dists, images[2].reshape(-1, 3))
            loss.backward()
            opt.step()
            losses.append(loss.item())
        pre = "nerf_wide_" if preset == "full" else "nerf_"
        for k in ("render_fwd_rays", "render_bwd_rays"):
            launches[pre + k] = fused_nerf.launches[pre + k]
        if launches[pre + "render_bwd_rays"] != 10 or launches[pre + "render_fwd_rays"] != 10 \
                or not np.all(np.isfinite(losses)) or losses[-1] >= losses[0]:
            raise AssertionError(f"{preset} NeRFModel.loss on per-ray depths: launches "
                                 f"{dict(fused_nerf.launches)}, losses {losses}")
        print(f"phase 14 NeRFModel.loss ({preset}) on jittered depths: 10 steps, loss "
              f"{losses[0]:.3f} -> {losses[-1]:.3f}; launches {dict(fused_nerf.launches)}")
    return launches


def perray_bound(cfg, n, mlp_layer_sizes, kind):
    """bound() of one per-ray kernel call on ``n`` rays: the forward's MACs
    (``kind`` "fwd") or the gradient kernels' (forward again, dW, d_h) per
    sample, at the f32 peak (narrow) or the bf16 peak (the flagship); bytes:
    origins, directions and targets (or colours, or the cotangent) per ray,
    and the (N, S) f32 depths and steps."""
    fwd, bwd = mlp_macs(mlp_layer_sizes(cfg.in_channels, cfg.out_channels,
                                        cfg.num_layers, cfg.filter_size))
    peak = PEAK_BF16 if cfg.compute_dtype == "bfloat16" else PEAK_F32
    S = cfg.num_samples
    return bound(n * S * (fwd if kind == "fwd" else bwd), peak, n * (36 + 8 * S))


def phase_perray_kernel_timing(fused_nerf, NeRFConfig, NeRFModel, mlp_layer_sizes, smi):
    """Phase 14, each per-ray kernel's own call: at the ``small`` bench batch
    (262,144 rays, narrow) and the flagship batch (16,384 rays, wide), on
    jittered depths, in turns with the shared-depth kernel on the same rays
    at (S,) depths and with the plain version of the same work (CUDA events,
    median).  Returns ``{kernel: (ms, plain_ms, bound_ms, bound_by)}``."""
    out = {}
    for preset, n, width, rounds in (("small", BENCH_RAYS, 32, 3),
                                     ("full", FLAGSHIP_RAYS, 256, 2)):
        cfg = NeRFConfig.preset(preset)
        params = seeded_params(np.random.default_rng(0), cfg)
        lv = leaves_of(params)
        o, d, tu, du, tgt = bench_batch(np.random.default_rng(0), cfg, n)
        t, dists = stratified_depths(NeRFModel(cfg), o, d, 3)
        cot = torch.tensor(np.random.default_rng(1).standard_normal((n, 3)),
                           dtype=torch.float32, device="cuda")
        plain_out = fused_nerf.render_rays_reference(params, o, d, t, dists, cfg)
        if preset == "small":
            L, G = cfg.num_layers, fused_nerf.grad_floats(params, width)
            pk_r = fused_nerf.pack_params(params, t, dists, width)
            pk_s = fused_nerf.pack_params(params, tu, du, width)
            calls = {
                "nerf_render_fwd_rays": (
                    lambda: fused_nerf._launch(pk_r, t, dists, o, d, cfg, L, width),
                    lambda: fused_nerf._launch(pk_s, tu, du, o, d, cfg, L, width)),
                "nerf_train_rays": (
                    lambda: fused_nerf._launch_grad("nerf_train", pk_r, G, t, dists, o, d,
                                                    tgt, cfg, L, width),
                    lambda: fused_nerf._launch_grad("nerf_train", pk_s, G, tu, du, o, d, tgt,
                                                    cfg, L, width)),
                "nerf_render_bwd_rays": (
                    lambda: fused_nerf._launch_grad("nerf_render_bwd", pk_r, G, t, dists, o,
                                                    d, cot, cfg, L, width),
                    lambda: fused_nerf._launch_grad("nerf_render_bwd", pk_s, G, tu, du, o, d,
                                                    cot, cfg, L, width)),
            }
        else:
            W, b = fused_nerf.pack_wide_params(params, width, cfg.compute_dtype)
            calls = {
                "nerf_wide_render_fwd_rays": (
                    lambda: fused_nerf._launch_wide_render(W, b, t, dists, o, d, cfg),
                    lambda: fused_nerf._launch_wide_render(W, b, tu, du, o, d, cfg)),
                "nerf_wide_train_rays": (
                    lambda: fused_nerf._launch_wide_grad("nerf_wide_train", W, b, t, dists,
                                                         o, d, tgt, cfg),
                    lambda: fused_nerf._launch_wide_grad("nerf_wide_train", W, b, tu, du,
                                                         o, d, tgt, cfg)),
                "nerf_wide_render_bwd_rays": (
                    lambda: fused_nerf._launch_wide_grad("nerf_wide_render_bwd", W, b, t,
                                                         dists, o, d, cot, cfg),
                    lambda: fused_nerf._launch_wide_grad("nerf_wide_render_bwd", W, b, tu,
                                                         du, o, d, cot, cfg)),
            }
        plains = {
            "render_fwd": lambda: fused_nerf.render_rays_reference(params, o, d, t, dists, cfg),
            "train": lambda: torch.autograd.grad(fused_nerf.nerf_train_loss_reference(
                params, o, d, t, dists, tgt, cfg), lv),
            "render_bwd": lambda: torch.autograd.grad(plain_out, lv, cot, retain_graph=True),
        }
        for name, (per_ray, shared) in calls.items():
            kind = name.split("nerf_")[-1].replace("wide_", "")[:-5]
            plain = plains[kind]
            with torch.no_grad() if kind == "render_fwd" else contextlib.nullcontext():
                per_ray(), shared(), plain()  # warm-up
                ts = timed_turns({"per-ray": per_ray, "shared": shared, "plain": plain},
                                 rounds)
            med = {k: statistics.median(v) for k, v in ts.items()}
            kb = perray_bound(cfg, n, mlp_layer_sizes, "fwd" if kind == "render_fwd" else "grad")
            out[name] = (med["per-ray"], med["plain"], *kb)
            print(f"phase 14 {name} alone, {preset}, {n} rays x {cfg.num_samples} samples, on "
                  f"{smi}: per-ray {spread(ts['per-ray'])}, shared-depth kernel "
                  f"{spread(ts['shared'])} (per-ray / shared {med['per-ray'] / med['shared']:.4f})"
                  f", plain {spread(ts['plain'])}"
                  + (" (backward pass only)" if kind == "render_bwd" else "")
                  + f"; bound {kb[0]:.4f} ms ({kb[1]}), {kb[0] / med['per-ray']:.1%} of it")
        del plain_out
    return out


def nerf_bounds(NeRFConfig, mlp_layer_sizes):
    """bound() of each NeRF kernel's timed work: #1 an 800x800 ``small``
    frame, #2 and #3 a 262,144-ray ``small`` call (f32 peak); #8 an 800x800
    ``full`` frame, #7 the 16,384-ray flagship step, #9 a 16,384-ray call
    (bf16 peak).  A ray reads 24 B and writes 12 B (train: the target
    instead of the colour)."""
    out = {}
    for cfg, n_grad, names, peak in (
            (NeRFConfig.small(), BENCH_RAYS,
             ("nerf_render_fwd", "nerf_train", "nerf_render_bwd"), PEAK_F32),
            (NeRFConfig.full(), FLAGSHIP_RAYS,
             ("nerf_wide_render_fwd", "nerf_wide_train", "nerf_wide_render_bwd"), PEAK_BF16)):
        fwd, bwd = mlp_macs(mlp_layer_sizes(cfg.in_channels, cfg.out_channels,
                                            cfg.num_layers, cfg.filter_size))
        n_frame, S = SERVE_SIZE * SERVE_SIZE, cfg.num_samples
        render, train, back = names
        out[render] = bound(n_frame * S * fwd, peak, n_frame * 36)
        out[train] = out[back] = bound(n_grad * S * bwd, peak, n_grad * 36)
    return out


# ---------------------------------------------------------------------------
# Phases 15-19: narrow MLPs past shared memory on the wide kernels, the
# video path, the ReLU-mask flips, the segmented scans (#15) with the
# kernels' output digests, and the grid-overhead probe (#16)
# ---------------------------------------------------------------------------


def wide_route_configs(NeRFConfig):
    """Narrow MLPs (padded width 64) whose 64-ray block of the narrow
    gradient kernels exceeds a block's shared memory at S = 64: ``_route``
    sends them to the wide kernels at pw = 128 in f32."""
    return {f"{L}x64": NeRFConfig(num_layers=L, filter_size=64, num_samples=64)
            for L in (5, 8)}


def phase_wide_route(fused_nerf, NeRFConfig, seed=19):
    """Phase 15: 5x64 and 8x64 at S = 64 through ``_route``'s wide route
    (``("wide", 128)``, f32), on 1037 rays and on a 65,536-ray batch: the
    colours, the train loss and dW/db and the render backward against their
    plain versions, at phase 4's bounds (1037 rays: a random colour
    cotangent; the batch: phase 4's bench-batch bounds, the render backward
    under the sum-MSE loss as ``NeRFModel.loss`` runs it), a leaf that
    misses against the plain version in f32 held to it in f64
    (``either_grads_close``).  Every launch must be a wide one.  Returns the
    worst |kernel - plain| per wide entry point."""
    rng = np.random.default_rng(seed)
    worst = dict.fromkeys(WIDE, 0.0)
    reset_launches(fused_nerf)
    for name, cfg in wide_route_configs(NeRFConfig).items():
        params = seeded_params(rng, cfg)
        leaves = leaves_of(params)
        route = fused_nerf._route(cfg, params)
        if route != ("wide", 128):
            raise AssertionError(f"{name} at S={cfg.num_samples}: route {route}")
        for n in (N_CHECK, SINGLE64_RAYS):
            o, d, t, dists, tgt = bench_batch(rng, cfg, n)
            cot = torch.tensor(rng.standard_normal((n, 3)), dtype=torch.float32,
                               device="cuda")

            def loss_grads(fn, dt=torch.float32):
                prm, lv = cast_params(params, leaves, dt)
                loss = fn(prm, *(x.to(dt) for x in (o, d, t, dists, tgt)), cfg)
                return (loss.detach(), *torch.autograd.grad(loss, lv))

            def render_grads(fn, dt=torch.float32):
                prm, lv = cast_params(params, leaves, dt)
                out = fn(prm, *(x.to(dt) for x in (o, d, t, dists)), cfg)
                return torch.autograd.grad((out * cot.to(dt)).sum(), lv)

            plain = fused_nerf.nerf_train_loss_reference
            with torch.no_grad():
                ck = fused_nerf.render_rays(params, o, d, t, dists, cfg)
                cp = fused_nerf.render_rays_reference(params, o, d, t, dists, cfg)
            kk, kp = loss_grads(fused_nerf.nerf_train_loss), loss_grads(plain)
            kp64 = lambda: loss_grads(plain, torch.float64)[1:]
            if n == N_CHECK:
                bk, bp = render_grads(fused_nerf.render_rays), \
                    render_grads(fused_nerf.render_rays_reference)
                bp64 = lambda: render_grads(fused_nerf.render_rays_reference, torch.float64)
                bounds, loss_rtol, under = (GRAD_RTOL, grad_atol), 1e-5, "a random cotangent"
            else:
                bk, bp, bp64 = loss_grads(fused_nerf.nerf_loss)[1:], kp[1:], kp64
                bounds = (1e-3, lambda w: 1e-4 * w.abs().max().item())
                loss_rtol, under = 1e-4, "the sum-MSE loss"
            torch.cuda.synchronize()
            what = f"{name} S={cfg.num_samples} N={n}"
            e_fwd = (ck - cp).abs().max().item()
            torch.testing.assert_close(ck, cp, atol=ATOL, rtol=RTOL)
            loss_err = abs(kk[0].item() - kp[0].item())
            torch.testing.assert_close(kk[0], kp[0], rtol=loss_rtol, atol=0.0)
            e_tr, f_tr = either_grads_close(kk[1:], kp[1:], kp64,
                                            f"nerf_wide_train {what}", cfg, *bounds)
            e_bw, f_bw = either_grads_close(bk, bp, bp64, f"nerf_wide_render_bwd {what}",
                                            cfg, *bounds)
            for k, e in (("nerf_wide_render_fwd", e_fwd), ("nerf_wide_train",
                                                           max(e_tr, loss_err)),
                         ("nerf_wide_render_bwd", e_bw)):
                worst[k] = max(worst[k], e)
            print(f"phase 15 {what} on the wide route {route}: max|kernel-plain| render "
                  f"{e_fwd:.3e}; loss {kk[0].item():.6e} (|kernel-plain| {loss_err:.3e}); "
                  f"dW,db train {e_tr:.3e}, render bwd under {under} {e_bw:.3e}"
                  + f64_note("train", f_tr) + f64_note("render bwd", f_bw))
            del kk, kp, bk, bp
    moved = {k: v for k, v in fused_nerf.launches.items() if v}
    if not all(moved.get(k) for k in WIDE) or set(moved) - set(WIDE):
        raise AssertionError(f"phase 15: launches {dict(fused_nerf.launches)}: need the "
                             "three wide entry points and no other")
    print(f"phase 15 launches: {moved}")
    return worst


@contextlib.contextmanager
def forced_wide(fused_nerf):
    """Within the block, ``_route`` sends every MLP to the wide kernels at
    pw = 128 (a patch of the module's private function, for timing only)."""
    saved = fused_nerf._route
    fused_nerf._route = lambda config, params: ("wide", 128)
    try:
        yield
    finally:
        fused_nerf._route = saved


def phase_single64_wide(fused_nerf, NeRFConfig, NeRFModel, make_single_chip_train_step,
                        smi):
    """Phase 15, timing: the ``single64`` train step (65,536 rays x 64, Adam
    5e-4, bench.py-style batches, two cycled) on its narrow kernel and
    forced through the wide f32 route (:func:`forced_wide`), from one init,
    in turns.  ``single64`` keeps its narrow route; the ratio is recorded
    for the kernels' redesign.  Returns ``(narrow ms, wide ms)``."""
    cfg = NeRFConfig.single_view_64()
    rng = np.random.default_rng(0)
    batches = [bench_batch(rng, cfg, SINGLE64_RAYS) for _ in range(2)]
    steps = {}
    for kind in ("narrow", "wide"):
        model = NeRFModel(cfg)
        model.init(torch.Generator().manual_seed(0))
        opt = torch.optim.Adam(model.parameters(), lr=5e-4)
        steps[kind] = (model, make_single_chip_train_step(cfg, opt), [0], [])

    def run(kind):
        model, step, calls, losses = steps[kind]
        with forced_wide(fused_nerf) if kind == "wide" else contextlib.nullcontext():
            losses.append(step(model, *batches[calls[0] % 2]))
        calls[0] += 1

    run("narrow"), run("wide")  # warm-up
    reset_launches(fused_nerf)
    times = timed_turns({"narrow": lambda: run("narrow"), "wide": lambda: run("wide")}, 3)
    if fused_nerf.launches["nerf_train"] != 6 or fused_nerf.launches["nerf_wide_train"] != 6:
        raise AssertionError(f"single64 narrow / wide steps: launches {fused_nerf.launches}")
    first = {k: steps[k][3][0].item() for k in steps}
    if not all(np.isfinite([x.item() for k in steps for x in steps[k][3]])):
        raise AssertionError("non-finite loss in the single64 steps")
    med = {k: statistics.median(v) for k, v in times.items()}
    print(f"phase 15 single64 train step, {SINGLE64_RAYS} rays x 64 samples, Adam 5e-4, on "
          f"{smi} (first-step loss narrow {first['narrow']:.6e}, wide f32 "
          f"{first['wide']:.6e}): narrow kernel {spread(times['narrow'])}/step, forced "
          f"through the wide f32 route (pw 128) {spread(times['wide'])}/step; wide / narrow "
          f"= {med['wide'] / med['narrow']:.4f}")
    return med["narrow"], med["wide"]


def phase_video(make_video, read_png, write_png, render_orbit, NeRFModel, NeRFConfig,
                load_params_npz, fused_nerf, tmp):
    """Phase 16: ``make_video.main`` end to end on the card: ``--params``
    with the trained fixture, 4 frames at 128x128 (through the render
    kernel), then ``--frames`` on numbered PNGs of those frames (the ones
    it wrote where imageio is missing, else written here).  Returns the
    render kernel's launches."""
    import importlib.util

    have = {m: importlib.util.find_spec(m) is not None for m in ("PIL", "imageio")}
    print(f"phase 16 on this machine: PIL importable {have['PIL']}, imageio importable "
          f"{have['imageio']}")
    reset_launches(fused_nerf)
    out = os.path.join(tmp, "orbit.mp4")
    wrote = make_video.main(["--params", FIXTURE, "--preset", "small", "--orbit", "4",
                             "--img-size", "128", "--out", out])
    n = fused_nerf.launches["nerf_render_fwd"]
    if n < 4 or not os.path.exists(wrote):
        raise AssertionError(f"make_video --params: {n} render launches, wrote {wrote}")
    if os.path.isdir(wrote):
        frames_dir = wrote
    else:
        p = load_params_npz(FIXTURE)
        model = NeRFModel.from_numpy(NeRFConfig.small(), p["w"], p["b"], device="cuda")
        frames_dir = os.path.join(tmp, "frames")
        for i, frame in enumerate(render_orbit(model, 1.1106, 4.0, 4, 128)):
            write_png(os.path.join(frames_dir, f"{i}.png"), frame)
    frames = np.stack([read_png(os.path.join(frames_dir, f))
                       for f in sorted(os.listdir(frames_dir))])
    if frames.shape != (4, 128, 128, 3) or frames.std() < 1.0:
        raise AssertionError(f"frames {frames.shape}, std {frames.std():.2f}")
    again = make_video.main(["--frames", frames_dir, "--out", os.path.join(tmp, "again.mp4")])
    if os.path.isdir(again):
        back = np.stack([read_png(os.path.join(again, f)) for f in sorted(os.listdir(again))])
        if not np.array_equal(back, frames):
            raise AssertionError("make_video --frames changed the frames")
    elif os.path.getsize(again) == 0:
        raise AssertionError(f"make_video --frames wrote an empty {again}")
    print(f"phase 16 make_video --params (4 frames at 128x128, {n} render launches) wrote "
          f"{os.path.relpath(wrote, tmp)}; --frames on {len(frames)} PNGs wrote "
          f"{os.path.relpath(again, tmp)}")
    return n


def pre_activations(params, o, d, t, nf, dt):
    """Each hidden layer's pre-activation z = h W + b of one ray's samples
    (``(S, width)`` per layer) in ``dt``, as the plain version computes
    them."""
    from lomanerf_tpu_torch.core import positional_encoding

    prm = {k: [x.detach().to(dt) for x in v] for k, v in params.items()}
    pts = o.to(dt)[None, :] + d.to(dt)[None, :] * t.to(dt)[:, None]
    h = positional_encoding(pts, nf)
    zs = []
    for w, b in zip(prm["w"][:-1], prm["b"][:-1]):
        z = h @ w + b
        zs.append(z)
        h = torch.relu(z)
    return zs


MASK_CHUNK, MASK_MAX_RAYS = 1024, 40  # bisection's first chunks; rays listed at most


def phase_mask_flips(fused_nerf, NeRFConfig, NeRFModel):
    """Phase 17 (a diagnostic: it gates nothing but running to its end): at
    phase 13's ``small`` batch (262,144 rays, its params and jittered
    depths) and at the same rays' uniform (S,) depths, the rays whose
    render-backward dW/db under a random colour cotangent differs from the
    plain version in f64 by more than phase 4's bound, through the kernel
    or through the plain version in f32, found by bisecting ray chunks by
    kernel launches (1,024-ray chunks, then halves).  For each ray (the
    first 40 listed): both distances to f64, and the samples whose hidden
    pre-activation lies within 1e-5 of the layer's |z| scale (its largest
    |z| over the ray's samples, f64) of 0, with its value in the plain
    version in f32 and in f64.  Returns ``{depths: counts}``."""
    cfg = NeRFConfig.small()
    params = seeded_params(np.random.default_rng(0), cfg)
    leaves = leaves_of(params)
    o, d, tu, du, _ = bench_batch(np.random.default_rng(0), cfg, BENCH_RAYS)
    tj, dj = stratified_depths(NeRFModel(cfg), o, d, 21)
    cot = torch.tensor(np.random.default_rng(1).standard_normal((BENCH_RAYS, 3)),
                       dtype=torch.float32, device="cuda")
    nf = cfg.num_encoding_functions

    def grads(fn, lo, hi, t, dists, dt=torch.float32):
        prm, lv = cast_params(params, leaves, dt)
        tt, dd = (t, dists) if t.ndim == 1 else (t[lo:hi], dists[lo:hi])
        out = fn(prm, *(x.to(dt) for x in (o[lo:hi], d[lo:hi], tt, dd)), cfg)
        return torch.autograd.grad((out * cot[lo:hi].to(dt)).sum(), lv)

    def misses(got, want):
        return any(((g.double() - w).abs() > GRAD_RTOL * w.abs()
                    + GRAD_ATOL * max(1.0, w.abs().max().item())).any().item()
                   for g, w in zip(got, want))

    def far(got, want):
        """max over leaves of |got - want| / max|want|."""
        return max(((g.double() - w).abs().max() / w.abs().max().clamp(min=1e-300)).item()
                   for g, w in zip(got, want))

    counts = {}
    for label, t, dists in (("jittered", tj, dj), ("uniform", tu, du)):
        checks, flagged = 0, []
        todo = [(lo, min(lo + MASK_CHUNK, BENCH_RAYS))
                for lo in range(0, BENCH_RAYS, MASK_CHUNK)]
        while todo:
            lo, hi = todo.pop()
            k = grads(fused_nerf.render_rays, lo, hi, t, dists)
            w32 = grads(fused_nerf.render_rays_reference, lo, hi, t, dists)
            w64 = grads(fused_nerf.render_rays_reference, lo, hi, t, dists, torch.float64)
            checks += 1
            miss_k, miss_32 = misses(k, w64), misses(w32, w64)
            if not (miss_k or miss_32):
                continue
            if hi - lo == 1:
                flagged.append((lo, miss_k, miss_32, far(k, w64), far(w32, w64)))
            else:
                mid = (lo + hi) // 2
                todo += [(mid, hi), (lo, mid)]
        flagged.sort()
        near_total = apart = 0
        for i, (ray, miss_k, miss_32, dk, d32) in enumerate(flagged):
            tr = t if t.ndim == 1 else t[ray]
            z32 = pre_activations(params, o[ray], d[ray], tr, nf, torch.float32)
            z64 = pre_activations(params, o[ray], d[ray], tr, nf, torch.float64)
            near = []
            for layer, (a, b) in enumerate(zip(z32, z64)):
                scale = b.abs().max().item()
                for s, j in torch.nonzero(b.abs() <= 1e-5 * scale).tolist():
                    near.append((s, layer, j, a[s, j].item(), b[s, j].item()))
            near_total += len(near)
            apart += sum((a > 0) != (b > 0) for *_, a, b in near)
            if i < MASK_MAX_RAYS:
                who = "kernel and plain f32" if miss_k and miss_32 else (
                    "kernel" if miss_k else "plain f32")
                print(f"phase 17 {label} ray {ray}: {who} off f64; |kernel-f64| {dk:.2e}, "
                      f"|plain f32-f64| {d32:.2e} of the leaf's largest entry; hidden "
                      f"pre-activations within 1e-5 of the layer's scale of 0 (sample, "
                      f"layer, unit, f32, f64): "
                      + (", ".join(f"({s}, {layer}, {j}, {a:+.3e}, {b:+.3e})"
                                   for s, layer, j, a, b in near) or "none"))
        n_k = sum(f[1] for f in flagged)
        n_32 = sum(f[2] for f in flagged)
        counts[label] = {"kernel_off_f64": n_k, "plain_f32_off_f64": n_32,
                         "near_zero": near_total, "signs_apart_f32_f64": apart,
                         "checks": checks}
        print(f"phase 17 {label} depths, {BENCH_RAYS} rays ({checks} chunk checks): dW/db off "
              f"the f64 plain version by more than phase 4's bound on {n_k} rays through the "
              f"kernel, on {n_32} through the plain version in f32; {near_total} near-zero "
              f"hidden pre-activations on those rays, {apart} with f32 and f64 signs apart")
    return counts


SCAN_TINY = float(np.finfo(np.float32).tiny)  # smallest normal f32, 1.2e-38
SCAN_RTOL = 1e-5  # test_pallas_kernels.py:57-66's bound


def scan_inputs(rng, R, S, kind):
    """An f32 column of R segments of S: uniform [0.5, 1.5) (the JAX test),
    or in [1e-10, 1] (``10^(-10 u^6)``: mostly near 1, about one value in
    nine below 1e-5, as c = exp(-sigma dist) + 1e-10 runs)."""
    u = rng.random((R, S))
    x = u + 0.5 if kind == "unit" else 10.0 ** (-10.0 * u ** 6)
    return x.astype(np.float32)


def scan_wants(x, fill):
    """numpy f64 versions of the three scans of an (R, S) f32 array."""
    x64 = x.astype(np.float64)
    return {"cumprod": np.cumprod(x64, axis=1),
            "suffix": np.cumsum(x64[:, ::-1], axis=1)[:, ::-1],
            "shift": np.concatenate([np.full((x.shape[0], 1), fill), x64[:, :-1]], axis=1)}


def scan_close(got, want, what):
    """Relative error of ``got`` against ``want`` where ``want`` is a normal
    f32 (both at most 1.2e-38 elsewhere: a product that underflows);
    raises above SCAN_RTOL."""
    g = got.double().cpu().numpy() if torch.is_tensor(got) else got.astype(np.float64)
    w = want.double().cpu().numpy() if torch.is_tensor(want) else want
    normal = np.abs(w) >= SCAN_TINY
    rel = float((np.abs(g - w)[normal] / np.abs(w)[normal]).max()) if normal.any() else 0.0
    if rel > SCAN_RTOL or np.any(np.abs(g[~normal]) > SCAN_TINY):
        raise AssertionError(f"{what}: relative error {rel:.3e} (bound {SCAN_RTOL}), or a "
                             "value above 1.2e-38 where the reference underflows")
    return rel


SCAN_SHAPES = (  # (R, S, values, fill, storage offset in floats)
    (4, 6, "unit", 1.0, 0), (4, 6, "unit", 0.0, 0), (1024, 128, "tiny", 1.0, 0),
    (1037, 64, "tiny", 1.0, 0), (1037, 30, "tiny", 0.0, 1), (37, 2048, "tiny", 1.0, 0),
    (BENCH_RAYS, 30, "tiny", 1.0, 0))


def scan_bits(x):
    """numpy's f32 sequential accumulate of an (R, S) f32 array: the bits
    every ``seg_scans`` output must have (the product along a segment, the
    sum along the reversed one)."""
    return {"cumprod": np.multiply.accumulate(x, axis=1),
            "suffix": np.add.accumulate(x[:, ::-1], axis=1)[:, ::-1]}


def phase_seg_scans(scans, variants, smi, seed=29):
    """Phase 18: ``seg_scans`` (#15) through ``scans.seg_*`` against numpy's
    f32 sequential accumulate of the same inputs bit for bit, numpy f64, its
    plain version and the library call: cumprod and suffix sum within rtol
    1e-5 of f64 and of the plain version where the reference is a normal
    f32 (both at most 1.2e-38 where the product underflows), the shift
    exact, repeat launches bit-identical, at ``SCAN_SHAPES``: R = 4, S = 6
    on [0.5, 1.5) (the JAX test's), fill 1 and 0; S = 128 on [1e-10, 1]
    (subnormal products); S = 64 (an even stride) and S = 30 at a ragged R,
    the latter at a storage offset of one float (not 16-B aligned); S =
    2048 (past one run's fit: the direct walk); the 262,144 x 30 column.
    Then the timed main path at that column: kernel, plain version and
    library call in turns, the card's work alone (``variants.device_turns``),
    as found and with the L2 flushed (a 128 MiB read) before each call; its
    launches are this phase's own (no train step or frame runs the scans).
    Returns ``(worst |kernel - plain|, launches, {op: {"warm" | "flushed":
    (ms, plain_ms, library_ms)}}, bound)``."""
    rng = np.random.default_rng(seed)
    fns = {"cumprod": (scans.seg_inclusive_cumprod, scans.seg_inclusive_cumprod_reference),
           "suffix": (scans.seg_suffix_sum, scans.seg_suffix_sum_reference),
           "shift": (scans.seg_shift_down, scans.seg_shift_down_reference)}
    worst = 0.0
    main = None
    for R, S, kind, fill, offset in SCAN_SHAPES:
        x = scan_inputs(rng, R, S, kind)
        buf = torch.from_numpy(np.concatenate([np.zeros(offset, np.float32), x.ravel()]))
        col = buf.cuda()[offset:].reshape(-1, 1)
        wants, bits = scan_wants(x, fill), scan_bits(x)
        route = scans.scan_plan(R * S, S).route
        line = []
        for op, (kernel, plain) in fns.items():
            args = (S, fill) if op == "shift" else (S,)
            k1, k2, p = kernel(col, *args), kernel(col, *args), plain(col, *args)
            torch.cuda.synchronize()
            if k1.shape != col.shape or not torch.equal(k1, k2):
                raise AssertionError(f"seg_scans {op} R={R} S={S}: shape {tuple(k1.shape)} "
                                     "or repeat launches differ")
            got = k1.reshape(R, S)
            if op == "shift":
                exact = np.array_equal(got.cpu().numpy(), wants[op].astype(np.float32)) \
                    and torch.equal(k1, p)
                if not exact:
                    raise AssertionError(f"seg_shift_down R={R} S={S} fill={fill}: not exact")
                line.append("shift exact")
                continue
            apart = int((got.cpu().numpy().view(np.uint32) != bits[op].view(np.uint32)).sum())
            if apart:
                raise AssertionError(f"seg_scans {op} R={R} S={S}: {apart} values differ "
                                     "from numpy's f32 accumulate")
            e_np = scan_close(got, wants[op], f"seg_scans {op} R={R} S={S} vs numpy")
            e_pl = scan_close(k1, p, f"seg_scans {op} R={R} S={S} vs its plain version")
            worst = max(worst, (k1 - p).abs().max().item())
            line.append(f"{op} equal to numpy's f32 accumulate bit for bit, rel err "
                        f"{e_np:.2e} vs numpy f64, {e_pl:.2e} vs plain")
        under = int((bits["cumprod"] < SCAN_TINY).sum())
        print(f"phase 18 seg_scans R={R} S={S} ({route}) on {kind} values, fill {fill}, "
              f"offset {offset}: " + "; ".join(line) + f"; repeat launches bit-identical "
              f"({under} products below 1.2e-38)")
        if R == BENCH_RAYS:
            main = (col, S)

    col, S = main
    view = col.reshape(-1, S)
    library = {"cumprod": lambda: torch.cumprod(view, dim=1),
               "suffix": lambda: torch.flip(torch.cumsum(torch.flip(view, [1]), dim=1), [1])}
    flush = variants.l2_flush()
    scans.launches["seg_scans"] = 0
    timing = {}
    for op, (kernel, plain) in fns.items():
        args = (S, 1.0) if op == "shift" else (S,)
        turns = {"plain": lambda: plain(col, *args), "kernel": lambda: kernel(col, *args)}
        if op in library:
            turns["library"] = library[op]
        for fn in turns.values():
            fn()  # warm-up
        timing[op] = {}
        for mode, fl in (("warm", None), ("flushed", flush)):
            ts = variants.device_turns(turns, 3, fl)
            timing[op][mode] = tuple(statistics.median(ts[k]) if k in ts else None
                                     for k in ("kernel", "plain", "library"))
            print(f"phase 18 {op} at the {BENCH_RAYS} x {S} column, the card's work, L2 "
                  f"{'as found' if fl is None else 'flushed'}, on {smi}: "
                  + ", ".join(f"{k} {spread(v)}" for k, v in ts.items()))
    launches = scans.launches["seg_scans"]
    nbytes = 2 * col.numel() * 4
    kb = bound(col.numel() / 2, PEAK_F32, nbytes)  # one operation per value
    print(f"phase 18 seg_scans launches on the main path: {launches}; bound {kb[0]:.4f} ms "
          f"({kb[1]}: {nbytes / 1e6:.1f} MB read and written); with the L2 flushed "
          + ", ".join(f"{op} {t['flushed'][0]:.4f} ms ({kb[0] / t['flushed'][0]:.1%})"
                      for op, t in timing.items())
          + "; L2 as found " + ", ".join(f"{op} {t['warm'][0]:.4f} ms"
                                         for op, t in timing.items()))
    return worst, launches, timing, kb


NERF12 = tuple(f"{pre}{k}{suf}" for suf in ("", "_rays") for pre in ("nerf_", "nerf_wide_")
               for k in ("render_fwd", "train", "render_bwd"))
# SHA-256 of the twelve NeRF entry points' output bytes (kernel_digests). They
# pin every bit of #1-#12: a kernel change that moves one fails phase 18 until
# its entry is updated on purpose, with the reason here.  Taken when the
# per-ray instances were added; unchanged by the scans' lift onto seg_scan.cuh, by
# the bf16 dW stage's move onto wgmma/TMA (nerf_wide_dw.cuh: each 32-row
# k-step's tensor-core sum and its f32 promotion give the mma.sync kernel's
# bits, so the four wide gradient entries did not move either) and by the bf16
# render's MLP moving into one wgmma/TMA kernel (nerf_wide_mlp.cuh: the same
# promotion, epilogue and encoding arithmetic, so #8 and #10 kept theirs).  The
# four wide gradient entries moved when bf16 db began to be summed from the
# column partials that compositing and the d_h GEMM write (a row per ray, per
# 128-row tile) in place of an f32 d_z: db's order alone changed (their loss
# and dW kept every bit of the tree that summed the f32 d_z, on the card; both
# orders lie as far from f64 sums of the plain path's d_z, to 4 digits).  #8
# and #10 moved when the fused MLP began to sum each layer's whole K in the
# tensor core's accumulator, not in 32-deep k-steps promoted by IEEE adds:
# the sums' grouping alone changed (phase 9 and tests/test_torch_cuda.py hold
# the rows to the layer chain's bits off near ties).  The four wide gradient
# entries moved again when the layer GEMM (nerf_wide_layer_gemm.cuh) began
# to promote each 64-deep stage, not each 32-deep k-step: the grouping alone.
KERNEL_DIGESTS = {
    "nerf_render_fwd":
        "64ba1c0f42400d315d53444f6e0d3757183e1f452497a0006831db6639d28aff",
    "nerf_train":
        "fc4c85999f1f3941e3a61e0d181ba8d1a81c95687796309d5b16466efe1ba3ed",
    "nerf_render_bwd":
        "7e3e623e002bd74905a6ec696bfe97773ee8101c4b43a9d16a11809782e4fd5d",
    "nerf_wide_render_fwd":
        "e808d2cdb43b1ab4c2ec71e6a2658a45fc9b44acaf80343d0cb5c1ed7ad99eab",
    "nerf_wide_train":
        "e9a66f067b1c58d21228fbcb4b891c99bcb56c3e357147b08c41c4237bca5c2b",
    "nerf_wide_render_bwd":
        "0c79b3c175c2f60ed677e818571dd8026236cb44377579daa8df7d6f320cef1a",
    "nerf_render_fwd_rays":
        "b28cdecd22d6d86784a68059e14aa54b1a1a54ea8bf1d2a96b6dc10b9a090d3b",
    "nerf_train_rays":
        "7e42c0699bb65afc0677bda6c03a06fa22bb746f76d1a20d3237f499a6f04820",
    "nerf_render_bwd_rays":
        "e18229536c2632fa4e91045d8e5b85f9fdffaacfb778ba7b9a4860f10c9c9060",
    "nerf_wide_render_fwd_rays":
        "8f2709111148c6e97875aa2e65b1edc88e0a1afd0961dc7e1f6525eb4be264f2",
    "nerf_wide_train_rays":
        "04d4208c4ecfa1f270a9f251ce53fd74d15401bbd691e268d6721418ef9b382d",
    "nerf_wide_render_bwd_rays":
        "578e7a9f6197eef5d610c9eb19506cc7c44d28695bd26909a06e8301f5be686b",
}


# The same digests of the six wide entry points at the bf16 MLPs past the
# fused MLP's pw 256 (C4_MLPS, phase 24's), whose render runs the layer
# chain: recorded from the tree whose bf16 forward and d_h GEMMs ran
# gemm_mma_kernel (mma.sync), so that they hold the chain's move onto
# wgmma/TMA to those bits; the eight gradient entries again when bf16 db
# moved onto column partials (as KERNEL_DIGESTS': db's order alone); all
# twelve when the layer GEMM began to promote each 64-deep stage, not each
# 32-deep k-step.
C4_MLPS = ("3x384 bfloat16", "8x1024 bfloat16")
C4_DIGESTS = {
    "nerf_wide_render_fwd 3x384 bfloat16":
        "0fc5c0e44f290a69753f632716997903063fb726071f3a63ff5ec37a87e9395b",
    "nerf_wide_train 3x384 bfloat16":
        "9374a82f3c314c1d9e5e2043f16f29702c0f0bb1a83f8b312bb505082e975760",
    "nerf_wide_render_bwd 3x384 bfloat16":
        "4c783977fb22ccc88e24baa8a698b4d51421fe1c7be6c0e7f3f078d67503da76",
    "nerf_wide_render_fwd_rays 3x384 bfloat16":
        "2ef9bc5fd982217fb8574ec2ddcb83eca3963ca25381cc132a9c225a49b5834f",
    "nerf_wide_train_rays 3x384 bfloat16":
        "206c1850e8bbac8b01f60154ee59067508fa462c037d87c8a0094b679d5b2216",
    "nerf_wide_render_bwd_rays 3x384 bfloat16":
        "f7e6f2de30107c588961d8ccacaf610b612b171226d7ef324fed2b93caf34222",
    "nerf_wide_render_fwd 8x1024 bfloat16":
        "4870e44eaa1ac98a8919bdb52622fefab4181986448cb9ba659f634a6fd5ae0a",
    "nerf_wide_train 8x1024 bfloat16":
        "c8823bed1d7112d2afe1eb0690230b459b21f1889447ddf3249550be5a870da4",
    "nerf_wide_render_bwd 8x1024 bfloat16":
        "f1b7a3f1fab7c7b399f0dcd309e4f4c0b16036b96681b79328b7c49878370fd6",
    "nerf_wide_render_fwd_rays 8x1024 bfloat16":
        "f513cac2a8cbe907d6779a6ef4bc695a4186c69d3b08cd7c8f85109ee9b415e6",
    "nerf_wide_train_rays 8x1024 bfloat16":
        "7b4820ee0e57838f6a22e48ef61bc459199ed05060df62ee6b8c954449a641f8",
    "nerf_wide_render_bwd_rays 8x1024 bfloat16":
        "bf2b4121f4513cacf3f40718ad59972b863404b76c24a7b771da584e556a1640",
}


# The same digests at f32 compute, recorded from the tree whose f32 products
# ran the FMA GEMM that nerf_wide_f32_gemm.cuh replaced, so that they hold the
# move onto nerf_wide_f32_gemm.cuh to those bits: the six wide entry points at the f32
# MLPs of phase 24 (F32_MLPS, both modes, both depth kinds, 1037 rays), and
# the wide field route's "highest" forward and dW/db at phase 25's three
# fields on 1037 points (f32_digests).
F32_MLPS = ("3x384 float32", "4x512 float32", "1x(75->4) float32")
F32_DIGESTS = {
    "nerf_wide_render_fwd 3x384 float32":
        "7180f3901fcfc47b715ead36cff9244883f135d42b7c55a8c4cd79cb872474b2",
    "nerf_wide_train 3x384 float32":
        "0fff04f26a36772137d30dd1c46d67265e6434c953973d9f27351229509b2fab",
    "nerf_wide_render_bwd 3x384 float32":
        "5b01640b39b5ec22339f4a7cd5eebde0eea57db031f893f2a6593935b0a27750",
    "nerf_wide_render_fwd_rays 3x384 float32":
        "6d151ba1a0e5c630dec11a323e79bb54725e5477c1239c609291dda6d2844bb8",
    "nerf_wide_train_rays 3x384 float32":
        "37168adf61d3cb44b4c079b1703edea797333c089357a475930124a96979ef4b",
    "nerf_wide_render_bwd_rays 3x384 float32":
        "77838d2b30d6a1abe5925b53dca3bd5382ef6c420ec87b664d9d912fe452f88b",
    "nerf_wide_render_fwd 4x512 float32":
        "cfc4bb42ca7cce2cfc5f1c941c536f3a0f147a25bc8907bbb20e37623eb144f2",
    "nerf_wide_train 4x512 float32":
        "261ad3074d5c9c031eb8742a9c0f5d3412efe0979661616b4b0ec368c934f10b",
    "nerf_wide_render_bwd 4x512 float32":
        "5a01dfcafd1e087feb5d9a71d696454d0d3e2865b0ee944b6fe83ce1da0c628d",
    "nerf_wide_render_fwd_rays 4x512 float32":
        "fda1e856df46ae3f0aa642d1350c6651b17fd84e4edf738aa8835828b0f105db",
    "nerf_wide_train_rays 4x512 float32":
        "e4f4277338f8e0704ae382378c29b7d54e0c832fff6bd95f82da50f786a98c4c",
    "nerf_wide_render_bwd_rays 4x512 float32":
        "d42f7942076e4806a384d2f84da37314475511305ee16590e1272dc0d6384f65",
    "nerf_wide_render_fwd 1x(75->4) float32":
        "4cfad15a577e44324568205879ac81ae54a06bf91bc9b2bb5c7463a52785712d",
    "nerf_wide_train 1x(75->4) float32":
        "aa9efdc2cbcbc21a27de0ec9988585031de1907e8d74ab9c735661074b53a133",
    "nerf_wide_render_bwd 1x(75->4) float32":
        "27574929f3882329909087a3881bd762a3da491988b82a0fedab211602f7c7dc",
    "nerf_wide_render_fwd_rays 1x(75->4) float32":
        "d7b46f26c9256f9e736a2062e109ae8c9b06c0e8ce2a596e1e479d58f47c786c",
    "nerf_wide_train_rays 1x(75->4) float32":
        "41e3baf790a0ee041cfac75a380ca91fb4d2ee990e59e517a315ebb5ff80af7e",
    "nerf_wide_render_bwd_rays 1x(75->4) float32":
        "8e7194bc7d9d2f3ddae36bc098f6e99a6d4eb5c1dc3ecfba6deeb362fad81b00",
    "field_wide highest 4x256":
        "fd55ebeccbcc9d85d8a5f04056d19bbcd5db07fbe944e0bd64c18ae6f1ea2e39",
    "field_wide highest 8x128":
        "6f9784df94bbcf40e62dd11a2a3ac6b3d42e5d6893df5c53543ea2dc0dba8f3a",
    "field_wide highest 3d 3x64 16ch":
        "ab83c32ae495ea098113f6cfe83f0b29d57a57c38a7a35ae197b7e216a93ceff",
}


def kernel_digests(fused_nerf, NeRFConfig, seed=23):
    """SHA-256 of the output bytes of each NeRF entry point (#1-#12) at fixed
    seeded inputs: phase 1 and 4's MLPs (``small``, ``single64``) and phase
    7's (``full``, the f32 4x128/S=32) in both modes on 1037 rays, at uniform
    (S,) depths and at numpy-jittered (N, S) ones; the colours, the train
    loss and dW/db, and the render backward's dW/db for a fixed cotangent."""
    import hashlib

    rng = np.random.default_rng(seed)
    digests = {name: hashlib.sha256() for name in NERF12}
    f32 = NeRFConfig(num_layers=4, filter_size=128, num_samples=32)
    for base in (NeRFConfig.small(), NeRFConfig.single_view_64(), NeRFConfig.full(), f32):
        for mode in ("loma", "standard"):
            digest_outputs(fused_nerf, dataclasses.replace(base, mode=mode), rng,
                           lambda name, x: digests[name].update(x))
    return {name: h.hexdigest() for name, h in digests.items()}


def digest_outputs(fused_nerf, cfg, rng, update):
    """The outputs :func:`kernel_digests` hashes for one MLP on 1037 rays,
    params, rays, targets, cotangent and jittered depths drawn from ``rng``
    in that order: ``update(entry point, bytes)`` for the colours, the train
    loss and dW/db and the render backward's dW/db, at uniform (S,) and at
    (N, S) depths."""
    params = seeded_params(rng, cfg)
    leaves = leaves_of(params)
    o, d = seeded_rays(rng, N_CHECK)
    tgt = torch.tensor(rng.random((N_CHECK, 3)), dtype=torch.float32, device="cuda")
    cot = torch.tensor(rng.standard_normal((N_CHECK, 3)), dtype=torch.float32, device="cuda")
    S = cfg.num_samples
    tj = np.sort(rng.uniform(cfg.near, cfg.far, (N_CHECK, S)), axis=1)
    dj = np.concatenate([np.diff(tj, axis=1), np.full((N_CHECK, 1), 1e8)], axis=1)
    jit = tuple(torch.tensor(x, dtype=torch.float32, device="cuda") for x in (tj, dj))
    pre = "nerf_wide_" if fused_nerf._route(cfg, params)[0] == "wide" else "nerf_"
    for (t, dists), suf in ((uniform_depths(cfg), ""), (jit, "_rays")):
        with torch.no_grad():
            col = fused_nerf.render_rays(params, o, d, t, dists, cfg)
        loss = fused_nerf.nerf_train_loss(params, o, d, t, dists, tgt, cfg)
        train = (loss.detach(), *torch.autograd.grad(loss, leaves))
        back = torch.autograd.grad(
            (fused_nerf.render_rays(params, o, d, t, dists, cfg) * cot).sum(), leaves)
        for k, outs in (("render_fwd", (col,)), ("train", train), ("render_bwd", back)):
            for x in outs:
                update(pre + k + suf, x.detach().cpu().numpy().tobytes())


def c4_digests(fused_nerf, NeRFConfig, seed=37):
    """SHA-256 of the wide entry points' outputs (:func:`digest_outputs`)
    at the bf16 widths past the fused MLP, 3x384 and 8x1024 (phase 24's
    MLPs), each in both compositing modes, keyed by entry point and MLP."""
    import hashlib

    rng = np.random.default_rng(seed)
    digests = {}
    for name in C4_MLPS:
        for mode in ("loma", "standard"):
            cfg = dataclasses.replace(width_configs(NeRFConfig)[name], mode=mode)
            digest_outputs(fused_nerf, cfg, rng, lambda entry, x: digests.setdefault(
                f"{entry} {name}", hashlib.sha256()).update(x))
    return {k: h.hexdigest() for k, h in digests.items()}


def f32_digests(fused_nerf, fused_mlp, NeRFConfig, ImageFieldConfig, mlp_layer_sizes,
                seed=43):
    """SHA-256 of the wide entry points' outputs (:func:`digest_outputs`) at
    the f32 MLPs of ``F32_MLPS``, each in both compositing modes, keyed by
    entry point and MLP; and of the wide field route's "highest" output and
    dW/db (:func:`field_grads` for a seeded cotangent) at each field of
    :func:`field_wide_configs` on 1037 points."""
    import hashlib

    rng = np.random.default_rng(seed)
    digests = {}
    for name in F32_MLPS:
        for mode in ("loma", "standard"):
            cfg = dataclasses.replace(width_configs(NeRFConfig)[name], mode=mode)
            digest_outputs(fused_nerf, cfg, rng, lambda entry, x: digests.setdefault(
                f"{entry} {name}", hashlib.sha256()).update(x))
    for name, (cfg, D, out) in field_wide_configs(ImageFieldConfig).items():
        params = field_params_for(rng, mlp_layer_sizes, cfg, D, out)
        if fused_mlp.kernel_width(params, D, cfg.num_encoding_functions, out) is not None:
            raise AssertionError(f"field {name}: routed to the tile kernels")
        coords = torch.tensor(rng.random((N_CHECK, D)), dtype=torch.float32, device="cuda")
        cot = torch.tensor(rng.standard_normal((N_CHECK, out)), dtype=torch.float32,
                           device="cuda")
        y, grads, _ = field_grads(lambda p, c, nf: fused_mlp.field_forward(
            p, c, nf, out, precision="highest"), params, coords, cot, cfg.num_encoding_functions)
        h = digests[f"field_wide highest {name}"] = hashlib.sha256()
        for x in (y, *grads):
            h.update(x.detach().cpu().numpy().tobytes())
    return {k: h.hexdigest() for k, h in digests.items()}


def phase_digests(fused_nerf, fused_mlp, NeRFConfig, ImageFieldConfig, mlp_layer_sizes):
    """Phase 18, the bit check: :func:`kernel_digests` against
    ``KERNEL_DIGESTS``, :func:`c4_digests` against ``C4_DIGESTS`` and
    :func:`f32_digests` against ``F32_DIGESTS``."""
    f32 = f32_digests(fused_nerf, fused_mlp, NeRFConfig, ImageFieldConfig, mlp_layer_sizes)
    for what, got, want in (("#1-#12", kernel_digests(fused_nerf, NeRFConfig), KERNEL_DIGESTS),
                            ("C4", c4_digests(fused_nerf, NeRFConfig), C4_DIGESTS),
                            ("f32", f32, F32_DIGESTS)):
        for name, h in got.items():
            print(f"phase 18 digest {name}: {h}")
        if got != want:
            apart = sorted(set(got) ^ set(want) | {k for k in got if got[k] != want.get(k)})
            raise AssertionError(f"{what} output digests differ from the recorded ones: {apart}")
        print(f"phase 18 digests of {what} ({len(got)}) equal to the recorded ones")


GRID_ROWS, GRID_BLOCK = 7864320, 3840  # 262,144 rays x 30; the JAX sweep's first block


def phase_grid_overhead(probe, grid_overhead, smi):
    """Phase 19: the grid-overhead probe (#16).  Its main path is the
    sweep script's entry point, ``grid_overhead.main`` at 7,864,320 rows
    and 8 reps (every sum within 1e-6 of the f64 sum of |x|, repeats
    bit-identical: the script checks both); then ``grid_sum`` alone at the
    sweep's first block against its f64 sum on the card, its plain version
    and ``torch.sum`` in turns.  Returns ``(|kernel - plain|, launches,
    (ms, plain_ms, library_ms), bound, sweep)``."""
    probe.launches["grid_sum"] = 0
    sweep = grid_overhead.main(["--rows", str(GRID_ROWS), "--reps", "8"])
    launches = probe.launches["grid_sum"]
    if len(sweep["A"]) != 5 or len(sweep["B"]) != 5 or not launches:
        raise AssertionError(f"grid_overhead: {len(sweep['A'])} + {len(sweep['B'])} sweep "
                             f"lines, {launches} launches")
    x = torch.randn((8, GRID_ROWS), generator=torch.Generator("cuda").manual_seed(0),
                    device="cuda")
    ref64, abs64 = x.double().sum().item(), x.double().abs().sum().item()
    k = [probe.grid_sum(x, GRID_BLOCK) for _ in range(3)]
    p = probe.grid_sum_reference(x, GRID_BLOCK)
    if not all(torch.equal(k[0], y) for y in k[1:]):
        raise AssertionError("grid_sum: repeat launches differ")
    err64 = abs(k[0].item() - ref64) / abs64
    if err64 > 1e-6 or abs(p.item() - ref64) / abs64 > 1e-6:
        raise AssertionError(f"grid_sum {k[0].item()} / plain {p.item()} vs f64 {ref64}")
    err = abs(k[0].item() - p.item())
    ts = timed_turns({"plain": lambda: probe.grid_sum_reference(x, GRID_BLOCK),
                      "kernel": lambda: probe.grid_sum(x, GRID_BLOCK),
                      "library": lambda: torch.sum(x)}, 5)
    med = tuple(statistics.median(ts[n]) for n in ("kernel", "plain", "library"))
    kb = bound(x.numel() / 2, PEAK_F32, x.numel() * 4)  # one add per value
    print(f"phase 19 grid_sum alone, (8, {GRID_ROWS}) in {GRID_BLOCK}-column tiles, on {smi}: "
          f"kernel {spread(ts['kernel'])}, plain {spread(ts['plain'])}, torch.sum "
          f"{spread(ts['library'])}; bound {kb[0]:.4f} ms ({kb[1]}), {kb[0] / med[0]:.1%} of "
          f"it; |kernel-f64|/sum|x| {err64:.2e}, |kernel-plain| {err:.3e}; launches on the "
          f"main path (the sweep) {launches}")

    # the event window split: the host's enqueue (the clock around a call,
    # nothing awaited) and the kernels' own device time (one trace session
    # in a process of its own)
    host = {}
    for name, fn in (("kernel", lambda: probe.grid_sum(x, GRID_BLOCK)),
                     ("torch.sum", lambda: torch.sum(x))):
        host[name] = []
        for _ in range(50):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            host[name].append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    dev = card_probe("grid_sum", "--calls", "20")
    per_call = dev["kernels_per_call"]
    if list(per_call.values()) != [1.0]:
        raise AssertionError(f"grid_sum: kernels per call {per_call}, need one launch")
    print(f"phase 19 grid_sum split, on {smi}: event window {med[0]:.4f} ms (torch.sum "
          f"{med[2]:.4f}); device {dev['device_ms_per_call']:.4f} ms per call "
          f"(utils.profiling.trace, 20 calls, one kernel each; torch.sum "
          f"{dev['torch_sum_device_ms']:.4f}), {kb[0] / dev['device_ms_per_call']:.1%} of "
          f"the bound; host "
          f"{spread(host['kernel'])} per wrapper call, torch.sum {spread(host['torch.sum'])}")
    return err, launches, med, kb, sweep


DP_STEPS = 3  # phase 20 (a): Adam steps after which the params must be bit-identical
DP_ROUNDS = 10  # its timing: rounds of single, data-parallel, data-parallel, single
# phase 20 (d): the tensor-parallel step (plain path) at a narrow width
TP_WIDTH, TP_LAYERS, TP_SAMPLES, TP_RAYS = 32, 4, 16, 4096


def _rank_setup():
    """A phase-20 rank's device, its kernels (built once per node), and the
    TF32 switches the parent sets (a spawned rank starts without them)."""
    from lomanerf_tpu_torch.parallel import build_kernels_once, rank_device

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = rank_device("cuda")
    build_kernels_once()
    return dev


def dp_one_rank():
    """Phase 20 (a), on a one-rank NCCL group: the data-parallel step
    (``parallel.make_train_step``: the train kernel, then one flat SUM
    all-reduce over NCCL) and ``make_single_chip_train_step`` from the same
    init at the bench shape (small, 262,144 rays, Adam 5e-4, bench.py's two
    cycled batches): after ``DP_STEPS`` steps the params must be equal bit
    for bit; then both steps timed in turns by CUDA events."""
    import torch.distributed as dist

    from lomanerf_tpu_torch.models import NeRFConfig, NeRFModel
    from lomanerf_tpu_torch.ops import fused_nerf
    from lomanerf_tpu_torch.parallel import RayBatch, data_mesh, make_train_step, place_state
    from lomanerf_tpu_torch.train.steps import make_single_chip_train_step

    dev = _rank_setup()
    cfg = NeRFConfig.small()
    rng = np.random.default_rng(0)
    batches = [bench_batch(rng, cfg, BENCH_RAYS) for _ in range(2)]
    mesh = data_mesh(dev)
    calls, models = {}, {}
    for name in ("single", "dp"):
        model = NeRFModel(cfg, device=dev)
        model.init(torch.Generator().manual_seed(0))
        opt = torch.optim.Adam(model.parameters(), lr=5e-4)
        if name == "single":
            step = make_single_chip_train_step(cfg, opt)
            calls[name] = lambda b, m=model, s=step: s(m, *b)
        else:
            place_state(mesh, cfg, model, opt)
            step = make_train_step(cfg, opt, mesh)
            calls[name] = lambda b, m=model, s=step: s(m, RayBatch(*b))
        models[name] = model
    losses = {name: [] for name in calls}
    launches = {}
    for name in ("single", "dp"):  # the main path: the counts reset just before
        reset_launches(fused_nerf)
        for i in range(DP_STEPS):
            losses[name].append(calls[name](batches[i % 2]).item())
        torch.cuda.synchronize()
        launches[name] = fused_nerf.launches["nerf_train"]
    same = all(torch.equal(a, b) for a, b in zip(models["single"].parameters(),
                                                 models["dp"].parameters()))
    ms = {name: [] for name in calls}
    for i in range(DP_ROUNDS):
        for name in ("single", "dp", "dp", "single"):
            ms[name].append(cuda_ms(lambda: calls[name](batches[i % 2]))[0])
    return {"backend": dist.get_backend(mesh.data_group), "losses": losses, "same": same,
            "launches": launches["dp"], "single_launches": launches["single"], "ms": ms}


def dp_two_ranks():
    """Phase 20 (b)-(d), on two gloo ranks that share the card: (b) the
    data-parallel step, each rank running the train kernel on its 131,072
    of the bench batch's rays, at shared (#3) and at per-ray depths (#6,
    sharded with the rays), summed loss and gradients against one process's
    kernel and against the plain version on the whole batch; the step
    timed; (c) the sharded 800x800 ``small`` frame of the trained fixture
    against ``render_image``'s, bit for bit, and against the plain version
    on the frame's rays; (d) a tensor-parallel step (dp=1, tp=2, plain path) against the
    single-process plain step.  Rank 0 compares; every rank counts."""
    import torch.distributed as dist

    from lomanerf_tpu_torch.core import normalized_intrinsics, rays
    from lomanerf_tpu_torch.models import NeRFConfig, NeRFModel
    from lomanerf_tpu_torch.ops import fused_nerf
    from lomanerf_tpu_torch.parallel import (RayBatch, data_mesh, gather_state, is_primary,
                                             make_mesh, make_train_step, place_state,
                                             shard_batch)
    from lomanerf_tpu_torch.train.checkpoint import load_params_npz
    from lomanerf_tpu_torch.train.steps import make_single_chip_train_step

    dev = _rank_setup()
    mesh = data_mesh(dev)
    out = {"backend": dist.get_backend(mesh.data_group), "launches": {}, "checks": {}}
    cfg = NeRFConfig.small()
    o, d, t, dists, tgt = bench_batch(np.random.default_rng(0), cfg, BENCH_RAYS)
    params = seeded_params(np.random.default_rng(1), cfg)
    _, tr, dr = rays.sample_along_rays(o, d, cfg.near, cfg.far, cfg.num_samples,
                                       generator=torch.Generator(device=dev).manual_seed(13))
    for label, entry, (tv, dd) in (("shared", "nerf_train", (t, dists)),
                                   ("per-ray", "nerf_train_rays", (tr, dr))):
        # one data-parallel SGD step of this rank's shard: the main path
        batch = RayBatch(o, d, tv, dd, tgt)
        p = {k: [torch.nn.Parameter(x.clone()) for x in v] for k, v in params.items()}
        step = make_train_step(cfg, torch.optim.SGD([*p["w"], *p["b"]], lr=1e-3), mesh)
        local = shard_batch(mesh, batch)
        reset_launches(fused_nerf)
        loss = step(p, local)
        torch.cuda.synchronize()
        out["launches"][entry] = fused_nerf.launches[entry]
        grads = [x.grad.clone() for x in [*p["w"], *p["b"]]]  # summed over the ranks
        if is_primary():
            # held to one process's kernel on the whole batch, and to the
            # plain version (autograd of the core pipeline) on it
            ref = {k: [x.clone() for x in v] for k, v in params.items()}
            lv = leaves_of(ref)
            want = fused_nerf.nerf_train_loss(ref, *batch, cfg)
            wg = torch.autograd.grad(want, lv)
            plain = fused_nerf.nerf_train_loss_reference(ref, *batch, cfg)
            pg = torch.autograd.grad(plain, lv)
            torch.testing.assert_close(loss, want.detach(), rtol=1e-5, atol=0.0)
            torch.testing.assert_close(loss, plain.detach(), rtol=1e-5, atol=0.0)
            err = grads_close(grads, wg, f"phase 20 two ranks, {label} depths", GRAD_RTOL,
                              grad_atol)
            err_plain = grads_close(grads, pg, f"phase 20 two ranks against the plain "
                                    f"version, {label} depths", GRAD_RTOL, grad_atol)
            out["checks"][label] = {"rays_per_rank": local.origins.shape[0],
                                    "loss": loss.item(), "loss_one_process": want.item(),
                                    "loss_plain": plain.item(), "max_grad_err": err,
                                    "max_grad_err_plain": err_plain}
            del plain, pg
        # the step's time with the two ranks on the one card
        ts = []
        for _ in range(10):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(p, local)
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        out.setdefault("step_ms", {})[label] = ts

    # (c) the sharded frame of the trained fixture
    fx = np.load(FIXTURE)
    pf = load_params_npz(FIXTURE)
    model = NeRFModel.from_numpy(cfg, pf["w"], pf["b"], device=dev)
    K = normalized_intrinsics(float(fx["focal"]), device=dev)
    pose = torch.from_numpy(fx["poses"][1]).to(dev)
    with torch.no_grad():
        reset_launches(fused_nerf)
        frame = model.render_image(K, pose, SERVE_SIZE, mesh=mesh)
        torch.cuda.synchronize()
        out["launches"]["nerf_render_fwd"] = fused_nerf.launches["nerf_render_fwd"]
        ms = []
        for _ in range(6):
            dist.barrier()
            ms.append(cuda_ms(lambda: model.render_image(K, pose, SERVE_SIZE, mesh=mesh))[0])
        out["frame_ms"] = ms
        if is_primary():
            alone = model.render_image(K, pose, SERVE_SIZE)
            # the plain version on the frame's rays, at phase 3's tolerance
            o_f, d_f = rays.get_rays(SERVE_SIZE, SERVE_SIZE, K, pose)
            tv_f, dd_f = rays.uniform_depths(cfg.near, cfg.far, cfg.num_samples, dev)
            plain = fused_nerf.render_rays_reference(model.params, o_f, d_f, tv_f, dd_f,
                                                     cfg).reshape(frame.shape)
            torch.testing.assert_close(frame, plain, atol=ATOL, rtol=RTOL)
            out["checks"]["frame"] = {"equal": bool(torch.equal(frame, alone)),
                                      "finite": bool(torch.isfinite(frame).all()),
                                      "std": frame.std().item(),
                                      "max_err_plain": (frame - plain).abs().max().item()}

    # (d) tensor parallelism on the plain path, dp=1 x tp=2
    tcfg = NeRFConfig(num_layers=TP_LAYERS, filter_size=TP_WIDTH, num_samples=TP_SAMPLES)
    tmesh = make_mesh(dp=1, tp=2, device=dev)
    tparams = seeded_params(np.random.default_rng(3), tcfg)
    tbatch = RayBatch(*bench_batch(np.random.default_rng(4), tcfg, TP_RAYS))
    p = {k: [torch.nn.Parameter(x.clone()) for x in v] for k, v in tparams.items()}
    opt = torch.optim.SGD([*p["w"], *p["b"]], lr=1e-3)
    local = place_state(tmesh, tcfg, p, opt, tp=True)
    loss = make_train_step(tcfg, opt, tmesh, tp=True, backend="plain")(local, tbatch)
    full, _ = gather_state(tmesh, tcfg, local, None, tp=True)
    if is_primary():
        ref = {k: [torch.nn.Parameter(x.clone()) for x in v] for k, v in tparams.items()}
        ropt = torch.optim.SGD([*ref["w"], *ref["b"]], lr=1e-3)
        want = make_single_chip_train_step(tcfg, ropt, backend="plain")(ref, *tbatch)
        torch.testing.assert_close(loss, want, rtol=1e-5, atol=0.0)
        worst = 0.0
        for i, (a, b) in enumerate(zip([*full["w"], *full["b"]], [*ref["w"], *ref["b"]])):
            worst = max(worst, (a - b).abs().max().item())
            torch.testing.assert_close(a, b.detach(), rtol=1e-4, atol=1e-6,
                                       msg=lambda m, i=i: f"phase 20 TP leaf {i}: {m}")
        out["checks"]["tp"] = {"loss": loss.item(), "loss_one_process": want.item(),
                               "max_param_err": worst}
    return out


def phase_data_parallel(smi):
    """Phase 20: the data-parallel path in ranks of its own
    (``parallel.run_ranks``; no process group outlives it): (a) one NCCL
    rank against the single-card step, (b)-(d) two gloo ranks on the one
    card (NCCL refuses two ranks on one GPU).  Returns the launches of
    #1, #3 and #6 summed over the ranks."""
    from lomanerf_tpu_torch.parallel import run_ranks

    one = run_ranks(dp_one_rank, 1, backend="nccl", timeout=600)[0]
    if not one["same"]:
        raise AssertionError(f"phase 20 (a): params after {DP_STEPS} steps differ from the "
                             f"single-card step's (losses {one['losses']})")
    if one["losses"]["dp"] != one["losses"]["single"]:
        raise AssertionError(f"phase 20 (a): losses differ: {one['losses']}")
    if one["launches"] != DP_STEPS or one["backend"] != "nccl":
        raise AssertionError(f"phase 20 (a): {one['launches']} train launches for "
                             f"{DP_STEPS} steps on {one['backend']}")
    print(f"phase 20 (a) one-rank {one['backend']} data-parallel step, small, {BENCH_RAYS} "
          f"rays, Adam 5e-4: params after {DP_STEPS} steps bit-identical to "
          f"make_single_chip_train_step's (losses {one['losses']['dp']}); nerf_train "
          f"launches {one['launches']}; on {smi}, in turns:")
    for name, what in (("single", "single-card step"), ("dp", "data-parallel step")):
        print(f"  {what:20s}: {spread(one['ms'][name])}, "
              f"{BENCH_RAYS / statistics.median(one['ms'][name]) * 1e3:.4e} rays/s")
    two = run_ranks(dp_two_ranks, 2, backend="gloo", timeout=600)
    checks = two[0]["checks"]
    for label in ("shared", "per-ray"):
        c = checks[label]
        print(f"phase 20 (b) two {two[0]['backend']} ranks on one card, {label} depths: "
              f"{c['rays_per_rank']} rays a rank, summed loss {c['loss']:.6e} vs one process "
              f"{c['loss_one_process']:.6e} (plain version {c['loss_plain']:.6e}), max|dW,db| "
              f"diff {c['max_grad_err']:.3e} (plain version {c['max_grad_err_plain']:.3e}); "
              f"step on rank 0 {spread(two[0]['step_ms'][label])} (host clock, {smi})")
    f = checks["frame"]
    if not (f["equal"] and f["finite"] and f["std"] > 0.01):
        raise AssertionError(f"phase 20 (c): sharded frame {f}")
    print(f"phase 20 (c) sharded {SERVE_SIZE}x{SERVE_SIZE} small frame on two ranks: "
          f"bit-identical to render_image's, max|frame-plain| {f['max_err_plain']:.3e}; "
          f"{spread(two[0]['frame_ms'])} per frame on rank 0")
    tpc = checks["tp"]
    print(f"phase 20 (d) tp=2 plain step ({TP_LAYERS}x{TP_WIDTH}, S={TP_SAMPLES}, {TP_RAYS} "
          f"rays, SGD 1e-3): loss {tpc['loss']:.6e} vs one process "
          f"{tpc['loss_one_process']:.6e}, max|param diff| {tpc['max_param_err']:.3e}")
    launches = {"nerf_train": one["launches"]}
    for r, res in enumerate(two):
        want = {"nerf_train": 1, "nerf_train_rays": 1, "nerf_render_fwd": 1}
        if res["launches"] != want:
            raise AssertionError(f"phase 20 rank {r}: launches {res['launches']}, need {want}")
        for k, v in res["launches"].items():
            launches[k] = launches.get(k, 0) + v
    print(f"phase 20 launches per rank {[res['launches'] for res in two]}; summed {launches}")
    return launches


PIPE_STEPS, PIPE_EVAL = 500, 250  # phase 21's driver runs (native x4, x1, numpy), evals
# phase 21: the numpy run against the native one after 500 Adam steps.  Their
# batches agree to float32 rounding (the C++ rounds in f32, numpy partly in
# f64), and Adam carries the difference forward: every param within this
# absolute bound, the final eval PSNR within PIPE_PSNR_DB
PIPE_PARAM_ATOL, PIPE_PSNR_DB = 5e-3, 0.1
PIPE_VIEWS, PIPE_SIZE = 100, 800  # the pipeline alone: 768 MB of images
PIPE_TIMED = {4096: {"native": 300, "numpy": 60}, 262144: {"native": 30, "numpy": 4}}
PIPE_HELD = 16  # batches held on the card, unread, against the CPU pipeline's
PIPE_SPLIT_STEPS = 60  # card_probe --what pipeline: driver steps a producer


def phase_pipeline(train_nerf, fused_nerf, CheckpointManager, NeRFModel, NeRFConfig,
                   synthetic_views, normalized_intrinsics, psnr, smi, tmp):
    """Phase 21: the C++ ray-batch prefetcher on the card's host.  (a) 500
    ``train_nerf`` steps (small, 4096 rays, the 16-view 64x64 synthetic
    scene, one seed) under ``--pipeline native`` at 4 threads and at 1
    thread, params bit-identical (batches in batch-id order), and under
    ``--pipeline numpy``, within PIPE_PARAM_ATOL and PIPE_PSNR_DB of them;
    (b) the pipeline alone on 100 random 800x800 views: batches on the
    card, held unread behind a busy card, equal to the CPU pipeline's bit
    for bit (the pinned ring), and batches/s at 4096 and 262,144 rays,
    native against numpy; (c) the driver step's host ms, device ms and
    idle share under each producer (``card_probe --what pipeline``).
    Returns (the train kernel's launches in (a), a summary)."""
    from lomanerf_tpu_torch.data.native import RayBatchPipeline
    from lomanerf_tpu_torch.data.synthetic import LEGO_CAMERA_ANGLE_X, focal_of, sphere_poses

    flags = ["--device", "cuda", "--data", "synthetic", "--preset", "small",
             "--img-size", "64", "--rays-per-batch", "4096", "--eval-every", str(PIPE_EVAL),
             "--optimizer", "adam", "--lr", "5e-4", "--ckpt-every", "0",
             "--steps", str(PIPE_STEPS)]
    runs = {"native x4": ["--pipeline", "native", "--pipeline-threads", "4"],
            "native x1": ["--pipeline", "native", "--pipeline-threads", "1"],
            "numpy": ["--pipeline", "numpy"]}
    images, poses, focal = synthetic_views(16, 64, device="cuda")
    K = normalized_intrinsics(focal, device="cuda")
    res = {}
    reset_launches(fused_nerf)  # the main path: the three runs
    for name, extra in runs.items():
        d = os.path.join(tmp, name.replace(" ", "_"))
        t0 = time.perf_counter()
        out = train_nerf.main([*flags, *extra, "--log-dir", os.path.join(d, "logs"),
                               "--ckpt-dir", os.path.join(d, "ck")])
        secs = time.perf_counter() - t0
        model = NeRFModel(NeRFConfig.small(), device="cuda")
        step = CheckpointManager(os.path.join(d, "ck")).restore(model)
        with torch.no_grad():
            img = model.render_image(K, poses[2], 64)
        with open(os.path.join(d, "logs", "metrics.jsonl")) as f:
            stamps = {r["step"]: r["time"] for r in map(json.loads, f)}
        res[name] = {"losses": out["losses"], "params": [p.detach().clone()
                                                         for p in model.parameters()],
                     "psnr": {**out["psnr"], step: psnr(images[2], img).item()}, "s": secs,
                     "ms_per_step": (stamps[PIPE_EVAL] - stamps[0]) / PIPE_EVAL * 1e3}
    torch.cuda.synchronize()
    launches = fused_nerf.launches["nerf_train"]
    if launches != len(runs) * PIPE_STEPS or fused_nerf.launches["nerf_render_fwd"] < 1:
        raise AssertionError(f"phase 21: launches {dict(fused_nerf.launches)} for "
                             f"{len(runs)} x {PIPE_STEPS} steps")
    a, b, c = (res[k] for k in runs)
    if a["losses"] != b["losses"] or not all(torch.equal(x, y) for x, y in
                                             zip(a["params"], b["params"])):
        raise AssertionError("phase 21: --pipeline native at 4 threads and at 1 thread differ")
    worst = max((x - y).abs().max().item() for x, y in zip(a["params"], c["params"]))
    for name, r in res.items():
        final = r["psnr"][PIPE_STEPS]
        if not (np.all(np.isfinite(r["losses"])) and final >= PSNR_FLOOR_DB
                and final >= r["psnr"][0] + PSNR_GAIN_DB):
            raise AssertionError(f"phase 21 {name}: PSNR {r['psnr']}")
    dpsnr = abs(c["psnr"][PIPE_STEPS] - a["psnr"][PIPE_STEPS])
    if worst > PIPE_PARAM_ATOL or dpsnr > PIPE_PSNR_DB:
        raise AssertionError(f"phase 21: numpy run vs native: max|param diff| {worst:.3e}, "
                             f"|PSNR diff| {dpsnr:.3f} dB")
    print(f"phase 21 (a) train_nerf --preset small, {PIPE_STEPS} steps x 4096 rays, seed 215: "
          f"native x4 and native x1 params bit-identical; numpy vs native max|param diff| "
          f"{worst:.3e} (bound {PIPE_PARAM_ATOL}); nerf_train launches {launches}")
    for name, r in res.items():
        print(f"  {name:9s}: PSNR " + ", ".join(f"step {k}: {v:.2f}"
                                               for k, v in sorted(r["psnr"].items()))
              + f" dB; {r['ms_per_step']:.3f} ms/step between the evals at 0 and {PIPE_EVAL} "
              f"(host clock); {r['s']:.2f} s the run")

    # (b) the pipeline alone: 100 random 800x800 views (768 MB)
    g = torch.Generator(device="cuda").manual_seed(21)
    views = torch.rand((PIPE_VIEWS, PIPE_SIZE, PIPE_SIZE, 3), generator=g,
                       device="cuda").cpu().numpy()
    vposes = sphere_poses(PIPE_VIEWS)
    vfocal = focal_of(LEGO_CAMERA_ANGLE_X)
    rates = {}
    for n, counts in PIPE_TIMED.items():
        for name, count in counts.items():
            kw = dict(stratified=True, seed=3, force_numpy=name == "numpy")
            pipe = RayBatchPipeline(vposes, views, vfocal, n, 30, 2.0, 6.0, device="cuda", **kw)
            if n == max(PIPE_TIMED):
                # the ring: batches copied while the card is busy, read at the end
                host = RayBatchPipeline(vposes, views, vfocal, n, 30, 2.0, 6.0, device="cpu",
                                        **kw)
                held = []
                for _ in range(PIPE_HELD):
                    torch.cuda._sleep(2_000_000)
                    held.append(pipe.next_batch())
                for i, batch in enumerate(held):
                    if not all(torch.equal(x.cpu(), y) for x, y in zip(batch, host.next_batch())):
                        raise AssertionError(f"phase 21 (b) {name}: card batch {i} differs from "
                                             "the CPU pipeline's")
                host.close()
            for _ in range(2):
                pipe.next_batch()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(count):
                pipe.next_batch()
            torch.cuda.synchronize()
            rates[(n, name)] = count / (time.perf_counter() - t0)
            pipe.close()
    del views
    print(f"phase 21 (b) RayBatchPipeline alone, {PIPE_VIEWS} random {PIPE_SIZE}x{PIPE_SIZE} "
          f"views, stratified, batches on the card (host clock, {smi}); {PIPE_HELD} batches "
          f"held behind a busy card equal the CPU pipeline's, native and numpy:")
    for n in PIPE_TIMED:
        print(f"  {n:7d} rays: native (4 threads) {rates[(n, 'native')]:.1f} batches/s "
              f"({rates[(n, 'native')] * n:.4e} rays/s), numpy {rates[(n, 'numpy')]:.1f} "
              f"batches/s ({rates[(n, 'numpy')] * n:.4e} rays/s)")

    # (c) the driver step's split under each producer, in a process of its own
    split = card_probe("pipeline", "--steps", str(PIPE_SPLIT_STEPS))
    print("phase 21 (c) the small driver step (4096 rays), utils.profiling.trace, "
          f"{split['steps']} steps a producer: " + "; ".join(
              f"{k} host {v['host_ms_per_step']:.4f} ms, device {v['device_ms_per_step']:.4f} "
              f"ms, idle {v['idle_share']:.1%}" for k, v in split["pipelines"].items()))
    return launches, {
        "driver_psnr": {k: r["psnr"][PIPE_STEPS] for k, r in res.items()},
        "numpy_vs_native_max_param_diff": worst,
        "batches_per_s": {f"{n} {name}": v for (n, name), v in rates.items()},
        "step_split": split["pipelines"]}


def phase_dsl(smi):
    """Phase 22: the loma DSL on the card.  Every program of the parity
    table (``tests/test_torch_dsl_programs.py``; the reference's own
    kernels are not in the checkout) compiled for ``device="cuda"`` and for
    ``"cpu"``, held to each other at the table's tolerances, and one warm
    call of each timed; one ``@simd`` add-and-reduce at 65,536 threads
    through the vmap route against numpy, and at 1,024 threads through
    both routes (vmap and the threads in turn); ``diff_raytrace``'s image
    and gradient (the rev-over-fwd Hessian is in the table)."""
    import warnings

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_torch_dsl_programs import ATOL, PROGRAMS, RTOL, assert_trees_close

    from lomanerf_tpu_torch import dsl
    from lomanerf_tpu_torch.dsl import lower, parser
    from lomanerf_tpu_torch.examples import diff_raytrace

    ms = {}
    with warnings.catch_warnings():
        warnings.simplefilter("error", dsl.compiler.LoopBoundWarning)
        for name, (code, run, *rest) in sorted(PROGRAMS.items()):
            tol = (rest[0] if rest else None) or (RTOL, ATOL)
            _, card = dsl.compile(code, device="cuda")
            _, host = dsl.compile(code, device="cpu")
            assert_trees_close(run(card, dsl), run(host, dsl), *tol,
                               what=f"phase 22 {name}: ")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(card, dsl)  # results come back to numpy: the call ends synchronised
            ms[name] = (time.perf_counter() - t0) * 1e3
    code = PROGRAMS["simd_parallel_add_and_atomic_reduce"][0]
    _, lib = dsl.compile(code, device="cuda")
    _, funcs = parser.parse(code)
    low = lower.Lowerer({}, funcs, device="cuda")
    n = 65536
    if low._simd_vmap_plan(funcs["parallel_reduce"], n) != (frozenset(), frozenset({"total"})):
        raise AssertionError("phase 22: parallel_reduce does not take the vmap route")
    rng = np.random.default_rng(22)
    x, y = (rng.random(n).astype(np.float32) for _ in range(2))
    zz, total = np.zeros(n, np.float32), np.zeros(1, np.float32)
    t0 = time.perf_counter()
    lib.parallel_add(x, y, zz, n)
    lib.parallel_reduce(x, total, n)
    simd_ms = (time.perf_counter() - t0) * 1e3
    if not np.array_equal(zz, x + y):
        raise AssertionError("phase 22: parallel_add at 65,536 threads")
    np.testing.assert_allclose(total[0], x.astype(np.float64).sum(), rtol=RTOL)
    m = 1024
    args = [torch.tensor(x[:m], device="cuda"), torch.zeros(1, device="cuda")]
    plan = low._simd_vmap_plan(funcs["parallel_reduce"], m)
    t0 = time.perf_counter()
    scan = low._run_simd_scan(funcs["parallel_reduce"], args, m)["total"].item()
    scan_ms = (time.perf_counter() - t0) * 1e3
    vmapped = low._run_simd_vmap(funcs["parallel_reduce"], args, m, *plan)[0]["total"].item()
    np.testing.assert_allclose(scan, vmapped, rtol=1e-6)
    t0 = time.perf_counter()
    ray = diff_raytrace.main(["--device", "cuda", "--size", "8"])
    ray_ms = (time.perf_counter() - t0) * 1e3
    want = diff_raytrace.main(["--device", "cpu", "--size", "8"])
    assert_trees_close((ray["image"], ray["grad"]), (want["image"], want["grad"]),
                       what="phase 22 diff_raytrace: ")
    print(f"phase 22 the DSL on the card: {len(ms)} programs on cuda equal to cpu at the "
          f"table's tolerances; one warm call each, host clock ({smi}), ms: "
          + ", ".join(f"{k} {v:.2f}" for k, v in sorted(ms.items())))
    print(f"  @simd add + reduce at {n} threads (vmap route): {simd_ms:.2f} ms, sum rel err "
          f"{abs(total[0] / x.astype(np.float64).sum() - 1):.2e}; reduce at {m} threads: "
          f"threads in turn {scan_ms:.2f} ms, equal to the vmap route; diff_raytrace "
          f"(8x8 image + gradient) {ray_ms:.2f} ms, equal to the cpu run")
    return {"programs": len(ms), "ms": ms, "simd_65536_ms": simd_ms, "scan_1024_ms": scan_ms,
            "diff_raytrace_ms": ray_ms}


# ---------------------------------------------------------------------------
# Phases 23-25: the driver surface (entry.py), NeRF MLPs at any width (C4)
# and narrow ones in bf16 (A4) on the wide kernels, and image fields past
# the tile kernels on field_wide.cu (D2)
# ---------------------------------------------------------------------------

ENTRY_RANKS = (1, 4)  # dryrun_multichip: one NCCL rank; four gloo ranks (tp = 2)


def phase_entry(fused_nerf, NeRFConfig):
    """Phase 23: ``entry.entry()`` on the card, its loss and dW/db (one
    launch of the wide train kernel) against the plain version on the same
    args (loss rtol 1e-4, dW/db phase 7's bf16 bound), then
    ``dryrun_multichip(1)`` over NCCL and ``dryrun_multichip(4)`` over gloo
    (tp = 2; four ranks on one card): each rank's losses finite and its
    train and render kernels launched; then the command line, ``python -m
    lomanerf_tpu_torch.entry 2`` (two gloo ranks), in a process of its own.
    Returns the launches of the three main paths by kernel."""
    from lomanerf_tpu_torch import entry

    fn, args = entry.entry()
    params, batch = args[0], args[1:]
    leaves = leaves_of(params)
    cfg = NeRFConfig.full()
    reset_launches(fused_nerf)
    loss = fn(*args)
    grads = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    launches = {"nerf_wide_train": fused_nerf.launches["nerf_wide_train"]}
    if launches["nerf_wide_train"] != 1 or sum(fused_nerf.launches.values()) != 1:
        raise AssertionError(f"entry()'s loss launched {fused_nerf.launches}")
    plain = fused_nerf.nerf_train_loss_reference(params, *batch, cfg)
    p_grads = torch.autograd.grad(plain, leaves)
    _, loss_rtol, _ = wide_tolerances(cfg)
    torch.testing.assert_close(loss.detach(), plain.detach(), rtol=loss_rtol, atol=0.0)
    e = wide_grads_close(grads, p_grads, "entry() dW/db", cfg)
    print(f"phase 23 entry(): full() on {batch[0].shape[0]} rays, loss kernel "
          f"{loss.item():.6e} plain {plain.item():.6e}; max|dW,db kernel-plain| {e:.3e}; "
          f"per leaf {leaf_errors(grads, p_grads)}")
    del grads, p_grads, plain
    for n in ENTRY_RANKS:
        t0 = time.perf_counter()
        ranks = entry.dryrun_multichip(n)
        secs = time.perf_counter() - t0
        for r in ranks:
            if not (np.isfinite(r["loss_dp_tp"]) and np.isfinite(r["loss_fused"])):
                raise AssertionError(f"dryrun_multichip({n}): {r}")
            if r["launches"]["nerf_train"] != 1 or r["launches"]["nerf_render_fwd"] < 1:
                raise AssertionError(f"dryrun_multichip({n}) launched {r['launches']}")
        for k in ("nerf_train", "nerf_render_fwd"):
            launches[k] = launches.get(k, 0) + sum(r["launches"][k] for r in ranks)
        print(f"phase 23 dryrun_multichip({n}) OK in {secs:.1f} s: losses dp x tp "
              f"{ranks[0]['loss_dp_tp']:.4f}, fused {ranks[0]['loss_fused']:.4f}; render "
              f"{ranks[0]['render_shape']}; launches a rank (#3, #1) "
              f"{[(r['launches']['nerf_train'], r['launches']['nerf_render_fwd']) for r in ranks]}")
    t0 = time.perf_counter()
    cli = subprocess.run([sys.executable, "-m", "lomanerf_tpu_torch.entry", "2"], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    last = cli.stdout.strip().splitlines()[-1:] or [""]
    if cli.returncode != 0 or last[0] != "dryrun_multichip(2) OK":
        raise AssertionError(f"python -m lomanerf_tpu_torch.entry 2: rc {cli.returncode}\n"
                             f"{cli.stdout[-2000:]}\n{cli.stderr[-4000:]}")
    print(f"phase 23 python -m lomanerf_tpu_torch.entry 2 in {time.perf_counter() - t0:.1f} s: "
          + " | ".join(cli.stdout.strip().splitlines()))
    return launches


WIDTHS_RAYS = 16384  # the 8x1024 step: the flagship rung's batch (bench.py:334)
WIDTHS_PLAIN_RAYS = 4096  # where the 8x1024 plain step fits beside the kernels' scratch
WIDTHS_STEPS = 5


def width_configs(NeRFConfig):
    """Phase 24's MLPs: C4 (hidden widths past 256: 3x384, 4x512 in f32 and
    bf16; 8x1024 bf16, the NeRF MLP of mip-NeRF 360 (Barron et al., CVPR
    2022, section 5) at S = 128, standard, init "nerf"; one-layer wide,
    n = 12, 75 inputs) and A4 (``small()`` in bf16)."""
    big = NeRFConfig(num_layers=8, filter_size=1024, num_samples=128, mode="standard",
                     init="nerf", compute_dtype="bfloat16")
    out = {}
    for L, W in ((3, 384), (4, 512)):
        for cdt in ("float32", "bfloat16"):
            out[f"{L}x{W} {cdt}"] = NeRFConfig(num_layers=L, filter_size=W, num_samples=32,
                                               compute_dtype=cdt)
    out["8x1024 bfloat16"] = big
    for cdt in ("float32", "bfloat16"):
        out[f"1x(75->4) {cdt}"] = NeRFConfig(num_layers=1, num_encoding_functions=12,
                                             num_samples=32, mode="standard",
                                             compute_dtype=cdt)
    out["small bfloat16"] = NeRFConfig(compute_dtype="bfloat16")
    return out


def jittered_depths(rng, cfg, n):
    """Sorted uniform (N, S) depths and their steps (the 1e8 sentinel last)."""
    S = cfg.num_samples
    tj = np.sort(rng.uniform(cfg.near, cfg.far, (n, S)), axis=1)
    dj = np.concatenate([np.diff(tj, axis=1), np.full((n, 1), 1e8)], axis=1)
    return tuple(torch.tensor(x, dtype=torch.float32, device="cuda") for x in (tj, dj))


def phase_widths(fused_nerf, NeRFConfig, make_single_chip_train_step, mlp_layer_sizes,
                 train_nerf, smi, tmp, seed=31):
    """Phase 24: the wide kernels at the shapes C4 and A4 opened
    (:func:`width_configs`) against their plain versions on 1037 rays, at
    shared and per-ray depths: render, train loss and dW/db, render backward
    at phases 4 and 7's bounds (:func:`wide_tolerances`), repeat launches
    bit-identical, only wide launches.  Then the 8x1024 bf16 step at 16,384
    rays (Adam 5e-4): a few steps timed by CUDA events, its TFLOP/s and
    share of the bf16 peak; each wide entry point's own call there; the
    step in turns with the plain version at 4096 rays (16,384 rays of the
    plain version's f32 activations do not fit beside the kernels'
    scratch); ``train_nerf --layers 8 --width 1024 --samples 128 --steps 3``
    (f32) through the wide train kernel.  Returns (worst |kernel - plain|
    per entry point, timings, bounds, launches of the driver run)."""
    rng = np.random.default_rng(seed)
    worst = dict.fromkeys([n + s for n in WIDE for s in ("", "_rays")], 0.0)
    for name, cfg in width_configs(NeRFConfig).items():
        params = seeded_params(rng, cfg)
        leaves = leaves_of(params)
        kind, pw = fused_nerf._route(cfg, params)
        if kind != "wide":
            raise AssertionError(f"{name}: routed {kind}")
        o, d = seeded_rays(rng, N_CHECK)
        tgt = torch.tensor(rng.random((N_CHECK, 3)), dtype=torch.float32, device="cuda")
        cot = torch.tensor(rng.standard_normal((N_CHECK, 3)), dtype=torch.float32,
                           device="cuda")
        col_atol, loss_rtol, _ = wide_tolerances(cfg)
        for depths, suf in ((uniform_depths(cfg), ""), (jittered_depths(rng, cfg, N_CHECK),
                                                          "_rays")):
            t, dists = depths

            def train(loss_fn):
                loss = loss_fn(params, o, d, t, dists, tgt, cfg)
                return (loss.detach(), *torch.autograd.grad(loss, leaves))

            def render_bwd(render_fn):
                out = render_fn(params, o, d, t, dists, cfg)
                return torch.autograd.grad((out * cot).sum(), leaves)

            reset_launches(fused_nerf)
            with torch.no_grad():
                c1 = fused_nerf.render_rays(params, o, d, t, dists, cfg)
                c2 = fused_nerf.render_rays(params, o, d, t, dists, cfg)
            k1, k2 = train(fused_nerf.nerf_train_loss), train(fused_nerf.nerf_train_loss)
            b1, b2 = render_bwd(fused_nerf.render_rays), render_bwd(fused_nerf.render_rays)
            torch.cuda.synchronize()
            got = {k: v for k, v in fused_nerf.launches.items() if v}
            want = {"nerf_wide_render_fwd" + suf: 4, "nerf_wide_train" + suf: 2,
                    "nerf_wide_render_bwd" + suf: 2}
            if got != want:
                raise AssertionError(f"{name}{suf}: launches {got}, expected {want}")
            with torch.no_grad():
                cp = fused_nerf.render_rays_reference(params, o, d, t, dists, cfg)
            p = train(fused_nerf.nerf_train_loss_reference)
            q = render_bwd(fused_nerf.render_rays_reference)
            if not all(torch.equal(x, y) for x, y in zip((c1, *k1, *b1), (c2, *k2, *b2))):
                raise AssertionError(f"{name}{suf}: repeat launches differ")
            what = f"{name} pw={pw} S={cfg.num_samples} {cfg.mode}{suf or ' shared'}"
            e_fwd = (c1 - cp).abs().max().item()
            torch.testing.assert_close(c1, cp, atol=col_atol, rtol=RTOL)
            loss_err = abs(k1[0].item() - p[0].item())
            torch.testing.assert_close(k1[0], p[0], rtol=loss_rtol, atol=0.0)
            e_tr = wide_grads_close(k1[1:], p[1:], f"nerf_wide_train {what}", cfg)
            e_bw = wide_grads_close(b1, q, f"nerf_wide_render_bwd {what}", cfg)
            for k, e in (("render_fwd", e_fwd), ("train", max(e_tr, loss_err)),
                         ("render_bwd", e_bw)):
                worst["nerf_wide_" + k + suf] = max(worst["nerf_wide_" + k + suf], e)
            print(f"phase 24 {what} N={N_CHECK}: max|kernel-plain| render {e_fwd:.3e}; "
                  f"loss {k1[0].item():.6e} (|kernel-plain| {loss_err:.3e}); dW,db train "
                  f"{e_tr:.3e}, render bwd {e_bw:.3e} (of the largest entry: train "
                  f"{leaf_errors(k1[1:], p[1:])}); repeat launches bit-identical; launches "
                  f"{got}")
        del params, leaves

    # the 8x1024 bf16 step at the flagship batch, and each entry alone
    cfg = width_configs(NeRFConfig)["8x1024 bfloat16"]
    fwd, bwd = mlp_macs(mlp_layer_sizes(cfg.in_channels, cfg.out_channels, cfg.num_layers,
                                        cfg.filter_size))
    S = cfg.num_samples
    params = seeded_params(np.random.default_rng(0), cfg)
    leaves = leaves_of(params)
    opt = torch.optim.Adam(leaves, lr=5e-4)
    step = make_single_chip_train_step(cfg, opt)
    batch = bench_batch(np.random.default_rng(0), cfg, WIDTHS_RAYS)
    losses = [step(params, *batch).item()]  # warm-up
    ms = [cuda_ms(lambda: step(params, *batch))[0] for _ in range(WIDTHS_STEPS)]
    med = statistics.median(ms)
    flop = 2.0 * bwd * WIDTHS_RAYS * S
    print(f"phase 24 8x1024 bf16 train step, {WIDTHS_RAYS} rays x {S} samples, Adam 5e-4, "
          f"on {smi}: {spread(ms)}; {flop / med / 1e9:.1f} TFLOP/s, "
          f"{flop / med / 1e9 / (PEAK_BF16 / 1e12) * 100:.1f}% of the bf16 peak; "
          f"first loss {losses[0]:.6e}")
    cot = torch.tensor(np.random.default_rng(1).standard_normal((WIDTHS_RAYS, 3)),
                       dtype=torch.float32, device="cuda")
    o, d, t, dists, tgt = batch

    def call(name):
        if name == "nerf_wide_render_fwd":
            def run():
                with torch.no_grad():
                    return fused_nerf.render_rays(params, o, d, t, dists, cfg)
        elif name == "nerf_wide_train":
            def run():
                loss = fused_nerf.nerf_train_loss(params, o, d, t, dists, tgt, cfg)
                return torch.autograd.grad(loss, leaves)
        else:
            out = fused_nerf.render_rays(params, o, d, t, dists, cfg)

            def run():
                return torch.autograd.grad(out, leaves, cot, retain_graph=True)
        return run

    timing, bounds = {}, {}
    for name in WIDE:
        fn = call(name)
        fn()
        ts = [cuda_ms(fn)[0] for _ in range(3)]
        macs = fwd if name == "nerf_wide_render_fwd" else bwd
        bounds[name] = bound(WIDTHS_RAYS * S * macs, PEAK_BF16, WIDTHS_RAYS * 36)
        timing[name] = statistics.median(ts)
        print(f"phase 24 {name} alone, 8x1024 bf16, {WIDTHS_RAYS} rays x {S}: {spread(ts)}; "
              f"bound {bounds[name][0]:.3f} ms ({bounds[name][1]}), "
              f"{bounds[name][0] / timing[name] * 100:.1f}% of it")
    del batch, o, d, t, dists, tgt, cot, opt, step

    # kernels and plain in turns at 4096 rays, from one init
    small_batch = bench_batch(np.random.default_rng(2), cfg, WIDTHS_PLAIN_RAYS)
    runs = {}
    for backend in ("auto", "plain"):
        prm = seeded_params(np.random.default_rng(0), cfg)
        opt = torch.optim.Adam(leaves_of(prm), lr=5e-4)
        def plain_step(p, *b, _opt=opt):  # the plain version of the same loss
            _opt.zero_grad(set_to_none=True)
            loss = fused_nerf.nerf_train_loss_reference(p, *b, cfg)
            loss.backward()
            _opt.step()
            return loss.detach()

        st = make_single_chip_train_step(cfg, opt) if backend == "auto" else plain_step
        runs[backend] = (lambda p=prm, s=st: s(p, *small_batch))
    first = {k: fn().item() for k, fn in runs.items()}
    turns = timed_turns(runs, 2)
    plain_ms = statistics.median(turns["plain"])
    print(f"phase 24 8x1024 bf16 train step at {WIDTHS_PLAIN_RAYS} rays, in turns: kernels "
          f"{spread(turns['auto'])}, plain {spread(turns['plain'])}; first losses kernel "
          f"{first['auto']:.6e} plain {first['plain']:.6e} (at {WIDTHS_RAYS} rays the plain "
          "version's f32 activations do not fit beside the kernels' scratch)")
    torch.testing.assert_close(torch.tensor(first["auto"]), torch.tensor(first["plain"]),
                               rtol=1e-4, atol=0.0)
    del runs, small_batch, params, leaves
    torch.cuda.empty_cache()
    f32_step = phase_f32_step(fused_nerf, cfg, make_single_chip_train_step, fwd, bwd, smi)

    # train_nerf at 8x1024 (f32, the compute dtype it trains in)
    reset_launches(fused_nerf)
    t0 = time.perf_counter()
    out = train_nerf.main(["--device", "cuda", "--data", "synthetic", "--img-size", "64",
                           "--layers", "8", "--width", "1024", "--samples", "128",
                           "--steps", "3", "--eval-every", "2", "--ckpt-every", "0",
                           "--log-dir", os.path.join(tmp, "logs_1024"),
                           "--ckpt-dir", os.path.join(tmp, "ck_1024")])
    secs = time.perf_counter() - t0
    driver = {k: v for k, v in fused_nerf.launches.items() if v}
    if driver.get("nerf_wide_train") != 3 or not np.all(np.isfinite(out["losses"])):
        raise AssertionError(f"train_nerf 8x1024: launches {driver}, losses {out['losses']}")
    print(f"phase 24 train_nerf --layers 8 --width 1024 --samples 128 --steps 3 (f32): "
          f"{secs:.1f} s host time; losses {[round(x, 4) for x in out['losses']]}; launches "
          f"{driver}")
    timing = {k: (v, plain_ms if k == "nerf_wide_train" else None) for k, v in timing.items()}
    return worst, timing, bounds, driver, f32_step


def phase_f32_step(fused_nerf, cfg, make_single_chip_train_step, fwd_macs, bwd_macs, smi):
    """Phase 24, the 8x1024 MLP at f32 compute (the ``train_nerf --layers 8
    --width 1024`` default: every product on the f32 GEMM,
    ``nerf_wide_f32_gemm.cuh``): the Adam 5e-4 step at 4096 rays through
    the kernels and the plain version from one init, in turns, first losses
    within rtol 1e-5; its share of the f32 bound (dW, d_h and the forward
    again at 67 TFLOP/s); each wide entry point's own call there at shared
    and per-ray depths against its f32 bound.  Returns their numbers."""
    cfg = dataclasses.replace(cfg, compute_dtype="float32")
    batch = bench_batch(np.random.default_rng(2), cfg, WIDTHS_PLAIN_RAYS)
    runs = {}
    for backend in ("auto", "plain"):
        prm = seeded_params(np.random.default_rng(0), cfg)
        opt = torch.optim.Adam(leaves_of(prm), lr=5e-4)

        def plain_step(p, *b, _opt=opt):
            _opt.zero_grad(set_to_none=True)
            loss = fused_nerf.nerf_train_loss_reference(p, *b, cfg)
            loss.backward()
            _opt.step()
            return loss.detach()

        st = make_single_chip_train_step(cfg, opt) if backend == "auto" else plain_step
        runs[backend] = (lambda p=prm, s=st: s(p, *batch))
    first = {k: fn().item() for k, fn in runs.items()}
    torch.testing.assert_close(torch.tensor(first["auto"]), torch.tensor(first["plain"]),
                               rtol=1e-5, atol=0.0)
    turns = timed_turns(runs, 2)
    rows = WIDTHS_PLAIN_RAYS * cfg.num_samples
    bd = bound(rows * bwd_macs, PEAK_F32, 0)
    med = {k: statistics.median(v) for k, v in turns.items()}
    print(f"phase 24 8x1024 f32 train step at {WIDTHS_PLAIN_RAYS} rays x {cfg.num_samples}, "
          f"Adam 5e-4, on {smi}, in turns: kernels {spread(turns['auto'])}, plain "
          f"{spread(turns['plain'])}; {2.0 * rows * bwd_macs / med['auto'] / 1e9:.1f} TFLOP/s, "
          f"{bd[0] / med['auto']:.1%} of its f32 bound {bd[0]:.3f} ms ({bd[1]}); first losses "
          f"kernel {first['auto']:.6e} plain {first['plain']:.6e}")
    del runs
    # each wide entry point's own call there, at shared and per-ray depths
    o, d, t, dists, tgt = batch
    jit = jittered_depths(np.random.default_rng(3), cfg, WIDTHS_PLAIN_RAYS)
    params = seeded_params(np.random.default_rng(0), cfg)
    leaves = leaves_of(params)
    cot = torch.tensor(np.random.default_rng(1).standard_normal((WIDTHS_PLAIN_RAYS, 3)),
                       dtype=torch.float32, device="cuda")
    entries = {}
    for (tt, dd), suf in (((t, dists), ""), (jit, "_rays")):
        def render(tt=tt, dd=dd):
            with torch.no_grad():
                return fused_nerf.render_rays(params, o, d, tt, dd, cfg)

        def train(tt=tt, dd=dd):
            loss = fused_nerf.nerf_train_loss(params, o, d, tt, dd, tgt, cfg)
            return torch.autograd.grad(loss, leaves)
        out = fused_nerf.render_rays(params, o, d, tt, dd, cfg)

        def render_bwd(out=out):
            return torch.autograd.grad(out, leaves, cot, retain_graph=True)
        for name, fn, macs in (("nerf_wide_render_fwd", render, fwd_macs),
                               ("nerf_wide_train", train, bwd_macs),
                               ("nerf_wide_render_bwd", render_bwd, bwd_macs)):
            fn()
            ts = [cuda_ms(fn)[0] for _ in range(3)]
            ebd = bound(rows * macs, PEAK_F32, WIDTHS_PLAIN_RAYS * 36)
            entries[name + suf] = {"ms": statistics.median(ts), "bound_ms": ebd[0],
                                   "bound_by": ebd[1]}
            print(f"phase 24 {name + suf} alone, 8x1024 f32, {WIDTHS_PLAIN_RAYS} rays x "
                  f"{cfg.num_samples}: {spread(ts)}; f32 bound {ebd[0]:.3f} ms ({ebd[1]}), "
                  f"{ebd[0] / statistics.median(ts):.1%} of it")
        del out
    del batch, o, d, t, dists, tgt, jit, params, leaves, cot
    torch.cuda.empty_cache()
    return {"rays": WIDTHS_PLAIN_RAYS, "ms": med["auto"], "plain_ms": med["plain"],
            "bound_ms": bd[0], "bound_by": bd[1], "share": bd[0] / med["auto"],
            "entries": entries}


# the f32 GEMM alone at the field's layer: the rows of one hidden layer of
# the 4x256 field at 512x512 (phase 25's cell)
F32_GEMM_ROWS = 512 * 512


def phase_f32_gemm(fused_nerf, f32_gemm, NeRFConfig, smi, seed=47):
    """Phase 24, the f32 GEMM alone (``f32_gemm``: ``nerf_wide_f32_gemm.cuh``,
    the forward, ``d_h`` and dW forms) at one hidden layer of the 4x256
    field at 512x512 (262,144 x 256 . 256 x 256) and at one gradient
    chunk's hidden layer of the f32 8x1024 MLP (rows x 1024 . 1024 x 1024):
    within 1e-5 of the largest entry of the plain version, repeats
    bit-identical; timed in turns with the plain version and the library
    call (``torch.addmm`` + ``relu_``, or ``torch.mm``; f32, TF32 off),
    against its bound.  Returns {shape: {form: numbers}}."""
    out = {}
    g = torch.Generator("cuda").manual_seed(seed)
    big = dataclasses.replace(width_configs(NeRFConfig)["8x1024 bfloat16"],
                              compute_dtype="float32")
    for name, rows, pw in (("field 4x256", F32_GEMM_ROWS, 256),
                           ("8x1024 f32", fused_nerf.wide_grad_chunk_rays(big, 1024, 8)
                            * big.num_samples, 1024)):
        h = torch.rand((rows, pw), generator=g, device="cuda")
        dz = torch.randn((rows, pw), generator=g, device="cuda")
        mask = torch.randn((rows, pw), generator=g, device="cuda")
        W = torch.randn((pw, pw), generator=g, device="cuda") / pw ** 0.5
        b = torch.randn(pw, generator=g, device="cuda") * 0.1
        kc = 8192
        act = 4 * rows * pw  # bytes of one (rows, pw) f32 operand
        forms = {
            "forward": ({"kernel": lambda: f32_gemm.f32_layer_gemm(h, W, b, pw),
                         "plain": lambda: f32_gemm.layer_reference(h, W, b, pw),
                         "library": lambda: torch.addmm(b, h, W).relu_()},
                        2 * act + 4 * (pw * pw + pw)),
            "d_h": ({"kernel": lambda: f32_gemm.f32_dh_gemm(dz, W, mask, pw),
                     "plain": lambda: f32_gemm.dh_reference(dz, W, mask, pw),
                     "library": lambda: torch.mm(dz, W.T)},
                    3 * act + 4 * pw * pw),
            "dW": ({"kernel": lambda: f32_gemm.f32_dw_gemm(h, dz, pw, kc),
                    "plain": lambda: f32_gemm.dw_reference(h, dz, pw, kc),
                    "library": lambda: torch.mm(h.T, dz)},
                   2 * act + 4 * -(-rows // kc) * pw * pw)}
        out[name] = {}
        for form, (fns, nbytes) in forms.items():
            got, again, plain = fns["kernel"](), fns["kernel"](), fns["plain"]()
            torch.cuda.synchronize()
            same = torch.equal(got.view(torch.int32), again.view(torch.int32))
            err = (got - plain).abs().max().item()
            if not same or err > 1e-5 * plain.abs().max().item():
                raise AssertionError(f"f32 GEMM {form} at {name}: repeats bit-identical {same}, "
                                     f"|kernel - plain| {err:.3e} of "
                                     f"{plain.abs().max().item():.3e}")
            del got, again, plain
            ts = timed_turns(fns, 3)
            med = {k: statistics.median(v) for k, v in ts.items()}
            bd = bound(rows * pw * pw, PEAK_F32, nbytes)
            out[name][form] = {"ms": med["kernel"],
                               "plain_ms": med["plain"], "library_ms": med["library"],
                               "bound_ms": bd[0], "bound_by": bd[1], "share": bd[0] / med["kernel"],
                               "max_abs_err": err, "rows": rows, "pw": pw}
            print(f"phase 24 f32 GEMM {form} at {name} ({rows} x {pw} . {pw} x {pw}) on {smi}: "
                  f"kernel {spread(ts['kernel'])}, "
                  f"{2.0 * rows * pw * pw / med['kernel'] / 1e9:.1f} TFLOP/s, "
                  f"{bd[0] / med['kernel']:.1%} of its bound {bd[0]:.3f} ms ({bd[1]}); "
                  f"plain {med['plain']:.3f}, "
                  f"{'addmm + relu_' if form == 'forward' else 'mm'} {med['library']:.3f}; "
                  f"repeats bit-identical, max|kernel-plain| {err:.3e}")
        del h, dz, mask, W, b
        torch.cuda.empty_cache()
    return out


def phase_c4_split(fused_nerf, NeRFConfig):
    """Phase 24, the 8x1024 bf16 step's and render's device time by kernel
    family (``card_probe --what flagship|frame --config c4``, processes of
    their own, 16,384 rays): every bf16 forward layer and every ``d_h`` of
    the step's gradient chunks, and every layer of the render's ray chunks,
    on the wgmma/TMA layer GEMM, none on ``gemm_mma_kernel``.  Returns both
    splits."""
    cfg = width_configs(NeRFConfig)["8x1024 bfloat16"]
    pw = fused_nerf._round_up(cfg.filter_size, 128)
    out = {"step": card_probe("flagship", "--config", "c4", "--steps", "2"),
           "frame": card_probe("frame", "--config", "c4")}
    chunks = -(-WIDTHS_RAYS // fused_nerf.wide_grad_chunk_rays(cfg, pw, cfg.num_layers))
    layer_gemm_launches(out["step"]["launches_per_step"], cfg, chunks, "8x1024 step")
    layer_gemm_launches(out["frame"]["launches_per_frame"], cfg, out["frame"]["chunks"],
                        "8x1024 render", train=False)
    for what, split in out.items():
        total = split["device_ms_per_step" if what == "step" else "device_ms_per_frame"]
        print(f"phase 24 8x1024 bf16 {what} split ({WIDTHS_RAYS} rays): device {total:.3f} ms; "
              + ", ".join(f"{k} {v:.3f} ms ({split['share'][k]:.1%})"
                          for k, v in split["ms"].items() if v))
    return {what: {"device_ms": split.get("device_ms_per_step", split.get(
        "device_ms_per_frame")), "ms": {k: v for k, v in split["ms"].items() if v}}
        for what, split in out.items()}


def phase_layer_gemm(fused_nerf, wide_gemm, NeRFConfig, smi, seed=41):
    """Phase 24, the wide chain's bf16 layer GEMM alone (``wide_gemm``: the
    wgmma/TMA kernel, both forms) at one gradient chunk's hidden layer of the
    8x1024 MLP (598,784 x 1024 . 1024 x 1024) and of the flagship (2,391,296
    x 256 . 256 x 256): within the plain version's bounds (the forward one
    bf16 rounding step of the entry plus 1e-5 of the largest, a ReLU at f32
    rounding of 0; ``d_h`` 1e-5 of its largest entry), repeats
    bit-identical; timed in turns with the plain version and (the forward)
    ``torch.addmm`` + ``relu_`` in bf16, against its bound.  Returns
    {shape: {form: numbers}}."""
    out = {}
    g = torch.Generator("cuda").manual_seed(seed)
    for name, cfg in (("8x1024", width_configs(NeRFConfig)["8x1024 bfloat16"]),
                      ("flagship", NeRFConfig.full())):
        pw = fused_nerf._round_up(cfg.filter_size, 128)
        rows = fused_nerf.wide_grad_chunk_rays(cfg, pw, cfg.num_layers) * cfg.num_samples
        a = torch.randn((rows, pw), generator=g, device="cuda").to(torch.bfloat16)
        W = (torch.randn((pw, pw), generator=g, device="cuda") / pw ** 0.5).to(torch.bfloat16)
        b = torch.randn(pw, generator=g, device="cuda") * 0.1
        mask = torch.relu(a)
        flop_macs = rows * pw * pw
        forms = {
            "forward": ({"kernel": lambda: wide_gemm.wide_layer_gemm(a, W, b, pw),
                         "plain": lambda: wide_gemm.layer_reference(a, W, b, pw),
                         "addmm": lambda: torch.addmm(b.to(torch.bfloat16), a, W).relu_()},
                        2 * (2 * rows * pw + pw * pw) + 4 * pw),
            "d_h": ({"kernel": lambda: wide_gemm.wide_dh_gemm(a, W, mask, pw),
                     "plain": lambda: wide_gemm.dh_reference(a, W, mask, pw)},
                    2 * (2 * rows * pw + pw * pw) + 6 * rows * pw)}
        out[name] = {}
        for form, (fns, nbytes) in forms.items():
            got, again, plain = fns["kernel"](), fns["kernel"](), fns["plain"]()
            torch.cuda.synchronize()
            if form == "forward":
                same = torch.equal(got, again)
                diff = (got.float() - plain.float()).abs()
                step = torch.ldexp(torch.ones_like(diff), torch.frexp(
                    torch.maximum(got.float().abs(), plain.float().abs()))[1] - 8)
                ok = bool((diff <= step + 1e-5 * plain.float().abs().max()).all())
                err = diff.max().item()
            else:
                same = all(torch.equal(x, y) for x, y in zip(got, again))
                err = (got[0] - plain[0]).abs().max().item()
                ok = err <= 1e-5 * plain[0].abs().max().item()
            if not same or not ok:
                raise AssertionError(f"layer GEMM {form} at {name}: repeats bit-identical "
                                     f"{same}, |kernel - plain| {err:.3e} within bounds {ok}")
            del got, again, plain
            ts = timed_turns(fns, 3)
            med = {k: statistics.median(v) for k, v in ts.items()}
            bd = bound(flop_macs, PEAK_BF16, nbytes)
            out[name][form] = {"ms": med["kernel"],
                               "plain_ms": med["plain"], "library_ms": med.get("addmm"),
                               "bound_ms": bd[0], "bound_by": bd[1], "max_abs_err": err,
                               "rows": rows, "pw": pw}
            print(f"phase 24 layer GEMM {form} at {name}'s chunk ({rows} x {pw} . {pw} x {pw}, "
                  f"bf16, f32 sums) on {smi}: wgmma {spread(ts['kernel'])}, "
                  f"{2.0 * flop_macs / med['kernel'] / 1e9:.1f} TFLOP/s, "
                  f"{bd[0] / med['kernel']:.1%} of its bound {bd[0]:.3f} ms ({bd[1]}); "
                  f"plain {med['plain']:.3f}"
                  + (f", addmm + relu_ {med['addmm']:.3f}" if "addmm" in med else "")
                  + f"; repeats bit-identical, max|kernel-plain| {err:.3e}")
        del a, W, b, mask
        torch.cuda.empty_cache()
    return out


FIELD_WIDE_SIZE = 512  # Tancik et al.'s image-regression resolution
FIELD_WIDE_STEPS = 200


def field_wide_configs(ImageFieldConfig):
    """Phase 25's fields: 4x256 (the image-regression network of Tancik et
    al., "Fourier Features Let Networks Learn High Frequency Functions",
    NeurIPS 2020: 4 layers, 256 channels, ReLU, sigmoid) with the repo's
    n = 8 encoding; 8x128 (past a tile's shared memory); a 3D-coordinate
    field with a 16-channel head.  (config, coordinate dimension, output
    channels)."""
    return {"4x256": (ImageFieldConfig(num_layers=4, filter_size=256,
                                       num_encoding_functions=8), 2, 3),
            "8x128": (ImageFieldConfig(num_layers=8, filter_size=128,
                                       num_encoding_functions=8), 2, 3),
            "3d 3x64 16ch": (ImageFieldConfig(num_layers=3, filter_size=64,
                                              num_encoding_functions=5), 3, 16)}


def field_params_for(rng, mlp_layer_sizes, cfg, D, out):
    sizes = mlp_layer_sizes(D * (1 + 2 * cfg.num_encoding_functions), out, cfg.num_layers,
                            cfg.filter_size)
    return {"w": [torch.tensor(rng.standard_normal(s) * np.sqrt(2.0 / s[0]),
                               dtype=torch.float32, device="cuda") for s in sizes],
            "b": [torch.tensor(rng.standard_normal(s[1]) * 0.5, dtype=torch.float32,
                               device="cuda") for s in sizes]}


def phase_field_wide(fused_mlp, ImageFieldConfig, image_grid_coords, mlp_layer_sizes,
                     make_image_fit_step, fit_image, smi, tmp, seed=37):
    """Phase 25: the wide field route (``field_wide.cu``) against its plain
    version on both product routes of ``FIELD_TIERS`` ("high": 3xTF32 on the
    tensor cores, ``field_wide_gemm.cuh``; "highest": exact f32 FMAs): 8x128
    and the 3D 16-channel field on 1037 points (phase 10's bounds), the
    4x256 field over the whole 512x512 image (outputs within 1e-4, dW/db
    within ``FIELD_IMAGE_GRAD`` of the leaf's largest entry), each tier's
    repeat launches bit-identical, the two tiers' outputs apart; each
    kernel's own call on both tiers at 512x512 against the plain version
    and its 3xTF32 and f32 bounds, and the fit step (Adam) through the
    kernels ("high", the config's tier) and the plain backend in turns;
    then 200 ``fit_image`` steps at 4x256 on 512x512 (``--layers 4 --width
    256 --img-size 512 --enc-functions 8``) through the kernels and the
    plain backend from one init: PSNR >= 8 dB above step 0 and within 0.3
    dB of plain, the step's ms in turns.  Returns (worst per kernel over
    both tiers, timings ("high"), bounds (3xTF32, as phase 12's), launches
    of the kernel run, extra: the "highest" tier's times and the fit
    step's)."""
    rng = np.random.default_rng(seed)
    worst = {"field_wide_fwd": 0.0, "field_wide_bwd": 0.0}

    def kernel(tier, out):
        return lambda params, coords, nf: fused_mlp.field_forward(params, coords, nf, out,
                                                                  precision=tier)

    def plain(out):
        return lambda params, coords, nf: fused_mlp.field_forward_reference(params, coords,
                                                                            nf, out)
    for name, (cfg, D, out) in field_wide_configs(ImageFieldConfig).items():
        nf = cfg.num_encoding_functions
        params = field_params_for(rng, mlp_layer_sizes, cfg, D, out)
        if fused_mlp.kernel_width(params, D, nf, out) is not None:
            raise AssertionError(f"field {name}: routed to the tile kernels")
        big = name == "4x256"
        n = FIELD_WIDE_SIZE ** 2 if big else N_CHECK
        coords = image_grid_coords(FIELD_WIDE_SIZE, "cuda") if big else torch.tensor(
            rng.random((n, D)), dtype=torch.float32, device="cuda")
        cot = torch.tensor(rng.standard_normal((n, out)), dtype=torch.float32, device="cuda")
        p = field_grads(plain(out), params, coords, cot, nf)
        got = {}
        for tier in FIELD_TIERS:
            reset_launches(fused_mlp)
            k1 = field_grads(kernel(tier, out), params, coords, cot, nf)
            k2 = field_grads(kernel(tier, out), params, coords, cot, nf)
            torch.cuda.synchronize()
            if fused_mlp.launches["field_wide_fwd"] != 2 or \
                    fused_mlp.launches["field_wide_bwd"] != 2 or \
                    fused_mlp.launches["field_fwd"] or fused_mlp.launches["field_bwd"]:
                raise AssertionError(f"field {name} {tier}: launches {fused_mlp.launches}")
            if not all(torch.equal(a, b) for a, b in zip((k1[0], *k1[1]), (k2[0], *k2[1]))):
                raise AssertionError(f"field {name} {tier}: repeat launches differ")
            if k1[2] is not None:
                raise AssertionError(f"field {name} {tier}: the coords got a gradient")
            # autograd's backward reads the activations its forward kept (one
            # chunk); recomputed, they give the same bits
            dims = fused_mlp.field_wide_dims(params, D, out)
            packed = fused_mlp.pack_field_wide(params, dims[2], out)
            again = fused_mlp.unpack_field_wide(*fused_mlp._launch_wide_bwd(
                *packed, coords, cot, nf, dims, fused_mlp.exact_tier(tier)), params)
            if not all(torch.equal(x, y) for x, y in zip(again, k1[1])):
                raise AssertionError(f"field {name} {tier}: the recomputed forward's dW/db "
                                     "differ from the kept activations'")
            e_f = (k1[0] - p[0]).abs().max().item()
            torch.testing.assert_close(k1[0], p[0], atol=ATOL, rtol=RTOL)
            if big:
                e_b = max(((a - b).abs().max() / b.abs().max()).item()
                          for a, b in zip(k1[1], p[1]))
                grads_close(k1[1], p[1], f"field_wide_bwd {name} {tier}", 0.0,
                            lambda w: FIELD_IMAGE_GRAD * w.abs().max().item())
                e_abs = max((a - b).abs().max().item() for a, b in zip(k1[1], p[1]))
            else:
                e_b = e_abs = grads_close(k1[1], p[1], f"field_wide_bwd {name} {tier}",
                                          GRAD_RTOL, grad_atol)
            worst["field_wide_fwd"] = max(worst["field_wide_fwd"], e_f)
            worst["field_wide_bwd"] = max(worst["field_wide_bwd"], e_abs)
            got[tier] = k1
            print(f"phase 25 field {name} (D={D}, {out} channels, n={nf}) on {n} points, "
                  f"\"{tier}\": max|kernel-plain| forward {e_f:.3e}, dW/db {e_b:.3e}"
                  f"{' of the leaf largest entry' if big else ''}; repeat launches and the "
                  f"recomputed forward's backward bit-identical; coords gradient None")
        a, b = got["high"], got["highest"]
        if torch.equal(a[0], b[0]):
            raise AssertionError(f"field {name}: the \"high\" and \"highest\" outputs are "
                                 "the same bits (one product route)")
        print(f"  {name}: max|high - highest| forward {(a[0] - b[0]).abs().max().item():.3e}, "
              f"dW/db {max((x - y).abs().max().item() for x, y in zip(a[1], b[1])):.3e}")
        del got, a, b, k1, k2, p

    # each kernel's own call at 4x256 on 512x512 on both tiers, against the
    # plain version
    cfg, D, out = field_wide_configs(ImageFieldConfig)["4x256"]
    nf = cfg.num_encoding_functions
    params = field_params_for(np.random.default_rng(0), mlp_layer_sizes, cfg, D, out)
    leaves = leaves_of(params)
    coords = image_grid_coords(FIELD_WIDE_SIZE, "cuda")
    n_px = coords.shape[0]
    cot = torch.tensor(np.random.default_rng(1).standard_normal((n_px, out)),
                       dtype=torch.float32, device="cuda")
    fwd, bwd = mlp_macs(mlp_layer_sizes(D * (1 + 2 * nf), out, cfg.num_layers,
                                        cfg.filter_size))
    outs = {tier: fused_mlp.field_forward(params, coords, nf, out, precision=tier)
            for tier in FIELD_TIERS}
    p_out = fused_mlp.field_forward_reference(params, coords, nf, out)
    calls = {}
    for tier in FIELD_TIERS:
        calls[f"fwd {tier}"] = (lambda t=tier: fused_mlp.field_forward(params, coords, nf, out,
                                                                       precision=t))
        calls[f"bwd {tier}"] = (lambda t=tier: torch.autograd.grad(outs[t], leaves, cot,
                                                                   retain_graph=True))
    calls["fwd plain"] = lambda: fused_mlp.field_forward_reference(params, coords, nf, out)
    calls["bwd plain"] = lambda: torch.autograd.grad(p_out, leaves, cot, retain_graph=True)
    # the fit step (Adam 1e-3) through the kernels and the plain backend
    target = torch.rand((n_px, out), generator=torch.Generator("cuda").manual_seed(2),
                        device="cuda")
    for tier, backend, key in (("high", "auto", "step"), ("highest", "auto", "step highest"),
                               ("high", "plain", "plain step")):
        prm = {k: [x.detach().clone().requires_grad_(True) for x in v]
               for k, v in params.items()}
        fit_step = make_image_fit_step(dataclasses.replace(cfg, precision=tier),
                                       torch.optim.Adam(leaves_of(prm), lr=1e-3), backend)
        calls[key] = lambda s=fit_step, p=prm: s(p, coords, target)
    turns = timed_turns(calls, 3)
    timing, bounds, tiers, f32_share = {}, {}, {}, {}
    n_par = sum(x.numel() for x in leaves)
    # the least time of the function the fit runs: the "high" tier (the
    # config's default), which 3xTF32 meets, as phase 12 bounds #13/#14;
    # the f32 FMA bound ("highest"'s own products) printed beside it.  The
    # timed backward reads the activations its forward kept (L x n x pw
    # floats): its work is dW and d_h, no recomputed forward
    L, pw = len(params["w"]), fused_mlp.field_wide_dims(params, D, out)[2]
    for name, kind, macs, nbytes in (
            ("field_wide_fwd", "fwd", fwd, n_px * 4 * (D + out) + 4 * n_par),
            ("field_wide_bwd", "bwd", bwd - fwd, n_px * 4 * (out + L * pw) + 8 * n_par)):
        bounds[name] = bound(TF32_PASSES * n_px * macs, PEAK_TF32, nbytes)
        f32_bound = bound(n_px * macs, PEAK_F32, nbytes)
        plain_ms = statistics.median(turns[f"{kind} plain"])
        for tier in FIELD_TIERS:
            ms = statistics.median(turns[f"{kind} {tier}"])
            tiers.setdefault(name, {})[tier] = ms
            if tier == "highest":
                f32_share[name] = f32_bound[0] / ms
            print(f"phase 25 {name} \"{tier}\" alone, 4x256 at {FIELD_WIDE_SIZE}x"
                  f"{FIELD_WIDE_SIZE}, on {smi}: kernel {spread(turns[f'{kind} {tier}'])}, "
                  f"plain {spread(turns[f'{kind} plain'])}; "
                  f"{2.0 * n_px * macs / ms / 1e9:.2f} TFLOP/s; 3xTF32 bound "
                  f"{bounds[name][0]:.4f} ms ({bounds[name][1]}, "
                  f"{bounds[name][0] / ms:.1%} of it); f32 bound {f32_bound[0]:.4f} ms "
                  f"({f32_bound[1]}, {f32_bound[0] / ms:.1%} of it)")
        timing[name] = (tiers[name]["high"], plain_ms)
    step_ms = {k: statistics.median(turns[k]) for k in ("step", "step highest", "plain step")}
    print(f"phase 25 fit step, 4x256 at {FIELD_WIDE_SIZE}x{FIELD_WIDE_SIZE}, Adam 1e-3, in "
          f"turns: kernels \"high\" {spread(turns['step'])}, \"highest\" "
          f"{spread(turns['step highest'])}, plain {spread(turns['plain step'])}; "
          f"{n_px / step_ms['step'] * 1e3:.4e} px/s (\"high\"), "
          f"{n_px / step_ms['step highest'] * 1e3:.4e} (\"highest\")")
    del outs, p_out, calls, params, leaves

    base = ["--device", "cuda", "--img", "synthetic", "--optimizer", "adam", "--ckpt-every",
            "0", "--img-size", str(FIELD_WIDE_SIZE), "--layers", "4", "--width", "256",
            "--enc-functions", "8", "--lr", "1e-3", "--log-every", "50",
            "--steps", str(FIELD_WIDE_STEPS)]
    runs, launches = {}, {}
    for backend in ("auto", "plain"):
        reset_launches(fused_mlp)
        t0 = time.perf_counter()
        runs[backend] = fit_image.main([
            *base, "--backend", backend, "--log-dir", os.path.join(tmp, f"wlogs_{backend}"),
            "--ckpt-dir", os.path.join(tmp, f"wck_{backend}")])
        secs = time.perf_counter() - t0
        got = dict(fused_mlp.launches)
        if backend == "auto":
            launches = {k: got[k] for k in ("field_wide_fwd", "field_wide_bwd")}
            if got["field_wide_bwd"] != FIELD_WIDE_STEPS or got["field_bwd"]:
                raise AssertionError(f"fit 4x256: launches {got} in {FIELD_WIDE_STEPS} steps")
        elif any(got.values()):
            raise AssertionError(f"the plain backend launched kernels: {got}")
        r = runs[backend]
        with open(os.path.join(tmp, f"wlogs_{backend}", "metrics.jsonl")) as f:
            stamps = {x["step"]: x["time"] for x in map(json.loads, f)}
        host_ms = (stamps[99] - stamps[51]) / 48 * 1e3  # no eval in between
        print(f"phase 25 fit_image 4x256, {FIELD_WIDE_SIZE}x{FIELD_WIDE_SIZE}, "
              f"{FIELD_WIDE_STEPS} Adam steps (lr 1e-3), backend {backend}: {secs:.2f} s host "
              f"time, {host_ms:.3f} ms/step between steps 51 and 99 (host clock); launches "
              f"{got}; eval PSNR dB " + ", ".join(
                  f"step {s}: {v:.2f}" for s, v in sorted(r["psnr"].items()))
              + f", final {r['final_psnr']:.2f}")
    k, p = runs["auto"], runs["plain"]
    gain = k["final_psnr"] - k["psnr"][0]
    diff = abs(k["final_psnr"] - p["final_psnr"])
    print(f"  4x256: {gain:.2f} dB above step 0; final PSNR kernel - plain = "
          f"{k['final_psnr'] - p['final_psnr']:+.4f} dB")
    if gain < HIRES_GAIN_DB or diff > HIRES_PLAIN_DB:
        raise AssertionError(f"fit 4x256: gain {gain:.2f} dB (need {HIRES_GAIN_DB}), "
                             f"|kernel - plain| {diff:.3f} dB (need <= {HIRES_PLAIN_DB})")
    extra = {name: {"highest_ms": tiers[name]["highest"],
                    "highest_share_of_f32_bound": f32_share[name]} for name in tiers}
    extra["field_wide_bwd"].update(step_ms=step_ms["step"],
                                   highest_step_ms=step_ms["step highest"],
                                   plain_step_ms=step_ms["plain step"])
    return worst, timing, bounds, launches, extra


# SHA-256 of the published NeRF's entries' outputs (paper_digests), recorded
# from a card run of nerf_paper.cu; the train entries' moved when both
# compositing kernels took the shared walks (composite_walk, adjoint_walk),
# all four when the layer GEMM began to promote each 64-deep stage
PAPER_DIGESTS = {
    "nerf_paper_train coarse": "0188259f75763f6af6d011db9744622502d4957610354ca43f5702f711b7840e",
    "nerf_paper_render coarse": "ac673ccdf300e73f56b3c9c5cba708ea3ea18ad4e66c7b2fc9c03b9d2851dca6",
    "nerf_paper_train fine": "b532d18bfe94adbdf32b3bd210b61cf3da1a11c4ed4a7a33f5b8b98732756d16",
    "nerf_paper_render fine": "6951dc44270a9172eb7fe3b891a263b571030f557ff8d4274b8beca47f90b563",
}
PAPER_RAYS, PAPER_STEP_RAYS = 1037, 4096


def paper_inputs(NeRFConfig, NeRFModel, rays, n, seed):
    """``(cfg, model, origins, directions, targets, coarse t, coarse dists)``
    of ``NeRFConfig.paper()`` on the card: the model's init from ``seed``,
    standard-normal rays, uniform targets and per-bin jittered coarse
    depths, all from one CUDA generator."""
    cfg = NeRFConfig.paper()
    model = NeRFModel(cfg, device="cuda")
    model.init(torch.Generator().manual_seed(seed))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    o, d = (torch.randn((n, 3), generator=gen, device="cuda") for _ in range(2))
    tgt = torch.rand((n, 3), generator=gen, device="cuda")
    _, t, dists = rays.sample_along_rays(o, d, cfg.near, cfg.far, cfg.num_samples,
                                         generator=gen)
    return cfg, model, o, d, tgt, t, dists


def paper_plain_pass(fused_nerf, net, o, d, t, dists, tgt, cfg):
    """The plain version of one pass on the card's tensors (torch ops, TF32
    off): ``(loss, weights, grads)``."""
    leaves = [*net["w"], *net["b"]]
    col, w = fused_nerf.paper_reference(net, o, d, t, dists, cfg)
    loss = ((col - tgt) ** 2).sum()
    return loss.detach(), w.detach(), torch.autograd.grad(loss, leaves)


def paper_digests(fused_nerf, NeRFConfig, NeRFModel, rays, seed=53):
    """SHA-256 of ``nerf_paper_train``'s loss, gradients and weights and of
    ``nerf_paper_render``'s colours and weights for both networks on 1037
    rays at fixed seeded inputs (the fine pass at the depths drawn evenly
    from the coarse weights)."""
    import hashlib

    cfg, model, o, d, tgt, t, dists = paper_inputs(NeRFConfig, NeRFModel, rays, PAPER_RAYS,
                                                   seed)
    digests = {}
    for name, net in zip(("coarse", "fine"), fused_nerf.paper_nets(model.params)):
        loss, w = fused_nerf.paper_train_loss(net, o, d, t, dists, tgt, cfg, weights=True)
        grads = torch.autograd.grad(loss, [*net["w"], *net["b"]])
        with torch.no_grad():
            col, wr = fused_nerf.paper_render(net, o, d, t, dists, cfg, weights=True)
        for entry, outs in (("nerf_paper_train", (loss.detach(), w, *grads)),
                            ("nerf_paper_render", (col, wr))):
            h = digests.setdefault(f"{entry} {name}", hashlib.sha256())
            for x in outs:
                h.update(x.detach().cpu().numpy().tobytes())
        if name == "coarse":
            t, dists = rays.fine_depths(t, wr, cfg.num_fine_samples)
    return {k: h.hexdigest() for k, h in digests.items()}


def paper_macs(cfg):
    """``(forward, train)`` multiply-adds of one row of one network of
    ``NeRFConfig.paper()``: the train call adds dW (the forward's count) and
    ``d_h`` of every leaf but the first onto the columns it reaches (the
    skip layer's onto h_5's 256, not gamma(x)'s; the view layer's onto the
    feature's 256, not gamma(d)'s)."""
    sizes = cfg.leaf_sizes()[:12]
    fwd = sum(fi * fo for fi, fo in sizes)
    cut = (cfg.skip_layer, cfg.num_layers + 2)  # the skip layer, the view layer
    dh = sum((cfg.filter_size if i in cut else fi) * fo for i, (fi, fo) in enumerate(sizes)
             if i)
    return fwd, 2 * fwd + dh


# the published NeRF's gradients on a batch of about 1000 rays, of each
# leaf's norm, as tests/test_torch_nerf_paper.py holds them at 37 rays: on
# 2 of 8 seeds 2-3 entries of a trunk leaf read 1.1-1.3e-2 of the leaf's
# largest entry off the plain version (at 1037 and at 1024 rays alike),
# past phase 7's 1e-2, where at 4096 rays four seeds read 4.6e-3 at most
PAPER_SMALL_GRAD = 0.06


def paper_check(fused_nerf, rays, cfg, model, o, d, t, dists, tgt):
    """Both passes of one batch against the plain version: each pass's
    train call (loss, weights, every gradient; repeats bit-identical) and
    render call (colours; weights equal to the train call's), coarse at
    ``t`` and fine at the sorted union with the depths drawn evenly from the
    coarse weights, at phase 7's bf16 bounds; below NeRF's 4096 rays each
    gradient within ``PAPER_SMALL_GRAD`` of its leaf's norm instead of
    phase 7's entrywise bound.  Returns the worst |kernel - plain| per
    entry (train: weights and gradients; render: colours)."""
    col_atol, loss_rtol, _ = wide_tolerances(cfg)
    worst = {"nerf_paper_train": 0.0, "nerf_paper_render": 0.0}
    for name, net in zip(("coarse", "fine"), fused_nerf.paper_nets(model.params)):
        leaves = [*net["w"], *net["b"]]
        loss, w = fused_nerf.paper_train_loss(net, o, d, t, dists, tgt, cfg, weights=True)
        grads = torch.autograd.grad(loss, leaves)
        loss2, w2 = fused_nerf.paper_train_loss(net, o, d, t, dists, tgt, cfg, weights=True)
        grads2 = torch.autograd.grad(loss2, leaves)
        what = f"{o.shape[0]} rays, {name}"
        if not all(torch.equal(a, b) for a, b in zip((loss, w, *grads), (loss2, w2, *grads2))):
            raise AssertionError(f"nerf_paper_train {what}: repeats differ")
        want_loss, want_w, want_grads = paper_plain_pass(fused_nerf, net, o, d, t, dists, tgt,
                                                         cfg)
        torch.testing.assert_close(loss.detach(), want_loss, rtol=loss_rtol, atol=0.0)
        torch.testing.assert_close(w, want_w, rtol=0.0, atol=col_atol)
        if o.shape[0] >= PAPER_STEP_RAYS:
            g_err = wide_grads_close(grads, want_grads, f"nerf_paper_train {what}", cfg)
        else:
            g_err = max((g - r).abs().max().item() for g, r in zip(grads, want_grads))
            for i, (g, r) in enumerate(zip(grads, want_grads)):
                if float((g - r).norm()) > PAPER_SMALL_GRAD * float(r.norm()) + 1e-6:
                    raise AssertionError(f"nerf_paper_train {what}, leaf {i}: "
                                         f"|kernel - plain| {float((g - r).norm()):.3e} "
                                         f"against the leaf's norm {float(r.norm()):.3e}")
        w_err = (w - want_w).abs().max().item()
        with torch.no_grad():
            col, wr = fused_nerf.paper_render(net, o, d, t, dists, cfg, weights=True)
            want_col, _ = fused_nerf.paper_reference(net, o, d, t, dists, cfg)
        torch.testing.assert_close(col, want_col, rtol=0.0, atol=col_atol)
        if not torch.equal(wr, w):
            raise AssertionError(f"nerf_paper_render {what}: weights differ from the train "
                                 "call's")
        c_err = (col - want_col).abs().max().item()
        g_rel = max(float((g - r).norm()) / max(float(r.norm()), 1e-30)
                    for g, r in zip(grads, want_grads))
        worst["nerf_paper_train"] = max(worst["nerf_paper_train"], g_err, w_err)
        worst["nerf_paper_render"] = max(worst["nerf_paper_render"], c_err)
        print(f"phase 26 {what} ({t.shape[1]} samples): loss {float(loss):.6f} plain "
              f"{float(want_loss):.6f} (rel {abs(float(loss) / float(want_loss) - 1):.2e}); "
              f"|kernel - plain| weights {w_err:.3e}, colours {c_err:.3e}, grads {g_err:.3e} "
              f"(of its leaf's norm at most {g_rel:.2e})")
        if name == "coarse":
            t, dists = rays.fine_depths(t, wr, cfg.num_fine_samples)
    return worst


def phase_paper(fused_nerf, NeRFConfig, NeRFModel, rays, make_single_chip_train_step, smi,
                seed=51):
    """Phase 26, the published NeRF (``nerf_paper.cu``): :func:`paper_check`
    at NeRF's 4096 rays (the cell's batch: 262,144 coarse and 786,432 fine
    rows, one chunk each) and on 1037 rays (a ragged batch); each entry's
    fine-pass call at 4096 rays timed against the plain version's, in
    turns; on the main path (launches counted) the model's loss and
    render_image through the kernels only, then 30 Adam steps at 4096 rays
    through make_single_chip_train_step, the last 10 timed; the digests
    against ``PAPER_DIGESTS``.  Returns ``(worst, timing, bounds, launches,
    extra)`` of the two entries."""
    worst = {"nerf_paper_train": 0.0, "nerf_paper_render": 0.0}
    for n, s in ((PAPER_STEP_RAYS, seed), (PAPER_RAYS, seed + 2)):
        cfg, model, o, d, tgt, t, dists = paper_inputs(NeRFConfig, NeRFModel, rays, n, s)
        for k, e in paper_check(fused_nerf, rays, cfg, model, o, d, t, dists, tgt).items():
            worst[k] = max(worst[k], e)

    cfg, model, o, d, tgt, t, dists = paper_inputs(NeRFConfig, NeRFModel, rays,
                                                   PAPER_STEP_RAYS, seed)
    coarse, fine = fused_nerf.paper_nets(model.params)
    with torch.no_grad():
        _, w = fused_nerf.paper_render(coarse, o, d, t, dists, cfg, weights=True)
    tf, df = rays.fine_depths(t, w, cfg.num_fine_samples)
    leaves = [*fine["w"], *fine["b"]]

    def train():
        torch.autograd.grad(fused_nerf.paper_train_loss(fine, o, d, tf, df, tgt, cfg)[0],
                            leaves)

    def render():
        with torch.no_grad():
            fused_nerf.paper_render(fine, o, d, tf, df, cfg)

    def plain_render():
        with torch.no_grad():
            fused_nerf.paper_reference(fine, o, d, tf, df, cfg)

    fns = {"nerf_paper_train": train,
           "plain train": lambda: paper_plain_pass(fused_nerf, fine, o, d, tf, df, tgt, cfg),
           "nerf_paper_render": render, "plain render": plain_render}
    for fn in fns.values():  # warm-up
        fn()
    med = {k: statistics.median(v) for k, v in timed_turns(fns, 3).items()}
    rows = PAPER_STEP_RAYS * tf.shape[1]
    fwd, train_macs = paper_macs(cfg)
    n_params = sum(fi * fo + fo for fi, fo in cfg.leaf_sizes()[:12])
    # read once: the rays (and targets), depths and steps, the packed bf16
    # weights and f32 biases; written once: the colours, or the loss and
    # the f32 gradients
    bounds = {"nerf_paper_train": bound(rows * train_macs, PEAK_BF16,
                                        PAPER_STEP_RAYS * 36 + rows * 8 + n_params * 10),
              "nerf_paper_render": bound(rows * fwd, PEAK_BF16,
                                         PAPER_STEP_RAYS * 36 + rows * 8 + n_params * 6)}
    timing = {k: (med[k], med["plain " + k.split("_")[-1]]) for k in bounds}
    for k, (ms, plain) in timing.items():
        print(f"phase 26 {k}, fine pass at {PAPER_STEP_RAYS} rays ({rows} rows; {smi}): "
              f"{ms:.3f} ms, plain {plain:.3f} ms, bound {bounds[k][0]:.3f} ms "
              f"({bounds[k][1]}), {bounds[k][0] / ms:.1%} of it")

    reset_launches(fused_nerf)
    model.loss(o, d, t, dists, tgt).backward()
    img = model.render_image(rays.normalized_intrinsics(1.1, "cuda"),
                             torch.eye(4, device="cuda"), 64)
    if not torch.isfinite(img).all():
        raise AssertionError("phase 26: render_image gave non-finite colours")
    model.zero_grad(set_to_none=True)
    opt = torch.optim.Adam(model.parameters(), lr=5e-4)
    step = make_single_chip_train_step(cfg, opt, generator=torch.Generator(
        device="cuda").manual_seed(seed))
    losses = [float(step(model, o, d, t, dists, tgt)) for _ in range(20)]
    if not all(np.isfinite(losses)) or losses[-1] >= losses[0]:
        raise AssertionError(f"phase 26: 20 steps of one batch gave losses {losses}")
    ms = sorted(cuda_ms(lambda: step(model, o, d, t, dists, tgt))[0] for _ in range(10))
    launches = {k: fused_nerf.launches[k] for k in bounds}
    want = {"nerf_paper_train": 2 + 2 * 30, "nerf_paper_render": 2}
    got = {k: v for k, v in fused_nerf.launches.items() if v}
    if got != want:
        raise AssertionError(f"phase 26: main-path launches {got}, expected {want}")
    step_rows = PAPER_STEP_RAYS * (2 * cfg.num_samples + cfg.num_fine_samples)
    flop = 2 * step_rows * train_macs
    print(f"phase 26 step at {PAPER_STEP_RAYS} rays ({smi}): median {ms[5]:.3f} ms "
          f"(min {ms[0]:.3f}), losses {losses[0]:.4f} -> {losses[-1]:.4f}; "
          f"{flop / 1e12:.3f} TFLOP, {flop / (ms[5] * 1e-3) / 1e12:.1f} TFLOP/s; main-path "
          f"launches {launches}")
    got = paper_digests(fused_nerf, NeRFConfig, NeRFModel, rays)
    for k, h in got.items():
        print(f"phase 26 digest {k}: {h}")
    if PAPER_DIGESTS and got != PAPER_DIGESTS:
        raise AssertionError("the published NeRF's output digests differ from the recorded "
                             "ones")
    extra = {k: {"rows": rows, "rays": PAPER_STEP_RAYS, "pass": "fine"} for k in bounds}
    extra["nerf_paper_train"].update(step_ms=ms[5], step_tflop=flop / 1e12)
    return worst, timing, bounds, launches, extra


def reset_launches(fused_nerf):
    for name in fused_nerf.launches:
        fused_nerf.launches[name] = 0


def cuda_ms(fn):
    """One call of ``fn`` timed with CUDA events, in ms."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is "
                         "False); the port's kernels run only on the card")
    sys.path.insert(0, ROOT)
    import lomanerf_tpu_torch

    if os.path.dirname(os.path.dirname(os.path.abspath(lomanerf_tpu_torch.__file__))) != ROOT:
        raise SystemExit("chip_smoke: run it from a checkout of the repository")
    from lomanerf_tpu_torch.core import mlp_layer_sizes, normalized_intrinsics, psnr, rays
    from lomanerf_tpu_torch.data import native, synthetic_views
    from lomanerf_tpu_torch.models import (ImageFieldConfig, ImageFieldModel, NeRFConfig,
                                           NeRFModel, image_grid_coords)
    from lomanerf_tpu_torch.ops import (build, f32_gemm, fused_mlp, fused_nerf, probe, scans,
                                        wide_dw, wide_gemm, wide_mlp)
    from lomanerf_tpu_torch.scripts import grid_overhead, variants
    from lomanerf_tpu_torch.train import fit_image, make_video, train_nerf
    from lomanerf_tpu_torch.train.checkpoint import CheckpointManager, load_params_npz
    from lomanerf_tpu_torch.train.logging_utils import read_png, write_png
    from lomanerf_tpu_torch.train.make_video import render_orbit
    from lomanerf_tpu_torch.train.steps import make_image_fit_step, make_single_chip_train_step
    from lomanerf_tpu_torch.utils import trace

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    lib_path = build.build()
    build.load()
    print(f"build: {os.path.relpath(lib_path, ROOT)} in {time.perf_counter() - t0:.1f} s")
    print((lib_path.parent / "build.log").read_text().strip())
    t0 = time.perf_counter()
    host_lib = native.build()  # the ray-batch prefetcher (phase 21), by g++
    native.load_native()
    print(f"build: {os.path.relpath(host_lib, ROOT)} in {time.perf_counter() - t0:.1f} s")

    worst = {"nerf_render_fwd": phase_kernel_vs_plain(fused_nerf, NeRFConfig)}

    # ---- the serving path: trained field -> render_image / render_orbit ----
    fx = np.load(FIXTURE)
    p = load_params_npz(FIXTURE)
    cfg = NeRFConfig.small()
    model = NeRFModel.from_numpy(cfg, p["w"], p["b"], device="cuda")
    reset_launches(fused_nerf)
    worst["nerf_render_fwd"] = max(worst["nerf_render_fwd"], phase_trained_field(
        fx, model, normalized_intrinsics, psnr))
    after_phase2 = fused_nerf.launches["nerf_render_fwd"]
    if after_phase2 == 0:
        raise AssertionError("phase 2 made no kernel launch")
    t0 = time.perf_counter()
    frames = render_orbit(model, float(fx["focal"]), 4.0, SERVE_FRAMES, SERVE_SIZE)
    orbit_s = time.perf_counter() - t0
    launches = {"nerf_render_fwd": fused_nerf.launches["nerf_render_fwd"]}
    if launches["nerf_render_fwd"] <= after_phase2:
        raise AssertionError("render_orbit made no kernel launch")
    if frames.shape != (SERVE_FRAMES, SERVE_SIZE, SERVE_SIZE, 3) or frames.dtype != np.uint8:
        raise AssertionError(f"orbit frames {frames.shape} {frames.dtype}")
    if frames.std() < 1.0:
        raise AssertionError("orbit frames are blank")
    print(f"phase 3 render_orbit: {SERVE_FRAMES} frames at {SERVE_SIZE}x{SERVE_SIZE} "
          f"in {orbit_s:.2f} s host time (incl. copies); kernel launches on the main "
          f"path: {launches['nerf_render_fwd']}")

    # ---- phase 3 timing: one frame, kernel vs plain version, CUDA events ----
    K = normalized_intrinsics(float(fx["focal"]), device="cuda")
    pose = torch.from_numpy(fx["poses"][1]).cuda()

    def plain_frame():
        o, d = rays.get_rays(SERVE_SIZE, SERVE_SIZE, K, pose)
        tv, dists = rays.uniform_depths(cfg.near, cfg.far, cfg.num_samples, "cuda")
        return fused_nerf.render_rays_reference(
            model.params, o, d, tv, dists, cfg).reshape(SERVE_SIZE, SERVE_SIZE, 3)

    def kernel_frame():
        return model.render_image(K, pose, SERVE_SIZE)

    # the kernel's own call, and the plain version's, on the frame's rays
    o_f, d_f = (x.contiguous() for x in rays.get_rays(SERVE_SIZE, SERVE_SIZE, K, pose))
    tv_f, dd_f = rays.uniform_depths(cfg.near, cfg.far, cfg.num_samples, "cuda")
    pk_f = fused_nerf.pack_params(model.params, tv_f, dd_f, 32)

    def kernel_alone():
        return fused_nerf._launch(pk_f, tv_f, dd_f, o_f, d_f, cfg, cfg.num_layers, 32)

    def plain_alone():
        return fused_nerf.render_rays_reference(model.params, o_f, d_f, tv_f, dd_f, cfg)

    calls = {"frame": kernel_frame, "plain frame": plain_frame, "kernel": kernel_alone,
             "plain": plain_alone}
    with torch.no_grad():
        _, img_k = cuda_ms(kernel_frame)  # warm-up
        _, img_p = cuda_ms(plain_frame)
        err = (img_k - img_p).abs().max().item()
        torch.testing.assert_close(img_k, img_p, atol=ATOL, rtol=RTOL)
        if not torch.isfinite(img_k).all():
            raise AssertionError("non-finite pixels")
        if not torch.equal(cuda_ms(kernel_alone)[1].reshape(img_k.shape), img_k):
            raise AssertionError("the kernel's own call differs from the frame's pixels")
        worst["nerf_render_fwd"] = max(worst["nerf_render_fwd"], err)
        ms = {k: [] for k in calls}
        for _ in range(3):  # in turns, forwards then backwards: 6 calls each
            for name, fn in [*calls.items(), *reversed(calls.items())]:
                ms[name].append(cuda_ms(fn)[0])
    med = {k: statistics.median(v) for k, v in ms.items()}
    timing = {"nerf_render_fwd": (med["kernel"], med["plain"])}
    # #1's entry in the kernels line also carries the frames' times
    extra = {"nerf_render_fwd": {"frame_ms": med["frame"], "plain_frame_ms": med["plain frame"]}}
    n_rays = SERVE_SIZE * SERVE_SIZE
    print(f"phase 3 800x800 frame ({n_rays} rays x {cfg.num_samples} samples), "
          f"max|kernel-plain| = {err:.3e}; on {smi}:")
    for name, what in (("frame", "render_image, kernel"), ("plain frame", "render_image, plain"),
                       ("kernel", "the kernel alone"), ("plain", "the plain version alone")):
        print(f"  {what:24s}: median {med[name]:.3f} ms/frame (min {min(ms[name]):.3f}, max "
              f"{max(ms[name]):.3f}, n={len(ms[name])}), {n_rays / med[name] * 1e3:.4e} rays/s")

    # ---- phase 4: the gradient kernels against their plain versions ----
    worst.update(phase_grad_kernels(fused_nerf, NeRFConfig))
    phase_bench_batch_grads(fused_nerf, NeRFConfig)

    # ---- phase 5: the train path (train_nerf), and NeRFModel.loss's backward ----
    with tempfile.TemporaryDirectory() as tmp:
        launches["nerf_train"] = phase_train_driver(
            train_nerf, fused_nerf, CheckpointManager, NeRFModel, NeRFConfig,
            synthetic_views, normalized_intrinsics, psnr, tmp)
    launches["nerf_render_bwd"] = phase_render_loss_steps(
        fused_nerf, NeRFConfig, NeRFModel, synthetic_views, normalized_intrinsics, rays)

    # ---- phase 6: the train step at the bench's shape, and its split ----
    timing.update(phase_bench_step(fused_nerf, NeRFConfig, NeRFModel,
                                   make_single_chip_train_step, smi))
    # #3's entry in the kernels line also carries the step's device split
    extra["nerf_train"] = {"step_split": phase_small_split()}

    # ---- phase 7: the wide kernels against their plain versions ----
    worst.update(phase_wide_kernels(fused_nerf, NeRFConfig))

    # ---- phase 8: the flagship's train and serve paths ----
    with tempfile.TemporaryDirectory() as tmp:
        launches.update(phase_flagship_driver(
            train_nerf, fused_nerf, CheckpointManager, NeRFModel, NeRFConfig,
            synthetic_views, normalized_intrinsics, psnr, render_orbit, rays, tmp))

    # ---- phase 9: flagship timing, its split, the dW stage alone ----
    timing.update(phase_flagship_timing(fused_nerf, wide_mlp, NeRFConfig, NeRFModel,
                                        make_single_chip_train_step,
                                        normalized_intrinsics, rays, smi))
    phase_flagship_split(NeRFConfig)
    phase_dw_stage(wide_dw, smi)
    # #8's entry in the kernels line also carries the fused MLP alone and the
    # frame's split by kernel family on both paths
    extra["nerf_wide_render_fwd"] = {
        "fused_mlp": phase_fused_mlp(fused_nerf, wide_mlp, NeRFConfig, NeRFModel, smi),
        "frame_split": {path: {"device_ms_per_frame": split["device_ms_per_frame"],
                               "ms": {k: v for k, v in split["ms"].items() if v}}
                        for path, split in phase_frame_split(NeRFConfig).items()}}

    # ---- phase 10: the 2D field's kernels against their plain versions ----
    field_worst, field_image = phase_field_kernels(fused_mlp, ImageFieldConfig,
                                                   image_grid_coords)
    worst.update(field_worst)
    # #14's entry also carries the whole-image leaves and flips on both routes
    extra["field_bwd"] = {"image_1024": field_image}

    # ---- phase 11: the image-fit path (fit_image) ----
    with tempfile.TemporaryDirectory() as tmp:
        launches.update(phase_field_driver(fit_image, fused_mlp, tmp))

    # ---- phase 12: image-fit timing ----
    with tempfile.TemporaryDirectory() as tmp:
        field_timing = phase_field_timing(fused_mlp, ImageFieldConfig, ImageFieldModel,
                                          image_grid_coords, make_image_fit_step,
                                          mlp_layer_sizes, trace, smi, tmp)
    timing.update({k: v[:2] for k, v in field_timing.items()})
    bounds = nerf_bounds(NeRFConfig, mlp_layer_sizes)
    bounds.update({k: v[2:] for k, v in field_timing.items()})

    # ---- phase 13: the per-ray (N, S) depth kernels against their plain versions ----
    worst.update(phase_perray_kernels(fused_nerf, NeRFConfig, NeRFModel))
    for k, e in phase_perray_batches(fused_nerf, NeRFConfig, NeRFModel).items():
        worst[k] = max(worst[k], e)
    phase_perray_wide_chunks(fused_nerf, NeRFConfig, NeRFModel)

    # ---- phase 14: the stratified path: timed steps, main paths, each kernel ----
    phase_stratified_steps(fused_nerf, NeRFConfig, NeRFModel, make_single_chip_train_step,
                           smi)
    launches.update(phase_stratified_paths(
        fused_nerf, NeRFConfig, NeRFModel, make_single_chip_train_step, synthetic_views,
        normalized_intrinsics, psnr, rays))
    perray_timing = phase_perray_kernel_timing(fused_nerf, NeRFConfig, NeRFModel,
                                               mlp_layer_sizes, smi)
    timing.update({k: v[:2] for k, v in perray_timing.items()})
    bounds.update({k: v[2:] for k, v in perray_timing.items()})

    # ---- phase 15: narrow MLPs past shared memory, on the wide kernels ----
    for k, e in phase_wide_route(fused_nerf, NeRFConfig).items():
        worst[k] = max(worst[k], e)
    phase_single64_wide(fused_nerf, NeRFConfig, NeRFModel, make_single_chip_train_step, smi)

    # ---- phase 16: the video path (make_video --params, then --frames) ----
    with tempfile.TemporaryDirectory() as tmp:
        phase_video(make_video, read_png, write_png, render_orbit, NeRFModel, NeRFConfig,
                    load_params_npz, fused_nerf, tmp)

    # ---- phase 17: the ReLU-mask flips at the small batch (a diagnostic) ----
    phase_mask_flips(fused_nerf, NeRFConfig, NeRFModel)

    # ---- phase 18: the segmented scans (#15), and #1-#12's output digests ----
    library = {}
    worst["seg_scans"], launches["seg_scans"], scan_timing, bounds["seg_scans"] = \
        phase_seg_scans(scans, variants, smi)
    # the flushed cumprod: the column read from device memory, as the bound
    timing["seg_scans"] = scan_timing["cumprod"]["flushed"][:2]
    library["seg_scans"] = scan_timing["cumprod"]["flushed"][2]
    extra["seg_scans"] = {
        "share": bounds["seg_scans"][0] / timing["seg_scans"][0],
        "ops": {op: {mode: dict(zip(("ms", "plain_ms", "library_ms"), t))
                     for mode, t in modes.items()} for op, modes in scan_timing.items()}}
    phase_digests(fused_nerf, fused_mlp, NeRFConfig, ImageFieldConfig, mlp_layer_sizes)

    # ---- phase 19: the grid-overhead probe (#16) ----
    worst["grid_sum"], launches["grid_sum"], grid_ms, bounds["grid_sum"], _ = \
        phase_grid_overhead(probe, grid_overhead, smi)
    timing["grid_sum"], library["grid_sum"] = grid_ms[:2], grid_ms[2]

    # ---- phase 20: the data-parallel path, in ranks of its own ----
    for k, v in phase_data_parallel(smi).items():
        launches[k] += v

    # ---- phase 21: the C++ ray-batch prefetcher (train_nerf --pipeline) ----
    with tempfile.TemporaryDirectory() as tmp:
        pipe_launches, extra["nerf_train"]["pipeline"] = phase_pipeline(
            train_nerf, fused_nerf, CheckpointManager, NeRFModel, NeRFConfig, synthetic_views,
            normalized_intrinsics, psnr, smi, tmp)
    launches["nerf_train"] += pipe_launches

    # ---- phase 22: the loma DSL on the card ----
    phase_dsl(smi)

    # ---- phase 23: the driver surface (entry.py): the flagship loss, the dry runs ----
    for k, v in phase_entry(fused_nerf, NeRFConfig).items():
        launches[k] = launches.get(k, 0) + v

    # ---- phase 24: NeRF MLPs at any width (C4) and narrow ones in bf16 (A4) ----
    with tempfile.TemporaryDirectory() as tmp:
        w_worst, w_timing, w_bounds, w_launches, f32_step = phase_widths(
            fused_nerf, NeRFConfig, make_single_chip_train_step, mlp_layer_sizes, train_nerf,
            smi, tmp)
    for k, e in w_worst.items():
        worst[k] = max(worst[k], e)
    for k, v in w_launches.items():
        launches[k] = launches.get(k, 0) + v
    for k, (ms_k, plain_k) in w_timing.items():  # #7-#9 at 8x1024, beside the flagship
        extra[k] = {**extra.get(k, {}), "c4_8x1024": {
            "ms": ms_k, "plain_ms_4096_rays": plain_k, "bound_ms": w_bounds[k][0],
            "bound_by": w_bounds[k][1]}}
    c4_split = phase_c4_split(fused_nerf, NeRFConfig)
    layer_gemm = phase_layer_gemm(fused_nerf, wide_gemm, NeRFConfig, smi)
    f32_gemm_alone = {"kernel": "gemm_f32_kernel", "source": _CSRC + "nerf_wide_f32_gemm.cuh",
                      **phase_f32_gemm(fused_nerf, f32_gemm, NeRFConfig, smi)}
    # #7's and #8's entries also carry the 8x1024 splits and the layer GEMM
    # alone, #7's the f32 8x1024 step; #7's and the wide field's the f32 GEMM
    # alone
    extra["nerf_wide_train"]["c4_8x1024"]["split"] = c4_split["step"]
    extra["nerf_wide_train"]["c4_8x1024"]["f32_step_4096_rays"] = f32_step
    extra["nerf_wide_render_fwd"]["c4_8x1024"]["split"] = c4_split["frame"]
    for k in ("nerf_wide_train", "nerf_wide_render_fwd"):
        extra[k]["layer_gemm"] = layer_gemm
    extra["nerf_wide_train"]["f32_gemm"] = f32_gemm_alone

    # ---- phase 25: image fields past the tile kernels (D2) ----
    with tempfile.TemporaryDirectory() as tmp:
        f_worst, f_timing, f_bounds, f_launches, f_extra = phase_field_wide(
            fused_mlp, ImageFieldConfig, image_grid_coords, mlp_layer_sizes,
            make_image_fit_step, fit_image, smi, tmp)
    worst.update(f_worst)
    timing.update(f_timing)
    bounds.update(f_bounds)
    launches.update(f_launches)
    extra.update(f_extra)
    for k in ("field_wide_fwd", "field_wide_bwd"):
        extra[k]["f32_gemm"] = f32_gemm_alone

    # ---- phase 26: the published NeRF (nerf_paper.cu; no TPU counterpart) ----
    for into, got in zip((worst, timing, bounds, launches, extra), phase_paper(
            fused_nerf, NeRFConfig, NeRFModel, rays, make_single_chip_train_step, smi)):
        into.update(got)

    for name in ("nerf_render_fwd", "nerf_render_fwd_rays"):  # the redesigned render's share
        extra[name] = {**extra.get(name, {}), "share": bounds[name][0] / timing[name][0]}
    print(smi)
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": src, "replaces": replaces,
        "launches": launches[name], "max_abs_err": worst[name],
        "ms": timing[name][0], "plain_ms": timing[name][1],
        "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
        # one PyTorch call computes the same function only for the scans and the sum
        "library_ms": library.get(name),
        **extra.get(name, {}),
    } for name, (src, replaces) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
