"""Weak scaling of the data-parallel train step and the sharded render
(port of ``scripts/scaling_bench.py``; the BASELINE's ">85% rays/s from 1
chip to N" target, BASELINE.md:28).

Runs the same step on 1 rank and on N ranks (``parallel.run_ranks``) with
the rays per rank fixed, and reports rays/s of the whole mesh and the
efficiency ``(rays/s at N / rays/s at 1) / N``.  ``--rung train``: the
``small`` train step (``parallel.make_train_step``, Adam 5e-4, the fused
train kernel on CUDA, one all-reduce a step); ``--rung render``: the
``full`` frame's sharded render (``parallel.make_render_step``, chunks of
half a rank's rays, one all-gather a frame).  A step's time is the host
clock around ``--inner`` steps ending in a synchronise, the median of
``--outer`` rounds after two warm-up rounds.

On CUDA N is the card count, each rank with a card of its own (NCCL): on a
one-card machine only N = 1 is measured, the output says so and gives no
efficiency.  ``--device cpu`` runs 2 gloo ranks on the host's shared
cores, a check of the harness only (the output says so).

Run: ``python -m lomanerf_tpu_torch.scripts.scaling_bench --rung train
--rays-per-rank 8192`` (``--device cpu`` for the harness).
"""

from __future__ import annotations

import argparse
import itertools
import json
import statistics
import subprocess
import time

import numpy as np


def _timed(fn, inner: int, outer: int, device) -> float:
    """Median seconds per call of ``fn`` over ``outer`` rounds of
    ``inner`` calls, after two warm-up rounds; every rank syncs."""
    import torch
    import torch.distributed as dist

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        if dist.is_initialized():
            dist.barrier()

    ts = []
    for r in range(outer + 2):
        sync()
        t0 = time.perf_counter()
        for _ in range(inner):
            fn()
        sync()
        if r >= 2:
            ts.append((time.perf_counter() - t0) / inner)
    return statistics.median(ts)


def measure(rung: str, rays_per_rank: int, inner: int, outer: int, device: str) -> float:
    """Rays/s of the whole mesh for one rank count (under ``run_ranks``)."""
    import torch

    from lomanerf_tpu_torch.core import uniform_depths
    from lomanerf_tpu_torch.models import NeRFConfig, NeRFModel
    from lomanerf_tpu_torch.parallel import (RayBatch, build_kernels_once, data_mesh,
                                             make_render_step, make_train_step,
                                             process_index, rank_device, shard_ray_chunks)

    dev = rank_device(device)
    if dev.type == "cuda":
        build_kernels_once()
    mesh = data_mesh(dev)
    cfg = NeRFConfig.small() if rung == "train" else NeRFConfig.full()
    model = NeRFModel(cfg, device=dev)
    model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1000 + process_index())
    n_global = rays_per_rank * mesh.dp

    def rays(n):
        return (torch.tensor(rng.standard_normal((n, 3)), dtype=torch.float32, device=dev)
                for _ in range(2))

    if rung == "train":
        opt = torch.optim.Adam(model.parameters(), lr=5e-4)
        step = make_train_step(cfg, opt, mesh)
        t_vals, dists = uniform_depths(cfg.near, cfg.far, cfg.num_samples, dev)
        batches = []
        for salt in (0.0, 0.5):
            o, d = rays(rays_per_rank)
            tgt = torch.tensor(rng.random((rays_per_rank, 3)), dtype=torch.float32, device=dev)
            batches.append(RayBatch(o + salt, d, t_vals, dists, tgt))
        calls = itertools.count()
        secs = _timed(lambda: step(model, batches[next(calls) % 2]), inner, outer, dev)
        return n_global / secs
    o, d = rays(n_global)  # every rank draws the same frame: one seed
    chunk = max(rays_per_rank // 2, 128)
    oc, dc, _ = shard_ray_chunks(mesh, o, d, chunk)
    render = make_render_step(cfg, mesh)
    secs = _timed(lambda: render(model.params, oc, dc), inner, outer, dev)
    return oc.shape[0] * chunk * mesh.dp / secs


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rung", default="train", choices=["train", "render"])
    ap.add_argument("--rays-per-rank", type=int, default=8192)
    ap.add_argument("--inner", type=int, default=10)
    ap.add_argument("--outer", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    import torch

    from lomanerf_tpu_torch.parallel import run_ranks

    cuda = args.device == "cuda"
    if cuda and not torch.cuda.is_available():
        raise SystemExit("scaling_bench: no CUDA device; --device cpu checks the harness")
    n = torch.cuda.device_count() if cuda else 2
    # a gloo rank on the host: one thread, so that the ranks share its cores evenly
    kw = {"backend": "nccl", "threads": None} if cuda else {"backend": "gloo", "threads": 1}
    run = (args.rung, args.rays_per_rank, args.inner, args.outer, args.device)
    r1 = run_ranks(measure, 1, *run, **kw)[0]
    out = {"rung": args.rung, "device": args.device, "rays_per_rank": args.rays_per_rank,
           "rays_per_s_1": r1}
    if cuda:
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip().splitlines()[0]
    if n == 1:
        out["ranks"] = 1
        out["note"] = "one rank (one card): weak scaling needs N > 1; no efficiency"
    else:
        rn = run_ranks(measure, n, *run, **kw)[0]
        out.update(ranks=n, rays_per_s_N=rn, weak_scaling_efficiency=rn / r1 / n,
                   hardware_number=cuda,
                   note="" if cuda else "gloo ranks share the host's cores: harness check only")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
