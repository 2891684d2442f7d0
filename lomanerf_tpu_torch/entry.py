"""Driver entry points: the flagship loss, and a dry run over several ranks
(the port's counterpart of the repository's ``__graft_entry__.py``).

``entry()`` returns the flagship NeRF's train loss and example arguments;
``dryrun_multichip(n)`` runs one data x tensor-parallel step, one
data-parallel step through the fused train kernel and one sharded render on
``n`` ranks at tiny shapes.  Both run on the card unless the caller passes
``device="cpu"``.

    python -m lomanerf_tpu_torch.entry [n]

runs ``dryrun_multichip(n)`` (n defaults to the card count) and prints
``dryrun_multichip(n) OK``.
"""

from __future__ import annotations

import numpy as np
import torch

N_RAYS = 1024  # entry()'s example batch


def entry(device=None):
    """``(fn, example_args)``: the ``NeRFConfig.full()`` sum-MSE train loss
    through ``train.steps.nerf_loss_fn`` with ``resolve_backend(cfg)``, so
    the production path runs: on the card the wide train kernel
    (``nerf_wide_train.cu``, loss and gradients in one call), on CPU
    tensors its plain version.  The example args are 1024 rays drawn with
    numpy ``default_rng(0)`` as the JAX entry draws them, and params from
    ``init_mlp(..., init="nerf")`` on a ``torch.Generator`` seeded 0.
    ``fn(params, origins, directions, t_vals, dists, target)`` returns a
    0-d loss differentiable w.r.t. params."""
    from lomanerf_tpu_torch.core import init_mlp, sample_along_rays
    from lomanerf_tpu_torch.models import NeRFConfig
    from lomanerf_tpu_torch.train.steps import nerf_loss_fn, resolve_backend

    device = torch.device(device or "cuda")
    cfg = NeRFConfig.full()  # 8 layers x 256 wide, 128 samples a ray, bf16
    backend = resolve_backend(cfg)
    params = init_mlp(torch.Generator().manual_seed(0), cfg.in_channels, cfg.out_channels,
                      cfg.num_layers, cfg.filter_size, init=cfg.init, device=device)
    rng = np.random.default_rng(0)

    def draw(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    origins = draw(rng.standard_normal((N_RAYS, 3)))
    directions = draw(rng.standard_normal((N_RAYS, 3)))
    _, t_vals, dists = sample_along_rays(origins, directions, cfg.near, cfg.far,
                                         cfg.num_samples)
    target = draw(rng.random((N_RAYS, 3)))

    def fn(params, origins, directions, t_vals, dists, target):
        return nerf_loss_fn(params, origins, directions, t_vals, dists, target, cfg, backend)

    return fn, (params, origins, directions, t_vals, dists, target)


def mesh_shape(n: int):
    """``(dp, tp)`` of the dry run: tp = 2 when n is even and at least 4,
    as the JAX dry run splits its devices."""
    tp = 2 if n % 2 == 0 and n >= 4 else 1
    return n // tp, tp


def backend_for(n: int, device) -> str:
    """The process group's backend: NCCL for one rank a card, gloo on the
    CPU or where ranks share a card (NCCL refuses two ranks on one GPU;
    gloo takes CUDA tensors and stages each collective through host
    memory)."""
    device = torch.device(device)
    if device.type == "cuda" and n <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _dryrun_rank(n: int, device: str) -> dict:
    """One rank of :func:`dryrun_multichip`: (a) the plain data x tensor
    parallel step with Adam 1e-3, (b) the fused-kernel data-parallel step
    over all n ranks, (c) the sharded render through ``shard_ray_chunks``
    (chunk 2).  Returns the losses, the render's shape and this rank's
    kernel launches."""
    from lomanerf_tpu_torch.core import init_mlp, sample_along_rays
    from lomanerf_tpu_torch.models import NeRFConfig
    from lomanerf_tpu_torch.ops import fused_nerf
    from lomanerf_tpu_torch.parallel import (RayBatch, build_kernels_once, make_mesh,
                                             make_render_step, make_train_step, place_state,
                                             rank_device, shard_batch, shard_ray_chunks)

    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        build_kernels_once()
    dp, tp = mesh_shape(n)
    cfg = NeRFConfig(num_layers=4, filter_size=16 * tp, num_samples=8)

    def params_of(seed, init):
        p = init_mlp(torch.Generator().manual_seed(seed), cfg.in_channels,
                     cfg.out_channels, cfg.num_layers, cfg.filter_size, init=init,
                     device=dev)
        for x in (*p["w"], *p["b"]):
            x.requires_grad_(True)
        return p

    n_rays = 4 * dp
    rng = np.random.default_rng(0)
    origins = torch.as_tensor(rng.standard_normal((n_rays, 3)), dtype=torch.float32,
                              device=dev)
    directions = torch.as_tensor(rng.standard_normal((n_rays, 3)), dtype=torch.float32,
                                 device=dev)
    _, t_vals, dists = sample_along_rays(origins, directions, cfg.near, cfg.far,
                                         cfg.num_samples)
    target = torch.as_tensor(rng.random((n_rays, 3)), dtype=torch.float32, device=dev)
    batch = RayBatch(origins, directions, t_vals, dists, target)
    for name in fused_nerf.launches:
        fused_nerf.launches[name] = 0

    # (a) the plain path under dp x tp: the TP MLP's collectives, one
    # gradient all-reduce over the data group
    mesh = make_mesh(dp=dp, tp=tp, device=dev)
    params = params_of(0, cfg.init)
    opt = torch.optim.Adam([*params["w"], *params["b"]], lr=1e-3)
    params = place_state(mesh, cfg, params, opt, tp=tp > 1)
    step = make_train_step(cfg, opt, mesh, tp=tp > 1, backend="plain")
    loss = step(params, shard_batch(mesh, batch))
    if not torch.isfinite(loss):
        raise AssertionError(f"dp x tp step: loss {loss.item()}")

    # (b) the production path: the fused train kernel on each rank's rays,
    # the gradients summed over every rank
    mesh_dp = make_mesh(dp=n, tp=1, device=dev)
    params_p = params_of(1, "he")
    opt_p = torch.optim.Adam([*params_p["w"], *params_p["b"]], lr=1e-3)
    place_state(mesh_dp, cfg, params_p, opt_p)
    step_p = make_train_step(cfg, opt_p, mesh_dp)
    loss_p = step_p(params_p, shard_batch(mesh_dp, batch))
    if not torch.isfinite(loss_p):
        raise AssertionError(f"fused data-parallel step: loss {loss_p.item()}")

    # (c) the sharded render: each rank renders its chunks through the
    # render kernel, the frame reassembled by one all-gather
    render = make_render_step(cfg, mesh_dp)
    oc, dc, n_r = shard_ray_chunks(mesh_dp, origins, directions, chunk=2)
    cols = render(params_p, oc, dc)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    if tuple(cols.shape) != (n * oc.shape[0] * 2, 3):
        raise AssertionError(f"render of shape {tuple(cols.shape)}")
    if not bool(torch.isfinite(cols[:n_r]).all()):
        raise AssertionError("non-finite render")
    return {"loss_dp_tp": loss.item(), "loss_fused": loss_p.item(),
            "render_shape": tuple(cols.shape), "launches": dict(fused_nerf.launches)}


def dryrun_multichip(n: int, device=None, threads=None) -> list:
    """One full train step on ``n`` ranks (``parallel.run_ranks``), each
    part at tiny shapes with a finite loss: (a) the plain step under
    dp x tp (tp = 2 when n is even and at least 4, dp = n / tp;
    ``NeRFConfig(num_layers=4, filter_size=16*tp, num_samples=8)``, 4 dp
    rays, Adam 1e-3), (b) the fused-kernel data-parallel step over all n
    ranks, (c) the sharded render (``shard_ray_chunks(chunk=2)``), its
    shape and finiteness checked.  The process group's backend follows
    from n and the card count (:func:`backend_for`) and is printed.
    ``threads`` sets each rank's torch CPU threads.  Returns each rank's
    results."""
    from lomanerf_tpu_torch.parallel import run_ranks

    device = torch.device(device or "cuda")
    backend = backend_for(n, device)
    dp, tp = mesh_shape(n)
    print(f"dryrun_multichip({n}): dp={dp} tp={tp} on {device.type}, backend {backend}",
          flush=True)
    return run_ranks(_dryrun_rank, n, n, device.type, backend=backend, threads=threads)


if __name__ == "__main__":
    import sys

    n = int(sys.argv[1]) if len(sys.argv) > 1 else max(1, torch.cuda.device_count())
    dryrun_multichip(n)
    print(f"dryrun_multichip({n}) OK")
