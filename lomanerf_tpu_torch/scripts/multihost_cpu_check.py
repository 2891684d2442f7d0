"""Two-process data-parallel check on the CPU (port of
``scripts/multihost_cpu_check.py``; no cluster, no card).

Two gloo ranks (``parallel.run_ranks``) each take their own disjoint rows
of a seeded global batch (the driver's per-rank draw), pass them through
``host_local_batch_to_global``, run one data-parallel train step
(``make_train_step``, SGD 1e-2) and render the global ray set sharded over
both ranks (``make_render_step``, chunks of 4).  Rank 0 also runs the
single-process step on the full batch from the same params
(``make_single_chip_train_step``) and renders the rays in one block with
the stepped params, and
asserts that the loss (rtol 1e-5), the updated params (rtol 1e-5, atol
1e-6) and the colours (rtol 1e-5, atol 1e-6) agree.  This is the
correctness half of the 1 -> N scaling target that a CPU can check.

Run: ``python -m lomanerf_tpu_torch.scripts.multihost_cpu_check [--out result.json]``
(the JSON result is written only where ``--out`` says).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

N_PROC = 2
N_RAYS_PER_RANK = 64


def _params(cfg):
    import torch

    from lomanerf_tpu_torch.core import init_mlp

    p = init_mlp(torch.Generator().manual_seed(5), cfg.in_channels, cfg.out_channels,
                 cfg.num_layers, cfg.filter_size)
    return {k: [torch.nn.Parameter(x) for x in v] for k, v in p.items()}


def worker(n_per_rank: int) -> dict:
    """One rank's part (under ``run_ranks``); rank 0 returns the result."""
    import torch

    from lomanerf_tpu_torch.core import uniform_depths
    from lomanerf_tpu_torch.models import NeRFConfig
    from lomanerf_tpu_torch.models.nerf import render_chunk
    from lomanerf_tpu_torch.parallel import (RayBatch, data_mesh, gather_global_batch,
                                             host_local_batch_to_global, is_primary,
                                             make_render_step, make_train_step,
                                             place_state, process_count, process_index,
                                             shard_ray_chunks)
    from lomanerf_tpu_torch.train.steps import make_single_chip_train_step

    cfg = NeRFConfig(num_samples=8)
    mesh = data_mesh()
    nproc = process_count()
    # the GLOBAL batch is seeded; each rank takes its DISJOINT rows
    rng = np.random.default_rng(215)
    n_global = nproc * n_per_rank
    o_g, d_g = (torch.tensor(rng.standard_normal((n_global, 3)), dtype=torch.float32)
                for _ in range(2))
    tgt_g = torch.tensor(rng.random((n_global, 3)), dtype=torch.float32)
    t_vals, dists = uniform_depths(cfg.near, cfg.far, cfg.num_samples, "cpu")
    lo = process_index() * n_per_rank
    local = RayBatch(o_g[lo:lo + n_per_rank], d_g[lo:lo + n_per_rank], t_vals, dists,
                     tgt_g[lo:lo + n_per_rank])
    batch = host_local_batch_to_global(mesh, local)
    assembled = gather_global_batch(mesh, batch)
    if not torch.equal(assembled.origins, o_g) or not torch.equal(assembled.target, tgt_g):
        raise AssertionError("the ranks' slices do not assemble the global batch")

    params = _params(cfg)
    opt = torch.optim.SGD([*params["w"], *params["b"]], lr=1e-2)
    place_state(mesh, cfg, params, opt)
    loss = float(make_train_step(cfg, opt, mesh)(params, batch))
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")

    # the sharded render of the global rays: every rank gets every colour
    oc, dc, n = shard_ray_chunks(mesh, o_g, d_g, chunk=4)
    cols = make_render_step(cfg, mesh)(params, oc, dc)[:n]
    if not is_primary():
        return {}

    # the single-process oracle over the FULL batch from the same params
    ref = _params(cfg)
    ref_opt = torch.optim.SGD([*ref["w"], *ref["b"]], lr=1e-2)
    ref_loss = float(make_single_chip_train_step(cfg, ref_opt)(ref, o_g, d_g, t_vals,
                                                                dists, tgt_g))
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
    for a, b in zip([*params["w"], *params["b"]], [*ref["w"], *ref["b"]]):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=1e-5,
                                   atol=1e-6)
    with torch.no_grad():
        ref_cols = render_chunk(cfg, params, o_g, d_g)
    np.testing.assert_allclose(cols.numpy(), ref_cols.numpy(), rtol=1e-5, atol=1e-6)
    return {"processes": nproc, "backend": "gloo", "device": "cpu",
            "rays_global": n_global, "loss_multiprocess": loss,
            "loss_singleprocess": ref_loss, "params_allclose": True,
            "render_allclose": True}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="write the JSON result here")
    args = ap.parse_args(argv)

    from lomanerf_tpu_torch.parallel import run_ranks

    try:
        result = run_ranks(worker, N_PROC, N_RAYS_PER_RANK, threads=1)[0]
    except RuntimeError as e:
        print(e)
        sys.exit(1)
    print("MULTIPROCESS_OK", json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(f"{N_PROC}-process check PASSED")
    return result


if __name__ == "__main__":
    main()
