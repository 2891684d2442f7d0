"""NeRF training driver (port of ``lomanerf_tpu.train.train_nerf``), on one
card or data-parallel over many (one process per card, ``parallel/``).

Trains a radiance field on the synthetic scene (built in memory) or a
Blender-format dataset directory.  Per step: a random view and a fixed-size
random ray batch drawn from ``np.random.default_rng(seed)`` exactly as the
JAX driver draws them, optional stratified depth offsets folded into the
origins (depths stay ``(S,)``), one train step (on CUDA: one call of the
fused train kernel for loss and gradients), a stop on a non-finite loss.
Every ``--eval-every`` steps: PSNR of the eval view and ``<step>.png`` of
its render; checkpoints every ``--ckpt-every`` steps and at the end;
``--resume`` restarts from the latest.  Every view's rays and targets stay
on the device: each step sends only the ray indices.

Several processes (``torchrun``, or ``--coordinator`` with ``RANK`` and
``WORLD_SIZE`` set for each): each rank draws its own ``--rays-per-batch``
rays from the seed ``seed + 7919 * data index`` (its rank when ``--tp`` is
1), the step sums the ranks' gradients and losses in one all-reduce, the
eval frame's rays are sharded over the ranks (with ``--tp`` the full params
are gathered and each rank renders the frame), and only rank 0 prints and
writes metrics, PNGs and checkpoints.  ``--tp N`` shards the MLP over N
ranks and runs on ``--backend plain`` only.  With one process and no
distributed environment the run is the single-card run, bit for bit.

``--pipeline native`` (or ``numpy``) draws each step's batch from
``data.native.RayBatchPipeline`` instead: the C++ prefetcher's worker pool
(``--pipeline-threads``; batches in batch-id order, so any thread count
gives the same run) or its numpy twin, seeded with the same per-rank seed,
on the host, one copy to the card a step.  Its depths are in offset form:
the driver folds each ray's offset into its origin (``o + d * dt``) and
trains on the pipeline's static ``(S,)`` comb, so stratified runs stay on
the shared-depth train kernel.

Run: ``python -m lomanerf_tpu_torch.train.train_nerf --preset small --steps 500``
(the narrow kernels) or ``--preset full --steps 300`` (the 8x256 bf16
flagship on the wide kernels; ~4 GB of saved activations per 4096-ray step)
or ``--preset paper --stratified`` (NeRF as published, coarse and fine
networks; its fine depths are drawn from the run's generator) or ``--preset
mipnerf360`` (mip-NeRF 360: the proposal network, then the NeRF MLP on the
resampled intervals; the resampler's jitter from the run's generator, the
cone radius from the views' focal length);
on N cards ``torchrun --nproc_per_node=N -m lomanerf_tpu_torch.train.train_nerf
--preset small`` (NCCL).
"""

from __future__ import annotations

import argparse
import math
import dataclasses
import os

import numpy as np
import torch


def _views(args, device):
    """``(images (V, H, W, 3), poses (V, 4, 4), focal)`` on ``device``."""
    from lomanerf_tpu_torch.data import NeRFDataset, synthetic_views

    if args.data == "synthetic":
        return synthetic_views(16, args.img_size, device=device)
    dataset = NeRFDataset(args.data, img_size=args.img_size, phase="train")
    items = [dataset[i] for i in range(len(dataset))]
    images = torch.tensor(np.stack([x["image"] for x in items]), device=device)
    poses = torch.tensor(np.stack([x["pose"] for x in items]), device=device)
    return images, poses, dataset.focal_length


def main(argv=None) -> dict:
    """Run the driver; returns ``{"losses": [...], "psnr": {step: dB}}``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", default="synthetic",
                    help="'synthetic' (built in memory) or a Blender-format dataset dir")
    ap.add_argument("--preset", default=None, choices=["small", "single64", "full", "paper", "mipnerf360"],
                    help="NeRFConfig ladder preset (overrides --layers/--width/"
                         "--samples/--mode)")
    ap.add_argument("--img-size", type=int, default=64)
    ap.add_argument("--steps", type=int, default=50000)
    ap.add_argument("--rays-per-batch", type=int, default=4096)
    ap.add_argument("--samples", type=int, default=30)
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--width", type=int, default=30)
    ap.add_argument("--enc-functions", type=int, default=5)
    ap.add_argument("--near", type=float, default=2.0)
    ap.add_argument("--far", type=float, default=6.0)
    ap.add_argument("--lr", type=float, default=5e-4)
    ap.add_argument("--optimizer", default="adam", choices=["adam", "loma_adam", "sgd"])
    ap.add_argument("--mode", default="loma", choices=["loma", "standard"],
                    help="transmittance mode (loma = reference parity)")
    ap.add_argument("--stratified", action="store_true",
                    help="shift each ray's depth comb by a random offset (--preset paper: "
                         "a draw in each of the coarse bins, per ray)")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda runs the kernels, cpu the plain version")
    ap.add_argument("--pipeline", default="python", choices=["python", "native", "numpy"],
                    help="ray-batch producer: in-driver python, the C++ prefetcher, or its "
                         "numpy twin")
    ap.add_argument("--pipeline-threads", type=int, default=4,
                    help="worker threads of --pipeline native")
    ap.add_argument("--backend", default="auto", choices=["auto", "plain"],
                    help="auto: the fused train loss (the kernel on CUDA); plain: "
                         "autograd through the core pipeline, for comparisons")
    ap.add_argument("--eval-every", type=int, default=25)
    ap.add_argument("--eval-view", type=int, default=2)
    ap.add_argument("--log-dir", default="logs_3d")
    ap.add_argument("--ckpt-dir", default="checkpoints/train_nerf")
    ap.add_argument("--ckpt-every", type=int, default=1000)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=215)
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel size (ranks per MLP; --backend plain only)")
    ap.add_argument("--coordinator", default=None,
                    help="rendezvous host:port (or an init_method URL) of a multi-process "
                         "run, each process with RANK and WORLD_SIZE set; omit under "
                         "torchrun and on one process")
    args = ap.parse_args(argv)

    from lomanerf_tpu_torch.core import psnr, stratified_ray_offsets, uniform_depths
    from lomanerf_tpu_torch.core.rays import get_rays, normalized_intrinsics
    from lomanerf_tpu_torch.models import NeRFConfig, NeRFModel
    from lomanerf_tpu_torch.parallel import (RayBatch, build_kernels_once,
                                             initialize_multihost, is_primary, make_mesh,
                                             make_train_step, place_state, process_count,
                                             rank_device, unshard_tp_params)
    from lomanerf_tpu_torch.train import optim
    from lomanerf_tpu_torch.train.checkpoint import CheckpointManager
    from lomanerf_tpu_torch.train.logging_utils import MetricsLogger, write_png
    from lomanerf_tpu_torch.utils.profiling import span

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("train_nerf: --device cuda but no CUDA device; "
                         "pass --device cpu for the plain version")
    if args.coordinator and not {"RANK", "WORLD_SIZE"} <= os.environ.keys():
        raise SystemExit("train_nerf: --coordinator needs RANK and WORLD_SIZE set for "
                         "each process")
    # the process group first: the mesh below spans every rank
    owns_group = initialize_multihost(args.coordinator,
                                      backend="gloo" if device.type == "cpu" else None)
    if process_count() % args.tp:
        raise SystemExit(f"train_nerf: --tp {args.tp} does not divide the "
                         f"{process_count()} ranks")
    device = rank_device(device)
    if device.type == "cuda":
        build_kernels_once()
    mesh = make_mesh(tp=args.tp, device=device)
    tp = args.tp > 1
    if args.preset:
        cfg = dataclasses.replace(NeRFConfig.preset(args.preset),
                                  near=args.near, far=args.far)
    else:
        cfg = NeRFConfig(num_layers=args.layers, filter_size=args.width,
                         num_encoding_functions=args.enc_functions,
                         num_samples=args.samples, near=args.near, far=args.far,
                         mode=args.mode)
    if (cfg.view_branch or cfg.mip360) and (tp or args.pipeline != "python"):
        raise SystemExit("train_nerf: --preset paper and mipnerf360 train with --tp 1 and "
                         "--pipeline python")

    images, poses, focal = _views(args, device)
    if cfg.mip360:  # a ray's cone radius: 2 / sqrt(12) of the pixel pitch
        cfg = dataclasses.replace(cfg, pixel_radius=2.0 / math.sqrt(12.0)
                                  / (focal * (args.img_size - 1)))
    n_views, n_pix = images.shape[0], args.img_size * args.img_size
    K = normalized_intrinsics(focal, device=device)
    # every view's rays and targets, once, on the device
    rays = [get_rays(args.img_size, args.img_size, K, p) for p in poses]
    all_o = torch.stack([o for o, _ in rays]).contiguous()  # (V, HW, 3)
    all_d = torch.stack([d for _, d in rays]).contiguous()
    all_t = images.reshape(n_views, -1, 3)
    t_vals, dists = uniform_depths(cfg.near, cfg.far, cfg.num_samples, device)

    model = NeRFModel(cfg, device=device)
    model.init(torch.Generator().manual_seed(args.seed))
    leaves = list(model.parameters())
    opt = {
        "adam": lambda: torch.optim.Adam(leaves, lr=args.lr),
        "loma_adam": lambda: optim.loma_adam(leaves, args.lr),
        "sgd": lambda: optim.loma_sgd(leaves, args.lr),
    }[args.optimizer]()

    ckpt = CheckpointManager(args.ckpt_dir)
    start_step = 0
    if args.resume and ckpt.latest_step() is not None:
        start_step = ckpt.restore(model, opt)
        if is_primary():
            print(f"resumed from step {start_step}")
    # replicas equal over the data axis; with --tp this rank's shard
    params = place_state(mesh, cfg, model, opt, tp=tp)
    # each data shard draws its own rays (the JAX trainer's per-host stream);
    # for --preset paper gen also draws the fine depths, for mipnerf360 the
    # resampler's jitter
    seed = args.seed + 7919 * mesh.data_index
    gen = torch.Generator(device=device).manual_seed(seed)
    step_fn = make_train_step(cfg, opt, mesh, tp=tp, backend=args.backend,
                              generator=gen if cfg.view_branch or cfg.mip360 else None)
    # sharded eval frames over the data axis (with --tp: full params, whole frames)
    eval_mesh = mesh if mesh.dp > 1 and not tp else None

    logger = MetricsLogger(args.log_dir)
    rng = np.random.default_rng(seed)
    pipe = None
    if args.pipeline != "python":
        from lomanerf_tpu_torch.data.native import RayBatchPipeline

        pipe = RayBatchPipeline(poses, images, focal, args.rays_per_batch, cfg.num_samples,
                                cfg.near, cfg.far, stratified=args.stratified, seed=seed,
                                n_threads=args.pipeline_threads,
                                force_numpy=args.pipeline == "numpy", device=device)
        t_vals, dists = pipe.t_base, pipe.dists
    view = args.eval_view % n_views
    losses, psnrs = [], {}
    for i in range(start_step, args.steps):
        with span("train_nerf.step"):
            if pipe is not None:
                o, d, dt, tgt = pipe.next_batch()
                o = o + d * dt[:, None]
            else:
                v = int(rng.integers(n_views))
                idx = torch.from_numpy(rng.integers(n_pix, size=args.rays_per_batch)).to(device)
                o, d, tgt = all_o[v, idx], all_d[v, idx], all_t[v, idx]
                if args.stratified and cfg.view_branch:
                    _, t_vals, dists = model.sample(o, d, generator=gen)
                elif args.stratified:
                    dt = stratified_ray_offsets(gen, args.rays_per_batch, cfg.near, cfg.far,
                                                cfg.num_samples)
                    o = o + d * dt[:, None]
            loss = step_fn(params, RayBatch(o, d, t_vals, dists, tgt))
            losses.append(float(loss))
        if not np.isfinite(losses[-1]):
            # report and stop (every rank: the loss is summed over them),
            # so the last checkpoint stays usable
            if is_primary():
                print(f"non-finite loss at step {i}; stopping")
            break

        if i % args.eval_every == 0:
            with torch.no_grad():
                if tp:
                    model.load_params(unshard_tp_params(params, cfg.num_layers,
                                                        mesh.model_group))
                img = model.render_image(K, poses[view], args.img_size, mesh=eval_mesh)
            p = float(psnr(images[view], img))
            psnrs[i] = p
            logger.log(i, loss=losses[-1], psnr=p)
            if is_primary():
                print(f"step {i} loss {losses[-1]:.4f} psnr {p:.2f} dB")
                write_png(os.path.join(args.log_dir, f"{i}.png"),
                          (img.clamp(0, 1) * 255).to(torch.uint8).cpu().numpy())
        if args.ckpt_every and i and i % args.ckpt_every == 0:
            ckpt.save(i, params, opt, mesh=mesh, config=cfg, tp=tp)

    if pipe is not None:
        pipe.close()
    ckpt.save(args.steps, params, opt, mesh=mesh, config=cfg, tp=tp)
    logger.close()
    if losses and is_primary():
        print(f"done; final loss {losses[-1]:.4f}")
    if owns_group:
        torch.distributed.destroy_process_group()
    return {"losses": losses, "psnr": psnrs}


if __name__ == "__main__":
    main()
