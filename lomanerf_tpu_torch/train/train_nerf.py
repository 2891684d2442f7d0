"""NeRF training driver on one device (port of ``lomanerf_tpu.train.train_nerf``).

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

Not ported yet (ROADMAP queue 1, item 10): ``--tp``, ``--coordinator``,
``--pipeline native|numpy`` and the mesh-sharded eval.

Run: ``python -m lomanerf_tpu_torch.train.train_nerf --preset small --steps 500``
(the narrow kernels) or ``--preset full --steps 300`` (the 8x256 bf16
flagship on the wide kernels; ~4 GB of saved activations per 4096-ray step).
"""

from __future__ import annotations

import argparse
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
    ap.add_argument("--preset", default=None, choices=["small", "single64", "full"],
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
                    help="shift each ray's depth comb by a random offset")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda runs the kernels, cpu the plain version")
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
    args = ap.parse_args(argv)

    from lomanerf_tpu_torch.core import psnr, stratified_ray_offsets, uniform_depths
    from lomanerf_tpu_torch.core.rays import get_rays, normalized_intrinsics
    from lomanerf_tpu_torch.models import NeRFConfig, NeRFModel
    from lomanerf_tpu_torch.train import optim
    from lomanerf_tpu_torch.train.checkpoint import CheckpointManager
    from lomanerf_tpu_torch.train.logging_utils import MetricsLogger, write_png
    from lomanerf_tpu_torch.train.steps import make_single_chip_train_step

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("train_nerf: --device cuda but no CUDA device; "
                         "pass --device cpu for the plain version")
    if args.preset:
        cfg = dataclasses.replace(NeRFConfig.preset(args.preset),
                                  near=args.near, far=args.far)
    else:
        cfg = NeRFConfig(num_layers=args.layers, filter_size=args.width,
                         num_encoding_functions=args.enc_functions,
                         num_samples=args.samples, near=args.near, far=args.far,
                         mode=args.mode)

    images, poses, focal = _views(args, device)
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
    params = list(model.parameters())
    opt = {
        "adam": lambda: torch.optim.Adam(params, lr=args.lr),
        "loma_adam": lambda: optim.loma_adam(params, args.lr),
        "sgd": lambda: optim.loma_sgd(params, args.lr),
    }[args.optimizer]()
    step_fn = make_single_chip_train_step(cfg, opt, backend=args.backend)

    ckpt = CheckpointManager(args.ckpt_dir)
    start_step = 0
    if args.resume and ckpt.latest_step() is not None:
        start_step = ckpt.restore(model, opt)
        print(f"resumed from step {start_step}")

    logger = MetricsLogger(args.log_dir)
    rng = np.random.default_rng(args.seed)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    view = args.eval_view % n_views
    losses, psnrs = [], {}
    for i in range(start_step, args.steps):
        v = int(rng.integers(n_views))
        idx = torch.from_numpy(rng.integers(n_pix, size=args.rays_per_batch)).to(device)
        o, d = all_o[v, idx], all_d[v, idx]
        if args.stratified:
            dt = stratified_ray_offsets(gen, args.rays_per_batch, cfg.near, cfg.far,
                                        cfg.num_samples)
            o = o + d * dt[:, None]
        loss = step_fn(model, o, d, t_vals, dists, all_t[v, idx])
        losses.append(float(loss))
        if not np.isfinite(losses[-1]):
            # report and stop, so the last checkpoint stays usable
            print(f"non-finite loss at step {i}; stopping")
            break

        if i % args.eval_every == 0:
            with torch.no_grad():
                img = model.render_image(K, poses[view], args.img_size)
            p = float(psnr(images[view], img))
            psnrs[i] = p
            logger.log(i, loss=losses[-1], psnr=p)
            print(f"step {i} loss {losses[-1]:.4f} psnr {p:.2f} dB")
            write_png(os.path.join(args.log_dir, f"{i}.png"),
                      (img.clamp(0, 1) * 255).to(torch.uint8).cpu().numpy())
        if args.ckpt_every and i and i % args.ckpt_every == 0:
            ckpt.save(i, model, opt)

    ckpt.save(args.steps, model, opt)
    logger.close()
    if losses:
        print(f"done; final loss {losses[-1]:.4f}")
    return {"losses": losses, "psnr": psnrs}


if __name__ == "__main__":
    main()
