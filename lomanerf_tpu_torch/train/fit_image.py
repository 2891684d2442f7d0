"""2D image-fit training driver on one device (port of
``lomanerf_tpu.train.fit_image``).

Fits an MLP to a target image through positional-encoded pixel coords.  As
in the JAX driver: the whole image trains as one batch per step (``--chunk``
restores the reference's chunked steps); the optimizer is configurable (raw
SGD is the reference's default); ``--parity-seed`` seeds each step's adjoint
with the previous loss (the reference's ``_dreturn`` quirk, fit_img.py:497)
instead of 1.  On CUDA each step is one launch of the field kernel and one
of its backward kernel.  Every ``--log-every`` steps: the PSNR of the
whole-image render, and ``iter_<step>.png``, target | prediction side by
side (written without PIL or matplotlib, which the card's machine lacks);
the loss of every step goes to ``metrics.jsonl``.  Checkpoints every
``--ckpt-every`` steps and at the end; ``--resume`` restarts from the
latest.

Run: ``python -m lomanerf_tpu_torch.train.fit_image --steps 2000 --img synthetic``
(``--device cpu`` runs the plain version).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def synthetic_target(img_size: int) -> np.ndarray:
    """A colorful smooth test image (used when no --img is given)."""
    c = np.linspace(0, 1, img_size)
    ii, jj = np.meshgrid(c, c, indexing="xy")
    img = np.stack(
        [
            0.5 + 0.5 * np.sin(6.28 * ii) * np.cos(3.14 * jj),
            0.5 + 0.5 * np.cos(6.28 * (ii + jj)),
            0.5 + 0.5 * np.sin(9.42 * ii * jj),
        ],
        axis=-1,
    )
    return np.clip(img, 0, 1).astype(np.float32)


def load_target(path: str, img_size: int) -> np.ndarray:
    """The target image, resized and RGB in [0, 1] (``data.blender.load_rgb``:
    PIL where installed, else the port's PNG reader)."""
    from lomanerf_tpu_torch.data.blender import load_rgb

    return load_rgb(path, img_size)


def _to_u8(img: torch.Tensor) -> np.ndarray:
    return (img.clamp(0, 1) * 255).to(torch.uint8).cpu().numpy()


def main(argv=None) -> dict:
    """Run the driver; returns ``{"losses": [...], "psnr": {step: dB},
    "final_psnr": dB}``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--img", default="synthetic",
                    help="'synthetic' or a path to an image file")
    ap.add_argument("--img-size", type=int, default=256)
    ap.add_argument("--steps", type=int, default=50000)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--optimizer", default="sgd", choices=["sgd", "adam", "loma_adam"])
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--width", type=int, default=16)
    ap.add_argument("--enc-functions", type=int, default=5)
    ap.add_argument("--chunk", type=int, default=0,
                    help="pixels per step (0 = full image per step)")
    ap.add_argument("--parity-seed", action="store_true",
                    help="seed adjoints with the previous loss (reference quirk)")
    ap.add_argument("--log-every", type=int, default=250)
    ap.add_argument("--log-dir", default="logs_2d")
    ap.add_argument("--ckpt-dir", default="checkpoints/fit_image")
    ap.add_argument("--ckpt-every", type=int, default=5000)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--backend", default="auto", choices=["auto", "plain"],
                    help="auto: the fused field (the kernels on CUDA); plain: "
                         "autograd through the core pipeline, for comparisons")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda runs the kernels, cpu the plain version")
    args = ap.parse_args(argv)

    from lomanerf_tpu_torch.core import psnr
    from lomanerf_tpu_torch.models import ImageFieldConfig, ImageFieldModel, image_grid_coords
    from lomanerf_tpu_torch.train import optim
    from lomanerf_tpu_torch.train.checkpoint import CheckpointManager
    from lomanerf_tpu_torch.train.logging_utils import MetricsLogger, write_png
    from lomanerf_tpu_torch.train.steps import make_image_fit_step

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("fit_image: --device cuda but no CUDA device; "
                         "pass --device cpu for the plain version")
    cfg = ImageFieldConfig(num_layers=args.layers, filter_size=args.width,
                           num_encoding_functions=args.enc_functions,
                           img_size=args.img_size)
    model = ImageFieldModel(cfg, device=device, backend=args.backend)
    model.init(torch.Generator().manual_seed(215))

    target_np = (synthetic_target(args.img_size) if args.img == "synthetic"
                 else load_target(args.img, args.img_size))
    target = torch.from_numpy(target_np).to(device)
    target_flat = target.reshape(-1, 3)
    coords = image_grid_coords(args.img_size, device)

    params = list(model.parameters())
    opt = {
        "sgd": lambda: optim.loma_sgd(params, args.lr),
        "adam": lambda: torch.optim.Adam(params, lr=args.lr),
        "loma_adam": lambda: optim.loma_adam(params, args.lr),
    }[args.optimizer]()
    step_fn = make_image_fit_step(cfg, opt, backend=args.backend)

    ckpt = CheckpointManager(args.ckpt_dir)
    start_step = 0
    if args.resume and ckpt.latest_step() is not None:
        start_step = ckpt.restore(model, opt)
        print(f"resumed from step {start_step}")

    def render():
        with torch.no_grad():
            pred = model.render()
        return pred, float(psnr(pred, target))

    def save_frame(step, pred):
        # target | prediction, side by side
        write_png(os.path.join(args.log_dir, f"iter_{step}.png"),
                  np.concatenate([_to_u8(target), _to_u8(pred)], axis=1))

    logger = MetricsLogger(args.log_dir)
    n_px = coords.shape[0]
    chunk = args.chunk or n_px
    losses, psnrs, prev_loss = [], {}, None
    for i in range(start_step, args.steps):
        for lo in range(0, n_px, chunk):
            seed = prev_loss if args.parity_seed else None
            loss = step_fn(model, coords[lo:lo + chunk], target_flat[lo:lo + chunk], seed)
            prev_loss = loss
        losses.append(float(loss))
        if i % args.log_every == 0:
            pred, p = render()
            psnrs[i] = p
            logger.log(i, loss=losses[-1], psnr=p)
            print(f"step {i} loss {losses[-1]:.4f} psnr {p:.2f} dB")
            save_frame(i, pred)
        else:
            logger.log(i, loss=losses[-1])
        if args.ckpt_every and i and i % args.ckpt_every == 0:
            ckpt.save(i, model, opt)

    ckpt.save(args.steps, model, opt)
    pred, final = render()
    save_frame(args.steps, pred)
    logger.close()
    print(f"final psnr: {final:.2f} dB")
    return {"losses": losses, "psnr": psnrs, "final_psnr": final}


if __name__ == "__main__":
    main()
