"""Render an orbit of a trained NeRF into a video (port of the ``--ckpt-dir``
path of ``lomanerf_tpu.train.make_video``).

Run:
    python -m lomanerf_tpu_torch.train.make_video \
        --params tests/data/convergence_64_step5000.npz --preset small \
        --orbit 8 --img-size 800 --out orbit.mp4
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from lomanerf_tpu_torch.core import normalized_intrinsics
from lomanerf_tpu_torch.data import sphere_poses


@torch.no_grad()
def render_orbit(model, focal: float, radius: float, n: int, img_size: int) -> np.ndarray:
    """``(n, img_size, img_size, 3)`` uint8 frames of ``model`` seen from
    ``sphere_poses(n, radius)``, rendered on the model's device."""
    K = normalized_intrinsics(focal, device=model.device)
    frames = []
    for pose in sphere_poses(n, radius=radius):
        img = model.render_image(K, pose, img_size)
        frames.append((img.clamp(0, 1) * 255).to(torch.uint8).cpu().numpy())
    return np.stack(frames)


def main(argv=None) -> None:
    from lomanerf_tpu_torch.models import NeRFConfig, NeRFModel
    from lomanerf_tpu_torch.train.checkpoint import load_params_npz

    ap = argparse.ArgumentParser()
    ap.add_argument("--params", required=True,
                    help="npz of w0.., b0.. params (scripts/export_torch_fixture.py)")
    ap.add_argument("--preset", default="small",
                    choices=["small", "single64", "full"],
                    help="NeRFConfig preset (must match the params)")
    ap.add_argument("--orbit", type=int, default=60, help="orbit frame count")
    ap.add_argument("--img-size", type=int, default=64)
    ap.add_argument("--focal", type=float, default=1.1106)
    ap.add_argument("--radius", type=float, default=4.0)
    ap.add_argument("--fps", type=int, default=15)
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda runs the CUDA kernel, cpu the plain version")
    ap.add_argument("--out", default="nerf.mp4")
    args = ap.parse_args(argv)

    import imageio.v2 as imageio

    p = load_params_npz(args.params)
    model = NeRFModel.from_numpy(NeRFConfig.preset(args.preset), p["w"], p["b"],
                                 device=args.device)
    print(f"rendering {args.orbit}-frame orbit at {args.img_size}px on {args.device}")
    frames = render_orbit(model, args.focal, args.radius, args.orbit, args.img_size)
    out = args.out
    try:
        imageio.mimsave(out, list(frames), fps=args.fps)
    except (ValueError, OSError):
        # no ffmpeg backend available: write a gif instead
        out = os.path.splitext(out)[0] + ".gif"
        imageio.mimsave(out, list(frames), fps=args.fps)
    print(f"wrote {out} ({len(frames)} frames)")


if __name__ == "__main__":
    main()
