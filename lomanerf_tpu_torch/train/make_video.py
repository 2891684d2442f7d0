"""Render an orbit of a trained NeRF into a video, or stitch numbered PNG
frames into one (port of ``lomanerf_tpu.train.make_video``): the orbit from
a params ``.npz`` or from the port's own checkpoints (``train_nerf
--ckpt-dir``), the frames with ``--frames DIR`` (its ``*.png`` in the
numeric order of the digits in their names, read by the port's zlib reader).

The video goes through imageio (a gif where it has no ffmpeg backend).
Where imageio is not installed, the frames are written as numbered PNGs
into ``<out without its extension>_frames/`` next to ``--out`` instead, and
the run says so; ``--frames`` on that directory makes the video where
imageio is.

Run:
    python -m lomanerf_tpu_torch.train.make_video \
        --params tests/data/convergence_64_step5000.npz --preset small \
        --orbit 8 --img-size 800 --out orbit.mp4
    python -m lomanerf_tpu_torch.train.make_video \
        --ckpt-dir checkpoints/train_nerf --preset small --orbit 60 --out orbit.mp4
    python -m lomanerf_tpu_torch.train.make_video \
        --ckpt-dir checkpoints/train_nerf --preset full --orbit 8 --img-size 800

    python -m lomanerf_tpu_torch.train.make_video --frames orbit_frames --out orbit.mp4

``--preset full`` renders through the wide kernels (65,536-ray chunks);
``--preset paper`` (NeRF as published: coarse, then fine on the depths drawn
from the coarse weights) through ``nerf_paper_render`` on one rank, and
``--preset mipnerf360`` (the proposal rounds, then the NeRF pass) through
``ops.mip360.render_rays`` on one rank.
Under ``torchrun --nproc_per_node=N`` each frame's rays are sharded over
the ranks (``parallel.render_step``, as the JAX driver shards them over its
devices) and only rank 0 writes.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch

from lomanerf_tpu_torch.core import normalized_intrinsics
from lomanerf_tpu_torch.data import sphere_poses
from lomanerf_tpu_torch.train.logging_utils import read_png, write_png


@torch.no_grad()
def render_orbit(model, focal: float, radius: float, n: int, img_size: int,
                 mesh=None) -> np.ndarray:
    """``(n, img_size, img_size, 3)`` uint8 frames of ``model`` seen from
    ``sphere_poses(n, radius)``, rendered on the model's device; with
    ``mesh``, each frame's rays sharded over its data group (every rank
    calls it and gets every frame)."""
    K = normalized_intrinsics(focal, device=model.device)
    frames = []
    for pose in sphere_poses(n, radius=radius):
        img = model.render_image(K, pose, img_size, mesh=mesh)
        frames.append((img.clamp(0, 1) * 255).to(torch.uint8).cpu().numpy())
    return np.stack(frames)


def read_frames(directory: str) -> np.ndarray:
    """The ``*.png`` of ``directory`` as ``(n, H, W, 3)`` uint8, in the
    numeric order of the digits in their names (as the JAX driver sorts
    them)."""
    paths = sorted(glob.glob(os.path.join(directory, "*.png")), key=lambda p: int(
        "".join(c for c in os.path.basename(p) if c.isdigit()) or 0))
    if not paths:
        raise SystemExit(f"no PNG frames in {directory}")
    return np.stack([read_png(p)[..., :3] for p in paths])


def write_video(frames: np.ndarray, out: str, fps: int) -> str:
    """Write ``frames`` to ``out`` through imageio (a gif where it has no
    ffmpeg backend) or, without imageio, as numbered PNGs into
    ``<out without its extension>_frames/``; returns the path written."""
    try:
        import imageio.v2 as imageio
    except ImportError:
        folder = os.path.splitext(out)[0] + "_frames"
        for i, frame in enumerate(frames):
            write_png(os.path.join(folder, f"{i:04d}.png"), frame)
        print(f"imageio is not installed: wrote {len(frames)} numbered PNGs to {folder} "
              f"(make_video --frames {folder} stitches them where imageio is)")
        return folder
    try:
        imageio.mimsave(out, list(frames), fps=fps)
    except (ValueError, OSError):
        # no ffmpeg backend available: write a gif instead
        out = os.path.splitext(out)[0] + ".gif"
        imageio.mimsave(out, list(frames), fps=fps)
    print(f"wrote {out} ({len(frames)} frames)")
    return out


def main(argv=None) -> str:
    """Run the driver; returns the path of the video (or of the frames'
    directory) it wrote, ``None`` on ranks other than 0."""
    from lomanerf_tpu_torch.models import NeRFConfig, NeRFModel
    from lomanerf_tpu_torch.parallel import (build_kernels_once, data_mesh,
                                             initialize_multihost, is_primary,
                                             process_count, rank_device)
    from lomanerf_tpu_torch.train.checkpoint import CheckpointManager, load_params_npz

    ap = argparse.ArgumentParser()
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--frames", help="directory of numbered PNGs to stitch")
    src.add_argument("--params",
                     help="npz of w0.., b0.. params (scripts/export_torch_fixture.py)")
    src.add_argument("--ckpt-dir",
                     help="render from the latest checkpoint of train_nerf in this dir")
    ap.add_argument("--preset", default=None,
                    choices=["small", "single64", "full", "paper", "mipnerf360"],
                    help="NeRFConfig preset (must match the params; overrides "
                         "--layers/--width/--samples/--enc-functions)")
    ap.add_argument("--samples", type=int, default=30)
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--width", type=int, default=30)
    ap.add_argument("--enc-functions", type=int, default=5)
    ap.add_argument("--orbit", type=int, default=60, help="orbit frame count")
    ap.add_argument("--img-size", type=int, default=64)
    ap.add_argument("--focal", type=float, default=1.1106)
    ap.add_argument("--radius", type=float, default=4.0)
    ap.add_argument("--fps", type=int, default=15)
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda runs the CUDA kernel, cpu the plain version")
    ap.add_argument("--out", default="nerf.mp4")
    args = ap.parse_args(argv)
    if args.frames:
        return write_video(read_frames(args.frames), args.out, args.fps)
    if args.preset:
        cfg = NeRFConfig.preset(args.preset)
    else:
        cfg = NeRFConfig(num_layers=args.layers, filter_size=args.width,
                         num_encoding_functions=args.enc_functions,
                         num_samples=args.samples)
    # under torchrun: one rank per card, each frame's rays over the ranks
    owns_group = initialize_multihost(
        backend="gloo" if torch.device(args.device).type == "cpu" else None)
    device = rank_device(args.device)
    if device.type == "cuda":
        build_kernels_once()
    mesh = data_mesh(device) if process_count() > 1 else None
    if args.params:
        p = load_params_npz(args.params)
        model = NeRFModel.from_numpy(cfg, p["w"], p["b"], device=device)
    else:
        model = NeRFModel(cfg, device=device)
        step = CheckpointManager(args.ckpt_dir).restore(model)
        if is_primary():
            print(f"restored step {step} from {args.ckpt_dir}")
    if is_primary():
        print(f"rendering {args.orbit}-frame orbit at {args.img_size}px on {args.device} "
              f"({process_count()} rank(s))")
    frames = render_orbit(model, args.focal, args.radius, args.orbit, args.img_size, mesh)
    wrote = write_video(frames, args.out, args.fps) if is_primary() else None
    if owns_group:
        torch.distributed.destroy_process_group()
    return wrote


if __name__ == "__main__":
    main()
