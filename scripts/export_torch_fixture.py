"""Export the trained 3x30 NeRF checkpoint as a numpy fixture for the port.

Restores ``artifacts/convergence_64/ckpt/5000`` (read-only) through the JAX
package's ``CheckpointManager`` and writes
``tests/data/convergence_64_step5000.npz`` holding:

  * ``w0..w{L-1}``, ``b0..b{L-1}`` — the trained MLP params, f32;
  * ``cfg_<field>`` — the ``NeRFConfig`` fields the render needs;
  * ``focal``, ``poses`` — focal 1.1106 and ``sphere_poses(4, radius=4.0)``;
  * ``jax_renders`` — the jnp-backend (fp32 HIGHEST) renders of those poses
    at 64x64, (4, 64, 64, 3);
  * ``eval_pose``, ``eval_target``, ``eval_focal``, ``eval_jax_render``,
    ``eval_jax_psnr`` — view 2 of a regenerated 16-frame, 64x64 synthetic
    Blender scene (the training scene's generator), its target image, the
    JAX render of that view and its PSNR.

The PyTorch port (``lomanerf_tpu_torch``) reads this file without jax or
orbax.  Run from the repository root, on the CPU:

    JAX_PLATFORMS=cpu python scripts/export_torch_fixture.py
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from lomanerf_tpu.core import normalized_intrinsics, psnr  # noqa: E402
from lomanerf_tpu.data import (  # noqa: E402
    NeRFDataset,
    sphere_poses,
    write_blender_dataset,
)
from lomanerf_tpu.models import NeRFConfig, NeRFModel  # noqa: E402
from lomanerf_tpu.train.checkpoint import CheckpointManager  # noqa: E402

CONFIG_FIELDS = ("num_layers", "filter_size", "out_channels",
                 "num_encoding_functions", "num_samples", "near", "far",
                 "mode", "init")


def restore_params(ckpt_dir: str, step: int, cfg: NeRFConfig):
    """Params of ``ckpt_dir/step``, restored against a fresh template.  The
    checkpoint directory is only read (orbax restores in place)."""
    model = NeRFModel(cfg, backend="jnp")
    template = model.init(jax.random.PRNGKey(0))
    mgr = CheckpointManager(ckpt_dir)
    try:
        params, _, got = mgr.restore(template, optax.adam(5e-4).init(template),
                                     step=step)
    finally:
        mgr.close()
    assert got == step, (got, step)
    return params


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt-dir", default="artifacts/convergence_64/ckpt")
    ap.add_argument("--step", type=int, default=5000)
    ap.add_argument("--out", default="tests/data/convergence_64_step5000.npz")
    ap.add_argument("--img-size", type=int, default=64)
    ap.add_argument("--focal", type=float, default=1.1106)
    ap.add_argument("--eval-view", type=int, default=2)
    args = ap.parse_args(argv)

    cfg = NeRFConfig()  # precision "highest": the fp32 semantic core
    params = restore_params(args.ckpt_dir, args.step, cfg)
    model = NeRFModel(cfg, backend="jnp")
    size = args.img_size

    poses = sphere_poses(4, radius=4.0)
    K = normalized_intrinsics(args.focal)
    renders = np.stack([
        np.asarray(model.render_image(params, K, jnp.asarray(p), size))
        for p in poses
    ])

    # the training scene, regenerated with the driver's own settings
    # (train_nerf.py: write_blender_dataset(n_frames=16, img_size=...))
    tmp = tempfile.mkdtemp(prefix="lomanerf_fixture_")
    try:
        write_blender_dataset(tmp, n_frames=16, img_size=size)
        ds = NeRFDataset(tmp, img_size=size, phase="train")
        view = ds[args.eval_view % len(ds)]
        eval_focal = ds.focal_length
    finally:
        shutil.rmtree(tmp)
    eval_render = np.asarray(model.render_image(
        params, normalized_intrinsics(eval_focal),
        jnp.asarray(view["pose"]), size))
    eval_psnr = float(psnr(jnp.asarray(view["image"]),
                           jnp.asarray(eval_render)))

    out = {}
    for i, (w, b) in enumerate(zip(params["w"], params["b"])):
        out[f"w{i}"] = np.asarray(w, np.float32)
        out[f"b{i}"] = np.asarray(b, np.float32)
    fields = dataclasses.asdict(cfg)
    for name in CONFIG_FIELDS:
        out[f"cfg_{name}"] = np.asarray(fields[name])
    out.update(
        step=np.asarray(args.step),
        focal=np.asarray(args.focal, np.float32),
        poses=poses.astype(np.float32),
        jax_renders=renders.astype(np.float32),
        eval_pose=np.asarray(view["pose"], np.float32),
        eval_target=np.asarray(view["image"], np.float32),
        eval_focal=np.asarray(eval_focal, np.float32),
        eval_jax_render=eval_render.astype(np.float32),
        eval_jax_psnr=np.asarray(eval_psnr, np.float32),
    )
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes); "
          f"eval view {args.eval_view} JAX PSNR {eval_psnr:.4f} dB")


if __name__ == "__main__":
    main()
