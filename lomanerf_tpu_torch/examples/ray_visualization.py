"""Rays and dataset frames, plotted (port of ``examples/ray_visualization.py``,
the counterpart of the reference's rayvis and dataloader notebooks).

A 3D plot of camera origins, a sparse set of rays per camera and their
depth samples (``core.get_rays``, ``core.sample_along_rays``), beside a
contact sheet of the frames, from the synthetic scene (``--data
synthetic``, built in memory) or a Blender-format dataset directory.
Without matplotlib it writes the contact sheet alone as a PNG.

Run: ``python -m lomanerf_tpu_torch.examples.ray_visualization [--device cpu]
--out rayvis.png``
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def main(argv=None) -> dict:
    """Returns the focal length, the poses plotted and each one's sampled
    ``(origins, directions, points)``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", default="synthetic",
                    help="'synthetic' (built in memory) or a Blender-format dataset dir")
    ap.add_argument("--img-size", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="rayvis.png")
    args = ap.parse_args(argv)

    from lomanerf_tpu_torch.core import get_rays, normalized_intrinsics, sample_along_rays
    from lomanerf_tpu_torch.data import NeRFDataset, synthetic_views

    if args.data == "synthetic":
        images, poses, focal = synthetic_views(8, args.img_size, device=args.device)
        images, poses = images.cpu().numpy(), poses.cpu().numpy()
    else:
        ds = NeRFDataset(args.data, img_size=args.img_size)
        images = np.stack([ds[i]["image"] for i in range(len(ds))])
        poses = np.stack([ds[i]["pose"] for i in range(len(ds))])
        focal = ds.focal_length
    K = normalized_intrinsics(focal, device=args.device)
    out = {"focal": focal, "poses": [], "rays": []}
    for pose in poses[::2]:
        o, d = get_rays(args.img_size, args.img_size, K, torch.from_numpy(pose))
        sel = np.linspace(0, o.shape[0] - 1, 9).astype(int)  # a sparse subset a camera
        pts, _, _ = sample_along_rays(o[sel], d[sel], 2.0, 6.0, 8)
        out["poses"].append(pose)
        out["rays"].append(tuple(x.cpu().numpy() for x in (o[sel], d[sel], pts)))

    try:
        import matplotlib
    except ImportError:
        from lomanerf_tpu_torch.train.logging_utils import write_png

        sheet = np.concatenate(list(images[:6]), axis=1)
        write_png(args.out, (np.clip(sheet, 0, 1) * 255).astype(np.uint8))
        print(f"wrote {args.out} (the frames only: matplotlib is not installed)")
        return out
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(14, 6))
    ax = fig.add_subplot(1, 2, 1, projection="3d")
    for o, d, pts in out["rays"]:
        ax.scatter(*o[0], marker="o", s=40)
        for r in range(len(o)):
            ax.plot(*np.stack([o[r], o[r] + 6.0 * d[r]]).T, alpha=0.3, lw=0.8)
            ax.scatter(*pts[r].T, s=2, alpha=0.5)
    ax.set_title("camera origins, rays, depth samples")
    for i in range(min(len(images), 6)):
        axi = fig.add_subplot(2, 6, 7 + i)
        axi.imshow(images[i])
        axi.set_title(f"frame {i}", fontsize=8)
        axi.axis("off")
    fig.tight_layout()
    fig.savefig(args.out, dpi=110)
    print(f"wrote {args.out}; {len(images)} frames, focal {focal:.4f}, image "
          f"{images[0].shape}")
    return out


if __name__ == "__main__":
    main()
