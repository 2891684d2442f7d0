"""Synthetic volumetric scenes (port of ``lomanerf_tpu.data.synthetic``).

Camera poses (numpy), an analytic emission-absorption volume of coloured
Gaussian blobs rendered with the reference camera model, the training views
built in memory (``synthetic_views``: what the train driver uses, with no
image library), and the reference-format on-disk dataset writer.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np
import torch

from lomanerf_tpu_torch.core import composite, rays

LEGO_CAMERA_ANGLE_X = 0.8575560450553894  # the Blender lego scene's FOV


def look_at_pose(eye, target=(0.0, 0.0, 0.0), up=(0.0, 0.0, 1.0)) -> np.ndarray:
    """Camera-to-world pose, -z forward (Blender/NeRF convention)."""
    eye = np.asarray(eye, np.float32)
    target = np.asarray(target, np.float32)
    up = np.asarray(up, np.float32)
    fwd = eye - target  # camera looks along -z, so +z points away from target
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(up, fwd)
    right = right / np.linalg.norm(right)
    true_up = np.cross(fwd, right)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0] = right
    c2w[:3, 1] = true_up
    c2w[:3, 2] = fwd
    c2w[:3, 3] = eye
    return c2w


def sphere_poses(n: int, radius: float = 4.0, elevation: float = 0.5) -> np.ndarray:
    """n camera poses on a circle around the origin at fixed elevation."""
    poses = []
    for k in range(n):
        th = 2 * np.pi * k / n
        eye = (
            radius * np.cos(th),
            radius * np.sin(th),
            radius * np.sin(elevation),
        )
        poses.append(look_at_pose(eye))
    return np.stack(poses)


class GaussianBlobScene:
    """Analytic volume: a sum of coloured Gaussian density blobs, drawn from
    ``np.random.default_rng(seed)`` exactly as the JAX package draws them,
    held as float32 tensors on ``device``."""

    def __init__(self, seed: int = 0, num_blobs: int = 4, extent: float = 1.0,
                 device: torch.device | str = "cpu"):
        g = np.random.default_rng(seed)

        def f32(x):
            return torch.tensor(np.asarray(x, np.float32), device=device)

        self.centers = f32(g.uniform(-extent * 0.6, extent * 0.6, (num_blobs, 3)))
        self.scales = f32(g.uniform(0.15, 0.4, (num_blobs,)))
        self.peaks = f32(g.uniform(4.0, 10.0, (num_blobs,)))
        self.colors = f32(g.uniform(0.2, 1.0, (num_blobs, 3)))

    def field(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(sigma, rgb)`` at points ``x`` ``(..., 3)``."""
        d2 = torch.sum((x[..., None, :] - self.centers) ** 2, dim=-1)  # (..., B)
        w = self.peaks * torch.exp(-0.5 * d2 / self.scales ** 2)
        sigma = torch.sum(w, dim=-1)
        rgb = torch.sum(w[..., None] * self.colors, dim=-2) / (sigma[..., None] + 1e-6)
        return sigma, torch.clamp(rgb, 0.0, 1.0)

    def render(self, K: torch.Tensor, c2w, img_size: int, num_samples: int = 128,
               near: float = 2.0, far: float = 6.0) -> torch.Tensor:
        """Ground-truth ``(img_size, img_size, 3)`` render on the scene's
        device: dense samples and standard compositing."""
        dev = self.centers.device
        K = torch.as_tensor(K, dtype=torch.float32).to(dev)
        c2w = torch.as_tensor(c2w, dtype=torch.float32).to(dev)
        o, d = rays.get_rays(img_size, img_size, K, c2w)
        pts, _, dists = rays.sample_along_rays(o, d, near, far, num_samples)
        sigma, rgb = self.field(pts)
        weights = composite.render_weights(sigma, dists, mode="standard")
        return composite.accumulate_color(weights, rgb).reshape(img_size, img_size, 3)


def focal_of(camera_angle_x: float) -> float:
    """Normalised focal length (principal point 0.5) of a horizontal FOV."""
    return float(0.5 / np.tan(0.5 * camera_angle_x))


def synthetic_views(n_frames: int = 16, img_size: int = 64,
                    scene: Optional[GaussianBlobScene] = None,
                    camera_angle_x: float = LEGO_CAMERA_ANGLE_X,
                    radius: float = 4.0, device: torch.device | str = "cpu"):
    """The synthetic training set, built in memory on ``device``: ``(images
    (V, H, W, 3) float32, poses (V, 4, 4) float32, focal)``.  The same poses
    and renders as ``write_blender_dataset``, quantised as its PNG round
    trip quantises them (``uint8(clip(img, 0, 1) * 255) / 255``), so a
    driver needs no image library."""
    scene = scene or GaussianBlobScene(device=device)
    focal = focal_of(camera_angle_x)
    K = rays.normalized_intrinsics(focal, device=device)
    poses = sphere_poses(n_frames, radius=radius)
    images = []
    with torch.no_grad():
        for pose in poses:
            img = scene.render(K, pose, img_size)
            img8 = (torch.clamp(img, 0, 1) * 255).to(torch.uint8)
            images.append(img8.to(torch.float32) / 255.0)
    return torch.stack(images), torch.tensor(poses, device=device), focal


def write_blender_dataset(out_dir: str, scene: Optional[GaussianBlobScene] = None,
                          n_frames: int = 8, img_size: int = 64,
                          camera_angle_x: float = LEGO_CAMERA_ANGLE_X,
                          phase: str = "train", radius: float = 4.0) -> str:
    """Render the scene from circular poses and write a reference-format
    dataset (``transforms_<phase>.json`` + ``<phase>/r_i.png``; needs PIL).
    Returns ``out_dir``."""
    from PIL import Image

    scene = scene or GaussianBlobScene()
    K = rays.normalized_intrinsics(focal_of(camera_angle_x),
                                   device=scene.centers.device)
    poses = sphere_poses(n_frames, radius=radius)
    os.makedirs(os.path.join(out_dir, phase), exist_ok=True)
    frames = []
    with torch.no_grad():
        for i, pose in enumerate(poses):
            img = scene.render(K, pose, img_size).cpu().numpy()
            img8 = (np.clip(img, 0, 1) * 255).astype(np.uint8)
            rel = f"{phase}/r_{i}"
            Image.fromarray(img8).save(os.path.join(out_dir, rel + ".png"))
            frames.append({"file_path": rel,
                           "transform_matrix": [list(map(float, r)) for r in pose]})
    with open(os.path.join(out_dir, f"transforms_{phase}.json"), "w") as f:
        json.dump({"camera_angle_x": camera_angle_x, "frames": frames}, f)
    return out_dir
