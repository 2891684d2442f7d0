"""Camera poses for synthetic scenes (numpy; port of the pose helpers of
``lomanerf_tpu.data.synthetic``)."""

from __future__ import annotations

import numpy as np


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
