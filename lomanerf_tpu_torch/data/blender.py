"""Blender-synthetic dataset loader (port of ``lomanerf_tpu.data.blender``).

Same on-disk format and semantics as the reference loader:
``<root>/transforms_<phase>.json`` lists frames with ``file_path`` (png,
extension added) and a 4x4 ``transform_matrix``; images are resized to
``img_size`` square, RGB, scaled to [0, 1]; the normalised focal length is
``0.5 / tan(0.5 * camera_angle_x)``.  Frames are read by :func:`load_rgb`:
through PIL where it is installed, else through the port's zlib PNG reader.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

import numpy as np
import torch

from lomanerf_tpu_torch.train.logging_utils import read_png


def _resize_png(img: np.ndarray, img_size: int) -> np.ndarray:
    """uint8 ``(H, W, 3 or 4)`` to ``(img_size, img_size, 3)`` f32 in [0,
    255], as PIL's default resize then ``convert("RGB")`` compute it: a
    bicubic filter widened when it shrinks (torch's antialiased bicubic
    follows PIL's), colour premultiplied by alpha while it is filtered,
    alpha then dropped."""
    x = torch.from_numpy(img).permute(2, 0, 1)[None].to(torch.float64)
    if img.shape[2] == 4:
        x = torch.cat([x[:, :3] * x[:, 3:] / 255.0, x[:, 3:]], dim=1)
    x = torch.nn.functional.interpolate(x, size=(img_size, img_size), mode="bicubic",
                                        align_corners=False, antialias=True)
    x = x.clamp(0.0, 255.0)
    if img.shape[2] == 4:
        alpha = x[:, 3:]
        x = torch.where(alpha > 0, x[:, :3] * 255.0 / alpha.clamp(min=1e-12), 0.0)
    return x[0, :3].permute(1, 2, 0).clamp(0.0, 255.0).round().numpy()


def load_rgb(path: str, img_size: int) -> np.ndarray:
    """An image file as ``(img_size, img_size, 3)`` f32 RGB in [0, 1]:
    resized then converted to RGB, by PIL where it is installed; without
    PIL, 8-bit RGB or RGBA PNGs through :func:`read_png` and the same
    resize in torch (an RGB image within a few 8-bit levels of PIL's;
    where a resized alpha is partial, PIL unpremultiplies in 8 bits and the
    two differ more)."""
    try:
        from PIL import Image
    except ImportError:
        img = read_png(path)
        if img.shape[:2] == (img_size, img_size):
            return img[..., :3].astype(np.float32) / 255.0
        return _resize_png(img, img_size).astype(np.float32) / 255.0
    with Image.open(path) as im:
        image = im.resize((img_size, img_size)).convert("RGB")
    return np.asarray(image, dtype=np.float32) / 255.0


class NeRFDataset:
    """Sequence of ``{image, pose, focal_length}`` samples (numpy)."""

    def __init__(self, root_dir: str, img_size: int = 16, phase: str = "train"):
        self.root_dir = root_dir
        self.img_size = img_size
        self.phase = phase
        self.data: List[Tuple[str, np.ndarray]] = []
        with open(os.path.join(root_dir, f"transforms_{phase}.json")) as f:
            transforms = json.load(f)
        self.camera_angle_x = float(transforms["camera_angle_x"])
        for frame in transforms["frames"]:
            img_path = os.path.join(root_dir, frame["file_path"] + ".png")
            self.data.append(
                (img_path, np.array(frame["transform_matrix"], dtype=np.float32)))

    @property
    def focal_length(self) -> float:
        """Normalised focal (principal point 0.5)."""
        return float(0.5 / np.tan(0.5 * self.camera_angle_x))

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, idx: int) -> Dict:
        img_path, pose = self.data[idx]
        return {
            "image": load_rgb(img_path, self.img_size),
            "pose": pose,
            "focal_length": self.focal_length,
        }
