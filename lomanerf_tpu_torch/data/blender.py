"""Blender-synthetic dataset loader (port of ``lomanerf_tpu.data.blender``).

Same on-disk format and semantics as the reference loader:
``<root>/transforms_<phase>.json`` lists frames with ``file_path`` (png,
extension added) and a 4x4 ``transform_matrix``; images are resized to
``img_size`` square, RGB, scaled to [0, 1]; the normalised focal length is
``0.5 / tan(0.5 * camera_angle_x)``.  PIL is imported only where a frame is
read.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

import numpy as np


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
        from PIL import Image

        img_path, pose = self.data[idx]
        with Image.open(img_path) as im:
            image = im.resize((self.img_size, self.img_size)).convert("RGB")
        return {
            "image": np.asarray(image, dtype=np.float32) / 255.0,
            "pose": pose,
            "focal_length": self.focal_length,
        }
