"""Metrics and image logging (port of ``lomanerf_tpu.train.logging_utils``).

A JSONL metrics stream (always on), wandb only when asked for, and a PNG
writer with no dependency beyond zlib, since the card's machine has no PIL,
imageio or matplotlib.  ``save_triptych`` keeps the JAX package's
matplotlib figure, imported inside; the train driver does not need it.
"""

from __future__ import annotations

import json
import os
import struct
import time
import zlib
from typing import Optional, Sequence

import numpy as np


class MetricsLogger:
    """Appends ``{"step", "time", <metrics>}`` lines to
    ``<log_dir>/metrics.jsonl``; with ``use_wandb``, also logs to wandb
    (imported only then)."""

    def __init__(self, log_dir: str, project: Optional[str] = None,
                 use_wandb: bool = False):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._f = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._wandb = None
        if use_wandb:
            import wandb

            self._wandb = wandb
            wandb.init(project=project or "lomanerf-tpu")

    def log(self, step: int, **metrics) -> None:
        rec = {"step": step, "time": time.time()}
        rec.update({k: float(v) for k, v in metrics.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def close(self) -> None:
        self._f.close()
        if self._wandb is not None:
            self._wandb.finish()


def write_png(path: str, img: np.ndarray) -> None:
    """Write a uint8 ``(H, W, 3)`` image as an 8-bit RGB PNG (zlib + struct;
    every row with filter 0)."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"need uint8 (H, W, 3), got {img.dtype} {img.shape}")
    h, w, _ = img.shape

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], axis=1)
    png = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
           + chunk(b"IEND", b""))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(png)


def save_triptych(path: str, target: np.ndarray, prediction: np.ndarray,
                  curve: Sequence[float], curve_label: str = "loss") -> None:
    """Target | prediction | metric-curve panel, like the reference's logs
    (needs matplotlib)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(1, 3, figsize=(15, 5))
    ax[0].imshow(np.clip(np.asarray(target), 0, 1))
    ax[0].set_title("Target")
    ax[1].imshow(np.clip(np.asarray(prediction), 0, 1))
    ax[1].set_title("Prediction")
    ax[2].plot(list(curve))
    ax[2].set_title(curve_label)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path)
    plt.close(fig)
