"""Metrics and image logging (port of ``lomanerf_tpu.train.logging_utils``).

A JSONL metrics stream (always on), wandb only when asked for, and a PNG
writer and reader with no dependency beyond zlib, for machines without
PIL, imageio or matplotlib.  ``save_triptych`` keeps the JAX package's
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
    (imported only then).

    Under a process group only rank 0 writes: every other rank gets a
    logger that does nothing, so the drivers log unconditionally without
    ranks racing on one file."""

    def __init__(self, log_dir: str, project: Optional[str] = None,
                 use_wandb: bool = False):
        from lomanerf_tpu_torch.parallel.mesh import is_primary

        self.active = is_primary()
        self.log_dir = log_dir
        self._f = None
        self._wandb = None
        if not self.active:
            return
        os.makedirs(log_dir, exist_ok=True)
        self._f = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        if use_wandb:
            import wandb

            self._wandb = wandb
            wandb.init(project=project or "lomanerf-tpu")

    def log(self, step: int, **metrics) -> None:
        if not self.active:
            return
        rec = {"step": step, "time": time.time()}
        rec.update({k: float(v) for k, v in metrics.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def close(self) -> None:
        if not self.active:
            return
        self._f.close()
        if self._wandb is not None:
            self._wandb.finish()


def write_png(path: str, img: np.ndarray) -> None:
    """Write a uint8 ``(H, W, 3)`` or ``(H, W, 4)`` image as an 8-bit RGB or
    RGBA PNG (zlib + struct; every row with filter 0)."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError(f"need uint8 (H, W, 3 or 4), got {img.dtype} {img.shape}")
    h, w, ch = img.shape

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * ch)], axis=1)
    png = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2 if ch == 3 else 6, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
           + chunk(b"IEND", b""))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(png)


def _unfilter_sequential(ft: int, line: bytes, prior: bytes, bpp: int) -> bytearray:
    """PNG filters 3 (Average) and 4 (Paeth) undone byte by byte: each
    byte's predictor reads the byte already restored to its left."""
    cur = bytearray(line)
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prior[i]
        if ft == 3:
            pred = (a + b) >> 1
        else:
            c = prior[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF
    return cur


def read_png(path: str) -> np.ndarray:
    """An 8-bit RGB or RGBA non-interlaced PNG as a uint8 ``(H, W, 3)`` or
    ``(H, W, 4)`` array (zlib + struct, the five row filters undone): the
    counterpart of :func:`write_png`, for machines without PIL or imageio.
    Raises ``ValueError`` for any other PNG."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, comp, filt, interlace = header
    if depth != 8 or ctype not in (2, 6) or (comp, filt, interlace) != (0, 0, 0):
        raise ValueError(f"{path}: bit depth {depth}, colour type {ctype}, interlace "
                         f"{interlace}: only 8-bit RGB or RGBA non-interlaced PNGs are read")
    bpp = 3 if ctype == 2 else 4
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (w * bpp + 1):
        raise ValueError(f"{path}: {raw.size} bytes of image data for {w}x{h}x{bpp}")
    rows = raw.reshape(h, w * bpp + 1)
    out = np.empty((h, w * bpp), np.uint8)
    prior = np.zeros(w * bpp, np.uint8)
    for y in range(h):
        ft, line = int(rows[y, 0]), rows[y, 1:]
        if ft == 0:
            cur = line
        elif ft == 1:  # Sub: a running sum along the row, per channel, mod 256
            cur = np.cumsum(line.reshape(w, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif ft == 2:  # Up: uint8 adds wrap mod 256
            cur = line + prior
        elif ft in (3, 4):
            cur = np.frombuffer(bytes(_unfilter_sequential(ft, line.tobytes(),
                                                           prior.tobytes(), bpp)), np.uint8)
        else:
            raise ValueError(f"{path}: row {y} has filter type {ft}")
        out[y] = cur
        prior = out[y]
    return out.reshape(h, w, bpp)


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
