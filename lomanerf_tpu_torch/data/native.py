"""The C++ ray-batch prefetcher and its numpy twin (port of
``lomanerf_tpu.data.native``).

``RayBatchPipeline`` produces NeRF training batches ahead of the step: a
worker pool in ``csrc/ray_pipeline.cpp`` (bound with ctypes, built by
``g++`` at first use) or, with ``force_numpy=True``, a numpy
reimplementation of the same counter-based draw.  Batch ``b`` of seed ``s``
is the same on both (the C++ rounds in float32, numpy partly in float64:
they agree to rounding) and, unlike the JAX package's C++, the native
batches come out in batch-id order for any number of threads.

Batches are ``(origins, dirs, t_offsets, targets)`` float32 tensors on the
pipeline's device; depths are in OFFSET form: the static comb ``t_base``
``(S,)`` and ``dists`` ``(S,)`` (1e8 last) plus a per-ray offset, 0 unless
stratified.  Fold the offset into the origins (``o + d * dt[:, None]``) and
the depths stay ``(S,)``, the shared-depth kernels' contract.  On CUDA each
batch crosses in one copy from page-locked host memory, without
synchronising: a ring of ``PINNED_BUFFERS`` host buffers, each refilled only
after the copy that last read it has finished (its CUDA event).

The build goes to ``build/host/<hash of the source, compiler and
flags>/`` at the repository root.  A failed build or load raises with the
compiler's output; nothing falls back to numpy.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Tuple

import numpy as np
import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "ray_pipeline.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "host"
CXX = "g++"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-shared")
LIB_NAME = "liblomanerf_host.so"
PINNED_BUFFERS = 2  # host buffers in the ring behind the copies to the card


def build(cxx: str | None = None) -> Path:
    """Compile ``csrc/ray_pipeline.cpp`` unless a library built from the same
    source, compiler and flags exists; returns its path.  Raises
    ``RuntimeError`` with the compiler's output when the build fails."""
    cxx = cxx or CXX
    h = hashlib.sha256(" ".join((cxx, *CXX_FLAGS)).encode())
    h.update(SOURCE.read_bytes())
    lib = BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        done = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"the ray pipeline's build could not run {' '.join(cmd)}: {e}") \
            from e
    if done.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"the ray pipeline's build failed ({done.returncode}): "
                           f"{' '.join(cmd)}\n{done.stdout}{done.stderr}")
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def _load(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.ln_create.restype = ctypes.c_void_p
    lib.ln_create.argtypes = [
        f32p, f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
        ctypes.c_int, ctypes.c_uint64, ctypes.c_int, ctypes.c_int,
    ]
    lib.ln_next_batch.restype = ctypes.c_int
    lib.ln_next_batch.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 4
    lib.ln_depths.restype = None
    lib.ln_depths.argtypes = [ctypes.c_void_p, f32p, f32p]
    lib.ln_destroy.restype = None
    lib.ln_destroy.argtypes = [ctypes.c_void_p]
    return lib


def load_native() -> ctypes.CDLL:
    """Load (building if needed) the native library; raises if either fails."""
    return _load(str(build()))


def _splitmix64(x: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):  # uint64 wraparound is the algorithm
        x = (x + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return x ^ (x >> np.uint64(31))


def _u01(x: np.ndarray) -> np.ndarray:
    return (x >> np.uint64(11)).astype(np.float64) / 9007199254740992.0


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.ascontiguousarray(x, np.float32)


class RayBatchPipeline:
    """Prefetching ray-batch producer: the native C++ pool, or its numpy
    twin with ``force_numpy=True``.  Arguments as in the JAX package, plus
    ``device`` (default ``"cuda"``) for the batches and the depth comb."""

    def __init__(
        self,
        poses,  # (V, 4, 4)
        images,  # (V, H, W, 3), H == W
        focal: float,
        n_rays: int,
        num_samples: int,
        near: float,
        far: float,
        stratified: bool = False,
        seed: int = 0,
        queue_depth: int = 4,
        n_threads: int = 4,
        force_numpy: bool = False,
        device: torch.device | str = "cuda",
    ):
        self._ctx = None
        self.poses = _host(poses)
        self.images = _host(images)
        v, h, w, _ = self.images.shape
        if h != w:
            raise ValueError(f"RayBatchPipeline draws pixels over width x width: images "
                             f"must be square, got {h}x{w}")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("RayBatchPipeline: device cuda but no CUDA device; pass "
                               "device='cpu'")
        self.focal = float(focal)
        self.n_rays = n_rays
        self.num_samples = num_samples
        self.near = near
        self.far = far
        self.stratified = stratified
        self.seed = seed
        self._counter = 0
        self._lib = None if force_numpy else load_native()
        s = num_samples
        t_base, dists = np.empty(s, np.float32), np.empty(s, np.float32)
        if self._lib is not None:
            f32p = ctypes.POINTER(ctypes.c_float)
            self._ctx = self._lib.ln_create(
                self.poses.ctypes.data_as(f32p), self.images.ctypes.data_as(f32p),
                v, h, w, self.focal, n_rays, num_samples, near, far, int(stratified),
                seed, queue_depth, n_threads)
            self._lib.ln_depths(self._ctx, t_base.ctypes.data_as(f32p),
                                dists.ctypes.data_as(f32p))
        else:
            step = (far - near) / (s - 1)
            t_base = (near + step * np.arange(s, dtype=np.float32)).astype(np.float32)
            dists = np.full(s, step, np.float32)
            dists[-1] = 1e8
        self.t_base = torch.from_numpy(t_base).to(self.device)
        self.dists = torch.from_numpy(dists).to(self.device)
        # one (10 n,) f32 host buffer a batch: origins, dirs, offsets, targets
        self._ring = []
        if self.device.type == "cuda":
            self._ring = [(torch.empty(10 * n_rays, dtype=torch.float32, pin_memory=True),
                           torch.cuda.Event()) for _ in range(PINNED_BUFFERS)]
        self._slot = 0

    @property
    def is_native(self) -> bool:
        return self._ctx is not None

    def next_batch(self) -> Tuple[torch.Tensor, ...]:
        """``(origins (N, 3), dirs (N, 3), t_offsets (N,), targets (N, 3))``
        float32 on the pipeline's device; depths are ``t_base``/``dists``."""
        n = self.n_rays
        if self._ring:
            buf, done = self._ring[self._slot]
            self._slot = (self._slot + 1) % len(self._ring)
            done.synchronize()  # the copy that last read this buffer has finished
            self._fill(buf.numpy())
            flat = torch.empty(10 * n, dtype=torch.float32, device=self.device)
            flat.copy_(buf, non_blocking=True)
            done.record()
        else:
            flat = torch.from_numpy(self._fill(np.empty(10 * n, np.float32)))
        return (flat[:3 * n].view(n, 3), flat[3 * n:6 * n].view(n, 3),
                flat[6 * n:7 * n], flat[7 * n:].view(n, 3))

    def _fill(self, out: np.ndarray) -> np.ndarray:
        """Write the next batch into ``out`` (10 n floats)."""
        n = self.n_rays
        parts = (out[:3 * n], out[3 * n:6 * n], out[6 * n:7 * n], out[7 * n:])
        if self._lib is not None:
            if self._ctx is None:
                raise RuntimeError("RayBatchPipeline: next_batch after close()")
            self._lib.ln_next_batch(self._ctx, *(p.ctypes.data for p in parts))
        else:
            for p, x in zip(parts, self._numpy_batch()):
                p[:] = x.reshape(-1)
        return out

    def _numpy_batch(self):
        """Numpy reimplementation of the C++ producer."""
        n, s = self.n_rays, self.num_samples
        v_cnt, h, w, _ = self.images.shape
        batch_id = self._counter
        self._counter += 1
        base = _splitmix64(
            np.uint64(self.seed) ^ (np.uint64(batch_id) * np.uint64(0x9E3779B9))
        )
        view = int(_splitmix64(base ^ np.uint64(0xABCDEF)) % np.uint64(v_cnt))
        P = self.poses[view]
        R, T = P[:3, :3], P[:3, 3]
        hsh = _splitmix64(
            base + np.arange(n, dtype=np.uint64) * np.uint64(0x100000001B3)
        )
        px = (hsh % np.uint64(w * w)).astype(np.int64)
        ix, iy = px % w, px // w
        u = ix / (w - 1) if w > 1 else np.zeros(n)
        vv = iy / (w - 1) if w > 1 else np.zeros(n)
        dc = np.stack(
            [(u - 0.5) / self.focal, -(vv - 0.5) / self.focal,
             -np.ones(n)], axis=-1
        ).astype(np.float32)
        dirs = dc @ R.T
        origins = np.tile(T, (n, 1)).astype(np.float32)
        if self.stratified:
            bin_w = (self.far - self.near) / s
            toff = (_u01(_splitmix64(hsh ^ np.uint64(0x5EEDB175)))
                    * bin_w).astype(np.float32)
        else:
            toff = np.zeros(n, np.float32)
        targets = self.images[view, iy, ix].astype(np.float32)
        return origins, dirs.astype(np.float32), toff, targets

    def close(self):
        if self._ctx is not None:
            self._lib.ln_destroy(self._ctx)
            self._ctx = None
        for _, done in self._ring:
            done.synchronize()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
