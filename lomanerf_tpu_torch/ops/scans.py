"""Segmented scans over a column of ``R * S`` values (port of the scans of
``lomanerf_tpu.ops.pallas_utils`` and of the TPU kernel that runs them,
``tests/test_pallas_kernels.py:46``).

One hand-written CUDA entry point, ``csrc/seg_scans.cu`` — ``seg_scans``.
Device memory bounds it (one read and one write a value), so a warp owns a
run of 32 whole segments: it stages the run into shared memory with
coalesced 4-B copies (segment ``r`` at ``r * P``, ``P = S | 1``, so that the
lanes' walks meet no bank conflict), each lane walks its segment there in
order with the step functions of ``csrc/seg_scan.cuh`` (the ones the NeRF
kernels composite with: the transmittance's running product, the adjoint's
suffix sum), and the warp writes the run back coalesced.  An ``S`` whose run
does not fit a block's shared memory takes the direct walk (one thread a
segment, from device memory).  :func:`scan_plan` restates that choice.
Either way every output bit is the in-order f32 walk's: numpy's
``np.multiply.accumulate`` along a segment, ``np.add.accumulate`` along the
reversed one.

The functions keep the JAX names and argument order and take an
``(R * S, 1)`` or ``(R * S,)`` column, a ray's ``S`` samples contiguous; the
output has the input's shape.  On CUDA tensors each launches the kernel or
raises; on CPU tensors it runs its plain version (``*_reference``, on the
``(R, S)`` view).  The JAX versions also take a ``stride`` for the s-major
rows of the TPU's tiles; no layout of the port needs it.
"""

from __future__ import annotations

import dataclasses

import torch

# kernel launches of the C entry point; a run resets and reads them
launches = {"seg_scans": 0}

# seg_scans.cu's kWarps (32-segment runs a block, at most), kSmemMax (the
# dynamic shared memory a block may take) and kWalkThreads
SCAN_WARPS, SCAN_SMEM_MAX, WALK_THREADS = 4, 232448, 256


@dataclasses.dataclass(frozen=True)
class ScanPlan:
    """One ``seg_scans`` launch: ``route`` "staged" (a warp stages a run of
    32 segments at tile stride ``stride``) or "direct" (a thread walks a
    segment from device memory); ``threads`` a block, ``blocks``, and the
    block's dynamic shared memory in bytes."""
    route: str
    stride: int
    threads: int
    blocks: int
    smem_bytes: int


def scan_plan(n_rows: int, num_samples: int) -> ScanPlan:
    """The launch ``seg_scans`` makes for ``n_rows`` values in segments of
    ``num_samples`` (the host mirror of ``seg_scans.cu:launch``): the staged
    kernel with as many runs a block, up to ``SCAN_WARPS``, as fit
    ``SCAN_SMEM_MAX``; the direct walk where not even one does."""
    S = num_samples
    n_seg = n_rows // S
    stride = S | 1
    warps = min(SCAN_WARPS, SCAN_SMEM_MAX // (32 * stride * 4))
    if warps == 0:
        return ScanPlan("direct", S, WALK_THREADS, -(-n_seg // WALK_THREADS), 0)
    return ScanPlan("staged", stride, 32 * warps, -(-n_seg // (32 * warps)),
                    warps * 32 * stride * 4)


def seg_inclusive_cumprod_reference(x: torch.Tensor, num_samples: int) -> torch.Tensor:
    """Plain version of :func:`seg_inclusive_cumprod`: ``torch.cumprod``."""
    return torch.cumprod(x.reshape(-1, num_samples), dim=1).reshape(x.shape)


def seg_suffix_sum_reference(x: torch.Tensor, num_samples: int) -> torch.Tensor:
    """Plain version of :func:`seg_suffix_sum`: flip, cumsum, flip."""
    v = torch.flip(x.reshape(-1, num_samples), [1])
    return torch.flip(torch.cumsum(v, dim=1), [1]).reshape(x.shape)


def seg_shift_down_reference(x: torch.Tensor, num_samples: int,
                             fill: float) -> torch.Tensor:
    """Plain version of :func:`seg_shift_down`: ``fill``, then each
    segment's first ``S - 1`` values."""
    v = x.reshape(-1, num_samples)
    return torch.cat([torch.full_like(v[:, :1], fill), v[:, :-1]], dim=1).reshape(x.shape)


def _scan(x: torch.Tensor, num_samples: int, op: int, reference, *fill) -> torch.Tensor:
    """``seg_scans`` with op code ``op`` (0 cumprod, 1 suffix sum, 2 shift
    down with ``fill``) on a CUDA column; ``reference`` on a CPU one."""
    if x.ndim not in (1, 2) or (x.ndim == 2 and x.shape[1] != 1):
        raise ValueError(f"need an (R * S, 1) or (R * S,) column, got {tuple(x.shape)}")
    if num_samples <= 0 or x.shape[0] % num_samples:
        raise ValueError(f"{x.shape[0]} rows are not segments of {num_samples}")
    if x.device.type == "cpu":
        return reference(x, num_samples, *fill)
    if x.device.type != "cuda":
        raise NotImplementedError(f"no segmented scan for device {x.device}")
    if x.dtype != torch.float32 or x.shape[0] >= 2 ** 31:
        raise ValueError(f"the kernel takes f32 columns below 2^31 rows, got {x.dtype} "
                         f"x {x.shape[0]}")
    from lomanerf_tpu_torch.ops import build

    x = x.contiguous()
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = build.load().seg_scans(x.data_ptr(), out.data_ptr(), x.shape[0], num_samples,
                                 op, float(fill[0]) if fill else 0.0, stream)
    if err != 0:
        raise RuntimeError(f"seg_scans launch failed: cudaError {err}")
    launches["seg_scans"] += 1
    return out


def seg_inclusive_cumprod(x: torch.Tensor, num_samples: int) -> torch.Tensor:
    """Per-segment inclusive cumulative product: out[s] = x[0] * ... * x[s]."""
    return _scan(x, num_samples, 0, seg_inclusive_cumprod_reference)


def seg_suffix_sum(x: torch.Tensor, num_samples: int) -> torch.Tensor:
    """Per-segment suffix sum: out[s] = sum_{m >= s} x[m]."""
    return _scan(x, num_samples, 1, seg_suffix_sum_reference)


def seg_shift_down(x: torch.Tensor, num_samples: int, fill: float) -> torch.Tensor:
    """out[s] = x[s - 1] within each segment, ``fill`` at s == 0 (the
    exclusive shift of standard-mode transmittance)."""
    return _scan(x, num_samples, 2, seg_shift_down_reference, fill)
