"""The grid-overhead probe (port of the kernel of
``scripts/tpu_grid_overhead.py``): the sum of an ``(8, cols)`` f32 array
streamed in ``(8, block)`` tiles.

One hand-written CUDA entry point, ``csrc/grid_sum.cu`` — ``grid_sum``: one
launch of ``cols // block`` blocks, one per tile (the TPU kernel's grid
steps), each writing its tile's sum to a partial; the last block to finish
adds the partials in a fixed order; block 0 zeroes ``n_dummy`` dummy
``(3, 40, 40)`` outputs, as grid step 0 does on the TPU.  Like the JAX
script, only the first ``(cols // block) * block`` columns are summed.  On
CUDA tensors :func:`grid_sum` launches the kernel or raises; on CPU tensors
it runs the plain version (:func:`grid_sum_reference`).  The sweep that
prices a tile and a launch with it is
``lomanerf_tpu_torch.scripts.grid_overhead``.
"""

from __future__ import annotations

import functools
import math

import torch

# kernel launches of the C entry point; a run resets and reads them
launches = {"grid_sum": 0}
DUMMY_SHAPE = (3, 40, 40)  # the TPU script's dummy outputs
# per (device, stream) the kernel's scratch, kept between calls: the ticket
# counter (zero between launches), the partials and the dummies, grown as
# needed
_scratch: dict = {}


@functools.lru_cache(maxsize=None)
def _entry():
    """The C entry point, looked up once."""
    from lomanerf_tpu_torch.ops import build

    return build.load().grid_sum


def grid_sum_reference(x: torch.Tensor, block: int) -> torch.Tensor:
    """Plain version of :func:`grid_sum`: the per-tile sums, then their sum
    (a 0-d tensor)."""
    n_tiles = x.shape[1] // block
    tiles = x[:, : n_tiles * block].reshape(8, n_tiles, block)
    return tiles.sum(dim=(0, 2)).sum()


def grid_sum(x: torch.Tensor, block: int, n_dummy: int = 0) -> torch.Tensor:
    """Sum of the first ``(cols // block) * block`` columns of the ``(8,
    cols)`` array ``x`` (rows may be strided), as a fresh 0-d f32 tensor."""
    shape = x.shape
    if len(shape) != 2 or shape[0] != 8:
        raise ValueError(f"need an (8, cols) array, got {tuple(shape)}")
    if block <= 0 or n_dummy < 0:
        raise ValueError(f"block {block} and n_dummy {n_dummy}: need block > 0, "
                         "n_dummy >= 0")
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise NotImplementedError(f"no grid_sum for device {x.device}")
        return grid_sum_reference(x, block)
    ld, unit = x.stride()
    if x.dtype != torch.float32 or unit != 1 or shape[1] >= 2 ** 31:
        raise ValueError("the kernel takes f32 rows of unit stride, below 2^31 columns")
    n_tiles = shape[1] // block
    dev = x.get_device()
    stream = torch._C._cuda_getCurrentRawStream(dev)
    words = 1 + n_tiles + n_dummy * math.prod(DUMMY_SHAPE)
    scratch = _scratch.get((dev, stream))
    if scratch is None or scratch.numel() < words:
        scratch = torch.zeros(words, dtype=torch.float32, device=x.device)
        _scratch[(dev, stream)] = scratch
    out = x.new_empty(())
    ptr = scratch.data_ptr()
    err = _entry()(x.data_ptr(), ld, shape[1], block, ptr, out.data_ptr(),
                    ptr + 4 * (1 + n_tiles) if n_dummy else None, n_dummy, stream)
    if err != 0:
        raise RuntimeError(f"grid_sum launch failed: cudaError {err}")
    launches["grid_sum"] += 1
    return out
