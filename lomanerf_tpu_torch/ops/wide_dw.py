"""The wide gradient sequence's dW stage alone, for the bf16 compute dtype:
the split-K partials of ``dW = H^T rnd(d_z)`` over 8192-row chunks, which
the sequence then adds in chunk order.

The wide gradient kernels (#7, #9, #11, #12) run this stage for every
hidden layer on ``csrc/nerf_wide_dw.cuh`` (wgmma fed by TMA, a 32-row
promotion into f32 sums), reading the bf16 copy of d_z that its producers
write.  Its entry point alone, ``wide_dw_gemm`` (``csrc/nerf_wide_train.cu``),
lets the card test and time the stage.  On CUDA tensors :func:`wide_dw_gemm`
launches the kernel or raises; on CPU tensors it runs the plain version
(:func:`wide_dw_reference`).
"""

from __future__ import annotations

import torch

# kernel launches of the C entry points; a run resets and reads them
launches = {"wide_dw_gemm": 0}
ROW_CHUNK = 8192  # rows per partial (nerf_wide_common.cuh: kRowChunk)


def n_partials(rows: int) -> int:
    return -(-rows // ROW_CHUNK)


def wide_dw_reference(h: torch.Tensor, dz: torch.Tensor, in_cols: int) -> torch.Tensor:
    """Plain version of :func:`wide_dw_gemm`: ``(n_parts, in_cols, pw)``,
    partial z the f32 product of rows ``[8192 z, 8192 (z + 1))`` of
    ``h[:, :in_cols]`` (transposed) and ``dz``, both rounded to bf16 (the
    products of two bf16 values are exact in f32; the sums are torch's)."""
    rows, pw = h.shape
    n = n_partials(rows)
    hp = h.new_zeros((n * ROW_CHUNK, in_cols), dtype=torch.float32)
    dp = dz.new_zeros((n * ROW_CHUNK, pw), dtype=torch.float32)
    hp[:rows] = h[:, :in_cols].to(torch.bfloat16).float()
    dp[:rows] = dz.to(torch.bfloat16).float()
    return torch.bmm(hp.view(n, ROW_CHUNK, in_cols).transpose(1, 2),
                     dp.view(n, ROW_CHUNK, pw))


def operands(rows: int, ld: int, seed: int = 31, device: str = "cuda"):
    """ReLU'd normal activations and normal d_z x 1e-3, (rows, ld) bf16: the
    operands on which ``chip_smoke.py`` phase 9 and ``scripts/dw_variants``
    hold the kernel to :func:`f64_gap`."""
    g = torch.Generator(device).manual_seed(seed)
    h = torch.relu(torch.randn((rows, ld), generator=g, device=device)).to(torch.bfloat16)
    db = (torch.randn((rows, ld), generator=g, device=device) * 1e-3).to(torch.bfloat16)
    return h, db


def f64_gap(h: torch.Tensor, db: torch.Tensor, M: int, N: int, got: torch.Tensor) -> float:
    """The largest gap of the partials ``got`` of ``h[:, :M]`` and
    ``db[:, :N]`` from the f64 product of the same bf16 operands, over the
    f64 sum of |products| of its entry."""
    rows = db.shape[0]
    n = got.shape[0]
    hp = h.new_zeros((n * ROW_CHUNK, M), dtype=torch.float64)
    dp = h.new_zeros((n * ROW_CHUNK, N), dtype=torch.float64)
    hp[:rows], dp[:rows] = h[:, :M].double(), db[:, :N].double()
    h3, d3 = hp.view(n, -1, M).transpose(1, 2), dp.view(n, -1, N)
    del hp, dp
    gap = (got.double() - torch.bmm(h3, d3)).abs_()
    gap /= torch.bmm(h3.abs(), d3.abs()).clamp_min_(1e-30)
    return gap.max().item()


def _check(h: torch.Tensor, dz: torch.Tensor, in_cols: int) -> None:
    if h.ndim != 2 or dz.shape != h.shape or h.shape[0] == 0:
        raise ValueError(f"need h and dz of one (rows, pw) shape, got {tuple(h.shape)} and "
                         f"{tuple(dz.shape)}")
    pw = h.shape[1]
    if pw % 8 or in_cols % 8 or not 0 < in_cols <= pw:
        raise ValueError(f"pw {pw} and in_cols {in_cols}: need multiples of 8, "
                         "0 < in_cols <= pw")
    if h.dtype != torch.bfloat16 or dz.dtype != torch.bfloat16:
        raise ValueError(f"need bf16 h and dz, got {h.dtype} and {dz.dtype}")
    if h.device != dz.device or not (h.is_contiguous() and dz.is_contiguous()):
        raise ValueError("h and dz must be contiguous, on one device")
    if h.device.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"no dW stage for device {h.device}")


def wide_dw_gemm(h: torch.Tensor, dz: torch.Tensor, in_cols: int) -> torch.Tensor:
    """The dW partials ``(n_parts, in_cols, pw)`` f32 of a layer input ``h``
    and the bf16 copy of its output's d_z ``dz``, both ``(rows, pw)`` bf16:
    the wgmma/TMA kernel on CUDA tensors, the plain version on CPU ones."""
    _check(h, dz, in_cols)
    if h.device.type == "cpu":
        return wide_dw_reference(h, dz, in_cols)
    from lomanerf_tpu_torch.ops import build

    rows, pw = h.shape
    part = torch.empty((n_partials(rows), in_cols, pw), dtype=torch.float32,
                       device=h.device)
    stream = torch.cuda.current_stream(h.device).cuda_stream
    err = build.load().wide_dw_gemm(h.data_ptr(), dz.data_ptr(), pw, in_cols, pw, rows,
                                    part.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"wide_dw_gemm launch failed: cudaError {err}")
    launches["wide_dw_gemm"] += 1
    return part
