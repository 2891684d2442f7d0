"""The wide chain's bf16 layer GEMM alone: the forward layer
``bf16(ReLU(h W + b))`` and ``d_h = rnd(d_z) W^T`` masked by ``h > 0``.

The wide gradient kernels (#7, #9, #11, #12) run these products for every
hidden layer, and the bf16 render past the fused MLP's pw 256 (#8, #10) its
forward layers, on ``csrc/nerf_wide_layer_gemm.cuh`` (wgmma fed by TMA, each
32-deep k-step promoted into f32 sums).  The ``d_h`` form also sums its f32
output over each 128-row tile (:data:`TILE_ROWS`): the column partials db is
summed from, so that the gradient kernels write no f32 ``d_h`` at all.  Its
entry point alone, ``wide_layer_gemm`` (``csrc/nerf_wide_train.cu``), lets
the card test and time it: :func:`wide_layer_gemm` (the forward form) and
:func:`wide_dh_gemm` (the ``d_h`` form) launch it.  On CUDA tensors each
launches the kernel or raises; on CPU tensors it runs the plain version
(:func:`layer_reference`, :func:`dh_reference`).
"""

from __future__ import annotations

import torch

# kernel launches of the C entry points, by wrapper; a run resets and reads them
launches = {"wide_layer_gemm": 0, "wide_dh_gemm": 0}
TILE_ROWS = 128  # rows of d_h a column partial sums (the kernel's row tile, kLgBM)


def layer_reference(h: torch.Tensor, W: torch.Tensor, b: torch.Tensor, K: int) -> torch.Tensor:
    """Plain version of :func:`wide_layer_gemm`: ``bf16(ReLU(h[:, :K] W[:K]
    + b))`` with f32 sums (the products of two bf16 values are exact in f32;
    the sums are torch's)."""
    return torch.relu(h[:, :K].float() @ W[:K].float() + b).to(torch.bfloat16)


def dh_reference(dz: torch.Tensor, W: torch.Tensor, mask: torch.Tensor, K: int):
    """Plain version of :func:`wide_dh_gemm`: ``(d_h, bf16(d_h), part)``,
    ``d_h = dz[:, :K] W[:, :K]^T`` in f32 where ``mask > 0``, else 0, and
    ``part[i]`` the column sums of its rows ``128 i .. 128 i + 127`` (the
    rows past the last count as 0), summed in f64 and rounded to f32."""
    d = dz[:, :K].float() @ W[:, :K].float().T
    d = torch.where(mask.float() > 0, d, torch.zeros_like(d))
    tiles = -(-d.shape[0] // TILE_ROWS)
    padded = torch.zeros((tiles * TILE_ROWS, d.shape[1]), dtype=torch.float64, device=d.device)
    padded[: d.shape[0]] = d
    part = padded.view(tiles, TILE_ROWS, -1).sum(1).float()
    return d, d.to(torch.bfloat16), part


def _check(a: torch.Tensor, W: torch.Tensor, other: torch.Tensor, K: int, dh: bool) -> None:
    if a.ndim != 2 or a.shape[0] == 0:
        raise ValueError(f"need a (rows > 0, pw) operand, got {tuple(a.shape)}")
    rows, pw = a.shape
    if pw % 8 or K % 8 or not 0 < K <= pw:
        raise ValueError(f"pw {pw} and K {K}: need multiples of 8, 0 < K <= pw")
    if W.shape != (pw, pw):
        raise ValueError(f"need a ({pw}, {pw}) W, got {tuple(W.shape)}")
    want = (rows, pw) if dh else (pw,)
    if other.shape != want:
        raise ValueError(f"need a {want} {'mask' if dh else 'bias'}, got {tuple(other.shape)}")
    if a.dtype != torch.bfloat16 or W.dtype != torch.bfloat16 or other.dtype != (
            torch.bfloat16 if dh else torch.float32):
        raise ValueError(f"need bf16 operands and a {'bf16 mask' if dh else 'f32 bias'}, got "
                         f"{a.dtype}, {W.dtype} and {other.dtype}")
    if any(x.device != a.device or not x.is_contiguous() for x in (a, W, other)):
        raise ValueError("every input must be contiguous, on one device")
    if a.device.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"no layer GEMM for device {a.device}")


def _launch(wrapper: str, a, W, b, mask, K: int):
    from lomanerf_tpu_torch.ops import build

    rows, pw = a.shape
    dh = mask is not None
    C = torch.empty((rows, pw), dtype=torch.float32 if dh else torch.bfloat16, device=a.device)
    Cb = torch.empty((rows, pw), dtype=torch.bfloat16, device=a.device) if dh else None
    P = torch.empty((-(-rows // TILE_ROWS), pw), dtype=torch.float32, device=a.device) \
        if dh else None
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = build.load().wide_layer_gemm(
        a.data_ptr(), W.data_ptr(), None if dh else b.data_ptr(),
        mask.data_ptr() if dh else None, C.data_ptr(), Cb.data_ptr() if dh else None,
        P.data_ptr() if dh else None, rows, pw, K, int(dh), stream)
    if err != 0:
        raise RuntimeError(f"wide_layer_gemm launch failed: cudaError {err}")
    launches[wrapper] += 1
    return (C, Cb, P) if dh else C


def wide_layer_gemm(h: torch.Tensor, W: torch.Tensor, b: torch.Tensor, K: int) -> torch.Tensor:
    """The forward layer: ``(rows, pw)`` bf16 ``bf16(ReLU(h[:, :K] W[:K] +
    b))`` of a layer input ``h`` (rows, pw) bf16, its ``W`` (pw, pw) bf16
    ``[in][out]`` and ``b`` (pw,) f32: the wgmma/TMA kernel on CUDA
    tensors, the plain version on CPU ones."""
    _check(h, W, b, K, False)
    if h.device.type == "cpu":
        return layer_reference(h, W, b, K)
    return _launch("wide_layer_gemm", h, W, b, None, K)


def wide_dh_gemm(dz: torch.Tensor, W: torch.Tensor, mask: torch.Tensor, K: int):
    """``d_h`` of a layer: ``(d_h (rows, pw) f32, its bf16 copy, its column
    partials (ceil(rows / 128), pw) f32)``, ``d_h = dz[:, :K] W[:, :K]^T``
    where ``mask > 0``, else 0, from the bf16 d_z ``dz`` (rows, pw), the
    layer's ``W`` (pw, pw) bf16 and its input ``mask`` (rows, pw) bf16; a
    partial is the column sum of one 128-row tile of ``d_h``: the wgmma/TMA
    kernel on CUDA tensors, the plain version on CPU ones."""
    _check(dz, W, mask, K, True)
    if dz.device.type == "cpu":
        return dh_reference(dz, W, mask, K)
    return _launch("wide_dh_gemm", dz, W, None, mask, K)
