"""The wide chain's bf16 layer GEMM alone: the forward layer
``bf16(ReLU(h W + b))`` and ``d_h = rnd(d_z) W^T`` masked by ``h > 0``.

The wide gradient kernels (#7, #9, #11, #12) run these products for every
hidden layer, and the bf16 render past the fused MLP's pw 256 (#8, #10) its
forward layers, on ``csrc/nerf_wide_layer_gemm.cuh`` (wgmma fed by TMA, each
32-deep k-step promoted into f32 sums).  Its entry point alone,
``wide_layer_gemm`` (``csrc/nerf_wide_train.cu``), lets the card test and
time it: :func:`wide_layer_gemm` (the forward form) and
:func:`wide_dh_gemm` (the ``d_h`` form) launch it; :func:`wide_layer_gemm_mma`
and :func:`wide_dh_gemm_mma` run the ``mma.sync`` kernel it replaced
(``gemm_mma_kernel``) on the same inputs, so that the two can be compared
bit for bit.  On CUDA tensors each launches its kernel or raises; on CPU
tensors it runs the plain version (:func:`layer_reference`,
:func:`dh_reference`).
"""

from __future__ import annotations

import torch

# kernel launches of the C entry points, by wrapper; a run resets and reads them
launches = {"wide_layer_gemm": 0, "wide_layer_gemm_mma": 0, "wide_dh_gemm": 0,
            "wide_dh_gemm_mma": 0}


def layer_reference(h: torch.Tensor, W: torch.Tensor, b: torch.Tensor, K: int) -> torch.Tensor:
    """Plain version of :func:`wide_layer_gemm`: ``bf16(ReLU(h[:, :K] W[:K]
    + b))`` with f32 sums (the products of two bf16 values are exact in f32;
    the sums are torch's)."""
    return torch.relu(h[:, :K].float() @ W[:K].float() + b).to(torch.bfloat16)


def dh_reference(dz: torch.Tensor, W: torch.Tensor, mask: torch.Tensor, K: int):
    """Plain version of :func:`wide_dh_gemm`: ``(d_h, bf16(d_h))``, ``d_h =
    dz[:, :K] W[:, :K]^T`` in f32 where ``mask > 0``, else 0."""
    d = dz[:, :K].float() @ W[:, :K].float().T
    d = torch.where(mask.float() > 0, d, torch.zeros_like(d))
    return d, d.to(torch.bfloat16)


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


def _launch(entry: str, wrapper: str, a, W, b, mask, K: int):
    from lomanerf_tpu_torch.ops import build

    rows, pw = a.shape
    dh = mask is not None
    C = torch.empty((rows, pw), dtype=torch.float32 if dh else torch.bfloat16, device=a.device)
    Cb = torch.empty((rows, pw), dtype=torch.bfloat16, device=a.device) if dh else None
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = getattr(build.load(), entry)(
        a.data_ptr(), W.data_ptr(), None if dh else b.data_ptr(),
        mask.data_ptr() if dh else None, C.data_ptr(), Cb.data_ptr() if dh else None,
        rows, pw, K, int(dh), stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {err}")
    launches[wrapper] += 1
    return (C, Cb) if dh else C


def wide_layer_gemm(h: torch.Tensor, W: torch.Tensor, b: torch.Tensor, K: int) -> torch.Tensor:
    """The forward layer: ``(rows, pw)`` bf16 ``bf16(ReLU(h[:, :K] W[:K] +
    b))`` of a layer input ``h`` (rows, pw) bf16, its ``W`` (pw, pw) bf16
    ``[in][out]`` and ``b`` (pw,) f32: the wgmma/TMA kernel on CUDA
    tensors, the plain version on CPU ones."""
    _check(h, W, b, K, False)
    if h.device.type == "cpu":
        return layer_reference(h, W, b, K)
    return _launch("wide_layer_gemm", "wide_layer_gemm", h, W, b, None, K)


def wide_layer_gemm_mma(h, W, b, K: int) -> torch.Tensor:
    """:func:`wide_layer_gemm` on the ``mma.sync`` kernel it replaced."""
    _check(h, W, b, K, False)
    if h.device.type == "cpu":
        return layer_reference(h, W, b, K)
    return _launch("wide_layer_gemm_mma", "wide_layer_gemm_mma", h, W, b, None, K)


def wide_dh_gemm(dz: torch.Tensor, W: torch.Tensor, mask: torch.Tensor, K: int):
    """``d_h`` of a layer: ``(d_h (rows, pw) f32, its bf16 copy)``, ``d_h =
    dz[:, :K] W[:, :K]^T`` where ``mask > 0``, else 0, from the bf16 d_z
    ``dz`` (rows, pw), the layer's ``W`` (pw, pw) bf16 and its input
    ``mask`` (rows, pw) bf16: the wgmma/TMA kernel on CUDA tensors, the
    plain version on CPU ones."""
    _check(dz, W, mask, K, True)
    if dz.device.type == "cpu":
        return dh_reference(dz, W, mask, K)
    return _launch("wide_layer_gemm", "wide_dh_gemm", dz, W, None, mask, K)


def wide_dh_gemm_mma(dz, W, mask, K: int):
    """:func:`wide_dh_gemm` on the ``mma.sync`` kernel it replaced."""
    _check(dz, W, mask, K, True)
    if dz.device.type == "cpu":
        return dh_reference(dz, W, mask, K)
    return _launch("wide_layer_gemm_mma", "wide_dh_gemm_mma", dz, W, None, mask, K)
