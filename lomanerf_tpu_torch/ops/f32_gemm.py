"""The wide chain's exact f32 GEMM alone: every product of the wide NeRF
kernels at f32 compute (#7-#12) and of the wide field route's "highest"
tier (``field_wide.cu``), on ``csrc/nerf_wide_f32_gemm.cuh`` (FMAs on k-tiles
staged by ``cp.async`` through a three-stage ring).

Its entry point alone, ``wide_f32_gemm`` (``csrc/wide_f32_gemm.cu``), lets
the card test and time it in the forms the two routes run:

* :func:`f32_layer_gemm`: the forward layer ``ReLU(h[:, :K] W[:K] + b)``;
* :func:`f32_dh_gemm`: ``d_h = dz[:, :K] W[:, :K]^T`` where ``mask > 0``;
* :func:`f32_dw_gemm`: the split-K partials of ``dW = h^T dz``, one per
  ``k_chunk`` rows;
* :func:`f32_head_gemm`: the field's head ``sigmoid(h[:, :K] W[:K] + b)``,
  or with ``dout`` its ``d_z = dout y (1 - y)``.

On CUDA tensors each wrapper launches the kernel or raises; on CPU tensors
it runs the plain version (``*_reference``).  Operands are contiguous f32;
a row stride is the operand's width (3 for a head).

:func:`tile_shape`, :func:`stage_copies` and :func:`k_terms` mirror the
kernel's block tile, its staging of one k-tile and the terms each output
sums, for the CPU tests.
"""

from __future__ import annotations

import torch

FORMS = {"forward": 0, "d_h": 1, "dW": 2, "head": 3, "head_grad": 4}
# kernel launches of the C entry points, by wrapper; a run resets and reads them
launches = {f"f32_{name}_gemm": 0 for name in ("layer", "dh", "dw", "head")}

K_TILE = 32  # nerf_wide_f32_gemm.cuh's kFK


def layer_reference(h, W, b, K: int) -> torch.Tensor:
    """Plain version of :func:`f32_layer_gemm`."""
    return torch.relu(h[:, :K] @ W[:K] + b)


def dh_reference(dz, W, mask, K: int) -> torch.Tensor:
    """Plain version of :func:`f32_dh_gemm`."""
    d = dz[:, :K] @ W[:, :K].T
    return torch.where(mask > 0, d, torch.zeros_like(d))


def dw_reference(h, dz, M: int, k_chunk: int) -> torch.Tensor:
    """Plain version of :func:`f32_dw_gemm`: ``(parts, M, N)``, part z =
    ``h[rows of chunk z, :M]^T dz[rows of chunk z]``."""
    return torch.stack([h[r:r + k_chunk, :M].T @ dz[r:r + k_chunk]
                        for r in range(0, h.shape[0], k_chunk)])


def head_reference(h, W, b, K: int, dout=None) -> torch.Tensor:
    """Plain version of :func:`f32_head_gemm`."""
    y = torch.sigmoid(h[:, :K] @ W[:K] + b)
    return y if dout is None else dout * y * (1.0 - y)


def tile_shape(form: str, M: int, N: int, K: int, k_chunk: int, sms: int = 132):
    """``(BM, BN, TM, TN)`` of the block tile the kernel takes (the host
    mirror of ``f32_gemm``): N <= 16 the narrow 256 x 16 (a dW 64 x 16, of
    64 threads); a dW whose 128 x 128 grid would leave more than a quarter
    of the SMs idle, 64 x 64; else 128 x 128 (256 threads)."""
    if N <= 16:
        return (64, 16, 4, 4) if form == "dW" else (256, 16, 4, 4)
    if form == "dW" and 4 * -(-M // 128) * -(-N // 128) * -(-K // k_chunk) < 3 * sms:
        return 64, 64, 4, 4
    return 128, 128, 8, 8


def tile_index(x: int, k: int, bx: int, x_major: bool) -> int:
    """Where element (x, k) of a staged k-tile lies in shared memory
    (``tile_at``): ``[k][x]``, or ``[x][k]`` in rows of 32 whose 16-B units
    of 4 k are XOR-swizzled by ``(x >> 2) & 7``."""
    if not x_major:
        return k * bx + x
    return x * K_TILE + ((((k >> 2) ^ (x >> 2)) & 7) << 2) + (k & 3)


def stage_copies(bx: int, x_major: bool, x0: int, xmax: int, k0: int, kend: int, vec: bool):
    """The copies one k-tile of an operand takes (``stage_tile``): a list of
    ``(shared index, x, k, elements read, elements written)`` for each
    thread's ``cp.async``, the elements running along the contiguous
    dimension (k for ``[x][k]``, x for ``[k][x]``); past ``xmax`` or
    ``kend`` the copy reads fewer (zero-fill)."""
    out = []
    if vec:
        run = K_TILE // 4 if x_major else bx // 4
        for i in range(bx * K_TILE // 4):
            a, b = i // run, i % run * 4
            x, k = (a, b) if x_major else (b, a)
            gx, gk = x0 + x, k0 + k
            if x_major:
                valid = min(max(kend - gk, 0), 4) if gx < xmax else 0
            else:
                valid = min(max(xmax - gx, 0), 4) if gk < kend else 0
            out.append((tile_index(x, k, bx, x_major), x, k, valid, 4))
    else:
        for i in range(bx * K_TILE):
            x, k = (i // K_TILE, i % K_TILE) if x_major else (i % bx, i // bx)
            ok = x0 + x < xmax and k0 + k < kend
            out.append((tile_index(x, k, bx, x_major), x, k, int(ok), 1))
    return out


def k_terms(kbeg: int, kend: int) -> int:
    """The terms each output of the k chunk [kbeg, kend) sums: every k of
    a whole k-tile, and the last tile's up to the next multiple of 8 from
    kbeg (its zero terms past kend)."""
    terms = 0
    for k0 in range(kbeg, kend, K_TILE):
        terms += K_TILE if k0 + K_TILE <= kend else (kend - k0 + 7) // 8 * 8
    return terms


def _check(what: str, *xs: torch.Tensor) -> None:
    dev = xs[0].device
    for x in xs:
        if x.ndim not in (1, 2) or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{what}: need contiguous f32 operands, got {x.dtype} "
                             f"{tuple(x.shape)}")
        if x.device != dev:
            raise ValueError(f"{what}: every input on one device")
        if x.numel() == 0:
            raise ValueError(f"{what}: empty operand {tuple(x.shape)}")
    if dev.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"no f32 GEMM for device {dev}")


def _need(ok: bool, what: str, msg: str) -> None:
    if not ok:
        raise ValueError(f"{what}: {msg}")


def _launch(wrapper: str, form: str, A, B, bias, mask, C, M, N, K, k_chunk):
    from lomanerf_tpu_torch.ops import build

    stream = torch.cuda.current_stream(A.device).cuda_stream
    err = build.load().wide_f32_gemm(
        A.data_ptr(), A.shape[1], B.data_ptr(), B.shape[1],
        None if bias is None else bias.data_ptr(), None if mask is None else mask.data_ptr(),
        C.data_ptr(), C.shape[-1], M, N, K, k_chunk, FORMS[form], stream)
    if err != 0:
        raise RuntimeError(f"wide_f32_gemm launch failed: cudaError {err}")
    launches[wrapper] += 1
    return C


def _layer(h, W, b, K: int, head: bool, dout=None):
    what = "f32_head_gemm" if head else "f32_layer_gemm"
    _check(what, h, W, b, *([] if dout is None else [dout]))
    rows = h.shape[0] if h.ndim == 2 else 0
    _need(h.ndim == 2 and W.ndim == 2 and b.ndim == 1, what, "need h (rows, k), W (k, n), b (n,)")
    _need(0 < K <= min(h.shape[1], W.shape[0]), what, f"K {K} past the operands' columns")
    N = W.shape[1]
    _need(b.shape == (N,), what, f"need a ({N},) bias, got {tuple(b.shape)}")
    _need(dout is None or dout.shape == (rows, N), what, f"need a ({rows}, {N}) cotangent")
    if h.device.type == "cpu":
        return head_reference(h, W, b, K, dout) if head else layer_reference(h, W, b, K)
    form = ("head" if dout is None else "head_grad") if head else "forward"
    C = torch.empty((rows, N), dtype=torch.float32, device=h.device)
    return _launch(what, form, h, W, b, dout, C, rows, N, K, K)


def f32_layer_gemm(h: torch.Tensor, W: torch.Tensor, b: torch.Tensor, K: int) -> torch.Tensor:
    """The forward layer: ``(rows, n)`` f32 ``ReLU(h[:, :K] W[:K] + b)`` of a
    layer input ``h`` (rows, >= K), its ``W`` (>= K, n) ``[in][out]`` and
    ``b`` (n,): the f32 GEMM on CUDA tensors, the plain version on CPU ones."""
    return _layer(h, W, b, K, head=False)


def f32_head_gemm(h, W, b, K: int, dout=None) -> torch.Tensor:
    """The field's head, ``sigmoid(h[:, :K] W[:K] + b)`` (rows, n), or with
    ``dout`` (rows, n) its ``d_z = dout y (1 - y)``: the f32 GEMM on CUDA
    tensors, the plain version on CPU ones."""
    return _layer(h, W, b, K, head=True, dout=dout)


def f32_dh_gemm(dz: torch.Tensor, W: torch.Tensor, mask: torch.Tensor, K: int) -> torch.Tensor:
    """``d_h`` of a layer, (rows, n) f32: ``dz[:, :K] W[:, :K]^T`` where
    ``mask > 0``, else 0, from ``dz`` (rows, >= K), the layer's ``W`` (n, >=
    K) ``[in][out]`` and its input ``mask`` (rows, n): the f32 GEMM on CUDA
    tensors, the plain version on CPU ones."""
    what = "f32_dh_gemm"
    _check(what, dz, W, mask)
    _need(dz.ndim == 2 and W.ndim == 2 and mask.ndim == 2, what,
          "need dz (rows, k), W (n, k), mask (rows, n)")
    _need(0 < K <= min(dz.shape[1], W.shape[1]), what, f"K {K} past the operands' columns")
    rows, N = dz.shape[0], W.shape[0]
    _need(mask.shape == (rows, N), what, f"need a ({rows}, {N}) mask, got {tuple(mask.shape)}")
    if dz.device.type == "cpu":
        return dh_reference(dz, W, mask, K)
    C = torch.empty((rows, N), dtype=torch.float32, device=dz.device)
    return _launch(what, "d_h", dz, W, None, mask, C, rows, N, K, K)


def f32_dw_gemm(h: torch.Tensor, dz: torch.Tensor, M: int, k_chunk: int) -> torch.Tensor:
    """dW's split-K partials, ``(ceil(rows / k_chunk), M, n)`` f32: part z =
    ``h[rows of chunk z, :M]^T dz[rows of chunk z]`` of a layer input ``h``
    (rows, >= M) and ``dz`` (rows, n): the f32 GEMM on CUDA tensors, the
    plain version on CPU ones."""
    what = "f32_dw_gemm"
    _check(what, h, dz)
    _need(h.ndim == 2 and dz.ndim == 2 and h.shape[0] == dz.shape[0], what,
          "need h (rows, >= M) and dz (rows, n)")
    _need(0 < M <= h.shape[1] and k_chunk > 0, what, f"M {M}, k_chunk {k_chunk}")
    rows, N = dz.shape
    if h.device.type == "cpu":
        return dw_reference(h, dz, M, k_chunk)
    C = torch.empty((-(-rows // k_chunk), M, N), dtype=torch.float32, device=h.device)
    return _launch(what, "dW", h, dz, None, None, C, M, N, rows, k_chunk)
