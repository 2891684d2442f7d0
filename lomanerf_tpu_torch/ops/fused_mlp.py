"""Fused 2D image field, forward and parameter gradient (port of
``lomanerf_tpu.ops.fused_mlp``).

Two hand-written CUDA kernels, each the Hopper counterpart of a TPU kernel:

* ``csrc/field_fwd.cu`` — ``fused_mlp._fwd_kernel``: :func:`field_forward`;
* ``csrc/field_bwd.cu`` — ``fused_mlp._bwd_kernel``: its backward
  (``_FieldFwd.backward``), dW/db from the output cotangent.

Both take the raw ``(N, 2)`` pixel coords and encode them on the chip.
Their parameters use the packed layout of the narrow NeRF kernels
(``fused_nerf.pack_params``: per layer, W zero-padded to (rows, cols), then
b), with the hidden width padded to one of :data:`WIDTHS` and the head to 4
columns.

Dispatch follows ``fused_nerf``: on CUDA tensors :func:`field_forward`
launches the kernel or raises, naming the ROADMAP item of what it does not
take (:func:`kernel_width`); on CPU tensors it runs the plain PyTorch
version (:func:`field_forward_reference`, autograd through ``core``).  No
case falls back quietly from one to the other.

Like the JAX package, the field differentiates params only: the coords are
detached, so their gradient comes back ``None`` (where the TPU version
returns zeros).
"""

from __future__ import annotations

import functools

import torch

from lomanerf_tpu_torch.core.encoding import encoded_dim, positional_encoding
from lomanerf_tpu_torch.core.mlp import Params
from lomanerf_tpu_torch.core.pipeline import image_fit_pred
from lomanerf_tpu_torch.ops.fused_nerf import (_f32, _params_of, grad_floats, pack_params,
                                               unpack_grads)

# kernel launches per C entry point; a run resets them and reads them to
# show that its steps and renders went through the kernels
launches = {"field_fwd": 0, "field_bwd": 0}

WIDTHS = (16, 32, 64, 128)  # padded hidden widths the kernels are built for
TILE = 64  # pixels per block tile (field_common.cuh)
_HEAD = 4  # head columns the kernels compute
_SMEM_LIMIT = 227 * 1024  # dynamic shared memory one Hopper block can use


def field_smem_bytes(L: int, in_dim: int, width: int) -> int:
    """Shared memory of one block of either kernel (the formula of
    ``field_common.cuh:Dims::smem_bytes``): the largest layer's weights with
    rows padded by one float, then every layer's input for a tile and the
    head's output, rows padded by one float."""
    rows = [in_dim] + [width] * (L - 1)
    cols = [width] * (L - 1) + [_HEAD]
    wbuf = max(r * (c + 1) + c for r, c in zip(rows, cols))
    acts = TILE * (in_dim + 1 + sum(c + 1 for c in cols))
    return 4 * (wbuf + acts)


def kernel_width(params: Params, coord_dim: int, num_functions: int,
                 out_channels: int) -> int:
    """The padded hidden width (one of :data:`WIDTHS`) the kernels run this
    field at, after checking that they take it; raises for what they do not
    take, naming ROADMAP item D2."""
    ws = params["w"]
    in_dim = encoded_dim(coord_dim, num_functions)
    if ws[0].shape[0] != in_dim:
        raise ValueError(f"first layer takes {ws[0].shape[0]} inputs, the "
                         f"n={num_functions} encoding of {coord_dim}-d coords gives {in_dim}")
    if out_channels > ws[-1].shape[1]:
        raise ValueError(f"out_channels={out_channels} > the head's {ws[-1].shape[1]}")
    if coord_dim != 2:
        raise NotImplementedError(f"{coord_dim}-d coords have no CUDA field kernel "
                                  "yet (ROADMAP queue 2, D2)")
    if ws[-1].shape[1] > _HEAD:
        raise NotImplementedError(f"a {ws[-1].shape[1]}-channel head has no CUDA field "
                                  f"kernel yet (> {_HEAD}; ROADMAP queue 2, D2)")
    hidden = max((w.shape[1] for w in ws[:-1]), default=0)
    width = next((w for w in WIDTHS if w >= hidden), None)
    if width is None:
        raise NotImplementedError(f"field width {hidden} > {WIDTHS[-1]} has no CUDA "
                                  "kernel yet (ROADMAP queue 2, D2)")
    smem = field_smem_bytes(len(ws), in_dim, width)
    if smem > _SMEM_LIMIT:
        raise NotImplementedError(
            f"a {len(ws)}-layer field at width {width} needs {smem} B of shared "
            f"memory per block, over the {_SMEM_LIMIT} B a block has (ROADMAP "
            "queue 2, D2)")
    return width


def pack_field_params(params: Params, width: int) -> torch.Tensor:
    """The kernels' flat f32 parameter buffer, on the params' device."""
    empty = params["w"][0].new_zeros(0, dtype=torch.float32)
    return pack_params(params, empty, empty, width)


def _launch_fwd(pk, coords, L, in_dim, width, nf, out_ch) -> torch.Tensor:
    """One launch of ``field_fwd``; counted in ``launches``."""
    from lomanerf_tpu_torch.ops import build

    n = coords.shape[0]
    out = torch.empty((n, out_ch), dtype=torch.float32, device=coords.device)
    stream = torch.cuda.current_stream(coords.device).cuda_stream
    err = build.load().field_fwd(pk.data_ptr(), coords.data_ptr(), out.data_ptr(), n, L,
                                 in_dim, width, nf, out_ch, stream)
    if err != 0:
        raise RuntimeError(f"field_fwd launch failed: cudaError {err}")
    launches["field_fwd"] += 1
    return out


@functools.lru_cache(maxsize=None)
def resident_blocks(device_index: int, L: int, in_dim: int, width: int, nf: int,
                    out_ch: int) -> int:
    """Blocks of the gradient kernel the card holds at once at these shapes:
    the upper bound of its grid (each block strides over the tiles)."""
    from lomanerf_tpu_torch.ops import build

    with torch.cuda.device(device_index):
        got = build.load().field_bwd_blocks(L, in_dim, width, nf, out_ch)
    if got <= 0:
        raise RuntimeError(f"field_bwd_blocks failed: cudaError {-got}" if got
                           else "field_bwd: no block fits on the card")
    return got


def _launch_bwd(pk, G, coords, dout, L, in_dim, width, nf, out_ch) -> torch.Tensor:
    """One call of ``field_bwd`` (the gradient kernel and its fixed-order
    partial sum): the G gradient floats.  Counted in ``launches``."""
    from lomanerf_tpu_torch.ops import build

    n, dev = coords.shape[0], coords.device
    tiles = -(-n // TILE)
    blocks = max(1, min(tiles, resident_blocks(dev.index, L, in_dim, width, nf, out_ch)))
    partials = torch.empty(blocks * G, dtype=torch.float32, device=dev)
    out = torch.empty(G, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = build.load().field_bwd(pk.data_ptr(), G, coords.data_ptr(), dout.data_ptr(),
                                 partials.data_ptr(), blocks, out.data_ptr(), n, L,
                                 in_dim, width, nf, out_ch, stream)
    if err != 0:
        raise RuntimeError(f"field_bwd launch failed: cudaError {err}")
    launches["field_bwd"] += 1
    return out


class _FieldFwd(torch.autograd.Function):
    """The field kernel behind autograd: forward launches ``field_fwd``;
    backward launches ``field_bwd`` with the output cotangent (the
    counterpart of ``pallas_utils.render_vjp``).  Coords get no gradient."""

    @staticmethod
    def forward(ctx, coords, num_functions, out_channels, width, *wb):
        params = _params_of(wb)
        pk = pack_field_params(params, width)
        ctx.save_for_backward(pk, coords, *wb)
        ctx.dims = (len(wb) // 2, wb[0].shape[0], width, num_functions, out_channels)
        return _launch_fwd(pk, coords, *ctx.dims)

    @staticmethod
    def backward(ctx, grad_out):
        pk, coords, *wb = ctx.saved_tensors
        params, width = _params_of(wb), ctx.dims[2]
        flat = _launch_bwd(pk, grad_floats(params, width), coords, _f32(grad_out),
                           *ctx.dims)
        return (None,) * 4 + unpack_grads(flat, params, width)


def field_forward(params: Params, coords: torch.Tensor, num_functions: int,
                  out_channels: int = 3) -> torch.Tensor:
    """Fused encode + MLP + sigmoid field: coords ``(N, 2)`` to
    ``(N, out_channels)``, with the JAX signature less the TPU tile.
    Differentiable w.r.t. params only.  Every precision tier of the JAX
    package runs in f32 on the card."""
    coords = coords.detach()
    if coords.device.type == "cpu":
        return field_forward_reference(params, coords, num_functions, out_channels)
    if coords.device.type != "cuda":
        raise NotImplementedError(f"no field kernel for device {coords.device}")
    if coords.ndim != 2:
        raise ValueError(f"coords of shape {tuple(coords.shape)}, expected (N, 2)")
    width = kernel_width(params, coords.shape[1], num_functions, out_channels)
    if any(x.device != coords.device for x in [*params["w"], *params["b"]]):
        raise ValueError("coords and params must share one CUDA device")
    return _FieldFwd.apply(_f32(coords), num_functions, out_channels, width,
                           *params["w"], *params["b"])


def field_forward_reference(params: Params, coords: torch.Tensor, num_functions: int,
                            out_channels: int = 3) -> torch.Tensor:
    """Plain PyTorch version of :func:`field_forward`: the core pipeline's
    encoding and sigmoid MLP, under autograd (coords detached)."""
    enc = positional_encoding(coords.detach(), num_functions)
    return image_fit_pred(params, enc)[:, :out_channels]
