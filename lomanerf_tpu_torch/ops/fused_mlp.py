"""Fused 2D image field, forward and parameter gradient (port of
``lomanerf_tpu.ops.fused_mlp``).

Two hand-written CUDA kernels, each the Hopper counterpart of a TPU kernel:

* ``csrc/field_fwd.cu`` — ``fused_mlp._fwd_kernel``: :func:`field_forward`;
* ``csrc/field_bwd.cu`` — ``fused_mlp._bwd_kernel``: its backward
  (``_FieldFwd.backward``), dW/db from the output cotangent.

Both take the raw ``(N, 2)`` pixel coords and encode them on the chip, and
run their hidden layers' products by the JAX package's precision tier
(:func:`exact_tier`): "highest" as f32 FMAs (exact f32 products, for parity
work), "high" and "default" on the tensor cores in split TF32 (3xTF32,
f32-level accuracy).  Their parameters arrive staged
(:func:`pack_field_params`: the image of the kernels' shared memory, so that
one bulk copy brings a layer in) with the hidden width padded to one of
:data:`WIDTHS`; the gradient comes back in the packed layout of the narrow
NeRF kernels (``fused_nerf.pack_params``: per layer, W zero-padded to (rows,
cols), then b, the head at 4 columns).  The kernels stream the weights layer by layer
through two shared-memory slots; :func:`field_smem_bytes` mirrors a block's
shared memory.

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

import numpy as np
import torch

from lomanerf_tpu_torch.core.encoding import encoded_dim, positional_encoding
from lomanerf_tpu_torch.core.mlp import Params
from lomanerf_tpu_torch.core.pipeline import image_fit_pred
from lomanerf_tpu_torch.ops.fused_nerf import _f32, _params_of, grad_floats, unpack_grads

# kernel launches per C entry point; a run resets them and reads them to
# show that its steps and renders went through the kernels
launches = {"field_fwd": 0, "field_bwd": 0}

WIDTHS = (16, 32, 64, 128)  # padded hidden widths the kernels are built for
TILE = 32  # pixels per block tile (field_common.cuh)
_HEAD = 4  # head columns the kernels compute
_SMEM_LIMIT = 227 * 1024  # dynamic shared memory one Hopper block can use
# the JAX package's precision tiers (``ImageFieldConfig.precision``) ->
# whether the kernels run exact f32 products (1) or 3xTF32 (0)
TIERS = {"highest": 1, "high": 0, "default": 0}


def exact_tier(precision: str) -> int:
    """The kernels' ``exact`` flag for a precision tier of the JAX package
    ("highest": 1, f32 FMA products; "high" and "default": 0, 3xTF32);
    raises ``ValueError`` for any other."""
    if precision not in TIERS:
        raise ValueError(f"unknown precision tier {precision!r}; one of {list(TIERS)}")
    return TIERS[precision]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def field_layout(L: int, in_dim: int, width: int):
    """The kernels' shapes (``field_common.cuh:Dims``): per layer the
    product's (krows, kcols) (the encoding rounded up to 8 rows, the head at 4
    columns), its staged floats (W, then kcols of bias, padded to 16 bytes),
    and the columns of each layer's input in shared memory (act(0) rounded
    up to 32; act(L) the head's d_z)."""
    krows = [_round_up(in_dim, 8)] + [width] * (L - 1)
    kcols = [width] * (L - 1) + [_HEAD]
    stage = [_round_up(r * c + c, 4) for r, c in zip(krows, kcols)]
    return krows, kcols, stage, [_round_up(in_dim, 32)] + kcols


def field_smem_bytes(L: int, in_dim: int, width: int) -> int:
    """Shared memory bytes of a block of either kernel (the formula of
    ``field_common.cuh:Dims::smem_bytes``): two barriers, two weight slots
    of the largest layer, every layer's input for a tile of :data:`TILE`
    pixels, from two layers on a second d_z buffer of the hidden width, and
    the tile's coords.  It may exceed what a block has (no kernel takes
    that)."""
    _, _, stage, act_cols = field_layout(L, in_dim, width)
    acts = TILE * (sum(act_cols) + (width if L >= 2 else 0) + 2)
    return 16 + 4 * (2 * max(stage) + acts)


def swizzle(r, c, cols: int):
    """Float index of element (r, c) of a row-major (., cols) matrix in the
    kernels' shared memory (``field_common.cuh:swz``): rows of 32 or more
    floats XOR bits 2-4 of the column with ``(r & 3) << 3 | (r & 4)``."""
    f = ((r & 3) << 3) | (r & 4)
    return r * cols + ((c ^ f) if cols >= 32 else c)


@functools.lru_cache(maxsize=None)
def _stage_index(shapes: tuple, width: int, device: torch.device):
    """Where each float of ``cat(W_0, b_0, W_1, ...)`` goes in the staged
    buffer, and the buffer's length."""
    krows, kcols, stage, _ = field_layout(len(shapes), shapes[0][0], width)
    idx, off = [], 0
    for (fi, fo), kr, kc, st in zip(shapes, krows, kcols, stage):
        r, c = np.meshgrid(np.arange(fi), np.arange(fo), indexing="ij")
        idx += [off + swizzle(r, c, kc).ravel(), off + kr * kc + np.arange(fo)]
        off += st
    return torch.as_tensor(np.concatenate(idx), device=device), off


def pack_field_params(params: Params, width: int) -> torch.Tensor:
    """The kernels' staged f32 parameter buffer, on the params' device: per
    layer W_l zero-padded to (krows, kcols) in the swizzle of
    :func:`swizzle`, then b_l in kcols floats, each layer padded to 16 bytes
    (:func:`field_layout`): the image of a layer's slot in shared memory."""
    shapes = tuple(tuple(w.shape) for w in params["w"])
    idx, total = _stage_index(shapes, width, params["w"][0].device)
    vals = torch.cat([t.reshape(-1).to(torch.float32)
                      for w, b in zip(params["w"], params["b"]) for t in (w, b)])
    out = vals.new_zeros(total)
    out[idx] = vals
    return out


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
            f"memory per block, over the {_SMEM_LIMIT} B a block has (ROADMAP queue 2, D2)")
    return width


@functools.lru_cache(maxsize=None)
def resident_blocks(device_index: int, entry: str, L: int, in_dim: int, width: int, nf: int,
                    out_ch: int, exact: int) -> int:
    """Blocks of ``entry``'s kernel (``"field_fwd"`` or ``"field_bwd"``, on
    the route ``exact`` names) the card holds at once at these shapes: the
    upper bound of its grid (each block strides over the tiles)."""
    from lomanerf_tpu_torch.ops import build

    with torch.cuda.device(device_index):
        got = getattr(build.load(), f"{entry}_blocks")(L, in_dim, width, nf, out_ch, exact)
    if got <= 0:
        raise RuntimeError(f"{entry}_blocks failed: cudaError {-got}" if got
                           else f"{entry}: no block fits on the card")
    return got


def _grid(entry, n, dev, *dims) -> int:
    """The persistent grid of one launch: the card's resident blocks, at
    most one per tile."""
    return max(1, min(-(-n // TILE), resident_blocks(dev.index, entry, *dims)))


def _launch_fwd(pk, coords, L, in_dim, width, nf, out_ch, exact) -> torch.Tensor:
    """One launch of ``field_fwd`` (``exact``: :func:`exact_tier`); counted
    in ``launches``."""
    from lomanerf_tpu_torch.ops import build

    n, dev = coords.shape[0], coords.device
    out = torch.empty((n, out_ch), dtype=torch.float32, device=dev)
    blocks = _grid("field_fwd", n, dev, L, in_dim, width, nf, out_ch, exact)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = build.load().field_fwd(pk.data_ptr(), coords.data_ptr(), out.data_ptr(), blocks, n,
                                 L, in_dim, width, nf, out_ch, exact, stream)
    if err != 0:
        raise RuntimeError(f"field_fwd launch failed: cudaError {err}")
    launches["field_fwd"] += 1
    return out


def _launch_bwd(pk, G, coords, dout, L, in_dim, width, nf, out_ch, exact) -> torch.Tensor:
    """One call of ``field_bwd`` (the gradient kernel and its fixed-order
    partial sum; ``exact`` as for :func:`_launch_fwd`): the G gradient
    floats.  Counted in ``launches``."""
    from lomanerf_tpu_torch.ops import build

    n, dev = coords.shape[0], coords.device
    blocks = _grid("field_bwd", n, dev, L, in_dim, width, nf, out_ch, exact)
    partials = torch.empty(blocks * G, dtype=torch.float32, device=dev)
    out = torch.empty(G, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = build.load().field_bwd(pk.data_ptr(), G, coords.data_ptr(), dout.data_ptr(),
                                 partials.data_ptr(), blocks, out.data_ptr(), n, L,
                                 in_dim, width, nf, out_ch, exact, stream)
    if err != 0:
        raise RuntimeError(f"field_bwd launch failed: cudaError {err}")
    launches["field_bwd"] += 1
    return out


class _FieldFwd(torch.autograd.Function):
    """The field kernel behind autograd: forward launches ``field_fwd``;
    backward launches ``field_bwd`` with the output cotangent (the
    counterpart of ``pallas_utils.render_vjp``), both on the product route
    ``exact`` names (:func:`exact_tier`).  Coords get no gradient."""

    @staticmethod
    def forward(ctx, coords, num_functions, out_channels, width, exact, *wb):
        params = _params_of(wb)
        pk = pack_field_params(params, width)
        ctx.save_for_backward(pk, coords, *wb)
        ctx.dims = (len(wb) // 2, wb[0].shape[0], width, num_functions, out_channels, exact)
        return _launch_fwd(pk, coords, *ctx.dims)

    @staticmethod
    def backward(ctx, grad_out):
        pk, coords, *wb = ctx.saved_tensors
        params, width = _params_of(wb), ctx.dims[2]
        flat = _launch_bwd(pk, grad_floats(params, width), coords, _f32(grad_out),
                           *ctx.dims)
        return (None,) * 5 + unpack_grads(flat, params, width)


def field_forward(params: Params, coords: torch.Tensor, num_functions: int,
                  out_channels: int = 3, precision: str = "high") -> torch.Tensor:
    """Fused encode + MLP + sigmoid field: coords ``(N, 2)`` to
    ``(N, out_channels)``, with the JAX signature less the TPU tile.
    Differentiable w.r.t. params only.  ``precision`` is the JAX package's
    tier (the models pass their config's; :func:`exact_tier`): on the card
    "highest" runs the hidden layers' products as exact f32 FMAs, "high"
    and "default" in split TF32 on the tensor cores (3xTF32: about 2^-21 of
    each product, f32 sums), more exact than the JAX package's "high"
    (bf16x3).  The plain version (CPU tensors) is f32 on every tier."""
    exact = exact_tier(precision)
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
    return _FieldFwd.apply(_f32(coords), num_functions, out_channels, width, exact,
                           *params["w"], *params["b"])


def field_forward_reference(params: Params, coords: torch.Tensor, num_functions: int,
                            out_channels: int = 3) -> torch.Tensor:
    """Plain PyTorch version of :func:`field_forward`: the core pipeline's
    encoding and sigmoid MLP, under autograd (coords detached)."""
    enc = positional_encoding(coords.detach(), num_functions)
    return image_fit_pred(params, enc)[:, :out_channels]
