"""Fused 2D image field, forward and parameter gradient (port of
``lomanerf_tpu.ops.fused_mlp``).

Two hand-written CUDA kernels, each the Hopper counterpart of a TPU kernel,
in two routes.  The tile kernels, for 2D coords, hidden widths up to 128, a
head of at most 4 channels and a 32-pixel tile that fits a block's shared
memory (:func:`kernel_width`):

* ``csrc/field_fwd.cu`` — ``fused_mlp._fwd_kernel``: :func:`field_forward`;
* ``csrc/field_bwd.cu`` — ``fused_mlp._bwd_kernel``: its backward
  (``_FieldFwd.backward``), dW/db from the output cotangent.

Every other field the JAX kernels take (any width, any depth, heads of up
to 128 channels, ``(N, D)`` coords of any D) runs on ``csrc/field_wide.cu``
(``field_wide_fwd`` and ``field_wide_bwd``, ``_FieldWide``): the encoding,
then one tiled GEMM a layer with the activations in device memory, in
pixel chunks of :func:`field_wide_chunk`.

Both take the raw pixel coords and encode them on the chip (``sincosf`` of
the exact octave ``2^i x``, as ``core.positional_encoding``).  Both run their
products by the JAX package's precision tier (:func:`exact_tier`): "highest"
as f32 FMAs (exact f32 products, for parity work), "high" and "default" on
the tensor cores in split TF32 (3xTF32, f32-level accuracy): the tile
kernels their hidden layers' products, the wide route every layer's, the
head's too.  The tile kernels' parameters arrive staged
(:func:`pack_field_params`: the image of the kernels' shared memory, so that
one bulk copy brings a layer in) with the hidden width padded to one of
:data:`WIDTHS`; the gradient comes back in the packed layout of the narrow
NeRF kernels (``fused_nerf.pack_params``: per layer, W zero-padded to (rows,
cols), then b, the head at 4 columns).  The kernels stream the weights layer by layer
through two shared-memory slots; :func:`field_smem_bytes` mirrors a block's
shared memory.

Dispatch follows ``fused_nerf``: on CUDA tensors :func:`field_forward`
launches a kernel or raises (only where the JAX package refuses too: more
than 128 output channels); on CPU tensors it runs the plain PyTorch version
(:func:`field_forward_reference`: autograd through ``core``, one version
for both routes).  No case falls back quietly from one to the other.

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
launches = {"field_fwd": 0, "field_bwd": 0, "field_wide_fwd": 0, "field_wide_bwd": 0}

WIDTHS = (16, 32, 64, 128)  # padded hidden widths the kernels are built for
TILE = 32  # pixels per block tile (field_common.cuh)
_HEAD = 4  # head columns the kernels compute
_SMEM_LIMIT = 227 * 1024  # dynamic shared memory one Hopper block can use
MAX_OUT = 128  # output channels the JAX field writes (its out[:, :128])
FIELD_WIDE_BYTES = 4 << 30  # activation and d_z scratch of one field_wide chunk
ROW_CHUNK = 8192  # rows per split-K partial of field_wide's dW (nerf_wide_common.cuh)
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
                 out_channels: int):
    """The padded hidden width (one of :data:`WIDTHS`) the tile kernels run
    this field at, or ``None`` where they do not take it and
    ``field_wide.cu`` does: coords that are not 2D, a head above 4
    channels, a hidden width above 128, or a 32-pixel tile over a block's
    shared memory (:func:`field_smem_bytes`).  Raises ``ValueError`` for a
    first layer that does not take the encoding or a head narrower than
    ``out_channels``, and ``NotImplementedError`` for more than
    :data:`MAX_OUT` output channels, which the JAX field does not write
    either."""
    ws = params["w"]
    in_dim = encoded_dim(coord_dim, num_functions)
    if ws[0].shape[0] != in_dim:
        raise ValueError(f"first layer takes {ws[0].shape[0]} inputs, the "
                         f"n={num_functions} encoding of {coord_dim}-d coords gives {in_dim}")
    if out_channels > ws[-1].shape[1]:
        raise ValueError(f"out_channels={out_channels} > the head's {ws[-1].shape[1]}")
    if out_channels > MAX_OUT:
        raise NotImplementedError(f"out_channels={out_channels}: the JAX field writes at "
                                  f"most {MAX_OUT} channels (its out[:, :{MAX_OUT}])")
    hidden = max((w.shape[1] for w in ws[:-1]), default=0)
    width = next((w for w in WIDTHS if w >= hidden), None)
    if coord_dim != 2 or ws[-1].shape[1] > _HEAD or width is None:
        return None
    if field_smem_bytes(len(ws), in_dim, width) > _SMEM_LIMIT:
        return None
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


# ---------------------------------------------------------------------------
# The wide route (csrc/field_wide.cu): what the tile kernels do not take
# ---------------------------------------------------------------------------


def field_wide_dims(params: Params, coord_dim: int, out_channels: int):
    """``(enc, hidden, pw)`` of the wide route: the encoded width, the
    widest hidden layer (0 with none), and the stacks' row stride, the
    widest of them and ``out_channels`` rounded up to 4."""
    enc = params["w"][0].shape[0]
    hidden = max((w.shape[1] for w in params["w"][:-1]), default=0)
    return enc, hidden, _round_up(max(enc, hidden, out_channels), 4)


def pack_field_wide(params: Params, pw: int, out_channels: int):
    """``W`` (L, pw, pw) and ``b`` (L, pw) f32, on the params' device: layer
    l's (in, out) weight and bias zero-padded, the head cut to its first
    ``out_channels`` columns (the only ones the field writes)."""
    ws, bs = params["w"], params["b"]
    L = len(ws)
    W = ws[0].new_zeros((L, pw, pw), dtype=torch.float32)
    b = ws[0].new_zeros((L, pw), dtype=torch.float32)
    for l, (w, bl) in enumerate(zip(ws, bs)):
        c = out_channels if l == L - 1 else w.shape[1]
        W[l, : w.shape[0], :c] = w.detach()[:, :c]
        b[l, :c] = bl.detach()[:c]
    return W.contiguous(), b.contiguous()


def unpack_field_wide(dW: torch.Tensor, db: torch.Tensor, params: Params):
    """(L, pw, pw) / (L, pw) gradient stacks back to the params' shapes:
    ``(dW_0.., db_0..)``; the head's columns past ``out_channels`` are zero
    (their cotangent is)."""
    ws, bs = params["w"], params["b"]
    dws, dbs = [], []
    for l, (w, b) in enumerate(zip(ws, bs)):
        c = min(w.shape[1], dW.shape[2])
        dw, dbl = torch.zeros_like(w), torch.zeros_like(b)
        dw[:, :c] = dW[l, : w.shape[0], :c].to(w.dtype)
        dbl[:c] = db[l, :c].to(b.dtype)
        dws.append(dw)
        dbs.append(dbl)
    return (*dws, *dbs)


def field_wide_chunk(L: int, pw: int) -> int:
    """Pixels per chunk of a wide-route call: the backward's L activation
    slots and two d_z buffers (rows x pw f32 each) within
    :data:`FIELD_WIDE_BYTES` (699,050 pixels for a 4x256 field)."""
    return max(1, FIELD_WIDE_BYTES // (4 * pw * (L + 2)))


def _launch_wide_fwd(W, b, coords, num_functions, out_ch, dims, exact, keep=False):
    """One call of ``field_wide_fwd``, every chunk (``exact``:
    :func:`exact_tier`): ``(out, acts)``.  With ``keep``, where the pixels
    fit one chunk, ``acts`` holds every layer's input for
    :func:`_launch_wide_bwd` (L x n x pw floats), else it is None.  Counted
    in ``launches``."""
    from lomanerf_tpu_torch.ops import build

    _, hidden, pw = dims
    L = W.shape[0]
    n, D, dev = coords.shape[0], coords.shape[1], coords.device
    chunk = max(1, min(n, field_wide_chunk(L, pw)))
    keep = keep and n <= chunk
    acts = torch.empty((L if keep else 2) * chunk * pw, dtype=torch.float32, device=dev)
    out = torch.empty((n, out_ch), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = build.load().field_wide_fwd(
        W.data_ptr(), b.data_ptr(), coords.data_ptr(), out.data_ptr(), acts.data_ptr(), n,
        chunk, L, D, num_functions, hidden, out_ch, pw, exact, int(keep), stream)
    if err != 0:
        raise RuntimeError(f"field_wide_fwd launch failed: cudaError {err}")
    launches["field_wide_fwd"] += 1
    return out, (acts if keep else None)


def _launch_wide_bwd(W, b, coords, dout, num_functions, dims, exact, acts=None):
    """One call of ``field_wide_bwd``, every chunk (``exact`` as for
    :func:`_launch_wide_fwd`): ``(dW, db)`` stacks.  ``acts``: the layer
    inputs a ``keep`` forward left, or None to recompute them.  Counted in
    ``launches``."""
    from lomanerf_tpu_torch.ops import build

    _, hidden, pw = dims
    L = W.shape[0]
    n, D, dev = coords.shape[0], coords.shape[1], coords.device
    chunk = max(1, min(n, field_wide_chunk(L, pw)))
    n_parts = -(-chunk // ROW_CHUNK) * pw * pw

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    kept = acts is not None
    if kept and acts.numel() != L * n * pw:
        raise ValueError(f"kept activations of {acts.numel()} floats, need {L * n * pw}")
    acts = acts if kept else f32(L * chunk * pw)
    dz, partials = f32(2 * chunk * pw), f32(n_parts)
    dW, db = f32(L, pw, pw), f32(L, pw)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = build.load().field_wide_bwd(
        W.data_ptr(), b.data_ptr(), coords.data_ptr(), dout.data_ptr(), acts.data_ptr(),
        dz.data_ptr(), partials.data_ptr(), n_parts, dW.data_ptr(), db.data_ptr(), n, chunk,
        L, D, num_functions, hidden, dout.shape[1], pw, exact, int(kept), stream)
    if err != 0:
        raise RuntimeError(f"field_wide_bwd launch failed: cudaError {err}")
    launches["field_wide_bwd"] += 1
    return dW, db


class _FieldWide(torch.autograd.Function):
    """The wide route behind autograd: forward launches ``field_wide_fwd``,
    backward ``field_wide_bwd`` with the output cotangent, both on the
    product route ``exact`` names (:func:`exact_tier`).  With ``keep`` (a
    gradient will be taken) the forward keeps every layer's input for the
    backward where the pixels fit one chunk; else the backward recomputes
    them (the same bits).  Coords get no gradient."""

    @staticmethod
    def forward(ctx, coords, num_functions, out_channels, exact, keep, *wb):
        params = _params_of(wb)
        dims = field_wide_dims(params, coords.shape[1], out_channels)
        W, b = pack_field_wide(params, dims[2], out_channels)
        ctx.save_for_backward(coords, W, b, *wb)
        ctx.num_functions, ctx.dims, ctx.exact = num_functions, dims, exact
        out, ctx.acts = _launch_wide_fwd(W, b, coords, num_functions, out_channels, dims, exact,
                                         keep)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        coords, W, b, *wb = ctx.saved_tensors
        dW, db = _launch_wide_bwd(W, b, coords, _f32(grad_out), ctx.num_functions, ctx.dims,
                                  ctx.exact, ctx.acts)
        return (None,) * 5 + unpack_field_wide(dW, db, _params_of(wb))


def _on_card(coords: torch.Tensor) -> bool:
    """True for CUDA coords (the kernels), False for CPU ones (the plain
    version); any other device raises."""
    if coords.device.type == "cpu":
        return False
    if coords.device.type != "cuda":
        raise NotImplementedError(f"no field kernel for device {coords.device}")
    return True


def field_forward(params: Params, coords: torch.Tensor, num_functions: int,
                  out_channels: int = 3, precision: str = "high") -> torch.Tensor:
    """Fused encode + MLP + sigmoid field: coords ``(N, D)`` to
    ``(N, out_channels)``, with the JAX signature less the TPU tile.
    Differentiable w.r.t. params only.  ``precision`` is the JAX package's
    tier (the models pass their config's; :func:`exact_tier`): "highest"
    runs the products as exact f32 FMAs, "high" and "default" in split TF32
    on the tensor cores (3xTF32: about 2^-21 of each product, f32 sums),
    more exact than the JAX package's "high" (bf16x3); on the tile kernels
    the hidden layers' products, on the wide route every layer's.  The
    plain version (CPU tensors) is f32 on every tier."""
    exact = exact_tier(precision)
    coords = coords.detach()
    if not _on_card(coords):
        return field_forward_reference(params, coords, num_functions, out_channels)
    if coords.ndim != 2:
        raise ValueError(f"coords of shape {tuple(coords.shape)}, expected (N, D)")
    width = kernel_width(params, coords.shape[1], num_functions, out_channels)
    if any(x.device != coords.device for x in [*params["w"], *params["b"]]):
        raise ValueError("coords and params must share one CUDA device")
    if width is None:
        keep = torch.is_grad_enabled() and any(
            x.requires_grad for x in [*params["w"], *params["b"]])
        return _FieldWide.apply(_f32(coords), num_functions, out_channels, exact, keep,
                                *params["w"], *params["b"])
    return _FieldFwd.apply(_f32(coords), num_functions, out_channels, width, exact,
                           *params["w"], *params["b"])


def field_forward_reference(params: Params, coords: torch.Tensor, num_functions: int,
                            out_channels: int = 3) -> torch.Tensor:
    """Plain PyTorch version of :func:`field_forward`, for both routes: the
    core pipeline's encoding and sigmoid MLP under autograd (coords
    detached), cut to ``out_channels``."""
    enc = positional_encoding(coords.detach(), num_functions)
    return image_fit_pred(params, enc)[:, :out_channels]
