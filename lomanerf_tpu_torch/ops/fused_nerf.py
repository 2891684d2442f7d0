"""Fused NeRF render and train loss (port of ``lomanerf_tpu.ops.fused_nerf``).

Twelve hand-written CUDA entry points, each the Hopper counterpart of a TPU
kernel: six kernels, each in two instances, one for depths shared by every
ray (``(S,)``, the unjittered sampler's) and one for per-ray ``(N, S)``
depths (the stratified sampler's, ``NeRFModel.sample(generator=...)``).
The ``*_rays`` entry points read the per-ray depths; a ray's arithmetic is
the same in both.  Narrow MLPs (every width, the 33 inputs and 4 outputs
included, padded to 8, at most 64), one thread per ray (the render
forward runs a ray's samples in groups, :func:`sample_groups`):

* ``csrc/nerf_render_fwd.cu`` — ``nerf_render_fwd`` (``_nerf_forward_kernel_S``)
  and ``nerf_render_fwd_rays`` (``_nerf_forward_kernel_T``): :func:`render_rays`;
* ``csrc/nerf_render_bwd.cu`` — ``nerf_render_bwd`` (``_nerf_backward_kernel_S``)
  and ``csrc/nerf_render_bwd_rays.cu`` — ``nerf_render_bwd_rays``
  (``_nerf_backward_kernel_T``): the backward of :func:`render_rays`
  (``_RenderFwd.backward``);
* ``csrc/nerf_train.cu`` — ``nerf_train`` (``_nerf_train_kernel_S``) and
  ``csrc/nerf_train_rays.cu`` — ``nerf_train_rays`` (``_nerf_train_kernel_T``):
  :func:`nerf_train_loss`, the loss and its parameter gradients in one call.

Wide MLPs (padded width above 64, any width padded to a multiple of 128,
one layer or more, f32 or bf16 compute, e.g. the 8x256 flagship or an
8x1024 MLP), tiled GEMMs around a one-warp-per-ray compositing kernel.  In
bf16 at pw 128 or 256 the render's MLP is one persistent kernel per ray
chunk (``csrc/nerf_wide_mlp.cuh``: the encoding and every hidden layer of a
row tile on ``wgmma`` fed by TMA, the activations in shared memory; alone,
with the chain it replaced, in ``ops/wide_mlp``); wider bf16 MLPs and
one-layer ones render on that chain (``mma.sync`` layer GEMMs).  Each hidden
layer's dW in the bf16 gradient sequence runs on ``csrc/nerf_wide_dw.cuh``
(``wgmma`` fed by TMA, alone in ``ops/wide_dw``); the rest runs layer by
layer:

* ``csrc/nerf_wide_render_fwd.cu`` — ``nerf_wide_render_fwd``
  (``_nerf_forward_kernel_W``) and ``nerf_wide_render_fwd_rays``
  (``_nerf_forward_kernel``);
* ``csrc/nerf_wide_render_bwd.cu`` — ``nerf_wide_render_bwd``
  (``_nerf_backward_kernel_W``) and ``nerf_wide_render_bwd_rays``
  (``_nerf_backward_kernel``), behind ``_WideRender.backward``;
* ``csrc/nerf_wide_train.cu`` — ``nerf_wide_train`` (``_nerf_train_kernel_W``)
  and ``nerf_wide_train_rays`` (``_nerf_train_kernel``), behind
  ``_WideTrainLoss``.

Dispatch follows the JAX package's rule (:func:`_route`) for the width and
the depths' shape for the instance.  A narrow MLP whose block does not fit
one block's 227 KB of shared memory (the gradient kernels keep 64 rays'
activations and d_z there beside the packed params: e.g. 5x64 at S = 64,
~279 KB; ``single64``, 4x64 at S = 64, takes ~213 KB and stays narrow) runs
on the wide kernels at pw = 128 in f32, as the JAX package sends it to its
packed wide kernel at pw = 128; so does a narrow MLP in bf16 (the narrow
kernels are f32 only), in bf16.  Its forward, backward and train loss all
take that route.  On CUDA tensors each function launches its kernel or
raises; on CPU tensors it runs the plain PyTorch version
(:func:`render_rays_reference` under autograd).  No case falls back quietly
from one to the other.

The published NeRF (``NeRFConfig.paper()``, two networks with the skip
connection and the view branch; no JAX counterpart) runs one network per
call on per-ray depths: ``csrc/nerf_paper.cu`` — ``nerf_paper_render``
(:func:`paper_render`: colours and the compositing weights the sampler
reads) and ``nerf_paper_train`` (:func:`paper_train_loss`: the loss and
every gradient, behind ``_PaperTrainLoss``), on the wide chain's kernels
with the non-uniform layers packed by :func:`pack_paper_params`.

Like the JAX package, the render and the losses differentiate params only:
the ray inputs are detached, so their gradients come back ``None``.

Spans (``utils.profiling.span``, recorded only under a profiler):
``lomanerf.fused_nerf.train_loss`` and ``.render_rays`` around the two
entry points on every route, ``.pack`` and ``.unpack`` around the parameter
and gradient layouts, ``.launch.<entry>`` around a C entry's scratch and
host enqueue, ``.backward`` around each autograd Function's backward (on
autograd's device thread on the card).
"""

from __future__ import annotations

import functools
import math

import torch

from lomanerf_tpu_torch.core.composite import EPS
from lomanerf_tpu_torch.core.encoding import positional_encoding
from lomanerf_tpu_torch.core.losses import sum_mse
from lomanerf_tpu_torch.core.mlp import Params
from lomanerf_tpu_torch.core.pipeline import nerf_render_rays
from lomanerf_tpu_torch.ops.wide_gemm import TILE_ROWS
from lomanerf_tpu_torch.utils.profiling import span, spanned

# kernel launches per C entry point; a run resets them and reads them to
# show that its render and train steps went through the kernels
_ENTRIES = ("nerf_render_fwd", "nerf_render_bwd", "nerf_train", "nerf_wide_render_fwd",
            "nerf_wide_render_bwd", "nerf_wide_train")
launches = {name + suffix: 0 for suffix in ("", "_rays") for name in _ENTRIES}
launches.update(nerf_paper_render=0, nerf_paper_train=0)

MAX_WIDTH = 64  # widest padded width the narrow kernels' register arrays take
WIDE_FUSED_MAX = 256  # widest pw the bf16 render's fused MLP takes (nerf_wide_chain.cuh)
_HEAD = 4  # rgba channels the render reads
_SMEM_LIMIT = 227 * 1024  # dynamic shared memory one Hopper block can use
GRAD_THREADS = 64  # rays per block of the gradient kernels (nerf_grad.cuh)
RENDER_THREADS = 128  # rays per block of the render forward (nerf_render_fwd.cu)
RENDER_GROUP = 2  # samples of a ray its thread runs together (nerf_render_mlp.cuh)
_STRIDE = GRAD_THREADS + 4  # their staging row stride (a float4 of 4 rays)
WIDE_ROW_CHUNK = 8192  # rows per split-K partial (nerf_wide_common.cuh)
# scratch budgets of the wide kernels: one activation buffer of a render
# chunk, and all of a gradient call's buffers
WIDE_BUFFER_BYTES = 4 << 30
WIDE_GRAD_BYTES = 16 << 30
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _padded_width(config, params: Params) -> int:
    """ps: the widest layer, inputs and outputs included, padded to 8
    (``fused_nerf.py:1845-1849`` of the JAX package)."""
    widths = [config.in_channels] + [w.shape[1] for w in params["w"]]
    return _round_up(max(max(widths), 8), 8)


def _narrow_fits(config, params: Params, width: int) -> bool:
    """Whether one block of the narrow kernels holds this MLP in shared
    memory: the render forward's block (:func:`render_smem_bytes`, with its
    staged per-ray depths) and the gradient kernels' 64-ray block
    (:func:`grad_smem_bytes`), both counted with the shared ``(S,)`` depths'
    tail (the larger packing), so that an MLP takes one route whatever its
    depth source."""
    G = grad_floats(params, width)
    pk_floats = G + _round_up(2 * config.num_samples, 4)
    grad = grad_smem_bytes(pk_floats, G, config.num_samples, len(params["w"]),
                           config.in_channels, width)
    render = render_smem_bytes(pk_floats, config.num_samples, width, per_ray=True)
    return max(render, grad) <= _SMEM_LIMIT


def _plan(config, params: Params):
    """``("narrow", W)`` with W the narrow kernels' register width (32 or
    64), or ``("wide", pw)`` with pw the wide kernels' padded width (a
    multiple of 128).  The JAX rule: narrow if ps <= 64 and the narrow
    kernels' tile fits the chip's fast memory (here one block's shared
    memory), else wide; a narrow MLP that does not fit (e.g. 5x64 at
    S = 64) goes to the wide kernels at pw = 128, as the JAX package sends
    it to the packed wide kernel at pw = 128 when its T-kernel tile misses
    VMEM.  The narrow kernels compute in f32 only: a narrow MLP in bf16
    takes the wide kernels' bf16 rounding plan at pw = 128."""
    ps = _padded_width(config, params)
    if ps <= MAX_WIDTH and _itemsize(config) == 4:
        hidden = max((w.shape[1] for w in params["w"][:-1]), default=0)
        width = 32 if hidden <= 32 else 64
        if _narrow_fits(config, params, width):
            return "narrow", width
    return "wide", _round_up(max(ps, 128), 128)


def _route(config, params: Params):
    """:func:`_plan` after checking the MLP's shape: the encoding's width
    in, an rgba head out (``ValueError`` otherwise).  Every width and depth
    the JAX kernels take has a kernel: narrow f32 MLPs the narrow ones,
    the rest the wide ones at any multiple of 128.  The render forward,
    its backward and the train loss all take this route, so a backward
    always runs on the family of its forward."""
    ws = params["w"]
    in_dim = 3 * (1 + 2 * config.num_encoding_functions)
    if ws[0].shape[0] != in_dim:
        raise ValueError(f"first layer takes {ws[0].shape[0]} inputs, the "
                         f"n={config.num_encoding_functions} encoding gives {in_dim}")
    if ws[-1].shape[1] < _HEAD:
        raise ValueError("render needs an rgba head (>= 4 output channels)")
    return _plan(config, params)


def _blocks(params: Params, width: int):
    """(rows, cols) of each layer's padded block in the packed layout."""
    L = len(params["w"])
    return [(w.shape[0] if l == 0 else width, _HEAD if l == L - 1 else width)
            for l, w in enumerate(params["w"])]


@spanned("lomanerf.fused_nerf.pack")
def pack_params(params: Params, t_vals: torch.Tensor, dists: torch.Tensor,
                width: int) -> torch.Tensor:
    """The kernels' flat f32 buffer, on the params' device: per layer, W_l
    zero-padded to (rows_l, cols_l) then b_l padded to cols_l
    (rows_0 = in_dim, rows_l = width after; cols = width, 4 for the last
    layer), then, for ``(S,)`` shared depths, t[0..S) and dists[0..S);
    padded to a multiple of 4 floats.  Per-ray ``(N, S)`` depths stay out
    of it: the ``*_rays`` kernels read them from device memory."""
    blocks = []
    for (rows, cols), w, b in zip(_blocks(params, width), params["w"], params["b"]):
        wp = w.new_zeros((rows, cols), dtype=torch.float32)
        wp[: w.shape[0], : min(w.shape[1], cols)] = w[:, :cols]
        bp = b.new_zeros((cols,), dtype=torch.float32)
        bp[: min(b.shape[0], cols)] = b[:cols]
        blocks += [wp.reshape(-1), bp]
    if t_vals.ndim == 1:
        blocks += [t_vals.to(torch.float32), dists.to(torch.float32)]
    flat = torch.cat(blocks)
    return torch.nn.functional.pad(flat, (0, (-flat.numel()) % 4)).contiguous()


def grad_floats(params: Params, width: int) -> int:
    """G: the floats of the packed weights and biases (the gradient layout)."""
    return sum(rows * cols + cols for rows, cols in _blocks(params, width))


@spanned("lomanerf.fused_nerf.unpack")
def unpack_grads(flat: torch.Tensor, params: Params, width: int):
    """The kernels' G gradient floats back to the params' unpadded shapes:
    ``(dW_0.., db_0..)``, zero for head columns past the four it reads."""
    dws, dbs, off = [], [], 0
    for (rows, cols), w, b in zip(_blocks(params, width), params["w"], params["b"]):
        blk = flat[off: off + rows * cols].view(rows, cols)
        c = min(w.shape[1], cols)
        dw = torch.zeros_like(w)
        dw[:, :c] = blk[: w.shape[0], :c].to(w.dtype)
        db = torch.zeros_like(b)
        db[:c] = flat[off + rows * cols: off + rows * cols + c].to(b.dtype)
        dws.append(dw)
        dbs.append(db)
        off += rows * cols + cols
    return (*dws, *dbs)


def grad_smem_bytes(pk_floats: int, G: int, S: int, L: int, in_dim: int,
                    width: int) -> int:
    """Shared memory one block of the gradient kernels takes (the formula of
    ``nerf_grad.cuh:grad_smem_floats``); ``pk_floats`` counts the depth tail
    only for shared depths (:func:`pack_params`)."""
    return 4 * (pk_floats + G + S * GRAD_THREADS
                + (in_dim + (L - 1) * width) * _STRIDE
                + ((L - 1) * width + _HEAD) * _STRIDE + GRAD_THREADS)


def sample_groups(S: int, group: int):
    """The render forward's walk over a ray's S samples
    (``nerf_render_fwd.cu``, groups of :data:`RENDER_GROUP`): per group, the
    sample index of each of its ``group`` slots and how many are real.  A group starts at every multiple
    of ``group``; the last group of an S that ``group`` does not divide
    repeats sample S-1 in its pad slots, whose colours are not composited."""
    return [([min(s0 + j, S - 1) for j in range(group)], min(group, S - s0))
            for s0 in range(0, S, group)]


def render_smem_bytes(pk_floats: int, S: int, width: int, per_ray: bool) -> int:
    """Shared memory one block of the render forward takes (the formula of
    ``nerf_render_fwd.cu:render_smem_floats``): the packed params (with the
    shared depths' tail: ``pk_floats``, :func:`pack_params`), the activation
    stage of :data:`RENDER_THREADS` threads (:data:`RENDER_GROUP` x
    ``width`` floats each) and, for per-ray depths, the block's rows of t
    and dist at the odd stride ``S | 1``."""
    rows = 2 * RENDER_THREADS * (S | 1) if per_ray else 0
    return 4 * (pk_floats + RENDER_THREADS * RENDER_GROUP * width + rows)


def grad_tile_plan(L: int, in_dim: int, width: int):
    """The gradient kernels' dW tile plan (``nerf_grad.cuh``: ``DwTile``,
    ``layer_dw``): per layer, ``(main, rest, budget)``.  ``main[t]`` lists
    the indices (in the G-float gradient layout) of thread t's main tile,
    whose per-sample sums the kernel keeps in ``budget`` registers;
    ``rest[t]`` those of its remainder entries, taken one at a time.  A
    layer of R input rows (then its bias row) and C columns has ``min(C, 8)``
    column groups and ``64 / min(C, 8)`` row groups; the main tiles span the
    rows below ``min(R, width)``."""
    plan, off = [], 0
    for l in range(L):
        R = in_dim if l == 0 else width
        C = _HEAD if l == L - 1 else width
        cgs = min(C, 8)
        rgs = GRAD_THREADS // cgs
        tr, tc = width // rgs, C // cgs
        main = [[off + i * C + t % cgs + cgs * b
                 for i in range(t // cgs, width, rgs) if i < R for b in range(tc)]
                for t in range(GRAD_THREADS)]
        r0 = min(R, width)
        rest = [[off + r0 * C + e for e in range(t, (R + 1 - r0) * C, GRAD_THREADS)]
                for t in range(GRAD_THREADS)]
        plan.append((main, rest, tr * tc))
        off += R * C + C
    return plan


def _check_cuda_inputs(origins, directions, t_vals, dists, config, params, *extra):
    """Depths and steps both ``(S,)`` (shared by every ray) or both
    ``(N, S)`` (per ray), ray inputs ``(N, 3)``, all on one device; raises
    ``ValueError`` otherwise."""
    n, S = origins.shape[0], config.num_samples
    if dists.shape != t_vals.shape or tuple(t_vals.shape) not in ((S,), (n, S)):
        raise ValueError(f"depths {tuple(t_vals.shape)} and steps {tuple(dists.shape)}: "
                         f"need both ({S},) or both ({n}, {S}) for {n} rays and "
                         f"num_samples={S}")
    for x in (origins, directions, *extra):
        if tuple(x.shape) != (n, 3):
            raise ValueError(f"ray input of shape {tuple(x.shape)}, expected ({n}, 3)")
    tensors = [origins, directions, t_vals, dists, *extra, *params["w"], *params["b"]]
    if any(x.device != origins.device for x in tensors):
        raise ValueError("rays, depths and params must share one CUDA device")


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).contiguous()


def _suffix(t_vals: torch.Tensor) -> str:
    """The entry-point suffix of a depth source: ``""`` for ``(S,)`` depths
    shared by every ray, ``"_rays"`` for per-ray ``(N, S)`` ones."""
    return "_rays" if t_vals.ndim == 2 else ""


def _launch(pk, t_vals, dists, origins, directions, config, L, width) -> torch.Tensor:
    """One launch of the render forward (``nerf_render_fwd``, or
    ``nerf_render_fwd_rays`` for per-ray depths, whose pointers it passes:
    shared ones travel in ``pk``); counted in ``launches``."""
    from lomanerf_tpu_torch.ops import build

    n = origins.shape[0]
    suffix = _suffix(t_vals)
    smem = render_smem_bytes(pk.numel(), config.num_samples, width, bool(suffix))
    if smem > _SMEM_LIMIT:
        raise NotImplementedError(
            f"the render forward needs {smem} B of shared memory per block, over the "
            f"{_SMEM_LIMIT} B a block has; render_rays sends such MLPs to the "
            "wide kernels (ROADMAP queue 2, A5)")
    entry = "nerf_render_fwd" + suffix
    with span("lomanerf.fused_nerf.launch." + entry):
        ptrs = (t_vals.data_ptr(), dists.data_ptr()) if suffix else ()
        out = torch.empty((n, 3), dtype=torch.float32, device=origins.device)
        stream = torch.cuda.current_stream(origins.device).cuda_stream
        err = getattr(build.load(), entry)(
            pk.data_ptr(), pk.numel(), *ptrs, origins.data_ptr(), directions.data_ptr(),
            out.data_ptr(), n, config.num_samples, L, config.in_channels,
            config.num_encoding_functions, width, int(config.mode == "loma"), stream,
        )
        if err != 0:
            raise RuntimeError(f"{entry} launch failed: cudaError {err}")
        launches[entry] += 1
        return out


def _launch_grad(entry: str, pk, G, t_vals, dists, origins, directions, cot, config,
                 L, width) -> torch.Tensor:
    """One call of a gradient kernel (``nerf_train`` or ``nerf_render_bwd``;
    their ``*_rays`` instance for per-ray depths, as :func:`_launch`) and
    its fixed-order block sum: G gradient floats, then the loss.  Counted in
    ``launches``."""
    from lomanerf_tpu_torch.ops import build

    suffix = _suffix(t_vals)
    entry += suffix
    ptrs = (t_vals.data_ptr(), dists.data_ptr()) if suffix else ()
    n, S = origins.shape[0], config.num_samples
    smem = grad_smem_bytes(pk.numel(), G, S, L, config.in_channels, width)
    if smem > _SMEM_LIMIT:
        raise NotImplementedError(
            f"{entry} needs {smem} B of shared memory per block, over the "
            f"{_SMEM_LIMIT} B a block has; the losses and the render backward "
            "send such MLPs to the wide kernels (ROADMAP queue 2, A5)")
    with span("lomanerf.fused_nerf.launch." + entry):
        n_blocks = -(-n // GRAD_THREADS)
        partials = torch.empty((max(n_blocks, 1), G + 1), dtype=torch.float32,
                               device=origins.device)
        out = torch.empty((G + 1,), dtype=torch.float32, device=origins.device)
        stream = torch.cuda.current_stream(origins.device).cuda_stream
        err = getattr(build.load(), entry)(
            pk.data_ptr(), pk.numel(), G, *ptrs, origins.data_ptr(), directions.data_ptr(),
            cot.data_ptr(), partials.data_ptr(), out.data_ptr(), n, S, L,
            config.in_channels, config.num_encoding_functions, width,
            int(config.mode == "loma"), stream,
        )
        if err != 0:
            raise RuntimeError(f"{entry} launch failed: cudaError {err}")
        launches[entry] += 1
        return out


def _params_of(wb):
    L = len(wb) // 2
    return {"w": list(wb[:L]), "b": list(wb[L:])}


class _RenderFwd(torch.autograd.Function):
    """The render kernel behind autograd: forward launches
    ``nerf_render_fwd`` (``nerf_render_fwd_rays`` on per-ray depths);
    backward launches ``nerf_render_bwd`` (``nerf_render_bwd_rays``) with
    the colour cotangent (the counterpart of ``pallas_utils.render_vjp``).
    Rays, depths and config get no gradient."""

    @staticmethod
    def forward(ctx, origins, directions, t_vals, dists, config, width, *wb):
        params = _params_of(wb)
        pk = pack_params(params, t_vals, dists, width)
        ctx.save_for_backward(pk, origins, directions, t_vals, dists, *wb)
        ctx.config, ctx.width = config, width
        return _launch(pk, t_vals, dists, origins, directions, config, len(wb) // 2,
                       width)

    @staticmethod
    @spanned("lomanerf.fused_nerf.backward")
    def backward(ctx, grad_out):
        pk, origins, directions, t_vals, dists, *wb = ctx.saved_tensors
        params = _params_of(wb)
        G = grad_floats(params, ctx.width)
        out = _launch_grad("nerf_render_bwd", pk, G, t_vals, dists, origins,
                           directions, _f32(grad_out), ctx.config, len(wb) // 2,
                           ctx.width)
        return (None,) * 6 + unpack_grads(out[:G], params, ctx.width)


class _TrainLoss(torch.autograd.Function):
    """The train kernel behind autograd (the counterpart of
    ``pallas_utils.train_loss_vjp``): forward makes one ``nerf_train`` call
    (``nerf_train_rays`` on per-ray depths), which returns the loss and
    dW/db together, and keeps the gradients; backward scales them by the
    loss's cotangent."""

    @staticmethod
    def forward(ctx, origins, directions, t_vals, dists, target, config, width, *wb):
        params = _params_of(wb)
        pk = pack_params(params, t_vals, dists, width)
        G = grad_floats(params, width)
        out = _launch_grad("nerf_train", pk, G, t_vals, dists, origins, directions,
                           target, config, len(wb) // 2, width)
        ctx.save_for_backward(*unpack_grads(out[:G], params, width))
        return out[G]

    @staticmethod
    @spanned("lomanerf.fused_nerf.backward")
    def backward(ctx, g):
        return (None,) * 7 + tuple(g * x for x in ctx.saved_tensors)


# ---------------------------------------------------------------------------
# The wide kernels (padded width above 64)
# ---------------------------------------------------------------------------


@spanned("lomanerf.fused_nerf.pack")
def pack_wide_params(params: Params, pw: int, compute_dtype: str = "float32"):
    """The wide kernels' parameter stacks, on the params' device: ``W``
    (L, pw, pw) in the compute dtype, layer l's (in, out) weight
    zero-padded, and ``b`` (L, pw) in f32 (the counterpart of the JAX
    package's ``pallas_utils.stack_padded_params``; zero padding keeps the
    padded lanes inert)."""
    ws, bs = params["w"], params["b"]
    W = ws[0].new_zeros((len(ws), pw, pw), dtype=torch.float32)
    b = ws[0].new_zeros((len(ws), pw), dtype=torch.float32)
    for l, (w, bl) in enumerate(zip(ws, bs)):
        W[l, : w.shape[0], : w.shape[1]] = w.detach()
        b[l, : bl.shape[0]] = bl.detach()
    return W.to(_DTYPES[compute_dtype]).contiguous(), b.contiguous()


@spanned("lomanerf.fused_nerf.unpack")
def unpack_wide_grads(dW: torch.Tensor, db: torch.Tensor, params: Params):
    """(L, pw, pw) / (L, pw) gradient stacks back to the params' exact
    shapes: ``(dW_0.., db_0..)``."""
    ws, bs = params["w"], params["b"]
    return (*(dW[l, : w.shape[0], : w.shape[1]].to(w.dtype) for l, w in enumerate(ws)),
            *(db[l, : b.shape[0]].to(b.dtype) for l, b in enumerate(bs)))


def _itemsize(config) -> int:
    return 2 if getattr(config, "compute_dtype", "float32") == "bfloat16" else 4


def fused_mlp_takes(config, L: int, pw: int) -> bool:
    """Whether the bf16 render runs its MLP on the fused kernel
    (``csrc/nerf_wide_mlp.cuh``: bf16, pw 128 or 256, a hidden layer);
    else on the layer-by-layer chain, as ``nerf_wide_chain.cuh``'s
    ``fused_mlp_takes`` decides."""
    return _itemsize(config) == 2 and L >= 2 and pw <= WIDE_FUSED_MAX


def wide_chunk_rays(config, pw: int) -> int:
    """Rays per chunk of the wide render: one (rays x S, pw) activation
    buffer in the compute dtype within ``WIDE_BUFFER_BYTES`` (65,536 rays
    for the flagship).  The fused bf16 MLP's scratch is one such slot (its
    H_{L-1}, ``csrc/nerf_wide_mlp.cuh``); the layer GEMMs' is two
    (ping-pong buffers: f32, and bf16 where :func:`fused_mlp_takes` is
    false)."""
    return max(1, WIDE_BUFFER_BYTES // (config.num_samples * pw * _itemsize(config)))


def wide_grad_chunk_rays(config, pw: int, L: int) -> int:
    """Rays per chunk of a wide gradient call: L activation buffers in the
    compute dtype, two f32 d_z buffers (and, for bf16, their two bf16
    copies, which the dW stage reads) and the head's d_z within
    ``WIDE_GRAD_BYTES`` (18,682 rays for the flagship, 4,678 for an 8x1024
    bf16 MLP at S = 128).  For bf16 the budget still counts the two f32 d_z
    buffers' 8 bytes a sample-column, though the call allocates none (db's
    column partials that replace them, :func:`_launch_wide_grad`, take a
    128th of one at S = 128).  The dW stage's split-K partials (pw x pw
    floats per 8192 rows) lie outside it: pw / 2048 bytes a row against the
    activations' 10 pw or more, 310 MB at the 8x1024 chunk."""
    isz = _itemsize(config)
    per_ray = config.num_samples * (pw * (L * isz + 8 + (4 if isz == 2 else 0))
                                    + 4 * _HEAD)
    return max(1, WIDE_GRAD_BYTES // per_ray)


def render_chunk_rays(config, params: Params) -> int:
    """Default rays per ``render_rays`` call of a frame: one activation
    buffer of about ``WIDE_BUFFER_BYTES`` (the kernel's for a wide MLP, the
    plain version's f32 one for a narrow one), at most 2^20."""
    if config.view_branch:
        return paper_chunk_rays(config)
    kind, pw = _plan(config, params)
    if kind == "wide":
        return min(1 << 20, wide_chunk_rays(config, pw))
    ps = _padded_width(config, params)
    return min(1 << 20, WIDE_BUFFER_BYTES // (config.num_samples * _round_up(ps, 32) * 4))


def _wide_args(config, pw: int, L: int):
    """The ints every wide entry point takes after its pointers."""
    return (config.num_samples, L, pw, _round_up(config.in_channels, 8),
            config.num_encoding_functions, int(config.mode == "loma"),
            int(_itemsize(config) == 2))


def _launch_wide_render(W, b, t_vals, dists, origins, directions, config) -> torch.Tensor:
    """One call of ``nerf_wide_render_fwd`` (``nerf_wide_render_fwd_rays``
    for per-ray ``(N, S)`` depths), all chunks of the rays, with its
    scratch (:func:`wide_chunk_rays`); counted in ``launches``."""
    from lomanerf_tpu_torch.ops import build

    entry = "nerf_wide_render_fwd" + _suffix(t_vals)
    with span("lomanerf.fused_nerf.launch." + entry):
        L, pw = W.shape[0], W.shape[1]
        n = origins.shape[0]
        chunk = max(1, min(n, wide_chunk_rays(config, pw)))
        slots = 1 if fused_mlp_takes(config, L, pw) else 2
        acts = torch.empty(slots * chunk * config.num_samples * pw, dtype=W.dtype,
                           device=origins.device)
        out = torch.empty((n, 3), dtype=torch.float32, device=origins.device)
        stream = torch.cuda.current_stream(origins.device).cuda_stream
        err = getattr(build.load(), entry)(
            W.data_ptr(), b.data_ptr(), t_vals.data_ptr(), dists.data_ptr(),
            origins.data_ptr(), directions.data_ptr(), out.data_ptr(), acts.data_ptr(),
            n, chunk, *_wide_args(config, pw, L), stream)
        if err != 0:
            raise RuntimeError(f"{entry} launch failed: cudaError {err}")
        launches[entry] += 1
        return out


def _launch_wide_grad(entry: str, W, b, t_vals, dists, origins, directions, cot,
                      config):
    """One call of ``nerf_wide_train`` (cot: targets) or
    ``nerf_wide_render_bwd`` (cot: the colour cotangent), or of its
    ``*_rays`` instance for per-ray ``(N, S)`` depths, with its scratch;
    returns ``(loss (1,), dW (L, pw, pw), db (L, pw))``.  Counted in
    ``launches``."""
    from lomanerf_tpu_torch.ops import build

    entry += _suffix(t_vals)
    with span("lomanerf.fused_nerf.launch." + entry):
        L, pw = W.shape[0], W.shape[1]
        n, S, dev = origins.shape[0], config.num_samples, origins.device
        chunk = max(1, min(n, wide_grad_chunk_rays(config, pw, L)))
        rows = chunk * S
        n_parts = -(-rows // WIDE_ROW_CHUNK) * pw * pw

        def f32(*shape):
            return torch.empty(shape, dtype=torch.float32, device=dev)

        acts = torch.empty(L * rows * pw, dtype=W.dtype, device=dev)
        dz_head, partials = f32(rows * _HEAD), f32(n_parts)
        if W.dtype == torch.bfloat16:
            # d_z only as its rounded copies (the products' operand) and db's
            # column partials of the unrounded values: a row per ray or per
            # 128-row tile of d_z
            dz, dzb = None, torch.empty(2 * rows * pw, dtype=W.dtype, device=dev)
            n_db_part = max(chunk, -(-rows // TILE_ROWS)) * pw
            db_part = f32(n_db_part)
        else:
            dz, dzb, db_part, n_db_part = f32(2 * rows * pw), None, None, 0
        ray_loss, dW, db, loss = f32(max(n, 1)), f32(L, pw, pw), f32(L, pw), f32(1)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(build.load(), entry)(
            W.data_ptr(), b.data_ptr(), t_vals.data_ptr(), dists.data_ptr(),
            origins.data_ptr(), directions.data_ptr(), cot.data_ptr(), acts.data_ptr(),
            *(None if x is None else x.data_ptr() for x in (dz, dzb, db_part)), n_db_part,
            dz_head.data_ptr(), partials.data_ptr(), n_parts,
            ray_loss.data_ptr(), dW.data_ptr(), db.data_ptr(), loss.data_ptr(), n, chunk,
            *_wide_args(config, pw, L), stream)
        if err != 0:
            raise RuntimeError(f"{entry} launch failed: cudaError {err}")
        launches[entry] += 1
        return loss, dW, db


class _WideRender(torch.autograd.Function):
    """The wide render kernel behind autograd: forward launches
    ``nerf_wide_render_fwd``; backward launches ``nerf_wide_render_bwd``
    with the colour cotangent (their ``*_rays`` instances on per-ray
    depths).  Rays, depths and config get no gradient."""

    @staticmethod
    def forward(ctx, origins, directions, t_vals, dists, config, pw, *wb):
        W, b = pack_wide_params(_params_of(wb), pw, config.compute_dtype)
        ctx.save_for_backward(origins, directions, t_vals, dists, W, b, *wb)
        ctx.config = config
        return _launch_wide_render(W, b, t_vals, dists, origins, directions, config)

    @staticmethod
    @spanned("lomanerf.fused_nerf.backward")
    def backward(ctx, grad_out):
        origins, directions, t_vals, dists, W, b, *wb = ctx.saved_tensors
        _, dW, db = _launch_wide_grad("nerf_wide_render_bwd", W, b, t_vals, dists,
                                      origins, directions, _f32(grad_out), ctx.config)
        return (None,) * 6 + unpack_wide_grads(dW, db, _params_of(wb))


class _WideTrainLoss(torch.autograd.Function):
    """The wide train kernel behind autograd: forward makes one
    ``nerf_wide_train`` call (``nerf_wide_train_rays`` on per-ray depths),
    which returns the loss and dW/db together, and keeps the gradients;
    backward scales them by the loss's cotangent."""

    @staticmethod
    def forward(ctx, origins, directions, t_vals, dists, target, config, pw, *wb):
        params = _params_of(wb)
        W, b = pack_wide_params(params, pw, config.compute_dtype)
        loss, dW, db = _launch_wide_grad("nerf_wide_train", W, b, t_vals, dists,
                                         origins, directions, target, config)
        ctx.save_for_backward(*unpack_wide_grads(dW, db, params))
        return loss[0]

    @staticmethod
    @spanned("lomanerf.fused_nerf.backward")
    def backward(ctx, g):
        return (None,) * 7 + tuple(g * x for x in ctx.saved_tensors)


def _rnd(x: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """x rounded to the compute dtype, as f32."""
    return x if cdt == torch.float32 else x.to(cdt).to(torch.float32)


def _wide_plain_forward(ws, bs, origins, directions, t_vals, dists, config,
                        keep: bool = True):
    """The wide kernels' function in plain PyTorch, rounding plan included:
    the encoding, each weight, each stored activation and the rgba head
    output rounded to the compute dtype; products in f32 (TF32 off);
    compositing in f32.  Returns the ``(N, 3)`` colours and what the
    backward reads (every layer's input only with ``keep``)."""
    cdt = _DTYPES[config.compute_dtype]
    pts = origins[:, None, :] + directions[:, None, :] * t_vals[..., None]
    n, S = pts.shape[:2]
    h = _rnd(positional_encoding(pts, config.num_encoding_functions).reshape(n * S, -1),
             cdt)
    acts = [h.to(cdt)]  # each layer's input, stored in the compute dtype
    for w, b in zip(ws[:-1], bs[:-1]):
        h = _rnd(torch.relu(h @ _rnd(w, cdt) + b), cdt)
        acts = acts + [h.to(cdt)] if keep else []
    z = h @ _rnd(ws[-1][:, :_HEAD], cdt) + bs[-1][:_HEAD]
    rgba = _rnd(torch.cat([torch.sigmoid(z[:, :3]), torch.relu(z[:, 3:])], 1), cdt)
    rgb, sigma = rgba[:, :3].reshape(n, S, 3), rgba[:, 3].reshape(n, S)
    e = torch.exp(-sigma * dists)
    alpha, c = 1.0 - e, e + EPS
    P = torch.cumprod(c, dim=-1)
    T = torch.cat([torch.ones_like(P[:, :1]),
                   P[:, 1:] if config.mode == "loma" else P[:, :-1]], dim=-1)
    w = alpha * T
    col = torch.sum(w[..., None] * rgb, dim=1)
    return col, (*acts, rgb, sigma, alpha, c, P, T, w)


def _wide_plain_backward(ws, bs, saved, dcol, dists, config):
    """The adjoint of :func:`_wide_plain_forward` as the TPU kernel's
    ``_bwd_from_dcol`` computes it (:func:`_wide_plain_dzs`): dW from each
    d_z rounded to the compute dtype, db from the unrounded d_z."""
    L = len(ws)
    acts = saved[:L]
    gws, gbs = [torch.zeros_like(x) for x in ws], [torch.zeros_like(x) for x in bs]
    for l, dz, dzc in _wide_plain_dzs(ws, saved, dcol, dists, config):
        gws[l][:, : dz.shape[1]] = acts[l].to(torch.float32).T @ dzc
        gbs[l][: dz.shape[1]] = dz.sum(0)
    return gws, gbs


def _wide_plain_dzs(ws, saved, dcol, dists, config):
    """``(l, d_z, rnd(d_z))`` of each layer l from the head down, the
    unrounded d_z in f32: ``d_c = suffix_sum / c`` with P kept per sample,
    sigmoid' from the rounded rgb, each d_z rounded to the compute dtype
    before both of its products, the ReLU mask from the stored activation."""
    cdt = _DTYPES[config.compute_dtype]
    L = len(ws)
    acts, (rgb, sigma, alpha, c, P, T, w) = saved[:L], saved[L:]
    d_w = torch.sum(dcol[:, None, :] * rgb, dim=-1)
    d_T = d_w * alpha
    if config.mode == "loma":
        d_P = torch.cat([torch.zeros_like(d_T[:, :1]), d_T[:, 1:]], dim=-1)
    else:
        d_P = torch.cat([d_T[:, 1:], torch.zeros_like(d_T[:, :1])], dim=-1)
    suf = torch.flip(torch.cumsum(torch.flip(d_P * P, [-1]), dim=-1), [-1])
    d_sigma = (d_w * T - suf / c) * dists * (1.0 - alpha)
    dz = torch.cat([dcol[:, None, :] * w[..., None] * rgb * (1.0 - rgb),
                    torch.where(sigma > 0, d_sigma, 0.0)[..., None]], dim=-1)
    dz = dz.reshape(-1, _HEAD)
    for l in range(L - 1, -1, -1):
        dzc = _rnd(dz, cdt)
        yield l, dz, dzc
        if l > 0:
            dz = (dzc @ _rnd(ws[l][:, : dz.shape[1]], cdt).T) * (acts[l] > 0)


class _WidePlain(torch.autograd.Function):
    """Plain version of the wide kernels under autograd: forward
    :func:`_wide_plain_forward`, backward :func:`_wide_plain_backward`."""

    @staticmethod
    def forward(ctx, origins, directions, t_vals, dists, config, *wb):
        L = len(wb) // 2
        col, saved = _wide_plain_forward(wb[:L], wb[L:], origins, directions,
                                         t_vals, dists, config)
        ctx.save_for_backward(dists, *wb, *saved)
        ctx.config, ctx.L = config, L
        return col

    @staticmethod
    @spanned("lomanerf.fused_nerf.backward")
    def backward(ctx, dcol):
        dists, *rest = ctx.saved_tensors
        L = ctx.L
        gws, gbs = _wide_plain_backward(rest[:L], rest[L:2 * L], rest[2 * L:],
                                        dcol.to(torch.float32), dists, ctx.config)
        return (None,) * 5 + (*gws, *gbs)


@spanned("lomanerf.fused_nerf.render_rays")
def render_rays(params: Params, origins, directions, t_vals, dists, config) -> torch.Tensor:
    """Fused render of ``(N, 3)`` rays to ``(N, 3)`` colours, with the JAX
    signature: depths and steps ``(S,)`` shared by every ray or per-ray
    ``(N, S)`` (the stratified sampler's), each on its own kernel instance.
    Differentiable w.r.t. params only."""
    origins, directions, t_vals, dists = (
        x.detach() for x in (origins, directions, t_vals, dists))
    if origins.device.type == "cpu":
        return render_rays_reference(params, origins, directions, t_vals, dists, config)
    if origins.device.type != "cuda":
        raise NotImplementedError(f"no render for device {origins.device}")
    _check_cuda_inputs(origins, directions, t_vals, dists, config, params)
    kind, width = _route(config, params)
    fn = _WideRender if kind == "wide" else _RenderFwd
    return fn.apply(_f32(origins), _f32(directions), _f32(t_vals), _f32(dists),
                    config, width, *params["w"], *params["b"])


def render_rays_reference(params: Params, origins, directions, t_vals, dists,
                          config) -> torch.Tensor:
    """Plain PyTorch version of :func:`render_rays`: for an MLP the kernels
    run wide (:func:`_plan`) the wide kernels' function with their rounding
    plan (:class:`_WidePlain`), else the core pipeline in f32.  Takes
    ``(S,)`` or per-ray ``(N, S)`` depths."""
    if _plan(config, params)[0] == "wide":
        if not torch.is_grad_enabled():  # nothing to save for a backward
            return _wide_plain_forward(params["w"], params["b"], origins, directions,
                                       t_vals, dists, config, keep=False)[0]
        return _WidePlain.apply(
            origins.detach(), directions.detach(), t_vals.detach(), dists.detach(),
            config, *params["w"], *params["b"])
    return nerf_render_rays(
        params, origins.detach(), directions.detach(), t_vals.detach(),
        dists.detach(), num_functions=config.num_encoding_functions,
        mode=config.mode,
    )


@spanned("lomanerf.fused_nerf.train_loss")
def nerf_train_loss(params: Params, origins, directions, t_vals, dists, target,
                    config) -> torch.Tensor:
    """Sum-MSE train loss whose gradient comes from one call of a fused
    train kernel (narrow or wide, by :func:`_route`), with the JAX
    signature: a 0-d tensor, differentiable w.r.t. params only (the ray
    inputs are detached; their gradients are ``None``).
    ``n_rays`` is the rays' count at run time: nothing is fixed when the
    kernels are built.  On CPU tensors, the plain version
    (:func:`nerf_train_loss_reference`)."""
    origins, directions, t_vals, dists, target = (
        x.detach() for x in (origins, directions, t_vals, dists, target))
    if origins.device.type == "cpu":
        return nerf_train_loss_reference(params, origins, directions, t_vals,
                                         dists, target, config)
    if origins.device.type != "cuda":
        raise NotImplementedError(f"no train loss for device {origins.device}")
    _check_cuda_inputs(origins, directions, t_vals, dists, config, params, target)
    kind, width = _route(config, params)
    fn = _WideTrainLoss if kind == "wide" else _TrainLoss
    return fn.apply(_f32(origins), _f32(directions), _f32(t_vals), _f32(dists),
                    _f32(target), config, width, *params["w"], *params["b"])


def nerf_train_loss_reference(params: Params, origins, directions, t_vals, dists,
                              target, config) -> torch.Tensor:
    """Plain PyTorch version of :func:`nerf_train_loss`: the sum-MSE of the
    plain render, under autograd."""
    return sum_mse(render_rays_reference(params, origins, directions, t_vals,
                                         dists, config), target.detach())


def nerf_loss(params: Params, origins, directions, t_vals, dists, target,
              config) -> torch.Tensor:
    """Sum-MSE of :func:`render_rays` (its backward is the render backward
    kernel on CUDA tensors)."""
    return sum_mse(render_rays(params, origins, directions, t_vals, dists, config),
                   target)


# ---------------------------------------------------------------------------
# The published NeRF (NeRFConfig.paper(): csrc/nerf_paper.cu)
# ---------------------------------------------------------------------------

PAPER_LD = 320  # row stride of the sequence's activation and d_z buffers
# the packed layers (nerf_paper.cu): the trunk's 8, F ([feature | sigma]),
# the view layer and the rgb head; stored rows, columns and bias length
PAPER_ROWS = (64, 256, 256, 256, 256, 320, 256, 256, 256, 296, 128)
PAPER_COLS = (256,) * 8 + (264, 128, 4)
PAPER_BIAS = (256,) * 8 + (264, 128, 8)
PAPER_SIG_COL = 256  # sigma's column in F
PAPER_DIR_ROW = 264  # the direction encoding's first row in the view layer
PAPER_DB_LD = 136  # floats of a ray's column partials (the view layer's, sigma's)
# (rows, PAPER_LD) bf16 activation buffers a call (nerf_paper.cu: acts_of);
# a train call also keeps two d_z buffers of that shape
_PAPER_SLOTS = {"render": 5, "train": 10}


def paper_nets(params: Params):
    """``(coarse, fine)``: the model's 24 leaves as two networks of 12."""
    h = len(params["w"]) // 2
    return ({"w": params["w"][:h], "b": params["b"][:h]},
            {"w": params["w"][h:], "b": params["b"][h:]})


def _paper_offsets(sizes):
    offs, at = [], 0
    for n in sizes:
        offs.append(at)
        at += n
    return offs, at


_PAPER_W_OFF, _PAPER_W_LEN = _paper_offsets([r * c for r, c in zip(PAPER_ROWS, PAPER_COLS)])
_PAPER_B_OFF, _PAPER_B_LEN = _paper_offsets(PAPER_BIAS)


def _paper_leaf_slots(config):
    """For each of a network's 12 leaves (weights, then biases), where it lies
    in the packed layout: ``(layer, row blocks, columns)``, a row block being
    ``(packed first row, leaf first row, rows)``.  The skip layer's leaf is
    ``[gamma(x) rows | h_5 rows]`` (NeRF's order) and is packed ``[h_5 |
    gamma(x)]``; F holds the feature (columns 0-255) and sigma (256); the
    view layer's feature rows and direction rows sit apart."""
    width, in_x, in_d = config.filter_size, config.in_channels, config.dir_channels
    trunk = config.num_layers
    w = []
    for i in range(trunk):
        if i == config.skip_layer:
            w.append((i, [(0, in_x, width), (width, 0, in_x)], (0, width)))
        else:
            w.append((i, [(0, 0, in_x if i == 0 else width)], (0, width)))
    w += [(trunk, [(0, 0, width)], (PAPER_SIG_COL, PAPER_SIG_COL + 1)),
          (trunk, [(0, 0, width)], (0, width)),
          (trunk + 1, [(0, 0, width), (PAPER_DIR_ROW, width, in_d)], (0, config.view_width)),
          (trunk + 2, [(0, 0, config.view_width)], (0, 3))]
    b = [(i, c) for i, _, c in w]
    return w, b


def _check_paper(config, net: Params) -> None:
    """The kernels take the published widths only (``ValueError``
    otherwise): the plain version takes any."""
    want = _paper_sizes(config)
    got = tuple(tuple(x.shape) for x in net["w"])
    if (config.filter_size, config.view_width, config.num_layers, config.skip_layer,
            config.num_encoding_functions, config.dir_encoding_functions) != \
            (256, 128, 8, 5, 10, 4) or got != want:
        raise ValueError(f"nerf_paper kernels take NeRFConfig.paper()'s widths; got leaves "
                         f"{got} of {config}")


@functools.lru_cache(maxsize=None)
def _paper_sizes(config):
    """One network's 12 ``(fan_in, fan_out)`` (``config.leaf_sizes()``'s first
    half), worked out once per config."""
    return tuple(config.leaf_sizes()[:12])


@functools.lru_cache(maxsize=None)
def _paper_index(config, device):
    """The flat positions in the packed layout (``W`` then ``b``, one f32
    buffer) of every entry of the network's 12 weight leaves (in order,
    each row-major), then of its 12 biases, as int64 on ``device``; and the
    weights' and the biases' own positions apart, ``(packed, w_pos,
    b_pos)``.  Made once per config and device."""
    slots_w, slots_b = _paper_leaf_slots(config)
    w_pos = torch.cat([
        (_PAPER_W_OFF[layer] + PAPER_COLS[layer]
         * torch.arange(r_pack, r_pack + n)[:, None] + torch.arange(c0, c1)).reshape(-1)
        for layer, blocks, (c0, c1) in slots_w
        for r_pack, _, n in sorted(blocks, key=lambda blk: blk[1])])
    b_pos = torch.cat([_PAPER_B_OFF[layer] + torch.arange(c0, c1) for layer, (c0, c1) in slots_b])
    return tuple(x.to(device) for x in (torch.cat([w_pos, _PAPER_W_LEN + b_pos]), w_pos, b_pos))


@spanned("lomanerf.fused_nerf.pack")
def pack_paper_params(net: Params, config):
    """One network's packed parameters on its device (``nerf_paper.cu``): the
    eleven layers' weights, each zero-padded to ``(PAPER_ROWS[l],
    PAPER_COLS[l])``, flat in bf16, and their biases, each padded to
    ``PAPER_BIAS[l]``, flat in f32; one scatter of every leaf into one f32
    buffer (:func:`_paper_index`), then the weights' part rounded."""
    ws, bs = net["w"], net["b"]
    packed = _paper_index(config, ws[0].device)[0]
    flat = ws[0].new_zeros((_PAPER_W_LEN + _PAPER_B_LEN,), dtype=torch.float32)
    flat[packed] = torch.cat([x.detach().reshape(-1) for x in [*ws, *bs]]).to(torch.float32)
    return flat[:_PAPER_W_LEN].to(torch.bfloat16), flat[_PAPER_W_LEN:]


@spanned("lomanerf.fused_nerf.unpack")
def unpack_paper_grads(dW: torch.Tensor, db: torch.Tensor, net: Params, config):
    """The packed f32 gradients back to the network's 12 leaves, one gather
    each: ``(dW_0.., db_0..)`` in the leaves' shapes and dtypes."""
    return _unpack_paper(dW, db, [(x.shape, x.dtype) for x in [*net["w"], *net["b"]]],
                         config)


def _unpack_paper(dW, db, leaves, config):
    """:func:`unpack_paper_grads` from the leaves' ``(shape, dtype)``."""
    _, w_pos, b_pos = _paper_index(config, dW.device)
    out = []
    for flat, pos, part in ((dW, w_pos, leaves[:12]), (db, b_pos, leaves[12:])):
        grads = torch.split(flat[pos], [math.prod(shape) for shape, _ in part])
        out += [g.view(shape).to(dtype) for g, (shape, dtype) in zip(grads, part)]
    return tuple(out)


def paper_chunk_rays(config) -> int:
    """Rays per chunk of a render of the published NeRF: the fine pass's
    five ``(rays x S, PAPER_LD)`` bf16 buffers within twice
    ``WIDE_BUFFER_BYTES`` (13,981 rays at 64 + 128 samples)."""
    rows = config.num_samples + config.num_fine_samples
    return max(1, 2 * WIDE_BUFFER_BYTES // (rows * PAPER_LD * 2 * _PAPER_SLOTS["render"]))


def paper_grad_chunk_rays(S: int) -> int:
    """Rays per chunk of a ``nerf_paper_train`` call at S samples: its
    twelve ``(rows, PAPER_LD)`` bf16 buffers and the head's f32 d_z within
    ``WIDE_GRAD_BYTES`` (10,836 rays at S = 192)."""
    return max(1, WIDE_GRAD_BYTES // (S * (PAPER_LD * 2 * (_PAPER_SLOTS["train"] + 2)
                                           + 4 * _HEAD)))


def _paper_rays(t_vals, dists, n):
    """Per-ray ``(N, S)`` f32 depths and steps (shared ones broadcast)."""
    s = t_vals.shape[-1]
    return (_f32(t_vals.expand(n, s)), _f32(dists.expand(n, s)))


def _launch_paper_render(W, b, t_vals, dists, origins, directions, want_weights):
    """One ``nerf_paper_render`` call on ``(N, S)`` depths: ``(colours,
    weights or None)``; counted in ``launches``."""
    from lomanerf_tpu_torch.ops import build

    with span("lomanerf.fused_nerf.launch.nerf_paper_render"):
        n, S = t_vals.shape
        dev = origins.device
        acts = torch.empty(_PAPER_SLOTS["render"] * n * S * PAPER_LD, dtype=torch.bfloat16,
                           device=dev)
        out = torch.empty((n, 3), dtype=torch.float32, device=dev)
        weights = torch.empty((n, S), dtype=torch.float32, device=dev) if want_weights \
            else None
        err = build.load().nerf_paper_render(
            W.data_ptr(), b.data_ptr(), t_vals.data_ptr(), dists.data_ptr(),
            origins.data_ptr(), directions.data_ptr(), out.data_ptr(),
            None if weights is None else weights.data_ptr(), acts.data_ptr(), n, S,
            torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"nerf_paper_render launch failed: cudaError {err}")
        launches["nerf_paper_render"] += 1
        return out, weights


def _launch_paper_train(W, b, t_vals, dists, origins, directions, target, want_weights):
    """One ``nerf_paper_train`` call on ``(N, S)`` depths, all chunks of the
    rays, with its scratch: ``(loss (1,), dW, db, weights or None)``;
    counted in ``launches``."""
    from lomanerf_tpu_torch.ops import build

    with span("lomanerf.fused_nerf.launch.nerf_paper_train"):
        n, S = t_vals.shape
        dev = origins.device
        chunk = max(1, min(n, paper_grad_chunk_rays(S)))
        rows = chunk * S

        def f32(*shape):
            return torch.empty(shape, dtype=torch.float32, device=dev)

        acts = torch.empty(_PAPER_SLOTS["train"] * rows * PAPER_LD, dtype=torch.bfloat16,
                           device=dev)
        dz = torch.empty(2 * rows * PAPER_LD, dtype=torch.bfloat16, device=dev)
        n_parts = -(-rows // WIDE_ROW_CHUNK) * PAPER_ROWS[5] * PAPER_COLS[5]
        dz_head, db_part = f32(rows * _HEAD), f32(chunk * PAPER_DB_LD)
        tile_part, partials = f32(-(-rows // TILE_ROWS) * PAPER_COLS[0]), f32(n_parts)
        ray_loss, dW, db, loss = f32(n), f32(_PAPER_W_LEN), f32(_PAPER_B_LEN), f32(1)
        weights = f32(n, S) if want_weights else None
        err = build.load().nerf_paper_train(
            W.data_ptr(), b.data_ptr(), t_vals.data_ptr(), dists.data_ptr(),
            origins.data_ptr(), directions.data_ptr(), target.data_ptr(),
            None if weights is None else weights.data_ptr(), acts.data_ptr(), dz.data_ptr(),
            dz_head.data_ptr(), db_part.data_ptr(), tile_part.data_ptr(), partials.data_ptr(),
            n_parts, ray_loss.data_ptr(), dW.data_ptr(), db.data_ptr(), loss.data_ptr(), n,
            chunk, S, torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"nerf_paper_train launch failed: cudaError {err}")
        launches["nerf_paper_train"] += 1
        return loss, dW, db, weights


class _PaperTrainLoss(torch.autograd.Function):
    """``nerf_paper_train`` behind autograd: forward makes one call, which
    returns the loss, every gradient of the network (packed) and (for the
    coarse pass) the compositing weights, and keeps the packed gradients;
    backward scales them by the loss's cotangent and unpacks them (two
    products and two gathers, not one product a leaf).  The weights carry
    no gradient."""

    @staticmethod
    def forward(ctx, origins, directions, t_vals, dists, target, config, want_weights, *wb):
        net = _params_of(wb)
        W, b = pack_paper_params(net, config)
        loss, dW, db, weights = _launch_paper_train(W, b, t_vals, dists, origins, directions,
                                                    target, want_weights)
        ctx.save_for_backward(dW, db)
        ctx.config, ctx.leaves = config, [(x.shape, x.dtype) for x in wb]
        if weights is None:
            weights = loss.new_zeros((0,))
        ctx.mark_non_differentiable(weights)
        return loss[0], weights

    @staticmethod
    @spanned("lomanerf.fused_nerf.backward")
    def backward(ctx, g, _g_weights):
        dW, db = ctx.saved_tensors
        with span("lomanerf.fused_nerf.unpack"):
            return (None,) * 7 + _unpack_paper(dW * g, db * g, ctx.leaves, ctx.config)


def _paper_rnd(config):
    cdt = _DTYPES[config.compute_dtype]
    return lambda x: _rnd(x, cdt) if x.dtype == torch.float32 else x


def paper_reference(net: Params, origins, directions, t_vals, dists, config):
    """Plain PyTorch version of one pass of the published NeRF:
    ``core.pipeline.paper_render_rays`` with the kernels' rounding plan
    (every weight and stored value rounded to the compute dtype, f32 values
    only), under autograd: ``(colours, weights)``."""
    from lomanerf_tpu_torch.core.pipeline import paper_render_rays

    return paper_render_rays(net, origins.detach(), directions.detach(), t_vals.detach(),
                             dists.detach(), config.num_encoding_functions,
                             config.dir_encoding_functions, config.skip_layer,
                             _paper_rnd(config))


@spanned("lomanerf.fused_nerf.train_loss")
def paper_train_loss(net: Params, origins, directions, t_vals, dists, target, config,
                     weights: bool = False):
    """One pass of the published NeRF's train loss, one network ``net``:
    ``(sum-MSE, compositing weights (N, S) or None)``, the loss
    differentiable w.r.t. the network's leaves only, the weights detached.
    Depths ``(S,)`` or per-ray ``(N, S)``.  On CUDA tensors one
    ``nerf_paper_train`` call gives the loss and its gradients; on CPU
    tensors, the plain version (:func:`paper_reference`)."""
    origins, directions, t_vals, dists, target = (
        x.detach() for x in (origins, directions, t_vals, dists, target))
    if origins.device.type == "cpu":
        col, w = paper_reference(net, origins, directions, t_vals, dists, config)
        return sum_mse(col, target), (w.detach() if weights else None)
    if origins.device.type != "cuda":
        raise NotImplementedError(f"no train loss for device {origins.device}")
    _check_paper(config, net)
    n = origins.shape[0]
    t, d = _paper_rays(t_vals, dists, n)
    loss, w = _PaperTrainLoss.apply(_f32(origins), _f32(directions), t, d, _f32(target),
                                    config, weights, *net["w"], *net["b"])
    return loss, (w if weights else None)


@spanned("lomanerf.fused_nerf.render_rays")
def paper_render(net: Params, origins, directions, t_vals, dists, config,
                 weights: bool = False):
    """One pass of the published NeRF's render, one network ``net``:
    ``(colours (N, 3), compositing weights (N, S) or None)``, no gradient.
    On CUDA tensors one ``nerf_paper_render`` call; on CPU tensors the plain
    version."""
    origins, directions, t_vals, dists = (
        x.detach() for x in (origins, directions, t_vals, dists))
    if origins.device.type == "cpu":
        with torch.no_grad():
            col, w = paper_reference(net, origins, directions, t_vals, dists, config)
        return col, (w if weights else None)
    if origins.device.type != "cuda":
        raise NotImplementedError(f"no render for device {origins.device}")
    _check_paper(config, net)
    W, b = pack_paper_params(net, config)
    t, d = _paper_rays(t_vals, dists, origins.shape[0])
    return _launch_paper_render(W, b, t, d, _f32(origins), _f32(directions), weights)
