"""Fused NeRF render and train loss (port of ``lomanerf_tpu.ops.fused_nerf``).

Three hand-written CUDA kernels, each the Hopper counterpart of a TPU kernel:

* ``csrc/nerf_render_fwd.cu`` — ``_nerf_forward_kernel_S``: :func:`render_rays`;
* ``csrc/nerf_render_bwd.cu`` — ``_nerf_backward_kernel_S``: the backward of
  :func:`render_rays` (``_RenderFwd.backward``);
* ``csrc/nerf_train.cu`` — ``_nerf_train_kernel_S``: :func:`nerf_train_loss`,
  the loss and its parameter gradients in one call.

On CUDA tensors each function launches its kernel or raises; on CPU tensors
it runs the plain PyTorch version (:func:`render_rays_reference` under
autograd).  No case falls back quietly from one to the other.

Like the JAX package, the render and the losses differentiate params only:
the ray inputs are detached, so their gradients come back ``None``.
"""

from __future__ import annotations

import torch

from lomanerf_tpu_torch.core.losses import sum_mse
from lomanerf_tpu_torch.core.mlp import Params
from lomanerf_tpu_torch.core.pipeline import nerf_render_rays

# kernel launches per C entry point; a run resets them and reads them to
# show that its render and train steps went through the kernels
launches = {"nerf_render_fwd": 0, "nerf_render_bwd": 0, "nerf_train": 0}

MAX_WIDTH = 64  # widest hidden layer the kernels' register arrays take
_HEAD = 4  # rgba channels the render reads
_SMEM_LIMIT = 227 * 1024  # dynamic shared memory one Hopper block can use
GRAD_THREADS = 64  # rays per block of the gradient kernels (nerf_grad.cuh)
_STRIDE = GRAD_THREADS + 1  # their staging row stride


def _kernel_width(config, params: Params) -> int:
    """Padded activation width (32 or 64) after checking that the kernels
    take this case; raises for the cases they do not."""
    if getattr(config, "compute_dtype", "float32") == "bfloat16":
        raise NotImplementedError(
            "compute_dtype='bfloat16' has no CUDA kernel yet "
            "(ROADMAP queue 2, C1/C2: the bf16 wide path)")
    ws = params["w"]
    hidden = [w.shape[1] for w in ws[:-1]]
    if max(hidden, default=0) > MAX_WIDTH:
        raise NotImplementedError(
            f"layer width {max(hidden)} > {MAX_WIDTH} has no CUDA kernel "
            "yet (ROADMAP queue 2, C1/C2: the wide train step and render)")
    in_dim = 3 * (1 + 2 * config.num_encoding_functions)
    if ws[0].shape[0] != in_dim:
        raise ValueError(f"first layer takes {ws[0].shape[0]} inputs, the "
                         f"n={config.num_encoding_functions} encoding gives {in_dim}")
    if ws[-1].shape[1] < _HEAD:
        raise ValueError("render needs an rgba head (>= 4 output channels)")
    return 32 if max(hidden, default=0) <= 32 else 64


def _blocks(params: Params, width: int):
    """(rows, cols) of each layer's padded block in the packed layout."""
    L = len(params["w"])
    return [(w.shape[0] if l == 0 else width, _HEAD if l == L - 1 else width)
            for l, w in enumerate(params["w"])]


def pack_params(params: Params, t_vals: torch.Tensor, dists: torch.Tensor,
                width: int) -> torch.Tensor:
    """The kernels' flat f32 buffer, on the params' device: per layer, W_l
    zero-padded to (rows_l, cols_l) then b_l padded to cols_l
    (rows_0 = in_dim, rows_l = width after; cols = width, 4 for the last
    layer), then t[0..S) and dists[0..S), padded to a multiple of 4 floats."""
    blocks = []
    for (rows, cols), w, b in zip(_blocks(params, width), params["w"], params["b"]):
        wp = w.new_zeros((rows, cols), dtype=torch.float32)
        wp[: w.shape[0], : min(w.shape[1], cols)] = w[:, :cols]
        bp = b.new_zeros((cols,), dtype=torch.float32)
        bp[: min(b.shape[0], cols)] = b[:cols]
        blocks += [wp.reshape(-1), bp]
    blocks += [t_vals.to(torch.float32), dists.to(torch.float32)]
    flat = torch.cat(blocks)
    return torch.nn.functional.pad(flat, (0, (-flat.numel()) % 4)).contiguous()


def grad_floats(params: Params, width: int) -> int:
    """G: the floats of the packed weights and biases (the gradient layout)."""
    return sum(rows * cols + cols for rows, cols in _blocks(params, width))


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
    ``nerf_grad.cuh:grad_smem_floats``)."""
    return 4 * (pk_floats + G + S * GRAD_THREADS
                + (in_dim + (L - 1) * width) * _STRIDE
                + ((L - 1) * width + _HEAD) * _STRIDE + GRAD_THREADS)


def _check_cuda_inputs(origins, directions, t_vals, dists, config, params, *extra):
    if t_vals.ndim != 1 or dists.ndim != 1:
        raise NotImplementedError(
            "per-ray (N, S) depths have no CUDA kernel yet "
            "(ROADMAP queue 2, B1/B2)")
    if t_vals.shape[0] != config.num_samples or dists.shape != t_vals.shape:
        raise ValueError(f"depths {tuple(t_vals.shape)}/{tuple(dists.shape)} do "
                         f"not match num_samples={config.num_samples}")
    n = origins.shape[0]
    for x in (origins, directions, *extra):
        if tuple(x.shape) != (n, 3):
            raise ValueError(f"ray input of shape {tuple(x.shape)}, expected ({n}, 3)")
    tensors = [origins, directions, t_vals, dists, *extra, *params["w"], *params["b"]]
    if any(x.device != origins.device for x in tensors):
        raise ValueError("rays, depths and params must share one CUDA device")


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).contiguous()


def _launch(pk, origins, directions, config, L, width) -> torch.Tensor:
    """One launch of the render forward; counted in ``launches``."""
    from lomanerf_tpu_torch.ops import build

    n = origins.shape[0]
    if pk.numel() * 4 > _SMEM_LIMIT:
        raise NotImplementedError(
            f"params need {pk.numel() * 4} B of shared memory, over the "
            f"{_SMEM_LIMIT} B a block has (streamed weights: a later PR)")
    out = torch.empty((n, 3), dtype=torch.float32, device=origins.device)
    stream = torch.cuda.current_stream(origins.device).cuda_stream
    err = build.load().nerf_render_fwd(
        pk.data_ptr(), pk.numel(), origins.data_ptr(), directions.data_ptr(),
        out.data_ptr(), n, config.num_samples, L, config.in_channels,
        config.num_encoding_functions, width, int(config.mode == "loma"), stream,
    )
    if err != 0:
        raise RuntimeError(f"nerf_render_fwd launch failed: cudaError {err}")
    launches["nerf_render_fwd"] += 1
    return out


def _launch_grad(entry: str, pk, G, origins, directions, cot, config, L,
                 width) -> torch.Tensor:
    """One call of a gradient kernel (``nerf_train`` or ``nerf_render_bwd``)
    and its fixed-order block sum: G gradient floats, then the loss.
    Counted in ``launches``."""
    from lomanerf_tpu_torch.ops import build

    n, S = origins.shape[0], config.num_samples
    smem = grad_smem_bytes(pk.numel(), G, S, L, config.in_channels, width)
    if smem > _SMEM_LIMIT:
        raise NotImplementedError(
            f"{entry} needs {smem} B of shared memory per block, over the "
            f"{_SMEM_LIMIT} B a block has (streamed weights: a later PR)")
    n_blocks = -(-n // GRAD_THREADS)
    partials = torch.empty((max(n_blocks, 1), G + 1), dtype=torch.float32,
                           device=origins.device)
    out = torch.empty((G + 1,), dtype=torch.float32, device=origins.device)
    stream = torch.cuda.current_stream(origins.device).cuda_stream
    err = getattr(build.load(), entry)(
        pk.data_ptr(), pk.numel(), G, origins.data_ptr(), directions.data_ptr(),
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
    ``nerf_render_fwd``; backward launches ``nerf_render_bwd`` with the
    colour cotangent (the counterpart of ``pallas_utils.render_vjp``).
    Rays, depths and config get no gradient."""

    @staticmethod
    def forward(ctx, origins, directions, t_vals, dists, config, width, *wb):
        params = _params_of(wb)
        pk = pack_params(params, t_vals, dists, width)
        ctx.save_for_backward(pk, origins, directions, *wb)
        ctx.config, ctx.width = config, width
        return _launch(pk, origins, directions, config, len(wb) // 2, width)

    @staticmethod
    def backward(ctx, grad_out):
        pk, origins, directions, *wb = ctx.saved_tensors
        params = _params_of(wb)
        G = grad_floats(params, ctx.width)
        out = _launch_grad("nerf_render_bwd", pk, G, origins, directions,
                           _f32(grad_out), ctx.config, len(wb) // 2, ctx.width)
        return (None,) * 6 + unpack_grads(out[:G], params, ctx.width)


class _TrainLoss(torch.autograd.Function):
    """The train kernel behind autograd (the counterpart of
    ``pallas_utils.train_loss_vjp``): forward makes one ``nerf_train`` call,
    which returns the loss and dW/db together, and keeps the gradients;
    backward scales them by the loss's cotangent."""

    @staticmethod
    def forward(ctx, origins, directions, t_vals, dists, target, config, width, *wb):
        params = _params_of(wb)
        pk = pack_params(params, t_vals, dists, width)
        G = grad_floats(params, width)
        out = _launch_grad("nerf_train", pk, G, origins, directions, target,
                           config, len(wb) // 2, width)
        ctx.save_for_backward(*unpack_grads(out[:G], params, width))
        return out[G]

    @staticmethod
    def backward(ctx, g):
        return (None,) * 7 + tuple(g * x for x in ctx.saved_tensors)


def render_rays(params: Params, origins, directions, t_vals, dists, config) -> torch.Tensor:
    """Fused render of ``(N, 3)`` rays at ``(S,)`` shared depths to ``(N, 3)``
    colours, with the JAX signature.  Differentiable w.r.t. params only."""
    origins, directions, t_vals, dists = (
        x.detach() for x in (origins, directions, t_vals, dists))
    if origins.device.type == "cpu":
        return render_rays_reference(params, origins, directions, t_vals, dists, config)
    if origins.device.type != "cuda":
        raise NotImplementedError(f"no render for device {origins.device}")
    _check_cuda_inputs(origins, directions, t_vals, dists, config, params)
    width = _kernel_width(config, params)
    return _RenderFwd.apply(_f32(origins), _f32(directions), t_vals, dists,
                            config, width, *params["w"], *params["b"])


def render_rays_reference(params: Params, origins, directions, t_vals, dists,
                          config) -> torch.Tensor:
    """Plain PyTorch version of :func:`render_rays` (the core pipeline).
    Takes ``(S,)`` or per-ray ``(N, S)`` depths."""
    return nerf_render_rays(
        params, origins.detach(), directions.detach(), t_vals.detach(),
        dists.detach(), num_functions=config.num_encoding_functions,
        mode=config.mode,
    )


def nerf_train_loss(params: Params, origins, directions, t_vals, dists, target,
                    config) -> torch.Tensor:
    """Sum-MSE train loss whose gradient comes from the single fused train
    kernel, with the JAX signature: a 0-d tensor, differentiable w.r.t.
    params only (the ray inputs are detached; their gradients are ``None``).
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
    width = _kernel_width(config, params)
    return _TrainLoss.apply(_f32(origins), _f32(directions), t_vals, dists,
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
