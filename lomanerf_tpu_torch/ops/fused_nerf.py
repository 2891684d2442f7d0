"""Fused NeRF render: (N, 3) colours from rays (port of
``lomanerf_tpu.ops.fused_nerf.render_rays``).

On CUDA tensors :func:`render_rays` launches the hand-written kernel
``csrc/nerf_render_fwd.cu`` (the Hopper counterpart of the TPU kernel
``_nerf_forward_kernel_S``) or raises; on CPU tensors it runs
:func:`render_rays_reference`, the plain PyTorch version of the same
function.  No case falls back quietly from one to the other.

Like the JAX package, the render differentiates params only: the ray inputs
are detached.  Backward through the kernel is not written yet and raises.
"""

from __future__ import annotations

import torch

from lomanerf_tpu_torch.core.mlp import Params
from lomanerf_tpu_torch.core.pipeline import nerf_render_rays

# kernel launches made by render_rays; a run resets it and reads it to show
# that its render went through the kernel
launches = 0

MAX_WIDTH = 64  # widest hidden layer the kernel's register arrays take
_HEAD = 4  # rgba channels the render reads
_SMEM_LIMIT = 227 * 1024  # dynamic shared memory one Hopper block can use


def _kernel_width(config, params: Params) -> int:
    """Padded activation width (32 or 64) after checking that the kernel
    takes this case; raises for the cases it does not."""
    if getattr(config, "compute_dtype", "float32") == "bfloat16":
        raise NotImplementedError(
            "compute_dtype='bfloat16' has no CUDA render kernel yet "
            "(ROADMAP queue 2, C1/C2: the bf16 wide path)")
    ws = params["w"]
    hidden = [w.shape[1] for w in ws[:-1]]
    if max(hidden, default=0) > MAX_WIDTH:
        raise NotImplementedError(
            f"layer width {max(hidden)} > {MAX_WIDTH} has no CUDA render kernel "
            "yet (ROADMAP queue 2, C2: the wide full() render)")
    in_dim = 3 * (1 + 2 * config.num_encoding_functions)
    if ws[0].shape[0] != in_dim:
        raise ValueError(f"first layer takes {ws[0].shape[0]} inputs, the "
                         f"n={config.num_encoding_functions} encoding gives {in_dim}")
    if ws[-1].shape[1] < _HEAD:
        raise ValueError("render needs an rgba head (>= 4 output channels)")
    return 32 if max(hidden, default=0) <= 32 else 64


def pack_params(params: Params, t_vals: torch.Tensor, dists: torch.Tensor,
                width: int) -> torch.Tensor:
    """The kernel's flat f32 buffer, on the params' device: per layer, W_l
    zero-padded to (rows_l, cols_l) then b_l padded to cols_l
    (rows_0 = in_dim, rows_l = width after; cols = width, 4 for the last
    layer), then t[0..S) and dists[0..S), padded to a multiple of 4 floats."""
    ws, bs = params["w"], params["b"]
    L = len(ws)
    blocks = []
    for l, (w, b) in enumerate(zip(ws, bs)):
        rows = w.shape[0] if l == 0 else width
        cols = _HEAD if l == L - 1 else width
        wp = w.new_zeros((rows, cols), dtype=torch.float32)
        wp[: w.shape[0], : min(w.shape[1], cols)] = w[:, :cols]
        bp = b.new_zeros((cols,), dtype=torch.float32)
        bp[: min(b.shape[0], cols)] = b[:cols]
        blocks += [wp.reshape(-1), bp]
    blocks += [t_vals.to(torch.float32), dists.to(torch.float32)]
    flat = torch.cat(blocks)
    return torch.nn.functional.pad(flat, (0, (-flat.numel()) % 4)).contiguous()


def _launch(pk, origins, directions, config, L, width) -> torch.Tensor:
    """One launch of the CUDA kernel; counts it in ``launches``."""
    global launches
    from lomanerf_tpu_torch.ops import build

    n = origins.shape[0]
    S = config.num_samples
    if pk.numel() * 4 > _SMEM_LIMIT:
        raise NotImplementedError(
            f"params need {pk.numel() * 4} B of shared memory, over the "
            f"{_SMEM_LIMIT} B a block has (streamed weights: a later PR)")
    out = torch.empty((n, 3), dtype=torch.float32, device=origins.device)
    stream = torch.cuda.current_stream(origins.device).cuda_stream
    err = build.load().nerf_render_fwd(
        pk.data_ptr(), pk.numel(), origins.data_ptr(), directions.data_ptr(),
        out.data_ptr(), n, S, L, config.in_channels,
        config.num_encoding_functions, width, int(config.mode == "loma"), stream,
    )
    if err != 0:
        raise RuntimeError(f"nerf_render_fwd launch failed: cudaError {err}")
    launches += 1
    return out


class _RenderFwd(torch.autograd.Function):
    """The kernel behind autograd: forward launches it; the backward
    (``_nerf_backward_kernel_S``'s port) is not written yet."""

    @staticmethod
    def forward(ctx, origins, directions, t_vals, dists, config, width, *wb):
        L = len(wb) // 2
        params = {"w": list(wb[:L]), "b": list(wb[L:])}
        pk = pack_params(params, t_vals, dists, width)
        return _launch(pk, origins, directions, config, L, width)

    @staticmethod
    def backward(ctx, grad_out):
        raise NotImplementedError(
            "the CUDA render kernel has no backward yet (ROADMAP queue 2, A2: "
            "_nerf_backward_kernel_S); differentiate on CPU tensors, which "
            "take the plain PyTorch render")


def render_rays(params: Params, origins, directions, t_vals, dists, config) -> torch.Tensor:
    """Fused render of ``(N, 3)`` rays at ``(S,)`` shared depths to ``(N, 3)``
    colours, with the JAX signature.  Differentiable w.r.t. params only."""
    origins, directions, t_vals, dists = (
        x.detach() for x in (origins, directions, t_vals, dists))
    if origins.device.type == "cpu":
        return render_rays_reference(params, origins, directions, t_vals, dists, config)
    if origins.device.type != "cuda":
        raise NotImplementedError(f"no render for device {origins.device}")
    if t_vals.ndim != 1 or dists.ndim != 1:
        raise NotImplementedError(
            "per-ray (N, S) depths have no CUDA render kernel yet "
            "(ROADMAP queue 2, B1/B2)")
    if t_vals.shape[0] != config.num_samples or dists.shape != t_vals.shape:
        raise ValueError(f"depths {tuple(t_vals.shape)}/{tuple(dists.shape)} do "
                         f"not match num_samples={config.num_samples}")
    tensors = [origins, directions, t_vals, dists, *params["w"], *params["b"]]
    if any(x.device != origins.device for x in tensors):
        raise ValueError("rays, depths and params must share one CUDA device")
    width = _kernel_width(config, params)
    origins = origins.to(torch.float32).contiguous()
    directions = directions.to(torch.float32).contiguous()
    return _RenderFwd.apply(origins, directions, t_vals, dists, config, width,
                            *params["w"], *params["b"])


def render_rays_reference(params: Params, origins, directions, t_vals, dists,
                          config) -> torch.Tensor:
    """Plain PyTorch version of :func:`render_rays` (the core pipeline).
    Takes ``(S,)`` or per-ray ``(N, S)`` depths."""
    return nerf_render_rays(
        params, origins.detach(), directions.detach(), t_vals.detach(),
        dists.detach(), num_functions=config.num_encoding_functions,
        mode=config.mode,
    )
