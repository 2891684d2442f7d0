"""Radiance-field render pipelines and losses in plain PyTorch (port of
``lomanerf_tpu.core.pipeline``): the port's semantic oracle."""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from lomanerf_tpu_torch.core.composite import accumulate_color, render_weights
from lomanerf_tpu_torch.core.encoding import positional_encoding
from lomanerf_tpu_torch.core.losses import sum_mse
from lomanerf_tpu_torch.core.mlp import Params, mlp_apply


def image_fit_pred(params: Params, coords_encoded: torch.Tensor) -> torch.Tensor:
    """MLP prediction for the 2D image fit (sigmoid head on all channels)."""
    return mlp_apply(params, coords_encoded, head="sigmoid")


def image_fit_loss(params: Params, coords_encoded: torch.Tensor,
                   target: torch.Tensor) -> torch.Tensor:
    """Sum-MSE of the sigmoid MLP against target pixels."""
    return sum_mse(image_fit_pred(params, coords_encoded), target)


def nerf_render(
    params: Params,
    points_encoded: torch.Tensor,
    dists: torch.Tensor,
    mode: str = "loma",
) -> torch.Tensor:
    """MLP -> rgba -> compositing: ``(N, S, F)`` encoded points and
    ``(N, S)`` (or broadcastable ``(S,)``) dists to ``(N, 3)`` colours."""
    n, s, f = points_encoded.shape
    rgba = mlp_apply(params, points_encoded.reshape(n * s, f), head="rgba")
    rgba = rgba.reshape(n, s, -1)
    weights = render_weights(rgba[..., 3], dists, mode=mode)
    return accumulate_color(weights, rgba[..., :3])


def nerf_render_rays(
    params: Params,
    origins: torch.Tensor,
    directions: torch.Tensor,
    t_vals: torch.Tensor,
    dists: torch.Tensor,
    num_functions: int = 5,
    mode: str = "loma",
) -> torch.Tensor:
    """Render straight from ``(N, 3)`` rays and ``(S,)`` or ``(N, S)``
    depths: sample points, encode, :func:`nerf_render`."""
    points = origins[:, None, :] + directions[:, None, :] * t_vals[..., None]
    enc = positional_encoding(points, num_functions=num_functions)
    return nerf_render(params, enc, dists, mode=mode)


def nerf_loss(
    params: Params,
    points_encoded: torch.Tensor,
    dists: torch.Tensor,
    target: torch.Tensor,
    mode: str = "loma",
) -> torch.Tensor:
    """Sum-MSE of :func:`nerf_render` against ``(N, 3)`` targets."""
    return sum_mse(nerf_render(params, points_encoded, dists, mode=mode), target)


def nerf_loss_rays(
    params: Params,
    origins: torch.Tensor,
    directions: torch.Tensor,
    t_vals: torch.Tensor,
    dists: torch.Tensor,
    target: torch.Tensor,
    num_functions: int = 5,
    mode: str = "loma",
) -> torch.Tensor:
    """Sum-MSE of :func:`nerf_render_rays` against ``(N, 3)`` targets."""
    pred = nerf_render_rays(params, origins, directions, t_vals, dists,
                            num_functions, mode)
    return sum_mse(pred, target)


def seeded_value_and_grad(
    loss_fn: Callable[..., torch.Tensor],
) -> Callable[..., Tuple[torch.Tensor, Params]]:
    """Value and gradient w.r.t. arg 0 with an explicit adjoint seed.

    The returned function takes ``(params, *args, seed=...)`` and returns
    ``(loss, grads)`` with ``grads = seed * dloss/dparams`` in the params'
    ``{"w": [...], "b": [...]}`` layout, through
    ``torch.autograd.grad(loss, leaves, grad_outputs=seed)``.  ``seed``
    defaults to 1; the previous step's loss reproduces the reference's
    ``_dreturn = losses[-1]`` convention.  The params are not modified."""

    def wrapped(params: Params, *args, seed: Optional[torch.Tensor] = None):
        leaves = [p.detach().requires_grad_(True) for p in [*params["w"], *params["b"]]]
        L = len(params["w"])
        loss = loss_fn({"w": leaves[:L], "b": leaves[L:]}, *args)
        s = torch.as_tensor(1.0 if seed is None else seed, dtype=loss.dtype,
                            device=loss.device)
        grads = torch.autograd.grad(loss, leaves, grad_outputs=s)
        return loss.detach(), {"w": list(grads[:L]), "b": list(grads[L:])}

    return wrapped
