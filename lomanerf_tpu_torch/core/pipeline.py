"""Radiance-field render pipelines in plain PyTorch (port of the forward half
of ``lomanerf_tpu.core.pipeline``): the port's semantic oracle."""

from __future__ import annotations

import torch

from lomanerf_tpu_torch.core.composite import accumulate_color, render_weights
from lomanerf_tpu_torch.core.encoding import positional_encoding
from lomanerf_tpu_torch.core.mlp import Params, mlp_apply


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
