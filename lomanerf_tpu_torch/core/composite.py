"""Alpha compositing / volume-rendering weights (port of
``lomanerf_tpu.core.composite``).

* ``mode="loma"`` — the reference semantics:
      a[j] = 1 - exp(-sigma[j] * dist[j]);   c[j] = exp(-sigma[j] * dist[j]) + 1e-10
      T[0] = 1;  T[j] = prod_{k<=j} c[k] for j >= 1   (INCLUSIVE cumprod)
      w[j] = a[j] * T[j]
* ``mode="standard"`` — textbook exclusive transmittance T[j] = prod_{k<j} c[k].

``dists`` carries the 1e8 far-plane sentinel in its last entry.
"""

from __future__ import annotations

import torch

EPS = 1e-10


def render_weights(
    sigma: torch.Tensor, dists: torch.Tensor, mode: str = "loma"
) -> torch.Tensor:
    """Per-sample compositing weights; ``sigma`` is ``(..., S)``, ``dists``
    broadcasts against it."""
    # c = e + EPS, never the reference's literal ``1 - alpha + 1e-10``: a
    # compiler may reassociate that to (1 + 1e-10) - alpha and fold
    # 1 + 1e-10 == 1.0f, giving c == 0 (NaN adjoints) at saturated alpha.
    e = torch.exp(-sigma * dists)
    alpha = 1.0 - e
    c = e + EPS
    inclusive = torch.cumprod(c, dim=-1)
    ones = torch.ones_like(inclusive[..., :1])
    if mode == "loma":
        trans = torch.cat([ones, inclusive[..., 1:]], dim=-1)
    elif mode == "standard":
        trans = torch.cat([ones, inclusive[..., :-1]], dim=-1)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    return alpha * trans


def accumulate_color(weights: torch.Tensor, rgb: torch.Tensor) -> torch.Tensor:
    """``sum_j w[..., j] * rgb[..., j, :]``."""
    return torch.sum(weights[..., None] * rgb, dim=-2)


def accumulate_depth(weights: torch.Tensor, t_vals: torch.Tensor) -> torch.Tensor:
    """Expected ray depth ``sum_j w[..., j] * t[j]``."""
    return torch.sum(weights * t_vals, dim=-1)
