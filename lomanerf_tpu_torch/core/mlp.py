"""Plain MLP: init + apply (port of ``lomanerf_tpu.core.mlp``).

Params are ``{"w": [W_0..W_{L-1}], "b": [b_0..b_{L-1}]}`` with exact
(unpadded) shapes ``(in, out)`` and ``(out,)`` — the JAX package's layout, so
the same numpy arrays initialise both packages.  Apply is ``x @ W + b`` per
layer, ReLU on hidden layers and a head on the last:

* ``"sigmoid"``: sigmoid on every channel (2D image fit);
* ``"rgba"``: sigmoid on channels != 3, ReLU on channel 3 (density);
* ``"none"``: raw linear output.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch

Params = Dict[str, List[torch.Tensor]]


def mlp_layer_sizes(
    in_channels: int, out_channels: int, num_layers: int, filter_size: int
) -> List[tuple]:
    """Per-layer (fan_in, fan_out)."""
    sizes = []
    fan_in = in_channels
    for i in range(num_layers):
        fan_out = out_channels if i == num_layers - 1 else filter_size
        sizes.append((fan_in, fan_out))
        fan_in = fan_out
    return sizes


def init_mlp(
    generator: torch.Generator,
    in_channels: int,
    out_channels: int,
    num_layers: int,
    filter_size: int = 16,
    init: str = "he",
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cpu",
) -> Params:
    """Initialise MLP params from ``generator`` (drawn on the generator's
    device, then moved to ``device``).

    ``init="he"``: W ~ N(0, sqrt(2/fan_in)), b ~ N(0, 0.5).
    ``init="randn"``: W, b ~ N(0, 1).
    ``init="nerf"``: He hidden weights, zero biases, head weights x0.1 and a
    +0.5 density bias (channel 3 of an rgba head) — deep radiance MLPs at
    plain He init start with a dead density head about half the time.

    The JAX package draws from ``jax.random``; the streams differ, so parity
    tests pass the same numpy arrays to both packages instead of a seed.
    """
    if init not in ("he", "randn", "nerf"):
        raise ValueError(f"unknown init {init!r}")

    def normal(shape):
        return torch.randn(shape, generator=generator, dtype=dtype,
                           device=generator.device)

    ws, bs = [], []
    for fan_in, fan_out in mlp_layer_sizes(
        in_channels, out_channels, num_layers, filter_size
    ):
        w = normal((fan_in, fan_out))
        b = normal((fan_out,))
        if init == "randn":
            ws.append(w)
            bs.append(b)
            continue
        ws.append(w * math.sqrt(2.0 / fan_in))
        bs.append(torch.zeros_like(b) if init == "nerf" else b * 0.5)
    if init == "nerf":
        ws[-1] = ws[-1] * 0.1
        if out_channels >= 4:
            bs[-1][3] = 0.5
    return {"w": [w.to(device) for w in ws], "b": [b.to(device) for b in bs]}


def params_from_numpy(
    ws: Sequence, bs: Sequence, device: torch.device | str,
    dtype: torch.dtype = torch.float32,
) -> Params:
    """The weights bridge: numpy params (e.g. the JAX package's, as arrays)
    to the port's tensors on ``device``.  Copies, so the result never
    aliases the caller's arrays."""
    return {
        "w": [torch.tensor(w, dtype=dtype, device=device) for w in ws],
        "b": [torch.tensor(b, dtype=dtype, device=device) for b in bs],
    }


def _apply_head(y: torch.Tensor, head: str) -> torch.Tensor:
    if head == "sigmoid":
        return torch.sigmoid(y)
    if head == "rgba":
        # sigmoid on colour channels, ReLU on density channel 3
        density = torch.clamp_min(y[..., 3:4], 0.0)
        rgb = torch.sigmoid(torch.cat([y[..., :3], y[..., 4:]], dim=-1))
        return torch.cat([rgb[..., :3], density, rgb[..., 3:]], dim=-1)
    if head == "none":
        return y
    raise ValueError(f"unknown head {head!r}")


def mlp_apply(params: Params, x: torch.Tensor, head: str = "sigmoid") -> torch.Tensor:
    """Forward the MLP: ReLU hidden layers, ``head`` on the output layer.
    Float32 matmuls run in full float32 unless the caller enables TF32."""
    n = len(params["w"])
    y = x
    for i, (w, b) in enumerate(zip(params["w"], params["b"])):
        y = torch.matmul(y, w) + b
        y = torch.clamp_min(y, 0.0) if i < n - 1 else _apply_head(y, head)
    return y
