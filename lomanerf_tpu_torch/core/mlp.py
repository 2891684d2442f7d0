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


def paper_layer_sizes(in_x: int, in_d: int, num_layers: int, width: int,
                      skip_layer: int, view_width: int) -> List[tuple]:
    """Per-leaf (fan_in, fan_out) of one network of the published NeRF
    (Mildenhall et al. 2020, Fig. 7), in leaf order: ``num_layers`` ReLU
    trunk layers of ``width`` (layer ``skip_layer``, 0-based, reads
    ``[gamma(x) | h]``: NeRF's ``skips=[4]`` is 5 here), the density head
    ``width -> 1``, the linear feature layer ``width -> width``, the view
    layer ``[feature | gamma(d)] -> view_width`` and the rgb head
    ``view_width -> 3``."""
    sizes, fan_in = [], in_x
    for i in range(num_layers):
        if skip_layer and i == skip_layer:
            fan_in = in_x + width
        sizes.append((fan_in, width))
        fan_in = width
    return sizes + [(width, 1), (width, width), (width + in_d, view_width), (view_width, 3)]


def init_paper_net(generator: torch.Generator, sizes: Sequence[tuple],
                   dtype: torch.dtype = torch.float32,
                   device: torch.device | str = "cpu") -> Params:
    """One network of the published NeRF with ``init="nerf"`` applied to
    both heads: He-normal weights, zero biases, the density and rgb heads'
    weights x0.1 and a +0.5 density bias (``sizes`` as
    :func:`paper_layer_sizes` gives them; drawn leaf by leaf from
    ``generator`` on its device, then moved to ``device``)."""
    ws, bs = [], []
    for fan_in, fan_out in sizes:
        w = torch.randn((fan_in, fan_out), generator=generator, dtype=dtype,
                        device=generator.device)
        ws.append(w * math.sqrt(2.0 / fan_in))
        bs.append(torch.zeros((fan_out,), dtype=dtype, device=generator.device))
    n = len(sizes)
    ws[n - 4] = ws[n - 4] * 0.1  # density head
    ws[n - 1] = ws[n - 1] * 0.1  # rgb head
    bs[n - 4][0] = 0.5
    return {"w": [w.to(device) for w in ws], "b": [b.to(device) for b in bs]}


def init_he(generator: torch.Generator, sizes: Sequence[tuple],
            dtype: torch.dtype = torch.float32, device: torch.device | str = "cpu") -> Params:
    """He-normal weights (std ``sqrt(2 / fan_in)``) and zero biases for
    every ``(fan_in, fan_out)`` of ``sizes``, drawn leaf by leaf from
    ``generator`` on its device, then moved to ``device`` (mip-NeRF 360's
    He init, normal where multinerf draws it uniform)."""
    ws = [torch.randn((fi, fo), generator=generator, dtype=dtype, device=generator.device)
          * math.sqrt(2.0 / fi) for fi, fo in sizes]
    return {"w": [w.to(device) for w in ws],
            "b": [torch.zeros((fo,), dtype=dtype, device=device) for _, fo in sizes]}


def paper_mlp_apply(net: Params, enc_x: torch.Tensor, enc_d: torch.Tensor,
                    skip_layer: int, rnd=None) -> tuple:
    """One network of the published NeRF on ``(rows, in_x)`` encoded points
    and ``(rows, in_d)`` encoded directions: ``(rgb_raw (rows, 3),
    sigma_raw (rows,))`` before the sigmoid and the ReLU.  ``rnd`` rounds
    every weight and every stored value (encodings, each layer's output,
    the feature and density) to a compute dtype (the kernels' plan); the
    products accumulate in the inputs' dtype."""
    rnd = rnd or (lambda x: x)
    ws, bs = net["w"], net["b"]
    trunk = len(ws) - 4
    ex, ed = rnd(enc_x), rnd(enc_d)
    h = ex
    for i in range(trunk):
        if skip_layer and i == skip_layer:
            h = torch.cat([ex, h], dim=-1)
        h = rnd(torch.relu(h @ rnd(ws[i]) + bs[i]))
    sigma = rnd(h @ rnd(ws[trunk]) + bs[trunk])[:, 0]
    feature = rnd(h @ rnd(ws[trunk + 1]) + bs[trunk + 1])
    v = rnd(torch.relu(torch.cat([feature, ed], dim=-1) @ rnd(ws[trunk + 2]) + bs[trunk + 2]))
    return v @ rnd(ws[trunk + 3]) + bs[trunk + 3], sigma


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
