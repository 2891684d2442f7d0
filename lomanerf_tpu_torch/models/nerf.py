"""NeRF model family: a radiance-field MLP + volume renderer (port of
``lomanerf_tpu.models.nerf``).

Presets: ``small()`` — 3 layers x 30, n=5 (in 33), 30 samples, near/far 2/6,
loma compositing; ``single_view_64()`` — 4 x 64, 64 samples; ``full()`` —
8 x 256, 128 samples, standard compositing, bf16 compute.

``NeRFModel`` is an ``nn.Module`` that owns its MLP parameters; the device
of those parameters decides the path: CUDA renders (and differentiates the
render) through the hand-written kernels (``ops.fused_nerf``: the narrow
ones for ``small``/``single64``, the wide ones for ``full``), CPU through
the plain PyTorch version.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from lomanerf_tpu_torch.core import encoding, mlp, rays
from lomanerf_tpu_torch.ops import fused_nerf
from lomanerf_tpu_torch.utils.profiling import spanned


@dataclasses.dataclass(frozen=True)
class NeRFConfig:
    num_layers: int = 3
    filter_size: int = 30
    out_channels: int = 4
    num_encoding_functions: int = 5
    num_samples: int = 30
    near: float = 2.0
    far: float = 6.0
    mode: str = "loma"  # transmittance mode: "loma" (reference parity) | "standard"
    init: str = "he"
    dtype: torch.dtype = torch.float32  # parameter dtype
    compute_dtype: str = "float32"  # kernel compute dtype; "bfloat16" runs on the wide kernels
    precision: str = "highest"  # TPU matmul tier; every tier is f32 on the card

    @property
    def in_channels(self) -> int:
        return encoding.encoded_dim(3, self.num_encoding_functions)

    @staticmethod
    def preset(name: str) -> "NeRFConfig":
        """Ladder preset by name: ``small``, ``single64`` or ``full``."""
        return {
            "small": NeRFConfig.small,
            "single64": NeRFConfig.single_view_64,
            "full": NeRFConfig.full,
        }[name]()

    @staticmethod
    def small() -> "NeRFConfig":
        return NeRFConfig(precision="high")

    @staticmethod
    def single_view_64() -> "NeRFConfig":
        return NeRFConfig(num_layers=4, filter_size=64, num_samples=64,
                          precision="high")

    @staticmethod
    def full() -> "NeRFConfig":
        # init="nerf": deep radiance MLPs at plain He init start with a dead
        # density head about half the time (see core.mlp.init_mlp)
        return NeRFConfig(
            num_layers=8, filter_size=256, num_samples=128, mode="standard",
            compute_dtype="bfloat16", precision="default", init="nerf",
        )


class NeRFModel(nn.Module):
    """Radiance-field MLP parameters plus the render entry points.

    Built with zero weights on ``device`` (the card unless the caller asks
    for the CPU); fill them with :meth:`init`
    (random, from a ``torch.Generator``) or build with :meth:`from_numpy`
    (e.g. the JAX package's trained params)."""

    def __init__(self, config: NeRFConfig, device: torch.device | str = "cuda"):
        super().__init__()
        self.config = config
        c = config
        sizes = mlp.mlp_layer_sizes(c.in_channels, c.out_channels, c.num_layers,
                                    c.filter_size)
        self.w = nn.ParameterList(
            nn.Parameter(torch.zeros(fi, fo, dtype=c.dtype, device=device))
            for fi, fo in sizes)
        self.b = nn.ParameterList(
            nn.Parameter(torch.zeros(fo, dtype=c.dtype, device=device))
            for _, fo in sizes)

    @classmethod
    def from_numpy(cls, config: NeRFConfig, ws: Sequence[np.ndarray],
                   bs: Sequence[np.ndarray], device: torch.device | str) -> "NeRFModel":
        """A model holding numpy params ``{"w": ws, "b": bs}`` in the JAX
        package's ``(in, out)`` layout, on ``device``."""
        model = cls(config, device=device)
        model.load_params(mlp.params_from_numpy(ws, bs, device, config.dtype))
        return model

    @property
    def params(self) -> mlp.Params:
        """The parameters as the JAX-layout dict ``{"w": [...], "b": [...]}``."""
        return {"w": list(self.w), "b": list(self.b)}

    @property
    def device(self) -> torch.device:
        return self.w[0].device

    @torch.no_grad()
    def load_params(self, params: mlp.Params) -> None:
        for dst, src in zip([*self.w, *self.b], [*params["w"], *params["b"]]):
            if dst.shape != src.shape:
                raise ValueError(f"param shape {tuple(src.shape)} != {tuple(dst.shape)}")
            dst.copy_(src)

    def init(self, generator: torch.Generator) -> mlp.Params:
        """Fill the parameters with the config's init drawn from ``generator``."""
        c = self.config
        self.load_params(mlp.init_mlp(
            generator, c.in_channels, c.out_channels, c.num_layers, c.filter_size,
            init=c.init, dtype=c.dtype, device=self.device))
        return self.params

    def sample(self, origins, directions, generator: Optional[torch.Generator] = None):
        """``(points, t_vals, dists)`` along the rays: ``(S,)`` shared depths,
        or with ``generator`` per-bin stratified ``(N, S)`` ones, which
        :meth:`render_rays` and :meth:`loss` take as they are (the ``*_rays``
        kernels on the card)."""
        c = self.config
        return rays.sample_along_rays(origins, directions, c.near, c.far,
                                      c.num_samples, generator=generator)

    def render_rays(self, origins, directions, t_vals, dists) -> torch.Tensor:
        return fused_nerf.render_rays(self.params, origins, directions, t_vals,
                                      dists, self.config)

    def loss(self, origins, directions, t_vals, dists, target) -> torch.Tensor:
        """Sum-MSE of :meth:`render_rays` against ``(N, 3)`` targets; its
        backward on CUDA runs the render backward kernel."""
        return fused_nerf.nerf_loss(self.params, origins, directions, t_vals,
                                    dists, target, self.config)

    @spanned("lomanerf.nerf.render_image")
    def render_image(self, K, c2w, img_size: int, chunk: Optional[int] = None,
                     mesh=None) -> torch.Tensor:
        """``(img_size, img_size, 3)`` render of pose ``c2w`` on the
        parameters' device.  ``chunk`` rays per render call only bounds
        memory: each ray's colour does not depend on it.  The default comes
        from a byte budget (``fused_nerf.render_chunk_rays``): about 4 GB per
        activation buffer, 65,536 rays for ``full`` and 2^20 (frames up to
        1024x1024 in one call) for the narrow presets.

        With ``mesh`` (``parallel.make_mesh``), the frame's rays are sharded
        over its data group and the frame reassembled by an all-gather
        (``parallel.render_step``): every rank of the group must call it,
        and every rank gets the whole frame, the same bits as without.

        Under a profiler the call is the span ``lomanerf.nerf.render_image``,
        with one ``lomanerf.fused_nerf.render_rays`` a chunk inside it."""
        chunk = chunk or fused_nerf.render_chunk_rays(self.config, self.params)
        if mesh is not None:
            from lomanerf_tpu_torch.parallel import render_step

            step = render_step.make_render_step(self.config, mesh)
            return render_step.sharded_render_image(self.params, K, c2w, img_size, mesh,
                                                    step, chunk=chunk)
        dev = self.device
        K = torch.as_tensor(K, dtype=torch.float32).to(dev)
        c2w = torch.as_tensor(c2w, dtype=torch.float32).to(dev)
        o, d = rays.get_rays(img_size, img_size, K, c2w)
        cols = [render_chunk(self.config, self.params, oc, dc)
                for oc, dc in zip(o.split(chunk), d.split(chunk))]
        return torch.cat(cols).reshape(img_size, img_size, 3)

    def count_params(self) -> int:
        return count_params(self.params)


def render_chunk(config: NeRFConfig, params: mlp.Params, o, d) -> torch.Tensor:
    """Render one ``(chunk, 3)`` ray block at the config's uniform depths."""
    tv, dists = rays.uniform_depths(config.near, config.far, config.num_samples,
                                    o.device)
    return fused_nerf.render_rays(params, o, d, tv, dists, config)


def count_params(params: mlp.Params) -> int:
    return sum(int(x.numel()) for x in [*params["w"], *params["b"]])
