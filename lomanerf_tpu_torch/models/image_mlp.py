"""2D image-fitting field (port of ``lomanerf_tpu.models.image_mlp``).

Presets: ``small()`` — the reference's 256x256 parity config, 3 layers
22->16->16->3 with an n=5 encoding; ``hires()`` — 4 layers
34->128->128->128->3, n=8, 1024x1024.

``ImageFieldModel`` is an ``nn.Module`` that owns its MLP parameters; the
device of those parameters decides the path: CUDA runs the field and its
gradient through the hand-written kernels (``ops.fused_mlp``), CPU through
the plain PyTorch version.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from lomanerf_tpu_torch.core import encoding, losses, mlp, pipeline
from lomanerf_tpu_torch.ops import fused_mlp


@dataclasses.dataclass(frozen=True)
class ImageFieldConfig:
    num_layers: int = 3
    filter_size: int = 16
    out_channels: int = 3
    num_encoding_functions: int = 5
    img_size: int = 256
    init: str = "he"
    dtype: torch.dtype = torch.float32  # parameter dtype
    precision: str = "high"  # TPU matmul tier; every tier is 3xTF32 on the card

    @property
    def in_channels(self) -> int:
        return encoding.encoded_dim(2, self.num_encoding_functions)

    @staticmethod
    def small() -> "ImageFieldConfig":
        return ImageFieldConfig()

    @staticmethod
    def hires() -> "ImageFieldConfig":
        return ImageFieldConfig(num_layers=4, filter_size=128,
                                num_encoding_functions=8, img_size=1024)


def image_grid_coords(img_size: int, device: torch.device | str = "cpu") -> torch.Tensor:
    """The reference's input grid: the ``xy``-indexed meshgrid of
    linspace(0, 1) stacked to ``(H*W, 2)``, x varying fastest (the JAX
    package's ``jnp.meshgrid`` default).  The points are ``i * f32(1 /
    (n - 1))``, as ``jnp.linspace`` computes them (``torch.linspace`` differs
    in the last bit at about half of them)."""
    step = 1.0 / (img_size - 1) if img_size > 1 else 0.0
    c = torch.arange(img_size, dtype=torch.float32, device=device) * step
    g = torch.meshgrid(c, c, indexing="xy")
    return torch.stack(g, dim=-1).reshape(-1, 2)


class ImageFieldModel(nn.Module):
    """Image-field MLP parameters plus the predict / render entry points.

    Built with zero weights on ``device`` (the card unless the caller asks
    for the CPU); fill them with :meth:`init`
    (random, from a ``torch.Generator``) or build with :meth:`from_numpy`.
    ``backend="plain"`` runs the plain version on any device (for
    comparisons); ``"auto"`` lets the device decide."""

    def __init__(self, config: ImageFieldConfig, device: torch.device | str = "cuda",
                 backend: str = "auto"):
        super().__init__()
        if backend not in ("auto", "plain"):
            raise ValueError(f"unknown backend {backend!r}; one of ('auto', 'plain')")
        self.config = config
        self.backend = backend
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
    def from_numpy(cls, config: ImageFieldConfig, ws: Sequence[np.ndarray],
                   bs: Sequence[np.ndarray], device: torch.device | str,
                   backend: str = "auto") -> "ImageFieldModel":
        """A model holding numpy params ``{"w": ws, "b": bs}`` in the JAX
        package's ``(in, out)`` layout, on ``device``."""
        model = cls(config, device=device, backend=backend)
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
        for dst, src in zip([*self.w, *self.b], [*params["w"], *params["b"]], strict=True):
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

    def encode(self, coords: torch.Tensor) -> torch.Tensor:
        return encoding.positional_encoding(coords, self.config.num_encoding_functions)

    def predict(self, coords_encoded: torch.Tensor) -> torch.Tensor:
        """Predict from pre-encoded inputs (the parity path; always plain)."""
        return pipeline.image_fit_pred(self.params, coords_encoded)

    def predict_coords(self, coords: torch.Tensor) -> torch.Tensor:
        """Predict from raw ``(N, 2)`` coords: the fused encode + MLP (the
        kernels on CUDA), or the plain version with ``backend="plain"``."""
        c = self.config
        fn = (fused_mlp.field_forward_reference if self.backend == "plain"
              else fused_mlp.field_forward)
        return fn(self.params, coords, c.num_encoding_functions, c.out_channels)

    def loss(self, coords: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """Sum-MSE of :meth:`predict_coords` against ``(N, 3)`` targets; its
        backward on CUDA runs the field's backward kernel."""
        return losses.sum_mse(self.predict_coords(coords), target)

    def render(self, img_size: Optional[int] = None) -> torch.Tensor:
        """The ``(img_size, img_size, 3)`` image of the field, on the
        parameters' device."""
        size = img_size or self.config.img_size
        coords = image_grid_coords(size, self.device)
        return self.predict_coords(coords).reshape(size, size, -1)
