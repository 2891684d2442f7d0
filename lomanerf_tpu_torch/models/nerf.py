"""NeRF model family: a radiance-field MLP + volume renderer (port of
``lomanerf_tpu.models.nerf``).

Presets: ``small()`` — 3 layers x 30, n=5 (in 33), 30 samples, near/far 2/6,
loma compositing; ``single_view_64()`` — 4 x 64, 64 samples; ``full()`` —
8 x 256, 128 samples, standard compositing, bf16 compute; ``paper()`` — NeRF
as published (Mildenhall et al., ECCV 2020): two networks (coarse and fine)
of 8 ReLU layers of 256 with the skip into the sixth, a density head, a
view-direction branch (feature 256, view layer 128, rgb head), L = 10 for
positions and 4 for directions, 64 stratified coarse samples and 128 fine
ones drawn from the coarse weights, bf16 compute; ``mipnerf360()`` —
mip-NeRF 360 as published (Barron et al., CVPR 2022): a proposal MLP of
4 x 256 run on two rounds of 64 intervals, the NeRF MLP of 8 x 1024 (skip
into the sixth layer, bottleneck 256, view layer 128) on 32 intervals drawn
from the proposal's weights, the integrated encoding of contracted
frustums, bf16 compute.

``NeRFModel`` is an ``nn.Module`` that owns its MLP parameters; the device
of those parameters decides the path: CUDA renders (and differentiates the
render) through the hand-written kernels (``ops.fused_nerf``: the narrow
ones for ``small``/``single64``, the wide ones for ``full``, the wide
chain's sequence for ``paper``, ``csrc/nerf_paper.cu``, and for
``mipnerf360``, ``csrc/mip360.cu``), CPU through the plain PyTorch version.

``paper()`` runs coarse, then the sampler, then fine (:func:`paper_loss`,
:func:`paper_render_rays`).  Spans (``utils.profiling.span``, recorded
only under a profiler): ``lomanerf.nerf.pass.coarse`` and
``lomanerf.nerf.pass.fine`` around each pass's call, and
``lomanerf.nerf.sample_pdf`` around the fine depths' draw.
``mipnerf360()`` runs its rounds, its resampling, the NeRF pass and its
losses under ``lomanerf.nerf.pass.proposal``, ``lomanerf.nerf.sample_pdf``,
``lomanerf.nerf.pass.nerf`` and ``lomanerf.nerf.mip360_loss``
(``ops.mip360``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from lomanerf_tpu_torch.core import encoding, mlp, rays
from lomanerf_tpu_torch.ops import fused_nerf, mip360
from lomanerf_tpu_torch.utils.profiling import span, spanned


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
    # the published NeRF (paper()); all 0 for the plain chain.  skip_layer:
    # the 0-based trunk layer that reads [gamma(x) | h] (NeRF's skips=[4]);
    # dir_encoding_functions: L of the direction encoding; view_width: the
    # view layer's width (> 0: the view branch, two networks); with it
    # num_layers counts the trunk's ReLU layers, num_samples the coarse
    # samples and num_fine_samples those drawn from the coarse weights
    skip_layer: int = 0
    dir_encoding_functions: int = 0
    view_width: int = 0
    num_fine_samples: int = 0
    # mip-NeRF 360 (mipnerf360()); all 0 elsewhere.  proposal_layers and
    # proposal_width: the proposal MLP's ReLU layers (> 0: mip-NeRF 360);
    # proposal_samples: the intervals of each proposal round; then
    # num_samples counts the NeRF MLP's intervals, num_encoding_functions is
    # the IPE's degree (6 L inputs), bottleneck_width the linear layer the
    # view layer reads, pixel_radius a ray's cone radius at unit distance
    # (2 / sqrt(12) of the pixel pitch), near and far bound s-space
    proposal_layers: int = 0
    proposal_width: int = 0
    proposal_samples: tuple = ()
    bottleneck_width: int = 0
    pixel_radius: float = 0.0

    def __post_init__(self):
        # a configuration file gives a list
        object.__setattr__(self, "proposal_samples", tuple(self.proposal_samples))

    @property
    def mip360(self) -> bool:
        """Whether this is mip-NeRF 360: the proposal network, then the NeRF
        MLP on resampled intervals (:meth:`mipnerf360`)."""
        return self.proposal_layers > 0

    @property
    def in_channels(self) -> int:
        if self.mip360:
            return 6 * self.num_encoding_functions
        return encoding.encoded_dim(3, self.num_encoding_functions)

    @property
    def view_branch(self) -> bool:
        """Whether this is the published NeRF: coarse and fine networks with
        the view branch (:meth:`paper`)."""
        return self.view_width > 0 and not self.mip360

    @property
    def dir_channels(self) -> int:
        return encoding.encoded_dim(3, self.dir_encoding_functions)

    def leaf_sizes(self):
        """Per-leaf ``(fan_in, fan_out)`` of the model's parameters: the
        chain's layers, or for :meth:`paper` the coarse network's twelve
        then the fine one's, or for :meth:`mipnerf360` the proposal MLP's
        layers and density head, then the NeRF MLP's trunk (the skip
        layer's leaf ``[h | IPE]``), density head, bottleneck, view layer
        and rgb head."""
        if self.mip360:
            w, fan_in, prop = self.proposal_width, self.in_channels, []
            for _ in range(self.proposal_layers):
                prop.append((fan_in, w))
                fan_in = w
            width, sizes, fan_in = self.filter_size, [], self.in_channels
            for i in range(self.num_layers):
                sizes.append((width + self.in_channels if i == self.skip_layer else fan_in,
                              width))
                fan_in = width
            b = self.bottleneck_width
            return prop + [(w, 1)] + sizes + [(width, 1), (width, b),
                                              (b + self.dir_channels, self.view_width),
                                              (self.view_width, 3)]
        if self.view_branch:
            net = mlp.paper_layer_sizes(self.in_channels, self.dir_channels,
                                        self.num_layers, self.filter_size,
                                        self.skip_layer, self.view_width)
            return net + net
        return mlp.mlp_layer_sizes(self.in_channels, self.out_channels, self.num_layers,
                                   self.filter_size)

    @staticmethod
    def preset(name: str) -> "NeRFConfig":
        """Ladder preset by name: ``small``, ``single64``, ``full``,
        ``paper`` or ``mipnerf360``."""
        return {
            "small": NeRFConfig.small,
            "single64": NeRFConfig.single_view_64,
            "full": NeRFConfig.full,
            "paper": NeRFConfig.paper,
            "mipnerf360": NeRFConfig.mipnerf360,
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

    @staticmethod
    def paper() -> "NeRFConfig":
        """NeRF as published (§5.3 and Fig. 7; ``run_nerf_helpers.py``):
        per network 8 ReLU layers of 256, the sixth reading [gamma(x) | h_5]
        (319 inputs), a density head (256 -> 1, ReLU at compositing), a
        linear feature layer (256 -> 256), the view layer ([feature |
        gamma(d)], 283 -> 128, ReLU) and the rgb head (128 -> 3, sigmoid);
        L = 10 (63 inputs) and 4 (27); Nc = 64 stratified coarse samples and
        Nf = 128 fine ones; the full() compute plan (bf16 products, f32
        parameters) with init="nerf" on both heads."""
        return NeRFConfig(
            num_layers=8, filter_size=256, num_encoding_functions=10, num_samples=64,
            mode="standard", compute_dtype="bfloat16", precision="default", init="nerf",
            skip_layer=5, dir_encoding_functions=4, view_width=128, num_fine_samples=128,
        )

    @staticmethod
    def mipnerf360() -> "NeRFConfig":
        """mip-NeRF 360 as published (Barron et al., CVPR 2022): one proposal
        MLP of 4 ReLU layers of 256 and a density head, run on two rounds of
        64 intervals; the NeRF MLP, 8 ReLU layers of 1024, the sixth reading
        [h_5 | IPE] (1120 inputs), a density head, a linear bottleneck of
        256, the view layer ([bottleneck | gamma(d)], 283 -> 128, ReLU) and
        the rgb head, on 32 intervals drawn from round 2's weights; the IPE
        of the contracted frustums at L = 16 (96 inputs), gamma(d) at L = 4;
        densities softplus(x - 1), colours the padded sigmoid; near 0.2 and
        far 1000 bound s-space; the full() compute plan (bf16 products, f32
        parameters).  ``pixel_radius`` is an 800-pixel Blender camera's
        (camera_angle_x 0.6911): 2 / sqrt(12) / (focal x 799)."""
        focal = 0.5 / math.tan(0.5 * 0.6911112070083618)
        return NeRFConfig(
            num_layers=8, filter_size=1024, out_channels=4, num_encoding_functions=16,
            num_samples=32, near=0.2, far=1000.0, mode="standard", compute_dtype="bfloat16",
            precision="default", init="he", skip_layer=5, dir_encoding_functions=4,
            view_width=128, proposal_layers=4, proposal_width=256, proposal_samples=(64, 64),
            bottleneck_width=256, pixel_radius=2.0 / math.sqrt(12.0) / (focal * 799),
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
        if c.view_branch and c.mode != "standard":
            raise ValueError("the published NeRF composites in standard mode")
        sizes = c.leaf_sizes()
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
        """Fill the parameters with the config's init drawn from ``generator``
        (for :meth:`NeRFConfig.paper`: the coarse network, then the fine)."""
        c = self.config
        if c.mip360:
            self.load_params(mlp.init_he(generator, c.leaf_sizes(), c.dtype, self.device))
            return self.params
        if c.view_branch:
            sizes = c.leaf_sizes()[:len(self.w) // 2]
            nets = [mlp.init_paper_net(generator, sizes, c.dtype, self.device)
                    for _ in range(2)]
            self.load_params({k: nets[0][k] + nets[1][k] for k in ("w", "b")})
            return self.params
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
        """Colours of ``(N, 3)`` rays; for :meth:`NeRFConfig.paper` at the
        coarse depths given, then the fine pass on the depths the sampler
        draws evenly from the coarse weights (no gradient)."""
        if self.config.mip360:
            return mip360.render_rays(self.params, origins, directions, self.config)
        if self.config.view_branch:
            return paper_render_rays(self.config, self.params, origins, directions,
                                     t_vals, dists)
        return fused_nerf.render_rays(self.params, origins, directions, t_vals,
                                      dists, self.config)

    def loss(self, origins, directions, t_vals, dists, target,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Sum-MSE of :meth:`render_rays` against ``(N, 3)`` targets; its
        backward on CUDA runs the render backward kernel.  For
        :meth:`NeRFConfig.paper`: :func:`paper_loss`, the fine depths drawn
        from ``generator`` (evenly spaced without one)."""
        if self.config.mip360:
            return mip360_loss(self.config, self.params, origins, directions, target,
                               generator)
        if self.config.view_branch:
            return paper_loss(self.config, self.params, origins, directions, t_vals,
                              dists, target, generator)
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
        chunk = chunk or (mip360.RENDER_RAYS if self.config.mip360 else
                          fused_nerf.render_chunk_rays(self.config, self.params))
        if mesh is not None and (self.config.view_branch or self.config.mip360):
            raise NotImplementedError("the published NeRF and mip-NeRF 360 render on one rank")
        if mesh is not None:
            from lomanerf_tpu_torch.parallel import render_step

            step = render_step.make_render_step(self.config, mesh)
            return render_step.sharded_render_image(self.params, K, c2w, img_size, mesh,
                                                    step, chunk=chunk)
        dev = self.device
        K = torch.as_tensor(K, dtype=torch.float32).to(dev)
        c2w = torch.as_tensor(c2w, dtype=torch.float32).to(dev)
        o, d = rays.get_rays(img_size, img_size, K, c2w)
        config = self.config
        if config.mip360:  # the cone radius of this frame's pixels
            config = dataclasses.replace(config, pixel_radius=2.0 / math.sqrt(12.0) / (
                float(K[0, 0]) * (img_size - 1)))
        cols = [render_chunk(config, self.params, oc, dc)
                for oc, dc in zip(o.split(chunk), d.split(chunk))]
        return torch.cat(cols).reshape(img_size, img_size, 3)

    def count_params(self) -> int:
        return count_params(self.params)


def render_chunk(config: NeRFConfig, params: mlp.Params, o, d) -> torch.Tensor:
    """Render one ``(chunk, 3)`` ray block at the config's uniform depths
    (for :meth:`NeRFConfig.paper` the coarse ones, then the fine pass)."""
    if config.mip360:
        return mip360.render_rays(params, o, d, config)
    tv, dists = rays.uniform_depths(config.near, config.far, config.num_samples,
                                    o.device)
    if config.view_branch:
        return paper_render_rays(config, params, o, d, tv, dists)
    return fused_nerf.render_rays(params, o, d, tv, dists, config)


def paper_loss(config: NeRFConfig, params: mlp.Params, origins, directions, t_vals,
               dists, target, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The published NeRF's train loss: the coarse network's sum-MSE at the
    coarse depths ``t_vals`` (``(S,)`` or per-ray ``(N, S)``, e.g. the
    stratified ones of :meth:`NeRFModel.sample`), plus the fine network's at
    the sorted union of those and ``num_fine_samples`` depths drawn by
    inverse transform from the coarse weights (detached; ``u`` from
    ``generator``, evenly spaced without one: ``core.rays.fine_depths``).
    Each pass is one call of ``fused_nerf.paper_train_loss`` (the
    ``nerf_paper_train`` kernel sequence on the card, which gives the loss and
    its gradients together; the plain version on the CPU)."""
    coarse, fine = fused_nerf.paper_nets(params)
    with span("lomanerf.nerf.pass.coarse"):
        loss_c, weights = fused_nerf.paper_train_loss(coarse, origins, directions, t_vals,
                                                      dists, target, config, weights=True)
    with span("lomanerf.nerf.sample_pdf"):
        t_fine, d_fine = rays.fine_depths(t_vals, weights, config.num_fine_samples, generator)
    with span("lomanerf.nerf.pass.fine"):
        loss_f, _ = fused_nerf.paper_train_loss(fine, origins, directions, t_fine, d_fine,
                                                target, config)
    return loss_c + loss_f


def mip360_loss(config: NeRFConfig, params: mlp.Params, origins, directions, target,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """mip-NeRF 360's train loss: the two proposal rounds, the NeRF MLP on
    the intervals drawn from round 2's weights, then the mean Charbonnier
    plus 0.01 times the mean distortion plus each round's mean interlevel
    term; the resampler's jitter from ``generator`` (the deterministic
    centres without one).  ``ops.mip360.train_loss``: the kernels on the
    card, which give the loss and its gradients together; the plain version
    on the CPU."""
    return mip360.train_loss(params, origins, directions, target, config, generator)[0]


def paper_render_rays(config: NeRFConfig, params: mlp.Params, origins, directions,
                      t_vals, dists) -> torch.Tensor:
    """The published NeRF's colours of ``(N, 3)`` rays: the coarse pass at
    ``t_vals``, the fine depths drawn evenly from its weights, the fine
    network's colours at their union (``fused_nerf.paper_render``: the
    ``nerf_paper_render`` sequence on the card).  No gradient."""
    coarse, fine = fused_nerf.paper_nets(params)
    with torch.no_grad():
        with span("lomanerf.nerf.pass.coarse"):
            _, weights = fused_nerf.paper_render(coarse, origins, directions, t_vals, dists,
                                                 config, weights=True)
        with span("lomanerf.nerf.sample_pdf"):
            t_fine, d_fine = rays.fine_depths(t_vals, weights, config.num_fine_samples)
        with span("lomanerf.nerf.pass.fine"):
            col, _ = fused_nerf.paper_render(fine, origins, directions, t_fine, d_fine,
                                             config)
    return col


def count_params(params: mlp.Params) -> int:
    return sum(int(x.numel()) for x in [*params["w"], *params["b"]])
