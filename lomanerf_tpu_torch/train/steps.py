"""Single-device train steps for both model families (port of
``lomanerf_tpu.train.steps``).

PyTorch runs eagerly: there is no ``jit`` and no buffer donation.  A step
updates the parameters in place through the optimizer built over them.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from lomanerf_tpu_torch.core.encoding import positional_encoding
from lomanerf_tpu_torch.core.losses import sum_mse
from lomanerf_tpu_torch.core.mlp import Params
from lomanerf_tpu_torch.core.pipeline import image_fit_loss, nerf_loss_rays
from lomanerf_tpu_torch.utils.profiling import spanned

BACKENDS = ("auto", "plain")


def resolve_backend(cfg, backend: str = "auto") -> str:
    """``"auto"`` is ``"fused"``: ``ops.fused_nerf.nerf_train_loss`` (or, for
    the image field, ``ops.fused_mlp.field_forward``), which runs the kernels
    on CUDA params and their plain version on CPU params, so the params'
    device decides.  ``"plain"`` (autograd through the core pipeline) exists
    for comparisons only."""
    del cfg
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    return "fused" if backend == "auto" else backend


def nerf_loss_fn(params: Params, origins, directions, t_vals, dists, target, cfg,
                 backend: str = "fused", mlp_fn: Optional[Callable] = None,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The sum-MSE train loss of one ray batch, differentiable w.r.t. params.
    ``mlp_fn`` replaces the plain pipeline's MLP (``core.pipeline.nerf_render``).
    For ``NeRFConfig.paper()`` the coarse and the fine passes'
    (``models.nerf.paper_loss``, the fine depths drawn from ``generator``);
    it has no plain backend beside its CPU route."""
    if cfg.view_branch:
        if backend != "fused" or mlp_fn is not None:
            raise ValueError("the published NeRF trains on the fused backend only")
        from lomanerf_tpu_torch.models.nerf import paper_loss

        return paper_loss(cfg, params, origins, directions, t_vals, dists, target, generator)
    if backend == "fused":
        # one kernel call gives the loss AND its gradients
        from lomanerf_tpu_torch.ops import fused_nerf

        return fused_nerf.nerf_train_loss(params, origins, directions, t_vals,
                                          dists, target, cfg)
    if backend == "plain":
        return nerf_loss_rays(params, origins, directions, t_vals, dists, target,
                              cfg.num_encoding_functions, cfg.mode, mlp_fn)
    raise ValueError(f"unknown backend {backend!r}")


def make_single_chip_train_step(cfg, optimizer: torch.optim.Optimizer,
                                backend: str = "auto", mlp_fn: Optional[Callable] = None,
                                reduce_fn: Optional[Callable] = None,
                                generator: Optional[torch.Generator] = None) -> Callable:
    """``step(model_or_params, origins, directions, t_vals, dists, target)
    -> loss``: the loss, zero the gradients, its backward, one
    ``optimizer.step()``; returns the loss as a detached 0-d tensor.  The
    optimizer must hold the same parameter tensors.

    The data-parallel step (``parallel.train_step.make_train_step``) is
    this step with ``reduce_fn(params, loss) -> loss``, which sums the
    gradients and the loss over the ranks between the backward and the
    update, and, under tensor parallelism, ``mlp_fn`` (see
    :func:`nerf_loss_fn`).  For ``NeRFConfig.paper()`` ``t_vals`` and
    ``dists`` are the coarse depths and one step runs both passes and one
    update of both networks; ``generator`` draws the fine depths (evenly
    spaced without one).

    Under a profiler the whole step is the span ``lomanerf.steps.train_step``
    (zero_grad, the optimizer and autograd carry PyTorch's own)."""
    backend = resolve_backend(cfg, backend)

    @spanned("lomanerf.steps.train_step")
    def step(model_or_params, origins, directions, t_vals, dists, target):
        params = (model_or_params.params if isinstance(model_or_params, torch.nn.Module)
                  else model_or_params)
        loss = nerf_loss_fn(params, origins, directions, t_vals, dists, target,
                            cfg, backend, mlp_fn, generator)
        # after the forward, so that its kernels start sooner; the
        # forward reads no gradient
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        loss = loss.detach()
        if reduce_fn is not None:
            loss = reduce_fn(params, loss)
        optimizer.step()
        return loss

    return step


def image_fit_loss_fn(params: Params, coords, target, cfg,
                      backend: str = "fused") -> torch.Tensor:
    """The sum-MSE of the image field on raw ``(N, 2)`` coords,
    differentiable w.r.t. params."""
    if backend == "fused":
        # the field kernel forward; its backward is the field's backward
        # kernel; on the config's precision tier, as the JAX step passes it
        from lomanerf_tpu_torch.ops import fused_mlp

        pred = fused_mlp.field_forward(params, coords, cfg.num_encoding_functions,
                                       cfg.out_channels, precision=cfg.precision)
        return sum_mse(pred, target)
    if backend == "plain":
        return image_fit_loss(params, positional_encoding(coords, cfg.num_encoding_functions),
                              target)
    raise ValueError(f"unknown backend {backend!r}")


def make_image_fit_step(cfg, optimizer: torch.optim.Optimizer,
                        backend: str = "auto") -> Callable:
    """2D-fit step: ``step(model_or_params, coords, target, seed=None) ->
    loss``.  Takes raw ``(N, 2)`` pixel coords (encoded on the device, inside
    the kernel on CUDA).  Zero the gradients, the loss, its backward seeded
    with ``seed`` (1 if None; the previous loss reproduces the reference's
    adjoint-seeding quirk, fit_img.py:497), one ``optimizer.step()``;
    returns the loss of the parameters before the update, detached."""
    backend = resolve_backend(cfg, backend)

    def step(model_or_params, coords, target, seed=None):
        params = (model_or_params.params if isinstance(model_or_params, torch.nn.Module)
                  else model_or_params)
        optimizer.zero_grad(set_to_none=True)
        loss = image_fit_loss_fn(params, coords, target, cfg, backend)
        if seed is None:
            loss.backward()
        else:
            loss.backward(gradient=torch.as_tensor(seed, dtype=loss.dtype,
                                                   device=loss.device))
        optimizer.step()
        return loss.detach()

    return step
