"""Single-device NeRF train step (port of ``lomanerf_tpu.train.steps``).

PyTorch runs eagerly: there is no ``jit`` and no buffer donation.  The step
updates the parameters in place through the optimizer built over them.
``make_image_fit_step`` waits for the 2D field's kernels (ROADMAP D1).
"""

from __future__ import annotations

from typing import Callable

import torch

from lomanerf_tpu_torch.core.mlp import Params
from lomanerf_tpu_torch.core.pipeline import nerf_loss_rays

BACKENDS = ("auto", "plain")


def resolve_backend(cfg, backend: str = "auto") -> str:
    """``"auto"`` is ``"fused"``: ``ops.fused_nerf.nerf_train_loss``, which
    runs the train kernel on CUDA params and its plain version on CPU params,
    so the params' device decides.  ``"plain"`` (autograd through the core
    pipeline) exists for comparisons only."""
    del cfg
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    return "fused" if backend == "auto" else backend


def nerf_loss_fn(params: Params, origins, directions, t_vals, dists, target, cfg,
                 backend: str = "fused") -> torch.Tensor:
    """The sum-MSE train loss of one ray batch, differentiable w.r.t. params."""
    if backend == "fused":
        # one kernel call gives the loss AND its gradients
        from lomanerf_tpu_torch.ops import fused_nerf

        return fused_nerf.nerf_train_loss(params, origins, directions, t_vals,
                                          dists, target, cfg)
    if backend == "plain":
        return nerf_loss_rays(params, origins, directions, t_vals, dists, target,
                              cfg.num_encoding_functions, cfg.mode)
    raise ValueError(f"unknown backend {backend!r}")


def make_single_chip_train_step(cfg, optimizer: torch.optim.Optimizer,
                                backend: str = "auto") -> Callable:
    """``step(model_or_params, origins, directions, t_vals, dists, target)
    -> loss``: zero the gradients, the loss, its backward, one
    ``optimizer.step()``; returns the loss as a detached 0-d tensor.  The
    optimizer must hold the same parameter tensors."""
    backend = resolve_backend(cfg, backend)

    def step(model_or_params, origins, directions, t_vals, dists, target):
        params = (model_or_params.params if isinstance(model_or_params, torch.nn.Module)
                  else model_or_params)
        optimizer.zero_grad(set_to_none=True)
        loss = nerf_loss_fn(params, origins, directions, t_vals, dists, target,
                            cfg, backend)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step
