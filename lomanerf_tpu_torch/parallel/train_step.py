"""Data- and tensor-parallel NeRF train steps (port of
``lomanerf_tpu.parallel.train_step``).

Rays are sharded over the mesh's data axis: each rank holds its own rows of
the step's batch (``mesh.shard_batch``, or its own draw in the driver).
Params are replicated over the data axis and, with ``tp``, sharded over the
model axis (``parallel.tp``).  A step on each rank: ``zero_grad``, the loss
of its shard, ``backward``, ONE all-reduce (sum) over the data group of
every gradient flattened into one buffer with the loss behind them, then
``optimizer.step()``.  The loss is a sum-MSE, so shard losses and gradients
add up to the whole batch's, as the JAX step's ``psum`` adds them;
``DistributedDataParallel`` averages and is not used.

The JAX module derives PartitionSpec trees for the optax state
(``state_specs``, ``_mirror_spec``); a torch optimizer keeps its state per
parameter tensor, so :func:`place_state` takes their place: it broadcasts
params and optimizer state from the data group's first rank and, with TP,
slices both into this rank's shard (a state tensor shaped like its param
is sliced like it; the rest is copied) and rebinds the optimizer to the
shards.  :func:`gather_state` is its inverse, for checkpoints.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional

import torch
import torch.distributed as dist

from lomanerf_tpu_torch.core.mlp import Params
from lomanerf_tpu_torch.core.pipeline import nerf_render_rays
from lomanerf_tpu_torch.parallel.mesh import Mesh, all_gather_cat
from lomanerf_tpu_torch.parallel.tp import (shard_dim, shard_tp_params, tp_mlp_apply,
                                            tp_param_specs, unshard_tp_params)
from lomanerf_tpu_torch.train.steps import make_single_chip_train_step, resolve_backend


class RayBatch(NamedTuple):
    """One training batch of rays.  ``t_vals``/``dists`` are ``(S,)``,
    shared by every ray and replicated over the ranks, or per-ray
    ``(N, S)`` (the stratified sampler's), sharded with the rays."""

    origins: torch.Tensor  # (N, 3)
    directions: torch.Tensor  # (N, 3)
    t_vals: torch.Tensor  # (N, S) or (S,)
    dists: torch.Tensor  # (N, S) or (S,)
    target: torch.Tensor  # (N, 3)


def _params_of(model_or_params) -> Params:
    if isinstance(model_or_params, torch.nn.Module):
        return model_or_params.params
    return model_or_params


def _leaves(params: Params):
    return [*params["w"], *params["b"]]


def render_rays_local(params: Params, batch: RayBatch, num_functions: int, mode: str,
                      mlp_fn: Callable) -> torch.Tensor:
    """Render this rank's rays through the core pipeline with ``mlp_fn``
    (``tp_mlp_apply`` under TP).  The JAX function's fused branch has no
    counterpart: ``make_train_step`` sends the kernels' backend straight
    to ``ops.fused_nerf.nerf_train_loss``."""
    return nerf_render_rays(params, batch.origins, batch.directions, batch.t_vals,
                            batch.dists, num_functions, mode, mlp_fn)


def _to_comm(t: torch.Tensor, mesh: Mesh, group) -> torch.Tensor:
    """``t`` where ``group``'s backend can take it: NCCL takes device
    tensors only, so a host tensor (Adam's step count) is copied to the
    mesh's device."""
    if group is not None and t.device.type == "cpu" and dist.get_backend(group) == "nccl":
        return t.to(mesh.device)
    return t


@torch.no_grad()
def _broadcast_(t: torch.Tensor, mesh: Mesh) -> None:
    """Overwrite ``t`` with the data group's first rank's ``t``."""
    if mesh.data_group is None:
        return
    buf = _to_comm(t, mesh, mesh.data_group)
    dist.broadcast(buf, src=mesh.data_source(), group=mesh.data_group)
    if buf is not t:
        t.copy_(buf)


def _rebind(optimizer: torch.optim.Optimizer, old, new, state_fn) -> None:
    """Point ``optimizer`` at the tensors ``new`` in place of ``old`` (one
    for one), carrying each one's state through ``state_fn(value, old_p)``."""
    swap = {id(o): n for o, n in zip(old, new)}
    for group in optimizer.param_groups:
        group["params"] = [swap.get(id(p), p) for p in group["params"]]
    state = {}
    for p, st in optimizer.state.items():
        state[swap.get(id(p), p)] = {k: state_fn(v, p) for k, v in st.items()}
    optimizer.state.clear()
    optimizer.state.update(state)


def place_state(mesh: Mesh, config, model_or_params, optimizer=None, tp: bool = False) -> Params:
    """Put the train state in the step's layout: params and optimizer state
    equal on every rank of a data group (broadcast from its first rank)
    and, with ``tp``, this rank's shard of each (``shard_tp_params``, the
    optimizer rebound to the shards).  Needed at the start and after a
    checkpoint restore.  Returns the params the step takes: the model's
    own tensors without TP, new leaf tensors with it."""
    params = _params_of(model_or_params)
    if tp:
        specs = tp_param_specs(config.num_layers)
        dims = {id(p): d for p, d in zip(_leaves(params), _leaves(specs))}
        shards = shard_tp_params(params, config.num_layers, mesh.tp, mesh.model_index)
        new = [torch.nn.Parameter(x.detach().clone(memory_format=torch.contiguous_format))
               for x in _leaves(shards)]

        def shard_state(v, p):
            if torch.is_tensor(v) and v.shape == p.shape:
                return shard_dim(v, dims[id(p)], mesh.tp, mesh.model_index).clone(
                    memory_format=torch.contiguous_format)
            return v.clone() if torch.is_tensor(v) else v

        if optimizer is not None:
            _rebind(optimizer, _leaves(params), new, shard_state)
        L = config.num_layers
        params = {"w": new[:L], "b": new[L:]}
    for p in _leaves(params):
        _broadcast_(p.data, mesh)
    if optimizer is not None:
        for st in optimizer.state.values():
            for v in st.values():
                if torch.is_tensor(v):
                    _broadcast_(v, mesh)
    return params


@torch.no_grad()
def gather_state(mesh: Mesh, config, params: Params, optimizer=None, tp: bool = False):
    """The inverse of :func:`place_state` under TP: ``(full params, full
    optimizer state_dict)`` all-gathered over the model group, the same at
    any world size.  Without TP: the params and ``optimizer.state_dict()``
    as they are.  Every rank of the model group must call it."""
    if not tp:
        return params, (optimizer.state_dict() if optimizer is not None else None)
    specs = tp_param_specs(config.num_layers)
    dims = {id(p): d for p, d in zip(_leaves(params), _leaves(specs))}
    full = unshard_tp_params(params, config.num_layers, mesh.model_group)
    if optimizer is None:
        return full, None
    sd = optimizer.state_dict()
    order = [p for g in optimizer.param_groups for p in g["params"]]
    for i, st in sd["state"].items():
        p = order[i]
        sd["state"][i] = {
            k: (all_gather_cat(_to_comm(v, mesh, mesh.model_group), mesh.model_group,
                               dims[id(p)]).to(v.device)
                if torch.is_tensor(v) and v.shape == p.shape else v)
            for k, v in st.items()}
    return full, sd


def _sum_over_data(mesh: Mesh, params: Params, loss: torch.Tensor) -> torch.Tensor:
    """The gradient all-reduce over the ray shards: every gradient and the
    loss in ONE flat buffer, summed over the data group; the grads become
    views of it.  Returns the summed loss."""
    leaves = _leaves(params)
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in leaves]
    flat = torch.cat([*(g.reshape(-1) for g in grads), loss.reshape(1)])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.data_group)
    off = 0
    for p in leaves:
        p.grad = flat[off:off + p.numel()].view_as(p)
        off += p.numel()
    return flat[off]


def make_train_step(cfg, optimizer: torch.optim.Optimizer, mesh: Mesh, tp: bool = False,
                    backend: str = "auto",
                    generator: Optional[torch.Generator] = None) -> Callable:
    """``step(model_or_params, batch) -> loss`` for this rank's shard
    ``batch`` (a :class:`RayBatch`); the loss returned is the whole batch's
    (summed over the data group), detached.

    ``train.steps.make_single_chip_train_step`` with the flat all-reduce
    between backward and update.  ``backend="auto"``: the loss and its
    gradients from ``ops.fused_nerf.nerf_train_loss`` (one launch of the
    train kernel on CUDA, of its ``*_rays`` instance for ``(N, S)`` depths;
    the plain version on the CPU); ``"plain"``: autograd through the core
    pipeline (``tp_mlp_apply`` under ``tp``).  The optimizer must hold the
    step's params (after :func:`place_state` under TP).  ``generator``
    draws ``NeRFConfig.paper()``'s fine depths (the single-card step's)."""
    if tp and resolve_backend(cfg, backend) == "fused":
        # the fused kernels hold the whole (padded) weight stack per block:
        # width-sharded params would compute something else
        raise ValueError("backend='auto' (the fused kernels) supports data parallelism "
                         "only (params replicated); use backend='plain' for tensor "
                         "parallelism")
    mlp_fn = (functools.partial(tp_mlp_apply, head="rgba", group=mesh.model_group)
              if tp else None)
    reduce_fn = (functools.partial(_sum_over_data, mesh)
                 if mesh.data_group is not None else None)
    local = make_single_chip_train_step(cfg, optimizer, backend, mlp_fn, reduce_fn,
                                        generator)

    def step(model_or_params, batch: RayBatch) -> torch.Tensor:
        return local(model_or_params, *batch)

    return step
