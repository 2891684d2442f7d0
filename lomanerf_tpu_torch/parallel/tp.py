"""Tensor-parallel MLP, Megatron-style column/row alternation (port of
``lomanerf_tpu.parallel.tp``).

Hidden layers are sharded over the mesh's ``model`` group: even layers
column-parallel (output features sharded), odd layers row-parallel (input
features sharded), one all-reduce per pair.  ReLU runs on the column-sharded
activations, so only row layers communicate in the forward pass.

The collectives are the port's own ``torch.autograd.Function``s, with the
backward each needs when every rank of the model group computes the same
(replicated) loss:

* ``_CopyToModel`` ("f"): identity forward, all-reduce of the cotangent
  backward, at a column layer's input — each rank's cotangent holds only
  its own output columns' share;
* ``_ReduceFromModel`` ("g"): all-reduce forward, identity backward, at a
  row layer's output — the cotangent is replicated already;
* ``_GatherFromModel``: the odd-layer-count tail's all-gather of a column
  layer's output; backward takes the rank's own slice of the replicated
  cotangent and sums nothing.

``torch.distributed.nn.functional.all_reduce`` and ``all_gather`` would not
do: their backward all-reduces (or reduce-scatters) the cotangent again,
which multiplies a replicated loss's gradients by ``tp``.  The JAX module
has the same fault (ROADMAP F7): it has "g" but no "f", and under
``check_vma=False`` the transpose of its ``psum`` is a ``psum``; the port
is held to the single-device gradients of ``core`` instead.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

from lomanerf_tpu_torch.core.mlp import Params, _apply_head
from lomanerf_tpu_torch.parallel.mesh import all_gather_cat


def tp_param_specs(num_layers: int) -> Params:
    """The shard dimension of each TP param (``None``: replicated): even
    layers column-sharded (W ``(in, out/tp)`` on dim 1, b ``(out/tp,)`` on
    dim 0), odd layers row-sharded (W ``(in/tp, out)`` on dim 0, b
    replicated)."""
    w_specs: List[Optional[int]] = []
    b_specs: List[Optional[int]] = []
    for i in range(num_layers):
        w_specs.append(1 if i % 2 == 0 else 0)
        b_specs.append(0 if i % 2 == 0 else None)
    return {"w": w_specs, "b": b_specs}


def shard_dim(x, dim: Optional[int], tp: int, index: int):
    """Shard ``index`` of ``tp`` equal slices of ``x`` (a numpy array or a
    tensor; a view) along ``dim``; ``x`` itself where ``dim`` is None."""
    if dim is None:
        return x
    step = x.shape[dim] // tp
    sl = [slice(None)] * x.ndim
    sl[dim] = slice(index * step, (index + 1) * step)
    return x[tuple(sl)]


def shard_tp_params(params: Params, num_layers: int, tp: int, tp_index: int) -> Params:
    """Slice full params (numpy arrays or tensors, the JAX layout) into the
    shard owned by ``tp_index``; tensors come back as views."""
    specs = tp_param_specs(num_layers)
    return {k: [shard_dim(x, dim, tp, tp_index) for x, dim in zip(params[k], specs[k])]
            for k in ("w", "b")}


@torch.no_grad()
def unshard_tp_params(params: Params, num_layers: int, group) -> Params:
    """The full params from every model rank's shard (the inverse of
    :func:`shard_tp_params`, all-gathered over ``group``; replicated
    leaves as they are).  Every rank of the group must call it."""
    specs = tp_param_specs(num_layers)
    return {k: [all_gather_cat(x.detach(), group, dim) for x, dim in zip(params[k], specs[k])]
            for k in ("w", "b")}


class _CopyToModel(torch.autograd.Function):
    """f: identity forward; backward all-reduces the cotangent over the
    model group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    """g: all-reduce (sum) forward over the model group; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    """All-gather of the last dimension over the model group; backward
    takes this rank's slice of the (replicated) cotangent."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.width = group, x.shape[-1]
        return all_gather_cat(x, group, x.ndim - 1)

    @staticmethod
    def backward(ctx, g):
        i = dist.get_rank(ctx.group)
        return g[..., i * ctx.width:(i + 1) * ctx.width], None


def tp_mlp_apply(params: Params, x: torch.Tensor, head: str = "rgba",
                 group=None) -> torch.Tensor:
    """Forward the TP-sharded MLP (this rank's shard ``params``) on the
    replicated activations ``x``; the output is replicated.

    Column layer i: ``y_loc = f(x) @ W_loc + b_loc`` (output sharded).
    Row layer i:    ``y = g(x_loc @ W_loc) + b`` (output replicated).
    An odd layer count ends on a column layer, whose output is all-gathered
    so that the head sees every feature.  ``group`` is the model group; a
    ``None`` group is one rank holding the whole MLP."""
    n = len(params["w"])
    y = x
    for i, (w, b) in enumerate(zip(params["w"], params["b"])):
        if i % 2 == 0:
            if group is not None:
                y = _CopyToModel.apply(y, group)
            y = torch.matmul(y, w) + b
            if i == n - 1:
                if group is not None:
                    y = _GatherFromModel.apply(y, group)
                return _apply_head(y, head)
        else:
            y = torch.matmul(y, w)
            if group is not None:
                y = _ReduceFromModel.apply(y, group)
            y = y + b
        y = torch.clamp_min(y, 0.0) if i < n - 1 else _apply_head(y, head)
    return y
