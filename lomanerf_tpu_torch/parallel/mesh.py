"""Process set-up and the (data, model) mesh on ``torch.distributed`` (port of
``lomanerf_tpu.parallel.mesh``).

The port runs one process per card: a *rank* here is what the JAX package
calls a *process*, and a JAX device on the ``data`` axis is a rank.  Rays
are data-parallel over the ranks, optionally with a tensor-parallel
``model`` axis (``parallel.tp``); the gradient reduction is one all-reduce
over the data axis (``parallel.train_step``).

Collectives: NCCL on CUDA, gloo on the CPU or where the caller asks for it
(two ranks on one card: NCCL refuses a second rank on the same GPU).  The
port uses only ``all_reduce``, ``broadcast``, ``all_gather`` and
``barrier``.  Gloo accepts CUDA tensors for each of them (checked on the
card) but stages them itself: it copies each one to pinned host memory,
runs the collective on the CPU and copies the result back, so a gloo
group's collectives cost two host copies each.  NCCL takes device tensors
only, so optimizer state kept on the host (``torch.optim.Adam``'s step
count) crosses it through an explicit device copy
(``train_step.place_state``).  There is no fallback from one backend to
the other: a missing backend raises.

Without a process group (one process, no coordinator, no torchrun
environment) every function here still works: the mesh is ``dp = tp = 1``
and its groups are ``None``, which the collectives of the port skip.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist


def is_primary() -> bool:
    """True on the rank that owns host-side writes (metrics, images,
    checkpoints): rank 0, or the one process without a process group."""
    return process_index() == 0


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_rank() -> int:
    """This rank's index on its node: torchrun's ``LOCAL_RANK``, else its
    global rank."""
    return int(os.environ.get("LOCAL_RANK", process_index()))


def rank_device(device: torch.device | str = "cuda") -> torch.device:
    """The device of this rank: ``cuda:{LOCAL_RANK % device_count}`` for
    CUDA (two ranks share a card when the node has fewer cards than
    ranks); a CUDA device with an index, or the CPU, as given."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    return torch.device("cuda", local_rank() % torch.cuda.device_count())


def initialize_multihost(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> bool:
    """Join or form the process group (the counterpart of
    ``jax.distributed.initialize``).

    * a no-op when a group exists already;
    * with ``coordinator`` (``host:port``, or a full ``init_method`` URL
      such as ``file:///tmp/rendezvous``): that rendezvous, with
      ``num_processes`` and ``process_id`` or else the ``WORLD_SIZE`` and
      ``RANK`` environment variables;
    * with torchrun's environment (``MASTER_ADDR``, ``WORLD_SIZE``,
      ``RANK``), which plays the part of ``JAX_COORDINATOR_ADDRESS``:
      ``env://``;
    * otherwise a no-op: one process.

    ``backend`` defaults to NCCL where CUDA is available and gloo
    elsewhere; pass ``"gloo"`` for ranks that share a card or run on the
    CPU.  NCCL that is not built in raises: there is no gloo fallback.
    Under NCCL each rank binds :func:`rank_device` first.  Returns whether
    it formed a group (whose owner destroys it at the end)."""
    if dist.is_initialized():
        return False
    env = os.environ
    if coordinator is None and not all(k in env for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK")):
        return False
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    kw = {}
    if backend == "nccl":
        if not dist.is_nccl_available():
            raise RuntimeError("initialize_multihost: backend nccl is not available in this "
                               "torch build; pass backend='gloo' for CPU ranks")
        kw["device_id"] = rank_device("cuda")
        torch.cuda.set_device(kw["device_id"])
    if coordinator is None:
        dist.init_process_group(backend, init_method="env://", **kw)
        return True
    init = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    world = num_processes if num_processes is not None else env.get("WORLD_SIZE")
    rank = process_id if process_id is not None else env.get("RANK")
    if world is None or rank is None:
        raise ValueError("initialize_multihost: a coordinator needs num_processes and "
                         "process_id (or the WORLD_SIZE and RANK environment variables)")
    dist.init_process_group(backend, init_method=init, world_size=int(world), rank=int(rank),
                            **kw)
    return True


def build_kernels_once() -> None:
    """Build the CUDA kernels on one rank per node and load them on all:
    local rank 0 runs ``ops.build.build()`` (seconds to minutes of nvcc on
    a fresh tree) while the others wait at a barrier, then every rank
    loads the library it built.  Without a process group: build and load."""
    from lomanerf_tpu_torch.ops import build

    if local_rank() == 0:
        build.build()
    if dist.is_initialized():
        dist.barrier()
    build.load()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place on a ``(data, model)`` grid of ranks, data axis
    outer: rank = data_index * tp + model_index.  ``data_group`` holds the
    ``dp`` ranks of this rank's model index (the gradient all-reduce and
    the sharded render's all-gather run over it), ``model_group`` the
    ``tp`` ranks of its data index (the tensor-parallel MLP's
    collectives).  Both are ``None`` without a process group."""

    dp: int
    tp: int
    data_index: int
    model_index: int
    data_group: Optional[dist.ProcessGroup]
    model_group: Optional[dist.ProcessGroup]
    device: torch.device

    def data_source(self) -> int:
        """Global rank of data index 0 in this rank's data group."""
        return self.model_index


def make_mesh(dp: Optional[int] = None, tp: int = 1,
              device: torch.device | str = "cpu") -> Mesh:
    """Build a ``(data, model)`` mesh over every rank.  ``dp=None`` gives
    the data axis the ranks the model axis leaves; ``dp * tp`` must equal
    the world size.  Every rank must call it (it creates process groups)."""
    world = process_count()
    if dp is None:
        if world % tp:
            raise ValueError(f"{world} ranks not divisible by tp={tp}")
        dp = world // tp
    if dp * tp != world:
        raise ValueError(f"dp*tp={dp * tp} must equal the {world} ranks")
    rank = process_index()
    data_index, model_index = divmod(rank, tp)
    data_group = model_group = None
    if dist.is_initialized():
        data_group, _ = dist.new_subgroups_by_enumeration(
            [[d * tp + m for d in range(dp)] for m in range(tp)])
        model_group, _ = dist.new_subgroups_by_enumeration(
            [[d * tp + m for m in range(tp)] for d in range(dp)])
    return Mesh(dp, tp, data_index, model_index, data_group, model_group,
                torch.device(device))


def data_mesh(device: torch.device | str = "cpu") -> Mesh:
    """All ranks on the data axis."""
    return make_mesh(tp=1, device=device)


def _rows(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's contiguous rows of a per-ray (rank >= 2) leaf; a 1-D
    leaf (the ``(S,)`` shared depths) is replicated."""
    if x.ndim < 2:
        return x
    n = x.shape[0]
    if n % mesh.dp:
        raise ValueError(f"{n} rays are not divisible by dp={mesh.dp}")
    k = n // mesh.dp
    return x[mesh.data_index * k:(mesh.data_index + 1) * k]


def _map(fn, batch):
    return type(batch)(*(fn(x) for x in batch))


def shard_batch(mesh: Mesh, batch):
    """This rank's shard of a GLOBAL batch (a tuple or ``RayBatch`` of
    tensors that every rank holds whole): the contiguous rows of its data
    index, as ``P("data")`` places them; 1-D leaves replicated.  Raises
    when the ray count is not divisible by ``dp``, as ``shard_map`` does."""
    return _map(lambda x: _rows(mesh, x), batch)


def host_local_batch_to_global(mesh: Mesh, batch):
    """The counterpart of the JAX helper that stitches each host's LOCAL
    batch into global arrays: here a rank's local batch already is its
    shard, so no data moves.  Checks that the per-ray leaves share their
    leading dimension and returns the batch unchanged
    (:func:`gather_global_batch` assembles the global batch)."""
    del mesh
    ns = {x.shape[0] for x in batch if x.ndim >= 2}
    if len(ns) > 1:
        raise ValueError(f"per-ray leaves with different ray counts {sorted(ns)}")
    return batch


def all_gather_cat(x: torch.Tensor, group, dim: Optional[int] = 0) -> torch.Tensor:
    """``x`` from every rank of ``group`` (equal shapes) concatenated along
    ``dim`` in rank order; ``x`` itself without a group or with ``dim``
    None (a replicated leaf)."""
    if group is None or dim is None:
        return x
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def gather_global_batch(mesh: Mesh, batch):
    """The global batch assembled from every rank's local shard over the
    data group (per-ray leaves concatenated in data order, 1-D leaves as
    they are): for tests and checks."""
    return _map(lambda x: all_gather_cat(x, mesh.data_group) if x.ndim >= 2 else x, batch)
