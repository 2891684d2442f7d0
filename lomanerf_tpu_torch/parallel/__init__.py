"""Data-parallel rays and a tensor-parallel MLP on ``torch.distributed``
(port of ``lomanerf_tpu.parallel``; one process per card, a rank per JAX
process).  ``ray_sharding`` and ``replicated`` name JAX shardings and
``state_specs`` derives optax PartitionSpecs: the port has no counterpart
of them (``shard_batch`` places rows, ``place_state`` the train state)."""

from lomanerf_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    all_gather_cat,
    build_kernels_once,
    data_mesh,
    gather_global_batch,
    host_local_batch_to_global,
    initialize_multihost,
    is_primary,
    local_rank,
    make_mesh,
    process_count,
    process_index,
    rank_device,
    shard_batch,
)
from lomanerf_tpu_torch.parallel.launch import run_ranks  # noqa: F401
from lomanerf_tpu_torch.parallel.tp import (  # noqa: F401
    shard_tp_params,
    tp_mlp_apply,
    tp_param_specs,
    unshard_tp_params,
)
from lomanerf_tpu_torch.parallel.render_step import (  # noqa: F401
    make_render_step,
    shard_ray_chunks,
    sharded_render_fn,
    sharded_render_image,
)
from lomanerf_tpu_torch.parallel.train_step import (  # noqa: F401
    RayBatch,
    gather_state,
    make_train_step,
    place_state,
    render_rays_local,
)
