"""lomanerf_tpu_torch — the PyTorch / CUDA (Hopper) port of ``lomanerf_tpu``.

Module paths and function names mirror the JAX package, so each counterpart
is easy to find; public functions keep its layouts (params
``{"w": [(in, out)], "b": [(out,)]}``, rays ``(N, 3)``, uniform depths
``(S,)``, colours ``(N, 3)``).  The package imports torch and numpy only.

* ``core``   — plain PyTorch semantic ops (the port's oracle layer)
* ``ops``    — hand-written CUDA kernels for sm_90a, their plain PyTorch
               versions, and the nvcc/ctypes build
* ``models`` — ``NeRFConfig``/``NeRFModel`` and ``ImageFieldConfig``/
               ``ImageFieldModel`` (``nn.Module``s)
* ``data``   — camera poses, the synthetic scene, the Blender loader, and
               the ray-batch prefetcher (``data.native``: a C++ worker pool
               built by g++ at first use, and its numpy twin)
* ``train``  — optimizers, the train step, checkpoints, logging, the
               ``train_nerf`` and ``fit_image`` drivers and the orbit
               renderer
* ``parallel`` — ``torch.distributed`` (one process per card): process
               set-up, the (data, model) mesh, the data-parallel train step
               (one SUM all-reduce), the sharded render, the
               tensor-parallel MLP and a launcher for ranks
* ``utils``  — profiling hooks (``trace``, ``device_memory_stats``)
* ``dsl``    — the loma DSL: parser, checks and type inference, lowered to
               eager PyTorch with ``torch.func`` autodiff (``dsl.compile``)
* ``examples`` — the DSL and data demos (``python -m
               lomanerf_tpu_torch.examples.<name>``)
* ``entry``  — the driver entry points: ``entry()`` (the flagship loss)
               and ``dryrun_multichip(n)`` (``python -m
               lomanerf_tpu_torch.entry [n]``)
* ``parity`` — the golden-oracle harness (the reference loma compiler,
               driven through ctypes and gcc)

Tensors are made on the device of a function's inputs, or on the ``device``
it is given; randomness comes from a ``torch.Generator`` argument.  The
core functions the JAX package's top level exports are exported here too.
"""

__version__ = "0.1.0"

from lomanerf_tpu_torch.core import (  # noqa: F401
    accumulate_color,
    get_rays,
    init_mlp,
    mlp_apply,
    positional_encoding,
    psnr,
    render_weights,
    sample_along_rays,
    stratified_ray_offsets,
    sum_mse,
)
