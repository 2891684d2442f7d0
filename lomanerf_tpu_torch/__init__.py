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
* ``data``   — camera poses, the synthetic scene, the Blender loader
* ``train``  — optimizers, the train step, checkpoints, logging, the
               ``train_nerf`` and ``fit_image`` drivers and the orbit
               renderer
* ``utils``  — profiling hooks (``trace``, ``device_memory_stats``)

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
