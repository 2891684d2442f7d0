"""lomanerf_tpu_torch — the PyTorch / CUDA (Hopper) port of ``lomanerf_tpu``.

Module paths and function names mirror the JAX package, so each counterpart
is easy to find; public functions keep its layouts (params
``{"w": [(in, out)], "b": [(out,)]}``, rays ``(N, 3)``, uniform depths
``(S,)``, colours ``(N, 3)``).  The package imports torch and numpy only.

* ``core``   — plain PyTorch semantic ops (the port's oracle layer)
* ``ops``    — hand-written CUDA kernels for sm_90a, their plain PyTorch
               versions, and the nvcc/ctypes build
* ``models`` — ``NeRFConfig`` and ``NeRFModel`` (an ``nn.Module``)
* ``data``   — camera poses
* ``train``  — params fixtures and the orbit renderer

Tensors are made on the device of a function's inputs, or on the ``device``
it is given; randomness comes from a ``torch.Generator`` argument.
"""

__version__ = "0.1.0"
