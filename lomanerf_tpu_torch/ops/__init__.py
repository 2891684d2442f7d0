"""Hand-written CUDA kernels (sm_90a) with their plain PyTorch versions.

``fused_nerf`` — the narrow render forward (``csrc/nerf_render_fwd.cu``);
``build`` — nvcc at first use, bound with ctypes.
"""
