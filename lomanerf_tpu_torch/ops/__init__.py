"""Hand-written CUDA kernels (sm_90a) with their plain PyTorch versions.

``fused_nerf`` — the narrow render forward (``csrc/nerf_render_fwd.cu``),
its backward (``csrc/nerf_render_bwd.cu``) and the fused train loss
(``csrc/nerf_train.cu``), sharing ``csrc/nerf_common.cuh`` and
``csrc/nerf_grad.cuh``, and the wide flagship kernels
(``csrc/nerf_wide_*``); ``fused_mlp`` — the 2D image field's forward
(``csrc/field_fwd.cu``) and its backward (``csrc/field_bwd.cu``), sharing
``csrc/field_common.cuh``; ``scans`` — the segmented scans every NeRF
kernel composites with (``csrc/seg_scan.cuh``), alone
(``csrc/seg_scans.cu``); ``probe`` — the grid-overhead probe's tile sum
(``csrc/grid_sum.cu``); ``wide_dw`` — the wide gradient sequence's bf16 dW
stage alone (``csrc/nerf_wide_dw.cuh``: wgmma fed by TMA); ``wide_gemm``
and ``f32_gemm`` — the wide chain's bf16 layer GEMM
(``csrc/nerf_wide_layer_gemm.cuh``) and its exact f32 GEMM
(``csrc/nerf_wide_f32_gemm.cuh``, also the wide field's "highest" tier)
alone; ``build`` — nvcc at first use, bound with ctypes.
"""
