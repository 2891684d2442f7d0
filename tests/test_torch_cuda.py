"""The port's CUDA render kernel on the card (skips without one).

Imports neither jax nor the JAX package, so it also runs where only the
port is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

The kernel is held to its plain PyTorch version at atol/rtol 1e-4: both are
float32 and differ in the order of their sums and in sin/cos/exp.
"""

import dataclasses

import numpy as np
import pytest
import torch

from lomanerf_tpu_torch.core import mlp_layer_sizes, params_from_numpy, uniform_depths
from lomanerf_tpu_torch.models import NeRFConfig, NeRFModel
from lomanerf_tpu_torch.ops import fused_nerf

N_RAYS = 1037  # not a multiple of the kernel's 128-ray block


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False


def np_params(rng, cfg):
    sizes = mlp_layer_sizes(cfg.in_channels, cfg.out_channels, cfg.num_layers,
                            cfg.filter_size)
    ws = [(rng.standard_normal((fi, fo)) * np.sqrt(2.0 / fi)).astype(np.float32)
          for fi, fo in sizes]
    bs = [(rng.standard_normal(fo) * 0.5).astype(np.float32) for _, fo in sizes]
    return ws, bs


def cuda_rays(rng, n):
    return tuple(torch.from_numpy(rng.standard_normal((n, 3)).astype(np.float32)).cuda()
                 for _ in range(2))


@pytest.mark.cuda
@pytest.mark.parametrize("preset", ["small", "single64"])
@pytest.mark.parametrize("mode", ["loma", "standard"])
def test_kernel_matches_plain_version(preset, mode):
    need_card()
    rng = np.random.default_rng(215)
    cfg = dataclasses.replace(NeRFConfig.preset(preset), mode=mode)
    params = params_from_numpy(*np_params(rng, cfg), "cuda")
    o, d = cuda_rays(rng, N_RAYS)
    t, dists = uniform_depths(cfg.near, cfg.far, cfg.num_samples, "cuda")
    before = fused_nerf.launches
    got = fused_nerf.render_rays(params, o, d, t, dists, cfg)
    torch.cuda.synchronize()
    assert fused_nerf.launches == before + 1
    want = fused_nerf.render_rays_reference(params, o, d, t, dists, cfg)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_kernel_refuses_and_has_no_backward():
    need_card()
    rng = np.random.default_rng(0)
    cfg = NeRFConfig.small()
    params = params_from_numpy(*np_params(rng, cfg), "cuda")
    o, d = cuda_rays(rng, 64)
    t, dists = uniform_depths(cfg.near, cfg.far, cfg.num_samples, "cuda")
    with pytest.raises(NotImplementedError, match="B1/B2"):
        fused_nerf.render_rays(params, o, d, t.expand(64, -1), dists.expand(64, -1), cfg)
    with pytest.raises(NotImplementedError, match="C1/C2"):
        fused_nerf.render_rays(params, o, d, t, dists,
                               dataclasses.replace(cfg, compute_dtype="bfloat16"))
    wide = NeRFConfig(filter_size=128)
    with pytest.raises(NotImplementedError, match="C2"):
        fused_nerf.render_rays(params_from_numpy(*np_params(rng, wide), "cuda"),
                               o, d, t, dists, wide)
    for p in params["w"]:
        p.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="A2"):
        fused_nerf.render_rays(params, o, d, t, dists, cfg).sum().backward()


@pytest.mark.cuda
def test_render_image_chunks_give_identical_pixels():
    """One thread per ray: each pixel is the same whatever the chunking."""
    need_card()
    cfg = NeRFConfig.small()
    rng = np.random.default_rng(1)
    model = NeRFModel.from_numpy(cfg, *np_params(rng, cfg), device="cuda")
    K = torch.tensor([[1.1106, 0, 0.5], [0, 1.1106, 0.5], [0, 0, 1]], device="cuda")
    pose = torch.eye(4, device="cuda")
    pose[2, 3] = 4.0
    with torch.no_grad():
        whole = model.render_image(K, pose, 40)
        chunked = model.render_image(K, pose, 40, chunk=333)
    assert torch.equal(whole, chunked)
