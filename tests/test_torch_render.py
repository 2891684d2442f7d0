"""The port's fused render (``lomanerf_tpu_torch.ops.fused_nerf``).

On CPU tensors ``render_rays`` runs its plain PyTorch version; these tests
hold that against the JAX package's Pallas render (``_nerf_forward_kernel_S``
in interpret mode, as tests/test_pallas_kernels.py runs it) and against the
JAX core pipeline, at rtol 3e-4 / atol 1e-5 — the JAX test's own bound for
the same comparison.  The CUDA kernel itself runs only on the card: its
packed-parameter layout is checked here by a numpy walk of the buffer with
the kernel's offsets and per-ray loop; tests/test_torch_cuda.py compares
the kernel with the plain version on the card.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lomanerf_tpu.core import params_from_numpy as j_params
from lomanerf_tpu.core import sample_along_rays as j_sample
from lomanerf_tpu.core.pipeline import nerf_render_rays as j_pipeline
from lomanerf_tpu.models import NeRFConfig as JConfig
from lomanerf_tpu.ops import fused_nerf as j_fused
from lomanerf_tpu_torch.core import mlp_layer_sizes, params_from_numpy, uniform_depths
from lomanerf_tpu_torch.models import NeRFConfig
from lomanerf_tpu_torch.ops import fused_nerf

RTOL, ATOL = 3e-4, 1e-5


def np_params(rng, sizes):
    ws = [(rng.standard_normal((fi, fo)) * np.sqrt(2.0 / fi)).astype(np.float32)
          for fi, fo in sizes]
    bs = [(rng.standard_normal(fo) * 0.5).astype(np.float32) for _, fo in sizes]
    return ws, bs


def rays(rng, n):
    return (rng.standard_normal((n, 3)).astype(np.float32),
            rng.standard_normal((n, 3)).astype(np.float32))


@pytest.mark.parametrize("mode", ["loma", "standard"])
@pytest.mark.parametrize("num_samples", [8, 30])
def test_render_rays_cpu_matches_jax_fused_and_core(rng, mode, num_samples):
    jcfg = JConfig(num_samples=num_samples, mode=mode)
    cfg = NeRFConfig(num_samples=num_samples, mode=mode)
    ws, bs = np_params(rng, mlp_layer_sizes(33, 4, 3, 30))
    o, d = rays(rng, 20)  # not a tile multiple
    _, t, dists = j_sample(jnp.asarray(o), jnp.asarray(d), 2.0, 6.0, num_samples)

    got = fused_nerf.render_rays(
        params_from_numpy(ws, bs, "cpu"), torch.from_numpy(o), torch.from_numpy(d),
        torch.from_numpy(np.array(t)), torch.from_numpy(np.array(dists)), cfg)
    assert got.shape == (20, 3) and got.dtype == torch.float32
    want_kernel = j_fused.render_rays(j_params(ws, bs), jnp.asarray(o),
                                      jnp.asarray(d), t, dists, jcfg)
    want_core = j_pipeline(j_params(ws, bs), jnp.asarray(o), jnp.asarray(d), t,
                           dists, 5, mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_kernel), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_core), rtol=RTOL, atol=ATOL)


def test_render_rays_cpu_per_ray_depths(rng):
    """The plain version also takes per-ray (N, S) depths, as the JAX render does."""
    cfg = NeRFConfig(num_samples=8)
    ws, bs = np_params(rng, mlp_layer_sizes(33, 4, 3, 30))
    o, d = rays(rng, 6)
    _, t, dists = j_sample(jnp.asarray(o), jnp.asarray(d), 2.0, 6.0, 8)
    t2, d2 = np.broadcast_to(np.array(t), (6, 8)), np.broadcast_to(np.array(dists), (6, 8))
    got = fused_nerf.render_rays(params_from_numpy(ws, bs, "cpu"), torch.from_numpy(o),
                                 torch.from_numpy(d), torch.tensor(t2), torch.tensor(d2), cfg)
    want = j_pipeline(j_params(ws, bs), jnp.asarray(o), jnp.asarray(d), jnp.asarray(t2),
                      jnp.asarray(d2), 5, "loma")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_render_rays_cpu_grads_params_only(rng):
    """Like the JAX render, params get gradients and ray inputs are detached."""
    cfg = NeRFConfig(num_samples=8)
    ws, bs = np_params(rng, mlp_layer_sizes(33, 4, 2, 16))
    params = params_from_numpy(ws, bs, "cpu")
    for p in params["w"] + params["b"]:
        p.requires_grad_(True)
    o = torch.from_numpy(rays(rng, 5)[0]).requires_grad_(True)
    t, dists = uniform_depths(2.0, 6.0, 8, "cpu")
    fused_nerf.render_rays(params, o, torch.ones(5, 3), t, dists, cfg).sum().backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in params["w"] + params["b"])
    assert o.grad is None


def kernel_walk(pk, origins, directions, S, L, in_dim, nf, W, loma):
    """numpy re-statement of nerf_render_fwd.cu's per-ray loop, reading the
    packed buffer with the kernel's own offsets (f64 arithmetic)."""
    pk = pk.astype(np.float64)
    l0_cols = 4 if L == 1 else W
    w_first = 0
    w_hidden = w_first + in_dim * l0_cols + l0_cols
    w_head = w_hidden + (L - 2) * (W * W + W) if L >= 2 else 0
    ts = w_hidden if L == 1 else w_head + W * 4 + 4
    t, dist = pk[ts:ts + S], pk[ts + S:ts + 2 * S]

    def layer(x, off, rows, cols):
        w = pk[off:off + rows * cols].reshape(rows, cols)
        return x @ w + pk[off + rows * cols:off + rows * cols + cols]

    out = np.zeros((origins.shape[0], 3))
    for r in range(origins.shape[0]):
        P, acc = 1.0, np.zeros(3)
        for s in range(S):
            p = origins[r] + directions[r] * t[s]
            enc = [p]
            for i in range(nf):
                enc += [np.sin(2.0**i * p), np.cos(2.0**i * p)]
            z = layer(np.concatenate(enc), w_first, in_dim, l0_cols)
            if L >= 2:
                h = np.maximum(z, 0.0)
                for l in range(1, L - 1):
                    h = np.maximum(layer(h, w_hidden + (l - 1) * (W * W + W), W, W), 0.0)
                z = layer(h, w_head, W, 4)
            sigma = max(z[3], 0.0)
            e = np.exp(-sigma * dist[s])
            if loma:
                P *= e + 1e-10
                T = 1.0 if s == 0 else P
            else:
                T = P
                P *= e + 1e-10
            acc += (1.0 - e) * T / (1.0 + np.exp(-z[:3]))
        out[r] = acc
    return out


@pytest.mark.parametrize("layers,width,mode", [
    (3, 30, "loma"),       # small: W = 32
    (4, 64, "standard"),   # single64: W = 64
    (1, 30, "loma"),       # one layer: layer 0 is the head
    (2, 17, "standard"),   # no hidden-to-hidden layer
])
def test_packed_layout_matches_plain_render(rng, layers, width, mode):
    S = 7
    cfg = NeRFConfig(num_layers=layers, filter_size=width, num_samples=S, mode=mode)
    ws, bs = np_params(rng, mlp_layer_sizes(33, 5, layers, width))  # 5 ch: extra ignored
    params = params_from_numpy(ws, bs, "cpu")
    t, dists = uniform_depths(2.0, 6.0, S, "cpu")
    W = fused_nerf._kernel_width(cfg, params)
    assert W == (32 if width <= 32 else 64)
    pk = fused_nerf.pack_params(params, t, dists, W)
    assert pk.dtype == torch.float32 and pk.numel() % 4 == 0
    o, d = rays(rng, 9)
    got = kernel_walk(pk.numpy(), o.astype(np.float64), d.astype(np.float64), S,
                      layers, 33, 5, W, mode == "loma")
    want = fused_nerf.render_rays_reference(params, torch.from_numpy(o),
                                            torch.from_numpy(d), t, dists, cfg)
    np.testing.assert_allclose(got, want.numpy(), rtol=RTOL, atol=ATOL)


def test_kernel_refuses_what_it_does_not_take(rng):
    """Cases the CUDA kernel does not take raise, naming the ROADMAP item."""
    small = NeRFConfig.small()
    ws, bs = np_params(rng, mlp_layer_sizes(33, 4, 3, 30))
    params = params_from_numpy(ws, bs, "cpu")
    assert fused_nerf._kernel_width(small, params) == 32
    with pytest.raises(NotImplementedError, match="C1/C2"):
        fused_nerf._kernel_width(dataclasses.replace(small, compute_dtype="bfloat16"), params)
    wide = params_from_numpy(*np_params(rng, mlp_layer_sizes(33, 4, 3, 65)), "cpu")
    with pytest.raises(NotImplementedError, match="C2"):
        fused_nerf._kernel_width(small, wide)
    with pytest.raises(ValueError):  # the n=4 encoding gives 27 inputs, not 33
        fused_nerf._kernel_width(dataclasses.replace(small, num_encoding_functions=4),
                                 params)
    with pytest.raises(NotImplementedError, match="A2"):
        fused_nerf._RenderFwd.backward(None, torch.ones(2, 3))
