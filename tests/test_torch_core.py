"""The PyTorch port's semantic core against the JAX package's core.

Same numpy-seeded inputs through ``lomanerf_tpu.core`` (jnp, fp32 HIGHEST)
and ``lomanerf_tpu_torch.core`` (PyTorch on the CPU).  Unless a test says
otherwise the tolerance is rtol 1e-5, atol 1e-6: both sides are float32 and
differ only in the order of sums and in their sin/cos/exp implementations.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lomanerf_tpu import core as jcore
from lomanerf_tpu_torch import core as tcore

RTOL, ATOL = 1e-5, 1e-6


def close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def np_params(rng, sizes):
    ws = [f32(rng, fi, fo) * np.float32(np.sqrt(2.0 / fi)) for fi, fo in sizes]
    bs = [f32(rng, fo) * np.float32(0.5) for _, fo in sizes]
    return ws, bs


@pytest.mark.parametrize("shape", [(16, 3), (4, 6, 3), (10, 2)])
@pytest.mark.parametrize("num_functions", [0, 5])
def test_positional_encoding(rng, shape, num_functions):
    x = f32(rng, *shape) * 3.0
    got = tcore.positional_encoding(torch.from_numpy(x), num_functions)
    want = jcore.positional_encoding(jnp.asarray(x), num_functions)
    assert got.shape[-1] == tcore.encoded_dim(shape[-1], num_functions)
    close(got, want)


def test_mlp_layer_sizes():
    for args in [(33, 4, 3, 30), (22, 3, 1, 16), (63, 4, 8, 256)]:
        assert tcore.mlp_layer_sizes(*args) == jcore.mlp_layer_sizes(*args)


@pytest.mark.parametrize("head", ["sigmoid", "rgba", "none"])
def test_mlp_apply_heads(rng, head):
    sizes = tcore.mlp_layer_sizes(33, 6, 3, 30)
    ws, bs = np_params(rng, sizes)
    x = f32(rng, 40, 33)
    got = tcore.mlp_apply(tcore.params_from_numpy(ws, bs, "cpu"),
                          torch.from_numpy(x), head=head)
    want = jcore.mlp_apply(jcore.params_from_numpy(ws, bs), jnp.asarray(x),
                           head=head)
    close(got, want)
    if head == "rgba":  # ch 3 is ReLU density, the rest sigmoid
        assert float(got[:, 3].min()) >= 0.0
        rgb = got[:, [0, 1, 2, 4, 5]]
        assert float(rgb.min()) > 0.0 and float(rgb.max()) < 1.0


def test_mlp_apply_rejects_unknown_head(rng):
    ws, bs = np_params(rng, [(3, 4)])
    with pytest.raises(ValueError):
        tcore.mlp_apply(tcore.params_from_numpy(ws, bs, "cpu"),
                        torch.zeros(1, 3), head="softmax")


@pytest.mark.parametrize("init", ["he", "randn", "nerf"])
def test_init_mlp(init):
    """Shapes, determinism under one generator seed, and the init rules
    (distributions differ from jax.random's stream by design)."""
    def make(seed):
        g = torch.Generator().manual_seed(seed)
        return tcore.init_mlp(g, 33, 4, 3, 30, init=init)

    p, q = make(0), make(0)
    sizes = tcore.mlp_layer_sizes(33, 4, 3, 30)
    assert [tuple(w.shape) for w in p["w"]] == sizes
    assert [b.shape[0] for b in p["b"]] == [fo for _, fo in sizes]
    for a, b in zip(p["w"] + p["b"], q["w"] + q["b"]):
        assert torch.equal(a, b)
    if init == "nerf":
        assert float(p["b"][0].abs().max()) == 0.0
        assert float(p["b"][-1][3]) == 0.5
    if init == "he":  # W ~ N(0, sqrt(2/fan_in)): loose check on 990 draws
        assert abs(float(p["w"][0].std()) - np.sqrt(2 / 33)) < 0.05
    with pytest.raises(ValueError):
        tcore.init_mlp(torch.Generator(), 3, 4, 1, init="xavier")


@pytest.mark.parametrize("mode", ["loma", "standard"])
def test_render_weights(rng, mode):
    sigma = np.abs(f32(rng, 12, 9)) * 2.0
    sigma[0, :] = 0.0  # an empty ray
    t = np.linspace(2.0, 6.0, 9, dtype=np.float32)
    dists = np.concatenate([t[1:] - t[:-1], [1e8]]).astype(np.float32)
    got = tcore.render_weights(torch.from_numpy(sigma), torch.from_numpy(dists), mode)
    want = jcore.render_weights(jnp.asarray(sigma), jnp.asarray(dists), mode)
    close(got, want)
    with pytest.raises(ValueError):
        tcore.render_weights(torch.from_numpy(sigma), torch.from_numpy(dists), "x")


def test_accumulate_color_and_depth(rng):
    w = np.abs(f32(rng, 7, 5))
    rgb = np.abs(f32(rng, 7, 5, 3))
    t = np.linspace(2.0, 6.0, 5, dtype=np.float32)
    close(tcore.accumulate_color(torch.from_numpy(w), torch.from_numpy(rgb)),
          jcore.accumulate_color(jnp.asarray(w), jnp.asarray(rgb)))
    close(tcore.accumulate_depth(torch.from_numpy(w), torch.from_numpy(t)),
          jcore.accumulate_depth(jnp.asarray(w), jnp.asarray(t)))


@pytest.mark.parametrize("mode", ["loma", "standard"])
def test_render_weights_grad_finite_at_saturated_alpha(mode):
    """c = exp(-sigma*d) + 1e-10 keeps c > 0 where alpha saturates, so the
    adjoints through the cumprod stay finite (the folded-epsilon trap)."""
    sigma = torch.full((2, 6), 1e4, dtype=torch.float32, requires_grad=True)
    dists = torch.tensor([0.5] * 5 + [1e8], dtype=torch.float32)
    w = tcore.render_weights(sigma, dists, mode)
    assert bool(torch.all(torch.exp(-sigma.detach() * dists) == 0.0))  # saturated
    w.sum().backward()
    assert bool(torch.isfinite(sigma.grad).all())


def test_zero_density_with_far_sentinel():
    """sigma = 0 exactly against the 1e8 sentinel: 0 * 1e8 = 0, so the last
    sample's alpha and weight are exactly 0 and nothing is NaN."""
    sigma = torch.zeros(3, 5)
    t, dists = tcore.uniform_depths(2.0, 6.0, 5, "cpu")
    assert float(dists[-1]) == 1e8
    for mode in ("loma", "standard"):
        w = tcore.render_weights(sigma, dists, mode)
        assert bool(torch.all(w == 0.0))
    sigma[:, -1] = 2.0  # the sentinel sample then takes all remaining light
    w = tcore.render_weights(sigma, dists, "standard")
    assert bool(torch.allclose(w[:, -1], torch.ones(3)))


@pytest.mark.parametrize("normalize", [False, True])
def test_get_rays(rng, normalize):
    from lomanerf_tpu.data import sphere_poses

    pose = sphere_poses(5, radius=4.0)[2]
    K = jcore.normalized_intrinsics(1.1106)
    o_j, d_j = jcore.get_rays(12, 12, K, jnp.asarray(pose), normalize=normalize)
    o_t, d_t = tcore.get_rays(12, 12, tcore.normalized_intrinsics(1.1106, "cpu"),
                              torch.from_numpy(pose), normalize=normalize)
    close(tcore.normalized_intrinsics(1.1106, "cpu"), K)
    assert o_t.shape == d_t.shape == (144, 3)
    close(o_t, o_j)
    close(d_t, d_j)


def test_sample_along_rays_uniform(rng):
    o, d = f32(rng, 9, 3), f32(rng, 9, 3)
    pts_t, t_t, dists_t = tcore.sample_along_rays(
        torch.from_numpy(o), torch.from_numpy(d), 2.0, 6.0, 30)
    pts_j, t_j, dists_j = jcore.sample_along_rays(
        jnp.asarray(o), jnp.asarray(d), 2.0, 6.0, 30)
    assert t_t.shape == dists_t.shape == (30,)  # per-ray-uniform contract
    close(t_t, t_j)
    close(dists_t, dists_j)
    close(pts_t, pts_j)


def test_sample_along_rays_stratified():
    """Stratified depths are per ray (N, S), each within its bin; the jitter
    comes from the torch.Generator (JAX's stream differs by design)."""
    o, d = torch.zeros(50, 3), torch.ones(50, 3)
    g = torch.Generator().manual_seed(3)
    _, t, dists = tcore.sample_along_rays(o, d, 2.0, 6.0, 8, generator=g)
    base = torch.linspace(2.0, 6.0, 8)
    assert t.shape == dists.shape == (50, 8)
    off = t - base
    assert float(off.min()) >= 0.0 and float(off.max()) <= 0.5 + 1e-6
    assert bool(torch.all(dists[:, -1] == 1e8))
    g2 = torch.Generator().manual_seed(3)
    assert torch.equal(t, tcore.sample_along_rays(o, d, 2.0, 6.0, 8, generator=g2)[1])


def test_losses_and_psnr(rng):
    a, b = np.abs(f32(rng, 8, 8, 3)), np.abs(f32(rng, 8, 8, 3))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    close(tcore.sum_mse(ta, tb), jcore.sum_mse(ja, jb))
    close(tcore.mean_mse(ta, tb), jcore.mean_mse(ja, jb))
    close(tcore.psnr(ta, tb), jcore.psnr(ja, jb))
    close(tcore.psnr(ta, tb, max_val=2.0), jcore.psnr(ja, jb, max_val=2.0))


@pytest.mark.parametrize("mode", ["loma", "standard"])
def test_nerf_render_pipeline(rng, mode):
    """The port's oracle pipeline (points -> encoding -> MLP -> compositing)
    against the JAX core at both (S,) and per-ray (N, S) depths."""
    ws, bs = np_params(rng, tcore.mlp_layer_sizes(33, 4, 3, 30))
    o, d = f32(rng, 11, 3), f32(rng, 11, 3)
    _, t, dists = jcore.sample_along_rays(jnp.asarray(o), jnp.asarray(d), 2.0, 6.0, 12)
    for tv, dv in [(t, dists), (jnp.broadcast_to(t, (11, 12)), jnp.broadcast_to(dists, (11, 12)))]:
        got = tcore.nerf_render_rays(
            tcore.params_from_numpy(ws, bs, "cpu"), torch.from_numpy(o),
            torch.from_numpy(d), torch.from_numpy(np.array(tv)),
            torch.from_numpy(np.array(dv)), 5, mode)
        want = jcore.nerf_render_rays(jcore.params_from_numpy(ws, bs),
                                      jnp.asarray(o), jnp.asarray(d), tv, dv, 5, mode)
        close(got, want)
