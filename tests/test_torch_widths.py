"""NeRF MLPs at the widths the JAX kernels take and the port's kernels took
late: hidden widths padded to any multiple of 128 (C4: pw 384 and 512 here),
one-layer wide MLPs, and narrow MLPs in bf16 (A4), on the CPU.

On CPU tensors the port runs the plain version of its wide kernels
(``fused_nerf._WidePlain``, their rounding plan); it is held to the JAX
package's W kernels (shared ``(S,)`` depths) and packed kernels (per-ray
``(N, S)`` depths) in interpret mode, at ``tests/test_torch_wide.py``'s
bounds (f32: the JAX W test's; bf16: flips of a bf16 rounding measured
there).  A narrow MLP in bf16 takes the wide kernels at pw = 128 on the
card; its plain version is held to the JAX package's narrow bf16 kernels
(the S and T kernels) at the JAX test's own bounds
(``test_fused_nerf_bf16_compute_close``: colours rtol 0.05 / atol 0.02,
gradients within 0.1 of the leaf's largest entry).  The CUDA gradient
sequence at pw = 384 (``nerf_wide_chain.cuh``, one-layer MLPs included) is
restated in numpy (``test_torch_wide.kernel_sequence``) and held to the
plain version.  ``chip_smoke.py`` phase 24 holds the kernels themselves.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lomanerf_tpu import core as jcore
from lomanerf_tpu.models import NeRFConfig as JConfig
from lomanerf_tpu.ops import fused_nerf as j_fused
from lomanerf_tpu_torch import core as tcore
from lomanerf_tpu_torch.models import NeRFConfig
from lomanerf_tpu_torch.ops import fused_nerf

from test_torch_perray import stratified_batch
from test_torch_wide import (BF16_COL_ATOL, BF16_GRAD_REL, BF16_LOSS_RTOL, COL_ATOL, COL_RTOL,
                             GRAD_ATOL, GRAD_RTOL, LOSS_RTOL, batch, bf16_round, he_params,
                             kernel_sequence, nerf_init_params, three_ways)

# test_fused_nerf_bf16_compute_close (tests/test_pallas_kernels.py:388-412)
A4_RTOL, A4_ATOL, A4_GRAD_REL = 0.05, 0.02, 0.1
N, S = 20, 6  # rays (not a tile multiple) and samples


def held(got, want, compute_dtype):
    """The port's (colours, loss, train grads, render grads) against the
    JAX kernels' at the f32 or bf16 bounds."""
    if compute_dtype == "float32":
        np.testing.assert_allclose(got[0], want[0], rtol=COL_RTOL, atol=COL_ATOL)
        np.testing.assert_allclose(got[1], want[1], rtol=LOSS_RTOL)
        for a, b in zip(got[2] + got[3], want[2] + want[3]):
            np.testing.assert_allclose(a, b, rtol=GRAD_RTOL, atol=GRAD_ATOL)
        return
    assert np.abs(got[0] - want[0]).max() <= BF16_COL_ATOL
    assert abs(got[1] - want[1]) <= BF16_LOSS_RTOL * abs(want[1])
    for a, b in zip(got[2] + got[3], want[2] + want[3]):
        assert np.abs(a - b).max() <= BF16_GRAD_REL * np.abs(b).max()


def configs(compute_dtype, **kw):
    kw = dict(kw, compute_dtype=compute_dtype)
    if compute_dtype == "bfloat16":
        kw.update(precision="default", init="nerf")
    return NeRFConfig(**kw), JConfig(**kw)


def params_for(rng, cfg, width):
    sizes = tcore.mlp_layer_sizes(cfg.in_channels, 4, cfg.num_layers, width)
    return (nerf_init_params if cfg.init == "nerf" else he_params)(rng, sizes)


@pytest.mark.parametrize("depths", ["shared", "perray"])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("width,pw", [(384, 384), (400, 512)])
def test_wide_widths_match_jax_kernels(rng, width, pw, compute_dtype, depths):
    """2 layers at hidden width 384 (pw 384) and 400 (pw 512, a ragged
    width): the port's plain render, train loss and grads and render-loss
    grads vs the JAX W kernels (shared depths) or packed kernels (per-ray
    depths), which pad every width to a multiple of 128."""
    cfg, jcfg = configs(compute_dtype, num_layers=2, filter_size=width, num_samples=S,
                        mode="standard" if depths == "shared" else "loma")
    ws, bs = params_for(rng, cfg, width)
    assert fused_nerf._route(cfg, tcore.params_from_numpy(ws, bs, "cpu")) == ("wide", pw)
    b = batch(rng, N, S) if depths == "shared" else stratified_batch(rng, cfg, N, seed=pw)
    got, want = three_ways(ws, bs, b, cfg, jcfg)
    held(got, want, compute_dtype)


# At n = 12 the encoding's top octave is 2^11 p, and the JAX kernels take
# cos as sin(P + pi/2) with P + pi/2 rounded in f32 (about 4e-3 at |P| near
# 6e4): that moves the JAX kernels off the JAX core by up to 6.2e-5 on
# colours and 2.6e-4 of a leaf's largest gradient entry (measured over
# numpy seeds 215, 0, 1 at both depths), while the port's plain version
# (sin and cos of 2^i p, as the CUDA kernels compute them) stays within
# 1.5e-6 of the core.  f32 is held to the core at the f32 bounds and to the
# JAX kernels at about 4x that difference.
N12_COL_ATOL, N12_GRAD_REL = 2.5e-4, 1e-3


@pytest.mark.parametrize("compute_dtype,depths", [("float32", "shared"),
                                                  ("bfloat16", "perray")])
def test_one_layer_wide_matches_jax_kernels(rng, compute_dtype, depths):
    """A one-layer MLP on the n = 12 encoding (75 inputs: padded width 80,
    so wide at pw = 128): encoding -> rgba head, the head reading the
    encoded columns; vs the JAX kernels (and, in f32, the JAX core)."""
    cfg, jcfg = configs(compute_dtype, num_layers=1, num_encoding_functions=12,
                        num_samples=S, mode="standard")
    assert cfg.in_channels == 75
    ws, bs = params_for(rng, cfg, 0)
    assert [w.shape for w in ws] == [(75, 4)]
    assert fused_nerf._route(cfg, tcore.params_from_numpy(ws, bs, "cpu")) == ("wide", 128)
    b = batch(rng, N, S) if depths == "shared" else stratified_batch(rng, cfg, N, seed=12)
    got, want = three_ways(ws, bs, b, cfg, jcfg)
    if compute_dtype == "bfloat16":
        held(got, want, compute_dtype)
        return
    o, d, t, dists, tgt = (jnp.asarray(x) for x in b)
    jp = jcore.params_from_numpy(ws, bs)
    core_col = jcore.nerf_render_rays(jp, o, d, t, dists, 12, cfg.mode)
    core_g = jax.grad(lambda p: jcore.nerf_loss_rays(p, o, d, t, dists, tgt, 12, cfg.mode))(jp)
    np.testing.assert_allclose(got[0], np.asarray(core_col), rtol=COL_RTOL, atol=COL_ATOL)
    for a, r in zip(got[3], [*core_g["w"], *core_g["b"]]):
        np.testing.assert_allclose(a, np.asarray(r), rtol=GRAD_RTOL, atol=GRAD_ATOL)
    assert np.abs(got[0] - want[0]).max() <= N12_COL_ATOL
    np.testing.assert_allclose(got[1], want[1], rtol=N12_GRAD_REL)
    for a, r in zip(got[2] + got[3], want[2] + want[3]):
        assert np.abs(a - r).max() <= N12_GRAD_REL * np.abs(r).max()


@pytest.mark.parametrize("depths", ["shared", "perray"])
def test_narrow_bf16_matches_jax_narrow_bf16_kernels(rng, depths):
    """A4: the 3x30 MLP (ps 40) in bf16, routed to the wide kernels at
    pw = 128, against the JAX package's narrow bf16 kernels (the S kernels
    on shared depths, the T kernels on per-ray ones; their own tile) at the
    JAX test's bounds, and against the JAX f32 core at the same bounds."""
    cfg, jcfg = configs("bfloat16", num_samples=8)
    ws, bs = he_params(rng, tcore.mlp_layer_sizes(33, 4, 3, 30))
    params = tcore.params_from_numpy(ws, bs, "cpu")
    assert fused_nerf._route(cfg, params) == ("wide", 128)
    assert fused_nerf._route(dataclasses.replace(cfg, compute_dtype="float32"),
                             params) == ("narrow", 32)
    b = batch(rng, 16, 8) if depths == "shared" else stratified_batch(rng, cfg, 16, seed=4)
    got, want = three_ways(ws, bs, b, cfg, jcfg)
    o, d, t, dists, tgt = (jnp.asarray(x) for x in b)
    jp = jcore.params_from_numpy(ws, bs)
    core_col = jcore.nerf_render_rays(jp, o, d, t, dists, cfg.num_encoding_functions, cfg.mode)
    core_g = jax.grad(lambda p: jcore.nerf_loss_rays(p, o, d, t, dists, tgt,
                                                     cfg.num_encoding_functions, cfg.mode))(jp)
    core = [np.asarray(x) for x in [*core_g["w"], *core_g["b"]]]
    for ref_col, ref_grads in ((want[0], want[3]), (np.asarray(core_col), core)):
        np.testing.assert_allclose(got[0], ref_col, rtol=A4_RTOL, atol=A4_ATOL)
        for a, r in zip(got[3], ref_grads):
            assert np.abs(a - r).max() / (np.abs(r).max() + 1e-3) < A4_GRAD_REL
    # the train-loss gradients, against the JAX narrow bf16 train kernel
    for a, r in zip(got[2], want[2]):
        assert np.abs(a - r).max() / (np.abs(r).max() + 1e-3) < A4_GRAD_REL


@pytest.mark.parametrize("compute_dtype,layers,width,train", [
    ("float32", 3, 300, True),     # pw 384, ragged hidden width
    ("bfloat16", 2, 384, False),   # pw 384, the chain that renders past 256
    ("float32", 1, 0, True),       # one layer: the head reads the encoding
    ("bfloat16", 1, 0, False),
])
@pytest.mark.parametrize("depths", ["shared", "perray"])
def test_chain_sequence_at_new_widths_matches_plain(rng, compute_dtype, layers, width,
                                                    train, depths):
    """The CUDA gradient sequence (``nerf_wide_chain.cuh``) restated in
    numpy over ``pack_wide_params``' stacks at pw = 384 and for one-layer
    MLPs (the head's dW over the first kc columns of the encoded slot, no
    layer below it), equal to autograd of the plain version: ray chunks of
    4 and split-K chunks of 7 rows; bf16's dW stage in k-steps of 3."""
    S_, n = 5, 9
    nf = 12 if layers == 1 else 5
    cfg = NeRFConfig(num_layers=layers, filter_size=width, num_samples=S_, mode="standard",
                     num_encoding_functions=nf, compute_dtype=compute_dtype)
    ws, bs = nerf_init_params(rng, tcore.mlp_layer_sizes(cfg.in_channels, 4, layers, width))
    params = tcore.params_from_numpy(ws, bs, "cpu")
    kind, pw = fused_nerf._route(cfg, params)
    assert kind == "wide" and pw == (128 if layers == 1 else 384)
    o, d, t, dists, tgt = batch(rng, n, S_)
    if depths == "perray":
        _, t_r, d_r = tcore.sample_along_rays(torch.zeros(n, 3), torch.zeros(n, 3), 2.0, 6.0,
                                              S_, generator=torch.Generator().manual_seed(7))
        t, dists = t_r.numpy(), d_r.numpy()
    cot = tgt if train else rng.standard_normal((n, 3)).astype(np.float32)
    W, b = fused_nerf.pack_wide_params(params, pw, compute_dtype)
    rnd = bf16_round if compute_dtype == "bfloat16" else (lambda x: x)
    kc = -(-cfg.in_channels // 8) * 8
    dW, db, loss = kernel_sequence(
        W.double().numpy(), b.double().numpy(), t.astype(np.float64),
        dists.astype(np.float64), o.astype(np.float64), d.astype(np.float64),
        cot.astype(np.float64), S_, kc, nf, False, rnd, train, 4, 7,
        3 if compute_dtype == "bfloat16" else None)
    got = fused_nerf.unpack_wide_grads(torch.from_numpy(dW), torch.from_numpy(db), params)
    args = [torch.from_numpy(x) for x in (o, d, t, dists)]
    lv = [p.requires_grad_(True) for p in [*params["w"], *params["b"]]]
    if train:
        out = fused_nerf.nerf_train_loss_reference(params, *args, torch.from_numpy(tgt), cfg)
        np.testing.assert_allclose(loss, out.item(), rtol=LOSS_RTOL)
    else:
        out = (fused_nerf.render_rays_reference(params, *args, cfg)
               * torch.from_numpy(cot)).sum()
    for g, w in zip(got, torch.autograd.grad(out, lv)):
        if compute_dtype == "float32":
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=GRAD_RTOL, atol=GRAD_ATOL)
        else:  # f64 against f32 sums, bf16 roundings on both (test_torch_wide's bound)
            assert np.abs(g.numpy() - w.numpy()).max() <= 1.6e-4 * np.abs(w.numpy()).max()


def test_render_plan_and_scratch_at_new_widths():
    """The bf16 render runs its MLP fused only at pw 128 and 256 with a
    hidden layer (one activation slot a chunk), else on the layer chain
    (two), as ``nerf_wide_chain.cuh:fused_mlp_takes`` decides; the gradient
    chunk of an 8x1024 bf16 MLP at S = 128 keeps its activations within
    ``WIDE_GRAD_BYTES``, its dW partials (outside that budget) take under
    a fiftieth of it, and the flagship's chunk is unchanged."""
    bf16 = NeRFConfig(num_samples=128, compute_dtype="bfloat16")
    f32 = dataclasses.replace(bf16, compute_dtype="float32")
    assert fused_nerf.fused_mlp_takes(bf16, 8, 256)
    assert fused_nerf.fused_mlp_takes(bf16, 2, 128)
    assert not fused_nerf.fused_mlp_takes(bf16, 8, 384)
    assert not fused_nerf.fused_mlp_takes(bf16, 1, 128)
    assert not fused_nerf.fused_mlp_takes(f32, 8, 256)
    chunk = fused_nerf.wide_grad_chunk_rays(bf16, 1024, 8)
    assert chunk == fused_nerf.WIDE_GRAD_BYTES // (128 * (1024 * (8 * 2 + 8 + 4) + 16)) == 4678
    rows = chunk * 128
    parts = -(-rows // fused_nerf.WIDE_ROW_CHUNK) * 1024 * 1024 * 4
    assert parts == 74 * 4 * 2**20 and parts * 50 < fused_nerf.WIDE_GRAD_BYTES
    assert fused_nerf.wide_grad_chunk_rays(NeRFConfig.full(), 256, 8) == \
        fused_nerf.WIDE_GRAD_BYTES // (128 * (256 * (8 * 2 + 8 + 4) + 16)) == 18682
