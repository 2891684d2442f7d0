"""The port's CUDA kernels on the card (skips without one).

Imports neither jax nor the JAX package, so it also runs where only the
port is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

The narrow render kernel is held to its plain PyTorch version at atol/rtol 1e-4:
both are float32 and differ in the order of their sums and in sin/cos/exp.
The gradient kernels (train step #3, render backward #2) are held to
autograd of the plain version at the JAX test's bound for its fused train
kernel (loss rtol 1e-5; grads rtol 3e-4, atol 3e-5 scaled by the leaf's
largest entry where that is above 1, since these sums run over 1037 rays,
not 20), and two launches on the same inputs must agree bit for bit.  The
per-ray depth instances (``*_rays``: #4-#6, #10-#12) are held to the same
bounds (the wide bf16 ones to chip_smoke.py's; an f32 leaf that a ReLU-mask
flip moves off the plain version in f32 to the plain version in f64), and
on broadcast (S,) depths to the shared-depth kernels bit for bit, the wide
ones over many ray chunks to the one-chunk call.  The 2D field's kernels
(#13, #14) are held to the same bounds as the narrow ones, and so are
narrow MLPs past one block's shared memory on the wide kernels; the field's
"highest" tier (f32 FMA products) to the plain version in f64.  The
segmented scans (#15) and the grid-overhead probe's sum (#16) are held to
numpy's f64 results and their plain versions, the scans also bit for bit
to numpy's f32 sequential accumulate and the sum to the numpy restatement
of its fixed order; the wide chain's bf16 dW stage
(wgmma/TMA) to f64 of its rounded operands; the bf16 wide render's fused
MLP (wgmma/TMA) to the layer chain it replaced, bit for bit off near ties;
the wide chain's bf16 layer GEMM (wgmma/TMA, both forms) and its exact f32
GEMM (``nerf_wide_f32_gemm.cuh``, every form) to f64 and to their plain
versions, repeat launches bit for bit, the f32 GEMM's signed zeros to the
count of its zero terms.  The bf16 wide
gradient kernels' db, summed from column partials of the unrounded d_z, is
held to the f64 column sums of the plain path's f32 d_z.
"""

import dataclasses

import numpy as np
import pytest
import torch

from lomanerf_tpu_torch.core import mlp_layer_sizes, params_from_numpy, uniform_depths
from lomanerf_tpu_torch.models import (ImageFieldConfig, ImageFieldModel, NeRFConfig,
                                       NeRFModel, image_grid_coords)
from lomanerf_tpu_torch.ops import fused_mlp, fused_nerf
from lomanerf_tpu_torch.train.steps import make_image_fit_step

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
    before = fused_nerf.launches["nerf_render_fwd"]
    got = fused_nerf.render_rays(params, o, d, t, dists, cfg)
    torch.cuda.synchronize()
    assert fused_nerf.launches["nerf_render_fwd"] == before + 1
    want = fused_nerf.render_rays_reference(params, o, d, t, dists, cfg)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("preset", ["small", "single64", "small-S31"])
@pytest.mark.parametrize("mode", ["loma", "standard"])
@pytest.mark.parametrize("n_rays", [1, 31, N_RAYS])
def test_render_forward_groups_match_plain_repeat_and_broadcast(preset, mode, n_rays):
    """The render forward (#1, and #4 on per-ray depths), whose threads run a
    ray's samples in pairs: against the plain version at atol/rtol 1e-4 on
    uniform and on jittered depths, at S = 30 and 64 and at an odd S (the
    last pair ragged), two launches bit-identical, and #4 on the (S,)
    depths broadcast to (N, S) bit-identical to #1."""
    need_card()
    rng = np.random.default_rng(41)
    cfg = dataclasses.replace(NeRFConfig.small(), num_samples=31) if preset == "small-S31" \
        else NeRFConfig.preset(preset)
    cfg = dataclasses.replace(cfg, mode=mode)
    params = params_from_numpy(*np_params(rng, cfg), "cuda")
    o, d = cuda_rays(rng, n_rays)
    t, dists = uniform_depths(cfg.near, cfg.far, cfg.num_samples, "cuda")
    _, tj, dj = NeRFModel(cfg).sample(o, d, generator=torch.Generator("cuda").manual_seed(9))
    before = dict(fused_nerf.launches)
    with torch.no_grad():
        for tv, dv in ((t, dists), (tj, dj)):
            got = fused_nerf.render_rays(params, o, d, tv, dv, cfg)
            again = fused_nerf.render_rays(params, o, d, tv, dv, cfg)
            want = fused_nerf.render_rays_reference(params, o, d, tv, dv, cfg)
            torch.cuda.synchronize()
            assert torch.equal(got, again)
            torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
        shared = fused_nerf.render_rays(params, o, d, t, dists, cfg)
        rays = fused_nerf.render_rays(params, o, d, t.expand(n_rays, -1),
                                      dists.expand(n_rays, -1), cfg)
    assert torch.equal(shared, rays)
    assert fused_nerf.launches["nerf_render_fwd"] == before["nerf_render_fwd"] + 3
    assert fused_nerf.launches["nerf_render_fwd_rays"] == before["nerf_render_fwd_rays"] + 3


def grads_of(params, fn):
    """(value, *grads) of the 0-d ``fn()`` w.r.t. every param."""
    lv = [p.requires_grad_(True) for p in [*params["w"], *params["b"]]]
    out = fn()
    return (out.detach(), *torch.autograd.grad(out, lv))


def assert_grads_close(got, want):
    for g, w in zip(got, want):
        atol = 3e-5 * max(1.0, w.abs().max().item())
        torch.testing.assert_close(g, w, rtol=3e-4, atol=atol)


NARROW = {  # the narrow presets, and the one- and two-layer MLPs _route sends narrow
    "small": NeRFConfig.small(),
    "single64": NeRFConfig.single_view_64(),
    "1x30": NeRFConfig(num_layers=1, filter_size=30),  # layer 0 is the head
    "2x17": NeRFConfig(num_layers=2, filter_size=17),  # no hidden-to-hidden layer
}


@pytest.mark.cuda
@pytest.mark.parametrize("preset", list(NARROW))
@pytest.mark.parametrize("mode", ["loma", "standard"])
@pytest.mark.parametrize("n_rays", [N_RAYS, 64, 1])  # ragged, one full block, one ray
def test_gradient_kernels_match_plain_and_repeat_exactly(preset, mode, n_rays):
    """The train kernel (#3) and the render backward (#2) against autograd
    of the plain version, and bit-identical on a repeat launch: the narrow
    presets and the one- and two-layer MLPs, whose edge layers (layer 0's
    33 rows, the head's 4 columns) take the dW tile plan's ragged tiles."""
    need_card()
    rng = np.random.default_rng(7)
    cfg = dataclasses.replace(NARROW[preset], mode=mode)
    params = params_from_numpy(*np_params(rng, cfg), "cuda")
    o, d = cuda_rays(rng, n_rays)
    t, dists = uniform_depths(cfg.near, cfg.far, cfg.num_samples, "cuda")
    tgt = torch.from_numpy(rng.random((n_rays, 3)).astype(np.float32)).cuda()
    cot = torch.from_numpy(rng.standard_normal((n_rays, 3)).astype(np.float32)).cuda()

    def train(fn):
        return grads_of(params, lambda: fn(params, o, d, t, dists, tgt, cfg))

    def render_bwd(fn):
        return grads_of(params, lambda: (fn(params, o, d, t, dists, cfg) * cot).sum())

    before = dict(fused_nerf.launches)
    k1, k2 = train(fused_nerf.nerf_train_loss), train(fused_nerf.nerf_train_loss)
    b1, b2 = render_bwd(fused_nerf.render_rays), render_bwd(fused_nerf.render_rays)
    torch.cuda.synchronize()
    assert fused_nerf.launches["nerf_train"] == before["nerf_train"] + 2
    assert fused_nerf.launches["nerf_render_bwd"] == before["nerf_render_bwd"] + 2
    assert all(torch.equal(x, y) for x, y in zip(k1 + b1, k2 + b2))
    p = train(fused_nerf.nerf_train_loss_reference)
    torch.testing.assert_close(k1[0], p[0], rtol=1e-5, atol=0.0)
    assert_grads_close(k1[1:], p[1:])
    assert_grads_close(b1[1:], render_bwd(fused_nerf.render_rays_reference)[1:])


@pytest.mark.cuda
def test_train_loss_ray_inputs_get_no_gradient():
    need_card()
    rng = np.random.default_rng(3)
    cfg = NeRFConfig.small()
    params = params_from_numpy(*np_params(rng, cfg), "cuda")
    o, d = (x.requires_grad_(True) for x in cuda_rays(rng, 100))
    t, dists = uniform_depths(cfg.near, cfg.far, cfg.num_samples, "cuda")
    for p in [*params["w"], *params["b"]]:
        p.requires_grad_(True)
    loss = fused_nerf.nerf_train_loss(params, o, d, t, dists, torch.zeros(100, 3).cuda(), cfg)
    loss.backward()
    assert o.grad is None and d.grad is None
    assert all(p.grad is not None for p in params["w"])
    fused_nerf.nerf_loss(params, o, d, t, dists, torch.zeros(100, 3).cuda(), cfg).backward()
    assert o.grad is None and d.grad is None


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take():
    """Widths above 64 and wide bf16 launch the wide kernels, per-ray
    (N, S) depths their *_rays instances; widths above 256 (C4) and narrow
    bf16 (A4) launch them too; depths of mismatched shapes raise
    ValueError."""
    need_card()
    rng = np.random.default_rng(0)
    cfg = NeRFConfig.small()
    params = params_from_numpy(*np_params(rng, cfg), "cuda")
    o, d = cuda_rays(rng, 64)
    tgt = torch.zeros(64, 3, device="cuda")
    t, dists = uniform_depths(cfg.near, cfg.far, cfg.num_samples, "cuda")
    t2, d2 = t.expand(64, -1), dists.expand(64, -1)
    bf16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    before = dict(fused_nerf.launches)
    fused_nerf.render_rays(params, o, d, t2, d2, cfg)
    fused_nerf.nerf_train_loss(params, o, d, t2, d2, tgt, cfg)
    assert fused_nerf.launches["nerf_render_fwd_rays"] == before["nerf_render_fwd_rays"] + 1
    assert fused_nerf.launches["nerf_train_rays"] == before["nerf_train_rays"] + 1
    with pytest.raises(ValueError):
        fused_nerf.render_rays(params, o, d, t2, dists, cfg)
    with pytest.raises(ValueError):
        fused_nerf.nerf_train_loss(params, o[:10], d[:10], t2, d2, tgt[:10], cfg)
    before = dict(fused_nerf.launches)  # narrow bf16 (A4): the wide kernels at pw = 128
    fused_nerf.render_rays(params, o, d, t, dists, bf16)
    fused_nerf.nerf_train_loss(params, o, d, t, dists, tgt, bf16)
    torch.cuda.synchronize()
    assert fused_nerf.launches["nerf_wide_render_fwd"] == before["nerf_wide_render_fwd"] + 1
    assert fused_nerf.launches["nerf_wide_train"] == before["nerf_wide_train"] + 1
    for wide in (NeRFConfig(filter_size=128),
                 NeRFConfig(filter_size=256, compute_dtype="bfloat16")):
        wide_params = params_from_numpy(*np_params(rng, wide), "cuda")
        before = dict(fused_nerf.launches)
        fused_nerf.render_rays(wide_params, o, d, t, dists, wide)
        fused_nerf.nerf_train_loss(wide_params, o, d, t, dists, tgt, wide)
        torch.cuda.synchronize()
        assert fused_nerf.launches["nerf_wide_render_fwd"] == before["nerf_wide_render_fwd"] + 1
        assert fused_nerf.launches["nerf_wide_train"] == before["nerf_wide_train"] + 1
        fused_nerf.render_rays(wide_params, o, d, t2, d2, wide)
        assert fused_nerf.launches["nerf_wide_render_fwd_rays"] == \
            before["nerf_wide_render_fwd_rays"] + 1
    # past 256 (C4): the wide kernels at pw = 384, the bf16 render on the chain
    for too_wide in (NeRFConfig(filter_size=320),
                     NeRFConfig(filter_size=320, compute_dtype="bfloat16")):
        too_wide_params = params_from_numpy(*np_params(rng, too_wide), "cuda")
        assert fused_nerf._route(too_wide, too_wide_params) == ("wide", 384)
        before = dict(fused_nerf.launches)
        got = fused_nerf.render_rays(too_wide_params, o, d, t, dists, too_wide)
        fused_nerf.nerf_train_loss(too_wide_params, o, d, t, dists, tgt, too_wide)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        assert fused_nerf.launches["nerf_wide_render_fwd"] == before["nerf_wide_render_fwd"] + 1
        assert fused_nerf.launches["nerf_wide_train"] == before["nerf_wide_train"] + 1


PERRAY = {  # the narrow MLPs, and two wide ones (f32, and the bf16 flagship's plan)
    **NARROW,
    "wide-f32": NeRFConfig(num_layers=4, filter_size=128, num_samples=32),
    "wide-bf16": dataclasses.replace(NeRFConfig.full(), num_layers=4, num_samples=32),
}


@pytest.mark.cuda
@pytest.mark.parametrize("preset", list(PERRAY))
@pytest.mark.parametrize("mode", ["loma", "standard"])
@pytest.mark.parametrize("n_rays", [N_RAYS, 1])
def test_perray_kernels_match_plain_and_shared(preset, mode, n_rays):
    """The *_rays kernels on jittered (N, S) depths (NeRFModel.sample with a
    CUDA generator): colours, train loss and dW/db, render-backward dW/db
    against autograd of the plain version (chip_smoke.py phase 13's bounds:
    phases 1/4/7's; an f32 leaf that misses them against the plain version
    in f32, by a ReLU-mask flip, is held to it in f64);
    repeats bit-identical; broadcast (S,) depths through them equal the
    shared-depth kernels bit for bit."""
    need_card()
    rng = np.random.default_rng(13)
    cfg = dataclasses.replace(PERRAY[preset], mode=mode)
    params = params_from_numpy(*np_params(rng, cfg), "cuda")
    o, d = cuda_rays(rng, n_rays)
    model = NeRFModel(cfg)  # on the card by default
    _, t, dists = model.sample(o, d, generator=torch.Generator("cuda").manual_seed(5))
    assert t.shape == (n_rays, cfg.num_samples) and t.is_cuda
    tgt = torch.from_numpy(rng.random((n_rays, 3)).astype(np.float32)).cuda()
    cot = torch.from_numpy(rng.standard_normal((n_rays, 3)).astype(np.float32)).cuda()
    wide = fused_nerf._route(cfg, params)[0] == "wide"
    bf16 = cfg.compute_dtype == "bfloat16"
    col_atol = 2e-3 if bf16 else 1e-4

    def run(render, train, tv, dv):
        """(colours, loss, *dW/db, *render-backward dW/db)."""
        with torch.no_grad():
            col = render(params, o, d, tv, dv, cfg)
        k = grads_of(params, lambda: train(params, o, d, tv, dv, tgt, cfg))
        b = grads_of(params, lambda: (render(params, o, d, tv, dv, cfg) * cot).sum())
        return (col, *k, *b[1:])

    pre = "nerf_wide_" if wide else "nerf_"
    names = [pre + x + "_rays" for x in ("render_fwd", "train", "render_bwd")]
    before = dict(fused_nerf.launches)
    k1 = run(fused_nerf.render_rays, fused_nerf.nerf_train_loss, t, dists)
    k2 = run(fused_nerf.render_rays, fused_nerf.nerf_train_loss, t, dists)
    torch.cuda.synchronize()
    assert [fused_nerf.launches[x] - before[x] for x in names] == [4, 2, 2]
    assert all(torch.equal(x, y) for x, y in zip(k1, k2))
    p = run(fused_nerf.render_rays_reference, fused_nerf.nerf_train_loss_reference, t, dists)
    params64 = {k: [x.detach().double() for x in v] for k, v in params.items()}
    torch.testing.assert_close(k1[0], p[0], atol=col_atol, rtol=1e-4)
    torch.testing.assert_close(k1[1], p[1], rtol=1e-4 if bf16 else 1e-5, atol=0.0)
    if bf16:
        for g, w in zip(k1[2:], p[2:]):
            assert (g - w).abs().max() <= 1e-2 * w.abs().max()
    elif wide:
        assert_grads_close(k1[2:], p[2:])
    else:  # a leaf may miss against f32 by a ReLU-mask flip: then against f64
        k64 = grads_of(params64, lambda: fused_nerf.nerf_train_loss_reference(
            params64, o.double(), d.double(), t.double(), dists.double(), tgt.double(), cfg))
        b64 = grads_of(params64, lambda: (fused_nerf.render_rays_reference(
            params64, o.double(), d.double(), t.double(), dists.double(), cfg)
            * cot.double()).sum())
        for g, w, w64 in zip(k1[2:], p[2:], (*k64[1:], *b64[1:])):
            if not torch.allclose(g, w, rtol=3e-4, atol=3e-5 * max(1.0, w.abs().max().item())):
                assert_grads_close([g.double()], [w64])

    tu, du = uniform_depths(cfg.near, cfg.far, cfg.num_samples, "cuda")
    shared = run(fused_nerf.render_rays, fused_nerf.nerf_train_loss, tu, du)
    rays = run(fused_nerf.render_rays, fused_nerf.nerf_train_loss,
               tu.expand(n_rays, -1), du.expand(n_rays, -1))
    assert all(torch.equal(x, y) for x, y in zip(shared, rays))


@pytest.mark.cuda
@pytest.mark.parametrize("preset", ["wide-f32", "wide-bf16"])
def test_wide_perray_kernels_over_many_ray_chunks(preset, monkeypatch):
    """The wide *_rays kernels walk ray chunks, each reading the per-ray
    depths from its first ray on: with the scratch budgets cut so that 1037
    rays span many chunks, render chunks of 100 rays and gradient chunks of
    8192 / S rays (one split-K partial each, summed in the same order) equal
    the one-chunk call bit for bit; gradient chunks of 300 rays meet the
    plain version at the unchunked test's bounds."""
    need_card()
    rng = np.random.default_rng(17)
    cfg = PERRAY[preset]
    params = params_from_numpy(*np_params(rng, cfg), "cuda")
    o, d = cuda_rays(rng, N_RAYS)
    _, t, dists = NeRFModel(cfg).sample(o, d, generator=torch.Generator("cuda").manual_seed(3))
    tgt = torch.from_numpy(rng.random((N_RAYS, 3)).astype(np.float32)).cuda()
    cot = torch.from_numpy(rng.standard_normal((N_RAYS, 3)).astype(np.float32)).cuda()
    bf16 = cfg.compute_dtype == "bfloat16"

    def run(render, train):
        """(colours, loss, *dW/db, *render-backward dW/db)."""
        with torch.no_grad():
            col = render(params, o, d, t, dists, cfg)
        k = grads_of(params, lambda: train(params, o, d, t, dists, tgt, cfg))
        b = grads_of(params, lambda: (render(params, o, d, t, dists, cfg) * cot).sum())
        return (col, *k, *b[1:])

    kernel = (fused_nerf.render_rays, fused_nerf.nerf_train_loss)
    whole = run(*kernel)
    aligned = fused_nerf.WIDE_ROW_CHUNK // cfg.num_samples
    monkeypatch.setattr(fused_nerf, "wide_chunk_rays", lambda config, pw: 100)
    monkeypatch.setattr(fused_nerf, "wide_grad_chunk_rays", lambda config, pw, L: aligned)
    assert all(torch.equal(x, y) for x, y in zip(whole, run(*kernel)))
    monkeypatch.setattr(fused_nerf, "wide_grad_chunk_rays", lambda config, pw, L: 300)
    ragged = run(*kernel)
    p = run(fused_nerf.render_rays_reference, fused_nerf.nerf_train_loss_reference)
    assert torch.equal(ragged[0], whole[0])
    torch.testing.assert_close(ragged[1], p[1], rtol=1e-4 if bf16 else 1e-5, atol=0.0)
    if bf16:
        for g, w in zip(ragged[2:], p[2:]):
            assert (g - w).abs().max() <= 1e-2 * w.abs().max()
    else:
        assert_grads_close(ragged[2:], p[2:])


# bf16 db against the f64 column sums of the plain path's f32 d_z, as a
# share of the column's sum of |d_z|: the two d_z differ by the order of f32
# sums (and the bf16 roundings that order flips), not by db's own order: on
# an H100 the worst leaf read 3.5e-4 here, and a column sum of the kernel's
# f32 d_z read the same to 4 digits.
DB_GAP = 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["nerf_wide_train", "nerf_wide_render_bwd"])
def test_wide_bf16_db_sums_the_unrounded_d_z(entry):
    """For bf16 the wide gradient kernels write no f32 d_z: db comes from
    column partials of the unrounded d_z that compositing and the d_h GEMM
    write.  One call's db against the f64 column sums of the plain path's
    f32 d_z (``fused_nerf._wide_plain_dzs``) within ``DB_GAP`` of each
    column's sum of |d_z|; the loss, dW and db bit-identical across two
    launches."""
    need_card()
    rng = np.random.default_rng(29)
    cfg = PERRAY["wide-bf16"]
    params = params_from_numpy(*np_params(rng, cfg), "cuda")
    o, d = cuda_rays(rng, N_RAYS)
    t, dists = uniform_depths(cfg.near, cfg.far, cfg.num_samples, "cuda")
    tgt = torch.from_numpy(rng.random((N_RAYS, 3)).astype(np.float32)).cuda()
    cot = torch.from_numpy(rng.standard_normal((N_RAYS, 3)).astype(np.float32)).cuda()
    L = cfg.num_layers

    def run():
        if entry == "nerf_wide_train":
            return grads_of(params, lambda: fused_nerf.nerf_train_loss(
                params, o, d, t, dists, tgt, cfg))
        return grads_of(params, lambda: (fused_nerf.render_rays(
            params, o, d, t, dists, cfg) * cot).sum())

    before = fused_nerf.launches[entry]
    k1, k2 = run(), run()
    torch.cuda.synchronize()
    assert fused_nerf.launches[entry] == before + 2
    assert all(same_bits(x, y) for x, y in zip(k1, k2))
    with torch.no_grad():
        ws, bs = [w.detach() for w in params["w"]], [b.detach() for b in params["b"]]
        col, saved = fused_nerf._wide_plain_forward(ws, bs, o, d, t, dists, cfg)
        dcol = 2.0 * (col - tgt) if entry == "nerf_wide_train" else cot
        for l, dz, _ in fused_nerf._wide_plain_dzs(ws, saved, dcol, dists, cfg):
            got = k1[1 + L + l][: dz.shape[1]].double()
            want, scale = dz.double().sum(0), dz.double().abs().sum(0)
            gap = ((got - want).abs() / scale.clamp_min(1e-30)).max().item()
            print(f"{entry} db_{l}: worst |kernel - f64| / sum |d_z| {gap:.3e}")
            assert gap <= DB_GAP, (l, gap)


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


@pytest.mark.cuda
def test_wide_render_image_chunks_give_identical_pixels():
    """The wide kernels compute each row on its own (GEMM rows, one warp per
    ray): a flagship-width frame is the same whatever the chunking."""
    need_card()
    cfg = dataclasses.replace(NeRFConfig.full(), num_layers=4, num_samples=32)
    rng = np.random.default_rng(1)
    model = NeRFModel.from_numpy(cfg, *np_params(rng, cfg), device="cuda")
    K = torch.tensor([[1.1106, 0, 0.5], [0, 1.1106, 0.5], [0, 0, 1]], device="cuda")
    pose = torch.eye(4, device="cuda")
    pose[2, 3] = 4.0
    before = fused_nerf.launches["nerf_wide_render_fwd"]
    with torch.no_grad():
        whole = model.render_image(K, pose, 40)
        chunked = model.render_image(K, pose, 40, chunk=333)
    assert fused_nerf.launches["nerf_wide_render_fwd"] == before + 1 + 5
    assert torch.equal(whole, chunked)


# colours against the plain version: phase 7's bf16 bound (wide_tolerances)
FUSED_COL_ATOL = 2e-3
# the one case past it, at its measured 3.03e-3 (when the fused kernel's colours
# were the layer chain's bits): scripts/bf16_flips.py bisects it to one
# rounding flip at ray 984, hidden layer 2, sample 63, unit 228, where the f64
# sum lies 4.8e-7 from the bf16 rounding boundary, within the f32 sum's
# rounding (2.0e-6); the plain version continued from the kernel's layer-2
# output leaves 1.2e-7 of the colour error
FUSED_COL_ATOL_MEASURED = {("full", "standard", N_RAYS, 64, "perray"): 3.1e-3}
# share of rows on which the fused MLP and the layer chain may store
# different H_{L-1} (wide_mlp.tied_rows): 2.5x the largest share measured on
# an H100 over the cases of 66,368 rows or more (6.22%, full at S = 64), the
# rule test_torch_wide_mlp's NEAR_TIE_ROWS was set by; the tensor core's
# accumulator truncates, where that test's numpy order rounds to nearest (a
# numpy model of truncation put full at 6.3% before the card ran).  A
# one-ray case of 64 rows read 10.9% (7 rows).
NEAR_TIE_ROWS = 0.16
FUSED = {"full": NeRFConfig.full(),
         "4x128-bf16": dataclasses.replace(NeRFConfig.full(), num_layers=4, filter_size=128)}


@pytest.mark.cuda
@pytest.mark.parametrize("preset", list(FUSED))
@pytest.mark.parametrize("mode", ["loma", "standard"])
@pytest.mark.parametrize("n_rays", [N_RAYS, 1])
@pytest.mark.parametrize("S", [128, 64])
@pytest.mark.parametrize("depths", ["shared", "perray"])
def test_fused_mlp_render_equals_the_mma_chain(preset, mode, n_rays, S, depths):
    """The bf16 wide render (#8, #10 on per-ray depths) on the fused MLP
    (``csrc/nerf_wide_mlp.cuh``) against the layer chain it replaced
    (``wide_mlp.render_rays_layers``, on the ``wgmma`` layer GEMM that kept
    ``mma.sync``'s bits), at ragged 128-row tiles (1037 and 1 rays at S =
    128 and 64): the two sum each layer in another grouping, so their
    H_{L-1} are equal on every row without a near tie (``wide_mlp.tied_rows``:
    every value where they part a near tie, at most ``NEAR_TIE_ROWS`` of
    the rows tied), and so are the colours of the rays without one; repeat
    launches are bit-identical; both are within ``FUSED_COL_ATOL`` of the
    plain version (a case of ``FUSED_COL_ATOL_MEASURED`` within its own);
    the H_{L-1} of ``wide_mlp.wide_mlp`` is finite and its repeats
    bit-identical."""
    need_card()
    from lomanerf_tpu_torch.ops import wide_mlp

    rng = np.random.default_rng(n_rays + S)
    cfg = dataclasses.replace(FUSED[preset], mode=mode, num_samples=S)
    params = params_from_numpy(*np_params(rng, cfg), "cuda")
    kind, pw = fused_nerf._route(cfg, params)
    assert kind == "wide" and pw == cfg.filter_size
    W, b = fused_nerf.pack_wide_params(params, pw, cfg.compute_dtype)
    o, d = cuda_rays(rng, n_rays)
    t, dists = uniform_depths(cfg.near, cfg.far, S, "cuda")
    if depths == "perray":
        _, t, dists = NeRFModel(cfg).sample(o, d, generator=torch.Generator("cuda").manual_seed(S))
    before = dict(fused_nerf.launches), dict(wide_mlp.launches)
    new = fused_nerf._launch_wide_render(W, b, t, dists, o, d, cfg)
    again = fused_nerf._launch_wide_render(W, b, t, dists, o, d, cfg)
    old = wide_mlp.render_rays_layers(W, b, t, dists, o, d, cfg)
    h, h2 = wide_mlp.wide_mlp(W, b, t, o, d, cfg), wide_mlp.wide_mlp(W, b, t, o, d, cfg)
    plain = wide_mlp.render_reference(W, b, t, dists, o, d, cfg)
    torch.cuda.synchronize()
    entry = "nerf_wide_render_fwd" + ("_rays" if depths == "perray" else "")
    assert fused_nerf.launches[entry] == before[0][entry] + 2
    assert wide_mlp.launches["nerf_wide_render_fwd_layers"] == \
        before[1]["nerf_wide_render_fwd_layers"] + 1
    assert wide_mlp.launches["nerf_wide_mlp"] == before[1]["nerf_wide_mlp"] + 2
    assert torch.equal(new, again)
    atol = FUSED_COL_ATOL_MEASURED.get((preset, mode, n_rays, S, depths), FUSED_COL_ATOL)
    torch.testing.assert_close(new, plain, atol=atol, rtol=1e-4)
    assert h.shape == (n_rays * S, pw) and torch.equal(h, h2) and torch.isfinite(h.float()).all()
    tied, far, fused, chain = wide_mlp.tied_rows(W, b, t, dists, o, d, cfg)
    assert far == 0 and torch.equal(fused, h)
    assert tied.float().mean().item() <= NEAR_TIE_ROWS, tied.float().mean().item()
    assert torch.equal(h[~tied], chain[~tied])
    clear = ~tied.view(n_rays, S).any(1)
    assert torch.equal(new[clear], old[clear])


@pytest.mark.cuda
def test_fused_mlp_refuses_what_it_does_not_take():
    """The fused MLP's C entry refuses what its checks name (here an
    encoding wider than layer 0's rows) with an error, not a quiet fallback."""
    need_card()
    from lomanerf_tpu_torch.ops import build, wide_mlp

    cfg = NeRFConfig.full()
    W = torch.zeros((8, 256, 256), dtype=torch.bfloat16, device="cuda")
    b = torch.zeros((8, 256), device="cuda")
    o = torch.zeros((4, 3), device="cuda")
    t, _ = uniform_depths(cfg.near, cfg.far, cfg.num_samples, "cuda")
    out = torch.empty((4 * 128, 256), dtype=torch.bfloat16, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for kc, pw in ((32, 256), (40, 192)):  # 39 encoded columns need kc >= 40; pw 128 or 256
        err = build.load().nerf_wide_mlp(W.data_ptr(), b.data_ptr(), t.data_ptr(),
                                         o.data_ptr(), o.data_ptr(), out.data_ptr(), 4,
                                         128, 8, pw, kc, 6, 0, stream)
        assert err != 0
    with pytest.raises(ValueError):
        wide_mlp.wide_mlp(W.float(), b, t, o, o, cfg)


# ---------------------------------------------------------------------------
# The 2D image field (ops/fused_mlp.py: field_fwd.cu, field_bwd.cu)
# ---------------------------------------------------------------------------

FIELDS = {"small": ImageFieldConfig.small(), "hires": ImageFieldConfig.hires(),
          # five layers at width 128: seven weight copies a tile in the gradient
          "5x128": ImageFieldConfig(num_layers=5, filter_size=128, num_encoding_functions=8)}


@pytest.mark.cuda
@pytest.mark.parametrize("preset", list(FIELDS))
# ragged, around the 32-pixel tile, two tiles, one pixel; and 1024^2, where
# each block of the persistent grid walks hundreds of tiles (every copy of
# the two-slot weight schedule: the next tile's layer 0 in flight during this
# tile's d_h, the head's slot held across d_h)
@pytest.mark.parametrize("n_px", [1037, 64, 33, 32, 31, 1, 1 << 20])
def test_field_kernels_match_plain_and_repeat_exactly(preset, n_px):
    """field_fwd vs the plain version at atol/rtol 1e-4; field_bwd vs
    autograd of the plain version at rtol 3e-4, atol 3e-5 of max(1, the
    leaf's largest entry), and at 1024^2 within 5e-3 of each leaf's largest
    entry (``chip_smoke.py`` phase 10's bound there: both sides sum 1 M
    pixels in other orders, and a pre-activation within rounding of 0 takes
    a pixel's term out of a column); two launches agree bit for bit; coords
    get no gradient."""
    need_card()
    rng = np.random.default_rng(11)
    cfg = FIELDS[preset]
    params = params_from_numpy(*np_params(rng, cfg), "cuda")
    coords = torch.from_numpy(rng.random((n_px, 2)).astype(np.float32)).cuda()
    cot = torch.from_numpy(rng.standard_normal((n_px, 3)).astype(np.float32)).cuda()
    nf = cfg.num_encoding_functions

    def run(fn):
        c = coords.clone().requires_grad_(True)
        out = fn(params, c, nf)
        return (out.detach(), *grads_of(params, lambda: (fn(params, c, nf) * cot).sum())[1:])

    before = dict(fused_mlp.launches)
    k1, k2 = run(fused_mlp.field_forward), run(fused_mlp.field_forward)
    torch.cuda.synchronize()
    assert fused_mlp.launches["field_fwd"] == before["field_fwd"] + 4
    assert fused_mlp.launches["field_bwd"] == before["field_bwd"] + 2
    assert all(torch.equal(x, y) for x, y in zip(k1, k2))
    p = run(fused_mlp.field_forward_reference)
    torch.testing.assert_close(k1[0], p[0], atol=1e-4, rtol=1e-4)
    if n_px > 1037:
        for g, w in zip(k1[1:], p[1:]):
            assert (g - w).abs().max().item() <= 5e-3 * w.abs().max().item()
    else:
        assert_grads_close(k1[1:], p[1:])
    c = coords.clone().requires_grad_(True)
    fused_mlp.field_forward(params, c, nf).sum().backward()
    assert c.grad is None


@pytest.mark.cuda
@pytest.mark.parametrize("preset", list(FIELDS))
@pytest.mark.parametrize("n_px", [1037, 31])
def test_field_highest_tier_matches_f64_autograd(preset, n_px):
    """The field on the "highest" tier (f32 FMA products) against autograd of
    the plain version in f64: the forward at atol/rtol 1e-5, dW/db at the
    gradient kernels' bound (rtol 3e-4, atol 3e-5 of max(1, the leaf's
    largest entry)); repeats bit-identical; a model whose config asks for
    "highest" gets the same gradients through its own predict_coords."""
    need_card()
    rng = np.random.default_rng(43)
    cfg = dataclasses.replace(FIELDS[preset], precision="highest")
    params = params_from_numpy(*np_params(rng, cfg), "cuda")
    coords = torch.from_numpy(rng.random((n_px, 2)).astype(np.float32)).cuda()
    cot = torch.from_numpy(rng.standard_normal((n_px, 3)).astype(np.float32)).cuda()
    nf = cfg.num_encoding_functions

    def run(fn, prm, c, y):
        return grads_of(prm, lambda: (fn(prm, c, nf) * y).sum()), fn(prm, c, nf).detach()

    def exact(prm, c, n):
        return fused_mlp.field_forward(prm, c, n, precision="highest")
    (k, out), (k2, out2) = run(exact, params, coords, cot), run(exact, params, coords, cot)
    assert torch.equal(out, out2) and all(torch.equal(a, b) for a, b in zip(k, k2))
    p64 = {key: [x.detach().double() for x in v] for key, v in params.items()}
    w, want = run(fused_mlp.field_forward_reference, p64, coords.double(), cot.double())
    torch.testing.assert_close(out.double(), want, atol=1e-5, rtol=1e-5)
    assert_grads_close([g.double() for g in k[1:]], w[1:])
    model = ImageFieldModel(cfg)
    model.load_params(params)
    before = dict(fused_mlp.launches)
    got = grads_of(model.params, lambda: (model.predict_coords(coords) * cot).sum())
    assert fused_mlp.launches["field_bwd"] == before["field_bwd"] + 1
    assert all(torch.equal(a, b) for a, b in zip(got[1:], k[1:]))


@pytest.mark.cuda
def test_field_kernels_refuse_what_they_do_not_take():
    """Widths above 128, heads above 4 channels and fields whose tile does
    not fit shared memory (D2) run on the wide route (``field_wide.cu``):
    one launch of each of its kernels, outputs and dW/db at the plain
    version's (phase 10's f32 bounds); more than 128 output channels is
    refused, as the JAX field writes no more."""
    need_card()
    rng = np.random.default_rng(0)
    coords = torch.rand(64, 2, device="cuda")
    for cfg, out in ((ImageFieldConfig(filter_size=200), 3),
                     (ImageFieldConfig(out_channels=5), 5),
                     (ImageFieldConfig(num_layers=8, filter_size=128,
                                       num_encoding_functions=8), 3)):
        params = params_from_numpy(*np_params(rng, cfg), "cuda")
        leaves = [p.requires_grad_(True) for p in [*params["w"], *params["b"]]]
        nf = cfg.num_encoding_functions
        before = dict(fused_mlp.launches)
        got = fused_mlp.field_forward(params, coords, nf, out)
        k = torch.autograd.grad(got.sum(), leaves)
        torch.cuda.synchronize()
        assert fused_mlp.launches["field_wide_fwd"] == before["field_wide_fwd"] + 1
        assert fused_mlp.launches["field_wide_bwd"] == before["field_wide_bwd"] + 1
        want = fused_mlp.field_forward_reference(params, coords, nf, out)
        p = torch.autograd.grad(want.sum(), leaves)
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
        assert_grads_close(k, p)
    with pytest.raises(NotImplementedError, match="128 channels"):
        cfg = ImageFieldConfig(out_channels=129)
        fused_mlp.field_forward(params_from_numpy(*np_params(rng, cfg), "cuda"), coords,
                                cfg.num_encoding_functions, 129)


@pytest.mark.cuda
def test_image_fit_steps_on_card_follow_the_plain_backend():
    """5 Adam steps of the small field at 64x64 through the kernels and
    through the plain backend, from the same numpy init: one launch of each
    kernel per step, and losses within rtol 1e-4."""
    need_card()
    cfg = ImageFieldConfig(img_size=64)
    rng = np.random.default_rng(5)
    ws, bs = np_params(rng, cfg)
    coords = image_grid_coords(64, "cuda")
    target = torch.from_numpy(rng.random((64 * 64, 3)).astype(np.float32)).cuda()
    losses = {}
    for backend in ("auto", "plain"):
        model = ImageFieldModel.from_numpy(cfg, ws, bs, device="cuda", backend=backend)
        step = make_image_fit_step(cfg, torch.optim.Adam(model.parameters(), lr=1e-3),
                                   backend)
        before = dict(fused_mlp.launches)
        losses[backend] = [step(model, coords, target).item() for _ in range(5)]
        if backend == "auto":
            assert fused_mlp.launches["field_bwd"] == before["field_bwd"] + 5
            assert fused_mlp.launches["field_fwd"] == before["field_fwd"] + 5
    np.testing.assert_allclose(losses["auto"], losses["plain"], rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("layers", [5, 8])
def test_narrow_mlps_past_shared_memory_run_on_the_wide_kernels(layers):
    """5x64 and 8x64 at S = 64 exceed one narrow block's shared memory:
    the render, the train loss and the render backward launch the wide
    kernels (no narrow one) and meet the narrow kernels' bounds against the
    plain version."""
    need_card()
    rng = np.random.default_rng(layers)
    cfg = NeRFConfig(num_layers=layers, filter_size=64, num_samples=64)
    params = params_from_numpy(*np_params(rng, cfg), "cuda")
    assert fused_nerf._route(cfg, params) == ("wide", 128)
    o, d = cuda_rays(rng, N_RAYS)
    t, dists = uniform_depths(cfg.near, cfg.far, cfg.num_samples, "cuda")
    tgt = torch.from_numpy(rng.random((N_RAYS, 3)).astype(np.float32)).cuda()
    before = dict(fused_nerf.launches)
    with torch.no_grad():
        got = fused_nerf.render_rays(params, o, d, t, dists, cfg)
    k = grads_of(params, lambda: fused_nerf.nerf_train_loss(params, o, d, t, dists, tgt, cfg))
    b = grads_of(params, lambda: fused_nerf.nerf_loss(params, o, d, t, dists, tgt, cfg))
    p = grads_of(params, lambda: fused_nerf.nerf_train_loss_reference(params, o, d, t, dists,
                                                                      tgt, cfg))
    torch.cuda.synchronize()
    moved = {n: fused_nerf.launches[n] - before[n] for n in before}
    assert moved["nerf_wide_render_fwd"] == 2 and moved["nerf_wide_train"] == 1
    assert moved["nerf_wide_render_bwd"] == 1
    assert sum(moved.values()) == 4
    torch.testing.assert_close(got, fused_nerf.render_rays_reference(params, o, d, t, dists,
                                                                     cfg),
                               atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(k[0], p[0], rtol=1e-5, atol=0.0)
    for x, y, w in zip(k[1:], b[1:], p[1:]):
        atol = 3e-5 * max(1.0, w.abs().max().item())
        torch.testing.assert_close(x, w, rtol=3e-4, atol=atol)
        torch.testing.assert_close(y, w, rtol=3e-4, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("R,S,kind,offset", [
    (4, 6, "unit", 0), (1024, 128, "tiny", 0), (262144, 30, "tiny", 0),
    (1037, 64, "tiny", 0), (1037, 30, "tiny", 1), (33, 1815, "tiny", 1), (37, 2048, "tiny", 0)])
def test_seg_scans_kernel_matches_plain_and_numpy(R, S, kind, offset):
    """The seg_scans kernel (#15) against numpy's f32 sequential accumulate
    of the same inputs bit for bit (the product along a segment, the sum
    along the reversed one), against its plain version and numpy f64:
    cumprod and suffix sum within rtol 1e-5 where the f64 value is a normal
    f32 (both below 1.2e-38 where the product underflows), the shift exact,
    repeat launches bit-identical, one launch counted per call.  Shapes: the
    JAX test's, S = 128 with subnormal products, the 262,144 x 30 column,
    S = 64 (32-way banks at an even stride), ragged R, a column at a
    storage offset of ``offset`` floats (not 16-B aligned), the largest S
    the staged kernel takes and an S past it (the direct walk)."""
    need_card()
    from lomanerf_tpu_torch.ops import scans

    tiny = float(np.finfo(np.float32).tiny)
    rng = np.random.default_rng(R)
    u = rng.random((R * S, 1))
    x = (u + 0.5 if kind == "unit" else 10.0 ** (-10.0 * u ** 6)).astype(np.float32)
    buf = torch.from_numpy(np.concatenate([np.zeros((offset, 1), np.float32), x])).cuda()
    col = buf[offset:]
    assert col.data_ptr() % 16 == 4 * offset % 16
    assert scans.scan_plan(R * S, S).route == ("direct" if S > 1815 else "staged")
    x32 = x.reshape(R, S)
    x64 = x32.astype(np.float64)
    wants = {"cumprod": np.cumprod(x64, axis=1),
             "suffix": np.cumsum(x64[:, ::-1], axis=1)[:, ::-1]}
    bits = {"cumprod": np.multiply.accumulate(x32, axis=1),
            "suffix": np.add.accumulate(x32[:, ::-1], axis=1)[:, ::-1]}
    for op, fn, ref in (("cumprod", scans.seg_inclusive_cumprod,
                         scans.seg_inclusive_cumprod_reference),
                        ("suffix", scans.seg_suffix_sum, scans.seg_suffix_sum_reference)):
        before = scans.launches["seg_scans"]
        got, again = fn(col, S), fn(col, S)
        assert scans.launches["seg_scans"] == before + 2
        assert got.shape == col.shape and torch.equal(got, again)
        g32 = got.cpu().numpy().reshape(R, S)
        np.testing.assert_array_equal(g32.view(np.uint32), bits[op].view(np.uint32))
        for want in (wants[op], ref(col, S).double().cpu().numpy().reshape(R, S)):
            g = g32.astype(np.float64)
            normal = np.abs(want) >= tiny
            np.testing.assert_allclose(g[normal], want[normal], rtol=1e-5, atol=0.0)
            assert np.all(np.abs(g[~normal]) <= tiny)
    for fill in (0.0, 1.0):
        got = scans.seg_shift_down(col, S, fill)
        want = np.concatenate([np.full((R, 1), fill), x64[:, :-1]], axis=1)
        np.testing.assert_array_equal(got.cpu().numpy().reshape(R, S), want.astype(np.float32))
        assert torch.equal(got, scans.seg_shift_down_reference(col, S, fill))


@pytest.mark.cuda
@pytest.mark.parametrize("rows,block,n_dummy", [(15360, 3840, 0), (16000, 3840, 2),
                                                (16000, 15360, 0), (7864320, 122880, 0)])
def test_grid_sum_kernel_matches_f64_and_repeats_exactly(rows, block, n_dummy):
    """The grid_sum kernel (#16) within 1e-6 of the sum of |x| from the f64
    sum of the first (rows // block) * block columns, bit-identical over
    repeat launches, on a contiguous array and on strided column slices."""
    need_card()
    from lomanerf_tpu_torch.ops import probe

    x = torch.randn((8, rows), generator=torch.Generator("cuda").manual_seed(rows),
                    device="cuda")
    for view in (x, x[:, rows // 4:], x[:, 1:]):  # float4 loads; scalar ones (unaligned)
        cols = view.shape[1] // block * block
        want = view[:, :cols].double().sum().item()
        scale = view[:, :cols].double().abs().sum().item()
        before = probe.launches["grid_sum"]
        got = [probe.grid_sum(view, block, n_dummy) for _ in range(3)]
        assert probe.launches["grid_sum"] == before + 3
        assert all(torch.equal(got[0], g) for g in got[1:])
        assert abs(got[0].item() - want) <= 1e-6 * max(scale, 1.0)
        assert abs(probe.grid_sum_reference(view, block).item() - want) <= 1e-6 * max(scale, 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,in_cols,pw", [(2 * 8192 + 1037, 256, 256),
                                             (1037 * 128, 40, 256), (1037, 128, 128),
                                             (3 * 8192 + 1037, 1024, 1024),
                                             (3 * 8192 + 1037, 40, 1024),
                                             (300 * 8192 + 1037, 256, 256)])
def test_wide_dw_gemm_matches_f64(rows, in_cols, pw):
    """The bf16 dW stage on wgmma/TMA (``wide_dw.wide_dw_gemm``, the kernel
    #7, #9, #11 and #12 run per hidden layer) within 1e-6 of the f64 sum of
    |products| of the f64 product of its rounded operands, per 8192-row
    partial, at ragged rows, at layer 0's 40 columns, 1024 wide, and with
    many times more work items (partial x 128 x 256 tile) than SMs, so that
    the persistent blocks walk many of them; repeat launches bit-identical.
    The 1024-wide and the 300-partial cases take 256-column tiles, the
    others (their walk has fewer rounds of the SMs so) 128-column ones."""
    need_card()
    from lomanerf_tpu_torch.ops import wide_dw

    g = torch.Generator("cuda").manual_seed(rows)
    h = torch.relu(torch.randn((rows, pw), generator=g, device="cuda")).to(torch.bfloat16)
    db = (torch.randn((rows, pw), generator=g, device="cuda") * 1e-3).to(torch.bfloat16)
    before = dict(wide_dw.launches)
    got, again = wide_dw.wide_dw_gemm(h, db, in_cols), wide_dw.wide_dw_gemm(h, db, in_cols)
    torch.cuda.synchronize()
    assert wide_dw.launches["wide_dw_gemm"] == before["wide_dw_gemm"] + 2
    assert got.shape == (-(-rows // 8192), in_cols, pw) and torch.equal(got, again)
    for z in range(got.shape[0]):
        a = h[8192 * z:8192 * (z + 1), :in_cols].double()
        b = db[8192 * z:8192 * (z + 1)].double()
        exact, scale = a.T @ b, a.abs().T @ b.abs()
        assert ((got[z].double() - exact).abs() <= 1e-6 * scale + 1e-30).all()


# (K, pw) of the layer GEMM: layer 0's 40 columns, hidden layers at K = pw,
# and K below pw at every pw that holds it
GEMM_SHAPES = [(K, pw) for pw in (128, 256, 384, 1024)
               for K in sorted({40, 256, 384, 1024, pw}) if K <= pw]


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 37, 33184, 65536])
@pytest.mark.parametrize("K,pw", GEMM_SHAPES)
@pytest.mark.parametrize("form", ["forward", "d_h"])
def test_wide_layer_gemm_equals_its_mma_twin(form, K, pw, rows):
    """The wide chain's bf16 layer GEMM on wgmma/TMA (``wide_gemm``: the
    forward layer and ``d_h``, the kernel #7-#12 run past the fused MLP and
    for every ``d_h``) within the plain version's bounds
    (``tests/test_torch_wide_gemm.py``) of the plain version and of f64, at
    ragged rows, layer 0's 40 columns and pw up to 1024; repeat launches
    bit-identical; the launch counts rise by the calls made."""
    need_card()
    from lomanerf_tpu_torch.ops import wide_gemm

    g = torch.Generator("cuda").manual_seed(rows + K + pw)
    a = torch.randn((rows, pw), generator=g, device="cuda").to(torch.bfloat16)
    W = (torch.randn((pw, pw), generator=g, device="cuda") / pw ** 0.5).to(torch.bfloat16)
    before = dict(wide_gemm.launches)
    if form == "forward":
        b = torch.randn(pw, generator=g, device="cuda") * 0.1
        got, again = wide_gemm.wide_layer_gemm(a, W, b, K), wide_gemm.wide_layer_gemm(a, W, b, K)
        plain = wide_gemm.layer_reference(a, W, b, K)
        exact = torch.relu(a[:, :K].double() @ W[:K].double() + b.double())
        torch.cuda.synchronize()
        name = "wide_layer_gemm"
        assert torch.equal(got, again)
        for want in (plain.double(), exact):
            diff = (got.double() - want).abs()
            # one bf16 rounding step of the entry, and a ReLU at f32 rounding of 0
            step = torch.ldexp(torch.ones_like(diff), torch.frexp(
                torch.maximum(got.double().abs(), want.abs()))[1] - 8)
            assert (diff <= step + 1e-5 * want.abs().max()).all()
    else:
        mask = torch.randn((rows, pw), generator=g, device="cuda").to(torch.bfloat16)
        got, again = wide_gemm.wide_dh_gemm(a, W, mask, K), wide_gemm.wide_dh_gemm(a, W, mask, K)
        plain = wide_gemm.dh_reference(a, W, mask, K)[0]
        exact = torch.where(mask > 0, a[:, :K].double() @ W[:, :K].double().T, 0.0)
        torch.cuda.synchronize()
        name = "wide_dh_gemm"
        assert len(got) == 3
        for x, y in zip(got, again):
            assert torch.equal(x, y)
        assert torch.equal(got[1], got[0].to(torch.bfloat16))
        assert (got[0] - plain).abs().max() <= 1e-5 * plain.abs().max()
        assert (got[0].double() - exact).abs().max() <= 1e-5 * exact.abs().max()
        # the 128-row column partials against f64 sums of the kernel's own d_h
        tiles = -(-rows // wide_gemm.TILE_ROWS)
        d64 = torch.zeros((tiles * wide_gemm.TILE_ROWS, pw), dtype=torch.float64, device="cuda")
        d64[:rows] = got[0]
        d64 = d64.view(tiles, wide_gemm.TILE_ROWS, pw)
        assert got[2].shape == (tiles, pw)
        assert ((got[2].double() - d64.sum(1)).abs() <= 1e-6 * d64.abs().sum(1) + 1e-30).all()
    assert wide_gemm.launches[name] == before[name] + 2


@pytest.mark.cuda
def test_wide_layer_gemm_refuses_what_it_does_not_take():
    """The C entry point refuses a K past pw (cudaErrorInvalidValue); the
    wrappers refuse f32 operands before any launch."""
    need_card()
    from lomanerf_tpu_torch.ops import build, wide_gemm

    a = torch.zeros((37, 128), dtype=torch.bfloat16, device="cuda")
    W = torch.zeros((128, 128), dtype=torch.bfloat16, device="cuda")
    b = torch.zeros(128, device="cuda")
    C = torch.empty((37, 128), dtype=torch.bfloat16, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    err = build.load().wide_layer_gemm(a.data_ptr(), W.data_ptr(), b.data_ptr(), None,
                                       C.data_ptr(), None, None, 37, 128, 136, 0, stream)
    assert err != 0
    before = dict(wide_gemm.launches)
    with pytest.raises(ValueError):
        wide_gemm.wide_layer_gemm(a.float(), W, b, 40)
    with pytest.raises(ValueError):
        wide_gemm.wide_dh_gemm(a, W, a.float(), 128)
    assert wide_gemm.launches == before


def same_bits(x, y):
    """Bit-equal (``torch.equal`` takes -0 for +0)."""
    return x.shape == y.shape and torch.equal(x.contiguous().view(torch.int32),
                                              y.contiguous().view(torch.int32))


# the f32 GEMM's forms: the forward layer, the field's head and its d_z
# (3 columns, row stride 3), d_h (from a hidden layer's d_z, and from a
# head's: K = 3 at row stride 3), dW's partials (of a hidden layer, and of a
# head: 3 columns)
F32_FORMS = ["forward", "head", "head d_z", "d_h", "d_h from a head", "dW", "dW of a head"]


def f32_form_calls(form, rows, K, g):
    """``(wrapper name, call() -> outputs, plain(f) -> outputs)`` of one form
    of ``ops/f32_gemm`` on seeded operands: K the contracted width (the
    input width of dW, 3 for a head's d_h), 256 or 3 output columns; dW at
    k_chunk 8192 and at rows.  ``plain`` runs the plain version on the
    operands mapped by ``f``: ``torch.Tensor.double`` gives the f64
    result."""
    from lomanerf_tpu_torch.ops import f32_gemm

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device="cuda") * scale

    N = 3 if form in ("head", "head d_z", "dW of a head") else 256
    if form in ("forward", "head", "head d_z"):
        h, W, b = rnd(rows, K), rnd(K, N, scale=K ** -0.5), rnd(N, scale=0.1)
        if form == "forward":
            return ("f32_layer_gemm", lambda: [f32_gemm.f32_layer_gemm(h, W, b, K)],
                    lambda f: [f32_gemm.layer_reference(f(h), f(W), f(b), K)])
        dout = rnd(rows, N) if form == "head d_z" else None
        return ("f32_head_gemm", lambda: [f32_gemm.f32_head_gemm(h, W, b, K, dout)],
                lambda f: [f32_gemm.head_reference(f(h), f(W), f(b), K,
                                                   None if dout is None else f(dout))])
    if form.startswith("d_h"):
        C = 3 if form == "d_h from a head" else K
        N = K if C == 3 else N
        dz, W, mask = rnd(rows, C), rnd(N, C, scale=C ** -0.5), rnd(rows, N)
        return ("f32_dh_gemm", lambda: [f32_gemm.f32_dh_gemm(dz, W, mask, C)],
                lambda f: [f32_gemm.dh_reference(f(dz), f(W), f(mask), C)])
    h, dz = rnd(rows, K), rnd(rows, N)
    chunks = (8192, rows)
    return ("f32_dw_gemm", lambda: [f32_gemm.f32_dw_gemm(h, dz, K, c) for c in chunks],
            lambda f: [f32_gemm.dw_reference(f(h), f(dz), K, c) for c in chunks])


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 37, 1037, 8193, 65536])
@pytest.mark.parametrize("K", [34, 40, 256, 384, 1024])
@pytest.mark.parametrize("form", F32_FORMS)
def test_f32_gemm_equals_its_fma_twin(form, K, rows):
    """The wide chain's f32 GEMM (``ops/f32_gemm``, ``nerf_wide_f32_gemm.cuh``:
    every product of #7-#12 at f32 compute and of the wide field's "highest"
    tier) in every form, at ragged rows, the field's 34 and the NeRF's 40
    input columns, hidden widths to 1024, heads at row stride 3 and dW at
    k_chunk 8192 and the whole rows: within 1e-4 of the largest entry of the
    plain version; within 1e-6 of f64's sum of |terms| of each output
    (``plain`` on |operands| in f64; the heads, whose sigmoid hides that sum,
    within 1e-5 of f64's largest entry); repeat launches bit-identical; the
    launch counts rise by the calls made."""
    need_card()
    from lomanerf_tpu_torch.ops import f32_gemm

    name, call, plain = f32_form_calls(form, rows, K,
                                       torch.Generator("cuda").manual_seed(rows * 7 + K))
    before = dict(f32_gemm.launches)
    got, again = call(), call()
    torch.cuda.synchronize()
    exact = plain(torch.Tensor.double)
    if form.startswith("head"):
        tol = [1e-5 * e.abs().max() for e in exact]
    else:  # a linear or ReLU epilogue: |result| <= the sum of |terms|
        tol = [1e-6 * t for t in plain(lambda x: x.double().abs())]
    for x, y, p, e, t in zip(got, again, plain(lambda x: x), exact, tol):
        assert same_bits(x, y)
        assert (x - p).abs().max() <= 1e-4 * p.abs().max()
        assert ((x.double() - e).abs() <= t).all()
    assert f32_gemm.launches[name] == before[name] + 2 * len(got)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [3, 34, 40, 256, 8193])
@pytest.mark.parametrize("form", ["d_h", "dW"])
def test_f32_gemm_keeps_the_signed_zeros_of_its_padding(form, K):
    """Products that underflow (operands near 1e-25) leave every sum at a
    signed zero: the last product's sign where the k range is a multiple of
    8, +0 where the kernel pads it with zero terms (``f32_gemm.k_terms``):
    no zero term more or fewer."""
    need_card()
    from lomanerf_tpu_torch.ops import f32_gemm

    g = torch.Generator("cuda").manual_seed(K)
    if form == "d_h":
        dz = torch.randn((64, K), generator=g, device="cuda") * 1e-25
        W = torch.randn((128, K), generator=g, device="cuda") * 1e-25
        mask = torch.ones((64, 128), device="cuda")
        got, again = f32_gemm.f32_dh_gemm(dz, W, mask, K), f32_gemm.f32_dh_gemm(dz, W, mask, K)
        tails = [K]
    else:
        h = torch.randn((K, 96), generator=g, device="cuda") * 1e-25
        dz = torch.randn((K, 80), generator=g, device="cuda") * 1e-25
        got, again = f32_gemm.f32_dw_gemm(h, dz, 96, 8192), f32_gemm.f32_dw_gemm(h, dz, 96, 8192)
        tails = [min(8192, K - z * 8192) for z in range(got.shape[0])]
    torch.cuda.synchronize()
    assert not got.any() and same_bits(got, again)
    neg = torch.signbit(got).reshape(len(tails), -1)
    for part, tail in zip(neg, tails):
        assert bool(part.any()) == (tail % 8 == 0), (tail, int(part.sum()))


@pytest.mark.cuda
def test_f32_gemm_refuses_what_it_does_not_take():
    """The C entry point refuses an unknown form and an empty extent
    (cudaErrorInvalidValue); the wrappers refuse bf16 operands before any
    launch."""
    need_card()
    from lomanerf_tpu_torch.ops import build, f32_gemm

    a = torch.zeros((37, 128), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for M, form in ((37, 5), (0, 0)):
        err = build.load().wide_f32_gemm(a.data_ptr(), 128, a.data_ptr(), 128, a.data_ptr(),
                                         None, a.data_ptr(), 128, M, 128, 128, 128, form, stream)
        assert err != 0
    before = dict(f32_gemm.launches)
    with pytest.raises(ValueError):
        f32_gemm.f32_layer_gemm(a.to(torch.bfloat16), a[:, :128], a[0], 40)
    assert f32_gemm.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("n_tiles", [1, 7, 2048])
def test_grid_sum_is_one_launch_in_a_fixed_order(n_tiles):
    """grid_sum at 1, 7 and 2,048 tiles of 3,840 columns (and a remainder
    it leaves out): repeat launches bit-identical and equal, bit for bit,
    to the numpy restatement of the kernel's fixed order
    (``test_torch_probe.kernel_order_sum``)."""
    need_card()
    from test_torch_probe import kernel_order_sum

    from lomanerf_tpu_torch.ops import probe

    x = torch.randn((8, n_tiles * 3840 + 4), generator=torch.Generator("cuda").manual_seed(
        n_tiles), device="cuda")
    got = [probe.grid_sum(x, 3840) for _ in range(3)]
    assert all(torch.equal(got[0], y) for y in got[1:])
    assert got[0].item() == float(kernel_order_sum(x.cpu().numpy(), 3840))


@pytest.mark.cuda
def test_pinned_ring_batches_on_the_card():
    """On the card each batch crosses from a ring of pinned buffers without
    a synchronise: 50 batches held back on the card (none read until the
    end) equal the CPU pipeline's, bit for bit."""
    need_card()
    from lomanerf_tpu_torch.data.native import RayBatchPipeline

    rng = np.random.default_rng(215)
    poses = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    poses[:, :3, 3] = rng.standard_normal((3, 3))
    images = rng.random((3, 64, 64, 3)).astype(np.float32)
    kw = dict(focal=1.2, n_rays=65536, num_samples=16, near=2.0, far=6.0, seed=5,
              stratified=True)
    for force_numpy in (False, True):
        card = RayBatchPipeline(poses, images, force_numpy=force_numpy, device="cuda", **kw)
        host = RayBatchPipeline(poses, images, force_numpy=force_numpy, device="cpu", **kw)
        held = []
        for _ in range(50):
            torch.cuda._sleep(100000)  # keep the card busy: copies queue behind
            held.append(card.next_batch())
        for i, batch in enumerate(held):
            for g, w in zip(batch, host.next_batch()):
                assert torch.equal(g.cpu(), w), f"batch {i}"
        assert torch.equal(card.t_base.cpu(), host.t_base)
        card.close()
        host.close()
