"""mip-NeRF 360 (``NeRFConfig.mipnerf360()``) on the CPU: each piece of
``core/mip360.py`` against a brute-force form (the IPE against a Monte-Carlo
expectation, the contraction's Jacobian against autograd, the O(n)
distortion against the double sum, the interlevel bound against a loop over
interval overlaps, the resampler against a bisection of the step
histogram's CDF); the whole step's loss and gradients (the CPU route)
against the benchmark's plain reference (``benchmark/reference/mip360.py``)
in float64 at small widths; the preset's widths; the packing; and, on a
card, ``csrc/mip360.cu`` against the plain version (the ``cuda`` tests skip
here):

    python -m pytest tests/test_torch_mip360.py -q
"""

import dataclasses
import math
import os
import sys

import pytest
import torch

from lomanerf_tpu_torch.core import mip360 as plain
from lomanerf_tpu_torch.models import NeRFConfig, NeRFModel
from lomanerf_tpu_torch.ops import fused_nerf, mip360
from lomanerf_tpu_torch.train.steps import make_single_chip_train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.reference import mip360 as ref  # noqa: E402

# a small mip-NeRF 360: 2 proposal layers of 16, 4 NeRF layers of 32 with
# the skip into the third, 8 + 8 proposal intervals and 4 NeRF ones
SMALL = dict(num_layers=4, filter_size=32, skip_layer=2, bottleneck_width=8, view_width=8,
             proposal_layers=2, proposal_width=16, proposal_samples=(8, 8), num_samples=4,
             num_encoding_functions=4, dir_encoding_functions=2, pixel_radius=0.01)
MODEL_KEYS = ("near", "far", "pixel_radius", "num_encoding_functions", "proposal_samples",
              "num_samples", "dir_encoding_functions", "skip_layer", "proposal_layers",
              "filter_size", "num_layers", "proposal_width")


def small_config(**kw):
    return dataclasses.replace(NeRFConfig.mipnerf360(), **{**SMALL, "dtype": torch.float64,
                                                           **kw})


def rays_in_ball(gen, n, dtype=torch.float64, device="cpu"):
    """Cameras inside the unit ball looking roughly at the origin."""
    o = torch.nn.functional.normalize(torch.randn((n, 3), generator=gen, device=device),
                                      dim=-1) * 0.8
    d = -o / 0.8 + 0.3 * torch.randn((n, 3), generator=gen, device=device)
    return o.to(dtype), d.to(dtype)


def small_model(seed, **kw):
    cfg = small_config(**kw)
    model = NeRFModel(cfg, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    model.init(gen)
    with torch.no_grad():  # the init's biases are zero
        for b in model.b:
            b.normal_(0.0, 0.3, generator=gen)
    return cfg, model, gen


# ---- each piece against a brute-force form ----


@pytest.mark.parametrize("variance", [1e-3, 0.05])
def test_ipe_is_the_expectation_under_the_gaussian(variance):
    """exp(-4^l var / 2) sin(2^l mean) against the mean of sin(2^l x) over
    400,000 draws of x ~ N(mean, var), and the cosines."""
    gen = torch.Generator().manual_seed(3)
    mean = torch.randn((5, 3), generator=gen, dtype=torch.float64)
    var = torch.full((5, 3), variance, dtype=torch.float64)
    x = mean + var.sqrt() * torch.randn((400_000, 5, 3), generator=gen, dtype=torch.float64)
    mc = torch.cat([f(x * 2.0 ** lvl) for lvl in range(3) for f in (torch.sin, torch.cos)],
                   dim=-1).mean(0)
    torch.testing.assert_close(plain.ipe(mean, var, 3), mc, rtol=0, atol=6e-3)


def autograd_covariance(o, d, t0, t1, radius):
    """``(contract(mean), diag(J Sigma J^T))`` in float64 with J taken by
    autograd of :func:`plain.contract` at each mean and the product
    multiplied out."""
    mean, _ = plain.frustum_gaussian(o, d, t0, t1, radius, contracted=False)
    mu, hw = (t0 + t1) / 2, (t1 - t0) / 2
    den = 3 * mu ** 2 + hw ** 2
    t_var = hw ** 2 / 3 - (4 / 15) * hw ** 4 * (12 * mu ** 2 - hw ** 2) / den ** 2
    r_var = radius ** 2 * (mu ** 2 / 4 + (5 / 12) * hw ** 2 - (4 / 15) * hw ** 4 / den)
    dv = d[:, None, :].expand(mean.shape)
    outer = dv[..., :, None] * dv[..., None, :]
    cov = t_var[..., None, None] * outer + r_var[..., None, None] * (
        torch.eye(3, dtype=torch.float64) - outer / (dv * dv).sum(-1)[..., None, None])
    jac = torch.stack([torch.autograd.functional.jacobian(plain.contract, x)
                       for x in mean.reshape(-1, 3)]).reshape(cov.shape)
    return plain.contract(mean), torch.diagonal(jac @ cov @ jac.transpose(-1, -2), dim1=-2,
                                                dim2=-1)


@pytest.mark.parametrize("scale", [0.5, 1.0, 3.0])
def test_contraction_jacobian_matches_autograd(scale):
    """The contracted Gaussians (``frustum_gaussian``'s closed-form J) in
    float64 against ``J Sigma J^T`` with autograd's Jacobian of ``contract``:
    rays from inside the unit ball out to ``scale`` times farther, the
    intervals inside and outside it; the contracted means lie in the ball of
    radius 2."""
    gen = torch.Generator().manual_seed(int(scale * 10))
    o, d = rays_in_ball(gen, 4)
    t = torch.sort(torch.rand((4, 6), generator=gen, dtype=torch.float64) * 3 * scale,
                   -1).values + 0.1
    mean, var = plain.frustum_gaussian(o, d, t[:, :-1], t[:, 1:], 5e-3)
    want_mean, want_var = autograd_covariance(o, d, t[:, :-1], t[:, 1:], 5e-3)
    torch.testing.assert_close(mean, want_mean, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(var, want_var, rtol=1e-9, atol=1e-15)
    assert float(mean.norm(dim=-1).max()) < 2.0


def test_contracted_variance_is_stable_in_float32():
    """The contracted covariance's diagonal in float32, from intervals out
    to t = 1000, against the float64 product with autograd's Jacobian:
    within 1e-3 of each entry (the product multiplied out in float32
    cancels to a millionth of its terms there)."""
    gen = torch.Generator().manual_seed(11)
    o, d = rays_in_ball(gen, 8)
    t = 10.0 ** (torch.sort(torch.rand((8, 9), generator=gen, dtype=torch.float64), -1).values
                 * 3.0)  # 1 to 1000
    mean, var = plain.frustum_gaussian(o.float(), d.float(), t[:, :-1].float(),
                                       t[:, 1:].float(), 5e-4)
    want_mean, want_var = autograd_covariance(o, d, t[:, :-1], t[:, 1:], 5e-4)
    torch.testing.assert_close(var.double(), want_var, rtol=1e-3, atol=0)
    torch.testing.assert_close(mean.double(), want_mean, rtol=1e-5, atol=1e-6)


def test_frustum_gaussian_matches_sampled_frustum():
    """The frustum's mean and variance along the ray against a Monte-Carlo
    over the cone's volume (uncontracted), each interval's first two
    moments within 1% of its length."""
    gen = torch.Generator().manual_seed(5)
    o = torch.zeros((1, 3), dtype=torch.float64)
    d = torch.tensor([[0.0, 0.0, 1.0]], dtype=torch.float64)
    t0, t1 = torch.tensor([[1.0, 2.0]], dtype=torch.float64), torch.tensor([[1.5, 4.0]],
                                                                           dtype=torch.float64)
    radius = 0.1
    mean, var = plain.frustum_gaussian(o, d, t0, t1, radius, contracted=False)
    for j in range(2):
        a, b = float(t0[0, j]), float(t1[0, j])
        # t with density ~ t^2 on [a, b], then a uniform point of the disc of radius r t
        u = torch.rand(400_000, generator=gen, dtype=torch.float64)
        t = (a ** 3 + u * (b ** 3 - a ** 3)) ** (1 / 3)
        rr = radius * t * torch.rand(400_000, generator=gen, dtype=torch.float64).sqrt()
        phi = 2 * math.pi * torch.rand(400_000, generator=gen, dtype=torch.float64)
        pts = torch.stack([rr * phi.cos(), rr * phi.sin(), t], dim=-1)
        torch.testing.assert_close(mean[0, j], pts.mean(0), rtol=0, atol=0.01 * (b - a))
        torch.testing.assert_close(var[0, j], pts.var(0), rtol=0.02, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_distortion_matches_the_double_sum(seed):
    gen = torch.Generator().manual_seed(seed)
    s = torch.sort(torch.rand((4, 17), generator=gen, dtype=torch.float64), dim=-1).values
    w = torch.rand((4, 16), generator=gen, dtype=torch.float64)
    m = 0.5 * (s[:, 1:] + s[:, :-1])
    brute = torch.zeros(4, dtype=torch.float64)
    for i in range(16):
        brute += w[:, i] ** 2 * (s[:, i + 1] - s[:, i]) / 3
        for j in range(16):
            brute += w[:, i] * w[:, j] * (m[:, i] - m[:, j]).abs()
    torch.testing.assert_close(plain.distortion(s, w), brute, rtol=1e-12, atol=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_interlevel_bound_is_the_overlapping_weight(seed):
    """``outer_bound`` against a loop that adds the proposal weight of every
    proposal interval overlapping the NeRF interval (``te_{k+1} > t_j`` and
    ``te_k <= t_{j+1}``), and the interlevel term from it; shared endpoints
    and rays past the envelope included."""
    gen = torch.Generator().manual_seed(seed)
    te = torch.sort(torch.rand((3, 9), generator=gen, dtype=torch.float64), dim=-1).values
    t = torch.sort(torch.rand((3, 6), generator=gen, dtype=torch.float64), dim=-1).values
    te[0, 4] = t[0, 2]  # an endpoint shared with the envelope
    te = torch.sort(te, dim=-1).values
    t[1, -1] = 1.5  # past its last endpoint
    we = torch.rand((3, 8), generator=gen, dtype=torch.float64)
    w = torch.rand((3, 5), generator=gen, dtype=torch.float64)
    brute = torch.zeros((3, 5), dtype=torch.float64)
    for r in range(3):
        for j in range(5):
            for k in range(8):
                if te[r, k + 1] > t[r, j] and te[r, k] <= t[r, j + 1]:
                    brute[r, j] += we[r, k]
    torch.testing.assert_close(plain.outer_bound(t, te, we), brute, rtol=0, atol=1e-12)
    want = torch.sum(torch.relu(w - brute) ** 2 / (w + plain.F32_EPS), dim=-1)
    torch.testing.assert_close(plain.interlevel(t, w, te, we), want, rtol=1e-12, atol=0)


@pytest.mark.parametrize("weights", ["random", "sparse", "zeros"])
def test_resampler_inverts_the_step_histogram(weights):
    """Each centre the resampler draws is the point where the histogram's
    CDF (linear within a bin) reaches its ``u``, found by bisection; the
    endpoints are the centres' midpoints with the outer two reflected; a
    histogram of zeros resamples evenly."""
    gen = torch.Generator().manual_seed(7)
    n, n_in, n_out = 4, 12, 9
    s = torch.sort(torch.rand((n, n_in + 1), generator=gen, dtype=torch.float64), dim=-1).values
    s[:, 0], s[:, -1] = 0.0, 1.0
    w = torch.rand((n, n_in), generator=gen, dtype=torch.float64)
    if weights == "sparse":
        w[:, ::3] = 0.0
    elif weights == "zeros":
        w.zero_()
    xi = torch.rand((n,), generator=gen, dtype=torch.float64)
    got = plain.resample(s, w, n_out, xi)
    pdf = w / w.sum(-1, keepdim=True) if weights != "zeros" else torch.full_like(w, 1 / n_in)
    u0, du, jit = plain.jitter_grid(n_out, True)
    for r in range(n):
        def cdf(x):
            frac = ((x - s[r, :-1]) / (s[r, 1:] - s[r, :-1])).clamp(0, 1)
            return float(torch.sum(pdf[r] * frac))

        ctr = []
        for j in range(n_out):
            u, lo, hi = u0 + j * du + float(xi[r]) * jit, 0.0, 1.0
            for _ in range(60):
                mid = 0.5 * (lo + hi)
                lo, hi = (mid, hi) if cdf(mid) <= u else (lo, mid)
            ctr.append(lo)
        ctr = torch.tensor(ctr, dtype=torch.float64)
        mid = 0.5 * (ctr[1:] + ctr[:-1])
        want = torch.cat([(2 * ctr[:1] - mid[:1]).clamp_min(0), mid,
                          (2 * ctr[-1:] - mid[-1:]).clamp_max(1)])
        torch.testing.assert_close(got[r], want, rtol=0, atol=1e-9)


# ---- the whole step against the benchmark's reference ----


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_step_matches_reference(seed):
    """The CPU route of ``NeRFModel.loss`` (the plain version, float64, so
    the rounding plan is the identity) against ``reference/mip360.py``: the
    four loss terms, the NeRF's intervals and every gradient of both
    networks."""
    cfg, model, gen = small_model(seed)
    n = 11
    o, d = rays_in_ball(gen, n)
    tgt = torch.rand((n, 3), generator=gen, dtype=torch.float64)
    loss, aux = mip360.train_loss(model.params, o, d, tgt, cfg,
                                  torch.Generator().manual_seed(seed + 100))
    grads = torch.autograd.grad(loss, [*model.w, *model.b])
    xi = torch.rand((3, n), generator=torch.Generator().manual_seed(seed + 100))
    terms, want, s = ref.loss_and_grads(model.params, o, d, tgt, xi,
                                        {k: getattr(cfg, k) for k in MODEL_KEYS}, block=4)
    torch.testing.assert_close(aux["terms"], torch.tensor(terms, dtype=torch.float64),
                               rtol=1e-10, atol=1e-14)
    torch.testing.assert_close(aux["sdist"], s, rtol=0, atol=1e-12)
    for g, r in zip(grads, want):
        torch.testing.assert_close(g, r, rtol=1e-9, atol=1e-13)


def test_render_matches_reference():
    """The CPU render (deterministic centres) against the reference's
    forward without jitter."""
    cfg, model, gen = small_model(4)
    o, d = rays_in_ball(gen, 6)
    with torch.no_grad():
        got = model.render_rays(o, d, None, None)
        want = ref.forward(model.params, o, d, {k: getattr(cfg, k) for k in MODEL_KEYS},
                           None)[0]
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


def test_train_step_moves_both_networks():
    """``make_single_chip_train_step`` at the small config: the loss is
    finite, every leaf of both networks changes after one Adam step, and
    the rounding plan (float32 leaves, bf16 compute) stays within 5% of the
    exact loss at these narrow widths."""
    cfg, model, gen = small_model(9, dtype=torch.float32)
    o, d = rays_in_ball(gen, 8, torch.float32)
    tgt = torch.rand((8, 3), generator=gen)
    before = [p.detach().clone() for p in model.parameters()]
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    step = make_single_chip_train_step(cfg, opt, generator=torch.Generator().manual_seed(1))
    loss = float(step(model, o, d, None, None, tgt))
    assert math.isfinite(loss)
    assert all(not torch.equal(a, b) for a, b in zip(before, model.parameters()))
    model.load_params({"w": before[:len(model.w)], "b": before[len(model.w):]})
    exact, _ = mip360.train_loss(model.params, o, d, tgt,
                                 dataclasses.replace(cfg, compute_dtype="float32"),
                                 torch.Generator().manual_seed(1))
    assert abs(loss - float(exact)) <= 0.05 * abs(float(exact))


def test_train_nerf_and_make_video_at_preset_mipnerf360(tmp_path):
    """``train_nerf --preset mipnerf360 --device cpu`` (two steps at the
    published widths, an eval render, a checkpoint) and ``make_video
    --preset mipnerf360`` from it."""
    import numpy as np

    from lomanerf_tpu_torch.train import make_video, train_nerf

    ckpt = tmp_path / "ckpt"
    out = train_nerf.main(["--preset", "mipnerf360", "--device", "cpu", "--steps", "2",
                           "--img-size", "4", "--rays-per-batch", "4", "--eval-every", "1",
                           "--log-dir", str(tmp_path / "logs"), "--ckpt-dir", str(ckpt)])
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    assert sorted(out["psnr"]) == [0, 1]
    wrote = make_video.main(["--ckpt-dir", str(ckpt), "--preset", "mipnerf360", "--device",
                             "cpu", "--orbit", "1", "--img-size", "4",
                             "--out", str(tmp_path / "orbit.mp4")])
    assert wrote is not None


# ---- the preset and the packing ----


def test_preset_has_the_published_widths():
    """Proposal 4 x 256 and a density head; NeRF 8 x 1024 with the sixth
    layer on [h_5 | IPE] (1120 inputs), density head, bottleneck 256, view
    283 -> 128, rgb 128 -> 3; IPE L = 16 (96 inputs); 64, 64 and 32
    intervals; about 8 M parameters."""
    cfg = NeRFConfig.mipnerf360()
    assert cfg.mip360 and not cfg.view_branch
    assert cfg.leaf_sizes() == [(96, 256), (256, 256), (256, 256), (256, 256), (256, 1),
                                (96, 1024), (1024, 1024), (1024, 1024), (1024, 1024),
                                (1024, 1024), (1120, 1024), (1024, 1024), (1024, 1024),
                                (1024, 1), (1024, 256), (283, 128), (128, 3)]
    assert (cfg.proposal_samples, cfg.num_samples, cfg.num_encoding_functions,
            cfg.dir_encoding_functions, cfg.in_channels) == ((64, 64), 32, 16, 4, 96)
    assert cfg.compute_dtype == "bfloat16" and cfg.far >= 1000 and 0 < cfg.near < 1
    n = sum(fi * fo + fo for fi, fo in cfg.leaf_sizes())
    assert 8_000_000 < n < 8_100_000


@pytest.mark.parametrize("net", ["prop", "nerf"])
def test_packing_round_trips(net):
    """Every leaf lands once in the packed layout, the padding stays zero,
    and the gradients' gather reads each leaf back from its place."""
    cfg = NeRFConfig.mipnerf360()
    gen = torch.Generator().manual_seed(2)
    sizes = cfg.leaf_sizes()
    k = cfg.proposal_layers + 1
    part = sizes[:k] if net == "prop" else sizes[k:]
    leaves = {"w": [torch.randn(s, generator=gen) for s in part],
              "b": [torch.randn((s[1],), generator=gen) for s in part]}
    W, b = mip360.pack_params(leaves, net)
    lay = mip360.PROP if net == "prop" else mip360.NERF
    assert W.shape == (lay["w_len"],) and b.shape == (lay["b_len"],)
    flat = [x.reshape(-1) for x in [*leaves["w"], *leaves["b"]]]
    assert int((W != 0).sum()) == sum(int((x.to(torch.bfloat16) != 0).sum())
                                      for x in flat[:len(part)])
    back = mip360._unpack(W.float(), b, [(x.shape, x.dtype)
                                         for x in [*leaves["w"], *leaves["b"]]], net)
    for got, want in zip(back, [*leaves["w"], *leaves["b"]]):
        torch.testing.assert_close(got, want.to(torch.bfloat16).float()
                                   if got.ndim == 2 else want, rtol=0, atol=0)


def test_kernels_refuse_other_widths():
    cfg, model, _ = small_model(0)
    with pytest.raises(ValueError, match="mip360 kernels"):
        mip360._check(cfg, model.params)


def test_reference_imports_torch_only():
    import ast

    tree = ast.parse(open(os.path.join(ROOT, "benchmark/reference/mip360.py")).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module)
    assert names == {"__future__", "torch", "benchmark.reference.nerf"}, names


# ---- on the card (skip here) ----


def card_inputs(n=64, seed=21):
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = NeRFConfig.mipnerf360()
    model = NeRFModel(cfg, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model.init(gen)
    o, d = rays_in_ball(gen, n, torch.float32, "cuda")
    tgt = torch.rand((n, 3), generator=gen, device="cuda")
    return cfg, model, o, d, tgt


@pytest.mark.cuda
def test_card_pieces_match_plain():
    """At the published widths on 64 rays: the resampler (f32, 2e-5), the
    encode (one bf16 step), a proposal round's weights (2e-3), the losses
    and their cotangents (rtol 1e-4) against the plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg, model, o, d, tgt = card_inputs()
    n = o.shape[0]
    rnd = mip360._rnd(cfg)
    prop, nerf = plain.split_nets(model.params, cfg)
    xi = torch.rand((3, n), device="cuda", generator=torch.Generator("cuda").manual_seed(3))
    s1 = mip360.resample(None, None, 64, xi[0], o)
    torch.testing.assert_close(s1, plain.resample(*plain.one_bin(n, o), 64, xi[0]),
                               rtol=0, atol=2e-5)
    Wp, bp = mip360.pack_params(prop, "prop")
    w1, acts = mip360._prop_round(Wp, bp, s1, o, d, cfg)
    feats = plain.encode_intervals(o, d, s1, cfg)
    got = acts[:n * 64 * 256].view(n * 64, 256)[:, :96].float()
    torch.testing.assert_close(got, rnd(feats), rtol=1e-2, atol=8e-3)
    with torch.no_grad():
        want_w = plain.prop_round(prop, o, d, s1, cfg, rnd)
    torch.testing.assert_close(w1, want_w, rtol=0, atol=2e-3)
    s2 = mip360.resample(s1, w1, 64, xi[1], o)
    torch.testing.assert_close(s2, plain.resample(s1, w1, 64, xi[1]), rtol=0, atol=2e-5)
    w2, _ = mip360._prop_round(Wp, bp, s2, o, d, cfg)
    s3 = mip360.resample(s2, w2, 32, xi[2], o)
    col = torch.rand((n, 3), device="cuda")
    w3 = torch.softmax(torch.randn((n, 32), device="cuda"), -1) * 0.9
    terms, dcol, dw3, dws = mip360.losses(col, tgt, s3, w3, [(s1, w1), (s2, w2)])
    leaves = [x.clone().requires_grad_(True) for x in (col, w3, w1, w2)]
    want = torch.stack([plain.charbonnier(leaves[0], tgt).sum() / (3 * n),
                        0.01 * plain.distortion(s3, leaves[1]).sum() / n,
                        plain.interlevel(s3, w3, s1, leaves[2]).sum() / n,
                        plain.interlevel(s3, w3, s2, leaves[3]).sum() / n])
    torch.testing.assert_close(terms, want.detach(), rtol=1e-4, atol=1e-9)
    grads = torch.autograd.grad(want[0] + want[1], leaves[:2]) + \
        torch.autograd.grad(want[2] + want[3], leaves[2:])
    for g, r in zip((dcol, dw3, *dws), grads):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-7)


@pytest.mark.cuda
def test_card_step_matches_plain():
    """The whole step on the card against the plain version with the bf16
    plan on the card (the same jitter) at 256 rays: the loss terms (rtol
    1e-2), the NeRF's intervals (1e-3), every gradient within 15% of its
    leaf's norm (the kernels round each d_z to bf16 where the plain version
    keeps f32: at 64 rays the NeRF's first layer read 13.6% off); two calls
    bit for bit; the render against the plain render."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg, model, o, d, tgt = card_inputs(n=256)
    leaves = [*model.w, *model.b]
    outs = []
    for _ in range(2):
        loss, aux = mip360.train_loss(model.params, o, d, tgt, cfg,
                                      torch.Generator("cuda").manual_seed(5))
        outs.append((loss.detach(), aux["terms"], aux["sdist"],
                     *torch.autograd.grad(loss, leaves)))
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    xi = mip360.draw_jitter(cfg, o.shape[0], torch.Generator("cuda").manual_seed(5))
    want, terms, s3 = plain.train_loss(model.params, o, d, tgt, cfg, xi, mip360._rnd(cfg))
    want_grads = torch.autograd.grad(want, leaves)
    torch.testing.assert_close(outs[0][1], terms.detach(), rtol=1e-2, atol=1e-6)
    torch.testing.assert_close(outs[0][2], s3, rtol=0, atol=1e-3)
    errors = [float((g - r).norm()) / max(float(r.norm()), 1e-12)
              for g, r in zip(outs[0][3:], want_grads)]
    assert max(errors) <= 0.15, errors
    with torch.no_grad():
        got = mip360.render_rays(model.params, o, d, cfg)
        col = plain.render(model.params, o, d, cfg, mip360._rnd(cfg))
    torch.testing.assert_close(got, col, rtol=0, atol=2e-2)


@pytest.mark.cuda
def test_card_model_runs_on_kernels_only():
    """``NeRFModel.loss`` and ``render_image`` at ``mipnerf360()`` launch
    mip360.cu's entries only: per step three resamples, three encodes, two
    proposal rounds forward and backward, one NeRF pass and one loss call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg, model, o, d, tgt = card_inputs()
    for k in fused_nerf.launches:
        fused_nerf.launches[k] = 0
    model.loss(o, d, None, None, tgt, generator=torch.Generator(device="cuda")).backward()
    assert {k: v for k, v in fused_nerf.launches.items() if v} == {
        "mip_resample": 3, "mip_encode": 3, "mip_prop_forward": 2, "mip_prop_backward": 2,
        "mip_nerf_forward": 1, "mip_nerf_backward": 1, "mip_losses": 1}
    from lomanerf_tpu_torch.core import rays

    img = model.render_image(rays.normalized_intrinsics(1.1, "cuda"),
                             torch.eye(4, device="cuda"), 16)
    assert torch.isfinite(img).all()
