"""The published NeRF (``NeRFConfig.paper()``: coarse and fine networks with
the skip connection and the view branch) on the CPU, against the
benchmark's plain reference (``benchmark/reference/nerf_paper.py``) in
float64 at a small width; NeRF's sampler against a direct evaluation of
its formula; the packing of the non-uniform layers; the existing presets'
packing, byte for byte as recorded; ``train_nerf`` and ``make_video`` at
``--preset paper``; and, on a card, ``csrc/nerf_paper.cu`` against the
plain version (the ``cuda`` tests skip here):

    python -m pytest tests/test_torch_nerf_paper.py -q
"""

import ast
import hashlib
import os
import sys

import numpy as np
import pytest
import torch

from lomanerf_tpu_torch.core import rays
from lomanerf_tpu_torch.models import NeRFConfig, NeRFModel
from lomanerf_tpu_torch.models.nerf import paper_loss
from lomanerf_tpu_torch.ops import fused_nerf
from lomanerf_tpu_torch.train.steps import make_single_chip_train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.reference import nerf_paper as ref  # noqa: E402

# a small published NeRF: the skip into the third of 4 layers, the view
# branch, 8 coarse and 8 fine samples
SMALL = dict(num_layers=4, filter_size=16, num_encoding_functions=3, num_samples=8,
             mode="standard", init="nerf", skip_layer=2, dir_encoding_functions=2,
             view_width=8, num_fine_samples=8)


def small_config(**kw):
    return NeRFConfig(**{**SMALL, "dtype": torch.float64, **kw})


def model_dict(cfg):
    return {k: getattr(cfg, k) for k in ("num_layers", "filter_size", "num_encoding_functions",
                                         "num_samples", "near", "far", "skip_layer",
                                         "dir_encoding_functions", "view_width",
                                         "num_fine_samples")}


def small_inputs(seed, n=7, **kw):
    """``(cfg, model, origins, directions, targets, coarse t, coarse dists,
    fine draws u)`` in float64: random biases (the init's are zero), rays
    from around (0, 0, 4) toward the origin."""
    cfg = small_config(**kw)
    model = NeRFModel(cfg, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    model.init(gen)
    with torch.no_grad():
        for b in model.b:
            b.add_(0.1 * torch.randn(b.shape, generator=gen, dtype=b.dtype))
    o = torch.randn(n, 3, generator=gen, dtype=torch.float64) * 0.3 \
        + torch.tensor([0.0, 0.0, 4.0], dtype=torch.float64)
    d = torch.randn(n, 3, generator=gen, dtype=torch.float64) * 0.2 \
        + torch.tensor([0.0, 0.0, -1.0], dtype=torch.float64)
    tgt = torch.rand(n, 3, generator=gen, dtype=torch.float64)
    _, t, dists = rays.sample_along_rays(o, d, cfg.near, cfg.far, cfg.num_samples,
                                         generator=gen)
    u = torch.rand((n, cfg.num_fine_samples), generator=gen)
    return cfg, model, o, d, tgt, t.double(), dists.double(), u


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_loss_and_grads_match_reference(seed):
    """Both passes' loss and every leaf's gradient of both networks, the
    port's plain path (``paper_loss`` on CPU tensors, fine draws from a
    generator) against the reference (the draws worked out again from the
    same seed) in float64."""
    cfg, model, o, d, tgt, t, dists, _ = small_inputs(seed)
    leaves = [*model.w, *model.b]
    loss = paper_loss(cfg, model.params, o, d, t, dists, tgt,
                      torch.Generator().manual_seed(100 + seed))
    grads = torch.autograd.grad(loss, leaves)
    u = ref.fine_draws(torch.Generator().manual_seed(100 + seed), o.shape[0], model_dict(cfg))
    want, want_grads = ref.loss_and_grads(model.params, o, d, tgt, t, u, model_dict(cfg))
    assert float(loss) == pytest.approx(want, rel=1e-10)
    assert len(grads) == len(want_grads) == 2 * len(model.w)
    for i, (g, w) in enumerate(zip(grads, want_grads)):
        torch.testing.assert_close(g, w, rtol=1e-8, atol=1e-11, msg=f"leaf {i}")


@pytest.mark.parametrize("net", ["coarse", "fine"])
def test_each_pass_matches_reference(net):
    """Each pass's colours, weights and sum-MSE (``fused_nerf.paper_train_loss``)
    against the reference's pass, the fine one at the sorted union."""
    cfg, model, o, d, tgt, t, dists, u = small_inputs(3)
    coarse, fine = fused_nerf.paper_nets(model.params)
    rc, rf = ref.nets(model.params)
    if net == "fine":
        _, w = ref.render_pass(rc, o, d, t, model_dict(cfg))
        t = ref.fine_depths(t, w, u)
        dists = ref.steps_of(t)
    mine, theirs = (coarse, rc) if net == "coarse" else (fine, rf)
    loss, w = fused_nerf.paper_train_loss(mine, o, d, t, dists, tgt, cfg, weights=True)
    col_ref, w_ref = ref.render_pass(theirs, o, d, t, model_dict(cfg))
    torch.testing.assert_close(w, w_ref.detach(), rtol=1e-10, atol=1e-13)
    assert float(loss) == pytest.approx(float(((col_ref - tgt) ** 2).sum()), rel=1e-10)


@pytest.mark.parametrize("seed", [4, 5])
def test_render_matches_reference(seed):
    """``NeRFModel.render_rays`` (coarse at the comb, fine depths drawn
    evenly) against the reference's renderer."""
    cfg, model, o, d, *_ = small_inputs(seed)
    t = torch.linspace(cfg.near, cfg.far, cfg.num_samples, dtype=torch.float64)
    dists = torch.cat([t[1:] - t[:-1], torch.full((1,), 1e8, dtype=torch.float64)])
    with torch.no_grad():
        col = model.render_rays(o, d, t, dists)
        want = ref.render(model.params, o, d, model_dict(cfg))
    torch.testing.assert_close(col, want, rtol=1e-10, atol=1e-12)


def direct_inverse(bins, weights, u):
    """The paper code's ``sample_pdf`` evaluated draw by draw in float64
    numpy: the bin whose CDF interval holds u (the last edge at or below
    it), linear inside it."""
    out = np.zeros(u.shape)
    for r in range(u.shape[0]):
        w = weights[r] + 1e-5
        cdf = np.concatenate([[0.0], np.cumsum(w / w.sum())])
        for j, x in enumerate(u[r]):
            i = np.searchsorted(cdf, x, side="right")
            lo, hi = max(i - 1, 0), min(i, len(cdf) - 1)
            den = cdf[hi] - cdf[lo]
            den = 1.0 if den < 1e-5 else den
            out[r, j] = bins[r, lo] + (x - cdf[lo]) / den * (bins[r, hi] - bins[r, lo])
    return out


@pytest.mark.parametrize("draws", ["even", "random"])
@pytest.mark.parametrize("weights", ["random", "zeros", "onehot"])
def test_sample_pdf_matches_formula(weights, draws):
    """``core.rays.sample_pdf`` against :func:`direct_inverse`; all-zero
    weights give the uniform density (the draws at 0 and 1 land on the end
    edges), one-hot weights put every draw but those in the hot bin."""
    gen = torch.Generator().manual_seed(9)
    n, b, s = 5, 12, 16
    bins = torch.sort(torch.rand(n, b + 1, generator=gen, dtype=torch.float64) * 4 + 2).values
    w = {"random": torch.rand(n, b, generator=gen, dtype=torch.float64),
         "zeros": torch.zeros(n, b, dtype=torch.float64),
         "onehot": torch.nn.functional.one_hot(torch.arange(n) % b, b).double()}[weights]
    g = torch.Generator().manual_seed(3) if draws == "random" else None
    got = rays.sample_pdf(bins, w, s, g)
    u = (torch.rand((n, s), generator=torch.Generator().manual_seed(3)).double().numpy()
         if g is not None else np.broadcast_to(np.linspace(0.0, 1.0, s), (n, s)))
    np.testing.assert_allclose(got.numpy(), direct_inverse(bins.numpy(), w.numpy(), u),
                               rtol=1e-12, atol=1e-12)
    if weights == "zeros" and g is None:  # the end draws land on the end edges
        assert torch.all(got[:, 0] == bins[:, 0]) and torch.allclose(got[:, -1], bins[:, -1])
    if weights == "onehot":
        hot = torch.arange(n) % b
        inside = (got >= bins.gather(1, hot[:, None])) & (got <= bins.gather(1, hot[:, None] + 1))
        assert inside[:, 1:-1].all()  # all but the draws at 0 and 1


@pytest.mark.parametrize("coarse", ["shared", "per_ray"])
def test_fine_depths_sorted_and_counted(coarse):
    """The fine pass's depths: the coarse ones and the drawn ones merged,
    sorted, ``S + Nf`` a ray, the coarse depths all present; dists the
    forward differences with the far sentinel."""
    gen = torch.Generator().manual_seed(11)
    n, s, nf = 6, 10, 14
    t = torch.linspace(2.0, 6.0, s)
    if coarse == "per_ray":
        t = t + torch.rand(n, s, generator=gen) * 0.4
    w = torch.rand(n, s, generator=gen)
    t_all, dists = rays.fine_depths(t, w, nf, gen)
    assert t_all.shape == dists.shape == (n, s + nf)
    assert torch.all(t_all[:, 1:] >= t_all[:, :-1])
    tc = t.expand(n, s)
    for r in range(n):
        assert all(bool((t_all[r] == x).any()) for x in tc[r])
    torch.testing.assert_close(dists[:, :-1], t_all[:, 1:] - t_all[:, :-1])
    assert torch.all(dists[:, -1] == 1e8)


@pytest.mark.parametrize("net", ["coarse", "fine"])
def test_pack_unpack_round_trip(net):
    """``pack_paper_params`` then ``unpack_paper_grads`` gives each of the 12
    leaves back (weights rounded to bf16, as packed), and the packed
    layout's padding (the skip layer's zero row, F's zero columns, the view
    layer's rows between the feature and the direction) is zero."""
    cfg = NeRFConfig.paper()
    model = NeRFModel(cfg, device="cpu")
    gen = torch.Generator().manual_seed(13)
    model.init(gen)
    with torch.no_grad():
        for b in model.b:
            b.add_(torch.randn(b.shape, generator=gen))
    part = fused_nerf.paper_nets(model.params)[0 if net == "coarse" else 1]
    W, b = fused_nerf.pack_paper_params(part, cfg)
    assert W.dtype == torch.bfloat16 and W.numel() == sum(
        r * c for r, c in zip(fused_nerf.PAPER_ROWS, fused_nerf.PAPER_COLS))
    back = fused_nerf.unpack_paper_grads(W.float(), b, part, cfg)
    for i, (x, leaf) in enumerate(zip(back, [*part["w"], *part["b"]])):
        want = leaf.detach().to(torch.bfloat16).float() if i < 12 else leaf.detach()
        assert torch.equal(x, want), i
    views, wo, bo = [], 0, 0
    for r, c, nb in zip(fused_nerf.PAPER_ROWS, fused_nerf.PAPER_COLS, fused_nerf.PAPER_BIAS):
        views.append((W.float()[wo: wo + r * c].view(r, c), b[bo: bo + nb]))
        wo, bo = wo + r * c, bo + nb
    assert not views[5][0][319].any()  # the skip layer's row past gamma(x)
    assert not views[8][0][:, 257:].any() and not views[8][1][257:].any()  # F's padding
    assert not views[9][0][256:fused_nerf.PAPER_DIR_ROW].any()
    assert not views[9][0][fused_nerf.PAPER_DIR_ROW + 27:].any()
    assert not views[10][0][:, 3:].any()


# the packed buffers of the existing presets at NeRFModel.init(seed 7), as
# recorded before the published NeRF's packing was added
PRESET_PACK_DIGESTS = {
    "small": ("narrow", 32, "c4cc8eb9f7728762a5e47c0b6cdc092ff7e6ab93a7d2c447b14afa9bb63e39e5"),
    "single64": ("narrow", 64,
                 "6ecd3aab57123a9e33402854d9f3d0498581d1678147a95fc13881144534dfb4"),
    "full": ("wide", 256, "7ffcc6cf291c72a1747664e2e45ded4c00877449489206d6a3a23533c2509948"),
}


@pytest.mark.parametrize("preset", sorted(PRESET_PACK_DIGESTS))
def test_existing_presets_pack_as_before(preset):
    """The narrow and wide packings of ``small``, ``single64`` and ``full``
    are byte for byte what they were."""
    cfg = NeRFConfig.preset(preset)
    model = NeRFModel(cfg, device="cpu")
    model.init(torch.Generator().manual_seed(7))
    kind, width = fused_nerf._plan(cfg, model.params)
    h = hashlib.sha256()
    if kind == "wide":
        W, b = fused_nerf.pack_wide_params(model.params, width, cfg.compute_dtype)
        h.update(W.float().numpy().tobytes())
        h.update(b.numpy().tobytes())
    else:
        t, dists = rays.uniform_depths(cfg.near, cfg.far, cfg.num_samples, "cpu")
        h.update(fused_nerf.pack_params(model.params, t, dists, width).detach().numpy()
                 .tobytes())
    assert (kind, width, h.hexdigest()) == PRESET_PACK_DIGESTS[preset]


def test_paper_preset_shapes():
    """``NeRFConfig.paper()``: 12 leaves a network at the published widths
    (~0.6 M parameters each), both heads under init "nerf"."""
    cfg = NeRFConfig.preset("paper")
    assert (cfg.num_samples, cfg.num_fine_samples, cfg.in_channels, cfg.dir_channels) == \
        (64, 128, 63, 27)
    model = NeRFModel(cfg, device="cpu")
    model.init(torch.Generator().manual_seed(0))
    sizes = [tuple(w.shape) for w in model.w]
    assert sizes[:12] == sizes[12:] == [(63, 256)] + [(256, 256)] * 4 + [(319, 256)] + \
        [(256, 256)] * 2 + [(256, 1), (256, 256), (283, 128), (128, 3)]
    assert model.count_params() == 2 * 595844
    assert float(model.b[8][0]) == 0.5 and float(model.b[20][0]) == 0.5
    assert not torch.equal(model.w[0], model.w[12])


@pytest.mark.parametrize("stratified", [False, True])
def test_train_step_runs_both_passes(stratified):
    """``make_single_chip_train_step`` on the plain path: one step runs both
    passes and one Adam update of both networks' 48 leaves; the loss falls
    over steps on one batch."""
    cfg, model, o, d, tgt, t, dists, _ = small_inputs(6, n=16, dtype=torch.float32)
    if not stratified:
        t, dists = rays.uniform_depths(cfg.near, cfg.far, cfg.num_samples, "cpu")
    t, dists = t.float(), dists.float()
    before = [p.detach().clone() for p in model.parameters()]
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    step = make_single_chip_train_step(cfg, opt, generator=torch.Generator().manual_seed(1))
    losses = [float(step(model, o.float(), d.float(), t, dists, tgt.float()))
              for _ in range(8)]
    assert losses[-1] < losses[0]
    assert all(not torch.equal(p, q) for p, q in zip(model.parameters(), before))


def test_fused_route_refuses_other_widths_on_the_card_check():
    """The card's kernels take the published widths only: the check refuses
    a small network (the plain path takes it)."""
    cfg, model, *_ = small_inputs(0, dtype=torch.float32)
    with pytest.raises(ValueError, match="widths"):
        fused_nerf._check_paper(cfg, fused_nerf.paper_nets(model.params)[0])
    paper = NeRFConfig.paper()
    full = NeRFModel(paper, device="cpu")
    fused_nerf._check_paper(paper, fused_nerf.paper_nets(full.params)[0])


def test_train_nerf_and_make_video_at_preset_paper(tmp_path):
    """``train_nerf --preset paper --device cpu`` (two stratified steps, an
    eval render, a checkpoint) and ``make_video --preset paper`` from it."""
    from lomanerf_tpu_torch.train import make_video, train_nerf

    ckpt = tmp_path / "ckpt"
    out = train_nerf.main(["--preset", "paper", "--device", "cpu", "--steps", "2",
                           "--img-size", "6", "--rays-per-batch", "8", "--stratified",
                           "--eval-every", "1", "--log-dir", str(tmp_path / "logs"),
                           "--ckpt-dir", str(ckpt)])
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    assert sorted(out["psnr"]) == [0, 1]
    wrote = make_video.main(["--ckpt-dir", str(ckpt), "--preset", "paper", "--device", "cpu",
                             "--orbit", "1", "--img-size", "5",
                             "--out", str(tmp_path / "orbit.mp4")])
    assert wrote is not None


def test_reference_imports_torch_alone():
    """``benchmark/reference/nerf_paper.py`` imports torch and this
    directory's ``nerf.py`` only: nothing of the program, no JAX."""
    path = os.path.join(ROOT, "benchmark", "reference", "nerf_paper.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module)
    assert names == {"__future__", "torch", "benchmark.reference.nerf"}, names


# ---- on the card (skip here) ----


def card_inputs(n=37, seed=21):
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = NeRFConfig.paper()
    model = NeRFModel(cfg, device="cuda")
    model.init(torch.Generator().manual_seed(seed))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    o = torch.nn.functional.normalize(torch.randn((n, 3), generator=gen, device="cuda"),
                                      dim=-1) * 4.0
    d = -o / 4.0 + 0.3 * torch.randn((n, 3), generator=gen, device="cuda")
    tgt = torch.rand((n, 3), generator=gen, device="cuda")
    _, t, dists = rays.sample_along_rays(o, d, cfg.near, cfg.far, cfg.num_samples,
                                         generator=gen)
    return cfg, model, o, d, tgt, t, dists


@pytest.mark.cuda
@pytest.mark.parametrize("net", ["coarse", "fine"])
def test_card_pass_matches_plain(net):
    """``nerf_paper_train`` against the plain version (the bf16 plan) on the
    card at 37 rays: loss rtol 1e-3, weights 2e-3, every gradient within 6%
    of its leaf's norm (bf16 roundings in another order on both sides); two
    calls bit for bit; ``nerf_paper_render``'s colours and weights."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg, model, o, d, tgt, t, dists = card_inputs()
    coarse, fine = fused_nerf.paper_nets(model.params)
    if net == "fine":
        with torch.no_grad():
            _, w = fused_nerf.paper_render(coarse, o, d, t, dists, cfg, weights=True)
        t, dists = rays.fine_depths(t, w, cfg.num_fine_samples)
    part = coarse if net == "coarse" else fine
    leaves = [*part["w"], *part["b"]]
    outs = []
    for _ in range(2):
        loss, w = fused_nerf.paper_train_loss(part, o, d, t, dists, tgt, cfg, weights=True)
        outs.append((loss.detach(), w, *torch.autograd.grad(loss, leaves)))
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    col, want_w = fused_nerf.paper_reference(part, o, d, t, dists, cfg)
    want = ((col - tgt) ** 2).sum()
    want_grads = torch.autograd.grad(want, leaves)
    torch.testing.assert_close(outs[0][0], want.detach(), rtol=1e-3, atol=0.0)
    torch.testing.assert_close(outs[0][1], want_w.detach(), rtol=0.0, atol=2e-3)
    for i, (g, r) in enumerate(zip(outs[0][2:], want_grads)):
        assert float((g - r).norm()) <= 0.06 * float(r.norm()) + 1e-6, i
    with torch.no_grad():
        got_col, got_w = fused_nerf.paper_render(part, o, d, t, dists, cfg, weights=True)
    torch.testing.assert_close(got_col, col.detach(), rtol=0.0, atol=2e-2)
    assert torch.equal(got_w, outs[0][1])


@pytest.mark.cuda
def test_card_model_runs_on_kernels_only():
    """``NeRFModel.loss`` and ``render_image`` at ``paper()`` launch the
    published NeRF's entries only: two train calls a loss, two render calls
    a chunk."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg, model, o, d, tgt, t, dists = card_inputs()
    for k in fused_nerf.launches:
        fused_nerf.launches[k] = 0
    model.loss(o, d, t, dists, tgt, generator=torch.Generator(device="cuda")).backward()
    img = model.render_image(rays.normalized_intrinsics(1.1, "cuda"),
                             torch.eye(4, device="cuda"), 16)
    assert {k: v for k, v in fused_nerf.launches.items() if v} == {
        "nerf_paper_train": 2, "nerf_paper_render": 2}
    assert torch.isfinite(img).all()
