"""The port's train slice against the JAX package, on the CPU.

Same numpy-seeded params and rays through both packages.  On CPU tensors the
port's ``nerf_train_loss`` and render backward run their plain versions;
they are held to the JAX package's fused train kernel
(``_nerf_train_kernel_S`` in interpret mode: ``(S,)`` depths and no
``tile_rays``), its render VJP (``_nerf_backward_kernel_S`` through
``render_vjp``) and ``jax.value_and_grad`` of the core pipeline, at the JAX
test's bounds: loss rtol 1e-5, grads rtol 3e-4 / atol 3e-5.  The CUDA
kernels' algorithm (the reverse walk of ``csrc/nerf_grad.cuh``, reading and
writing the packed layouts) is checked here by a numpy re-statement;
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` compare the kernels
themselves on the card.  Also: the ray samplers, optimizers, train step,
synthetic data, checkpoints, logging, the driver and the build hash.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lomanerf_tpu import core as jcore
from lomanerf_tpu.models import NeRFConfig as JConfig
from lomanerf_tpu.ops import fused_nerf as j_fused
from lomanerf_tpu.train import loma_adam as j_loma_adam
from lomanerf_tpu.train import loma_sgd as j_loma_sgd
from lomanerf_tpu_torch import core as tcore
from lomanerf_tpu_torch.models import NeRFConfig, NeRFModel
from lomanerf_tpu_torch.ops import build, fused_nerf
from lomanerf_tpu_torch.train import optim
from lomanerf_tpu_torch.train.checkpoint import CheckpointManager
from lomanerf_tpu_torch.train.logging_utils import MetricsLogger, write_png
from lomanerf_tpu_torch.train.steps import make_single_chip_train_step, resolve_backend

LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 3e-4, 3e-5


def np_params(rng, sizes):
    ws = [(rng.standard_normal((fi, fo)) * np.sqrt(2.0 / fi)).astype(np.float32)
          for fi, fo in sizes]
    bs = [(rng.standard_normal(fo) * 0.5).astype(np.float32) for _, fo in sizes]
    return ws, bs


def batch(rng, n, S, near=2.0, far=6.0):
    """numpy (origins, directions, t, dists, target) with (S,) depths."""
    o = rng.standard_normal((n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    t = np.linspace(near, far, S, dtype=np.float32)
    dists = np.concatenate([t[1:] - t[:-1], [1e8]]).astype(np.float32)
    tgt = rng.random((n, 3)).astype(np.float32)
    return o, d, t, dists, tgt


def leaves(params):
    return [p.requires_grad_(True) for p in [*params["w"], *params["b"]]]


def close_grads(got, want, rtol=GRAD_RTOL, atol=GRAD_ATOL):
    """``got``: port leaves (w..., b...); ``want``: a JAX {"w", "b"} dict."""
    for g, w in zip(got, [*want["w"], *want["b"]]):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=rtol, atol=atol)


@pytest.mark.parametrize("mode", ["loma", "standard"])
@pytest.mark.parametrize("num_samples", [8, 30])
def test_train_loss_matches_jax_kernel_and_core(rng, mode, num_samples):
    """Port nerf_train_loss (CPU) vs the JAX fused train kernel and
    value_and_grad of the JAX core; the loss-seeded adjoint; None ray grads."""
    cfg = NeRFConfig(num_layers=3, filter_size=16, num_samples=num_samples, mode=mode)
    jcfg = JConfig(num_layers=3, filter_size=16, num_samples=num_samples, mode=mode)
    ws, bs = np_params(rng, tcore.mlp_layer_sizes(33, 4, 3, 16))
    o, d, t, dists, tgt = batch(rng, 20, num_samples)  # 20: not a tile multiple
    jp = jcore.params_from_numpy(ws, bs)
    j_args = [jnp.asarray(x) for x in (o, d, t, dists, tgt)]
    k_loss, k_grads = jax.value_and_grad(
        lambda p: j_fused.nerf_train_loss(p, *j_args, jcfg))(jp)
    c_loss, c_grads = jax.value_and_grad(
        lambda p: jcore.nerf_loss_rays(p, *j_args, 5, mode))(jp)

    params = tcore.params_from_numpy(ws, bs, "cpu")
    lv = leaves(params)
    t_args = [torch.from_numpy(x) for x in (o, d, t, dists, tgt)]
    t_args[0].requires_grad_(True)
    loss = fused_nerf.nerf_train_loss(params, *t_args, cfg)
    assert loss.shape == ()
    got = torch.autograd.grad(loss, lv, retain_graph=True)
    for want_loss, want in ((k_loss, k_grads), (c_loss, c_grads)):
        np.testing.assert_allclose(loss.item(), float(want_loss), rtol=LOSS_RTOL)
        close_grads(got, want)
    assert torch.autograd.grad(loss, [t_args[0]], allow_unused=True) == (None,)

    vg = tcore.seeded_value_and_grad(
        lambda p, *a: fused_nerf.nerf_train_loss(p, *a, cfg))
    l1, g1 = vg(params, *t_args)
    l2, g2 = vg(params, *t_args, seed=l1)
    assert float(l1) == float(l2) == loss.item()
    # the plain version carries the seed through every backward op, so
    # entries near 0 round apart: atol 1e-6 of the seed beside rtol 1e-5
    for a, b in zip([*g2["w"], *g2["b"]], [*g1["w"], *g1["b"]]):
        np.testing.assert_allclose(a.numpy(), float(l1) * b.numpy(), rtol=1e-5,
                                   atol=1e-6 * float(l1))


@pytest.mark.parametrize("mode", ["loma", "standard"])
def test_render_backward_matches_jax_vjp(rng, mode):
    """Gradients through the port's render_rays (CPU) vs jax.vjp of the JAX
    fused render, whose VJP is the _nerf_backward_kernel_S kernel."""
    cfg = NeRFConfig(num_samples=8, mode=mode)
    ws, bs = np_params(rng, tcore.mlp_layer_sizes(33, 4, 3, 30))
    o, d, t, dists, _ = batch(rng, 20, 8)
    cot = rng.standard_normal((20, 3)).astype(np.float32)
    _, vjp = jax.vjp(lambda p: j_fused.render_rays(
        p, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t), jnp.asarray(dists),
        JConfig(num_samples=8, mode=mode)), jcore.params_from_numpy(ws, bs))
    (want,) = vjp(jnp.asarray(cot))
    params = tcore.params_from_numpy(ws, bs, "cpu")
    lv = leaves(params)
    out = fused_nerf.render_rays(params, *(torch.from_numpy(x) for x in (o, d, t, dists)),
                                 cfg)
    got = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), lv)
    close_grads(got, want)


@pytest.mark.parametrize("mode", ["loma", "standard"])
def test_stratified_offset_equals_perray_depths(rng, mode):
    """Offsets folded into the origins, with (S,) depths (the fused path),
    give the loss and grads of the JAX core at explicit per-ray depths."""
    S = 30
    cfg = NeRFConfig(num_samples=S, mode=mode)
    ws, bs = np_params(rng, tcore.mlp_layer_sizes(33, 4, 3, 30))
    o, d, t, dists, tgt = batch(rng, 20, S)
    dt = tcore.stratified_ray_offsets(torch.Generator().manual_seed(11), 20,
                                      cfg.near, cfg.far, S)
    assert float(dt.min()) >= 0.0 and float(dt.max()) < (cfg.far - cfg.near) / S
    params = tcore.params_from_numpy(ws, bs, "cpu")
    lv = leaves(params)
    o_t, d_t = torch.from_numpy(o), torch.from_numpy(d)
    loss = fused_nerf.nerf_train_loss(params, o_t + d_t * dt[:, None], d_t,
                                      torch.from_numpy(t), torch.from_numpy(dists),
                                      torch.from_numpy(tgt), cfg)
    got = torch.autograd.grad(loss, lv)
    t_perray = jnp.asarray(t)[None, :] + jnp.asarray(dt.numpy())[:, None]
    want_loss, want = jax.value_and_grad(lambda p: jcore.nerf_loss_rays(
        p, jnp.asarray(o), jnp.asarray(d), t_perray,
        jnp.broadcast_to(jnp.asarray(dists), (20, S)), jnp.asarray(tgt), 5, mode))(
        jcore.params_from_numpy(ws, bs))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=LOSS_RTOL)
    close_grads(got, want)


def grad_walk(pk, origins, directions, cot, S, L, in_dim, nf, W, loma, train,
              depths=None):
    """numpy (f64) re-statement of nerf_grad.cuh: per ray, the forward keeping
    P_s, then the reverse walk with the scalar suffix sum, accumulating into
    the packed gradient layout.  Depths: the shared ones of the buffer's
    tail, or with ``depths = (t, dists)`` (N, S) row r for ray r (the
    ``*_rays`` kernels; the buffer then ends with the weights).  Returns
    (G gradient floats, loss)."""
    pk = pk.astype(np.float64)
    rows = [in_dim] + [W] * (L - 1)
    cols = [W] * (L - 1) + [4]
    offs = np.cumsum([0] + [r * c + c for r, c in zip(rows, cols)])
    G = int(offs[-1])
    n = origins.shape[0]
    if depths is None:
        t_rays = np.broadcast_to(pk[G:G + S], (n, S))
        d_rays = np.broadcast_to(pk[G + S:G + 2 * S], (n, S))
    else:
        assert pk.size == -(-G // 4) * 4  # no depth tail
        t_rays, d_rays = depths
    grad, loss = np.zeros(G), 0.0

    def layer(l):
        w = pk[offs[l]:offs[l] + rows[l] * cols[l]].reshape(rows[l], cols[l])
        return w, pk[offs[l] + rows[l] * cols[l]:offs[l + 1]]

    def forward(p):
        enc = [p]
        for i in range(nf):
            enc += [np.sin(2.0**i * p), np.cos(2.0**i * p)]
        ins = [np.concatenate(enc)]
        for l in range(L):
            w, b = layer(l)
            z = ins[-1] @ w + b
            if l < L - 1:
                ins.append(np.maximum(z, 0.0))
        return ins, z

    for r in range(n):
        o, d = origins[r], directions[r]
        t, dist = t_rays[r], d_rays[r]
        P, Ps, col = 1.0, [], np.zeros(3)
        for s in range(S):
            _, raw = forward(o + d * t[s])
            e = np.exp(-max(raw[3], 0.0) * dist[s])
            c = e + 1e-10
            if loma:
                P *= c
                T = 1.0 if s == 0 else P
            else:
                T, P = P, P * c
            Ps.append(P)
            col += (1.0 - e) * T / (1.0 + np.exp(-raw[:3]))
        if train:
            loss += float(np.sum((col - cot[r]) ** 2))
            dcol = 2.0 * (col - cot[r])
        else:
            dcol = cot[r]
        suf = carry = 0.0
        for s in reversed(range(S)):
            ins, raw = forward(o + d * t[s])
            alpha = 1.0 - np.exp(-max(raw[3], 0.0) * dist[s])
            c = 1.0 - alpha + 1e-10
            Ts = 1.0 if s == 0 else (Ps[s] if loma else Ps[s - 1])
            rgb = 1.0 / (1.0 + np.exp(-raw[:3]))
            d_w = float(dcol @ rgb)
            if loma:
                d_P = d_w * alpha if s >= 1 else 0.0
            else:
                d_P, carry = (carry if s < S - 1 else 0.0), d_w * alpha
            suf += d_P * Ps[s]
            d_alpha = d_w * Ts - suf / c
            dz = np.zeros(4)
            dz[:3] = dcol * alpha * Ts * rgb * (1.0 - rgb)
            dz[3] = d_alpha * dist[s] * (1.0 - alpha) if raw[3] > 0 else 0.0
            for l in reversed(range(L)):
                grad[offs[l]:offs[l] + rows[l] * cols[l]] += np.outer(ins[l], dz).ravel()
                grad[offs[l] + rows[l] * cols[l]:offs[l + 1]] += dz
                if l > 0:
                    dz = (layer(l)[0] @ dz) * (ins[l] > 0)
    return grad, loss


@pytest.mark.parametrize("depths", ["shared", "perray"])
@pytest.mark.parametrize("layers,width,mode", [
    (3, 30, "loma"),       # small: W = 32
    (4, 64, "standard"),   # single64: W = 64
    (1, 30, "standard"),   # one layer: layer 0 is the head
    (2, 17, "loma"),       # no hidden-to-hidden layer
])
@pytest.mark.parametrize("train", [True, False])
def test_grad_kernel_algorithm_matches_autograd(rng, layers, width, mode, train, depths):
    """The gradient kernels' reverse walk, restated in numpy over the packed
    buffer, unpacked by the wrapper's unpack_grads, equals autograd of the
    plain version: the train loss (#3, or #6 on per-ray depths) or
    (render * cot).sum() (#2, or #5): shared (S,) depths, or jittered
    per-ray (N, S) ones from the stratified sampler."""
    S, n = 7, 9
    cfg = NeRFConfig(num_layers=layers, filter_size=width, num_samples=S, mode=mode)
    ws, bs = np_params(rng, tcore.mlp_layer_sizes(33, 5, layers, width))  # ch 4 unread
    params = tcore.params_from_numpy(ws, bs, "cpu")
    o, d, t, dists, tgt = batch(rng, n, S)
    if depths == "perray":
        _, t_rays, d_rays = tcore.sample_along_rays(
            torch.zeros(n, 3), torch.zeros(n, 3), 2.0, 6.0, S,
            generator=torch.Generator().manual_seed(layers))
        t, dists = t_rays.numpy(), d_rays.numpy()
        assert t.shape == (n, S)
    cot = tgt if train else rng.standard_normal((n, 3)).astype(np.float32)
    W = fused_nerf._route(cfg, params)[1]
    pk = fused_nerf.pack_params(params, torch.from_numpy(t), torch.from_numpy(dists), W)
    G = fused_nerf.grad_floats(params, W)
    flat, loss = grad_walk(pk.numpy(), o.astype(np.float64), d.astype(np.float64),
                           cot.astype(np.float64), S, layers, 33, 5, W, mode == "loma",
                           train, None if depths == "shared" else
                           (t.astype(np.float64), dists.astype(np.float64)))
    assert flat.shape == (G,)
    got = fused_nerf.unpack_grads(torch.from_numpy(flat), params, W)
    args = [torch.from_numpy(x) for x in (o, d, t, dists)]
    lv = leaves(params)
    if train:
        out = fused_nerf.nerf_train_loss_reference(params, *args, torch.from_numpy(tgt), cfg)
        np.testing.assert_allclose(loss, out.item(), rtol=LOSS_RTOL)
    else:
        out = (fused_nerf.render_rays_reference(params, *args, cfg)
               * torch.from_numpy(cot)).sum()
    want = torch.autograd.grad(out, lv)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=GRAD_RTOL, atol=GRAD_ATOL)
    assert float(got[layers - 1][:, 4].abs().max()) == 0.0  # unread head channel


def test_gradient_kernels_fit_shared_memory(rng):
    """Both presets fit one block's shared memory (small ~70 KB, single64
    ~213 KB: staging rows of 68 floats, a float4 of 4 rays) and take the
    narrow kernels; a 64-wide MLP whose block does not fit (5x64 and 8x64 at
    S = 64, 4x64 at S = 160) takes the wide route at pw = 128 instead, as
    the JAX package's dispatch does."""
    for name, limit in (("small", 70 * 1024), ("single64", 214 * 1024)):
        cfg = NeRFConfig.preset(name)
        params = tcore.params_from_numpy(*np_params(rng, tcore.mlp_layer_sizes(
            33, 4, cfg.num_layers, cfg.filter_size)), "cpu")
        kind, W = fused_nerf._route(cfg, params)
        assert kind == "narrow"
        G = fused_nerf.grad_floats(params, W)
        pk_floats = G + 2 * cfg.num_samples  # G and 2S are multiples of 4 here
        assert fused_nerf.grad_smem_bytes(pk_floats, G, cfg.num_samples,
                                          cfg.num_layers, 33, W) < limit
    for layers, S in ((5, 64), (8, 64), (4, 160)):
        deep = NeRFConfig(num_layers=layers, filter_size=64, num_samples=S)
        params = tcore.params_from_numpy(*np_params(rng, tcore.mlp_layer_sizes(
            33, 4, layers, 64)), "cpu")
        G = fused_nerf.grad_floats(params, 64)
        assert fused_nerf.grad_smem_bytes(G + 2 * S, G, S, layers, 33, 64) > 227 * 1024
        assert fused_nerf._route(deep, params) == ("wide", 128)


@pytest.mark.parametrize("layers,width", [(3, 30), (4, 64), (1, 30), (2, 17)])
def test_grad_tile_plan_covers_each_entry_once(rng, layers, width):
    """The dW tile plan's host mirror (``nerf_grad.cuh``: ``DwTile``) at
    ``small``, ``single64`` and the one- and two-layer MLPs ``_route`` sends
    narrow: the block's 64 threads cover each of G's entries exactly once,
    each main tile's per-sample sums stay within the registers the source
    states (16 at W = 32, 64 at W = 64; the head 2 and 4), and at the
    presets no thread takes more than 5% above an even share."""
    cfg = NeRFConfig(num_layers=layers, filter_size=width)
    params = tcore.params_from_numpy(*np_params(rng, tcore.mlp_layer_sizes(
        33, 4, layers, width)), "cpu")
    kind, W = fused_nerf._route(cfg, params)
    assert kind == "narrow"
    G = fused_nerf.grad_floats(params, W)
    plan = fused_nerf.grad_tile_plan(layers, 33, W)
    assert len(plan) == layers
    got = sorted(i for main, rest, _ in plan for t in range(64) for i in main[t] + rest[t])
    assert got == list(range(G))
    for l, (main, rest, budget) in enumerate(plan):
        assert budget == ({32: 2, 64: 4} if l == layers - 1 else {32: 16, 64: 64})[W]
        assert all(len(m) <= budget for m in main)
    share = [sum(len(main[t]) + len(rest[t]) for main, rest, _ in plan) for t in range(64)]
    if layers >= 3:
        assert max(share) <= 1.05 * G / 64


def test_grad_variants_edit_the_current_source():
    """Every variant of ``scripts/grad_variants`` applies to the walk's
    headers as they stand (each edit matches as often as it names), the
    first is the headers unchanged, and each changes what it names; the
    script refuses to run without a card."""
    from lomanerf_tpu_torch.scripts import grad_variants

    srcs = grad_variants.patched(grad_variants.VARIANTS)
    now = {h: (build.CSRC / h).read_text() for h in grad_variants.HEADERS}
    assert srcs.pop("as is") == now
    keys = [tuple(v.values()) for v in srcs.values()]
    assert len(set(keys)) == len(keys) and now not in srcs.values()
    with pytest.raises(SystemExit):
        grad_variants.patched({"x": ([("nerf_grad.cuh", "no such line", "", 1)], False)})
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):
            grad_variants.main([])


def test_generate_random_rays(rng):
    from lomanerf_tpu.data import sphere_poses

    cams = sphere_poses(3, radius=4.0)
    o, d = tcore.generate_random_rays(torch.Generator().manual_seed(0), (32, 32), 17,
                                      torch.from_numpy(cams))
    assert o.shape == d.shape == (51, 3)
    np.testing.assert_allclose(torch.linalg.norm(d, dim=-1).numpy(), 1.0, rtol=1e-6)
    np.testing.assert_array_equal(o.numpy(), np.repeat(cams[:, :3, 3], 17, axis=0))
    # a 1x1 image fixes the pixel: the rays equal the JAX sampler's
    o1, d1 = tcore.generate_random_rays(torch.Generator(), (1, 1), 4, torch.from_numpy(cams))
    jo, jd = jcore.generate_random_rays(jax.random.PRNGKey(0), (1, 1), 4, jnp.asarray(cams))
    np.testing.assert_allclose(o1.numpy(), np.asarray(jo), rtol=0, atol=0)
    np.testing.assert_allclose(d1.numpy(), np.asarray(jd), rtol=1e-6, atol=1e-7)


def _np_grads(rng, shapes, steps):
    return [[rng.standard_normal(s).astype(np.float32) for s in shapes]
            for _ in range(steps)]


@pytest.mark.parametrize("which", ["loma_adam", "adam", "sgd"])
def test_optimizers_match_jax(rng, which):
    """5 steps of the same numpy grads: LomaAdam vs JAX loma_adam,
    torch.optim.Adam vs optax.adam, loma_sgd vs JAX loma_sgd (rtol 1e-6)."""
    shapes = [(4, 3), (3,)]
    p0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = _np_grads(rng, shapes, 5)
    lr = 1e-3
    jopt = {"loma_adam": j_loma_adam(lr), "adam": optax.adam(lr),
            "sgd": j_loma_sgd(lr)}[which]
    tp = [torch.tensor(p, requires_grad=True) for p in p0]
    topt = {"loma_adam": lambda: optim.loma_adam(tp, lr),
            "adam": lambda: torch.optim.Adam(tp, lr=lr),
            "sgd": lambda: optim.loma_sgd(tp, lr)}[which]()
    jp = [jnp.asarray(p) for p in p0]
    state = jopt.init(jp)
    for g in grads:
        upd, state = jopt.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x)
        topt.step()
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)


def test_loma_adam_differs_from_standard_adam(rng):
    """The reference double-corrects bias: LomaAdam is not textbook Adam."""
    p0 = rng.standard_normal(5).astype(np.float32)
    g = torch.from_numpy(rng.standard_normal(5).astype(np.float32))
    out = []
    for make in (lambda p: optim.loma_adam([p], 1e-3), lambda p: torch.optim.Adam([p], lr=1e-3)):
        p = torch.tensor(p0, requires_grad=True)
        opt = make(p)
        for _ in range(2):
            p.grad = g.clone()
            opt.step()
        out.append(p.detach().numpy())
    assert not np.allclose(out[0], out[1])


@pytest.mark.parametrize("which", ["loma_sgd", "loma_adam"])
def test_train_step_trajectory_matches_jax(rng, which):
    """3 steps of make_single_chip_train_step on the same numpy params and
    batches vs the JAX step (backend="jnp").  SGD: params rtol 1e-5 / atol
    1e-6.  Adam divides by sqrt(v), so a gradient entry near 0 turns a tiny
    difference into a larger relative one: params rtol 1e-4 / atol 1e-5."""
    from lomanerf_tpu.train.steps import make_single_chip_train_step as j_make_step

    cfg = NeRFConfig(num_layers=3, filter_size=16, num_samples=8)
    jcfg = JConfig(num_layers=3, filter_size=16, num_samples=8)
    ws, bs = np_params(rng, tcore.mlp_layer_sizes(33, 4, 3, 16))
    batches = [batch(rng, 32, 8) for _ in range(3)]
    lr = 1e-3
    j_opt = {"loma_sgd": j_loma_sgd(lr), "loma_adam": j_loma_adam(lr)}[which]
    jp = jcore.params_from_numpy(ws, bs)
    js = j_opt.init(jp)
    j_step = j_make_step(jcfg, j_opt, backend="jnp", donate=False)
    model = NeRFModel.from_numpy(cfg, ws, bs, device="cpu")
    t_opt = {"loma_sgd": optim.loma_sgd, "loma_adam": optim.loma_adam}[which](
        list(model.parameters()), lr)
    step = make_single_chip_train_step(cfg, t_opt)
    rtol, atol = (1e-5, 1e-6) if which == "loma_sgd" else (1e-4, 1e-5)
    for b in batches:
        jp, js, j_loss = j_step(jp, js, *(jnp.asarray(x) for x in b))
        loss = step(model, *(torch.from_numpy(x) for x in b))
        assert loss.shape == () and not loss.requires_grad
        np.testing.assert_allclose(float(loss), float(j_loss), rtol=LOSS_RTOL)
        for a, w in zip([*model.w, *model.b], [*jp["w"], *jp["b"]]):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(w), rtol=rtol,
                                       atol=atol)


def test_backends_and_model_loss(rng):
    cfg = NeRFConfig(num_samples=8)
    assert resolve_backend(cfg) == "fused" and resolve_backend(cfg, "plain") == "plain"
    with pytest.raises(ValueError):
        resolve_backend(cfg, "pallas")
    model = NeRFModel.from_numpy(cfg, *np_params(rng, tcore.mlp_layer_sizes(33, 4, 3, 30)),
                                 device="cpu")
    args = [torch.from_numpy(x) for x in batch(rng, 11, 8)]
    want = tcore.nerf_loss_rays(model.params, *args, 5, "loma")
    torch.testing.assert_close(model.loss(*args), want, rtol=1e-6, atol=0)
    torch.testing.assert_close(
        fused_nerf.nerf_train_loss(model.params, *args, cfg), want, rtol=1e-6, atol=0)


def test_synthetic_scene_render_matches_jax():
    from lomanerf_tpu.data.synthetic import GaussianBlobScene as JScene
    from lomanerf_tpu_torch.data import GaussianBlobScene, sphere_poses

    pose = sphere_poses(4, radius=4.0)[1]
    want = JScene().render(jcore.normalized_intrinsics(1.1106), pose, 16)
    got = GaussianBlobScene().render(tcore.normalized_intrinsics(1.1106), pose, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_synthetic_views_equal_png_round_trip(tmp_path):
    """synthetic_views (in memory, no PIL) equals the dataset written to PNGs
    and read back: exactly through the port's own writer and loader, and
    within one 8-bit level of the JAX package's (the two renders differ in
    the last float32 bits, which can move a value across a level)."""
    from lomanerf_tpu.data import NeRFDataset as JDataset
    from lomanerf_tpu.data import write_blender_dataset as j_write
    from lomanerf_tpu_torch.data import NeRFDataset, synthetic_views, write_blender_dataset

    images, poses, focal = synthetic_views(4, 16)
    assert images.shape == (4, 16, 16, 3) and poses.shape == (4, 4, 4)
    write_blender_dataset(str(tmp_path / "port"), n_frames=4, img_size=16)
    j_write(str(tmp_path / "jax"), n_frames=4, img_size=16)
    for root, Dataset, exact in ((tmp_path / "port", NeRFDataset, True),
                                 (tmp_path / "jax", JDataset, False)):
        ds = Dataset(str(root), img_size=16)
        assert len(ds) == 4 and ds.focal_length == focal
        for i in range(4):
            np.testing.assert_array_equal(poses[i].numpy(), ds[i]["pose"])
            diff = np.abs(images[i].numpy() - ds[i]["image"])
            if exact:
                assert diff.max() == 0.0
            else:
                assert diff.max() <= 1.0 / 255 + 1e-7 and (diff > 0).mean() < 0.01


def test_checkpoint_round_trip_rotation_and_latest(tmp_path, rng):
    cfg = NeRFConfig(num_samples=8)
    ws, bs = np_params(rng, tcore.mlp_layer_sizes(33, 4, 3, 30))
    model = NeRFModel.from_numpy(cfg, ws, bs, device="cpu")
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    assert mgr.latest_step() is None
    for step in (5, 10, 15):
        for p in model.parameters():
            p.grad = torch.ones_like(p)
        opt.step()
        mgr.save(step, model, opt)
    assert mgr.steps() == [10, 15] and mgr.latest_step() == 15
    saved = [p.detach().clone() for p in model.parameters()]

    fresh = NeRFModel(cfg, device="cpu")
    fresh_opt = torch.optim.Adam(fresh.parameters(), lr=1e-3)
    assert mgr.restore(fresh, fresh_opt) == 15
    for a, b in zip(fresh.parameters(), saved):
        assert torch.equal(a.detach(), b)
    assert fresh_opt.state_dict()["state"][0]["step"] == 3
    params = {"w": [torch.zeros_like(w) for w in model.w],
              "b": [torch.zeros_like(b) for b in model.b]}
    assert mgr.restore(params, step=10) == 10
    assert not torch.equal(params["w"][0], saved[0])  # step 10, not 15
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(fresh)


def test_metrics_logger_and_png(tmp_path):
    from PIL import Image

    log = MetricsLogger(str(tmp_path / "logs"))
    log.log(3, loss=1.5, psnr=20.0)
    log.close()
    rec = json.loads(open(tmp_path / "logs" / "metrics.jsonl").read())
    assert rec["step"] == 3 and rec["loss"] == 1.5 and rec["psnr"] == 20.0
    img = np.random.default_rng(0).integers(0, 256, (5, 7, 3), dtype=np.uint8)
    write_png(str(tmp_path / "a.png"), img)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "a.png")), img)
    with pytest.raises(ValueError):
        write_png(str(tmp_path / "b.png"), img.astype(np.float32))
    from lomanerf_tpu_torch.train.logging_utils import save_triptych

    save_triptych(str(tmp_path / "t.png"), img / 255.0, img / 255.0, [3.0, 2.0, 1.0])
    assert (tmp_path / "t.png").stat().st_size > 0


def test_build_hash_follows_headers(tmp_path):
    """The library's hash covers every .cu and .cuh: editing a header gives
    a new build directory."""
    (tmp_path / "k.cu").write_text('#include "k.cuh"\n')
    (tmp_path / "k.cuh").write_text("// v1\n")
    h1 = build.source_hash(tmp_path)
    assert build.source_hash(tmp_path) == h1
    (tmp_path / "k.cuh").write_text("// v2\n")
    assert build.source_hash(tmp_path) != h1
    (tmp_path / "k.cu").write_text('#include "k.cuh"\n// edited\n')
    assert len({h1, build.source_hash(tmp_path)}) == 2
    assert build.source_hash() != build.source_hash(tmp_path)


def test_train_nerf_driver_smoke(tmp_path, monkeypatch):
    from lomanerf_tpu_torch.train import train_nerf

    monkeypatch.chdir(tmp_path)
    flags = ["--device", "cpu", "--data", "synthetic", "--img-size", "16",
             "--rays-per-batch", "64", "--samples", "8", "--width", "16",
             "--log-dir", str(tmp_path / "logs_3d"), "--ckpt-dir", str(tmp_path / "ck"),
             "--ckpt-every", "0"]
    out = train_nerf.main([*flags, "--steps", "12", "--eval-every", "10"])
    assert os.path.exists(tmp_path / "logs_3d" / "10.png")
    assert len(out["losses"]) == 12 and sorted(out["psnr"]) == [0, 10]
    assert CheckpointManager(str(tmp_path / "ck")).latest_step() == 12
    # resume path, with stratified offsets
    out = train_nerf.main([*flags, "--steps", "14", "--eval-every", "100", "--resume",
                           "--stratified"])
    assert len(out["losses"]) == 2 and np.all(np.isfinite(out["losses"]))
    assert CheckpointManager(str(tmp_path / "ck")).latest_step() == 14


def test_train_nerf_converges_psnr(tmp_path, monkeypatch):
    """The JAX driver's convergence guard (test_train.py), same config and
    thresholds: eval PSNR must rise well above its start in 301 steps."""
    from lomanerf_tpu_torch.train import train_nerf

    monkeypatch.chdir(tmp_path)
    train_nerf.main([
        "--device", "cpu", "--data", "synthetic", "--img-size", "16", "--steps", "301",
        "--rays-per-batch", "256", "--samples", "8", "--width", "16",
        "--lr", "5e-3", "--eval-every", "100",
        "--log-dir", str(tmp_path / "logs_3d"),
        "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "0",
    ])
    rows = [json.loads(line) for line in open(tmp_path / "logs_3d" / "metrics.jsonl")]
    psnrs = [r["psnr"] for r in rows if "psnr" in r]
    assert psnrs[0] < 13.0, "starting PSNR unexpectedly high"
    assert max(psnrs) > 15.0, f"did not converge: {psnrs}"
    assert max(psnrs) > psnrs[0] + 4.0, f"insufficient improvement: {psnrs}"


def test_train_nerf_refuses_missing_card_and_unported_flags():
    from lomanerf_tpu_torch.train import train_nerf

    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            train_nerf.main(["--steps", "1"])
    # --pipeline native|numpy is ported (test_torch_native.py); an unknown
    # producer is refused
    for flag in (["--tp", "2"], ["--pipeline", "jax"], ["--coordinator", "h:1"]):
        with pytest.raises(SystemExit):
            train_nerf.main(["--device", "cpu", *flag])

