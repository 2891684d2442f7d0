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


def kernel_walk(pk, origins, directions, S, L, in_dim, nf, W, loma, depths=None):
    """numpy re-statement of nerf_render_fwd.cu's per-ray loop, reading the
    packed buffer with the kernel's own offsets (f64 arithmetic): the
    shared depths from its tail, or, with ``depths = (t, dists)`` (N, S),
    row r for ray r (nerf_render_fwd_rays: the buffer then ends with the
    weights).  A ray's samples go in the kernel's groups
    (``fused_nerf.sample_groups``): every slot's MLP runs, the pad slots of
    the last group on sample S-1, and only the real ones are composited."""
    pk = pk.astype(np.float64)
    l0_cols = 4 if L == 1 else W
    w_first = 0
    w_hidden = w_first + in_dim * l0_cols + l0_cols
    w_head = w_hidden + (L - 2) * (W * W + W) if L >= 2 else 0
    ts = w_hidden if L == 1 else w_head + W * 4 + 4
    if depths is None:
        t_rays = np.broadcast_to(pk[ts:ts + S], (origins.shape[0], S))
        d_rays = np.broadcast_to(pk[ts + S:ts + 2 * S], (origins.shape[0], S))
    else:
        assert pk.size == -(-ts // 4) * 4  # no depth tail
        t_rays, d_rays = depths

    def layer(x, off, rows, cols):
        w = pk[off:off + rows * cols].reshape(rows, cols)
        return x @ w + pk[off + rows * cols:off + rows * cols + cols]

    def mlp(p):
        enc = [p]
        for i in range(nf):
            enc += [np.sin(2.0**i * p), np.cos(2.0**i * p)]
        z = layer(np.concatenate(enc), w_first, in_dim, l0_cols)
        if L >= 2:
            h = np.maximum(z, 0.0)
            for l in range(1, L - 1):
                h = np.maximum(layer(h, w_hidden + (l - 1) * (W * W + W), W, W), 0.0)
            z = layer(h, w_head, W, 4)
        return z

    out = np.zeros((origins.shape[0], 3))
    for r in range(origins.shape[0]):
        t, dist = t_rays[r], d_rays[r]
        P, acc = 1.0, np.zeros(3)
        for slots, real in fused_nerf.sample_groups(S, fused_nerf.RENDER_GROUP):
            rgba = [mlp(origins[r] + directions[r] * t[s]) for s in slots]
            for s, z in zip(slots[:real], rgba):
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


def jittered_depths(seed, n, S, near=2.0, far=6.0):
    """Per-bin stratified (N, S) depths and steps, as NeRFModel.sample draws
    them (core.rays.sample_along_rays with a torch.Generator)."""
    from lomanerf_tpu_torch.core import sample_along_rays

    o = torch.zeros(n, 3)
    _, t, dists = sample_along_rays(o, o, near, far, S,
                                    generator=torch.Generator().manual_seed(seed))
    assert t.shape == dists.shape == (n, S)
    return t, dists


@pytest.mark.parametrize("depths", ["shared", "perray"])
@pytest.mark.parametrize("layers,width,mode", [
    (3, 30, "loma"),       # small: W = 32
    (4, 64, "standard"),   # single64: W = 64
    (1, 30, "loma"),       # one layer: layer 0 is the head
    (2, 17, "standard"),   # no hidden-to-hidden layer
])
def test_packed_layout_matches_plain_render(rng, layers, width, mode, depths):
    """The render kernel's walk over the packed buffer equals the plain
    render: shared (S,) depths from the buffer's tail (nerf_render_fwd), or
    jittered per-ray (N, S) depths beside it (nerf_render_fwd_rays)."""
    S, n = 7, 9
    cfg = NeRFConfig(num_layers=layers, filter_size=width, num_samples=S, mode=mode)
    ws, bs = np_params(rng, mlp_layer_sizes(33, 5, layers, width))  # 5 ch: extra ignored
    params = params_from_numpy(ws, bs, "cpu")
    if depths == "shared":
        t, dists = uniform_depths(2.0, 6.0, S, "cpu")
    else:
        t, dists = jittered_depths(layers, n, S)
    W = fused_nerf._route(cfg, params)[1]
    assert W == (32 if width <= 32 else 64)
    pk = fused_nerf.pack_params(params, t, dists, W)
    assert pk.dtype == torch.float32 and pk.numel() % 4 == 0
    o, d = rays(rng, n)
    got = kernel_walk(pk.numpy(), o.astype(np.float64), d.astype(np.float64), S,
                      layers, 33, 5, W, mode == "loma",
                      None if depths == "shared" else (t.double().numpy(),
                                                       dists.double().numpy()))
    want = fused_nerf.render_rays_reference(params, torch.from_numpy(o),
                                            torch.from_numpy(d), t, dists, cfg)
    np.testing.assert_allclose(got, want.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("S", [1, 30, 64, 7])
@pytest.mark.parametrize("group", [1, 2, 4])
def test_sample_groups_match_a_direct_restatement(S, group):
    """The render forward's walk over a ray's samples (nerf_render_fwd.cu):
    groups of ``group`` slots from every multiple of ``group``, the last
    one's pad slots on sample S-1; the real slots take each sample once, in
    order.  The kernel runs groups of 2 (an odd S ends in one real slot)."""
    n_groups = -(-S // group)
    slots = np.minimum(np.arange(n_groups * group).reshape(n_groups, group), S - 1)
    real = np.minimum(group, S - group * np.arange(n_groups))
    got = fused_nerf.sample_groups(S, group)
    assert [g[0] for g in got] == slots.tolist()
    assert [g[1] for g in got] == real.tolist()
    assert [s for sl, n in got for s in sl[:n]] == list(range(S))
    assert fused_nerf.RENDER_GROUP == 2


@pytest.mark.parametrize("S", [1, 30, 64])
@pytest.mark.parametrize("width", [32, 64])
@pytest.mark.parametrize("per_ray", [False, True])
def test_render_smem_bytes_match_a_direct_restatement(S, width, per_ray):
    """A render block's shared memory (nerf_render_fwd.cu:render_smem_floats):
    the packed params, 128 threads' activation stage of 2 x W floats, and
    for per-ray depths the block's t and dist rows at an odd stride."""
    pk_floats = 2468
    stride = S + 1 if S % 2 == 0 else S
    want = 4 * (pk_floats + 128 * 2 * width + (2 * 128 * stride if per_ray else 0))
    assert fused_nerf.render_smem_bytes(pk_floats, S, width, per_ray) == want
    assert fused_nerf.RENDER_THREADS == 128


def test_render_block_past_shared_memory_routes_wide(rng):
    """The narrow route also needs the render's block to fit: a 2-layer
    W = 32 MLP at S = 256 fits the gradient kernels' block but its render
    block (256 rows of staged per-ray depths a thread pair) does not, so it
    goes wide at pw = 128; the presets stay narrow."""
    params = params_from_numpy(*np_params(rng, mlp_layer_sizes(33, 4, 2, 32)), "cpu")
    cfg = NeRFConfig(num_layers=2, filter_size=32, num_samples=256)
    G = fused_nerf.grad_floats(params, 32)
    pk = G + 512
    assert fused_nerf.grad_smem_bytes(pk, G, 256, 2, 33, 32) <= 227 * 1024
    assert fused_nerf.render_smem_bytes(pk, 256, 32, per_ray=True) > 227 * 1024
    assert fused_nerf._plan(cfg, params) == ("wide", 128)
    for preset, W in (("small", 32), ("single64", 64)):
        c = NeRFConfig.preset(preset)
        p = params_from_numpy(*np_params(rng, mlp_layer_sizes(33, 4, c.num_layers,
                                                              c.filter_size)), "cpu")
        assert fused_nerf._plan(c, p) == ("narrow", W)


def test_kernel_refuses_what_it_does_not_take(rng):
    """The JAX dispatch rule routes each MLP to the narrow kernels (every
    width padded to 8 at most 64) or the wide ones (hidden widths up to 256,
    f32 or bf16); the cases no CUDA kernel takes raise, naming the ROADMAP
    item.  Depths of either shape pass the input check; mismatched shapes
    or ray counts raise ValueError."""
    small = NeRFConfig.small()
    ws, bs = np_params(rng, mlp_layer_sizes(33, 4, 3, 30))
    params = params_from_numpy(ws, bs, "cpu")
    assert fused_nerf._route(small, params) == ("narrow", 32)
    with pytest.raises(NotImplementedError, match="A4"):  # narrow bf16
        fused_nerf._route(dataclasses.replace(small, compute_dtype="bfloat16"), params)
    for width, pw in ((65, 128), (128, 128), (160, 256), (256, 256)):
        wide = params_from_numpy(*np_params(rng, mlp_layer_sizes(33, 4, 3, width)), "cpu")
        for cdt in ("float32", "bfloat16"):
            cfg = dataclasses.replace(small, filter_size=width, compute_dtype=cdt)
            assert fused_nerf._route(cfg, wide) == ("wide", pw)
    too_wide = params_from_numpy(*np_params(rng, mlp_layer_sizes(33, 4, 3, 257)), "cpu")
    with pytest.raises(NotImplementedError, match="C4"):
        fused_nerf._route(small, too_wide)
    with pytest.raises(ValueError):  # the n=4 encoding gives 27 inputs, not 33
        fused_nerf._route(dataclasses.replace(small, num_encoding_functions=4), params)
    # depths: both (S,) or both per-ray (N, S) pass; any other pair raises
    o, t = torch.zeros(4, 3), torch.linspace(2.0, 6.0, 30)
    t2 = t.expand(4, -1)
    fused_nerf._check_cuda_inputs(o, o, t, t, small, params, o)
    fused_nerf._check_cuda_inputs(o, o, t2, t2, small, params, o)
    for bad_t, bad_d in ((t2, t), (t, t2), (t.expand(5, -1), t.expand(5, -1)),
                         (t[:8], t[:8]), (t2[:, :8], t2[:, :8]), (t2[None], t2[None])):
        with pytest.raises(ValueError):
            fused_nerf._check_cuda_inputs(o, o, bad_t, bad_d, small, params)
    with pytest.raises(ValueError):  # targets of another ray count
        fused_nerf._check_cuda_inputs(o, o, t, t, small, params, torch.zeros(5, 3))


def test_render_variants_edit_the_current_source():
    """Every variant of ``scripts/render_variants`` applies to the render's
    sources as they stand ("as is" is them unchanged, every other variant
    changes them), an edit that no longer matches is refused, and the script
    and ``card_probe --what render`` refuse to run without a card."""
    from lomanerf_tpu_torch.ops import build
    from lomanerf_tpu_torch.scripts import card_probe, render_variants

    srcs = render_variants.patched(render_variants.VARIANTS, render_variants.FILES)
    now = {f: (build.CSRC / f).read_text() for f in render_variants.FILES}
    now["render_entry.cuh"] = now.pop("nerf_render_fwd.cu")
    assert srcs.pop("as is") == now
    assert all(texts != now for texts in srcs.values())
    with pytest.raises(SystemExit, match="out of date"):
        render_variants.patched({"x": ([("nerf_render_mlp.cuh", "no such line", "", 1)],
                                       False)}, render_variants.FILES)
    if not torch.cuda.is_available():
        for main in (lambda: render_variants.main([]),
                     lambda: card_probe.main(["--what", "render", "--parent", "x"])):
            with pytest.raises(SystemExit):
                main()
