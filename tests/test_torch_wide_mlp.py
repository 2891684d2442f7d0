"""The bf16 wide render's fused MLP (``ops/wide_mlp``: the kernel of
``csrc/nerf_wide_mlp.cuh`` alone, and the layer chain it replaced)
against the JAX package and against numpy, on the CPU.

On CPU tensors ``wide_mlp.wide_mlp`` and ``wide_mlp.render_rays_layers`` run
their plain versions; they and the port's ``render_rays`` are held to the
JAX package's W kernel (``_nerf_forward_kernel_W``, shared ``(S,)`` depths)
and packed kernel (``_nerf_forward_kernel``, per-ray ``(N, S)`` depths) in
interpret mode, within ``tests/test_torch_wide.py``'s bf16 bounds.  The
kernel's order (128-row tiles, one f32 sum a layer over 16-deep k-steps in
ascending k, then bias, ReLU and the bf16 round) is restated in numpy and
held to f64 and to ``test_torch_wide.forward_sequence``; the card tests
(``tests/test_torch_cuda.py``) hold the kernel to the layer chain bit for
bit off near ties (``wide_mlp.tied_rows``, whose plain path is checked
here).  The card scripts' CPU parts are checked here: the plain
continuation of ``scripts/bf16_flips`` and the source edits of
``scripts/mlp_variants``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_wide import BF16_COL_ATOL, batch, bf16_round, forward_sequence, nerf_init_params

from lomanerf_tpu import core as jcore
from lomanerf_tpu.models import NeRFConfig as JConfig
from lomanerf_tpu.ops import fused_nerf as j_fused
from lomanerf_tpu_torch import core as tcore
from lomanerf_tpu_torch.models import NeRFConfig
from lomanerf_tpu_torch.ops import fused_nerf, wide_mlp

N = 37  # 37 x 8 and 37 x 12 rows: a ragged last 128-row tile
MLPS = [(3, 128, 8), (4, 256, 12)]  # (layers, width, S): pw 128 and 256
TILE, K_STEP = 128, 16  # the kernel's rows per tile and wgmma k-step depth
ORDER_RTOL = 1e-6  # of the f64 sum of |products|: f32 sums of exact products
# share of rows with a near-tie in some layer: worst measured 2.0% (9 of 444
# rows) over numpy seeds 215 and 0-5 of the four cases below; 2.5x that
NEAR_TIE_ROWS = 0.05


def case(rng, layers, width, S, depths):
    """(cfg, jcfg, params, numpy (o, d, t, dists)) of a bf16 wide MLP
    (init="nerf"-style params, standard mode) on N rays, at shared (S,) or
    per-ray jittered (N, S) depths."""
    kw = dict(num_layers=layers, filter_size=width, num_samples=S, mode="standard",
              compute_dtype="bfloat16", precision="default", init="nerf")
    ws, bs = nerf_init_params(rng, tcore.mlp_layer_sizes(33, 4, layers, width))
    o, d, t, dists, _ = batch(rng, N, S)
    if depths == "perray":
        _, t_rays, d_rays = tcore.sample_along_rays(
            torch.zeros(N, 3), torch.zeros(N, 3), 2.0, 6.0, S,
            generator=torch.Generator().manual_seed(layers))
        t, dists = t_rays.numpy(), d_rays.numpy()
    return NeRFConfig(**kw), JConfig(**kw), (ws, bs), (o, d, t, dists)


def stacks(params, cfg):
    kind, pw = fused_nerf._route(cfg, params)
    assert kind == "wide" and pw == (128 if cfg.filter_size <= 128 else 256)
    return fused_nerf.pack_wide_params(params, pw, cfg.compute_dtype)


@pytest.mark.parametrize("depths", ["shared", "perray"])
@pytest.mark.parametrize("layers,width,S", MLPS)
def test_render_matches_jax_kernels(rng, layers, width, S, depths):
    """Through the wrapper's plain path (``render_rays_layers`` on CPU tensors)
    and the port's ``render_rays``, the colours of the JAX W kernel (shared
    depths) or packed kernel (per-ray depths) in interpret mode."""
    cfg, jcfg, (ws, bs), arrays = case(rng, layers, width, S, depths)
    want = np.asarray(j_fused.render_rays(jcore.params_from_numpy(ws, bs),
                                          *[jnp.asarray(x) for x in arrays], jcfg))
    params = tcore.params_from_numpy(ws, bs, "cpu")
    o, d, t, dists = (torch.from_numpy(x) for x in arrays)
    W, b = stacks(params, cfg)
    with torch.no_grad():
        got = wide_mlp.render_rays_layers(W, b, t, dists, o, d, cfg).numpy()
        port = fused_nerf.render_rays(params, o, d, t, dists, cfg).numpy()
    assert got.shape == want.shape == (N, 3)
    assert np.abs(got - want).max() <= BF16_COL_ATOL
    assert np.abs(port - want).max() <= BF16_COL_ATOL


def fused_order(W, b, enc, n_k0):
    """numpy restatement of ``mlp_wgmma_kernel``'s order over the stacks
    (f64 arrays of bf16 values) from the bf16 encoding ``enc`` (rows, kc):
    rows padded with zeros to whole 128-row tiles, layer 0's columns and
    W_0's rows with zeros to ``n_k0`` 16-deep k-steps; per hidden layer one
    f32 sum of the k-steps in ascending k, each k-step's exact sum added to
    it with one rounding (the tensor core's accumulator: one wgmma a
    k-step, scale-d 0 on the first), then ``bf16(ReLU(f32(acc + b)))``.
    Returns the stored activations and, per layer, (pre-activation, exact
    f64 sum, sum of |products|), cut to the rows of ``enc``."""
    rows, L, pw = enc.shape[0], W.shape[0], W.shape[1]
    A = np.zeros((-(-rows // TILE) * TILE, n_k0 * K_STEP))
    A[:rows, :enc.shape[1]] = enc
    H, sums = [A[:rows]], []
    for l in range(L - 1):
        Wl = W[l, :A.shape[1]]
        acc = np.zeros((A.shape[0], pw), np.float32)
        for k0 in range(0, A.shape[1], K_STEP):
            part = A[:, k0:k0 + K_STEP] @ Wl[k0:k0 + K_STEP]
            acc = (acc + part).astype(np.float32)  # exact f64 sum, one round to f32
        sums.append((acc[:rows], A[:rows] @ Wl, np.abs(A[:rows]) @ np.abs(Wl)))
        A = bf16_round(np.maximum(acc + b[l].astype(np.float32), np.float32(0.0)))
        H.append(A[:rows])
    return H, sums


@pytest.mark.parametrize("depths", ["shared", "perray"])
@pytest.mark.parametrize("layers,width,S", MLPS)
def test_fused_order_matches_f64_and_the_sequence(rng, layers, width, S, depths):
    """The kernel's order, restated in numpy, gives each hidden
    pre-activation within 1e-6 of the f64 sum of |products|, and the same
    H_{L-1} as ``forward_sequence`` (exact f64 sums) from the same encoding
    on every row where no layer met a near-tie; the wrapper's plain path
    gives the same H_{L-1} as the port's plain render stores."""
    cfg, _, (ws, bs), (o, d, t, dists) = case(rng, layers, width, S, depths)
    params = tcore.params_from_numpy(ws, bs, "cpu")
    W, b = stacks(params, cfg)
    W64, b64 = W.double().numpy(), b.double().numpy()
    t_rays = np.broadcast_to(t, (N, S))
    p = (o[:, None, :].astype(np.float64) + d[:, None, :] * t_rays[:, :, None]).reshape(N * S, 3)
    kc, nf = fused_nerf._round_up(cfg.in_channels, 8), cfg.num_encoding_functions
    want = forward_sequence(W64, b64, p, kc, nf, bf16_round)
    got, sums = fused_order(W64, b64, want[0][:, :kc], -(-kc // K_STEP))
    # per layer, from the same stored input: the pre-activation within the
    # bound, and the stored output that forward_sequence's formula gives
    # except where an exact sum lies within the bound of a bf16 rounding
    # boundary (a near-tie: the two then store adjacent bf16 values, and
    # the row's later layers may part)
    tied = np.zeros(N * S, bool)
    for l, (pre, exact, scale) in enumerate(sums):
        bound = ORDER_RTOL * scale + 1e-30
        assert np.all(np.abs(pre - exact) <= bound), l
        ref = bf16_round(np.maximum(exact + b64[l], 0.0))
        top = np.maximum(np.abs(got[l + 1]), np.abs(ref))
        ulp = np.exp2(np.floor(np.log2(np.where(top > 0, top, 1.0))) - 7)
        apart = got[l + 1] != ref
        assert np.all(np.abs(got[l + 1] - ref)[apart] <= np.maximum(ulp, bound)[apart]), l
        tied |= apart.any(1)
    assert tied.mean() <= NEAR_TIE_ROWS, tied.mean()
    np.testing.assert_array_equal(got[-1][~tied], want[-1][~tied])

    ot, dt, tt = (torch.from_numpy(x) for x in (o, d, t))
    hidden = wide_mlp.wide_mlp(W, b, tt, ot, dt, cfg)
    _, saved = fused_nerf._wide_plain_forward(params["w"], params["b"], ot, dt, tt,
                                              torch.from_numpy(dists), cfg)
    assert hidden.shape == (N * S, W.shape[1]) and hidden.dtype == torch.bfloat16
    assert torch.equal(hidden[:, :width], saved[layers - 1])
    assert not hidden[:, width:].any()  # the padded columns stay inert


@pytest.mark.parametrize("depths", ["shared", "perray"])
@pytest.mark.parametrize("layers,width,S", MLPS)
def test_cpu_path_equals_render_rays_reference(rng, layers, width, S, depths):
    """On CPU tensors ``render_rays_layers`` computes what the port's plain
    render computes from the params, bit for bit."""
    cfg, _, (ws, bs), arrays = case(rng, layers, width, S, depths)
    params = tcore.params_from_numpy(ws, bs, "cpu")
    o, d, t, dists = (torch.from_numpy(x) for x in arrays)
    W, b = stacks(params, cfg)
    with torch.no_grad():
        got = wide_mlp.render_rays_layers(W, b, t, dists, o, d, cfg)
        want = fused_nerf.render_rays_reference(params, o, d, t, dists, cfg)
    assert torch.equal(got, want)


@pytest.mark.parametrize("depths", ["shared", "perray"])
@pytest.mark.parametrize("layers,width,S", MLPS)
def test_tied_rows_on_the_plain_path(rng, layers, width, S, depths):
    """On CPU tensors ``wide_mlp.tied_rows`` runs both sides' plain
    versions, which store the same values: no row tied, no value far, and
    both H_{L-1} the plain render's; ``render_rays_layers(hidden=True)``
    returns the plain colours beside that H_{L-1}."""
    cfg, _, (ws, bs), arrays = case(rng, layers, width, S, depths)
    params = tcore.params_from_numpy(ws, bs, "cpu")
    o, d, t, dists = (torch.from_numpy(x) for x in arrays)
    W, b = stacks(params, cfg)
    with torch.no_grad():
        tied, far, fused, chain = wide_mlp.tied_rows(W, b, t, dists, o, d, cfg)
        col, hidden = wide_mlp.render_rays_layers(W, b, t, dists, o, d, cfg, hidden=True)
        want = fused_nerf.render_rays_reference(params, o, d, t, dists, cfg)
    assert tied.shape == (N * S,) and not tied.any() and far == 0
    assert torch.equal(fused, chain) and torch.equal(hidden, chain)
    assert torch.equal(chain, wide_mlp.wide_mlp(W, b, t, o, d, cfg))
    assert torch.equal(col, want)


def test_wide_mlp_refuses_what_it_does_not_take(rng):
    """Shapes and types are checked before the device is looked at: pw
    outside {128, 256}, non-bf16 weights or config, and mismatched biases,
    rays or depths raise ValueError here too."""
    cfg, _, (ws, bs), arrays = case(rng, 3, 128, 8, "shared")
    W, b = stacks(tcore.params_from_numpy(ws, bs, "cpu"), cfg)
    o, d, t, dists = (torch.from_numpy(x) for x in arrays)
    f32 = NeRFConfig(num_layers=3, filter_size=128, num_samples=8)
    pad = torch.zeros((3, 384, 384), dtype=torch.bfloat16)
    bad = [
        (torch.zeros((3, 64, 64), dtype=torch.bfloat16), b[:, :64], t, dists, o, d, cfg),
        (pad, torch.zeros((3, 384)), t, dists, o, d, cfg),
        (W.float(), b, t, dists, o, d, cfg),
        (W, b, t, dists, o, d, f32),
        (W[:1], b[:1], t, dists, o, d, cfg),
        (W, b.double(), t, dists, o, d, cfg),
        (W, b[:, :64].contiguous(), t, dists, o, d, cfg),
        (W, b, t[:5], dists[:5], o, d, cfg),
        (W, b, t, dists[None].expand(N, -1), o, d, cfg),
        (W, b, t, dists, o[:5], d, cfg),
        (W, b, t, dists, o[:0], d[:0], cfg),
    ]
    for W_, b_, t_, dists_, o_, d_, cfg_ in bad:
        with pytest.raises(ValueError):
            wide_mlp.render_rays_layers(W_, b_, t_, dists_, o_, d_, cfg_)
        if dists_ is dists:
            with pytest.raises(ValueError):
                wide_mlp.wide_mlp(W_, b_, t_, o_, d_, cfg_)


@pytest.mark.parametrize("mode", ["standard", "loma"])
@pytest.mark.parametrize("layers,width,S", MLPS)
def test_flip_bisection_continues_as_the_plain_version(rng, layers, width, S, mode):
    """``scripts/bf16_flips.continued`` (the plain version's later layers,
    head and compositing from a ray's stored layer output) gives, from the
    plain version's own output of every hidden layer, the plain colours of
    the ray, so that a colour error left by it comes from the kernel's
    values alone."""
    from lomanerf_tpu_torch.scripts import bf16_flips

    cfg, _, (ws, bs), arrays = case(rng, layers, width, S, "perray")
    cfg = dataclasses.replace(cfg, mode=mode)
    W, b = stacks(tcore.params_from_numpy(ws, bs, "cpu"), cfg)
    o, d, t, dists = (torch.from_numpy(x) for x in arrays)
    with torch.no_grad():
        col, saved = wide_mlp._plain(W, b, t, dists, o, d, cfg, keep=True)
        for ray in (0, N - 1):
            for m in range(W.shape[0] - 1):
                got = bf16_flips.continued(saved[m + 1][ray * S:(ray + 1) * S], m + 1, W, b,
                                           dists[ray], mode)
                torch.testing.assert_close(got, col[ray], atol=1e-6, rtol=1e-6)


def test_mlp_variants_edit_the_current_source():
    """Every variant of ``scripts/mlp_variants`` applies to the fused MLP's
    source as it stands (each edit matches as often as it names), the first
    is the source unchanged, and each changes what it names; the script and
    ``bf16_flips`` refuse to run without a card."""
    from lomanerf_tpu_torch.scripts import bf16_flips, mlp_variants

    sources = {name: mlp_variants.patched(edits)
               for name, (edits, _) in mlp_variants.VARIANTS.items()}
    assert sources.pop("as is") == mlp_variants.HEADER.read_text()
    assert len(set(sources.values())) == len(sources)
    assert all(src != mlp_variants.HEADER.read_text() for src in sources.values())
    with pytest.raises(SystemExit):
        mlp_variants.patched([("no such line", "", 1)])
    if not torch.cuda.is_available():
        for main in (mlp_variants.main, lambda: bf16_flips.main([])):
            with pytest.raises(SystemExit):
                main()
