"""Image fields past the tile kernels (D2) against the JAX package, on the
CPU: widths above 128, more layers than a 32-pixel tile holds, heads of up
to 128 channels and coordinates of any dimension, which the port runs on
``csrc/field_wide.cu`` on the card.

Same numpy-seeded params and coords through both packages.  On CPU tensors
the port's ``field_forward`` runs its plain version
(``fused_mlp.field_forward_reference``: the core encoding, sin and cos of
``2^i x``, and sigmoid MLP, as the kernel computes them); it is held to the
JAX fused field (``fused_mlp._fwd_kernel`` / ``_bwd_kernel`` in
interpret mode, ``highest_precision=True``) at the JAX test's bounds
(``test_fused_field_forward_and_grads``: forward rtol 2e-4 / atol 1e-5,
grads rtol 3e-4 / atol 3e-5).  The kernel's launch sequence (the encoding,
one GEMM a layer, the head's d_z, split-K dW partials and column sums added
in a fixed order, pixel chunks) is restated in f64 numpy over the packed
stacks, and in f32 with the "high" tier's 3xTF32 products
(``field_wide_gemm.cuh``, the tile kernels' split arithmetic:
``test_torch_field.mma_products``) against the JAX field and f64.
``chip_smoke.py`` phase 25 holds the kernels themselves.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lomanerf_tpu import core as jcore
from lomanerf_tpu.ops import fused_mlp as j_fused
from lomanerf_tpu_torch import core as tcore
from lomanerf_tpu_torch.models import ImageFieldConfig, ImageFieldModel
from lomanerf_tpu_torch.ops import fused_mlp
from lomanerf_tpu_torch.scripts import card_probe

from test_torch_field import mma_products

FWD_RTOL, FWD_ATOL, GRAD_RTOL, GRAD_ATOL = 2e-4, 1e-5, 3e-4, 3e-5
# (layers, width, octaves, coordinate dimension, output channels): the
# Fourier-feature image network (4x256, n = 8), 8x128 (past a tile's shared
# memory), a 3D field with a 16-channel head, a one-layer 3D field
SHAPES = {"4x256": (4, 256, 8, 2, 3), "8x128": (8, 128, 8, 2, 3),
          "3d 16ch": (3, 64, 5, 3, 16), "1 layer 3d": (1, 0, 4, 3, 7)}


def np_params(rng, layers, width, nf, D, out):
    sizes = tcore.mlp_layer_sizes(D * (1 + 2 * nf), out, layers, width)
    ws = [(rng.standard_normal(s) * np.sqrt(2.0 / s[0])).astype(np.float32) for s in sizes]
    bs = [(rng.standard_normal(s[1]) * 0.5).astype(np.float32) for s in sizes]
    return ws, bs


def leaves(params):
    return [p.requires_grad_(True) for p in [*params["w"], *params["b"]]]


@pytest.mark.parametrize("shape", list(SHAPES))
def test_wide_field_matches_jax_kernel(rng, shape):
    """The port's field_forward (CPU: the wide route's plain version) vs the
    JAX fused field in interpret mode: outputs and the grads of the
    sum-MSE, on 70 points (not a tile multiple); no coords gradient."""
    layers, width, nf, D, out = SHAPES[shape]
    ws, bs = np_params(rng, layers, width, nf, D, out)
    n = 70
    coords = rng.random((n, D)).astype(np.float32)
    target = rng.random((n, out)).astype(np.float32)
    params = tcore.params_from_numpy(ws, bs, "cpu")
    assert fused_mlp.kernel_width(params, D, nf, out) is None  # the wide route

    def j_kernel(p):
        return j_fused.field_forward(p, jnp.asarray(coords), nf, out, rows_tile=32,
                                     highest_precision=True)

    jp = jcore.params_from_numpy(ws, bs)
    k_out = j_kernel(jp)
    k_grads = jax.grad(lambda p: jcore.sum_mse(j_kernel(p), jnp.asarray(target)))(jp)
    lv = leaves(params)
    t_coords = torch.from_numpy(coords).requires_grad_(True)
    got = fused_mlp.field_forward(params, t_coords, nf, out)
    assert got.shape == (n, out)
    loss = tcore.sum_mse(got, torch.from_numpy(target))
    grads = torch.autograd.grad(loss, lv, retain_graph=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(k_out), rtol=FWD_RTOL,
                               atol=FWD_ATOL)
    for g, w in zip(grads, [*k_grads["w"], *k_grads["b"]]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=GRAD_RTOL, atol=GRAD_ATOL)
    assert torch.autograd.grad(loss, [t_coords], allow_unused=True) == (None,)


def encode_lanes(x, nf):
    """numpy restatement of ``field_wide.cu:encode_kernel`` (f64 of the
    f32 coords): thread (row, b, k) for b <= nf writes the identity lane
    k (b = 0), or sin and cos of 2^(b-1) x_k at lanes (2b - 1) D + k and
    2b D + k.  Returns the encoding and how often each lane was written."""
    n, D = x.shape
    enc, hits = np.zeros((n, D * (1 + 2 * nf))), np.zeros(D * (1 + 2 * nf), int)
    for b in range(nf + 1):
        for k in range(D):
            xk = x[:, k].astype(np.float64)
            if b == 0:
                enc[:, k] = xk
                hits[k] += 1
                continue
            s = 2.0 ** (b - 1) * xk
            enc[:, (2 * b - 1) * D + k], enc[:, 2 * b * D + k] = np.sin(s), np.cos(s)
            hits[[(2 * b - 1) * D + k, 2 * b * D + k]] += 1
    return enc, hits


@pytest.mark.parametrize("D,nf", [(2, 8), (3, 5), (1, 0)])
def test_encode_lanes_are_the_core_encoding(D, nf):
    """The kernel's encode threads write every lane of the encoded width
    once, in the reference's block layout: their values equal the port's
    ``positional_encoding`` (the plain version's) and the JAX core's
    within f32 rounding of sin and cos."""
    x = np.random.default_rng(D).random((33, D)).astype(np.float32)
    got, hits = encode_lanes(x, nf)
    assert (hits == 1).all()
    want = tcore.positional_encoding(torch.from_numpy(x), nf)
    assert want.dtype == torch.float32 and want.shape == got.shape
    np.testing.assert_allclose(want.numpy(), got, rtol=0, atol=2e-7)
    np.testing.assert_allclose(np.asarray(jcore.positional_encoding(jnp.asarray(x), nf)),
                               got, rtol=0, atol=2e-7)


def column_sums(z, row_chunk):
    """``field_wide_gemm.cuh:column_sums`` in ``z``'s dtype (the order of
    ``nerf_wide_gemm.cuh``'s): per chunk of ``row_chunk`` rows, lane q < 8
    sums rows q, q + 8, ... in order, the eight lane sums added in order;
    the chunks' sums added in order."""
    total = np.zeros(z.shape[1], z.dtype)
    for r0 in range(0, z.shape[0], row_chunk):
        blk = z[r0:r0 + row_chunk]
        lanes = []
        for q in range(8):
            s = np.zeros(z.shape[1], z.dtype)
            for r in range(q, blk.shape[0], 8):
                s = s + blk[r]
            lanes.append(s)
        part = np.zeros(z.shape[1], z.dtype)
        for s in lanes:
            part = part + s
        total = total + part
    return total


def kernel_sequence(W, b, nf, coords, dout, L, enc, hidden, out_ch, chunk, row_chunk,
                    passes=None):
    """numpy restatement of ``field_wide_bwd`` over the packed stacks, in
    f64 (``passes`` None) or in f32 with the "high" tier's products
    (``passes`` 3: ``mma_products``, the tile kernels' 3xTF32 split, the
    head's too; 1: one TF32 pass).  Per chunk of ``chunk`` pixels: the
    encoding (:func:`encode_lanes`, rounded to the dtype), each hidden layer
    ReLU(h W_l + b_l) on its real columns, the head's sigmoid and d_z =
    dout * y * (1 - y) on ``out_ch`` columns; then in reverse each layer's
    dW as split-K partials of ``row_chunk`` rows (their k-steps from each
    partial's first row) added in order, db by :func:`column_sums`, and d_h
    = d_z W_l^T masked by h_l > 0.  Returns (out, dW, db)."""
    dt = np.float64 if passes is None else np.float32
    W, b, dout = W.astype(dt), b.astype(dt), dout.astype(dt)
    one = dt(1)
    pw = W.shape[1]
    dW, db = np.zeros((L, pw, pw), dt), np.zeros((L, pw), dt)
    ins = [enc] + [hidden] * (L - 1)
    cols = [hidden] * (L - 1) + [out_ch]
    outs = []

    def prod(a, w):
        return a @ w if passes is None else mma_products(a, w, passes)
    for c0 in range(0, coords.shape[0], chunk):
        h = [encode_lanes(coords[c0:c0 + chunk].astype(np.float32), nf)[0].astype(dt)]
        for l in range(L - 1):
            h.append(np.maximum(prod(h[l], W[l, :ins[l], :cols[l]]) + b[l, :cols[l]], dt(0)))
        z = prod(h[-1], W[L - 1, :ins[-1], :out_ch]) + b[L - 1, :out_ch]
        y = one / (one + np.exp(-z))
        outs.append(y)
        g = dout[c0:c0 + chunk] * y * (one - y)
        for l in range(L - 1, -1, -1):
            s = np.zeros((ins[l], cols[l]), dt)
            for r0 in range(0, g.shape[0], row_chunk):
                s = s + prod(h[l][r0:r0 + row_chunk].T, g[r0:r0 + row_chunk])
            dW[l, :ins[l], :cols[l]] += s
            db[l, :cols[l]] += column_sums(g, row_chunk)
            if l >= 1:
                g = np.where(h[l] > 0, prod(g, W[l, :ins[l], :cols[l]].T), dt(0))
    return np.concatenate(outs), dW, db


@pytest.mark.parametrize("shape", ["8x128", "3d 16ch", "1 layer 3d"])
def test_kernel_sequence_matches_plain(rng, shape):
    """``field_wide.cu``'s sequence, restated in numpy over
    ``pack_field_wide``'s stacks (pw from ``field_wide_dims``) and unpacked
    by ``unpack_field_wide``, equals the plain version and its autograd:
    chunks of 9 pixels and split-K partials of 4 rows make every sum cross
    an edge; the head's columns past ``out_channels`` get zero gradient."""
    layers, width, nf, D, out = SHAPES[shape]
    ws, bs = np_params(rng, layers, width, nf, D, out + 2)  # a head wider than the output
    params = tcore.params_from_numpy(ws, bs, "cpu")
    enc, hidden, pw = fused_mlp.field_wide_dims(params, D, out)
    assert enc == D * (1 + 2 * nf) and hidden == width
    assert pw == -(-max(enc, hidden, out) // 4) * 4
    W, b = fused_mlp.pack_field_wide(params, pw, out)
    assert W.shape == (layers, pw, pw) and b.shape == (layers, pw)
    n = 23
    coords = rng.random((n, D)).astype(np.float32)
    dout = rng.standard_normal((n, out))
    got_out, dW, db = kernel_sequence(W.numpy(), b.numpy(), nf, coords,
                                      dout, layers, enc, hidden, out, 9, 4)
    lv = leaves(params)
    want_out = fused_mlp.field_forward(params, torch.from_numpy(coords), nf, out)
    want = torch.autograd.grad((want_out * torch.from_numpy(dout).float()).sum(), lv)
    np.testing.assert_allclose(got_out, want_out.detach().numpy(), rtol=FWD_RTOL, atol=FWD_ATOL)
    got = fused_mlp.unpack_field_wide(torch.from_numpy(dW), torch.from_numpy(db), params)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=GRAD_RTOL, atol=GRAD_ATOL)
    assert not got[layers - 1][:, out:].any() and not got[-1][out:].any()


@pytest.mark.parametrize("shape", ["4x256", "8x128", "3d 16ch"])
def test_3xtf32_route_meets_the_jax_field_and_f64(rng, shape):
    """The wide route's "high" tier (``field_wide.cu`` on
    ``field_wide_gemm.cuh``), restated in numpy on 240 points (chunks of
    100 pixels, split-K partials of 32 rows: the kernels' 8192 scaled
    down), meets the JAX fused field's test bounds (interpret mode,
    ``highest_precision=True``: forward rtol 2e-4 / atol 1e-5, grads rtol
    3e-4 / atol 3e-5) and the f64 field at ``chip_smoke.py`` phase 25's
    (outputs 1e-4 abs + 1e-4 rel, dW/db rtol 3e-4 and atol 3e-5 of max(1,
    the leaf's largest entry)); one TF32 pass lands at least 10x farther
    from f64 than three."""
    layers, width, nf, D, out = SHAPES[shape]
    ws, bs = np_params(rng, layers, width, nf, D, out)
    n = 240
    coords = rng.random((n, D)).astype(np.float32)
    dout = rng.standard_normal((n, out)).astype(np.float32)
    params = tcore.params_from_numpy(ws, bs, "cpu")
    enc, hidden, pw = fused_mlp.field_wide_dims(params, D, out)
    W, b = (x.numpy() for x in fused_mlp.pack_field_wide(params, pw, out))
    got_out, dW, db = kernel_sequence(W, b, nf, coords, dout, layers, enc, hidden, out, 100,
                                      32, passes=3)
    got = fused_mlp.unpack_field_wide(torch.from_numpy(dW), torch.from_numpy(db), params)

    k_out, vjp = jax.vjp(lambda p: j_fused.field_forward(p, jnp.asarray(coords), nf, out,
                                                         rows_tile=32,
                                                         highest_precision=True),
                         jcore.params_from_numpy(ws, bs))
    (k_grads,) = vjp(jnp.asarray(dout))
    np.testing.assert_allclose(got_out, np.asarray(k_out), rtol=FWD_RTOL, atol=FWD_ATOL)
    for g, w in zip(got, [*k_grads["w"], *k_grads["b"]]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=GRAD_RTOL, atol=GRAD_ATOL)

    p64 = tcore.params_from_numpy(ws, bs, "cpu", dtype=torch.float64)
    lv = leaves(p64)
    want_out = fused_mlp.field_forward_reference(p64, torch.from_numpy(coords).double(), nf,
                                                 out)
    want = torch.autograd.grad((want_out * torch.from_numpy(dout).double()).sum(), lv)
    want_out = want_out.detach().numpy()
    np.testing.assert_allclose(got_out, want_out, rtol=1e-4, atol=1e-4)
    for g, w in zip(got, want):
        w = w.numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=3e-4,
                                   atol=3e-5 * max(1.0, np.abs(w).max()))
    one_out = kernel_sequence(W, b, nf, coords, dout, layers, enc, hidden, out, 100, 32,
                              passes=1)[0]
    err3, err1 = np.abs(got_out - want_out).max(), np.abs(one_out - want_out).max()
    assert err1 > 10 * err3, (err1, err3)


@pytest.mark.parametrize("tier,exact", [("highest", 1), ("high", 0), ("default", 0)])
def test_model_tier_reaches_both_wide_launches(rng, monkeypatch, tier, exact):
    """``_FieldWide`` hands the model's precision tier, as ``field_forward``
    maps it (``exact_tier``), to the forward and the gradient launch of the
    wide route (the launchers stubbed with the plain version on CPU
    tensors), and the backward reads what a ``keep`` forward left."""
    calls = []
    cfg = ImageFieldConfig(num_layers=4, filter_size=256, num_encoding_functions=8,
                           precision=tier)
    ws, bs = np_params(rng, 4, 256, 8, 2, 3)
    model = ImageFieldModel.from_numpy(cfg, ws, bs, device="cpu")
    params = model.params
    coords = torch.from_numpy(rng.random((37, 2)).astype(np.float32))
    assert fused_mlp.kernel_width(params, 2, 8, 3) is None

    def fwd(W, b, c, nf, out_ch, dims, exact, keep=False):
        calls.append(("fwd", exact, keep))
        out = fused_mlp.field_forward_reference(params, c, nf, out_ch).detach()
        return out, (torch.zeros(1) if keep else None)

    def bwd(W, b, c, dout, nf, dims, exact, acts=None):
        calls.append(("bwd", exact, acts is not None))
        return torch.zeros(W.shape), torch.zeros(b.shape)
    monkeypatch.setattr(fused_mlp, "_launch_wide_fwd", fwd)
    monkeypatch.setattr(fused_mlp, "_launch_wide_bwd", bwd)
    lv = leaves(params)
    got = fused_mlp.exact_tier(model.config.precision)
    out = fused_mlp._FieldWide.apply(coords, 8, 3, got, True, *lv)
    out.sum().backward()
    with torch.no_grad():
        fused_mlp._FieldWide.apply(coords, 8, 3, got, False, *lv)
    assert got == exact
    assert calls == [("fwd", exact, True), ("bwd", exact, True), ("fwd", exact, False)]


@pytest.mark.parametrize("tier,exact", [("highest", 1), ("high", 0), ("default", 0)])
def test_field_forward_keeps_activations_only_for_a_gradient(rng, monkeypatch, tier, exact):
    """``field_forward`` itself (its route check stubbed to the card's, and
    ``_FieldWide`` recorded) hands the wide route its tier and ``keep``:
    ``keep`` only where grad is enabled and a param requires grad, so that
    inference under ``no_grad`` or with frozen params keeps no activations
    (1.07 GB at 4x256 on 512x512)."""
    seen = []
    ws, bs = np_params(rng, 4, 256, 8, 2, 3)
    params = tcore.params_from_numpy(ws, bs, "cpu")
    coords = torch.from_numpy(rng.random((37, 2)).astype(np.float32))

    def apply(c, nf, out_ch, ex, keep, *wb):
        seen.append((nf, out_ch, ex, keep, len(wb)))
        return torch.zeros((c.shape[0], out_ch))
    monkeypatch.setattr(fused_mlp, "_on_card", lambda c: True)
    monkeypatch.setattr(fused_mlp._FieldWide, "apply", apply)

    def run():
        fused_mlp.field_forward(params, coords, 8, 3, precision=tier)
    run()  # frozen params
    lv = leaves(params)
    with torch.no_grad():
        run()
    run()
    lv[-1].requires_grad_(False)
    run()  # one leaf still requires grad
    n = len(lv)
    assert seen == [(8, 3, exact, False, n)] * 2 + [(8, 3, exact, True, n)] * 2


def test_card_probe_labels_the_wide_route():
    """``card_probe --what field_wide`` names each kernel of a fit step by
    its place: the forward's encoding, layers and head; a recomputed
    forward between the head and its d_z; each layer's dW partials (counted
    down from the head), their sums, the column sums and ``d_h``; Adam."""
    def gemm(epi, kern="gemm3_kernel<4, 4, 2, 2, false, false, {}>"):
        return "void wide3::(anonymous namespace)::" + kern.format(epi) + "(float const*)"
    head = [gemm(3), "loss"]
    back = [gemm(4)]
    for l in (2, 1, 0):
        back += [gemm(2), "wide::sum_partials_kernel", "colsum_kernel", "sum_partials_kernel"]
        back += [gemm(1)] if l else []
    step = ["encode_kernel", gemm(0), gemm(0), *head, *back, "multi_tensor_apply_kernel<x>"]
    recompute = ["encode_kernel", gemm(0, "gemm_f32_kernel<128, 128, 8, 8, false, false, {}>"),
                 gemm(0), *head, "encode_kernel", gemm(0), gemm(0), *back]
    state = {}
    got = [card_probe.wide_field_label(n, "kernel", state) for n in step + recompute]
    assert got[:6] == ["fwd: encode", "fwd: layer 0", "fwd: layer 1", "fwd: head", "other",
                       "bwd: head d_z"]
    assert got[6:12] == ["bwd: dW layer 2", "bwd: dW partial sums", "bwd: db column sums",
                         "bwd: db column sums", "bwd: d_h layer 2", "bwd: dW layer 1"]
    assert got[step.index("multi_tensor_apply_kernel<x>")] == "Adam"
    assert got[len(step):len(step) + 9] == [
        "fwd: encode", "fwd: layer 0", "fwd: layer 1", "fwd: head", "other", "bwd: encode",
        "bwd: layer 0", "bwd: layer 1", "bwd: head d_z"]
    assert got[-4:] == ["bwd: dW layer 0", "bwd: dW partial sums", "bwd: db column sums",
                        "bwd: db column sums"]
    assert card_probe.wide_field_label("x", "gpu_memset", state) == "memset and copy"


def test_route_and_scratch():
    """The tile kernels keep every shape they took (2D coords, hidden width
    <= 128, a head of <= 4 channels, a tile within shared memory); the
    rest goes to the wide route (``kernel_width`` None); more than 128
    output channels is refused as the JAX field writes no more; a chunk's
    scratch stays within ``FIELD_WIDE_BYTES``."""
    rng = np.random.default_rng(0)

    def params(layers, width, nf=5, D=2, out=3):
        return tcore.params_from_numpy(*np_params(rng, layers, width, nf, D, out), "cpu")

    assert fused_mlp.kernel_width(params(3, 16), 2, 5, 3) == 16
    assert fused_mlp.kernel_width(params(5, 128, 8), 2, 8, 3) == 128
    for p, D, nf, out in ((params(4, 256, 8), 2, 8, 3), (params(3, 200), 2, 5, 3),
                          (params(8, 128, 8), 2, 8, 3), (params(3, 16, out=5), 2, 5, 5),
                          (params(3, 16, D=3), 3, 5, 3), (params(3, 16, 4, 1, 3), 1, 4, 3),
                          (params(2, 16, out=128), 2, 5, 128)):
        assert fused_mlp.kernel_width(p, D, nf, out) is None
    with pytest.raises(NotImplementedError, match="128 channels"):
        fused_mlp.kernel_width(params(2, 16, out=130), 2, 5, 129)
    assert fused_mlp.field_wide_chunk(4, 256) == fused_mlp.FIELD_WIDE_BYTES // (4 * 256 * 6)
    assert fused_mlp.field_wide_chunk(4, 256) >= 512 * 512


def test_fit_image_driver_runs_a_wide_field(tmp_path):
    """``fit_image --layers 4 --width 256 --enc-functions 8 --device cpu``
    (the Fourier-feature network at 16x16): the wide route's plain version
    through the driver and ``ImageFieldModel``, a finite loss each step."""
    from lomanerf_tpu_torch.train import fit_image

    out = fit_image.main(["--device", "cpu", "--img-size", "16", "--layers", "4",
                          "--width", "256", "--enc-functions", "8", "--steps", "3",
                          "--optimizer", "adam", "--lr", "1e-3", "--log-every", "2",
                          "--log-dir", str(tmp_path / "logs"), "--ckpt-dir",
                          str(tmp_path / "ck"), "--ckpt-every", "0"])
    assert len(out["losses"]) == 3 and np.all(np.isfinite(out["losses"]))
    assert out["losses"][-1] < out["losses"][0]
    cfg = ImageFieldConfig(num_layers=4, filter_size=256, num_encoding_functions=8,
                           img_size=16)
    model = ImageFieldModel(cfg, device="cpu")
    model.init(torch.Generator().manual_seed(0))
    assert fused_mlp.kernel_width(model.params, 2, 8, 3) is None
    with torch.no_grad():
        img = model.render()
    assert img.shape == (16, 16, 3) and torch.isfinite(img).all()
