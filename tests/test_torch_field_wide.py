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
stacks.  ``chip_smoke.py`` phase 25 holds the kernels themselves.
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


def kernel_sequence(W, b, nf, coords, dout, L, enc, hidden, out_ch, chunk, row_chunk):
    """numpy (f64) restatement of ``field_wide_bwd`` over the packed stacks:
    per chunk of ``chunk`` pixels, the encoding (:func:`encode_lanes`), each
    hidden layer ReLU(h W_l + b_l) on its real columns,
    the head's d_z = dout * y * (1 - y) on ``out_ch`` columns, then in
    reverse each layer's dW as split-K partials of ``row_chunk`` rows and
    db as column-sum partials, each added in order into the running sums,
    and d_h = d_z W_l^T masked by h_l > 0.  Returns (out, dW, db)."""
    pw = W.shape[1]
    dW, db = np.zeros((L, pw, pw)), np.zeros((L, pw))
    outs = []
    ins = [enc] + [hidden] * (L - 1)
    cols = [hidden] * (L - 1) + [out_ch]
    for c0 in range(0, coords.shape[0], chunk):
        h = [encode_lanes(coords[c0:c0 + chunk].astype(np.float32), nf)[0]]
        for l in range(L - 1):
            h.append(np.maximum(h[l] @ W[l, :ins[l], :cols[l]] + b[l, :cols[l]], 0.0))
        y = 1.0 / (1.0 + np.exp(-(h[-1] @ W[L - 1, :ins[-1], :out_ch] + b[L - 1, :out_ch])))
        outs.append(y)
        g = dout[c0:c0 + chunk] * y * (1.0 - y)
        for l in range(L - 1, -1, -1):
            for r0 in range(0, g.shape[0], row_chunk):
                dW[l, :ins[l], :cols[l]] += h[l][r0:r0 + row_chunk].T @ g[r0:r0 + row_chunk]
                db[l, :cols[l]] += g[r0:r0 + row_chunk].sum(0)
            if l >= 1:
                g = (g @ W[l, :ins[l], :cols[l]].T) * (h[l] > 0)
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
    got_out, dW, db = kernel_sequence(W.double().numpy(), b.double().numpy(), nf, coords,
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
