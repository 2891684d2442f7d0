"""The port's copy of the golden-oracle harness
(``lomanerf_tpu_torch.parity.oracle``) against the JAX package's
(``lomanerf_tpu.parity.oracle``), and the port's plain pipelines against the
reference loma CPU implementation.

The marshalling helpers run anywhere and must give the JAX module's arrays
bit for bit on the same numpy input.  The parity checks mirror
``tests/test_parity_oracle.py`` with the port's ``core`` on CPU tensors and
the same bounds; they need the reference tree and gcc, and skip without
them as that file does.
"""

import ctypes

import numpy as np
import pytest
import torch

from lomanerf_tpu.parity import oracle as j_oracle
from lomanerf_tpu_torch import core as tcore
from lomanerf_tpu_torch.parity import oracle
from lomanerf_tpu_torch.parity import oracle_available

needs_reference = pytest.mark.skipif(not oracle_available(),
                                     reason="reference loma compiler not present")


def _make_mlp(rng, sizes):
    ws = [rng.standard_normal(s).astype(np.float32) * (2.0 / s[0]) ** 0.5 for s in sizes]
    bs = [rng.standard_normal(s[1]).astype(np.float32) * 0.5 for s in sizes]
    return ws, bs


SIZES = {"fit": [(22, 16), (16, 16), (16, 3)], "nerf": [(33, 30), (30, 30), (30, 4)],
         "ragged": [(5, 9), (9, 2), (2, 7)]}


@pytest.mark.parametrize("sizes", list(SIZES))
def test_padding_helpers_match_the_jax_module(rng, sizes):
    """pad_weights, pad_biases, unpad_like and intermediate_shapes_for give
    the JAX module's arrays bit for bit, and unpad_like inverts the padding."""
    ws, bs = _make_mlp(rng, SIZES[sizes])
    for fn, arg in ((oracle.pad_weights, ws), (oracle.pad_biases, bs)):
        got, want = fn(arg), getattr(j_oracle, fn.__name__)(arg)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    shapes = [w.shape for w in ws]
    for a, w in zip(oracle.unpad_like(oracle.pad_weights(ws), shapes), ws):
        np.testing.assert_array_equal(a, w)
    np.testing.assert_array_equal(oracle.intermediate_shapes_for(37, ws),
                                  j_oracle.intermediate_shapes_for(37, ws))
    assert oracle.intermediate_shapes_for(37, ws).dtype == np.int32


def test_row_pointers_address_the_numpy_rows(rng):
    """The zero-copy row tables (_rowptrs_2d/3d through f2d, f3d, i2d)
    point into the array's own rows, as the JAX module's do, also for a
    strided view; the 3-D table keeps its inner tables alive."""
    a = rng.standard_normal((5, 7)).astype(np.float32)
    cube = rng.standard_normal((3, 4, 6)).astype(np.float32)
    ints = rng.integers(0, 100, (4, 3)).astype(np.int32)
    strided = np.ascontiguousarray(rng.standard_normal((8, 7)).astype(np.float32))[::2]
    for x in (a, strided):
        table, want = oracle.f2d(x), j_oracle.f2d(x)
        for r in range(x.shape[0]):
            assert ctypes.addressof(table[r].contents) == ctypes.addressof(want[r].contents)
            assert [table[r][c] for c in range(x.shape[1])] == list(x[r])
    t3 = oracle.f3d(cube)
    assert len(t3._keepalive) == 3
    for i in range(3):
        for r in range(4):
            assert [t3[i][r][c] for c in range(6)] == list(cube[i, r])
    ti = oracle.i2d(ints)
    assert [[ti[r][c] for c in range(3)] for r in range(4)] == ints.tolist()
    np.testing.assert_array_equal(oracle._as_f32([[1, 2]]), j_oracle._as_f32([[1, 2]]))
    assert oracle._as_i32([1.0]).dtype == np.int32


def test_availability_follows_the_reference_tree(tmp_path, monkeypatch):
    """The oracle is available exactly where the tree that
    ``LOMANERF_REFERENCE`` names holds ``loma_public``, as the JAX module
    decides for the same tree; without the variable it is not."""
    monkeypatch.setattr(oracle, "REFERENCE_ROOT", None)
    assert not oracle.oracle_available()
    monkeypatch.setattr(j_oracle, "REFERENCE_ROOT", str(tmp_path))
    monkeypatch.setattr(oracle, "REFERENCE_ROOT", str(tmp_path))
    assert oracle.oracle_available() == j_oracle.oracle_available()
    assert not oracle.oracle_available()
    (tmp_path / "loma_public").mkdir()
    assert oracle.oracle_available() and j_oracle.oracle_available()


def _params(ws, bs):
    return tcore.params_from_numpy(ws, bs, "cpu")


@needs_reference
def test_mlp_fit_forward_parity(rng):
    """2D-fit forward loss vs oracle (config: fit_img.py 22->16->16->3)."""
    ws, bs = _make_mlp(rng, SIZES["fit"])
    coords = rng.standard_normal((64, 22)).astype(np.float32)
    target = rng.random((64, 3)).astype(np.float32)
    loss_oracle = oracle.mlp_fit_forward(coords, ws, bs, target)
    loss = tcore.image_fit_loss(_params(ws, bs), torch.from_numpy(coords),
                                torch.from_numpy(target))
    np.testing.assert_allclose(loss.item(), loss_oracle, rtol=1e-5)


@needs_reference
def test_mlp_fit_grad_parity(rng):
    ws, bs = _make_mlp(rng, SIZES["fit"])
    coords = rng.standard_normal((64, 22)).astype(np.float32)
    target = rng.random((64, 3)).astype(np.float32)
    seed = 0.37  # loss-valued adjoint seed quirk (fit_img.py:497)
    d_ws_o, d_bs_o, _ = oracle.mlp_fit_grad(coords, ws, bs, target, seed=seed)
    _, grads = tcore.seeded_value_and_grad(tcore.image_fit_loss)(
        _params(ws, bs), torch.from_numpy(coords), torch.from_numpy(target), seed=seed)
    for got, want in zip([*grads["w"], *grads["b"]], [*d_ws_o, *d_bs_o]):
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-5)


def _nerf_case(rng, n_rays, s):
    ws, bs = _make_mlp(rng, SIZES["nerf"])
    pts = rng.standard_normal((n_rays, s, 3)).astype(np.float32)
    enc = tcore.positional_encoding(torch.from_numpy(pts), 5).numpy()
    target = rng.random((n_rays, 3)).astype(np.float32)
    t = np.linspace(2.0, 6.0, s).astype(np.float32)
    dists = np.tile(np.concatenate([t[1:] - t[:-1], [1e8]]), (n_rays, 1)).astype(np.float32)
    return ws, bs, enc, target, dists


@needs_reference
def test_nerf_forward_parity(rng):
    """Single-view NeRF chunk vs oracle (4 rays x 30 samples, 33->30->30->4)."""
    ws, bs, enc, target, dists = _nerf_case(rng, 4, 30)
    loss_o, color_o = oracle.nerf_forward(enc.reshape(-1, 33), ws, bs, target, dists)
    e, dd, tt = (torch.from_numpy(x) for x in (enc, dists, target))
    color = tcore.nerf_render(_params(ws, bs), e, dd, mode="loma")
    loss = tcore.nerf_loss(_params(ws, bs), e, dd, tt)
    np.testing.assert_allclose(color.numpy(), color_o, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(loss.item(), loss_o, rtol=1e-4)


@needs_reference
def test_nerf_grad_parity(rng):
    ws, bs, enc, target, dists = _nerf_case(rng, 4, 30)
    seed = 1.7  # train_nerf.py:477 seeds with the running loss value
    d_ws_o, d_bs_o, _ = oracle.nerf_grad(enc.reshape(-1, 33), ws, bs, target, dists, seed=seed)
    _, grads = tcore.seeded_value_and_grad(tcore.nerf_loss)(
        _params(ws, bs), *(torch.from_numpy(x) for x in (enc, dists, target)), seed=seed)
    for got, want in zip([*grads["w"], *grads["b"]], [*d_ws_o, *d_bs_o]):
        np.testing.assert_allclose(got.numpy(), want, rtol=3e-4, atol=3e-5)


@needs_reference
def test_nerf_input_grad_parity(rng):
    """d(loss)/d(encoded points) must also match (pixel-gradient parity)."""
    ws, bs, enc, target, dists = _nerf_case(rng, 2, 8)
    _, _, d_enc_o = oracle.nerf_grad(enc.reshape(-1, 33), ws, bs, target, dists)
    e = torch.from_numpy(enc).requires_grad_(True)
    loss = tcore.nerf_loss(_params(ws, bs), e, torch.from_numpy(dists),
                           torch.from_numpy(target))
    (d_enc,) = torch.autograd.grad(loss, [e])
    np.testing.assert_allclose(d_enc.numpy().reshape(-1, 33), d_enc_o, rtol=3e-4, atol=3e-5)
