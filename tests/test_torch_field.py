"""The port's 2D image field against the JAX package, on the CPU.

Same numpy-seeded params and coords through both packages.  On CPU tensors
the port's ``field_forward`` runs its plain version; it is held to the JAX
package's fused field (``fused_mlp._fwd_kernel`` / ``_bwd_kernel`` in
interpret mode, ``highest_precision=True``, ``rows_tile=32``) and to
``core.image_fit_pred`` / ``jax.grad`` of ``core.image_fit_loss``, at the
JAX test's bounds (``test_fused_field_forward_and_grads``): forward rtol
2e-4 / atol 1e-5, grads rtol 3e-4 / atol 3e-5.  The JAX kernel takes cos
as sin(x + pi/2); at n=8 the octave reaches 128 x and its cos lanes sit
~1e-5 from ``cos``; the port computes ``cos`` as core does, and the
forward's rtol (2e-4 of outputs near 0.5) absorbs that difference.  The
CUDA kernels' algorithm (``csrc/field_common.cuh``: tiles of 64 pixels,
d_z written over each layer's input, per-block partials) is restated in
numpy over the packed buffers; ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` compare the kernels themselves on the card.  Also: the
grid coords, the packing, the image-fit step, the model's render and the
``fit_image`` driver.
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
from lomanerf_tpu.models import ImageFieldConfig as JConfig
from lomanerf_tpu.models import ImageFieldModel as JModel
from lomanerf_tpu.models.image_mlp import image_grid_coords as j_grid
from lomanerf_tpu.ops import fused_mlp as j_fused
from lomanerf_tpu.train import loma_adam as j_loma_adam
from lomanerf_tpu.train import loma_sgd as j_loma_sgd
from lomanerf_tpu_torch import core as tcore
from lomanerf_tpu_torch.models import ImageFieldConfig, ImageFieldModel, image_grid_coords
from lomanerf_tpu_torch.ops import fused_mlp, fused_nerf
from lomanerf_tpu_torch.train import optim
from lomanerf_tpu_torch.train.steps import make_image_fit_step

FWD_RTOL, FWD_ATOL, GRAD_RTOL, GRAD_ATOL = 2e-4, 1e-5, 3e-4, 3e-5
# (layers, width, octaves): the small preset, and the hires preset narrowed
# to 32 so that interpret mode stays quick
SHAPES = {"small": (3, 16, 5), "hires_narrow": (4, 32, 8)}


def np_params(rng, sizes):
    ws = [(rng.standard_normal((fi, fo)) * np.sqrt(2.0 / fi)).astype(np.float32)
          for fi, fo in sizes]
    bs = [(rng.standard_normal(fo) * 0.5).astype(np.float32) for _, fo in sizes]
    return ws, bs


def field_params(rng, layers, width, nf, out=3):
    return np_params(rng, tcore.mlp_layer_sizes(2 * (1 + 2 * nf), out, layers, width))


def leaves(params):
    return [p.requires_grad_(True) for p in [*params["w"], *params["b"]]]


def close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("n", [50, 1037])  # neither a multiple of the 64-pixel tile
@pytest.mark.parametrize("shape", list(SHAPES))
def test_field_forward_matches_jax_kernel_and_core(rng, shape, n):
    """Port field_forward (CPU) vs the JAX fused field (interpret mode) and
    the JAX core: values, and the grads of the sum-MSE; None coords grad."""
    layers, width, nf = SHAPES[shape]
    ws, bs = field_params(rng, layers, width, nf)
    coords = rng.random((n, 2)).astype(np.float32)
    target = rng.random((n, 3)).astype(np.float32)
    jp, jc, jt = jcore.params_from_numpy(ws, bs), jnp.asarray(coords), jnp.asarray(target)
    enc = jcore.positional_encoding(jc, nf)

    def j_kernel(p):
        return j_fused.field_forward(p, jc, num_functions=nf, rows_tile=32,
                                     highest_precision=True)

    k_out = j_kernel(jp)
    k_grads = jax.grad(lambda p: jcore.sum_mse(j_kernel(p), jt))(jp)
    c_out = jcore.image_fit_pred(jp, enc)
    c_grads = jax.grad(lambda p: jcore.image_fit_loss(p, enc, jt))(jp)

    params = tcore.params_from_numpy(ws, bs, "cpu")
    lv = leaves(params)
    t_coords = torch.from_numpy(coords).requires_grad_(True)
    out = fused_mlp.field_forward(params, t_coords, nf)
    assert out.shape == (n, 3)
    loss = tcore.sum_mse(out, torch.from_numpy(target))
    got = torch.autograd.grad(loss, lv, retain_graph=True)
    for want_out, want in ((k_out, k_grads), (c_out, c_grads)):
        close(out.detach(), want_out, FWD_RTOL, FWD_ATOL)
        for g, w in zip(got, [*want["w"], *want["b"]]):
            close(g, w, GRAD_RTOL, GRAD_ATOL)
    assert torch.autograd.grad(loss, [t_coords], allow_unused=True) == (None,)


def field_walk(pk, coords, dout, L, K0, H, nf, out_ch, n_blocks, tile=64):
    """numpy (f64) restatement of field_common.cuh over the packed buffer:
    blocks stride over tiles of ``tile`` pixels (pad pixels at coords 0 with
    a zero cotangent); per tile the encoding, the forward keeping every
    layer's input, the head's d_z, then per layer from the top dW += h^T d_z
    and db += sum d_z into the block's partial, and d_z written over the
    layer's input; the partials summed in block order.  Returns
    ``(out (n, out_ch), G gradient floats)``."""
    pk = pk.astype(np.float64)
    rows, cols = [K0] + [H] * (L - 1), [H] * (L - 1) + [4]
    offs = np.cumsum([0] + [r * c + c for r, c in zip(rows, cols)])
    G = int(offs[-1])

    def layer(l):
        w = pk[offs[l]:offs[l] + rows[l] * cols[l]].reshape(rows[l], cols[l])
        return w, pk[offs[l] + rows[l] * cols[l]:offs[l + 1]]

    n = coords.shape[0]
    out, parts = np.zeros((n, out_ch)), np.zeros((n_blocks, G))
    for t in range(-(-n // tile)):
        px = np.arange(t * tile, (t + 1) * tile)
        real = px < n
        xy = np.zeros((tile, 2))
        xy[real] = coords[px[real]]
        enc = [xy]
        for i in range(nf):
            enc += [np.sin(2.0**i * xy), np.cos(2.0**i * xy)]
        acts = [np.concatenate(enc, axis=1)]
        for l in range(L):
            w, b = layer(l)
            z = acts[l] @ w + b
            acts.append(np.maximum(z, 0.0) if l < L - 1 else 1.0 / (1.0 + np.exp(-z)))
        y = acts[L]
        out[px[real]] = y[real, :out_ch]
        dz = np.zeros((tile, 4))
        dz[real, :out_ch] = dout[px[real]] * y[real, :out_ch] * (1.0 - y[real, :out_ch])
        acts[L] = dz
        part = parts[t % n_blocks]
        for l in reversed(range(L)):
            part[offs[l]:offs[l] + rows[l] * cols[l]] += (acts[l].T @ acts[l + 1]).ravel()
            part[offs[l] + rows[l] * cols[l]:offs[l + 1]] += acts[l + 1].sum(0)
            if l > 0:
                acts[l] = (acts[l + 1] @ layer(l)[0].T) * (acts[l] > 0)
    return out, parts.sum(0)


@pytest.mark.parametrize("n", [50, 1037])
@pytest.mark.parametrize("layers,width,nf,out", [
    (3, 16, 5, 3),   # small: W = 16
    (4, 32, 8, 3),   # hires shape, narrowed: W = 32
    (2, 20, 5, 2),   # padded hidden columns (20 -> 32), two channels read of a 2-wide head
    (1, 16, 5, 3),   # one layer: layer 0 is the head
])
def test_field_kernel_algorithm_matches_autograd(rng, layers, width, nf, out, n):
    """The field kernels' walk, restated in numpy over the packed buffer and
    unpacked by the wrapper's unpack_grads, equals the plain version and
    autograd of (field * dout).sum(); pad pixels and pad columns add
    nothing.  Both sides in f64 on f32-exact inputs, so that a ReLU mask
    cannot flip between them: rtol 1e-9."""
    ws, bs = field_params(rng, layers, width, nf, out)
    params = tcore.params_from_numpy(ws, bs, "cpu", dtype=torch.float64)
    coords = rng.random((n, 2)).astype(np.float32).astype(np.float64)
    dout = rng.standard_normal((n, out))
    W = fused_mlp.kernel_width(params, 2, nf, out)
    pk = fused_mlp.pack_field_params(params, W)
    G = fused_nerf.grad_floats(params, W)
    got_out, flat = field_walk(pk.numpy(), coords, dout, layers, 2 * (1 + 2 * nf), W, nf,
                               out, n_blocks=3)
    assert flat.shape == (G,)
    lv = leaves(params)
    want_out = fused_mlp.field_forward(params, torch.from_numpy(coords), nf, out)
    close(got_out, want_out.detach(), 1e-9, 1e-12)
    want = torch.autograd.grad((want_out * torch.from_numpy(dout)).sum(), lv)
    got = fused_nerf.unpack_grads(torch.from_numpy(flat), params, W)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        close(g, w, 1e-9, 1e-12)


def test_kernel_width_and_shared_memory():
    """The padded width of each preset, the shared memory the kernels' own
    formula gives (hires: 16,640 floats of weights + 64 x 427 of
    activations), and a raise naming D2 for each case no kernel takes."""
    rng = np.random.default_rng(0)

    def params(layers, width, nf=5, out=3):
        return tcore.params_from_numpy(*field_params(rng, layers, width, nf, out), "cpu")

    assert fused_mlp.kernel_width(params(3, 16), 2, 5, 3) == 16
    assert fused_mlp.kernel_width(params(3, 30), 2, 5, 3) == 32
    assert fused_mlp.kernel_width(params(4, 128, 8), 2, 8, 3) == 128
    assert fused_mlp.field_smem_bytes(4, 34, 128) == 4 * (16640 + 64 * 427) == 175872
    assert fused_mlp.field_smem_bytes(3, 22, 16) == 4 * (22 * 17 + 16 + 64 * (23 + 17 + 17 + 5))
    for p, nf, out, match in ((params(3, 200), 5, 3, "width 200"),
                              (params(3, 16, out=5), 5, 5, "5-channel head"),
                              (params(8, 128, 8), 8, 3, "shared memory")):
        with pytest.raises(NotImplementedError, match="D2"):
            fused_mlp.kernel_width(p, 2, nf, out)
        with pytest.raises(NotImplementedError, match=match):
            fused_mlp.kernel_width(p, 2, nf, out)
    p3 = tcore.params_from_numpy(*np_params(rng, tcore.mlp_layer_sizes(33, 3, 2, 16)), "cpu")
    with pytest.raises(NotImplementedError, match="3-d coords.*D2"):
        fused_mlp.kernel_width(p3, 3, 5, 3)
    with pytest.raises(ValueError, match="first layer"):
        fused_mlp.kernel_width(params(3, 16), 2, 4, 3)
    with pytest.raises(ValueError, match="out_channels"):
        fused_mlp.kernel_width(params(3, 16), 2, 5, 4)


def test_packing_round_trip_and_cpu_route(rng):
    """unpack_grads of the packed buffer gives the params back exactly; the
    CPU path launches nothing."""
    for layers, width, nf in SHAPES.values():
        params = tcore.params_from_numpy(*field_params(rng, layers, width, nf), "cpu")
        W = fused_mlp.kernel_width(params, 2, nf, 3)
        pk = fused_mlp.pack_field_params(params, W)
        G = fused_nerf.grad_floats(params, W)
        assert pk.dtype == torch.float32 and pk.numel() >= G
        back = fused_nerf.unpack_grads(pk[:G], params, W)
        for a, b in zip(back, [*params["w"], *params["b"]]):
            assert torch.equal(a, b)
    before = dict(fused_mlp.launches)
    fused_mlp.field_forward(params, torch.rand(10, 2), nf).sum()
    assert fused_mlp.launches == before


@pytest.mark.parametrize("size", [1, 5, 64])
def test_image_grid_coords_match_jax(size):
    got = image_grid_coords(size)
    assert got.shape == (size * size, 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_grid(size)))
    if size > 1:  # x varies fastest: "xy" indexing, not torch's "ij" default
        assert float(got[1, 0]) > 0.0 and float(got[1, 1]) == 0.0


@pytest.mark.parametrize("which", ["sgd", "adam", "loma_adam"])
def test_image_fit_step_trajectory_matches_jax(rng, which):
    """3 steps of make_image_fit_step with seeded adjoints (1, 0.5, then the
    previous loss) vs the JAX step (backend="jnp").  SGD: params rtol 1e-5 /
    atol 1e-6.  Adam divides by sqrt(v), so a gradient entry near 0 turns a
    tiny difference into a larger relative one: rtol 1e-4 / atol 1e-5."""
    from lomanerf_tpu.train.steps import make_image_fit_step as j_make_step

    cfg, jcfg = ImageFieldConfig(img_size=8), JConfig(img_size=8)
    ws, bs = field_params(rng, 3, 16, 5)
    batches = [(rng.random((64, 2)).astype(np.float32),
                rng.random((64, 3)).astype(np.float32)) for _ in range(3)]
    lr = 1e-3
    j_opt = {"sgd": j_loma_sgd(lr), "adam": optax.adam(lr), "loma_adam": j_loma_adam(lr)}[which]
    jp = jcore.params_from_numpy(ws, bs)
    js = j_opt.init(jp)
    j_step = j_make_step(jcfg, j_opt, backend="jnp", donate=False)
    model = ImageFieldModel.from_numpy(cfg, ws, bs, device="cpu")
    params = list(model.parameters())
    t_opt = {"sgd": lambda: optim.loma_sgd(params, lr),
             "adam": lambda: torch.optim.Adam(params, lr=lr),
             "loma_adam": lambda: optim.loma_adam(params, lr)}[which]()
    step = make_image_fit_step(cfg, t_opt)
    rtol, atol = (1e-5, 1e-6) if which == "sgd" else (1e-4, 1e-5)
    seed = None
    for i, (c, t) in enumerate(batches):
        jp, js, j_loss = j_step(jp, js, jnp.asarray(c), jnp.asarray(t), seed)
        loss = step(model, torch.from_numpy(c), torch.from_numpy(t),
                    None if seed is None else torch.tensor(seed))
        assert loss.shape == () and not loss.requires_grad
        np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
        for a, w in zip([*model.w, *model.b], [*jp["w"], *jp["b"]]):
            close(a.detach(), w, rtol, atol)
        seed = 0.5 if i == 0 else float(loss)


def test_model_render_and_loss_match_jax(rng):
    """ImageFieldModel.render and .loss (CPU: the plain version) vs the JAX
    model's (jnp backend); the plain backend gives the same."""
    cfg, jcfg = ImageFieldConfig(img_size=12), JConfig(img_size=12)
    ws, bs = field_params(rng, 3, 16, 5)
    jp = jcore.params_from_numpy(ws, bs)
    jm = JModel(jcfg)
    coords = rng.random((30, 2)).astype(np.float32)
    target = rng.random((30, 3)).astype(np.float32)
    for backend in ("auto", "plain"):
        model = ImageFieldModel.from_numpy(cfg, ws, bs, device="cpu", backend=backend)
        with torch.no_grad():
            img = model.render()
        assert img.shape == (12, 12, 3)
        close(img, jm.render(jp), FWD_RTOL, FWD_ATOL)
        close(model.render(5).detach(), jm.render(jp, 5), FWD_RTOL, FWD_ATOL)
        loss = model.loss(torch.from_numpy(coords), torch.from_numpy(target))
        np.testing.assert_allclose(loss.item(), float(jm.loss(jp, jnp.asarray(coords),
                                                             jnp.asarray(target))), rtol=1e-5)
        close(model.predict(model.encode(torch.from_numpy(coords))).detach(),
              jm.predict(jp, jm.encode(jnp.asarray(coords))), FWD_RTOL, FWD_ATOL)
    with pytest.raises(ValueError):
        ImageFieldModel(cfg, backend="pallas")
    assert ImageFieldConfig.hires().in_channels == JConfig.hires().in_channels == 34
    assert ImageFieldConfig.small().in_channels == 22


def test_init_shapes_and_synthetic_target_match_jax():
    from lomanerf_tpu.train.fit_image import synthetic_target as j_target
    from lomanerf_tpu_torch.train.fit_image import synthetic_target

    np.testing.assert_array_equal(synthetic_target(33), j_target(33))
    model = ImageFieldModel(ImageFieldConfig.hires(), device="cpu")
    params = model.init(torch.Generator().manual_seed(215))
    jparams = JModel(JConfig.hires()).init(jax.random.PRNGKey(215))
    assert [tuple(w.shape) for w in params["w"]] == [w.shape for w in jparams["w"]]
    assert [tuple(b.shape) for b in params["b"]] == [b.shape for b in jparams["b"]]


def _rows(path):
    return [json.loads(line) for line in open(path)]


def test_fit_image_driver_smoke_resume_and_parity_seed(tmp_path):
    from PIL import Image

    from lomanerf_tpu_torch.train import fit_image
    from lomanerf_tpu_torch.train.checkpoint import CheckpointManager

    flags = ["--device", "cpu", "--img", "synthetic", "--img-size", "16",
             "--optimizer", "adam", "--lr", "3e-3", "--log-every", "10",
             "--log-dir", str(tmp_path / "logs_2d"), "--ckpt-dir", str(tmp_path / "ck"),
             "--ckpt-every", "0"]
    out = fit_image.main([*flags, "--steps", "12"])
    assert len(out["losses"]) == 12 and sorted(out["psnr"]) == [0, 10]
    for step in (0, 10, 12):  # target | prediction
        assert np.asarray(Image.open(tmp_path / "logs_2d" / f"iter_{step}.png")).shape == (16, 32, 3)
    rows = _rows(tmp_path / "logs_2d" / "metrics.jsonl")
    assert [r["step"] for r in rows] == list(range(12))  # the loss curve
    assert all("loss" in r for r in rows) and [r["step"] for r in rows if "psnr" in r] == [0, 10]
    assert CheckpointManager(str(tmp_path / "ck")).latest_step() == 12
    # resume with the loss-seeded adjoint, in chunks of 100 pixels
    more = fit_image.main([*flags, "--steps", "14", "--resume", "--parity-seed",
                           "--chunk", "100"])
    assert len(more["losses"]) == 2 and np.all(np.isfinite(more["losses"]))
    assert np.isfinite(more["final_psnr"])
    assert CheckpointManager(str(tmp_path / "ck")).latest_step() == 14


def test_fit_image_converges_and_refuses_missing_card(tmp_path):
    """150 Adam steps on a 48x48 synthetic target lift the PSNR well above
    its start; without a card, --device cuda exits."""
    from lomanerf_tpu_torch.train import fit_image

    out = fit_image.main(["--device", "cpu", "--img-size", "48", "--steps", "151",
                          "--optimizer", "adam", "--lr", "3e-3", "--log-every", "50",
                          "--log-dir", str(tmp_path / "logs"), "--ckpt-dir",
                          str(tmp_path / "ck"), "--ckpt-every", "0"])
    psnrs = out["psnr"]
    assert psnrs[150] > psnrs[0] + 8.0, psnrs
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            fit_image.main(["--steps", "1"])
    assert os.path.exists(tmp_path / "logs" / "iter_151.png")
