"""The port's stratified path against the JAX package, on the CPU: per-ray
``(N, S)`` depths from ``NeRFModel.sample(generator=...)``.

With per-ray depths the JAX dispatch sends narrow MLPs to the ray-major T
kernels (#4 ``_nerf_forward_kernel_T``, #5 ``_nerf_backward_kernel_T``, #6
``_nerf_train_kernel_T``) and wide ones to the packed row-major kernels (#10
``_nerf_forward_kernel``, #11 ``_nerf_backward_kernel``, #12
``_nerf_train_kernel``), here in interpret mode as the JAX package's own
tests run them.  On CPU tensors the port runs the plain versions of its
``*_rays`` CUDA kernels; both packages get the same numpy params, rays and
jittered depths.  Bounds: the JAX tests' own for the T kernels (colours
rtol 3e-4 / atol 1e-5, loss rtol 1e-5, dW/db rtol 3e-4 / atol 3e-5) and
``tests/test_torch_wide.py``'s for the wide ones.  The kernels' walks on
per-ray depths are restated in numpy in test_torch_render.py,
test_torch_train.py and test_torch_wide.py; ``tests/test_torch_cuda.py``
and ``chip_smoke.py`` hold the kernels themselves on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lomanerf_tpu import core as jcore
from lomanerf_tpu.models import NeRFConfig as JConfig
from lomanerf_tpu.models import NeRFModel as JModel
from lomanerf_tpu.ops import fused_nerf as j_fused
from lomanerf_tpu.train.steps import make_single_chip_train_step as j_make_step
from lomanerf_tpu_torch import core as tcore
from lomanerf_tpu_torch.models import NeRFConfig, NeRFModel
from lomanerf_tpu_torch.ops import fused_nerf
from lomanerf_tpu_torch.train.steps import make_single_chip_train_step

COL_RTOL, COL_ATOL, LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 3e-4, 1e-5, 1e-5, 3e-4, 3e-5
# bf16 (test_torch_wide.py): a sum in another order can flip a bf16 rounding
BF16_COL_ATOL, BF16_LOSS_RTOL, BF16_GRAD_REL = 2.2e-3, 7e-5, 4.4e-2
N = 20  # not a tile multiple


def np_params(rng, sizes, init="he"):
    ws = [(rng.standard_normal((fi, fo)) * np.sqrt(2.0 / fi)).astype(np.float32)
          for fi, fo in sizes]
    bs = [(rng.standard_normal(fo) * 0.5).astype(np.float32) for _, fo in sizes]
    if init == "nerf":  # zero biases, the head x0.1, a +0.5 density bias
        bs = [np.zeros_like(b) for b in bs]
        ws[-1] = ws[-1] * np.float32(0.1)
        bs[-1][3] = 0.5
    return ws, bs


def stratified_batch(rng, cfg, n, seed):
    """numpy (origins, directions, t, dists, target): rays from ``rng``,
    per-bin jittered (N, S) depths from the port's ``NeRFModel.sample``."""
    o = rng.standard_normal((n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    tgt = rng.random((n, 3)).astype(np.float32)
    model = NeRFModel(cfg, device="cpu")
    pts, t, dists = model.sample(torch.from_numpy(o), torch.from_numpy(d),
                                 generator=torch.Generator().manual_seed(seed))
    S = cfg.num_samples
    assert t.shape == dists.shape == (n, S) and pts.shape == (n, S, 3)
    jitter = t - torch.linspace(cfg.near, cfg.far, S)  # one draw per bin
    assert float(jitter.min()) >= 0 and float(jitter.max()) <= (cfg.far - cfg.near) / S
    assert len(torch.unique(jitter)) > n * S // 2  # truly jittered, per ray and bin
    assert torch.all(dists[:, -1] == 1e8)
    return o, d, t.numpy(), dists.numpy(), tgt


def leaves(params):
    return [p.requires_grad_(True) for p in [*params["w"], *params["b"]]]


def flat(tree):
    return [np.asarray(x) for x in [*tree["w"], *tree["b"]]]


def both_ways(ws, bs, batch, cfg, jcfg):
    """(colours, train loss, train-loss grads, NeRFModel.loss, its grads) of
    the port (CPU) and of the JAX fused kernels on the same inputs; also
    checks that the ray inputs and depths get no gradient."""
    jp = jcore.params_from_numpy(ws, bs)
    ja = [jnp.asarray(x) for x in batch]
    jmodel = JModel(jcfg, backend="pallas")
    j_col = j_fused.render_rays(jp, *ja[:4], jcfg)
    j_loss, j_g = jax.value_and_grad(lambda p: j_fused.nerf_train_loss(p, *ja, jcfg))(jp)
    j_mloss, j_r = jax.value_and_grad(lambda p: jmodel.loss(p, *ja))(jp)

    model = NeRFModel.from_numpy(cfg, ws, bs, device="cpu")
    lv = list(model.parameters())
    ta = [torch.from_numpy(x) for x in batch]
    for x in ta[:4]:
        x.requires_grad_(True)
    with torch.no_grad():
        col = model.render_rays(*ta[:4])
    loss = fused_nerf.nerf_train_loss(model.params, *ta, cfg)
    g = torch.autograd.grad(loss, lv, retain_graph=True)
    assert torch.autograd.grad(loss, ta[:4], allow_unused=True) == (None,) * 4
    mloss = model.loss(*ta)
    mloss.backward()
    assert all(x.grad is None for x in ta)  # t_vals.grad, dists.grad: None
    got = (col.numpy(), loss.item(), [x.numpy() for x in g], mloss.item(),
           [p.grad.numpy() for p in lv])
    want = (np.asarray(j_col), float(j_loss), flat(j_g), float(j_mloss), flat(j_r))
    return got, want


@pytest.mark.parametrize("mode", ["loma", "standard"])
@pytest.mark.parametrize("num_samples", [8, 30])
def test_narrow_perray_matches_jax_T_kernels(rng, mode, num_samples):
    """3x30 on jittered (N, S) depths: the port's render_rays, nerf_train_loss
    and NeRFModel.loss (the plain versions of nerf_render_fwd_rays,
    nerf_train_rays, nerf_render_bwd_rays) vs the JAX T kernels #4, #6 and
    #4 + #5."""
    cfg = NeRFConfig(num_samples=num_samples, mode=mode)
    jcfg = JConfig(num_samples=num_samples, mode=mode)
    ws, bs = np_params(rng, tcore.mlp_layer_sizes(33, 4, 3, 30))
    batch = stratified_batch(rng, cfg, N, seed=num_samples)
    assert fused_nerf._route(cfg, tcore.params_from_numpy(ws, bs, "cpu")) == ("narrow", 32)
    got, want = both_ways(ws, bs, batch, cfg, jcfg)
    np.testing.assert_allclose(got[0], want[0], rtol=COL_RTOL, atol=COL_ATOL)
    for i in (1, 3):
        np.testing.assert_allclose(got[i], want[i], rtol=LOSS_RTOL)
    for a, b in zip(got[2] + got[4], want[2] + want[4]):
        np.testing.assert_allclose(a, b, rtol=GRAD_RTOL, atol=GRAD_ATOL)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_wide_perray_matches_jax_packed_kernels(rng, compute_dtype):
    """3x128, S=8, on jittered (N, S) depths: the port's wide plain version
    (that of nerf_wide_render_fwd_rays, nerf_wide_train_rays and
    nerf_wide_render_bwd_rays) vs the JAX packed kernels #10, #12 and
    #10 + #11 (pw = 128)."""
    kw = dict(num_layers=3, filter_size=128, num_samples=8, mode="standard",
              compute_dtype=compute_dtype)
    if compute_dtype == "bfloat16":
        kw.update(precision="default", init="nerf")
    cfg, jcfg = NeRFConfig(**kw), JConfig(**kw)
    ws, bs = np_params(rng, tcore.mlp_layer_sizes(33, 4, 3, 128), cfg.init)
    assert fused_nerf._route(cfg, tcore.params_from_numpy(ws, bs, "cpu")) == ("wide", 128)
    got, want = both_ways(ws, bs, stratified_batch(rng, cfg, N, seed=3), cfg, jcfg)
    if compute_dtype == "float32":
        np.testing.assert_allclose(got[0], want[0], rtol=COL_RTOL, atol=COL_ATOL)
        for i in (1, 3):
            np.testing.assert_allclose(got[i], want[i], rtol=LOSS_RTOL)
        for a, b in zip(got[2] + got[4], want[2] + want[4]):
            np.testing.assert_allclose(a, b, rtol=GRAD_RTOL, atol=GRAD_ATOL)
        return
    assert np.abs(got[0] - want[0]).max() <= BF16_COL_ATOL
    for i in (1, 3):
        assert abs(got[i] - want[i]) <= BF16_LOSS_RTOL * abs(want[i])
    for a, b in zip(got[2] + got[4], want[2] + want[4]):
        assert np.abs(a - b).max() <= BF16_GRAD_REL * np.abs(b).max()


def test_train_step_on_stratified_batches_matches_jax():
    """3 Adam steps of make_single_chip_train_step on (N, S) batches, each
    with fresh jittered depths, vs the JAX step (backend="pallas": the T
    train kernel #6), from the same params.  Adam divides by sqrt(v), so a
    gradient entry near 0 turns a tiny difference into a larger relative
    one: params rtol 1e-4 / atol 1e-5 (test_torch_train.py's Adam bound)."""
    rng = np.random.default_rng(215)
    cfg = NeRFConfig(num_layers=3, filter_size=16, num_samples=8)
    jcfg = JConfig(num_layers=3, filter_size=16, num_samples=8)
    ws, bs = np_params(rng, tcore.mlp_layer_sizes(33, 4, 3, 16))
    batches = [stratified_batch(rng, cfg, 32, seed=i) for i in range(3)]
    j_opt = optax.adam(1e-3)
    jp = jcore.params_from_numpy(ws, bs)
    js = j_opt.init(jp)
    j_step = j_make_step(jcfg, j_opt, backend="pallas", donate=False)
    model = NeRFModel.from_numpy(cfg, ws, bs, device="cpu")
    step = make_single_chip_train_step(cfg, torch.optim.Adam(model.parameters(), lr=1e-3))
    for b in batches:
        jp, js, j_loss = j_step(jp, js, *(jnp.asarray(x) for x in b))
        loss = step(model, *(torch.from_numpy(x) for x in b))
        np.testing.assert_allclose(float(loss), float(j_loss), rtol=LOSS_RTOL)
        for a, w in zip([*model.w, *model.b], [*jp["w"], *jp["b"]]):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(w), rtol=1e-4,
                                       atol=1e-5)


def test_broadcast_depths_give_the_shared_result(rng):
    """(S,) depths broadcast to (N, S) give the same colours, loss and
    gradients through the port as the (S,) depths themselves (on the card
    the *_rays kernels then match the shared-depth ones bit for bit)."""
    cfg = NeRFConfig(num_samples=8)
    ws, bs = np_params(rng, tcore.mlp_layer_sizes(33, 4, 3, 30))
    o, d = (torch.from_numpy(rng.standard_normal((N, 3)).astype(np.float32))
            for _ in range(2))
    tgt = torch.from_numpy(rng.random((N, 3)).astype(np.float32))
    t, dists = tcore.uniform_depths(cfg.near, cfg.far, 8, "cpu")
    out = []
    for depths in ((t, dists), (t.expand(N, -1), dists.expand(N, -1))):
        params = tcore.params_from_numpy(ws, bs, "cpu")
        lv = leaves(params)
        loss = fused_nerf.nerf_train_loss(params, o, d, *depths, tgt, cfg)
        out.append((fused_nerf.render_rays(params, o, d, *depths, cfg).detach(),
                    loss.detach(), *torch.autograd.grad(loss, lv)))
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
