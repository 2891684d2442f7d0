"""The port's driver surface (``lomanerf_tpu_torch.entry``) against the
repository's JAX entry points (``__graft_entry__.py``), on the CPU.

``entry()``'s loss takes the port's fused backend; on CPU tensors that is
the plain version of the wide train kernel, in the flagship's bf16 rounding
plan.  It is held, on the JAX entry's own example args and params (passed
as numpy), to the JAX fused train kernel in bf16 (``backend="pallas"``, the
path the JAX entry takes on a TPU, here in interpret mode) at PERF.md
section 2's bf16 bounds (loss rtol 1e-4, dW/db within 1e-2 of the leaf's
largest entry), and to the JAX entry's own function (on the CPU its f32
``jnp`` pipeline) at bounds of bf16 against f32.  ``dryrun_multichip``
runs on four gloo ranks of the CPU (one thread a rank).  ``chip_smoke.py``
phase 23 runs both on the card.
"""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as j_entry
from lomanerf_tpu.models import NeRFConfig as JConfig
from lomanerf_tpu.train.steps import nerf_loss_fn as j_loss_fn
from lomanerf_tpu_torch import core as tcore
from lomanerf_tpu_torch import entry
from lomanerf_tpu_torch.models import NeRFConfig

# PERF.md section 2, bf16 (full): the kernels against their plain version
BF16_LOSS_RTOL, BF16_GRAD_REL = 1e-4, 1e-2
# bf16 against the JAX entry's f32 pipeline on its 1024 rays: measured loss
# 1.2e-4 relative and 2.2e-2 of a leaf's largest gradient entry; about 4x
F32_LOSS_RTOL, F32_GRAD_REL = 5e-4, 8e-2


@pytest.fixture(scope="module")
def both():
    """The JAX entry's (fn, args), its f32 loss and grads, its bf16 fused
    loss and grads, and the port's on the same args."""
    jfn, jargs = j_entry.entry()
    f32 = jax.value_and_grad(jfn)(*jargs)
    bf16 = jax.value_and_grad(
        lambda p, *r: j_loss_fn(p, *r, JConfig.full(), "pallas"))(*jargs)
    jp = jargs[0]
    params = tcore.params_from_numpy([np.asarray(w) for w in jp["w"]],
                                     [np.asarray(b) for b in jp["b"]], "cpu")
    lv = [p.requires_grad_(True) for p in [*params["w"], *params["b"]]]
    fn, targs = entry.entry("cpu")
    loss = fn(params, *[torch.from_numpy(np.array(x)) for x in jargs[1:]])
    grads = torch.autograd.grad(loss, lv)
    return jargs, targs, f32, bf16, (loss.item(), [g.numpy() for g in grads])


def flat(tree):
    return [np.asarray(x) for x in [*tree["w"], *tree["b"]]]


@pytest.mark.parametrize("against", ["jax bf16 kernel", "jax entry f32"])
def test_entry_loss_matches_jax_entry(both, against):
    """The port's entry() function on the JAX entry's args and params: loss
    and dW/db against the JAX fused bf16 train kernel at the bf16 bounds,
    and against the JAX entry's own function at bf16-against-f32 bounds."""
    _, _, f32, bf16, (loss, grads) = both
    (want_loss, want_grads), loss_rtol, rel = (
        (bf16, BF16_LOSS_RTOL, BF16_GRAD_REL) if against == "jax bf16 kernel"
        else (f32, F32_LOSS_RTOL, F32_GRAD_REL))
    np.testing.assert_allclose(loss, float(want_loss), rtol=loss_rtol)
    for g, w in zip(grads, flat(want_grads)):
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= rel * np.abs(w).max()


def test_entry_example_args_follow_the_jax_entry(both):
    """entry()'s example args: the flagship's 1024 rays drawn with numpy
    default_rng(0) as the JAX entry draws them (origins, directions and
    targets bit for bit; the (S,) depths and steps of the same linspace
    within 1e-6: the two linspaces round apart), params from
    init_mlp(init="nerf") in the flagship's shapes on the CPU when asked,
    and a finite 0-d loss."""
    jargs, targs, *_ = both
    params, *rays = targs
    cfg = NeRFConfig.full()
    assert [tuple(w.shape) for w in params["w"]] == [tuple(np.shape(w)) for w in jargs[0]["w"]]
    assert all(x.device.type == "cpu" for x in [*params["w"], *rays])
    assert not params["b"][0].any() and params["b"][-1][3] == 0.5
    for i in (0, 1, 4):
        np.testing.assert_array_equal(rays[i].numpy(), np.asarray(jargs[1 + i]))
    for i in (2, 3):
        np.testing.assert_allclose(rays[i].numpy(), np.asarray(jargs[1 + i]), rtol=0,
                                   atol=1e-6)
    assert rays[2].shape == (cfg.num_samples,) and rays[0].shape == (entry.N_RAYS, 3)
    fn, _ = entry.entry("cpu")
    loss = fn(*targs)
    assert loss.shape == () and torch.isfinite(loss)


def test_dryrun_mesh_shape_and_backend():
    """tp = 2 when n is even and at least 4, as the JAX dry run splits its
    devices; gloo on the CPU and where ranks share a card."""
    assert [entry.mesh_shape(n) for n in (1, 2, 3, 4, 6, 8)] == \
        [(1, 1), (2, 1), (3, 1), (2, 2), (3, 2), (4, 2)]
    assert entry.backend_for(4, "cpu") == "gloo"
    assert entry.backend_for(1, "cpu") == "gloo"


def test_dryrun_multichip_on_four_cpu_ranks():
    """dryrun_multichip(4) on four gloo ranks (dp = 2, tp = 2): (a) the
    plain dp x tp step, (b) the fused data-parallel step, (c) the sharded
    render, each finite on every rank; the data-parallel results agree
    across ranks (one all-reduce, one all-gather)."""
    ranks = entry.dryrun_multichip(4, device="cpu", threads=1)
    assert len(ranks) == 4
    for r in ranks:
        assert np.isfinite(r["loss_dp_tp"]) and np.isfinite(r["loss_fused"])
        assert r["render_shape"] == (8, 3)  # 8 rays in chunks of 2 over 4 ranks
        assert not any(r["launches"].values())  # the CPU runs the plain versions
    assert len({r["loss_fused"] for r in ranks}) == 1
    assert len({r["loss_dp_tp"] for r in ranks}) == 1
