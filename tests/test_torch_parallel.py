"""The port's ``parallel/`` (``torch.distributed``, gloo ranks in spawned CPU
processes) against the JAX package's ``parallel/`` and core.

One counterpart of each of ``tests/test_parallel.py``'s 13 tests, each held
to the JAX result computed here, in the test process, from the same numpy
params and batch, at the JAX test's tolerance: the data-parallel step (loss
rtol 1e-5, params rtol 1e-4 / atol 1e-6, against JAX's dp=8 mesh and the
single-device step), the TP forward (rtol 1e-5 / atol 1e-6 against the
replicated MLP), the fused step (its plain version here), the sharded
render (37 ragged rays at chunk 2), TP with the kernels refused, the batch
helpers, ``MetricsLogger`` on rank 0 only, ``place_state`` with Adam and
``LomaAdam`` state (in place of the optax ``_mirror_spec`` test), dp x tp
improving the loss, and the two-process script.  Also: F5 (the sharded
render's chunk capped at ceil(n / dp)), F7 (the port's dp=2 x tp=2
gradients equal the single-device core's on every leaf), that the port's
``parallel`` imports no JAX, the scaling script, and the driver on one and
two ranks.

Every in-suite rank scenario runs in ONE spawn of four gloo ranks
(``_rank_scenarios``, a module fixture); the scripts and the driver run in
processes of their own.  A rank imports this module to find its function.
"""

import json
import os
import socket
import subprocess
import sys
import traceback

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from lomanerf_tpu.core import init_mlp, mlp_apply, normalized_intrinsics, sample_along_rays
from lomanerf_tpu.core.pipeline import nerf_loss_rays
from lomanerf_tpu.models import NeRFConfig
from lomanerf_tpu_torch import parallel as tpar
from lomanerf_tpu_torch.models import NeRFConfig as TConfig
from lomanerf_tpu_torch.train import train_nerf
from lomanerf_tpu_torch.train.checkpoint import CheckpointManager

try:
    from jax import shard_map
except ImportError:
    from jax.experimental.shard_map import shard_map

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def ray_batch(rng, n, cfg):
    """numpy (origins, directions, t_vals, dists, target) as
    ``test_parallel._ray_batch`` makes them: (S,) uniform depths."""
    o = rng.standard_normal((n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    _, t, dists = sample_along_rays(jnp.asarray(o), jnp.asarray(d), cfg.near, cfg.far,
                                    cfg.num_samples)
    tgt = rng.random((n, 3)).astype(np.float32)
    return o, d, np.asarray(t), np.asarray(dists), tgt


def cfg_kw(cfg):
    return {"num_layers": cfg.num_layers, "filter_size": cfg.filter_size,
            "num_samples": cfg.num_samples}


def leaves(p):
    return [*p["w"], *p["b"]]


def sgd_reference(params, batch, cfg, lr):
    """``(loss, params after one SGD step)`` of the single-device core."""
    loss, g = jax.value_and_grad(lambda p: nerf_loss_rays(
        p, *(jnp.asarray(x) for x in batch), num_functions=cfg.num_encoding_functions,
        mode=cfg.mode))(params)
    return float(loss), np_tree(jax.tree.map(lambda p, gg: p - lr * gg, params, g))


# ---------------------------------------------------------------------------
# the inputs every rank gets, and what each rank runs


def scenario_inputs(tmp):
    rng = np.random.default_rng(215)
    small = NeRFConfig.small()
    narrow4 = NeRFConfig(num_layers=4, filter_size=32, num_samples=8)
    eight = NeRFConfig(num_samples=8)
    tiny = NeRFConfig(num_layers=2, filter_size=8, num_samples=4)
    from lomanerf_tpu.data import sphere_poses
    from lomanerf_tpu.models import NeRFModel as JModel

    return {
        "tmp": str(tmp),
        # test_parallel.py:42: small, dp=8 there, 32 rays, SGD 1e-3
        "dp": {"cfg": cfg_kw(small), "batch": ray_batch(rng, 32, small),
               "params": np_tree(init_mlp(jax.random.PRNGKey(0), small.in_channels, 4,
                                          small.num_layers, small.filter_size))},
        # :69 and :109: the TP forward, tp=4 / 4 layers and tp=2 / 3 layers
        "tp4": {"params": np_tree(init_mlp(jax.random.PRNGKey(1), 33, 4, 4, 32)),
                "x": rng.standard_normal((16, 33)).astype(np.float32)},
        "tp_odd": {"params": np_tree(init_mlp(jax.random.PRNGKey(2), 33, 4, 3, 30)),
                   "x": rng.standard_normal((8, 33)).astype(np.float32)},
        # :129: the fused step, 64 rays, 3x30 at S = 8
        "fused": {"cfg": cfg_kw(eight), "batch": ray_batch(rng, 64, eight),
                  "params": np_tree(init_mlp(jax.random.PRNGKey(4), eight.in_channels, 4,
                                             eight.num_layers, eight.filter_size))},
        # :172: a 16x16 frame at chunk 32, and 37 ragged rays at chunk 2
        "render": {"cfg": cfg_kw(tiny),
                   "params": np_tree(JModel(tiny, backend="jnp").init(jax.random.PRNGKey(7))),
                   "K": np.asarray(normalized_intrinsics(1.1)),
                   "pose": np.asarray(sphere_poses(1, radius=4.0)[0], np.float32),
                   "o": rng.standard_normal((37, 3)).astype(np.float32),
                   "d": rng.standard_normal((37, 3)).astype(np.float32)},
        # :211: the render through the fused path, 64 rays at chunk 8
        "render_fused": {"cfg": cfg_kw(eight),
                         "params": np_tree(init_mlp(jax.random.PRNGKey(9), eight.in_channels,
                                                    4, eight.num_layers, eight.filter_size)),
                         "o": rng.standard_normal((64, 3)).astype(np.float32),
                         "d": rng.standard_normal((64, 3)).astype(np.float32)},
        # :241 and :263: the batch helpers on 16 rays
        "batch": ray_batch(rng, 16, eight),
        # :298 and :334, and F7: dp=2 x tp=2, 4x32 at S = 8, 16 rays
        "tp_train": {"cfg": cfg_kw(narrow4), "batch": ray_batch(rng, 16, narrow4),
                     "params": np_tree(init_mlp(jax.random.PRNGKey(3), narrow4.in_channels,
                                                4, 4, 32)),
                     "grads": [rng.standard_normal(x.shape).astype(np.float32) for x in
                               leaves(np_tree(init_mlp(jax.random.PRNGKey(3),
                                                       narrow4.in_channels, 4, 4, 32)))]},
    }


def _params(p):
    return {k: [torch.nn.Parameter(torch.tensor(x)) for x in p[k]] for k in ("w", "b")}


def _batch(b):
    return tpar.RayBatch(*(torch.tensor(x) for x in b))


def _numpy(params):
    return [x.detach().numpy().copy() for x in leaves(params)]


def _train(inp, dp, tp, backend, opt, lr, steps):
    cfg = TConfig(**inp["cfg"])
    mesh = tpar.make_mesh(dp=dp, tp=tp)
    params = _params(inp["params"])
    optimizer = {"sgd": torch.optim.SGD, "adam": torch.optim.Adam}[opt](leaves(params), lr=lr)
    params = tpar.place_state(mesh, cfg, params, optimizer, tp=tp > 1)
    step = tpar.make_train_step(cfg, optimizer, mesh, tp=tp > 1, backend=backend)
    batch = tpar.shard_batch(mesh, _batch(inp["batch"]))
    losses = [float(step(params, batch)) for _ in range(steps)]
    full, _ = tpar.gather_state(mesh, cfg, params, None, tp=tp > 1)
    return {"losses": losses, "params": _numpy(full)}


def _tp_forward(inp, dp, tp):
    mesh = tpar.make_mesh(dp=dp, tp=tp)
    L = len(inp["params"]["w"])
    full = {k: [torch.tensor(x) for x in inp["params"][k]] for k in ("w", "b")}
    local = tpar.shard_tp_params(full, L, tp, mesh.model_index)
    back = tpar.unshard_tp_params(local, L, mesh.model_group)
    out = tpar.tp_mlp_apply(local, torch.tensor(inp["x"]), head="rgba", group=mesh.model_group)
    return {"out": out.detach().numpy(),
            "reassembled": all(torch.equal(a, b) for a, b in zip(leaves(back), leaves(full)))}


def _render(inp):
    from lomanerf_tpu_torch.models import NeRFModel

    cfg = TConfig(**inp["cfg"])
    mesh = tpar.make_mesh()
    model = NeRFModel.from_numpy(cfg, inp["params"]["w"], inp["params"]["b"], device="cpu")
    with torch.no_grad():
        single = model.render_image(inp["K"], inp["pose"], 16, chunk=32)
        sharded = model.render_image(inp["K"], inp["pose"], 16, chunk=32, mesh=mesh)
    oc, dc, n = tpar.shard_ray_chunks(mesh, inp["o"], inp["d"], chunk=2)
    cols = tpar.make_render_step(cfg, mesh)(model.params, oc, dc)
    return {"single": single.numpy(), "sharded": sharded.numpy(), "n": n,
            "chunks": tuple(oc.shape), "cols": cols.numpy()}


def _render_fused(inp):
    cfg = TConfig(**inp["cfg"])
    mesh = tpar.make_mesh()
    params = _params(inp["params"])
    oc, dc, n = tpar.shard_ray_chunks(mesh, inp["o"], inp["d"], chunk=8)
    return {"n": n, "cols": tpar.make_render_step(cfg, mesh)(params, oc, dc).numpy()}


def _batch_helpers(b):
    mesh = tpar.make_mesh()
    glob = _batch(b)
    local = tpar.shard_batch(mesh, glob)
    same = tpar.host_local_batch_to_global(mesh, local)
    back = tpar.gather_global_batch(mesh, same)
    try:
        tpar.shard_batch(mesh, tpar.RayBatch(*(x[:15] if x.ndim > 1 else x for x in glob)))
        ragged = "no error"
    except ValueError as e:
        ragged = str(e)
    try:
        tpar.host_local_batch_to_global(mesh, local._replace(target=local.target[:1]))
        mixed = "no error"
    except ValueError as e:
        mixed = str(e)
    return {"local": [x.numpy() for x in local], "identity": all(a is c for a, c in
                                                                 zip(local, same)),
            "global": [x.numpy() for x in back], "ragged": ragged, "mixed": mixed}


def _logger(tmp):
    from lomanerf_tpu_torch.train.logging_utils import MetricsLogger

    d = os.path.join(tmp, f"rank{tpar.process_index()}")
    log = MetricsLogger(d)
    log.log(0, loss=1.0)
    log.close()
    return {"wrote": os.path.exists(os.path.join(d, "metrics.jsonl"))}


def _place_state(inp, opt_name):
    """place_state under dp=2 x tp=2 with real optimizer state, then
    gather_state back, then 3 steps."""
    import copy

    from lomanerf_tpu_torch.train.optim import LomaAdam

    cfg = TConfig(**inp["cfg"])
    mesh = tpar.make_mesh(dp=2, tp=2)
    params = _params(inp["params"])
    opt = {"adam": torch.optim.Adam, "loma_adam": LomaAdam}[opt_name](leaves(params), lr=5e-3)
    for p, g in zip(leaves(params), inp["grads"]):
        p.grad = torch.tensor(g)
    opt.step()
    ref = {k: [x.detach().clone() for x in params[k]] for k in ("w", "b")}
    ref_sd = copy.deepcopy(opt.state_dict())
    if mesh.data_index:  # only the data group's first rank holds the state
        with torch.no_grad():
            for p in leaves(params):
                p.add_(1000.0)
                for v in opt.state[p].values():
                    if torch.is_tensor(v) and v.ndim:
                        v.add_(7.0)
    local = tpar.place_state(mesh, cfg, params, opt, tp=True)
    want = tpar.shard_tp_params(ref, cfg.num_layers, 2, mesh.model_index)
    sharded = all(torch.equal(a, b) for a, b in zip(leaves(local), leaves(want)))
    rebound = [p for g in opt.param_groups for p in g["params"]] == leaves(local)
    specs = leaves(tpar.tp_param_specs(cfg.num_layers))
    state_sharded = True
    for i, (p, dim) in enumerate(zip(leaves(local), specs)):
        for k, v in opt.state[p].items():
            r = ref_sd["state"][i][k]
            if torch.is_tensor(v) and v.ndim:
                r = r if dim is None else r.narrow(dim, mesh.model_index * v.shape[dim],
                                                   v.shape[dim])
                state_sharded &= torch.equal(v, r)
            else:
                state_sharded &= (v == r) if not torch.is_tensor(v) else torch.equal(v, r)
    full, sd = tpar.gather_state(mesh, cfg, local, opt, tp=True)
    gathered = all(torch.equal(a, b) for a, b in zip(leaves(full), leaves(ref)))
    for i, st in sd["state"].items():
        for k, v in st.items():
            r = ref_sd["state"][i][k]
            gathered &= torch.equal(v, r) if torch.is_tensor(v) else v == r
    step = tpar.make_train_step(cfg, opt, mesh, tp=True, backend="plain")
    batch = tpar.shard_batch(mesh, _batch(inp["batch"]))
    losses = [float(step(local, batch)) for _ in range(3)]
    return {"sharded": sharded, "rebound": rebound, "state_sharded": bool(state_sharded),
            "gathered": bool(gathered), "losses": losses}


def _f5(n, chunk, dp, tp):
    mesh = tpar.make_mesh(dp=dp, tp=tp)
    o = torch.arange(1, n + 1, dtype=torch.float32)[:, None].repeat(1, 3)
    oc, _, got = tpar.shard_ray_chunks(mesh, o, o, chunk)
    rows = oc.reshape(-1, 3)[:, 0]
    return {"n": got, "chunk": oc.shape[1], "real": int((rows > 0).sum()),
            "first": float(rows[0])}


def _rank_scenarios(inp):
    """Every in-suite scenario on this rank, each result (or its traceback)
    under its name.  All ranks run them in the same order: each makes its
    own mesh (a collective)."""
    torch.manual_seed(0)
    out = {}
    runs = {
        "dp_step": lambda: _train(inp["dp"], 4, 1, "plain", "sgd", 1e-3, 1),
        "tp4": lambda: _tp_forward(inp["tp4"], 1, 4),
        "tp_odd": lambda: _tp_forward(inp["tp_odd"], 2, 2),
        "fused": lambda: _train(inp["fused"], 4, 1, "auto", "sgd", 1e-3, 1),
        "render": lambda: _render(inp["render"]),
        "render_fused": lambda: _render_fused(inp["render_fused"]),
        "batch": lambda: _batch_helpers(inp["batch"]),
        "logger": lambda: _logger(inp["tmp"]),
        "place_adam": lambda: _place_state(inp["tp_train"], "adam"),
        "place_loma_adam": lambda: _place_state(inp["tp_train"], "loma_adam"),
        "dp_tp": lambda: _train(inp["tp_train"], 2, 2, "plain", "adam", 5e-3, 5),
        "f7": lambda: _train(inp["tp_train"], 2, 2, "plain", "sgd", 1e-3, 1),
        "f7_tp4": lambda: _train(inp["tp_train"], 1, 4, "plain", "sgd", 1e-3, 1),
        "f5": lambda: _f5(4096, 4096, 2, 2),
        "f5_ragged": lambda: _f5(37, 2, 4, 1),
    }
    for name, fn in runs.items():
        try:
            out[name] = fn()
        except Exception:
            out[name] = {"error": traceback.format_exc()}
    return out


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return scenario_inputs(tmp_path_factory.mktemp("ranks"))


@pytest.fixture(scope="module")
def ranks(inputs):
    """The scenarios' results, one dict per rank (one spawn of four)."""
    return tpar.run_ranks(_rank_scenarios, WORLD, inputs, threads=1, timeout=240)


def result(ranks, name, rank=0):
    r = ranks[rank][name]
    if "error" in r:
        pytest.fail(f"rank {rank}, {name}:\n{r['error']}")
    return r


# ---------------------------------------------------------------------------
# counterparts of tests/test_parallel.py, in its order


def test_dp_train_step_matches_single_device(inputs, ranks):
    """:42 — the dp step (4 ranks here, 8 devices there) against JAX's dp=8
    mesh step and the single-device step."""
    from lomanerf_tpu.parallel import RayBatch, make_mesh, make_train_step

    inp = inputs["dp"]
    cfg = NeRFConfig.small()
    params = jax.tree.map(jnp.asarray, inp["params"])
    opt = optax.sgd(1e-3)
    mesh = make_mesh(dp=8, tp=1, axis_names=("data", "model"))
    step = make_train_step(cfg, opt, mesh, params, opt.init(params), donate=False,
                           uniform_depths=True)
    j_params, _, j_loss = step(params, opt.init(params),
                               RayBatch(*(jnp.asarray(x) for x in inp["batch"])))
    ref_loss, ref_params = sgd_reference(params, inp["batch"], cfg, 1e-3)
    got = result(ranks, "dp_step")
    for want_loss, want in ((float(j_loss), leaves(np_tree(j_params))),
                            (ref_loss, leaves(ref_params))):
        np.testing.assert_allclose(got["losses"][0], want_loss, rtol=1e-5)
        for a, b in zip(got["params"], want):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
    # every rank holds the same replica
    for r in range(1, WORLD):
        for a, b in zip(result(ranks, "dp_step", r)["params"], got["params"]):
            np.testing.assert_array_equal(a, b)


def _jax_tp_forward(params, x, tp, dp):
    from lomanerf_tpu.parallel import make_mesh, tp_mlp_apply, tp_param_specs

    mesh = make_mesh(dp=dp, tp=tp, axis_names=("data", "model"))
    fn = shard_map(lambda p, xx: tp_mlp_apply(p, xx, head="rgba"), mesh=mesh,
                   in_specs=(tp_param_specs(len(params["w"])), P()), out_specs=P(),
                   check_vma=False)
    return np.asarray(fn(params, x))


def test_tp_mlp_matches_replicated(inputs, ranks):
    """:69 — 4-layer width-32 MLP, tp=4: the sharded forward equals the
    replicated one (and JAX's shard_map forward); the shards reassemble."""
    inp = inputs["tp4"]
    params = jax.tree.map(jnp.asarray, inp["params"])
    full = np.asarray(mlp_apply(params, jnp.asarray(inp["x"]), head="rgba"))
    jtp = _jax_tp_forward(params, jnp.asarray(inp["x"]), 4, 2)
    for r in range(WORLD):
        got = result(ranks, "tp4", r)
        assert got["reassembled"]
        np.testing.assert_allclose(got["out"], full, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["out"], jtp, rtol=1e-5, atol=1e-6)


def test_tp_odd_layers_all_gather_tail(inputs, ranks):
    """:109 — 3 layers end column-parallel: the all-gather tail (tp=2 of a
    dp=2 x tp=2 mesh) still matches."""
    inp = inputs["tp_odd"]
    params = jax.tree.map(jnp.asarray, inp["params"])
    full = np.asarray(mlp_apply(params, jnp.asarray(inp["x"]), head="rgba"))
    for r in range(WORLD):
        got = result(ranks, "tp_odd", r)
        assert got["reassembled"]
        np.testing.assert_allclose(got["out"], full, rtol=1e-5, atol=1e-6)


def test_dp_fused_train_step_matches_single_device_fused(inputs, ranks):
    """:129 — the production configuration: the fused train loss per rank
    (``backend="auto"``; its plain version on the CPU), gradients summed
    over 4 ranks, against the JAX fused train kernel on one device
    (interpret mode) and the core pipeline."""
    from lomanerf_tpu.ops import fused_nerf as j_fused

    inp = inputs["fused"]
    cfg = NeRFConfig(num_samples=8)
    params = jax.tree.map(jnp.asarray, inp["params"])
    b = [jnp.asarray(x) for x in inp["batch"]]
    loss_1dev, g = jax.value_and_grad(lambda p: j_fused.nerf_train_loss(p, *b, cfg))(params)
    expect = leaves(np_tree(jax.tree.map(lambda p, gg: p - 1e-3 * gg, params, g)))
    got = result(ranks, "fused")
    np.testing.assert_allclose(got["losses"][0], float(loss_1dev), rtol=1e-5)
    for a, e in zip(got["params"], expect):
        np.testing.assert_allclose(a, e, rtol=1e-4, atol=1e-6)
    ref_loss, _ = sgd_reference(params, inp["batch"], cfg, 1e-3)
    np.testing.assert_allclose(got["losses"][0], ref_loss, rtol=1e-5)


def test_mesh_sharded_render_matches_single_device(inputs, ranks):
    """:172 — the sharded 16x16 frame equals the single-rank frame and the
    JAX one; 37 ragged rays at chunk 2 pad, render and come back in ray
    order on every rank."""
    from lomanerf_tpu.models import NeRFModel as JModel
    from lomanerf_tpu.models.nerf import render_chunk

    inp = inputs["render"]
    cfg = NeRFConfig(num_layers=2, filter_size=8, num_samples=4)
    params = jax.tree.map(jnp.asarray, inp["params"])
    j_single = np.asarray(JModel(cfg, backend="jnp").render_image(
        params, jnp.asarray(inp["K"]), jnp.asarray(inp["pose"]), img_size=16, chunk=32))
    ref = np.asarray(render_chunk(cfg, "jnp", params, jnp.asarray(inp["o"]),
                                  jnp.asarray(inp["d"])))
    for r in range(WORLD):
        got = result(ranks, "render", r)
        np.testing.assert_array_equal(got["sharded"], got["single"])
        np.testing.assert_allclose(got["sharded"], j_single, rtol=1e-6, atol=1e-6)
        assert got["n"] == 37 and got["chunks"] == (5, 2, 3)  # 40 rays: 4 ranks x 5 x 2
        np.testing.assert_allclose(got["cols"][:37], ref, rtol=1e-5, atol=1e-6)


def test_mesh_sharded_render_fused(inputs, ranks):
    """:211 — the fused render under the sharded render (its plain version
    on the CPU) against the JAX fused render kernel (interpret mode)."""
    from lomanerf_tpu.models.nerf import render_chunk

    inp = inputs["render_fused"]
    cfg = NeRFConfig(num_samples=8)
    params = jax.tree.map(jnp.asarray, inp["params"])
    ref = np.asarray(render_chunk(cfg, "pallas", params, jnp.asarray(inp["o"]),
                                  jnp.asarray(inp["d"])))
    got = result(ranks, "render_fused")
    np.testing.assert_allclose(got["cols"][:got["n"]], ref, rtol=2e-4, atol=2e-5)


def test_fused_with_tp_raises():
    """:230 — the kernels take replicated params only: TP with
    ``backend="auto"`` is refused, as JAX refuses pallas with TP."""
    cfg = TConfig(num_samples=8)
    model_params = _params(np_tree(init_mlp(jax.random.PRNGKey(5), cfg.in_channels, 4,
                                            cfg.num_layers, cfg.filter_size)))
    opt = torch.optim.SGD(leaves(model_params), lr=1e-3)
    with pytest.raises(ValueError, match="data parallelism only"):
        tpar.make_train_step(cfg, opt, tpar.make_mesh(), tp=True, backend="auto")
    tpar.make_train_step(cfg, opt, tpar.make_mesh(), tp=True, backend="plain")


def test_host_local_batch_to_global(inputs, ranks):
    """:241 — a rank's local batch is its shard: the helper returns it as
    it is, and the all-gather assembles the global batch ((S,) depths
    replicated); mismatched ray counts are refused."""
    glob = inputs["batch"]
    for r in range(WORLD):
        got = result(ranks, "batch", r)
        assert got["identity"]
        for a, b in zip(got["global"], glob):
            np.testing.assert_array_equal(a, b)
        assert "different ray counts" in got["mixed"]


def test_shard_batch_places_contiguous_rows(inputs, ranks):
    """:263 — ``shard_batch`` gives rank i the rows JAX's ``shard_batch``
    puts on device i of a dp=4 mesh; 1-D depths are replicated; a ray count
    that 4 does not divide is refused, as ``shard_map`` refuses it."""
    from lomanerf_tpu.parallel import RayBatch, make_mesh, shard_batch

    mesh = make_mesh(dp=4, tp=1, devices=jax.devices()[:4], axis_names=("data", "model"))
    placed = shard_batch(mesh, RayBatch(*(jnp.asarray(x) for x in inputs["batch"])))
    for r in range(WORLD):
        got = result(ranks, "batch", r)
        for leaf, mine in zip(placed, got["local"]):
            shard = next(s for s in leaf.addressable_shards if s.device == mesh.devices[r, 0])
            np.testing.assert_array_equal(mine, np.asarray(shard.data))
        assert "not divisible by dp=4" in got["ragged"]


def test_metrics_logger_primary_only(ranks):
    """:281 — only rank 0 writes metrics."""
    for r in range(WORLD):
        got = result(ranks, "logger", r)
        assert got == {"wrote": r == 0}


@pytest.mark.parametrize("opt", ["place_adam", "place_loma_adam"])
def test_place_state_shards_optimizer_state(ranks, opt):
    """:298 (``_mirror_spec``'s place) — ``place_state`` under dp=2 x tp=2
    with Adam and ``LomaAdam`` state: params and every param-shaped moment
    come from the data group's first rank, sliced like their param (steps
    copied); the optimizer is rebound to the shards; ``gather_state``
    returns the full state bit for bit; and the dp x tp step then runs and
    lowers the loss."""
    for r in range(WORLD):
        got = result(ranks, opt, r)
        assert got["sharded"] and got["rebound"] and got["state_sharded"] and got["gathered"]
        assert np.isfinite(got["losses"]).all() and got["losses"][-1] < got["losses"][0]


def test_dp_tp_train_step_runs_and_improves(inputs, ranks):
    """:334 — dp=2 x tp=2 Adam steps lower the loss, and follow the
    single-device optax Adam run of the core pipeline."""
    inp = inputs["tp_train"]
    cfg = NeRFConfig(num_layers=4, filter_size=32, num_samples=8)
    params = jax.tree.map(jnp.asarray, inp["params"])
    opt = optax.adam(5e-3)
    state = opt.init(params)
    b = [jnp.asarray(x) for x in inp["batch"]]
    want = []
    for _ in range(5):
        loss, g = jax.value_and_grad(lambda p: nerf_loss_rays(
            p, *b, num_functions=cfg.num_encoding_functions, mode=cfg.mode))(params)
        updates, state = opt.update(g, state, params)
        params = optax.apply_updates(params, updates)
        want.append(float(loss))
    got = result(ranks, "dp_tp")["losses"]
    assert np.isfinite(got).all() and got[-1] < got[0]
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_two_process_multihost_cpu_end_to_end(tmp_path):
    """:353 — ``lomanerf_tpu_torch/scripts/multihost_cpu_check.py``: two
    gloo ranks with disjoint ray slices reach one process's loss and
    params on the full batch, and the sharded render its colours."""
    out = tmp_path / "check.json"
    r = subprocess.run([sys.executable, "-m", "lomanerf_tpu_torch.scripts.multihost_cpu_check",
                        "--out", str(out)], capture_output=True, text=True, timeout=240,
                       cwd=ROOT, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "2-process check PASSED" in r.stdout
    got = json.loads(out.read_text())
    assert got["processes"] == 2 and got["params_allclose"] and got["render_allclose"]
    np.testing.assert_allclose(got["loss_multiprocess"], got["loss_singleprocess"], rtol=1e-5)


# ---------------------------------------------------------------------------
# F5, F7, the import rule, the scripts, the driver


@pytest.mark.parametrize("case", ["f5", "f5_ragged"])
def test_shard_ray_chunks_caps_the_chunk(ranks, case):
    """F5: 4096 rays at chunk 4096 on a data axis of 2 give each rank 2048
    real rays (JAX pads to chunk x devices: device 0 gets all 4096); 37
    rays at chunk 2 over 4 ranks keep the chunk and pad to 40."""
    for r in range(WORLD):
        got = result(ranks, case, r)
        if case == "f5":
            d = r // 2  # data index of a dp=2 x tp=2 mesh
            assert (got["n"], got["chunk"], got["real"]) == (4096, 2048, 2048)
            assert got["first"] == 1 + 2048 * d
        else:
            assert (got["n"], got["chunk"]) == (37, 2)
            assert got["real"] == [10, 10, 10, 7][r]


@pytest.mark.parametrize("case", ["f7", "f7_tp4"])
def test_tp_gradients_equal_single_device(inputs, ranks, case):
    """F7: after one SGD step the port's dp=2 x tp=2 (and dp=1 x tp=4)
    params equal the single-device core step's on every leaf, ``b[1]``
    included (the JAX TP step's gradients are tp times too large there
    and ``b[1]`` points elsewhere)."""
    inp = inputs["tp_train"]
    cfg = NeRFConfig(num_layers=4, filter_size=32, num_samples=8)
    loss, want = sgd_reference(jax.tree.map(jnp.asarray, inp["params"]), inp["batch"], cfg,
                               1e-3)
    for r in range(WORLD):
        got = result(ranks, case, r)
        np.testing.assert_allclose(got["losses"][0], loss, rtol=1e-5)
        for a, b in zip(got["params"], leaves(want)):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)


def test_parallel_imports_no_jax():
    code = ("import sys, lomanerf_tpu_torch.parallel, lomanerf_tpu_torch.train.train_nerf, "
            "lomanerf_tpu_torch.scripts.scaling_bench, "
            "lomanerf_tpu_torch.scripts.multihost_cpu_check\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'lomanerf_tpu')]\n"
            "assert not bad, bad")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=120, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]


def test_scaling_bench_help_and_cpu_harness(capsys):
    """``scripts/scaling_bench.py``: ``--help``, then the weak-scaling
    harness on 1 and 2 gloo ranks at a tiny size (a harness check: the
    ranks share the host's cores)."""
    from lomanerf_tpu_torch.scripts import scaling_bench

    with pytest.raises(SystemExit) as e:
        scaling_bench.main(["--help"])
    assert e.value.code == 0 and "--rays-per-rank" in capsys.readouterr().out
    r = subprocess.run([sys.executable, "-m", "lomanerf_tpu_torch.scripts.scaling_bench",
                        "--device", "cpu", "--rays-per-rank", "32", "--inner", "1",
                        "--outer", "1"], capture_output=True, text=True, timeout=180, cwd=ROOT,
                       env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["ranks"] == 2 and out["hardware_number"] is False
    assert out["rays_per_s_1"] > 0 and out["rays_per_s_N"] > 0
    assert "harness check only" in out["note"]


def test_multihost_cpu_check_help(capsys):
    from lomanerf_tpu_torch.scripts import multihost_cpu_check

    with pytest.raises(SystemExit) as e:
        multihost_cpu_check.main(["--help"])
    assert e.value.code == 0 and "--out" in capsys.readouterr().out


def driver_flags(tmp, name):
    return ["--device", "cpu", "--data", "synthetic", "--img-size", "16",
            "--rays-per-batch", "64", "--samples", "8", "--width", "16",
            "--eval-every", "5", "--ckpt-every", "0",
            "--log-dir", os.path.join(tmp, name, "logs"),
            "--ckpt-dir", os.path.join(tmp, name, "ck")]


def test_train_nerf_one_rank_group_is_bit_identical(tmp_path):
    """The driver with no distributed environment and the same run in a
    one-rank gloo group give the same losses and params, bit for bit."""
    threads = torch.get_num_threads()
    try:
        torch.set_num_threads(2)
        alone = train_nerf.main([*driver_flags(str(tmp_path), "alone"), "--steps", "12"])
    finally:
        torch.set_num_threads(threads)
    grouped = tpar.run_ranks(train_nerf.main, 1,
                             [*driver_flags(str(tmp_path), "group"), "--steps", "12"],
                             threads=2)[0]
    assert [x.hex() for x in alone["losses"]] == [x.hex() for x in grouped["losses"]]
    a, b = (torch.load(os.path.join(tmp_path, name, "ck", "ckpt_12.pt"), weights_only=True)
            for name in ("alone", "group"))
    for x, y in zip(leaves(a["params"]), leaves(b["params"])):
        assert torch.equal(x, y)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _two_ranks(*runs, timeout=180):
    """Run ``train_nerf`` runs side by side, each as two processes joined
    by a ``--coordinator`` of its own; ``runs`` are ``(argv of rank 0,
    argv of rank 1)`` pairs.  Returns every process's output in order."""
    procs = []
    for argvs in runs:
        coord = f"127.0.0.1:{_free_port()}"
        for rank, argv in enumerate(argvs):
            env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2", OMP_NUM_THREADS="1")
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "lomanerf_tpu_torch.train.train_nerf", *argv,
                 "--coordinator", coord], env=env, cwd=ROOT, text=True,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    outs = []
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return outs


def test_train_nerf_two_ranks_coordinator(tmp_path):
    """Two gloo ranks of ``train_nerf --coordinator``: rank 0 alone prints
    and writes ``metrics.jsonl``, PNGs and checkpoints (each rank is given
    its own directories to show it); ``--resume`` from rank 0's checkpoint
    continues; and with ``--tp 2 --backend plain`` the checkpoint holds the
    full params, as one process's would."""
    t = str(tmp_path)
    f0, f1 = driver_flags(t, "r0"), driver_flags(t, "r1")
    ftp = [*driver_flags(t, "tp"), "--steps", "3", "--tp", "2", "--backend", "plain"]
    out0, out1, _, _ = _two_ranks([[*f0, "--steps", "11"], [*f1, "--steps", "11"]],
                                  [ftp, ftp])
    assert "step 10 loss" in out0 and "step" not in out1
    rows = [json.loads(x) for x in open(os.path.join(t, "r0", "logs", "metrics.jsonl"))]
    assert [r["step"] for r in rows] == [0, 5, 10]
    assert os.path.exists(os.path.join(t, "r0", "logs", "10.png"))
    assert not os.path.exists(os.path.join(t, "r1", "logs"))
    assert CheckpointManager(os.path.join(t, "r0", "ck")).latest_step() == 11
    assert CheckpointManager(os.path.join(t, "r1", "ck")).latest_step() is None
    # resume both ranks from rank 0's checkpoint
    ck0 = os.path.join(t, "r0", "ck")
    out0, _ = _two_ranks([[*f0, "--steps", "14", "--resume"],
                          [*f1[:-1], ck0, "--steps", "14", "--resume"]])
    assert "resumed from step 11" in out0
    assert CheckpointManager(ck0).latest_step() == 14
    # tensor parallel: the checkpoint is the full model's
    state = torch.load(os.path.join(t, "tp", "ck", "ckpt_3.pt"), weights_only=True)
    assert [tuple(w.shape) for w in state["params"]["w"]] == [(33, 16), (16, 16), (16, 4)]
    assert all(v["exp_avg"].shape == w.shape for v, w in
               zip(state["optimizer"]["state"].values(), leaves(state["params"])))


def test_make_video_orbit_on_two_ranks(tmp_path):
    """``make_video`` in a two-rank group: each frame's rays sharded over
    the ranks, rank 0 alone writes, and the frames equal one process's."""
    from lomanerf_tpu_torch.train import make_video

    def argv(name):
        return ["--params", os.path.join(ROOT, "tests", "data", "convergence_64_step5000.npz"),
                "--preset", "small", "--orbit", "2", "--img-size", "16", "--device", "cpu",
                "--out", str(tmp_path / name / "orbit.gif")]

    os.makedirs(tmp_path / "alone")
    os.makedirs(tmp_path / "ranks")
    alone = make_video.main(argv("alone"))
    wrote = tpar.run_ranks(make_video.main, 2, argv("ranks"), threads=1)
    assert wrote[1] is None and os.path.basename(wrote[0]) == os.path.basename(alone)

    def frames(path):
        if os.path.isdir(path):
            return make_video.read_frames(path)
        import imageio.v2 as imageio

        return np.stack(imageio.mimread(path))

    np.testing.assert_array_equal(frames(wrote[0]), frames(alone))
