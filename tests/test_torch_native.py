"""The port's ray-batch pipeline (``lomanerf_tpu_torch.data.native``): its
C++ prefetcher (built here with g++) and numpy twin against the JAX
package's ``RayBatchPipeline``, the faults of the reference it does not
copy (F8 batch order, F9 non-square images, F10 per-rank seeds, F11 silent
fallback), ``train_nerf --pipeline``, and the port's imports.
"""

import ast
import dataclasses
import os
import tempfile

import numpy as np
import pytest
import torch

from lomanerf_tpu.data.native import RayBatchPipeline as JaxPipeline
from lomanerf_tpu_torch.data import native
from lomanerf_tpu_torch.data.native import RayBatchPipeline, load_native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-6, 1e-7  # the JAX test's native-vs-numpy bound: f32 C++ vs partly f64 numpy


def _toy_dataset(rng, v=3, size=8):
    poses = np.tile(np.eye(4, dtype=np.float32), (v, 1, 1))
    for i in range(v):
        th = 2 * np.pi * i / v
        poses[i, :3, :3] = np.array(
            [[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0],
             [0, 0, 1]], np.float32,
        )
        poses[i, :3, 3] = [np.cos(th) * 4, np.sin(th) * 4, 0.5]
    images = rng.random((v, size, size, 3)).astype(np.float32)
    return poses, images


def _np(batch):
    return [x.numpy() for x in batch]


# ---- the JAX package's three tests, on the port ----


def test_numpy_fallback_batches(rng):
    poses, images = _toy_dataset(rng)
    pipe = RayBatchPipeline(poses, images, focal=1.2, n_rays=32, num_samples=8, near=2.0,
                            far=6.0, seed=7, force_numpy=True, device="cpu")
    o, d, toff, tgt = _np(pipe.next_batch())
    assert o.shape == (32, 3) and toff.shape == (32,)
    # unjittered: zero offsets; static depth comb with the 1e8 sentinel
    np.testing.assert_array_equal(toff, 0.0)
    assert pipe.t_base.shape == (8,) and pipe.dists.shape == (8,)
    np.testing.assert_allclose(pipe.t_base.numpy(), np.linspace(2.0, 6.0, 8), rtol=1e-6)
    np.testing.assert_allclose(pipe.dists[:-1].numpy(), 4.0 / 7, rtol=1e-6)
    assert pipe.dists[-1] == 1e8
    # all origins equal (one view per batch) and match some pose translation
    assert np.allclose(o, o[0])
    assert any(np.allclose(o[0], poses[i, :3, 3]) for i in range(3))
    # targets are real pixels from the chosen view's image
    assert tgt.min() >= 0 and tgt.max() <= 1


def test_native_matches_numpy(rng):
    poses, images = _toy_dataset(rng)
    kw = dict(focal=1.2, n_rays=64, num_samples=10, near=2.0, far=6.0, seed=42,
              queue_depth=2, stratified=True, device="cpu")
    nat = RayBatchPipeline(poses, images, n_threads=1, **kw)
    ref = RayBatchPipeline(poses, images, force_numpy=True, **kw)
    assert nat.is_native and not ref.is_native
    np.testing.assert_allclose(nat.t_base.numpy(), ref.t_base.numpy(), rtol=1e-7)
    np.testing.assert_allclose(nat.dists.numpy(), ref.dists.numpy(), rtol=1e-7)
    for _ in range(3):
        for g, w in zip(_np(nat.next_batch()), _np(ref.next_batch())):
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    nat.close()


def test_native_stratified_and_throughput(rng):
    poses, images = _toy_dataset(rng)
    S = 32
    pipe = RayBatchPipeline(poses, images, focal=1.2, n_rays=4096, num_samples=S, near=2.0,
                            far=6.0, seed=1, stratified=True, n_threads=4, queue_depth=4,
                            device="cpu")
    bin_w = 4.0 / S
    toff_prev = None
    for _ in range(8):
        o, d, toff, tgt = _np(pipe.next_batch())
        assert np.isfinite(o).all() and np.isfinite(toff).all()
        # offsets land within one stratum width
        assert (toff >= 0).all() and (toff <= bin_w + 1e-6).all()
        assert np.unique(toff).size > 1
        if toff_prev is not None:
            assert not np.array_equal(toff, toff_prev)
        toff_prev = toff
    pipe.close()


# ---- the port against the JAX package ----


@pytest.mark.parametrize("stratified", [False, True])
def test_batches_match_the_jax_pipeline(rng, stratified):
    """The port's native and numpy batches against JAX's (its C++ at one
    thread, its numpy twin), same seed: 3 batches and the depth comb."""
    poses, images = _toy_dataset(rng)
    kw = dict(focal=1.2, n_rays=96, num_samples=12, near=2.0, far=6.0, seed=9,
              stratified=stratified)
    jax_native = JaxPipeline(poses, images, n_threads=1, **kw)
    assert jax_native.is_native, "the JAX package's C++ did not build"
    pipes = {"native": (RayBatchPipeline(poses, images, n_threads=1, device="cpu", **kw),
                        jax_native),
             "numpy": (RayBatchPipeline(poses, images, force_numpy=True, device="cpu", **kw),
                       JaxPipeline(poses, images, force_numpy=True, **kw))}
    for name, (port, jax) in pipes.items():
        np.testing.assert_allclose(port.t_base.numpy(), jax.t_base, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(port.dists.numpy(), jax.dists, rtol=RTOL, atol=ATOL)
        for i in range(3):
            for g, w, what in zip(_np(port.next_batch()), jax.next_batch(),
                                  ("origins", "dirs", "t_offsets", "targets")):
                np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                           err_msg=f"{name} batch {i} {what}")
        port.close()
        jax.close()


def test_batches_arrive_in_order_under_threads(rng):
    """F8: the JAX package's C++ hands batches out in the order its workers
    finish them, so at 4 threads some arrive out of order.  The port's
    native batches at ``n_threads=4, queue_depth=4`` (a consumer that does
    nothing else) are bit-identical to its batches at one thread over 200
    batches, and equal its numpy batches batch for batch.  At these sizes
    (65,536 rays a batch, gathered from 256x256 images) the JAX package's
    C++ delivered 2-64 of the 200 batches out of order in each of 10 runs
    through this binding."""
    poses, images = _toy_dataset(rng, size=256)
    kw = dict(focal=1.2, n_rays=65536, num_samples=16, near=2.0, far=6.0, seed=3,
              stratified=True, device="cpu")
    four = RayBatchPipeline(poses, images, n_threads=4, queue_depth=4, **kw)
    one = RayBatchPipeline(poses, images, n_threads=1, **kw)
    ref = RayBatchPipeline(poses, images, force_numpy=True, **kw)
    got = [_np(four.next_batch()) for _ in range(200)]
    for i, batch in enumerate(got):
        for g, w, r in zip(batch, _np(one.next_batch()), _np(ref.next_batch())):
            np.testing.assert_array_equal(g, w, err_msg=f"batch {i}")
            np.testing.assert_allclose(g, r, rtol=RTOL, atol=ATOL, err_msg=f"batch {i}")
    for p in (four, one):
        p.close()


@pytest.mark.parametrize("force_numpy", [False, True])
def test_non_square_images_are_refused(rng, force_numpy):
    """F9: the pixel index is drawn over width x width, so an H != W image
    would be read past its end (H < W) or never below row W (H > W)."""
    poses, _ = _toy_dataset(rng)
    for shape in ((3, 6, 8, 3), (3, 8, 6, 3)):
        with pytest.raises(ValueError, match="square"):
            RayBatchPipeline(poses, np.zeros(shape, np.float32), 1.2, 16, 8, 2.0, 6.0,
                             force_numpy=force_numpy, device="cpu")


@pytest.mark.parametrize("cxx", ["/nonexistent/g++", "false"])
def test_a_failed_build_raises(rng, monkeypatch, tmp_path, cxx):
    """F11: no quiet fallback to numpy when the library cannot be built (a
    missing compiler, or one that fails); the error names the command."""
    poses, images = _toy_dataset(rng)
    monkeypatch.setattr(native, "CXX", cxx)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path)
    with pytest.raises(RuntimeError, match="ray pipeline's build"):
        RayBatchPipeline(poses, images, 1.2, 16, 8, 2.0, 6.0, device="cpu")
    with pytest.raises(RuntimeError, match=cxx):
        load_native()
    # the numpy twin needs no build
    RayBatchPipeline(poses, images, 1.2, 16, 8, 2.0, 6.0, force_numpy=True, device="cpu")


def test_next_batch_after_close_raises(rng):
    poses, images = _toy_dataset(rng)
    pipe = RayBatchPipeline(poses, images, 1.2, 16, 8, 2.0, 6.0, device="cpu")
    pipe.next_batch()
    pipe.close()
    pipe.close()
    with pytest.raises(RuntimeError, match="after close"):
        pipe.next_batch()


def test_cuda_device_without_a_card_raises(rng, monkeypatch):
    poses, images = _toy_dataset(rng)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RayBatchPipeline(poses, images, 1.2, 16, 8, 2.0, 6.0, force_numpy=True)


# ---- train_nerf --pipeline ----

DRIVER = ["--device", "cpu", "--steps", "3", "--rays-per-batch", "64", "--img-size", "16",
          "--layers", "2", "--width", "8", "--samples", "8", "--stratified",
          "--eval-every", "100", "--ckpt-every", "0"]


def _drive(*flags):
    """3 stratified steps of ``train_nerf`` on the CPU: (losses, params)."""
    from lomanerf_tpu_torch.models import NeRFConfig, NeRFModel
    from lomanerf_tpu_torch.train import train_nerf
    from lomanerf_tpu_torch.train.checkpoint import CheckpointManager

    with tempfile.TemporaryDirectory() as tmp:
        out = train_nerf.main([*DRIVER, "--log-dir", os.path.join(tmp, "logs"),
                               "--ckpt-dir", os.path.join(tmp, "ck"), *flags])
        model = NeRFModel(NeRFConfig(num_layers=2, filter_size=8, num_samples=8), device="cpu")
        CheckpointManager(os.path.join(tmp, "ck")).restore(model)
    return out["losses"], [p.detach().clone() for p in model.parameters()]


def test_train_nerf_native_and_numpy_pipelines_agree():
    """``--pipeline native`` (at 1 and 4 threads: bit for bit) and
    ``--pipeline numpy`` train to the same params, batches equal to
    rounding (f32 C++ against partly f64 numpy)."""
    nat_loss, nat = _drive("--pipeline", "native")
    one_loss, one = _drive("--pipeline", "native", "--pipeline-threads", "1")
    np_loss, npy = _drive("--pipeline", "numpy")
    assert nat_loss == one_loss and all(torch.equal(a, b) for a, b in zip(nat, one))
    np.testing.assert_allclose(nat_loss, np_loss, rtol=1e-5)
    for a, b in zip(nat, npy):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    assert np.all(np.isfinite(nat_loss))


def test_pipeline_seed_is_the_ranks_data_seed(monkeypatch):
    """F10: each rank's pipeline is seeded with ``seed + 7919 * data
    index`` (the seed of the in-driver draw), so data-parallel ranks train
    on different rays (the JAX driver seeds every host's pipeline alike)."""
    from lomanerf_tpu_torch import parallel

    seeds = []

    class Recording(RayBatchPipeline):
        def __init__(self, *a, **kw):
            seeds.append(kw["seed"])
            super().__init__(*a, **kw)

    make_mesh = parallel.make_mesh
    monkeypatch.setattr(native, "RayBatchPipeline", Recording)
    rank0_loss, _ = _drive("--pipeline", "numpy", "--seed", "5")
    monkeypatch.setattr(parallel, "make_mesh",
                        lambda *a, **kw: dataclasses.replace(make_mesh(*a, **kw), data_index=1))
    rank1_loss, _ = _drive("--pipeline", "numpy", "--seed", "5")
    assert seeds == [5, 5 + 7919]
    assert rank0_loss[0] != rank1_loss[0]


# ---- the port's imports ----


def test_port_imports_neither_jax_nor_the_jax_package():
    """No module of ``lomanerf_tpu_torch/`` (examples included) and not
    ``chip_smoke.py`` imports ``jax`` or ``lomanerf_tpu``: the card's
    machine has no JAX, and the port keeps its own copies."""
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "lomanerf_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 50
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) and
                     not node.level else [])
            for name in names:
                if name.split(".")[0] in ("jax", "jaxlib", "lomanerf_tpu"):
                    bad.append((os.path.relpath(path, ROOT), node.lineno, name))
    assert not bad, bad
