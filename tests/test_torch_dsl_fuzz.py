"""Differential fuzzing of the port's DSL (``lomanerf_tpu_torch.dsl``)
against the JAX package's, on the generators of ``tests/test_dsl_fuzz.py``
and their seeds: 24 random scalar programs (arithmetic, bounded loops,
if/else, intrinsics) forward, 8 of them reverse, and 12 random ``@simd``
kernels, which also run on the port's own lowerer through both routes
(``torch.func.vmap`` against the threads in turn).
"""

import numpy as np
import pytest
import torch

from lomanerf_tpu import dsl as jdsl
from lomanerf_tpu_torch import dsl as tdsl
from test_dsl_fuzz import _gen_program, _gen_simd_program, _python_reference

# float32 through exp/sin/cos chains, XLA-compiled against eager PyTorch:
# the JAX fuzz test's own tolerance against plain Python floats
RTOL, ATOL = 2e-5, 2e-6


@pytest.mark.parametrize("seed", range(24))
def test_fuzz_forward_matches_jax(seed):
    source, n_args = _gen_program(seed)
    rng = np.random.default_rng(seed)
    _, tlib = tdsl.compile(source, device="cpu")
    _, jlib = jdsl.compile(source)
    for _ in range(3):
        xs = [float(v) for v in rng.uniform(-1.2, 1.2, size=n_args)]
        got = tlib.f(*xs)
        np.testing.assert_allclose(got, jlib.f(*xs), rtol=RTOL, atol=ATOL,
                                   err_msg=f"seed {seed}\n{source}")
        np.testing.assert_allclose(got, _python_reference(source, xs), rtol=RTOL, atol=ATOL,
                                   err_msg=f"seed {seed}\n{source}")


@pytest.mark.parametrize("seed", range(0, 24, 3))
def test_fuzz_rev_grad_matches_jax(seed):
    source, n_args = _gen_program(seed)
    rng = np.random.default_rng(1000 + seed)
    code = source + "\ngrad_f = rev_diff(f)\n"
    _, tlib = tdsl.compile(code, device="cpu")
    _, jlib = jdsl.compile(code)
    xs = [float(v) for v in rng.uniform(-1.0, 1.0, size=n_args)]
    grads = []
    for lib in (tlib, jlib):
        bufs = [np.zeros((), np.float32) for _ in xs]
        adj = lib.grad_f(*[v for x, b in zip(xs, bufs) for v in (x, b)], 1.0)
        grads.append(([float(np.asarray(adj[f"x{i}"])) for i in range(n_args)], bufs))
    (got, got_bufs), (want, want_bufs) = grads
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=f"seed {seed}\n{source}")
    np.testing.assert_allclose(got_bufs, want_bufs, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("seed", range(12))
def test_fuzz_simd_vmap_equals_scan_and_jax(seed):
    """Planner soundness, generatively, on the port's lowerer: for kernels
    the static analysis accepts, the ``torch.func.vmap`` route gives the
    threads-in-turn route's results (rtol 1e-6, atol 1e-6, as the JAX
    test holds its two routes), and both equal the JAX package's dispatch
    of the same kernel."""
    from lomanerf_tpu_torch.dsl import lower, parser

    source = _gen_simd_program(seed)
    _, funcs = parser.parse(source)
    low = lower.Lowerer({}, funcs, device="cpu")
    f, n = funcs["k"], 64
    rng = np.random.default_rng(seed)
    a, b = rng.random(n).astype(np.float32), rng.random(n).astype(np.float32)

    def fresh():
        return [torch.tensor(a), torch.tensor(b), torch.zeros(n), torch.zeros(4)]

    plan = low._simd_vmap_plan(f, n)
    assert plan is not None, f"planner rejected a plannable kernel:\n{source}"
    got, still = low._run_simd_vmap(f, fresh(), n, *plan)
    assert not still.any()
    want = low._run_simd_scan(f, fresh(), n)
    _, jlib = jdsl.compile(source)
    jout, jtotal = np.zeros(n, np.float32), np.zeros(4, np.float32)
    jlib.k(a, b, jout, jtotal, n)
    for name, jax_val in (("out", jout), ("total", jtotal)):
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), rtol=1e-6, atol=1e-6,
                                   err_msg=f"seed {seed} {name}\n{source}")
        np.testing.assert_allclose(got[name].numpy(), jax_val, rtol=1e-6, atol=1e-6,
                                   err_msg=f"seed {seed} {name} vs JAX\n{source}")
