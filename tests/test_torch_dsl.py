"""The loma DSL on PyTorch (``lomanerf_tpu_torch.dsl``) against the JAX
package's DSL (``lomanerf_tpu.dsl``).

Every program of ``tests/test_dsl.py`` (the table in
``tests/test_torch_dsl_programs.py``) runs through both packages, called
the same way (the two libraries share the reference's calling
convention): return values, ``Out`` buffers and gradients within rtol 1e-5
/ atol 1e-6 (float32 arithmetic in another order: the JAX side is
XLA-compiled, the port eager), the error programs raise the same class at
the same line, and ``_simd_vmap_plan`` gives the same sets.  The programs
that need the reference checkout skip without it, as JAX's do.  Then the
port's own rules: no bounded loop truncates (loops run to their end; a
vmapped loop that overruns its budget warns and runs again), and the five
examples against the JAX examples' functions.
"""

import importlib.util
import os
import warnings

import numpy as np
import pytest

from lomanerf_tpu import dsl as jdsl
from lomanerf_tpu_torch import dsl as tdsl
from lomanerf_tpu_torch.dsl.error import LoopBoundWarning
from test_dsl import REFERENCE  # the reference checkout the JAX tests read
from test_torch_dsl_programs import (ATOL, COLLISION_CODE, FALLBACK_CODE, PLAN_CODE, PROGRAMS,
                                     RTOL, STRUCT_SLOTS_CODE, TRUNCATION_CODE,
                                     assert_trees_close, z, zi)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def both(code, run, jax_kw=None):
    """``run(lib, dsl)`` on each package's library of ``code`` (the JAX one
    compiled with ``jax_kw``): ``(port result, JAX result)``.  The JAX
    package's loop auto-extension warnings are expected there."""
    out = []
    for d, kw in ((tdsl, {"device": "cpu"}), (jdsl, jax_kw or {})):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            _, lib = d.compile(code, **kw)
            out.append(run(lib, d))
    return out


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_program_matches_jax(name):
    code, run, *rest = PROGRAMS[name]
    tol = (rest[0] if rest else None) or (RTOL, ATOL)
    got, want = both(code, run, rest[1] if len(rest) > 1 else None)
    assert_trees_close(got, want, *tol, what=f"{name}: ")


def test_every_entry_runs_twice_alike():
    """A second call of each entry gives the first's results: nothing a
    ``torch.func`` transform made in one call (the program's literals are
    tensors made at compile time) is reused by the next."""
    for name, (code, run, *_) in sorted(PROGRAMS.items()):
        _, lib = tdsl.compile(code, device="cpu")
        with warnings.catch_warnings():
            warnings.simplefilter("error", LoopBoundWarning)
            assert_trees_close(run(lib, tdsl), run(lib, tdsl), 0.0, 0.0, what=f"{name}: ")


# ---------------------------------------------------------------------------
# the reference's own kernels (skip without the reference checkout, as JAX's do)
# ---------------------------------------------------------------------------


def _reference(*parts):
    path = os.path.join(REFERENCE, *parts)
    if not os.path.exists(path):
        pytest.skip("reference not available")
    with open(path) as f:
        return f.read()


def _mlp_fit_args(rng):
    n = 16
    sizes = [(22, 16), (16, 16), (16, 3)]
    ws_p, bs_p = np.zeros((3, 22, 16), np.float32), np.zeros((3, 16), np.float32)
    for i, s in enumerate(sizes):
        ws_p[i, : s[0], : s[1]] = rng.standard_normal(s) * 0.3
        bs_p[i, : s[1]] = rng.standard_normal(s[1]) * 0.1
    coords = rng.standard_normal((n, 22)).astype(np.float32)
    target = rng.random((n, 3)).astype(np.float32)
    shapes = (np.array(sizes, np.int32), np.array([[s[1], 1] for s in sizes], np.int32),
              np.array([[n, s[1]] for s in sizes], np.int32))
    return (coords, n, 22, np.zeros((n, 3), np.float32), ws_p, bs_p, target, n, 3, 3,
            *shapes, np.zeros((3, 16, 16), np.float32))


def _run_mlp_fit(lib, d):
    args = _mlp_fit_args(np.random.default_rng(215))
    loss = lib.mlp_fit(*[a.copy() if isinstance(a, np.ndarray) else a for a in args])
    adjs = [np.zeros_like(a) if isinstance(a, np.ndarray) else zi() for a in args]
    lib.grad_mlp_fit(*[x for pair in zip(args, adjs) for x in pair], 0.43)
    return {"loss": loss, "d_ws": adjs[4], "d_bs": adjs[5]}


def _nerf_args(rng):
    n_rays, S, rows = 2, 4, 8
    sizes = [(33, 30), (30, 30), (30, 4)]
    ws_p, bs_p = np.zeros((3, 33, 30), np.float32), np.zeros((3, 30), np.float32)
    for i, s in enumerate(sizes):
        ws_p[i, : s[0], : s[1]] = rng.standard_normal(s) * 0.3
        bs_p[i, : s[1]] = rng.standard_normal(s[1]) * 0.1
    enc = rng.standard_normal((rows, 33)).astype(np.float32)
    target = rng.random((n_rays, 3)).astype(np.float32)
    t = np.linspace(2.0, 6.0, S).astype(np.float32)
    dists = np.tile(np.concatenate([t[1:] - t[:-1], [1e8]]), (n_rays, 1)).astype(np.float32)
    return (enc, rows, 33, ws_p, bs_p, target, n_rays, 3, 3, np.array(sizes, np.int32),
            np.array([[s[1], 1] for s in sizes], np.int32),
            np.array([[rows, s[1]] for s in sizes], np.int32),
            np.zeros((3, rows, 30), np.float32), np.zeros((n_rays, S, 4), np.float32), S,
            dists, *(np.zeros((n_rays, S), np.float32) for _ in range(3)),
            np.zeros((n_rays, 3), np.float32))


def _run_nerf(lib, d):
    args = _nerf_args(np.random.default_rng(215))
    loss = lib.nerf_evaluate_and_march(*[a.copy() if isinstance(a, np.ndarray) else a
                                         for a in args])
    adjs = [np.zeros_like(a) if isinstance(a, np.ndarray) else zi() for a in args]
    lib.grad_nerf_evaluate_and_march(*[x for pair in zip(args, adjs) for x in pair], 0.37)
    return {"loss": loss, "d_enc": adjs[0], "d_ws": adjs[3], "d_bs": adjs[4]}


def _run_sum_array(lib, d):
    arr = np.random.default_rng(215).standard_normal(37).astype(np.float32)
    return {"f": lib.sum_array(arr, 37)}


def _run_pendulum(lib, d):
    c = {"mass": 1.0, "radius": 20.0, "g": 9.8}
    return {"q": lib.dHdq(0.6, 0.3, c), "p": lib.dHdp(0.6, 0.3, c)}


def _run_mult_a_b(lib, d):
    c = z(3, 1)
    lib.mult_a_b(np.array([[1, 2], [3, 4], [5, 6]], np.float32), 3, 2,
                 np.array([[100], [200]], np.float32), 2, 1, c)
    return {"c": c}


REFERENCE_PROGRAMS = {
    "mlp_fit": (("scripts", "mlp_fit.py"), _run_mlp_fit, (2e-4, 2e-5)),
    "nerf": (("scripts", "nerf.py"), _run_nerf, (3e-4, 3e-5)),
    "sum_array": (("loma_public", "examples", "loma_code", "sum_array.py"), _run_sum_array,
                  (RTOL, ATOL)),
    "pendulum_fwd": (("loma_public", "examples", "loma_code", "pendulum_fwd.py"),
                     _run_pendulum, (RTOL, ATOL)),
    "mult_a_b": (("scripts", "mlp_fit.py"), _run_mult_a_b, (RTOL, ATOL)),
}


@pytest.mark.parametrize("name", sorted(REFERENCE_PROGRAMS))
def test_reference_program_matches_jax(name):
    """The reference's unmodified kernels (the JAX side with the loop_slack
    its test passes for nerf.py's 33-iteration feature loop)."""
    parts, run, tol = REFERENCE_PROGRAMS[name]
    code = _reference(*parts)
    got, want = both(code, run, {"loop_slack": 1} if name == "nerf" else None)
    assert_trees_close(got, want, *tol, what=f"{name}: ")


# ---------------------------------------------------------------------------
# errors: the same class at the same line
# ---------------------------------------------------------------------------

ERRORS = {
    "undeclared_variable": """
def f(x : In[float]) -> float:
    return x + q
""",
    "duplicate_declare": """
def f(x : In[float]) -> float:
    y : float = 1.0
    y : float = 2.0
    return y
""",
    "declare_not_outermost": """
def f(x : In[float]) -> float:
    i : int = 0
    while (i < 3, max_iter := 3):
        y : float = 1.0
        i = i + 1
    return x
""",
    "out_call_not_stmt": """
def g(y : Out[float]):
    y = 1.0

def f(x : In[float]) -> float:
    z : float = 0
    return x + g(z)
""",
    "binop_on_array": """
def f(x : In[Array[float]]) -> float:
    y : float = 0.0
    y = x + 1.0
    return y
""",
    "subscript_non_array": """
def f(x : In[float]) -> float:
    return x[0]
""",
    "member_access_non_struct": """
def f(x : In[float]) -> float:
    return x.val
""",
    "struct_member_not_found": """
class Pt:
    x : float
    y : float

def f(p : In[Pt]) -> float:
    return p.z
""",
    "assign_struct_to_float": """
class Pt:
    x : float

def f(p : In[Pt]) -> float:
    y : float = 0.0
    y = p
    return y
""",
    "declare_array_from_float": """
def f(x : In[float]) -> float:
    a : Array[float, 3] = x
    return x
""",
    "return_type_mismatch": """
class Pt:
    x : float

def f(p : In[Pt]) -> float:
    return p
""",
    "call_arity": """
def g(a : In[float], b : In[float]) -> float:
    return a + b

def f(x : In[float]) -> float:
    return g(x)
""",
    "intrinsic_arity": """
def f(x : In[float]) -> float:
    return pow(x)
""",
    "call_array_arg_mismatch": """
def g(a : In[Array[float]]) -> float:
    return a[0]

def f(x : In[float]) -> float:
    return g(x)
""",
    "ifelse_cond_struct": """
class Pt:
    x : float

def f(p : In[Pt]) -> float:
    y : float = 0.0
    if p:
        y = 1.0
    return y
""",
}


def _raised(d, code, **kw):
    with pytest.raises(d.compiler.UserError) as ei:
        d.compile(code, **kw)
    return type(ei.value).__name__, ei.value.lineno, str(ei.value)


@pytest.mark.parametrize("name", sorted(ERRORS))
def test_error_matches_jax(name):
    got = _raised(tdsl, ERRORS[name], device="cpu")
    assert got == _raised(jdsl, ERRORS[name])


# ---------------------------------------------------------------------------
# the vmap planner, and the port's loop rules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("code,names", [
    (PLAN_CODE, ("parallel_add", "parallel_reduce", "prefix_scan_ish", "racy_write")),
    (FALLBACK_CODE, ("shifted_write", "running_read")),
    (STRUCT_SLOTS_CODE, ("make_pairs",)),
    (COLLISION_CODE, ("k",)),
])
def test_simd_vmap_plan_matches_jax(code, names):
    from lomanerf_tpu.dsl import lower as jlower
    from lomanerf_tpu.dsl import parser as jparser
    from lomanerf_tpu_torch.dsl import lower as tlower
    from lomanerf_tpu_torch.dsl import parser as tparser

    js, jf = jparser.parse(code)
    ts, tf = tparser.parse(code)
    jlow, tlow = jlower.Lowerer(js, jf), tlower.Lowerer(ts, tf)
    for name in names:
        assert tlow._simd_vmap_plan(tf[name], 64) == jlow._simd_vmap_plan(jf[name], 64), name
    if code is PLAN_CODE:  # the JAX test's expectations, held here too
        assert tlow._simd_vmap_plan(tf["parallel_add"], 1000) == (frozenset({"z"}), frozenset())
        assert tlow._simd_vmap_plan(tf["racy_write"], 1000) is None


def test_loops_outside_vmap_run_to_their_end_without_warning():
    """Outside a vmapped @simd body a bounded loop is a true loop: no
    budget, no auto-extension, no warning (max_iter sizes only loma's
    reverse tape); the gradient covers every iteration."""
    _, lib = tdsl.compile(PROGRAMS["arg_bound_loop_auto_extends_at_call"][0], device="cpu")
    _, lib2 = tdsl.compile(TRUNCATION_CODE, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert lib.f(300, 1.0) == 300.0
        assert float(lib.grad_f(300, zi(), 1.0, z(), 1.0)["x"]) == 300.0
        assert lib2.f(np.array([1000, 0], np.int32), 0.5) == 500.0


VMAP_LOOP = """
@simd
def k(n : In[Array[int]], m : In[int], w : In[Array[float]], z : Out[Array[float]]):
    i : int = thread_id()
    j : int = 0
    while (j < n[i], max_iter := 2):
        z[i] = z[i] + w[i]
        j = j + 1
    j = 0
    while (j < m, max_iter := 2):
        z[i] = z[i] + 0.5 * w[i]
        j = j + 1

grad_k = rev_diff(k)
"""


def test_vmapped_loop_overrun_warns_and_runs_every_iteration():
    """A vmapped loop's iterations are masked and budgeted: a thread whose
    condition is still true after ``max_iter + loop_slack + extension``
    makes the dispatch run again with a larger budget and a
    LoopBoundWarning, never a silent truncation.  An In[int] bound (``m``)
    is extended up front from loopcheck's trip count, also with a warning.
    Values and gradients equal the JAX package's (compiled with enough
    loop_slack)."""
    from lomanerf_tpu_torch.dsl import lower as tlower
    from lomanerf_tpu_torch.dsl import parser as tparser

    _, funcs = tparser.parse(VMAP_LOOP)
    assert tlower.Lowerer({}, funcs)._simd_vmap_plan(funcs["k"], 4) == (frozenset({"z"}),
                                                                          frozenset())
    n, w = np.array([1, 3, 9, 0], np.int32), np.array([1.0, 2.0, 0.5, 3.0], np.float32)
    _, lib = tdsl.compile(VMAP_LOOP, device="cpu")
    _, jlib = jdsl.compile(VMAP_LOOP, loop_slack=16)
    for m, overrun in ((2, "ran out of its iterations"), (5, "extending every vmapped loop by 3")):
        got, want = z(4), z(4)
        with pytest.warns(LoopBoundWarning) as rec:
            lib.k(n if m == 2 else np.minimum(n, 2), m, w, got, 4)
        assert len(rec) == 1 and overrun in str(rec[0].message)
        jlib.k(n if m == 2 else np.minimum(n, 2), m, w, want, 4)
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, w * (np.minimum(n, 2) + 2.5))
    # the gradient through the dispatch that ran again
    dw, jdw = z(4), z(4)
    with pytest.warns(LoopBoundWarning):
        lib.grad_k(n, np.zeros(4, np.int32), 2, zi(), w, dw, z(4), np.ones(4, np.float32), 4)
    jlib.grad_k(n, np.zeros(4, np.int32), 2, zi(), w, jdw, z(4), np.ones(4, np.float32), 4)
    np.testing.assert_array_equal(dw, n + 1.0)
    np.testing.assert_array_equal(dw, jdw)


def test_loopcheck_does_not_count_too_few_trips():
    """The JAX package's loopcheck underestimates two loops; the port's
    refuses them: a counter passed to a call (it may be an Out argument),
    and an inner loop whose bound the enclosing loop's body changes."""
    from lomanerf_tpu.dsl import loopcheck as jcheck
    from lomanerf_tpu.dsl import parser as jparser
    from lomanerf_tpu_torch.dsl import loopcheck as tcheck
    from lomanerf_tpu_torch.dsl import parser as tparser

    code = """
def bump(c : Out[int]):
    c = c + 5

def f(x : In[float]) -> float:
    i : int = 0
    acc : float = 0.0
    while (i < 10, max_iter := 4):
        acc = acc + x
        i = i + 1
        bump(i)
    return acc

def g(x : In[float]) -> float:
    k : int = 2
    i : int = 0
    j : int = 0
    acc : float = 0.0
    while (i < 3, max_iter := 3):
        j = 0
        while (j < k, max_iter := 8):
            acc = acc + x
            j = j + 1
        k = k + 4
        i = i + 1
    return acc
"""
    _, jf = jparser.parse(code)
    _, tf = tparser.parse(code)
    # JAX: trip counts it cannot promise (f's loop runs 2 times, not 10;
    # g's inner loop 2, 6 and 10 times, not 2)
    assert [lb.bound for lb in jcheck.analyze(jf["f"])] == [10]
    assert [(lb.bound, lb.init) for lb in jcheck.analyze(jf["g"])] == [(3, 0), (2, 0)]
    assert tcheck.analyze(tf["f"]) == []
    assert [(lb.bound, lb.init) for lb in tcheck.analyze(tf["g"])] == [(3, 0)]
    _, lib = tdsl.compile(code, device="cpu")
    assert lib.f(1.0) == 2.0 and lib.g(1.0) == 18.0


def test_compile_refuses_other_targets_and_a_missing_card(monkeypatch):
    with pytest.raises(ValueError):
        tdsl.compile("def f(x : In[float]) -> float:\n    return x\n", target="jax",
                     device="cpu")
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdsl.compile("def f(x : In[float]) -> float:\n    return x\n")


# ---------------------------------------------------------------------------
# the examples
# ---------------------------------------------------------------------------


def _jax_example(name):
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}",
                                                  os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _example_optimize_poly(port, jax_mod):
    got = port.main(["--device", "cpu", "--steps", "4"])
    _, jlib = jdsl.compile(jax_mod.CODE)
    for x, g, h in zip(got["x"], got["df"], got["d2f"]):
        assert_trees_close((g, h), (jlib.d_poly(jdsl.make__dfloat(x, 1.0))["dval"],
                                    float(np.asarray(jlib.hess_poly(
                                        jdsl.make__dfloat(x, 1.0),
                                        {"val": z(), "dval": z()},
                                        {"val": 0.0, "dval": 1.0})["x"]["val"]))),
                           rtol=1e-4, atol=1e-5)  # f'' by rev over fwd: two transforms


def _example_single_pendulum(port, jax_mod):
    got = port.main(["--device", "cpu", "--steps", "20"])
    _, jlib = jdsl.compile(jax_mod.CODE)
    cfg = {"mass": 1.0, "radius": 20.0, "g": 9.8}
    q, p, want = np.pi / 4, 0.0, []
    for _ in range(20):
        p = p - got["ts"] * jlib.dHdq(q, p, cfg)
        q = q + got["ts"] * jlib.dHdp(q, p, cfg)
        want.append(q)
    assert_trees_close(got["q"], np.asarray(want))


def _example_mass_spring(port, jax_mod):
    got = port.main(["--device", "cpu", "--steps", "20"])
    _, jlib = jdsl.compile(jax_mod.CODE)
    k, m, dt = got["k"], got["m"], got["dt"]
    q, p = np.array([1.5, 0.2], np.float32), np.zeros(2, np.float32)
    for _ in range(20):
        dq = z(2)
        jlib.grad_h(q, dq, p, z(2), k, z(), m, z(), 1.0)
        p = p - dt * dq
        q = q + dt * p / m
    assert_trees_close((got["q"], got["p"]), (q, p))
    assert_trees_close(got["H"], jlib.hamiltonian(q, p, k, m))


def _example_diff_raytrace(port, jax_mod):
    got = port.main(["--device", "cpu", "--size", "6"])
    _, jlib = jdsl.compile(jax_mod.CODE)
    sphere = got["sphere"]
    img = np.array([[jlib.intensity(sphere, float(x), float(y)) for x in np.linspace(-1, 1, 6)]
                    for y in np.linspace(-1, 1, 6)], np.float32)
    d_sph = {"center": {"x": z(), "y": z(), "z": z()}, "radius": z()}
    adj = jlib.d_intensity(sphere, d_sph, 0.45, z(), 0.0, z(), 1.0)
    assert_trees_close((got["image"], got["grad"]), (img, adj["sph"]))


def _example_ray_visualization(port, jax_mod, tmp_path):
    import jax.numpy as jnp

    from lomanerf_tpu.core import get_rays, normalized_intrinsics, sample_along_rays

    got = port.main(["--device", "cpu", "--data", "synthetic", "--img-size", "8",
                     "--out", str(tmp_path / "rayvis.png")])
    assert os.path.exists(tmp_path / "rayvis.png")
    K = normalized_intrinsics(got["focal"])
    for pose, (o, d, pts) in zip(got["poses"], got["rays"]):
        jo, jd = get_rays(8, 8, K, jnp.asarray(pose))
        sel = np.linspace(0, jo.shape[0] - 1, 9).astype(int)
        jpts, _, _ = sample_along_rays(jnp.asarray(np.asarray(jo)[sel]),
                                       jnp.asarray(np.asarray(jd)[sel]), 2.0, 6.0, 8)
        assert_trees_close((o, d, pts), (np.asarray(jo)[sel], np.asarray(jd)[sel],
                                         np.asarray(jpts)))


EXAMPLES = ("optimize_poly", "single_pendulum", "mass_spring", "diff_raytrace",
            "ray_visualization")


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_matches_the_jax_example(name, tmp_path):
    """Each port example (``python -m lomanerf_tpu_torch.examples.<name>
    --device cpu``) at a few steps, held to the JAX example's DSL functions
    (or, for ray_visualization, its core functions) on the same inputs."""
    port = importlib.import_module(f"lomanerf_tpu_torch.examples.{name}")
    jax_mod = _jax_example(name)
    check = globals()[f"_example_{name}"]
    if name == "ray_visualization":
        check(port, jax_mod, tmp_path)
    else:
        check(port, jax_mod)
