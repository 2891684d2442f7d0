"""The programs of ``tests/test_dsl.py`` as one table, for the DSL parity
tests (``tests/test_torch_dsl.py``: the port against the JAX package) and
for ``chip_smoke.py`` phase 22 (the port on the card against the CPU).

Each entry of ``PROGRAMS`` is ``(code, run[, tolerance[, JAX compile
kwargs]])``: ``run(lib, dsl)`` calls the compiled library the way the
reference's convention does (the two packages share it) and returns its
results, ``Out`` buffers and gradients as a tree of numpy values; the
tolerance is ``(rtol, atol)``, ``RTOL``/``ATOL`` unless stated.  This
module imports numpy only, so that it runs where JAX is not installed.
"""

import numpy as np

RTOL, ATOL = 1e-5, 1e-6

def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from _leaves(x, f"{prefix}[{i}]")
    else:
        yield prefix, np.asarray(tree, np.float64)


def assert_trees_close(got, want, rtol=RTOL, atol=ATOL, what=""):
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert g.keys() == w.keys(), (what, g.keys(), w.keys())
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=atol, err_msg=f"{what}{k}")


def z(*shape, dtype=np.float32):
    return np.zeros(shape, dtype)


def zi():
    return np.zeros((), np.int32)


def _seeded(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).random(shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# the programs of tests/test_dsl.py: (code, run, tolerance (rtol, atol) or
# None for the default, JAX compile kwargs)
# ---------------------------------------------------------------------------

def _run_fill(lib, d):
    buf = z(4)
    lib.fill(buf, 2.0)
    return {"out": buf}


def _run_parallel_add_reduce(lib, d):
    n = 100
    x, y = _seeded(0, n), _seeded(1, n)
    zz, total = z(n), z(1)
    lib.parallel_add(x, y, zz, n)
    lib.parallel_reduce(x, total, n)
    return {"z": zz, "total": total}


def _run_rev_parallel_copy(lib, d):
    n = 10000
    dx = z()
    dz = _seeded(1234, n, scale=1.0 / n)
    lib.rev_parallel_copy(0.123, dx, z(n), dz, n)
    return {"dx": dx}


def _run_rev_parallel_add(lib, d):
    n = 10000
    x, y, dz = (_seeded(s, n, scale=1.0 / n) for s in (1, 2, 3))
    dx, dy = z(n), z(n)
    lib.rev_parallel_add(x, dx, y, dy, z(n), dz, n)
    return {"dx": dx, "dy": dy}


def _run_rev_parallel_reduce(lib, d):
    n = 10000
    x = _seeded(1234, n, scale=1.0 / n)
    dx = z(n)
    lib.rev_parallel_reduce(x, dx, z(), np.asarray(0.234, np.float32), n)
    return {"dx": dx}


def _run_fwd_parallel(lib, d):
    n = 257
    x, dx, y, dy = (_seeded(7 + s, n) for s in range(4))
    zd = {"val": z(n), "dval": z(n)}
    lib.d_parallel_mul({"val": x, "dval": dx}, {"val": y, "dval": dy}, zd, n)
    return zd


def _run_rev_if_side_effects(lib, d):
    out = {}
    for x in (2.0, 0.5):
        dx = z()
        lib.d_f(x, dx, z(), np.asarray(0.3, np.float32))
        out[str(x)] = dx
    return out


def _run_rev_struct(lib, d):
    dp = {"x": z(), "y": z()}
    dq = z()
    adj = lib.d_f({"x": 0.8, "y": -1.2}, dp, 2.0, dq, 1.0)
    return {"dp": dp, "dq": dq, "adj": adj}


def _run_untaken_branch(lib, d):
    out = {}
    for x in (-1.0, 1.0):
        dx = z()
        lib.d_f(x, dx, 1.0)
        out[str(x)] = dx
    return out


def _run_hessian(lib, d):
    dx = {"val": z(), "dval": z()}
    adj = lib.h_f(d.make__dfloat(1.7, 1.0), dx, {"val": 0.0, "dval": 1.0})
    return {"adj": adj, "dx": dx}


def _run_fallback(lib, d):
    n = 16
    x = np.arange(n, dtype=np.float32)
    zz, total = z(n), z(1)
    lib.shifted_write(x, zz, n)
    lib.running_read(total, 5)
    return {"z": zz, "total": total}


def _run_struct_slots(lib, d):
    n = 8
    out = {"a": z(n), "b": z(n)}
    lib.make_pairs(np.arange(n, dtype=np.float32), out, n)
    return out


def _run_unsized_accum(lib, d):
    n = 1000
    total = z(1)
    lib.reduce_unsized(np.arange(n, dtype=np.float32) / n, total, n)
    return {"total": total}


def _run_collision(lib, d):
    out = z(4)
    lib.k(np.arange(4, dtype=np.float32), out, 4)
    return {"out": out}


PLAN_CODE = """
@simd
def parallel_add(x : In[Array[float]], y : In[Array[float]],
                 z : Out[Array[float]]):
    i : int = thread_id()
    z[i] = x[i] + y[i]

@simd
def parallel_reduce(x : In[Array[float]], total : Out[Array[float, 1]]):
    atomic_add(total[0], x[thread_id()])

@simd
def prefix_scan_ish(z : Out[Array[float]]):
    i : int = thread_id()
    z[i] = z[i - 1] + 1.0

@simd
def racy_write(z : Out[Array[float]]):
    z[0] = int2float(thread_id())
"""

FALLBACK_CODE = """
@simd
def shifted_write(x : In[Array[float]], z : Out[Array[float]]):
    i : int = thread_id()
    i = i + 1
    z[i - 1] = x[i - 1] * 2.0

@simd
def running_read(total : Out[Array[float, 1]]):
    atomic_add(total[0], total[0] + 1.0)
"""

STRUCT_SLOTS_CODE = """
class Pair:
    a : float
    b : float

@simd
def make_pairs(x : In[Array[float]], out : Out[Array[Pair]]):
    i : int = thread_id()
    out[i].a = x[i] + 1.0
    out[i].b = x[i] * 3.0
"""

COLLISION_CODE = """
def fill(out : Out[Array[float, 2]]):
    out[0] = 7.0
    out[1] = 9.0

@simd
def k(x : In[Array[float]], out : Out[Array[float]]):
    tmp : Array[float, 2]
    fill(tmp)
    out[thread_id()] = tmp[0] + tmp[1] + x[thread_id()]
"""

TRUNCATION_CODE = """
def f(bounds : In[Array[int, 2]], x : In[float]) -> float:
    i : int = 0
    acc : float = 0.0
    while (i < bounds[0], max_iter := 4):
        acc = acc + x
        i = i + 1
    return acc
"""

PROGRAMS = {
    "basic_arithmetic": ("""
def f(x : In[float], y : In[float]) -> float:
    z : float = x * y + 2.0
    return z / (x - y)
""", lambda lib, d: {"f": lib.f(3.0, 2.0)}),
    # C semantics: int / int and % truncate toward zero
    "int_semantics_c_division": ("""
def f(x : In[int], y : In[int]) -> int:
    return x / y

def g(x : In[int], y : In[int]) -> int:
    return x % y
""", lambda lib, d: {f"{x}/{y}": (lib.f(x, y), lib.g(x, y))
                     for x, y in ((7, 2), (-7, 2), (7, -2), (-7, -2))}),
    "array_out_arg_and_mutation": ("""
def fill(out : Out[Array[float, 4]], scale : In[float]):
    i : int = 0
    while (i < 4, max_iter := 4):
        out[i] = int2float(i) * scale
        i = i + 1
""", _run_fill),
    "if_else_and_call": ("""
def relu(x : In[float]) -> float:
    y : float = 0
    if x > 0:
        y = x
    else:
        y = 0
    return y

def f(x : In[float]) -> float:
    return relu(x) + relu(0 - x)
""", lambda lib, d: {"-3": lib.f(-3.0), "2.5": lib.f(2.5)}),
    "struct_support": ("""
class Point:
    x : float
    y : float

def norm2(p : In[Point]) -> float:
    return p.x * p.x + p.y * p.y
""", lambda lib, d: {"f": lib.norm2({"x": 3.0, "y": 4.0})}),
    "forward_diff": ("""
def f(x : In[float]) -> float:
    return x * x * x + sin(x)

d_f = fwd_diff(f)
""", lambda lib, d: lib.d_f(d.make__dfloat(2.0, 1.0))),
    "reverse_diff_scalar": ("""
def f(x : In[float], y : In[float]) -> float:
    return x / y

grad_f = rev_diff(f)
""", lambda lib, d: lib.grad_f(3.0, z(), 5.0, z(), 0.7)),
    "reverse_diff_through_loop": ("""
def f(x : In[float]) -> float:
    y : float = 1.0
    i : int = 0
    while (i < 5, max_iter := 10):
        y = y * x
        i = i + 1
    return y

grad_f = rev_diff(f)
""", lambda lib, d: lib.grad_f(2.0, z(), 1.0)),
    "reverse_diff_array_adjoint_accumulates": ("""
def f(xs : In[Array[float, 3]]) -> float:
    return xs[0] * xs[1] + xs[2]

grad_f = rev_diff(f)
""", lambda lib, d: (lambda dxs: (lib.grad_f(np.array([2.0, 3.0, 4.0], np.float32), dxs,
                                             1.0), dxs)[1])(np.ones(3, np.float32))),
    "simd_parallel_add_and_atomic_reduce": ("""
@simd
def parallel_add(x : In[Array[float]], y : In[Array[float]],
                 z : Out[Array[float]]):
    i : int = thread_id()
    z[i] = x[i] + y[i]

@simd
def parallel_reduce(x : In[Array[float]], total : Out[Array[float, 1]]):
    i : int = thread_id()
    atomic_add(total[0], x[i])
""", _run_parallel_add_reduce),
    "rev_parallel_copy": ("""
@simd
def parallel_copy(x : In[float],
                  z : Out[Array[float]]):
    i : int = thread_id()
    z[i] = x

rev_parallel_copy = rev_diff(parallel_copy)
""", _run_rev_parallel_copy, (1e-4, ATOL)),  # a sum over 10,000 threads
    "rev_parallel_add": ("""
@simd
def parallel_add(x : In[Array[float]],
                 y : In[Array[float]],
                 z : Out[Array[float]]):
    i : int = thread_id()
    z[i] = x[i] + y[i]

rev_parallel_add = rev_diff(parallel_add)
""", _run_rev_parallel_add),
    "rev_parallel_reduce": ("""
@simd
def parallel_reduce(x : In[Array[float]],
                    z : Out[float]):
    i : int = thread_id()
    atomic_add(z, x[i])

rev_parallel_reduce = rev_diff(parallel_reduce)
""", _run_rev_parallel_reduce),
    "fwd_parallel_simd": ("""
@simd
def parallel_mul(x : In[Array[float]],
                 y : In[Array[float]],
                 z : Out[Array[float]]):
    i : int = thread_id()
    z[i] = x[i] * y[i]

d_parallel_mul = fwd_diff(parallel_mul)
""", _run_fwd_parallel),
    "rev_through_call_mutating_out_arg": ("""
def square_into(x : In[float], y : Out[float]):
    y = x * x

def f(x : In[float]) -> float:
    t : float = 0.0
    square_into(x + 1.0, t)
    return 3.0 * t

grad_f = rev_diff(f)
""", lambda lib, d: lib.grad_f(0.7, z(), 1.0)),
    "rev_through_nested_call_args": ("""
def cube(x : In[float]) -> float:
    return x * x * x

def scale_into(x : In[float], s : In[float], y : Out[float]):
    y = x * s

def f(x : In[float]) -> float:
    t : float = 0.0
    scale_into(cube(x) + x, 2.0, t)
    return t + cube(t)

grad_f = rev_diff(f)
""", lambda lib, d: lib.grad_f(0.6, z(), 1.0)),
    "rev_three_level_nested_loop": ("""
def f(x : In[float], n : In[int]) -> float:
    i : int = 0
    j : int = 0
    k : int = 0
    z : float = 0.0
    while (i < n, max_iter := 4):
        j = 0
        while (j < i + 1, max_iter := 4):
            k = 0
            while (k < j + 1, max_iter := 4):
                z = z + x * x
                k = k + 1
            j = j + 1
        i = i + 1
    return z

d_f = rev_diff(f)
""", lambda lib, d: (lambda dx: (lib.d_f(1.7, dx, 3, zi(), 1.0), dx)[1])(z())),
    "rev_if_with_side_effects": ("""
def f(x : In[float], y : Out[float]):
    if x > 1.0:
        y = x * x * x
    else:
        y = 5.0 * x

d_f = rev_diff(f)
""", _run_rev_if_side_effects),
    "rev_struct_adjoints": ("""
class Pt:
    x : float
    y : float

def f(p : In[Pt], q : In[float]) -> float:
    return p.x * p.y + sin(p.x) * q

d_f = rev_diff(f)
""", _run_rev_struct),
    "ifelse_untaken_branch_cannot_nan": ("""
def f(x : In[float]) -> float:
    y : float = 0.0
    if x > 0.0:
        y = sqrt(x)
    else:
        y = 1.0 / (x - 1.0) + 0.0 - x
    return y

d_f = rev_diff(f)
""", _run_untaken_branch),
    "while_skipped_iterations_cannot_nan": ("""
def f(x : In[float], n : In[int]) -> float:
    i : int = 0
    z : float = 1.0
    while (i < n, max_iter := 8):
        z = z * x / (2.0 - z)
        i = i + 1
    return z

d_f = rev_diff(f)
""", lambda lib, d: (lambda dx: (lib.d_f(2.0, dx, 1, zi(), 1.0), dx)[1])(z())),
    "auto_casts_match_reference_semantics": ("""
def f(n : In[int]) -> float:
    half : int = 2.9
    q : int = n / 2
    y : float = q
    z : float = n * 0.5
    return y + z + half
""", lambda lib, d: {"f": lib.f(7)}),
    "auto_cast_call_args": ("""
def g(a : In[float]) -> float:
    return a * 2.0

def f(n : In[int]) -> float:
    return g(n) + sin(0) * pow(2, n)
""", lambda lib, d: {"f": lib.f(3)}),
    "sized_array_passes_unbounded_arg": ("""
def total(a : In[Array[float]], n : In[int]) -> float:
    s : float = 0.0
    i : int = 0
    while (i < n, max_iter := 8):
        s = s + a[i]
        i = i + 1
    return s

def f(x : In[float]) -> float:
    buf : Array[float, 4]
    buf[0] = x
    buf[1] = 2.0
    return total(buf, 4)
""", lambda lib, d: {"f": lib.f(1.5)}),
    # a literal bound past max_iter: the JAX package extends its scan, the
    # port runs a true loop; both run all 10 iterations
    "const_bound_loop_auto_extends": ("""
def f(x : In[float]) -> float:
    i : int = 0
    acc : float = 0.0
    while (i < 10, max_iter := 5):
        acc = acc + x
        i = i + 1
    return acc
""", lambda lib, d: {"f": lib.f(2.0)}),
    "arg_bound_loop_auto_extends_at_call": ("""
def f(n : In[int], x : In[float]) -> float:
    i : int = 0
    acc : float = 0.0
    while (i < n, max_iter := 4):
        acc = acc + x
        i = i + 1
    return acc

grad_f = rev_diff(f)
""", lambda lib, d: {"3": lib.f(3, 1.5), "7": lib.f(7, 1.0),
                     "grad": lib.grad_f(7, zi(), 1.0, z(), 1.0)["x"]}),
    # a bound loopcheck cannot see (an array element): the JAX package
    # truncates it (loudly) unless compiled with enough loop_slack; the
    # port runs the loop to its end, as JAX does with loop_slack=3
    "unanalyzable_overrun_runs_to_its_end": (
        TRUNCATION_CODE,
        lambda lib, d: {"7": lib.f(np.array([7, 0], np.int32), 1.0),
                        "3": lib.f(np.array([3, 0], np.int32), 1.0)},
        None, {"loop_slack": 3}),
    "hessian_rev_over_fwd": ("""
def f(x : In[float]) -> float:
    return x * x * x - 2.0 * x

d_f = fwd_diff(f)
h_f = rev_diff(d_f)
""", _run_hessian),
    "simd_vmap_fallback_correctness": (FALLBACK_CODE, _run_fallback),
    "simd_vmap_struct_slots": (STRUCT_SLOTS_CODE, _run_struct_slots),
    "simd_unsized_accumulator_runs": ("""
@simd
def reduce_unsized(x : In[Array[float]], total : Out[Array[float]]):
    atomic_add(total[0], x[thread_id()])
""", _run_unsized_accum),
    "simd_vmap_callee_name_collision": (COLLISION_CODE, _run_collision),
}

