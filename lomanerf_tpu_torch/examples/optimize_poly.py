"""Newton's method on a polynomial via DSL derivatives (port of
``examples/optimize_poly.py``).

Minimises f(x) = x^4 - 3x^3 + 2 from x = 3 with the first derivative from
``fwd_diff`` (checked against ``rev_diff``) and the second from the
rev-over-fwd composition (the reference's third_order_poly_hess.py:23-45
pattern).

Run: ``python -m lomanerf_tpu_torch.examples.optimize_poly [--device cpu]``
"""

from __future__ import annotations

import argparse

import numpy as np

from lomanerf_tpu_torch import dsl

CODE = """
def poly(x : In[float]) -> float:
    return x * x * x * x - 3.0 * x * x * x + 2.0

d_poly = fwd_diff(poly)
grad_poly = rev_diff(poly)
hess_poly = rev_diff(d_poly)
"""


def main(argv=None) -> dict:
    """Returns the iterates ``x`` and ``f'``, ``f''`` at each."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=12)
    args = ap.parse_args(argv)
    _, lib = dsl.compile(CODE, device=args.device)

    def df(x):  # forward mode: seed dval = 1
        return lib.d_poly(dsl.make__dfloat(x, 1.0))["dval"]

    def df_rev(x):
        return float(lib.grad_poly(float(x), np.zeros((), np.float32), 1.0)["x"])

    def d2f(x):  # rev over fwd: the dual return's dval cotangent extracts f''
        dxd = {"val": np.zeros((), np.float32), "dval": np.zeros((), np.float32)}
        adj = lib.hess_poly(dsl.make__dfloat(x, 1.0), dxd, {"val": 0.0, "dval": 1.0})
        return float(adj["x"]["val"])

    x, out = 3.0, {"x": [], "df": [], "d2f": []}
    for it in range(args.steps):
        g, h = df(x), d2f(x)
        if not np.isclose(g, df_rev(x), rtol=1e-3, atol=1e-4):
            raise AssertionError(f"fwd {g} and rev {df_rev(x)} derivatives differ at {x}")
        for k, v in (("x", x), ("df", g), ("d2f", h)):
            out[k].append(v)
        step = g / h
        x -= step
        print(f"iter {it}: x={x:.6f} f={lib.poly(float(x)):.6f} f'={g:.5f} f''={h:.5f}")
        if abs(step) < 1e-6:
            break
    out["x_final"] = x
    print("x =", x, "(the analytic minimum is 9/4)")
    return out


if __name__ == "__main__":
    main()
