"""Hamiltonian gradients for a mass-spring system via DSL reverse mode
(port of ``examples/mass_spring.py``).

Symplectic Euler integration whose force comes from ``rev_diff`` of the
Hamiltonian (dH/dq).

Run: ``python -m lomanerf_tpu_torch.examples.mass_spring [--device cpu]``
"""

from __future__ import annotations

import argparse

import numpy as np

from lomanerf_tpu_torch import dsl

CODE = """
def hamiltonian(q : In[Array[float, 2]], p : In[Array[float, 2]],
                k : In[float], m : In[float]) -> float:
    # H = |p|^2 / (2m) + 0.5 k |q - rest|^2 with rest at (1, 0)
    dq0 : float = q[0] - 1.0
    dq1 : float = q[1]
    return (p[0] * p[0] + p[1] * p[1]) / (2.0 * m) + \\
        0.5 * k * (dq0 * dq0 + dq1 * dq1)

grad_h = rev_diff(hamiltonian)
"""


def main(argv=None) -> dict:
    """Returns the final ``q``, ``p``, energy ``H`` and the constants."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=500)
    args = ap.parse_args(argv)
    _, lib = dsl.compile(CODE, device=args.device)
    k, m, dt = 4.0, 1.0, 0.01
    q = np.array([1.5, 0.2], np.float32)
    p = np.zeros(2, np.float32)
    e0 = lib.hamiltonian(q, p, k, m)
    for step in range(args.steps):
        dq = np.zeros(2, np.float32)
        lib.grad_h(q, dq, p, np.zeros(2, np.float32), k, np.zeros((), np.float32), m,
                   np.zeros((), np.float32), 1.0)
        # symplectic Euler: momentum first, then position with the UPDATED
        # momentum (dH/dp = p/m for this separable H)
        p = p - dt * dq
        q = q + dt * p / m
        if step % 100 == 0:
            print(f"step {step}: q={q} H={lib.hamiltonian(q, p, k, m):.5f}")
    e1 = lib.hamiltonian(q, p, k, m)
    # symplectic Euler approximately conserves energy
    if abs(e1 - e0) / e0 >= 0.05:
        raise AssertionError(f"energy drifted: {e0} -> {e1}")
    print(f"energy drift over {args.steps} steps: {abs(e1 - e0) / e0:.3%} (H0={e0:.5f})")
    return {"q": q, "p": p, "H": e1, "k": k, "m": m, "dt": dt}


if __name__ == "__main__":
    main()
