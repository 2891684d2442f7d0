"""Single-pendulum simulation driven by forward-mode DSL derivatives (port
of ``examples/single_pendulum.py``).

The Hamiltonian is a DSL function over a struct config; its partials dH/dq
and dH/dp are DSL functions that build ``Diff[...]`` duals
(struct-of-duals) and call the ``fwd_diff`` function from DSL code; the
host integrates with symplectic Euler and, where matplotlib is installed,
plots the trajectory.

Run: ``python -m lomanerf_tpu_torch.examples.single_pendulum [--device cpu]``
"""

from __future__ import annotations

import argparse
import math

import numpy as np

from lomanerf_tpu_torch import dsl

CODE = """
class PendulumConfig:
    mass : float
    radius : float
    g : float

def hamiltonian(q : In[float], p : In[float],
                c : In[PendulumConfig]) -> float:
    K : float = p * p / (c.mass * c.radius * c.radius)
    U : float = c.mass * c.g * (0.0 - c.radius * cos(q))
    return K + U

d_hamiltonian = fwd_diff(hamiltonian)

def dHdq(q : In[float], p : In[float], c : In[PendulumConfig]) -> float:
    d_q : Diff[float]
    d_q.val = q
    d_q.dval = 1.0
    d_p : Diff[float]
    d_p.val = p
    d_c : Diff[PendulumConfig]
    d_c.mass.val = c.mass
    d_c.radius.val = c.radius
    d_c.g.val = c.g
    return d_hamiltonian(d_q, d_p, d_c).dval

def dHdp(q : In[float], p : In[float], c : In[PendulumConfig]) -> float:
    d_q : Diff[float]
    d_q.val = q
    d_p : Diff[float]
    d_p.val = p
    d_p.dval = 1.0
    d_c : Diff[PendulumConfig]
    d_c.mass.val = c.mass
    d_c.radius.val = c.radius
    d_c.g.val = c.g
    return d_hamiltonian(d_q, d_p, d_c).dval
"""


def main(argv=None) -> dict:
    """Returns the trajectory ``q`` and the step ``ts``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--out", default=None, help="trajectory plot (needs matplotlib)")
    args = ap.parse_args(argv)
    _, lib = dsl.compile(CODE, device=args.device)
    cfg = {"mass": 1.0, "radius": 20.0, "g": 9.8}
    q, p, ts = math.pi / 4, 0.0, 0.01
    traj = []
    for _ in range(args.steps):
        # symplectic Euler: advance p with dH/dq, then q with dH/dp(new p)
        p = p - ts * lib.dHdq(q, p, cfg)
        q = q + ts * lib.dHdp(q, p, cfg)
        traj.append(q)
    traj = np.asarray(traj)
    print(f"q range over {args.steps} steps: [{traj.min():.4f}, {traj.max():.4f}]")
    if abs(traj).max() > math.pi / 4 + 0.05:
        raise AssertionError("pendulum diverged")
    if args.out:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.plot(np.arange(args.steps) * ts, traj)
        plt.xlabel("t [s]")
        plt.ylabel("q [rad]")
        plt.title("single pendulum (DSL fwd-diff Hamiltonian partials)")
        plt.savefig(args.out, dpi=80)
        print("wrote", args.out)
    return {"q": traj, "ts": ts}


if __name__ == "__main__":
    main()
