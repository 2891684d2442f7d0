"""Optimizers (port of ``lomanerf_tpu.train.optim``).

``LomaAdam`` reproduces the reference's hand-rolled AdamOptimizer EXACTLY,
including its quirk of applying bias correction twice: the step is

    lr_t = lr * sqrt(1 - b2^t) / (1 - b1^t)
    p   -= lr_t * m_hat / (sqrt(v_hat) + eps)

with m_hat = m/(1-b1^t) and v_hat = v/(1-b2^t) ALSO corrected, so the
effective correction is (1-b2^t)/(1-b1^t)^2 — not textbook Adam.  The
driver's plain ``adam`` is ``torch.optim.Adam``, the same update as
``optax.adam`` (eps outside the square root, no eps_root).

``loma_sgd`` is the 2D-fit path's raw SGD (``p -= lr * g``).
"""

from __future__ import annotations

import math

import torch


class LomaAdam(torch.optim.Optimizer):
    """The reference's double-bias-corrected Adam.  State per parameter:
    ``step`` (an int), ``m`` and ``v``."""

    def __init__(self, params, lr: float = 5e-4, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            lr, b1, b2, eps = group["lr"], group["b1"], group["b2"], group["eps"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["m"] = torch.zeros_like(p)
                    state["v"] = torch.zeros_like(p)
                state["step"] += 1
                t = state["step"]
                g, m, v = p.grad, state["m"], state["v"]
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                c1, c2 = 1 - b1 ** t, 1 - b2 ** t
                lr_t = lr * math.sqrt(c2) / c1
                denom = (v / c2).sqrt_().add_(eps)
                p.addcdiv_(m / c1, denom, value=-lr_t)
        return loss


def loma_adam(params, lr: float = 5e-4) -> LomaAdam:
    """The reference's double-bias-corrected Adam over ``params``."""
    return LomaAdam(params, lr=lr)


def loma_sgd(params, lr: float = 1e-4) -> torch.optim.SGD:
    """Raw SGD (``p -= lr * g``), the fit_img.py update rule."""
    return torch.optim.SGD(params, lr=lr)
