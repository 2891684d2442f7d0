"""Plain PyTorch reference of the NeRF cells: what the port computes, written
from the model's equations, in float32 with TF32 off (float64 in the CPU
tests).

It imports torch alone: nothing of the program under test, and nothing that
the program made.  Inputs are the benchmark's own (rays, targets, initial
weights); the comb offsets are worked out again from their seed.

* encoding: ``[x | sin 2^0 x | cos 2^0 x | ... | cos 2^(n-1) x]``;
* MLP: ``x @ W + b`` per layer, ReLU on hidden layers, the head sigmoid on
  rgb and ReLU on the density;
* compositing: ``alpha = 1 - exp(-sigma * dist)``, ``c = exp(-sigma * dist)
  + 1e-10``, ``T`` the exclusive (``standard``) or inclusive (``loma``)
  product of ``c``, colour ``sum_j alpha_j T_j rgb_j``; ``dist`` the forward
  differences of the depths with 1e8 last;
* loss: the sum of squared errors over the batch;
* Adam as ``torch.optim.Adam`` defines it, restated.

``plan`` says in what precision values are kept: :data:`EXACT` (the
reference: float32 throughout) or :data:`FP8` (the control, the port's bf16
rounding plan one precision down: both operands of every product, forward
and backward, and the head's rgba output rounded to float8 e4m3 under a
per-tensor scale; sums, encoding and compositing in float32).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence

import torch

EPS = 1e-10
FAR_DIST = 1e8
FP8_MAX = 448.0  # largest finite float8 e4m3fn
# rows (rays x samples) a block of the reference holds: about this many
# bytes of float32 activations and their gradients a block
BLOCK_BYTES = 6 << 30

Params = Dict[str, List[torch.Tensor]]


def set_exact() -> None:
    """Float32 products in float32: no TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale that maps its
    largest magnitude to 448, back in x's dtype."""
    scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _fp8(a), _fp8(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _fp8(g)
        return qg @ qb.T, qa.T @ qg


class Plan:
    """Products ``mm(a, b)`` and the rounding ``out(rgba)`` of the head's
    output."""

    def __init__(self, name: str, mm: Callable, out: Callable):
        self.name, self.mm, self.out = name, mm, out


EXACT = Plan("float32", lambda a, b: a @ b, lambda x: x)
# rounded values forward, the gradient straight through the rounding
FP8 = Plan("float8", _Fp8Matmul.apply, lambda x: x + (_fp8(x) - x).detach())


def encode(x: torch.Tensor, n: int) -> torch.Tensor:
    blocks = [x]
    for i in range(n):
        blocks += [torch.sin(x * 2.0 ** i), torch.cos(x * 2.0 ** i)]
    return torch.cat(blocks, dim=-1)


def depths(near: float, far: float, samples: int, device, dtype=torch.float32):
    """``(t, dist)``, each ``(S,)``: the comb every ray shares and its
    forward differences with the far sentinel last."""
    t = torch.linspace(near, far, samples, dtype=dtype, device=device)
    dist = torch.cat([t[1:] - t[:-1], torch.full_like(t[:1], FAR_DIST)])
    return t, dist


def comb_offsets(generator: torch.Generator, n_rays: int, near: float, far: float,
                 samples: int) -> torch.Tensor:
    """Each ray's shift of the whole comb: one uniform draw in ``[0, (far -
    near) / S)`` from ``generator``, in float32 on its device."""
    u = torch.rand((n_rays,), generator=generator, dtype=torch.float32,
                   device=generator.device)
    return u * ((far - near) / samples)


def mlp(params: Params, h: torch.Tensor, plan: Plan = EXACT) -> torch.Tensor:
    """rgba ``(rows, 4)``: sigmoid rgb, ReLU density (channel 3)."""
    ws, bs = params["w"], params["b"]
    for w, b in zip(ws[:-1], bs[:-1]):
        h = torch.relu(plan.mm(h, w) + b)
    z = plan.mm(h, ws[-1]) + bs[-1]
    return plan.out(torch.cat([torch.sigmoid(z[:, :3]), torch.relu(z[:, 3:4])], dim=1))


def render(params: Params, origins, directions, model: dict,
           plan: Plan = EXACT) -> torch.Tensor:
    """``(N, 3)`` colours of ``(N, 3)`` rays at the model's shared comb."""
    t, dist = depths(model["near"], model["far"], model["num_samples"], origins.device,
                     origins.dtype)
    n, s = origins.shape[0], t.shape[0]
    pts = origins[:, None, :] + directions[:, None, :] * t[:, None]
    rgba = mlp(params, encode(pts, model["num_encoding_functions"]).reshape(n * s, -1),
               plan).reshape(n, s, 4)
    sigma = rgba[..., 3]
    e = torch.exp(-sigma * dist)
    alpha, c = 1.0 - e, e + EPS
    incl = torch.cumprod(c, dim=-1)
    ones = torch.ones_like(incl[:, :1])
    if model["mode"] == "standard":
        trans = torch.cat([ones, incl[:, :-1]], dim=-1)
    elif model["mode"] == "loma":
        trans = torch.cat([ones, incl[:, 1:]], dim=-1)
    else:
        raise ValueError(f"unknown compositing mode {model['mode']!r}")
    return torch.sum((alpha * trans)[..., None] * rgba[..., :3], dim=1)


def block_rays(model: dict, dtype=torch.float32) -> int:
    """Rays per block: about ``BLOCK_BYTES`` of activations, each layer's
    input and its gradient kept."""
    width = max(model["filter_size"], 4 * (1 + 2 * model["num_encoding_functions"]))
    per_ray = model["num_samples"] * width * model["num_layers"] * 3 * \
        torch.finfo(dtype).bits // 8
    return max(1, BLOCK_BYTES // per_ray)


@torch.no_grad()
def render_blocked(params: Params, origins, directions, model: dict,
                   plan: Plan = EXACT, block: int | None = None) -> torch.Tensor:
    block = block or block_rays(model, origins.dtype)
    return torch.cat([render(params, o, d, model, plan)
                      for o, d in zip(origins.split(block), directions.split(block))])


def loss_and_grads(params: Params, origins, directions, target, model: dict,
                   plan: Plan = EXACT, block: int | None = None):
    """``(loss, grads)``: the batch's sum of squared errors (a float, summed
    over blocks in float64) and its gradient per leaf (``w`` leaves, then
    ``b`` leaves), accumulated over blocks of rays."""
    block = block or block_rays(model, origins.dtype)
    leaves = [p.detach().clone().requires_grad_(True) for p in [*params["w"], *params["b"]]]
    n_w = len(params["w"])
    local = {"w": leaves[:n_w], "b": leaves[n_w:]}
    total = 0.0
    for o, d, tg in zip(origins.split(block), directions.split(block), target.split(block)):
        diff = render(local, o, d, model, plan) - tg
        loss = torch.sum(diff * diff)
        loss.backward()
        total += float(loss.detach())
    return total, [p.grad for p in leaves]


class Adam:
    """``torch.optim.Adam`` (no weight decay, no amsgrad), restated:
    ``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2) g^2``, ``p -= lr /
    (1 - b1^t) * m / (sqrt(v) / sqrt(1 - b2^t) + eps)``."""

    def __init__(self, leaves: Sequence[torch.Tensor], lr: float, betas=(0.9, 0.999),
                 eps: float = 1e-8):
        self.lr, (self.b1, self.b2), self.eps, self.t = lr, betas, eps, 0
        self.m = [torch.zeros_like(p) for p in leaves]
        self.v = [torch.zeros_like(p) for p in leaves]

    @torch.no_grad()
    def step(self, leaves: Sequence[torch.Tensor], grads: Sequence[torch.Tensor]) -> None:
        self.t += 1
        c1, c2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        for p, g, m, v in zip(leaves, grads, self.m, self.v):
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            denom = v.sqrt() / math.sqrt(c2) + self.eps
            p.addcdiv_(m, denom, value=-self.lr / c1)


def train(params: Params, batches, model: dict, optimizer: dict,
          plan: Plan = EXACT, block: int | None = None) -> dict:
    """Adam steps on ``batches`` (``(origins, directions, target)`` each,
    comb offsets already folded into the origins) from ``params``.
    Returns each step's loss, the first step's gradient per leaf, and each
    leaf's change after the last step."""
    start = [p.detach().clone() for p in [*params["w"], *params["b"]]]
    leaves = [p.clone() for p in start]
    n_w = len(params["w"])
    adam = Adam(leaves, optimizer["lr"], tuple(optimizer["betas"]), optimizer["eps"])
    losses, first = [], None
    for o, d, tg in batches:
        loss, grads = loss_and_grads({"w": leaves[:n_w], "b": leaves[n_w:]}, o, d, tg,
                                     model, plan, block)
        losses.append(loss)
        first = grads if first is None else first
        adam.step(leaves, grads)
    return {"losses": losses, "first_grads": first,
            "changes": [p - p0 for p, p0 in zip(leaves, start)]}
