"""Plain PyTorch reference of mip-NeRF 360 (Barron et al., CVPR 2022, arXiv
2111.12077; the public code ``github.com/google-research/multinerf``): what
the port computes for ``NeRFConfig.mipnerf360()``, written from the paper's
equations, in float32 with TF32 off (float64 in the CPU tests).

It imports torch alone, and this directory's ``nerf.py`` for the encoding,
the precision plans and Adam: nothing of the program under test, and nothing
that the program made.  Inputs are the benchmark's own (rays, targets,
initial weights); the resampler's jitter is worked out again from its seed.

* intervals in s-space, ``s = (1/t - 1/t_n) / (1/t_f - 1/t_n)`` (eq. 11);
* each interval the Gaussian of its conical frustum (mip-NeRF eqs. 7-8:
  ``t_mean``, ``t_var``, ``r_var`` of the cone of radius ``pixel_radius`` at
  ``t = 1``, ``Sigma = t_var d d^T + r_var (I - d d^T / |d|^2)``), mapped by
  the contraction ``(2 - 1/|x|) x / |x|`` outside the unit ball (eq. 10) and
  linearised with its Jacobian taken by ``torch.func.jacfwd`` (eq. 9), in
  float64;
* the IPE: per frequency l < L, ``exp(-4^l var / 2)`` times the sines of
  ``2^l mean``, then the cosines, ``var`` the covariance's diagonal;
* the resampler (multinerf's ``stepfun.sample_intervals`` with one jitter a
  ray): the CDF of the histogram's weights, ``u_j = j (1 - u_max) / (n - 1)
  + xi max_jitter``, the inverse by ``sorted_interp`` (the largest CDF entry
  at or below ``u`` and the smallest above it), the centres' midpoints
  with the outer two reflected and clipped to [0, 1]; the first round from
  the one bin [0, 1], each later round from the previous round's detached
  weights;
* the networks: the proposal MLP (ReLU layers, density head), the NeRF MLP
  (trunk with ``[h | IPE]`` into layer ``skip_layer``, density head,
  bottleneck, view layer on ``[bottleneck | gamma(d / |d|)]``, rgb head);
  density ``softplus(raw - 1)``, colour ``1.002 sigmoid(z) - 0.001``;
* compositing: ``alpha = 1 - exp(-density delta |d|)``, ``T = exp(-cumsum)``
  of the earlier terms;
* the loss: the mean over rays and channels of ``sqrt((C - C*)^2 + 1e-6)``,
  plus 0.01 times the mean over rays of ``sum_ij w_i w_j |m_i - m_j| + sum_i
  w_i^2 (s_{i+1} - s_i) / 3`` (the double sum as written), plus per round the
  mean over rays of ``sum_j max(0, w_j - outer_j)^2 / (w_j + eps)`` with the
  NeRF's ``(s, w)`` detached and ``outer`` from multinerf's
  ``inner_outer``; Adam over both networks.

``plan`` as in ``nerf.py``: :data:`nerf.EXACT` or the float8 control
:data:`nerf.FP8` (every product's operands and the heads' outputs rounded
to float8 e4m3 under a per-tensor scale).
"""

from __future__ import annotations

import torch

from benchmark.reference.nerf import BLOCK_BYTES, EXACT, Adam, Plan, encode

EPS32 = 1.1920928955078125e-07
CHARB = 1e-3
RGB_PAD = 1e-3
LAMBDA_DIST = 0.01


def nets(params: dict, model: dict):
    """``(proposal, nerf)``: the proposal's ``proposal_layers + 1`` leaves
    first."""
    k = model["proposal_layers"] + 1
    return ({"w": params["w"][:k], "b": params["b"][:k]},
            {"w": params["w"][k:], "b": params["b"][k:]})


def t_of(s: torch.Tensor, model: dict) -> torch.Tensor:
    near, far = model["near"], model["far"]
    return 1.0 / (1.0 / near + s * (1.0 / far - 1.0 / near))


def _contract_one(x: torch.Tensor) -> torch.Tensor:
    n2 = torch.sum(x * x)
    n = torch.sqrt(torch.clamp(n2, min=1.0))
    return torch.where(n2 <= 1.0, x, (2.0 - 1.0 / n) * x / n)


@torch.no_grad()
def features(origins, directions, s, model: dict) -> torch.Tensor:
    """``(N S, 6 L)`` IPE of the intervals ``s`` ``(N, S + 1)``, worked out
    in float64 (far out, the Jacobian's radial and tangential factors differ
    by ``2|x|`` and ``J Sigma J^T`` cancels to a millionth of its terms) and
    returned in the inputs' dtype."""
    dtype = s.dtype
    origins, directions, s = (x.double() for x in (origins, directions, s))
    t = t_of(s, model)
    t0, t1 = t[:, :-1], t[:, 1:]
    mu, hw = (t0 + t1) / 2, (t1 - t0) / 2
    t_mean = mu + (2 * mu * hw ** 2) / (3 * mu ** 2 + hw ** 2)
    t_var = hw ** 2 / 3 - (4 / 15) * (hw ** 4 * (12 * mu ** 2 - hw ** 2)) \
        / (3 * mu ** 2 + hw ** 2) ** 2
    r = model["pixel_radius"]
    r_var = r ** 2 * (mu ** 2 / 4 + (5 / 12) * hw ** 2 - (4 / 15) * hw ** 4
                      / (3 * mu ** 2 + hw ** 2))
    d = directions[:, None, :].expand(t_mean.shape + (3,))
    mean = origins[:, None, :] + d * t_mean[..., None]
    dd = torch.clamp(torch.sum(d * d, dim=-1), min=1e-10)[..., None, None]
    ddt = d[..., :, None] * d[..., None, :]
    eye = torch.eye(3, dtype=s.dtype, device=s.device)
    cov = t_var[..., None, None] * ddt + r_var[..., None, None] * (eye - ddt / dd)
    flat = mean.reshape(-1, 3)
    jac = torch.func.vmap(torch.func.jacfwd(_contract_one))(flat).reshape(cov.shape)
    cov = jac @ cov @ jac.transpose(-1, -2)
    mean = torch.func.vmap(_contract_one)(flat).reshape(mean.shape)
    var = torch.diagonal(cov, dim1=-2, dim2=-1)
    blocks = []
    for lvl in range(model["num_encoding_functions"]):
        scale = torch.exp(-0.5 * var * 4.0 ** lvl)
        blocks += [scale * torch.sin(mean * 2.0 ** lvl), scale * torch.cos(mean * 2.0 ** lvl)]
    return torch.cat(blocks, dim=-1).reshape(s.shape[0] * (s.shape[1] - 1), -1).to(dtype)


def _sorted_interp(x, xp, fp):
    """multinerf's ``math.sorted_interp``: piecewise-linear ``fp(xp)`` at
    ``x``, between the largest ``xp`` at or below and the smallest above."""
    below = x[..., None, :] >= xp[..., :, None]  # (N, n_xp, n_x)
    xp0 = torch.max(torch.where(below, xp[..., :, None], xp[..., :1, None]), dim=-2).values
    xp1 = torch.min(torch.where(~below, xp[..., :, None], xp[..., -1:, None]), dim=-2).values
    fp0 = torch.max(torch.where(below, fp[..., :, None], fp[..., :1, None]), dim=-2).values
    fp1 = torch.min(torch.where(~below, fp[..., :, None], fp[..., -1:, None]), dim=-2).values
    offset = torch.nan_to_num((x - xp0) / (xp1 - xp0), nan=0.0).clamp(0.0, 1.0)
    return fp0 + offset * (fp1 - fp0)


@torch.no_grad()
def resample(s: torch.Tensor, w: torch.Tensor, n: int, xi) -> torch.Tensor:
    """``(N, n + 1)`` endpoints drawn from the histogram ``(s, w)``; ``xi``
    ``(N,)`` the jitter, None for the deterministic centres."""
    total = torch.sum(w, dim=-1, keepdim=True)
    pdf = torch.where(total > 0, w / torch.where(total > 0, total, 1.0), 1.0 / w.shape[-1])
    cw = torch.clamp(torch.cumsum(pdf[..., :-1], dim=-1), max=1.0)
    cw = torch.cat([torch.zeros_like(pdf[..., :1]), cw, torch.ones_like(pdf[..., :1])], dim=-1)
    if xi is None:
        pad = 1 / (2 * n)
        u = torch.linspace(pad, 1 - pad - EPS32, n, dtype=s.dtype, device=s.device)
        u = u.expand(s.shape[0], n)
    else:
        u_max = EPS32 + (1 - EPS32) / n
        max_jitter = (1 - u_max) / (n - 1) - EPS32
        u = torch.arange(n, dtype=s.dtype, device=s.device) * ((1 - u_max) / (n - 1))
        u = u[None, :] + xi.to(s.dtype)[:, None] * max_jitter
    c = _sorted_interp(u, cw, s)
    mid = (c[..., 1:] + c[..., :-1]) / 2
    first = torch.clamp(2 * c[..., :1] - mid[..., :1], min=0.0)
    last = torch.clamp(2 * c[..., -1:] - mid[..., -1:], max=1.0)
    return torch.cat([first, mid, last], dim=-1)


def weights_of(density, s, directions, model: dict) -> torch.Tensor:
    t = t_of(s, model)
    dd = density * (t[:, 1:] - t[:, :-1]) * torch.linalg.vector_norm(directions, dim=-1)[:, None]
    alpha = 1 - torch.exp(-dd)
    trans = torch.exp(-torch.cat([torch.zeros_like(dd[:, :1]), torch.cumsum(dd[:, :-1], -1)], -1))
    return alpha * trans


def proposal(net: dict, feats, plan: Plan):
    h = feats
    for w, b in zip(net["w"][:-1], net["b"][:-1]):
        h = torch.relu(plan.mm(h, w) + b)
    raw = plan.out(plan.mm(h, net["w"][-1]) + net["b"][-1])
    return torch.nn.functional.softplus(raw[:, 0] - 1.0)


def nerf(net: dict, feats, enc_d, skip: int, plan: Plan):
    ws, bs = net["w"], net["b"]
    trunk = len(ws) - 4
    h = feats
    for i in range(trunk):
        if i == skip:
            h = torch.cat([h, feats], dim=-1)
        h = torch.relu(plan.mm(h, ws[i]) + bs[i])
    raw = plan.out(plan.mm(h, ws[trunk]) + bs[trunk])
    bottleneck = plan.mm(h, ws[trunk + 1]) + bs[trunk + 1]
    v = torch.relu(plan.mm(torch.cat([bottleneck, enc_d], dim=-1), ws[trunk + 2]) + bs[trunk + 2])
    rgb = plan.out(plan.mm(v, ws[trunk + 3]) + bs[trunk + 3])
    return (1 + 2 * RGB_PAD) * torch.sigmoid(rgb) - RGB_PAD, \
        torch.nn.functional.softplus(raw[:, 0] - 1.0)


def distortion(s, w):
    m = (s[:, 1:] + s[:, :-1]) / 2
    inter = torch.sum(w * torch.sum(w[:, None, :] * torch.abs(m[:, :, None] - m[:, None, :]),
                                    dim=-1), dim=-1)
    return inter + torch.sum(w ** 2 * (s[:, 1:] - s[:, :-1]), dim=-1) / 3


def outer(t0, t1, y1):
    """multinerf's ``inner_outer``'s outer bound of the histogram ``(t1,
    y1)`` on the intervals of ``t0``."""
    cy1 = torch.cat([torch.zeros_like(y1[:, :1]), torch.cumsum(y1, dim=-1)], dim=-1)
    i = torch.arange(t1.shape[-1], device=t1.device)
    ge = t0[:, None, :] >= t1[:, :, None]  # (N, n1 + 1, n0 + 1)
    idx_lo = torch.max(torch.where(ge, i[:, None], i[:1, None]), dim=-2).values
    idx_hi = torch.min(torch.where(~ge, i[:, None], i[-1:, None]), dim=-2).values
    return torch.gather(cy1, 1, idx_hi[:, 1:]) - torch.gather(cy1, 1, idx_lo[:, :-1])


def interlevel(s, w, sp, wp):
    s, w = s.detach(), w.detach()
    return torch.sum(torch.clamp(w - outer(s, sp, wp), min=0.0) ** 2 / (w + EPS32), dim=-1)


def forward(params: dict, origins, directions, model: dict, xi, plan: Plan = EXACT):
    """``(colour (N, 3), s (N, S + 1), w (N, S), [(s_k, w_k)])``."""
    prop, net = nets(params, model)
    n = origins.shape[0]
    s = torch.tensor([0.0, 1.0], dtype=origins.dtype, device=origins.device).expand(n, 2)
    w = torch.ones((n, 1), dtype=origins.dtype, device=origins.device)
    rounds = []
    for k, samples in enumerate(model["proposal_samples"]):
        s = resample(s, w.detach(), samples, None if xi is None else xi[k])
        w = weights_of(proposal(prop, features(origins, directions, s, model), plan).reshape(n, -1),
                       s, directions, model)
        rounds.append((s, w))
    s = resample(s, w.detach(), model["num_samples"], None if xi is None else xi[-1])
    S = model["num_samples"]
    unit = directions / torch.linalg.vector_norm(directions, dim=-1, keepdim=True)
    enc_d = encode(unit, model["dir_encoding_functions"])
    enc_d = enc_d[:, None, :].expand(n, S, enc_d.shape[-1]).reshape(n * S, -1)
    rgb, density = nerf(net, features(origins, directions, s, model), enc_d,
                        model["skip_layer"], plan)
    w = weights_of(density.reshape(n, S), s, directions, model)
    return torch.sum(w[..., None] * rgb.reshape(n, S, 3), dim=1), s, w, rounds


def block_rays(model: dict, dtype=torch.float32) -> int:
    """Rays per block: about ``BLOCK_BYTES`` of activations and gradients."""
    per_ray = (model["num_samples"] * model["filter_size"] * (model["num_layers"] + 3)
               + sum(model["proposal_samples"]) * model["proposal_width"]
               * (model["proposal_layers"] + 3)) * 3 * torch.finfo(dtype).bits // 8
    return max(1, BLOCK_BYTES // per_ray)


def loss_and_grads(params: dict, origins, directions, target, xi, model: dict,
                   plan: Plan = EXACT, block: int | None = None):
    """``(terms, grads, s)``: the loss's four terms (Charbonnier,
    distortion, round 1's and round 2's interlevel; floats summed over
    blocks in float64), its gradient per leaf, and the NeRF's intervals."""
    block = block or block_rays(model, origins.dtype)
    leaves = [p.detach().clone().requires_grad_(True) for p in [*params["w"], *params["b"]]]
    n_w, n = len(params["w"]), origins.shape[0]
    local = {"w": leaves[:n_w], "b": leaves[n_w:]}
    terms, s_all = [0.0] * 4, []
    for i in range(0, n, block):
        sl = slice(i, min(n, i + block))
        col, s, w, rounds = forward(local, origins[sl], directions[sl], model,
                                    None if xi is None else xi[:, sl], plan)
        parts = [torch.sum(torch.sqrt((col - target[sl]) ** 2 + CHARB ** 2)) / (3 * n),
                 LAMBDA_DIST * torch.sum(distortion(s, w)) / n]
        parts += [torch.sum(interlevel(s, w, sk, wk)) / n for sk, wk in rounds]
        torch.stack(parts).sum().backward()
        terms = [a + float(b.detach()) for a, b in zip(terms, parts)]
        s_all.append(s.detach())
    return terms, [p.grad for p in leaves], torch.cat(s_all)


def train(params: dict, batches, model: dict, optimizer: dict, plan: Plan = EXACT,
          block: int | None = None) -> dict:
    """Adam steps on ``batches`` (``(origins, directions, target, xi)``
    each) from ``params``: each step's loss terms, the first step's
    gradient per leaf and intervals, each leaf's change after the last step."""
    start = [p.detach().clone() for p in [*params["w"], *params["b"]]]
    leaves = [p.clone() for p in start]
    n_w = len(params["w"])
    adam = Adam(leaves, optimizer["lr"], tuple(optimizer["betas"]), optimizer["eps"])
    terms, first, s_first = [], None, None
    for o, d, tg, xi in batches:
        t, grads, s = loss_and_grads({"w": leaves[:n_w], "b": leaves[n_w:]}, o, d, tg, xi,
                                     model, plan, block)
        terms.append(t)
        if first is None:
            first, s_first = grads, s
        adam.step(leaves, grads)
    return {"terms": terms, "first_grads": first, "sdist": s_first,
            "changes": [p - p0 for p, p0 in zip(leaves, start)]}
