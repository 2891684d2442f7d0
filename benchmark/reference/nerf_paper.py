"""Plain PyTorch reference of the published NeRF (Mildenhall et al., ECCV
2020, arXiv 2003.08934; the public code ``github.com/bmild/nerf``,
``run_nerf_helpers.py``): what the port computes for ``NeRFConfig.paper()``,
written from the paper's equations, in float32 with TF32 off (float64 in the
CPU tests).

It imports torch alone, and this directory's ``nerf.py`` for the encoding,
the precision plans and Adam: nothing of the program under test, and nothing
that the program made.  Inputs are the benchmark's own (rays, targets,
initial weights); the coarse depths' jitter and the fine draws ``u`` are
worked out again from their seeds.

* one network: ``num_layers`` ReLU layers of ``filter_size`` on ``gamma(x)``
  (L = ``num_encoding_functions``), the layer ``skip_layer`` (0-based) on
  ``[gamma(x) | h]`` (the code's ``skips=[4]``); the density ``sigma = h W_s +
  b_s`` (ReLU at compositing); the feature ``h W_f + b_f`` (no activation);
  the view layer ``ReLU([feature | gamma(d / |d|)] W_v + b_v)`` (L =
  ``dir_encoding_functions``); ``rgb = sigmoid(v W_rgb + b_rgb)``.  Leaves in
  the port's order: the trunk's weights, then sigma, feature, view and rgb's;
  then the biases in the same order; the model holds the coarse network's
  twelve and then the fine one's;
* coarse depths: ``linspace(near, far, S)`` plus a uniform draw times
  ``(far - near) / S`` per ray and sample;
* fine depths (``sample_pdf``): bins at the midpoints of the coarse depths,
  ``weights[1:-1] + 1e-5`` normalised, the CDF with a leading 0,
  ``searchsorted(cdf, u, right=True)``, a CDF step below 1e-5 taken as 1;
  the coarse weights detached; the fine pass on the sorted union;
* compositing: the port's standard mode (``nerf.py``'s), ``dist`` the
  forward differences of the depths with 1e8 last;
* loss: the coarse and the fine sum of squared errors, added; Adam over both
  networks' leaves.

``plan`` as in ``nerf.py``: :data:`nerf.EXACT` or the float8 control
:data:`nerf.FP8` (every product's operands, and the rgb and density entering
compositing, rounded to float8 e4m3 under a per-tensor scale).
"""

from __future__ import annotations

import torch

from benchmark.reference.nerf import BLOCK_BYTES, EPS, EXACT, FAR_DIST, Adam, Plan, encode

PDF_EPS = 1e-5


def nets(params: dict):
    """``(coarse, fine)``: each ``{"w": [...12], "b": [...12]}``."""
    h = len(params["w"]) // 2
    return ({"w": params["w"][:h], "b": params["b"][:h]},
            {"w": params["w"][h:], "b": params["b"][h:]})


def network(net: dict, enc_x: torch.Tensor, enc_d: torch.Tensor, skip: int,
            plan: Plan = EXACT):
    """``(rgb (rows, 3), sigma (rows,))``: rgb after the sigmoid, sigma after
    the ReLU."""
    ws, bs = net["w"], net["b"]
    trunk = len(ws) - 4
    h = enc_x
    for i in range(trunk):
        if skip and i == skip:
            h = torch.cat([enc_x, h], dim=-1)
        h = torch.relu(plan.mm(h, ws[i]) + bs[i])
    sigma = plan.mm(h, ws[trunk]) + bs[trunk]
    feature = plan.mm(h, ws[trunk + 1]) + bs[trunk + 1]
    v = torch.relu(plan.mm(torch.cat([feature, enc_d], dim=-1), ws[trunk + 2]) + bs[trunk + 2])
    rgb = torch.sigmoid(plan.mm(v, ws[trunk + 3]) + bs[trunk + 3])
    return plan.out(rgb), plan.out(torch.relu(sigma[:, 0]))


def steps_of(t: torch.Tensor) -> torch.Tensor:
    return torch.cat([t[:, 1:] - t[:, :-1], torch.full_like(t[:, :1], FAR_DIST)], dim=-1)


def render_pass(net: dict, origins, directions, t, model: dict, plan: Plan = EXACT):
    """``(colours (N, 3), weights (N, S))`` of one network at per-ray depths
    ``t`` ``(N, S)``."""
    n, s = t.shape
    pts = origins[:, None, :] + directions[:, None, :] * t[..., None]
    unit = directions / torch.linalg.vector_norm(directions, dim=-1, keepdim=True)
    enc_x = encode(pts, model["num_encoding_functions"]).reshape(n * s, -1)
    enc_d = encode(unit, model["dir_encoding_functions"])
    enc_d = enc_d[:, None, :].expand(n, s, enc_d.shape[-1]).reshape(n * s, -1)
    rgb, sigma = network(net, enc_x, enc_d, model["skip_layer"], plan)
    e = torch.exp(-sigma.reshape(n, s) * steps_of(t))
    alpha, c = 1.0 - e, e + EPS
    incl = torch.cumprod(c, dim=-1)
    trans = torch.cat([torch.ones_like(incl[:, :1]), incl[:, :-1]], dim=-1)
    w = alpha * trans
    return torch.sum(w[..., None] * rgb.reshape(n, s, 3), dim=1), w


def coarse_depths(generator: torch.Generator, n_rays: int, model: dict) -> torch.Tensor:
    """``(N, S)`` stratified coarse depths: the comb plus one uniform draw
    per bin from ``generator``, in float32 on its device."""
    near, far, s = model["near"], model["far"], model["num_samples"]
    comb = torch.linspace(near, far, s, dtype=torch.float32, device=generator.device)
    u = torch.rand((n_rays, s), generator=generator, dtype=torch.float32,
                   device=generator.device)
    return comb[None, :] + u * ((far - near) / s)


def fine_draws(generator: torch.Generator, n_rays: int, model: dict) -> torch.Tensor:
    """``(N, Nf)`` uniform draws ``u`` of the fine samples, from ``generator``."""
    return torch.rand((n_rays, model["num_fine_samples"]), generator=generator,
                      dtype=torch.float32, device=generator.device)


def even_draws(n_rays: int, model: dict, device, dtype=torch.float32) -> torch.Tensor:
    """The renderer's ``u``: evenly spaced on [0, 1] (the code's ``det``)."""
    u = torch.linspace(0.0, 1.0, model["num_fine_samples"], dtype=dtype, device=device)
    return u.expand(n_rays, -1)


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``run_nerf_helpers.sample_pdf`` with its draws ``u`` given."""
    w = weights + PDF_EPS
    pdf = w / torch.sum(w, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1)
    inds = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)
    cdf_g = [torch.gather(cdf, 1, i) for i in (below, above)]
    bins_g = [torch.gather(bins, 1, i) for i in (below, above)]
    denom = cdf_g[1] - cdf_g[0]
    denom = torch.where(denom < PDF_EPS, torch.ones_like(denom), denom)
    return bins_g[0] + (u - cdf_g[0]) / denom * (bins_g[1] - bins_g[0])


def fine_depths(t: torch.Tensor, weights: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The sorted union of the coarse depths and those drawn from the
    (detached) coarse weights."""
    mids = 0.5 * (t[:, 1:] + t[:, :-1])
    drawn = sample_pdf(mids, weights.detach()[:, 1:-1], u.to(t.dtype))
    return torch.sort(torch.cat([t, drawn.detach()], dim=-1), dim=-1).values


def render(params: dict, origins, directions, model: dict, plan: Plan = EXACT):
    """``(N, 3)`` colours as the renderer makes them: the coarse pass at the
    comb, the fine depths drawn evenly, the fine network's colours."""
    coarse, fine = nets(params)
    n = origins.shape[0]
    t = torch.linspace(model["near"], model["far"], model["num_samples"],
                       dtype=origins.dtype, device=origins.device).expand(n, -1)
    _, w = render_pass(coarse, origins, directions, t, model, plan)
    tf = fine_depths(t, w, even_draws(n, model, origins.device, origins.dtype))
    return render_pass(fine, origins, directions, tf, model, plan)[0]


def block_rays(model: dict, dtype=torch.float32) -> int:
    """Rays per block: about ``BLOCK_BYTES`` of both passes' activations,
    each layer's input and its gradient kept."""
    rows = model["num_samples"] * 2 + model["num_fine_samples"]
    width = model["filter_size"] + 4 * (1 + 2 * model["num_encoding_functions"])
    per_ray = rows * width * (model["num_layers"] + 4) * 3 * torch.finfo(dtype).bits // 8
    return max(1, BLOCK_BYTES // per_ray)


def loss_and_grads(params: dict, origins, directions, target, t, u, model: dict,
                   plan: Plan = EXACT, block: int | None = None):
    """``(loss, grads)``: the coarse plus the fine sum of squared errors of a
    batch at coarse depths ``t`` ``(N, S)`` and fine draws ``u`` ``(N, Nf)``
    (a float, summed over blocks in float64), and its gradient per leaf (the
    model's order), accumulated over blocks of rays."""
    block = block or block_rays(model, origins.dtype)
    leaves = [p.detach().clone().requires_grad_(True) for p in [*params["w"], *params["b"]]]
    n_w = len(params["w"])
    coarse, fine = nets({"w": leaves[:n_w], "b": leaves[n_w:]})
    total = 0.0
    for o, d, tg, tb, ub in zip(*(x.split(block) for x in (origins, directions, target, t, u))):
        col_c, w = render_pass(coarse, o, d, tb, model, plan)
        col_f, _ = render_pass(fine, o, d, fine_depths(tb, w, ub), model, plan)
        loss = torch.sum((col_c - tg) ** 2) + torch.sum((col_f - tg) ** 2)
        loss.backward()
        total += float(loss.detach())
    return total, [p.grad for p in leaves]


def train(params: dict, batches, model: dict, optimizer: dict, plan: Plan = EXACT,
          block: int | None = None) -> dict:
    """Adam steps on ``batches`` (``(origins, directions, target, t, u)``
    each) from ``params``.  Returns each step's loss, the first step's
    gradient per leaf, and each leaf's change after the last step."""
    start = [p.detach().clone() for p in [*params["w"], *params["b"]]]
    leaves = [p.clone() for p in start]
    n_w = len(params["w"])
    adam = Adam(leaves, optimizer["lr"], tuple(optimizer["betas"]), optimizer["eps"])
    losses, first = [], None
    for o, d, tg, t, u in batches:
        loss, grads = loss_and_grads({"w": leaves[:n_w], "b": leaves[n_w:]}, o, d, tg, t, u,
                                     model, plan, block)
        losses.append(loss)
        first = grads if first is None else first
        adam.step(leaves, grads)
    return {"losses": losses, "first_grads": first,
            "changes": [p - p0 for p, p0 in zip(leaves, start)]}
