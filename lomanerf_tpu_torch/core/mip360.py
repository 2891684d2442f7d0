"""mip-NeRF 360 (Barron et al., CVPR 2022, arXiv 2111.12077) in plain
PyTorch: the pieces of ``NeRFConfig.mipnerf360()`` that the kernels of
``ops/csrc/mip360.cu`` compute on the card, as their CPU route.

* intervals live in s-space, ``s = (g(t) - g(t_n)) / (g(t_f) - g(t_n))``
  with ``g(x) = 1/x`` (eq. 11): :func:`s_to_t`;
* each interval ``[t0, t1]`` of a ray is the Gaussian of its conical
  frustum (mip-NeRF, arXiv 2103.13415, eqs. 7-8), mapped through the
  contraction (eq. 10) and linearised, ``(f(mu), J Sigma J^T)`` (eq. 9):
  :func:`frustum_gaussian`, :func:`contract`;
* the integrated positional encoding of its mean and the covariance's
  diagonal, ``exp(-4^l var / 2) sin(2^l mean)`` and the cosines, l < L:
  :func:`ipe`;
* the resampler: interval endpoints drawn from the step histogram of the
  previous round's weights (multinerf's ``stepfun.sample_intervals``):
  :func:`resample`;
* compositing over intervals, ``w_i = (1 - exp(-x_i)) exp(-sum_{k<i} x_k)``,
  ``x_i = density_i (t_{i+1} - t_i) |d|``: :func:`interval_weights`;
* the losses: Charbonnier, the distortion (eq. 15, in O(n) by prefix sums)
  and the interlevel term (eqs. 13-14): :func:`charbonnier`,
  :func:`distortion`, :func:`interlevel`;
* the networks and the whole step: :func:`prop_density`, :func:`nerf_apply`,
  :func:`train_loss`, :func:`render`.

``rnd`` rounds what the kernels store in bf16 (every weight, the encodings,
each layer's output, sigma_raw and the bottleneck as F's output); the
products accumulate in the inputs' dtype.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from lomanerf_tpu_torch.core.encoding import positional_encoding

F32_EPS = 1.1920928955078125e-07  # float32's machine epsilon (multinerf's eps)
RGB_PAD = 0.001  # the padded sigmoid's epsilon
CHARB_EPS = 0.001  # Charbonnier's epsilon
DISTORTION_MULT = 0.01  # the distortion loss's weight


def s_to_t(s: torch.Tensor, near: float, far: float) -> torch.Tensor:
    """Metric distance of s-space ``s``: ``1 / t = (1 - s) / t_n + s / t_f``."""
    return 1.0 / ((1.0 - s) * (1.0 / near) + s * (1.0 / far))


def contract(x: torch.Tensor) -> torch.Tensor:
    """``x`` where ``|x| <= 1``, else ``(2 - 1/|x|) x / |x|`` (eq. 10)."""
    xx = torch.sum(x * x, dim=-1, keepdim=True)
    r = torch.sqrt(xx.clamp_min(1.0))
    return torch.where(xx <= 1.0, x, (2.0 * r - 1.0) / (r * r) * x)


def frustum_gaussian(origins, directions, t0, t1, radius: float, contracted: bool = True):
    """``(mean (N, S, 3), var (N, S, 3))``: the conical frustum of each
    interval ``[t0, t1]`` (each ``(N, S)``) along ``o + d t`` with radius
    ``radius`` at ``t = 1`` as a Gaussian (the stable form of mip-NeRF's
    eqs. 7-8: ``Sigma = t_var d d^T + r_var (I - d d^T / |d|^2)``), then, with
    ``contracted``, mapped through :func:`contract` and linearised (``J Sigma
    J^T``, ``J = a (I - u u^T) + u u^T / |x|^2`` with ``u = x / |x|`` and ``a
    = (2|x| - 1) / |x|^2``); ``var`` is the covariance's diagonal.  ``J Sigma
    J^T`` is taken as ``(t_var - r_var / |d|^2) (J d)(J d)^T + r_var J J^T``
    with ``J J^T = a^2 (I - u u^T) + u u^T / |x|^4``: far out J's radial and
    tangential factors differ by ``2|x|``, and the product of the matrices
    would cancel to a millionth of its terms in float32."""
    mu, hw = 0.5 * (t0 + t1), 0.5 * (t1 - t0)
    mu2, hw2 = mu * mu, hw * hw
    den = 3.0 * mu2 + hw2
    t_mean = mu + 2.0 * mu * hw2 / den
    t_var = hw2 / 3.0 - (4.0 / 15.0) * (hw2 * hw2 * (12.0 * mu2 - hw2)) / (den * den)
    r_var = radius * radius * (mu2 / 4.0 + (5.0 / 12.0) * hw2 - (4.0 / 15.0) * hw2 * hw2 / den)
    d = directions[:, None, :]
    mean = origins[:, None, :] + d * t_mean[..., None]
    dd = torch.sum(d * d, dim=-1, keepdim=True).clamp_min(1e-10)
    var = t_var[..., None] * d * d + r_var[..., None] * (1.0 - d * d / dd)
    if not contracted:
        return mean, var
    xx = torch.sum(mean * mean, dim=-1, keepdim=True)
    r = torch.sqrt(xx.clamp_min(1.0))
    a, b = (2.0 * r - 1.0) / (r * r), 2.0 * (1.0 - r) / (r * r)
    u = mean / r
    jd = a * d + b * u * torch.sum(u * d, dim=-1, keepdim=True)
    jj = a * a * (1.0 - u * u) + u * u / (r ** 4)
    far = (t_var - r_var / dd[..., 0])[..., None] * jd * jd + r_var[..., None] * jj
    inside = xx <= 1.0
    return torch.where(inside, mean, a * mean), torch.where(inside, var, far)


def ipe(mean: torch.Tensor, var: torch.Tensor, degree: int, variance: bool = True):
    """``(..., 6 degree)``: per frequency l < ``degree`` the three sines of
    ``2^l mean``, then the three cosines, each times ``exp(-4^l var / 2)``
    (the expectations under the Gaussian; plain sin and cos of the means
    without ``variance``)."""
    blocks = []
    for lvl in range(degree):
        x = mean * 2.0 ** lvl
        damp = torch.exp(-0.5 * var * 4.0 ** lvl) if variance else torch.ones_like(var)
        blocks += [damp * torch.sin(x), damp * torch.cos(x)]
    return torch.cat(blocks, dim=-1)


def dir_encoding(directions: torch.Tensor, degree: int) -> torch.Tensor:
    """gamma of the unit direction: ``[d | sin 2^0 d | cos 2^0 d | ...]``."""
    unit = directions / torch.linalg.vector_norm(directions, dim=-1, keepdim=True)
    return positional_encoding(unit, degree)


def jitter_grid(n_out: int, jittered: bool):
    """``(u0, du, jit)`` of the resampler's draws ``u_j = u0 + j du + xi jit``
    (multinerf's ``stepfun.sample``): with a jitter ``xi`` in [0, 1) per ray,
    the grid ``linspace(0, 1 - u_max, n)`` shifted by at most a stride;
    without, the deterministic centres ``linspace(pad, 1 - pad - eps, n)``."""
    if jittered:
        u_max = F32_EPS + (1.0 - F32_EPS) / n_out
        return 0.0, (1.0 - u_max) / (n_out - 1), (1.0 - u_max) / (n_out - 1) - F32_EPS
    pad = 1.0 / (2 * n_out)
    return pad, (1.0 - 2.0 * pad - F32_EPS) / (n_out - 1), 0.0


def one_bin(n_rays: int, like: torch.Tensor):
    """``(s, w)`` of the first round's histogram: the one bin [0, 1]."""
    s = torch.tensor([0.0, 1.0], dtype=like.dtype, device=like.device).expand(n_rays, 2)
    return s, torch.ones((n_rays, 1), dtype=like.dtype, device=like.device)


def resample(s: torch.Tensor, w: torch.Tensor, n_out: int,
             xi: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``(N, n_out + 1)`` endpoints in s-space drawn from the step histogram
    of ``(s (N, n + 1), w (N, n))``: the CDF ``[0, min(1, cumsum(w / sum
    w)[:-1]), 1]`` (uniform where ``sum w`` is not positive), ``n_out``
    centres at the inverse of its piecewise-linear interpolation of
    :func:`jitter_grid`'s draws, then their midpoints with the outer two
    reflected, clipped to [0, 1]."""
    n_in = w.shape[-1]
    total = torch.sum(w, dim=-1, keepdim=True)
    ok = (total > 0) & torch.isfinite(total)
    pdf = torch.where(ok, w / torch.where(ok, total, torch.ones_like(total)),
                      torch.full_like(w, 1.0 / n_in))
    cw = torch.cat([torch.zeros_like(w[:, :1]), torch.cumsum(pdf[:, :-1], dim=-1).clamp_max(1.0),
                    torch.ones_like(w[:, :1])], dim=-1)
    u0, du, jit = jitter_grid(n_out, xi is not None)
    u = u0 + torch.arange(n_out, dtype=w.dtype, device=w.device) * du
    u = u.expand(w.shape[0], n_out)
    if xi is not None:
        u = u + xi.to(w.dtype)[:, None] * jit
    k = (torch.searchsorted(cw.contiguous(), u.contiguous(), right=True) - 1).clamp(0, n_in - 1)
    c0, c1 = torch.gather(cw, 1, k), torch.gather(cw, 1, k + 1)
    s0, s1 = torch.gather(s, 1, k), torch.gather(s, 1, k + 1)
    span = c1 - c0
    frac = torch.where(span > 0, (u - c0) / torch.where(span > 0, span, torch.ones_like(span)),
                       torch.zeros_like(span)).clamp(0.0, 1.0)
    ctr = s0 + frac * (s1 - s0)
    mid = 0.5 * (ctr[:, 1:] + ctr[:, :-1])
    first = (2.0 * ctr[:, :1] - 0.5 * (ctr[:, :1] + ctr[:, 1:2])).clamp_min(0.0)
    last = (2.0 * ctr[:, -1:] - 0.5 * (ctr[:, -2:-1] + ctr[:, -1:])).clamp_max(1.0)
    return torch.cat([first, mid, last], dim=-1)


def interval_weights(density: torch.Tensor, s: torch.Tensor, directions: torch.Tensor,
                     near: float, far: float) -> torch.Tensor:
    """``(N, S)`` compositing weights over the intervals of ``s`` ``(N, S +
    1)`` (multinerf's ``compute_alpha_weights``)."""
    t = s_to_t(s, near, far)
    x = density * (t[:, 1:] - t[:, :-1]) * torch.linalg.vector_norm(directions, dim=-1,
                                                                      keepdim=True)
    trans = torch.exp(-torch.cat([torch.zeros_like(x[:, :1]), torch.cumsum(x[:, :-1], dim=-1)],
                                 dim=-1))
    return (1.0 - torch.exp(-x)) * trans


def charbonnier(col: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """``(N,)`` per ray: ``sum_c sqrt((C - C*)^2 + eps^2)``."""
    d = col - target
    return torch.sum(torch.sqrt(d * d + CHARB_EPS * CHARB_EPS), dim=-1)


def distortion(s: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``(N,)`` eq. 15, ``sum_ij w_i w_j |m_i - m_j| + sum_i w_i^2 (s_{i+1} -
    s_i) / 3`` (``m`` the midpoints), in O(n): the double sum is ``2 sum_i
    w_i (m_i A_i - B_i)``, ``A_i`` and ``B_i`` the sums of ``w`` and ``w m``
    before ``i``."""
    m, ds = 0.5 * (s[:, 1:] + s[:, :-1]), s[:, 1:] - s[:, :-1]
    a = torch.cumsum(w, dim=-1) - w
    b = torch.cumsum(w * m, dim=-1) - w * m
    return 2.0 * torch.sum(w * (m * a - b), dim=-1) + torch.sum(w * w * ds, dim=-1) / 3.0


def outer_bound(t: torch.Tensor, te: torch.Tensor, we: torch.Tensor) -> torch.Tensor:
    """``(N, S)``: for each interval of ``t`` (N, S + 1), the weight ``we``
    of the envelope's intervals (``te``) that overlap it (multinerf's
    ``stepfun.inner_outer``): ``cy[idx_hi(t_{j+1})] - cy[idx_lo(t_j)]``,
    ``cy`` the cumulative sum with a leading 0, ``idx_lo(v)`` the last ``i``
    with ``te_i <= v`` and ``idx_hi(v)`` the first with ``te_i > v``."""
    n = te.shape[-1] - 1
    cy = torch.cat([torch.zeros_like(we[:, :1]), torch.cumsum(we, dim=-1)], dim=-1)
    ge = t[:, :, None] >= te[:, None, :]  # (N, S + 1, n + 1)
    idx = torch.arange(n + 1, device=t.device)
    lo = torch.where(ge, idx, torch.zeros_like(idx)).amax(dim=-1)
    hi = torch.where(~ge, idx, torch.full_like(idx, n)).amin(dim=-1)
    return torch.gather(cy, 1, hi[:, 1:]) - torch.gather(cy, 1, lo[:, :-1])


def interlevel(t: torch.Tensor, w: torch.Tensor, te: torch.Tensor,
               we: torch.Tensor) -> torch.Tensor:
    """``(N,)`` eqs. 13-14: ``sum_j max(0, w_j - bound_j)^2 / (w_j + eps)``
    of the NeRF's ``(t, w)``, both detached, against the proposal's ``(te,
    we)``; its gradient reaches ``we`` alone."""
    t, w = t.detach(), w.detach()
    gap = torch.relu(w - outer_bound(t, te, we))
    return torch.sum(gap * gap / (w + F32_EPS), dim=-1)


def softplus_density(raw: torch.Tensor) -> torch.Tensor:
    """mip-NeRF's density: ``softplus(raw - 1)``."""
    return torch.nn.functional.softplus(raw - 1.0)


def padded_sigmoid(z: torch.Tensor) -> torch.Tensor:
    """mip-NeRF's colour: ``(1 + 2 eps) sigmoid(z) - eps``."""
    return (1.0 + 2.0 * RGB_PAD) * torch.sigmoid(z) - RGB_PAD


def _ident(x):
    return x


def prop_density(net, feats: torch.Tensor, rnd: Callable = _ident) -> torch.Tensor:
    """``(rows,)`` densities of the proposal MLP (ReLU layers, then the
    density head) on ``(rows, 6L)`` IPE features."""
    ws, bs = net["w"], net["b"]
    h = rnd(feats)
    for w, b in zip(ws[:-1], bs[:-1]):
        h = rnd(torch.relu(h @ rnd(w) + b))
    return softplus_density((h @ rnd(ws[-1]) + bs[-1])[:, 0])


def nerf_apply(net, feats: torch.Tensor, enc_d: torch.Tensor, skip_layer: int,
               rnd: Callable = _ident):
    """``(rgb (rows, 3), density (rows,))`` of the NeRF MLP on IPE features
    and the direction encoding: the trunk (layer ``skip_layer`` on ``[h |
    IPE]``), the density head and the bottleneck (one linear layer, stored
    as F's output), the view layer on ``[bottleneck | gamma(d)]``, the rgb
    head; mip-NeRF's activations."""
    ws, bs = net["w"], net["b"]
    trunk = len(ws) - 4
    x = rnd(feats)
    h = x
    for i in range(trunk):
        if i == skip_layer:
            h = torch.cat([h, x], dim=-1)
        h = rnd(torch.relu(h @ rnd(ws[i]) + bs[i]))
    raw = rnd(h @ rnd(ws[trunk]) + bs[trunk])[:, 0]
    bottleneck = rnd(h @ rnd(ws[trunk + 1]) + bs[trunk + 1])
    v = rnd(torch.relu(torch.cat([bottleneck, rnd(enc_d)], dim=-1) @ rnd(ws[trunk + 2])
                       + bs[trunk + 2]))
    return padded_sigmoid(v @ rnd(ws[trunk + 3]) + bs[trunk + 3]), softplus_density(raw)


def encode_intervals(origins, directions, s, config, contracted: bool = True,
                     variance: bool = True) -> torch.Tensor:
    """``(N S, 6L)`` IPE features of the intervals ``s`` ``(N, S + 1)``."""
    t = s_to_t(s, config.near, config.far)
    mean, var = frustum_gaussian(origins, directions, t[:, :-1], t[:, 1:], config.pixel_radius,
                                 contracted)
    return ipe(mean, var, config.num_encoding_functions, variance).reshape(-1, 6 * \
        config.num_encoding_functions)


def prop_round(net, origins, directions, s, config, rnd: Callable = _ident) -> torch.Tensor:
    """One proposal round's ``(N, S)`` weights over the intervals ``s``."""
    density = prop_density(net, encode_intervals(origins, directions, s, config), rnd)
    return interval_weights(density.reshape(s.shape[0], -1), s, directions, config.near,
                            config.far)


def nerf_pass(net, origins, directions, s, config, rnd: Callable = _ident):
    """The NeRF MLP's ``(colours (N, 3), weights (N, S))`` over ``s``."""
    n, S = s.shape[0], s.shape[1] - 1
    enc_d = dir_encoding(directions, config.dir_encoding_functions)
    enc_d = enc_d[:, None, :].expand(n, S, enc_d.shape[-1]).reshape(n * S, -1)
    rgb, density = nerf_apply(net, encode_intervals(origins, directions, s, config), enc_d,
                              config.skip_layer, rnd)
    w = interval_weights(density.reshape(n, S), s, directions, config.near, config.far)
    return torch.sum(w[..., None] * rgb.reshape(n, S, 3), dim=1), w


def split_nets(params, config):
    """``(proposal, nerf)`` of the model's leaves: the proposal's
    ``proposal_layers + 1`` weights first, then the NeRF's."""
    k = config.proposal_layers + 1
    return ({"w": params["w"][:k], "b": params["b"][:k]},
            {"w": params["w"][k:], "b": params["b"][k:]})


def sample_rounds(prop, origins, directions, config, xi=None, rnd: Callable = _ident):
    """The proposal rounds and the NeRF's intervals: ``([(s_k, w_k)], s)``,
    every ``s`` detached; ``xi`` ``(rounds + 1, N)`` the jitters (None:
    the deterministic centres)."""
    s, w = one_bin(origins.shape[0], origins)
    rounds = []
    for k, samples in enumerate(config.proposal_samples):
        s = resample(s, w.detach(), samples, None if xi is None else xi[k]).detach()
        w = prop_round(prop, origins, directions, s, config, rnd)
        rounds.append((s, w))
    s_nerf = resample(s, w.detach(), config.num_samples,
                      None if xi is None else xi[len(rounds)]).detach()
    return rounds, s_nerf


def train_loss(params, origins, directions, target, config, xi=None,
               rnd: Callable = _ident, distortion_mult: float = DISTORTION_MULT):
    """The step's loss under autograd: ``(loss, terms (4,), s_nerf)``, the
    terms the mean Charbonnier over rays and channels, ``distortion_mult``
    times the mean distortion and each round's mean interlevel term."""
    prop, nerf = split_nets(params, config)
    rounds, s3 = sample_rounds(prop, origins, directions, config, xi, rnd)
    col, w = nerf_pass(nerf, origins, directions, s3, config, rnd)
    n = origins.shape[0]
    terms = [torch.sum(charbonnier(col, target)) / (3 * n),
             distortion_mult * torch.sum(distortion(s3, w)) / n]
    terms += [torch.sum(interlevel(s3, w, sk, wk)) / n for sk, wk in rounds]
    terms = torch.stack(terms)
    return torch.sum(terms), terms, s3


def render(params, origins, directions, config, rnd: Callable = _ident) -> torch.Tensor:
    """``(N, 3)`` colours: the rounds at the deterministic centres, then the
    NeRF pass."""
    prop, nerf = split_nets(params, config)
    _, s3 = sample_rounds(prop, origins, directions, config, None, rnd)
    return nerf_pass(nerf, origins, directions, s3, config, rnd)[0]
