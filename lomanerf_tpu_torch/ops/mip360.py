"""mip-NeRF 360 (``NeRFConfig.mipnerf360()``) on the card: the train step and
the render of ``csrc/mip360.cu``, behind autograd, and their CPU route.

A train step (:func:`train_loss`) runs, on CUDA tensors:

1. proposal round 1: 64 intervals drawn from the one bin [0, 1] (the
   resampler, ``mip_resample``), their IPE (``mip_encode``) and the
   proposal MLP with its compositing (``mip_prop_forward``): the weights;
2. proposal round 2: 64 intervals drawn from round 1's histogram, the same;
3. the NeRF: 32 intervals drawn from round 2's, their IPE and gamma(d), the
   NeRF MLP and its compositing (``mip_nerf_forward``): colours and weights;
4. the losses (``mip_losses``): the mean Charbonnier, 0.01 times the mean
   distortion, the mean interlevel term of each round, and their
   cotangents on the colours and on every pass's weights;
5. the backward: ``mip_nerf_backward`` from the colours' and the NeRF
   weights' cotangents, ``mip_prop_backward`` for round 2, then round 1,
   into the packed gradients of both networks.

The forward call gives the loss and every gradient together, as
``_PaperTrainLoss`` does; autograd's backward scales them.  The products
run on the wide chain's kernels (the layer GEMM, d_h, dW), the rest on the
kernels of ``csrc/mip360.cu``.  On CPU tensors the same step is the plain
version (``core.mip360.train_loss`` under autograd, with the kernels'
rounding plan).  On CUDA tensors each entry launches its kernels or raises.

The resampler's jitter, one draw per ray and round, comes from the step's
generator as one ``(3, N)`` uniform draw (no generator: the deterministic
centres, as the render uses).

Spans: ``lomanerf.fused_nerf.train_loss`` and ``.render_rays`` around the
two entry points (every route), ``.pack``, ``.unpack``, ``.backward`` and
``.launch.<entry>`` as in ``ops.fused_nerf``; ``lomanerf.nerf.pass.proposal``
around each proposal round (its forward, and its backward), the resampling
under ``lomanerf.nerf.sample_pdf``, ``lomanerf.nerf.pass.nerf`` around the
NeRF's forward and backward, ``lomanerf.nerf.mip360_loss`` around the three
losses.  Each entry's launches count in ``ops.fused_nerf.launches``.
"""

from __future__ import annotations

import functools
import math

import torch

from lomanerf_tpu_torch.core import mip360 as plain
from lomanerf_tpu_torch.ops import fused_nerf
from lomanerf_tpu_torch.ops.wide_gemm import TILE_ROWS
from lomanerf_tpu_torch.utils.profiling import span, spanned

ENTRIES = ("mip_encode", "mip_resample", "mip_prop_forward", "mip_prop_backward",
           "mip_nerf_forward", "mip_nerf_backward", "mip_losses")
fused_nerf.launches.update({name: 0 for name in ENTRIES})

# the NeRF MLP's packed layers (mip360.cu): the trunk's 8, F ([bottleneck |
# sigma]), the view layer and the rgb head; stored rows, columns and bias
# length; every buffer at row stride NERF_LD
NERF_LD = 1120
NERF_ROWS = (96, 1024, 1024, 1024, 1024, 1120, 1024, 1024, 1024, 296, 128)
NERF_COLS = (1024,) * 8 + (264, 128, 4)
NERF_BIAS = (1024,) * 8 + (264, 128, 8)
NERF_SLOTS = 10  # (rows, NERF_LD) bf16 activation buffers (mip360.cu: mip_acts)
ENC_COL = 1024  # the IPE's first column in X
SIG_COL = 256  # sigma's column in F
DIR_COL = 264  # gamma(d)'s first column in V, and its first row in the view layer
DB_LD = 136  # floats of a ray's column partials (the view layer's, sigma's)
# the proposal MLP's: 4 layers of 256, then the density head (stored 4 wide)
PROP_LD = 256
PROP_ROWS = (96, 256, 256, 256, 256)
PROP_COLS = (256, 256, 256, 256, 4)
PROP_BIAS = (256, 256, 256, 256, 8)
PROP_SLOTS = 5  # the IPE, then each layer's output
HEAD = 4  # columns of a head's f32 d_z
ROW_CHUNK = 8192  # rows per split-K partial (nerf_wide_common.cuh)
RENDER_RAYS = 16384  # rays per render call
PUBLISHED = dict(proposal_layers=4, proposal_width=256, num_layers=8, filter_size=1024,
                 skip_layer=5, bottleneck_width=256, view_width=128,
                 num_encoding_functions=16, dir_encoding_functions=4)


def _offsets(sizes):
    offs, at = [], 0
    for n in sizes:
        offs.append(at)
        at += n
    return tuple(offs), at


def _layout(rows, cols, bias):
    w_off, w_len = _offsets([r * c for r, c in zip(rows, cols)])
    b_off, b_len = _offsets(bias)
    return {"rows": rows, "cols": cols, "w_off": w_off, "w_len": w_len, "b_off": b_off,
            "b_len": b_len}


NERF = _layout(NERF_ROWS, NERF_COLS, NERF_BIAS)
PROP = _layout(PROP_ROWS, PROP_COLS, PROP_BIAS)


def _slots(net: str):
    """Each leaf's place in the packed layout, weights then biases: a
    weight's ``(layer, row blocks, (first column, last + 1))``, a row block
    ``(packed first row, leaf first row, rows)``; a bias's ``(layer,
    columns)``.  The skip layer's leaf is ``[h_5 | IPE]``, as X holds them;
    the view layer's bottleneck rows and direction rows sit apart."""
    if net == "prop":
        w = [(i, [(0, 0, PROP_ROWS[i])], (0, 256)) for i in range(4)]
        w.append((4, [(0, 0, 256)], (0, 1)))
    else:
        w = [(i, [(0, 0, NERF_ROWS[i])], (0, 1024)) for i in range(8)]
        w += [(8, [(0, 0, 1024)], (SIG_COL, SIG_COL + 1)),
              (8, [(0, 0, 1024)], (0, 256)),
              (9, [(0, 0, 256), (DIR_COL, 256, 27)], (0, 128)),
              (10, [(0, 0, 128)], (0, 3))]
    return w, [(layer, cols) for layer, _, cols in w]


@functools.lru_cache(maxsize=None)
def _index(net: str, device):
    """``(packed, w_pos, b_pos)``: the flat positions (weights, then biases,
    one f32 buffer) of every entry of the network's leaves in order, and
    the weights' and the biases' own positions apart, on ``device``."""
    lay = PROP if net == "prop" else NERF
    slots_w, slots_b = _slots(net)
    w_pos = torch.cat([
        (lay["w_off"][layer] + lay["cols"][layer] * torch.arange(r_pack, r_pack + n)[:, None]
         + torch.arange(c0, c1)).reshape(-1)
        for layer, blocks, (c0, c1) in slots_w for r_pack, _, n in blocks])
    b_pos = torch.cat([lay["b_off"][layer] + torch.arange(c0, c1) for layer, (c0, c1) in slots_b])
    return tuple(x.to(device) for x in (torch.cat([w_pos, lay["w_len"] + b_pos]), w_pos, b_pos))


@spanned("lomanerf.fused_nerf.pack")
def pack_params(net: dict, name: str):
    """One network's packed parameters (``mip360.cu``): its layers' weights
    zero-padded to their stored shapes, flat in bf16, and their biases,
    flat in f32; one scatter of every leaf into one f32 buffer, then the
    weights' part rounded."""
    lay = PROP if name == "prop" else NERF
    ws, bs = net["w"], net["b"]
    packed = _index(name, ws[0].device)[0]
    flat = ws[0].new_zeros((lay["w_len"] + lay["b_len"],), dtype=torch.float32)
    flat[packed] = torch.cat([x.detach().reshape(-1) for x in [*ws, *bs]]).to(torch.float32)
    return flat[:lay["w_len"]].to(torch.bfloat16), flat[lay["w_len"]:]


def _unpack(dW, db, leaves, name):
    """The packed f32 gradients back to the leaves' ``(shape, dtype)``."""
    _, w_pos, b_pos = _index(name, dW.device)
    n = len(leaves) // 2
    out = []
    for flat, pos, part in ((dW, w_pos, leaves[:n]), (db, b_pos, leaves[n:])):
        grads = torch.split(flat[pos], [math.prod(shape) for shape, _ in part])
        out += [g.view(shape).to(dtype) for g, (shape, dtype) in zip(grads, part)]
    return out


def _check(config, params) -> None:
    """The kernels take the published widths only (``ValueError``
    otherwise): the plain version takes any."""
    got = {k: getattr(config, k) for k in PUBLISHED}
    if got != PUBLISHED or len(config.proposal_samples) != 2 or \
            max(*config.proposal_samples, config.num_samples) > 128 or \
            min(*config.proposal_samples, config.num_samples) < 2:
        raise ValueError(f"mip360 kernels take NeRFConfig.mipnerf360()'s widths and two "
                         f"proposal rounds of 2-128 intervals; got {config}")
    want = config.leaf_sizes()
    shapes = [tuple(x.shape) for x in params["w"]]
    if shapes != [tuple(s) for s in want]:
        raise ValueError(f"mip360 kernels take leaves {want}; got {shapes}")


def _rnd(config):
    cdt = fused_nerf._DTYPES[config.compute_dtype]
    return lambda x: fused_nerf._rnd(x, cdt) if x.dtype == torch.float32 else x


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _call(entry: str, *args) -> None:
    """One C entry's call, under its launch span, counted in
    ``fused_nerf.launches``."""
    from lomanerf_tpu_torch.ops import build

    with span(f"lomanerf.fused_nerf.launch.{entry}"):
        err = getattr(build.load(), entry)(*args)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {err}")
    fused_nerf.launches[entry] += 1


def _p(x):
    return None if x is None else x.data_ptr()


# ---- the kernels' launchers (CUDA tensors); the faults patch these ----

def resample(s_in, w_in, n_out: int, xi, origins) -> torch.Tensor:
    """``mip_resample``: ``(N, n_out + 1)`` endpoints from the histogram of
    ``(s_in, w_in)`` (None, None: the one bin [0, 1]), jittered by ``xi``
    ``(N,)`` or at the deterministic centres; ``origins`` gives the rays'
    count and device."""
    n, dev = origins.shape[0], origins.device
    n_in = 1 if w_in is None else w_in.shape[1]
    out = torch.empty((n, n_out + 1), dtype=torch.float32, device=dev)
    u0, du, jit = plain.jitter_grid(n_out, xi is not None)
    _call("mip_resample", _p(s_in), _p(w_in), n_in, _p(xi), u0, du, jit, out.data_ptr(), n_out,
          n, _stream(dev))
    return out


def encode(sdist, origins, directions, config, X, ldx: int, colx: int, V=None, ldv: int = 0,
           colv: int = 0, contract: bool = True, variance: bool = True) -> None:
    """``mip_encode``: the IPE of the intervals ``sdist`` into ``X`` and,
    where ``V`` is given, gamma(d) into ``V``."""
    n, S = sdist.shape[0], sdist.shape[1] - 1
    _call("mip_encode", origins.data_ptr(), directions.data_ptr(), sdist.data_ptr(),
          config.pixel_radius, config.near, config.far, X.data_ptr(), ldx, colx, _p(V), ldv,
          colv, n, S, int(contract) | (int(variance) << 1), _stream(origins.device))


def losses(col, target, s3, w3, rounds, distortion_mult: float = plain.DISTORTION_MULT):
    """``mip_losses``: ``(terms (4,), dcol, dw3, [dw_k])``: the mean
    Charbonnier, ``distortion_mult`` times the mean distortion, each round's
    mean interlevel term, and their cotangents."""
    n, S = w3.shape
    (s1, w1), (s2, w2) = rounds
    dev = col.device
    f32 = functools.partial(torch.empty, dtype=torch.float32, device=dev)
    ray_terms, terms, dcol, dw3 = f32((4, n)), f32((4,)), f32((n, 3)), f32((n, S))
    dws = [f32(w1.shape), f32(w2.shape)]
    _call("mip_losses", col.data_ptr(), target.data_ptr(), s3.data_ptr(), w3.data_ptr(), S,
          s1.data_ptr(), w1.data_ptr(), s2.data_ptr(), w2.data_ptr(), w1.shape[1],
          1.0 / (3 * n), distortion_mult / n, 1.0 / n, ray_terms.data_ptr(), terms.data_ptr(),
          dcol.data_ptr(), dw3.data_ptr(), dws[0].data_ptr(), dws[1].data_ptr(), n,
          _stream(dev))
    return terms, dcol, dw3, dws


def _prop_round(Wp, bp, s, origins, directions, config):
    """One proposal round's forward: ``(weights (N, S), acts)``."""
    n, S = s.shape[0], s.shape[1] - 1
    acts = torch.empty(PROP_SLOTS * n * S * PROP_LD, dtype=torch.bfloat16, device=s.device)
    encode(s, origins, directions, config, acts, PROP_LD, 0)
    w = torch.empty((n, S), dtype=torch.float32, device=s.device)
    _call("mip_prop_forward", Wp.data_ptr(), bp.data_ptr(), s.data_ptr(), directions.data_ptr(),
          acts.data_ptr(), w.data_ptr(), n, S, config.near, config.far, _stream(s.device))
    return w, acts


def _nerf_forward(Wn, bn, s, origins, directions, config, want_weights: bool):
    """The NeRF pass's forward: ``(colours (N, 3), weights (N, S) or None,
    acts)``."""
    n, S = s.shape[0], s.shape[1] - 1
    dev = s.device
    rows = n * S
    acts = torch.empty(NERF_SLOTS * rows * NERF_LD, dtype=torch.bfloat16, device=dev)
    # X is slot 0 (the IPE from column 1024), V slot 1 (gamma(d) from 264)
    encode(s, origins, directions, config, acts, NERF_LD, ENC_COL, acts[rows * NERF_LD:],
           NERF_LD, DIR_COL)
    col = torch.empty((n, 3), dtype=torch.float32, device=dev)
    w = torch.empty((n, S), dtype=torch.float32, device=dev) if want_weights else None
    _call("mip_nerf_forward", Wn.data_ptr(), bn.data_ptr(), s.data_ptr(), directions.data_ptr(),
          acts.data_ptr(), col.data_ptr(), _p(w), n, S, config.near, config.far, _stream(dev))
    return col, w, acts


def _scratch(n: int, rows: int, prop_rows: int, dev):
    """The backward's scratch, shared by the three passes' backward calls."""
    def f32(size):
        return torch.empty((size,), dtype=torch.float32, device=dev)

    big = max(rows * NERF_LD, prop_rows * PROP_LD)
    parts = max(-(-rows // ROW_CHUNK) * NERF_ROWS[5] * NERF_COLS[5],
                -(-prop_rows // ROW_CHUNK) * PROP_LD * PROP_LD)
    tiles = max(-(-rows // TILE_ROWS) * NERF_COLS[0], -(-prop_rows // TILE_ROWS) * PROP_LD)
    return {"dz": torch.empty(2 * big, dtype=torch.bfloat16, device=dev),
            "dz_head": f32(max(rows, prop_rows) * HEAD), "db_part": f32(n * max(DB_LD, PROP_LD)),
            "tile_part": f32(tiles), "partials": f32(parts)}


def _sample(Wp, bp, origins, directions, config, xi):
    """The proposal rounds and the NeRF's intervals: ``(rounds, acts,
    s_nerf)``, each round's ``(s, w)`` and activations (``xi`` None: the
    deterministic centres)."""
    rounds, acts_p, s, w = [], [], None, None
    for k, samples in enumerate(config.proposal_samples):
        with span("lomanerf.nerf.sample_pdf"):
            s = resample(s, w, samples, None if xi is None else xi[k], origins)
        with span("lomanerf.nerf.pass.proposal"):
            w, acts = _prop_round(Wp, bp, s, origins, directions, config)
        rounds.append((s, w))
        acts_p.append(acts)
    with span("lomanerf.nerf.sample_pdf"):
        s = resample(s, w, config.num_samples, None if xi is None else xi[len(rounds)], origins)
    return rounds, acts_p, s


def _train_step(Wp, bp, Wn, bn, origins, directions, target, xi, config):
    """Every kernel of one step: ``(loss, terms, s_nerf, dWp, dbp, dWn,
    dbn)``."""
    n, dev = origins.shape[0], origins.device
    rounds, acts_p, s3 = _sample(Wp, bp, origins, directions, config, xi)
    with span("lomanerf.nerf.pass.nerf"):
        col, w3, acts_n = _nerf_forward(Wn, bn, s3, origins, directions, config, True)
    with span("lomanerf.nerf.mip360_loss"):
        terms, dcol, dw3, dws = losses(col, target, s3, w3, rounds)
    S = config.num_samples
    sc = _scratch(n, n * S, max(n * r[1].shape[1] for r in rounds), dev)
    dWn, dbn = _zeros(NERF, dev)
    dWp, dbp = _zeros(PROP, dev)
    with span("lomanerf.nerf.pass.nerf"):
        _nerf_backward(Wn, bn, s3, directions, acts_n, dcol, dw3, sc, dWn, dbn, config)
    del acts_n
    for k in reversed(range(len(rounds))):
        with span("lomanerf.nerf.pass.proposal"):
            _prop_backward(Wp, bp, rounds[k][0], directions, acts_p[k], dws[k], sc, dWp, dbp,
                           config)
    return terms.sum(), terms, s3, dWp, dbp, dWn, dbn


def _zeros(lay, dev):
    """Zero f32 gradients of a packed layout: ``(dW, db)``."""
    return (torch.zeros(lay["w_len"], dtype=torch.float32, device=dev),
            torch.zeros(lay["b_len"], dtype=torch.float32, device=dev))


def _nerf_backward(Wn, bn, s, directions, acts, dcol, dw, sc, dW, db, config) -> None:
    """``mip_nerf_backward``: ``dW``, ``db`` += the NeRF's gradients from the
    colours' and the weights' cotangents."""
    n, S = s.shape[0], s.shape[1] - 1
    _call("mip_nerf_backward", Wn.data_ptr(), bn.data_ptr(), s.data_ptr(), directions.data_ptr(),
          acts.data_ptr(), dcol.data_ptr(), dw.data_ptr(), sc["dz"].data_ptr(),
          sc["dz_head"].data_ptr(), sc["db_part"].data_ptr(), sc["tile_part"].data_ptr(),
          sc["partials"].data_ptr(), dW.data_ptr(), db.data_ptr(), n, S, config.near,
          config.far, _stream(s.device))


def _prop_backward(Wp, bp, s, directions, acts, dw, sc, dW, db, config) -> None:
    """``mip_prop_backward``: ``dW``, ``db`` += one proposal round's
    gradients from its weights' cotangent."""
    n, S = s.shape[0], s.shape[1] - 1
    _call("mip_prop_backward", Wp.data_ptr(), bp.data_ptr(), s.data_ptr(), directions.data_ptr(),
          acts.data_ptr(), dw.data_ptr(), sc["dz"].data_ptr(), sc["dz_head"].data_ptr(),
          sc["db_part"].data_ptr(), sc["tile_part"].data_ptr(), sc["partials"].data_ptr(),
          dW.data_ptr(), db.data_ptr(), n, S, config.near, config.far, _stream(s.device))


class _Mip360TrainLoss(torch.autograd.Function):
    """The whole step behind autograd: forward runs every kernel, which
    gives the loss, its terms, the NeRF's intervals and every gradient of
    both networks (packed), and keeps the gradients; backward scales them by
    the loss's cotangent and unpacks them."""

    @staticmethod
    def forward(ctx, origins, directions, target, xi, config, *wb):
        k = len(wb) // 2
        params = {"w": list(wb[:k]), "b": list(wb[k:])}
        prop, nerf = plain.split_nets(params, config)
        Wp, bp = pack_params(prop, "prop")
        Wn, bn = pack_params(nerf, "nerf")
        loss, terms, s3, dWp, dbp, dWn, dbn = _train_step(Wp, bp, Wn, bn, origins, directions,
                                                          target, xi, config)
        ctx.save_for_backward(dWp, dbp, dWn, dbn)
        ctx.config = config
        ctx.leaves = [(x.shape, x.dtype) for x in wb]
        ctx.mark_non_differentiable(terms, s3)
        return loss, terms, s3

    @staticmethod
    @spanned("lomanerf.fused_nerf.backward")
    def backward(ctx, g, _g_terms, _g_s):
        dWp, dbp, dWn, dbn = ctx.saved_tensors
        leaves, cfg = ctx.leaves, ctx.config
        k = len(leaves) // 2
        np_ = cfg.proposal_layers + 1
        with span("lomanerf.fused_nerf.unpack"):
            gp = _unpack(dWp * g, dbp * g, leaves[:np_] + leaves[k:k + np_], "prop")
            gn = _unpack(dWn * g, dbn * g, leaves[np_:k] + leaves[k + np_:], "nerf")
        grads = gp[:np_] + gn[:k - np_] + gp[np_:] + gn[k - np_:]
        return (None,) * 5 + tuple(grads)


def draw_jitter(config, n: int, generator):
    """``(rounds + 1, N)`` uniform jitters from ``generator`` (None without
    one)."""
    if generator is None:
        return None
    return torch.rand((len(config.proposal_samples) + 1, n), generator=generator,
                      device=generator.device)


@spanned("lomanerf.fused_nerf.train_loss")
def train_loss(params, origins, directions, target, config, generator=None):
    """The mip-NeRF 360 train loss of one ray batch: ``(loss, aux)``, the
    loss differentiable w.r.t. both networks' leaves, ``aux`` the loss's
    four terms ``(4,)`` (Charbonnier, distortion, round 1's and round 2's
    interlevel) and the NeRF's intervals ``(N, S + 1)``, detached.  On CUDA
    tensors :class:`_Mip360TrainLoss`; on CPU tensors the plain version
    with the kernels' rounding plan."""
    origins, directions, target = (x.detach() for x in (origins, directions, target))
    xi = draw_jitter(config, origins.shape[0], generator)
    if origins.device.type == "cpu":
        loss, terms, s3 = plain.train_loss(params, origins, directions, target, config, xi,
                                           _rnd(config))
        return loss, {"terms": terms.detach(), "sdist": s3}
    if origins.device.type != "cuda":
        raise NotImplementedError(f"no train loss for device {origins.device}")
    _check(config, params)
    f32 = fused_nerf._f32
    loss, terms, s3 = _Mip360TrainLoss.apply(f32(origins), f32(directions), f32(target),
                                             None if xi is None else xi.contiguous(), config,
                                             *params["w"], *params["b"])
    return loss, {"terms": terms, "sdist": s3}


@spanned("lomanerf.fused_nerf.render_rays")
def render_rays(params, origins, directions, config) -> torch.Tensor:
    """``(N, 3)`` colours, no gradient: the rounds at the deterministic
    centres, then the NeRF pass; on CUDA tensors in calls of
    ``RENDER_RAYS`` rays, on CPU tensors the plain version."""
    origins, directions = (x.detach() for x in (origins, directions))
    if origins.device.type == "cpu":
        with torch.no_grad():
            return plain.render(params, origins, directions, config, _rnd(config))
    if origins.device.type != "cuda":
        raise NotImplementedError(f"no render for device {origins.device}")
    _check(config, params)
    prop, nerf = plain.split_nets(params, config)
    Wp, bp = pack_params(prop, "prop")
    Wn, bn = pack_params(nerf, "nerf")
    cols = []
    with torch.no_grad():
        for o, d in zip(fused_nerf._f32(origins).split(RENDER_RAYS),
                        fused_nerf._f32(directions).split(RENDER_RAYS)):
            o, d = o.contiguous(), d.contiguous()
            s = _sample(Wp, bp, o, d, config, None)[2]
            with span("lomanerf.nerf.pass.nerf"):
                cols.append(_nerf_forward(Wn, bn, s, o, d, config, False)[0])
    return torch.cat(cols)
