"""``kind: "train_mip360"`` — a closed loop of mip-NeRF 360's Adam steps.

Each step draws one of ``views`` training views and ``rays_per_step`` of
its pixels (one from each of as many equal runs of the view's pixels, as
``loops/train.py`` draws them), then runs one
``train.steps.make_single_chip_train_step`` step: proposal round 1 (the
intervals drawn from the one bin [0, 1]), round 2 (drawn from round 1's
weights), the NeRF MLP on the intervals drawn from round 2's, the three
losses and one Adam update of both networks; and reads the loss back.  The
resampler's jitter comes from the step's generator.

Spans: ``bench.train_step`` around a whole step, ``bench.draw`` around its
draw.

The numbers that decide ``correct`` are the train kind's (``loops/train.py``;
``grad_gap`` against the larger of a leaf's own norm and ``GAP_FLOOR`` of the
median leaf's, as ``loops/train_paper.py`` takes it: a head's bias is one
scalar, a sum that can nearly cancel), ``grad_gap``, ``grad_error`` and
``head_error`` (the density and rgb heads) over the NeRF MLP's leaves,
``change_gap`` over both networks', with:

* ``prop_grad_error`` — the proposal MLP's first gradient, all its leaves
  as one vector, ``|g - g_ref| / |g_ref|``.  Its only signal is the
  interlevel hinge ``max(0, w - bound)``: where the NeRF's weights sit near
  the proposal's bound, rounding turns hinges on and off, and on one seed
  of 28 (3500000017) it read 13% apart (its leaves 5-18% each, as far as
  the float8 control's) where the NeRF's leaves read below 3.5%; held by
  the worst leaf with the NeRF's, that seed would fail.  Neither it nor
  ``grad_gap`` (the NeRF's density head reads up to 3.3% apart, the
  control 5-10%) tells the precisions apart, so their limits sit between
  the program's readings and the unchanged state's 1 (``change_gap``'s
  rule); the control fails the other numbers;
* ``loss_gap`` — the first step's whole loss, ``|p - r| / |r|``;
* ``terms_gap`` — the same of each of its three terms (Charbonnier, 0.01
  times the distortion, the two rounds' interlevel terms together), the
  worst of the three.  The interlevel term squares the NeRF weights' excess
  over the proposal's bound, so rounding moves it by up to about 1.5% (in
  calibration on the card), ten times as much as the whole loss: held
  together, the whole loss could not tell a loss read back 1% high;
* ``interval_gap`` — the first step's NeRF intervals, the 33 endpoints a
  ray after two rounds, ``mean |s - s_ref|`` in units of the first round's
  bins (``1 / proposal_samples[0]``).  The resampler is continuous in the
  weights, so rounding moves an endpoint by about the weights' rounding;
  intervals drawn from another histogram move by a good part of a bin.

The reference (``reference/mip360.py``) works out the jitter again from its
seed.

``work`` counts both networks' forward, dW and ``d_h`` (every leaf but each
network's first, ``d_h`` onto the columns it reaches: the skip layer's onto
h_5's 1024, the view layer's onto the bottleneck's 256) on the proposal's
``2 x rays x 64`` rows and the NeRF's ``rays x 32``, and, under
``kernels``, the operations and bytes of each kernel of ``mip360.cu`` a
step, which their roofline metrics read.
"""

from __future__ import annotations

import math
import statistics

import torch
from torch.profiler import record_function

from benchmark import scene, workloads
from benchmark.reference import mip360 as ref_mip
from benchmark.reference import nerf as ref
from lomanerf_tpu_torch.models import NeRFModel
from lomanerf_tpu_torch.ops import mip360
from lomanerf_tpu_torch.train.steps import make_single_chip_train_step

DRAW_SPAN = "bench.draw"
MOVING = 1e-3
GAP_FLOOR = 0.1
NAMES = ("loss_gap", "terms_gap", "grad_gap", "grad_error", "head_error", "prop_grad_error",
         "change_gap", "interval_gap")


def net_sizes(model: dict):
    """``(proposal, nerf)`` per-leaf ``(fan_in, fan_out)``: the proposal's
    layers and density head; the NeRF's trunk (the skip layer on ``[h |
    IPE]``), density head, bottleneck, view layer and rgb head."""
    ipe = 6 * model["num_encoding_functions"]
    pw, fan_in, prop = model["proposal_width"], ipe, []
    for _ in range(model["proposal_layers"]):
        prop.append((fan_in, pw))
        fan_in = pw
    prop.append((pw, 1))
    width, fan_in, nerf = model["filter_size"], ipe, []
    for i in range(model["num_layers"]):
        nerf.append((width + ipe if i == model["skip_layer"] else fan_in, width))
        fan_in = width
    b, v = model["bottleneck_width"], model["view_width"]
    nerf += [(width, 1), (width, b), (b + 3 * (1 + 2 * model["dir_encoding_functions"]), v),
             (v, 3)]
    return prop, nerf


def init_params(gen: torch.Generator, model: dict, device) -> dict:
    """mip-NeRF 360's init as the port applies it, restated: He-normal
    weights (std ``sqrt(2 / fan_in)``) drawn leaf by leaf, the proposal's
    first, and zero biases; float32 on ``device``."""
    prop, nerf = net_sizes(model)
    sizes = prop + nerf
    ws = [(torch.randn((fi, fo), generator=gen, device=gen.device) * math.sqrt(2.0 / fi))
          .to(device) for fi, fo in sizes]
    return {"w": ws, "b": [torch.zeros(fo, device=device) for _, fo in sizes]}


def work(model: dict, traffic: dict) -> dict:
    """One step: forward, dW and ``d_h`` of both networks on their rows;
    bytes as ``counts.train_step`` counts them.  ``kernels``: per kernel of
    ``mip360.cu``, its multiply-adds and bytes a step, each input read once
    and each output written once:

    * ``mip_encode_kernel``: a row reads its two endpoints and writes the
      IPE (96 bf16) and, in the NeRF pass, gamma(d) with its zeros (32);
      each pass reads each ray's origin and direction;
    * ``mip_resample_kernel``: per ray, each call reads the histogram (its
      endpoints and weights; none for the one bin) and the jitter and
      writes the new endpoints;
    * ``mip_prop_composite_kernel`` (two rounds, forward and backward):
      forward, a row reads the top layer's 256 outputs (bf16) and writes its
      weight, a ray reads its endpoints and direction; backward, a row
      reads the outputs again and its weight's cotangent and writes the
      head's f32 d_z (16 B) and the top layer's bf16 d_z, a ray writes its
      256 column partials; MACs the head's 256 a row, twice backward;
    * ``mip_composite_kernel`` (the NeRF's, forward and backward): a row
      reads the view layer's 128 outputs and sigma_raw and writes its
      weight; backward reads them again and the weight's cotangent and
      writes the head's f32 d_z, sigma's d_z with F's 7 zero columns (8
      bf16) and the view layer's bf16 d_z; a ray reads its endpoints and
      direction each time, its colour's cotangent once, writes its colour
      and its 136 column partials; MACs the rgb head's 384 a row, twice
      backward;
    * ``mip_loss_kernel``: a ray reads its colour and target, the three
      passes' endpoints and weights, and writes its four terms and every
      cotangent."""
    prop, nerf = net_sizes(model)
    n = traffic["rays_per_step"]
    sp, s = model["proposal_samples"], model["num_samples"]
    rows_p, rows_n = n * sum(sp), n * s

    def macs_of(sizes, cut, width):
        fwd = sum(fi * fo for fi, fo in sizes)
        d_h = sum((width[cut.index(i)] if i in cut else fi) * fo
                  for i, (fi, fo) in enumerate(sizes) if i)
        return 2 * fwd + d_h

    view = model["num_layers"] + 2
    macs = rows_p * macs_of(prop, (), ()) + rows_n * macs_of(
        nerf, (model["skip_layer"], view), (model["filter_size"], model["bottleneck_width"]))
    n_params = sum(fi * fo + fo for fi, fo in prop + nerf)
    pw, vw = model["proposal_width"], model["view_width"]
    ipe = 6 * model["num_encoding_functions"]
    resample = n * ((4 + 4 * (sp[0] + 1))
                    + sum(4 * (a + 1) + 4 * a + 4 + 4 * (b + 1)
                          for a, b in zip(sp, list(sp[1:]) + [s])))
    return {"macs": macs, "bytes": n * 36 + n_params * 8, "kernels": {
        "mip_encode_kernel": {"macs": 0, "bytes": rows_p * (8 + 2 * ipe)
                              + rows_n * (8 + 2 * ipe + 64) + (len(sp) + 1) * n * 24},
        "mip_resample_kernel": {"macs": 0, "bytes": resample},
        "mip_prop_composite_kernel": {
            "macs": rows_p * pw * 3,
            "bytes": rows_p * (2 * pw + 4 + 2 * pw + 4 + 16 + 2 * pw)
            + 2 * sum(n * (4 * (a + 1) + 12) for a in sp) + len(sp) * n * 4 * pw},
        "mip_composite_kernel": {
            "macs": rows_n * vw * 3 * 3,
            "bytes": rows_n * (2 * vw + 2 + 4 + 2 * vw + 2 + 4 + 16 + 16 + 2 * vw)
            + 2 * n * (4 * (s + 1) + 12) + n * (12 + 12 + 4 * (vw + 8))},
        "mip_loss_kernel": {
            "macs": 0,
            "bytes": n * (24 + 4 * (2 * s + 1) + sum(4 * (2 * a + 1) for a in sp) + 16 + 12
                          + 4 * s + sum(4 * a for a in sp))},
    }}


class Loop(workloads.Loop):
    metric = "train_step_ms"
    span = "bench.train_step"

    def __init__(self, cell, seed: int, device):
        # the base set-up builds a plain chain: this model has its own leaves
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.model_spec, self.traffic = cell.model, cell.traffic
        self.cfg = workloads.program_config(self.model_spec)
        self.gen = scene.generator(seed, "scene", self.device)
        self.focal = scene.focal(self.traffic["camera_angle_x"])
        self.init = init_params(self.gen, self.model_spec, self.device)
        self.model = NeRFModel(self.cfg, device=self.device)
        self.model.load_params(self.init)
        t = self.traffic
        poses = scene.train_poses(self.gen, t["views"], t["radius"])
        cam = scene.camera_directions(t["side"], self.focal, self.device)
        o, d = scene.rays(poses, cam)
        self.pixels = cam.shape[0]
        self.all_o, self.all_d = o.view(-1, 3), d.view(-1, 3)
        self.all_t = torch.rand(self.all_o.shape, generator=self.gen, device=self.gen.device)
        opt = self.cell.config["optimizer"]
        self.opt = torch.optim.Adam(self.model.parameters(), lr=opt["lr"],
                                    betas=tuple(opt["betas"]), eps=opt["eps"])
        self.draw_gen = scene.generator(seed, "draw", self.device)
        self.step_fn = make_single_chip_train_step(
            self.cfg, self.opt, generator=scene.generator(seed, "jitter", self.device))
        n = t["rays_per_step"]
        self.strata = torch.arange(n, dtype=torch.float32, device=self.device) \
            * (self.pixels / n)

    def leaves(self):
        return [*self.model.w, *self.model.b]

    def draw(self):
        """``(origins, directions, targets)`` of one batch."""
        t = self.traffic
        n = t["rays_per_step"]
        with record_function(DRAW_SPAN):
            view = torch.randint(t["views"], (1,), generator=self.draw_gen,
                                 device=self.device)
            u = torch.rand((n,), generator=self.draw_gen, device=self.device)
            pix = (self.strata + u * (self.pixels / n)).long().clamp_max_(self.pixels - 1)
            rows = view * self.pixels + pix
            return self.all_o[rows], self.all_d[rows], self.all_t[rows]

    def step(self):
        with record_function(self.span):
            o, d, tgt = self.draw()
            loss = float(self.step_fn(self.model, o, d, None, None, tgt))
        return loss, (o, d, tgt)

    def item(self) -> bool:
        return math.isfinite(self.step()[0])

    def first(self) -> None:
        """As the train kind's: the first ``check_steps`` steps through the
        window's own call, then ``warmup_steps`` more.  Keeps each checked
        step's batch and loss, the first step's loss terms and NeRF
        intervals, the first gradient as Adam holds it after one step and
        its norm per leaf, and each leaf's change after the checked steps."""
        beta1 = self.cell.config["optimizer"]["betas"][0]
        self.batches, self.losses = [], []
        for k in range(self.traffic["check_steps"]):
            if k == 0:
                loss, batch, self.aux = self.recording_aux()
            else:
                loss, batch = self.step()
            self.losses.append(loss)
            self.batches.append(batch)
            if k == 0:
                self.first_grads = [
                    self.opt.state[p]["exp_avg"] / (1.0 - beta1) if self.opt.state.get(p)
                    else torch.zeros_like(p) for p in self.leaves()]
                self.grad_norms = workloads.norms(self.first_grads)
        start = [*self.init["w"], *self.init["b"]]
        self.change_norms = workloads.norms(p - p0 for p, p0 in zip(self.leaves(), start))
        for _ in range(self.traffic["warmup_steps"]):
            self.step()

    def recording_aux(self):
        """One step, keeping the loss terms and the NeRF intervals that
        ``ops.mip360.train_loss`` (whatever stands there) handed back."""
        call, kept = mip360.train_loss, []

        def recording(*args, **kwargs):
            out = call(*args, **kwargs)
            kept.append({k: v.detach().clone() for k, v in out[1].items()})
            return out

        with workloads.patched(mip360, "train_loss", recording):
            loss, batch = self.step()
        return loss, batch, kept[0]

    def free(self) -> None:
        self.model = self.opt = self.step_fn = None
        self.all_o = self.all_d = self.all_t = None

    def reference(self, plan=ref.EXACT) -> dict:
        """The plain reference over the checked steps, the jitter worked out
        again from its seed."""
        ref.set_exact()
        m = self.model_spec
        jitter = scene.generator(self.seed, "jitter", self.device)
        batches = [(o, d, tgt, torch.rand((len(m["proposal_samples"]) + 1, o.shape[0]),
                                          generator=jitter, device=jitter.device))
                   for o, d, tgt in self.batches]
        out = ref_mip.train(self.init, batches, m, self.cell.config["optimizer"], plan)
        return {"losses": [sum(t) for t in out["terms"]], "terms": out["terms"][0],
                "first_grads": out["first_grads"],
                "grad_norms": workloads.norms(out["first_grads"]),
                "change_norms": workloads.norms(out["changes"]), "sdist": out["sdist"],
                "bin": 1.0 / m["proposal_samples"][0]}

    def outputs(self) -> dict:
        return {"losses": self.losses, "terms": [float(x) for x in self.aux["terms"]],
                "first_grads": self.first_grads, "grad_norms": self.grad_norms,
                "change_norms": self.change_norms, "sdist": self.aux["sdist"]}


def head_leaves(n_leaves: int) -> list:
    """Indices of the NeRF's density and rgb heads' weights and biases among
    a model's ``n_leaves`` leaves (weights, then biases; the NeRF's 12 of
    each last)."""
    n_w = n_leaves // 2
    heads = [n_w - 4, n_w - 1]
    return heads + [n_w + i for i in heads]


def proposal_leaves(n_leaves: int) -> list:
    """Indices of the proposal MLP's weights and biases (each network's
    leaves in order, the proposal's first, the NeRF's 12 of each last)."""
    n_w = n_leaves // 2
    return [i for i in range(n_w - 12)] + [n_w + i for i in range(n_w - 12)]


def _terms3(terms):
    """Charbonnier, distortion, the interlevel terms together."""
    return [terms[0], terms[1], sum(terms[2:])]


def numbers(prog: dict, ref_out: dict) -> dict:
    median = statistics.median(ref_out["grad_norms"])
    keep = [i for i, g in enumerate(ref_out["grad_norms"]) if g >= median * MOVING]
    errors = [float(torch.linalg.vector_norm((p.double() - r.double()).ravel()))
              for p, r in zip(prog["first_grads"], ref_out["first_grads"])]
    gaps = [abs(p - r) / max(r, GAP_FLOOR * median)
            for p, r in zip(prog["grad_norms"], ref_out["grad_norms"])]
    change = [abs(prog["change_norms"][i] - ref_out["change_norms"][i])
              / max(ref_out["change_norms"][i], 1e-30) for i in keep]
    prop = proposal_leaves(len(errors))
    nerf = [i for i in range(len(errors)) if i not in prop]
    head = head_leaves(len(errors))

    def joint(idx):  # the norm of the leaves' errors (or references) together
        return sum(errors[i] ** 2 for i in idx) ** 0.5

    ref_norm = [float(torch.linalg.vector_norm(g.double())) for g in ref_out["first_grads"]]
    return {
        "loss_gap": abs(prog["losses"][0] - ref_out["losses"][0]) / abs(ref_out["losses"][0]),
        "terms_gap": max(abs(p - r) / max(abs(r), 1e-30)
                         for p, r in zip(_terms3(prog["terms"]), _terms3(ref_out["terms"]))),
        "grad_gap": max(gaps[i] for i in keep if i in nerf),
        "grad_error": max(errors[i] / max(ref_out["grad_norms"][i], median, 1e-30)
                          for i in nerf),
        "head_error": joint(head) / max(sum(ref_norm[i] ** 2 for i in head) ** 0.5, 1e-30),
        "prop_grad_error": joint(prop) / max(sum(ref_norm[i] ** 2 for i in prop) ** 0.5,
                                             1e-30),
        "change_gap": statistics.median(change),
        "interval_gap": float(_interval_gaps(prog, ref_out).mean()),
    }


def _interval_gaps(prog: dict, ref_out: dict) -> torch.Tensor:
    """``|s - s_ref|`` in first-round bins, over the rays both hold (a
    program that ran fewer rays is held on its own)."""
    n = min(prog["sdist"].shape[0], ref_out["sdist"].shape[0])
    return (prog["sdist"][:n].double() - ref_out["sdist"][:n].double()).abs() / ref_out["bin"]


def look(prog: dict, ref_out: dict) -> dict:
    """Each leaf's gaps against its own norm, each term's and each checked
    step's loss gap, the largest interval gap."""
    leaves = {k: [round(abs(p - r) / max(r, 1e-30), 6) for p, r in zip(prog[k], ref_out[k])]
              for k in ("grad_norms", "change_norms")}
    leaves["grad_errors"] = [round(float((p - r).norm() / r.norm().clamp_min(1e-30)), 6)
                             for p, r in zip(prog["first_grads"], ref_out["first_grads"])]
    leaves["ref_grad_norms"] = [float(f"{g:.4g}") for g in ref_out["grad_norms"]]
    return {"leaves": leaves, "interval_gap_max": float(_interval_gaps(prog, ref_out).max()),
            "terms": prog["terms"], "ref_terms": ref_out["terms"],
            "term_gaps": [abs(p - r) / max(abs(r), 1e-30)
                          for p, r in zip(prog["terms"], ref_out["terms"])],
            "step_loss_gaps": [abs(p - r) / abs(r) for p, r in zip(prog["losses"],
                                                                    ref_out["losses"])]}


def control_outputs(control: dict) -> dict:
    return control


# ---- the faults that a cell of this kind can have ----

def unchanged_state():
    """The step returns without updating the parameters or Adam's state."""
    return workloads.patched(torch.optim.Adam, "step", lambda self, closure=None: None)


def _loss_patched(fn):
    return workloads.patched(mip360, "train_loss", fn)


def half_batch():
    """The loss covers the first half of the rays only (its mean over them,
    as a mean over the batch would give)."""
    train = mip360.train_loss

    def train_half(params, origins, directions, target, config, generator=None):
        h = origins.shape[0] // 2
        return train(params, origins[:h], directions[:h], target[:h], config, generator)

    return _loss_patched(train_half)


def answer_altered():
    """The loss read back 1% high."""
    train = mip360.train_loss

    def train_high(*args, **kwargs):
        loss, aux = train(*args, **kwargs)
        return loss * 1.01, aux

    return _loss_patched(train_high)


class _HalfGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return 0.5 * g


def bias_grad_halved():
    """The NeRF trunk's bias gradients (the column sums) come out halved."""
    train = mip360.train_loss

    def train_db_half(params, *args, **kwargs):
        k = len(params["b"]) - 12  # the proposal's leaves come first
        b = [_HalfGrad.apply(x) if k <= i < k + 8 else x for i, x in enumerate(params["b"])]
        return train({"w": params["w"], "b": b}, *args, **kwargs)

    return _loss_patched(train_db_half)


def proposal_ignored():
    """Each round resamples from equal weights on the previous intervals
    (the one bin's round as it is), not from the proposal's weights."""
    draw = mip360.resample

    def even(s_in, w_in, n_out, xi, origins):
        return draw(s_in, None if w_in is None else torch.ones_like(w_in), n_out, xi, origins)

    return workloads.patched(mip360, "resample", even)


def distortion_dropped():
    """The loss leaves out the distortion term (and its cotangent)."""
    losses = mip360.losses

    def without(*args, **kwargs):
        return losses(*args, **{**kwargs, "distortion_mult": 0.0})

    return workloads.patched(mip360, "losses", without)


def _encode_patched(**flags):
    encode = mip360.encode
    return workloads.patched(mip360, "encode",
                             lambda *args, **kwargs: encode(*args, **{**kwargs, **flags}))


def contraction_off():
    """The Gaussians are encoded where they lie, without the contraction."""
    return _encode_patched(contract=False)


def ipe_variance_dropped():
    """Plain sin and cos of the Gaussians' means, no damping by their
    variance."""
    return _encode_patched(variance=False)


FAULTS = {"unchanged_state": unchanged_state, "half_batch": half_batch,
          "answer_altered": answer_altered, "bias_grad_halved": bias_grad_halved,
          "proposal_ignored": proposal_ignored, "distortion_dropped": distortion_dropped,
          "contraction_off": contraction_off, "ipe_variance_dropped": ipe_variance_dropped}
