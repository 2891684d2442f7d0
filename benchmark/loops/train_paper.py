"""``kind: "train_paper"`` — a closed loop of the published NeRF's Adam steps.

Each step draws one of ``views`` training views and ``rays_per_step`` of
its pixels (one from each of as many equal runs of the view's pixels, as
``loops/train.py`` draws them), their stratified coarse depths
(``NeRFModel.sample(generator=)``: a uniform draw in each of the
``num_samples`` bins), then runs one ``train.steps.make_single_chip_train_step``
step: the coarse pass, the fine depths drawn from its detached weights (the
step's generator), the fine pass on the sorted union and one Adam update of
both networks; and reads the loss back.

Spans: ``bench.train_step`` around a whole step, ``bench.draw`` around its
draw and coarse depths.

The numbers that decide ``correct`` are the train kind's (``loops/train.py``:
the first checked steps of both networks' leaves, as Adam saw them), with
``head_error`` over the density and rgb heads of both networks, weights and
biases together; ``grad_gap`` takes each leaf against the larger of its own
norm and ``GAP_FLOOR`` of the median leaf's: the density head's bias is one
scalar, the sum of every sample's density derivative, and on 3 of 8 seeds
that sum nearly cancelled (2e-3 to 7e-3 of the median leaf) and read 13-80%
apart on rounding alone against its own norm.  And one of the sampler's:

* ``depth_gap`` — the first checked step's fine depths (the sorted union the
  fine pass ran on), ``mean |t - t_ref|`` over every ray and sample, in
  coarse bins (``(far - near) / num_samples``).  The inverse transform is
  continuous in the coarse weights, so rounding moves a depth by about the
  weights' rounding times the span; depths drawn from another density move
  by a good part of a bin.  The train numbers barely see that at these
  seeded weights: the fine pass's gradients part by a few % at most.

The reference (``reference/nerf_paper.py``) works out the coarse depths'
jitter and the fine draws again from their seeds.

``work`` counts both passes' forward, dW and ``d_h`` of every leaf but the
first (``counts.py``'s count, ``d_h`` onto the columns it reaches) from the
layer shapes, and, under
``kernels``, the operations and bytes of the two kernels that only this
model runs (``nerf_paper.cu``), which their roofline metrics read.
"""

from __future__ import annotations

import math
import statistics

import torch
from torch.profiler import record_function

from benchmark import scene, workloads
from benchmark.reference import nerf as ref
from benchmark.reference import nerf_paper as ref_paper
from lomanerf_tpu_torch.core import rays
from lomanerf_tpu_torch.models import NeRFModel
from lomanerf_tpu_torch.ops import fused_nerf
from lomanerf_tpu_torch.train.steps import make_single_chip_train_step

DRAW_SPAN = "bench.draw"
MOVING = 1e-3
GAP_FLOOR = 0.1
NAMES = ("loss_gap", "grad_gap", "grad_error", "head_error", "change_gap", "depth_gap")


def net_sizes(model: dict) -> list:
    """Per-leaf ``(fan_in, fan_out)`` of one network: the trunk, then the
    density head, the feature layer, the view layer and the rgb head."""
    in_x = 3 * (1 + 2 * model["num_encoding_functions"])
    in_d = 3 * (1 + 2 * model["dir_encoding_functions"])
    width, sizes, fan_in = model["filter_size"], [], in_x
    for i in range(model["num_layers"]):
        sizes.append((in_x + width if i == model["skip_layer"] else fan_in, width))
        fan_in = width
    return sizes + [(width, 1), (width, width), (width + in_d, model["view_width"]),
                    (model["view_width"], 3)]


def init_params(gen: torch.Generator, model: dict, device) -> dict:
    """NeRF's init as the port applies it to this model, restated: for the
    coarse and then the fine network, He-normal weights drawn in one call,
    zero biases, the density and rgb heads' weights times 0.1 and a +0.5
    density bias; float32 on ``device``."""
    sizes = net_sizes(model)
    ws, bs = [], []
    for _ in range(2):
        flat = torch.randn((sum(fi * fo for fi, fo in sizes),), generator=gen,
                           device=gen.device).to(device)
        at, net_w = 0, []
        for fi, fo in sizes:
            net_w.append(flat[at:at + fi * fo].view(fi, fo) * math.sqrt(2.0 / fi))
            at += fi * fo
        density, rgb = len(sizes) - 4, len(sizes) - 1
        for i in (density, rgb):
            net_w[i] = net_w[i] * 0.1
        net_b = [torch.zeros(fo, device=device) for _, fo in sizes]
        net_b[density][0] = 0.5
        ws += net_w
        bs += net_b
    return {"w": ws, "b": bs}


def work(model: dict, traffic: dict) -> dict:
    """One step: forward, dW and ``d_h`` of every leaf but the first, on the
    coarse pass's ``rays x num_samples`` rows and the fine pass's ``rays x
    (num_samples + num_fine_samples)``; ``d_h`` counted onto the columns it
    reaches (the skip layer's onto h_5's ``filter_size``, not gamma(x)'s;
    the view layer's onto the feature's, not gamma(d)'s); bytes as
    ``counts.train_step`` counts them.  ``kernels``: per kernel that only
    this model runs, its multiply-adds and bytes a step:
    ``paper_encode_kernel`` reads a row's depth and writes its two encodings
    (bf16) and reads each ray once; ``paper_composite_kernel`` (train) reads
    a row's 128 view outputs, its density and step and writes the head's
    f32 d_z, the view layer's bf16 d_z, the density's d_z with F's 7 zero
    columns past it (8 bf16), and the coarse pass's weight, and per ray
    reads the ray and target and writes its loss and its column partials;
    the rgb head forward and its d_z are its MACs."""
    sizes = net_sizes(model)
    rays_n = traffic["rays_per_step"]
    coarse = rays_n * model["num_samples"]
    rows = coarse + rays_n * (model["num_samples"] + model["num_fine_samples"])
    fwd = sum(fi * fo for fi, fo in sizes)
    cut = (model["skip_layer"], model["num_layers"] + 2)  # the skip and view layers
    d_h = sum((model["filter_size"] if i in cut else fi) * fo
              for i, (fi, fo) in enumerate(sizes) if i)
    macs = rows * (2 * fwd + d_h)
    n_params = 2 * sum(fi * fo + fo for fi, fo in sizes)
    view = model["view_width"]
    enc = sizes[0][0] + 1 + sizes[-2][0] - model["filter_size"]  # gamma(x), its zero, gamma(d)
    return {"macs": macs, "bytes": rays_n * 36 + n_params * 8, "kernels": {
        "paper_encode_kernel": {"macs": 0, "bytes": rows * (4 + 2 * enc) + 2 * rays_n * 24},
        "paper_composite_kernel": {
            "macs": rows * 2 * view * 3,
            "bytes": rows * (2 * view + 2 + 4 + 16 + 2 * view + 16) + coarse * 4
            + 2 * rays_n * (12 + 4 + 4 * (view + 8))},
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
        self.comb_gen = scene.generator(seed, "comb", self.device)
        self.step_fn = make_single_chip_train_step(
            self.cfg, self.opt, generator=scene.generator(seed, "pdf", self.device))
        n = t["rays_per_step"]
        self.strata = torch.arange(n, dtype=torch.float32, device=self.device) \
            * (self.pixels / n)

    def leaves(self):
        return [*self.model.w, *self.model.b]

    def draw(self):
        """``(origins, directions, targets, coarse depths, coarse steps)`` of
        one batch."""
        t = self.traffic
        n = t["rays_per_step"]
        with record_function(DRAW_SPAN):
            view = torch.randint(t["views"], (1,), generator=self.draw_gen,
                                 device=self.device)
            u = torch.rand((n,), generator=self.draw_gen, device=self.device)
            pix = (self.strata + u * (self.pixels / n)).long().clamp_max_(self.pixels - 1)
            rows = view * self.pixels + pix
            o, d, tgt = self.all_o[rows], self.all_d[rows], self.all_t[rows]
            _, tc, dc = self.model.sample(o, d, generator=self.comb_gen)
            return o, d, tgt, tc, dc

    def step(self):
        with record_function(self.span):
            o, d, tgt, tc, dc = self.draw()
            loss = float(self.step_fn(self.model, o, d, tc, dc, tgt))
        return loss, (o, d, tgt)

    def item(self) -> bool:
        return math.isfinite(self.step()[0])

    def first(self) -> None:
        """As the train kind's: the first ``check_steps`` steps through the
        window's own call, then ``warmup_steps`` more.  Keeps each checked
        step's batch and loss, the first gradient as Adam holds it after one
        step and its norm per leaf, and each leaf's change after the checked
        steps."""
        beta1 = self.cell.config["optimizer"]["betas"][0]
        self.batches, self.losses = [], []
        for k in range(self.traffic["check_steps"]):
            if k == 0:  # the fine depths the first step's fine pass ran on
                loss, batch, self.fine_t = self.recording_fine_depths()
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

    def recording_fine_depths(self):
        """One step, keeping the fine depths that the sampler handed the fine
        pass (the program's ``core.rays.fine_depths`` output, read as it
        passes, under whatever stands there)."""
        draw, kept = rays.fine_depths, []

        def recording(*args, **kwargs):
            out = draw(*args, **kwargs)
            kept.append(out[0].detach().clone())
            return out

        with workloads.patched(rays, "fine_depths", recording):
            loss, batch = self.step()
        return loss, batch, kept[0]

    def free(self) -> None:
        self.model = self.opt = self.step_fn = None
        self.all_o = self.all_d = self.all_t = None

    def reference(self, plan=ref.EXACT) -> dict:
        """The plain reference over the checked steps, the coarse depths'
        jitter and the fine draws worked out again from their seeds."""
        ref.set_exact()
        m = self.model_spec
        comb = scene.generator(self.seed, "comb", self.device)
        pdf = scene.generator(self.seed, "pdf", self.device)
        batches = []
        for o, d, tgt in self.batches:
            n = o.shape[0]
            t = ref_paper.coarse_depths(comb, n, m)
            batches.append((o, d, tgt, t, ref_paper.fine_draws(pdf, n, m)))
        out = ref_paper.train(self.init, batches, m, self.cell.config["optimizer"], plan)
        o, d, _, t, u = batches[0]
        with torch.no_grad():
            _, w = ref_paper.render_pass(ref_paper.nets(self.init)[0], o, d, t, m, plan)
        return {"losses": out["losses"], "first_grads": out["first_grads"],
                "grad_norms": workloads.norms(out["first_grads"]),
                "change_norms": workloads.norms(out["changes"]),
                "fine_t": ref_paper.fine_depths(t, w, u), "bin": (m["far"] - m["near"])
                / m["num_samples"]}

    def outputs(self) -> dict:
        return {"losses": self.losses, "first_grads": self.first_grads,
                "grad_norms": self.grad_norms, "change_norms": self.change_norms,
                "fine_t": self.fine_t}


def head_leaves(n_leaves: int) -> list:
    """Indices of the density and rgb heads' weights and biases of both
    networks among a model's ``n_leaves`` leaves (weights, then biases)."""
    per = n_leaves // 4  # weights of one network
    heads = [net * per + i for net in range(2) for i in (per - 4, per - 1)]
    return heads + [n_leaves // 2 + i for i in heads]


def numbers(prog: dict, ref_out: dict) -> dict:
    """The train kind's numbers (``loops/train.py``), ``grad_gap`` with its
    floor, ``head_error`` over :func:`head_leaves`, and ``depth_gap``."""
    median = statistics.median(ref_out["grad_norms"])
    keep = [i for i, g in enumerate(ref_out["grad_norms"]) if g >= median * MOVING]
    errors = [float(torch.linalg.vector_norm((p.double() - r.double()).ravel()))
              for p, r in zip(prog["first_grads"], ref_out["first_grads"])]
    gaps = [abs(p - r) / max(r, GAP_FLOOR * median)
            for p, r in zip(prog["grad_norms"], ref_out["grad_norms"])]
    change = [abs(prog["change_norms"][i] - ref_out["change_norms"][i])
              / max(ref_out["change_norms"][i], 1e-30) for i in keep]
    head = head_leaves(len(errors))
    head_ref = sum(float(torch.linalg.vector_norm(ref_out["first_grads"][i].double())) ** 2
                   for i in head) ** 0.5
    return {
        "loss_gap": abs(prog["losses"][0] - ref_out["losses"][0]) / abs(ref_out["losses"][0]),
        "grad_gap": max(gaps[i] for i in keep),
        "grad_error": max(e / max(r, median, 1e-30)
                          for e, r in zip(errors, ref_out["grad_norms"])),
        "head_error": sum(errors[i] ** 2 for i in head) ** 0.5 / max(head_ref, 1e-30),
        "change_gap": statistics.median(change),
        "depth_gap": float((prog["fine_t"].double() - ref_out["fine_t"].double()).abs().mean())
        / ref_out["bin"],
    }


def look(prog: dict, ref_out: dict) -> dict:
    """Each leaf's gaps against its own norm, and each checked step's loss
    gap."""
    leaves = {k: [round(abs(p - r) / max(r, 1e-30), 6) for p, r in zip(prog[k], ref_out[k])]
              for k in ("grad_norms", "change_norms")}
    leaves["grad_errors"] = [round(float((p - r).norm() / r.norm().clamp_min(1e-30)), 6)
                             for p, r in zip(prog["first_grads"], ref_out["first_grads"])]
    leaves["ref_grad_norms"] = [float(f"{g:.4g}") for g in ref_out["grad_norms"]]
    gap = (prog["fine_t"].double() - ref_out["fine_t"].double()).abs() / ref_out["bin"]
    return {"leaves": leaves, "depth_gap_max": float(gap.max()),
            "step_loss_gaps": [abs(p - r) / abs(r) for p, r in zip(prog["losses"],
                                                                    ref_out["losses"])]}


def control_outputs(control: dict) -> dict:
    return control


# ---- the faults that a cell of this kind can have ----

def unchanged_state():
    """The step returns without updating the parameters or Adam's state."""
    return workloads.patched(torch.optim.Adam, "step", lambda self, closure=None: None)


def _pass_patched(fn):
    return workloads.patched(fused_nerf, "paper_train_loss", fn)


def half_batch():
    """Each pass's loss covers the first half of the rays only, doubled, as a
    mean over the rest would give (the coarse weights of the rest left as
    they are)."""
    train = fused_nerf.paper_train_loss

    def train_half(net, origins, directions, t_vals, dists, target, config, weights=False):
        h = origins.shape[0] // 2
        loss, _ = train(net, origins[:h], directions[:h], t_vals[:h], dists[:h], target[:h],
                        config)
        _, w = train(net, origins, directions, t_vals, dists, target, config, weights)
        return 2.0 * loss, w

    return _pass_patched(train_half)


def answer_altered():
    """Each pass's loss read back 1% high."""
    train = fused_nerf.paper_train_loss

    def train_high(*args, **kwargs):
        loss, w = train(*args, **kwargs)
        return loss * 1.01, w

    return _pass_patched(train_high)


class _HalfGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return 0.5 * g


def bias_grad_halved():
    """The trunk's bias gradients (the column sums) come out halved."""
    train = fused_nerf.paper_train_loss

    def train_db_half(net, *args, **kwargs):
        trunk = len(net["b"]) - 4
        b = [_HalfGrad.apply(x) for x in net["b"][:trunk]] + net["b"][trunk:]
        return train({"w": net["w"], "b": b}, *args, **kwargs)

    return _pass_patched(train_db_half)


def pdf_ignored():
    """The fine depths come from the uniform comb (equal weights) instead of
    the coarse weights."""
    draw = rays.fine_depths

    def uniform(t_coarse, weights, num_fine, generator=None):
        return draw(t_coarse, torch.ones_like(weights), num_fine, generator)

    return workloads.patched(rays, "fine_depths", uniform)


FAULTS = {"unchanged_state": unchanged_state, "half_batch": half_batch,
          "answer_altered": answer_altered, "bias_grad_halved": bias_grad_halved,
          "pdf_ignored": pdf_ignored}
