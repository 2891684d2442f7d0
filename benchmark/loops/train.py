"""``kind: "train"`` — a closed loop of Adam steps.

Each step draws one of ``views`` training views and ``rays_per_step`` of
its pixels (one from each of as many equal runs of the view's pixels, so
that no two rows of a batch are alike) from the ray table, shifts each
ray's comb by ``core.rays.stratified_ray_offsets`` (the shared ``(S,)``
depths stay, as ``train_nerf --stratified`` trains), runs one
``train.steps.make_single_chip_train_step`` step on the model and reads the
loss back, as ``train_nerf --pipeline python`` does.

Spans: ``bench.train_step`` around a whole step, ``bench.draw`` around its
draw and offsets.

The numbers that decide ``correct`` (the first checked steps, as Adam saw
them).  "Kept" leaves are those whose reference gradient is at least
``MOVING`` of the median leaf's: a leaf with a gradient nought to rounding
moves under Adam by round-off alone.

* ``loss_gap`` — the first step's ``|loss - reference| / reference``.  The
  later steps' losses are not compared: Adam's first update moves every
  weight by about the learning rate, whatever its gradient's size, so a
  gradient that rounding turns the other way moves a wide layer's outputs
  by much, and the later losses part by up to a few % on some seeds
  (``calibrate.py`` prints them);
* ``grad_gap`` — the first gradient's norm, by the worst leaf: ``| |g| -
  |g_ref| | / |g_ref|`` over the kept leaves, each against its own norm, so
  that a bias far below the median leaf weighs as much as a weight;
* ``grad_error`` — the first gradient itself, by the worst leaf: ``|g -
  g_ref|`` over the larger of that leaf's ``|g_ref|`` and the median
  leaf's: norms and sums let independent rounding errors cancel, this does
  not.  The first layer's weight, at the bottom of the chain of ReLU masks
  that flip within rounding of zero, is its worst leaf, and lies below the
  median; against its own norm it would read twice as much on its worst
  seeds;
* ``head_error`` — the same for the head's weight and bias together.  A
  ReLU mask that flips where a pre-activation lies within rounding of zero
  moves the hidden leaves' gradients by about the square root of the
  precision; the head's gradient has no mask behind it and moves with the
  precision itself, so it parts the program's bfloat16 from the float8
  control by the most;
* ``change_gap`` — each leaf's change over the checked steps, ``| |dp| -
  |dp_ref| | / |dp_ref|``, at the median leaf: Adam moves every element by
  about the learning rate whatever its gradient's size, so a small leaf's
  change (a bias, the head) turns on the signs of a few near-zero
  gradients; over the kept leaves.
"""

from __future__ import annotations

import math
import statistics

import torch
from torch.profiler import record_function

from benchmark import counts, scene, workloads
from benchmark.reference import nerf as ref
from lomanerf_tpu_torch.core.rays import stratified_ray_offsets, uniform_depths
from lomanerf_tpu_torch.ops import fused_nerf
from lomanerf_tpu_torch.train.steps import make_single_chip_train_step

DRAW_SPAN = "bench.draw"
MOVING = 1e-3
NAMES = ("loss_gap", "grad_gap", "grad_error", "head_error", "change_gap")


def work(model: dict, traffic: dict) -> dict:
    return counts.train_step(model, traffic["rays_per_step"])


class Loop(workloads.Loop):
    metric = "train_step_ms"
    span = "bench.train_step"

    def __init__(self, cell, seed: int, device):
        super().__init__(cell, seed, device)
        t, m = self.traffic, self.model_spec
        poses = scene.train_poses(self.gen, t["views"], t["radius"])
        cam = scene.camera_directions(t["side"], self.focal, self.device)
        o, d = scene.rays(poses, cam)
        self.pixels = cam.shape[0]
        self.all_o, self.all_d = o.view(-1, 3), d.view(-1, 3)
        self.all_t = torch.rand(self.all_o.shape, generator=self.gen, device=self.gen.device)
        opt = self.cell.config["optimizer"]
        self.opt = torch.optim.Adam(self.model.parameters(), lr=opt["lr"],
                                    betas=tuple(opt["betas"]), eps=opt["eps"])
        self.step_fn = make_single_chip_train_step(self.cfg, self.opt)
        self.t_vals, self.dists = uniform_depths(m["near"], m["far"], m["num_samples"],
                                                 self.device)
        self.draw_gen = scene.generator(seed, "draw", self.device)
        self.comb_gen = scene.generator(seed, "comb", self.device)
        n = t["rays_per_step"]
        self.strata = torch.arange(n, dtype=torch.float32, device=self.device) \
            * (self.pixels / n)

    def leaves(self):
        return [*self.model.w, *self.model.b]

    def draw(self):
        """``((origins, directions, targets), shifted origins)`` of one batch."""
        t, m = self.traffic, self.model_spec
        n = t["rays_per_step"]
        with record_function(DRAW_SPAN):
            view = torch.randint(t["views"], (1,), generator=self.draw_gen,
                                 device=self.device)
            u = torch.rand((n,), generator=self.draw_gen, device=self.device)
            pix = (self.strata + u * (self.pixels / n)).long().clamp_max_(self.pixels - 1)
            rows = view * self.pixels + pix
            o, d, tgt = self.all_o[rows], self.all_d[rows], self.all_t[rows]
            dt = stratified_ray_offsets(self.comb_gen, n, m["near"], m["far"],
                                        m["num_samples"])
            return (o, d, tgt), o + d * dt[:, None]

    def step(self):
        with record_function(self.span):
            (o, d, tgt), shifted = self.draw()
            loss = float(self.step_fn(self.model, shifted, d, self.t_vals, self.dists, tgt))
        return loss, (o, d, tgt)

    def item(self) -> bool:
        return math.isfinite(self.step()[0])

    def first(self) -> None:
        """The first ``check_steps`` steps through the window's own call,
        then ``warmup_steps`` more.  Keeps each checked step's batch and
        loss, the first gradient as Adam holds it after one step
        (``exp_avg / (1 - beta1)``) and its norm per leaf, and each leaf's
        change after the checked steps."""
        beta1 = self.cell.config["optimizer"]["betas"][0]
        self.batches, self.losses = [], []
        for k in range(self.traffic["check_steps"]):
            loss, batch = self.step()
            self.losses.append(loss)
            self.batches.append(batch)
            if k == 0:
                # a step that left Adam without state reads a zero gradient
                self.first_grads = [
                    self.opt.state[p]["exp_avg"] / (1.0 - beta1) if self.opt.state.get(p)
                    else torch.zeros_like(p) for p in self.leaves()]
                self.grad_norms = workloads.norms(self.first_grads)
        start = [*self.init["w"], *self.init["b"]]
        self.change_norms = workloads.norms(p - p0 for p, p0 in zip(self.leaves(), start))
        for _ in range(self.traffic["warmup_steps"]):
            self.step()

    def free(self) -> None:
        self.model = self.opt = self.step_fn = None
        self.all_o = self.all_d = self.all_t = None

    def reference(self, plan=ref.EXACT) -> dict:
        """The plain reference over the checked steps: its losses, first
        gradient (and its norms) and changes' norms."""
        ref.set_exact()
        m = self.model_spec
        comb = scene.generator(self.seed, "comb", self.device)
        batches = []
        for o, d, tgt in self.batches:
            dt = ref.comb_offsets(comb, o.shape[0], m["near"], m["far"], m["num_samples"])
            batches.append((o + d * dt[:, None], d, tgt))
        out = ref.train(self.init, batches, m, self.cell.config["optimizer"], plan)
        return {"losses": out["losses"], "first_grads": out["first_grads"],
                "grad_norms": workloads.norms(out["first_grads"]),
                "change_norms": workloads.norms(out["changes"])}

    def outputs(self) -> dict:
        return {"losses": self.losses, "first_grads": self.first_grads,
                "grad_norms": self.grad_norms, "change_norms": self.change_norms}


def numbers(prog: dict, ref: dict) -> dict:
    median = statistics.median(ref["grad_norms"])
    keep = [i for i, g in enumerate(ref["grad_norms"]) if g >= median * MOVING]
    errors = [float(torch.linalg.vector_norm((p.double() - r.double()).ravel()))
              for p, r in zip(prog["first_grads"], ref["first_grads"])]
    gaps = [abs(p - r) for p, r in zip(prog["grad_norms"], ref["grad_norms"])]
    change = [abs(prog["change_norms"][i] - ref["change_norms"][i])
              / max(ref["change_norms"][i], 1e-30) for i in keep]
    head = [len(errors) // 2 - 1, len(errors) - 1]  # the last weight and bias
    head_ref = sum(float(torch.linalg.vector_norm(ref["first_grads"][i].double())) ** 2
                   for i in head) ** 0.5
    return {
        "loss_gap": abs(prog["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0]),
        "grad_gap": max(gaps[i] / ref["grad_norms"][i] for i in keep),
        "grad_error": max(e / max(r, median, 1e-30)
                          for e, r in zip(errors, ref["grad_norms"])),
        "head_error": sum(errors[i] ** 2 for i in head) ** 0.5 / max(head_ref, 1e-30),
        "change_gap": statistics.median(change),
    }


def look(prog: dict, ref: dict) -> dict:
    """Each leaf's gaps against its own norm, and each checked step's loss
    gap, for a look at where a number's reading comes from."""
    leaves = {k: [round(abs(p - r) / max(r, 1e-30), 6) for p, r in zip(prog[k], ref[k])]
              for k in ("grad_norms", "change_norms")}
    leaves["grad_errors"] = [round(float((p - r).norm() / r.norm().clamp_min(1e-30)), 6)
                             for p, r in zip(prog["first_grads"], ref["first_grads"])]
    return {"leaves": leaves,
            "step_loss_gaps": [abs(p - r) / abs(r) for p, r in zip(prog["losses"],
                                                                    ref["losses"])]}


def control_outputs(control: dict) -> dict:
    return control


# ---- the faults that a train cell can have ----

def unchanged_state():
    """The step returns without updating the parameters or Adam's state."""
    return workloads.patched(torch.optim.Adam, "step", lambda self, closure=None: None)


def half_batch():
    """The loss covers the first half of the rays only, doubled, as a mean
    over the rest would give."""
    train = fused_nerf.nerf_train_loss

    def train_half(params, origins, directions, t_vals, dists, target, config):
        h = origins.shape[0] // 2
        return 2.0 * train(params, origins[:h], directions[:h], t_vals, dists, target[:h],
                           config)

    return workloads.patched(fused_nerf, "nerf_train_loss", train_half)


def answer_altered():
    """The loss read back 1% high."""
    train = fused_nerf.nerf_train_loss
    return workloads.patched(fused_nerf, "nerf_train_loss",
                             lambda *args: train(*args) * 1.01)


class _HalfGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return 0.5 * g


def bias_grad_halved():
    """The hidden layers' bias gradients (the column sums) come out halved."""
    train = fused_nerf.nerf_train_loss

    def train_db_half(params, *args):
        b = [_HalfGrad.apply(x) for x in params["b"][:-1]] + params["b"][-1:]
        return train({"w": params["w"], "b": b}, *args)

    return workloads.patched(fused_nerf, "nerf_train_loss", train_db_half)


FAULTS = {"unchanged_state": unchanged_state, "half_batch": half_batch,
          "answer_altered": answer_altered, "bias_grad_halved": bias_grad_halved}
