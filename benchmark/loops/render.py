"""``kind: "render"`` — a closed loop of frames.

Each frame renders the next of ``poses`` orbit poses through
``NeRFModel.render_image`` at its default chunk and copies the colours to
the host as ``uint8``, as ``make_video.render_orbit`` does.  Span:
``bench.frame`` around a frame.

The number that decides ``correct``: ``colour_gap`` — over every pixel and
channel of the checked frames (``check_frames`` of the window's, drawn from
the seed), how far (in 1/255 levels) the reference's colour times 255 lies
outside the ``[u8, u8 + 1)`` interval that the program's ``uint8`` stands
for (``uint8`` truncates).
"""

from __future__ import annotations

import random

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import counts, scene, workloads
from benchmark.reference import nerf as ref
from lomanerf_tpu_torch.ops import fused_nerf

NAMES = ("colour_gap",)


def work(model: dict, traffic: dict) -> dict:
    return counts.frame(model, traffic["side"] ** 2)


def check_cell(name: str, config: dict, traffic: dict):
    side = config.get("render_side")
    if side is not None and side != traffic["side"]:
        return (f"{name}: the traffic renders {traffic['side']}-pixel frames, "
                f"the configuration states {side}")
    return None


class Loop(workloads.Loop):
    metric = "frame_ms"
    span = "bench.frame"

    def __init__(self, cell, seed: int, device):
        super().__init__(cell, seed, device)
        t = self.traffic
        self.poses = scene.orbit_poses(self.gen, t["poses"], t["radius"], t["elevation"])
        f = self.focal
        self.K = torch.tensor([[f, 0.0, 0.5], [0.0, f, 0.5], [0.0, 0.0, 1.0]],
                              dtype=torch.float32, device=self.device)
        self.frames = []  # (frame index, uint8 frame) of the window
        self.items = 0

    def frame(self, i: int):
        t = self.traffic
        with torch.no_grad(), record_function(self.span):
            img = self.model.render_image(self.K, self.poses[i % t["poses"]], t["side"])
            return (img.clamp(0, 1) * 255).to(torch.uint8).cpu().numpy()

    def item(self) -> bool:
        i = self.items
        self.items += 1
        self.frames.append((i, self.frame(i)))
        return True

    def first(self) -> None:
        for _ in range(self.traffic["warmup_frames"]):
            self.item()
        self.frames = []

    def fill_check(self) -> None:
        for _ in range(self.traffic["check_frames"]):
            self.item()

    def checked(self) -> list:
        """The window's frames that the check compares, drawn from the seed."""
        k = min(self.traffic["check_frames"], len(self.frames))
        return random.Random(scene.derive(self.seed, "check")).sample(self.frames, k)

    def reference(self, plan=ref.EXACT) -> dict:
        """The reference's colours of every checked frame's pixels."""
        ref.set_exact()
        t = self.traffic
        cam = scene.camera_directions(t["side"], self.focal, self.device)
        cols = []
        for i, _ in self.checked():
            o, d = scene.rays(self.poses[i % t["poses"]][None], cam)
            cols.append(ref.render_blocked(self.init, o[0], d[0], self.model_spec,
                                           plan).cpu().numpy())
        return {"colours": cols}

    def outputs(self) -> dict:
        return {"frames": [u8.reshape(-1, 3) for _, u8 in self.checked()]}


def numbers(prog: dict, ref: dict) -> dict:
    gap = 0.0
    for u8, cols in zip(prog["frames"], ref["colours"]):
        r = 255.0 * np.clip(cols.astype(np.float64), 0.0, 1.0)
        lo = u8.astype(np.float64)
        gap = max(gap, float(np.max(np.maximum(lo - r, r - (lo + 1.0)))))
    return {"colour_gap": max(gap, 0.0)}


def control_outputs(control: dict) -> dict:
    """The control's colours as the program's ``uint8`` frames."""
    return {"frames": [(np.clip(c, 0.0, 1.0) * 255).astype(np.uint8)
                       for c in control["colours"]]}


# ---- the faults that a render cell can have (a frame keeps no state) ----

def half_batch():
    """Each render call colours the first half of its rays; the rest stay
    black."""
    render = fused_nerf.render_rays

    def render_half(params, origins, directions, t_vals, dists, config):
        h = origins.shape[0] // 2
        out = torch.zeros_like(origins)
        out[:h] = render(params, origins[:h], directions[:h], t_vals, dists, config)
        return out

    return workloads.patched(fused_nerf, "render_rays", render_half)


def answer_altered():
    """The first ray's colour of every render call comes out white."""
    render = fused_nerf.render_rays

    def render_white(*args):
        out = render(*args).clone()
        out[0] = 1.0
        return out

    return workloads.patched(fused_nerf, "render_rays", render_white)


FAULTS = {"half_batch": half_batch, "answer_altered": answer_altered}
