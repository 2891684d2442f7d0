"""The traced run: a few steps or frames under ``torch.profiler``, reduced
to what the per-layer readers and the result's ``breakdown`` take.

Each device operation (kernel, copy, memset) is attributed to the host
spans that were open when it was launched: the runtime call that launched
it carries the same correlation id, and the spans around that call's host
time are the benchmark's (``bench.*``) and PyTorch's
(``Optimizer.step#Adam.step``).  An operation whose launch the trace does
not hold takes the spans of the operation before it on the device.  The
window runs from the start of the first counted step's (frame's) span to
the end of the last one's.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
import time
from pathlib import Path

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op", "cuda_runtime", "cuda_driver", "python_function")
MARGIN_S = 0.05  # idle host time at both ends: the capture keeps the first and last kernel
FAMILIES = json.loads((Path(__file__).resolve().parent / "families.json").read_text())


def family(name: str, cat: str) -> str:
    """The family of a device operation by its trace name (``families.json``)."""
    if cat != "kernel":
        return FAMILIES["not_a_kernel"]
    for rule in FAMILIES["rules"]:
        found = re.search(rule["pattern"], name)
        if found:
            return rule["by_group"][found.group(1)] if "by_group" in rule else rule["family"]
    return FAMILIES["other"]


class Op:
    __slots__ = ("name", "cat", "ts", "dur", "spans", "family")

    def __init__(self, name, cat, ts, dur, spans):
        self.name, self.cat, self.ts, self.dur, self.spans = name, cat, ts, dur, spans
        self.family = family(name, cat)


class Trace:
    """Device operations with their spans, the window, and ``items`` steps
    or frames in it.  Times in µs of the trace's clock."""

    def __init__(self, events: list, items: int, item_spans, skip: int = 0):
        spans = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
        self.host = sorted((e for e in events if e.get("ph") == "X"
                            and e.get("cat") in HOST_CATS), key=lambda e: e["ts"])
        launch = {e["args"]["correlation"]: float(e["ts"]) for e in events
                  if e.get("cat") in ("cuda_runtime", "cuda_driver")
                  and "correlation" in e.get("args", {})}
        self.items = items
        marks = sorted((e for e in spans if e["name"] in item_spans),
                       key=lambda e: float(e["ts"]))[skip:]
        self.window = ((min(float(e["ts"]) for e in marks),
                        max(float(e["ts"]) + float(e["dur"]) for e in marks))
                       if marks else (0.0, 0.0))
        self.ops, prev = [], frozenset()
        for e in sorted((e for e in events if e.get("cat") in DEVICE_CATS),
                        key=lambda e: float(e["ts"])):
            t = launch.get(e.get("args", {}).get("correlation"))
            if t is not None:
                prev = frozenset(s["name"] for s in spans
                                 if float(s["ts"]) <= t <= float(s["ts"]) + float(s["dur"]))
            self.ops.append(Op(e.get("name", ""), e["cat"], float(e["ts"]),
                               float(e.get("dur", 0.0)), prev))

    def in_window(self):
        t0, t1 = self.window
        return [op for op in self.ops if op.ts + op.dur > t0 and op.ts < t1]

    def device_ms(self, within: str, outside=(), kernels_only: bool = True):
        """Device ms per item of the operations launched inside the span
        ``within`` and outside every span of ``outside``; None if there is
        none."""
        ops = [op for op in self.in_window() if within in op.spans
               and not op.spans.intersection(outside)
               and (op.cat == "kernel" or not kernels_only)]
        return sum(op.dur for op in ops) / 1e3 / self.items if ops else None

    def busy(self) -> list:
        """The union of the device's busy intervals, clipped to the window."""
        t0, t1 = self.window
        merged = []
        for op in sorted(self.in_window(), key=lambda op: op.ts):
            a, b = max(op.ts, t0), min(op.ts + op.dur, t1)
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy()) / 1e6

    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def _host_at(self, t: float) -> str:
        """The innermost host event open at ``t``."""
        open_ = [e for e in self.host if float(e["ts"]) <= t <= float(e["ts"]) + float(e["dur"])]
        if not open_:
            return "(python, no op open)"
        return min(open_, key=lambda e: float(e["dur"]))["name"]

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time (five families, then
        kernels by name) and the longest idle gaps, named by what the host
        was doing, in seconds over the window."""
        by_family, by_name = {}, {}
        for op in self.in_window():
            by_family[op.family] = by_family.get(op.family, 0.0) + op.dur / 1e6
            by_name[op.name] = by_name.get(op.name, 0.0) + op.dur / 1e6
        families = sorted(by_family.items(), key=lambda kv: -kv[1])[:top // 2]
        names = sorted(by_name.items(), key=lambda kv: -kv[1])[:top - len(families)]
        ops = [[f"family: {k}", v] for k, v in families] + \
            [[f"op: {k[:160]}", v] for k, v in names]
        edges = [self.window[0], *[x for iv in self.busy() for x in iv], self.window[1]]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
                if edges[i + 1] > edges[i]]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
        idle = [[self._host_at((a + b) / 2)[:160], (b - a) / 1e6] for a, b in gaps]
        return {"device_ops": ops, "idle_gaps": idle}


def capture(run_item, items: int, item_spans) -> Trace:
    """``items`` calls of ``run_item`` in one profiler session (the host
    and, on a card, its work), in a temporary directory, after one more
    that the window leaves out: the session's first operations pay for
    starting it."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with tempfile.TemporaryDirectory() as tmp:
        with profile(activities=activities) as prof:
            time.sleep(MARGIN_S)
            for _ in range(items + 1):
                run_item()
            if cuda:
                torch.cuda.synchronize()
            time.sleep(MARGIN_S)
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return Trace(events, items, item_spans, skip=1)
