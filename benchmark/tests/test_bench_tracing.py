"""The readers of the program's spans (``spans.py`` and the ``fused_nerf.*``,
``steps.*`` and ``nerf.*`` metrics) on hand-made traces with known idle
gaps, and traced CPU rehearsals of the harness's tiny cells that still end
correct (``test_bench_harness`` holds the faults to failing them)."""

import json
import os
import types
from pathlib import Path

import pytest

from benchmark import spans, spec
from benchmark.tests.test_bench_harness import LIMITS_OF, last_line, run_cell, tiny_copy
from benchmark.trace import Trace

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
TRAIN = ("fused_nerf.host_ms.train", "fused_nerf.idle_ms.train", "fused_nerf.launches.train",
         "steps.idle_ms.train")
RENDER = ("nerf.idle_ms.render",)


class Events:
    """A trace's events: host spans, and device operations each with the
    runtime call that launched it (one correlation id)."""

    def __init__(self):
        self.events, self.ids = [], 0

    def span(self, name, a, b, tid=1):
        self.events.append({"ph": "X", "cat": "user_annotation", "name": name, "ts": a,
                            "dur": b - a, "tid": tid})

    def op(self, launched, a, b, cat="kernel", tid=1):
        self.ids += 1
        self.events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                            "ts": launched, "dur": 0.5, "tid": tid,
                            "args": {"correlation": self.ids}})
        self.events.append({"ph": "X", "cat": cat, "name": f"op{self.ids}", "ts": a,
                            "dur": b - a, "args": {"correlation": self.ids}})


def train_trace(program=True):
    """Three 100 µs steps, the first left out of the window.  In each (at
    offset o): the benchmark's draw; the program's step [10, 95] with the
    loss [20, 60] (pack, launch, unpack nested in it, on the main thread)
    and its backward [58, 75] on autograd's thread, overlapping the loss's
    end.  The device runs [6, 9] (draw), [13, 15] (zero_grad), [26, 28]
    (pack's copy), [36, 70] (the chain), [71, 74] (the backward's scaling),
    [81, 90] (Adam)."""
    ev = Events()
    for k in range(3):
        o = 100.0 * k
        ev.span("bench.train_step", o, o + 100)
        ev.span("bench.draw", o + 2, o + 8)
        ev.op(o + 5, o + 6, o + 9)
        if program:
            ev.span("lomanerf.steps.train_step", o + 10, o + 95)
            ev.span("lomanerf.fused_nerf.train_loss", o + 20, o + 60)
            ev.span("lomanerf.fused_nerf.pack", o + 22, o + 30)
            ev.span("lomanerf.fused_nerf.launch.nerf_wide_train", o + 30, o + 40)
            ev.span("lomanerf.fused_nerf.unpack", o + 50, o + 60)
            ev.span("lomanerf.fused_nerf.backward", o + 58, o + 75, tid=2)
        ev.op(o + 12, o + 13, o + 15, cat="gpu_memset")
        ev.op(o + 25, o + 26, o + 28, cat="gpu_memcpy")
        ev.op(o + 35, o + 36, o + 70)
        ev.op(o + 66, o + 71, o + 74, tid=2)
        ev.op(o + 80, o + 81, o + 90)
    return Trace(ev.events, 2, ("bench.train_step",), skip=1)


def render_trace(program=True):
    """Three 100 µs frames, the first left out.  In each: the program's
    frame [5, 80] with two chunks [20, 40] and [45, 70]; the device runs
    [11, 14] (rays), [26, 44] and [51, 75] (the chunks), [79, 82] (the
    concatenation) and [86, 95] (the benchmark's copy to the host)."""
    ev = Events()
    for k in range(3):
        o = 100.0 * k
        ev.span("bench.frame", o, o + 100)
        if program:
            ev.span("lomanerf.nerf.render_image", o + 5, o + 80)
            ev.span("lomanerf.fused_nerf.render_rays", o + 20, o + 40)
            ev.span("lomanerf.fused_nerf.render_rays", o + 45, o + 70)
        ev.op(o + 10, o + 11, o + 14)
        ev.op(o + 25, o + 26, o + 44)
        ev.op(o + 50, o + 51, o + 75)
        ev.op(o + 78, o + 79, o + 82)
        ev.op(o + 85, o + 86, o + 95, cat="gpu_memcpy")
    return Trace(ev.events, 2, ("bench.frame",), skip=1)


def read(metric, trace):
    return spec.load_reader(BENCH / "metrics" / f"{metric}.py")(
        types.SimpleNamespace(trace=trace))


def test_interval_algebra():
    assert spans.merged([(5, 7), (1, 3), (2, 4), (6, 6)]) == [[1, 4], [5, 7]]
    assert spans.minus([[0, 10], [20, 30]], [[2, 3], [8, 22], [29, 40]]) == \
        [[0, 2], [3, 8], [22, 29]]
    assert spans.common([[0, 10], [20, 30]], [[5, 25]]) == [[5, 10], [20, 25]]


def test_train_readers_split_the_idle():
    """Per step: the wrapper's spans cover [20, 75] (the union over both
    threads), 55 µs; the idle in it [20, 26] [28, 36] [70, 71] [74, 75],
    16 µs; the step's idle outside it [10, 13] [15, 20] [75, 81] [90, 95],
    19 µs; three operations launched in it (a copy, the chain, the
    backward's kernel on the second thread).  With the 12 µs before and
    after the program's step, the split adds up to the window's idle."""
    t = train_trace()
    assert t.window == (100.0, 300.0)
    got = {m: read(m, t) for m in TRAIN}
    assert got == pytest.approx({"fused_nerf.host_ms.train": 0.055,
                                 "fused_nerf.idle_ms.train": 0.016,
                                 "fused_nerf.launches.train": 3.0,
                                 "steps.idle_ms.train": 0.019}, abs=1e-12)
    idle_ms = (t.window_s() - t.busy_s()) * 1e3 / t.items
    outside = spans.length(spans.minus(spans.idle(t), spans.cover(t, spans.TRAIN_STEP)))
    assert idle_ms == pytest.approx(0.047)
    assert got["fused_nerf.idle_ms.train"] + got["steps.idle_ms.train"] \
        + outside / 1e3 / t.items == pytest.approx(idle_ms)


def test_render_reader():
    """Per frame: the idle inside [5, 80] is [5, 11] [14, 26] [44, 51]
    [75, 79], 29 µs; the benchmark's copy to the host lies outside."""
    assert read("nerf.idle_ms.render", render_trace()) == pytest.approx(0.029, abs=1e-12)


@pytest.mark.parametrize("metric", TRAIN + RENDER)
def test_readers_give_none_without_their_spans(metric):
    """A program without the spans (the parent's) and a run without a
    trace (the CPU's) read None, not 0."""
    parent = (train_trace if metric in TRAIN else render_trace)(program=False)
    assert parent.ops and read(metric, parent) is None
    assert read(metric, None) is None


def test_readers_are_entries_of_their_cells():
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    kinds = {w["name"]: json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
             ["kind"] for w in b["workloads"]}
    for m in b["per_layer"]:
        if m["name"] in TRAIN + RENDER:
            kind = "train" if m["name"] in TRAIN else "render"
            assert sorted(m["workloads"]) == sorted(w for w, k in kinds.items() if k == kind)


@pytest.mark.parametrize("kind", ["train", "render"])
def test_traced_cpu_rehearsal_is_correct_without_span_metrics(tmp_path, kind):
    """A ``--cpu --trace 1`` run of the harness's tiny cell of each kind ends
    correct under that kind's limits and reports no device metric (none of
    the program's span readers either; ``extra.ms`` is the copy's host-clock
    stand-in): the CPU trace has no device operations to read against."""
    root = tiny_copy(tmp_path, LIMITS_OF)
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = run_cell(root, f"tiny.{kind}", "--trace", "1", "--cpu", env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    line = last_line(out)
    assert line["correct"] is True and set(line["metrics"]) <= {"extra.ms"}, line
