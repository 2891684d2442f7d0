"""The published NeRF's cell (``nerf_paper_8x256.train_4k``, ``loops/train_paper.py``):
its ``work`` against a hand count of the paper's layer shapes, its readers
(``sampling.*``, the two kernels' rooflines) on a hand-made trace, its
reference blocked against unblocked, and a tiny copy of the cell on the
CPU: correct as it is, not correct under each of its kind's faults."""

import json
import os
import shutil
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

from benchmark import counts, spec
from benchmark.reference import nerf_paper as ref
from benchmark.tests.test_bench_harness import last_line, run_cell
from benchmark.tests.test_bench_tracing import Events
from benchmark.trace import Trace

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
CELL = "nerf_paper_8x256.train_4k"


def paper_model():
    return json.loads((BENCH / "configs" / "nerf_paper_8x256.json").read_text())["model"]


def kind():
    return spec.load_kind("train_paper")


def test_work_is_the_hand_count():
    """Per row forward: 63 x 256, 4 x 256 x 256, 319 x 256 (the skip), 2 x 256
    x 256, 256 (density), 256 x 256 (feature), 283 x 128 (view), 128 x 3:
    593,408 MACs; d_h of all but the first leaf, the skip layer's onto h_5's
    256 columns (not gamma(x)'s 63) and the view layer's onto the feature's
    256 (not gamma(d)'s 27): 557,696; 4096 rays x (64 + 192) rows: 3.6585
    TFLOP a step."""
    fwd = 63 * 256 + 4 * 65536 + 319 * 256 + 2 * 65536 + 256 + 65536 + 283 * 128 + 384
    assert fwd == 593408
    d_h = 4 * 65536 + 256 * 256 + 2 * 65536 + 256 + 65536 + 256 * 128 + 384
    assert d_h == fwd - 63 * 256 - 63 * 256 - 27 * 128 == 557696
    rows = 4096 * (64 + 64 + 128)
    w = kind().work(paper_model(), {"rays_per_step": 4096})
    assert w["macs"] == rows * (2 * fwd + d_h)
    assert 2 * w["macs"] / 1e12 == pytest.approx(3.6585, abs=1e-4)
    n_params = 2 * (fwd + 8 * 256 + 1 + 256 + 128 + 3)
    assert w["bytes"] == 4096 * 36 + n_params * 8
    enc = w["kernels"]["paper_encode_kernel"]
    assert enc == {"macs": 0, "bytes": rows * (4 + 2 * (64 + 27)) + 2 * 4096 * 24}
    comp = w["kernels"]["paper_composite_kernel"]
    assert comp["macs"] == rows * 768
    # a row: V2 read and the view layer's d_z written (2 x 256 B), sigma (2),
    # its step (4), the head's f32 d_z (16), sigma's d_z and 7 zeros (16)
    assert comp["bytes"] == rows * 550 + 4096 * 64 * 4 + 2 * 4096 * (16 + 4 * 136)


class NamedEvents(Events):
    """:class:`Events` whose device operations may carry a kernel's name."""

    def op(self, launched, a, b, cat="kernel", tid=1, name=None):
        super().op(launched, a, b, cat, tid)
        if name is not None:
            self.events[-1]["name"] = name


def paper_trace(program=True):
    """Three 100 µs steps, the first left out.  In each: the sampler's span
    [40, 50] with two kernels [44, 46] and [47, 48] launched in it (so
    [40, 44] and [46, 47] and [48, 50] are idle in it, 7 µs); the coarse
    pass's encode kernel [10, 12] and compositing kernel [20, 25], the fine
    pass's [55, 58] and [70, 80]."""
    ev = NamedEvents()
    for k in range(3):
        o = 100.0 * k
        ev.span("bench.train_step", o, o + 100)
        if program:
            ev.span("lomanerf.nerf.sample_pdf", o + 40, o + 50)
        ev.op(o + 9, o + 10, o + 12, name="void wide::paper_encode_kernel(float const*)")
        ev.op(o + 19, o + 20, o + 25, name="void wide::paper_composite_kernel<1>(int)")
        ev.op(o + 41, o + 44, o + 46)
        ev.op(o + 42, o + 47, o + 48)
        ev.op(o + 54, o + 55, o + 58, name="void wide::paper_encode_kernel(float const*)")
        ev.op(o + 69, o + 70, o + 80, name="void wide::paper_composite_kernel<1>(int)")
    return Trace(ev.events, 2, ("bench.train_step",), skip=1)


def read(metric, trace, work=None):
    run = types.SimpleNamespace(trace=trace, peak_flops=989e12, work=counts.of_work(
        work or kind().work(paper_model(), {"rays_per_step": 4096}), 989e12))
    return spec.load_reader(BENCH / "metrics" / f"{metric}.py")(run)


def test_sampling_readers():
    t = paper_trace()
    assert read("sampling.device_ms.train", t) == pytest.approx(0.003, abs=1e-12)
    assert read("sampling.idle_ms.train", t) == pytest.approx(0.007, abs=1e-12)


@pytest.mark.parametrize("metric, kernel, us", [
    ("paper_composite.roofline.train", "paper_composite_kernel", 15.0),
    ("paper_encode.roofline.train", "paper_encode_kernel", 5.0)])
def test_kernel_roofline_readers(metric, kernel, us):
    """The kernel's bound from the kind's count over its kernels' device time
    a step (15 µs of compositing, 5 of encoding in the hand-made trace)."""
    w = kind().work(paper_model(), {"rays_per_step": 4096})
    k = w["kernels"][kernel]
    want = 100.0 * counts.bound(k["macs"], 989e12, k["bytes"])[0] / (us / 1e3)
    assert read(metric, paper_trace(), w) == pytest.approx(want)


@pytest.mark.parametrize("metric", ["sampling.device_ms.train", "sampling.idle_ms.train",
                                    "paper_composite.roofline.train",
                                    "paper_encode.roofline.train"])
def test_new_readers_give_none_without_what_they_read(metric):
    """Without the sampler's span or the kernels (the parent's program, a
    plain chain's cell) or without a trace, None, not 0."""
    ev = Events()
    for k in range(3):
        ev.span("bench.train_step", 100.0 * k, 100.0 * k + 100)
        ev.op(100.0 * k + 1, 100.0 * k + 2, 100.0 * k + 3)
    assert read(metric, Trace(ev.events, 2, ("bench.train_step",), skip=1)) is None
    assert read(metric, None) is None


def test_cell_reports_its_metrics():
    c = spec.load_cell(CELL, ROOT)
    assert {m["name"] for m in c.end_to_end} == {"train_step_ms", "setup_s"}
    assert {"sampling.device_ms.train", "sampling.idle_ms.train", "mfu.train",
            "paper_composite.roofline.train"} <= set(c.readers)
    assert set(c.limits) == set(c.kind.NAMES) and set(c.kind.FAULTS) >= {"pdf_ignored"}


def tiny(width=16):
    m = dict(paper_model(), num_layers=3, filter_size=width, num_encoding_functions=3,
             num_samples=8, skip_layer=1, dir_encoding_functions=2, view_width=8,
             num_fine_samples=8)
    return m


@pytest.mark.parametrize("block", [1, 3])
def test_reference_blocked_equals_unblocked(block):
    m = tiny()
    gen = torch.Generator().manual_seed(1)
    p = kind().init_params(gen, m, "cpu")
    o = torch.randn(5, 3, generator=gen) * 0.3 + torch.tensor([0.0, 0.0, 4.0])
    d = torch.randn(5, 3, generator=gen) * 0.2 + torch.tensor([0.0, 0.0, -1.0])
    tg = torch.rand(5, 3, generator=gen)
    t = ref.coarse_depths(gen, 5, m)
    u = ref.fine_draws(gen, 5, m)
    whole = ref.loss_and_grads(p, o, d, tg, t, u, m)
    part = ref.loss_and_grads(p, o, d, tg, t, u, m, block=block)
    assert part[0] == pytest.approx(whole[0], rel=1e-6)
    for a, b in zip(part[1], whole[1]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


def tiny_paper_copy(tmp_path):
    """The benchmark copied with a tiny published NeRF and its train cell
    (new files and entries only), limited as the real cell is."""
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((BENCH / "configs" / "nerf_paper_8x256.json").read_text())
    cfg["model"] = tiny(width=32)
    (tmp_path / "benchmark/configs/tiny_paper.json").write_text(json.dumps(cfg))
    t = json.loads((BENCH / "traffic" / "train_paper_4k.json").read_text())
    t.update(views=3, side=16, rays_per_step=128, trace_items=1)
    (tmp_path / "benchmark/traffic/tiny_paper.json").write_text(json.dumps(t))
    shutil.copy(BENCH / "limits" / f"{CELL}.json",
                tmp_path / "benchmark/limits/tiny_paper.train.json")
    b["configs"].append({"name": "tiny_paper", "source": "test", "reduced": [], "why": "tiny",
                         "file": "benchmark/configs/tiny_paper.json"})
    b["workloads"].append({"name": "tiny_paper.train", "config": "tiny_paper",
                           "traffic": "tiny_paper", "chips": 1, "why": "tiny"})
    for m in b["end_to_end"] + b["per_layer"]:
        if CELL in m.get("workloads", ()):
            m["workloads"].append("tiny_paper.train")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    return tmp_path


DRIVE = ("import runpy, sys\n"
         "from pathlib import Path\n"
         "from benchmark import spec\n"
         "fault = sys.argv.pop(1)\n"
         "cell = spec.load_cell(sys.argv[sys.argv.index('--workload') + 1], Path.cwd())\n"
         "with cell.kind.FAULTS[fault]():\n"
         "    runpy.run_path('benchmark/run.py', run_name='__main__')\n")


def test_tiny_cell_correct_and_each_fault_not(tmp_path):
    root = tiny_paper_copy(tmp_path)
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "2"}
    sound = run_cell(root, "tiny_paper.train", "--trace", "0", "--cpu", env=env)
    assert sound.returncode == 0, sound.stderr[-3000:]
    assert last_line(sound)["correct"] is True, sound.stdout[-2000:]
    for name in kind().FAULTS:
        out = subprocess.run([sys.executable, "-c", DRIVE, name, "--workload",
                              "tiny_paper.train", "--seed", str(2 ** 31 + 7), "--seconds", "0.5",
                              "--trace", "0", "--cpu"], cwd=root, env=env,
                             capture_output=True, text=True, timeout=600)
        assert out.returncode == 0, out.stderr[-3000:]
        assert last_line(out)["correct"] is False, (name, out.stdout[-2000:])
