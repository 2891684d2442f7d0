"""The harness: ``BENCHMARK.json`` against the contract's shape, cells found
by name, a CPU rehearsal's last line, a run without a card, and the check
failing under each planted fault and under the float8 control."""

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import check, spec

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTH_WORDS = ("hidden", "intermediate", "latent", "state", "projection", "head", "width",
               "filter", "expansion", "experts_per_tok")


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_contract_shape():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"] and b["command"] == ["python3", "benchmark/run.py"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    files = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert one_line(c["source"]) and one_line(c["why"])
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        assert c["file"] not in files
        files.add(c["file"])
        for key in c["reduced"]:
            assert NAME.match(key) and not key.endswith(("_dim", "_rank"))
            assert not any(w in key for w in WIDTH_WORDS)
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and one_line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
    setup = [m for m in b["end_to_end"] if m["name"] == "setup_s"]
    assert len(setup) == 1 and "workloads" not in setup[0] and setup[0]["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert one_line(m["layer"]) and m["source"] in SOURCES
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in {"lower", "higher"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in b[k]]
    assert all(NAME.match(n) for n in names) and len(names) == len(set(names))
    assert len(json.dumps(b).encode()) <= 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_every_cell_resolves_and_reports_what_its_metrics_move(cell):
    c = spec.load_cell(cell, ROOT)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e, (cell, m["name"])
        assert callable(c.readers[m["name"]])
    assert set(c.limits) == set(c.kind.NAMES)
    kind_metric = {"train": "train_step_ms", "render": "frame_ms"}[c.traffic["kind"]]
    assert kind_metric in e2e


def tiny_copy(tmp_path, limits_of=None):
    """The benchmark copied into ``tmp_path`` with a tiny configuration, two
    tiny traffic mixes and their cells, added as new files and entries
    only (no file of the copy is edited but ``BENCHMARK.json``)."""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = bench()
    cfg = json.loads((BENCH / "configs" / "nerf_8x256.json").read_text())
    cfg["model"].update(num_layers=3, num_samples=16)
    cfg.pop("render_side")
    (tmp_path / "benchmark/configs/tiny.json").write_text(json.dumps(cfg))
    t = json.loads((BENCH / "traffic" / "train_16k.json").read_text())
    t.update(views=3, side=16, rays_per_step=128, trace_items=2)
    (tmp_path / "benchmark/traffic/tiny_train.json").write_text(json.dumps(t))
    r = json.loads((BENCH / "traffic" / "render_800.json").read_text())
    r.update(poses=3, side=16, warmup_frames=1, check_frames=1, trace_items=1)
    (tmp_path / "benchmark/traffic/tiny_render.json").write_text(json.dumps(r))
    (tmp_path / "benchmark/metrics/extra.ms.py").write_text("def read(run):\n    return 1.5\n")
    b["configs"].append({"name": "tiny", "source": "test", "file": "benchmark/configs/tiny.json",
                         "reduced": [], "why": "tiny"})
    for kind in ("train", "render"):
        b["workloads"].append({"name": f"tiny.{kind}", "config": "tiny",
                               "traffic": f"tiny_{kind}", "chips": 1, "why": "tiny"})
        for m in b["end_to_end"] + b["per_layer"]:
            if m["name"].endswith(f".{kind}") or m["name"] == {
                    "train": "train_step_ms", "render": "frame_ms"}[kind]:
                m["workloads"].append(f"tiny.{kind}")
        if limits_of:
            shutil.copy(BENCH / "limits" / f"{limits_of[kind]}.json",
                        tmp_path / f"benchmark/limits/tiny.{kind}.json")
    b["per_layer"].append({"name": "extra.ms", "unit": "ms", "better": "lower",
                           "source": "host_clock", "layer": "data", "moves": "train_step_ms",
                           "workloads": ["tiny.train"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    return tmp_path


def test_new_files_are_found_by_name(tmp_path):
    root = tiny_copy(tmp_path)
    c = spec.load_cell("tiny.train", root)
    assert c.config["model"]["num_layers"] == 3 and c.traffic["rays_per_step"] == 128
    assert c.readers["extra.ms"](None) == 1.5
    assert "mfu.train" in c.readers and "frame_ms" not in {m["name"] for m in c.end_to_end}
    r = spec.load_cell("tiny.render", root)
    assert "extra.ms" not in r.readers and "mfu.render" in r.readers


def run_cell(root, cell, *extra, env=None, seed=2 ** 31 + 7):
    env = dict(os.environ if env is None else env)
    env.setdefault("OMP_NUM_THREADS", "2")
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                           str(seed), "--seconds", "0.5", *extra], cwd=root, env=env,
                          capture_output=True, text=True, timeout=600)


def last_line(out):
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert list(line)[-1] == "checks"
    return line


@pytest.mark.parametrize("cell, trace", [("tiny.train", "0"), ("tiny.render", "1")])
def test_cpu_rehearsal_prints_the_contract_line(tmp_path, cell, trace):
    root = tiny_copy(tmp_path)
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = run_cell(root, cell, "--trace", trace, "--cpu", env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    line = last_line(out)
    assert line["device"]["platform"] == "cpu" and line["attempted"] >= 1
    if trace == "0":
        assert set(line["metrics"]) == {"train_step_ms", "setup_s"}
    else:  # no device metric from a CPU run
        assert set(line["metrics"]) <= {"extra.ms"} and "busy_s" not in line["device"]
    assert out.stderr.strip().splitlines()[-1].startswith("check ")


NEW_KIND = '''"""``kind: "rays"``: one forward pass over a fixed batch of seeded rays."""
import torch
from torch.profiler import record_function

from benchmark import counts, workloads
from benchmark.reference import nerf as ref
from lomanerf_tpu_torch.core.rays import uniform_depths

NAMES = ("colour_error",)
FAULTS = {}


def work(model, traffic):
    return counts.frame(model, traffic["rays"])


class Loop(workloads.Loop):
    metric = "rays_ms"
    span = "bench.rays"

    def __init__(self, cell, seed, device):
        super().__init__(cell, seed, device)
        n, m = self.traffic["rays"], self.model_spec
        self.o, self.d = torch.randn((2, n, 3), generator=self.gen, device=self.gen.device)
        self.t_vals, self.dists = uniform_depths(m["near"], m["far"], m["num_samples"],
                                                 self.device)

    def item(self):
        with torch.no_grad(), record_function(self.span):
            self.out = self.model.render_rays(self.o, self.d, self.t_vals, self.dists).cpu()
        return True

    def first(self):
        self.item()

    def outputs(self):
        return {"colours": self.out}

    def reference(self, plan=ref.EXACT):
        return {"colours": ref.render_blocked(self.init, self.o, self.d, self.model_spec,
                                              plan).cpu()}


def numbers(prog, ref):
    return {"colour_error": float((prog["colours"] - ref["colours"]).abs().max())}


def control_outputs(control):
    return control
'''


def test_a_new_kind_of_traffic_is_new_files(tmp_path):
    """A kind of traffic the harness has never seen (its loop, its numbers,
    its work), dropped into a copy as ``loops/rays.py`` with its mix, its
    limits, a new end-to-end metric and a cell, runs on the CPU and comes
    out correct: no file of the benchmark is edited, only
    ``BENCHMARK.json``'s entries added."""
    root = tiny_copy(tmp_path)
    (root / "benchmark/loops/rays.py").write_text(NEW_KIND)
    (root / "benchmark/traffic/tiny_rays.json").write_text(json.dumps(
        {"kind": "rays", "rays": 64, "camera_angle_x": 0.6911, "trace_items": 1}))
    (root / "benchmark/limits/tiny.rays.json").write_text(json.dumps({"colour_error": 0.05}))
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["workloads"].append({"name": "tiny.rays", "config": "tiny", "traffic": "tiny_rays",
                           "chips": 1, "why": "tiny"})
    b["end_to_end"].append({"name": "rays_ms", "unit": "ms", "better": "lower", "bound": 0.05,
                            "source": "host_clock", "workloads": ["tiny.rays"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    for p in BENCH.rglob("*"):
        if p.is_file() and "__pycache__" not in p.parts:
            assert (root / "benchmark" / p.relative_to(BENCH)).read_bytes() == p.read_bytes()
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = run_cell(root, "tiny.rays", "--trace", "0", "--cpu", env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    line = last_line(out)
    assert line["correct"] is True and set(line["metrics"]) == {"rays_ms", "setup_s"}
    assert set(line["checks"]) == {"colour_error"}


def test_a_measured_run_without_a_card_fails():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = run_cell(ROOT, "nerf_8x256.train_16k", "--trace", "0", env=env)
    assert out.returncode == 2 and out.stdout.strip() == ""


def test_the_benchmark_alone_fails(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for extra in ((), ("--cpu",)):
        out = run_cell(tmp_path, "nerf_8x256.train_16k", "--trace", "0", *extra, env=env)
        assert out.returncode != 0 and "{" not in out.stdout


LIMITS_OF = {"train": "nerf_8x256.train_16k", "render": "nerf_8x256.render_800"}
DRIVE = ("import runpy, sys\n"
         "from pathlib import Path\n"
         "from benchmark import spec\n"
         "fault = sys.argv.pop(1)\n"
         "cell = spec.load_cell(sys.argv[sys.argv.index('--workload') + 1], Path.cwd())\n"
         "with cell.kind.FAULTS[fault]():\n"
         "    runpy.run_path('benchmark/run.py', run_name='__main__')\n")


@pytest.mark.parametrize("kind", ["train", "render"])
def test_each_fault_turns_correct_false(tmp_path, kind):
    """A whole run (past the look for a card: ``--cpu``) with the timed path
    broken underneath: correct is false under every fault the cell can
    have, and true without one."""
    root = tiny_copy(tmp_path, LIMITS_OF)
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "2"}
    sound = run_cell(root, f"tiny.{kind}", "--trace", "0", "--cpu", env=env)
    assert sound.returncode == 0 and last_line(sound)["correct"] is True, sound.stdout[-2000:]
    for name in spec.load_kind(kind).FAULTS:
        out = subprocess.run([sys.executable, "-c", DRIVE, name, "--workload", f"tiny.{kind}",
                              "--seed", str(2 ** 31 + 7), "--seconds", "0.5", "--trace", "0",
                              "--cpu"], cwd=root, env=env, capture_output=True, text=True,
                             timeout=600)
        assert out.returncode == 0, out.stderr[-3000:]
        assert last_line(out)["correct"] is False, (name, out.stdout[-2000:])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_the_float8_control_fails_at_the_cells_size(cell):
    """The reference computed in float8 in the program's place, at the
    cell's own size on three seeds: correct comes out false on each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell's own size")
    from benchmark import calibrate
    from benchmark.reference import nerf as ref

    c = spec.load_cell(cell, ROOT)
    for seed in (2 ** 31 + 11, 12, 13):
        loop, _ = calibrate.readings(c, seed, torch.device("cuda"))
        control = c.kind.control_outputs(loop.reference(ref.FP8))
        assert check.judge(c.kind.numbers(control, loop.reference()), c.limits)[0] is False
