"""A cell of ``BENCHMARK.json``, resolved into its files by name.

Nothing here knows a particular cell: a configuration is the file that its
entry names, a traffic mix is ``traffic/<traffic>.json``, the kind of
traffic that the mix names is the module ``loops/<kind>.py`` (see
``workloads.py``), a cell's limits are ``limits/<cell>.json``, and a
per-layer metric is the reader ``metrics/<metric>.py``.  Adding any of them
is adding files and entries.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
import types
from pathlib import Path
from typing import Callable, Dict, List

BENCH_DIR = Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration file's contents
    traffic: dict  # the traffic mix's parameters
    limits: dict  # number compared -> its limit
    end_to_end: List[dict]  # the BENCHMARK.json entries this cell reports
    per_layer: List[dict]
    kind: types.ModuleType  # loops/<kind>.py
    readers: Dict[str, Callable] = dataclasses.field(default_factory=dict)

    @property
    def model(self) -> dict:
        return self.config["model"]


def _reports(metric: dict, cell: str, e2e_names=None) -> bool:
    """Whether ``cell`` reports ``metric``: the cells its ``workloads``
    list, else every cell (an end-to-end metric) or every cell that reports
    the end-to-end metric it ``moves`` (a per-layer one)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_names is None or metric["moves"] in e2e_names


def _load(path: Path, prefix: str) -> types.ModuleType:
    """The module of a file found by name, loaded once a process."""
    name = f"{prefix}_{path.stem}".replace(".", "_")
    module = sys.modules.get(name)
    if module is None or getattr(module, "__file__", None) != str(path):
        mod_spec = importlib.util.spec_from_file_location(name, path)
        module = importlib.util.module_from_spec(mod_spec)
        sys.modules[name] = module
        mod_spec.loader.exec_module(module)
    return module


def load_reader(path: Path) -> Callable:
    """The ``read`` function of a metric's reader file."""
    return _load(path, "bench_metric").read


def load_kind(kind: str, bench_dir: Path = BENCH_DIR) -> types.ModuleType:
    """The module of the traffic kind ``kind``: ``loops/<kind>.py``."""
    path = bench_dir / "loops" / f"{kind}.py"
    if not path.is_file():
        raise SystemExit(f"no traffic kind {kind!r}: {path} is not there")
    return _load(path, "bench_loop")


def load_cell(name: str, root: Path | None = None) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json`` (the checkout's)."""
    bench_dir = (root / "benchmark") if root is not None else BENCH_DIR
    root = bench_dir.parent
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json; one of {sorted(cells)}")
    work = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[work["config"]]["file"]).read_text())
    traffic = json.loads((bench_dir / "traffic" / f"{work['traffic']}.json").read_text())
    limits_file = bench_dir / "limits" / f"{name}.json"
    limits = json.loads(limits_file.read_text()) if limits_file.exists() else {}
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, e2e_names)]
    readers = {m["name"]: load_reader(bench_dir / "metrics" / f"{m['name']}.py")
               for m in per_layer}
    kind = load_kind(traffic["kind"], bench_dir)
    refusal = kind.check_cell(name, config, traffic) if hasattr(kind, "check_cell") else None
    if refusal:
        raise SystemExit(refusal)
    return Cell(name, work["chips"], config, traffic, limits, e2e, per_layer, kind, readers)
