"""Readings that a cell's limits are set from (``limits/<cell>.json``), at
the cell's own size, in one process:

* the program: what its timed path produced (a train cell's first checked
  steps; a render cell's first ``check_frames`` frames after its warm-up),
  against the plain reference, on every seed;
* the control: the reference computed in float8 (``reference.nerf.FP8``) in
  the program's place, on the first ``--control-seeds`` seeds;
* each fault that the cell's kind can have (``loops/<kind>.py``:
  ``FAULTS``), planted in the program, on the first ``--fault-seeds`` seeds.

    python3 benchmark/calibrate.py --workload <cell> --seeds 11 12 13 ...

Prints one JSON line a reading, then a summary: each number's largest
program reading (the lower one) and the smallest control and fault
readings.  Benchmark runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(cell, seed: int, device, fault=None):
    """The loop of ``cell`` at ``seed`` (under ``fault``) through the
    outputs the check compares; returns the freed loop and its outputs."""
    import torch

    from benchmark import workloads

    loop = workloads.make(cell, seed, device)
    loop.first()
    loop.fill_check()
    out = loop.outputs()
    loop.free()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return loop, out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--cpu", action="store_true", help="rehearse on the CPU")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import spec
    from benchmark.reference import nerf as ref

    cell = spec.load_cell(args.workload, ROOT)
    device = torch.device("cpu" if args.cpu else "cuda")
    kind = cell.kind
    found = {}

    def report(what, seed, got, prog=None, reference=None):
        found.setdefault(what, []).append(got)
        row = {"cell": cell.name, "what": what, "seed": seed, **got}
        if prog is not None and hasattr(kind, "look"):
            row.update(kind.look(prog, reference))
        print(json.dumps(row), flush=True)

    for i, seed in enumerate(args.seeds):
        loop, out = readings(cell, seed, device)
        reference = loop.reference()
        report("program", seed, kind.numbers(out, reference), out, reference)
        if i < args.control_seeds:
            control = kind.control_outputs(loop.reference(ref.FP8))
            report("control", seed, kind.numbers(control, reference))
        if i < args.fault_seeds:
            for name, fault in kind.FAULTS.items():
                with fault():
                    _, bad = readings(cell, seed, device)
                report(f"fault {name}", seed, kind.numbers(bad, reference))
        del loop
    summary = {}
    for what, rows in found.items():
        pick = max if what == "program" else min
        summary[what] = {k: pick(r[k] for r in rows) for k in rows[0]}
    print(json.dumps({"cell": cell.name, "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
