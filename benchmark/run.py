"""Run one cell of ``BENCHMARK.json`` and print its result as the last line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  One process, one card: set-up (the kernels'
build on a checkout's first run, the inputs and weights from ``--seed``,
the cell's first steps or frames), then a closed loop for ``--seconds``,
then, with ``--trace 1``, a few more steps or frames under the profiler for
the per-layer metrics.  Once the window has closed and the program's state
is freed, the plain reference (``reference/``) follows what the timed path
produced and decides ``correct``; each number compared is printed beside its
limit, last on standard error and last in the result.

Without a card (or with fewer than the cell's chips) it exits with code 2
and prints no result.  ``--cpu`` asks for a rehearsal on the CPU instead,
where the port runs its plain versions: the result names the CPU and holds
no device metric.
"""

import sys
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]
# bytecode of every module this process imports (the port's, torch's), kept
# at a fixed path inside the checkout whatever PYTHONDONTWRITEBYTECODE says:
# only a checkout's first run compiles them
sys.pycache_prefix = str(ROOT / "build" / "pycache")
sys.dont_write_bytecode = False

import argparse  # noqa: E402
import json  # noqa: E402
import platform  # noqa: E402
import resource  # noqa: E402
import subprocess  # noqa: E402
import types  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "lomanerf_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the port must not load."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="rehearse on the CPU (the port's plain versions); never a measurement")
    return ap.parse_args(argv)


def power_limit():
    """The card's power limit in W, from nvidia-smi, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=20)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def main(argv=None) -> int:
    args = parse(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark import spec

    cell = spec.load_cell(args.workload, ROOT)
    import torch

    on_gpu = not args.cpu
    if on_gpu and (not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips):
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{cell.name} needs {cell.chips} CUDA device(s); found {found}. "
              "No result (--cpu rehearses on the CPU).", file=sys.stderr)
        return 2
    device = torch.device("cuda" if on_gpu else "cpu")

    from benchmark import check, counts, trace, workloads

    t_import = time.perf_counter()
    loop = workloads.make(cell, args.seed, device)
    if on_gpu:
        torch.cuda.synchronize()
    t_inputs = time.perf_counter()
    loop.first()
    if on_gpu:
        torch.cuda.synchronize()
    t_first = time.perf_counter()
    setup_s = t_first - T_START
    phases = {"imports_s": t_import - T_START, "inputs_and_model_s": t_inputs - t_import,
              "first_items_s": t_first - t_inputs}

    result = loop.window(args.seconds)
    if on_gpu:
        torch.cuda.synchronize()
        memory_peak = torch.cuda.max_memory_allocated()
    else:
        memory_peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    values = {"setup_s": setup_s, **result["metric"]}
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}

    traced = None
    if args.trace:
        traced = trace.capture(loop.item, cell.traffic["trace_items"], (loop.span,))
    loop.free()
    if on_gpu:
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    numbers = cell.kind.numbers(loop.outputs(), loop.reference())
    correct, checks = check.judge(numbers, cell.limits)
    check_s = time.perf_counter() - t_check

    if args.trace:
        run = types.SimpleNamespace(
            trace=traced if on_gpu else None, on_gpu=on_gpu, metrics=values,
            work=counts.of_work(cell.kind.work(cell.model, cell.traffic),
                                cell.config["peak_flops"]),
            peak_flops=cell.config["peak_flops"])
        wanted = {m["name"]: cell.readers[m["name"]](run) for m in cell.per_layer}
        metrics = {k: {"value": v, "unit": units[k]} for k, v in wanted.items()
                   if v is not None}
    else:
        missing = [m["name"] for m in cell.end_to_end if m["name"] not in values]
        if missing:
            print(f"{cell.name}: the loop gives no {missing}", file=sys.stderr)
            return 1
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}

    if on_gpu:
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
               "memory_peak_bytes": memory_peak, "power_limit_w": power_limit()}
    else:
        dev = {"platform": "cpu", "kind": platform.processor() or platform.machine(),
               "count": 1, "memory_peak_bytes": memory_peak}
    if args.trace and on_gpu:
        dev.update(busy_s=traced.busy_s(), window_s=traced.window_s())
    line = {"correct": correct, "attempted": result["attempted"],
            "failed": result["failed"], "metrics": metrics, "device": dev}
    if args.trace and on_gpu:
        line["breakdown"] = traced.breakdown()
    line["setup_phases"] = phases
    line["check_s"] = check_s
    line["checks"] = checks

    loaded = forbidden_modules()
    if loaded:
        print(f"the process loaded {loaded}: no result", file=sys.stderr)
        return 3
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
