"""Price a block and a launch on the card: the counterpart of
``scripts/tpu_grid_overhead.py``, which priced a Pallas grid step on the TPU.

``ops/probe.grid_sum`` sums an ``(8, rows)`` f32 array in ``(8, block)``
tiles, one block per tile, in one launch.  Two sweeps at constant bytes:

* **A, tiles per launch**: the JAX script's ``(block, dummies)`` list, one
  launch each (2,048, 2,048, 512, 128 and 64 tiles at 7,864,320 rows);
* **B, launches per step**: the same array in ``k`` launches in a row, each
  over ``rows // k`` columns in tiles of at most 3,840 columns, their sums
  added on the card and read back once.

Each line gives the median over ``2 x reps`` steps, the two inputs in turn
as the JAX script runs them: the device time (CUDA events) and the host's
clock around the step and the read of its result (the host's share is what
sweep B prices), per tile (A) or per launch (B), GB/s and the share of the
bound (the bytes over 3.35 TB/s), beside ``torch.sum`` of the same columns
timed in the same turns (the library call).  Every sum is checked against
numpy's f64 sum (within 1e-6 of the sum of |x|) and, per input, bit-identical
over the repeats.  ``--device cpu`` runs the plain version at the sizes
given, on the host's clock only.

Run:
    python -m lomanerf_tpu_torch.scripts.grid_overhead --rows 7864320 --reps 8
    python -m lomanerf_tpu_torch.scripts.grid_overhead --device cpu --rows 15360 --reps 1
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import time

import numpy as np
import torch

from lomanerf_tpu_torch.ops import probe

SWEEP_A = ((3840, 0), (3840, 2), (15360, 0), (61440, 0), (122880, 0))  # the JAX list
SWEEP_B = (1, 8, 64, 512, 2048)  # launches per step
SWEEP_B_BLOCK = 3840  # columns per tile in sweep B
PEAK_BYTES = 3.35e12  # H100 SXM device memory, bytes/s (NVIDIA data sheet)
SUM_RTOL = 1e-6  # |sum - f64 sum| over the sum of |x|


def _measure(fns, xs, reps, cuda):
    """``{name: (device ms list or None, host ms list, [(input, value)])}``:
    each step of each callable on the inputs in turn, the callables in
    order on even steps and in reverse on odd ones."""
    out = {name: ([], [], []) for name in fns}
    order = list(fns.items())
    for fn in fns.values():  # warm-up, both inputs
        for x in xs:
            fn(x).item()
    for i in range(2 * reps):
        x = xs[i % 2]
        for name, fn in (order if i % 2 == 0 else order[::-1]):
            dev, host, vals = out[name]
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            t0 = time.perf_counter()
            res = fn(x)
            if cuda:
                end.record()
            value = res.item()  # waits for the step
            host.append((time.perf_counter() - t0) * 1e3)
            if cuda:
                dev.append(start.elapsed_time(end))
            vals.append((i % 2, value))
    return out


def _line(label, count, per, cols, got, lib, refs, cuda):
    """The printed line of one sweep entry, and its numbers; raises if a
    sum misses the f64 sum or a repeat differs."""
    dev, host, vals = got
    err = max(abs(v - refs[cols][i][0]) / refs[cols][i][1] for i, v in vals)
    if err > SUM_RTOL:
        raise AssertionError(f"{label}: |sum - f64 sum| = {err:.3e} of sum|x| > {SUM_RTOL}")
    for i in (0, 1):
        if len({v for j, v in vals if j == i}) != 1:
            raise AssertionError(f"{label}: repeats on input {i} differ")
    nbytes = 8 * cols * 4
    rec = {"label": label, count: per, "cols": cols, "host_ms": statistics.median(host),
           "lib_host_ms": statistics.median(lib[1]), "err": err}
    text = f"{label}: host {rec['host_ms']:.4f} ms"
    unit = "tile" if count == "blocks" else "launch"
    if cuda:
        rec.update(ms=statistics.median(dev), lib_ms=statistics.median(lib[0]),
                   bound_ms=nbytes / PEAK_BYTES * 1e3)
        rec["gbps"] = nbytes / rec["ms"] / 1e6
        text = (f"{label}: device {rec['ms']:.4f} ms ({rec['ms'] / per * 1e3:.3f} us per "
                f"{unit}), host {rec['host_ms']:.4f} ms ({rec['host_ms'] / per * 1e3:.3f} us "
                f"per {unit}); {rec['gbps']:.1f} GB/s, {rec['bound_ms'] / rec['ms']:.1%} of "
                f"the {rec['bound_ms']:.4f} ms bound; torch.sum device {rec['lib_ms']:.4f} ms, "
                f"host {rec['lib_host_ms']:.4f} ms")
    else:
        text += (f"; torch.sum host {rec['lib_host_ms']:.4f} ms (the plain version on the "
                 "CPU: no device metric)")
    print(f"{text}; |sum-f64|/sum|x| {err:.2e}, repeats bit-identical", flush=True)
    return rec


def main(argv=None) -> dict:
    """Run both sweeps; returns ``{"A": [line...], "B": [line...],
    "slope": {...}}`` with each line's numbers (device ms only on a card)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=7864320)  # 262144 rays x 30
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="cuda runs the kernel, cpu its plain version")
    args = ap.parse_args(argv)
    cuda = args.device.startswith("cuda")
    if cuda and not torch.cuda.is_available():
        raise SystemExit("grid_overhead: no CUDA device; --device cpu runs the plain version")
    if cuda:
        try:
            smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"], capture_output=True,
                                 text=True).stdout.strip()
        except FileNotFoundError:
            smi = "nvidia-smi not found"
        print(f"device {torch.cuda.get_device_name(0)} ({smi})", flush=True)
    rng = np.random.default_rng(0)
    host_xs = [rng.standard_normal((8, args.rows)).astype(np.float32) for _ in range(2)]
    xs = [torch.from_numpy(x).to(args.device) for x in host_xs]
    refs = {}  # covered columns -> per input (f64 sum, f64 sum of |x|)

    def covered(cols):
        if cols not in refs:
            refs[cols] = [(float(np.sum(x[:, :cols], dtype=np.float64)),
                           float(np.sum(np.abs(x[:, :cols]), dtype=np.float64)))
                          for x in host_xs]
        return cols

    res = {"A": [], "B": []}
    for block, n_dummy in SWEEP_A:
        n_tiles = args.rows // block
        if n_tiles == 0:
            print(f"A block={block:6d}: fewer than {block} rows, skipped", flush=True)
            continue
        cols = covered(n_tiles * block)
        got = _measure({"kernel": lambda x, b=block, nd=n_dummy: probe.grid_sum(x, b, nd),
                        "lib": lambda x, c=cols: torch.sum(x[:, :c])}, xs, args.reps, cuda)
        res["A"].append(_line(f"A block={block:6d} dummies={n_dummy} tiles/launch="
                              f"{n_tiles:5d}", "blocks", n_tiles, cols, got["kernel"],
                              got["lib"], refs, cuda))
    for k in SWEEP_B:
        per = args.rows // k
        if per == 0:
            print(f"B launches={k:5d}: fewer rows than launches, skipped", flush=True)
            continue
        block = min(SWEEP_B_BLOCK, per)
        cols = covered(k * (per // block) * block)

        def step(x, k=k, per=per, block=block):
            return torch.stack([probe.grid_sum(x[:, j * per:(j + 1) * per], block)
                                for j in range(k)]).sum()

        got = _measure({"kernel": step, "lib": lambda x, c=cols: torch.sum(x[:, :c])},
                       xs, args.reps, cuda)
        res["B"].append(_line(f"B launches={k:5d} tiles/launch={per // block:5d}",
                              "launches", k, cols, got["kernel"], got["lib"], refs, cuda))
    if len(res["B"]) >= 2:
        ks = np.array([r["launches"] for r in res["B"]], dtype=np.float64)
        res["slope"] = {key: float(np.polyfit(ks, [r[key] for r in res["B"]], 1)[0]) * 1e3
                        for key in (("ms", "host_ms") if cuda else ("host_ms",))}
        print("B slope (least squares over k): "
              + ", ".join(f"{'device' if key == 'ms' else 'host'} {us:.3f} us per launch"
                          for key, us in res["slope"].items()), flush=True)
    return res


if __name__ == "__main__":
    main()
