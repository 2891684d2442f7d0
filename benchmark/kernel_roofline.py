"""One kernel's share of its roofline in a traced run: the bound of the
operations and bytes that the cell's kind counts for it a step (``work``'s
``kernels``, by kernel name) over the device time a step of the trace's
kernels whose names hold that name."""

from __future__ import annotations

from benchmark import counts


def share(run, kernel: str) -> float | None:
    """In %; None without a trace, a count or a kernel of the name."""
    counted = run.work.get("kernels", {}).get(kernel) if run.trace is not None else None
    if counted is None:
        return None
    ops = [op for op in run.trace.in_window() if op.cat == "kernel" and kernel in op.name]
    if not ops:
        return None
    ms = sum(op.dur for op in ops) / 1e3 / run.trace.items
    return 100.0 * counts.bound(counted["macs"], run.peak_flops, counted["bytes"])[0] / ms
