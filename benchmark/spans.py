"""Readings of the program's own spans in a traced run.

The port opens ``record_function`` ranges named ``lomanerf.<module>.<what>``
(``utils.profiling.span``) while a profiler records, so they lie on the
trace's clock beside the device's operations.  A layer's spans, by name
prefix, cover the window in the union of their intervals over every thread
(autograd runs a backward on a thread of its own), less the intervals of
another prefix's spans.  That cover is read against the window's device
idle (the window less ``Trace.busy()``) and against the operations
launched in it (``Op.spans``).  Each reading is per step or frame, and
None where the window holds none of the prefix's spans: on the CPU, or on
a program without them.
"""

from __future__ import annotations

FUSED_NERF = "lomanerf.fused_nerf."
TRAIN_STEP = "lomanerf.steps.train_step"
RENDER_IMAGE = "lomanerf.nerf.render_image"


def merged(intervals) -> list:
    """The union of ``(start, end)`` intervals, sorted and disjoint."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        elif b > a:
            out.append([a, b])
    return out


def minus(cover, cut) -> list:
    """``cover`` less ``cut``, both sorted and disjoint."""
    out = []
    for a, b in cover:
        for c, d in cut:
            if d <= a or c >= b:
                continue
            if c > a:
                out.append([a, c])
            a = max(a, d)
            if a >= b:
                break
        if a < b:
            out.append([a, b])
    return out


def common(x, y) -> list:
    """The intersection of two sorted, disjoint interval lists."""
    return minus(x, minus(x, y))


def length(intervals) -> float:
    return sum(b - a for a, b in intervals)


def cover(trace, prefix: str, less: str | None = None) -> list | None:
    """The window's part under spans whose names start with ``prefix``, less
    the part under those that start with ``less``; None if no span of
    ``prefix`` reaches into the window."""
    t0, t1 = trace.window

    def of(p):
        return merged((max(float(e["ts"]), t0), min(float(e["ts"]) + float(e["dur"]), t1))
                      for e in trace.host if e["name"].startswith(p))

    under = of(prefix)
    if not under:
        return None
    return minus(under, of(less)) if less else under


def idle(trace) -> list:
    """The window's intervals in which the device ran no operation."""
    return minus([list(trace.window)], trace.busy())


def host_ms(trace, prefix: str) -> float | None:
    """Host ms an item under the spans of ``prefix``."""
    under = cover(trace, prefix)
    return None if under is None else length(under) / 1e3 / trace.items


def idle_ms(trace, prefix: str, less: str | None = None) -> float | None:
    """Device-idle ms an item under the spans of ``prefix`` and outside those
    of ``less``."""
    under = cover(trace, prefix, less)
    return None if under is None else length(common(under, idle(trace))) / 1e3 / trace.items


def launches(trace, prefix: str) -> float | None:
    """Device operations an item launched inside a span of ``prefix``."""
    if cover(trace, prefix) is None:
        return None
    ops = [op for op in trace.in_window() if any(s.startswith(prefix) for s in op.spans)]
    return len(ops) / trace.items
