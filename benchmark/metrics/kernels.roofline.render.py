"""The frame's kernels' share of their roofline: the frame's forward bound
(``counts.frame``) over the device time of every kernel launched in a
frame, in %."""


def read(run):
    if run.trace is None:
        return None
    ms = run.trace.device_ms("bench.frame")
    return None if ms is None else 100.0 * run.work["bound_ms"] / ms
