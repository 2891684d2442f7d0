"""The share of the traced frames' window in which the device ran no
kernel, copy or memset, in %."""


def read(run):
    if run.trace is None or not run.trace.ops or run.trace.window_s() <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s())
