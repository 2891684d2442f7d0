"""The loss-and-gradient kernels' share of their roofline: the step's bound
(``counts.train_step``: the larger of FLOPs over the peak and bytes over
3.35 TB/s) over the device time of the kernels launched in a step outside
the draw and the optimizer, in %."""


def read(run):
    if run.trace is None:
        return None
    ms = run.trace.device_ms("bench.train_step",
                             outside=("bench.draw", "Optimizer.step#Adam.step"))
    return None if ms is None else 100.0 * run.work["bound_ms"] / ms
