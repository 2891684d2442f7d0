"""Device ms a train step spends in Adam: the kernels launched inside
PyTorch's ``Optimizer.step#Adam.step`` span."""


def read(run):
    if run.trace is None:
        return None
    return run.trace.device_ms("Optimizer.step#Adam.step")
