"""Device ms a train step spends on mip-NeRF 360's three losses and their
cotangents: the kernels launched inside the port's
``lomanerf.nerf.mip360_loss`` span."""


def read(run):
    if run.trace is None:
        return None
    return run.trace.device_ms("lomanerf.nerf.mip360_loss")
