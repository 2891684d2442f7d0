"""Device ms a train step spends in mip-NeRF 360's proposal MLP: the kernels
launched inside the port's ``lomanerf.nerf.pass.proposal`` spans (each
round's encode, layers and compositing, and its backward)."""


def read(run):
    if run.trace is None:
        return None
    return run.trace.device_ms("lomanerf.nerf.pass.proposal")
