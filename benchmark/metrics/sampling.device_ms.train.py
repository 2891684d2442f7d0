"""Device ms a train step spends in the published NeRF's sampler: the kernels
launched inside the port's ``lomanerf.nerf.sample_pdf`` span (the fine
depths drawn from the coarse weights, merged and sorted)."""


def read(run):
    if run.trace is None:
        return None
    return run.trace.device_ms("lomanerf.nerf.sample_pdf")
