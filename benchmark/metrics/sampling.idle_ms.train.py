"""Device-idle ms a train step inside the port's ``lomanerf.nerf.sample_pdf``
span: the device waiting on the sampler's host work between the coarse and
the fine pass (a host synchronisation there shows here)."""

from benchmark import spans


def read(run):
    return None if run.trace is None else spans.idle_ms(run.trace, "lomanerf.nerf.sample_pdf")
