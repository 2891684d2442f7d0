"""Device-idle ms a train step that falls inside the port's fused-NeRF
wrapper's ``lomanerf.fused_nerf.*`` spans: the device waiting on the
wrapper's host work (packing, scratch, the C entry's enqueue, unpacking,
the backward's scaling)."""

from benchmark import spans


def read(run):
    return None if run.trace is None else spans.idle_ms(run.trace, spans.FUSED_NERF)
