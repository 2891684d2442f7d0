"""Device operations (kernels, copies, memsets) a train step launched inside
the port's ``lomanerf.fused_nerf.*`` spans: the wrapper's count of work, the
number that packed parameter storage or a CUDA graph of the step would
lower."""

from benchmark import spans


def read(run):
    return None if run.trace is None else spans.launches(run.trace, spans.FUSED_NERF)
