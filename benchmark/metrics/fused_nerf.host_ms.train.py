"""Host ms a train step spends in the port's fused-NeRF wrapper: the union,
over threads, of its ``lomanerf.fused_nerf.*`` spans (the loss call, the
parameter packing, the C entry's launch, the gradients' unpacking and the
autograd backward)."""

from benchmark import spans


def read(run):
    return None if run.trace is None else spans.host_ms(run.trace, spans.FUSED_NERF)
