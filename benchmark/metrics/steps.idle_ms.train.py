"""Device-idle ms a train step inside the port's ``lomanerf.steps.train_step``
span and outside every ``lomanerf.fused_nerf.*`` span: the step's own host
work around the wrapper (zero_grad, the autograd engine, Adam's launches)."""

from benchmark import spans


def read(run):
    if run.trace is None:
        return None
    return spans.idle_ms(run.trace, spans.TRAIN_STEP, less=spans.FUSED_NERF)
