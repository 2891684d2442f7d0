"""The whole frame's share of the card's peak: the forward FLOPs of every
sample of the frame's rays (``counts.frame``) over ``frame_ms`` of the
untraced window times the configuration's peak, in %."""


def read(run):
    if not run.on_gpu or "frame_ms" not in run.metrics:
        return None
    return 100.0 * run.work["flops"] / (run.metrics["frame_ms"] * 1e-3 * run.peak_flops)
