"""The whole train step's share of the card's peak: the step's forward, dW
and ``d_h`` FLOPs (``counts.train_step``) over ``train_step_ms`` of the
untraced window times the configuration's peak, in %."""


def read(run):
    if not run.on_gpu or "train_step_ms" not in run.metrics:
        return None
    return 100.0 * run.work["flops"] / (run.metrics["train_step_ms"] * 1e-3 * run.peak_flops)
