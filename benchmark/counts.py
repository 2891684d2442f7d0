"""Operations and bytes of each cell's work, from its shapes.

The arithmetic of the port's card checks (``chip_smoke.py``: ``bound`` and
``mlp_macs``), frozen here so that the yardstick does not move with the
program.  A train step counts, per sample, the MLP's forward, its dW (the
forward's count again) and its ``d_h`` of every layer but the first: no
recompute and no first-layer ``d_h``, which the step does not need.  A frame
counts the forward of every sample of its rays.  Bytes count each input read
once and each output written once: a ray's origin, direction and target or
colour, and a train step's parameters read and gradients written.
"""

from __future__ import annotations

PEAK_BYTES = 3.35e12  # H100 SXM HBM3, NVIDIA's data sheet


def layer_sizes(model: dict) -> list:
    """Per-layer ``(fan_in, fan_out)`` of the model's MLP."""
    fan_in = 3 * (1 + 2 * model["num_encoding_functions"])
    sizes = []
    for i in range(model["num_layers"]):
        fan_out = model["out_channels"] if i == model["num_layers"] - 1 \
            else model["filter_size"]
        sizes.append((fan_in, fan_out))
        fan_in = fan_out
    return sizes


def mlp_macs(sizes) -> tuple:
    """(forward, backward) multiply-adds of one MLP row with layer ``sizes``.
    The backward is ``2 * forward + d_h``: the port's checks count it as
    the forward again, dW (the forward's count) and ``d_h`` of every layer
    but the first.  A train step (forward, dW, ``d_h``, no recompute) has
    the same count."""
    fwd = sum(fi * fo for fi, fo in sizes)
    return fwd, 2 * fwd + sum(fi * fo for fi, fo in sizes[1:])


def bound(macs: float, peak: float, nbytes: float) -> tuple:
    """(ms, "operations" or "bytes"): the least time the card could take for
    ``macs`` multiply-adds at ``peak`` FLOP/s and ``nbytes`` of device
    memory traffic."""
    ops_ms, bytes_ms = 2.0 * macs / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def train_step(model: dict, rays: int) -> dict:
    """A train step's forward + dW + ``d_h`` on ``rays`` rays."""
    sizes = layer_sizes(model)
    macs = rays * model["num_samples"] * mlp_macs(sizes)[1]
    n_params = sum(fi * fo + fo for fi, fo in sizes)
    return {"macs": macs, "bytes": rays * 36 + n_params * 8}


def frame(model: dict, rays: int) -> dict:
    """A frame's forward on ``rays`` rays (origins and directions in, colours
    out)."""
    macs = rays * model["num_samples"] * mlp_macs(layer_sizes(model))[0]
    return {"macs": macs, "bytes": rays * 36}


def of_work(work: dict, peak: float) -> dict:
    """One item's ``work`` (``macs`` and ``bytes``, from its kind's
    ``work``) with its ``flops``, ``bound_ms`` and what bounds it."""
    ms, by = bound(work["macs"], peak, work["bytes"])
    return {**work, "flops": 2.0 * work["macs"], "bound_ms": ms, "bound_by": by}
