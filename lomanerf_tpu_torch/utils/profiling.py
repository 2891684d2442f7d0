"""Profiling hooks (port of ``lomanerf_tpu.utils.profiling``).

* :func:`trace` — a context manager around ``torch.profiler`` (the host
  and, where there is a card, its kernels) that writes a Chrome trace
  (``trace.json``, for ``chrome://tracing`` or Perfetto) into ``log_dir``;
* :func:`device_memory_stats` — ``torch.cuda.memory_stats`` of the card,
  ``{}`` on the CPU.

Left out: ``dump_hlo``, ``print_lowered`` and ``cost_analysis``, which read
XLA's compiled HLO, StableHLO and cost model; PyTorch runs eagerly and
has no such artefacts.
"""

from __future__ import annotations

import contextlib
import os

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str = "profile_trace"):
    """Profile everything inside the block; on exit, write the Chrome trace
    to ``<log_dir>/trace.json``.  Yields ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def device_memory_stats(device=None) -> dict:
    """Allocator statistics of a CUDA device (current, peak, ... bytes), or
    ``{}`` for a device without them (the CPU)."""
    device = torch.device(device) if device is not None else (
        torch.device("cuda") if torch.cuda.is_available() else torch.device("cpu"))
    if device.type != "cuda":
        return {}
    return dict(torch.cuda.memory_stats(device))
