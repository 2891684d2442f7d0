"""Profiling hooks (port of ``lomanerf_tpu.utils.profiling``).

* :func:`trace` — a context manager around ``torch.profiler`` (the host
  and, where there is a card, its kernels) that writes a Chrome trace
  (``trace.json``, for ``chrome://tracing`` or Perfetto) into ``log_dir``;
* :func:`span` — a named range of the program (``lomanerf.<module>.<what>``)
  in whatever profiler is recording, on the clock of the device's
  operations in the same trace; nothing while none records;
  :func:`spanned` makes a function's whole call one;
* :func:`device_memory_stats` — ``torch.cuda.memory_stats`` of the card,
  ``{}`` on the CPU.

Left out: ``dump_hlo``, ``print_lowered`` and ``cost_analysis``, which read
XLA's compiled HLO, StableHLO and cost model; PyTorch runs eagerly and
has no such artefacts.
"""

from __future__ import annotations

import contextlib
import functools
import os

import torch

TRACE_FILE = "trace.json"
_NO_SPAN = contextlib.nullcontext()  # stateless, so one serves every span


def span(name: str):
    """``torch.profiler.record_function(name)`` while a profiler is
    recording (a ``user_annotation`` range of the trace, on its clock), else
    a shared no-op context: the check costs a fraction of a microsecond, a
    ``record_function`` several, which a host-bound step would pay in device
    idle."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def spanned(name: str):
    """Decorator: each call of the function is the span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


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
