"""Utilities: profiling hooks."""

from lomanerf_tpu_torch.utils.profiling import (  # noqa: F401
    device_memory_stats, span, spanned, trace)
