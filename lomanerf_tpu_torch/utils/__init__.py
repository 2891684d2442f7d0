"""Utilities: profiling hooks."""

from lomanerf_tpu_torch.utils.profiling import device_memory_stats, trace  # noqa: F401
