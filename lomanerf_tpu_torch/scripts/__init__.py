"""Measurement scripts run as modules: ``grid_overhead`` (the launch-overhead
probe, the counterpart of ``scripts/tpu_grid_overhead.py``),
``multihost_cpu_check`` (two gloo ranks against one process, the
counterpart of ``scripts/multihost_cpu_check.py``) and ``scaling_bench``
(weak scaling from 1 to N ranks, of ``scripts/scaling_bench.py``)."""
