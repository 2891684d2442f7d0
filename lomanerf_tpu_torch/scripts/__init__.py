"""Measurement scripts run as modules: ``grid_overhead`` (the launch-overhead
probe, the counterpart of ``scripts/tpu_grid_overhead.py``)."""
