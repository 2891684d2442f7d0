"""The benchmark of ``lomanerf_tpu_torch`` (``BENCHMARK.json`` at the
repository root names its cells).  Run a cell from the root of a checkout:
``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>``."""
