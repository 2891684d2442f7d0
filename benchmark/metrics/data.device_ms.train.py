"""Device ms a train step spends on the draw: the gathers from the ray table
and the comb offsets, launched inside the benchmark's ``bench.draw`` span."""


def read(run):
    if run.trace is None:
        return None
    return run.trace.device_ms("bench.draw")
