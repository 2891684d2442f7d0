"""Run a function on N ranks, each a spawned process of its own joined in
one process group (the port's launcher for tests, checks and benchmarks;
``torchrun`` is the launcher for training).

The rendezvous is a ``file://`` in a fresh temporary directory, so runs
side by side never contend for a port.  Each rank gets ``RANK``,
``WORLD_SIZE`` and ``LOCAL_RANK`` (its rank: on one node, ranks beyond the
card count share cards, ``mesh.rank_device``), forms the group through
``initialize_multihost``, runs ``fn(*args)`` and destroys the group.  The
parent never joins a group, so none outlives the run.  ``fn`` and its
arguments are pickled (a module-level function); so is its return value.
"""

from __future__ import annotations

import os
import queue
import tempfile
import time
import traceback

import torch
import torch.multiprocessing as mp


def _rank_main(rank, world, init, backend, threads, fn, args, results):
    import torch.distributed as dist

    from lomanerf_tpu_torch.parallel.mesh import initialize_multihost

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    if threads:
        torch.set_num_threads(threads)
    try:
        initialize_multihost(init, world, rank, backend)
        results.put((rank, True, fn(*args)))
    except Exception:  # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world_size: int, *args, backend: str = "gloo", threads: int | None = None,
              timeout: float = 300.0) -> list:
    """``[fn(*args) on rank 0, ..., on rank world_size - 1]``, each run in
    a spawned process within one ``backend`` process group (NCCL needs a
    card per rank).  ``threads`` sets each rank's torch CPU threads.  The
    first rank to fail (or the timeout) stops every rank and raises
    ``RuntimeError`` with its traceback."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    out, failure = {}, None
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main, args=(r, world_size, init, backend, threads,
                                                      fn, args, results))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while len(out) < world_size and failure is None:
                try:
                    rank, ok, value = results.get(timeout=1.0)
                except queue.Empty:
                    # a rank that died without a word (killed, or failed to
                    # start) stops the run; so does the timeout
                    dead = [r for r, p in enumerate(procs)
                            if r not in out and p.exitcode not in (None, 0)]
                    if dead:
                        failure = (f"rank {dead[0]} exited with code "
                                   f"{procs[dead[0]].exitcode} and no result")
                    elif time.monotonic() > deadline:
                        failure = f"timed out after {timeout} s; ranks done: {sorted(out)}"
                    continue
                if ok:
                    out[rank] = value
                else:
                    failure = f"rank {rank} failed:\n{value}"
        finally:
            for p in procs:
                if failure is not None:
                    p.kill()
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join()
    if failure is not None:
        raise RuntimeError(f"run_ranks({getattr(fn, '__name__', fn)}, {world_size}): {failure}")
    return [out[r] for r in range(world_size)]
