"""The compile-and-time machinery of the variant scripts (``mlp_variants``,
``grad_variants``): a kernel header with textual edits, each variant built
by ``nvcc`` with the port's flags into a library of its own (all compiled at
once), its kernel's SASS counted and its registers and spills read from
``ptxas -v``, and the variants' calls timed in turns by CUDA events
(:func:`device_turns`: the card's work alone, with or without the L2
flushed, for calls shorter than their host time).

Needs the CUDA toolkit to compile and a card to time; the edits apply
anywhere (the tests check that every edit still matches its source).
"""

from __future__ import annotations

import hashlib
import re
import subprocess
from pathlib import Path

import torch

from lomanerf_tpu_torch.ops import build


def patch(path: Path, edits, tool: str) -> str:
    """The text of ``path`` with each ``(old, new, times)`` edit applied;
    ``old`` must occur exactly ``times`` times, so a changed source fails
    here rather than timing something else."""
    src = path.read_text()
    for old, new, times in edits:
        if src.count(old) != times:
            raise SystemExit(f"{tool}: {old!r} occurs {src.count(old)} times in "
                             f"{path.name}, not {times}: the variant is out of date")
        src = src.replace(old, new)
    return src


def compile_all(variants: dict, entry: str, out: Path, tool: str,
                include: Path = build.CSRC) -> dict:
    """One library per variant, all ``nvcc`` started together.  ``variants``
    maps a name to ``{header file name: text}``: the headers are written
    beside ``entry`` (the C entry's source), so they shadow those of
    ``include`` for the entry and for each other.  Returns name -> library
    path; a library of the same texts is reused."""
    nvcc = build._nvcc()
    jobs = {}
    for name, texts in variants.items():
        key = build.source_hash(include) + entry + "".join(
            f"{k}\n{v}" for k, v in sorted(texts.items()))
        d = out / hashlib.sha256(key.encode()).hexdigest()[:16]
        proc = None
        if not (d / "libvariant.so").exists():
            d.mkdir(parents=True, exist_ok=True)
            for file, text in texts.items():
                (d / file).write_text(text)
            (d / "variant.cu").write_text(entry)
            cmd = [nvcc, *build.NVCC_FLAGS, "-shared", "-I", str(include), "-o",
                   str(d / "tmp.so"), str(d / "variant.cu")]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)
        jobs[name] = (proc, d)
    libs = {}
    for name, (proc, d) in jobs.items():
        if proc is not None:
            log = proc.communicate()[0]
            (d / "build.log").write_text(log)
            if proc.returncode:
                raise SystemExit(f"{tool}: nvcc failed on {name!r}:\n{log[-4000:]}")
            (d / "tmp.so").replace(d / "libvariant.so")
        libs[name] = d / "libvariant.so"
    return libs


def sass_counts(lib: Path, kernel: str, prefixes) -> dict | None:
    """Instruction counts of the library's ``kernel`` (all, and those whose
    opcode starts with each of ``prefixes``), or None where the toolkit has
    no cuobjdump."""
    tool = Path(build._nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return None
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True).stdout
    body = next((f for f in sass.split("Function : ") if kernel in f.split("\n", 1)[0]), "")
    ins = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", body)
    return {"instructions": len(ins),
            **{p: sum(i.startswith(p) for i in ins) for p in prefixes}}


def ptxas(lib: Path, kernel: str) -> dict:
    """Registers a thread and spill stores of the first ``kernel`` entry the
    build log reports."""
    log = lib.with_name("build.log").read_text()
    start = re.search(rf"Compiling entry function '[^']*{kernel}", log)
    part = log[start.start():] if start else ""
    regs, spills = re.search(r"Used (\d+) registers", part), re.search(
        r"(\d+) bytes spill stores", part)
    return {"registers": int(regs.group(1)) if regs else None,
            "spill_stores": int(spills.group(1)) if spills else None}


def timed_turns(calls: dict, rounds: int) -> dict:
    """ms of each call by CUDA events from an idle card, in turns: every
    round runs the calls in order, then in reverse."""
    ms = {name: [] for name in calls}
    order = list(calls.items())
    for _ in range(rounds):
        for name, call in order + order[::-1]:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda.synchronize()
            start.record()
            call()
            end.record()
            torch.cuda.synchronize()
            ms[name].append(start.elapsed_time(end))
    return ms


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


SPIN_CYCLES = 200_000  # torch.cuda._sleep ahead of a timed call: ~0.1 ms of card work
L2_FLUSH_FLOATS = 32 << 20  # 128 MiB, past the card's 50 MB L2


def l2_flush(mode: str = "read"):
    """A callable that leaves the card's L2 holding none of a call's data:
    a read of a 128 MiB buffer, which leaves clean lines; with ``mode``
    "write", a write of it, which leaves dirty ones that the next call's
    misses write back."""
    buf = torch.ones(L2_FLUSH_FLOATS, device="cuda")
    return (lambda: buf.sum()) if mode == "read" else (lambda: buf.fill_(1.0))


def device_turns(calls: dict, rounds: int, flush=None) -> dict:
    """ms of each call's work on the card by CUDA events, in turns (every
    round in order, then in reverse).  Before each call the card is idle,
    then ``flush`` runs (if given) and a spin kernel keeps the card busy
    while the host enqueues the call, so the events time the card's work
    and not the host's."""
    ms = {name: [] for name in calls}
    order = list(calls.items())
    for _ in range(rounds):
        for name, call in order + order[::-1]:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda.synchronize()
            if flush is not None:
                flush()
            torch.cuda._sleep(SPIN_CYCLES)
            start.record()
            call()
            end.record()
            torch.cuda.synchronize()
            ms[name].append(start.elapsed_time(end))
    return ms
