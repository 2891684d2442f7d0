"""Build the hand-written CUDA kernels at first use and bind them with ctypes.

Every ``ops/csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface (no PyTorch headers: a build takes
seconds, not minutes), under ``build/kernels/<hash>/`` at the repository
root, keyed by a hash of the sources and flags.  No fast-math: the kernels
keep IEEE ``expf``/``sincosf``.  Pointers and the CUDA stream cross as
``c_void_p``; each entry point returns ``cudaGetLastError()`` of its launch.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# entry point -> argtypes (every pointer and the stream as c_void_p)
SIGNATURES = {
    # (pk, pk_floats, origins, directions, out, n_rays, S, L, in_dim,
    #  num_functions, width, loma, stream)
    "nerf_render_fwd": [_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin); "
                       "the CUDA kernels are built only where the toolkit is")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def build() -> Path:
    """Compile the sources unless a library for them (same sources, same
    flags) exists; returns its path.  The compiler's register/shared-memory
    report goes to ``build.log`` beside it."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    lib = BUILD_ROOT / h.hexdigest()[:16] / "liblomanerf_kernels.so"
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    (lib.parent / "build.log").write_text(" ".join(cmd) + "\n" + log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The built library with every entry point's signature set."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
