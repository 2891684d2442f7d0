"""Build the hand-written CUDA kernels at first use and bind them with ctypes.

Every ``ops/csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface (no PyTorch headers: a build takes
seconds, not minutes), under ``build/kernels/<hash>/`` at the repository
root, keyed by a hash of the sources (``*.cu`` and the ``*.cuh`` headers
they include) and flags.  No fast-math: the kernels keep IEEE
``expf``/``sincosf``.  Pointers and the CUDA stream cross as ``c_void_p``;
each entry point returns ``cudaGetLastError()`` of its launches.
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
GENCODE = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*GENCODE, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# the narrow gradient kernels (nerf_grad.cuh): (pk, pk_floats, G, origins,
# directions, target or dcol, partials, out, n_rays, S, L, in_dim,
# num_functions, width, loma, stream)
_GRAD = [_P, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]
# their per-ray instances: t and dists ((N, S) pointers) after G
_GRAD_RAYS = _GRAD[:3] + [_P, _P] + _GRAD[3:]
# the wide gradient sequence (nerf_wide_chain.cuh): (W, b, ts, ds, origins,
# directions, target or dcol, acts, dz, dzb, db_part, n_db_part, dz_head,
# partials, n_parts, ray_loss, dW, db, loss, n_rays, chunk_rays, S, L, pw, kc,
# num_functions, loma, bf16, stream)
_WIDE_GRAD = [_P] * 11 + [_LL] + [_P] * 2 + [_LL] + [_P] * 4 + [_I] * 9 + [_P]
# (pk, pk_floats, origins, directions, out, n_rays, S, L, in_dim,
#  num_functions, width, loma, stream)
_RENDER = [_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]
# (W, b, ts, ds, origins, directions, out, acts, n_rays, chunk_rays, S, L,
#  pw, kc, num_functions, loma, bf16, stream); ts, ds (S,) or, for the
#  *_rays instances, (N, S)
_WIDE_RENDER = [_P] * 8 + [_I] * 9 + [_P]
# entry point -> argtypes (every pointer and the stream as c_void_p)
SIGNATURES = {
    "nerf_render_fwd": _RENDER,
    "nerf_train": _GRAD,
    "nerf_render_bwd": _GRAD,
    # the per-ray depth instances of the narrow kernels
    "nerf_render_fwd_rays": _RENDER[:2] + [_P, _P] + _RENDER[2:],
    "nerf_train_rays": _GRAD_RAYS,
    "nerf_render_bwd_rays": _GRAD_RAYS,
    "nerf_wide_render_fwd": _WIDE_RENDER,
    "nerf_wide_train": _WIDE_GRAD,
    "nerf_wide_render_bwd": _WIDE_GRAD,
    "nerf_wide_render_fwd_rays": _WIDE_RENDER,
    "nerf_wide_train_rays": _WIDE_GRAD,
    "nerf_wide_render_bwd_rays": _WIDE_GRAD,
    # the bf16 render on the layer chain the fused MLP replaced: as
    #  _WIDE_RENDER, with per_ray in place of bf16
    "nerf_wide_render_fwd_layers": _WIDE_RENDER,
    # the bf16 render's fused MLP alone (nerf_wide_mlp.cuh): (W, b, ts,
    #  origins, directions, out, n_rays, S, L, pw, kc, num_functions,
    #  per_ray, stream)
    "nerf_wide_mlp": [_P] * 6 + [_I] * 7 + [_P],
    # the wide sequence's bf16 dW stage alone (nerf_wide_dw.cuh): (H, Dz,
    #  ld, M, N, rows, partials, stream)
    "wide_dw_gemm": [_P, _P] + [_I] * 4 + [_P, _P],
    # the wide chain's bf16 layer GEMM alone (nerf_wide_layer_gemm.cuh): (A,
    #  W, b, mask, C, Cb, part, rows, pw, K, dh, stream), dh 0 the forward
    #  layer, 1 d_h (part: its column partials)
    "wide_layer_gemm": [_P] * 7 + [_I] * 4 + [_P],
    # the published NeRF (nerf_paper.cu): (W, b, ts, ds, origins,
    #  directions, out, weights, acts, n_rays, S, stream) and (W, b, ts, ds,
    #  origins, directions, target, weights, acts, dz, dz_head, db_part,
    #  tile_part, partials, n_parts, ray_loss, dW, db, loss, n_rays,
    #  chunk_rays, S, stream); weights may be null
    "nerf_paper_render": [_P] * 9 + [_I] * 2 + [_P],
    "nerf_paper_train": [_P] * 14 + [_LL] + [_P] * 4 + [_I] * 3 + [_P],
    # mip-NeRF 360 (mip360.cu): (origins, directions, sdist, radius, near,
    #  far, X, ldx, colx, V, ldv, colv, n_rays, S, flags, stream); V may be null
    "mip_encode": [_P, _P, _P, _F, _F, _F, _P, _I, _I, _P, _I, _I, _I, _I, _I, _P],
    # (s_in, w_in, n_in, xi, u0, du, jit, s_out, n_out, n_rays, stream);
    #  s_in, w_in and xi may be null
    "mip_resample": [_P, _P, _I, _P, _F, _F, _F, _P, _I, _I, _P],
    # (W, b, sdist, directions, acts, weights, n_rays, S, near, far, stream)
    "mip_prop_forward": [_P] * 6 + [_I, _I, _F, _F, _P],
    # (W, b, sdist, directions, acts, dw, dz, dz_head, db_part, tile_part,
    #  partials, dW, db, n_rays, S, near, far, stream)
    "mip_prop_backward": [_P] * 13 + [_I, _I, _F, _F, _P],
    # (W, b, sdist, directions, acts, out, weights, n_rays, S, near, far,
    #  stream); weights may be null
    "mip_nerf_forward": [_P] * 7 + [_I, _I, _F, _F, _P],
    # (W, b, sdist, directions, acts, dcol, dw, dz, dz_head, db_part,
    #  tile_part, partials, dW, db, n_rays, S, near, far, stream)
    "mip_nerf_backward": [_P] * 14 + [_I, _I, _F, _F, _P],
    # (col, tgt, s3, w3, S, s1, w1, s2, w2, Sp, c_data, c_dist, c_inter,
    #  ray_terms, terms, dcol, dw, dw1, dw2, n_rays, stream)
    "mip_losses": [_P] * 4 + [_I] + [_P] * 4 + [_I, _F, _F, _F] + [_P] * 6 + [_I, _P],
    # the wide chain's f32 GEMM alone (nerf_wide_f32_gemm.cuh): (A, lda, B,
    #  ldb, bias, mask, C, ldc, M, N, K, k_chunk, form, stream), form 0
    #  forward, 1 d_h, 2 dW, 3 head, 4 the head's d_z
    "wide_f32_gemm": [_P, _I, _P, _I, _P, _P, _P] + [_I] * 6 + [_P],
    # the 2D field (field_common.cuh): (pk, coords, out, n_blocks, n, L,
    #  in_dim, width, num_functions, out_ch, exact, stream); exact != 0 the
    #  f32 FMA products of the "highest" tier, 0 3xTF32
    "field_fwd": [_P, _P, _P] + [_I] * 8 + [_P],
    # (pk, G, coords, dout, partials, n_blocks, out, n, L, in_dim, width,
    #  num_functions, out_ch, exact, stream)
    "field_bwd": [_P, _I, _P, _P, _P, _I, _P] + [_I] * 7 + [_P],
    # (L, in_dim, width, num_functions, out_ch, exact) -> blocks of each
    #  kernel the card holds at once
    "field_fwd_blocks": [_I] * 6,
    "field_bwd_blocks": [_I] * 6,
    # fields past the tile kernels (field_wide.cu): (W, b, coords, out, acts,
    #  n, chunk, L, D, nf, hidden, out_ch, pw, exact, keep, stream); exact as
    #  for field_fwd, keep: acts keeps every layer's input for the backward
    "field_wide_fwd": [_P] * 5 + [_I] * 10 + [_P],
    # (W, b, coords, dout, acts, dz, partials, n_parts, dW, db, n, chunk, L,
    #  D, nf, hidden, out_ch, pw, exact, kept, stream); kept: acts holds them
    "field_wide_bwd": [_P] * 7 + [_LL, _P, _P] + [_I] * 10 + [_P],
    # the segmented scans (seg_scans.cu, steps in seg_scan.cuh): (x, out,
    #  n_rows, S, op: 0 cumprod / 1 suffix sum / 2 shift down, fill, stream)
    "seg_scans": [_P, _P, _I, _I, _I, ctypes.c_float, _P],
    # the grid-overhead probe (grid_sum.cu): (x, ld, cols, block, scratch,
    #  out, dummies, n_dummy, stream); x (8, cols) with row stride ld
    "grid_sum": [_P, _LL, _I, _I, _P, _P, _P, _I, _P],
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


def source_hash(csrc: Path = CSRC, flags=tuple(NVCC_FLAGS)) -> str:
    """Hash of the flags and of every ``*.cu`` and ``*.cuh`` under ``csrc``
    (name and bytes): a changed header gives a new library, not a stale one."""
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sorted([*csrc.glob("*.cu"), *csrc.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the ``*.cu`` sources unless a library for them (same sources
    and headers, same flags) exists; returns its path.  One ``nvcc -c`` per
    source, all started together, then one link.  The compiler's
    register/shared-memory report goes to ``build.log`` beside it."""
    lib = BUILD_ROOT / source_hash() / "liblomanerf_kernels.so"
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    nvcc, pid = _nvcc(), os.getpid()
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(lib.parent / f"{src.stem}.{pid}.o"),
             str(src)] for src in sorted(CSRC.glob("*.cu"))]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for cmd in cmds]
    outs = [proc.communicate()[0] for proc in procs]
    tmp = lib.with_suffix(f".{pid}.tmp")
    objs = [cmd[cmd.index("-o") + 1] for cmd in cmds]
    link = [nvcc, *GENCODE, "-shared", "-o", str(tmp), *objs]
    if all(proc.returncode == 0 for proc in procs):
        done = subprocess.run(link, capture_output=True, text=True)
        outs.append(done.stdout + done.stderr)
        failed = done.returncode
    else:
        failed = next(proc.returncode for proc in procs if proc.returncode)
    log = "\n".join(" ".join(cmd) + "\n" + out for cmd, out in zip([*cmds, link], outs))
    (lib.parent / "build.log").write_text(log)
    for obj in objs:
        Path(obj).unlink(missing_ok=True)
    if failed:
        raise RuntimeError(f"nvcc failed ({failed}):\n{log}")
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
