"""Golden-oracle harness: drive the reference loma CPU compiler from tests
(the port's own copy of the JAX package's ``parity/oracle.py``: numpy,
ctypes and gcc, importing nothing of either package).

This module compiles the reference's two differentiable kernels
(``$LOMANERF_REFERENCE/scripts/mlp_fit.py`` and ``.../nerf.py``) with the
reference's own compiler (``loma_public/compiler.py``, target='c', gcc) and
exposes numpy-in / numpy-out wrappers for the forward and reverse-mode
entry points.  The port's parity tests hold its plain PyTorch pipelines to
it (``tests/test_torch_oracle.py``), as the JAX package's tests hold its
own (the BASELINE.md correctness gate).

Nothing from the reference is copied; its compiler is imported as an
external tool (read-only), and the marshalling uses zero-copy ctypes
row-pointer builders (the reference deep-copies element-by-element per
call, mlp_utils.py:33-118 — a recorded perf quirk not reproduced).

Availability: requires the reference tree, named by the environment
variable ``LOMANERF_REFERENCE`` (no default: nothing outside the checkout
is read unless asked for), and gcc; tests skip without them through
:func:`oracle_available`.  The marshalling helpers (``pad_weights``,
``pad_biases``, ``unpad_like``, ``intermediate_shapes_for``, the row-pointer
builders) run anywhere.  Compiled oracles are cached in ``_oracle/`` at the
repository root (git-ignored).
"""

from __future__ import annotations

import ctypes
import os
import sys
import types
from typing import List, Sequence, Tuple

import numpy as np

_REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
REFERENCE_ROOT = os.environ.get("LOMANERF_REFERENCE")
ORACLE_CACHE = os.environ.get("LOMANERF_ORACLE_CACHE", os.path.join(_REPO, "_oracle"))

_FLOATP = ctypes.POINTER(ctypes.c_float)
_FLOATPP = ctypes.POINTER(_FLOATP)
_INTP = ctypes.POINTER(ctypes.c_int)


def oracle_available() -> bool:
    return bool(REFERENCE_ROOT) and os.path.isdir(os.path.join(REFERENCE_ROOT, "loma_public"))


_compiled_libs = {}


def _import_reference_compiler():
    """Import the reference compiler with its optional deps stubbed out.

    The reference needs the `asdl` + `gpuctypes` pip packages only for
    (re)generating its IR module and for the OpenCL backend; neither is
    needed for the C target, and its generated `_asdl/loma.py` is checked in.
    """
    loma_dir = os.path.join(REFERENCE_ROOT, "loma_public")
    for name, members in [
        ("asdl_gen", {"ADT": lambda *a, **k: None}),
        ("gpuctypes", {}),
        ("gpuctypes.opencl", {}),
        ("cl_utils", {"cl_compile": None, "build_ocl_kernels": None}),
    ]:
        if name not in sys.modules:
            mod = types.ModuleType(name)
            for k, v in members.items():
                setattr(mod, k, v)
            sys.modules[name] = mod
    if loma_dir not in sys.path:
        sys.path.insert(0, loma_dir)
    import compiler  # noqa: the reference's loma_public/compiler.py

    return compiler


def _raise_stack_limit():
    """loma's reverse-mode functions declare statically-sized tape arrays on
    the C stack (test.c:573-580); the NeRF tapes run to tens of MB.  Linux
    grows the main-thread stack on demand up to RLIMIT_STACK, so raise it."""
    import resource

    soft, hard = resource.getrlimit(resource.RLIMIT_STACK)
    want = 1 << 30  # 1 GiB
    if soft != resource.RLIM_INFINITY and soft < want:
        new_soft = want if hard == resource.RLIM_INFINITY else min(want, hard)
        try:
            resource.setrlimit(resource.RLIMIT_STACK, (new_soft, hard))
        except (ValueError, OSError):
            pass


# Entry points whose return value we read (loma forwards return float; the
# generated grad_* functions return void).  Needed when loading a cached .so
# directly, where the reference compiler hasn't set restype for us.
_FLOAT_SYMBOLS = {
    "mlp_fit": ["mlp_fit", "mult_a_b"],
    "nerf": ["nerf_evaluate_and_march"],
}


def get_lib(kernel: str):
    """Compile (once per process) scripts/<kernel>.py with the reference
    compiler and return the ctypes CDLL.

    Fast path: if a previously compiled ``_oracle/<kernel>.so`` is newer
    than the reference DSL source, load it directly — the reference's
    parse→AD→gcc pipeline takes minutes on the NeRF kernel (its reverse-mode
    C runs to tens of MB of tape), which starved timed benchmark windows
    (round-3 ladder).  All wrappers below pass explicit ctypes objects, so
    only restype needs setting.  Pre-seed the cache untimed with
    ``python scripts/precompile_oracle.py``.
    """
    if kernel in _compiled_libs:
        return _compiled_libs[kernel]
    _raise_stack_limit()
    src_path = os.path.join(REFERENCE_ROOT, "scripts", f"{kernel}.py")
    so_path = os.path.join(ORACLE_CACHE, f"{kernel}.so")
    # staleness = newest of the kernel DSL source AND the reference
    # compiler itself (loma_public/*.py): a compiler change must invalidate
    # the cached oracle binary, not silently reuse it
    deps_mtime = os.path.getmtime(src_path)
    compiler_dir = os.path.join(REFERENCE_ROOT, "loma_public")
    if os.path.isdir(compiler_dir):
        for root, _dirs, files in os.walk(compiler_dir):
            for f in files:
                if f.endswith((".py", ".cpp", ".h", ".asdl")):
                    deps_mtime = max(
                        deps_mtime,
                        os.path.getmtime(os.path.join(root, f)))
    if (
        os.path.exists(so_path)
        and os.path.getmtime(so_path) >= deps_mtime
    ):
        lib = ctypes.CDLL(so_path)
        for sym in _FLOAT_SYMBOLS.get(kernel, []):
            getattr(lib, sym).restype = ctypes.c_float
        _compiled_libs[kernel] = lib
        return lib
    compiler = _import_reference_compiler()
    os.makedirs(ORACLE_CACHE, exist_ok=True)
    with open(src_path) as f:
        code = f.read()
    out = os.path.join(ORACLE_CACHE, kernel)
    # The reference compiler prints every differentiated function; silence it.
    import contextlib, io

    with contextlib.redirect_stdout(io.StringIO()):
        _, lib = compiler.compile(code, target="c", output_filename=out)
    _compiled_libs[kernel] = lib
    return lib


# ---------------------------------------------------------------------------
# zero-copy ctypes marshalling (rows point into the numpy buffer)
# ---------------------------------------------------------------------------


def _as_f32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float32)


def _as_i32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int32)


def _rowptrs_2d(a: np.ndarray, ctype):
    rows, _ = a.shape
    ptr_t = ctypes.POINTER(ctype)
    arr = (ptr_t * rows)()
    base = a.ctypes.data
    stride = a.strides[0]
    for r in range(rows):
        arr[r] = ctypes.cast(base + r * stride, ptr_t)
    return arr


def _rowptrs_3d(a: np.ndarray, ctype):
    n = a.shape[0]
    ptr_t = ctypes.POINTER(ctypes.POINTER(ctype))
    outer = (ptr_t * n)()
    keepalive = []
    for i in range(n):
        inner = _rowptrs_2d(a[i], ctype)
        keepalive.append(inner)
        outer[i] = ctypes.cast(inner, ptr_t)
    outer._keepalive = keepalive  # prevent GC of row tables
    return outer


def f2d(a: np.ndarray):
    return _rowptrs_2d(a, ctypes.c_float)


def f3d(a: np.ndarray):
    return _rowptrs_3d(a, ctypes.c_float)


def i2d(a: np.ndarray):
    return _rowptrs_2d(a, ctypes.c_int)


# ---------------------------------------------------------------------------
# padding helpers (reference pads ragged layer lists to a dense cube,
# mlp_utils.py:272-313; gradients on the padding are structurally zero)
# ---------------------------------------------------------------------------


def pad_weights(ws: Sequence[np.ndarray]) -> np.ndarray:
    d0 = max(w.shape[0] for w in ws)
    d1 = max(w.shape[1] for w in ws)
    out = np.zeros((len(ws), d0, d1), dtype=np.float32)
    for i, w in enumerate(ws):
        out[i, : w.shape[0], : w.shape[1]] = w
    return out


def pad_biases(bs: Sequence[np.ndarray]) -> np.ndarray:
    d0 = max(b.shape[0] for b in bs)
    out = np.zeros((len(bs), d0), dtype=np.float32)
    for i, b in enumerate(bs):
        out[i, : b.shape[0]] = b
    return out


def unpad_like(padded: np.ndarray, shapes: Sequence[Tuple[int, ...]]) -> List[np.ndarray]:
    out = []
    for i, s in enumerate(shapes):
        sl = tuple(slice(0, d) for d in s)
        out.append(np.array(padded[i][sl]))
    return out


def intermediate_shapes_for(
    batch_rows: int, ws: Sequence[np.ndarray]
) -> np.ndarray:
    """Shapes of per-layer outputs for a given (traced) batch size
    (mlp_utils.trace_mlp_and_get_intermediate_outputs semantics)."""
    return np.array([[batch_rows, w.shape[1]] for w in ws], dtype=np.int32)


# ---------------------------------------------------------------------------
# mlp_fit (2D image fit) wrappers
# ---------------------------------------------------------------------------


def mlp_fit_forward(
    coords: np.ndarray,
    ws: Sequence[np.ndarray],
    bs: Sequence[np.ndarray],
    target: np.ndarray,
    trace_rows: int | None = None,
) -> float:
    """Run the oracle's compiled ``mlp_fit`` → scalar sum-MSE loss.

    ``trace_rows`` sets the traced intermediate row count (the reference
    traces with the actual chunk in fit_img.py:434-441; defaults to the
    batch size).
    """
    lib = get_lib("mlp_fit")
    coords = _as_f32(coords)
    target = _as_f32(target)
    n, in_ch = coords.shape
    ws_p, bs_p = pad_weights([_as_f32(w) for w in ws]), pad_biases(
        [_as_f32(b) for b in bs]
    )
    ws_shape = np.array([w.shape for w in ws], dtype=np.int32)
    bs_shape = np.array([[len(b), 1] for b in bs], dtype=np.int32)
    inter_shapes = intermediate_shapes_for(trace_rows or n, ws)
    md = int(inter_shapes.max())
    inter = np.zeros((len(ws), md, md), dtype=np.float32)
    layer_output = np.zeros_like(target)

    loss = lib.mlp_fit(
        f2d(coords),
        ctypes.c_int(n),
        ctypes.c_int(in_ch),
        f2d(layer_output),
        f3d(ws_p),
        f2d(bs_p),
        f2d(target),
        ctypes.c_int(target.shape[0]),
        ctypes.c_int(target.shape[1]),
        ctypes.c_int(len(ws)),
        i2d(ws_shape),
        i2d(bs_shape),
        i2d(inter_shapes),
        f3d(inter),
    )
    return float(loss)


def mlp_fit_grad(
    coords: np.ndarray,
    ws: Sequence[np.ndarray],
    bs: Sequence[np.ndarray],
    target: np.ndarray,
    seed: float = 1.0,
    trace_rows: int | None = None,
) -> Tuple[List[np.ndarray], List[np.ndarray], np.ndarray]:
    """Run the oracle's ``grad_mlp_fit`` with adjoint seed ``seed``.

    Returns ``(d_ws, d_bs, d_coords)`` sliced back to exact layer shapes.
    """
    lib = get_lib("mlp_fit")
    coords = _as_f32(coords)
    target = _as_f32(target)
    n, in_ch = coords.shape
    ws = [_as_f32(w) for w in ws]
    bs = [_as_f32(b) for b in bs]
    ws_p, bs_p = pad_weights(ws), pad_biases(bs)
    ws_shape = np.array([w.shape for w in ws], dtype=np.int32)
    bs_shape = np.array([[len(b), 1] for b in bs], dtype=np.int32)
    inter_shapes = intermediate_shapes_for(trace_rows or n, ws)
    md = int(inter_shapes.max())
    inter = np.zeros((len(ws), md, md), dtype=np.float32)
    layer_output = np.zeros_like(target)

    d_coords = np.zeros_like(coords)
    d_layer_output = np.zeros_like(layer_output)
    d_ws = np.zeros_like(ws_p)
    d_bs = np.zeros_like(bs_p)
    d_target = np.zeros_like(target)
    d_inter = np.zeros_like(inter)
    d_ws_shape = np.zeros_like(ws_shape)
    d_bs_shape = np.zeros_like(bs_shape)
    d_inter_shapes = np.zeros_like(inter_shapes)
    ints = [ctypes.c_int(0) for _ in range(5)]

    lib.grad_mlp_fit(
        f2d(coords),
        f2d(d_coords),
        ctypes.c_int(n),
        ctypes.byref(ints[0]),
        ctypes.c_int(in_ch),
        ctypes.byref(ints[1]),
        f2d(layer_output),
        f2d(d_layer_output),
        f3d(ws_p),
        f3d(d_ws),
        f2d(bs_p),
        f2d(d_bs),
        f2d(target),
        f2d(d_target),
        ctypes.c_int(target.shape[0]),
        ctypes.byref(ints[2]),
        ctypes.c_int(target.shape[1]),
        ctypes.byref(ints[3]),
        ctypes.c_int(len(ws)),
        ctypes.byref(ints[4]),
        i2d(ws_shape),
        i2d(d_ws_shape),
        i2d(bs_shape),
        i2d(d_bs_shape),
        i2d(inter_shapes),
        i2d(d_inter_shapes),
        f3d(inter),
        f3d(d_inter),
        ctypes.c_float(seed),
    )
    w_shapes = [w.shape for w in ws]
    b_shapes = [b.shape for b in bs]
    return unpad_like(d_ws, w_shapes), unpad_like(d_bs, b_shapes), d_coords


# ---------------------------------------------------------------------------
# nerf_evaluate_and_march wrappers
# ---------------------------------------------------------------------------


def _nerf_buffers(n_rays: int, num_samples: int):
    rgba = np.zeros((n_rays, num_samples, 4), dtype=np.float32)
    alpha = np.zeros((n_rays, num_samples), dtype=np.float32)
    cumprod = np.zeros((n_rays, num_samples), dtype=np.float32)
    wsamp = np.zeros((n_rays, num_samples), dtype=np.float32)
    color = np.zeros((n_rays, 3), dtype=np.float32)
    return rgba, alpha, cumprod, wsamp, color


def nerf_forward(
    enc_points: np.ndarray,
    ws: Sequence[np.ndarray],
    bs: Sequence[np.ndarray],
    target: np.ndarray,
    dists: np.ndarray,
    trace_rows: int = 256,
) -> Tuple[float, np.ndarray]:
    """Run the oracle's ``nerf_evaluate_and_march``.

    Args:
        enc_points: ``(N*S, F)`` encoded sample points.
        target: ``(N, 3)`` chunk targets.
        dists: ``(N, S)``.
        trace_rows: row count used for the traced intermediate shapes — the
            reference traces a FAKE 256-row batch (train_nerf.py:230-238),
            a recorded quirk that does not change results (padding rows get
            zero adjoints).

    Returns:
        (loss, accumulated_color (N,3)).
    """
    lib = get_lib("nerf")
    enc_points = _as_f32(enc_points)
    target = _as_f32(target)
    dists = _as_f32(dists)
    n_rays, num_samples = dists.shape
    total_rows, in_ch = enc_points.shape
    assert total_rows == n_rays * num_samples
    ws = [_as_f32(w) for w in ws]
    bs = [_as_f32(b) for b in bs]
    ws_p, bs_p = pad_weights(ws), pad_biases(bs)
    ws_shape = np.array([w.shape for w in ws], dtype=np.int32)
    bs_shape = np.array([[len(b), 1] for b in bs], dtype=np.int32)
    inter_shapes = intermediate_shapes_for(trace_rows, ws)
    md = int(inter_shapes.max())
    inter = np.zeros((len(ws), md, 256), dtype=np.float32)
    rgba, alpha, cumprod, wsamp, color = _nerf_buffers(n_rays, num_samples)

    loss = lib.nerf_evaluate_and_march(
        f2d(enc_points),
        ctypes.c_int(total_rows),
        ctypes.c_int(in_ch),
        f3d(ws_p),
        f2d(bs_p),
        f2d(target),
        ctypes.c_int(target.shape[0]),
        ctypes.c_int(target.shape[1]),
        ctypes.c_int(len(ws)),
        i2d(ws_shape),
        i2d(bs_shape),
        i2d(inter_shapes),
        f3d(inter),
        f3d(rgba),
        ctypes.c_int(num_samples),
        f2d(dists),
        f2d(alpha),
        f2d(cumprod),
        f2d(wsamp),
        f2d(color),
    )
    return float(loss), color


def nerf_grad(
    enc_points: np.ndarray,
    ws: Sequence[np.ndarray],
    bs: Sequence[np.ndarray],
    target: np.ndarray,
    dists: np.ndarray,
    seed: float = 1.0,
    trace_rows: int = 256,
) -> Tuple[List[np.ndarray], List[np.ndarray], np.ndarray]:
    """Run the oracle's ``grad_nerf_evaluate_and_march``.

    Returns ``(d_ws, d_bs, d_enc_points)`` (exact shapes).
    """
    lib = get_lib("nerf")
    enc_points = _as_f32(enc_points)
    target = _as_f32(target)
    dists = _as_f32(dists)
    n_rays, num_samples = dists.shape
    total_rows, in_ch = enc_points.shape
    ws = [_as_f32(w) for w in ws]
    bs = [_as_f32(b) for b in bs]
    ws_p, bs_p = pad_weights(ws), pad_biases(bs)
    ws_shape = np.array([w.shape for w in ws], dtype=np.int32)
    bs_shape = np.array([[len(b), 1] for b in bs], dtype=np.int32)
    inter_shapes = intermediate_shapes_for(trace_rows, ws)
    md = int(inter_shapes.max())
    inter = np.zeros((len(ws), md, 256), dtype=np.float32)
    rgba, alpha, cumprod, wsamp, color = _nerf_buffers(n_rays, num_samples)

    d_enc = np.zeros_like(enc_points)
    d_ws = np.zeros_like(ws_p)
    d_bs = np.zeros_like(bs_p)
    d_target = np.zeros_like(target)
    d_inter = np.zeros_like(inter)
    d_rgba = np.zeros_like(rgba)
    d_dists = np.zeros_like(dists)
    d_alpha = np.zeros_like(alpha)
    d_cumprod = np.zeros_like(cumprod)
    d_wsamp = np.zeros_like(wsamp)
    d_color = np.zeros_like(color)
    d_ws_shape = np.zeros_like(ws_shape)
    d_bs_shape = np.zeros_like(bs_shape)
    d_inter_shapes = np.zeros_like(inter_shapes)
    ints = [ctypes.c_int(0) for _ in range(5)]

    lib.grad_nerf_evaluate_and_march(
        f2d(enc_points),
        f2d(d_enc),
        ctypes.c_int(total_rows),
        ctypes.byref(ints[0]),
        ctypes.c_int(in_ch),
        ctypes.byref(ints[1]),
        f3d(ws_p),
        f3d(d_ws),
        f2d(bs_p),
        f2d(d_bs),
        f2d(target),
        f2d(d_target),
        ctypes.c_int(target.shape[0]),
        ctypes.byref(ints[2]),
        ctypes.c_int(target.shape[1]),
        ctypes.byref(ints[3]),
        ctypes.c_int(len(ws)),
        ctypes.byref(ints[4]),
        i2d(ws_shape),
        i2d(d_ws_shape),
        i2d(bs_shape),
        i2d(d_bs_shape),
        i2d(inter_shapes),
        i2d(d_inter_shapes),
        f3d(inter),
        f3d(d_inter),
        f3d(rgba),
        f3d(d_rgba),
        ctypes.c_int(num_samples),
        ctypes.byref(ctypes.c_int(0)),
        f2d(dists),
        f2d(d_dists),
        f2d(alpha),
        f2d(d_alpha),
        f2d(cumprod),
        f2d(d_cumprod),
        f2d(wsamp),
        f2d(d_wsamp),
        f2d(color),
        f2d(d_color),
        ctypes.c_float(seed),
    )
    w_shapes = [w.shape for w in ws]
    b_shapes = [b.shape for b in bs]
    return unpad_like(d_ws, w_shapes), unpad_like(d_bs, b_shapes), d_enc
