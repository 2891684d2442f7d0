"""Compile orchestrator: DSL source -> a library of eager PyTorch callables
(port of ``lomanerf_tpu.dsl.compiler``).

The counterpart of ``loma_public/compiler.py:70-278``: instead of codegen,
gcc/ispc/OpenCL and ctypes, the pipeline is

    parse -> static checks -> type inference -> lower to eager PyTorch

``compile(code)`` returns ``(structs, lib)`` where ``lib.<fname>`` are
callables with the reference's conventions (the JAX package's
``JaxLib``'s):

* plain functions: numpy arrays in, return value out; array arguments are
  written back in place (loma arrays are C pointers mutable by the callee;
  the reference's ctypes marshalling deep-copies per call,
  mlp_utils.py:33-118, so pass fresh buffers when re-calling accumulating
  kernels).
* ``d_f = fwd_diff(f)``: ``{"val": ..., "dval": ...}`` duals for float
  args (``lib.make__dfloat`` builds them), dual result out.
* ``grad_f = rev_diff(f)``: the interleaved (value, adjoint-buffer)
  argument list loma generates (reverse_diff.py:492-517) with the trailing
  ``_dreturn`` seed; In-arg adjoints are ACCUMULATED into the passed numpy
  buffers (and returned as numpy arrays), Out-arg adjoint buffers are read
  as incoming cotangents.
* compositions (``rev_diff`` of a ``fwd_diff`` function, etc.) resolve
  transitively — the reference's Hessian-by-rev-over-fwd pattern.
* ``@simd`` entries take the reference's trailing ``total_work``.

Everything runs eagerly on ``device`` (default ``"cuda"``; no card raises,
nothing falls back to the CPU): no ``jit``, no ``torch.compile``.  Loops
run until their condition is false, except in a vmapped ``@simd`` body
(``dsl/lower.py``), whose masked iterations the entry extends per call
from ``dsl/loopcheck``'s trip counts, with a :class:`LoopBoundWarning`.
The extension is an argument of the call, not a key of any cache.
"""

from __future__ import annotations

import warnings
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from lomanerf_tpu_torch.dsl import autodiff as dsl_ad
from lomanerf_tpu_torch.dsl import check as dsl_check
from lomanerf_tpu_torch.dsl import ir, loopcheck, parser
from lomanerf_tpu_torch.dsl import typecheck as dsl_typecheck
from lomanerf_tpu_torch.dsl.error import LoopBoundWarning, UserError
from lomanerf_tpu_torch.dsl.lower import Lowerer, tree_map


def make__dfloat(val, dval):
    return {"val": np.asarray(val, np.float32), "dval": np.asarray(dval, np.float32)}


class TorchLib:
    """Namespace of compiled DSL entry points (the CDLL analog)."""

    def __init__(self):
        self._fns: Dict[str, Any] = {}
        self.make__dfloat = make__dfloat

    def __getattr__(self, name):
        fns = self.__dict__.get("_fns", {})
        if name in fns:
            return fns[name]
        raise AttributeError(name)

    def add(self, name, fn):
        self._fns[name] = fn


def _to_torch(x, device):
    """A call argument as tensors on ``device``: float32 and int32 (numpy's
    float64 and int64 narrowed), dicts recursively; always a copy, so the
    caller's buffer changes only by the write-back."""
    if isinstance(x, dict):
        return {k: _to_torch(v, device) for k, v in x.items()}
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    if isinstance(x, (bool, np.bool_)):
        x = int(x)
    if isinstance(x, (int, np.integer)):
        return torch.tensor(x, dtype=torch.int32, device=device)
    if isinstance(x, (float, np.floating)):
        return torch.tensor(x, dtype=torch.float32, device=device)
    a = np.asarray(x)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    if a.dtype == np.int64:
        a = a.astype(np.int32)
    return torch.tensor(a, device=device)


def _to_numpy(tree):
    return tree_map(lambda x: x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x,
                    tree)


def _writeback(buf, val):
    """Write a result pytree back into the caller's buffers in place —
    recursing through struct (dict) values, whose arrays-of-structs are
    marshalled as dicts of numpy arrays."""
    if isinstance(buf, np.ndarray):
        np.copyto(buf, val.detach().cpu().numpy().astype(buf.dtype, copy=False))
    elif isinstance(buf, dict) and isinstance(val, dict):
        for k, v in val.items():
            if k in buf:
                _writeback(buf[k], v)


def _accum_into(buf, adj):
    """Accumulate an adjoint pytree into the caller's numpy buffers —
    recursing through struct (dict) adjoints, incl. nested _dfloat duals."""
    if isinstance(buf, np.ndarray):
        buf += adj.detach().cpu().numpy().astype(buf.dtype, copy=False)
    elif isinstance(buf, dict) and isinstance(adj, dict):
        for k, v in adj.items():
            if k in buf:
                _accum_into(buf[k], v)


def _scalar_or_array(x):
    r = x.detach().cpu().numpy()
    return r.item() if r.ndim == 0 else r


def _make_plain_entry(spec: dsl_ad.LoweredSpec, device):
    def entry(*call_args):
        if spec.is_simd:
            *args, total_work = call_args
            finals = spec.simd_fn([_to_torch(a, device) for a in args], int(total_work))
            ret = None
        else:
            args = call_args
            ret, finals = spec.fn([_to_torch(a, device) for a in args])
        for a, buf in zip(spec.args, args):
            if a.id in finals:
                _writeback(buf, finals[a.id])
        return None if ret is None else _scalar_or_array(ret)

    return entry


def _make_fwd_entry(spec: dsl_ad.LoweredSpec, device):
    def entry(*call_args):
        if spec.is_simd:
            # fwd_diff of a @simd kernel: dual args + the reference's
            # trailing total_work (compiler.py:262-277)
            *dual_args, total_work = call_args
            ret, dual_finals = None, spec.simd_fn(
                [_to_torch(a, device) for a in dual_args], int(total_work))
        else:
            dual_args = call_args
            ret, dual_finals = spec.fn([_to_torch(a, device) for a in dual_args])
        for a, buf in zip(spec.args, dual_args):
            if a.id in dual_finals and isinstance(buf, dict):
                _writeback(buf.get("val"), dual_finals[a.id]["val"])
                _writeback(buf.get("dval"), dual_finals[a.id]["dval"])
        return None if ret is None else tree_map(_scalar_or_array, ret)

    return entry


def _make_rev_entry(spec: dsl_ad.LoweredSpec, device):
    out_names = {a.id for a in spec.args if a.is_out}

    def entry(*call_args):
        """Interleaved loma convention: for each primal arg, (value,
        adjoint buffer); then _dreturn if the primal returns a value, or
        total_work for a @simd kernel (which returns nothing: its seeds are
        the Out-arg adjoint buffers)."""
        inter, last = list(call_args[:-1]), call_args[-1]
        if not (spec.is_simd or spec.ret):
            inter, last = list(call_args), 1.0
        if len(inter) != 2 * len(spec.args):
            tail = " + total_work" if spec.is_simd else " + _dreturn" if spec.ret else ""
            raise TypeError(f"grad entry expects {2 * len(spec.args)} interleaved args{tail}, "
                            f"got {len(call_args)}")
        values, adj_bufs = inter[0::2], inter[1::2]
        out_adj = {a.id: _to_torch(adj, device)
                   for a, adj in zip(spec.args, adj_bufs) if a.id in out_names}
        vals = [_to_torch(v, device) for v in values]
        if spec.is_simd:
            adjoints = spec.grad_simd_fn(vals, out_adj, int(last))
        else:
            dret = _to_torch(last, device) if isinstance(last, dict) else float(last)
            adjoints = spec.grad_fn(vals, dret, out_adj)
        for a, buf in zip(spec.args, adj_bufs):
            if a.id in adjoints:
                _accum_into(buf, adjoints[a.id])
        return _to_numpy(adjoints)

    return entry


def _resolve_spec(name: str, funcs: Dict[str, ir.Func], lowerer: Lowerer,
                  cache: Dict[str, dsl_ad.LoweredSpec]) -> dsl_ad.LoweredSpec:
    if name in cache:
        return cache[name]
    f = funcs[name]
    if isinstance(f, ir.FunctionDef):
        spec = dsl_ad.spec_of_function(lowerer, f)
    elif isinstance(f, ir.ForwardDiff):
        primal = _resolve_spec(f.primal_func, funcs, lowerer, cache)
        if primal.grad_fn is not None:
            raise UserError("fwd_diff of a rev_diff function is unsupported", f.lineno)
        spec = dsl_ad.forward_diff_spec(primal, f.id)
    elif isinstance(f, ir.ReverseDiff):
        primal = _resolve_spec(f.primal_func, funcs, lowerer, cache)
        spec = dsl_ad.reverse_diff_spec(primal, f.id)
    else:  # pragma: no cover
        raise UserError(f"unknown declaration {name}")
    cache[name] = spec
    return spec


def compile(
    code: str, target: str = "torch", output_filename: Optional[str] = None,
    loop_slack: int = 0, device: torch.device | str | None = None,
) -> Tuple[Dict[str, ir.Struct], TorchLib]:
    """Compile DSL source.  Returns (structs, lib).

    ``device`` (default ``"cuda"``) holds every value of a call; without a
    card ``"cuda"`` raises.  ``loop_slack`` adds masked iterations to every
    bounded loop of a vmapped ``@simd`` body (semantically free); loops
    elsewhere run until their condition is false, as in loma's C backend,
    where ``max_iter`` only budgets the reverse tape.  ``output_filename``
    is accepted for the reference's signature and unused."""
    if target != "torch":
        raise ValueError(f"target {target!r} is not supported by the PyTorch DSL; use "
                         "target='torch'")
    device = torch.device(device if device is not None else "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dsl.compile: device cuda but no CUDA device; pass device='cpu'")
    structs, funcs = parser.parse(code)
    dsl_check.check(structs, funcs)
    dsl_typecheck.infer(structs, funcs)  # static types + auto int<->float casts

    # resolve every entry EAGERLY so that lowering-stage errors surface at
    # compile() (the reference compiler's behavior), not at first call
    lowerer = Lowerer(structs, funcs, loop_slack=loop_slack, device=device)
    cache: Dict[str, dsl_ad.LoweredSpec] = {}
    lib = TorchLib()
    for name, f in funcs.items():
        spec = _resolve_spec(name, funcs, lowerer, cache)
        make = (_make_plain_entry if isinstance(f, ir.FunctionDef)
                else _make_fwd_entry if isinstance(f, ir.ForwardDiff) else _make_rev_entry)
        entry = make(spec, device)
        if spec.is_simd:
            primal = f
            while not isinstance(primal, ir.FunctionDef):
                primal = funcs[primal.primal_func]
            entry = _extended_entry(name, f, primal, lowerer, entry)
        lib.add(name, entry)
    return structs, lib


def _extended_entry(name: str, decl: ir.Func, primal: ir.FunctionDef, lowerer: Lowerer,
                    entry):
    """Wrap a ``@simd`` entry with the per-call loop extension: the masked
    iterations that ``dsl/loopcheck`` shows a vmapped loop needs beyond
    ``max_iter + loop_slack`` (a constant bound, or an unmodified ``In[int]``
    argument read from the call), with a :class:`LoopBoundWarning`.  Loops
    the analysis cannot see are caught after the dispatch
    (``Lowerer.run_simd``)."""
    bounds = loopcheck.analyze(primal)
    if not bounds:
        return entry
    step = 2 if isinstance(decl, ir.ReverseDiff) else 1  # interleaved (value, adjoint)
    arg_pos = {a.id: i for i, a in enumerate(primal.args)}

    def extended(*call_args):
        extra, culprit = 0, None
        for lb in bounds:
            v = lb.bound
            if isinstance(v, str):
                v = call_args[step * arg_pos[v]]
                v = int(np.asarray(v["val"] if isinstance(v, dict) else v))
            e = lb.extra_needed(v, lowerer.loop_slack)
            if e > extra:
                extra, culprit = e, (lb, v)
        if extra:
            warnings.warn(
                f"'{name}': the while loop at line {culprit[0].lineno} (bound "
                f"{culprit[0].bound}={culprit[1]}) runs more iterations than max_iter + "
                f"loop_slack allows; extending every vmapped loop by {extra} (legal in "
                "loma, where max_iter only sizes the reverse tape)",
                LoopBoundWarning, stacklevel=2)
        lowerer.loop_extend = extra
        try:
            return entry(*call_args)
        finally:
            lowerer.loop_extend = 0

    return extended
