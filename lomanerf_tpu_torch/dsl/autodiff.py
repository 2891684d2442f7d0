"""DSL autodiff: fwd_diff via ``torch.func.jvp``, rev_diff via
``torch.func.vjp`` — composable (port of ``lomanerf_tpu.dsl.autodiff``).

Replaces the reference's source-to-source transforms (forward_diff.py,
reverse_diff.py).  Every compiled entry is a :class:`LoweredSpec` — an
argument schema plus an eager PyTorch callable — and fwd/rev
differentiation maps specs to specs, so compositions like the reference's
Hessian-by-rev-over-fwd (examples/loma_code/third_order_poly_hess.py:23-45)
fall out of ``torch.func`` transform composition (a ``vjp`` of a ``jvp``).

Conventions match loma:
* ``fwd_diff``: float-typed args/results become ``_dfloat`` duals
  ``{"val", "dval"}`` (autodiff.py:164-166); ints pass through.
* ``rev_diff``: In-arg adjoints are accumulated outputs; Out-arg adjoints
  and the return adjoint ``_dreturn`` are inputs (reverse_diff.py:492-517).

Int leaves are never primals of a transform: torch has no ``float0``
tangent, so ``lower.jvp_leaves``/``vjp_leaves`` close over them, and their
tangents and adjoints come back as zeros.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from lomanerf_tpu_torch.dsl import ir
from lomanerf_tpu_torch.dsl.lower import Lowerer, jvp_leaves, tree_map, vjp_leaves


def is_float_type(t: ir.Type) -> bool:
    if isinstance(t, ir.Float):
        return True
    if isinstance(t, ir.Array):
        return is_float_type(t.elem)
    if isinstance(t, ir.Struct):
        return any(is_float_type(ft) for _, ft in t.fields)
    if isinstance(t, ir.Diff):
        return True
    return False


@dataclasses.dataclass
class ArgSpec:
    id: str
    t: ir.Type
    is_out: bool
    dual: bool = False  # argument is a {val, dval} dual (fwd_diff level)


@dataclasses.dataclass
class LoweredSpec:
    """A compiled DSL entry: schema + eager callable.

    ``fn(args: list) -> (ret_or_None, {mutable_arg_name: final_value})``
    where mutable args are Out args and arrays (C-pointer semantics).
    """

    name: str
    args: List[ArgSpec]
    ret: bool  # has a return value
    ret_dual: bool
    fn: Callable[[List[Any]], Tuple[Any, Dict[str, Any]]]
    is_simd: bool = False
    simd_fn: Optional[Callable] = None  # fn(args, total_work) -> finals
    grad_fn: Optional[Callable] = None  # rev_diff: (args, _dreturn, out_adjoints)
    grad_simd_fn: Optional[Callable] = None  # rev_diff of @simd: (args, out_adjoints, n)


def spec_of_function(lowerer: Lowerer, f: ir.FunctionDef) -> LoweredSpec:
    args = [ArgSpec(a.id, a.t, a.is_out) for a in f.args]

    def fn(vals):
        return lowerer.run_function(f, list(vals))

    simd_fn = None
    if f.is_simd:
        def simd_fn(vals, total_work):
            return lowerer.run_simd(f, list(vals), total_work)

    return LoweredSpec(f.id, args, f.ret_type is not None, False, fn, f.is_simd, simd_fn)


def _with(vals, idx, new):
    full = list(vals)
    for i, v in zip(idx, new):
        full[i] = v
    return full


def forward_diff_spec(primal: LoweredSpec, name: str) -> LoweredSpec:
    """fwd_diff: duals for every float-typed arg; a jvp under the hood.

    ``fwd_diff`` of a ``@simd`` kernel is itself a simd kernel (the
    reference preserves ``is_simd`` through the transform): the jvp is
    taken of the WHOLE parallel dispatch, so cross-thread writes propagate
    tangents exactly like the generated ISPC duals."""
    args = [
        ArgSpec(a.id, ir.Diff(a.t) if is_float_type(a.t) else a.t, a.is_out,
                dual=is_float_type(a.t) or a.dual)
        for a in primal.args
    ]
    float_idx = [i for i, a in enumerate(args) if a.dual]

    def _split(dual_vals):
        vals = [x["val"] if a.dual else x for a, x in zip(args, dual_vals)]
        tans = [dual_vals[i]["dval"] for i in float_idx]
        return vals, tuple(vals[i] for i in float_idx), tuple(tans)

    def fn(dual_vals):
        vals, fvals, ftans = _split(dual_vals)
        (ret, finals), (dret, dfinals), _ = jvp_leaves(
            lambda fv: (primal.fn(_with(vals, float_idx, fv)), []), fvals, ftans)
        out_ret = {"val": ret, "dval": dret} if primal.ret else None
        return out_ret, {k: {"val": finals[k], "dval": dfinals[k]} for k in finals}

    simd_fn = None
    if primal.is_simd:
        def simd_fn(dual_vals, total_work):
            vals, fvals, ftans = _split(dual_vals)
            finals, dfinals, _ = jvp_leaves(
                lambda fv: (primal.simd_fn(_with(vals, float_idx, fv), total_work), []),
                fvals, ftans)
            return {k: {"val": finals[k], "dval": dfinals[k]} for k in finals}

    return LoweredSpec(name, args, primal.ret, True, fn, primal.is_simd, simd_fn)


def _seed(ret, dreturn):
    """The return value's cotangent from loma's ``_dreturn``: a scalar for
    every leaf, or a pytree (e.g. a dual ``{val, dval}`` for rev-over-fwd:
    seed ``dval = 1`` to extract second derivatives)."""
    if isinstance(dreturn, dict):
        return tree_map(lambda r, c: torch.as_tensor(c).to(r).broadcast_to(r.shape),
                        ret, dreturn)
    return tree_map(lambda r: torch.as_tensor(dreturn).to(r).broadcast_to(r.shape), ret)


def reverse_diff_spec(primal: LoweredSpec, name: str) -> LoweredSpec:
    """rev_diff over any spec (plain or fwd-diffed): a vjp under the hood.

    The returned spec's ``grad_fn(vals, _dreturn, out_adjoints)`` yields the
    adjoints of the differentiable In args.

    ``rev_diff`` of a ``@simd`` kernel (the reference's parallel reverse
    mode, hw_tests/hw3/test.py:452-515) differentiates the WHOLE parallel
    dispatch, so the adjoint fan-in that loma realises with ``atomic_add``
    in the generated ISPC adjoint (reverse_diff.py:144-155) falls out of
    the vjp: a value read by many threads accumulates all their cotangents.
    That spec's ``grad_simd_fn(vals, out_adjoints, total_work)`` takes the
    reference's trailing ``total_work`` (compiler.py:273-275).
    """
    diff_idx = [
        i for i, a in enumerate(primal.args)
        if not a.is_out and (a.dual or is_float_type(a.t))
    ]
    out_names = [a.id for a in primal.args if a.is_out]

    def _outs_ct(outs, out_adjoints):
        return {k: (out_adjoints or {}).get(k, tree_map(torch.zeros_like, v))
                for k, v in outs.items()}

    def grad_fn(vals, _dreturn, out_adjoints):
        def g(diff_args):
            ret, finals = primal.fn(_with(vals, diff_idx, diff_args))
            return ret, {k: finals[k] for k in out_names if k in finals}

        (ret, outs), vjp_fn = vjp_leaves(g, tuple(vals[i] for i in diff_idx))
        ret_ct = _seed(ret, _dreturn) if primal.ret else None
        d_diff = vjp_fn((ret_ct, _outs_ct(outs, out_adjoints)))
        return {primal.args[i].id: d for i, d in zip(diff_idx, d_diff)}

    grad_simd_fn = None
    if primal.is_simd:
        def grad_simd_fn(vals, out_adjoints, total_work):
            def g(diff_args):
                finals = primal.simd_fn(_with(vals, diff_idx, diff_args), total_work)
                return {k: finals[k] for k in out_names if k in finals}

            outs, vjp_fn = vjp_leaves(g, tuple(vals[i] for i in diff_idx))
            d_diff = vjp_fn(_outs_ct(outs, out_adjoints))
            return {primal.args[i].id: d for i, d in zip(diff_idx, d_diff)}

    return dataclasses.replace(primal, name=name, args=list(primal.args), grad_fn=grad_fn,
                               grad_simd_fn=grad_simd_fn)
