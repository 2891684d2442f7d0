"""Lowering: DSL IR -> eager PyTorch (port of ``lomanerf_tpu.dsl.lower``).

The JAX package turns a program into a pure function for ``jax.jit``; here
the IR runs eagerly, statement by statement, on tensors on the library's
device, and stays a pure function of its inputs so that ``torch.func``
differentiates it (``dsl/autodiff.py``):

* mutable locals and arrays -> an environment dict threaded through the
  statements; array writes are out of place (``index_put``), so nothing
  that ``torch.func`` saved is overwritten;
* ``if/else`` -> only the TAKEN branch runs (the predicate is read on the
  host): loma's semantics, where an untaken branch that would divide by
  zero or take ``sqrt`` of a negative has no effect on values or adjoints.
  Inside a vmapped ``@simd`` body a predicate is one value per thread, so
  both branches run and each env entry is picked by ``torch.where`` (what
  ``lax.cond`` becomes under ``jax.vmap`` in the JAX package);
* bounded ``while (cond, max_iter := N)`` -> a true loop that runs until
  the condition is false: loma's own C semantics, where ``max_iter`` only
  sizes the reverse tape.  Inside a vmapped ``@simd`` body every thread runs
  ``N + loop_slack + loop_extend`` iterations, each masked by its own
  condition; each thread's final condition comes back from the dispatch
  and is checked once, after it: a thread that still wants to loop makes
  the dispatch run again with a larger budget, with a
  :class:`LoopBoundWarning`.  Nothing is truncated, and no host callback
  runs per loop;
* ``@simd`` bodies -> ``torch.func.vmap`` over thread ids when static
  analysis (:meth:`Lowerer._simd_vmap_plan`) proves the only cross-thread
  effects are thread-indexed slots and ``atomic_add`` accumulation;
  otherwise a Python loop over thread ids with the shared buffers in the
  env (sequential threads: deterministic, race-free);
* user calls -> inlined callees with copy-in/copy-out array args (loma
  arrays are C pointers mutable by callees).

Values: Int/Float -> 0-d int32/float32 tensors; Array -> tensors (dicts of
tensors for arrays of structs); Struct/Diff -> dicts.  ``_dfloat`` is the
dict ``{"val": x, "dval": dx}``.  Indices follow the JAX package's rules:
a negative index counts from the end, a read past the end is clamped and a
write past the end is dropped (never an out-of-bounds access on the card).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, Dict, List, Tuple

import torch
from torch.utils import _pytree

from lomanerf_tpu_torch.dsl import ir
from lomanerf_tpu_torch.dsl.error import LoopBoundWarning, TypeMismatch, UserError


def tree_map(fn: Callable, *trees):
    """``fn`` over the leaves of nested dicts of tensors (the DSL's values)."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _is_float(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


class _Out:
    """A function's output pytree split into its float tensors (what
    ``torch.func`` differentiates), its other tensors (ints, bools: carried
    as aux) and its other leaves (``None``: kept here)."""

    def split(self, out):
        leaves, self.spec = _pytree.tree_flatten(out)
        self.kind = [2 if _is_float(x) else 1 if isinstance(x, torch.Tensor) else 0
                     for x in leaves]
        self.const = [None if k else x for k, x in zip(self.kind, leaves)]
        return (tuple(x for k, x in zip(self.kind, leaves) if k == 2),
                tuple(x for k, x in zip(self.kind, leaves) if k == 1))

    def join(self, floats, others):
        fi, oi = iter(floats), iter(others)
        return _pytree.tree_unflatten(
            [next(fi) if k == 2 else next(oi) if k == 1 else c
             for k, c in zip(self.kind, self.const)], self.spec)

    def float_leaves(self, tree):
        """The float leaves of ``tree``, a pytree shaped as the output."""
        leaves, spec = _pytree.tree_flatten(tree)
        if spec != self.spec:
            raise ValueError(f"a cotangent shaped {spec}, not as the output {self.spec}")
        return [x for k, x in zip(self.kind, leaves) if k == 2]


def _leaves_like(ref, tree) -> list:
    """The leaves of ``tree`` in the order of ``ref``'s (nested dicts, lists
    and tuples of tensors; dicts matched by key)."""
    if isinstance(ref, dict):
        return [x for k in ref for x in _leaves_like(ref[k], tree[k])]
    if isinstance(ref, (list, tuple)):
        return [x for r, t in zip(ref, tree) for x in _leaves_like(r, t)]
    return [tree]


def jvp_leaves(fn: Callable, primals, tangents):
    """``torch.func.jvp`` of ``fn`` over the float leaves of the pytree
    ``primals`` (``tangents`` shaped alike); int leaves are closed over
    (torch has no ``float0`` tangent).  ``fn`` returns ``(out, aux)``, aux
    a list of tensors; returns ``(out, out_tangent, aux)``, with zero
    tangents for the int outputs."""
    p_leaves, spec = _pytree.tree_flatten(primals)
    t_leaves = _leaves_like(primals, tangents)
    idx = [i for i, x in enumerate(p_leaves) if _is_float(x)]
    shape = _Out()

    def inner(*floats):
        leaves = list(p_leaves)
        for i, x in zip(idx, floats):
            leaves[i] = x
        out, aux = fn(_pytree.tree_unflatten(leaves, spec))
        floats_out, others = shape.split(out)
        return floats_out, (others, aux)

    if idx:
        fo, ft, (others, aux) = torch.func.jvp(
            inner, tuple(p_leaves[i] for i in idx),
            tuple(torch.as_tensor(t_leaves[i]).to(p_leaves[i]) for i in idx), has_aux=True)
    else:
        fo, (others, aux) = inner()
        ft = tuple(torch.zeros_like(x) for x in fo)
    # a tangent in its output's dtype (a Python scalar in an op can widen a
    # tangent to float64)
    ft = tuple(t.to(o.dtype) for o, t in zip(fo, ft))
    return (shape.join(fo, others), shape.join(ft, [torch.zeros_like(x) for x in others]),
            aux)


def vjp_leaves(fn: Callable, primals):
    """``torch.func.vjp`` of ``fn`` over the float leaves of ``primals`` and
    of its output; int leaves pass through undifferentiated.  Returns
    ``(out, vjp_fn)``: ``vjp_fn(cotangent shaped as out)`` gives the pytree
    of ``primals``' adjoints, zeros for int leaves."""
    p_leaves, spec = _pytree.tree_flatten(primals)
    idx = [i for i, x in enumerate(p_leaves) if _is_float(x)]
    shape = _Out()

    def inner(*floats):
        leaves = list(p_leaves)
        for i, x in zip(idx, floats):
            leaves[i] = x
        return shape.split(fn(_pytree.tree_unflatten(leaves, spec)))

    if idx:
        fo, pullback, others = torch.func.vjp(inner, *(p_leaves[i] for i in idx),
                                              has_aux=True)
    else:
        (fo, others), pullback = inner(), None

    def vjp_fn(cotangent):
        leaves = [torch.zeros_like(x) for x in p_leaves]
        if pullback is not None:
            cts = shape.float_leaves(cotangent)
            for i, g in zip(idx, pullback(tuple(torch.as_tensor(c).to(o).broadcast_to(o.shape)
                                                for c, o in zip(cts, fo)))):
                leaves[i] = g
        return _pytree.tree_unflatten(leaves, spec)

    return shape.join(fo, others), vjp_fn


def zero_value(t: ir.Type, device) -> Any:
    if isinstance(t, ir.Int):
        return torch.zeros((), dtype=torch.int32, device=device)
    if isinstance(t, ir.Float):
        return torch.zeros((), dtype=torch.float32, device=device)
    if isinstance(t, ir.Array):
        n = t.static_size
        return tree_map(lambda z: torch.zeros((n,) + z.shape, dtype=z.dtype, device=device),
                        zero_value(t.elem, device))
    if isinstance(t, ir.Struct):
        return {f: zero_value(ft, device) for f, ft in t.fields}
    if isinstance(t, ir.Diff):
        base = zero_value(t.of, device)
        return {"val": base, "dval": base}
    raise TypeMismatch(f"cannot zero-init type {t}")


def _wrap(idx: torch.Tensor, n: int) -> torch.Tensor:
    """A negative index counts from the end (int64, for indexing)."""
    idx = idx.long()
    return torch.where(idx < 0, idx + n, idx)


def _index(value, idx):
    """``value[idx]`` on every leaf, the index clamped into range."""
    return tree_map(lambda a: a[_wrap(idx, a.shape[0]).clamp(0, a.shape[0] - 1)], value)


def _put(a: torch.Tensor, idx: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``a`` with ``a[idx] = s``, out of place; a write past either end is
    dropped."""
    n = a.shape[0]
    k = _wrap(idx, n)
    kc = k.clamp(0, n - 1)
    s = torch.where((k >= 0) & (k < n), s.to(a.dtype), a[kc])
    return a.index_put((kc,), s)


def _set_path(container, path, new_value):
    """Functional update along a path of ('idx', i) / ('field', name)."""
    if not path:
        return new_value
    kind, key = path[0]
    if kind == "field":
        return {**container, key: _set_path(container[key], path[1:], new_value)}
    sub = _set_path(_index(container, key), path[1:], new_value)
    return tree_map(lambda a, s: _put(a, key, s), container, sub)


def _as_bool(pred):
    """loma conditions are int/float (nonzero = true) or comparisons."""
    return pred if pred.dtype == torch.bool else pred != 0


def _select(pred, a, b):
    """``a`` where ``pred`` else ``b``, leaf by leaf (a leaf neither branch
    changed is passed through)."""
    return tree_map(lambda x, y: x if x is y else torch.where(pred, x, y), a, b)


def _dual_split(t: ir.Type, v):
    """Split a diff-typed VALUE of primal type ``t`` (struct-of-duals, the
    loma _dStruct layout) into (primal, tangent) trees; int leaves get zero
    tangents (closed over by :func:`jvp_leaves`)."""
    if isinstance(t, (ir.Float, ir.Diff)):
        return v["val"], v["dval"]
    if isinstance(t, ir.Int):
        return v, torch.zeros_like(v)
    if isinstance(t, ir.Array):
        return _dual_split(t.elem, v)  # arrays-of-structs are struct-of-arrays
    if isinstance(t, ir.Struct):
        vals, tans = {}, {}
        for f, ft in t.fields:
            vals[f], tans[f] = _dual_split(ft, v[f])
        return vals, tans
    raise TypeMismatch(f"cannot split dual of type {t}")


def _dual_merge(t: ir.Type, val, tan):
    """Inverse of :func:`_dual_split`: rebuild the struct-of-duals value."""
    if isinstance(t, (ir.Float, ir.Diff)):
        return {"val": val, "dval": tan}
    if isinstance(t, ir.Int):
        return val
    if isinstance(t, ir.Array):
        return _dual_merge(t.elem, val, tan)
    if isinstance(t, ir.Struct):
        return {f: _dual_merge(ft, val[f], tan[f]) for f, ft in t.fields}
    raise TypeMismatch(f"cannot merge dual of type {t}")


_BUILTIN_FNS = {
    "sin": torch.sin,
    "cos": torch.cos,
    "sqrt": torch.sqrt,
    "exp": torch.exp,
    "log": torch.log,
}

# the vmap route's accumulators materialise as (total_work, *shape) before
# the sum; above this many elements a body takes the sequential route
VMAP_ACCUM_ELEMS = 1 << 24


class Lowerer:
    def __init__(self, structs: Dict[str, ir.Struct], funcs: Dict[str, ir.Func],
                 loop_slack: int = 0, device: torch.device | str = "cpu"):
        self.structs = structs
        self.funcs = funcs
        self.device = torch.device(device)
        # extra masked iterations of every loop in a vmapped @simd body: the
        # caller's loop_slack, and a per-call extension the compiler sizes
        # from dsl/loopcheck (set around a call, 0 otherwise)
        self.loop_slack = loop_slack
        self.loop_extend = 0
        # roots of @simd shared buffers accessed only at thread_id() —
        # inside the vmap lowering their env entry IS the thread's slot
        self._slotted: frozenset = frozenset()
        # inside torch.func.vmap: branches select, loops are masked and
        # record each thread's final condition here
        self._vmapped = False
        self._still: List[torch.Tensor] = []
        # the program's literals as tensors, made here, outside any
        # torch.func transform (a tensor made inside one belongs to it)
        self._consts = {key: torch.tensor(key[0], dtype=key[1], device=self.device)
                        for key in _literals(list(funcs.values()), set())}

    def _const(self, val, dtype) -> torch.Tensor:
        const = self._consts.get((val, dtype))
        return const if const is not None else torch.tensor(val, dtype=dtype,
                                                            device=self.device)

    # -- expressions --------------------------------------------------------

    def eval_expr(self, e: ir.Expr, env: Dict) -> Any:
        if isinstance(e, ir.Var):
            return env[e.id]
        if isinstance(e, ir.ConstInt):
            return self._const(e.val, torch.int32)
        if isinstance(e, ir.ConstFloat):
            return self._const(e.val, torch.float32)
        if isinstance(e, ir.ArrayAccess):
            if isinstance(e.array, ir.Var) and e.array.id in self._slotted:
                # slotted @simd buffer: env holds this thread's slot (the
                # vmap plan proved the index is thread_id())
                return env[e.array.id]
            return _index(self.eval_expr(e.array, env), self.eval_expr(e.index, env))
        if isinstance(e, ir.StructAccess):
            return self.eval_expr(e.struct, env)[e.member]
        if isinstance(e, ir.UnaryOp):
            return -self.eval_expr(e.operand, env)
        if isinstance(e, ir.BinaryOp):
            return self._binop(e, env)
        if isinstance(e, ir.Call):
            return self._call_expr(e, env)
        raise UserError(f"cannot evaluate {e}", getattr(e, "lineno", None))

    def _binop(self, e: ir.BinaryOp, env: Dict):
        a = self.eval_expr(e.left, env)
        b = self.eval_expr(e.right, env)
        op = e.op
        if op == "+":
            return a + b
        if op == "-":
            return a - b
        if op == "*":
            return a * b
        if op == "/":
            # C semantics: int / int truncates toward zero
            if not (a.is_floating_point() or b.is_floating_point()):
                return torch.div(a, b, rounding_mode="trunc")
            return a / b
        if op == "%":
            return torch.fmod(a, b)  # C: the remainder takes the dividend's sign
        if op == "<":
            return a < b
        if op == "<=":
            return a <= b
        if op == ">":
            return a > b
        if op == ">=":
            return a >= b
        if op == "==":
            return a == b
        if op == "!=":
            return a != b
        if op == "and":
            return torch.logical_and(a, b)
        if op == "or":
            return torch.logical_or(a, b)
        raise UserError(f"unknown operator {op}", e.lineno)

    def _call_expr(self, e: ir.Call, env: Dict):
        if e.id in _BUILTIN_FNS:
            return _BUILTIN_FNS[e.id](self.eval_expr(e.args[0], env))
        if e.id == "pow":
            return torch.pow(self.eval_expr(e.args[0], env), self.eval_expr(e.args[1], env))
        if e.id == "int2float":
            return self.eval_expr(e.args[0], env).to(torch.float32)
        if e.id == "float2int":
            return self.eval_expr(e.args[0], env).to(torch.int32)
        if e.id == "thread_id":
            return env["__thread_id__"]
        if e.id == "make__dfloat":
            return {"val": self.eval_expr(e.args[0], env).to(torch.float32),
                    "dval": self.eval_expr(e.args[1], env).to(torch.float32)}
        if e.id in self.funcs:
            ret, env = self._call_user(e, env)
            return ret
        raise UserError(f"unknown function {e.id}", e.lineno)

    # -- calls --------------------------------------------------------------

    def _target_path(self, e: ir.Expr, env: Dict):
        """Decompose an lvalue expr into (root var name, path)."""
        path = []
        while True:
            if isinstance(e, ir.Var):
                p = list(reversed(path))
                if e.id in self._slotted and p and p[0][0] == "idx":
                    # slotted @simd buffer: the innermost [thread_id()]
                    # level is the env entry itself
                    p = p[1:]
                return e.id, p
            if isinstance(e, ir.ArrayAccess):
                path.append(("idx", self.eval_expr(e.index, env)))
                e = e.array
            elif isinstance(e, ir.StructAccess):
                path.append(("field", e.member))
                e = e.struct
            else:
                raise UserError("invalid assignment target", getattr(e, "lineno", None))

    def _call_user(self, e: ir.Call, env: Dict):
        callee = self.funcs[e.id]
        arg_vals = [self.eval_expr(a, env) for a in e.args]
        if isinstance(callee, ir.FunctionDef):
            ret, finals = self.run_function(callee, arg_vals,
                                            thread_id=env.get("__thread_id__"))
            arg_defs = callee.args
        elif isinstance(callee, ir.ForwardDiff):
            ret, finals = self._call_fwd_diff(callee, arg_vals, env)
            arg_defs = self.funcs[callee.primal_func].args
        else:
            raise UserError(f"cannot call rev_diff declaration '{e.id}' directly "
                            "from DSL code", e.lineno)
        # copy-out: arrays (C pointers) and Out args mutate the caller's view
        for arg, expr in zip(arg_defs, e.args):
            if arg.id in finals:
                root, path = self._target_path(expr, env)
                env = {**env, root: _set_path(env[root], path, finals[arg.id])}
        return ret, env

    def _call_fwd_diff(self, fd: ir.ForwardDiff, arg_vals: List[Any], env: Dict):
        """DSL-level call to a fwd_diff function (the reference's pendulum
        pattern): args/results are structural diff values (struct-of-duals);
        the dual arithmetic is ``torch.func.jvp`` over the lowered primal."""
        primal = self.funcs[fd.primal_func]
        if not isinstance(primal, ir.FunctionDef):
            raise UserError(f"fwd_diff of non-function '{fd.primal_func}'", fd.lineno)
        vals, tans = [], []
        for a, dv in zip(primal.args, arg_vals):
            v, t = _dual_split(a.t, dv)
            vals.append(v)
            tans.append(t)
        tid = env.get("__thread_id__")

        def g(vs):
            # a vmapped loop's final conditions leave the jvp as its aux
            before = len(self._still)
            out = self.run_function(primal, list(vs), thread_id=tid)
            still = self._still[before:]
            del self._still[before:]
            return out, still

        (ret, finals), (dret, dfinals), still = jvp_leaves(g, vals, tans)
        self._still.extend(still)
        out = (_dual_merge(primal.ret_type, ret, dret)
               if primal.ret_type is not None else None)
        arg_types = {a.id: a.t for a in primal.args}
        return out, {k: _dual_merge(arg_types[k], finals[k], dfinals[k]) for k in finals}

    # -- statements ---------------------------------------------------------

    def exec_stmts(self, stmts: List[ir.Stmt], env: Dict) -> Dict:
        for s in stmts:
            env = self.exec_stmt(s, env)
        return env

    def exec_stmt(self, s: ir.Stmt, env: Dict) -> Dict:
        if isinstance(s, ir.Declare):
            val = (self._coerce(self.eval_expr(s.val, env), s.t)
                   if s.val is not None else zero_value(s.t, self.device))
            return {**env, s.target: val}
        if isinstance(s, ir.Assign):
            root, path = self._target_path(s.target, env)
            val = self.eval_expr(s.val, env)
            old = env[root]
            # numeric coercion to the stored dtype (loma auto-casts,
            # type_inference.py:99-155)
            site = old
            for kind, key in path:
                site = site[key] if kind == "field" else _index(site, key)
            val = self._coerce_like(val, site)
            return {**env, root: _set_path(old, path, val)}
        if isinstance(s, ir.Return):
            return {**env, "__ret__": self.eval_expr(s.val, env)}
        if isinstance(s, ir.IfElse):
            pred = _as_bool(self.eval_expr(s.cond, env))
            if not self._vmapped:
                # only the taken branch runs: its values and adjoints alone
                # (an untaken 1/0 or sqrt(-x) cannot NaN the gradient)
                return self.exec_stmts(s.then_stmts if pred.item() else s.else_stmts, env)
            then_env = self.exec_stmts(s.then_stmts, env)
            else_env = self.exec_stmts(s.else_stmts, env)
            return {k: _select(pred, then_env[k], else_env[k]) for k in env}
        if isinstance(s, ir.While):
            return self._exec_while(s, env)
        if isinstance(s, ir.CallStmt):
            call = s.call
            if call.id == "atomic_add":
                root, path = self._target_path(call.args[0], env)
                add = self.eval_expr(call.args[1], env)
                site = env[root]
                for kind, key in path:
                    site = site[key] if kind == "field" else _index(site, key)
                return {**env, root: _set_path(env[root], path, site + add)}
            if call.id in self.funcs:
                _, env = self._call_user(call, env)
                return env
            # builtin as statement (no effect)
            self.eval_expr(call, env)
            return env
        raise UserError(f"cannot execute {s}", getattr(s, "lineno", None))

    def _exec_while(self, s: ir.While, env: Dict) -> Dict:
        if not self._vmapped:
            # a true loop, as loma's C backend runs it: max_iter sizes only
            # the reverse tape
            while _as_bool(self.eval_expr(s.cond, env)).item():
                env = self.exec_stmts(s.body, env)
            return env
        # one condition a thread: a fixed budget of masked iterations; a
        # thread whose condition is false keeps its env
        for _ in range(s.max_iter + self.loop_slack + self.loop_extend):
            pred = _as_bool(self.eval_expr(s.cond, env))
            new = self.exec_stmts(s.body, env)
            env = {k: _select(pred, new[k], env[k]) for k in env}
        self._still.append(_as_bool(self.eval_expr(s.cond, env)))
        return env

    def _coerce(self, val, t: ir.Type):
        if isinstance(t, ir.Float) and isinstance(val, torch.Tensor):
            return val.to(torch.float32)
        if isinstance(t, ir.Int) and isinstance(val, torch.Tensor):
            return val.to(torch.int32)
        return val

    def _coerce_like(self, val, site):
        if isinstance(site, torch.Tensor) and isinstance(val, torch.Tensor):
            return val.to(site.dtype)
        return val

    # -- functions ----------------------------------------------------------

    def run_function(self, f: ir.FunctionDef, arg_vals: List[Any],
                     thread_id=None) -> Tuple[Any, Dict[str, Any]]:
        """Execute a (non-simd dispatch of a) function body.

        Returns (return_value_or_None, {mutable_arg_name: final_value}).
        """
        env = {a.id: v for a, v in zip(f.args, arg_vals)}
        if thread_id is not None:
            env["__thread_id__"] = thread_id
        # slotted-name interception is scoped to the @simd BODY frame:
        # a callee whose parameter happens to share a slotted buffer's
        # name must index its own (by-value) arrays normally.  Copy-out
        # runs in the caller's frame afterwards, where slotting applies.
        prev = self._slotted
        self._slotted = frozenset()
        try:
            env = self.exec_stmts(f.body, env)
        finally:
            self._slotted = prev
        mutable = {a.id: env[a.id] for a in f.args if a.is_out or isinstance(a.t, ir.Array)}
        return env.get("__ret__"), mutable

    def run_simd(self, f: ir.FunctionDef, arg_vals: List[Any],
                 total_work: int) -> Dict[str, Any]:
        """Dispatch a @simd kernel.

        When static analysis proves the body's only cross-thread effects
        are thread-indexed slots and ``atomic_add`` accumulation (the
        reference's entire ``@simd`` contract — its ISPC/OpenCL backends
        run work-items concurrently with atomics as the sole communication
        primitive, codegen_ispc.py:15-75, codegen_opencl.py:15-62), the body
        runs under ``torch.func.vmap`` over thread ids: slots are gathered
        and scattered, and per-thread atomic contributions are summed.
        Bodies with order-dependent shared effects run the threads in turn
        (last-writer / read-your-predecessors semantics).
        """
        plan = self._simd_vmap_plan(f, total_work)
        if plan is not None and plan[1]:
            # accumulator contributions materialize as (total_work, *shape)
            # before the sum: sized from the runtime values
            elems = sum(x.numel() for a, v in zip(f.args, arg_vals) if a.id in plan[1]
                        for x in _pytree.tree_leaves(v))
            if total_work * elems > VMAP_ACCUM_ELEMS:
                plan = None
        if plan is None:
            return self._run_simd_scan(f, arg_vals, total_work)
        extend = self.loop_extend
        try:
            while True:
                out, still = self._run_simd_vmap(f, arg_vals, total_work, *plan)
                if not still.any().item():
                    return out
                grown = 2 * self.loop_extend + 8
                warnings.warn(
                    f"'{f.id}': a while loop in the vmapped @simd body ran out of its "
                    f"iterations (max_iter + loop_slack + {self.loop_extend}) with a "
                    f"thread's condition still true; running the dispatch again with "
                    f"{grown} more (legal in loma, where max_iter only sizes the "
                    "reverse tape)", LoopBoundWarning, stacklevel=2)
                self.loop_extend = grown
        finally:
            self.loop_extend = extend

    def _simd_vmap_plan(self, f: ir.FunctionDef, total_work: int):
        """Classify each shared (Out / Array) arg of a ``@simd`` body:

        * ``slot``: every access (read, write, atomic_add target, mutable
          call arg) is rooted at ``name[thread_id()]`` — threads touch
          disjoint slots;
        * ``accum``: appears ONLY as an ``atomic_add`` target (any index)
          and is never read — commutative accumulation;
        * read-only: never written (any index is fine);
        * anything else (bare mentions, non-thread-indexed writes, reads
          of an accumulator, whole-value Out assigns) is order-dependent.

        Returns ``(slotted, accums)`` frozensets when vmap is sound, else
        None (sequential fallback).
        """
        shared = {
            a.id for a in f.args
            if a.is_out or isinstance(a.t, ir.Array)
        }
        if not shared:
            return frozenset(), frozenset()
        uses: Dict[str, set] = {name: set() for name in shared}

        # locals provably == thread_id(): every write to the name (Declare
        # or Assign) stores thread_id() or another such alias (fixpoint;
        # e.g. ``i : int = thread_id()`` then indexing with ``i``)
        writes: Dict[str, list] = {}

        _non_tid = ir.BinaryOp()  # sentinel: disqualifies an alias

        def note_call_mutations(e):
            """Locals bound to a user callee's Out/Array params are written
            via copy-out — record a non-tid write for them."""
            if isinstance(e, ir.Call):
                callee = self.funcs.get(e.id)
                prim = callee if isinstance(callee, ir.FunctionDef) else (
                    self.funcs.get(callee.primal_func)
                    if isinstance(callee, ir.ForwardDiff) else None
                )
                for i, a in enumerate(e.args):
                    note_call_mutations(a)
                    if (prim is not None and i < len(prim.args)
                            and isinstance(a, ir.Var)):
                        ad = prim.args[i]
                        if ad.is_out or isinstance(ad.t, ir.Array):
                            writes.setdefault(a.id, []).append(_non_tid)
            elif isinstance(e, ir.BinaryOp):
                note_call_mutations(e.left)
                note_call_mutations(e.right)
            elif isinstance(e, ir.UnaryOp):
                note_call_mutations(e.operand)
            elif isinstance(e, ir.ArrayAccess):
                note_call_mutations(e.array)
                note_call_mutations(e.index)
            elif isinstance(e, ir.StructAccess):
                note_call_mutations(e.struct)

        def collect_writes(stmts):
            for s in stmts:
                if isinstance(s, ir.Declare):
                    writes.setdefault(s.target, []).append(s.val)
                    note_call_mutations(s.val)
                elif isinstance(s, ir.Assign):
                    if isinstance(s.target, ir.Var):
                        writes.setdefault(s.target.id, []).append(s.val)
                    note_call_mutations(s.val)
                elif isinstance(s, ir.Return):
                    note_call_mutations(s.val)
                elif isinstance(s, ir.IfElse):
                    note_call_mutations(s.cond)
                    collect_writes(s.then_stmts)
                    collect_writes(s.else_stmts)
                elif isinstance(s, ir.While):
                    note_call_mutations(s.cond)
                    collect_writes(s.body)
                elif isinstance(s, ir.CallStmt):
                    note_call_mutations(s.call)

        collect_writes(f.body)
        tid_aliases = {
            n for n, vs in writes.items()
            if n not in shared and all(v is not None for v in vs)
        }
        changed = True
        while changed:
            changed = False
            for n in list(tid_aliases):
                ok = all(
                    (isinstance(v, ir.Call) and v.id == "thread_id")
                    or (isinstance(v, ir.Var) and v.id in tid_aliases)
                    for v in writes[n]
                )
                if not ok:
                    tid_aliases.discard(n)
                    changed = True

        def is_tid(e):
            return (isinstance(e, ir.Call) and e.id == "thread_id") or (
                isinstance(e, ir.Var) and e.id in tid_aliases
            )

        def chain_root(e):
            """(root var name, innermost index expr or None) of an access
            chain; (None, None) if the chain isn't rooted at a Var."""
            idx = None
            while True:
                if isinstance(e, ir.ArrayAccess):
                    idx, e = e.index, e.array
                elif isinstance(e, ir.StructAccess):
                    idx, e = None, e.struct
                elif isinstance(e, ir.Var):
                    return e.id, idx
                else:
                    return None, None

        def walk_chain_indices(e):
            while isinstance(e, (ir.ArrayAccess, ir.StructAccess)):
                if isinstance(e, ir.ArrayAccess):
                    walk_expr(e.index)
                    e = e.array
                else:
                    e = e.struct

        def walk_expr(e):
            if e is None or isinstance(e, (ir.ConstInt, ir.ConstFloat)):
                return
            if isinstance(e, ir.Var):
                if e.id in shared:
                    uses[e.id].add("bad")  # bare mention
                return
            if isinstance(e, (ir.ArrayAccess, ir.StructAccess)):
                root, idx = chain_root(e)
                if root in shared:
                    uses[root].add(
                        "slot_read" if (idx is not None and is_tid(idx))
                        else "read"
                    )
                walk_chain_indices(e)
                return
            if isinstance(e, ir.UnaryOp):
                walk_expr(e.operand)
                return
            if isinstance(e, ir.BinaryOp):
                walk_expr(e.left)
                walk_expr(e.right)
                return
            if isinstance(e, ir.Call):
                callee = self.funcs.get(e.id)
                prim = None
                if isinstance(callee, ir.FunctionDef):
                    prim = callee
                elif isinstance(callee, ir.ForwardDiff):
                    prim = self.funcs.get(callee.primal_func)
                for i, a in enumerate(e.args):
                    walk_expr(a)
                    if prim is not None and i < len(prim.args):
                        ad = prim.args[i]
                        if ad.is_out or isinstance(ad.t, ir.Array):
                            # copy-out writes back through this arg expr
                            root, idx = chain_root(a) if isinstance(
                                a, (ir.ArrayAccess, ir.StructAccess)
                            ) else (None, None)
                            if isinstance(a, ir.Var) and a.id in shared:
                                pass  # already "bad" from walk_expr
                            elif root in shared:
                                # copy-out writes back through this arg
                                uses[root].add(
                                    "slot_write"
                                    if (idx is not None and is_tid(idx))
                                    else "bad"
                                )
                return
            return

        def walk_lvalue(t):
            if isinstance(t, ir.Var):
                if t.id in shared:
                    uses[t.id].add("bad")  # whole-value overwrite
                return
            root, idx = chain_root(t)
            if root in shared:
                uses[root].add(
                    "slot_write" if (idx is not None and is_tid(idx))
                    else "bad"
                )
            walk_chain_indices(t)

        def walk_stmt(s):
            if isinstance(s, ir.Declare):
                walk_expr(s.val)
            elif isinstance(s, ir.Assign):
                walk_lvalue(s.target)
                walk_expr(s.val)
            elif isinstance(s, ir.Return):
                walk_expr(s.val)
            elif isinstance(s, ir.IfElse):
                walk_expr(s.cond)
                for b in s.then_stmts:
                    walk_stmt(b)
                for b in s.else_stmts:
                    walk_stmt(b)
            elif isinstance(s, ir.While):
                walk_expr(s.cond)
                for b in s.body:
                    walk_stmt(b)
            elif isinstance(s, ir.CallStmt):
                c = s.call
                if c.id == "atomic_add":
                    t = c.args[0]
                    if isinstance(t, ir.Var):
                        if t.id in shared:
                            uses[t.id].add("accum")
                    else:
                        root, idx = chain_root(t)
                        if root in shared:
                            uses[root].add(
                                "slot_write"
                                if (idx is not None and is_tid(idx))
                                else "accum"
                            )
                        walk_chain_indices(t)
                    walk_expr(c.args[1])
                else:
                    walk_expr(c)

        for s in f.body:
            walk_stmt(s)

        slotted, accums = set(), set()
        for name, kinds in uses.items():
            if not kinds or kinds <= {"read", "slot_read"}:
                # untouched / read-only (including reads at [thread_id()]):
                # stays SHARED — per-thread [tid] reads are plain gathers
                # under vmap, so slotting (and the O(total_work) identity
                # scatter-back it implies) would be pure overhead
                continue
            if kinds <= {"slot_write", "slot_read"}:
                slotted.add(name)
            elif kinds == {"accum"}:
                accums.add(name)
            else:
                return None  # order-dependent (incl. slot+read mixes)
        # (the accumulator-size memory guard runs in run_simd, where the
        # runtime values are available — unsized Array accumulators carry
        # no static size here)
        return frozenset(slotted), frozenset(accums)

    def _run_simd_vmap(self, f: ir.FunctionDef, arg_vals: List[Any], total_work: int,
                       slotted: frozenset, accums: frozenset):
        """One vmapped dispatch: ``(finals, still)``, ``still`` each
        thread's final loop conditions (any of them true: the loops' budget
        was too small)."""
        env_shared = {a.id: v for a, v in zip(f.args, arg_vals)}
        tids = torch.arange(total_work, dtype=torch.int32, device=self.device)

        def per_thread(tid):
            self._still = []
            env = {}
            for a in f.args:
                v = env_shared[a.id]
                if a.id in slotted:
                    env[a.id] = _index(v, tid)
                elif a.id in accums:
                    env[a.id] = tree_map(torch.zeros_like, v)
                else:
                    env[a.id] = v
            env["__thread_id__"] = tid
            env = self.exec_stmts(f.body, env)
            still = (torch.stack(self._still).any() if self._still
                     else torch.zeros((), dtype=torch.bool, device=self.device))
            return ({k: env[k] for k in slotted}, {k: env[k] for k in accums}, still)

        prev = (self._slotted, self._vmapped, self._still)
        self._slotted, self._vmapped = slotted, True
        try:
            slots_out, contribs, still = torch.func.vmap(per_thread)(tids)
        finally:
            self._slotted, self._vmapped, self._still = prev
        out = {}
        for a in f.args:
            if not (a.is_out or isinstance(a.t, ir.Array)):
                continue
            v = env_shared[a.id]
            if a.id in slotted:
                out[a.id] = tree_map(lambda orig, sl: _scatter_slots(orig, sl),
                                     v, slots_out[a.id])
            elif a.id in accums:
                out[a.id] = tree_map(lambda orig, c: orig + c.sum(dim=0), v, contribs[a.id])
            else:
                out[a.id] = v
        return out, still

    def _run_simd_scan(self, f: ir.FunctionDef, arg_vals: List[Any],
                       total_work: int) -> Dict[str, Any]:
        """Fallback: the threads in turn, with the shared buffers in the env
        (deterministic sequential threads — the semantics of bodies with
        order-dependent shared effects)."""
        env = {a.id: v for a, v in zip(f.args, arg_vals)}
        keys = list(env)
        tids = torch.arange(total_work, dtype=torch.int32, device=self.device)
        for t in range(total_work):
            env = self.exec_stmts(f.body, {**{k: env[k] for k in keys},
                                           "__thread_id__": tids[t]})
        return {a.id: env[a.id] for a in f.args if a.is_out or isinstance(a.t, ir.Array)}


def _literals(node, out: set) -> set:
    """``(value, dtype)`` of every int and float literal under an IR node."""
    if isinstance(node, ir.ConstInt):
        out.add((node.val, torch.int32))
    elif isinstance(node, ir.ConstFloat):
        out.add((node.val, torch.float32))
    elif isinstance(node, (list, tuple)):
        for x in node:
            _literals(x, out)
    elif dataclasses.is_dataclass(node) and not isinstance(node, type):
        for f in dataclasses.fields(node):
            _literals(getattr(node, f.name), out)
    return out


def _scatter_slots(orig: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """``orig`` with rows ``0..total_work-1`` replaced by the threads'
    slots (rows past ``orig``'s end dropped)."""
    n = min(orig.shape[0], slots.shape[0])
    return torch.cat([slots[:n].to(orig.dtype), orig[n:]])
