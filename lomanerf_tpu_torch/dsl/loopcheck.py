"""Static trip-count analysis for bounded ``while`` loops (port of
``lomanerf_tpu.dsl.loopcheck``).

loma's ``max_iter`` budgets the reverse-mode TAPE as the *product over the
loop nest* (reference reverse_diff.py:444-461); its C backend runs a true
``while``, so a single loop may legally exceed its own ``max_iter`` — the
reference's NeRF kernel runs its feature loop 33 times under
``max_iter := 32`` (reference scripts/nerf.py:85 with in_ch 33).  The
port's lowering runs a true loop too, except in a ``@simd`` body lowered
with ``torch.func.vmap``, where every thread runs ``max_iter + loop_slack
+ extension`` masked iterations.  The compiler sizes that extension per
call from this analysis (and the lowering reruns a dispatch whose threads
still want to loop, with a warning), so nothing is truncated.

This module recognizes the canonical counting-loop pattern

    i = <const>
    while (i < BOUND, max_iter := N):   # or <=, or BOUND > i
        ...
        i = i + <const step>            # the only write to i

where BOUND is an integer literal, a local with a statically-known constant
value, or an ``In[int]`` argument that is never written.  For literal/local
bounds the trip count is known at *compile* time; for argument bounds it is
known at *call* time (entries receive concrete values).

Two cases the JAX package's copy counts too low are refused here: a call
statement that passes the counter (it may be an ``Out`` argument) is a
write that disqualifies the loop, and a variable written in an enclosing
loop's body is unknown inside that body (its value changes from one
iteration to the next).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Union

from lomanerf_tpu_torch.dsl import ir


@dataclasses.dataclass(frozen=True)
class LoopBound:
    """One analyzable bounded loop of an entry function.

    trips(v) = ceil((v + inclusive - init) / step) for bound value ``v``.
    """

    lineno: Optional[int]
    max_iter: int
    bound: Union[int, str]  # literal/propagated constant, or In[int] arg name
    init: int
    step: int
    inclusive: int  # 1 for <=, 0 for <

    def trips(self, bound_value: int) -> int:
        n = bound_value + self.inclusive - self.init
        return max(0, -(-n // self.step))

    def extra_needed(self, bound_value: int, slack: int) -> int:
        return max(0, self.trips(bound_value) - self.max_iter - slack)


def _written_vars(stmts: List[ir.Stmt], acc: Set[str]) -> Set[str]:
    """Names of scalar Vars assigned anywhere in ``stmts`` (array/struct
    element writes don't invalidate the scalar loop counters we track)."""
    for s in stmts:
        if isinstance(s, ir.Assign) and isinstance(s.target, ir.Var):
            acc.add(s.target.id)
        elif isinstance(s, ir.Declare):
            acc.add(s.target)
        elif isinstance(s, ir.IfElse):
            _written_vars(s.then_stmts, acc)
            _written_vars(s.else_stmts, acc)
        elif isinstance(s, ir.While):
            _written_vars(s.body, acc)
        elif isinstance(s, ir.CallStmt):
            # a user call could mutate any Var passed to an Out arg;
            # conservatively treat every Var argument as written
            for a in s.call.args:
                if isinstance(a, ir.Var):
                    acc.add(a.id)
    return acc


def _const_of(e: ir.Expr, env: Dict[str, Optional[int]]):
    if isinstance(e, ir.ConstInt):
        return e.val
    if isinstance(e, ir.Var):
        return env.get(e.id)
    return None


def _parse_cond(cond: ir.Expr):
    """Return (loop_var, bound_expr, inclusive) for ``v < B``/``v <= B``/
    ``B > v``/``B >= v``; None otherwise."""
    if not isinstance(cond, ir.BinaryOp):
        return None
    if cond.op in ("<", "<=") and isinstance(cond.left, ir.Var):
        return cond.left.id, cond.right, int(cond.op == "<=")
    if cond.op in (">", ">=") and isinstance(cond.right, ir.Var):
        return cond.right.id, cond.left, int(cond.op == ">=")
    return None


def _step_of(var: str, body: List[ir.Stmt]) -> Optional[int]:
    """Constant positive increment if ``var = var + c`` is the ONLY write to
    ``var`` in the loop body AND sits at the body's top level — an
    increment nested under an if/else or inner loop is CONDITIONAL, so the
    trip count would be underestimated and the auto-extension would
    falsely promise coverage."""
    writes = _written_vars(list(body), set())
    if var not in writes:
        return None
    incr: Optional[int] = None
    count = 0
    for s in body:
        if isinstance(s, ir.Assign) and isinstance(s.target, ir.Var) \
                and s.target.id == var:
            count += 1
            v = s.val
            if isinstance(v, ir.BinaryOp) and v.op == "+":
                l, r = v.left, v.right
                if isinstance(l, ir.Var) and l.id == var \
                        and isinstance(r, ir.ConstInt):
                    incr = r.val
                elif isinstance(r, ir.Var) and r.id == var \
                        and isinstance(l, ir.ConstInt):
                    incr = l.val
        elif isinstance(s, ir.CallStmt) and var in _written_vars([s], set()):
            return None  # the counter passed to a call: it may be an Out argument
        elif isinstance(s, (ir.IfElse, ir.While)):
            nested = _written_vars(
                s.body if isinstance(s, ir.While)
                else s.then_stmts + s.else_stmts, set())
            if var in nested:
                return None  # conditional/nested write: not analyzable
    if count != 1 or incr is None or incr < 1:
        return None
    return incr


def analyze(f: ir.FunctionDef) -> List[LoopBound]:
    """All statically-recognizable bounded loops of ``f`` (nested included)."""
    ever_written = _written_vars(f.body, set())
    int_args = {
        a.id for a in f.args
        if isinstance(a.t, ir.Int) and not a.is_out
        and a.id not in ever_written
    }
    out: List[LoopBound] = []

    def walk(stmts: List[ir.Stmt], env: Dict[str, Optional[int]]):
        for s in stmts:
            if isinstance(s, ir.Declare):
                env[s.target] = _const_of(s.val, env) if s.val is not None \
                    else 0  # loma zero-initializes declares
            elif isinstance(s, ir.Assign):
                if isinstance(s.target, ir.Var):
                    env[s.target.id] = _const_of(s.val, env)
            elif isinstance(s, ir.IfElse):
                walk(s.then_stmts, dict(env))
                walk(s.else_stmts, dict(env))
                for v in _written_vars(s.then_stmts + s.else_stmts, set()):
                    env[v] = None
            elif isinstance(s, ir.CallStmt):
                for a in s.call.args:
                    if isinstance(a, ir.Var):
                        env[a.id] = None
            elif isinstance(s, ir.While):
                parsed = _parse_cond(s.cond)
                if parsed is not None:
                    var, bound_e, inclusive = parsed
                    init = env.get(var)
                    step = _step_of(var, s.body)
                    bound: Union[int, str, None] = _const_of(bound_e, env)
                    if bound is None and isinstance(bound_e, ir.Var) \
                            and bound_e.id in int_args:
                        # bound is an unmodified In[int] arg: resolvable at
                        # call time from the concrete argument value
                        bound = bound_e.id
                    body_writes = _written_vars(s.body, set())
                    bound_stable = not (
                        isinstance(bound_e, ir.Var)
                        and bound_e.id in body_writes
                    )
                    if init is not None and step is not None \
                            and bound is not None and bound_stable:
                        out.append(LoopBound(
                            lineno=s.lineno, max_iter=s.max_iter,
                            bound=bound, init=init, step=step,
                            inclusive=inclusive,
                        ))
                # loop-carried: a variable the body writes is unknown in the
                # body (its value at an inner loop's entry changes with the
                # iteration), and after the loop
                carried = _written_vars(s.body, set())
                walk(s.body, {k: (None if k in carried else v) for k, v in env.items()})
                for v in carried:
                    env[v] = None

    walk(f.body, {})
    return out
