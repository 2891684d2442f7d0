"""Static checks (cf. loma_public/check.py:8-335).

Same seven checks as the reference, over our dataclass IR: duplicate
declarations, undeclared variables, return-as-last-statement, bounded local
array declarations, declarations only at the outermost scope, and calls
with Out arguments only as standalone statements.
"""

from __future__ import annotations

from typing import Dict, List, Set

from lomanerf_tpu_torch.dsl import ir
from lomanerf_tpu_torch.dsl.error import (
    CallWithOutArgNotInCallStmt,
    DeclarationNotOutmostLevel,
    DeclareUnboundedArray,
    DuplicateVariable,
    ReturnNotLastStmt,
    UndeclaredVariable,
    UnknownFunction,
)


def _walk_stmts(stmts, inner=False):
    for s in stmts:
        yield s, inner
        if isinstance(s, ir.IfElse):
            yield from _walk_stmts(s.then_stmts, True)
            yield from _walk_stmts(s.else_stmts, True)
        elif isinstance(s, ir.While):
            yield from _walk_stmts(s.body, True)


def _expr_vars(e: ir.Expr):
    if isinstance(e, ir.Var):
        yield e
    elif isinstance(e, ir.ArrayAccess):
        yield from _expr_vars(e.array)
        yield from _expr_vars(e.index)
    elif isinstance(e, ir.StructAccess):
        yield from _expr_vars(e.struct)
    elif isinstance(e, ir.BinaryOp):
        yield from _expr_vars(e.left)
        yield from _expr_vars(e.right)
    elif isinstance(e, ir.UnaryOp):
        yield from _expr_vars(e.operand)
    elif isinstance(e, ir.Call):
        for a in e.args:
            yield from _expr_vars(a)


def _stmt_exprs(s: ir.Stmt):
    if isinstance(s, ir.Assign):
        yield s.target
        yield s.val
    elif isinstance(s, ir.Declare) and s.val is not None:
        yield s.val
    elif isinstance(s, ir.Return):
        yield s.val
    elif isinstance(s, ir.IfElse):
        yield s.cond
    elif isinstance(s, ir.While):
        yield s.cond
    elif isinstance(s, ir.CallStmt):
        yield s.call


def _all_calls(stmts):
    for s, _ in _walk_stmts(stmts):
        for e in _stmt_exprs(s):
            stack = [e]
            while stack:
                x = stack.pop()
                if isinstance(x, ir.Call):
                    yield x, isinstance(s, ir.CallStmt) and s.call is x
                    stack.extend(x.args)
                elif isinstance(x, ir.BinaryOp):
                    stack.extend([x.left, x.right])
                elif isinstance(x, ir.UnaryOp):
                    stack.append(x.operand)
                elif isinstance(x, ir.ArrayAccess):
                    stack.extend([x.array, x.index])
                elif isinstance(x, ir.StructAccess):
                    stack.append(x.struct)


def check_func(f: ir.FunctionDef, funcs: Dict[str, ir.Func]) -> None:
    declared: Dict[str, int] = {a.id: f.lineno for a in f.args}

    # duplicate declares + outermost-level declares + bounded arrays
    for s, inner in _walk_stmts(f.body):
        if isinstance(s, ir.Declare):
            if inner:
                raise DeclarationNotOutmostLevel(s.lineno)
            if s.target in declared:
                raise DuplicateVariable(s.target, declared[s.target], s.lineno)
            declared[s.target] = s.lineno
            t = s.t
            while isinstance(t, ir.Array):
                if t.static_size is None:
                    raise DeclareUnboundedArray(s.lineno)
                t = t.elem

    # undeclared variables
    for s, _ in _walk_stmts(f.body):
        for e in _stmt_exprs(s):
            for v in _expr_vars(e):
                if v.id not in declared:
                    raise UndeclaredVariable(v.id, v.lineno)

    # return must be last (reference check.py:144-167)
    for s, _ in _walk_stmts(f.body):
        if isinstance(s, ir.Return) and s is not f.body[-1]:
            raise ReturnNotLastStmt(s.lineno)

    # calls with Out args only as CallStmt; known callees
    for call, is_stmt in _all_calls(f.body):
        if call.id in ir.BUILTINS:
            continue
        callee = funcs.get(call.id)
        if callee is None:
            raise UnknownFunction(call.id, call.lineno)
        if isinstance(callee, ir.FunctionDef):
            if any(a.is_out for a in callee.args) and not is_stmt:
                raise CallWithOutArgNotInCallStmt(call.lineno)


def check(structs, funcs: Dict[str, ir.Func]) -> None:
    for f in funcs.values():
        if isinstance(f, ir.FunctionDef):
            check_func(f, funcs)
        else:
            if f.primal_func not in funcs:
                raise UnknownFunction(f.primal_func, f.lineno)
