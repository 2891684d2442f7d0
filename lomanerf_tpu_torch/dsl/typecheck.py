"""Static type inference for the DSL (cf. loma_public/type_inference.py:34-348).

Runs after the structural checks and before lowering.  Three jobs:

1. annotate ``t`` on every expression (the IR carries a ``t`` slot),
2. insert explicit ``int2float`` / ``float2int`` casts where the reference's
   casting rules auto-convert (binary ops promote int->float; declares,
   assigns, returns and call arguments convert toward the declared type),
3. raise the ``TypeMismatch`` error family — with line numbers — for
   programs the rules cannot type, so user mistakes fail at
   ``dsl.compile`` time instead of surfacing as JAX tracer errors.

The pass mutates the parsed IR in place (statement fields are rebound to
the annotated/cast expressions); the lowerer then executes the result.

Deviations from the reference, both deliberate:
* array argument compatibility ignores ``static_size`` when the callee
  declares an unbounded ``Array[T]`` (the reference compares types exactly,
  which would reject passing a sized local array to an unbounded arg),
* casts are only inserted around In-position values — an Out argument with
  a mismatched scalar type is an error rather than a cast of an lvalue.
"""

from __future__ import annotations

from typing import Dict, Optional

from lomanerf_tpu_torch.dsl import ir
from lomanerf_tpu_torch.dsl.error import (
    ArrayAccessTypeMismatch,
    AssignTypeMismatch,
    BinaryOpTypeMismatch,
    CallTypeMismatch,
    DeclareTypeMismatch,
    IfElseCondTypeMismatch,
    ReturnTypeMismatch,
    StructAccessTypeMismatch,
    StructMemberNotFound,
    UnknownFunction,
)

_INT = ir.Int()
_FLOAT = ir.Float()

# name -> (arg types or None for unchecked, result type);
# float args accept ints via an inserted cast
_INTRINSICS = {
    "sin": ((_FLOAT,), _FLOAT),
    "cos": ((_FLOAT,), _FLOAT),
    "sqrt": ((_FLOAT,), _FLOAT),
    "exp": ((_FLOAT,), _FLOAT),
    "log": ((_FLOAT,), _FLOAT),
    "pow": ((_FLOAT, _FLOAT), _FLOAT),
    "int2float": ((_INT,), _FLOAT),
    "float2int": ((_FLOAT,), _INT),
    "thread_id": ((), _INT),
    "make__dfloat": ((_FLOAT, _FLOAT), ir.Diff(_FLOAT)),
}


def _is_num(t: Optional[ir.Type]) -> bool:
    return isinstance(t, (ir.Int, ir.Float))


def _cast(e: ir.Expr, to: ir.Type) -> ir.Expr:
    """Insert an int<->float cast if the target type calls for one."""
    if isinstance(to, ir.Float) and isinstance(e.t, ir.Int):
        return ir.Call("int2float", [e], lineno=e.lineno, t=_FLOAT)
    if isinstance(to, ir.Int) and isinstance(e.t, ir.Float):
        return ir.Call("float2int", [e], lineno=e.lineno, t=_INT)
    return e


def _compatible(got: Optional[ir.Type], want: Optional[ir.Type]) -> bool:
    if isinstance(want, ir.Array) and isinstance(got, ir.Array):
        if want.static_size is not None and got.static_size is not None \
                and want.static_size != got.static_size:
            return False
        return _compatible(got.elem, want.elem)
    return got == want


class TypeInference:
    def __init__(self, structs: Dict[str, ir.Struct],
                 funcs: Dict[str, ir.Func]):
        self.structs = structs
        self.funcs = funcs

    # -- expressions ---------------------------------------------------------

    def infer_expr(self, e: ir.Expr, env: Dict[str, ir.Type]) -> ir.Expr:
        if isinstance(e, ir.Var):
            e.t = env[e.id]
            return e
        if isinstance(e, ir.ConstInt):
            e.t = _INT
            return e
        if isinstance(e, ir.ConstFloat):
            e.t = _FLOAT
            return e
        if isinstance(e, ir.ArrayAccess):
            e.array = self.infer_expr(e.array, env)
            e.index = self.infer_expr(e.index, env)
            if not isinstance(e.array.t, ir.Array):
                raise ArrayAccessTypeMismatch(e.lineno)
            e.t = e.array.t.elem
            return e
        if isinstance(e, ir.StructAccess):
            e.struct = self.infer_expr(e.struct, env)
            st = e.struct.t
            if isinstance(st, ir.Diff):
                # Diff[T] values are {val, dval} pairs (autodiff.py:164-166)
                fields = (("val", st.of), ("dval", st.of))
                name = str(st)
            elif isinstance(st, ir.Struct):
                fields, name = st.fields, st.name
            else:
                raise StructAccessTypeMismatch(e.lineno)
            for fname, ftype in fields:
                if fname == e.member:
                    e.t = ftype
                    return e
            raise StructMemberNotFound(e.member, name, e.lineno)
        if isinstance(e, ir.UnaryOp):
            e.operand = self.infer_expr(e.operand, env)
            if not _is_num(e.operand.t):
                raise BinaryOpTypeMismatch(e.op, e.lineno)
            e.t = e.operand.t
            return e
        if isinstance(e, ir.BinaryOp):
            e.left = self.infer_expr(e.left, env)
            e.right = self.infer_expr(e.right, env)
            lt, rt = e.left.t, e.right.t
            if not (_is_num(lt) and _is_num(rt)):
                raise BinaryOpTypeMismatch(e.op, e.lineno)
            # casting rule (type_inference.py:218-245): int,int -> int;
            # any float operand promotes the other side
            if isinstance(lt, ir.Int) and isinstance(rt, ir.Int):
                e.t = _INT
            else:
                e.left = _cast(e.left, _FLOAT)
                e.right = _cast(e.right, _FLOAT)
                e.t = _FLOAT
            return e
        if isinstance(e, ir.Call):
            return self._infer_call(e, env)
        raise AssignTypeMismatch(getattr(e, "lineno", None))

    def _infer_call(self, e: ir.Call, env: Dict[str, ir.Type]) -> ir.Call:
        e.args = [self.infer_expr(a, env) for a in e.args]
        if e.id in _INTRINSICS:
            want, res = _INTRINSICS[e.id]
            if len(e.args) != len(want):
                raise CallTypeMismatch(
                    e.id, e.lineno,
                    f"expected {len(want)} argument(s), got {len(e.args)}",
                )
            for i, w in enumerate(want):
                if isinstance(w, ir.Float):
                    e.args[i] = _cast(e.args[i], w)
                if e.args[i].t != w:
                    raise CallTypeMismatch(
                        e.id, e.lineno,
                        f"argument {i + 1} is {e.args[i].t}, expected {w}",
                    )
            e.t = res
            return e
        if e.id == "atomic_add":
            # reference checks arity only (type_inference.py:289-292)
            if len(e.args) != 2:
                raise CallTypeMismatch(e.id, e.lineno,
                                       "expected 2 arguments")
            e.t = None
            return e
        callee = self.funcs.get(e.id)
        if callee is None:
            raise UnknownFunction(e.id, e.lineno)
        if isinstance(callee, ir.ForwardDiff):
            # calling a fwd_diff function from DSL code (the reference's
            # pendulum pattern, examples/loma_code/pendulum_fwd.py): every
            # arg/result type is the structural diff type of the primal's
            primal = self.funcs.get(callee.primal_func)
            if not isinstance(primal, ir.FunctionDef):
                raise UnknownFunction(callee.primal_func, e.lineno)
            want = [ir.diff_type(a.t) for a in primal.args]
            if len(e.args) != len(want):
                raise CallTypeMismatch(
                    e.id, e.lineno,
                    f"expected {len(want)} argument(s), got {len(e.args)}",
                )
            for i, (a, w) in enumerate(zip(e.args, want)):
                if not _compatible(a.t, w):
                    raise CallTypeMismatch(
                        e.id, e.lineno,
                        f"argument {i + 1} is {a.t}, expected {w}",
                    )
            e.t = (ir.diff_type(primal.ret_type)
                   if primal.ret_type is not None else None)
            return e
        if not isinstance(callee, ir.FunctionDef):
            # rev_diff declarations: the lowerer rejects direct DSL calls
            e.t = None
            return e
        if len(e.args) != len(callee.args):
            raise CallTypeMismatch(
                e.id, e.lineno,
                f"expected {len(callee.args)} argument(s), got {len(e.args)}",
            )
        for i, (a, fa) in enumerate(zip(e.args, callee.args)):
            if not fa.is_out:
                e.args[i] = a = _cast(a, fa.t)
            if not _compatible(a.t, fa.t):
                raise CallTypeMismatch(
                    e.id, e.lineno,
                    f"argument {i + 1} is {a.t}, expected {fa.t}",
                )
        e.t = callee.ret_type
        return e

    # -- statements ----------------------------------------------------------

    def infer_stmts(self, stmts, env, ret_type) -> None:
        for s in stmts:
            self.infer_stmt(s, env, ret_type)

    def infer_stmt(self, s: ir.Stmt, env, ret_type) -> None:
        if isinstance(s, ir.Declare):
            env[s.target] = s.t
            if s.val is not None:
                v = _cast(self.infer_expr(s.val, env), s.t)
                if not _compatible(v.t, s.t):
                    raise DeclareTypeMismatch(s.lineno)
                s.val = v
        elif isinstance(s, ir.Assign):
            s.target = self.infer_expr(s.target, env)
            v = _cast(self.infer_expr(s.val, env), s.target.t)
            if not _compatible(v.t, s.target.t):
                raise AssignTypeMismatch(s.lineno)
            s.val = v
        elif isinstance(s, ir.Return):
            v = self.infer_expr(s.val, env)
            if ret_type is not None:
                v = _cast(v, ret_type)
            if not _compatible(v.t, ret_type):
                raise ReturnTypeMismatch(s.lineno)
            s.val = v
        elif isinstance(s, ir.IfElse):
            s.cond = self.infer_expr(s.cond, env)
            if not _is_num(s.cond.t):
                raise IfElseCondTypeMismatch(s.lineno)
            self.infer_stmts(s.then_stmts, env, ret_type)
            self.infer_stmts(s.else_stmts, env, ret_type)
        elif isinstance(s, ir.While):
            s.cond = self.infer_expr(s.cond, env)
            if not _is_num(s.cond.t):
                raise IfElseCondTypeMismatch(s.lineno)
            self.infer_stmts(s.body, env, ret_type)
        elif isinstance(s, ir.CallStmt):
            s.call = self._infer_call(s.call, env)

    def infer_function(self, f: ir.FunctionDef) -> None:
        env = {a.id: a.t for a in f.args}
        self.infer_stmts(f.body, env, f.ret_type)


def infer(structs: Dict[str, ir.Struct], funcs: Dict[str, ir.Func]) -> None:
    """Annotate and check every FunctionDef in place."""
    ti = TypeInference(structs, funcs)
    for f in funcs.values():
        if isinstance(f, ir.FunctionDef):
            ti.infer_function(f)
