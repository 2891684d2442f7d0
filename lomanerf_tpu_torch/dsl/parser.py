"""Parser: loma DSL source (a Python subset) -> dsl.ir.

Accepts the same surface syntax as the reference parser
(loma_public/parser.py:109-379):

* annotated function defs with ``In[T]`` / ``Out[T]`` argument qualifiers,
  ``Array[T]`` / ``Array[T, n]`` / ``Diff[T]`` type expressions,
* ``@simd`` decorator,
* ``while (cond, max_iter := N):`` bounded loops,
* ``d_f = fwd_diff(f)`` / ``rev_diff(f)`` top-level differentiation
  declarations,
* class defs with annotated fields as structs.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple

from lomanerf_tpu_torch.dsl import ir
from lomanerf_tpu_torch.dsl.error import ParseError

_BINOPS = {
    ast.Add: "+", ast.Sub: "-", ast.Mult: "*", ast.Div: "/", ast.Mod: "%",
}
_CMPOPS = {
    ast.Lt: "<", ast.LtE: "<=", ast.Gt: ">", ast.GtE: ">=",
    ast.Eq: "==", ast.NotEq: "!=",
}


def _parse_type(node: ast.expr, structs: Dict[str, ir.Struct]) -> ir.Type:
    if isinstance(node, ast.Name):
        if node.id == "int":
            return ir.Int()
        if node.id == "float":
            return ir.Float()
        if node.id in structs:
            return structs[node.id]
        raise ParseError(f"unknown type '{node.id}'", node.lineno)
    if isinstance(node, ast.Subscript):
        base = node.value
        if not isinstance(base, ast.Name):
            raise ParseError("bad type expression", node.lineno)
        sl = node.slice
        if base.id == "Array":
            if isinstance(sl, ast.Tuple):
                elem = _parse_type(sl.elts[0], structs)
                size_node = sl.elts[1]
                if not isinstance(size_node, ast.Constant):
                    raise ParseError("array size must be a constant",
                                     node.lineno)
                return ir.Array(elem, int(size_node.value))
            return ir.Array(_parse_type(sl, structs), None)
        if base.id == "Diff":
            # Diff[T] resolves structurally at parse time: Diff[Struct] is
            # the struct-of-duals _dStruct (ir.diff_type)
            return ir.diff_type(_parse_type(sl, structs))
        if base.id in ("In", "Out"):
            # qualifier handled by caller
            return _parse_type(sl, structs)
        raise ParseError(f"unknown type constructor '{base.id}'", node.lineno)
    raise ParseError("bad type expression", getattr(node, "lineno", None))


def _parse_arg(node: ast.arg, structs) -> ir.Arg:
    ann = node.annotation
    if not (isinstance(ann, ast.Subscript) and isinstance(ann.value, ast.Name)
            and ann.value.id in ("In", "Out")):
        raise ParseError(
            f"argument '{node.arg}' must be annotated In[...] or Out[...]",
            node.lineno,
        )
    return ir.Arg(
        id=node.arg,
        t=_parse_type(ann.slice, structs),
        is_out=(ann.value.id == "Out"),
    )


def _parse_expr(node: ast.expr) -> ir.Expr:
    ln = getattr(node, "lineno", None)
    if isinstance(node, ast.Name):
        return ir.Var(node.id, lineno=ln)
    if isinstance(node, ast.Constant):
        if isinstance(node.value, bool):
            return ir.ConstInt(int(node.value), lineno=ln)
        if isinstance(node.value, int):
            return ir.ConstInt(node.value, lineno=ln)
        if isinstance(node.value, float):
            return ir.ConstFloat(node.value, lineno=ln)
        raise ParseError(f"unsupported constant {node.value!r}", ln)
    if isinstance(node, ast.Subscript):
        return ir.ArrayAccess(_parse_expr(node.value), _parse_expr(node.slice),
                              lineno=ln)
    if isinstance(node, ast.Attribute):
        return ir.StructAccess(_parse_expr(node.value), node.attr, lineno=ln)
    if isinstance(node, ast.BinOp):
        op = _BINOPS.get(type(node.op))
        if op is None:
            raise ParseError("unsupported binary operator", ln)
        return ir.BinaryOp(op, _parse_expr(node.left), _parse_expr(node.right),
                           lineno=ln)
    if isinstance(node, ast.UnaryOp):
        if isinstance(node.op, ast.USub):
            return ir.UnaryOp("-", _parse_expr(node.operand), lineno=ln)
        raise ParseError("unsupported unary operator", ln)
    if isinstance(node, ast.Compare):
        if len(node.ops) != 1:
            raise ParseError("chained comparisons unsupported", ln)
        op = _CMPOPS.get(type(node.ops[0]))
        if op is None:
            raise ParseError("unsupported comparison", ln)
        return ir.BinaryOp(op, _parse_expr(node.left),
                           _parse_expr(node.comparators[0]), lineno=ln)
    if isinstance(node, ast.BoolOp):
        op = "and" if isinstance(node.op, ast.And) else "or"
        out = _parse_expr(node.values[0])
        for v in node.values[1:]:
            out = ir.BinaryOp(op, out, _parse_expr(v), lineno=ln)
        return out
    if isinstance(node, ast.Call):
        if not isinstance(node.func, ast.Name):
            raise ParseError("only direct calls supported", ln)
        return ir.Call(node.func.id, [_parse_expr(a) for a in node.args],
                       lineno=ln)
    raise ParseError(f"unsupported expression {ast.dump(node)[:40]}", ln)


def _parse_while_header(node: ast.While) -> Tuple[ir.Expr, int]:
    """``while (cond, max_iter := N):`` — reference syntax
    (parser.py:218-233)."""
    test = node.test
    if isinstance(test, ast.Tuple) and len(test.elts) == 2 and isinstance(
        test.elts[1], ast.NamedExpr
    ):
        cond = _parse_expr(test.elts[0])
        mi = test.elts[1]
        if not (isinstance(mi.target, ast.Name) and mi.target.id == "max_iter"
                and isinstance(mi.value, ast.Constant)):
            raise ParseError("while needs 'max_iter := <int const>'",
                             node.lineno)
        return cond, int(mi.value.value)
    raise ParseError(
        "while must be 'while (cond, max_iter := N):'", node.lineno
    )


def _parse_stmts(nodes: List[ast.stmt], structs) -> List[ir.Stmt]:
    out: List[ir.Stmt] = []
    for node in nodes:
        ln = node.lineno
        if isinstance(node, ast.AnnAssign):
            if not isinstance(node.target, ast.Name):
                raise ParseError("bad declaration target", ln)
            t = _parse_type(node.annotation, structs)
            val = _parse_expr(node.value) if node.value is not None else None
            out.append(ir.Declare(node.target.id, t, val, lineno=ln))
        elif isinstance(node, ast.Assign):
            if len(node.targets) != 1:
                raise ParseError("multiple assignment unsupported", ln)
            out.append(ir.Assign(_parse_expr(node.targets[0]),
                                 _parse_expr(node.value), lineno=ln))
        elif isinstance(node, ast.Return):
            out.append(ir.Return(_parse_expr(node.value), lineno=ln))
        elif isinstance(node, ast.If):
            out.append(ir.IfElse(
                _parse_expr(node.test),
                _parse_stmts(node.body, structs),
                _parse_stmts(node.orelse, structs),
                lineno=ln,
            ))
        elif isinstance(node, ast.While):
            cond, max_iter = _parse_while_header(node)
            out.append(ir.While(cond, max_iter,
                                _parse_stmts(node.body, structs), lineno=ln))
        elif isinstance(node, ast.Expr):
            e = _parse_expr(node.value)
            if isinstance(e, ir.Call):
                out.append(ir.CallStmt(e, lineno=ln))
            elif isinstance(node.value, ast.Constant) and isinstance(
                node.value.value, str
            ):
                pass  # docstring
            else:
                raise ParseError("expression statements must be calls", ln)
        elif isinstance(node, ast.Pass):
            pass
        else:
            raise ParseError(f"unsupported statement {type(node).__name__}",
                             ln)
    return out


def _parse_struct(node: ast.ClassDef,
                  structs: Dict[str, ir.Struct]) -> ir.Struct:
    fields = []
    for item in node.body:
        if isinstance(item, ast.AnnAssign) and isinstance(item.target,
                                                          ast.Name):
            fields.append((item.target.id, _parse_type(item.annotation,
                                                       structs)))
        elif isinstance(item, ast.Pass):
            pass
        elif isinstance(item, ast.Expr):
            pass  # docstring
        else:
            raise ParseError("structs may only contain annotated fields",
                             item.lineno)
    return ir.Struct(node.name, tuple(fields))


def parse(code: str) -> Tuple[Dict[str, ir.Struct], Dict[str, ir.Func]]:
    """Parse DSL source into (structs, funcs)."""
    module = ast.parse(code)
    structs: Dict[str, ir.Struct] = {}
    funcs: Dict[str, ir.Func] = {}

    # structs may reference each other: iterate to fixpoint like the
    # reference's fill_structs loop (parser.py:357-368)
    class_nodes = [n for n in module.body if isinstance(n, ast.ClassDef)]
    for _ in range(len(class_nodes) + 1):
        progress = False
        for node in class_nodes:
            if node.name in structs:
                continue
            try:
                structs[node.name] = _parse_struct(node, structs)
                progress = True
            except ParseError:
                continue
        if not progress:
            break
    for node in class_nodes:
        if node.name not in structs:
            structs[node.name] = _parse_struct(node, structs)  # raise

    for node in module.body:
        if isinstance(node, ast.FunctionDef):
            is_simd = any(
                isinstance(d, ast.Name) and d.id == "simd"
                for d in node.decorator_list
            )
            args = [_parse_arg(a, structs) for a in node.args.args]
            ret_type = None
            if node.returns is not None and not (
                isinstance(node.returns, ast.Constant)
                and node.returns.value is None
            ):
                ret_type = _parse_type(node.returns, structs)
            funcs[node.name] = ir.FunctionDef(
                id=node.name,
                args=args,
                body=_parse_stmts(node.body, structs),
                is_simd=is_simd,
                ret_type=ret_type,
                lineno=node.lineno,
            )
        elif isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name) and \
                isinstance(node.value, ast.Call) and \
                isinstance(node.value.func, ast.Name) and \
                node.value.func.id in ("fwd_diff", "rev_diff"):
            primal = node.value.args[0]
            if not isinstance(primal, ast.Name):
                raise ParseError("fwd_diff/rev_diff take a function name",
                                 node.lineno)
            name = node.targets[0].id
            cls = (ir.ForwardDiff if node.value.func.id == "fwd_diff"
                   else ir.ReverseDiff)
            funcs[name] = cls(id=name, primal_func=primal.id,
                              lineno=node.lineno)
    return structs, funcs
