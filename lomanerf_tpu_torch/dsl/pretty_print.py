"""IR -> loma-like pseudocode (cf. loma_public/pretty_print.py)."""

from __future__ import annotations

from lomanerf_tpu_torch.dsl import ir


def expr_to_str(e: ir.Expr) -> str:
    if isinstance(e, ir.Var):
        return e.id
    if isinstance(e, (ir.ConstInt, ir.ConstFloat)):
        return str(e.val)
    if isinstance(e, ir.ArrayAccess):
        return f"{expr_to_str(e.array)}[{expr_to_str(e.index)}]"
    if isinstance(e, ir.StructAccess):
        return f"{expr_to_str(e.struct)}.{e.member}"
    if isinstance(e, ir.BinaryOp):
        return f"({expr_to_str(e.left)} {e.op} {expr_to_str(e.right)})"
    if isinstance(e, ir.UnaryOp):
        return f"(-{expr_to_str(e.operand)})"
    if isinstance(e, ir.Call):
        return f"{e.id}({', '.join(expr_to_str(a) for a in e.args)})"
    return repr(e)


def stmt_to_str(s: ir.Stmt, indent: int = 0) -> str:
    pad = "    " * indent
    if isinstance(s, ir.Declare):
        init = f" = {expr_to_str(s.val)}" if s.val is not None else ""
        return f"{pad}{s.target} : {s.t}{init}"
    if isinstance(s, ir.Assign):
        return f"{pad}{expr_to_str(s.target)} = {expr_to_str(s.val)}"
    if isinstance(s, ir.Return):
        return f"{pad}return {expr_to_str(s.val)}"
    if isinstance(s, ir.IfElse):
        lines = [f"{pad}if {expr_to_str(s.cond)}:"]
        lines += [stmt_to_str(t, indent + 1) for t in s.then_stmts]
        if s.else_stmts:
            lines.append(f"{pad}else:")
            lines += [stmt_to_str(t, indent + 1) for t in s.else_stmts]
        return "\n".join(lines)
    if isinstance(s, ir.While):
        lines = [f"{pad}while ({expr_to_str(s.cond)}, max_iter := "
                 f"{s.max_iter}):"]
        lines += [stmt_to_str(t, indent + 1) for t in s.body]
        return "\n".join(lines)
    if isinstance(s, ir.CallStmt):
        return f"{pad}{expr_to_str(s.call)}"
    return f"{pad}{s!r}"


def func_to_str(f: ir.Func) -> str:
    if isinstance(f, ir.ForwardDiff):
        return f"{f.id} = fwd_diff({f.primal_func})"
    if isinstance(f, ir.ReverseDiff):
        return f"{f.id} = rev_diff({f.primal_func})"
    args = ", ".join(
        f"{a.id} : {'Out' if a.is_out else 'In'}[{a.t}]" for a in f.args
    )
    head = "@simd\n" if f.is_simd else ""
    ret = f" -> {f.ret_type}" if f.ret_type is not None else ""
    body = "\n".join(stmt_to_str(s, 1) for s in f.body)
    return f"{head}def {f.id}({args}){ret}:\n{body}"
