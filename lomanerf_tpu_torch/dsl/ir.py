"""IR for the loma-compatible DSL front-end.

Covers the same language surface as the reference's ASDL grammar
(loma_public/ir.py:12-63): functions with In/Out-qualified args and an
``is_simd`` flag; Assign / Declare / Return / IfElse / bounded While /
CallStmt statements; Var / ArrayAccess / StructAccess / const / BinaryOp /
Call expressions; Int / Float / Array / Struct / Diff types; ForwardDiff /
ReverseDiff declarations.

Implementation is plain dataclasses (the reference metaprograms attrs
classes from an ASDL string via a vendored generator — an artifact of its
C-codegen pipeline, not of the language).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional, Tuple, Union


# ---------------------------------------------------------------------------
# types
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Int:
    def __str__(self):
        return "int"


@dataclass(frozen=True)
class Float:
    def __str__(self):
        return "float"


@dataclass(frozen=True)
class Array:
    elem: "Type"
    static_size: Optional[int] = None

    def __str__(self):
        n = f", {self.static_size}" if self.static_size is not None else ""
        return f"Array[{self.elem}{n}]"


@dataclass(frozen=True)
class Struct:
    name: str
    fields: Tuple[Tuple[str, "Type"], ...] = ()

    def __str__(self):
        return self.name


@dataclass(frozen=True)
class Diff:
    of: "Type"

    def __str__(self):
        return f"Diff[{self.of}]"


Type = Union[Int, Float, Array, Struct, Diff]


def diff_type(t: "Type") -> "Type":
    """Resolve ``Diff[T]`` structurally (autodiff.py:42-112's
    type_to_diff_type): floats become the primitive dual ``Diff[float]``
    ({val, dval}); ints are their own diff type; arrays/structs map
    elementwise — ``Diff[Struct]`` is the struct-of-duals ``_dStruct``, so
    DSL code can write ``d_c.mass.val`` like loma."""
    if isinstance(t, Float):
        return Diff(t)
    if isinstance(t, Int):
        return t
    if isinstance(t, Array):
        return Array(diff_type(t.elem), t.static_size)
    if isinstance(t, Struct):
        return Struct("_d" + t.name,
                      tuple((f, diff_type(ft)) for f, ft in t.fields))
    if isinstance(t, Diff):
        return t
    raise TypeError(f"no diff type for {t}")


# ---------------------------------------------------------------------------
# expressions / statements / functions
# ---------------------------------------------------------------------------


@dataclass
class Expr:
    lineno: Optional[int] = field(default=None, kw_only=True)
    t: Optional[Type] = field(default=None, kw_only=True)  # set by inference


@dataclass
class Var(Expr):
    id: str = ""


@dataclass
class ConstInt(Expr):
    val: int = 0


@dataclass
class ConstFloat(Expr):
    val: float = 0.0


@dataclass
class ArrayAccess(Expr):
    array: Expr = None
    index: Expr = None


@dataclass
class StructAccess(Expr):
    struct: Expr = None
    member: str = ""


@dataclass
class BinaryOp(Expr):
    op: str = ""  # + - * / % < <= > >= == != and or
    left: Expr = None
    right: Expr = None


@dataclass
class UnaryOp(Expr):
    op: str = ""  # -
    operand: Expr = None


@dataclass
class Call(Expr):
    id: str = ""
    args: List[Expr] = field(default_factory=list)


@dataclass
class Stmt:
    lineno: Optional[int] = field(default=None, kw_only=True)


@dataclass
class Assign(Stmt):
    target: Expr = None
    val: Expr = None


@dataclass
class Declare(Stmt):
    target: str = ""
    t: Type = None
    val: Optional[Expr] = None


@dataclass
class Return(Stmt):
    val: Expr = None


@dataclass
class IfElse(Stmt):
    cond: Expr = None
    then_stmts: List[Stmt] = field(default_factory=list)
    else_stmts: List[Stmt] = field(default_factory=list)


@dataclass
class While(Stmt):
    cond: Expr = None
    max_iter: int = 0
    body: List[Stmt] = field(default_factory=list)


@dataclass
class CallStmt(Stmt):
    call: Call = None


@dataclass
class Arg:
    id: str
    t: Type
    is_out: bool  # Out[...] vs In[...]


@dataclass
class FunctionDef:
    id: str
    args: List[Arg]
    body: List[Stmt]
    is_simd: bool = False
    ret_type: Optional[Type] = None
    lineno: Optional[int] = None


@dataclass
class ForwardDiff:
    id: str
    primal_func: str
    lineno: Optional[int] = None


@dataclass
class ReverseDiff:
    id: str
    primal_func: str
    lineno: Optional[int] = None


Func = Union[FunctionDef, ForwardDiff, ReverseDiff]

BUILTINS = (
    "sin", "cos", "sqrt", "pow", "exp", "log",
    "int2float", "float2int", "thread_id", "atomic_add",
)
