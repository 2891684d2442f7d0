"""DSL user-error hierarchy (cf. loma_public/error.py:8-186).

Same error taxonomy and line-number reporting as the reference so that
reference test expectations translate; plain exception classes instead of
attrs-frozen dataclasses.
"""

from __future__ import annotations


class UserError(Exception):
    def __init__(self, msg: str, lineno=None):
        self.lineno = lineno
        super().__init__(f"line {lineno}: {msg}" if lineno else msg)

    def to_string(self) -> str:
        return str(self)


class DuplicateVariable(UserError):
    def __init__(self, var: str, first_lineno=None, duplicate_lineno=None):
        self.var = var
        self.first_declare_stmt = first_lineno
        self.duplicate_declare_stmt = duplicate_lineno
        super().__init__(f"duplicate declaration of '{var}'", duplicate_lineno)


class UndeclaredVariable(UserError):
    def __init__(self, var: str, lineno=None):
        self.var = var
        super().__init__(f"use of undeclared variable '{var}'", lineno)


class ReturnNotLastStmt(UserError):
    def __init__(self, lineno=None):
        super().__init__("return must be the last statement", lineno)


class DeclareUnboundedArray(UserError):
    def __init__(self, lineno=None):
        super().__init__("locally declared arrays must have a static size",
                         lineno)


class DeclarationNotOutmostLevel(UserError):
    def __init__(self, lineno=None):
        super().__init__("declarations must be at the outermost scope", lineno)


class CallWithOutArgNotInCallStmt(UserError):
    def __init__(self, lineno=None):
        super().__init__(
            "calls with Out arguments must appear as standalone statements",
            lineno,
        )


class TypeMismatch(UserError):
    """Base of the static type-error family raised by dsl.typecheck
    (taxonomy mirrors loma_public/error.py:87-186)."""


class ArrayAccessTypeMismatch(TypeMismatch):
    def __init__(self, lineno=None):
        super().__init__("subscript of a non-array expression", lineno)


class StructAccessTypeMismatch(TypeMismatch):
    def __init__(self, lineno=None):
        super().__init__("member access on a non-struct expression", lineno)


class StructMemberNotFound(TypeMismatch):
    def __init__(self, member: str, struct: str, lineno=None):
        self.member = member
        super().__init__(f"struct '{struct}' has no member '{member}'", lineno)


class BinaryOpTypeMismatch(TypeMismatch):
    def __init__(self, op: str = "", lineno=None):
        super().__init__(f"operands of '{op}' must be int or float", lineno)


class CallTypeMismatch(TypeMismatch):
    def __init__(self, name: str = "", lineno=None, detail: str = ""):
        msg = f"argument mismatch calling '{name}'"
        if detail:
            msg += f": {detail}"
        super().__init__(msg, lineno)


class ReturnTypeMismatch(TypeMismatch):
    def __init__(self, lineno=None):
        super().__init__("returned value does not match the declared return "
                         "type", lineno)


class AssignTypeMismatch(TypeMismatch):
    def __init__(self, lineno=None):
        super().__init__("assigned value does not match the target's type",
                         lineno)


class DeclareTypeMismatch(TypeMismatch):
    def __init__(self, lineno=None):
        super().__init__("initializer does not match the declared type",
                         lineno)


class IfElseCondTypeMismatch(TypeMismatch):
    def __init__(self, lineno=None):
        super().__init__("if/while condition must be int or float", lineno)


class UnknownFunction(UserError):
    def __init__(self, name: str, lineno=None):
        super().__init__(f"call to unknown function '{name}'", lineno)


class ParseError(UserError):
    pass


class LoopBoundWarning(UserWarning):
    """A bounded while loop needs more iterations than its ``max_iter``
    (+ ``loop_slack``) budget; the compiler auto-extended the scan.

    Legal in loma, where max_iter only sizes the reverse tape as the
    product over the loop nest (reference reverse_diff.py:444-461)."""
