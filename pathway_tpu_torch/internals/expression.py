"""ColumnExpression AST for the declarative Table API.

Re-design of the reference's expression tree
(``python/pathway/internals/expression.py:88-1140``). Nodes are pure data;
typing and compilation to columnar kernels live in
``internals/expression_compiler.py`` (the analog of the reference's
``type_interpreter.py`` + the Rust typed interpreter ``src/engine/expression.rs``,
except expressions here compile to whole-batch numpy/JAX functions instead of
row-at-a-time evaluation).
"""

from __future__ import annotations

import operator
from typing import TYPE_CHECKING, Any, Callable, Iterable

from . import dtype as dt

if TYPE_CHECKING:
    from .table import Table


class ColumnExpression:
    _dtype: dt.DType | None = None

    # -- arithmetic --
    def __add__(self, other):
        return ColumnBinaryOpExpression(self, other, "+")

    def __radd__(self, other):
        return ColumnBinaryOpExpression(other, self, "+")

    def __sub__(self, other):
        return ColumnBinaryOpExpression(self, other, "-")

    def __rsub__(self, other):
        return ColumnBinaryOpExpression(other, self, "-")

    def __mul__(self, other):
        return ColumnBinaryOpExpression(self, other, "*")

    def __rmul__(self, other):
        return ColumnBinaryOpExpression(other, self, "*")

    def __truediv__(self, other):
        return ColumnBinaryOpExpression(self, other, "/")

    def __rtruediv__(self, other):
        return ColumnBinaryOpExpression(other, self, "/")

    def __floordiv__(self, other):
        return ColumnBinaryOpExpression(self, other, "//")

    def __rfloordiv__(self, other):
        return ColumnBinaryOpExpression(other, self, "//")

    def __mod__(self, other):
        return ColumnBinaryOpExpression(self, other, "%")

    def __rmod__(self, other):
        return ColumnBinaryOpExpression(other, self, "%")

    def __pow__(self, other):
        return ColumnBinaryOpExpression(self, other, "**")

    def __rpow__(self, other):
        return ColumnBinaryOpExpression(other, self, "**")

    def __matmul__(self, other):
        return ColumnBinaryOpExpression(self, other, "@")

    def __rmatmul__(self, other):
        return ColumnBinaryOpExpression(other, self, "@")

    def __lshift__(self, other):
        return ColumnBinaryOpExpression(self, other, "<<")

    def __rlshift__(self, other):
        return ColumnBinaryOpExpression(other, self, "<<")

    def __rshift__(self, other):
        return ColumnBinaryOpExpression(self, other, ">>")

    def __rrshift__(self, other):
        return ColumnBinaryOpExpression(other, self, ">>")

    def __neg__(self):
        return ColumnUnaryOpExpression(self, "-")

    # -- comparisons --
    def __eq__(self, other):  # type: ignore[override]
        return ColumnBinaryOpExpression(self, other, "==")

    def __ne__(self, other):  # type: ignore[override]
        return ColumnBinaryOpExpression(self, other, "!=")

    def __lt__(self, other):
        return ColumnBinaryOpExpression(self, other, "<")

    def __le__(self, other):
        return ColumnBinaryOpExpression(self, other, "<=")

    def __gt__(self, other):
        return ColumnBinaryOpExpression(self, other, ">")

    def __ge__(self, other):
        return ColumnBinaryOpExpression(self, other, ">=")

    # -- boolean / bitwise --
    def __and__(self, other):
        return ColumnBinaryOpExpression(self, other, "&")

    def __rand__(self, other):
        return ColumnBinaryOpExpression(other, self, "&")

    def __or__(self, other):
        return ColumnBinaryOpExpression(self, other, "|")

    def __ror__(self, other):
        return ColumnBinaryOpExpression(other, self, "|")

    def __xor__(self, other):
        return ColumnBinaryOpExpression(self, other, "^")

    def __rxor__(self, other):
        return ColumnBinaryOpExpression(other, self, "^")

    def __invert__(self):
        return ColumnUnaryOpExpression(self, "~")

    def __abs__(self):
        return ColumnUnaryOpExpression(self, "abs")

    def __hash__(self):
        return object.__hash__(self)

    def __bool__(self):
        raise TypeError(
            "ColumnExpression is not a boolean; use & | ~ instead of and/or/not, "
            "and == inside expressions builds an expression."
        )

    # -- item access --
    def __getitem__(self, index):
        return GetExpression(self, index, check_if_exists=True)

    def get(self, index, default=None):
        return GetExpression(self, index, default=default, check_if_exists=False)

    def is_none(self):
        return IsNoneExpression(self)

    def is_not_none(self):
        return IsNotNoneExpression(self)

    def to_string(self):
        return MethodCallExpression("to_string", [self])

    def as_int(self):
        return CastExpression(dt.Optional(dt.INT), self)

    def as_float(self):
        return CastExpression(dt.Optional(dt.FLOAT), self)

    def as_str(self):
        return CastExpression(dt.Optional(dt.STR), self)

    def as_bool(self):
        return CastExpression(dt.Optional(dt.BOOL), self)

    @property
    def dt(self):
        from .expressions_namespaces import DateTimeNamespace

        return DateTimeNamespace(self)

    @property
    def str(self):
        from .expressions_namespaces import StringNamespace

        return StringNamespace(self)

    @property
    def num(self):
        from .expressions_namespaces import NumericalNamespace

        return NumericalNamespace(self)

    @property
    def _deps(self) -> tuple["ColumnExpression", ...]:
        return ()

    def _collect_tables(self, order: list) -> None:
        if isinstance(self, ColumnReference):
            t = self._table
            if all(t is not o for o in order):
                order.append(t)
        for d in self._deps:
            if isinstance(d, ColumnExpression):
                d._collect_tables(order)

    def _fmt(self, tables: dict) -> str:
        return f"<{type(self).__name__}>"

    def __repr__(self) -> str:
        # reference ExpressionFormatter: tables number in first-appearance
        # order within ONE repr -> stable "<table1>.col" labels
        order: list = []
        self._collect_tables(order)
        tables = {id(t): i + 1 for i, t in enumerate(order)}
        return self._fmt(tables)


def smart_coerce(v: Any) -> ColumnExpression:
    if isinstance(v, ColumnExpression):
        return v
    return ColumnConstExpression(v)


class ColumnConstExpression(ColumnExpression):
    def __init__(self, value: Any):
        self._value = value

    def _fmt(self, tables: dict) -> str:
        return f"{self._value!r}"



class ColumnReference(ColumnExpression):
    """Reference to a column of a concrete table (``t.colname``)."""

    def __init__(self, table: "Table", name: str):
        self._table = table
        self._name = name

    @property
    def table(self) -> "Table":
        return self._table

    @property
    def name(self) -> str:
        return self._name

    def _fmt(self, tables: dict) -> str:
        n = tables.get(id(self._table))
        label = f"<table{n}>" if n is not None else f"<table {id(self._table):#x}>"
        return f"{label}.{self._name}"


class IdReference(ColumnReference):
    """``t.id`` — the pointer (row key) pseudo-column."""

    def __init__(self, table: "Table"):
        super().__init__(table, "id")


class SelfKeysExpression(ColumnExpression):
    """Compiles to the current batch's row keys (join-output ``pw.this.id``)."""

    @property
    def _deps(self):
        return ()


class HiddenRef(ColumnExpression):
    """Reference to a hidden engine column (reducer results etc.)."""

    def __init__(self, engine_name: str, dtype=None):
        self._engine_name = engine_name
        self._dtype = dtype

    @property
    def _deps(self):
        return ()

    def _fmt(self, tables: dict) -> str:
        return f"<hidden {self._engine_name}>"


class ColumnBinaryOpExpression(ColumnExpression):
    def __init__(self, left: Any, right: Any, op: str):
        self._left = smart_coerce(left)
        self._right = smart_coerce(right)
        self._op = op

    @property
    def _deps(self):
        return (self._left, self._right)

    def _fmt(self, tables: dict) -> str:
        return (
            f"({self._left._fmt(tables)} {self._op} "
            f"{self._right._fmt(tables)})"
        )


class ColumnUnaryOpExpression(ColumnExpression):
    def __init__(self, expr: Any, op: str):
        self._expr = smart_coerce(expr)
        self._op = op

    @property
    def _deps(self):
        return (self._expr,)


class ReducerExpression(ColumnExpression):
    def __init__(self, name: str, args: tuple, **kwargs: Any):
        self._reducer = name
        self._args = tuple(smart_coerce(a) for a in args)
        self._kwargs = kwargs

    @property
    def _deps(self):
        return self._args

    def _fmt(self, tables: dict) -> str:
        inner = ", ".join(a._fmt(tables) for a in self._args)
        return f"pathway.reducers.{self._reducer}({inner})"


class ApplyExpression(ColumnExpression):
    def __init__(
        self,
        fn: Callable,
        return_type: Any,
        args: tuple,
        kwargs: dict[str, Any],
        *,
        propagate_none: bool = False,
        deterministic: bool = True,
    ):
        self._fn = fn
        self._return_type = dt.wrap(return_type)
        self._args = tuple(smart_coerce(a) for a in args)
        self._kwargs = {k: smart_coerce(v) for k, v in kwargs.items()}
        self._propagate_none = propagate_none
        self._deterministic = deterministic

    @property
    def _deps(self):
        return self._args + tuple(self._kwargs.values())


class AsyncApplyExpression(ApplyExpression):
    pass


class CastExpression(ColumnExpression):
    def __init__(self, return_type: Any, expr: Any):
        self._return_type = dt.wrap(return_type)
        self._expr = smart_coerce(expr)

    @property
    def _deps(self):
        return (self._expr,)


class ConvertExpression(ColumnExpression):
    """Json value conversion (``.as_int()`` etc on Json)."""

    def __init__(self, return_type: Any, expr: Any, default: Any = None, unwrap: bool = False):
        self._return_type = dt.wrap(return_type)
        self._expr = smart_coerce(expr)
        self._default = smart_coerce(default)
        self._unwrap = unwrap

    @property
    def _deps(self):
        return (self._expr, self._default)


class DeclareTypeExpression(ColumnExpression):
    def __init__(self, return_type: Any, expr: Any):
        self._return_type = dt.wrap(return_type)
        self._expr = smart_coerce(expr)

    @property
    def _deps(self):
        return (self._expr,)


class CoalesceExpression(ColumnExpression):
    def __init__(self, *args: Any):
        self._args = tuple(smart_coerce(a) for a in args)

    @property
    def _deps(self):
        return self._args


class RequireExpression(ColumnExpression):
    def __init__(self, expr: Any, *args: Any):
        self._expr = smart_coerce(expr)
        self._args = tuple(smart_coerce(a) for a in args)

    @property
    def _deps(self):
        return (self._expr,) + self._args


class IfElseExpression(ColumnExpression):
    def __init__(self, _if: Any, _then: Any, _else: Any):
        self._if = smart_coerce(_if)
        self._then = smart_coerce(_then)
        self._else = smart_coerce(_else)

    @property
    def _deps(self):
        return (self._if, self._then, self._else)


class IsNoneExpression(ColumnExpression):
    def __init__(self, expr: Any):
        self._expr = smart_coerce(expr)

    @property
    def _deps(self):
        return (self._expr,)


class IsNotNoneExpression(IsNoneExpression):
    pass


class PointerExpression(ColumnExpression):
    """``table.pointer_from(*args, instance=...)`` — derive a row pointer."""

    def __init__(self, table: "Table | None", *args: Any, instance: Any = None, optional: bool = False):
        self._table = table
        self._args = tuple(smart_coerce(a) for a in args)
        self._instance = smart_coerce(instance) if instance is not None else None
        self._optional = optional

    @property
    def _deps(self):
        extra = (self._instance,) if self._instance is not None else ()
        return self._args + extra


class MakeTupleExpression(ColumnExpression):
    def __init__(self, *args: Any):
        self._args = tuple(smart_coerce(a) for a in args)

    @property
    def _deps(self):
        return self._args


class GetExpression(ColumnExpression):
    def __init__(self, obj: Any, index: Any, default: Any = None, check_if_exists: bool = True):
        self._obj = smart_coerce(obj)
        self._index = smart_coerce(index)
        self._default = smart_coerce(default)
        self._check_if_exists = check_if_exists

    @property
    def _deps(self):
        return (self._obj, self._index, self._default)


class MethodCallExpression(ColumnExpression):
    """Namespace method call (``x.dt.round('1h')``, ``x.str.lower()``)."""

    def __init__(self, method: str, args: Iterable[Any], **kwargs: Any):
        self._method = method
        self._args = tuple(smart_coerce(a) for a in args)
        self._method_kwargs = kwargs

    @property
    def _deps(self):
        return self._args


class UnwrapExpression(ColumnExpression):
    def __init__(self, expr: Any):
        self._expr = smart_coerce(expr)

    @property
    def _deps(self):
        return (self._expr,)


class FillErrorExpression(ColumnExpression):
    def __init__(self, expr: Any, replacement: Any):
        self._expr = smart_coerce(expr)
        self._replacement = smart_coerce(replacement)

    @property
    def _deps(self):
        return (self._expr, self._replacement)


# ---------------------------------------------------------------------------
# free functions (exported at package level)
# ---------------------------------------------------------------------------


def cast(target_type: Any, expr: Any) -> CastExpression:
    return CastExpression(target_type, expr)


def declare_type(target_type: Any, expr: Any) -> DeclareTypeExpression:
    return DeclareTypeExpression(target_type, expr)


def coalesce(*args: Any) -> CoalesceExpression:
    return CoalesceExpression(*args)


def require(val: Any, *args: Any) -> RequireExpression:
    return RequireExpression(val, *args)


def if_else(if_clause: Any, then_clause: Any, else_clause: Any) -> IfElseExpression:
    return IfElseExpression(if_clause, then_clause, else_clause)


def make_tuple(*args: Any) -> MakeTupleExpression:
    return MakeTupleExpression(*args)


def unwrap(col: Any) -> UnwrapExpression:
    return UnwrapExpression(col)


def fill_error(col: Any, replacement: Any) -> FillErrorExpression:
    return FillErrorExpression(col, replacement)


def apply(fn: Callable, *args: Any, **kwargs: Any) -> ApplyExpression:
    import typing

    hints = typing.get_type_hints(fn) if callable(fn) else {}
    ret = hints.get("return", dt.ANY)
    return ApplyExpression(fn, ret, args, kwargs)


def apply_with_type(fn: Callable, ret_type: Any, *args: Any, **kwargs: Any) -> ApplyExpression:
    return ApplyExpression(fn, ret_type, args, kwargs)


def apply_async(fn: Callable, *args: Any, **kwargs: Any) -> AsyncApplyExpression:
    import typing

    hints = typing.get_type_hints(fn) if callable(fn) else {}
    ret = hints.get("return", dt.ANY)
    return AsyncApplyExpression(fn, ret, args, kwargs)
