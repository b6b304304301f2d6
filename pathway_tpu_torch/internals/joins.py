"""Joinable / JoinResult — join desugaring.

Re-design of ``python/pathway/internals/joins.py`` (1,422 LoC; ``Joinable``
:46, ``JoinResult`` :135). A JoinResult holds both sides + equality
conditions; ``.select()``/``.reduce()`` produce concrete tables lowered to
the engine's incremental Join operator (dataflow.rs:2270).
"""

from __future__ import annotations

import copy
import enum
from typing import Any

from . import dtype as dt
from .expression import (
    ColumnBinaryOpExpression,
    ColumnExpression,
    ColumnReference,
    IdReference,
    smart_coerce,
)
from .parse_graph import Universe
from .schema import ColumnSchema, schema_from_columns
from .thisclass import ThisPlaceholder, left, right, substitute, this


class JoinMode(enum.Enum):
    INNER = "inner"
    LEFT = "left"
    RIGHT = "right"
    OUTER = "outer"


class JoinResult:
    def __init__(self, left_table, right_table, on: tuple, mode: JoinMode, id: Any = None):
        from .table import Table

        self._left = left_table
        self._right = right_table
        self._mode = mode
        self._id = id
        self._left_on: list[ColumnExpression] = []
        self._right_on: list[ColumnExpression] = []
        for cond in on:
            lexpr, rexpr = self._split_condition(cond)
            self._left_on.append(lexpr)
            self._right_on.append(rexpr)

    def _split_condition(self, cond: Any):
        if not isinstance(cond, ColumnBinaryOpExpression) or cond._op != "==":
            raise ValueError("join conditions must be equality expressions (a == b)")
        lexpr = substitute(cond._left, {left: self._left, right: self._right})
        rexpr = substitute(cond._right, {left: self._left, right: self._right})
        lside = _side_of(lexpr, self._left, self._right)
        rside = _side_of(rexpr, self._left, self._right)
        if lside == "right" or rside == "left":
            lexpr, rexpr = rexpr, lexpr
            lside, rside = rside, lside
        if lside != "left" or rside != "right":
            raise ValueError(
                "each join condition must reference the left table on one side "
                "and the right table on the other"
            )
        return lexpr, rexpr

    def _resolve(self, expr: ColumnExpression) -> ColumnExpression:
        """Rewrite pw.this/pw.left/pw.right and JoinResult refs to the
        underlying tables."""
        expr = substitute(
            smart_coerce(expr), {left: self._left, right: self._right, this: self}
        )
        return _replace_jr_refs(expr, self)

    def _lookup(self, name: str) -> ColumnReference:
        in_left = name in self._left.schema.__columns__
        in_right = name in self._right.schema.__columns__
        if in_left and in_right:
            raise ValueError(
                f"column {name!r} exists on both sides of the join; "
                "use pw.left / pw.right to disambiguate"
            )
        if in_left:
            return ColumnReference(self._left, name)
        if in_right:
            return ColumnReference(self._right, name)
        raise AttributeError(f"join result has no column {name!r}")

    def __getattr__(self, name: str) -> ColumnReference:
        if name.startswith("_"):
            raise AttributeError(name)
        return self._lookup(name)

    def __getitem__(self, name: str) -> ColumnReference:
        return self._lookup(name)

    def select(self, *args: Any, **kwargs: Any):
        from .table import Table

        from .thisclass import ThisWithout, left as left_ph, right as right_ph

        exprs: dict[str, ColumnExpression] = {}
        flat: list[Any] = []
        for arg in args:
            if isinstance(arg, ThisWithout):
                # pw.left/pw.right wildcards expand against their side;
                # bare pw.this expands against the left (reference join
                # desugaring binds this to the join's row namespace)
                side = (
                    self._right if arg.placeholder is right_ph else self._left
                )
                flat.extend(
                    ColumnReference(side, n)
                    for n in side.column_names()
                    if n not in arg.excluded
                )
            else:
                flat.append(arg)
        for arg in flat:
            resolved = self._resolve(arg)
            if not isinstance(resolved, ColumnReference):
                raise ValueError("positional select args must be column references")
            exprs[resolved.name] = resolved
        for name, e in kwargs.items():
            exprs[name] = self._resolve(e)

        schema = _join_select_schema(self, exprs)
        id_side = None
        if self._id is not None:
            id_expr = self._resolve(self._id)
            if not isinstance(id_expr, IdReference):
                raise ValueError("join id= must be pw.left.id or pw.right.id")
            id_side = "left" if id_expr.table is self._left else "right"
        # id=pw.left.id with a LEFT join emits exactly one row per left row
        # under the reference's uniqueness contract ("result.id == left.id";
        # duplicate matches are a runtime error) — so the output IS the
        # id-side universe, and downstream zips need no promise
        # (symmetrically for RIGHT joins keyed by the right side)
        if id_side == "left" and self._mode == JoinMode.LEFT:
            universe = self._left._universe
        elif id_side == "right" and self._mode == JoinMode.RIGHT:
            universe = self._right._universe
        else:
            universe = Universe()
        return Table(
            "join_select",
            [self._left, self._right],
            {
                "left_on": self._left_on,
                "right_on": self._right_on,
                "mode": self._mode.value,
                "exprs": exprs,
                "id_side": id_side,
                "asof_now": getattr(self, "_asof_now", False),
            },
            schema,
            universe,
        )

    def reduce(self, *args: Any, **kwargs: Any):
        full = self.select(
            **{
                n: self._lookup(n)
                for n in set(self._left.column_names()) ^ set(self._right.column_names())
            }
        )
        return full.reduce(*args, **kwargs)

    def groupby(self, *args: Any, **kwargs: Any):
        cols = {}
        for n in self._left.column_names():
            if n not in self._right.schema.__columns__:
                cols[n] = ColumnReference(self._left, n)
        for n in self._right.column_names():
            if n not in self._left.schema.__columns__:
                cols[n] = ColumnReference(self._right, n)
        full = self.select(**cols)
        new_args = [getattr(full, a.name) if isinstance(a, ColumnReference) else a for a in args]
        return full.groupby(*new_args, **kwargs)

    def filter(self, expression: Any):
        raise NotImplementedError("filter on JoinResult: select first, then filter")


def _side_of(expr: ColumnExpression, left_table, right_table) -> str | None:
    found: set[str] = set()

    def walk(e):
        if isinstance(e, ColumnReference):
            if e.table is left_table:
                found.add("left")
            elif e.table is right_table:
                found.add("right")
            elif isinstance(e.table, ThisPlaceholder):
                raise ValueError("unresolved placeholder in join condition")
        for d in getattr(e, "_deps", ()):
            walk(d)

    walk(expr)
    if found == {"left"}:
        return "left"
    if found == {"right"}:
        return "right"
    return None


def _replace_jr_refs(expr: ColumnExpression, jr: JoinResult) -> ColumnExpression:
    from .expression import SelfKeysExpression

    if isinstance(expr, IdReference):
        if expr.table is jr:
            return SelfKeysExpression()  # the joined row's own key
        return expr
    if isinstance(expr, ColumnReference):
        if expr.table is jr:
            return jr._lookup(expr.name)
        return expr
    if not getattr(expr, "_deps", ()):
        return expr
    clone = copy.copy(expr)
    for attr, value in list(vars(clone).items()):
        if isinstance(value, ColumnExpression):
            setattr(clone, attr, _replace_jr_refs(value, jr))
        elif isinstance(value, tuple) and any(isinstance(v, ColumnExpression) for v in value):
            setattr(clone, attr, tuple(
                _replace_jr_refs(v, jr) if isinstance(v, ColumnExpression) else v
                for v in value
            ))
    return clone


def _join_select_schema(jr: JoinResult, exprs: dict[str, ColumnExpression]):
    from .expression_compiler import ColumnEnv, infer_dtype

    env = ColumnEnv()
    env.add_table(jr._left, prefix="l.")
    env.add_table(jr._right, prefix="r.")
    env.add(jr, "id", None, dt.POINTER)
    mode = jr._mode
    l_opt = mode in (JoinMode.RIGHT, JoinMode.OUTER)
    r_opt = mode in (JoinMode.LEFT, JoinMode.OUTER)
    cols = {}
    for name, e in exprs.items():
        d = infer_dtype(_prefix_refs(e, jr), env)
        side = _side_of(e, jr._left, jr._right)
        if (side == "left" and l_opt) or (side == "right" and r_opt):
            d = dt.Optional(d)
        cols[name] = ColumnSchema(name=name, dtype=d)
    return schema_from_columns(cols, name="Joined")


def _prefix_refs(expr: ColumnExpression, jr: JoinResult) -> ColumnExpression:
    """For typing only: the env above registered prefixed names; references
    resolve by table identity so no rewrite is actually needed."""
    return expr


class Joinable:
    pass
