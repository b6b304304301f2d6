"""``pw.this`` / ``pw.left`` / ``pw.right`` placeholders.

Re-design of the reference's desugaring machinery
(``python/pathway/internals/thisclass.py`` + ``desugaring.py``): a
placeholder is a fake table; expressions built on it are rewritten against
concrete tables at the call site (select/filter/join/reduce) by
``substitute``.
"""

from __future__ import annotations

from typing import Any

from .expression import (
    ApplyExpression,
    ColumnExpression,
    ColumnReference,
    IdReference,
    PointerExpression,
)


class _ColNamespace:
    """``.C`` column accessor (reference ``table.C.colname``): reaches
    columns whose names collide with Table/this METHOD names — ``.C`` has
    no methods of its own, so every attribute is a column reference."""

    __slots__ = ("_owner",)

    def __init__(self, owner: Any):
        self._owner = owner

    def __getattr__(self, name: str):
        if name.startswith("__"):
            raise AttributeError(name)
        return self._owner[name]

    def __getitem__(self, name: str):
        return self._owner[name]


class ThisPlaceholder:
    def __init__(self, label: str):
        self._label = label

    @property
    def C(self) -> _ColNamespace:
        return _ColNamespace(self)

    def __getattr__(self, name: str) -> ColumnReference:
        if name.startswith("__") or name in ("_label", "_ipython_canary_method_should_not_exist_"):
            raise AttributeError(name)
        if name == "id":
            return IdReference(self)  # type: ignore[arg-type]
        return ColumnReference(self, name)  # type: ignore[arg-type]

    def __getitem__(self, name: str) -> ColumnReference:
        if name == "id":
            return IdReference(self)  # type: ignore[arg-type]
        return ColumnReference(self, name)  # type: ignore[arg-type]

    def pointer_from(self, *args: Any, instance: Any = None, optional: bool = False):
        return PointerExpression(self, *args, instance=instance, optional=optional)  # type: ignore[arg-type]

    def without(self, *columns: Any) -> "ThisWithout":
        """Wildcard minus named columns (reference ``pw.this.without``):
        ``t.select(*pw.this.without(pw.this.c))`` selects every column of
        the binding table except ``c``."""
        return ThisWithout(columns, self)

    def __iter__(self):
        # ``t.select(*pw.this)`` — all columns of the binding table
        return iter((ThisWithout((), self),))

    def __repr__(self) -> str:
        return f"<pw.{self._label}>"


class ThisWithout:
    """Deferred 'all columns except…' marker, expanded by select. Carries
    its source placeholder so join selects expand the correct side
    (``pw.left.without(...)`` vs ``pw.right.without(...)``)."""

    def __init__(self, excluded: tuple, placeholder: "ThisPlaceholder"):
        self.placeholder = placeholder
        self.excluded = tuple(
            c.name if isinstance(c, ColumnReference) else str(c)
            for c in excluded
        )

    def __iter__(self):
        return iter((self,))


this = ThisPlaceholder("this")
left = ThisPlaceholder("left")
right = ThisPlaceholder("right")


class DeferredIxTable:
    """``table.ix_ref(...)`` whose context table cannot be inferred from the
    arguments (no args, or only ``pw.this`` args) — the reference resolves
    these during select desugaring (``desugaring.py`` ix machinery); here a
    column read off this proxy becomes a :class:`DeferredIxColumn` that
    ``substitute`` binds once the enclosing select knows its table."""

    def __init__(self, table: Any, args: tuple, optional: bool, instance: Any):
        self._dtable = table
        self._dargs = args
        self._doptional = optional
        self._dinstance = instance

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return DeferredIxColumn(self, name)

    def __getitem__(self, name: str):
        return DeferredIxColumn(self, name)


class DeferredIxColumn(ColumnExpression):
    def __init__(self, deferred: DeferredIxTable, name: str):
        self._dix = deferred
        self._name = name

    @property
    def _deps(self):
        return tuple(
            a for a in self._dix._dargs if isinstance(a, ColumnExpression)
        )

    def __repr__(self) -> str:
        return f"<deferred {self._dix._dtable!r}.ix_ref(...).{self._name}>"


def substitute(expr: ColumnExpression, mapping: dict[Any, Any]) -> ColumnExpression:
    """Rewrite placeholder column references to concrete tables.

    mapping: placeholder-or-table -> concrete table. References to tables not
    in the mapping pass through unchanged.
    """
    import copy

    if isinstance(expr, DeferredIxColumn):
        ctx = mapping.get(this)
        if ctx is None:
            for ph in (left, right):
                if ph in mapping:
                    ctx = mapping[ph]
                    break
        if ctx is None:
            raise ValueError(
                "ix_ref context could not be inferred; pass context="
            )
        d = expr._dix
        args = tuple(
            substitute(a, mapping) if isinstance(a, ColumnExpression) else a
            for a in d._dargs
        )
        ixed = d._dtable.ix_ref(
            *args, optional=d._doptional, instance=d._dinstance, context=ctx
        )
        return ColumnReference(ixed, expr._name)
    if isinstance(expr, IdReference):
        if expr.table in mapping:
            return IdReference(mapping[expr.table])
        return expr
    if isinstance(expr, ColumnReference):
        if expr.table in mapping:
            target = mapping[expr.table]
            schema = getattr(target, "schema", None)
            if schema is not None and expr.name not in schema.__columns__:
                raise AttributeError(
                    f"Table has no column {expr.name!r}; columns: "
                    f"{schema.column_names()}"
                )
            return ColumnReference(target, expr.name)
        return expr
    if not expr._deps:
        return expr
    clone = copy.copy(expr)
    _substitute_in_place(clone, mapping)
    return clone


def _substitute_in_place(expr: ColumnExpression, mapping: dict[Any, Any]) -> None:
    for attr, value in list(vars(expr).items()):
        if isinstance(value, ColumnExpression):
            setattr(expr, attr, substitute(value, mapping))
        elif isinstance(value, tuple) and any(isinstance(v, ColumnExpression) for v in value):
            setattr(expr, attr, tuple(
                substitute(v, mapping) if isinstance(v, ColumnExpression) else v
                for v in value
            ))
        elif isinstance(value, dict) and any(
            isinstance(v, ColumnExpression) for v in value.values()
        ):
            setattr(expr, attr, {
                k: substitute(v, mapping) if isinstance(v, ColumnExpression) else v
                for k, v in value.items()
            })
