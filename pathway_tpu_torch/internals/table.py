"""``pw.Table`` — the declarative, incrementally-maintained table.

Re-design of ``python/pathway/internals/table.py`` (2,675 LoC; method parity
cites below). Every method appends a node to the parse graph; nothing
executes until ``pw.run``/debug computes outputs. Each node kind maps to one
engine operator family (see ``internals/graph_runner.py``).

Copy of ``pathway_tpu/internals/table.py``. ``sort`` runs on the port's
``stdlib._sorted``; ``live`` takes ``device=`` (default ``"cuda"``) for the
background run of ``internals/interactive.py::LiveTable``.
"""

from __future__ import annotations

import itertools
from typing import Any, Iterable

import numpy as np

from . import dtype as dt
from .expression import (
    ColumnExpression,
    ColumnReference,
    IdReference,
    PointerExpression,
    ReducerExpression,
    smart_coerce,
)
from .parse_graph import G, Universe
from .schema import Schema, SchemaMetaclass, schema_from_columns, schema_from_types
from .schema import ColumnSchema
from .thisclass import ThisPlaceholder, substitute, this


class TableLike:
    _universe: Universe


class Table(TableLike):
    _kind: str
    _inputs: list["Table"]
    _params: dict[str, Any]
    _schema: SchemaMetaclass

    _id_seq = itertools.count(1)

    def __init__(self, kind: str, inputs: list["Table"], params: dict[str, Any],
                 schema: SchemaMetaclass, universe: Universe):
        self._kind = kind
        self._inputs = inputs
        self._params = params
        self._schema = schema
        self._universe = universe
        self._table_seq = next(Table._id_seq)
        from . import lintmode

        if lintmode.ACTIVE:
            # static analysis: remember which script line built this table
            # so diagnostics (and `# pathway: ignore[...]` suppressions)
            # can anchor to source
            lintmode.note_table(self._table_seq)
        from .error_log_table import current_build_scope

        #: pw.local_error_log() scope active when this table was built —
        #: its nodes' runtime row errors carry the scope
        self._error_scope = current_build_scope()
        #: user-pinned stable operator name (``named``); None = unnamed
        self._pw_name: str | None = None

    def named(self, name: str) -> "Table":
        """Pin a stable, user-visible operator identity onto this table's
        node. ``pathway-tpu upgrade`` matches operators across code
        versions by structural fingerprint first and pinned name second —
        naming a stateful table lets its snapshots survive structural
        edits (the *remapped* plan verb) instead of being dropped."""
        if not name or not isinstance(name, str):
            raise ValueError("named() needs a non-empty string")
        self._pw_name = name
        return self

    # -- schema surface -----------------------------------------------------

    @property
    def schema(self) -> SchemaMetaclass:
        return self._schema

    def column_names(self) -> list[str]:
        return self._schema.column_names()

    def typehints(self) -> dict[str, Any]:
        return self._schema.typehints()

    @property
    def id(self) -> IdReference:
        return IdReference(self)

    def keys(self):
        return self._schema.columns()

    def __getattr__(self, name: str) -> ColumnReference:
        if name.startswith("__"):
            raise AttributeError(name)
        if name in self._schema.__columns__:
            return ColumnReference(self, name)
        raise AttributeError(
            f"Table has no column {name!r}; columns: {self.column_names()}"
        )

    def _column_ref(self, name: str) -> ColumnReference:
        """Schema-direct column reference — bypasses attribute lookup so
        columns named like Table methods/properties (select, C, ...) still
        resolve (the ``.C`` namespace and ``t["name"]`` route here)."""
        if name == "id":
            return IdReference(self)
        if name in self._schema.__columns__:
            return ColumnReference(self, name)
        raise AttributeError(
            f"Table has no column {name!r}; columns: {self.column_names()}"
        )

    def __getitem__(self, arg):
        if isinstance(arg, str):
            return self._column_ref(arg)
        if isinstance(arg, ColumnReference):
            return self._column_ref(arg.name)
        if isinstance(arg, (list, tuple)):
            return self.select(*[self[a] for a in arg])
        raise TypeError(f"cannot index Table with {arg!r}")

    def __iter__(self):
        raise TypeError("Table is not iterable; use pw.debug.compute_and_print")

    def __repr__(self) -> str:
        inner = ", ".join(f"{n}: {c.dtype!r}" for n, c in self._schema.columns().items())
        return f"<pw.Table ({inner})>"

    @property
    def C(self):
        """``.C`` column accessor (reference table.C.colname): columns
        whose names collide with Table method names."""
        from .thisclass import _ColNamespace

        return _ColNamespace(self)

    # -- live visualization (reference table.py:96 binds stdlib.viz) --------

    def plot(self, plotting_function, sorting_col: str | None = None):
        """Live-updating Bokeh plot of this table (reference viz.plot):
        ``plotting_function(source) -> figure`` gets a ColumnDataSource
        that streams append-only ticks incrementally after ``pw.run()``.
        Without bokeh/panel, returns the LiveTableSource mirror."""
        from ..stdlib.viz import plot as _plot

        return _plot(self, plotting_function, sorting_col)

    def show(self, sorting_col: str | None = None, **kwargs):
        """Live table widget (reference viz.table_viz/show)."""
        from ..stdlib.viz import table_viz as _table_viz

        return _table_viz(self, sorting_col, **kwargs)

    def _has_realtime_inputs(self) -> bool:
        seen: set[int] = set()
        stack: list[Table] = [self]
        while stack:
            t = stack.pop()
            if id(t) in seen:
                continue
            seen.add(id(t))
            if t._kind == "source":
                return True
            stack.extend(t._inputs)
        return False

    def _repr_html_(self) -> str:
        """Notebook display: a static snapshot when the table has no
        streaming inputs; otherwise the reference's run-first hint
        (plotting.py:81) — computing a live table here could block on an
        unbounded source."""
        if self._has_realtime_inputs():
            return (
                f"<em>{self!r} — depends on streaming inputs; run "
                "pw.run() with t.plot(...)/t.show() for live output</em>"
            )
        try:
            from ..debug import table_to_pandas

            df = table_to_pandas(self, include_id=False)
            return df.to_html()
        except Exception:
            return f"<em>{self!r}</em>"

    # -- desugaring helpers -------------------------------------------------

    def _sub(self, expr: Any) -> ColumnExpression:
        return substitute(smart_coerce(expr), {this: self})

    def _named_exprs(self, args: tuple, kwargs: dict[str, Any]) -> dict[str, ColumnExpression]:
        out: dict[str, ColumnExpression] = {}
        from .table_slice import TableSlice

        from .thisclass import ThisWithout

        flat: list[Any] = []
        for arg in args:
            if isinstance(arg, ThisWithout):
                # pw.this / pw.this.without(...): all of this table's
                # columns minus the excluded names
                flat.extend(
                    ColumnReference(self, n)
                    for n in self.column_names()
                    if n not in arg.excluded
                )
            elif isinstance(arg, TableSlice):
                # a TableSlice unpacks into its (possibly renamed) references
                flat.extend(arg)
            else:
                flat.append(arg)
        for arg in flat:
            if isinstance(arg, str):
                # reference error_messages: a bare string is the most
                # common slip — point at the fix
                raise ValueError(
                    f"Expected a ColumnReference, found a string. Did you "
                    f"mean this.{arg} instead of {arg!r}?"
                )
            arg = self._sub(arg)
            if not isinstance(arg, ColumnReference):
                raise ValueError(
                    "positional select arguments must be column references; "
                    "use keyword arguments for expressions"
                )
            # RenamedReference (from slice.rename): output name differs from
            # the referenced column
            out[arg.name] = getattr(arg, "_source", arg)
        for name, e in kwargs.items():
            out[name] = self._sub(e)
        return out

    def pointer_from(self, *args: Any, instance: Any = None, optional: bool = False) -> PointerExpression:
        # args stay UNBOUND: ``this`` in them refers to the table the
        # expression is used in (reference semantics — e.g. an expected
        # table built with ``.with_columns(k=t.pointer_from(this.k))``
        # reads ITS OWN k column and keys into t's universe)
        return PointerExpression(
            self, *[smart_coerce(a) for a in args],
            instance=instance, optional=optional,
        )

    # -- rowwise ops (table.py:382 select, :490 filter, :1613 with_columns) --

    def select(self, *args: Any, **kwargs: Any) -> "Table":
        exprs = self._named_exprs(args, kwargs)
        return self._rowwise(exprs)

    def _rowwise(self, exprs: dict[str, ColumnExpression], universe: Universe | None = None) -> "Table":
        from .expression_compiler import ColumnEnv

        schema = _infer_schema(exprs, self)
        return Table(
            "rowwise",
            [self],
            {"exprs": exprs},
            schema,
            universe if universe is not None else self._universe,
        )

    @classmethod
    def empty(cls, **kwargs: Any) -> "Table":
        """An empty table with the given column types (reference
        ``pw.Table.empty(cnt=int)``)."""
        from .schema import schema_from_types
        from .table_io import rows_to_table

        return rows_to_table(
            list(kwargs), [], schema=schema_from_types(**kwargs)
        )

    def remove_errors(self) -> "Table":
        """Drop rows in which any column holds an Error value (reference
        ``Table.remove_errors``, test_errors.py:620 — the engine's
        filter_out_results_of_failed_computations)."""
        return Table(
            "remove_errors",
            [self],
            {},
            self._schema,
            Universe(parent=self._universe),
        )

    def filter(self, filter_expression: Any) -> "Table":
        expr = self._sub(filter_expression)
        return Table(
            "filter",
            [self],
            {"predicate": expr},
            self._schema,
            Universe(parent=self._universe),
        )

    def with_columns(self, *args: Any, **kwargs: Any) -> "Table":
        new = self._named_exprs(args, kwargs)
        exprs: dict[str, ColumnExpression] = {
            name: ColumnReference(self, name) for name in self.column_names()
        }
        exprs.update(new)
        return self._rowwise(exprs)

    def without(self, *columns: Any) -> "Table":
        names = {c.name if isinstance(c, ColumnReference) else c for c in columns}
        exprs = {
            n: ColumnReference(self, n) for n in self.column_names() if n not in names
        }
        return self._rowwise(exprs)

    def rename_columns(self, **kwargs: Any) -> "Table":
        mapping = {}
        for new_name, old in kwargs.items():
            mapping[old.name if isinstance(old, ColumnReference) else old] = new_name
        return self._rename(mapping)

    def rename_by_dict(self, names_mapping: dict) -> "Table":
        mapping = {
            (old.name if isinstance(old, ColumnReference) else old): new
            for old, new in names_mapping.items()
        }
        return self._rename(mapping)

    def rename(self, names_mapping: dict | None = None, **kwargs: Any) -> "Table":
        if names_mapping is not None:
            return self.rename_by_dict(names_mapping)
        return self.rename_columns(**kwargs)

    def _rename(self, mapping: dict[str, str]) -> "Table":
        unknown = set(mapping) - set(self.column_names())
        if unknown:
            raise KeyError(
                f"rename: unknown column(s) {sorted(unknown)}; columns: "
                f"{self.column_names()}"
            )
        exprs = {
            mapping.get(n, n): ColumnReference(self, n) for n in self.column_names()
        }
        return self._rowwise(exprs)

    def copy(self) -> "Table":
        return self._rowwise(
            {n: ColumnReference(self, n) for n in self.column_names()}
        )

    def cast_to_types(self, **kwargs: Any) -> "Table":
        from .expression import CastExpression

        exprs: dict[str, ColumnExpression] = {}
        for n in self.column_names():
            if n in kwargs:
                exprs[n] = CastExpression(kwargs[n], ColumnReference(self, n))
            else:
                exprs[n] = ColumnReference(self, n)
        return self._rowwise(exprs)

    def update_types(self, **kwargs: Any) -> "Table":
        """Override DECLARED column dtypes without touching runtime values
        (reference ``Table.update_types`` — a type annotation, not a cast;
        use ``cast_to_types`` to convert values)."""
        cols = dict(self._schema.columns())
        unknown = set(kwargs) - set(cols)
        if unknown:
            raise KeyError(f"update_types: unknown column(s) {sorted(unknown)}")
        for n, t in kwargs.items():
            cols[n] = ColumnSchema(name=n, dtype=dt.wrap(t))
        schema = schema_from_columns(cols, name="Retyped")
        # "with_universe_of" lowers to a pure pass-through of input 0
        return Table("with_universe_of", [self], {}, schema, self._universe)

    # -- groupby / reduce (table.py:942, :1025) -----------------------------

    def groupby(self, *args: Any, id: Any = None, instance: Any = None,
                _skip_errors: bool = True, **kwargs: Any):
        from .groupbys import GroupedTable

        grouping = [self._sub(a) for a in args]
        by_id = False
        if id is not None:
            grouping = [self._sub(id)]
            by_id = True
        return GroupedTable(
            self,
            grouping,
            instance=self._sub(instance) if instance is not None else None,
            by_id=by_id,
            skip_errors=_skip_errors,
        )

    def reduce(self, *args: Any, **kwargs: Any) -> "Table":
        return self.groupby().reduce(*args, **kwargs)

    def deduplicate(
        self,
        value: Any = None,
        instance: Any = None,
        acceptor: Any = None,
        persistent_id: str | None = None,
    ) -> "Table":
        value = self._sub(value) if value is not None else IdReference(self)
        instance = self._sub(instance) if instance is not None else None
        return Table(
            "deduplicate",
            [self],
            {"value": value, "instance": instance, "acceptor": acceptor},
            self._schema,
            Universe(),
        )

    # -- joins (table.py / joins.py) ----------------------------------------

    @staticmethod
    def _with_instance_cond(on: tuple, kwargs: dict) -> tuple:
        """``left_instance=``/``right_instance=`` desugar to an extra
        equality condition (reference join instance kwargs)."""
        li = kwargs.pop("left_instance", None)
        ri = kwargs.pop("right_instance", None)
        if (li is None) != (ri is None):
            raise ValueError(
                "left_instance and right_instance must be given together"
            )
        if li is not None:
            on = (*on, li == ri)
        return on

    def join(self, other: "Table", *on: Any, id: Any = None, how: Any = None, **kwargs):
        from .joins import JoinMode, JoinResult

        on = self._with_instance_cond(on, kwargs)
        mode = how if how is not None else JoinMode.INNER
        return JoinResult(self, other, on, mode=mode, id=id)

    def join_inner(self, other: "Table", *on: Any, id: Any = None, **kwargs):
        from .joins import JoinMode, JoinResult

        on = self._with_instance_cond(on, kwargs)
        return JoinResult(self, other, on, mode=JoinMode.INNER, id=id)

    def join_left(self, other: "Table", *on: Any, id: Any = None, **kwargs):
        from .joins import JoinMode, JoinResult

        on = self._with_instance_cond(on, kwargs)
        return JoinResult(self, other, on, mode=JoinMode.LEFT, id=id)

    def join_right(self, other: "Table", *on: Any, id: Any = None, **kwargs):
        from .joins import JoinMode, JoinResult

        on = self._with_instance_cond(on, kwargs)
        return JoinResult(self, other, on, mode=JoinMode.RIGHT, id=id)

    def join_outer(self, other: "Table", *on: Any, id: Any = None, **kwargs):
        from .joins import JoinMode, JoinResult

        on = self._with_instance_cond(on, kwargs)
        return JoinResult(self, other, on, mode=JoinMode.OUTER, id=id)

    # -- set ops ------------------------------------------------------------

    def concat(self, *others: "Table") -> "Table":
        tables = [self, *others]
        schema = _common_schema(tables)
        universes = [t._universe for t in tables]
        if not G.solver.query_are_disjoint(*universes):
            # reference table.py:1334 `_concat`: concat keeps original row
            # ids, so colliding key sets are refused at build time unless
            # disjointness is provable or promised
            raise ValueError(
                "Table.concat: universes of the concatenated tables might "
                "collide; use pw.universes.promise_are_pairwise_disjoint "
                "(or concat_reindex, which reindexes)"
            )
        result = Universe()
        G.solver.register_as_union(result, *universes)
        return Table("concat", tables, {}, schema, result)

    def concat_reindex(self, *others: "Table") -> "Table":
        tables = [self, *others]
        schema = _common_schema(tables)
        return Table("concat_reindex", tables, {}, schema, Universe())

    def update_rows(self, other: "Table") -> "Table":
        schema = _common_schema([self, other])
        return Table("update_rows", [self, other], {}, schema, Universe())

    def update_cells(self, other: "Table") -> "Table":
        if not other._universe.is_subset_of(self._universe):
            raise ValueError(
                "update_cells requires other's universe to be a subset of self's; "
                "use promise_universe_is_subset_of if you know it holds"
            )
        extra = set(other.column_names()) - set(self.column_names())
        if extra:
            raise ValueError(f"update_cells: unknown columns {sorted(extra)}")
        return Table(
            "update_cells",
            [self, other],
            {"override": other.column_names()},
            self._schema,
            self._universe,
        )

    def __lshift__(self, other: "Table") -> "Table":
        """``self << other`` = ``update_cells`` (reference table.py
        ``__lshift__`` alias)."""
        return self.update_cells(other)

    @staticmethod
    def from_columns(*args: Any, **kwargs: Any) -> "Table":
        """Build a table from columns of (universe-compatible) tables
        (reference table.py ``Table.from_columns``)."""
        refs = list(args) + list(kwargs.values())
        if not refs:
            raise ValueError("from_columns needs at least one column")
        base = refs[0].table
        return base.select(*args, **kwargs)

    def __add__(self, other: "Table") -> "Table":
        """Column-wise sum of two same-universe tables (zip columns)."""
        if not isinstance(other, Table):
            return NotImplemented
        exprs: dict[str, ColumnExpression] = {
            n: ColumnReference(self, n) for n in self.column_names()
        }
        for n in other.column_names():
            if n in exprs:
                raise ValueError(f"duplicate column {n!r} in Table + Table")
            exprs[n] = ColumnReference(other, n)
        return self._rowwise(exprs)

    def restrict(self, other: TableLike) -> "Table":
        if not other._universe.is_subset_of(self._universe):
            raise ValueError(
                "restrict requires other's universe to be a provable subset "
                "of self's; use promise_universe_is_subset_of if you know "
                "it holds (reference table.py:1334)"
            )
        return Table(
            "restrict",
            [self, other],  # type: ignore[list-item]
            {},
            self._schema,
            other._universe,
        )

    def intersect(self, *tables: "Table") -> "Table":
        out = self
        for t in tables:
            u = Universe()
            G.solver.register_as_intersection(
                u, out._universe, t._universe
            )
            out = Table("intersect", [out, t], {}, self._schema, u)
        return out

    def difference(self, other: "Table") -> "Table":
        u = Universe()
        G.solver.register_as_difference(
            u, self._universe, other._universe
        )
        return Table("difference", [self, other], {}, self._schema, u)

    def having(self, *indexers: Any) -> "Table":
        """Rows of each indexer's table whose pointer value is a key of
        ``self``, carrying ``self``'s columns — the result universe is a
        provable subset of the indexer table's (reference ``_having``,
        table.py:2027 / ``HavingContext`` column.py:794: universe =
        ``key_column.universe.subset()``)."""
        out = self
        for ix in indexers:
            if not isinstance(ix, ColumnReference) or not isinstance(
                getattr(ix, "table", None), Table
            ):
                # pw.this.x is a ColumnReference too, but its "table" is
                # the ThisPlaceholder — there is no concrete universe to
                # subset, so refuse it here with a clear error
                raise TypeError(
                    "having takes pointer-valued column references on a "
                    "concrete table (e.g. q.select(p=t.pointer_from(q.k)).p)"
                )
            out = Table(
                "having",
                [out, ix.table],
                {"key_expr": ix},
                out._schema,
                Universe(parent=ix.table._universe),
            )
        return out

    # -- reindexing (table.py:1690 with_id_from) ----------------------------

    def with_id_from(self, *args: Any, instance: Any = None) -> "Table":
        key_expr = PointerExpression(
            self, *[self._sub(a) for a in args],
            instance=self._sub(instance) if instance is not None else None,
        )
        return self.with_id(key_expr)

    def with_id(self, new_id: Any) -> "Table":
        return Table(
            "reindex",
            [self],
            {"key_expr": self._sub(new_id)},
            self._schema,
            Universe(),
        )

    # -- pointer indexing (table.py:1164 ix) --------------------------------

    def ix(self, expression: Any, *, optional: bool = False, context: Any = None) -> "Table":
        if context is None:
            context = _expression_table(expression)
        if context is None:
            raise ValueError("cannot infer context table for ix; pass context=")
        key_expr = substitute(smart_coerce(expression), {this: context})
        schema = self._schema
        if optional:
            schema = schema_from_columns({
                n: ColumnSchema(name=n, dtype=dt.Optional(c.dtype))
                for n, c in schema.columns().items()
            }, name="Ixed")
        return Table(
            "ix",
            [context, self],
            {"key_expr": key_expr, "optional": optional},
            schema,
            context._universe,
        )

    def ix_ref(self, *args: Any, optional: bool = False, context: Any = None, instance: Any = None) -> "Table":
        if context is None:
            for a in args:
                context = _expression_table(smart_coerce(a))
                if context is not None:
                    break
        if context is None:
            # no args (singleton broadcast) or only pw.this args: the
            # context table is the enclosing select's — defer until its
            # desugaring binds pw.this (reference desugaring ix support)
            from .thisclass import DeferredIxTable

            return DeferredIxTable(self, args, optional, instance)  # type: ignore[return-value]
        return self.ix(
            PointerExpression(self, *args, instance=instance),
            optional=optional,
            context=context,
        )

    # -- flatten (table.py:2089) --------------------------------------------

    def flatten(self, to_flatten: Any, origin_id: str | None = None) -> "Table":
        ref = self._sub(to_flatten)
        if not isinstance(ref, ColumnReference):
            raise ValueError("flatten takes a column reference")
        cols = dict(self._schema.columns())
        inner = cols[ref.name].dtype
        iu = dt.unoptionalize(inner)
        if isinstance(iu, dt.List):
            new_dt: dt.DType = iu.wrapped
        elif isinstance(iu, dt.Tuple) and iu.args:
            new_dt = dt.types_lca_many(list(iu.args))
        elif iu == dt.STR:
            new_dt = dt.STR
        elif iu in (dt.INT, dt.FLOAT, dt.BOOL, dt.POINTER, dt.DURATION,
                    dt.DATE_TIME_NAIVE, dt.DATE_TIME_UTC, dt.BYTES):
            # statically non-iterable — a build-time error, as in the
            # reference (test_common.py:1095 test_flatten_incorrect_type);
            # dynamically wrong values in ANY/JSON columns are skipped at
            # run time with an error-log entry instead
            raise TypeError(
                f"flatten: column {ref.name!r} of type {iu} is not iterable"
            )
        else:
            new_dt = dt.ANY
        cols[ref.name] = ColumnSchema(name=ref.name, dtype=new_dt)
        params: dict[str, Any] = {"column": ref.name}
        schema = schema_from_columns(cols, name="Flattened")
        if origin_id is not None:
            schema = schema_from_columns(
                {**cols, origin_id: ColumnSchema(name=origin_id, dtype=dt.POINTER)},
                name="Flattened",
            )
            params["origin_id"] = origin_id
        return Table("flatten", [self], params, schema, Universe())

    def _gradual_broadcast(
        self, threshold_table: "Table", lower_column: Any, value_column: Any,
        upper_column: Any,
    ) -> "Table":
        """Append an ``apx_value`` column split by a moving threshold
        (reference table.py:631 over ``gradual_broadcast.rs``): each key
        deterministically lands on ``lower`` or ``upper`` such that about
        (value-lower)/(upper-lower) of keys read ``upper``; a threshold
        move re-emits only the keys whose side flips."""
        apx = Table(
            "gradual_broadcast",
            [self, threshold_table],
            {
                "cols": (
                    self._sub(lower_column), self._sub(value_column),
                    self._sub(upper_column),
                )
            },
            schema_from_columns({
                "apx_value": ColumnSchema(name="apx_value", dtype=dt.FLOAT)
            }),
            self._universe,
        )
        return self + apx

    # -- universe promises --------------------------------------------------

    def promise_universes_are_equal(self, other: "Table") -> "Table":
        G.promise_equal(self._universe, other._universe)
        return self

    def promise_universe_is_equal_to(self, other: "Table") -> "Table":
        G.promise_equal(self._universe, other._universe)
        return self

    def promise_universe_is_subset_of(self, other: "Table") -> "Table":
        G.promise_subset(self._universe, other._universe)
        return self

    def promise_universes_are_disjoint(self, other: "Table") -> "Table":
        G.promise_disjoint(self._universe, other._universe)
        return self

    # -- deprecated pre-1.0 aliases (reference test_backward_compatibility) --

    @staticmethod
    def _deprecated(old: str, new: str) -> None:
        import warnings

        warnings.warn(
            f"{old} is deprecated; use {new} instead",
            DeprecationWarning, stacklevel=3,
        )

    def unsafe_promise_same_universe_as(self, other: "Table") -> "Table":
        self._deprecated(
            "unsafe_promise_same_universe_as", "with_universe_of"
        )
        return self.promise_universes_are_equal(other).with_universe_of(other)

    def unsafe_promise_universe_is_subset_of(self, other: "Table") -> "Table":
        self._deprecated(
            "unsafe_promise_universe_is_subset_of",
            "promise_universe_is_subset_of",
        )
        return self.promise_universe_is_subset_of(other)

    def unsafe_promise_universes_are_pairwise_disjoint(
        self, *others: "Table"
    ) -> "Table":
        self._deprecated(
            "unsafe_promise_universes_are_pairwise_disjoint",
            "promise_universes_are_disjoint",
        )
        out = self
        for other in others:
            out = out.promise_universes_are_disjoint(other)
        return out

    def left_join(self, other: "Table", *on: Any, **kwargs: Any):
        self._deprecated("left_join", "join_left")
        return self.join_left(other, *on, **kwargs)

    def right_join(self, other: "Table", *on: Any, **kwargs: Any):
        self._deprecated("right_join", "join_right")
        return self.join_right(other, *on, **kwargs)

    def outer_join(self, other: "Table", *on: Any, **kwargs: Any):
        self._deprecated("outer_join", "join_outer")
        return self.join_outer(other, *on, **kwargs)

    def with_universe_of(self, other: TableLike) -> "Table":
        if not self._universe.is_equal(other._universe):
            raise ValueError(
                "with_universe_of requires provably equal universes; use "
                "promise_universes_are_equal if you know they match "
                "(reference table.py:1613)"
            )
        return Table(
            "with_universe_of",
            [self, other],  # type: ignore[list-item]
            {},
            self._schema,
            other._universe,
        )

    # -- misc ---------------------------------------------------------------

    @property
    def slice(self) -> "TableSlice":
        """A manipulable collection of references to this table's columns
        (reference table.py:468 / table_slice.py)."""
        from .table_slice import TableSlice

        return TableSlice(
            {name: ColumnReference(self, name) for name in self.column_names()},
            self,
        )

    def sort(self, key: Any, instance: Any = None) -> "Table":
        """Sort rows by `key` (within `instance`); returns a same-universe
        table with ``prev``/``next`` pointer columns (reference table.py:2157,
        backed by prev_next.rs in the reference engine). The definition of
        ``pathway_tpu/internals/table.py`` that runs there (its class body
        defines ``sort`` twice; the second wins)."""
        from ..stdlib._sorted import sorted_group_transform

        key_e = self._sub(key)
        inst_e = self._sub(instance) if instance is not None else None

        def fn(entries):
            out = []
            for i, (rk, order, _payload) in enumerate(entries):
                prev_k = entries[i - 1][0] if i > 0 else None
                next_k = entries[i + 1][0] if i + 1 < len(entries) else None
                out.append((rk, (
                    None if prev_k is None else np.uint64(prev_k),
                    None if next_k is None else np.uint64(next_k),
                )))
            return out

        return sorted_group_transform(
            self, key_e, [], inst_e,
            {"prev": dt.Optional(dt.POINTER), "next": dt.Optional(dt.POINTER)},
            fn,
        )

    def windowby(self, time_expr: Any, *, window: Any, instance: Any = None, behavior: Any = None, **kwargs):
        from ..stdlib.temporal import windowby as _windowby

        return _windowby(self, time_expr, window=window, instance=instance, behavior=behavior)

    def interval_join(self, other: "Table", self_time: Any, other_time: Any, interval: Any, *on: Any, **kwargs):
        from ..stdlib.temporal import interval_join as _ij

        return _ij(self, other, self_time, other_time, interval, *on, **kwargs)

    def interval_join_inner(self, other, self_time, other_time, interval, *on, **kw):
        from ..stdlib.temporal import interval_join_inner as _f

        return _f(self, other, self_time, other_time, interval, *on, **kw)

    def interval_join_left(self, other, self_time, other_time, interval, *on, **kw):
        from ..stdlib.temporal import interval_join_left as _f

        return _f(self, other, self_time, other_time, interval, *on, **kw)

    def interval_join_right(self, other, self_time, other_time, interval, *on, **kw):
        from ..stdlib.temporal import interval_join_right as _f

        return _f(self, other, self_time, other_time, interval, *on, **kw)

    def interval_join_outer(self, other, self_time, other_time, interval, *on, **kw):
        from ..stdlib.temporal import interval_join_outer as _f

        return _f(self, other, self_time, other_time, interval, *on, **kw)

    def window_join(self, other, self_time, other_time, window, *on, **kw):
        from ..stdlib.temporal import window_join as _f

        return _f(self, other, self_time, other_time, window, *on, **kw)

    def window_join_inner(self, other, self_time, other_time, window, *on):
        from ..stdlib.temporal import window_join_inner as _f

        return _f(self, other, self_time, other_time, window, *on)

    def window_join_left(self, other, self_time, other_time, window, *on):
        from ..stdlib.temporal import window_join_left as _f

        return _f(self, other, self_time, other_time, window, *on)

    def window_join_right(self, other, self_time, other_time, window, *on):
        from ..stdlib.temporal import window_join_right as _f

        return _f(self, other, self_time, other_time, window, *on)

    def window_join_outer(self, other, self_time, other_time, window, *on):
        from ..stdlib.temporal import window_join_outer as _f

        return _f(self, other, self_time, other_time, window, *on)

    def asof_join(self, other, self_time, other_time, *on, **kw):
        from ..stdlib.temporal import asof_join as _f

        return _f(self, other, self_time, other_time, *on, **kw)

    def asof_join_left(self, other, self_time, other_time, *on, **kw):
        from ..stdlib.temporal import asof_join_left as _f

        return _f(self, other, self_time, other_time, *on, **kw)

    def asof_now_join(self, other, *on, **kw):
        from ..stdlib.temporal import asof_now_join as _f

        return _f(self, other, *on, **kw)

    def diff(self, timestamp: Any, *values: Any, instance: Any = None) -> "Table":
        from ..stdlib.ordered import diff as _diff

        return _diff(self, timestamp, *values, instance=instance)

    def interpolate(self, timestamp: Any, *values: Any, **kwargs: Any) -> "Table":
        # reference attaches the stdlib fn as a Table method (table.py:75)
        from ..stdlib.statistical import interpolate as _interp

        return _interp(self, timestamp, *values, **kwargs)

    def live(self, device: Any = "cuda"):
        """Run this table's subgraph on a background engine thread on
        ``device`` and return a continuously-updated handle (reference
        interactive.py:130 ``LiveTable``; observe with
        snapshot()/frontier()/subscribe())."""
        from .interactive import LiveTable

        return LiveTable(self, device=device)


def _expression_table(expr: Any):
    """The unique concrete table an expression refers to (for ix context)."""
    tables = []

    def walk(e):
        # PointerExpression._table is the *indexed* table, not the context —
        # only column references inside the expression locate the context.
        if isinstance(e, ColumnReference) and not isinstance(e.table, ThisPlaceholder):
            tables.append(e.table)
        for d in getattr(e, "_deps", ()):
            walk(d)

    if isinstance(expr, ColumnExpression):
        walk(expr)
    uniq = {id(t): t for t in tables}
    if len(uniq) == 1:
        return next(iter(uniq.values()))
    return None


def _infer_schema(exprs: dict[str, ColumnExpression], table: "Table") -> SchemaMetaclass:
    """Static type propagation (the analog of type_interpreter.py)."""
    from .expression_compiler import ColumnEnv, infer_dtype

    env = ColumnEnv()
    _add_reachable_tables(env, exprs, table)
    cols = {}
    for name, e in exprs.items():
        cols[name] = ColumnSchema(name=name, dtype=infer_dtype(e, env))
    return schema_from_columns(cols, name="Selected")


def _add_reachable_tables(env, exprs, primary: "Table") -> None:
    env.add_table(primary)
    seen = {id(primary)}

    def walk(e):
        if isinstance(e, ColumnReference) and not isinstance(e.table, ThisPlaceholder):
            t = e.table
            if id(t) not in seen and isinstance(t, Table):
                seen.add(id(t))
                env.add_table(t)
        for d in getattr(e, "_deps", ()):
            walk(d)

    for e in exprs.values():
        walk(e)


def _common_schema(tables: list["Table"]) -> SchemaMetaclass:
    names = tables[0].column_names()
    for t in tables[1:]:
        if set(t.column_names()) != set(names):
            raise ValueError(
                f"tables have different columns: {names} vs {t.column_names()}"
            )
    cols = {}
    for n in names:
        dts = [t._schema.columns()[n].dtype for t in tables]
        cols[n] = ColumnSchema(name=n, dtype=dt.types_lca_many(dts))
    return schema_from_columns(cols, name="Concat")


# free functions mirroring the reference's module-level API


def groupby(table: Table, *args, **kwargs):
    return table.groupby(*args, **kwargs)


def join(left: Table, right: Table, *on, **kwargs):
    return left.join(right, *on, **kwargs)


def join_inner(left: Table, right: Table, *on, **kwargs):
    return left.join_inner(right, *on, **kwargs)


def join_left(left: Table, right: Table, *on, **kwargs):
    return left.join_left(right, *on, **kwargs)


def join_right(left: Table, right: Table, *on, **kwargs):
    return left.join_right(right, *on, **kwargs)


def join_outer(left: Table, right: Table, *on, **kwargs):
    return left.join_outer(right, *on, **kwargs)
