"""Legacy class-transformer API (``@pw.transformer``).

Re-design of ``python/pathway/internals/row_transformer.py`` (294 LoC,
``ClassArgMeta``/``ClassArg`` + attribute markers) and the ``shadows``
evaluation machinery over engine ``complex_columns``
(``src/engine/dataflow.rs`` legacy transformer columns). The reference
deprecates this API in favor of expressions; it is kept for parity.

Here every output class table lowers to ONE ``GroupedRecompute`` engine
node gathering the full current rows of all argument tables — computed
attributes then evaluate as plain Python with lazy per-row memoization,
which naturally supports the API's defining feature: pointer-chasing
across rows and tables (``self.transformer.nodes[ptr].val``) with
recursive attribute references. Not incremental within a tick (the whole
transformer recomputes when any input changes), matching the reference's
own guidance that transformers are for expressiveness, not speed.

Usage (reference ``tests/test_transformers.py``)::

    @pw.transformer
    class traversal:
        class nodes(pw.ClassArg):
            next = pw.input_attribute()
            val = pw.input_attribute()

        class requests(pw.ClassArg):
            node = pw.input_attribute()

            @pw.output_attribute
            def reached(self) -> int:
                return self.transformer.nodes[self.node].val

    out = traversal(nodes_table, requests_table).requests

Copy of ``pathway_tpu/internals/row_transformer.py``, over the port's Table API and engine nodes.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np

__all__ = [
    "ClassArg",
    "attribute",
    "input_attribute",
    "input_method",
    "method",
    "output_attribute",
    "transformer",
]


class _InputAttribute:
    def __init__(self) -> None:
        self.name: str | None = None


def input_attribute(type: Any = None) -> Any:  # noqa: A002 — reference name
    return _InputAttribute()


class _OutputAttribute:
    def __init__(self, fn: Callable, output_name: str | None = None):
        self.fn = fn
        self.output_name = output_name or fn.__name__
        self.name = fn.__name__


def output_attribute(fn: Callable | None = None, *, output_name: str | None = None):
    if fn is None:
        return lambda f: _OutputAttribute(f, output_name)
    return _OutputAttribute(fn, output_name)


class _Attribute:
    """Computed, memoized, NOT exported (reference ``attribute``)."""

    def __init__(self, fn: Callable):
        self.fn = fn
        self.name = fn.__name__


def attribute(fn: Callable) -> _Attribute:
    return _Attribute(fn)


def method(fn: Callable | None = None, **kwargs: Any):
    raise NotImplementedError(
        "@pw.method output columns are not supported; plain helper methods "
        "on the ClassArg work, and expressions/udfs cover exported callables"
    )


def input_method(type: Any = None) -> Any:
    raise NotImplementedError(
        "pw.input_method is not supported; pass data columns and call plain "
        "helper methods instead"
    )


class ClassArg:
    """Base for transformer argument classes. At evaluation time instances
    are per-row handles with lazy attribute resolution (reference
    ``ClassArg``, row_transformer.py:148)."""

    # populated per subclass by transformer()
    _pw_inputs: list[str]
    _pw_outputs: list[_OutputAttribute]
    _pw_attrs: dict[str, _Attribute]
    _pw_output_schema: Any = None

    def __init_subclass__(cls, output: Any = None, **kw: Any) -> None:
        super().__init_subclass__(**kw)
        cls._pw_output_schema = output


class _RowHandle:
    """One row of one class table during evaluation: input attributes read
    from the stored tuple, computed attributes evaluate lazily with
    memoization; ``self.transformer`` reaches the other tables."""

    __slots__ = ("_cls", "_ctx", "_key", "_row", "_cache")

    def __init__(self, cls, ctx, key, row):
        self._cls = cls
        self._ctx = ctx
        self._key = key
        self._row = row
        self._cache: dict[str, Any] = {}

    @property
    def id(self):
        return np.uint64(self._key)

    @property
    def transformer(self):
        return self._ctx

    def pointer_from(self, *args):
        from ..engine import keys as K

        return K.hash_values([tuple(args)])[0]

    def __getattr__(self, name: str):
        cls = object.__getattribute__(self, "_cls")
        cache = object.__getattribute__(self, "_cache")
        if name in cache:
            return cache[name]
        if name in cls._pw_inputs:
            v = self._row[cls._pw_inputs.index(name)]
            cache[name] = v
            return v
        for out in cls._pw_outputs:
            if out.name == name:
                v = out.fn(self)
                cache[name] = v
                return v
        if name in cls._pw_attrs:
            v = cls._pw_attrs[name].fn(self)
            cache[name] = v
            return v
        # plain helpers / class constants / staticmethods resolve on the
        # class; methods bind to this handle as `self`
        attr = getattr(cls, name)
        if callable(attr) and not isinstance(attr, type):
            import types

            if isinstance(
                inspect_getattr_static(cls, name), staticmethod
            ):
                return attr
            return types.MethodType(attr, self)
        return attr


def inspect_getattr_static(cls, name):
    import inspect

    return inspect.getattr_static(cls, name)


class _EvalContext:
    """``self.transformer`` — class-name → table accessor over the gathered
    row dicts of the current tick."""

    def __init__(self, classes: dict[str, type], rows: dict[str, dict]):
        self._classes = classes
        self._rows = rows
        self._handles: dict[tuple[str, int], _RowHandle] = {}

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        if name not in self._classes:
            raise AttributeError(f"transformer has no table {name!r}")
        return _TableAccessor(self, name)

    def handle(self, tab: str, key: int) -> _RowHandle:
        key = int(key)
        hk = (tab, key)
        h = self._handles.get(hk)
        if h is None:
            row = self._rows[tab].get(key)
            if row is None:
                # a KeyError; the engine holds it until the stream ends, since under the async
                # plane the row may yet arrive (the reference raises at once: ROADMAP, Queue 3)
                from ..engine.operators import DanglingPointerError

                raise DanglingPointerError(
                    f"no row {key} in transformer table {tab!r}"
                )
            h = _RowHandle(self._classes[tab], self, key, row)
            self._handles[hk] = h
        return h


class _TableAccessor:
    __slots__ = ("_ctx", "_tab")

    def __init__(self, ctx: _EvalContext, tab: str):
        self._ctx = ctx
        self._tab = tab

    def __getitem__(self, key) -> _RowHandle:
        return self._ctx.handle(self._tab, int(key))


class _TransformerResult:
    def __init__(self, tables: dict[str, Any], input_only: set[str]):
        self._tables = tables
        self._input_only = input_only

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        try:
            return self._tables[name]
        except KeyError:
            if name in self._input_only:
                raise AttributeError(
                    f"transformer class {name!r} has no output attributes, "
                    "so it produces no result table"
                ) from None
            raise AttributeError(name) from None

    def __getitem__(self, name: str):
        return getattr(self, name)


class Transformer:
    def __init__(self, cls: type):
        self._name = cls.__name__
        self._classes: dict[str, type] = {}
        for name, member in vars(cls).items():
            if isinstance(member, type) and issubclass(member, ClassArg):
                member._pw_inputs = [
                    n for n, v in vars(member).items()
                    if isinstance(v, _InputAttribute)
                ]
                member._pw_outputs = [
                    v for v in vars(member).values()
                    if isinstance(v, _OutputAttribute)
                ]
                member._pw_attrs = {
                    n: v for n, v in vars(member).items()
                    if isinstance(v, _Attribute)
                }
                self._classes[name] = member

    def __call__(self, *tables, **named):
        from .table import Table
        from .schema import ColumnSchema, schema_from_columns
        from . import dtype as dt
        from ..engine import operators as ops

        names = list(self._classes)
        if len(tables) > len(names):
            raise TypeError(
                f"transformer {self._name} takes {len(names)} table(s), "
                f"got {len(tables)} positional"
            )
        unknown = sorted(set(named) - set(names))
        if unknown:
            raise TypeError(
                f"transformer {self._name} has no table(s) named {unknown}"
            )
        bound: dict[str, Table] = dict(zip(names, tables))
        double = sorted(set(bound) & set(named))
        if double:
            raise TypeError(
                f"transformer {self._name}: table(s) {double} passed both "
                "positionally and by name"
            )
        bound.update(named)
        missing = [n for n in names if n not in bound]
        if missing:
            raise TypeError(
                f"transformer {self._name} missing table(s): {missing}"
            )
        classes = self._classes

        # input projections built ONCE: the runner caches lowered nodes by
        # Table object, so multiple output classes share the input nodes
        # (each output's GroupedRecompute still gathers its own state copy
        # — acceptable for a deprecated expressiveness-oriented API)
        projections = {
            n: bound[n].select(**{
                c: getattr(bound[n], c) for c in classes[n]._pw_inputs
            })
            for n in names
        }

        out_tables: dict[str, Table] = {}
        for out_name, out_cls in classes.items():
            outputs = out_cls._pw_outputs
            if not outputs:
                continue
            declared = out_cls._pw_output_schema
            cols = {}
            for o in outputs:
                dtype = dt.ANY
                if declared is not None and o.output_name in declared.column_names():
                    dtype = declared.dtypes()[o.output_name]
                cols[o.output_name] = ColumnSchema(name=o.output_name, dtype=dtype)
            schema = schema_from_columns(cols, name=f"{self._name}_{out_name}")

            def make_lower(out_name=out_name, out_cls=out_cls, outputs=outputs):
                def lower(runner, tbl):
                    in_nodes = [runner.lower(projections[n]) for n in names]

                    def compute(gk, *rows_and_time):
                        *rows_per_tab, time = rows_and_time
                        rows = {
                            n: tab_rows
                            for n, tab_rows in zip(names, rows_per_tab)
                        }
                        ctx = _EvalContext(classes, rows)
                        out = []
                        for key in rows[out_name]:
                            h = ctx.handle(out_name, key)
                            out.append(
                                (key, tuple(
                                    getattr(h, o.name) for o in outputs
                                ))
                            )
                        return out

                    return runner._add(ops.GroupedRecompute(
                        in_nodes, [None] * len(in_nodes),
                        [o.output_name for o in outputs], compute,
                    ))
                return lower

            out_tables[out_name] = Table(
                "custom", [bound[n] for n in names],
                {"lower": make_lower()}, schema,
                bound[out_name]._universe,
            )
        return _TransformerResult(
            out_tables,
            {n for n, c in classes.items() if not c._pw_outputs},
        )


def transformer(cls: type) -> Transformer:
    """Class-transformer decorator (reference row_transformer.py)."""
    return Transformer(cls)
