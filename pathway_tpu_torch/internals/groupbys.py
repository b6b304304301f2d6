"""GroupedTable — groupby().reduce() plumbing.

Re-design of ``python/pathway/internals/groupbys.py``. The reduce() call
rewrites its output expressions: reducer sub-expressions become hidden
reduced columns, grouping-column references become group-key columns; the
actual incremental reduction happens in the engine's GroupByReduce operator
(reference: ``Graph::group_by_table`` graph.rs:885 + reduce.rs).
"""

from __future__ import annotations

import copy
from typing import Any

from . import dtype as dt
from .expression import (
    ColumnExpression,
    ColumnReference,
    HiddenRef,
    IdReference,
    ReducerExpression,
    smart_coerce,
)
from .parse_graph import Universe
from .schema import ColumnSchema, schema_from_columns
from .thisclass import substitute, this


class GroupedTable:
    def __init__(
        self,
        table,
        grouping: list[ColumnExpression],
        instance: ColumnExpression | None = None,
        by_id: bool = False,
        skip_errors: bool = True,
    ):
        self._table = table
        self._grouping = grouping
        self._instance = instance
        self._by_id = by_id
        #: reference groupby(_skip_errors=True) default: value reducers
        #: ignore Error cells; False = the aggregate reads Error until
        #: the error row retracts (reduce.rs error_count)
        self._skip_errors = skip_errors
        # map grouping expr by (reference identity) so reduce() args can refer to them
        self._group_names: dict[str, int] = {}
        for i, g in enumerate(grouping):
            if isinstance(g, ColumnReference):
                self._group_names[g.name] = i

    def reduce(self, *args: Any, **kwargs: Any):
        from .table import Table

        table = self._table
        outputs: dict[str, ColumnExpression] = {}
        for arg in args:
            if isinstance(arg, str):
                raise ValueError(
                    f"Expected a ColumnReference, found a string. Did you "
                    f"mean this.{arg} instead of {arg!r}?"
                )
            arg = substitute(smart_coerce(arg), {this: table})
            if not isinstance(arg, ColumnReference):
                raise ValueError(
                    "In reduce() all positional arguments have to be a "
                    "ColumnReference."
                )
            outputs[arg.name] = arg
        for name, e in kwargs.items():
            outputs[name] = substitute(smart_coerce(e), {this: table})

        # collect reducers from output expressions; replace with hidden refs
        reducers: list[tuple[str, str, list[ColumnExpression], dict]] = []
        hidden_refs: list[HiddenRef] = []

        def extract(expr: ColumnExpression) -> ColumnExpression:
            if isinstance(expr, ReducerExpression):
                name = expr._reducer
                if name == "avg":
                    s = extract(ReducerExpression("sum", expr._args))
                    c = extract(ReducerExpression("count", ()))
                    return s / c
                idx = len(reducers)
                out_name = f"__r{idx}"
                args_exprs = [substitute(a, {this: self._table}) for a in expr._args]
                if name in ("min", "max", "sum", "unique", "any", "sorted_tuple", "tuple", "ndarray", "argmin", "argmax", "earliest", "latest") and not args_exprs:
                    raise ValueError(f"reducer {name} needs an argument")
                reducers.append((out_name, name, args_exprs, dict(expr._kwargs)))
                ref = HiddenRef(out_name)
                hidden_refs.append(ref)
                return ref
            if not getattr(expr, "_deps", ()):
                return expr
            clone = copy.copy(expr)
            for attr, value in list(vars(clone).items()):
                if isinstance(value, ColumnExpression):
                    setattr(clone, attr, extract(value))
                elif isinstance(value, tuple) and any(isinstance(v, ColumnExpression) for v in value):
                    setattr(clone, attr, tuple(
                        extract(v) if isinstance(v, ColumnExpression) else v for v in value
                    ))
            return clone

        rewritten = {name: extract(e) for name, e in outputs.items()}

        grouping = list(self._grouping)
        if self._instance is not None:
            grouping = grouping + [self._instance]

        return Table(
            "groupby_reduce",
            [self._table],
            {
                "grouping": grouping,
                "by_id": self._by_id,
                "reducers": reducers,
                "outputs": rewritten,
                "group_names": dict(self._group_names),
                "skip_errors": self._skip_errors,
            },
            _infer_reduce_schema(self._table, grouping, self._group_names, reducers, rewritten),
            Universe(),
        )


def _infer_reduce_schema(table, grouping, group_names, reducers, outputs):
    from .expression_compiler import ColumnEnv, infer_dtype
    from .table import _add_reachable_tables

    env = ColumnEnv()
    reach: dict[str, Any] = {f"g{i}": g for i, g in enumerate(grouping)}
    for out_name, _rname, rargs, _rkwargs in reducers:
        for j, a in enumerate(rargs):
            reach[f"{out_name}.{j}"] = a
    _add_reachable_tables(env, reach, table)

    reducer_dts: dict[str, dt.DType] = {}
    for out_name, rname, rargs, rkwargs in reducers:
        arg_ts = [infer_dtype(a, env) for a in rargs]
        reducer_dts[out_name] = _reducer_out_dtype(rname, arg_ts)

    def fill_hidden(e):
        if isinstance(e, HiddenRef):
            e._dtype = reducer_dts[e._engine_name]
        for d in getattr(e, "_deps", ()):
            fill_hidden(d)

    cols = {}
    for name, e in outputs.items():
        fill_hidden(e)
        try:
            d = infer_dtype(e, env)
        except Exception:
            d = dt.ANY
        cols[name] = ColumnSchema(name=name, dtype=d)
    return schema_from_columns(cols, name="Reduced")


def _reducer_out_dtype(name: str, arg_ts: list[dt.DType]) -> dt.DType:
    if name == "count":
        return dt.INT
    if name in ("sum", "min", "max", "unique", "any", "earliest", "latest"):
        return arg_ts[0] if arg_ts else dt.ANY
    if name in ("argmin", "argmax"):
        return dt.POINTER
    if name in ("sorted_tuple", "tuple"):
        return dt.List(arg_ts[0] if arg_ts else dt.ANY)
    if name == "tuple_by":
        return dt.List(arg_ts[1] if len(arg_ts) > 1 else dt.ANY)
    if name == "ndarray":
        return dt.Array(1, arg_ts[0] if arg_ts else dt.FLOAT)
    if name == "stateful":
        return dt.ANY
    return dt.ANY


