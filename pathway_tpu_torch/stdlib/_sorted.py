"""Shared sorted-group transform backing Table.sort (and, in the reference,
ordered.diff / statistical.interpolate; the reference implements these on the
prev-next pointer operator, ``src/engine/dataflow/operators/prev_next.rs:770``).

Copy of ``pathway_tpu/stdlib/_sorted.py``, on the port's ``GroupedRecompute``.

``sorted_group_transform`` groups rows (by optional instance), sorts each
group by an order expression, and lets a host function emit one output row
per input row — keyed by the input row's key, so the result shares the
source universe and composes with ``with_columns`` / ``+``.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np

from ..engine import keys as K
from ..internals import dtype as dt
from ..internals.expression import ColumnExpression
from ..internals.parse_graph import Universe
from ..internals.schema import ColumnSchema, schema_from_columns
from ..internals.table import Table


def sorted_group_transform(
    table: Table,
    order_expr: ColumnExpression,
    payload_exprs: list[ColumnExpression],
    instance_expr: ColumnExpression | None,
    out_cols: dict[str, dt.DType],
    fn: Callable[[list[tuple[int, Any, tuple]]], list[tuple[int, tuple]]],
) -> Table:
    """fn receives [(row_key, order_value, payload_tuple)] sorted by
    (order_value, row_key) and returns [(row_key, out_row_tuple)]."""
    from ..engine import operators as ops
    from ..internals.expression_compiler import compile_expr

    out_names = list(out_cols.keys())
    schema = schema_from_columns(
        {n: ColumnSchema(name=n, dtype=t) for n, t in out_cols.items()},
        name="SortedTransform",
    )

    def lower(runner, tbl):
        exprs = {"__o": order_expr}
        for i, p in enumerate(payload_exprs):
            exprs[f"__p{i}"] = p
        if instance_expr is not None:
            exprs["__i"] = instance_expr
        node, env = runner._zip_env(table, exprs)
        rw = {}
        rw["__o"] = compile_expr(order_expr, env).fn
        for i, p in enumerate(payload_exprs):
            rw[f"__p{i}"] = compile_expr(p, env).fn
        if instance_expr is not None:
            inst_fn = compile_expr(instance_expr, env).fn

            def g_fn(cols_, keys_, f=inst_fn):
                from ..internals.expression_compiler import _materialize

                vals = np.asarray(_materialize(f(cols_, keys_), len(keys_)))
                return K.mix_columns([vals], len(keys_))

            rw["__g"] = g_fn
        pre = runner._add(ops.Rowwise(node, rw))
        n_payload = len(payload_exprs)

        def compute(gk, rows, time):
            entries = sorted(
                (
                    (rk, row[0], tuple(row[1 : 1 + n_payload]))
                    for rk, row in rows.items()
                ),
                key=lambda e: (e[1], e[0]),
            )
            return fn(entries)

        gr = runner._add(ops.GroupedRecompute(
            [pre], ["__g" if instance_expr is not None else None], out_names, compute,
        ))
        return gr

    return Table(
        "custom", [table], {"lower": lower}, schema, table._universe
    )
