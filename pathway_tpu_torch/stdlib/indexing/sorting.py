"""Sortedness utilities (reference ``stdlib/indexing/sorting.py``).

The reference maintains sorted order with the prev-next pointer operator
(``src/engine/dataflow/operators/prev_next.rs:770``) and a distributed
treap for ``build_sorted_index``. Here sorted order per instance is computed
by the engine's grouped-recompute machinery (``stdlib/_sorted.py``) — a
host-side sort per group feeding pointer columns; chain walks
(``retrieve_prev_next_values``) recompute incrementally per tick.

Copy of ``pathway_tpu/stdlib/indexing/sorting.py``.
"""

from __future__ import annotations

from typing import Any, TypedDict

from ...internals import dtype as dt
from ...internals.expression import ColumnExpression, ColumnReference
from ...internals.table import Table
from ...internals.thisclass import this
from .._sorted import sorted_group_transform

__all__ = [
    "SortedIndex",
    "build_sorted_index",
    "sort_from_index",
    "retrieve_prev_next_values",
]


class SortedIndex(TypedDict):
    index: Table
    oriented_index: Table


def sort_from_index(
    table: Table,
    key: ColumnExpression | None = None,
    instance: ColumnExpression | None = None,
) -> Table:
    """``prev``/``next`` pointer columns ordering ``table`` by ``key``
    (reference sorting.py:137 / Table.sort table.py:2157)."""
    key_expr = table._sub(key) if key is not None else this.id
    key_expr = table._sub(key_expr)
    inst = table._sub(instance) if instance is not None else None

    def fn(entries):
        out = []
        n = len(entries)
        for i, (rk, _o, _p) in enumerate(entries):
            prev_k = entries[i - 1][0] if i > 0 else None
            next_k = entries[i + 1][0] if i < n - 1 else None
            out.append((rk, (prev_k, next_k)))
        return out

    return sorted_group_transform(
        table,
        key_expr,
        [],
        inst,
        {"prev": dt.Optional(dt.POINTER), "next": dt.Optional(dt.POINTER)},
        fn,
    )


def build_sorted_index(
    nodes: Table, key: ColumnExpression | None = None,
    instance: ColumnExpression | None = None,
) -> SortedIndex:
    """Reference sorting.py:92 — builds the sorted index structure. The
    treap internals are an implementation detail there; the public payload
    is the prev/next orientation, which is what this returns."""
    if key is None and "key" in nodes.column_names():
        key = nodes.key
    if instance is None and "instance" in nodes.column_names():
        instance = nodes.instance
    idx = nodes + sort_from_index(nodes, key, instance)
    return SortedIndex(index=idx, oriented_index=idx)


def retrieve_prev_next_values(
    ordered_table: Table, value: ColumnReference | None = None
) -> Table:
    """For each row of a prev/next-chained table: the nearest non-None
    ``value`` looking backward (``prev_value``) and forward (``next_value``)
    (reference sorting.py:195; backs ``statistical.interpolate``)."""
    from ...engine import operators as ops
    from ...internals.expression_compiler import compile_expr
    from ...internals.parse_graph import Universe
    from ...internals.schema import ColumnSchema, schema_from_columns

    if value is None:
        value = ordered_table.value
    value_expr = ordered_table._sub(value)
    val_dt = dt.Optional(dt.ANY)
    schema = schema_from_columns(
        {
            "prev_value": ColumnSchema(name="prev_value", dtype=val_dt),
            "next_value": ColumnSchema(name="next_value", dtype=val_dt),
        },
        name="PrevNextValues",
    )

    def lower(runner, tbl):
        exprs = {
            "__prev": ordered_table._sub(this.prev),
            "__next": ordered_table._sub(this.next),
            "__val": value_expr,
        }
        node, env = runner._zip_env(ordered_table, exprs)
        rw = {n: compile_expr(e, env).fn for n, e in exprs.items()}
        pre = runner._add(ops.Rowwise(node, rw))

        def compute(gk, rows, time):
            # rows: rk -> (prev, next, val); walk chains to nearest non-None
            def walk(rk, port):
                seen = set()
                cur = rows.get(rk)
                cur = cur[port] if cur else None
                while cur is not None and cur not in seen:
                    seen.add(cur)
                    row = rows.get(int(cur))
                    if row is None:
                        return None
                    if row[2] is not None:
                        return row[2]
                    cur = row[port]
                return None

            return [(rk, (walk(rk, 0), walk(rk, 1))) for rk in rows]

        return runner._add(
            ops.GroupedRecompute(
                [pre], [None], ["prev_value", "next_value"], compute
            )
        )

    return Table(
        "custom", [ordered_table], {"lower": lower}, schema, ordered_table._universe
    )
