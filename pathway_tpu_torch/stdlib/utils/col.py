"""Column utilities (reference ``python/pathway/stdlib/utils/col.py``):
``unpack_col`` (:60), ``flatten_column`` (:16), ``apply_all_rows`` (:276),
``multiapply_all_rows`` (:211), ``groupby_reduce_majority`` (:326).

Copy of ``pathway_tpu/stdlib/utils/col.py``, over the port's Table API and engine nodes.
"""

from __future__ import annotations

from typing import Any, Callable

from ... import reducers
from ...internals import dtype as dt
from ...internals.expression import ColumnReference, apply_with_type
from ...internals.table import Table
from ...internals.thisclass import this

__all__ = [
    "unpack_col",
    "flatten_column",
    "apply_all_rows",
    "multiapply_all_rows",
    "groupby_reduce_majority",
]


def unpack_col(column: ColumnReference, *unpacked_columns: Any, schema: Any = None) -> Table:
    """Tuple column -> one column per element (reference col.py:60)."""
    if schema is not None:
        names = schema.column_names()
    else:
        names = [c if isinstance(c, str) else c.name for c in unpacked_columns]
    table = column.table
    return table.select(**{
        n: apply_with_type(lambda v, i=i: v[i], dt.ANY, column)
        for i, n in enumerate(names)
    })


def flatten_column(column: ColumnReference, origin_id: str | None = "origin_id") -> Table:
    """One row per element of an iterable column (reference col.py:16 —
    deprecated there in favor of Table.flatten, kept for parity)."""
    table = column.table
    if origin_id is None:
        return table.flatten(column)
    return table.flatten(column, origin_id=origin_id)


def multiapply_all_rows(
    *cols: ColumnReference,
    fun: Callable[..., tuple[list, ...]],
    result_col_names: list[str],
) -> Table:
    """Apply a function to ALL rows at once: ``fun(col1_values, ...)``
    returns one result list per output column, positionally aligned with
    the input rows (reference col.py:211). Runs as a global gather +
    per-row re-keying back onto the source universe."""
    table = cols[0].table
    gathered = table.reduce(
        __keys=reducers.tuple(table.id),
        **{f"__c{i}": reducers.tuple(c) for i, c in enumerate(cols)},
    )
    n = len(cols)

    def explode(keys, *col_lists):
        results = fun(*[list(c) for c in col_lists])
        return tuple(zip(keys, zip(*results)))

    exploded = gathered.select(
        __pairs=apply_with_type(
            explode, dt.ANY,
            this["__keys"], *[this[f"__c{i}"] for i in range(n)],
        )
    ).flatten(this["__pairs"])
    return exploded.select(
        __newkey=apply_with_type(lambda p: p[0], dt.POINTER, this["__pairs"]),
        **{
            name: apply_with_type(lambda p, i=i: p[1][i], dt.ANY, this["__pairs"])
            for i, name in enumerate(result_col_names)
        },
    ).with_id(this["__newkey"]).select(
        **{name: this[name] for name in result_col_names}
    )


def apply_all_rows(
    *cols: ColumnReference,
    fun: Callable[..., list],
    result_col_name: str,
) -> Table:
    """Like multiapply_all_rows with a single result column
    (reference col.py:276)."""
    return multiapply_all_rows(
        *cols, fun=lambda *a: (fun(*a),), result_col_names=[result_col_name]
    )


def groupby_reduce_majority(
    column_group: ColumnReference, column_val: ColumnReference
) -> Table:
    """Per group, the most frequent value (reference col.py:326)."""
    table = column_group.table
    counted = table.groupby(column_group, column_val).reduce(
        group=column_group, val=column_val, cnt=reducers.count()
    )
    ranked = counted.groupby(this.group).reduce(
        group=this.group,
        __ordered=reducers.tuple_by(-this.cnt, this.val),
    )
    return ranked.select(
        group=this.group,
        majority=apply_with_type(lambda t: t[0], dt.ANY, this["__ordered"]),
    )
