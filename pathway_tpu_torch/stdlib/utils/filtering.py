"""Row filters (reference ``python/pathway/stdlib/utils/filtering.py``):
``argmax_rows`` (:8) / ``argmin_rows`` (:20) — keep, per group, the row
extremizing a column.

Copy of ``pathway_tpu/stdlib/utils/filtering.py``, over the port's Table API and engine nodes.
"""

from __future__ import annotations

from ... import reducers
from ...internals.expression import ColumnReference
from ...internals.table import Table
from ...internals.thisclass import this

__all__ = ["argmax_rows", "argmin_rows"]


def _extreme_rows(table: Table, *on: ColumnReference, what: ColumnReference, reducer) -> Table:
    winners = (
        table.groupby(*on)
        .reduce(__winner=reducer(what))
        .with_id(this["__winner"])
    )
    # argmax/argmin values are keys of `table` by construction — promised,
    # since the solver cannot prove it across the reindex
    return table.restrict(winners.promise_universe_is_subset_of(table))


def argmax_rows(table: Table, *on: ColumnReference, what: ColumnReference) -> Table:
    return _extreme_rows(table, *on, what=what, reducer=reducers.argmax)


def argmin_rows(table: Table, *on: ColumnReference, what: ColumnReference) -> Table:
    return _extreme_rows(table, *on, what=what, reducer=reducers.argmin)
