"""``pw.universes`` — key-set (universe) promises (reference
``python/pathway/internals/universes.py``: ``promise_is_subset_of``,
``promise_are_equal``, ``promise_are_pairwise_disjoint``). Promises feed
the universe solver consulted when columns of different tables are mixed.

Copy of ``pathway_tpu/universes.py``, over the port's Table API and engine nodes.
"""

from __future__ import annotations

from .internals.parse_graph import G
from .internals.table import Table

__all__ = [
    "promise_is_subset_of",
    "promise_are_equal",
    "promise_are_pairwise_disjoint",
]


def promise_is_subset_of(subset: Table, superset: Table) -> Table:
    G.promise_subset(subset._universe, superset._universe)
    return subset


def promise_are_equal(*tables: Table) -> None:
    for other in tables[1:]:
        G.promise_equal(tables[0]._universe, other._universe)


def promise_are_pairwise_disjoint(*tables: Table) -> None:
    """Disjointness lets ``concat`` keep original keys safely. The promise
    feeds the universe solver (consulted by Table.concat at build time);
    the engine additionally errors at runtime if colliding keys show up
    (reference `_concat` + engine key-uniqueness check)."""
    G.promise_disjoint(*[t._universe for t in tables])

