"""Global parse graph: every Table operation appends a node.

Re-design of ``python/pathway/internals/parse_graph.py:104-247`` +
``operator.py:84-444``. Here the graph is held directly by ``Table`` objects
(kind + inputs + params); the global ``G`` tracks sinks, static-table
content cache (shared universes for identical definitions — what makes
id-sensitive table equality asserts work, cf. reference
``debug/__init__.py:396-403``) and universe equivalences.

Copy of ``pathway_tpu/internals/parse_graph.py`` without the lint mode's
source-location breadcrumbs on sinks.
"""

from __future__ import annotations

from typing import Any

__all__ = ["G", "ParseGraph", "Universe"]


class Universe:
    """A key-set identity (reference ``internals/universe.py``). Relations
    (parent subset links, promises, intersection/difference registrations)
    feed the propositional universe solver
    (``internals/universe_solver.py``, mirroring the reference's SAT-based
    ``universe_solver.py``); queries delegate to it."""

    _ids = 0

    def __init__(self, parent: "Universe | None" = None):
        Universe._ids += 1
        self.uid = Universe._ids
        self.parent = parent  # self ⊆ parent
        if parent is not None:
            G.solver.register_as_subset(self, parent)

    def is_equal(self, other: "Universe") -> bool:
        return self is other or G.solver.query_are_equal(self, other)

    def is_subset_of(self, other: "Universe") -> bool:
        return self is other or G.solver.query_is_subset(self, other)

    def is_disjoint_from(self, other: "Universe") -> bool:
        return self is not other and G.solver.query_are_disjoint(self, other)


class ParseGraph:
    def __init__(self) -> None:
        from .universe_solver import UniverseSolver

        self.sinks: list[Any] = []  # sink Tables / subscribe nodes
        self.static_tables_cache: dict[Any, Any] = {}
        self.solver = UniverseSolver()
        self.error_log: list[Any] = []

    def clear(self) -> None:
        self.__init__()

    def promise_equal(self, a: Universe, b: Universe) -> None:
        self.solver.register_as_equal(a, b, promised=True)

    def promise_subset(self, sub: Universe, sup: Universe) -> None:
        self.solver.register_as_subset(sub, sup, promised=True)

    def promise_disjoint(self, *universes: Universe) -> None:
        self.solver.register_as_disjoint(*universes, promised=True)

    def add_sink(self, sink: Any) -> None:
        self.sinks.append(sink)


G = ParseGraph()
