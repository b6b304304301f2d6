"""Graph / WeightedGraph with clustering contraction.

Re-design of reference ``stdlib/graphs/graph.py:77-150``: a Graph is a pair
of tables (V, E); contracting by a ``Clustering`` relabels edge endpoints to
their cluster pointer and makes clusters the new vertex set. All operations
are incremental Table ops (relabeling is two key-joins; dedup/weight merge is
a groupby), each an engine operator.

Copy of ``pathway_tpu/stdlib/graphs/graph.py``, over the port's Table API and engine nodes.
"""

from __future__ import annotations

from dataclasses import dataclass

from ...internals.table import Table
from ...internals.thisclass import this
from ... import reducers
from .common import Clustering  # noqa: F401 (re-exported concept)


def _extended_to_full_clustering(
    vertices: Table, clustering: Table
) -> Table:
    """Every vertex gets a cluster: its assigned one, or itself as a
    singleton cluster (reference ``graph.py:61``)."""
    own = vertices.select(c=vertices.id)
    # a Clustering is keyed by vertices by contract (reference common.py)
    sub = clustering.select(clustering.c).promise_universe_is_subset_of(own)
    return own.update_cells(sub)


def _relabel_edges(edges: Table, full_clustering: Table) -> Table:
    return edges.select(
        u=full_clustering.ix(edges.u).c,
        v=full_clustering.ix(edges.v).c,
    )


def _cluster_vertices(full_clustering: Table) -> Table:
    return full_clustering.groupby(id=full_clustering.c).reduce()


@dataclass
class Graph:
    """Undirected, unweighted (multi)graph."""

    V: Table
    E: Table

    def contracted_to_multi_graph(self, clustering: Table) -> "Graph":
        full = _extended_to_full_clustering(self.V, clustering)
        return Graph(V=_cluster_vertices(full), E=_relabel_edges(self.E, full))

    def contracted_to_unweighted_simple_graph(
        self, clustering: Table, **reducer_expressions
    ) -> "Graph":
        g = self.contracted_to_multi_graph(clustering)
        simple = g.E.groupby(g.E.u, g.E.v).reduce(g.E.u, g.E.v)
        return Graph(V=g.V, E=simple)

    def contracted_to_weighted_simple_graph(
        self, clustering: Table, **reducer_expressions
    ) -> "WeightedGraph":
        g = self.contracted_to_multi_graph(clustering)
        we = g.E.groupby(g.E.u, g.E.v).reduce(g.E.u, g.E.v, **reducer_expressions)
        return WeightedGraph.from_vertices_and_weighted_edges(g.V, we)

    def without_self_loops(self) -> "Graph":
        return Graph(V=self.V, E=self.E.filter(this.u != this.v))


@dataclass
class WeightedGraph(Graph):
    """Graph whose edges carry weights (``WE``: u, v, weight)."""

    WE: Table = None  # type: ignore[assignment]

    @staticmethod
    def from_vertices_and_weighted_edges(V: Table, WE: Table) -> "WeightedGraph":
        return WeightedGraph(V=V, E=WE, WE=WE)

    def contracted_to_multi_graph(self, clustering: Table) -> "WeightedGraph":
        full = _extended_to_full_clustering(self.V, clustering)
        we = self.WE.select(
            u=full.ix(this.u).c,
            v=full.ix(this.v).c,
            weight=this.weight,
        )
        return WeightedGraph(V=_cluster_vertices(full), E=we, WE=we)

    def contracted_to_weighted_simple_graph(
        self, clustering: Table, **reducer_expressions
    ) -> "WeightedGraph":
        g = self.contracted_to_multi_graph(clustering)
        if not reducer_expressions:
            reducer_expressions = {"weight": reducers.sum(g.WE.weight)}
        we = g.WE.groupby(g.WE.u, g.WE.v).reduce(
            g.WE.u, g.WE.v, **reducer_expressions
        )
        return WeightedGraph.from_vertices_and_weighted_edges(g.V, we)

    def without_self_loops(self) -> "WeightedGraph":
        return WeightedGraph.from_vertices_and_weighted_edges(
            self.V, self.WE.filter(this.u != this.v)
        )
