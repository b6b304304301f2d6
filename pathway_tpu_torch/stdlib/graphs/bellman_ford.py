"""Bellman–Ford shortest paths over ``pw.iterate``.

Same API as reference ``stdlib/graphs/bellman_ford/impl.py:14-52``
(``Vertex{is_source}``, ``Dist{dist}``, ``DistFromSource{dist_from_source}``,
``bellman_ford(vertices, edges)``); the relaxation step is expressed as one
key-join plus one segment-min per round, and
the fixpoint is driven by the engine's Iterate node.

Copy of ``pathway_tpu/stdlib/graphs/bellman_ford.py``, over the port's Table API and engine nodes.
"""

from __future__ import annotations

import math

from ...internals.expression import coalesce, if_else
from ...internals.iterate import iterate
from ...internals.schema import Schema
from ...internals.table import Table
from ... import reducers


class Vertex(Schema):
    is_source: bool


class Dist(Schema):
    dist: float


class DistFromSource(Schema):
    dist_from_source: float


def _relax(vertices_dist: Table, edges: Table) -> Table:
    # candidate distance for edge target v: dist(u) + len(u→v)
    candidates = edges.select(
        dist_from_source=vertices_dist.ix(edges.u).dist_from_source + edges.dist
    )
    best = candidates.groupby(id=edges.v).reduce(
        dist_from_source=reducers.min(candidates.dist_from_source)
    )
    improved = best.ix(vertices_dist.id, optional=True).dist_from_source
    return vertices_dist.select(
        dist_from_source=if_else(
            coalesce(improved, math.inf) < vertices_dist.dist_from_source,
            coalesce(improved, math.inf),
            vertices_dist.dist_from_source,
        )
    )


def bellman_ford(vertices: Table, edges: Table) -> Table:
    """Distances from the ``is_source`` vertices; unreachable = inf."""
    init = vertices.select(
        dist_from_source=if_else(vertices.is_source, 0.0, math.inf)
    )
    return iterate(_relax, vertices_dist=init, edges=edges)
