"""Shared graph schemas (reference ``stdlib/graphs/common.py``).

Copy of ``pathway_tpu/stdlib/graphs/common.py``, over the port's Table API and engine nodes.
"""

from __future__ import annotations

from typing import Any

from ...internals import dtype as dt
from ...internals.schema import Schema


class Vertex(Schema):
    pass


class Edge(Schema):
    """Directed edge: pointers to the endpoint vertices."""

    u: dt.Pointer[Any]
    v: dt.Pointer[Any]


class Weight(Schema):
    """Weight extension for vertices / edges."""

    weight: float


class Cluster(Vertex):
    pass


class Clustering(Schema):
    """Cluster membership: vertex (row id) belongs to cluster ``c``."""

    c: dt.Pointer[Any]
