"""``pw.graphs`` — graph schemas + algorithms (reference
``stdlib/graphs/``): Graph/WeightedGraph with clustering contraction,
Bellman–Ford, PageRank, Louvain communities. Iterative algorithms ride
``pw.iterate`` (a host-driven fixpoint, each round a fresh inner run of the engine).

Copy of ``pathway_tpu/stdlib/graphs/__init__.py``, over the port's Table API and engine nodes.
"""

from __future__ import annotations

from . import bellman_ford, louvain_communities, pagerank
from .common import Cluster, Clustering, Edge, Vertex, Weight
from .graph import Graph, WeightedGraph

__all__ = [
    "bellman_ford",
    "pagerank",
    "louvain_communities",
    "Edge",
    "Graph",
    "Vertex",
    "Weight",
    "Cluster",
    "Clustering",
    "WeightedGraph",
]
