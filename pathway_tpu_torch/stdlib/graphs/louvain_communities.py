"""Louvain community detection.

Counterpart of reference ``stdlib/graphs/louvain_communities/impl.py``
(`_louvain_level`, `louvain_communities_fixed_iterations`,
`exact_modularity`). The local-move phase is irregular, data-dependent
control flow — a poor fit for per-step dataflow kernels — so one Louvain
level runs as a *host-recomputed* operator (engine Iterate node with a
single-round driver): on any change of the weighted edge table the whole
level is recomputed vectorized in numpy and diffed against the previous
clustering. ``exact_modularity`` is fully declarative (joins + segment
sums).

Copy of ``pathway_tpu/stdlib/graphs/louvain_communities.py``, over the port's Table API and engine nodes.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from ...internals import dtype as dt
from ...internals.parse_graph import Universe
from ...internals.schema import schema_from_types
from ...internals.table import Table
from ...internals.thisclass import this
from ... import reducers
from .graph import WeightedGraph


def _louvain_level_numpy(
    us: np.ndarray, vs: np.ndarray, ws: np.ndarray
) -> dict[int, int]:
    """One Louvain level: greedy modularity local moves until stable.
    Deterministic (vertices scanned in sorted key order)."""
    verts = np.unique(np.concatenate([us, vs]))
    index = {int(k): i for i, k in enumerate(verts)}
    n = len(verts)
    ui = np.array([index[int(k)] for k in us], dtype=np.int64)
    vi = np.array([index[int(k)] for k in vs], dtype=np.int64)
    w = ws.astype(np.float64)

    # undirected: accumulate both directions; self-loops count once
    deg = np.zeros(n)
    np.add.at(deg, ui, w)
    np.add.at(deg, vi, w)
    total = w.sum()
    if total <= 0:
        return {int(k): int(k) for k in verts}

    # adjacency in CSR-ish dict form (host side; n is the number of
    # *vertices*, typically ≪ rows of the stream)
    nbrs: list[dict[int, float]] = [dict() for _ in range(n)]
    for a, b, x in zip(ui, vi, w):
        a, b = int(a), int(b)
        if a == b:
            continue
        nbrs[a][b] = nbrs[a].get(b, 0.0) + float(x)
        nbrs[b][a] = nbrs[b].get(a, 0.0) + float(x)

    comm = np.arange(n)
    comm_deg = deg.copy()
    two_m = 2.0 * total
    improved = True
    rounds = 0
    while improved and rounds < 64:
        improved = False
        rounds += 1
        for i in range(n):
            ci = comm[i]
            # weights from i to each neighboring community
            to_comm: dict[int, float] = {}
            for j, x in nbrs[i].items():
                to_comm[comm[j]] = to_comm.get(comm[j], 0.0) + x
            comm_deg[ci] -= deg[i]
            best_c, best_gain = ci, to_comm.get(ci, 0.0) - comm_deg[ci] * deg[i] / two_m
            for c, k_in in to_comm.items():
                gain = k_in - comm_deg[c] * deg[i] / two_m
                if gain > best_gain + 1e-12 or (
                    abs(gain - best_gain) <= 1e-12 and c < best_c
                ):
                    best_c, best_gain = c, gain
            comm[i] = best_c
            comm_deg[best_c] += deg[i]
            if best_c != ci:
                improved = True

    # canonical cluster representative: smallest vertex key in the community
    rep: dict[int, int] = {}
    for i in range(n):
        c = int(comm[i])
        k = int(verts[i])
        if c not in rep or k < rep[c]:
            rep[c] = k
    return {int(verts[i]): rep[int(comm[i])] for i in range(n)}


class _LouvainDriver:
    """Single-round driver for the engine Iterate node: full recompute of
    one Louvain level on every change of the weighted edge table."""

    def __call__(
        self, snapshots: dict[str, dict[int, tuple]]
    ) -> dict[str, dict[int, tuple]]:
        rows = list(snapshots["edges"].values())
        if not rows:
            return {"clustering": {}}
        us = np.array([int(r[0]) for r in rows], dtype=np.uint64)
        vs = np.array([int(r[1]) for r in rows], dtype=np.uint64)
        ws = np.array([float(r[2]) for r in rows])
        assignment = _louvain_level_numpy(us, vs, ws)
        return {
            "clustering": {
                np.uint64(k).item(): (np.uint64(c).item(),)
                for k, c in assignment.items()
            }
        }


def _louvain_level(G: WeightedGraph) -> Table:
    """One level of Louvain: Clustering table keyed by vertex pointer with
    column ``c`` = cluster pointer."""
    from ...engine.iterate import Iterate, IterateOutput

    edges = G.WE.select(u=this.u, v=this.v, weight=this.weight)
    driver = _LouvainDriver()
    schema = schema_from_types(c=dt.Pointer)

    def lower(runner, _table):
        node = runner._add(
            Iterate(
                [runner._project(runner.lower(edges), edges, ["u", "v", "weight"])],
                ["edges"],
                driver,
                {"clustering": ["c"]},
            )
        )
        return runner._add(IterateOutput(node, "clustering"))

    return Table("custom", [edges], {"lower": lower}, schema, Universe())


louvain_level = _louvain_level


def louvain_communities(G: WeightedGraph, levels: int = 1) -> Table:
    """Hierarchical Louvain: repeatedly cluster and contract ``levels``
    times; returns the flattened Clustering of original vertices."""
    clustering = _louvain_level(G)
    for _ in range(levels - 1):
        G = G.contracted_to_weighted_simple_graph(clustering)
        higher = _louvain_level(G)
        # compose: vertex -> cluster -> higher cluster
        clustering = clustering.select(
            c=higher.ix(clustering.c, optional=True).c
        ).select(c=_coalesce_ptr(this.c, clustering.c))
    return clustering


def _coalesce_ptr(a, b):
    from ...internals.expression import coalesce

    return coalesce(a, b)


def exact_modularity(G: WeightedGraph, C: Table, round_digits: int = 16) -> Table:
    """Modularity Q of clustering ``C`` on graph ``G`` (reference
    ``impl.py:340``): sum over clusters of within-weight/total minus
    (degree/2·total)²; computed with joins + segment sums."""
    edges = G.WE
    labeled = edges.select(
        cu=C.ix(edges.u).c,
        cv=C.ix(edges.v).c,
        weight=edges.weight,
    )
    total = labeled.groupby().reduce(m=reducers.sum(labeled.weight))

    internal = labeled.filter(this.cu == this.cv)
    per_cluster_internal = internal.groupby(id=internal.cu).reduce(
        internal_w=reducers.sum(internal.weight)
    )
    # degree of a cluster: sum of weights of edges incident to it
    half_u = labeled.select(c=this.cu, w=this.weight)
    half_v = labeled.select(c=this.cv, w=this.weight)
    halves = half_u.concat_reindex(half_v)
    per_cluster_deg = halves.groupby(id=halves.c).reduce(
        degree=reducers.sum(halves.w)
    )
    from ...internals.expression import apply_with_type, coalesce

    m = total.ix(total.pointer_from(), context=per_cluster_deg).m
    internal_w = coalesce(
        per_cluster_internal.ix(per_cluster_deg.id, optional=True).internal_w, 0.0
    )
    scored = per_cluster_deg.select(
        q=internal_w / m - (per_cluster_deg.degree / (2.0 * m)) ** 2
    )
    summed = scored.groupby().reduce(modularity=reducers.sum(scored.q))
    return summed.select(
        modularity=apply_with_type(
            lambda q: round(q, round_digits), float, summed.modularity
        )
    )
