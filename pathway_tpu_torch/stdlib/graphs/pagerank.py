"""PageRank (reference ``stdlib/graphs/pagerank/impl.py:18``).

Same API (``pagerank(edges, steps=5) -> Table[Result]``, integer ranks so the
fixpoint is exact). Rank flow per step is a key-join (edge source lookup) +
segment-sum per target, two engine operators a step; steps are
driven by the engine's Iterate node with ``iteration_limit=steps``.

Copy of ``pathway_tpu/stdlib/graphs/pagerank.py``, over the port's Table API and engine nodes.
"""

from __future__ import annotations

from ...internals.expression import coalesce, if_else
from ...internals.iterate import iterate
from ...internals.schema import Schema
from ...internals.table import Table
from ... import reducers


class Result(Schema):
    rank: int


def pagerank(edges: Table, steps: int = 5) -> Table:
    # vertex set = all edge endpoints, keyed by their pointer; out-degree 0
    # for pure sinks
    out_deg = edges.groupby(id=edges.u).reduce(degree=reducers.count())
    sinks = edges.groupby(id=edges.v).reduce(degree=0)
    degrees = sinks.update_rows(out_deg)

    init = degrees.select(rank=6_000, degree=degrees.degree)

    def step(ranks: Table, edges: Table) -> Table:
        # each vertex sends rank*5/6 split over its out-edges; everyone keeps
        # a 1000 base (the damping term, integer arithmetic keeps it exact)
        outflow = ranks.select(
            flow=if_else(
                ranks.degree == 0, 0, (ranks.rank * 5) // (ranks.degree * 6)
            )
        )
        inflow = edges.groupby(id=edges.v).reduce(
            received=reducers.sum(outflow.ix(edges.u).flow)
        )
        return ranks.select(
            rank=coalesce(inflow.ix(ranks.id, optional=True).received, 0) + 1_000,
            degree=ranks.degree,
        )

    result = iterate(step, iteration_limit=steps, ranks=init, edges=edges)
    return result.select(rank=result.rank)
