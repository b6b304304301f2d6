"""Hidden-Markov-Model decoding reducer (reference
``python/pathway/stdlib/ml/hmm.py:11`` ``create_hmm_reducer``).

The HMM is a networkx DiGraph whose edges carry transition log-probability
functions of the observation; the reducer maintains per-state best
log-likelihood (online Viterbi) and emits the most likely current state
(optionally the decoded trail). Stateful, append-only — matches the
reference's stateful-reducer semantics.

Copy of ``pathway_tpu/stdlib/ml/hmm.py``, over the port's Table API and engine nodes.
"""

from __future__ import annotations

from typing import Any

from ... import reducers as _reducers

__all__ = ["create_hmm_reducer"]


def create_hmm_reducer(
    graph: Any,
    beam_size: int | None = None,
    num_results_kept: int | None = None,
):
    """Returns a reducer expression factory: ``reducer(observation_col)``
    decodes the observation stream per group (reference hmm.py:11).

    Graph contract (reference parity): nodes are states; ``graph.nodes[s]``
    may carry ``initial_log_ppb``; each edge (u, v) carries
    ``calc_log_ppb(observation) -> float`` (emission+transition log prob).
    """
    import math

    states = list(graph.nodes)
    initial = {
        s: float(graph.nodes[s].get("initial_log_ppb", 0.0)) for s in states
    }
    edges = {
        (u, v): data["calc_log_ppb"] for u, v, data in graph.edges(data=True)
    }

    def combine(state, values, diff=1):
        # state: (scores: dict state->logppb, trail: tuple) | None;
        # called once per row (engine StatefulReducer — append-only)
        (obs,) = values
        if state is None:
            scores = dict(initial)
            trail: tuple = ()
        else:
            scores, trail = dict(state[0]), state[1]
        new_scores: dict[Any, float] = {}
        for (u, v), calc in edges.items():
            if u not in scores:
                continue
            cand = scores[u] + float(calc(obs))
            if v not in new_scores or cand > new_scores[v]:
                new_scores[v] = cand
        if not new_scores:
            new_scores = dict(initial)
        if beam_size is not None:
            kept = sorted(new_scores, key=new_scores.get, reverse=True)[:beam_size]
            new_scores = {s: new_scores[s] for s in kept}
        scores = new_scores
        best = max(scores, key=scores.get) if scores else None
        trail = trail + (best,)
        if num_results_kept is not None:
            trail = trail[-num_results_kept:]
        return (scores, trail)

    def reducer(observation_col):
        expr = _reducers.stateful_many(combine, observation_col)
        return _extract_last(expr)

    return reducer


def _extract_last(state_expr):
    from ...internals import dtype as dt
    from ...internals.expression import apply_with_type

    return apply_with_type(
        lambda st: st[1][-1] if st and st[1] else None, dt.ANY, state_expr
    )
