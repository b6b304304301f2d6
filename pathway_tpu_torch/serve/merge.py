"""Pure scatter/gather bookkeeping for the serve plane (copy of ``pathway_tpu/serve/merge.py``).

A query batch scattered to N shards gathers N per-shard top-k answers;
this module owns the merge and the accounting — no comm, no threads,
no clocks beyond the ``time.time_ns`` deadline arguments it is handed.
The router wraps a :class:`GatherState` per in-flight correlation id
and waits on its event; unit tests drive the same object directly
(duplicate delivery, partial gathers, deadline expiry).

Merging generalizes the single-host gather in ``ops/knn.py``'s
``sharded_knn_search`` (local top-k per shard → global top-k over the
union) to shards that answer over the wire: each shard's candidate
list is already best-first, so the merge is a heap-free concat + sort
over at most ``n_shards * k`` pairs.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Iterable, Sequence

from .stats import bump

__all__ = [
    "merge_topk",
    "GatherState",
    "deadline_from_ms",
    "default_deadline_ms",
    "expired",
]


def default_deadline_ms() -> float:
    """Per-query budget when the client sent no deadline header —
    defaults to the REST edge's historical 120 s wait."""
    from ..internals.config import _env_float

    return max(1.0, _env_float("PATHWAY_SERVE_DEADLINE_MS", 120000.0))


def deadline_from_ms(deadline_ms: float, now_ns: int | None = None) -> int:
    """Absolute wall-clock deadline (ns) a relative budget away."""
    base = time.time_ns() if now_ns is None else now_ns
    return base + int(deadline_ms * 1e6)


def expired(deadline_ns: int | None, now_ns: int | None = None) -> bool:
    if deadline_ns is None:
        return False
    return (time.time_ns() if now_ns is None else now_ns) >= deadline_ns


def merge_topk(
    parts: Iterable[Sequence[tuple[Any, float]]], k: int
) -> list[tuple[Any, float]]:
    """Merge per-shard (key, score) candidate lists into a global
    best-first top-k. Scores compare higher-is-better (the engines
    negate distances). Duplicate keys — a rescale replaying a row into
    two shards' epochs — keep their best score only."""
    best: dict[Any, float] = {}
    for part in parts:
        for key, score in part:
            prev = best.get(key)
            if prev is None or score > prev:
                best[key] = score
    ranked = sorted(best.items(), key=lambda kv: (-kv[1], kv[0]))
    return [(key, score) for key, score in ranked[:k]]


class GatherState:
    """One in-flight scatter: per-shard answers for a batch of queries.

    Thread-safe; the router's dispatcher threads call :meth:`add` /
    :meth:`fail` while the origin blocks on :meth:`wait`. Duplicate
    delivery of a (qid, shard) answer — the serve seam inherits the
    async plane's at-least-once chaos duplication — is dropped by
    correlation-id dedup and counted.
    """

    def __init__(
        self,
        qid: tuple,
        shards: Iterable[int],
        limits: Sequence[int],
        deadline_ns: int | None = None,
    ):
        self.qid = qid
        self.expected = frozenset(shards)
        self.limits = list(limits)
        self.n_queries = len(self.limits)
        self.deadline_ns = deadline_ns
        self._lock = threading.Lock()
        self._event = threading.Event()
        #: shard -> list (per query) of [(key, score), ...] best-first
        self._answers: dict[int, list] = {}
        self._failed: set[int] = set()

    # -- responder side ------------------------------------------------

    def add(self, shard: int, per_query_hits: list) -> bool:
        """Record one shard's answer; returns False on duplicate or
        unexpected shard (dropped, counted)."""
        with self._lock:
            if shard not in self.expected or shard in self._answers:
                bump("duplicate_results_total")
                return False
            self._failed.discard(shard)
            self._answers[shard] = per_query_hits
            done = self._done_locked()
        if done:
            self._event.set()
        return True

    def fail(self, shard: int) -> None:
        """A shard reported an error (or the router knows it is gone):
        the gather completes without it rather than hanging."""
        with self._lock:
            if shard not in self.expected or shard in self._answers:
                return
            self._failed.add(shard)
            done = self._done_locked()
        if done:
            self._event.set()

    def _done_locked(self) -> bool:
        return len(self._answers) + len(self._failed) >= len(self.expected)

    # -- origin side ---------------------------------------------------

    def wait(self, timeout_s: float | None) -> bool:
        """Block until every shard answered/failed, the deadline passed,
        or ``timeout_s`` elapsed; True iff the gather is complete."""
        if timeout_s is not None and self.deadline_ns is not None:
            timeout_s = min(
                timeout_s, max(0.0, (self.deadline_ns - time.time_ns()) / 1e9)
            )
        elif self.deadline_ns is not None:
            timeout_s = max(0.0, (self.deadline_ns - time.time_ns()) / 1e9)
        return self._event.wait(timeout=timeout_s)

    def result(self) -> dict:
        """Merge whatever arrived. Never blocks, never raises: a shard
        that stayed silent is reported in ``missing_shards`` and flips
        ``degraded`` — partial answers over hung gathers."""
        with self._lock:
            answers = dict(self._answers)
            failed = set(self._failed)
        missing = sorted((self.expected - set(answers)) | failed)
        hits = [
            merge_topk(
                (
                    answers[s][q] if q < len(answers[s]) else []
                    for s in answers
                ),
                self.limits[q],
            )
            for q in range(self.n_queries)
        ]
        degraded = bool(missing)
        bump("results_merged_total")
        if degraded:
            bump("degraded_total")
        return {
            "hits": hits,
            "degraded": degraded,
            "missing_shards": missing,
            "deadline_exceeded": expired(self.deadline_ns),
        }
