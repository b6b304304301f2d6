"""Serve-plane counters — the ``serve.*`` surface.

Copy of ``pathway_tpu/serve/stats.py``. Module-global like
``io/python.py``'s INGEST_STAGE_STATS: every component of the serve plane
bumps these under a lock. The observability hub's ``/snapshot`` and
``/query``, the ``pathway_serve_*`` families of ``/metrics`` and the
``serve.*`` signals series read them through ``serve_stats_snapshot``, as in
the reference.

The snapshot is EMPTY until the serve plane has actually done
something.
"""

from __future__ import annotations

import threading
from typing import Callable

__all__ = [
    "SERVE_STATS",
    "bump",
    "serve_stats_snapshot",
    "register_gauge_provider",
    "unregister_gauge_provider",
    "reset_serve_stats",
]

#: monotone counters; every key ends ``_total`` (the serve_metrics gate
#: checks this — prometheus renders _total keys as counters)
SERVE_STATS: dict[str, int] = {
    #: queries admitted at the edge (one per accepted REST request)
    "queries_total": 0,
    #: queries refused with 429 (saturated: queue at bound)
    "rejected_total": 0,
    #: queries that waited in the admission queue before a slot freed
    "queued_total": 0,
    #: queries dropped at ANY hop because their deadline had passed
    "deadline_dropped_total": 0,
    #: gathers that completed with at least one shard missing
    "degraded_total": 0,
    #: cross-worker scatter posts (one per remote shard per query batch)
    "scatter_posts_total": 0,
    #: per-shard searches executed (local + remote responders)
    "shard_searches_total": 0,
    #: gathers merged into a final result (degraded or not)
    "results_merged_total": 0,
    #: duplicate shard results discarded by correlation-id dedup
    "duplicate_results_total": 0,
    #: admission slots cancelled by client disconnect
    "cancelled_total": 0,
    #: shard responder errors surfaced as failed shards
    "errors_total": 0,
}

_lock = threading.Lock()

#: live-gauge providers (admission controllers, routers) — each returns
#: a {name: value} dict merged into the snapshot; names must NOT end
#: ``_total`` (they are gauges: in-flight, queue depth, pending gathers)
_gauge_providers: list[Callable[[], dict[str, float]]] = []


def bump(key: str, n: int = 1) -> None:
    with _lock:
        SERVE_STATS[key] += n


def register_gauge_provider(fn: Callable[[], dict[str, float]]) -> None:
    with _lock:
        if fn not in _gauge_providers:
            _gauge_providers.append(fn)


def unregister_gauge_provider(fn: Callable[[], dict[str, float]]) -> None:
    with _lock:
        try:
            _gauge_providers.remove(fn)
        except ValueError:
            pass


def serve_stats_snapshot() -> dict[str, float]:
    """Counters + live gauges, or ``{}`` when the serve plane never ran
    (keeps non-serving expositions byte-identical)."""
    with _lock:
        counters = dict(SERVE_STATS)
        providers = list(_gauge_providers)
    if not any(counters.values()) and not providers:
        return {}
    out = {k: float(v) for k, v in counters.items()}
    for fn in providers:
        try:
            for k, v in fn().items():
                out[k] = float(v)
        except Exception:
            # telemetry must not fail the plane it observes
            continue
    return out


def reset_serve_stats() -> None:
    """Test hook: zero the counters and drop gauge providers."""
    with _lock:
        for k in SERVE_STATS:
            SERVE_STATS[k] = 0
        _gauge_providers.clear()
