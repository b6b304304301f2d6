"""The serve plane: admission control, the scatter/gather bookkeeping and the
per-query side channel behind ``io.http.rest_connector``.

Copy of ``pathway_tpu/serve/__init__.py`` without the router
(``serve/router.py``): the sharded-serving branch of ``ExternalIndexNode``
that scatters a query to every worker's shard is not ported (ROADMAP Queue 1).
On one process the REST edge admits each query through the shared
controller, and the index node answers it whole.

Modules:

- :mod:`.stats` — ``serve.*`` counters and gauges;
- :mod:`.admission` — the bounded in-flight admission controller;
- :mod:`.merge` — pure top-k merge and gather bookkeeping (``ops.knn``'s
  host merge is this ``merge_topk``);
- :mod:`.registry` — which local worker holds which index shard;
- :mod:`.status` — process-local per-query degraded/deadline side
  channel between the engine node and the HTTP edge.
"""

from __future__ import annotations

from .admission import AdmissionController
from .merge import GatherState, merge_topk
from .registry import ShardRegistry
from .stats import SERVE_STATS, bump, serve_stats_snapshot

__all__ = [
    "AdmissionController",
    "GatherState",
    "merge_topk",
    "ShardRegistry",
    "SERVE_STATS",
    "bump",
    "serve_stats_snapshot",
]
