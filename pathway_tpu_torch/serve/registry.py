"""Shard registry: which local worker holds which index shard (copy of
``pathway_tpu/serve/registry.py``; the sharded-serving branch that fills it is not ported).

Process-local directory from worker id to the index engine that holds
that worker's hash shard (ownership follows the engine's row-hash
exchange — the same ``shard_rows`` assignment that routes ``("key",)``
exchanges, so rescale/upgrade epochs carry index shards for free).
Each entry pairs the engine with an RLock: the engine node takes it
while mutating (inserts/removals inside a tick), the serve responder
takes it while searching — searches never observe a half-applied tick.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Iterator

__all__ = ["ShardHandle", "ShardRegistry"]


class ShardHandle:
    __slots__ = ("worker_id", "lock", "_search")

    def __init__(self, worker_id: int, search: Callable):
        self.worker_id = worker_id
        self.lock = threading.RLock()
        self._search = search

    def search(
        self, queries: list[Any], limits: list[int], filters: list[Any]
    ) -> list:
        """Per-query [(key, score), ...] best-first, under the shard
        lock so a concurrent tick's mutation can't interleave."""
        with self.lock:
            return self._search(queries, limits, filters)


class ShardRegistry:
    """One per process (module global via :func:`registry`); keyed by
    (node fingerprint, worker id) so several sharded index nodes in one
    graph don't collide."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._shards: dict[tuple[Any, int], ShardHandle] = {}

    def register(
        self, node_key: Any, worker_id: int, search: Callable
    ) -> ShardHandle:
        """(Re-)register a worker's shard; re-registration (a restarted
        generation, a re-run graph in the same process) replaces the
        stale handle."""
        handle = ShardHandle(worker_id, search)
        with self._lock:
            self._shards[(node_key, worker_id)] = handle
        return handle

    def unregister(self, node_key: Any, worker_id: int) -> None:
        with self._lock:
            self._shards.pop((node_key, worker_id), None)

    def get(self, node_key: Any, worker_id: int) -> ShardHandle | None:
        with self._lock:
            return self._shards.get((node_key, worker_id))

    def local_workers(self, node_key: Any) -> Iterator[int]:
        with self._lock:
            return iter(
                sorted(w for (nk, w) in self._shards if nk == node_key)
            )

    def clear(self) -> None:
        with self._lock:
            self._shards.clear()


_REGISTRY = ShardRegistry()


def registry() -> ShardRegistry:
    return _REGISTRY
