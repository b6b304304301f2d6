"""Process-local per-query side channel between the HTTP edge and the
sharded index node (copy of ``pathway_tpu/serve/status.py``).

The engine's reply column is shape-locked (a tuple of (key, score)
pairs — ``stdlib/indexing/data_index.py`` flattens and repacks it), so
degraded-gather metadata can't ride the dataflow value. But the scatter
origin (worker 0, a ``("gather",)`` query exchange) lives in the SAME
process as the REST edge, and the request key survives unchanged from
``rest_connector`` row to index-node query (``.select`` preserves the
universe). So: the node deposits per-key status here at merge time, the
edge reads it after the future resolves and turns it into the
``X-Pathway-Degraded`` header / ``degraded`` body field; the edge
deposits per-key deadline hints here at admission time, the node reads
them at scatter time. Bounded, self-evicting — an abandoned entry (a
query whose edge died) can't leak.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any

__all__ = [
    "note_deadline",
    "take_deadline",
    "note_status",
    "take_status",
]

_MAX_ENTRIES = 4096

_lock = threading.Lock()
_deadlines: "OrderedDict[Any, int]" = OrderedDict()
_status: "OrderedDict[Any, dict]" = OrderedDict()


def _put(table: OrderedDict, key: Any, value: Any) -> None:
    with _lock:
        table.pop(key, None)
        table[key] = value
        while len(table) > _MAX_ENTRIES:
            table.popitem(last=False)


def _take(table: OrderedDict, key: Any) -> Any:
    with _lock:
        return table.pop(key, None)


def note_deadline(key: Any, deadline_ns: int) -> None:
    """Edge → node: this query's absolute wall-clock deadline (ns)."""
    _put(_deadlines, key, int(deadline_ns))


def take_deadline(key: Any) -> int | None:
    return _take(_deadlines, key)


def note_status(key: Any, status: dict) -> None:
    """Node → edge: gather outcome for this query key —
    ``{"degraded": bool, "missing_shards": [...],
    "deadline_exceeded": bool}``."""
    _put(_status, key, status)


def take_status(key: Any) -> dict | None:
    return _take(_status, key)
