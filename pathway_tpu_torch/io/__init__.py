"""``pw.io`` — connector framework.

Re-design of ``python/pathway/io/`` (8,122 LoC, 30+ modules) over the engine's
SourceNode/Subscribe machinery. Implemented connectors live in submodules
(``fs``, ``csv``, ``jsonlines``, ``plaintext``, ``python``, ``http``, ...);
``subscribe`` is the universal callback sink (reference ``io.subscribe``).

Copy of ``pathway_tpu/io/__init__.py`` with the file connectors (``fs``,
``csv``, ``jsonlines``, ``plaintext``, and ``s3``'s object stream under
``fs``), the delivery-managed writers (``delivery``, ``null``), the
``python`` connector and ``http``'s REST server; the other connectors are not
ported.
"""

from __future__ import annotations

from typing import Any, Callable

from ..internals.parse_graph import G
from ..internals.table import Table

from . import (  # noqa: E402,F401
    csv,
    delivery,
    fs,
    http,
    jsonlines,
    null,
    plaintext,
    python,
    s3,
)

__all__ = [
    "csv",
    "delivery",
    "fs",
    "http",
    "jsonlines",
    "null",
    "plaintext",
    "python",
    "s3",
    "subscribe",
    "OnChangeCallback",
    "OnFinishCallback",
]

OnChangeCallback = Callable[..., None]
OnFinishCallback = Callable[[], None]


def subscribe(
    table: Table,
    on_change: Callable[..., None] | None = None,
    on_end: Callable[[], None] | None = None,
    on_time_end: Callable[[int], None] | None = None,
    *,
    on_batch: Callable[..., None] | None = None,
    skip_persisted_batch: bool = True,
    name: str | None = None,
    sort_by: Any = None,
) -> None:
    """Call ``on_change(key, row, time, is_addition)`` for every row update
    (reference ``io/subscribe``).

    ``on_batch(time, batch)`` is the columnar fast lane: called once per
    consolidated tick delta with the raw batch (``batch.keys`` uint64[n],
    ``batch.data`` {col: array}, ``batch.diffs`` ±k int64[n]) — no per-row
    dict building, for high-throughput sinks."""
    G.add_sink({
        "kind": "subscribe",
        "table": table,
        "on_change": on_change,
        "on_time_end": on_time_end,
        "on_end": on_end,
        "on_batch": on_batch,
        "skip_persisted_batch": skip_persisted_batch,
    })
