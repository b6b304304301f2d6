"""``pw.io.null`` — sink that discards output (reference NullWriter,
data_storage.rs:1387); still forces the table to be computed. Rides the
delivery layer like every other sink (a discarded batch still moves the
per-sink delivered counters — useful as a load probe).

Copy of ``pathway_tpu/io/null.py``."""

from __future__ import annotations

from typing import Any


def write(table, *, name: str | None = None, **kwargs: Any) -> None:
    from .delivery import CallableAdapter, deliver

    deliver(
        table,
        lambda: CallableAdapter(lambda batch: None, "null"),
        name=name,
        default_name="null",
    )
