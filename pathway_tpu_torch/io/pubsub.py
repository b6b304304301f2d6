"""``pw.io.pubsub`` — Google Pub/Sub sink.

Re-design of ``python/pathway/io/pubsub``: publishes the table's change
stream (a single binary column) with ``pathway_time``/``pathway_diff``
attributes per message. The connector logic is complete and unit-tested
with a fake publisher; the real ``pubsub_v1.PublisherClient`` is simply
whatever the caller passes in (exactly the reference's surface — the
publisher object IS the argument, so nothing needs gating here).

Copy of ``pathway_tpu/io/pubsub.py``.
"""

from __future__ import annotations

from typing import Any

from ..internals import dtype as dt
from ..internals.table import Table

__all__ = ["write"]


def write(table: Table, publisher: Any, project_id: str, topic_id: str,
          **kwargs: Any) -> None:
    """Publish ``table``'s stream of changes to a Pub/Sub topic. The table
    must have exactly one column, of binary type (reference
    io/pubsub/__init__.py:49); each update becomes one message with
    ``pathway_time`` and ``pathway_diff`` attributes."""
    names = table.column_names()
    if len(names) != 1:
        raise ValueError(
            f"pw.io.pubsub.write requires a single-column table, got {names}"
        )
    cs = table.schema.columns().get(names[0])
    if cs is not None and dt.unoptionalize(cs.dtype) not in (dt.BYTES, dt.ANY):
        raise ValueError(
            "pw.io.pubsub.write requires the column to be binary "
            f"(got {cs.dtype})"
        )
    (column,) = names
    topic_path = publisher.topic_path(project_id, topic_id)
    from .delivery import CallableAdapter, deliver

    def write_batch(batch):
        vals = batch.delta.data[column]
        for v, diff in zip(vals, batch.delta.diffs):
            data = v if isinstance(v, bytes) else str(v).encode()
            publisher.publish(
                topic_path, data,
                pathway_time=str(int(batch.time)),
                pathway_diff=str(int(diff)),
            )
        return None

    deliver(
        table,
        lambda: CallableAdapter(write_batch, "pubsub"),
        name=kwargs.get("name"),
        default_name=f"pubsub-{topic_id}",
        retry_policy=kwargs.get("retry_policy"),
    )
