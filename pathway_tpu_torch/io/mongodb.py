"""``pw.io.mongodb`` — MongoDB sink (reference Rust ``MongoWriter``,
``src/connectors/data_storage.rs:2187``). Gated on ``pymongo``.

Writes ride the columnar ``on_batch`` sink lane: each tick's
consolidated delta becomes ONE ``insert_many`` (chunked to
``max_batch_size`` when set) instead of a per-row ``insert_one`` — the
reference writer batches by ``max_batch_size`` exactly this way, and a
round-trip per row is the difference between a sink that keeps up with
the engine and one that backpressures it.

Copy of ``pathway_tpu/io/mongodb.py``, gated on ``pymongo``.
"""

from __future__ import annotations

from typing import Any

from ..internals.table import Table
from ._gated import require

__all__ = ["write"]


def write(table: Table, connection_string: str, database: str, collection: str,
          *, max_batch_size: int | None = None, name: str | None = None,
          retry_policy: Any = None, **kwargs: Any) -> None:
    with require("pymongo", "pw.io.mongodb"):
        import pymongo
    client = pymongo.MongoClient(connection_string)
    coll = client[database][collection]
    from .delivery import CallableAdapter, deliver

    def write_batch(batch):
        docs = []
        for row, diff in batch.rows():
            doc = dict(row)
            doc["time"] = batch.time
            doc["diff"] = 1 if diff > 0 else -1
            docs.append(doc)
        if not docs:
            return None
        step = (
            max_batch_size
            if max_batch_size and max_batch_size > 0
            else len(docs)
        )
        for i in range(0, len(docs), step):
            coll.insert_many(docs[i : i + step])
        return None

    deliver(
        table,
        lambda: CallableAdapter(write_batch, "mongodb"),
        name=name,
        default_name=f"mongodb-{database}.{collection}",
        retry_policy=retry_policy,
    )
