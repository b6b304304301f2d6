"""``pw.io.nats`` — NATS source/sink.

Re-design of the reference's Rust ``NatsReader``/``NatsWriter``
(``src/connectors/data_storage.rs:2226,2300``). The connector logic —
subscription draining into committed batches, JSON/plaintext parsing,
per-row publishing with the reference's ``time``/``diff`` fields — is
complete and unit-tested against a fake in-process client
(``tests/test_connectors_destubbed.py``); only the ``nats-py`` client
construction is gated on the package being installed.

Copy of ``pathway_tpu/io/nats.py``, gated on ``nats-py``.
"""

from __future__ import annotations

import json
import queue
import threading
from typing import Any, Protocol

from ..engine.executor import RealtimeSource
from ..internals.parse_graph import Universe
from ..internals.schema import SchemaMetaclass, schema_from_types
from ..internals.table import Table
from ._gated import unavailable

__all__ = ["read", "write"]


class NatsClient(Protocol):
    """The slice of a NATS connection the connector uses. The real client
    (nats-py) is adapted to this; tests inject an in-process fake."""

    def subscribe(self, topic: str, callback) -> None:
        """Register callback(payload: bytes) for messages on `topic`."""
        ...

    def publish(self, topic: str, payload: bytes) -> None:
        ...

    def close(self) -> None:
        ...


def _natspy_client(uri: str) -> NatsClient:
    try:
        import nats  # type: ignore[import-not-found]
    except ImportError:
        unavailable("pw.io.nats", "nats-py")
    import asyncio

    class _Client:
        """Bridges nats-py's asyncio API onto the blocking protocol (the
        reference runs its NATS IO on a tokio runtime the same way)."""

        def __init__(self) -> None:
            self._loop = asyncio.new_event_loop()
            self._thread = threading.Thread(
                target=self._loop.run_forever, daemon=True
            )
            self._thread.start()
            self._nc = asyncio.run_coroutine_threadsafe(
                nats.connect(uri), self._loop
            ).result(30)

        def subscribe(self, topic: str, callback) -> None:
            async def handler(msg):
                callback(msg.data)

            asyncio.run_coroutine_threadsafe(
                self._nc.subscribe(topic, cb=handler), self._loop
            ).result(30)

        def publish(self, topic: str, payload: bytes) -> None:
            asyncio.run_coroutine_threadsafe(
                self._nc.publish(topic, payload), self._loop
            ).result(30)

        def close(self) -> None:
            asyncio.run_coroutine_threadsafe(
                self._nc.drain(), self._loop
            ).result(30)
            self._loop.call_soon_threadsafe(self._loop.stop)

    return _Client()


class NatsSource(RealtimeSource):
    """Messages arrive via the client's subscription callback into a queue;
    each poll drains it into one committed batch (the reference's reader
    thread → channel → poller shape, ``src/connectors/mod.rs:427``)."""

    def __init__(self, client: NatsClient, topic: str, format: str,
                 names: list[str], schema: SchemaMetaclass | None):
        super().__init__(list(names))
        self.client = client
        self.topic = topic
        self.format = format
        self.names = list(names)
        self.fschema = schema
        self._queue: queue.Queue[bytes] = queue.Queue()
        self._delivered = 0

    def start(self) -> None:
        self.client.subscribe(self.topic, self._queue.put)

    def _parse(self, payload: bytes) -> tuple:
        if self.format == "json":
            obj = json.loads(payload)
            return tuple(obj.get(n) for n in self.names)
        if self.format in ("plaintext", "raw"):
            value = (
                payload.decode("utf-8", "replace")
                if self.format == "plaintext" else payload
            )
            return (value,)
        raise ValueError(f"unknown nats format {self.format!r}")

    def poll(self):
        import logging

        from ..engine import keys as K
        from ..engine.delta import Delta, rows_to_columns

        rows: list[tuple] = []
        while True:
            try:
                payload = self._queue.get_nowait()
            except queue.Empty:
                break
            try:
                rows.append(self._parse(payload))
            except (ValueError, TypeError) as e:
                # one malformed message must not take down the pipeline
                # (reference parsers route bad rows to the error log)
                logging.getLogger(__name__).warning(
                    "pw.io.nats: dropping unparsable message on %r: %s",
                    self.topic, e,
                )
        if not rows:
            return []
        start = self._delivered
        self._delivered += len(rows)
        # message identity includes the arrival index: NATS topics are
        # at-least-once streams of events, not keyed tables
        keys = K.hash_values([
            (self.topic, start + i, r) for i, r in enumerate(rows)
        ])
        return [Delta(keys=keys, data=rows_to_columns(rows, self.names))]

    def offset_state(self):
        return {"delivered": self._delivered}

    def seek(self, state) -> None:
        self._delivered = int(state.get("delivered", 0))

    def is_finished(self) -> bool:
        return False

    def stop(self) -> None:
        try:
            self.client.close()
        except Exception:
            pass


def read(uri: str, topic: str, *, schema: SchemaMetaclass | None = None,
         format: str = "json", autocommit_duration_ms: int | None = 1500,
         name: str | None = None, _client: NatsClient | None = None,
         **kwargs: Any) -> Table:
    """Subscribe to a NATS topic as a streaming table. ``_client`` injects
    any NatsClient (tests use an in-process fake)."""
    if schema is None:
        if format in ("plaintext", "raw"):
            schema = schema_from_types(
                data=str if format == "plaintext" else bytes
            )
        else:
            raise ValueError("pw.io.nats.read(format='json') requires schema=")
    names = schema.column_names()
    client = _client if _client is not None else _natspy_client(uri)
    use_schema = schema

    def build():
        src = NatsSource(client, topic, format, names, use_schema)
        src.persistent_id = name
        return src

    return Table("source", [], {"build": build}, use_schema, Universe())


def write(table: Table, uri: str, topic: str, *, format: str = "json",
          name: str | None = None, _client: NatsClient | None = None,
          **kwargs: Any) -> None:
    """Publish the table's change stream to a NATS topic: one message per
    row update, JSON with the reference's ``time``/``diff`` fields
    (``NatsWriter``, data_storage.rs:2300)."""
    from .delivery import CallableAdapter, deliver
    from .fs import _jsonable

    if format != "json":
        raise ValueError("pw.io.nats.write supports format='json'")
    names = table.column_names()
    client = _client if _client is not None else _natspy_client(uri)

    def write_batch(batch):
        cols = [batch.delta.data[n] for n in names]
        for vals, diff in zip(zip(*cols), batch.delta.diffs):
            obj = {n: _jsonable(v) for n, v in zip(names, vals)}
            obj["time"] = int(batch.time)
            obj["diff"] = int(diff)
            client.publish(topic, json.dumps(obj).encode())
        return None

    deliver(
        table,
        lambda: CallableAdapter(write_batch, "nats", on_close=client.close),
        name=name,
        default_name=f"nats-{topic}",
        retry_policy=kwargs.get("retry_policy"),
    )
