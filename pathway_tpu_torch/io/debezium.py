"""``pw.io.debezium`` — Debezium CDC message parsing.

Re-design of the reference ``DebeziumMessageParser``
(``src/connectors/data_format.rs:1056``) + ``python/pathway/io/debezium``.
The reference consumes Debezium envelopes from Kafka; here the transport is
pluggable (a Kafka client when available, a ``ConnectorSubject`` of raw
messages, or a jsonlines file for replay/testing) and the envelope decoding
(op c/r = insert, u = retract old + insert new, d = delete) is shared.

Copy of ``pathway_tpu/io/debezium.py``; its Kafka transport is gated on
``confluent-kafka`` as ``pw.io.kafka`` is.
"""

from __future__ import annotations

import json
from typing import Any

from ..internals.schema import SchemaMetaclass
from ..internals.table import Table
from .python import ConnectorSubject, read as python_read

__all__ = ["read", "parse_debezium_message"]


def parse_debezium_message(message: str | bytes | dict) -> list[tuple[int, dict]]:
    """One Debezium envelope -> [(diff, row_dict)] events
    (data_format.rs:1056 semantics)."""
    if isinstance(message, (str, bytes)):
        message = json.loads(message)
    payload = message.get("payload", message)
    op = payload.get("op", "r")
    before = payload.get("before")
    after = payload.get("after")
    if op in ("c", "r"):
        return [(1, after)] if after is not None else []
    if op == "u":
        events: list[tuple[int, dict]] = []
        if before is not None:
            events.append((-1, before))
        if after is not None:
            events.append((1, after))
        return events
    if op == "d":
        return [(-1, before)] if before is not None else []
    return []


class _DebeziumSubject(ConnectorSubject):
    """Wraps a transport of raw envelopes into parsed row events."""

    def __init__(self, raw_messages):
        super().__init__(datasource_name="debezium")
        self._raw = raw_messages

    def _emit_envelopes(self, envelopes) -> None:
        """Decoded-envelope emission: rows keep per-row ``next``/``_remove``
        (mixed diffs ride the ingest coalescer) and the per-envelope commit
        cadence — a CDC retract+insert pair squeezed into one tick would
        cancel before any subscriber saw it, so only the *decode* is
        batched, never the tick boundaries."""
        for msg in envelopes:
            for diff, row in parse_debezium_message(msg):
                if diff > 0:
                    self.next(**row)
                else:
                    self._remove(**row)
            self.commit()

    def run(self) -> None:
        from itertools import islice

        from . import columnar as _columnar

        if not _columnar.enabled():
            for msg in self._raw:
                for diff, row in parse_debezium_message(msg):
                    if diff > 0:
                        self.next(**row)
                    else:
                        self._remove(**row)
                self.commit()
            return
        step = _columnar.chunk_rows()
        it = iter(self._raw)
        while not self.stopped:
            chunk = list(islice(it, step))
            if not chunk:
                break
            if len(chunk) > 1 and all(
                isinstance(m, (str, bytes)) for m in chunk
            ):
                # batch decode: ONE json.loads over the joined chunk; any
                # disagreement falls back to per-envelope decoding, which
                # raises at the exact envelope the row-wise path would have
                try:
                    joined = ",".join(
                        m.decode("utf-8") if isinstance(m, bytes) else m
                        for m in chunk
                    )
                    decoded = json.loads("[" + joined + "]")
                    if len(decoded) != len(chunk):
                        raise ValueError("envelope count mismatch")
                except (ValueError, UnicodeDecodeError):
                    decoded = chunk
            else:
                decoded = chunk
            self._emit_envelopes(decoded)


def read(
    source: Any = None,
    *,
    schema: SchemaMetaclass,
    rdkafka_settings: dict | None = None,
    topic_name: str | None = None,
    input_file: str | None = None,
    autocommit_duration_ms: int | None = 1500,
    name: str | None = None,
    **kwargs: Any,
) -> Table:
    """Read a Debezium CDC stream into a live table.

    - ``rdkafka_settings`` + ``topic_name``: consume from Kafka (requires a
      Kafka client library — gated, like ``pw.io.kafka``).
    - ``input_file``: replay a jsonlines capture of envelopes.
    - ``source``: any iterable of raw envelopes (str/bytes/dict).
    """
    if rdkafka_settings is not None:
        from . import kafka as _kafka

        _kafka._require_client()  # raises with install guidance
        raise NotImplementedError("kafka transport requires a kafka client")
    if input_file is not None:
        def _lines():
            with open(input_file) as f:
                for line in f:
                    if line.strip():
                        yield line
        source = _lines()
    if source is None:
        raise ValueError("pass rdkafka_settings+topic_name, input_file, or source")
    return python_read(
        _DebeziumSubject(source), schema=schema,
        autocommit_duration_ms=autocommit_duration_ms, name=name,
    )
