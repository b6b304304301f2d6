"""Generic object-store polling scanner — the engine behind the s3, minio,
gdrive and pyfilesystem sources.

Re-design of the reference's posix-like scanner pair
(``src/connectors/posix_like.rs`` + ``src/connectors/scanner/``: filesystem
and S3 scanners share one polling core with object-version tracking and
deleted-object detection). A concrete connector provides an
``ObjectStoreClient`` (list + read); the scanner diffs each listing against
the last seen object versions, downloads new/changed objects, parses them
into rows (binary / plaintext / csv / json), and emits insertions for new
content plus retractions for every row of a changed or deleted object —
exactly the reference's ``SnapshotEvent`` upsert semantics for object
sources.

Copy of ``pathway_tpu/io/_object_scanner.py``.
"""

from __future__ import annotations

import csv as _csv
import io as _io
import json
import time as _time
from dataclasses import dataclass
from typing import Any, Iterable, Protocol

import numpy as np

from ..engine import keys as K
from ..engine.delta import Delta, rows_to_columns
from ..engine.executor import RealtimeSource
from ..internals.schema import SchemaMetaclass

__all__ = ["ObjectMeta", "ObjectStoreClient", "ObjectScanSource", "parse_object"]

METADATA_COLUMN = "_metadata"


@dataclass(frozen=True)
class ObjectMeta:
    """One listed object. ``version`` is whatever the store uses to detect
    change (etag, modified time + size, revision id)."""

    key: str
    version: str
    size: int | None = None
    modified_at: float | None = None


class ObjectStoreClient(Protocol):
    def list_objects(self) -> Iterable[ObjectMeta]:
        """Current listing under the connector's path/prefix."""
        ...

    def read_object(self, key: str) -> bytes:
        ...


def _convert(value: str, dtype) -> Any:
    from ..internals import dtype as dt

    u = dt.unoptionalize(dtype)
    if value == "" and dtype.is_optional:
        return None
    if u == dt.INT:
        return int(value)
    if u == dt.FLOAT:
        return float(value)
    if u == dt.BOOL:
        return value.strip().lower() in ("true", "1", "yes", "on")
    return value


def parse_object(
    data: bytes,
    format: str,
    schema: SchemaMetaclass | None,
    names: list[str],
    delimiter: str = ",",
) -> list[tuple]:
    """Object bytes -> row tuples (DsvParser/JsonLinesParser/IdentityParser
    analog, ``src/connectors/data_format.rs:500,831,1443``)."""
    if format == "binary":
        return [(data,)]
    text = data.decode("utf-8", "replace")
    if format in ("plaintext", "plaintext_by_object"):
        if format == "plaintext_by_object":
            return [(text,)]
        return [(line,) for line in text.splitlines() if line.strip()]
    if format in ("csv", "dsv"):
        reader = _csv.DictReader(_io.StringIO(text), delimiter=delimiter)
        out = []
        for rec in reader:
            if schema is not None:
                out.append(tuple(
                    _convert(rec.get(n, ""), schema.columns()[n].dtype)
                    for n in names
                ))
            else:
                out.append(tuple(rec.get(n, "") for n in names))
        return out
    if format in ("json", "jsonlines"):
        out = []
        for line in text.splitlines():
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            out.append(tuple(obj.get(n) for n in names))
        return out
    raise ValueError(f"unknown object format {format!r}")


class ObjectScanSource(RealtimeSource):
    """Polls an ObjectStoreClient; emits row diffs for object-level changes.

    Row identity = hash(object key, row position, row content): a changed
    object retracts all its previous rows and inserts the new ones; a
    deleted object retracts everything it contributed (the reference's
    deleted-object detection, ``posix_like.rs``).
    """

    # last seen objects: key -> [version, [row tuples]] — connector state
    # restored directly by operator snapshots (cached_object_storage.rs:37)
    STATE_FIELDS = ("_seen",)

    def __init__(
        self,
        client: ObjectStoreClient,
        format: str,
        schema: SchemaMetaclass | None,
        names: list[str],
        *,
        with_metadata: bool = False,
        refresh_interval_s: float = 1.0,
        autocommit_ms: int | None = 1500,
        delimiter: str = ",",
    ):
        cols = list(names) + ([METADATA_COLUMN] if with_metadata else [])
        super().__init__(cols)
        self.client = client
        self.format = format
        self.fschema = schema
        self.names = list(names)
        self.with_metadata = with_metadata
        # each poll is one commit batch: an explicit autocommit cadence IS
        # the refresh cadence on this source
        if autocommit_ms is not None:
            refresh_interval_s = min(refresh_interval_s, autocommit_ms / 1000.0)
        self.refresh_interval_s = refresh_interval_s
        self.autocommit_ms = autocommit_ms
        self.delimiter = delimiter
        self._seen: dict[str, list] = {}
        self._next_poll = 0.0
        self._stopped = False

    def _make_rows(self, meta: ObjectMeta, data: bytes) -> list[tuple]:
        rows = parse_object(
            data, self.format, self.fschema, self.names, self.delimiter
        )
        if self.with_metadata:
            md = {
                "path": meta.key,
                "size": meta.size if meta.size is not None else len(data),
                "seen_at": int(_time.time()),
                "modified_at": (
                    int(meta.modified_at) if meta.modified_at is not None else None
                ),
            }
            rows = [r + (json.dumps(md),) for r in rows]
        return rows

    def poll(self) -> list[Delta]:
        now = _time.monotonic()
        if now < self._next_poll or self._stopped:
            return []
        self._next_poll = now + self.refresh_interval_s
        try:
            listing = {m.key: m for m in self.client.list_objects()}
        except Exception:
            return []  # transient listing failure: retry next poll
        out_rows: list[tuple] = []
        out_keys: list[tuple] = []
        out_diffs: list[int] = []

        def emit(key: str, rows: list[tuple], diff: int) -> None:
            for pos, row in enumerate(rows):
                out_keys.append((key, pos, row))
                out_rows.append(row)
                out_diffs.append(diff)

        for key, entry in list(self._seen.items()):
            if key not in listing:
                emit(key, entry[1], -1)  # object deleted
                del self._seen[key]
        for key, meta in sorted(listing.items()):
            entry = self._seen.get(key)
            if entry is not None and entry[0] == meta.version:
                continue
            try:
                data = self.client.read_object(meta.key)
            except Exception:
                continue  # object vanished/unreadable mid-poll: next round
            try:
                rows = self._make_rows(meta, data)
            except Exception as e:
                # a permanently malformed object must be marked seen (at
                # this version) or it would be re-downloaded every poll;
                # its content contributes no rows (the reference routes
                # parse failures to the error log)
                import logging

                logging.getLogger(__name__).warning(
                    "object scanner: cannot parse %r (%s) — skipping this "
                    "version", key, e,
                )
                rows = []
            if entry is not None:
                emit(key, entry[1], -1)  # object changed: retract old rows
            emit(key, rows, 1)
            self._seen[key] = [meta.version, rows]
        if not out_rows:
            return []
        keys = K.hash_values(out_keys)
        return [Delta(
            keys=keys,
            data=rows_to_columns(out_rows, self.column_names),
            diffs=np.asarray(out_diffs, dtype=np.int64),
        )]

    def is_finished(self) -> bool:
        return False

    def stop(self) -> None:
        self._stopped = True
