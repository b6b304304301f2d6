"""Input snapshots + versioned metadata over a PersistenceBackend.

Re-design of the reference's input-snapshot and metadata machinery:
``src/persistence/input_snapshot.rs:56-217`` (chunked event capture),
``src/persistence/state.rs:17-35`` (``MetadataAccessor`` versioned
metadata), ``src/connectors/offset.rs`` (``OffsetAntichain`` per-source
resume positions).

Layout (keys in the backend):

- ``chunks/chunk-{seq:08d}``  — pickled list of (time, source_pid, keys,
  data-columns, diffs) entries, appended in commit order.
- ``meta/meta-{version:08d}`` — JSON: {"last_time", "n_chunks",
  "offsets": {pid: offset_state}}. The newest readable metadata wins; a
  chunk written without a following metadata commit is ignored on
  recovery (write-chunks-then-metadata gives crash atomicity, mirroring
  the reference's finalize protocol).

Copy of ``pathway_tpu/persistence/snapshots.py``. Every blob is read back
through :func:`load_blob`, whose unpickler refuses classes of the JAX package
(``pathway_tpu.*``): a store that package wrote raises ``PersistenceFormatError``
naming the store's location instead of importing the reference, also when the
resharder reads it. The operators' ``snapshot_state_parts`` streams (a resident
head, then each spilled segment loaded one at a time) are framed by
``write_parts``/``read_parts`` as the reference frames them.
"""

from __future__ import annotations

import io
import json
import pickle
from typing import Any

import numpy as np

from ..engine.delta import Delta
from .backends import PersistenceBackend

__all__ = [
    "PersistenceFormatError",
    "load_blob",
    "SnapshotWriter",
    "SnapshotReader",
    "MetadataAccessor",
    "OperatorSnapshots",
    "read_op_state",
]

_CHUNK_PREFIX = "chunks/chunk-"
_META_PREFIX = "meta/meta-"
_OPS_PREFIX = "ops/"

#: modules whose classes a blob may not name: the JAX package's, whose stores
#: this package does not read
_FOREIGN_ROOT = "pathway_tpu"


class PersistenceFormatError(RuntimeError):
    """A persisted blob this package cannot read (written by another
    package, or not a pickle)."""


class _PortUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str) -> Any:
        if module == _FOREIGN_ROOT or module.startswith(_FOREIGN_ROOT + "."):
            raise PersistenceFormatError(
                f"the blob names {module}.{name}, a class of the JAX package"
            )
        return super().find_class(module, name)


def load_blob(blob: bytes, backend: PersistenceBackend, key: str) -> Any:
    """Unpickle one persisted blob without importing the JAX package; a
    blob that names its classes raises with the store's location."""
    try:
        return _PortUnpickler(io.BytesIO(blob)).load()
    except PersistenceFormatError as e:
        raise PersistenceFormatError(
            f"persisted state at {backend.describe()} (key {key!r}) was "
            f"written by the JAX package ({e}); pathway_tpu_torch does not "
            "read its stores — point the port at its own persistence backend "
            "or clear this one"
        ) from None


def _delta_parts(delta: Delta) -> tuple:
    return (
        delta.keys,
        {c: np.asarray(v) for c, v in delta.data.items()},
        delta.diffs,
    )


def _delta_from_parts(parts: tuple) -> Delta:
    keys, data, diffs = parts
    return Delta(keys=keys, data=dict(data), diffs=diffs)


class MetadataAccessor:
    """Versioned metadata blobs; highest parseable version is current
    (``state.rs:35``). A truncated/corrupt NEWEST blob (a torn write that
    slipped past the backend's atomic-rename discipline) is not silently
    papered over: the accessor falls back to the previous readable version
    with a logged warning and remembers the skipped version in
    ``fell_back_from``, and the next commit rewrites (heals) the torn
    version number."""

    def __init__(self, backend: PersistenceBackend):
        self._backend = backend
        self._version = -1
        self._swept = False
        self.current: dict[str, Any] | None = None
        #: newest metadata version that existed but failed to parse while a
        #: usable older version was adopted instead; None = clean store
        self.fell_back_from: int | None = None
        corrupt: list[int] = []
        for key in backend.list_keys():
            if not key.startswith(_META_PREFIX):
                continue
            try:
                version = int(key[len(_META_PREFIX):])
            except ValueError:
                continue
            try:
                meta = json.loads(backend.get_value(key))
            except (KeyError, ValueError, UnicodeDecodeError):
                # parse-shaped failures only (JSONDecodeError is a
                # ValueError; KeyError = version pruned between list and
                # read): a transient I/O error (OSError, S3 throttling)
                # must PROPAGATE — falling back there would silently roll
                # state back and re-deliver recorded input
                corrupt.append(version)
                continue
            if version > self._version:
                self._version = version
                self.current = meta
        newer_corrupt = [v for v in corrupt if v > self._version]
        if newer_corrupt:
            self.fell_back_from = max(newer_corrupt)
            import logging

            logging.getLogger("pathway_tpu.persistence").warning(
                "metadata version %d is truncated/corrupt (torn write); "
                "falling back to version %d",
                self.fell_back_from,
                self._version,
            )

    def commit(self, meta: dict[str, Any]) -> None:
        self._version += 1
        self._backend.put_value(
            f"{_META_PREFIX}{self._version:08d}",
            json.dumps(meta).encode(),
        )
        self.current = meta

    def prune(self, keep: int = 2) -> None:
        """Remove superseded metadata versions. First call sweeps the whole
        backlog (heals anything a crash between commit and prune left
        behind); afterwards each commit deletes exactly one stale version —
        O(1) per commit, one listing per process lifetime."""
        stale = self._version - keep
        if stale < 0:
            return
        if not self._swept:
            for key in self._backend.list_keys():
                if not key.startswith(_META_PREFIX):
                    continue
                try:
                    version = int(key[len(_META_PREFIX):])
                except ValueError:
                    continue
                if version <= stale:
                    self._backend.remove_key(key)
            self._swept = True
        else:
            self._backend.remove_key(f"{_META_PREFIX}{stale:08d}")


class SnapshotWriter:
    """Buffers (time, pid, delta) entries; ``flush`` appends one chunk
    (``input_snapshot.rs:217`` WriteSnapshotEvent)."""

    def __init__(self, backend: PersistenceBackend, n_existing_chunks: int):
        self._backend = backend
        self._seq = n_existing_chunks
        self._buffer: list[tuple[int, str, tuple]] = []

    def record(self, time: int, pid: str, delta: Delta) -> None:
        self._buffer.append((time, pid, _delta_parts(delta)))

    @property
    def buffered_count(self) -> int:
        return len(self._buffer)

    def truncate(self, n: int) -> None:
        """Drop buffered entries beyond position ``n`` (the close() path
        flushes only the prefix consistent with its offset snapshot)."""
        del self._buffer[n:]

    @property
    def n_chunks(self) -> int:
        return self._seq

    def flush(self) -> tuple[int, int] | None:
        """Write buffered entries as one chunk. Returns (seq, max_time) of
        the written chunk (None if nothing buffered) — the span feeds chunk
        truncation once an operator snapshot covers it."""
        if not self._buffer:
            return None
        blob = pickle.dumps(self._buffer, protocol=pickle.HIGHEST_PROTOCOL)
        self._backend.put_value(f"{_CHUNK_PREFIX}{self._seq:08d}", blob)
        seq = self._seq
        max_time = max(int(t) for t, _, _ in self._buffer)
        self._seq += 1
        self._buffer = []
        return seq, max_time


class SnapshotReader:
    """Reads finalized chunks (those covered by metadata) back as
    time-ordered batches (``input_snapshot.rs:67`` ReadInputSnapshot)."""

    def __init__(
        self, backend: PersistenceBackend, n_chunks: int, first_chunk: int = 0
    ):
        self._backend = backend
        self._n_chunks = n_chunks
        self._first_chunk = first_chunk

    def batches(self, after_time: int = -1):
        """Yield persisted (time, pid, delta) entries with time >
        after_time, in commit order (nondecreasing in time by
        construction). A generator: replay/recovery memory stays O(chunk)
        — one chunk blob decoded at a time — never O(history). Chunks
        below ``first_chunk`` were truncated — their content is covered by
        an operator snapshot and never read again (O(state) restart)."""
        for seq in range(self._first_chunk, self._n_chunks):
            key = f"{_CHUNK_PREFIX}{seq:08d}"
            blob = self._backend.get_value(key)
            for time, pid, parts in load_blob(blob, self._backend, key):
                if int(time) > after_time:
                    yield int(time), pid, _delta_from_parts(parts)


class OperatorSnapshots:
    """Chunked per-operator state blobs (``operator_snapshot.rs:130-293``):
    one pickled state per stateful operator per snapshot version, split into
    bounded-size chunks (object stores cap value sizes; chunk writes also
    bound peak memory on read). Keys:

    ``ops/{rank:04d}/t{time}-{chunk:04d}``

    where ``rank`` is the operator's position among the graph's stateful
    nodes in deterministic build order, and ``time`` the snapshot's logical
    time. Metadata (held by the manager) maps each snapshot version to the
    per-rank ``{"cls", "at", "chunks"}`` descriptors; a clean operator's new
    version re-references the blob written at an earlier ``at`` instead of
    rewriting identical bytes — the compaction analog."""

    CHUNK_BYTES = 8 << 20

    def __init__(self, backend: PersistenceBackend):
        self._backend = backend

    @staticmethod
    def _key(rank: int, at: int, chunk: int) -> str:
        return f"{_OPS_PREFIX}{rank:04d}/t{at}-{chunk:04d}"

    def write(self, rank: int, at: int, state: Any) -> int:
        """Pickle + chunk one operator's state; returns chunk count."""
        blob = pickle.dumps(state, protocol=pickle.HIGHEST_PROTOCOL)
        n_chunks = max(1, -(-len(blob) // self.CHUNK_BYTES))
        for c in range(n_chunks):
            part = blob[c * self.CHUNK_BYTES:(c + 1) * self.CHUNK_BYTES]
            self._backend.put_value(self._key(rank, at, c), part)
        return n_chunks

    def read(self, rank: int, at: int, n_chunks: int) -> Any:
        blob = b"".join(
            self._backend.get_value(self._key(rank, at, c))
            for c in range(n_chunks)
        )
        return load_blob(blob, self._backend, self._key(rank, at, 0))

    # -- streaming parts format (spill-aware operators) -------------------
    #
    # An operator whose state is partially spilled to disk must not
    # materialize every spilled segment resident just to snapshot it —
    # commit-time peak RSS would be bounded by its TOTAL state, not the
    # memory budget. ``write_parts`` consumes an ITERATOR of picklable
    # parts (the operator loads one spilled segment at a time), framing
    # each part with an 8-byte length prefix and flushing chunks as the
    # buffer passes CHUNK_BYTES: peak memory = one part + one chunk.
    # Descriptors carry ``"fmt": "parts"``; the monolithic format stays
    # readable and is what the resharder writes.

    def write_parts(self, rank: int, at: int, parts: Any) -> int:
        import struct

        buf = bytearray()
        n = 0
        for part in parts:
            blob = pickle.dumps(part, protocol=pickle.HIGHEST_PROTOCOL)
            buf += struct.pack("<Q", len(blob))
            buf += blob
            del blob
            while len(buf) >= self.CHUNK_BYTES:
                self._backend.put_value(
                    self._key(rank, at, n), bytes(buf[: self.CHUNK_BYTES])
                )
                del buf[: self.CHUNK_BYTES]
                n += 1
        if buf or n == 0:
            self._backend.put_value(self._key(rank, at, n), bytes(buf))
            n += 1
        return n

    def read_parts(self, rank: int, at: int, n_chunks: int):
        """Yield the parts ``write_parts`` framed, reading chunks lazily
        (one blob resident at a time)."""
        import struct

        buf = bytearray()
        next_chunk = 0

        def fill(need: int) -> None:
            nonlocal next_chunk
            while len(buf) < need and next_chunk < n_chunks:
                buf.extend(
                    self._backend.get_value(self._key(rank, at, next_chunk))
                )
                next_chunk += 1
            if len(buf) < need:
                raise EOFError(
                    f"operator snapshot rank {rank} at t={at}: truncated "
                    f"parts stream (need {need} bytes, have {len(buf)})"
                )

        while True:
            # probe: pull chunks until bytes appear or the stream ends
            # (a zero-part snapshot is one empty chunk)
            while not buf and next_chunk < n_chunks:
                buf.extend(
                    self._backend.get_value(self._key(rank, at, next_chunk))
                )
                next_chunk += 1
            if not buf:
                return
            fill(8)
            (size,) = struct.unpack("<Q", bytes(buf[:8]))
            fill(8 + size)
            part = load_blob(
                bytes(buf[8 : 8 + size]), self._backend,
                self._key(rank, at, next_chunk - 1),
            )
            del buf[: 8 + size]
            yield part

    def drop(self, rank: int, at: int, n_chunks: int) -> None:
        for c in range(n_chunks):
            self._backend.remove_key(self._key(rank, at, c))


def read_op_state(ops: "OperatorSnapshots", rank: int, desc: dict,
                  node_cls: Any) -> Any:
    """Materialized operator state from a snapshot descriptor, whichever
    format it carries — the one read path the manager, the resharder and
    recovery all share."""
    if desc.get("fmt") == "parts":
        return node_cls.state_from_parts(
            ops.read_parts(rank, int(desc["at"]), int(desc["chunks"]))
        )
    return ops.read(rank, int(desc["at"]), int(desc["chunks"]))
