"""``pw.io.python`` — custom python sources (ConnectorSubject).

Re-design of ``python/pathway/io/python/__init__.py:349`` (ConnectorSubject)
+ the Rust ``PythonReader`` (``src/connectors/data_storage.rs:835``). The
subject's ``run()`` executes on a dedicated reader thread (exactly the
reference's connector-thread model, ``src/connectors/mod.rs:427``), emitting
rows via ``next``/``next_json``/``next_str`` into a queue; ``commit()``
closes a logical-time batch. The engine's streaming event loop polls the
queue and mints one commit timestamp per batch
(``engine/executor.RealtimeSource``).

Copy of ``pathway_tpu/io/python.py``. Keys are derived by
``keys.mix_columns_fused``, which folds object key columns in one pass of the
native module, as the reference's does; a columnar batch reaches the engine as
a connector wire frame (``parallel/frames.py``), passed by reference. The
ingest stage split (``INGEST_STAGE_STATS``, ``INGEST_CONNECTOR_STATS``) is on
under ``PATHWAY_PROFILE`` (default on), the reference's switch; the port has
no sampling profiler behind it.
"""

from __future__ import annotations

import json
import queue
import threading
import time as _time
from typing import Any

import numpy as np

from ..engine import keys as K
from ..engine.delta import Delta, rows_to_columns
from ..engine.executor import RealtimeSource
from ..internals.parse_graph import Universe
from ..internals.schema import SchemaMetaclass
from ..internals.table import Table

_COMMIT = object()
_DONE = object()


class _Batch:
    __slots__ = ("data", "diffs", "ingest_ns", "keys", "key_names", "frame")

    def __init__(self, data: dict[str, Any], diffs: Any):
        self.data = data
        self.diffs = diffs
        #: ingest wall-time stamp: when the connector handed these rows
        #: to the engine — the ingest→emit latency anchor
        #: (observability signals plane, EngineStats.e2e_latency_hist)
        self.ingest_ns = _time.time_ns()
        #: set by the source's pre-builder on the SUBJECT thread (fused
        #: key derivation): schema-ordered normalized columns land in
        #: ``data`` and the vectorized row keys here, so the engine
        #: thread's poll skips the whole delta-build + string-hash pass
        #: — the post-fusion wordcount bottleneck (PR 14 headroom note)
        self.keys: Any = None
        self.key_names: tuple | None = None
        #: the finished connector batch AS a wire frame
        #: (``parallel.frames.connector_frame``): in process it carries
        #: the built Delta by reference — the engine-side poll opens it
        #: and asserts identity (zero-copy, LocalComm.exchange contract)
        self.frame: Any = None


#: process-wide ingest-build accounting (read by bench.py's ingest-split
#: extra block): ns spent building batch deltas on subject (producer)
#: threads vs on the engine thread, and the rows covered by each
INGEST_BUILD_STATS = {
    "subject_ns": 0,
    "subject_rows": 0,
    "engine_ns": 0,
    "engine_rows": 0,
}

#: staged ingest cost split riding the INGEST_BUILD_STATS seam — the
#: continuous-profiling plane's answer to ROADMAP item 2: "string hashing
#: + delta building ~60% of wall" must be a measured, regression-gated
#: number, not folklore. parse = raw values → schema-ordered normalized
#: columns; hash = vectorized row-key derivation (K.mix_columns); delta =
#: Delta assembly + per-flush concat. Accrued only while the profiling
#: plane is on (PATHWAY_PROFILE, same kill switch as the sampler);
#: surfaces: pathway_ingest_stage_seconds on /metrics, ingest.* signals
#: series, the `pathway-tpu top` ingest line, bench's ingest_stage_split.
INGEST_STAGE_STATS = {
    "parse_ns": 0,
    "hash_ns": 0,
    "delta_ns": 0,
    "rows": 0,
    "flushes": 0,
}

#: the same staged split, keyed by connector (the subject's
#: ``datasource_name``, or the fs source's ``fs-<format>``): the
#: aggregate line above says ingest is the bottleneck, this says WHICH
#: source — `pathway-tpu top` / the profiling hub's /query render one
#: line per connector from it
INGEST_CONNECTOR_STATS: dict[str, dict[str, int]] = {}


def _connector_stage(name: str) -> dict[str, int]:
    s = INGEST_CONNECTOR_STATS.get(name)
    if s is None:
        s = INGEST_CONNECTOR_STATS[name] = {
            "parse_ns": 0, "hash_ns": 0, "delta_ns": 0,
            "rows": 0, "flushes": 0,
        }
    return s


def _stages_on() -> bool:
    """``PATHWAY_PROFILE`` (default on), re-read per call like the
    reference's ``observability.profiler.enabled``."""
    from ..internals.config import _env_bool

    return _env_bool("PATHWAY_PROFILE", True)


def _stage_sinks(conn: str):
    """(global split, per-connector split) when profiling is on, else
    None — every parse path accrues through exactly this pair."""
    if not _stages_on():
        return None
    return (INGEST_STAGE_STATS, _connector_stage(conn))


def _accrue(sinks, key: str, v: int) -> None:
    sinks[0][key] += v
    sinks[1][key] += v


class _SourceError:
    def __init__(self, exc: BaseException):
        self.exc = exc


class ConnectorSubject:
    """Subclass and override ``run()``; call ``self.next(**fields)`` per row
    and optionally ``self.commit()`` to close a batch."""

    #: rows buffered on the emitting thread before one queue put — the
    #: cross-thread SimpleQueue handoff costs ~1.3µs/row, which dominated
    #: the per-row ingestion path at 256 rows/put it is noise
    _CHUNK = 256
    #: max staleness of a buffered row before it is pushed anyway (matches
    #: the engine loop's idle park interval, executor._run_streaming)
    _MAX_HOLD_S = 0.005

    def __init__(self, datasource_name: str = "python"):
        #: names this subject in the per-connector ingest stage split
        #: (INGEST_CONNECTOR_STATS → `pathway-tpu top` / hub /query)
        self.datasource_name = datasource_name
        # SimpleQueue: C-implemented puts/gets, ~10x cheaper than Queue —
        # the per-row cross-thread handoff is the ingestion hot path
        self._queue: "queue.SimpleQueue[Any]" = queue.SimpleQueue()
        self._buf: list = []
        self._buf_lock = threading.Lock()
        self._buf_flushed_at = 0.0
        self._buf_t0_ns = 0
        #: True while every buffered entry is a bare kwargs dict (plain
        #: ``next()`` rows) — rides the chunk so the engine-side delta
        #: build skips its per-entry type scan on the hot path
        self._buf_plain = True
        #: set when the engine requests shutdown; long-running ``run`` loops
        #: must check ``self.stopped`` (the reference reader threads exit
        #: when the main loop drops the channel, src/connectors/mod.rs:427)
        self._stopped = False
        self._on_stop_lock = threading.Lock()
        self._on_stop_fired = False

    # -- emission API (reference io/python: next_json / next_str / next) --

    def _emit(self, entry: "tuple | dict", plain: bool = True) -> None:
        # entry: bare kwargs dict (diff=+1 row) or (diff, fields, key) tuple
        # size-triggered flush only: the per-row path must stay lean, so
        # time-based flushing of a lingering buffer is the engine side's
        # job (_flush_stale, called from every poll)
        with self._buf_lock:
            buf = self._buf
            if not buf:
                # ingest stamp = when the chunk's FIRST row arrived (the
                # oldest row bounds the batch's end-to-end latency)
                self._buf_t0_ns = _time.time_ns()
            if not plain:
                self._buf_plain = False
            buf.append(entry)
            if len(buf) >= self._CHUNK:
                self._queue.put((self._buf_t0_ns, buf, self._buf_plain))
                self._buf = []
                self._buf_plain = True
                self._buf_flushed_at = _time.monotonic()

    def _flush_rows(self) -> None:
        with self._buf_lock:
            if self._buf:
                self._queue.put((self._buf_t0_ns, self._buf, self._buf_plain))
                self._buf = []
                self._buf_plain = True
                self._buf_flushed_at = _time.monotonic()

    def _flush_stale(self) -> None:
        """Engine-side flush of rows held past the staleness bound (called
        from poll; the emitting thread may be blocked and never flush)."""
        if self._buf and (
            _time.monotonic() - self._buf_flushed_at > self._MAX_HOLD_S
        ):
            self._flush_rows()

    def next(self, **kwargs: Any) -> None:
        # hot path: a bare kwargs dict means (diff=+1, no explicit key) —
        # no wrapper tuple; retractions/keyed rows use the
        # (diff, fields, key) tuple entry form via the same _emit
        self._emit(kwargs)

    def next_batch(self, data: dict[str, Any], diffs: Any = None) -> None:
        """Columnar fast lane: emit many rows at once as column lists/arrays
        (all the same length). The engine hashes keys and builds the delta
        vectorized — use this from sources that naturally read in blocks
        (file chunks, kafka poll batches) for high-throughput ingestion."""
        # snapshot columns AND diffs NOW, on the subject thread: the engine
        # drains the queue later, and a subject refilling one preallocated
        # buffer (ndarray or list) across next_batch calls must not alias
        # engine state (the per-array hash memo in engine/keys.py relies on
        # column immutability)
        data = {
            k: (v.copy() if isinstance(v, np.ndarray)
                else list(v) if isinstance(v, list) else v)
            for k, v in data.items()
        }
        if isinstance(diffs, np.ndarray):
            diffs = diffs.copy()
        elif isinstance(diffs, list):
            diffs = list(diffs)
        self._flush_rows()  # arrival order: buffered rows precede the batch
        batch = _Batch(data, diffs)
        builder = getattr(self, "_batch_builder", None)
        if builder is not None:
            # fused key derivation: normalize columns + hash row keys HERE,
            # on the producer thread, overlapping with engine compute —
            # the engine-side poll then just slices and wraps. A build
            # error surfaces exactly like any other subject failure
            # (_SourceError via ConnectorSubject.start's catch).
            builder(batch)
        self._queue.put(batch)

    def next_json(self, message: dict | str) -> None:
        if isinstance(message, str):
            message = json.loads(message)
        self.next(**message)

    def next_str(self, message: str) -> None:
        self.next(data=message)

    def next_bytes(self, message: bytes) -> None:
        self.next(data=message)

    def _remove(self, **kwargs: Any) -> None:
        """Retract a previously emitted row (matched by content)."""
        self._emit((-1, kwargs, None), plain=False)

    def _next_with_key(self, key: int, diff: int = 1, **kwargs: Any) -> None:
        """Emit a row under an explicit engine key (rest_connector plumbing)."""
        self._emit((diff, kwargs, key), plain=False)

    def commit(self) -> None:
        self._flush_rows()
        self._queue.put(_COMMIT)
        waker = getattr(self, "_waker", None)
        if waker is not None:
            waker.set()  # end the engine loop's park immediately

    def close(self) -> None:
        self._flush_rows()
        self._queue.put(_DONE)
        waker = getattr(self, "_waker", None)
        if waker is not None:
            waker.set()

    def on_stop(self) -> None:
        pass

    @property
    def stopped(self) -> bool:
        """True once the engine has requested shutdown. Long-running ``run``
        loops should poll this (``while not self.stopped: ...``) so reader
        threads terminate promptly on engine teardown."""
        return self._stopped

    def _fire_on_stop(self) -> None:
        """Run ``on_stop`` exactly once, on the reader thread (it may close
        clients the run loop is still using — never call concurrently)."""
        with self._on_stop_lock:
            if self._on_stop_fired:
                return
            self._on_stop_fired = True
        self.on_stop()

    def run(self) -> None:
        raise NotImplementedError

    def start(self) -> None:
        try:
            self.run()
        except BaseException as e:  # surfaced by the engine loop, not lost
            self._flush_rows()  # rows emitted before the failure stay ahead
            self._queue.put(_SourceError(e))
        finally:
            self._stopped = True
            self._fire_on_stop()
            # commit() is optional: a run() that just returns must not
            # strand its buffered tail behind _DONE
            self._flush_rows()
            self._queue.put(_DONE)


class PythonSubjectSource(RealtimeSource):
    """Engine source draining a ConnectorSubject's queue
    (the PythonReader analog)."""

    def __init__(
        self,
        subject: ConnectorSubject,
        names: list[str],
        defaults: dict[str, Any],
        pk_indices: list[int] | None,
        autocommit_ms: int | None,
        dtypes: dict[str, Any] | None = None,
    ):
        super().__init__(names)
        self.subject = subject
        self.names = names
        self.defaults = defaults
        self.pk_indices = pk_indices
        self.autocommit_ms = autocommit_ms
        # columns whose DECLARED schema dtype is float: values are
        # normalized to float64 before key hashing, so a row's key is a
        # function of the row alone — never of which flush batch it rode
        # in (a mixed int/float batch promotes the whole column to
        # float64 while an all-int batch stays int64, and int 1 and
        # float 1.0 hash differently; a retraction landing in a
        # differently-typed batch then misses its row → ghost rows /
        # negative multiplicities; advisor-high python.py:261)
        from ..internals import dtype as dt

        self._float_cols = frozenset(
            name
            for name, dtc in (dtypes or {}).items()
            if dt.unoptionalize(dtc) == dt.FLOAT
        )
        # columns whose DECLARED dtype is STR/BYTES: schema-aware dtype
        # promotion — they land as object columns by declaration, so the
        # per-entry ``column_of_values`` type scan is skipped entirely
        # on the rowwise hot path (the columnar-ingest contract: the
        # schema, not the batch contents, picks the column dtype)
        self._obj_cols = frozenset(
            name
            for name, dtc in (dtypes or {}).items()
            if dt.unoptionalize(dtc) in (dt.STR, dt.BYTES)
        )
        self._conn_name = getattr(subject, "datasource_name", "python")
        self._partial: list[tuple[int, tuple, int | None]] = []  # (diff, row, key)
        #: AND of the plain-chunk flags accumulated into _partial — True
        #: means every entry is a bare kwargs dict, so the delta build
        #: skips its per-entry type scan
        self._partial_plain = True
        #: backlogged commit windows drained in ONE poll beyond this
        #: count are coalesced into a single delta (one engine tick):
        #: when the producer outruns the engine, per-window sweeps are
        #: pure overhead — the rows are already consolidated by the
        #: downstream operators at one logical time. 0 disables (every
        #: commit window keeps its own tick).
        import os as _os

        self._coalesce_windows = int(
            _os.environ.get("PATHWAY_INGEST_COALESCE_WINDOWS", "8")
        )
        #: deltas built within the current commit window (columnar batches +
        #: flushed row runs), concatenated into ONE delta per commit
        self._pending: list[Delta] = []
        #: oldest ingest wall-time (ns) among rows in the open commit
        #: window; per emitted delta it lands in _out_ingest, aligned
        #: with poll()'s return (take_ingest_stamps drains it)
        self._window_ingest_ns: int | None = None
        self._out_ingest: list[int | None] = []
        self._last_flush = _time.monotonic()
        self._done = False
        self._thread: threading.Thread | None = None
        self._emitted = 0  # rows delivered to the engine (offset state)
        self._skip = 0  # rows to drop after a recovery seek

    #: set False by the executor for stateless dataflows (suspended key
    #: registration is thread-local to the executor thread, so the
    #: subject-thread builder must be told explicitly)
    _keys_register = True
    #: class-level defaults (also cover sources built piecemeal in tests)
    _conn_name = "python"
    _obj_cols: frozenset = frozenset()

    def start(self) -> None:
        # install the fused batch builder BEFORE the reader thread exists:
        # every next_batch() then normalizes columns and hashes keys on
        # the producer thread (io/python module docstring: the reference's
        # connector-thread model — here the thread also pays the
        # delta-build so the engine loop does not)
        self.subject._batch_builder = self._prebuild_batch
        self._thread = threading.Thread(target=self.subject.start, daemon=True)
        self._thread.start()

    def _prebuild_batch(self, batch: _Batch) -> None:
        """Producer-thread half of the batch path: columns → schema-ordered
        normalized arrays + vectorized row keys + the finished Delta,
        wrapped as a connector wire frame (pure per-row work; the
        engine-side poll keeps the skip/offset bookkeeping). Bit-identical
        to the engine-side build — ``K.mix_columns`` over the same
        normalized columns."""
        stage = _stage_sinks(self._conn_name)
        t0 = _time.perf_counter_ns()
        data, n = self._batch_columns(batch)
        t1 = _time.perf_counter_ns() if stage is not None else 0
        if self.pk_indices is not None:
            key_names = tuple(self.names[i] for i in self.pk_indices)
        else:
            key_names = tuple(self.names)
        batch.data = data
        batch.keys = K.mix_columns_fused(
            [data[c] for c in key_names], n, register=self._keys_register
        )
        batch.key_names = key_names
        t2 = _time.perf_counter_ns()
        if stage is not None:
            _accrue(stage, "parse_ns", t1 - t0)
            _accrue(stage, "hash_ns", t2 - t1)
        # assemble the Delta here too and ship it as a wire frame: the
        # engine-side poll then just opens the frame (pass-by-reference
        # in process — the columnar-ingest zero-copy seam)
        from ..parallel import frames as _frames

        diffs = (
            np.ones(n, dtype=np.int64)
            if batch.diffs is None
            else np.asarray(batch.diffs, dtype=np.int64)
        )
        d = Delta(keys=batch.keys, data=data, diffs=diffs)
        # key provenance for the fusion content-key reuse fast path
        d.keys_content_cols = key_names
        batch.frame = _frames.connector_frame(d)
        t3 = _time.perf_counter_ns()
        if stage is not None:
            _accrue(stage, "delta_ns", t3 - t2)
        INGEST_BUILD_STATS["subject_ns"] += t3 - t0
        INGEST_BUILD_STATS["subject_rows"] += n

    def attach_waker(self, event) -> None:
        self.waker = event
        self.subject._waker = event

    def _make_delta(
        self,
        entries: list[tuple[int, dict, int | None]],
        plain: bool = False,
    ) -> Delta:
        # the offset covers exactly the rows delivered to the engine as
        # deltas — never rows still sitting in _partial, which would be
        # lost on recovery (persisted offset past unsnapshotted input).
        #
        # Columnar-first: the per-row ``next(**fields)`` entries keep their
        # kwargs dicts until here, where each schema column is extracted in
        # ONE comprehension and keys are hashed vectorized (``mix_columns``
        # over columns is bit-identical to ``hash_values`` over the
        # corresponding row tuples) — no per-row tuple building, no
        # rows->columns transpose (VERDICT r4 #4, the per-row API tax).
        from ..engine.delta import _object_column, column_of_values

        stage = _stage_sinks(self._conn_name)
        t0 = _time.perf_counter_ns() if stage is not None else 0
        self._emitted += len(entries)
        n = len(entries)
        # entries are bare kwargs dicts (next(): diff=+1, no key) or
        # (diff, fields, key) tuples (_remove / _next_with_key); the
        # chunk-level plain flag (stamped at _emit time) spares the
        # per-entry type scan on the hot all-dict path
        if not plain:
            plain = all(type(e) is dict for e in entries)
        fields_list = (
            entries if plain else [e if type(e) is dict else e[1] for e in entries]
        )
        import operator as _operator

        data: dict[str, np.ndarray] = {}
        for name in self.names:
            try:
                # C-speed extraction; rows missing the column (schema
                # defaults) fall to the .get comprehension below
                col = list(map(_operator.itemgetter(name), fields_list))
            except KeyError:
                dflt = self.defaults.get(name)
                col = [f.get(name, dflt) for f in fields_list]
            if name in self._obj_cols:
                # schema-aware promotion: a declared STR/BYTES column IS
                # an object column — no per-entry type scan
                data[name] = _object_column(col)
            else:
                data[name] = self._normalize(name, column_of_values(col))
        t_parse = _time.perf_counter_ns() if stage is not None else 0
        if stage is not None:
            _accrue(stage, "parse_ns", t_parse - t0)
        if plain:
            diffs = np.ones(n, dtype=np.int64)
        else:
            diffs = np.fromiter(
                (1 if type(e) is dict else e[0] for e in entries),
                np.int64, count=n,
            )
        key_cols = (
            [data[self.names[i]] for i in self.pk_indices]
            if self.pk_indices is not None
            else list(data.values())
        )
        explicit = (
            []
            if plain
            else [
                i for i, e in enumerate(entries)
                if type(e) is not dict and e[2] is not None
            ]
        )
        if not explicit:
            h0 = _time.perf_counter_ns() if stage is not None else 0
            keys = K.mix_columns_fused(key_cols, n)
            h1 = _time.perf_counter_ns() if stage is not None else 0
            out = Delta(keys=keys, data=data, diffs=diffs)
            out.keys_content_cols = tuple(
                self.names[i] for i in self.pk_indices
            ) if self.pk_indices is not None else tuple(self.names)
            if stage is not None:
                # everything past the column extraction that is not the
                # hash pass (diffs + Delta assembly) counts as delta
                hash_dt = h1 - h0
                _accrue(stage, "hash_ns", hash_dt)
                _accrue(
                    stage, "delta_ns",
                    _time.perf_counter_ns() - t_parse - hash_dt,
                )
            return out
        # rows carrying an explicit key never USE their derived key —
        # registering it would poison the 128-bit conflation registry
        # with dead entries (and a later legitimate use of the same
        # content key would false-collide). Derive + register only
        # the surviving rows (advisor-low python.py:279). No content
        # provenance either: explicit keys break the keys==fold(cols)
        # invariant the fusion key-reuse fast path depends on.
        keys = np.empty(n, dtype=np.uint64)
        keep = np.ones(n, dtype=bool)
        keep[explicit] = False
        hash_dt = 0
        if keep.any():
            h0 = _time.perf_counter_ns() if stage is not None else 0
            keys[keep] = K.mix_columns_fused(
                [np.asarray(c)[keep] for c in key_cols], int(keep.sum())
            )
            if stage is not None:
                hash_dt = _time.perf_counter_ns() - h0
        for i in explicit:
            keys[i] = entries[i][2]
        out = Delta(keys=keys, data=data, diffs=diffs)
        if stage is not None:
            _accrue(stage, "hash_ns", hash_dt)
            _accrue(
                stage, "delta_ns",
                _time.perf_counter_ns() - t_parse - hash_dt,
            )
        return out

    def _normalize(self, name: str, arr: np.ndarray) -> np.ndarray:
        """Coerce a column's values to the DECLARED schema dtype before
        key hashing. Only float declarations need this: ``column_of_values``
        picks the densest dtype of whatever one flush batch happens to
        hold, so the same logical row could hash as int64 in one batch
        and float64 in another — its key would depend on its batch
        neighbors (ghost rows on retraction). Normalizing against the
        schema makes the key a pure function of the row."""
        if name not in self._float_cols or arr.dtype == np.float64:
            return arr
        if arr.dtype.kind in "iubf":
            return arr.astype(np.float64)
        if arr.dtype == object:
            # optional float columns: coerce numeric cells, keep None &co
            from ..engine.delta import column_of_values

            out = np.empty(len(arr), dtype=object)
            changed = False
            for i, v in enumerate(arr):
                if isinstance(v, float):
                    out[i] = v
                elif isinstance(v, (int, np.integer, np.floating)):
                    out[i] = float(v)
                    changed = True
                else:
                    out[i] = v
            if not changed:
                return arr
            return column_of_values(list(out))
        return arr

    def _batch_columns(
        self, batch: _Batch
    ) -> tuple[dict[str, np.ndarray], int]:
        """Pure half of the batch build: raw snapshot columns →
        schema-ordered, declared-dtype-normalized arrays + row count."""
        from ..engine.delta import column_of_values

        data: dict[str, np.ndarray] = {}
        n = None
        for name, col in batch.data.items():
            # ndarrays were snapshotted at next_batch() enqueue time —
            # the engine owns them from here on
            arr = (
                col
                if isinstance(col, np.ndarray) and col.ndim == 1
                # lists were snapshotted at enqueue — owned, no second copy
                else column_of_values(
                    col if isinstance(col, list) else list(col)
                )
            )
            if n is None:
                n = len(arr)
            elif len(arr) != n:
                raise ValueError("next_batch columns must share one length")
            data[name] = arr
        if n is None:
            raise ValueError("next_batch needs at least one column")
        for name in self.names:
            if name not in data:
                fill = self.defaults.get(name)
                data[name] = column_of_values([fill] * n)
        # schema order + declared-dtype normalization (same key-stability
        # contract as the row path: keys must not depend on the batch)
        return (
            {name: self._normalize(name, data[name]) for name in self.names},
            n,
        )

    def _make_batch_delta(self, batch: _Batch) -> Delta | None:
        """Columnar batch → Delta with vectorized key hashing.
        ``K.mix_columns`` over columns is bit-identical to ``hash_values``
        over the corresponding row tuples (same per-scalar digests), so
        row-wise and batch emission produce the same keys. The normalize +
        hash pass normally already ran on the SUBJECT thread
        (_prebuild_batch, fused key derivation); this engine-side path
        keeps only the skip/offset bookkeeping then — the fallback build
        covers batches enqueued before the source started."""
        stage = _stage_sinks(self._conn_name)
        if batch.frame is not None and self._skip == 0:
            # the connector batch arrived AS a wire frame: open it and
            # hand the Delta straight through. In process the frame is
            # passed by reference, never serialized — the engine reads
            # the very column buffers the producer thread filled
            # (LocalComm.exchange's zero-copy contract, asserted here)
            from ..parallel import frames as _frames

            t_open = _time.perf_counter_ns() if stage is not None else 0
            d = _frames.open_connector_frame(batch.frame)
            assert d.data is batch.data, (
                "connector frame must pass by reference in-process"
            )
            self._emitted += len(d)
            if stage is not None:
                _accrue(
                    stage, "delta_ns", _time.perf_counter_ns() - t_open
                )
            return d
        if batch.keys is not None:
            data, n, keys = batch.data, len(batch.keys), batch.keys
            key_names = batch.key_names
            t_built = _time.perf_counter_ns() if stage is not None else 0
        else:
            t0 = _time.perf_counter_ns()
            data, n = self._batch_columns(batch)
            t1 = _time.perf_counter_ns() if stage is not None else 0
            if self.pk_indices is not None:
                key_names = tuple(self.names[i] for i in self.pk_indices)
            else:
                key_names = tuple(self.names)
            keys = K.mix_columns_fused([data[c] for c in key_names], n)
            t_built = _time.perf_counter_ns()
            if stage is not None:
                _accrue(stage, "parse_ns", t1 - t0)
                _accrue(stage, "hash_ns", t_built - t1)
            INGEST_BUILD_STATS["engine_ns"] += t_built - t0
            INGEST_BUILD_STATS["engine_rows"] += n
        # recovery seek already counted skipped rows into _emitted
        if self._skip >= n:
            self._skip -= n
            return None
        start = 0
        if self._skip:
            start = self._skip
            self._skip = 0
            data = {c: a[start:] for c, a in data.items()}
            keys = keys[start:]
            n -= start
        self._emitted += n
        diffs = (
            np.ones(n, dtype=np.int64)
            if batch.diffs is None
            else np.asarray(batch.diffs, dtype=np.int64)[start:]
        )
        out = Delta(keys=keys, data=data, diffs=diffs)
        # key provenance for the fusion content-key reuse fast path
        # (engine/fusion.py): these keys are a pure fold of exactly
        # these columns at salt 0 — a downstream groupby/join keying on
        # the same columns reuses them bit-for-bit
        out.keys_content_cols = tuple(key_names)
        if stage is not None:
            # skip/slice bookkeeping + Delta wrap (the whole engine-side
            # cost of a prebuilt batch)
            _accrue(stage, "delta_ns", _time.perf_counter_ns() - t_built)
        return out

    def _flush_partial(self) -> None:
        if self._partial:
            t0 = _time.perf_counter_ns()
            n = len(self._partial)
            self._pending.append(
                self._make_delta(self._partial, self._partial_plain)
            )
            INGEST_BUILD_STATS["engine_ns"] += _time.perf_counter_ns() - t0
            INGEST_BUILD_STATS["engine_rows"] += n
            self._partial = []
            self._partial_plain = True

    def _note_ingest(self, t0_ns: int | None) -> None:
        if t0_ns:
            if (
                self._window_ingest_ns is None
                or t0_ns < self._window_ingest_ns
            ):
                self._window_ingest_ns = t0_ns

    def _close_commit(self, out: list[Delta]) -> None:
        self._flush_partial()
        if self._pending:
            from ..engine.delta import concat_deltas

            stage = _stage_sinks(self._conn_name)
            t0 = _time.perf_counter_ns()
            d = (
                self._pending[0]
                if len(self._pending) == 1
                else concat_deltas(self._pending, self.names)
            )
            dt = _time.perf_counter_ns() - t0
            # the per-flush concat is delta-build work: count it into the
            # engine-side build wall so the staged split sums to it
            INGEST_BUILD_STATS["engine_ns"] += dt
            if stage is not None:
                _accrue(stage, "delta_ns", dt)
                _accrue(stage, "rows", len(d))
                _accrue(stage, "flushes", 1)
            out.append(d)
            self._pending = []
            self._out_ingest.append(self._window_ingest_ns)
        self._window_ingest_ns = None

    def take_ingest_stamps(self) -> list[int | None]:
        stamps, self._out_ingest = self._out_ingest, []
        return stamps

    def poll(self) -> list[Delta]:
        # commitless sources (pure autocommit): rows the subject buffered
        # but never flushed must not strand — push them from this side
        self.subject._flush_stale()
        q = self.subject._queue
        out: list[Delta] = []
        while True:
            try:
                item = q.get_nowait()
            except queue.Empty:
                break
            if item is _DONE:
                self._done = True
                break
            if isinstance(item, _SourceError):
                # re-raise on the engine thread (reference: connector errors
                # poison the run, dataflow.rs:5674 panic propagation)
                raise RuntimeError(
                    f"connector source {type(self.subject).__name__} failed"
                ) from item.exc
            if item is _COMMIT:
                self._close_commit(out)
                self._last_flush = _time.monotonic()
                continue
            if isinstance(item, _Batch):
                self._flush_partial()  # preserve arrival order in the commit
                d = self._make_batch_delta(item)
                if d is not None and len(d):
                    self._pending.append(d)
                    self._note_ingest(item.ingest_ns)
                continue
            # a chunk of buffered rows (ConnectorSubject._emit): one queue
            # item per ~256 rows instead of one per row, stamped with the
            # wall time its first row arrived plus the plain-dict flag;
            # entries keep their kwargs dicts — _make_delta extracts
            # columns in bulk
            t0_ns, item, chunk_plain = item
            if not chunk_plain:
                self._partial_plain = False
            if self._skip > 0:
                # already persisted before restart; the restarted subject
                # re-emits its deterministic prefix (reference
                # PythonReader offset = message count, data_storage.rs:835)
                drop = min(self._skip, len(item))
                self._skip -= drop
                item = item[drop:]
                if not item:
                    continue
            self._partial.extend(item)
            self._note_ingest(t0_ns)
        now = _time.monotonic()
        flush_due = (
            self.autocommit_ms is not None
            and (now - self._last_flush) * 1000.0 >= self.autocommit_ms
        )
        if (self._partial or self._pending) and (self._done or flush_due):
            self._close_commit(out)
            self._last_flush = now
        c = self._coalesce_windows
        if c and len(out) > c:
            # backpressure coalescing: the subject outran the engine by
            # more than `c` complete commit windows this poll. Sweeping
            # each backlogged window as its own tick is pure fixed-cost
            # overhead (the downstream operators consolidate to the same
            # net state); merge the backlog into ONE delta so the engine
            # catches up at columnar speed. Offsets already cover every
            # merged row, so recovery/exactly-once bookkeeping is
            # unchanged; the merged window keeps the OLDEST ingest stamp.
            from ..engine.delta import concat_deltas

            merged = concat_deltas(out, self.names)
            stamps = self._out_ingest[-len(out):]
            keep = self._out_ingest[: len(self._out_ingest) - len(out)]
            live = [s for s in stamps if s is not None]
            self._out_ingest = keep + [min(live) if live else None]
            out = [merged]
        return out

    def is_finished(self) -> bool:
        return (
            self._done
            and not self._partial
            and not self._pending
            and self.subject._queue.empty()
        )

    def stop(self) -> None:
        # flag the subject's run loop to exit so reader threads terminate
        # and clients close on engine shutdown (advisor finding r1). on_stop
        # itself runs on the reader thread (run()'s finally) — firing it
        # here could close a client the loop is still polling; only if the
        # thread never ran (or won't exit) does teardown fire it directly.
        self.subject._stopped = True
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            if not self._thread.is_alive():
                return
        self.subject._fire_on_stop()

    def offset_state(self):
        return {"rows": self._emitted}

    def seek(self, state) -> None:
        self._skip = int(state.get("rows", 0))
        self._emitted = self._skip


def read(
    subject: ConnectorSubject,
    *,
    schema: SchemaMetaclass,
    autocommit_duration_ms: int | None = 100,
    name: str | None = None,
    **kwargs: Any,
) -> Table:
    names = schema.column_names()
    defaults = {
        n: c.default_value for n, c in schema.columns().items() if c.has_default
    }
    pk = schema.primary_key_columns()
    pk_indices = [names.index(p) for p in pk] if pk else None

    def build():
        src = PythonSubjectSource(
            subject, names, defaults, pk_indices, autocommit_duration_ms,
            dtypes=schema.dtypes(),
        )
        src.persistent_id = name
        return src

    return Table("source", [], {"build": build}, schema, Universe())


write = None  # python connector is read-only (reference parity)
