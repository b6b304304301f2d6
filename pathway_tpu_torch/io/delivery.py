"""Exactly-once output plane: transactional sink delivery for every
``pw.io`` output connector.

Re-design of the reference's connector-writer protocol
(``src/connectors/mod.rs`` writer loop + ``src/persistence``'s frontier
commits): sink output is **acked at time boundaries against the same
persisted frontier that commits offsets and operator state**, which is
what turns the engine's at-least-once callback stream into
effectively-once external output (cf. Flink two-phase-commit sinks /
Kafka transactional producers — PAPERS.md stream-processing lineage).

Every output connector builds a :class:`SinkAdapter` (how to write one
batch to the external system) and registers it via :func:`deliver`; the
engine-side :class:`DeliverySink` owns everything else:

- **Transactional delivery log.** Each sink batch is stamped with a
  monotonically increasing ``(run_id, worker, boundary_seq)`` id, where
  ``boundary_seq`` is the batch's logical tick time — deterministic
  across crash-replay, because recorded input replays at its original
  tick times (``persistence/manager.py``). After a batch is written to
  the external system, a tiny ack cursor blob is committed through the
  persistence backend (``delivery/<sink>`` key); on recovery, replayed
  batches at-or-below the cursor are skipped, so output past the last
  snapshot is *re-generated but never re-delivered*.

  With persistence on, delivery is **gated to commit boundaries**: a
  batch is released to the external system only after the metadata
  commit that makes its input durable (never ack output whose input
  could be re-read live at a fresh tick time — that is the one window
  where a time-keyed cursor cannot dedupe). The persistence manager
  calls :meth:`DeliveryManager.pre_commit_barrier` /
  :meth:`DeliveryManager.on_commit` around each metadata commit; the
  barrier (previous release fully acked) is what bounds delivery lag to
  one snapshot interval and keeps the restore-point invariant: recovery
  picks the newest operator snapshot at-or-below every sink's ack
  cursor (``recovery_floor``), so unacked output is always regenerated.

  Without persistence, batches deliver continuously (retry/breaker/DLQ/
  backpressure still apply; there is no recovery to dedupe against).

- **Unified resilience policy.** One :class:`RetryPolicy` (the
  ``io/http`` surface, generalized) with jittered exponential backoff;
  a per-sink write timeout watchdog; a per-sink circuit breaker that
  opens after consecutive exhausted retry cycles and paces re-probes;
  bounded in-flight buffering whose full queue **blocks the engine
  tick** (backpressure, never unbounded growth); and a disk-backed
  dead-letter queue for poison rows (non-retryable serialize/reject
  errors) with loud metrics instead of silent drop or a crashed worker.

Copy of ``pathway_tpu/io/delivery.py`` without the ``sink.write`` chaos site.
Under the frontier-driven (async) executor the sinks ack at commit
boundaries only (``DeliverySink.boundary_acks``,
``DeliveryManager.use_boundary_acks``); under the BSP loop every ack writes
the cursor.

Knobs: ``PATHWAY_SINK_QUEUE_BATCHES``, ``PATHWAY_SINK_RETRY_MAX``,
``PATHWAY_SINK_RETRY_FIRST_DELAY_MS``, ``PATHWAY_SINK_RETRY_BACKOFF``,
``PATHWAY_SINK_RETRY_JITTER_MS``, ``PATHWAY_SINK_TIMEOUT_S``,
``PATHWAY_SINK_BREAKER_THRESHOLD``, ``PATHWAY_SINK_BREAKER_COOLDOWN_S``,
``PATHWAY_SINK_DLQ_DIR``, ``PATHWAY_SINK_DRAIN_TIMEOUT_S``,
``PATHWAY_SINK_FSYNC``.
"""

from __future__ import annotations

import json
import logging
import os
import random
import threading
import time as _time
from collections import deque
from typing import Any, Callable, Iterator

__all__ = [
    "RetryPolicy",
    "SinkRejectedError",
    "SinkWriteTimeout",
    "SinkBatch",
    "SinkAdapter",
    "CallableAdapter",
    "DeadLetterQueue",
    "DeliveryManager",
    "DeliverySink",
    "deliver",
    "sink_stats_snapshot",
]

log = logging.getLogger("pathway_tpu_torch.io.delivery")

#: ack-cursor keys in the persistence backend (worker namespace)
_ACK_PREFIX = "delivery/"


def _env_f(name: str, default: float) -> float:
    raw = os.environ.get(name, "")
    try:
        return float(raw) if raw.strip() else default
    except ValueError:
        log.warning("%s=%r is not a number; using %s", name, raw, default)
        return default


def _env_i(name: str, default: int) -> int:
    return int(_env_f(name, float(default)))


class RetryPolicy:
    """Jittered exponential backoff policy — the one retry surface every
    sink (and ``pw.io.http``, which re-exports it) shares.

    ``max_retries`` bounds attempts per *delivery cycle*; a sink that
    exhausts a cycle is not crashed — the circuit breaker opens and the
    batch is re-attempted after the cooldown (bounded buffering
    backpressures the engine meanwhile), so a transient outage degrades
    instead of killing the worker."""

    def __init__(self, first_delay_ms: int = 1000, backoff_factor: float = 2.0,
                 jitter_ms: int = 0, max_retries: int = 5):
        self.first_delay_ms = first_delay_ms
        self.backoff_factor = backoff_factor
        self.jitter_ms = jitter_ms
        self.max_retries = max_retries

    @classmethod
    def default(cls) -> "RetryPolicy":
        return cls()

    @classmethod
    def from_env(cls) -> "RetryPolicy":
        """Policy for delivery-managed sinks, tuned by PATHWAY_SINK_RETRY_*
        (defaults favor fast convergence over politeness: sinks sit on the
        engine's drain path)."""
        return cls(
            first_delay_ms=_env_i("PATHWAY_SINK_RETRY_FIRST_DELAY_MS", 50),
            backoff_factor=_env_f("PATHWAY_SINK_RETRY_BACKOFF", 2.0),
            jitter_ms=_env_i("PATHWAY_SINK_RETRY_JITTER_MS", 20),
            max_retries=_env_i("PATHWAY_SINK_RETRY_MAX", 4),
        )

    def delay_s(self, attempt: int, rng: random.Random | None = None) -> float:
        """Sleep before retry ``attempt`` (1-based): exponential from
        ``first_delay_ms`` with uniform jitter."""
        base = (self.first_delay_ms / 1000.0) * (
            self.backoff_factor ** max(0, attempt - 1)
        )
        if self.jitter_ms:
            r = rng.random() if rng is not None else random.random()
            base += r * (self.jitter_ms / 1000.0)
        return base

    def attempts(self) -> int:
        return max(1, self.max_retries + 1)


class SinkWriteTimeout(TimeoutError):
    """The per-sink watchdog cut off a write attempt. Distinct from any
    TimeoutError an adapter's own client may raise: the watchdog leaves a
    ZOMBIE thread still inside the adapter, so recovery must reset the
    adapter (``on_timeout`` + reopen) rather than merely roll back."""


class SinkRejectedError(Exception):
    """A sink refused rows for a non-retryable reason (serialization
    failure, schema reject, 4xx). The delivery layer routes the affected
    rows — ``row_indices`` when the adapter can name them, else the whole
    batch — to the dead-letter queue and moves on. Never retried."""

    def __init__(self, message: str, row_indices: list[int] | None = None):
        super().__init__(message)
        self.row_indices = row_indices


class SinkBatch:
    """One consolidated tick delta headed to a sink, stamped with its
    transactional id ``(run_id, worker, boundary_seq)``; ``boundary_seq``
    is the tick's logical time (replay-deterministic)."""

    __slots__ = ("time", "delta", "run_id", "worker", "enqueued_at")

    def __init__(self, time: int, delta: Any, run_id: str, worker: int):
        self.time = int(time)
        self.delta = delta
        self.run_id = run_id
        self.worker = worker
        self.enqueued_at = _time.monotonic()

    @property
    def stamp(self) -> tuple[str, int, int]:
        return (self.run_id, self.worker, self.time)

    def __len__(self) -> int:
        return len(self.delta)

    def rows(self) -> Iterator[tuple[dict, int]]:
        """Yield (row dict, diff) pairs — the common adapter loop."""
        names = list(self.delta.columns)
        for _key, vals, diff in self.delta.iter_rows():
            yield dict(zip(names, vals)), int(diff)


class SinkAdapter:
    """How one external system consumes batches. Implementations live in
    the connector modules; the delivery layer owns retries, ordering,
    acks and failure policy.

    ``open(resume_token)`` is called lazily before the first write (None)
    and again after a watchdog reset, with the last acked ``write_batch``
    return — the fs family truncates externally-visible output back to it.
    ``rollback(resume_token)`` (optional) restores external state to the
    LAST ACKED position before a retry — ``resume_token`` is the last
    acked ``write_batch`` return (None when nothing acked yet). A torn write may have
    pushed partial bytes (and even partial ``write_batch`` calls)
    since then; adapters that cannot roll back re-deliver on torn
    retries (effectively-once, not byte-exact)."""

    name = "sink"

    def open(self, resume_token: Any) -> None:  # pragma: no cover - default
        pass

    def write_batch(self, batch: SinkBatch) -> Any:
        raise NotImplementedError

    def rollback(self, resume_token: Any = None) -> None:
        pass

    def close(self) -> None:
        pass


class CallableAdapter(SinkAdapter):
    """Adapter over a plain ``fn(batch)`` — connector modules that need no
    open/close lifecycle build one of these."""

    def __init__(self, fn: Callable[[SinkBatch], Any], name: str = "sink",
                 on_close: Callable[[], None] | None = None):
        self._fn = fn
        self.name = name
        self._on_close = on_close

    def write_batch(self, batch: SinkBatch) -> Any:
        return self._fn(batch)

    def rollback(self, resume_token: Any = None) -> None:
        pass

    def close(self) -> None:
        if self._on_close is not None:
            self._on_close()


class DeadLetterQueue:
    """Disk-backed poison-row log: one JSONL file per sink under
    ``PATHWAY_SINK_DLQ_DIR`` (default ``./pathway-dlq``). Every entry
    carries the original row, the error, and the batch stamp — loud
    (metrics + warning log), durable, and greppable; never a silent
    drop."""

    def __init__(self, root: str | None = None):
        self.root = root or os.environ.get(
            "PATHWAY_SINK_DLQ_DIR", "./pathway-dlq"
        )
        self._lock = threading.Lock()
        self._files: dict[str, Any] = {}

    def path_for(self, sink: str) -> str:
        return os.path.join(self.root, f"{sink}.jsonl")

    def append(self, sink: str, batch: SinkBatch, rows: list[dict],
               error: BaseException) -> int:
        """Record poison rows; returns how many were written."""
        os.makedirs(self.root, exist_ok=True)
        with self._lock:
            f = self._files.get(sink)
            if f is None:
                f = self._files[sink] = open(
                    self.path_for(sink), "a", encoding="utf-8"
                )
            for row in rows:
                f.write(json.dumps({
                    "sink": sink,
                    "stamp": list(batch.stamp),
                    "time": batch.time,
                    "row": {k: _jsonable(v) for k, v in row.items()},
                    "error": f"{type(error).__name__}: {error}",
                    "wall_ts": _time.time(),
                }) + "\n")
            f.flush()
            os.fsync(f.fileno())
        log.warning(
            "sink %s: %d poison row(s) dead-lettered to %s (%s)",
            sink, len(rows), self.path_for(sink), error,
        )
        return len(rows)

    def close(self) -> None:
        with self._lock:
            for f in self._files.values():
                try:
                    f.close()
                except Exception:
                    pass
            self._files.clear()


def _jsonable(v: Any) -> Any:
    """fs._jsonable (the shared numpy/bytes conversion) plus a repr()
    fallback: DLQ entries must ALWAYS serialize, whatever the row holds."""
    from .fs import _jsonable as _fs_jsonable

    out = _fs_jsonable(v)
    if isinstance(out, (str, int, float, bool, list, dict)) or out is None:
        return out
    return repr(out)


# -- per-sink stats (metrics / signals / top) ----------------------------

_STATS_LOCK = threading.Lock()
_STATS: "dict[str, SinkStats]" = {}


class SinkStats:
    """Live counters for one sink, read by /metrics, the signals plane
    and ``pathway-tpu top``."""

    FIELDS = (
        "delivered_total", "delivered_rows_total", "retries_total",
        "dlq_total", "breaker_opens_total", "queue_depth",
        "breaker_open", "acked_time", "delivery_lag_seconds",
    )

    def __init__(self, name: str):
        self.name = name
        self.delivered_total = 0
        self.delivered_rows_total = 0
        self.retries_total = 0
        self.dlq_total = 0
        self.breaker_opens_total = 0
        self.queue_depth = 0
        self.breaker_open = 0
        self.acked_time = -1
        self.delivery_lag_seconds = 0.0

    def snapshot(self) -> dict[str, float]:
        return {f: float(getattr(self, f)) for f in self.FIELDS}


def _stats_for(name: str) -> SinkStats:
    with _STATS_LOCK:
        st = _STATS.get(name)
        if st is None:
            st = _STATS[name] = SinkStats(name)
        return st


def sink_stats_snapshot() -> dict[str, dict[str, float]]:
    """Every registered sink's counters — the /snapshot + signals-plane
    payload (empty dict when no delivery sinks exist in this process)."""
    with _STATS_LOCK:
        return {name: st.snapshot() for name, st in _STATS.items()}


def _reset_stats_for_tests() -> None:
    with _STATS_LOCK:
        _STATS.clear()


# -- delivery core -------------------------------------------------------


class _Breaker:
    """Per-sink circuit breaker: ``threshold`` consecutive *exhausted
    retry cycles* open it for ``cooldown_s``; while open, the writer
    sleeps instead of hammering a down sink. Half-open probes are the
    next ordinary cycle."""

    def __init__(self, threshold: int, cooldown_s: float, stats: SinkStats):
        self.threshold = max(1, threshold)
        self.cooldown_s = cooldown_s
        self._failures = 0
        self._opened_at: float | None = None
        self._stats = stats

    def note_success(self) -> None:
        self._failures = 0
        self._opened_at = None
        self._stats.breaker_open = 0

    def note_cycle_failure(self) -> None:
        self._failures += 1
        if self._failures >= self.threshold and self._opened_at is None:
            self._opened_at = _time.monotonic()
            self._stats.breaker_open = 1
            self._stats.breaker_opens_total += 1
            log.warning(
                "sink %s: circuit breaker OPEN after %d consecutive "
                "failed delivery cycles (cooldown %.1fs)",
                self._stats.name, self._failures, self.cooldown_s,
            )

    def wait_if_open(self, stop: threading.Event) -> None:
        if self._opened_at is None:
            return
        elapsed = _time.monotonic() - self._opened_at
        remaining = self.cooldown_s - elapsed
        if remaining > 0:
            stop.wait(remaining)
        # half-open: allow the next cycle through as the probe
        self._opened_at = _time.monotonic()


class DeliverySink:
    """One delivery-managed sink: bounded buffering, a dedicated writer
    thread, retry/breaker/DLQ policy, durable acks. Built by
    ``graph_runner.lower_sink`` from the spec :func:`deliver` registered.

    Threading: ``on_batch`` runs on the engine thread (blocking there IS
    the backpressure contract); ``_writer_loop`` owns the adapter and the
    ack writes. With a persistence manager attached, batches wait in
    ``_pending`` until :meth:`release` (called under the manager's commit
    protocol) moves them to the writer queue."""

    def __init__(
        self,
        adapter: SinkAdapter,
        name: str,
        *,
        policy: RetryPolicy | None = None,
        dlq: DeadLetterQueue | None = None,
        queue_batches: int | None = None,
        stats: SinkStats | None = None,
        worker_id: int = 0,
        backend: Any = None,
        transactional: bool = False,
    ):
        self.adapter = adapter
        self.name = name
        self.worker_id = worker_id
        self.policy = policy or RetryPolicy.from_env()
        self.run_id = os.environ.get("PATHWAY_RUN_ID", "local")
        self.dlq = dlq or DeadLetterQueue()
        self.stats = stats or _stats_for(name)
        #: persistence backend holding the ack cursor (worker namespace);
        #: None = in-memory acks only (no recovery dedupe possible)
        self._backend = backend
        #: True when delivery is gated to persistence commit boundaries
        self.transactional = transactional
        #: frontier-driven (async) execution: the durable ack cursor only
        #: advances at commit boundaries (``drain(bump_to=T)``), never per
        #: batch. Async sweep labels are not reproducible across a
        #: crash-replay (replay runs at recorded input times, live runs at
        #: per-worker mint times), so a mid-window cursor would be a dedup
        #: frontier in a coordinate system the replay does not share —
        #: boundary-only acks keep the cursor on the commit times both
        #: runs agree on, and the resume token rolls the external system
        #: back to that boundary before the window redelivers.
        self.boundary_acks = False
        self._queue_bound = queue_batches or _env_i(
            "PATHWAY_SINK_QUEUE_BATCHES", 64
        )
        self.timeout_s = _env_f("PATHWAY_SINK_TIMEOUT_S", 0.0)
        self._breaker = _Breaker(
            _env_i("PATHWAY_SINK_BREAKER_THRESHOLD", 3),
            _env_f("PATHWAY_SINK_BREAKER_COOLDOWN_S", 1.0),
            self.stats,
        )
        self._rng = random.Random(0xD15C0 ^ hash(name) & 0xFFFF)
        #: batches awaiting their input's metadata commit (transactional
        #: mode only); the engine thread owns it
        self._pending: deque[SinkBatch] = deque()
        self._pending_rows = 0
        #: released batches the writer thread drains, bounded
        self._queue: deque[SinkBatch] = deque()
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)
        self._drained = threading.Condition(self._lock)
        self._stop = threading.Event()
        self._writer: threading.Thread | None = None
        self._failure: BaseException | None = None
        self._opened = False
        #: highest delivered-and-acked boundary_seq (tick time); restored
        #: from the backend cursor before the first enqueue
        self.acked_time = -1
        #: the last acked ``write_batch`` return: what ``open`` and
        #: ``rollback`` restore the external system to
        self._resume_token: Any = None
        self._load_cursor()
        if self._backend is not None:
            # only the authoritative (cursor-backed) sink publishes its
            # restored position: SinkStats are shared per name, and a
            # muted peer worker's construction must not clobber worker
            # 0's restored acked_time gauge with -1
            self.stats.acked_time = self.acked_time

    # -- ack cursor (the transactional delivery log) --------------------

    @property
    def _ack_key(self) -> str:
        return f"{_ACK_PREFIX}{self.name}"

    def _load_cursor(self) -> None:
        if self._backend is None:
            return
        try:
            raw = self._backend.get_value(self._ack_key)
        except (KeyError, FileNotFoundError):
            # genuinely missing = fresh sink: stamp the floor NOW, so a
            # crash between the first metadata commit and the first ack
            # still pins recovery below any snapshot (nothing was ever
            # delivered). Transient I/O errors must PROPAGATE instead —
            # overwriting a perfectly good cursor with -1 on an EIO would
            # re-deliver the whole replayed tail (same rule the S3
            # backend applies to metadata reads).
            self._write_cursor()
            return
        try:
            doc = json.loads(raw)
        except (ValueError, UnicodeDecodeError):
            # corrupt cursor blob (should be impossible under the
            # backends' atomic-rename discipline): adopt the conservative
            # floor in memory but do NOT overwrite the blob — re-delivery
            # (duplicates possible) beats destroying evidence; the next
            # ack rewrites it
            log.warning(
                "sink %s: ack cursor %r is corrupt; treating as unacked "
                "(replayed output may re-deliver)",
                self.name, self._ack_key,
            )
            return
        self.acked_time = int(doc.get("acked_time", -1))
        self._resume_token = doc.get("token")

    def _write_cursor(self, token: Any = None) -> None:
        if self._backend is None:
            return
        self._backend.put_value(self._ack_key, json.dumps({
            "acked_time": self.acked_time,
            "token": token if token is not None else self._resume_token,
            "run_id": self.run_id,
            "worker": self.worker_id,
        }).encode())

    def recovery_floor(self) -> int:
        """The newest operator-snapshot time recovery may restore at
        without losing this sink's unacked output (everything at or below
        ``acked_time`` was delivered; everything above regenerates from
        replay and is deduped by the cursor)."""
        return self.acked_time

    # -- engine side -----------------------------------------------------

    def on_batch(self, time: int, delta: Any) -> None:
        """Subscribe's columnar callback: stamp + buffer one tick batch.
        Blocks when the released queue is at its bound (backpressure)."""
        self._raise_failure()
        if time <= self.acked_time:
            # recovery replay at/below the ack cursor: already delivered
            # by a previous incarnation — the exactly-once skip. This
            # covers END_TIME flush batches too: a kill after the final
            # drain acked END_TIME must not re-deliver the regenerated
            # END batch on the supervised restart.
            return
        batch = SinkBatch(time, delta, self.run_id, self.worker_id)
        if self.transactional:
            # waits for the commit protocol; the pending buffer is bounded
            # indirectly — want_early_commit() asks the manager to commit
            # (and so release) once it grows past the queue bound
            self._pending.append(batch)
            self._pending_rows += len(batch)
            return
        self._enqueue_blocking(batch)

    def on_end(self) -> None:
        """End of stream. Non-transactional sinks drain and close here;
        transactional ones defer to the manager's finish() (which runs
        after the final metadata commit — see executor._finish)."""
        if not self.transactional:
            timeout = self._drain_timeout()
            drained = self.drain(timeout=timeout)
            self.shutdown()
            if not drained:
                # losing queued output silently is the one failure mode
                # this subsystem exists to eliminate — fail the run loudly
                raise RuntimeError(
                    f"sink {self.name!r} failed to drain within "
                    f"PATHWAY_SINK_DRAIN_TIMEOUT_S={timeout}s at end of "
                    "run; undelivered batches remain"
                )

    def want_early_commit(self) -> bool:
        return len(self._pending) >= self._queue_bound

    def _raise_failure(self) -> None:
        if self._failure is not None:
            raise RuntimeError(
                f"sink {self.name!r} delivery failed fatally"
            ) from self._failure

    def _enqueue_blocking(self, batch: SinkBatch) -> None:
        self._ensure_writer()
        with self._not_full:
            while (
                len(self._queue) >= self._queue_bound
                and self._failure is None
                and not self._stop.is_set()
            ):
                self._not_full.wait(timeout=0.1)
            self._raise_failure()
            self._queue.append(batch)
            self.stats.queue_depth = len(self._queue)
            self._not_empty.notify_all()

    # -- transactional protocol (driven by DeliveryManager) --------------

    def release(self, up_to_time: int) -> None:
        """Move pending batches with time <= ``up_to_time`` to the writer
        queue — their input is now durably committed. Blocks at the queue
        bound (that block is the engine-thread backpressure)."""
        while self._pending and self._pending[0].time <= up_to_time:
            batch = self._pending.popleft()
            self._pending_rows -= len(batch)
            self._enqueue_blocking(batch)

    def release_all(self) -> int | None:
        """End-of-run: everything still pending (END_TIME flush batches
        included) — called only after the final metadata commit. Returns
        the newest time released (None when nothing was pending)."""
        newest = None
        while self._pending:
            batch = self._pending.popleft()
            self._pending_rows -= len(batch)
            self._enqueue_blocking(batch)
            newest = batch.time
        return newest

    def drain(self, timeout: float | None = None,
              bump_to: int | None = None) -> bool:
        """Block until the writer queue is empty and the in-flight batch
        (if any) acked. ``bump_to`` advances the durable cursor to that
        tick afterwards (the commit-boundary heartbeat — sparse output
        must not hold the recovery floor below the frontier). Returns
        False on timeout or when a shutdown raced the drain."""
        self._ensure_writer()
        deadline = (
            _time.monotonic() + timeout if timeout is not None else None
        )
        clean = True
        with self._drained:
            while self._queue or self._in_flight:
                self._raise_failure()
                if self._stop.is_set():
                    # shutdown raced the drain: batches remain undelivered
                    clean = False
                    break
                wait = 0.1
                if deadline is not None:
                    wait = min(wait, deadline - _time.monotonic())
                    if wait <= 0:
                        return False
                self._drained.wait(timeout=wait)
        self._raise_failure()
        if clean and bump_to is not None and bump_to > self.acked_time:
            # the heartbeat bump is only valid over a COMPLETED drain: a
            # cursor past an undelivered batch would make recovery skip it
            self.acked_time = bump_to
            self.stats.acked_time = bump_to
            self._write_cursor()
        return clean

    def shutdown(self) -> None:
        self._stop.set()
        with self._lock:
            self._not_empty.notify_all()
            self._not_full.notify_all()
        if self._writer is not None:
            self._writer.join(timeout=5.0)
        try:
            if self._opened:
                self.adapter.close()
        except Exception:
            log.warning("sink %s: close failed", self.name, exc_info=True)

    def _drain_timeout(self) -> float:
        return _env_f("PATHWAY_SINK_DRAIN_TIMEOUT_S", 120.0)

    # -- writer thread ----------------------------------------------------

    _in_flight: SinkBatch | None = None

    def _ensure_writer(self) -> None:
        if self._writer is None or not self._writer.is_alive():
            if self._failure is not None:
                return
            self._writer = threading.Thread(
                target=self._writer_loop, daemon=True,
                name=f"pathway-sink-{self.name}",
            )
            self._writer.start()

    def _writer_loop(self) -> None:
        try:
            while not self._stop.is_set():
                with self._not_empty:
                    while not self._queue and not self._stop.is_set():
                        self._not_empty.wait(timeout=0.1)
                    if self._stop.is_set() and not self._queue:
                        return
                    batch = self._queue.popleft()
                    self._in_flight = batch
                    self.stats.queue_depth = len(self._queue)
                    self._not_full.notify_all()
                try:
                    self._deliver_one(batch)
                finally:
                    with self._drained:
                        self._in_flight = None
                        self._drained.notify_all()
        except BaseException as e:
            self._failure = e
            with self._lock:
                self._not_full.notify_all()
                self._drained.notify_all()
            log.error("sink %s: writer thread died: %r", self.name, e)

    def _open_once(self) -> None:
        if not self._opened:
            self.adapter.open(self._resume_token)
            self._opened = True

    def _deliver_one(self, batch: SinkBatch) -> None:
        """Deliver one batch: retry cycles under the breaker -> ack.
        Poison rows peel off to the DLQ; retryable failures cycle
        forever (bounded buffering upstream is the pushback)."""
        while not self._stop.is_set():
            self._breaker.wait_if_open(self._stop)
            try:
                token = self._attempt_cycle(batch)
            except SinkRejectedError as e:
                batch = self._dead_letter(batch, e)
                if batch is None:
                    self._breaker.note_success()
                    return
                continue  # rest of the batch redelivers
            except Exception as e:
                self._breaker.note_cycle_failure()
                log.warning(
                    "sink %s: delivery cycle failed at t=%d (%r); "
                    "breaker %s, will retry",
                    self.name, batch.time, e,
                    "open" if self.stats.breaker_open else "closed",
                )
                continue
            self._breaker.note_success()
            self._ack(batch, token)
            return

    def _attempt_cycle(self, batch: SinkBatch) -> Any:
        """One retry cycle: up to ``policy.attempts()`` tries with
        backoff. Raises the last error when exhausted (the breaker counts
        it); SinkRejectedError propagates immediately (not retryable)."""
        last: BaseException | None = None
        for attempt in range(1, self.policy.attempts() + 1):
            if self._stop.is_set():
                raise RuntimeError("sink shutdown during delivery")
            if attempt > 1:
                self.stats.retries_total += 1
                _time.sleep(self.policy.delay_s(attempt - 1, self._rng))
            try:
                self._open_once()
                return self._timed_write(batch)
            except SinkRejectedError:
                raise
            except SinkWriteTimeout as e:
                last = e
                # the abandoned watchdog thread is STILL inside the
                # adapter — it must never race the retry on shared
                # handles (an fs zombie would interleave bytes with the
                # reopened file). Reset the adapter wholesale: on_timeout
                # severs the zombie (close the handle: writes on a closed
                # fd fail harmlessly), and the next attempt reopens from
                # the last acked token.
                try:
                    hook = getattr(self.adapter, "on_timeout", None)
                    if hook is not None:
                        hook()
                except Exception:
                    log.warning(
                        "sink %s: on_timeout reset failed",
                        self.name, exc_info=True,
                    )
                self._opened = False
            except Exception as e:
                last = e
                try:
                    # restore to the LAST ACKED position: a torn attempt
                    # may have pushed partial state since then
                    self.adapter.rollback(self._resume_token)
                except Exception:
                    log.warning(
                        "sink %s: rollback failed after write error",
                        self.name, exc_info=True,
                    )
        assert last is not None
        raise last

    def _timed_write(self, batch: SinkBatch) -> Any:
        """The adapter's write under the per-sink timeout watchdog: a hung
        external client turns into a retryable failure instead of a
        wedged worker. The abandoned attempt's thread leaks by design
        (Python cannot kill it) — daemonized, and the breaker paces how
        many can pile up."""
        if self.timeout_s <= 0:
            return self.adapter.write_batch(batch)
        result: list[Any] = []
        error: list[BaseException] = []

        def call() -> None:
            try:
                result.append(self.adapter.write_batch(batch))
            except BaseException as e:
                error.append(e)

        t = threading.Thread(
            target=call, daemon=True, name=f"pathway-sink-{self.name}-write"
        )
        t.start()
        t.join(timeout=self.timeout_s)
        if t.is_alive():
            raise SinkWriteTimeout(
                f"sink {self.name!r} write exceeded "
                f"PATHWAY_SINK_TIMEOUT_S={self.timeout_s}"
            )
        if error:
            raise error[0]
        return result[0] if result else None

    def _dead_letter(self, batch: SinkBatch, e: SinkRejectedError
                     ) -> SinkBatch | None:
        """Route the rejected rows to the DLQ; return the remainder batch
        to deliver (None when the whole batch was poison)."""
        import numpy as np

        names = list(batch.delta.columns)
        n = len(batch)
        if e.row_indices is not None:
            bad = sorted({i for i in e.row_indices if 0 <= i < n})
        else:
            bad = list(range(n))
        rows = []
        for i in bad:
            row = {c: batch.delta.data[c][i] for c in names}
            row["diff"] = int(batch.delta.diffs[i])
            rows.append(row)
        self.stats.dlq_total += self.dlq.append(self.name, batch, rows, e)
        keep = np.setdiff1d(np.arange(n), np.asarray(bad, dtype=np.int64))
        if not len(keep):
            # nothing deliverable left: the batch is fully accounted for —
            # ack it so recovery does not re-deliver the poison
            self._ack(batch, None)
            return None
        return SinkBatch(
            batch.time, batch.delta.take(keep), batch.run_id, batch.worker
        )

    def _ack(self, batch: SinkBatch, token: Any) -> None:
        """Durable ack: the batch is externally visible; record it through
        the persistence backend BEFORE anything else can commit offsets
        past it. A SIGKILL after this point cannot double-deliver — the
        cursor survives and replay skips the batch."""
        if token is not None:
            self._resume_token = token
        self.stats.delivered_total += 1
        self.stats.delivered_rows_total += len(batch)
        self.stats.delivery_lag_seconds = max(
            0.0, _time.monotonic() - batch.enqueued_at
        )
        if self.boundary_acks:
            # async mode: the durable cursor + resume token persist only
            # at the commit-boundary bump (drain(bump_to=T)); a crash
            # mid-window rolls the external system back to the boundary
            # token and the whole window redelivers after replay
            return
        self.acked_time = max(self.acked_time, batch.time)
        self.stats.acked_time = self.acked_time
        self._write_cursor(token)


class DeliveryManager:
    """All delivery sinks of one worker's dataflow, plus the commit-
    protocol seams the persistence manager drives:

    - ``pre_commit_barrier()`` — before a metadata commit: the previous
      release must be fully acked (bounds delivery lag to one snapshot
      interval; a down sink blocks here = engine backpressure).
    - ``on_commit(T)`` — after the metadata commit at T: release batches
      with time <= T to the writers (their input is durable now).
    - ``recovery_floor()`` — min ack cursor across sinks; recovery picks
      the newest operator snapshot at-or-below it.
    - ``finish()`` — after the final commit: release everything
      (END_TIME flush batches included), drain, close adapters.
    """

    def __init__(self, worker_id: int = 0):
        self.worker_id = worker_id
        self.sinks: list[DeliverySink] = []
        self.dlq = DeadLetterQueue()
        #: cumulative ns blocked in pre_commit_barrier / on_commit — the
        #: delivery plane's share of the commits' barrier and release
        self.barrier_wait_ns = 0
        self.release_ns = 0

    def add(self, sink: DeliverySink) -> None:
        self.sinks.append(sink)

    def use_boundary_acks(self) -> None:
        """Frontier-driven executor: persist ack cursors only at commit
        boundaries (see DeliverySink.boundary_acks). Called once when the
        async streaming loop takes over, before any release."""
        for s in self.sinks:
            s.boundary_acks = True

    def has_sinks(self) -> bool:
        return bool(self.sinks)

    def pre_commit_barrier(self) -> None:
        t0 = _time.perf_counter_ns()
        for s in self.sinks:
            if s.transactional:
                s.drain(timeout=None)
        self.barrier_wait_ns += _time.perf_counter_ns() - t0

    def on_commit(self, up_to_time: int) -> None:
        t0 = _time.perf_counter_ns()
        for s in self.sinks:
            if s.transactional:
                s.release(up_to_time)
        # drain NOW (not at the next barrier): acks land while the commit
        # is fresh, the cursor heartbeat advances to the commit tick, and
        # a crash right after the commit still finds acked >= T_prev
        for s in self.sinks:
            if s.transactional:
                s.drain(timeout=None, bump_to=up_to_time)
        self.release_ns += _time.perf_counter_ns() - t0

    def want_early_commit(self) -> bool:
        """Pending (uncommitted) output grew past the queue bound: ask the
        streaming loop to commit early so batches release — growing the
        pending buffer unboundedly would trade OOM for backpressure."""
        return any(s.want_early_commit() for s in self.sinks)

    def recovery_floor(self) -> int | None:
        floors = [
            s.recovery_floor() for s in self.sinks if s.transactional
        ]
        return min(floors) if floors else None

    def finish(self) -> None:
        timeout = _env_f("PATHWAY_SINK_DRAIN_TIMEOUT_S", 120.0)
        for s in self.sinks:
            if not s.transactional:
                continue
            newest = s.release_all()
            if s.boundary_acks:
                # async mode defers cursor writes to boundary bumps — the
                # final drain must bump past the END_TIME flush batches,
                # or a kill after a CLEAN finish would re-deliver the
                # regenerated END batch on the supervised restart. It bumps
                # to the newest batch released here and no further, as a
                # per-batch ack would: the reference bumps to END_TIME
                # even when no END batch exists, and a restarted run's
                # output (at later wall-clock times, all below END_TIME)
                # is then skipped as already delivered
                if not s.drain(timeout=timeout, bump_to=newest):
                    raise RuntimeError(
                        f"sink {s.name!r} failed to drain within "
                        f"PATHWAY_SINK_DRAIN_TIMEOUT_S={timeout}s at end "
                        f"of run ({len(s._queue)} batch(es) still queued)"
                    )
                s.shutdown()
                continue
            if not s.drain(timeout=timeout):
                raise RuntimeError(
                    f"sink {s.name!r} failed to drain within "
                    f"PATHWAY_SINK_DRAIN_TIMEOUT_S={timeout}s at end of "
                    f"run ({len(s._queue)} batch(es) still queued)"
                )
            s.shutdown()

    def abort(self) -> None:
        for s in self.sinks:
            s._stop.set()


# -- registration (the pw.io connector surface) ---------------------------

def _sanitize(name: str) -> str:
    """Sink ids double as backend keys and DLQ filenames — keep them to
    one safe path segment."""
    import re

    return re.sub(r"[^A-Za-z0-9._-]+", "_", name).strip("_") or "sink"


def deliver(
    table: Any,
    adapter_factory: Callable[[], SinkAdapter],
    *,
    name: str | None = None,
    default_name: str | None = None,
    retry_policy: RetryPolicy | None = None,
) -> None:
    """Register a delivery-managed sink for ``table``. Connector modules
    call this instead of raw ``subscribe``: ``adapter_factory`` builds
    the :class:`SinkAdapter` lazily at graph-lowering time (per worker;
    non-zero workers' Subscribe nodes are muted by the gather pass and
    the adapter is then never opened).

    The sink's id is its stable identity — the ack cursor key, the DLQ
    file, the metrics label. ``name`` is USER-supplied and must be
    unique (two sinks sharing one cursor would, after a crash, let the
    one that was behind adopt the other's position and silently skip
    rows); ``default_name`` is the connector's derived fallback
    (``fs-<basename>``, ``null``, ...) and de-collides with a
    registration-order suffix — deterministic for a fixed program, so
    two ``csv.write``s to files sharing a basename keep working."""
    from ..internals.parse_graph import G

    taken = {
        s["delivery"]["name"] for s in G.sinks if s.get("delivery")
    }
    if name is not None:
        sink_id = _sanitize(name)
        if sink_id in taken:
            raise ValueError(
                f"sink name {sink_id!r} is already registered in this "
                "pipeline — pass a distinct name= to each output connector"
            )
    else:
        sink_id = _sanitize(
            default_name
            or f"sink-{len([s for s in G.sinks if s.get('delivery')])}"
        )
        if sink_id in taken:
            i = 2
            while f"{sink_id}-{i}" in taken:
                i += 1
            sink_id = f"{sink_id}-{i}"
    G.add_sink({
        "kind": "subscribe",
        "table": table,
        "delivery": {
            "adapter_factory": adapter_factory,
            "name": sink_id,
            "retry_policy": retry_policy,
        },
    })
