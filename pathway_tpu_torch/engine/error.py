"""Per-row error values (reference ``Value::Error``, value.rs:226).

A row-level failure inside an expression becomes an ``Error`` value that
flows through the dataflow instead of poisoning the whole stream;
``pw.fill_error`` recovers it, ``pw.unwrap`` refuses it, sinks render it
as ``Error``. Each constructed Error is also counted and (rate-limited)
logged with its operator context — the reference's error-log channel.

Copy of ``pathway_tpu/engine/error.py``.
"""

from __future__ import annotations

import logging
import threading

__all__ = ["Error", "is_error", "errors_seen", "live_errors", "ERROR_LOG"]

logger = logging.getLogger("pathway_tpu.errors")


class _ErrorLog:
    """Process-wide error collector (reference global error log).

    Retention is a **ring buffer with a monotonic base index**: the
    newest ``max_kept`` entries are retained and every entry keeps its
    lifetime index (``base + position``), so live error-log tables
    (``pw.global_error_log()``) keep receiving rows after 1000 lifetime
    entries instead of silently freezing at the cap — pollers address
    entries by lifetime index via :meth:`entries_since`, which also
    reports how many fell off the ring between polls."""

    def __init__(self, max_kept: int = 1000, max_logged: int = 20):
        from collections import deque

        self._lock = threading.Lock()
        self._entries: "deque[tuple[str, str, int | None]]" = deque()
        #: lifetime index of the oldest retained entry
        self._base = 0
        self.total = 0
        self._max_kept = max_kept
        self._max_logged = max_logged

    def record(self, message: str, context: str) -> None:
        with self._lock:
            self.total += 1
            self._entries.append((message, context, get_current_scope()))
            if len(self._entries) > self._max_kept:
                self._entries.popleft()
                self._base += 1
            if self.total <= self._max_logged:
                logger.warning("row error in %s: %s", context, message)
            elif self.total == self._max_logged + 1:
                logger.warning("further row errors suppressed (see error log)")

    def entries(self) -> list[tuple[str, str]]:
        with self._lock:
            return [(m, c) for m, c, _ in self._entries]

    def entries_full(self) -> list[tuple[str, str, int | None]]:
        """(message, context, scope) — scope is the local_error_log scope
        active when the error was recorded (None = no local scope).
        Retained window only (newest ``max_kept``)."""
        with self._lock:
            return list(self._entries)

    @property
    def next_index(self) -> int:
        """Lifetime index the NEXT recorded entry will get."""
        with self._lock:
            return self._base + len(self._entries)

    def entries_since(self, index: int) -> tuple[int, list, int]:
        """Entries with lifetime index >= ``index`` that are still in the
        ring → ``(first_index, entries, next_index)``. ``first_index`` may
        exceed ``index`` when older entries already fell off the ring (a
        poller that lagged more than ``max_kept`` entries)."""
        with self._lock:
            end = self._base + len(self._entries)
            start = min(max(index, self._base), end)
            if start == end:
                return end, [], end
            from itertools import islice

            return (
                start,
                list(islice(self._entries, start - self._base, None)),
                end,
            )

    def clear(self) -> None:
        # clears the LOG, not the errors-seen latch: live Error values may
        # still sit in operator state, so error-aware paths must stay on
        with self._lock:
            self._entries.clear()
            self._base = 0
            self.total = 0


ERROR_LOG = _ErrorLog()

#: runtime local-error-log scope, THREAD-LOCAL: set by the executor
#: around each node's processing to the scope the node's table was BUILT
#: under (``pw.local_error_log()``). Thread-local because sharded runs
#: execute one worker per thread — a process-global would let worker A's
#: scope misattribute worker B's errors (review finding).
_scope_local = threading.local()


def get_current_scope() -> int | None:
    return getattr(_scope_local, "scope", None)


def set_current_scope(scope: int | None) -> None:
    _scope_local.scope = scope

#: count of Error values alive in this process — the cheap "may any Error
#: value exist?" gate used by the engine's error-aware fast paths. Counting
#: live objects (not a sticky latch) lets a long-lived multi-pipeline
#: process recover the no-error fast path once all Error values are
#: garbage-collected (ADVICE r3: scope the latch per-run).
_live_errors = 0
_count_lock = threading.Lock()
#: decrements deferred from ``Error.__del__``. ``list.append`` is atomic
#: under the GIL and safe from a GC pass that interrupts ``_incr`` on the
#: same thread (no lock to deadlock on), so __del__ never skips a
#: decrement; the pending entries are drained into ``_live_errors`` by the
#: next ``_incr`` (ADVICE r4: contended-skip made the count drift upward
#: permanently, pinning pipelines on the slow error-aware paths).
_pending_decr: list[None] = []


def _incr() -> None:
    global _live_errors
    with _count_lock:
        n = len(_pending_decr)
        if n:
            del _pending_decr[:n]
        _live_errors += 1 - n


def live_errors() -> int:
    """Net count of Error values alive right now. Also drains the pending
    decrements (safe: never called from ``__del__``), so a burst of
    collected Errors does not retain an ever-growing pending list when no
    new Error is constructed afterwards."""
    global _live_errors
    with _count_lock:
        n = len(_pending_decr)
        if n:
            del _pending_decr[:n]
            _live_errors -= n
        return _live_errors


def errors_seen() -> bool:
    return live_errors() > 0


class Error:
    """A row-level error value. Compares equal to nothing (including other
    errors and itself), so it never silently merges state; hashes by
    identity so containers still work."""

    __slots__ = ("message",)

    def __init__(self, message: str = "Error", context: str = "<expression>"):
        _incr()
        self.message = message
        ERROR_LOG.record(message, context)

    @classmethod
    def silent(cls, message: str = "Error") -> "Error":
        """An Error value without a log entry — for re-derived errors (a
        group aggregate re-read while its error rows persist) whose root
        cause was already logged when the original row Error was built."""
        _incr()
        e = cls.__new__(cls)
        e.message = message
        return e

    def __del__(self) -> None:
        try:
            # _incr() runs exactly when `message` is set (init / silent /
            # __setstate__); a half-built instance must not decrement.
            # Deferred decrement: __del__ can run from a GC pass while
            # this same thread holds _count_lock inside _incr, so taking
            # the lock here could deadlock and skipping would drift the
            # count upward forever. list.append is GIL-atomic and
            # reentrancy-safe; _incr drains the pending list.
            if hasattr(self, "message"):
                _pending_decr.append(None)
        except Exception:  # interpreter shutdown: globals may be gone
            pass

    def __repr__(self) -> str:
        return "Error"

    def __bool__(self) -> bool:
        raise TypeError("Error value used in a boolean context")

    def __eq__(self, other: object) -> bool:
        return False

    def __ne__(self, other: object) -> bool:
        return True

    def __hash__(self) -> int:
        return id(self)

    # unpickling (cluster exchange frames, operator-state snapshots) must
    # set the process-wide latch without re-logging
    def __getstate__(self):
        return self.message

    def __setstate__(self, state):
        _incr()
        self.message = state


def is_error(v: object) -> bool:
    return isinstance(v, Error)
