"""``pw.global_error_log()`` — the process error log as a live table.

Reference: ``pw.global_error_log()`` (``internals/errors.py``) exposes the
engine's error-log channel as a queryable table; tests assert on
``global_error_log().select(pw.this.message)`` alongside the pipeline
output. Here the table is a realtime source draining
``engine.error.ERROR_LOG`` entries recorded after the run starts: each
sweep of the event loop picks up errors the previous tick raised, so the
final table holds exactly this run's row errors.
"""

from __future__ import annotations

import numpy as np

from ..engine.delta import Delta
from ..engine.executor import RealtimeSource
from .parse_graph import Universe
from .schema import schema_from_types
from .table import Table

__all__ = ["global_error_log", "local_error_log"]

#: build-time scope stack for ``pw.local_error_log()``: tables created
#: while a scope is active are tagged with its id, the executor restores
#: the tag around their nodes' processing, and the scoped log table
#: filters on it
_scope_seq = 0
_scope_stack: list[int] = []


def current_build_scope() -> int | None:
    return _scope_stack[-1] if _scope_stack else None


class _ErrorLogSource(RealtimeSource):
    """Emits (message, context) rows for log entries recorded since the
    run began (offset captured at build time = run start); ``scope``
    filters to one local_error_log scope."""

    def __init__(self, columns: list[str], scope: int | None = None):
        super().__init__(columns)
        from ..engine.error import ERROR_LOG

        self._log = ERROR_LOG
        self._scope = scope
        #: lifetime index of the next entry to surface — stays valid past
        #: the retention cap because the log is a ring with a monotonic
        #: base, not a frozen prefix
        self._seen = ERROR_LOG.next_index

    def poll(self):
        from ..engine import keys as K

        start, new, self._seen = self._log.entries_since(self._seen)
        if not new:
            return []
        if self._scope is not None:
            new = [
                (start + i, m, c)
                for i, (m, c, sc) in enumerate(new)
                if sc == self._scope
            ]
        else:
            new = [(start + i, m, c) for i, (m, c, _) in enumerate(new)]
        if not new:
            return []
        keys = K.hash_values(
            [(ix, m, c) for ix, m, c in new],
            register=False,  # sequential identity, collision-free by index
        )
        msg = np.empty(len(new), dtype=object)
        ctx = np.empty(len(new), dtype=object)
        for i, (_, m, c) in enumerate(new):
            msg[i] = m
            ctx[i] = c
        return [Delta(keys=keys, data={"message": msg, "context": ctx})]

    def is_finished(self) -> bool:
        # nothing pending: the run ends when every OTHER source is also
        # finished (the event loop requires all-finished AND no rounds), so
        # errors raised by the final data tick still get drained first
        return self._log.next_index == self._seen


def _log_table(scope: int | None) -> Table:
    def build() -> _ErrorLogSource:
        return _ErrorLogSource(["message", "context"], scope)

    return Table(
        "source",
        [],
        {"build": build},
        schema_from_types(message=str, context=str),
        Universe(),
    )


def global_error_log() -> Table:
    """The error log of the current run as a table of
    ``(message, context)`` rows (reference ``pw.global_error_log()``)."""
    return _log_table(None)


class local_error_log:
    """``with pw.local_error_log() as log:`` — tables BUILT inside the
    block route their runtime row errors to ``log`` (a table like
    ``global_error_log()``, filtered to this scope) as well as the global
    log (reference ``pw.local_error_log``, test_errors.py:262)."""

    def __enter__(self) -> Table:
        global _scope_seq
        _scope_seq += 1
        self._scope = _scope_seq
        _scope_stack.append(self._scope)
        return _log_table(self._scope)

    def __exit__(self, *exc) -> None:
        _scope_stack.pop()
