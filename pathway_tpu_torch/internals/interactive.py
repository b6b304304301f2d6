"""Interactive mode: live tables in a REPL/notebook.

Re-design of ``python/pathway/internals/interactive.py`` (LiveTable
``:130``, ``enable_interactive_mode`` ``:202``): ``t.live()`` runs the
table's upstream subgraph on a background engine thread and returns a
handle whose ``snapshot()``/``frontier()``/``failed()`` observe the
continuously-updated state; printing a live table (or any snapshot)
renders the current rows. ``enable_interactive_mode()`` installs a
displayhook so a bare ``t.live()`` at the REPL prints itself, like the
reference's ``InteractiveModeController``.

Copy of ``pathway_tpu/internals/interactive.py``. ``LiveTable`` (and
``Table.live``) takes ``device=`` (default ``"cuda"``): its background
``GraphRunner`` lowers and runs there; with no card it raises unless the
caller passes ``device="cpu"``.

Where the reference exports through the engine's ExportedTable handoff
(``src/engine/dataflow/export.rs``), here the background runner feeds a
plain key→row dict through a Subscribe sink — the total-order tick sweep
makes every observed snapshot a consistent prefix of the stream.
"""

from __future__ import annotations

import sys
import threading
from typing import Any, Callable

__all__ = [
    "LiveTable",
    "LiveTableSnapshot",
    "enable_interactive_mode",
    "is_interactive_mode_enabled",
]


class DisplayAsStr:
    """Rendered via str() by the interactive displayhook."""


class LiveTableSnapshot(DisplayAsStr):
    """A consistent view of a live table as of one frontier time."""

    def __init__(self, frontier: int, names: list[str], rows: dict[int, tuple]):
        self.frontier = frontier
        self.column_names = names
        self.rows = rows

    def __len__(self) -> int:
        return len(self.rows)

    def __str__(self) -> str:
        from ..debug import _format_snapshot

        return _format_snapshot(self.column_names, self.rows, self.frontier)


class LiveTable(DisplayAsStr):
    """A table running live on a background engine thread.

    Reference ``interactive.py:130`` — snapshot/frontier/failed have the
    same meaning; ``subscribe`` works here (the reference left it TODO).
    """

    def __init__(self, origin: Any, device: Any = "cuda"):
        from ..engine import operators as ops
        from .graph_runner import GraphRunner

        self._names = list(origin.column_names())
        self._lock = threading.Lock()
        self._rows: dict[int, tuple] = {}
        self._frontier = 0
        self._error: BaseException | None = None
        self._callbacks: list[Callable[..., None]] = []
        self._stopped = threading.Event()

        runner = GraphRunner(device)
        node = runner.lower(origin)
        sub = ops.Subscribe(
            node,
            # one call per consolidated tick delta: the whole tick applies
            # under a single lock acquisition, so a concurrent snapshot()
            # never observes a half-applied tick
            on_batch=self._on_tick_delta,
            on_time_end=self._on_time_end,
        )
        runner._nodes.append(sub)
        self._runner = runner

        def work() -> None:
            try:
                runner._execute()
            except BaseException as e:  # noqa: BLE001 — surfaced via failed()
                self._error = e
            finally:
                self._stopped.set()

        self._thread = threading.Thread(
            target=work, name=f"live table {origin!r}", daemon=True
        )
        self._thread.start()

    # -- state ingestion (engine thread) -------------------------------

    def _on_tick_delta(self, time, delta) -> None:
        from ..engine.delta import rows_equal

        entries = list(delta.iter_rows())  # (key, row_tuple, diff)
        with self._lock:
            for key, values, diff in entries:
                if diff > 0:
                    self._rows[key] = values
                elif rows_equal(self._rows.get(key), values):
                    # value-aware (array-safe: tuple == on ndarray cells
                    # raises): within a tick the retract of the OLD row may
                    # come after the insert of the new one for the same
                    # key — only remove what is actually stored
                    self._rows.pop(key, None)
            # snapshot under the lock: subscribe() appends concurrently.
            # Callbacks run on the engine thread, after the tick's rows are
            # applied but before the next tick can mutate them (the engine
            # sweep is single-threaded per worker).
            cbs = list(self._callbacks)
        for cb in cbs:
            for key, values, diff in entries:
                cb(
                    key=key,
                    row=dict(zip(self._names, values)),
                    time=time,
                    is_addition=diff > 0,
                )

    def _on_time_end(self, time: int) -> None:
        with self._lock:
            self._frontier = max(self._frontier, time)

    # -- observers (any thread) -----------------------------------------

    def live(self) -> "LiveTable":
        return self

    def failed(self) -> bool:
        return self._error is not None

    def frontier(self) -> int:
        with self._lock:
            return self._frontier

    def snapshot(self) -> LiveTableSnapshot:
        with self._lock:
            return LiveTableSnapshot(
                self._frontier, self._names, dict(self._rows)
            )

    def subscribe(self, callback: Callable[..., None]) -> None:
        """Register an on_change-style callback (key=, row=, time=,
        is_addition=) fired for every future update."""
        self._callbacks.append(callback)

    def stop(self) -> None:
        """Wind the background engine down (joins the thread)."""
        # the flag covers the window before the executor exists
        # (graph_runner honors stop_requested at executor creation)
        self._runner.stop_requested = True
        if self._runner.executor is not None:
            self._runner.executor.request_stop()
        self._stopped.wait(timeout=30)

    def __str__(self) -> str:
        if self._error is not None:
            return f"LiveTable FAILED: {self._error!r}"
        return str(self.snapshot())


class InteractiveModeController:
    def __init__(self) -> None:
        self._orig_displayhook = sys.displayhook
        sys.displayhook = self._displayhook

    def _displayhook(self, value: object) -> None:
        if isinstance(value, DisplayAsStr):
            import builtins

            builtins._ = value
            print(str(value))
        else:
            self._orig_displayhook(value)

    def disable(self) -> None:
        global _controller
        sys.displayhook = self._orig_displayhook
        if _controller is self:
            _controller = None  # a later enable() reinstalls the hook


_controller: InteractiveModeController | None = None


def is_interactive_mode_enabled() -> bool:
    return _controller is not None


def enable_interactive_mode() -> InteractiveModeController:
    import warnings

    global _controller
    if _controller is None:
        warnings.warn("interactive mode is experimental", stacklevel=2)
        _controller = InteractiveModeController()
    return _controller
