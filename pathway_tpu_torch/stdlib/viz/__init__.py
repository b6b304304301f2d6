"""``pw.viz`` — live visualization of streaming tables.

Re-design of the reference's Bokeh/Panel integration
(``python/pathway/stdlib/viz/plotting.py``): a table is mirrored into a
live columnar snapshot (insertions/retractions applied per commit tick,
optional sort column), and every update pushes the fresh columns to the
attached render target. The mirror + update machinery is complete and
locally tested (``tests/test_viz.py``); only the Bokeh/Panel render
objects are gated on those packages being installed — without them,
``plot``/``table_viz`` return the live source itself, which exposes the
same column data the plot would show.

Copy of ``pathway_tpu/stdlib/viz/__init__.py``: the mirror subscribes to the
table, so it follows whatever ``pw.run(device=...)`` runs the graph.
"""

from __future__ import annotations

import threading
from typing import Any, Callable

__all__ = ["plot", "show", "table_viz", "LiveTableSource"]


class LiveTableSource:
    """A live, subscribe-fed mirror of a table: ``columns()`` returns the
    current column arrays (sorted by ``sorting_col`` when given); listeners
    fire after every applied commit tick — the ColumnDataSource-updating
    role of the reference's plotting callback."""

    def __init__(self, table: Any, sorting_col: str | None = None):
        from ... import io as pw_io

        self.table = table
        self.names = list(table.column_names())
        self.sorting_col = sorting_col
        if sorting_col is not None and sorting_col not in self.names:
            raise ValueError(
                f"sorting_col {sorting_col!r} is not a column of the table "
                f"(columns: {self.names})"
            )
        self._sort_ix = (
            self.names.index(sorting_col) if sorting_col is not None else None
        )
        self._rows: dict[int, tuple] = {}
        self._lock = threading.Lock()
        self._listeners: list[Callable[[dict[str, list]], None]] = []
        # a viz mirrors STATE, not an external sink: after a persistence
        # restart it must see the replayed history, not suppress it
        pw_io.subscribe(
            table, on_batch=self._on_batch, skip_persisted_batch=False
        )

    def _on_batch(self, time: int, batch: Any) -> None:
        from ...engine.delta import rows_equal

        with self._lock:
            # deletions first: a tick updating key K carries (K, old, -1)
            # and (K, new, +1) in arbitrary order, and the retraction must
            # not clobber the freshly-inserted row
            pending = list(batch.iter_rows())
            appended: list[tuple] | None = []
            for key, row, diff in pending:
                if diff < 0:
                    appended = None  # retraction: not an append-only tick
                    if key in self._rows and rows_equal(self._rows[key], row):
                        self._rows.pop(key, None)
            for key, row, diff in pending:
                if diff > 0:
                    if appended is not None and key in self._rows:
                        appended = None  # in-place update, not an append
                    self._rows[key] = row
                    if appended is not None:
                        appended.append(row)
            cols = self._columns_locked()
            # append-only ticks on an unsorted mirror carry the new rows
            # as an incremental hint: renderers stream JUST those to the
            # browser (reference plotting.py ColumnDataSource.stream)
            # instead of re-sending the whole snapshot
            inc = None
            if appended and self._sort_ix is None:
                inc = {
                    name: [r[i] for r in appended]
                    for i, name in enumerate(self.names)
                }
        for fn in list(self._listeners):
            fn(cols, inc)

    def _columns_locked(self) -> dict[str, list]:
        rows = list(self._rows.values())
        if self._sort_ix is not None:
            ix = self._sort_ix
            rows.sort(key=lambda r: r[ix])
        return {
            name: [r[i] for r in rows] for i, name in enumerate(self.names)
        }

    def columns(self) -> dict[str, list]:
        with self._lock:
            return self._columns_locked()

    def on_update(
        self, fn: Callable[[dict[str, list], dict[str, list] | None], None]
    ) -> None:
        """``fn(columns, appended)``: full snapshot columns plus, for
        append-only ticks on an unsorted mirror, just the appended rows
        (None otherwise) — the incremental-update channel."""
        self._listeners.append(fn)

    def __len__(self) -> int:
        with self._lock:
            return len(self._rows)


def _try_panel():
    try:
        import bokeh.models  # type: ignore[import-not-found]  # noqa: F401
        import panel  # type: ignore[import-not-found]

        return panel
    except ImportError:
        return None


def plot(table: Any, plotting_function: Callable, sorting_col: str | None = None):
    """Live-updating plot (reference plotting.py ``plot``): builds a
    ColumnDataSource over the table mirror, hands it to
    ``plotting_function(source) -> figure``, and streams updates into it.
    Without bokeh/panel installed, returns the LiveTableSource (same data,
    no rendering)."""
    source = LiveTableSource(table, sorting_col)
    panel = _try_panel()
    if panel is None:
        return source
    from bokeh.models import ColumnDataSource  # type: ignore[import-not-found]

    cds = ColumnDataSource(data=source.columns())
    fig = plotting_function(cds)

    def push(cols: dict[str, list], appended: dict[str, list] | None) -> None:
        # updates arrive on the engine thread; a served Bokeh document owns
        # its state on the session thread and requires next-tick callbacks
        # for cross-thread mutation. Append-only ticks stream JUST the new
        # rows (browser-side append, reference plotting.py:99); anything
        # with retractions/updates swaps the full snapshot.
        if appended is not None:
            apply = lambda: cds.stream(appended)  # noqa: E731
        else:
            apply = lambda: setattr(cds, "data", cols)  # noqa: E731
        doc = getattr(cds, "document", None)
        if doc is not None:
            doc.add_next_tick_callback(apply)
        else:
            apply()

    source.on_update(push)
    return panel.pane.Bokeh(fig)


def table_viz(table: Any, sorting_col: str | None = None, **kwargs: Any):
    """Live table widget (reference ``viz.table_viz``). Without panel,
    returns the LiveTableSource."""
    source = LiveTableSource(table, sorting_col)
    panel = _try_panel()
    if panel is None:
        return source
    import pandas as pd

    widget = panel.widgets.Tabulator(
        pd.DataFrame(source.columns()), **kwargs
    )

    def push(cols: dict[str, list], appended: dict[str, list] | None) -> None:
        if appended is not None and hasattr(widget, "stream"):
            apply = lambda: widget.stream(  # noqa: E731
                pd.DataFrame(appended), follow=True
            )
        else:
            apply = lambda: setattr(  # noqa: E731
                widget, "value", pd.DataFrame(cols)
            )
        doc = getattr(widget, "document", None)
        if doc is not None:
            doc.add_next_tick_callback(apply)
        else:
            apply()

    source.on_update(push)
    return widget


def show(obj: Any) -> None:
    """Open a Panel server for the visualization (reference ``show``)."""
    panel = _try_panel()
    if panel is None:
        raise ImportError(
            "pw.viz.show requires the 'bokeh' and 'panel' packages (not "
            "installed in this environment); plot()/table_viz() without "
            "them return a LiveTableSource whose .columns() holds the data"
        )
    panel.panel(obj).show()
