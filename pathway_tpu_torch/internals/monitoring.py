"""Live monitoring dashboard (reference
``python/pathway/internals/monitoring.py:56-190`` — a rich TUI table of
connector/operator progress fed by engine ProberStats). Renders from
``EngineStats`` on a background thread; falls back to plain-text lines
when rich is unavailable or stderr is not a TTY.

Copy of ``pathway_tpu/internals/monitoring.py``.
"""

from __future__ import annotations

import sys
import threading
from typing import Any

__all__ = ["MonitoringLevel", "start_dashboard"]


class MonitoringLevel:
    NONE = 0
    IN_OUT = 1
    ALL = 2
    AUTO = 3
    AUTO_ALL = 4


def _rows(stats: Any, level: int) -> list[tuple[str, str]]:
    out = [
        ("ticks (commits)", str(stats.ticks)),
        ("rows ingested", str(stats.input_rows)),
        ("rows emitted", str(stats.output_rows)),
        (
            "output latency",
            f"{stats.latency_ms:.0f} ms" if stats.latency_ms is not None else "-",
        ),
    ]
    tick_hist = getattr(stats, "tick_duration", None)
    if tick_hist is not None and len(tick_hist):
        from ..observability.histogram import quantile_from_snapshot

        snap = tick_hist.snapshot()
        p50 = quantile_from_snapshot(snap, 0.5) / 1e6
        p95 = quantile_from_snapshot(snap, 0.95) / 1e6
        out.append(("tick p50/p95", f"{p50:.1f}/{p95:.1f} ms"))
    if level >= MonitoringLevel.ALL:
        # snapshot: the executor thread inserts node keys concurrently.
        # per-operator row counts + cumulative processing time (the
        # reference's connector/operator latency table, monitoring.py:56-190)
        times = dict(stats.time_by_node)
        for label, count in sorted(list(stats.rows_by_node.items())):
            ms = times.get(label, 0) / 1e6
            out.append((
                f"  {label}",
                f"{count} rows / {ms:.1f} ms" if ms else f"{count} rows",
            ))
    return out


def start_dashboard(stats: Any, level: int, refresh_s: float = 1.0):
    """Returns a stop() callable."""
    if level == MonitoringLevel.NONE:
        # a NONE caller must get a no-op — without this early return a
        # refresh thread would still spawn and spam stderr
        return lambda: None
    if level in (MonitoringLevel.AUTO, MonitoringLevel.AUTO_ALL):
        if not sys.stderr.isatty():
            # AUTO means "dashboard only when interactive" (reference
            # resolves AUTO to NONE off-tty) — don't spam piped logs
            return lambda: None
        level = (
            MonitoringLevel.ALL
            if level == MonitoringLevel.AUTO_ALL
            else MonitoringLevel.IN_OUT
        )
    if level >= MonitoringLevel.ALL:
        stats.detailed = True  # turn on per-node timing in the executor
    stop_event = threading.Event()

    def plain_loop() -> None:
        while not stop_event.wait(refresh_s):
            parts = ", ".join(f"{k}={v}" for k, v in _rows(stats, level))
            print(f"[pathway monitoring] {parts}", file=sys.stderr)

    def rich_loop() -> None:
        from rich.console import Console
        from rich.live import Live
        from rich.table import Table as RichTable

        def render():
            table = RichTable(title="pathway_tpu engine")
            table.add_column("metric")
            table.add_column("value", justify="right")
            for k, v in _rows(stats, level):
                table.add_row(k, v)
            return table

        # dashboard goes to stderr (the tty we gated on) so redirected
        # stdout program output stays clean
        console = Console(file=sys.stderr)
        with Live(render(), refresh_per_second=4, transient=True,
                  console=console) as live:
            while not stop_event.wait(refresh_s):
                live.update(render())

    use_rich = sys.stderr.isatty()
    if use_rich:
        try:
            import rich  # noqa: F401
        except ImportError:
            use_rich = False
    thread = threading.Thread(
        target=rich_loop if use_rich else plain_loop, daemon=True
    )
    thread.start()

    def stop() -> None:
        stop_event.set()
        thread.join(timeout=2)

    return stop
