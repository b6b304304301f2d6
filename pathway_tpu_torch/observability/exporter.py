"""Periodic telemetry flusher.

The seed exported telemetry exactly once, at run exit — a crashed or
OOM-killed streaming run left nothing behind. This background thread
(the analog of the reference's batched OTLP export pipeline,
``src/engine/telemetry.rs:97-156``) flushes every N seconds:

- the local Chrome-trace file (``PATHWAY_TRACE_FILE``) is rewritten, so
  the newest window of spans survives a crash;
- tracer events appended since the last push go to the configured OTLP
  endpoints (incremental — the shared ``_otlp_mark`` cursor also keeps
  the end-of-run export from re-sending them);
- engine histograms (tick duration, per-operator processing time, output
  latency) ship as OTLP histogram data points.

Interval: ``PATHWAY_TELEMETRY_FLUSH_S`` (``internals/config.py``),
default 60, ``0`` disables. Export never raises into the run.

Copy of ``pathway_tpu/observability/exporter.py``.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any

__all__ = ["PeriodicFlusher", "start_periodic_flusher"]


class PeriodicFlusher:
    def __init__(
        self,
        interval_s: float,
        hub: Any = None,
        endpoints: list[str] | None = None,
    ):
        self.interval_s = interval_s
        self.hub = hub
        self._endpoints = endpoints or []
        self._exporters: list[Any] | None = None  # built lazily, once
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.flushes = 0

    def _make_exporters(self) -> list[Any]:
        if self._exporters is None:
            from ..internals.telemetry import OtlpExporter

            # one exporter per endpoint for the flusher's lifetime: every
            # push shares one run id / trace id, so the collector sees a
            # single coherent run instead of one per flush
            self._exporters = [OtlpExporter(ep) for ep in self._endpoints]
        return self._exporters

    def flush_once(self) -> None:
        """One flush cycle; swallows everything — telemetry must not fail
        (or slow down by raising into) the run it observes."""
        try:
            self._flush_inner()
            self.flushes += 1
        except Exception:
            pass

    def _flush_inner(self) -> None:
        from ..internals.tracing import get_tracer

        tracer = get_tracer()
        exporters = self._make_exporters()
        if tracer is not None:
            tracer.flush()  # crash-durable local trace file
            if exporters:
                events, mark = tracer.events_since(tracer._otlp_mark)
                if events:
                    origin_unix_ns = time.time_ns() - (
                        time.perf_counter_ns() - tracer._origin
                    )
                    for exp in exporters:
                        exp.export_events(events, origin_unix_ns)
                    tracer._otlp_mark = mark
        if exporters and self.hub is not None:
            points = self._histogram_points()
            if points:
                for exp in exporters:
                    exp.export_histograms(points, time.time_ns())

    def _histogram_points(self) -> list[tuple[str, dict, dict]]:
        points: list[tuple[str, dict, dict]] = []
        for snap in self.hub.local_snapshots():
            attrs = {"worker": snap.get("worker", 0)}
            points.append(
                ("pathway.tick_duration", attrs, snap["tick_duration"])
            )
            if snap.get("latency_hist", {}).get("count"):
                points.append(
                    ("pathway.output_latency", attrs, snap["latency_hist"])
                )
            for op, hsnap in snap.get("node_time_hist", {}).items():
                points.append(
                    (
                        "pathway.operator_processing",
                        {**attrs, "operator": op},
                        hsnap,
                    )
                )
        return points

    # -- lifecycle -----------------------------------------------------

    def start(self) -> "PeriodicFlusher":
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="pathway-telemetry-flush"
        )
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.flush_once()

    def stop(self) -> None:
        """Stop the loop, then flush one last time: a run shorter than the
        interval would otherwise export zero histogram datapoints (the
        caller's export_from_env only ships tracer events), and even long
        runs would leave the collector's cumulative totals one interval
        stale. The shared ``_otlp_mark`` cursor keeps the span side
        incremental, so nothing double-exports."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self.flush_once()


def start_periodic_flusher(hub: Any = None) -> PeriodicFlusher | None:
    """Env-gated: starts a flusher when a positive interval is configured
    AND there is something to flush (a trace file or an OTLP endpoint)."""
    from ..internals.config import get_pathway_config
    from ..internals.tracing import get_tracer

    try:
        cfg = get_pathway_config()
        interval = cfg.telemetry_flush_s
    except RuntimeError:
        interval = 60.0
    if interval <= 0:
        return None
    endpoints = sorted(
        {
            e
            for e in (
                os.environ.get("PATHWAY_TELEMETRY_SERVER"),
                os.environ.get("PATHWAY_MONITORING_SERVER"),
            )
            if e
        }
    )
    tracer = get_tracer()
    has_trace_file = tracer is not None and tracer.path is not None
    if not endpoints and not has_trace_file:
        return None
    return PeriodicFlusher(interval, hub=hub, endpoints=endpoints).start()
