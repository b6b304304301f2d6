"""OTLP telemetry push (reference ``src/engine/telemetry.rs:63-156``).

The tracer (``tracing.py``) records spans and counter samples locally;
this module exports them over OTLP/HTTP JSON to a collector when
``PATHWAY_TELEMETRY_SERVER`` (spans + metrics, the usage-telemetry role)
or ``PATHWAY_MONITORING_SERVER`` (operator monitoring) is set — the same
two-endpoint split as the reference's TelemetryConfig
(``telemetry.rs:180-221``). OTLP/gRPC needs the opentelemetry SDK (not
baked into this environment); OTLP/HTTP JSON is part of the OTLP spec and
needs only ``urllib``, so the export path is fully local-testable against
a loopback collector. Export never raises: telemetry must not fail the
run it observes.

Resource attributes mirror ``telemetry.rs:63-74``: service.name/version,
service.instance.id, run.id.

Copy of ``pathway_tpu/internals/telemetry.py``.
"""

from __future__ import annotations

import json
import os
import secrets
import time
from typing import Any

__all__ = ["OtlpExporter", "export_from_env"]

_EXPORT_TIMEOUT_S = 10.0


def _hex_id(n_bytes: int) -> str:
    return secrets.token_hex(n_bytes)


class OtlpExporter:
    """Convert tracer events to OTLP/HTTP JSON and POST them.

    Spans (Chrome ``ph: X`` duration events) go to ``/v1/traces`` as one
    scope-span batch under a fresh trace id; counter samples (``ph: C``)
    go to ``/v1/metrics`` as gauge points.
    """

    def __init__(self, endpoint: str, *, service_name: str = "pathway_tpu",
                 run_id: str | None = None):
        self.endpoint = endpoint.rstrip("/")
        self.service_name = service_name
        self.run_id = run_id or _hex_id(8)
        self.trace_id = _hex_id(16)

    # -- payload building -------------------------------------------------

    def _resource(self) -> dict:
        from .. import __version__

        attrs = {
            "service.name": self.service_name,
            "service.version": __version__,
            "service.instance.id": f"{os.getpid()}@{os.uname().nodename}",
            "run.id": self.run_id,
        }
        return {
            "attributes": [
                {"key": k, "value": {"stringValue": str(v)}}
                for k, v in attrs.items()
            ]
        }

    @staticmethod
    def _attr_value(v: Any) -> dict:
        if isinstance(v, bool):
            return {"boolValue": v}
        if isinstance(v, int):
            return {"intValue": str(v)}
        if isinstance(v, float):
            return {"doubleValue": v}
        return {"stringValue": str(v)}

    def spans_payload(self, events: list[dict], origin_unix_ns: int) -> dict:
        """ExportTraceServiceRequest for the tracer's duration events.
        ``origin_unix_ns`` anchors the tracer's relative µs timestamps."""
        spans = []
        for ev in events:
            if ev.get("ph") != "X":
                continue
            start = origin_unix_ns + int(ev["ts"] * 1e3)
            end = start + int(ev.get("dur", 0.0) * 1e3)
            span = {
                "traceId": self.trace_id,
                "spanId": _hex_id(8),
                "name": ev["name"],
                "kind": 1,  # SPAN_KIND_INTERNAL
                "startTimeUnixNano": str(start),
                "endTimeUnixNano": str(end),
            }
            args = ev.get("args") or {}
            if args:
                span["attributes"] = [
                    {"key": k, "value": self._attr_value(v)}
                    for k, v in args.items()
                ]
            spans.append(span)
        return {
            "resourceSpans": [{
                "resource": self._resource(),
                "scopeSpans": [{
                    "scope": {"name": "pathway_tpu.tracing"},
                    "spans": spans,
                }],
            }]
        }

    def metrics_payload(self, events: list[dict], origin_unix_ns: int) -> dict:
        """ExportMetricsServiceRequest: counter samples become gauges."""
        series: dict[str, list[dict]] = {}
        for ev in events:
            if ev.get("ph") != "C":
                continue
            t = str(origin_unix_ns + int(ev["ts"] * 1e3))
            for field, value in (ev.get("args") or {}).items():
                name = f"{ev['name']}.{field}" if field != "value" else ev["name"]
                series.setdefault(name, []).append({
                    "timeUnixNano": t,
                    "asDouble": float(value),
                })
        metrics = [
            {"name": name, "gauge": {"dataPoints": points}}
            for name, points in series.items()
        ]
        return {
            "resourceMetrics": [{
                "resource": self._resource(),
                "scopeMetrics": [{
                    "scope": {"name": "pathway_tpu.tracing"},
                    "metrics": metrics,
                }],
            }]
        }

    def histograms_payload(
        self,
        points: list[tuple[str, dict, dict]],
        time_unix_nano: int,
    ) -> dict:
        """ExportMetricsServiceRequest for engine histogram snapshots
        (observability/histogram.py log2 buckets → OTLP explicit-bounds
        histogram data points, cumulative temporality)."""
        metrics = []
        for name, attrs, snap in points:
            counts = snap["counts"]
            nonzero = [i for i, c in enumerate(counts) if c]
            if nonzero:
                lo, hi = nonzero[0], nonzero[-1]
                # bounds in seconds; bucket i upper bound is 2^i ns
                bounds = [(1 << i) / 1e9 for i in range(lo, hi + 1)]
                bucket_counts = (
                    [str(sum(counts[: lo]) + counts[lo])]
                    + [str(counts[i]) for i in range(lo + 1, hi + 1)]
                    + ["0"]  # overflow bucket beyond the occupied range
                )
            else:
                bounds = []
                bucket_counts = [str(snap["count"])]
            point = {
                "timeUnixNano": str(time_unix_nano),
                "count": str(snap["count"]),
                "sum": snap["sum"] / 1e9,
                "bucketCounts": bucket_counts,
                "explicitBounds": bounds,
            }
            if attrs:
                point["attributes"] = [
                    {"key": k, "value": self._attr_value(v)}
                    for k, v in attrs.items()
                ]
            metrics.append({
                "name": name,
                "histogram": {
                    "aggregationTemporality": 2,  # CUMULATIVE
                    "dataPoints": [point],
                },
            })
        return {
            "resourceMetrics": [{
                "resource": self._resource(),
                "scopeMetrics": [{
                    "scope": {"name": "pathway_tpu.observability"},
                    "metrics": metrics,
                }],
            }]
        }

    # -- transport --------------------------------------------------------

    def _post(self, path: str, payload: dict) -> bool:
        import urllib.request

        req = urllib.request.Request(
            self.endpoint + path,
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
        )
        try:
            with urllib.request.urlopen(req, timeout=_EXPORT_TIMEOUT_S) as r:
                return 200 <= r.status < 300
        except Exception:
            return False

    def export(self, tracer: Any) -> dict[str, bool]:
        """Push the tracer's current buffer; returns per-signal success.

        One-shot/diagnostic surface only: it ignores the ``_otlp_mark``
        cursor, so mixing it with the periodic flusher would double-export
        — incremental callers go through ``export_events`` +
        ``Tracer.events_since`` instead."""
        with tracer._lock:
            events = list(tracer._events)
            origin = tracer._origin
        # anchor relative timestamps to the wall clock NOW minus the
        # monotonic distance to each event (close enough for telemetry)
        origin_unix_ns = time.time_ns() - (time.perf_counter_ns() - origin)
        return self.export_events(events, origin_unix_ns)

    def export_events(
        self, events: list[dict], origin_unix_ns: int
    ) -> dict[str, bool]:
        """Push a specific event slice (the periodic flusher's incremental
        path — it exports only events_since the shared cursor)."""
        out = {}
        spans = self.spans_payload(events, origin_unix_ns)
        if spans["resourceSpans"][0]["scopeSpans"][0]["spans"]:
            out["traces"] = self._post("/v1/traces", spans)
        metrics = self.metrics_payload(events, origin_unix_ns)
        if metrics["resourceMetrics"][0]["scopeMetrics"][0]["metrics"]:
            out["metrics"] = self._post("/v1/metrics", metrics)
        return out

    def export_histograms(
        self, points: list[tuple[str, dict, dict]], time_unix_nano: int
    ) -> bool:
        payload = self.histograms_payload(points, time_unix_nano)
        if not payload["resourceMetrics"][0]["scopeMetrics"][0]["metrics"]:
            return True
        return self._post("/v1/metrics", payload)


def export_from_env(tracer: Any | None) -> None:
    """End-of-run hook: push to PATHWAY_TELEMETRY_SERVER and/or
    PATHWAY_MONITORING_SERVER when set. Idempotent per buffer state (the
    hook sits at several run exits) and never raises. Shares the
    ``_otlp_mark`` cursor with the periodic flusher
    (observability/exporter.py), so only the tail appended since the last
    periodic push goes out here."""
    if tracer is None:
        return
    endpoints = [
        os.environ.get("PATHWAY_TELEMETRY_SERVER"),
        os.environ.get("PATHWAY_MONITORING_SERVER"),
    ]
    eps = {e for e in endpoints if e}
    if not eps:
        return
    events, mark = tracer.events_since(tracer._otlp_mark)
    if not events:
        return
    tracer._otlp_mark = mark
    origin_unix_ns = time.time_ns() - (
        time.perf_counter_ns() - tracer._origin
    )
    for ep in eps:
        try:
            OtlpExporter(ep).export_events(events, origin_unix_ns)
        except Exception:
            pass
