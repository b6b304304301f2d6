"""Per-process monitoring HTTP server.

Re-design of ``src/engine/http_server.rs:21-60``: serves OpenMetrics/
Prometheus text built from the live ``EngineStats`` on port
``20000 + process_id`` (same convention). Pure-stdlib ``http.server`` on a
daemon thread.

Endpoints:

- ``/metrics`` (also ``/`` and ``/status``) — exposition text with
  counter + histogram families (``observability/prometheus.py``). On
  process 0 of a multi-process run this is the cluster-merged view with
  per-worker labels (``observability/hub.py`` scrapes the peers).
- ``/snapshot`` — this process's raw stats as JSON; what process 0
  scrapes from peers.
- ``/query`` — windowed derived signals (rates, latency percentiles,
  frontier lag, comm backpressure) from the in-process time-series
  store (``observability/timeseries.py``); cluster-merged on process 0.
  With params (``?expr=rate(engine_ticks)&window=10`` or
  ``?metric=...&op=p95``) evaluates one expression.
- ``/attribution`` — ranked per-operator bottleneck attribution.
- ``/profile`` — continuous-profiling flamegraph (cluster-merged on
  process 0; ``?local=1`` per-process, ``?format=collapsed|speedscope``,
  ``?mode=wall|cpu``, ``?heap=1`` for the tracemalloc view).
- ``/alerts`` — active + recent SLO alerts (``PATHWAY_SLO_RULES``).
- ``/healthz`` — 200 while no executor thread is wedged, else 503.
- ``/readyz`` — 200 once sources are connected and the first frontier
  advanced, else 503.

Copy of ``pathway_tpu/engine/http_server.py``.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

__all__ = ["start_http_server", "DEFAULT_PORT_BASE"]

DEFAULT_PORT_BASE = 20000


def _render_metrics(stats: Any) -> str:
    """Exposition text for one worker's live stats (single-process
    format, no worker label). Label values are escaped per OpenMetrics —
    the seed emitted raw operator names, so a ``"`` or ``\\`` in a label
    produced unparseable text."""
    from ..observability.hub import stats_snapshot
    from ..observability.prometheus import render_snapshots

    return render_snapshots([stats_snapshot(stats)])


def start_http_server(
    stats: Any, port: int | None = None, host: str | None = None
):
    """Serve the monitoring endpoints; returns (server, thread). ``stats``
    is either a single ``EngineStats`` (wrapped into a one-worker hub) or
    an ``ObservabilityHub``. Call ``server.shutdown()`` to stop; the bound
    port is ``server.server_address[1]`` (pass ``port=0`` for ephemeral).

    Binds loopback by default — the endpoint exposes operator names and row
    counts without authentication, so exposure to all interfaces is opt-in
    via ``PATHWAY_MONITORING_HTTP_HOST=0.0.0.0``."""
    from ..observability.hub import ObservabilityHub

    try:
        from ..internals.config import get_pathway_config

        cfg = get_pathway_config()
        cfg_host = cfg.monitoring_http_host
        base, pid = cfg.monitoring_http_port, cfg.process_id
        wedge_s = cfg.health_wedge_timeout_s
    except RuntimeError:
        # config can refuse bad worker env vars (e.g. a mismatched
        # PATHWAY_ADDRESSES); explicit host/port must still work, and the
        # defaults fall back to raw env reads like the seed's
        import os

        cfg_host = os.environ.get("PATHWAY_MONITORING_HTTP_HOST", "127.0.0.1")
        try:
            base = int(
                os.environ.get("PATHWAY_MONITORING_HTTP_PORT", DEFAULT_PORT_BASE)
            )
            pid = int(os.environ.get("PATHWAY_PROCESS_ID", "0"))
        except ValueError:
            base, pid = DEFAULT_PORT_BASE, 0
        wedge_s = 30.0
    # base 0 = ephemeral for EVERY process (0 + pid would bind privileged
    # ports); ephemeral ports are unknowable to peers, so the cluster
    # roll-up skips scraping under base 0 (hub.from_config)
    cfg_port = base + pid if base else 0
    if host is None:
        host = cfg_host
    if port is None:
        port = cfg_port

    if isinstance(stats, ObservabilityHub):
        hub = stats
    else:
        hub = ObservabilityHub(wedge_timeout_s=wedge_s)
        hub.register_worker(0, stats)

    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _reply_json(self, code: int, doc: Any) -> None:
            self._reply(
                code, json.dumps(doc).encode(), "application/json"
            )

        def do_GET(self) -> None:  # noqa: N802 - http.server API
            from urllib.parse import parse_qsl, urlparse

            parsed = urlparse(self.path)
            path = parsed.path.rstrip("/")
            if path in ("", "/metrics", "/status"):
                self._reply(
                    200,
                    hub.render_metrics().encode(),
                    "text/plain; version=0.0.4; charset=utf-8",
                )
            elif path == "/snapshot":
                self._reply_json(200, hub.snapshot_document())
            elif path == "/query":
                # windowed signals (observability/timeseries.py): the
                # full derived document, or a targeted expr evaluation
                # when query params are present
                if hub.signals_plane is None:
                    self._reply_json(
                        503, {"error": "signals plane is not running"}
                    )
                    return
                params = dict(parse_qsl(parsed.query))
                try:
                    doc = (
                        hub.query_eval(params)
                        if params
                        else hub.query_document()
                    )
                except ValueError as e:
                    self._reply_json(400, {"error": str(e)})
                    return
                self._reply_json(200, doc)
            elif path == "/profile":
                # continuous profiling (observability/profiler.py):
                # cluster-merged flamegraph by default (process 0 scrapes
                # peers' ?local=1 docs), per-process with ?local=1;
                # ?format=collapsed|speedscope render, ?heap=1 the
                # on-demand tracemalloc view
                params = dict(parse_qsl(parsed.query))
                if params.get("heap"):
                    from ..observability.profiler import heap_document

                    self._reply_json(200, heap_document())
                    return
                doc = (
                    hub.profile_document()
                    if params.get("local")
                    else hub.profile_view()
                )
                fmt = params.get("format")
                mode = params.get("mode", "wall")
                if mode not in ("wall", "cpu"):
                    self._reply_json(400, {"error": f"bad mode {mode!r}"})
                    return
                if fmt == "collapsed":
                    from ..observability.profile_merge import collapsed_text

                    self._reply(
                        200,
                        collapsed_text(doc, mode=mode).encode(),
                        "text/plain; charset=utf-8",
                    )
                elif fmt == "speedscope":
                    from ..observability.profile_merge import (
                        speedscope_document,
                    )

                    self._reply_json(200, speedscope_document(doc, mode=mode))
                elif fmt:
                    self._reply_json(400, {"error": f"bad format {fmt!r}"})
                else:
                    self._reply_json(200, doc)
            elif path == "/attribution":
                if hub.signals_plane is None:
                    self._reply_json(
                        503, {"error": "signals plane is not running"}
                    )
                    return
                self._reply_json(200, hub.attribution_view())
            elif path == "/alerts":
                self._reply_json(200, hub.alerts_view())
            elif path in ("/healthz", "/readyz"):
                ok, detail = (
                    hub.health() if path == "/healthz" else hub.ready()
                )
                self._reply(
                    200 if ok else 503,
                    json.dumps(detail).encode(),
                    "application/json",
                )
            else:
                self.send_response(404)
                self.end_headers()

        def log_message(self, *args: Any) -> None:  # silence request logs
            pass

    server = ThreadingHTTPServer((host, port), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread
