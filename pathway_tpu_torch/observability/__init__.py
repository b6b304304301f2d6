"""End-to-end engine observability.

The reference engine's telemetry pair — per-operator OTLP metrics
(``src/engine/telemetry.rs:47-156``) and per-process metrics ports
(``src/engine/http_server.rs:21-60``) — rebuilt as a subsystem:

- :mod:`histogram` — lock-cheap log2-bucketed latency histograms;
- :mod:`prometheus` — OpenMetrics exposition rendering (escaped labels,
  histogram families) from JSON snapshots;
- :mod:`hub` — per-process worker/comm registry + the cluster roll-up
  process 0 serves as a merged per-worker-labeled ``/metrics``;
- :mod:`health` — ``/healthz`` (executor not wedged) and ``/readyz``
  (sources connected, first frontier advanced) probe semantics;
- :mod:`exporter` — periodic OTLP/trace-file flusher so crashed runs
  still leave telemetry;
- :mod:`flightrecorder` — always-on mmap ring per process (the black
  box): the last K ticks survive SIGKILL, harvested by the supervisor
  into ``crash-<gen>-<proc>.json`` forensic bundles;
- :mod:`trace_merge` — assembles per-process ``PATHWAY_TRACE_FILE``
  parts into one clock-aligned cluster timeline
  (``pathway-tpu trace merge``);
- :mod:`timeseries` — the signals plane: windowed in-process
  time-series store over every EngineStats gauge/counter/histogram +
  comm counters, with rate/delta/percentile/sustained queries
  (``/query``, merged on process 0);
- :mod:`attribution` — per-operator bottleneck attribution over the
  signals window (``/attribution``, ``pathway_bottleneck_operator``);
- :mod:`slo` — declarative SLO rules (``PATHWAY_SLO_RULES``) evaluated
  against the store; alerts fan out to ``/alerts``, the trace stream
  and the flight recorder;
- :mod:`top` — the ``pathway-tpu top`` live terminal dashboard;
- :mod:`profiler` — the always-on sampling profiler: per-process
  collapsed-stack tables (wall + CPU) with operator tags joining
  against /attribution, flight-ring top-K deposits, tracemalloc heap
  view (``/profile``, ``PATHWAY_PROFILE*`` knobs);
- :mod:`profile_merge` — associative cluster merge of profiler
  snapshots + collapsed/speedscope/top renderers
  (``pathway-tpu profile``).

The HTTP surface itself lives in ``engine/http_server.py``; instrumented
state in ``engine/executor.EngineStats``.

Copy of ``pathway_tpu/observability/__init__.py``; the command line
(``python -m pathway_tpu_torch.cli``) drives ``top``, ``trace_merge`` and the
``profile`` and ``critpath`` renderers (``render_top``,
``critpath.render_report``).
"""

from .attribution import attribution_document, bottleneck_operator
from .exporter import PeriodicFlusher, start_periodic_flusher
from .flightrecorder import FlightRecorder, get_recorder, harvest
from .health import health_status, ready_status
from .histogram import LogHistogram, merge_snapshots, quantile_from_snapshot
from .hub import ObservabilityHub, stats_snapshot
from .profile_merge import (
    collapsed_text,
    render_top,
    speedscope_document,
    top_frames,
)
from .profiler import Profiler, current_op_slot, heap_document
from .prometheus import (
    escape_label_value,
    parse_exposition,
    render_snapshots,
)
from .slo import AlertLog, Rule, SloEngine, load_rules
from .timeseries import Signals, SignalsPlane, TimeSeriesStore

__all__ = [
    "AlertLog",
    "FlightRecorder",
    "LogHistogram",
    "ObservabilityHub",
    "PeriodicFlusher",
    "Profiler",
    "Rule",
    "Signals",
    "SignalsPlane",
    "SloEngine",
    "TimeSeriesStore",
    "attribution_document",
    "bottleneck_operator",
    "collapsed_text",
    "current_op_slot",
    "get_recorder",
    "harvest",
    "heap_document",
    "escape_label_value",
    "health_status",
    "load_rules",
    "merge_snapshots",
    "render_top",
    "speedscope_document",
    "top_frames",
    "parse_exposition",
    "quantile_from_snapshot",
    "ready_status",
    "render_snapshots",
    "start_periodic_flusher",
    "stats_snapshot",
]
