"""In-process span tracing and run profiling.

Re-design of the reference's telemetry pair — Rust OTLP traces/metrics
(``src/engine/telemetry.rs:47-156``) and the Python build/run spans
(``python/pathway/internals/graph_runner/telemetry.py``,
``graph_runner/__init__.py:146-176``) — for an environment with no
network egress: instead of pushing OTLP over gRPC, the tracer records
spans in memory and writes the Chrome Trace Event format (the catapult
JSON array understood by ``chrome://tracing`` and ``ui.perfetto.dev``)
when the run finishes.

Activation is env-first like every other engine knob
(``internals/config.py``): set ``PATHWAY_TRACE_FILE=/path/run.json``.
When unset, ``get_tracer()`` returns ``None`` and every instrumentation
site is a single ``is None`` check — no timestamps are taken.

Span taxonomy (mirrors the reference's span names where it has them):

- ``graph.build`` — lowering the parse graph to engine nodes
  (reference span ``graph_runner/__init__.py:146``);
- ``engine.run`` — the whole executor run;
- ``tick`` — one logical-time sweep, with the minted timestamp attached;
- per-node events under each tick, named ``<NodeClass>#<id>``, with the
  emitted row count — the analog of timely's event logging stream
  (``DIFFERENTIAL_LOG_ADDR``, reference ``dataflow.rs:5540-5548``);
- counter samples of ``EngineStats`` totals per tick, rendered by the
  trace viewers as time series.

Multi-process runs write one file per process (``<path>.p<process_id>``,
like the per-process metrics ports of ``engine/http_server.rs:21``);
worker threads separate naturally by ``tid``. Cross-process linkage is
Dapper-style: every tracer carries a cluster-wide ``run_id``
(``PATHWAY_RUN_ID``, stamped by ``pathway-tpu spawn``), comm frames ship a
``(run_id, flow_id)`` trace context, and both ends emit Chrome flow
events (``ph: s``/``f``) bound by that id — ``pathway-tpu trace merge``
assembles the per-process files into one clock-aligned cluster timeline
(``observability/trace_merge.py``), using the per-peer clock offsets the
cluster handshake estimates (``parallel/cluster.py``) and records here via
:meth:`Tracer.set_clock_offsets`.

Copy of ``pathway_tpu/internals/tracing.py``: the executor's tick and node
spans, the commit-wave spans, the comm backends' flow events, the OTLP
export cursor (``events_since``), ``instant``, ``counter``,
``set_clock_offsets``, ``init_from_env`` (each ``pw.run`` re-reads
``PATHWAY_TRACE_FILE``) and the module-level ``span``. The per-process file
naming (``<path>.p<N>``) reads ``PATHWAY_PROCESSES`` as the reference does;
the port's runner refuses more than one process.
"""

from __future__ import annotations

import json
import os
import secrets
import threading
import time
from typing import Any

__all__ = [
    "Tracer",
    "activate",
    "deactivate",
    "get_tracer",
    "init_from_env",
    "mint_flow_tag",
    "span",
]


def mint_flow_tag() -> str:
    """Per-comm-instance disambiguator for deterministic flow ids (ids are
    ``<run_id>/<tag>/...``): several comm backends — or repeated ``pw.run``
    calls under ``activate()`` — share one tracer, and two instances
    minting ids from the same (channel, tick) coordinates must not
    collide. One shared definition so every comm layer's ids stay
    mergeable by the same scheme."""
    return secrets.token_hex(2)


def make_flow_id(tracer: "Tracer", tag: str, *coords: Any) -> str:
    """THE flow-id scheme: ``<run_id>/<tag>/<coord>/...``. Every comm
    backend builds its ids here — the run id scopes them cluster-wide,
    ``tag`` (a :func:`mint_flow_tag`) scopes them per comm instance, and
    the coordinates make them deterministic so sender and receiver can
    mint the same id without shipping context (LocalComm/MeshComm) or
    ship it once per frame (ClusterComm)."""
    return "/".join([tracer.run_id, tag, *map(str, coords)])


class _Span:
    __slots__ = ("tracer", "name", "args", "t0")

    def __init__(self, tracer: "Tracer", name: str, args: dict[str, Any]):
        self.tracer = tracer
        self.name = name
        self.args = args

    def __enter__(self) -> "_Span":
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.tracer.complete(self.name, self.t0, self.args or None)


class Tracer:
    """Collects Chrome-trace events; thread-safe, append-only.

    ``path=None`` collects without writing a local trace file — the mode
    used when only an OTLP endpoint (``internals/telemetry.py``) consumes
    the spans."""

    def __init__(self, path: str | None, max_events: int | None = None):
        self.path = path
        self._events: list[dict[str, Any]] = []
        self._lock = threading.Lock()
        self._pid = os.getpid()
        #: cluster-wide run identity: every process of one spawn shares it
        #: (the CLI stamps PATHWAY_RUN_ID), so flow ids minted here are
        #: unique AND recognizable across the whole ensemble's trace files
        self.run_id = os.environ.get("PATHWAY_RUN_ID") or secrets.token_hex(4)
        #: wall-clock anchor of the perf_counter origin — what lets the
        #: merge CLI (and the OTLP exporters) place this process's relative
        #: timestamps on a shared unix timeline
        unix_now = time.time_ns()
        #: perf_counter origin so timestamps start near zero in the viewer
        self._origin = time.perf_counter_ns()
        self.origin_unix_ns = unix_now
        #: peer process id -> (unix-clock offset ns, rtt ns), estimated by
        #: the cluster handshake ping (ClusterComm); written to the trace
        #: file so `trace merge` can align per-host clocks
        self._clock_offsets: dict[int, tuple[float, float]] = {}
        #: streaming pipelines run forever (run.py) — bound the buffer so
        #: tracing a long-lived run keeps the most recent window instead of
        #: growing without limit; oldest half is dropped on overflow
        if max_events is None:
            max_events = int(
                os.environ.get("PATHWAY_TRACE_MAX_EVENTS", "500000")
            )
        self._max_events = max(max_events, 2)
        self._dropped = 0
        self._appended = 0
        self._flush_mark = -1  # _appended value at the last write
        #: incremental-export cursor shared by the periodic OTLP flusher
        #: and the end-of-run push (internals/telemetry.py)
        self._otlp_mark = 0

    # -- recording ----------------------------------------------------

    def _ts(self, ns: int) -> float:
        return (ns - self._origin) / 1e3  # µs

    def span(self, name: str, **args: Any) -> _Span:
        """``with tracer.span("graph.build", tables=3): ...``"""
        return _Span(self, name, args)

    def complete(
        self,
        name: str,
        t0_ns: int,
        args: dict[str, Any] | None = None,
        counter: tuple[str, dict[str, float]] | None = None,
    ) -> None:
        """A finished duration event that began at ``t0_ns``. With
        ``counter=(name, values)`` a counter sample is appended in the SAME
        lock acquisition, so the pair is adjacent in the buffer and the
        overflow drop can never orphan the sample from its span (the
        executor's per-tick row counters use this)."""
        ev = {
            "name": name,
            "ph": "X",
            "ts": self._ts(t0_ns),
            "dur": (time.perf_counter_ns() - t0_ns) / 1e3,
            "pid": self._pid,
            "tid": threading.get_ident() % 2**31,
        }
        if args:
            ev["args"] = args
        if counter is None:
            self._append(ev)
            return
        cname, values = counter
        cev = {
            "name": cname,
            "ph": "C",
            "ts": ev["ts"] + ev["dur"],
            "pid": self._pid,
            "args": values,
        }
        self._append(ev, cev)

    def _append(self, *evs: dict[str, Any]) -> None:
        with self._lock:
            self._events.extend(evs)
            self._appended += len(evs)
            if len(self._events) > self._max_events:
                n = len(self._events)
                drop = n // 2
                # span-boundary-consistent chunking: never let the kept
                # window BEGIN with a counter sample whose owning span was
                # just dropped (complete(..., counter=...) appends the pair
                # adjacently, so skipping leading "C" events preserves it)
                while drop < n and self._events[drop].get("ph") == "C":
                    drop += 1
                if drop >= n:  # pathological all-counter buffer
                    drop = n // 2
                self._dropped += drop
                del self._events[:drop]

    def instant(self, name: str, **args: Any) -> None:
        ev = {
            "name": name,
            "ph": "i",
            "s": "t",
            "ts": self._ts(time.perf_counter_ns()),
            "pid": self._pid,
            "tid": threading.get_ident() % 2**31,
        }
        if args:
            ev["args"] = args
        self._append(ev)

    def counter(self, name: str, values: dict[str, float]) -> None:
        """A counter sample (rendered as stacked time series). Callers with
        per-worker counters must put the worker id in ``name`` — trace
        viewers key counter tracks by (pid, name), so same-named samples
        from different workers would interleave into one garbled series."""
        self._append(
            {
                "name": name,
                "ph": "C",
                "ts": self._ts(time.perf_counter_ns()),
                "pid": self._pid,
                "args": values,
            }
        )

    # -- cross-worker flow linkage ------------------------------------

    def flow_start(self, name: str, flow_id: str, **args: Any) -> None:
        """Begin a Chrome flow (``ph: s``) — the sending half of a
        cross-worker arrow. The event must fall inside a duration slice on
        this thread (comm call sites sit inside the tick span); the
        receiving side closes the flow with :meth:`flow_end` using the
        SAME id, which travels in the comm frame's trace context."""
        ev = {
            "name": name,
            "cat": "comm",
            "ph": "s",
            "id": str(flow_id),
            "ts": self._ts(time.perf_counter_ns()),
            "pid": self._pid,
            "tid": threading.get_ident() % 2**31,
        }
        if args:
            ev["args"] = args
        self._append(ev)

    def flow_end(self, name: str, flow_id: str, **args: Any) -> None:
        """Close a flow (``ph: f``) at the receiving worker; ``bp: e``
        binds the arrow to the enclosing slice."""
        ev = {
            "name": name,
            "cat": "comm",
            "ph": "f",
            "bp": "e",
            "id": str(flow_id),
            "ts": self._ts(time.perf_counter_ns()),
            "pid": self._pid,
            "tid": threading.get_ident() % 2**31,
        }
        if args:
            ev["args"] = args
        self._append(ev)

    # -- merge/alignment metadata -------------------------------------

    def set_clock_offsets(self, offsets: dict[int, tuple[float, float]]) -> None:
        """Record per-peer unix-clock offset estimates (peer process id ->
        (offset ns, rtt ns), offset = peer clock minus ours) from the
        cluster handshake ping — flushed as ``trace.clock_sync`` metadata
        for ``pathway-tpu trace merge``."""
        with self._lock:
            self._clock_offsets = dict(offsets)

    def events_since(self, mark: int) -> tuple[list[dict[str, Any]], int]:
        """Events appended after the ``mark`` cursor (an ``_appended``
        value), plus the new cursor — the incremental-export protocol used
        by the periodic OTLP flusher (observability/exporter.py) and the
        end-of-run push, which share one cursor so nothing double-exports.
        Events already dropped by the ring buffer are simply gone: when
        more than ``new`` events were appended but the buffer holds fewer,
        the negative slice caps at the buffer — every returned event is
        still strictly after ``mark`` (the buffer always holds the newest
        ``len(_events)`` appends), so a drop can neither skip live events
        nor re-export old ones (tests/test_tracing.py drop-cursor cases)."""
        with self._lock:
            new = self._appended - mark
            if new <= 0:
                return [], self._appended
            return list(self._events[-new:]), self._appended

    # -- output -------------------------------------------------------

    def flush(self) -> str | None:
        """Write the full event buffer to the trace file. Re-flushable: a
        tracer kept alive across several ``pw.run`` calls (``activate()``)
        rewrites the file with the accumulated events each time; a flush
        with nothing new since the last write is a no-op. Never raises —
        tracing is auxiliary and must not fail (or mask the error of) the
        run it observes."""
        if self.path is None:  # OTLP-only mode: no local file
            return None
        with self._lock:
            if self._flush_mark == self._appended:
                return None
            self._flush_mark = self._appended
            events = list(self._events)
        path = self.path
        # raw env read, not PathwayConfig: config validation can refuse the
        # worker layout (e.g. over the worker cap) and flush must not raise
        try:
            n_processes = int(os.environ.get("PATHWAY_PROCESSES", "1"))
            process_id = int(os.environ.get("PATHWAY_PROCESS_ID", "0"))
        except ValueError:
            n_processes, process_id = 1, 0
        if n_processes > 1:
            path = f"{path}.p{process_id}"
        meta = [
            {
                "name": "process_name",
                "ph": "M",
                "pid": self._pid,
                "args": {"name": "pathway_tpu"},
            },
            # merge/alignment anchor: run identity, this process's place in
            # the ensemble, its unix-clock origin, and the handshake's
            # per-peer clock-offset estimates (trace_merge.py consumes it)
            {
                "name": "trace.clock_sync",
                "ph": "i",
                "s": "g",
                "ts": 0.0,
                "pid": self._pid,
                "tid": 0,
                "args": {
                    "run_id": self.run_id,
                    "process_id": process_id,
                    "origin_unix_ns": self.origin_unix_ns,
                    "clock_offsets": {
                        str(p): [off, rtt]
                        for p, (off, rtt) in sorted(
                            self._clock_offsets.items()
                        )
                    },
                },
            },
        ]
        if self._dropped:
            meta.append(
                {
                    "name": "trace.dropped_events",
                    "ph": "i",
                    "s": "g",
                    "ts": 0.0,
                    "pid": self._pid,
                    "tid": 0,
                    "args": {"count": self._dropped},
                }
            )
        try:
            # atomic rewrite: the periodic flusher rewrites this file every
            # interval, and a SIGKILL mid-write must leave the PREVIOUS
            # complete flush on disk, not a torn JSON — crashed runs are
            # exactly the ones whose trace gets read
            tmp = f"{path}.tmp"
            with open(tmp, "w") as f:
                json.dump(
                    {"traceEvents": meta + events, "displayTimeUnit": "ms"}, f
                )
            os.replace(tmp, path)
        except (OSError, TypeError, ValueError) as e:
            import warnings

            warnings.warn(
                f"could not write trace file {path!r}: {e}", RuntimeWarning
            )
            return None
        return path


_active: Tracer | None = None
_env_checked = False
_programmatic = False


def activate(path: str) -> Tracer:
    """Programmatic activation (the env var is the usual route). Survives
    ``pw.run``'s env re-read until ``deactivate()``."""
    global _active, _env_checked, _programmatic
    _active = Tracer(path)
    _env_checked = True
    _programmatic = True
    return _active


def deactivate() -> None:
    global _active, _env_checked, _programmatic
    _active = None
    _env_checked = True
    _programmatic = False


def init_from_env() -> Tracer | None:
    """Install a tracer if ``PATHWAY_TRACE_FILE`` is set (read through
    ``PathwayConfig`` so the config snapshot and the tracer agree). Called
    at the top of every run so each ``pw.run`` re-reads the environment; a
    tracer installed via ``activate()`` is kept as-is."""
    global _active, _env_checked
    if _programmatic:
        return _active
    try:
        from .config import get_pathway_config

        path = get_pathway_config().trace_file
    except (ImportError, RuntimeError):
        # config can refuse bad worker env vars; tracing still works
        path = os.environ.get("PATHWAY_TRACE_FILE")
    if path:
        _active = Tracer(path)
    elif os.environ.get("PATHWAY_TELEMETRY_SERVER") or os.environ.get(
        "PATHWAY_MONITORING_SERVER"
    ):
        # an OTLP endpoint alone still needs a span collector — file-less
        # tracer (the reference enables telemetry without local tracing,
        # telemetry.rs:215-221)
        _active = Tracer(None)
    else:
        _active = None
    _env_checked = True
    return _active


def get_tracer() -> Tracer | None:
    global _env_checked
    if not _env_checked:
        init_from_env()
    return _active


def span(name: str, **args: Any):
    """Span on the active tracer, or a no-op context when tracing is off —
    lets instrumentation sites keep a single code path."""
    import contextlib

    tracer = get_tracer()
    if tracer is None:
        return contextlib.nullcontext()
    return tracer.span(name, **args)
