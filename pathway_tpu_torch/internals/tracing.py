"""In-process span tracing: Chrome Trace Event files of an engine run.

Set ``PATHWAY_TRACE_FILE=/path/run.json`` (or call :func:`activate`) and the
executor records one span per tick and per node, the comm backends record
flow events that link a worker's deposit to the driver's collective and back;
the file opens in ``chrome://tracing`` or ``ui.perfetto.dev``. When unset,
``get_tracer()`` returns ``None`` and every instrumentation site is a single
``is None`` check — no timestamps are taken. A comm or executor reads the
active tracer when it is built.

Copy of the parts of ``pathway_tpu/internals/tracing.py`` that
``get_tracer``, ``mint_flow_tag`` and ``make_flow_id`` need: the OTLP export
cursor, the cluster clock offsets and multi-process file naming are left out.
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
    "make_flow_id",
    "mint_flow_tag",
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
    """Collects Chrome-trace events; thread-safe, append-only, bounded."""

    def __init__(self, path: str, max_events: int | None = None):
        self.path = path
        self._events: list[dict[str, Any]] = []
        self._lock = threading.Lock()
        self._pid = os.getpid()
        #: run identity: scopes the flow ids minted by the comm backends
        self.run_id = os.environ.get("PATHWAY_RUN_ID") or secrets.token_hex(4)
        #: perf_counter origin so timestamps start near zero in the viewer
        self._origin = time.perf_counter_ns()
        #: bound the buffer so tracing a long run keeps the most recent
        #: window instead of growing without limit; the oldest half is
        #: dropped on overflow
        if max_events is None:
            max_events = int(
                os.environ.get("PATHWAY_TRACE_MAX_EVENTS", "500000")
            )
        self._max_events = max(max_events, 2)
        self._dropped = 0

    def _ts(self, ns: int) -> float:
        return (ns - self._origin) / 1e3  # µs

    def span(self, name: str, **args: Any) -> _Span:
        """``with tracer.span("engine.run", n_nodes=3): ...``"""
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
        lock acquisition, so the overflow drop can never orphan the sample
        from its span (the executor's per-tick row counters use this)."""
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
        self._append(ev, {
            "name": cname, "ph": "C", "ts": ev["ts"] + ev["dur"],
            "pid": self._pid, "args": values,
        })

    def _append(self, *evs: dict[str, Any]) -> None:
        with self._lock:
            self._events.extend(evs)
            if len(self._events) > self._max_events:
                n = len(self._events)
                drop = n // 2
                # never let the kept window BEGIN with a counter sample
                # whose owning span was just dropped
                while drop < n and self._events[drop].get("ph") == "C":
                    drop += 1
                if drop >= n:
                    drop = n // 2
                self._dropped += drop
                del self._events[:drop]

    def _flow(self, ph: str, name: str, flow_id: str, args: dict) -> None:
        ev = {
            "name": name, "cat": "comm", "ph": ph, "id": str(flow_id),
            "ts": self._ts(time.perf_counter_ns()), "pid": self._pid,
            "tid": threading.get_ident() % 2**31,
        }
        if ph == "f":
            ev["bp"] = "e"  # bind the arrow to the enclosing slice
        if args:
            ev["args"] = args
        self._append(ev)

    def flow_start(self, name: str, flow_id: str, **args: Any) -> None:
        """Begin a Chrome flow (``ph: s``) — the sending half of a
        cross-worker arrow; the receiving side closes it with
        :meth:`flow_end` under the SAME id."""
        self._flow("s", name, flow_id, args)

    def flow_end(self, name: str, flow_id: str, **args: Any) -> None:
        """Close a flow (``ph: f``) at the receiving worker."""
        self._flow("f", name, flow_id, args)

    def flush(self) -> str | None:
        """Write the event buffer to the trace file. Never raises — tracing
        must not fail (or mask the error of) the run it observes."""
        with self._lock:
            events = list(self._events)
        meta = [{"name": "process_name", "ph": "M", "pid": self._pid,
                 "args": {"name": "pathway_tpu_torch"}}]
        if self._dropped:
            meta.append({"name": "trace.dropped_events", "ph": "i", "s": "g",
                         "ts": 0.0, "pid": self._pid, "tid": 0,
                         "args": {"count": self._dropped}})
        try:
            tmp = f"{self.path}.tmp"
            with open(tmp, "w") as f:
                json.dump({"traceEvents": meta + events, "displayTimeUnit": "ms"}, f)
            os.replace(tmp, self.path)
        except (OSError, TypeError, ValueError) as e:
            import warnings

            warnings.warn(
                f"could not write trace file {self.path!r}: {e}", RuntimeWarning
            )
            return None
        return self.path


_active: Tracer | None = None
_env_checked = False


def activate(path: str) -> Tracer:
    """Programmatic activation (the env var is the usual route); kept until
    ``deactivate()``."""
    global _active, _env_checked
    _active = Tracer(path)
    _env_checked = True
    return _active


def deactivate() -> None:
    global _active, _env_checked
    _active = None
    _env_checked = True


def get_tracer() -> Tracer | None:
    """The active tracer: one from ``PATHWAY_TRACE_FILE`` (read once), or
    ``activate()``'s; None when tracing is off."""
    global _active, _env_checked
    if not _env_checked:
        path = os.environ.get("PATHWAY_TRACE_FILE")
        _active = Tracer(path) if path else None
        _env_checked = True
    return _active

