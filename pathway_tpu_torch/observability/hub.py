"""ObservabilityHub — per-process registry + cluster-wide metrics roll-up.

Re-design of the reference's ProberStats aggregation (``src/engine/
graph.rs:521-563`` feeding per-process metrics ports,
``src/engine/http_server.rs:21-60``): each process registers the
``EngineStats`` of every worker it hosts plus its comm backend, and
serves them at ``/metrics``. Under multi-process sharding
(``parallel/cluster.py``), process 0 additionally scrapes every peer
process's ``/snapshot`` endpoint (JSON, same host book as the TCP mesh,
HTTP port ``base + process_id``) and serves the merged cluster view with
per-worker labels — operators point one Prometheus target at process 0
and see the whole fleet, including exchange-queue depth and frontier-lag
backpressure gauges.

The scrape direction (0 pulls peers) rather than push-over-collectives
keeps telemetry off the data plane: a peer stuck in a collective still
gets scraped, which is exactly when its frontier-lag gauge matters.

Copy of ``pathway_tpu/observability/hub.py``. The port has no fault plan
(``chaos/``) and no ``upgrade/``: ``_supervisor_snapshot`` takes the
reference's no-plan branch (no armed plan) and its ``{"total": 0}`` branch
for upgrades. ``from_config`` builds the reference's peer book, and the
cluster roll-up over it is the reference's.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any

from .health import health_status, ready_status

__all__ = ["ObservabilityHub", "stats_snapshot"]

_SCRAPE_TIMEOUT_S = 2.0


def _drop_empty(stats: dict[str, dict]) -> dict[str, dict] | None:
    """Per-process stat maps with no live entries render as NO metric
    families (byte-identical exposition when a concern is disabled)."""
    out = {k: v for k, v in stats.items() if v}
    return out or None


def stats_snapshot(stats: Any, worker_id: int = 0) -> dict:
    """JSON-serializable snapshot of one worker's EngineStats — the unit
    shipped across processes and merged by process 0. Ages are computed
    at snapshot time so remote clocks never mix."""
    now = time.time()
    snap = {
        "worker": worker_id,
        "ticks": stats.ticks,
        "rows_total": stats.rows_total,
        "input_rows": stats.input_rows,
        "output_rows": stats.output_rows,
        "latency_ms": stats.latency_ms,
        "last_time": stats.last_time,
        "uptime_s": now - stats.started_at,
        "finished": stats.finished,
        "heartbeat_age_s": now - stats.last_heartbeat,
        "sources_connected": stats.sources_connected,
        "rows_by_node": dict(stats.rows_by_node),
        "exchange_rows_out": stats.exchange_rows_out,
        "exchange_rows_in": stats.exchange_rows_in,
        "exchange_batches": stats.exchange_batches,
        "tick_duration": stats.tick_duration.snapshot(),
        "latency_hist": stats.latency_hist.snapshot(),
        "e2e_latency_hist": stats.e2e_latency_hist.snapshot()
        if getattr(stats, "e2e_latency_hist", None) is not None
        else None,
        "e2e_ms": getattr(stats, "e2e_ms", None),
        "node_time_hist": {
            label: h.snapshot()
            for label, h in list(stats.node_time_hist.items())
        },
        # staged ingest→emit decomposition (executor.E2E_STAGES)
        "stage_hists": {
            name: h.snapshot()
            for name, h in (getattr(stats, "stage_hists", None) or {}).items()
        },
        # commit-wave critical path (observability/critpath.py)
        "waves_total": getattr(stats, "waves_total", 0),
        "wave_duration": stats.wave_duration.snapshot()
        if getattr(stats, "wave_duration", None) is not None
        else None,
        "wave_stage_ns": dict(getattr(stats, "wave_stage_ns", None) or {}),
        "wave_held_total": dict(
            getattr(stats, "wave_held_total", None) or {}
        ),
        "waves": stats._waves.snapshot()
        if getattr(stats, "_waves", None) is not None
        else None,
        # key-group load sketch (observability/keyload.py)
        "keyload": stats.keyload.snapshot()
        if getattr(stats, "keyload", None) is not None
        else None,
    }
    if stats.latency_updated_at is not None:
        snap["latency_age_s"] = max(0.0, now - stats.latency_updated_at)
    return snap


class ObservabilityHub:
    def __init__(
        self,
        process_id: int = 0,
        n_processes: int = 1,
        peer_http: list[tuple[str, int]] | None = None,
        wedge_timeout_s: float = 30.0,
    ):
        self.process_id = process_id
        self.n_processes = n_processes
        #: (host, port) of every OTHER process's metrics server — scraped
        #: by process 0 for the merged view
        self.peer_http = peer_http or []
        self.wedge_timeout_s = wedge_timeout_s
        self._workers: dict[int, Any] = {}
        self._comms: list[Any] = []
        self._lock = threading.Lock()
        self.scrape_errors = 0
        #: windowed signal plane (observability/timeseries.py) — started
        #: by start_signals() alongside the metrics endpoint; None until
        #: then (tests building bare hubs pay nothing)
        self.signals_plane: Any = None
        #: last successful peer scrape per peer index: (unix time, doc).
        #: A peer that stops answering is reported as STALE (last-seen
        #: age per worker) instead of silently vanishing from the merged
        #: view — the difference between "fleet shrank" and "fleet lost
        #: a member" on one scrape.
        self._peer_cache: dict[int, tuple[float, dict]] = {}
        #: same discipline for the windowed /query roll-up: a peer whose
        #: /query scrape fails is served from this cache WITH its workers
        #: named in the merged document's ``stale_workers`` — consumers
        #: that act on the numbers (the autoscaler's decider) refuse
        #: stale-marked documents rather than deciding from frozen values
        self._query_cache: dict[int, tuple[float, dict]] = {}
        #: and for the /profile roll-up: a dead peer's flamegraph serves
        #: from its last good scrape with ``stale`` ages on the merged doc
        self._profile_cache: dict[int, tuple[float, dict]] = {}
        #: per-process sampling profiler (observability/profiler.py) —
        #: started with the signals plane, stopped in close(); None when
        #: PATHWAY_PROFILE=0 or before start_signals()
        self.profiler: Any = None

    @classmethod
    def from_config(cls, cfg: Any) -> "ObservabilityHub":
        peers: list[tuple[str, int]] = []
        base = cfg.monitoring_http_port
        # base 0 = ephemeral ports — peers' actual ports are unknowable,
        # so the roll-up degrades to local-only rather than scraping
        # garbage targets
        if cfg.processes > 1 and cfg.process_id == 0 and base:
            hosts = (
                [a.split(":")[0] if not a.startswith("[") else
                 a[1:].partition("]")[0] for a in cfg.addresses]
                if cfg.addresses
                else ["127.0.0.1"] * cfg.processes
            )
            peers = [
                (hosts[p], base + p)
                for p in range(cfg.processes)
                if p != cfg.process_id
            ]
            if (
                any(h not in ("127.0.0.1", "localhost") for h, _ in peers)
                and cfg.monitoring_http_host == "127.0.0.1"
            ):
                import warnings

                warnings.warn(
                    "cluster metrics roll-up: peers are on other hosts but "
                    "their monitoring servers bind loopback by default — "
                    "set PATHWAY_MONITORING_HTTP_HOST=0.0.0.0 on every "
                    "process or process 0's merged /metrics will miss them",
                    RuntimeWarning,
                )
        return cls(
            process_id=cfg.process_id,
            n_processes=cfg.processes,
            peer_http=peers,
            wedge_timeout_s=cfg.health_wedge_timeout_s,
        )

    # -- registration --------------------------------------------------

    def register_worker(self, worker_id: int, stats: Any) -> None:
        with self._lock:
            self._workers[worker_id] = stats

    def register_comm(self, comm: Any) -> None:
        with self._lock:
            self._comms.append(comm)

    # -- signals plane (windowed time-series + SLO rules) --------------

    def start_signals(
        self,
        sample_s: float | None = None,
        window_s: float | None = None,
        slo_rules: str | None = None,
    ) -> Any:
        """Start the sampler thread + SLO engine over this hub's workers
        (``PATHWAY_SIGNALS_SAMPLE_S`` / ``PATHWAY_SIGNALS_WINDOW_S`` /
        ``PATHWAY_SLO_RULES`` fill unset arguments). Idempotent."""
        if self.signals_plane is not None:
            return self.signals_plane
        import os

        from .slo import SloEngine, load_rules
        from .timeseries import (
            DEFAULT_SAMPLE_S,
            DEFAULT_WINDOW_S,
            SignalsPlane,
        )

        if sample_s is None:
            try:
                sample_s = float(
                    os.environ.get("PATHWAY_SIGNALS_SAMPLE_S", "")
                    or DEFAULT_SAMPLE_S
                )
            except ValueError:
                sample_s = DEFAULT_SAMPLE_S
        if window_s is None:
            try:
                window_s = float(
                    os.environ.get("PATHWAY_SIGNALS_WINDOW_S", "")
                    or DEFAULT_WINDOW_S
                )
            except ValueError:
                window_s = DEFAULT_WINDOW_S
        if slo_rules is None:
            slo_rules = os.environ.get("PATHWAY_SLO_RULES")
        try:
            rules = load_rules(slo_rules)
        except ValueError as e:
            import warnings

            # a typo'd rules file must be loud — but telemetry still must
            # not abort the run it observes
            warnings.warn(str(e), RuntimeWarning)
            rules = []
        engine = SloEngine(
            rules, default_window_s=window_s, process_id=self.process_id
        )
        self.signals_plane = SignalsPlane(
            self, sample_s=sample_s, window_s=window_s, slo_engine=engine
        ).start()
        self.start_profiler()
        return self.signals_plane

    def start_profiler(self) -> Any:
        """Start the per-process sampling profiler (idempotent; no-op
        with ``PATHWAY_PROFILE=0`` — zero threads, zero series)."""
        if self.profiler is not None:
            return self.profiler
        from . import profiler as _profiler

        if not _profiler.enabled():
            return None
        try:
            self.profiler = _profiler.Profiler(
                process_id=self.process_id
            ).start()
        except Exception:
            # telemetry must not fail the run it observes
            self.profiler = None
        return self.profiler

    def close(self) -> None:
        if self.signals_plane is not None:
            self.signals_plane.stop()
        if self.profiler is not None:
            self.profiler.stop()
            self.profiler = None

    @property
    def worker_stats(self) -> list[Any]:
        with self._lock:
            return [self._workers[w] for w in sorted(self._workers)]

    # -- snapshots -----------------------------------------------------

    def local_snapshots(self) -> list[dict]:
        with self._lock:
            items = sorted(self._workers.items())
        return [stats_snapshot(s, w) for w, s in items]

    def comm_snapshot(self) -> dict[str, float]:
        out: dict[str, float] = {}
        with self._lock:
            comms = list(self._comms)
        for comm in comms:
            fn = getattr(comm, "comm_stats", None)
            if fn is None:
                continue
            try:
                for k, v in fn().items():
                    out[k] = out.get(k, 0) + v
            except Exception:
                # telemetry must not fail the run it observes
                pass
        return out

    @staticmethod
    def _local_trace_dropped() -> int | None:
        """This process's tracer ring-buffer drop count (None = tracing
        off) — shipped in /snapshot so the cluster roll-up can report a
        PEER's truncated timeline, not just its own."""
        from ..internals.tracing import get_tracer

        tracer = get_tracer()
        return tracer._dropped if tracer is not None else None

    @staticmethod
    def memory_stats_snapshot() -> dict[str, float]:
        """This process's memory/spill/key-registry gauges (RSS, state
        budget occupancy, spill counters, registry tiers) — shipped in
        /snapshot like the comm gauges so the roll-up renders them per
        process."""
        try:
            from ..engine.spill import memory_snapshot

            return memory_snapshot()
        except Exception:
            # telemetry must not fail the run it observes
            return {}

    @staticmethod
    def sink_stats_snapshot() -> dict[str, dict[str, float]]:
        """This process's output-plane sink counters (delivered / retries
        / DLQ / breaker / queue depth / delivery lag per sink —
        io/delivery.py) — shipped in /snapshot like the memory gauges."""
        try:
            from ..io.delivery import sink_stats_snapshot

            return sink_stats_snapshot()
        except Exception:
            # telemetry must not fail the run it observes
            return {}

    @staticmethod
    def udf_stats_snapshot() -> dict[str, float]:
        """This process's UDF execution-path counters (lifted / traced /
        per-row rows — internals/expression_compiler.py) — which lane
        user ``pw.apply`` callables landed on, so a slow pipeline reads
        as "N rows ran per-row Python" instead of a guess."""
        try:
            from ..internals.expression_compiler import udf_stats_snapshot

            return udf_stats_snapshot()
        except Exception:
            # telemetry must not fail the run it observes
            return {}

    @staticmethod
    def fusion_stats_snapshot() -> dict[str, float]:
        """This process's kernel-fusion counters (chains compiled, member
        operators fused, per-batch fallbacks — engine/fusion.py), so a
        pipeline that silently fell back to per-node dispatch reads as
        "N batches fell back" instead of a mystery slowdown."""
        try:
            from ..engine.fusion import fusion_stats_snapshot

            return fusion_stats_snapshot()
        except Exception:
            # telemetry must not fail the run it observes
            return {}

    @staticmethod
    def serve_stats_snapshot() -> dict[str, float]:
        """This process's serve-plane counters + live gauges (admitted /
        rejected / degraded queries, scatter posts, in-flight, queue
        depth — serve/stats.py), so an overloaded or shard-degraded
        serving cluster reads as numbers, not client anecdotes. Empty
        until the serve plane ran, keeping non-serving expositions
        byte-identical."""
        try:
            from ..serve.stats import serve_stats_snapshot

            return serve_stats_snapshot()
        except Exception:
            # telemetry must not fail the run it observes
            return {}

    @staticmethod
    def ingest_stats_snapshot() -> dict[str, Any]:
        """This process's staged ingest cost split (parse | hash | delta
        seconds + rows/flushes — io/python.INGEST_STAGE_STATS), the
        measured share of hashing and delta building in ingest wall
        time. Empty until a connector flushed (or with
        ``PATHWAY_PROFILE=0``), so expositions stay byte-identical."""
        try:
            from ..io.python import INGEST_STAGE_STATS as s
            from .profiler import enabled as _prof_enabled

            # re-check the kill switch at read time: the module-global
            # counters survive a same-process PATHWAY_PROFILE flip
            if not _prof_enabled():
                return {}
            if not s["flushes"] and not s["rows"]:
                return {}
            out: dict[str, Any] = {
                "parse_s": round(s["parse_ns"] / 1e9, 6),
                "hash_s": round(s["hash_ns"] / 1e9, 6),
                "delta_s": round(s["delta_ns"] / 1e9, 6),
                "rows_total": float(s["rows"]),
                "flushes_total": float(s["flushes"]),
            }
            # per-connector stage split (io/python.INGEST_CONNECTOR_STATS)
            # so the bottleneck connector is nameable cluster-wide, not
            # just "ingest is slow somewhere"
            from ..io.python import INGEST_CONNECTOR_STATS as per_conn

            conns = {
                name: {
                    "parse_s": round(c["parse_ns"] / 1e9, 6),
                    "hash_s": round(c["hash_ns"] / 1e9, 6),
                    "delta_s": round(c["delta_ns"] / 1e9, 6),
                    "rows_total": float(c["rows"]),
                    "flushes_total": float(c["flushes"]),
                }
                for name, c in sorted(per_conn.items())
                if c["rows"] or c["flushes"]
            }
            if conns:
                out["connectors"] = conns
            return out
        except Exception:
            # telemetry must not fail the run it observes
            return {}

    def profile_stats_snapshot(self) -> dict[str, float]:
        """This process's profiler scalars (samples, distinct frames,
        top-frame/op-tagged shares — the ``pathway_profile_*`` families
        and ``profile.*`` series). Empty when the profiler is off."""
        try:
            if self.profiler is None:
                return {}
            return self.profiler.metrics_snapshot()
        except Exception:
            # telemetry must not fail the run it observes
            return {}

    def snapshot_document(self) -> dict:
        """The /snapshot payload peers serve to process 0."""
        return {
            "process_id": self.process_id,
            "workers": self.local_snapshots(),
            "comm": self.comm_snapshot(),
            "memory": self.memory_stats_snapshot(),
            "sinks": self.sink_stats_snapshot(),
            "udf": self.udf_stats_snapshot(),
            "fusion": self.fusion_stats_snapshot(),
            "serve": self.serve_stats_snapshot(),
            "ingest": self.ingest_stats_snapshot(),
            "profile": self.profile_stats_snapshot(),
            "trace_dropped": self._local_trace_dropped(),
        }

    def cluster_snapshots(
        self,
    ) -> tuple[
        list[dict],
        dict[str, dict],
        dict[str, int],
        dict[str, float],
        dict[str, dict],
        dict[str, dict],
        dict[str, dict],
        dict[str, dict],
        dict[str, dict],
        dict[str, dict],
        dict[str, dict],
    ]:
        """Local snapshots plus every reachable peer's; comm stats keyed
        by process id; tracer drops per reporting process (a transiently
        unreachable peer is MISSING from the dict, so its metrics series
        disappears for a scrape instead of decreasing a summed counter).
        Peers are scraped concurrently so N hung peers cost
        one timeout, not N (a partial outage is exactly when the merged
        view must still answer inside Prometheus's scrape deadline);
        unreachable peers count in ``scrape_errors`` and the view stays
        partial rather than failing. The fourth element maps worker id →
        last-seen age (s) for workers whose peer stopped answering but
        answered before — rendered as ``pathway_worker_last_seen_seconds``
        so a dead peer reads as STALE, not as a smaller fleet."""
        snapshots = self.local_snapshots()
        comm_stats = {str(self.process_id): self.comm_snapshot()}
        memory_stats = {str(self.process_id): self.memory_stats_snapshot()}
        sink_stats = {str(self.process_id): self.sink_stats_snapshot()}
        udf_stats = {str(self.process_id): self.udf_stats_snapshot()}
        fusion_stats = {str(self.process_id): self.fusion_stats_snapshot()}
        serve_stats = {str(self.process_id): self.serve_stats_snapshot()}
        ingest_stats = {str(self.process_id): self.ingest_stats_snapshot()}
        profile_stats = {str(self.process_id): self.profile_stats_snapshot()}
        trace_dropped: dict[str, int] = {}
        stale: dict[str, float] = {}
        local_dropped = self._local_trace_dropped()
        if local_dropped is not None:
            trace_dropped[str(self.process_id)] = local_dropped
        results: list[dict | None] = [None] * len(self.peer_http)

        def fetch(i: int, host: str, port: int) -> None:
            results[i] = self._scrape_peer(host, port)

        threads = [
            threading.Thread(target=fetch, args=(i, h, p), daemon=True)
            for i, (h, p) in enumerate(self.peer_http)
        ]
        for t in threads:
            t.start()
        deadline = time.monotonic() + _SCRAPE_TIMEOUT_S + 0.5
        for t in threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        now = time.time()
        for i, doc in enumerate(results):
            if doc is None:
                self.scrape_errors += 1
                cached = self._peer_cache.get(i)
                if cached is not None:
                    seen_at, seen_doc = cached
                    for w in seen_doc.get("workers", []):
                        stale[str(w.get("worker", "?"))] = now - seen_at
                continue
            self._peer_cache[i] = (now, doc)
            snapshots.extend(doc.get("workers", []))
            comm_stats[str(doc.get("process_id", "?"))] = doc.get("comm", {})
            peer_mem = doc.get("memory")
            if peer_mem:
                memory_stats[str(doc.get("process_id", "?"))] = peer_mem
            peer_sinks = doc.get("sinks")
            if peer_sinks:
                sink_stats[str(doc.get("process_id", "?"))] = peer_sinks
            peer_udf = doc.get("udf")
            if peer_udf:
                udf_stats[str(doc.get("process_id", "?"))] = peer_udf
            peer_fusion = doc.get("fusion")
            if peer_fusion:
                fusion_stats[str(doc.get("process_id", "?"))] = peer_fusion
            peer_serve = doc.get("serve")
            if peer_serve:
                serve_stats[str(doc.get("process_id", "?"))] = peer_serve
            peer_ingest = doc.get("ingest")
            if peer_ingest:
                ingest_stats[str(doc.get("process_id", "?"))] = peer_ingest
            peer_profile = doc.get("profile")
            if peer_profile:
                profile_stats[str(doc.get("process_id", "?"))] = peer_profile
            peer_dropped = doc.get("trace_dropped")
            if peer_dropped is not None:
                trace_dropped[str(doc.get("process_id", "?"))] = int(
                    peer_dropped
                )
        snapshots.sort(key=lambda s: s.get("worker", 0))
        return (
            snapshots, comm_stats, trace_dropped, stale, memory_stats,
            sink_stats, udf_stats, fusion_stats, ingest_stats, profile_stats,
            serve_stats,
        )

    @staticmethod
    def _scrape_peer(host: str, port: int) -> dict | None:
        import urllib.request

        try:
            with urllib.request.urlopen(
                f"http://{host}:{port}/snapshot", timeout=_SCRAPE_TIMEOUT_S
            ) as r:
                return json.loads(r.read().decode())
        except Exception:
            return None

    @staticmethod
    def _scrape_peer_path(host: str, port: int, path: str) -> dict | None:
        import urllib.request

        try:
            with urllib.request.urlopen(
                f"http://{host}:{port}{path}", timeout=_SCRAPE_TIMEOUT_S
            ) as r:
                return json.loads(r.read().decode())
        except Exception:
            return None

    def _scrape_peers_raw(self, path: str) -> list[dict | None]:
        """Concurrently fetch ``path`` from every peer (same discipline
        as cluster_snapshots: N hung peers cost one timeout). The result
        is indexed like ``peer_http`` — None marks a failed scrape."""
        results: list[dict | None] = [None] * len(self.peer_http)

        def fetch(i: int, host: str, port: int) -> None:
            results[i] = self._scrape_peer_path(host, port, path)

        threads = [
            threading.Thread(target=fetch, args=(i, h, p), daemon=True)
            for i, (h, p) in enumerate(self.peer_http)
        ]
        for t in threads:
            t.start()
        deadline = time.monotonic() + _SCRAPE_TIMEOUT_S + 0.5
        for t in threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        return results

    def _scrape_peers_path(self, path: str) -> list[dict]:
        return [d for d in self._scrape_peers_raw(path) if d is not None]

    # -- windowed signal queries (/query, /attribution, /alerts) -------

    def local_query_document(self) -> dict:
        """This process's windowed-signals view: per-worker rates +
        latency percentiles over the window, comm derivations, operator
        attribution, and the alert log — the ``/query`` payload a peer
        serves, and the exact document the autoscaler will consume."""
        plane = self.signals_plane
        doc: dict = {
            "process_id": self.process_id,
            "t": time.time(),
            "signals": plane is not None,
        }
        if plane is None:
            return doc
        sig, w = plane.signals, plane.window_s
        doc["sample_s"] = plane.sample_s
        doc["window_s"] = w
        doc["samples"] = plane.samples_taken
        workers: dict[str, dict] = {}
        for wid in sig.store.workers():
            entry: dict = {
                "tick_rate": sig.rate("engine_ticks", w, wid),
                "row_rate": sig.rate("rows_total", w, wid),
                "input_rate": sig.rate("input_rows", w, wid),
                "output_rate": sig.rate("output_rows", w, wid),
                "last_time": sig.last("last_time", wid),
                "latency_ms": sig.last("latency_ms", wid),
                "frontier_lag_ms": sig.last("frontier_lag_ms", wid),
            }
            for q in ("p50", "p95", "p99"):
                entry[f"tick_{q}_ms"] = sig.eval(
                    f"{q}(tick_duration)", w, wid
                )
                entry[f"e2e_{q}_ms"] = sig.eval(f"{q}(e2e_latency)", w, wid)
            # the headline windowed series, raw points included so `top`
            # and the autoscaler see trends, not just scalars
            entry["series"] = {
                "frontier_lag_ms": sig.store.points(
                    "frontier_lag_ms", wid, w
                ),
            }
            workers[str(wid)] = entry
        doc["workers"] = workers
        comm: dict[str, float | None] = {}
        for metric in sig.store.metrics(None):
            if not metric.startswith("comm."):
                continue
            key = metric[len("comm."):]
            comm[key] = sig.last(metric, None)
            if key.endswith(("_total", "_sent", "_received")):
                comm[key + "_rate"] = sig.rate(metric, w, None)
        sent_rate = sig.rate("comm.cluster_bytes_sent", w, None)
        if sent_rate is not None:
            comm["send_mb_per_sec"] = round(sent_rate / 1e6, 3)
        if "send_queue_depth" in comm:
            comm["send_queue_depth_series"] = sig.store.points(
                "comm.send_queue_depth", None, w
            )
        doc["comm"] = comm
        doc["memory"] = self.memory_stats_snapshot()
        doc["sinks"] = self.sink_stats_snapshot()
        doc["udf"] = self.udf_stats_snapshot()
        doc["fusion"] = self.fusion_stats_snapshot()
        doc["serve"] = self.serve_stats_snapshot()
        doc["ingest"] = self.ingest_stats_snapshot()
        doc["profile"] = self.profile_stats_snapshot()
        doc["waves"] = self._waves_document()
        doc["keyload"] = self._keyload_document()
        from .attribution import attribution_document

        doc["attribution"] = attribution_document(sig, w)
        doc["alerts"] = (
            plane.slo.alerts.document()
            if plane.slo is not None
            else {"active": [], "history": [], "fired_total": {}}
        )
        sup = self._supervisor_snapshot()
        if sup is not None:
            doc["supervisor"] = sup
        auto = self._autoscale_snapshot()
        if auto is not None:
            doc["autoscale"] = auto
        return doc

    def _waves_document(self) -> dict | None:
        """Process-level commit-wave merge: every local worker's
        WaveRecorder ring folded into one ``waves`` document (the
        per-epoch merge elects the holder by majority — see
        observability/critpath.py)."""
        from .critpath import merge_worker_waves

        with self._lock:
            items = sorted(self._workers.items())
        snaps = {
            str(w): s._waves.snapshot()
            for w, s in items
            if getattr(s, "_waves", None) is not None
        }
        if not snaps:
            return None
        return merge_worker_waves(snaps)

    def _keyload_document(self) -> dict | None:
        """Process-level key-group load merge over local workers'
        sketches (observability/keyload.py)."""
        from .keyload import merge_snapshots

        with self._lock:
            items = sorted(self._workers.items())
        return merge_snapshots(
            [
                s.keyload.snapshot()
                for _, s in items
                if getattr(s, "keyload", None) is not None
            ]
        )

    def query_document(self) -> dict:
        """The merged ``/query`` view: process 0 scrapes every peer's
        ``/query`` and merges — same pull direction as the /snapshot
        roll-up, so a peer stuck in a collective still gets queried.
        Adds cross-worker frontier lag (worker's logical time vs the most
        advanced worker's) which no single process can compute alone."""
        local = self.local_query_document()
        if not self.peer_http:
            merged = dict(local)
            merged["processes"] = [self.process_id]
            merged["stale_workers"] = {}
            self._add_cluster_lag(merged)
            return merged
        results = self._scrape_peers_raw("/query")
        now = time.time()
        stale_workers: dict[str, float | None] = {}
        peer_ids = [
            p for p in range(self.n_processes) if p != self.process_id
        ]
        peer_docs: list[dict] = []
        for i, doc in enumerate(results):
            if doc is None:
                self.scrape_errors += 1
                cached = self._query_cache.get(i)
                if cached is None:
                    # never scraped successfully: we cannot serve its
                    # workers, but the peer must still be VISIBLE as
                    # missing — an empty stale_workers here would let the
                    # decider act on a partial view of the cluster
                    pid = peer_ids[i] if i < len(peer_ids) else i
                    stale_workers[f"process-{pid}"] = None
                    continue
                # serve the last good scrape, but MARK every worker it
                # carries: a consumer acting on the merged numbers (the
                # autoscale decider) must see "this value is frozen",
                # not a plausible-looking live reading
                seen_at, cached_doc = cached
                age = now - seen_at
                doc = dict(cached_doc)
                doc["workers"] = {
                    wid: {**w, "stale_s": round(age, 3)}
                    for wid, w in (cached_doc.get("workers") or {}).items()
                }
                for wid in doc["workers"]:
                    stale_workers[str(wid)] = round(age, 3)
            else:
                self._query_cache[i] = (now, doc)
            peer_docs.append(doc)
        merged = dict(local)
        merged["stale_workers"] = stale_workers
        merged["workers"] = dict(local.get("workers", {}))
        merged["comm"] = {str(self.process_id): local.get("comm", {})}
        merged["memory"] = {str(self.process_id): local.get("memory", {})}
        merged["sinks"] = {str(self.process_id): local.get("sinks", {})}
        merged["udf"] = {str(self.process_id): local.get("udf", {})}
        merged["fusion"] = {str(self.process_id): local.get("fusion", {})}
        merged["serve"] = {str(self.process_id): local.get("serve", {})}
        merged["ingest"] = {str(self.process_id): local.get("ingest", {})}
        merged["profile"] = {str(self.process_id): local.get("profile", {})}
        merged["alerts"] = {
            "active": list(local.get("alerts", {}).get("active", [])),
            "history": list(local.get("alerts", {}).get("history", [])),
            "fired_total": dict(
                local.get("alerts", {}).get("fired_total", {})
            ),
        }
        processes = [self.process_id]
        attributions = [local.get("attribution")]
        for doc in peer_docs:
            pid = doc.get("process_id", "?")
            processes.append(pid)
            merged["workers"].update(doc.get("workers", {}))
            merged["comm"][str(pid)] = doc.get("comm", {})
            merged["memory"][str(pid)] = doc.get("memory", {})
            merged["sinks"][str(pid)] = doc.get("sinks", {})
            merged["udf"][str(pid)] = doc.get("udf", {})
            merged["fusion"][str(pid)] = doc.get("fusion", {})
            merged["serve"][str(pid)] = doc.get("serve", {})
            merged["ingest"][str(pid)] = doc.get("ingest", {})
            merged["profile"][str(pid)] = doc.get("profile", {})
            alerts = doc.get("alerts", {})
            merged["alerts"]["active"].extend(alerts.get("active", []))
            merged["alerts"]["history"].extend(alerts.get("history", []))
            for sev, n in alerts.get("fired_total", {}).items():
                merged["alerts"]["fired_total"][sev] = (
                    merged["alerts"]["fired_total"].get(sev, 0) + int(n)
                )
            attributions.append(doc.get("attribution"))
        merged["alerts"]["active"].sort(key=lambda e: e.get("t", 0))
        merged["alerts"]["history"].sort(key=lambda e: e.get("t", 0))
        from .attribution import merge_attribution_documents

        merged["processes"] = processes
        merged["attribution"] = merge_attribution_documents(attributions)
        # cluster-wide wave + key-load roll-ups: peer documents carry
        # the same shapes, so the merges re-merge; a stale (cached) peer
        # doc still contributes its last-good wave phases — a dead peer's
        # view is marked stale above, never silently dropped
        from .critpath import merge_process_waves
        from .keyload import merge_snapshots as _merge_keyload

        merged["waves"] = merge_process_waves(
            [local.get("waves")] + [d.get("waves") for d in peer_docs]
        )
        merged["keyload"] = _merge_keyload(
            [local.get("keyload")] + [d.get("keyload") for d in peer_docs]
        )
        self._add_cluster_lag(merged)
        return merged

    @staticmethod
    def _add_cluster_lag(doc: dict) -> None:
        """Per-worker frontier lag vs the most advanced worker in the
        (merged) view — the backpressure gauge, windowed."""
        workers = doc.get("workers", {})
        times = [
            w.get("last_time")
            for w in workers.values()
            if w.get("last_time")
        ]
        if not times:
            return
        frontier = max(times)
        for w in workers.values():
            lt = w.get("last_time")
            w["frontier_lag_vs_max_ms"] = (
                max(0.0, frontier - lt) if lt else None
            )

    def query_eval(self, params: dict) -> dict:
        """Targeted query: ``/query?expr=rate(engine_ticks)&window=10``
        or ``?metric=tick_duration&op=p95[&worker=0]``. Returns the
        scalar plus the raw windowed points behind it."""
        plane = self.signals_plane
        if plane is None:
            raise ValueError("signals plane is not running")
        sig = plane.signals
        expr = params.get("expr")
        if not expr:
            metric = params.get("metric")
            if not metric:
                raise ValueError("pass expr=op(metric) or metric=...&op=...")
            expr = f"{params.get('op', 'last')}({metric})"
        try:
            window = float(params.get("window", plane.window_s))
        except ValueError:
            raise ValueError(f"bad window {params.get('window')!r}")
        worker_s = params.get("worker")
        metric_name = expr
        if expr.endswith(")") and "(" in expr:
            metric_name = expr.partition("(")[2][:-1].strip()
        if worker_s is None:
            value, worker = sig.eval_worst(expr, window)
        else:
            worker = int(worker_s)
            value = sig.eval(expr, window, worker)
        points = sig.store.points(metric_name, worker, window)
        if not points and worker is not None:
            points = sig.store.points(metric_name, None, window)
        return {
            "expr": expr,
            "window_s": window,
            "worker": worker,
            "value": value,
            "points": points,
        }

    def attribution_view(self) -> dict:
        """The ``/attribution`` payload (cluster-merged on process 0)."""
        doc = self.query_document()
        att = doc.get("attribution") or {"ranked": [], "bottleneck": None}
        att["processes"] = doc.get("processes", [self.process_id])
        return att

    def alerts_view(self) -> dict:
        """The ``/alerts`` payload (cluster-merged on process 0)."""
        plane = self.signals_plane
        local = (
            plane.slo.alerts.document()
            if plane is not None and plane.slo is not None
            else {"active": [], "history": [], "fired_total": {}}
        )
        if not self.peer_http:
            return local
        for doc in self._scrape_peers_path("/alerts"):
            local["active"] = local["active"] + doc.get("active", [])
            local["history"] = local["history"] + doc.get("history", [])
            for sev, n in doc.get("fired_total", {}).items():
                local["fired_total"][sev] = (
                    local["fired_total"].get(sev, 0) + int(n)
                )
        local["active"].sort(key=lambda e: e.get("t", 0))
        local["history"].sort(key=lambda e: e.get("t", 0))
        return local

    # -- continuous profiling (/profile) -------------------------------

    def profile_document(self) -> dict:
        """This process's full profile (collapsed-stack sketches + scalar
        counters) — what a peer serves at ``/profile?local=1``."""
        if self.profiler is None:
            from .profile_merge import merge_snapshots

            doc = merge_snapshots([])
            doc["process_id"] = self.process_id
            return doc
        return self.profiler.snapshot()

    def profile_view(self) -> dict:
        """The cluster-merged ``/profile`` payload: process 0 scrapes
        every peer's local profile and merges the sketches (same pull
        direction as /snapshot). A peer that stops answering serves from
        its last good scrape, marked in the merged document's ``stale``
        map (process id -> age s) — ``stale: {pid: null}`` names a peer
        that never answered at all."""
        from .profile_merge import merge_snapshots

        local = self.profile_document()
        if not self.peer_http:
            merged = merge_snapshots([local])
            merged["stale"] = {}
            return merged
        results = self._scrape_peers_raw("/profile?local=1")
        now = time.time()
        stale: dict[str, float | None] = {}
        peer_ids = [
            p for p in range(self.n_processes) if p != self.process_id
        ]
        docs: list[dict] = [local]
        for i, doc in enumerate(results):
            pid = peer_ids[i] if i < len(peer_ids) else i
            if doc is None:
                self.scrape_errors += 1
                cached = self._profile_cache.get(i)
                if cached is None:
                    stale[str(pid)] = None
                    continue
                seen_at, doc = cached
                stale[str(pid)] = round(now - seen_at, 3)
            else:
                self._profile_cache[i] = (now, doc)
            docs.append(doc)
        merged = merge_snapshots(docs)
        merged["stale"] = stale
        return merged

    # -- rendering + probes --------------------------------------------

    def render_metrics(self) -> str:
        from .prometheus import render_snapshots

        trace_dropped: int | dict[str, int] | None
        stale: dict[str, float] | None = None
        if self.peer_http:
            (
                snapshots, comm_stats, dropped_by_proc, stale,
                memory_stats, sink_stats, udf_stats, fusion_stats,
                ingest_stats, profile_stats, serve_stats,
            ) = self.cluster_snapshots()
            # per-process labels, like the comm gauges: series identity
            # stays stable when a peer scrape transiently fails
            trace_dropped = dropped_by_proc or None
        else:
            snapshots = self.local_snapshots()
            comm = self.comm_snapshot()
            comm_stats = {str(self.process_id): comm} if comm else {}
            mem = self.memory_stats_snapshot()
            memory_stats = {str(self.process_id): mem} if mem else {}
            sinks = self.sink_stats_snapshot()
            sink_stats = {str(self.process_id): sinks} if sinks else {}
            udf = self.udf_stats_snapshot()
            udf_stats = {str(self.process_id): udf} if udf else {}
            fusion = self.fusion_stats_snapshot()
            fusion_stats = {str(self.process_id): fusion} if fusion else {}
            ingest = self.ingest_stats_snapshot()
            ingest_stats = {str(self.process_id): ingest} if ingest else {}
            profile = self.profile_stats_snapshot()
            profile_stats = (
                {str(self.process_id): profile} if profile else {}
            )
            serve = self.serve_stats_snapshot()
            serve_stats = {str(self.process_id): serve} if serve else {}
            trace_dropped = self._local_trace_dropped()
        # label by TOPOLOGY, not by how many snapshots this scrape got:
        # in cluster mode a transient peer outage must not flip series
        # between labeled and unlabeled (that forks Prometheus series and
        # breaks rate() continuity)
        cluster = (
            self.n_processes > 1
            or bool(self.peer_http)
            or len(self._workers) > 1
        )
        # tracer drop visibility: a truncated trace window — local OR on a
        # scraped peer — must be distinguishable from a quiet one (0
        # renders too, as the explicit "nothing dropped" signal); None
        # only when no process traces
        bottleneck = None
        alerts_fired = None
        alerts_active = None
        plane = self.signals_plane
        if plane is not None:
            from .attribution import bottleneck_operator

            try:
                bottleneck = bottleneck_operator(
                    plane.signals, plane.window_s
                )
            except Exception:
                bottleneck = None
            if plane.slo is not None and plane.slo.rules:
                alert_doc = plane.slo.alerts.document()
                alerts_fired = alert_doc["fired_total"] or None
                alerts_active = len(alert_doc["active"])
        return render_snapshots(
            snapshots,
            comm_stats,
            scrape_errors=self.scrape_errors,
            worker_labels=True if cluster else None,
            supervisor=self._supervisor_snapshot(),
            trace_dropped=trace_dropped,
            stale_workers=stale or None,
            bottleneck=bottleneck,
            alerts_fired=alerts_fired,
            alerts_active=alerts_active,
            autoscale=self._autoscale_snapshot(),
            memory_stats=memory_stats or None,
            sink_stats=sink_stats or None,
            udf_stats=udf_stats or None,
            fusion_stats=fusion_stats or None,
            ingest_stats=_drop_empty(ingest_stats),
            profile_stats=_drop_empty(profile_stats),
            serve_stats=_drop_empty(serve_stats),
        )

    @staticmethod
    def _supervisor_snapshot() -> dict | None:
        """Self-healing metrics: restart generation + reason, stamped into
        the child environment by ``spawn --supervise``. None when nothing
        applies (keeps the single-process exposition identical to the
        seed's). The port has no fault plan and no upgrade migrator, so the
        reference's armed-plan and upgrade counters never appear."""
        import os

        restarts = os.environ.get("PATHWAY_RESTART_COUNT")
        supervised = os.environ.get("PATHWAY_SUPERVISED")
        flight_dumps = os.environ.get("PATHWAY_FLIGHT_DUMPS")
        try:  # elastic boots reshard in-process before the engine mounts
            from ..rescale import stats as _rescale_stats

            rescales = _rescale_stats()
        except Exception:  # pragma: no cover — import cycle safety net
            rescales = {"total": 0}
        if not supervised and restarts is None and flight_dumps is None:
            if not rescales["total"]:
                return None
            # a rescale happened but nothing is supervised — surface ONLY
            # those counters (no pathway_restarts_total outside supervision)
            return {
                "rescales": int(rescales["total"]),
                "rescale_duration_s": float(rescales["duration_s"]),
            }
        doc: dict = {
            "restarts": int(restarts or 0),
            "reason": os.environ.get("PATHWAY_LAST_RESTART_REASON"),
        }
        window_failures = os.environ.get("PATHWAY_SUPERVISE_WINDOW_FAILURES")
        if window_failures is not None:
            # circuit-breaker window position at this generation's launch:
            # a restart storm is visible BEFORE the breaker trips. The
            # budget comes from the same knob the supervisor reads, so
            # /metrics shows failures/budget and open = exhausted.
            from ..internals.config import _env_int

            try:
                failures = int(window_failures)
            except ValueError:
                failures = 0
            budget = _env_int("PATHWAY_SUPERVISE_MAX_RESTARTS", 5)
            doc["window_failures"] = failures
            doc["window_budget"] = budget
            # the supervisor trips at failures > budget and then exits
            # WITHOUT launching, so no child can ever see a stamp above
            # the budget — failures == budget is the last-chance
            # generation (the next failure is terminal) and must read as
            # open, or the gauge could never fire from a real run
            doc["circuit_open"] = failures >= budget
        if flight_dumps is not None:
            try:
                doc["flight_dumps"] = int(flight_dumps)
            except ValueError:
                pass
        if rescales["total"]:
            doc["rescales"] = int(rescales["total"])
            doc["rescale_duration_s"] = float(rescales["duration_s"])
        return doc

    @staticmethod
    def _autoscale_snapshot() -> dict | None:
        """Closed-loop autoscaler surface: the controller stamps its
        range, event count, and last scale decision/pause into every
        child's environment (autoscale/controller.py), so /metrics and
        /query on any worker show the loop working. None outside
        ``spawn --autoscale`` (exposition unchanged elsewhere)."""
        import os

        rng = os.environ.get("PATHWAY_AUTOSCALE")
        if not rng:
            return None
        doc: dict = {"range": rng}
        try:
            doc["events"] = int(os.environ.get("PATHWAY_AUTOSCALE_EVENTS", "0"))
        except ValueError:
            doc["events"] = 0
        pause = os.environ.get("PATHWAY_AUTOSCALE_LAST_PAUSE_MS")
        if pause is not None:
            try:
                doc["last_pause_ms"] = float(pause)
            except ValueError:
                pass
        decision = os.environ.get("PATHWAY_AUTOSCALE_LAST_DECISION")
        if decision:
            doc["last_decision"] = decision
        return doc

    def health(self) -> tuple[bool, dict]:
        return health_status(self.worker_stats, self.wedge_timeout_s)

    def ready(self) -> tuple[bool, dict]:
        return ready_status(self.worker_stats)
