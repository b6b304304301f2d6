"""In-process windowed time-series store — the cluster's signal plane.

The `/metrics` + `/snapshot` surfaces built in the observability arc are
*point-in-time*: every derived signal (a rate, a trend, a sustained
breach, a latency percentile *over the last N seconds*) had to be
computed by an external scraper. This module keeps those derivations in
the cluster, in the Monarch/Prometheus in-process-aggregation lineage
(PAPERS.md): a background sampler snapshots every ``EngineStats``
gauge/counter/histogram plus the comm backend counters at a fixed
cadence (``PATHWAY_SIGNALS_SAMPLE_S``) into per-series ring buffers
bounded by the window (``PATHWAY_SIGNALS_WINDOW_S``), and the
:class:`Signals` API answers windowed queries over them:

- ``rate(name, window)`` / ``delta(name, window)`` for counters;
- ``avg/min/max/last`` for gauges;
- ``percentile(name, q, window)`` for log2-histogram series — the
  cumulative bucket counts at the window edges are differenced, which
  yields the *exact* distribution of observations inside the window
  (buckets share boundaries across samples, so the diff is lossless);
- ``sustained_above/below(name, threshold, for_s)`` — the predicate
  shape SLO rules (``observability/slo.py``) and the future traffic
  autoscaler consume.

Series are keyed ``(metric, worker)`` — ``worker=None`` holds
process-level series (comm backend counters). The store is the exact
input the autoscaler arc will read; over HTTP it backs the hub's
``/query`` endpoint (``engine/http_server.py``), which process 0 merges
across peers the same way it merges ``/snapshot``.

Copy of ``pathway_tpu/observability/timeseries.py``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable

from .histogram import N_BUCKETS, quantile_from_snapshot

__all__ = [
    "DEFAULT_SAMPLE_S",
    "DEFAULT_WINDOW_S",
    "Signals",
    "SignalsPlane",
    "TimeSeriesStore",
]

DEFAULT_SAMPLE_S = 0.5
DEFAULT_WINDOW_S = 60.0

#: metric-name prefixes of per-operator series (attribution input)
OP_TIME_PREFIX = "op_time_ns:"
OP_ROWS_PREFIX = "op_rows:"


class TimeSeriesStore:
    """Ring-buffered ``(metric, worker) -> [(t, value), ...]`` store.

    ``value`` is a float for counter/gauge series or a list of cumulative
    log2-bucket counts for histogram series. Appends come from the
    sampler thread; reads from HTTP handler threads and SLO evaluation —
    one lock, copies out."""

    def __init__(self, capacity: int):
        self.capacity = max(4, int(capacity))
        self._series: dict[tuple[str, int | None], deque] = {}
        self._appended: dict[tuple[str, int | None], int] = {}
        self._lock = threading.Lock()

    def record(
        self, metric: str, value: Any, worker: int | None = None,
        t: float | None = None,
    ) -> None:
        if t is None:
            t = time.time()
        key = (metric, worker)
        with self._lock:
            ring = self._series.get(key)
            if ring is None:
                ring = self._series[key] = deque(maxlen=self.capacity)
            ring.append((t, value))
            self._appended[key] = self._appended.get(key, 0) + 1

    def covers_birth(
        self, metric: str, worker: int | None, window_s: float,
    ) -> bool:
        """True when the window reaches back to the series' very first
        sample (nothing evicted, nothing older outside the window) — a
        cumulative-histogram diff may then use a zero baseline, so
        observations from before the first sample still count."""
        with self._lock:
            key = (metric, worker)
            ring = self._series.get(key)
            if not ring:
                return False
            if self._appended.get(key, 0) > len(ring):
                return False  # ring evicted older samples
            first_t = ring[0][0]
            last_t = ring[-1][0]
        return last_t - first_t <= window_s

    def points(
        self, metric: str, worker: int | None = None,
        window_s: float | None = None,
    ) -> list[tuple[float, Any]]:
        with self._lock:
            ring = self._series.get((metric, worker))
            pts = list(ring) if ring else []
        if window_s is None or not pts:
            return pts
        cutoff = pts[-1][0] - window_s
        # keep the last point at-or-before the cutoff too: a counter
        # delta over the window needs the value at the window's LEFT
        # edge, and a sustained-for check needs coverage of the FULL
        # horizon — with a jittered sample cadence no point lands
        # exactly on the cutoff, so the straddling sample is the edge
        i = len(pts) - 1
        while i > 0 and pts[i - 1][0] >= cutoff:
            i -= 1
        if i > 0 and pts[i][0] > cutoff:
            i -= 1
        return pts[i:]

    def workers(self) -> list[int]:
        with self._lock:
            return sorted({
                w for (_m, w) in self._series if w is not None
            })

    def metrics(self, worker: int | None = None) -> list[str]:
        with self._lock:
            return sorted({
                m for (m, w) in self._series if w == worker
            })


def _hist_window_snapshot(
    pts: list[tuple[float, Any]], zero_baseline: bool = False,
) -> dict:
    """Difference the cumulative bucket counts at the window edges into
    one histogram snapshot of the observations inside the window.
    ``zero_baseline`` means the window reaches the series' birth, so the
    left edge is an all-zero histogram (observations recorded before the
    first sample still count)."""
    if not pts:
        return {"counts": [0] * N_BUCKETS, "sum": 0, "count": 0}
    first = [0] * N_BUCKETS if zero_baseline else list(pts[0][1])
    last = list(pts[-1][1])
    counts = [
        max(0, int(b) - int(a))
        for a, b in zip(
            first + [0] * (len(last) - len(first)), last
        )
    ]
    if len(counts) < N_BUCKETS:
        counts = counts + [0] * (N_BUCKETS - len(counts))
    return {
        "counts": counts[:N_BUCKETS],
        "sum": 0,
        "count": sum(counts[:N_BUCKETS]),
    }


def _scalar(metric: str, v: Any) -> float:
    """A series value as a float — histogram series (list-of-bucket
    values) only support the percentile ops, and asking rate()/avg() of
    one must be a clean ValueError, not a TypeError out of a handler."""
    if isinstance(v, (list, tuple)):
        raise ValueError(
            f"{metric!r} is a histogram series — use p50/p95/p99, not a "
            "scalar op"
        )
    return float(v)


class Signals:
    """Windowed queries over a :class:`TimeSeriesStore` — the
    programmatic input for SLO rules, ``/query``, and the autoscaler.

    ``sample_s`` is the sampler cadence feeding the store, when known
    (the :class:`SignalsPlane` passes its own). It arms the sampler-gap
    guard on the sustained predicates: a hole in the samples is a hole
    in the evidence, not sustained coverage."""

    #: expression ops accepted by :meth:`eval` (``op(metric)`` strings)
    OPS = ("rate", "delta", "avg", "min", "max", "last",
           "p50", "p95", "p99")

    def __init__(
        self, store: TimeSeriesStore, sample_s: float | None = None
    ):
        self.store = store
        self.sample_s = sample_s

    # -- scalar queries -----------------------------------------------

    def last(self, metric: str, worker: int | None = None) -> float | None:
        pts = self.store.points(metric, worker)
        return _scalar(metric, pts[-1][1]) if pts else None

    def delta(
        self, metric: str, window_s: float, worker: int | None = None,
    ) -> float | None:
        """Counter increase over the window (clamped at 0 — a process
        restart resets counters; a negative delta is a reset, not
        regress)."""
        pts = self.store.points(metric, worker, window_s)
        if len(pts) < 2:
            return None
        return max(
            0.0, _scalar(metric, pts[-1][1]) - _scalar(metric, pts[0][1])
        )

    def rate(
        self, metric: str, window_s: float, worker: int | None = None,
    ) -> float | None:
        """Counter increase per second over the window."""
        pts = self.store.points(metric, worker, window_s)
        if len(pts) < 2:
            return None
        dt = pts[-1][0] - pts[0][0]
        if dt <= 0:
            return None
        return (
            max(0.0, _scalar(metric, pts[-1][1]) - _scalar(metric, pts[0][1]))
            / dt
        )

    def agg(
        self, metric: str, window_s: float, fn: Callable,
        worker: int | None = None,
    ) -> float | None:
        pts = self.store.points(metric, worker, window_s)
        if not pts:
            return None
        return float(fn(_scalar(metric, v) for _t, v in pts))

    def percentile(
        self, metric: str, q: float, window_s: float,
        worker: int | None = None,
    ) -> float | None:
        """q-quantile (ns by convention) of a histogram series over the
        window, or None when the window holds no observations."""
        pts = self.store.points(metric, worker, window_s)
        snap = _hist_window_snapshot(
            pts, self.store.covers_birth(metric, worker, window_s)
        )
        if snap["count"] <= 0:
            return None
        return quantile_from_snapshot(snap, q)

    # -- sustained predicates -----------------------------------------

    def _sustained(
        self, metric: str, threshold: float, for_s: float,
        worker: int | None, above: bool,
    ) -> bool:
        """True when every sample in the last ``for_s`` seconds breaches
        the threshold AND the samples actually cover ``for_s`` (a store
        younger than the horizon cannot claim a sustained breach; a
        sampler gap inside the horizon is missing evidence, not
        coverage)."""
        pts = self.store.points(metric, worker, for_s)
        if len(pts) < 2:
            return False
        if pts[-1][0] - pts[0][0] < for_s * 0.95:
            return False
        if self.sample_s:
            # two breaching samples with a dead sampler in between do not
            # prove the signal breached throughout — the metric may have
            # recovered and re-breached inside the hole. Tolerate a few
            # missed samples (scheduler jitter), refuse a real gap.
            gap_limit = self.sample_s * 4
            if any(
                t1 - t0 > gap_limit
                for (t0, _a), (t1, _b) in zip(pts, pts[1:])
            ):
                return False
        if above:
            return all(_scalar(metric, v) > threshold for _t, v in pts)
        return all(_scalar(metric, v) < threshold for _t, v in pts)

    def sustained_above(
        self, metric: str, threshold: float, for_s: float,
        worker: int | None = None,
    ) -> bool:
        return self._sustained(metric, threshold, for_s, worker, True)

    def sustained_below(
        self, metric: str, threshold: float, for_s: float,
        worker: int | None = None,
    ) -> bool:
        return self._sustained(metric, threshold, for_s, worker, False)

    # -- expression surface -------------------------------------------

    def eval(
        self, expr: str, window_s: float, worker: int | None = None,
    ) -> float | None:
        """Evaluate one ``op(metric)`` expression (or a bare metric name,
        = ``last``) for one worker. Histogram percentiles come back in
        MILLISECONDS (the unit every ``*_ms`` gauge already uses);
        everything else is in the series' native unit."""
        expr = expr.strip()
        op, metric = "last", expr
        if expr.endswith(")") and "(" in expr:
            op, _, rest = expr.partition("(")
            op = op.strip()
            metric = rest[:-1].strip()
        if op not in self.OPS:
            raise ValueError(
                f"unknown signal op {op!r} (expected one of {self.OPS})"
            )
        if op in ("p50", "p95", "p99"):
            q = {"p50": 0.50, "p95": 0.95, "p99": 0.99}[op]
            ns = self.percentile(metric, q, window_s, worker)
            return None if ns is None else ns / 1e6
        if op == "rate":
            return self.rate(metric, window_s, worker)
        if op == "delta":
            return self.delta(metric, window_s, worker)
        if op == "avg":
            return self.agg(
                metric, window_s, lambda it: _mean(list(it)), worker
            )
        if op == "min":
            return self.agg(metric, window_s, min, worker)
        if op == "max":
            return self.agg(metric, window_s, max, worker)
        return self.last(metric, worker)

    def eval_worst(
        self, expr: str, window_s: float, higher_is_worse: bool = True,
        max_age_s: float | None = None, now: float | None = None,
    ) -> tuple[float | None, int | None]:
        """Evaluate across every worker (falling back to the
        process-level series when no worker has the metric) and return
        (worst value, worker) — what a threshold rule compares.

        ``max_age_s`` is the staleness guard: a worker whose NEWEST
        sample for the metric is older than that is excluded entirely —
        its series froze (the worker died, or its peer scrape is being
        served from a cache), and a frozen value must not win a
        worst-worker comparison and drive a decision."""
        metric = expr
        if expr.endswith(")") and "(" in expr:
            metric = expr.partition("(")[2][:-1].strip()
        candidates: list[int | None] = [
            w for w in self.store.workers()
            if self.store.points(metric, w)
        ]
        if not candidates:
            candidates = [None]
        if max_age_s is not None:
            cutoff = (time.time() if now is None else now) - max_age_s
            candidates = [
                w for w in candidates
                if (pts := self.store.points(metric, w))
                and pts[-1][0] >= cutoff
            ]
        worst: float | None = None
        worst_w: int | None = None
        for w in candidates:
            v = self.eval(expr, window_s, w)
            if v is None:
                continue
            if (
                worst is None
                or (higher_is_worse and v > worst)
                or (not higher_is_worse and v < worst)
            ):
                worst, worst_w = v, w
        return worst, worst_w


def _mean(values: list[float]) -> float:
    return sum(values) / len(values)


class SignalsPlane:
    """Sampler thread + store + (optional) SLO engine for one process.

    Owned by the :class:`~pathway_tpu_torch.observability.hub.ObservabilityHub`
    — the hub registers workers/comms, the plane samples them. Sampling
    never raises into the run it observes."""

    def __init__(
        self,
        hub: Any,
        sample_s: float = DEFAULT_SAMPLE_S,
        window_s: float = DEFAULT_WINDOW_S,
        slo_engine: Any = None,
    ):
        self.hub = hub
        self.sample_s = max(0.05, float(sample_s))
        self.window_s = max(self.sample_s * 4, float(window_s))
        # capacity covers the window plus slack for the left-edge sample
        self.store = TimeSeriesStore(
            int(self.window_s / self.sample_s) + 8
        )
        self.signals = Signals(self.store, sample_s=self.sample_s)
        self.slo = slo_engine
        self.samples_taken = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- sampling ------------------------------------------------------

    def sample_once(self, t: float | None = None) -> None:
        try:
            self._sample_inner(t)
            self.samples_taken += 1
        except Exception:
            # the signal plane must not fail the run it observes
            pass
        if self.slo is not None:
            try:
                self.slo.evaluate(self.signals, t)
            except Exception:
                pass

    def _sample_inner(self, t: float | None) -> None:
        if t is None:
            t = time.time()
        with self.hub._lock:
            workers = sorted(self.hub._workers.items())
        now_ms = t * 1000.0
        for wid, stats in workers:
            rec = lambda m, v: self.store.record(m, v, wid, t)
            rec("engine_ticks", float(stats.ticks))
            rec("rows_total", float(stats.rows_total))
            rec("input_rows", float(stats.input_rows))
            rec("output_rows", float(stats.output_rows))
            rec("last_time", float(stats.last_time))
            if stats.latency_ms is not None:
                rec("latency_ms", float(stats.latency_ms))
            # frontier lag vs wall clock: streaming ticks are minted at
            # even wall-clock ms, so a worker keeping up shows a small
            # lag and a stalled/backpressured one grows linearly. Only
            # wall-scale logical times are comparable (scheduled test
            # streams use small ints).
            if stats.last_time > 1_000_000_000_000:
                rec(
                    "frontier_lag_ms",
                    max(0.0, now_ms - float(stats.last_time)),
                )
            self.store.record(
                "tick_duration", stats.tick_duration.snapshot()["counts"],
                wid, t,
            )
            e2e = getattr(stats, "e2e_latency_hist", None)
            if e2e is not None and len(e2e):
                self.store.record(
                    "e2e_latency", e2e.snapshot()["counts"], wid, t
                )
            # commit-wave critical path (async plane): wave counters +
            # per-phase cumulative seconds so SLO rules can watch e.g.
            # rate(wave.stage_settle_s) — the lineage behind an e2e p99
            waves_total = getattr(stats, "waves_total", 0)
            if waves_total:
                rec("wave.total", float(waves_total))
                for phase, ns in list(
                    (getattr(stats, "wave_stage_ns", None) or {}).items()
                ):
                    rec(f"wave.stage_{phase}_s", float(ns) / 1e9)
                last = None
                rec_ring = getattr(stats, "_waves", None)
                if rec_ring is not None and rec_ring.recent:
                    last = rec_ring.recent[-1]
                if last is not None:
                    rec("wave.last_duration_ms", float(last["duration_ms"]))
                    if last.get("holder") is not None:
                        rec("wave.last_holder", float(last["holder"]))
            # key-group load sketch: top share + skew vs uniform — the
            # skew rebalancer's runtime input
            acct = getattr(stats, "keyload", None)
            if acct is not None and acct.rows_total:
                rec("keyload.rows_total", float(acct.rows_total))
                items = acct.sketch.items()
                if items:
                    top_share = items[0][1] / (acct.sketch.total or 1.0)
                    rec("keyload.top_share", top_share)
                    rec("keyload.top_group", float(items[0][0]))
                    rec("keyload.skew", top_share * acct.n_groups)
            # per-operator cumulative processing time + rows — the
            # attribution inputs (populated when stats.detailed is on,
            # which the hub enables alongside the metrics endpoint)
            for op, ns in list(stats.time_by_node.items()):
                rec(OP_TIME_PREFIX + op, float(ns))
            for op, n in list(stats.rows_by_node.items()):
                rec(OP_ROWS_PREFIX + op, float(n))
        for key, value in self.hub.comm_snapshot().items():
            self.store.record(f"comm.{key}", float(value), None, t)
        # memory/spill/key-registry gauges (engine/spill.py): process-
        # scoped like the comm series — SLO rules and the autoscale
        # decider can watch rss_bytes or state_spilled_bytes directly
        for key, value in self.hub.memory_stats_snapshot().items():
            self.store.record(f"mem.{key}", float(value), None, t)
        # output-plane delivery counters (io/delivery.py): per-sink series
        # — SLO rules can watch sink.out.dlq_total or queue_depth directly
        for sink, gauges in self.hub.sink_stats_snapshot().items():
            for key, value in gauges.items():
                self.store.record(
                    f"sink.{sink}.{key}", float(value), None, t
                )
        # UDF execution-path counters (expression_compiler): lifted /
        # traced plans + rows that ran per-row Python — an SLO rule can
        # watch udf.perrow_rows_total to catch a pipeline falling off
        # the columnar fast path after a deploy
        for key, value in self.hub.udf_stats_snapshot().items():
            self.store.record(f"udf.{key}", float(value), None, t)
        # kernel-fusion counters (engine/fusion.py): chains compiled,
        # member operators fused, per-batch fallbacks — an SLO rule can
        # watch fusion.fallbacks_total to catch a stream that fell off
        # the fused path after a schema/dtype change
        for key, value in self.hub.fusion_stats_snapshot().items():
            self.store.record(f"fusion.{key}", float(value), None, t)
        # serve-plane counters + admission gauges (serve/stats.py): the
        # autoscale decider watches serve.queue_depth / serve.inflight
        # against their bounds, and an SLO rule can watch
        # serve.rejected_total or serve.degraded_total directly
        for key, value in self.hub.serve_stats_snapshot().items():
            self.store.record(f"serve.{key}", float(value), None, t)
        # staged ingest cost split (io/python.INGEST_STAGE_STATS): an SLO
        # rule can watch ingest.hash_s grow faster than ingest.parse_s —
        # the columnar ingest's regression tripwire
        for key, value in self.hub.ingest_stats_snapshot().items():
            if key == "connectors":
                # per-connector stage split rides as nested dicts:
                # ingest.conn.<name>.<stage> series name the bottleneck
                # connector instead of one anonymous ingest total
                for cname, gauges in value.items():
                    for ckey, cval in gauges.items():
                        self.store.record(
                            f"ingest.conn.{cname}.{ckey}", float(cval), None, t
                        )
                continue
            self.store.record(f"ingest.{key}", float(value), None, t)
        # continuous-profiling scalars (observability/profiler.py):
        # samples_total proves the sampler is alive; op_tagged_share
        # dropping means profiles stopped joining against /attribution
        for key, value in self.hub.profile_stats_snapshot().items():
            self.store.record(f"profile.{key}", float(value), None, t)

    # -- lifecycle -----------------------------------------------------

    def start(self) -> "SignalsPlane":
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="pathway-signals-sampler"
        )
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.sample_s):
            self.sample_once()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
