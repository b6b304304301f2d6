"""Prometheus/OpenMetrics exposition rendering for engine stats snapshots.

One renderer serves every surface: the per-process ``/metrics`` endpoint
(``engine/http_server.py``), the cluster-merged view on process 0, and
the smoke-test validator (``scripts/obs_smoke.py``). Everything renders
from plain snapshot dicts (``observability.hub.stats_snapshot``), never
live objects, so remote workers' metrics — shipped as JSON over the
cluster scrape — go through the identical code path as local ones.

Label values are escaped per the OpenMetrics text format ABNF
(``\\`` → ``\\\\``, ``"`` → ``\\"``, newline → ``\\n``); the seed emitted
raw operator labels, which produced invalid exposition text for any
operator name containing a quote or backslash.

Copy of ``pathway_tpu/observability/prometheus.py``.
"""

from __future__ import annotations

from .histogram import N_BUCKETS

__all__ = [
    "escape_label_value",
    "format_labels",
    "render_histogram",
    "render_snapshots",
    "parse_exposition",
]


def escape_label_value(v: str) -> str:
    """OpenMetrics label-value escaping (backslash first, then quote/NL)."""
    return (
        str(v)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def format_labels(labels: dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{escape_label_value(v)}"' for k, v in labels.items()
    )
    return "{" + inner + "}"


def _fmt(v: float) -> str:
    if isinstance(v, float):
        # integral floats (byte/frame counters cast through comm_stats)
        # render exactly — %.6g would quantize past ~1e6 and make
        # Prometheus increase() read 0-then-jump; non-integral values get
        # 9 significant digits (sub-ms resolution on week-long uptimes)
        if v.is_integer() and abs(v) < 1e15:
            return str(int(v))
        return f"{v:.9g}"
    return str(v)


class _Renderer:
    """Accumulates families so each gets exactly one # TYPE line."""

    def __init__(self) -> None:
        self.lines: list[str] = []
        self._typed: set[str] = set()

    def add(self, name: str, mtype: str, value, labels: dict | None = None):
        if name not in self._typed:
            self._typed.add(name)
            self.lines.append(f"# TYPE {name} {mtype}")
        self.lines.append(f"{name}{format_labels(labels or {})} {_fmt(value)}")

    def text(self) -> str:
        return "\n".join(self.lines) + "\n"


def render_histogram(
    r: _Renderer, name: str, snap: dict, labels: dict[str, str]
) -> None:
    """Render one log-bucketed snapshot as a Prometheus histogram family
    (``_bucket``/``_sum``/``_count``), bounds in seconds.

    Only the occupied bucket range renders (cumulative counts stay
    monotone regardless), keeping series cardinality ~10 per histogram
    instead of 64."""
    counts = snap["counts"]
    nonzero = [i for i, c in enumerate(counts) if c]
    if name not in r._typed:
        r._typed.add(name)
        r.lines.append(f"# TYPE {name} histogram")
    cum = 0
    if nonzero:
        lo, hi = nonzero[0], min(nonzero[-1] + 1, N_BUCKETS - 1)
        cum = sum(counts[:lo])
        for i in range(lo, hi + 1):
            cum += counts[i]
            le = (1 << i) / 1e9  # bucket i upper bound: 2^i ns, in seconds
            ls = format_labels({**labels, "le": f"{le:.9g}"})
            r.lines.append(f"{name}_bucket{ls} {cum}")
    ls_inf = format_labels({**labels, "le": "+Inf"})
    r.lines.append(f"{name}_bucket{ls_inf} {snap['count']}")
    r.lines.append(
        f"{name}_sum{format_labels(labels)} {snap['sum'] / 1e9:.9g}"
    )
    r.lines.append(f"{name}_count{format_labels(labels)} {snap['count']}")


def render_snapshots(
    snapshots: list[dict],
    comm_stats: dict[str, dict[str, float]] | None = None,
    scrape_errors: int = 0,
    worker_labels: bool | None = None,
    supervisor: dict | None = None,
    trace_dropped: int | dict[str, int] | None = None,
    stale_workers: dict[str, float] | None = None,
    bottleneck: str | None = None,
    alerts_fired: dict[str, int] | None = None,
    alerts_active: int | None = None,
    autoscale: dict | None = None,
    memory_stats: dict[str, dict[str, float]] | None = None,
    sink_stats: dict[str, dict[str, dict[str, float]]] | None = None,
    udf_stats: dict[str, dict[str, float]] | None = None,
    fusion_stats: dict[str, dict[str, float]] | None = None,
    ingest_stats: dict[str, dict[str, float]] | None = None,
    profile_stats: dict[str, dict[str, float]] | None = None,
    serve_stats: dict[str, dict[str, float]] | None = None,
) -> str:
    """Exposition text for a set of worker stats snapshots.

    ``worker_labels=None`` (auto) omits the ``worker`` label for a single
    snapshot (the seed's single-process format, relied on by existing
    scrapers) and labels every series ``worker="N"`` for several — the
    cluster-merged view. Cluster callers pass an explicit ``True`` so
    series identity is stable even when a peer scrape transiently fails.
    ``comm_stats`` maps a process label to that process's comm-backend
    gauges (exchange queue depth etc.).
    """
    r = _Renderer()
    labeled = (
        worker_labels if worker_labels is not None else len(snapshots) > 1
    )
    max_last_time = max((s.get("last_time", 0) for s in snapshots), default=0)
    for s in snapshots:
        lab = {"worker": str(s.get("worker", 0))} if labeled else {}
        r.add("pathway_engine_ticks", "counter", s["ticks"], lab)
        r.add("pathway_engine_rows_total", "counter", s["rows_total"], lab)
        r.add("pathway_input_rows", "counter", s["input_rows"], lab)
        r.add("pathway_output_rows", "counter", s["output_rows"], lab)
        r.add("pathway_uptime_seconds", "gauge", s["uptime_s"], lab)
        if s.get("latency_ms") is not None:
            r.add("pathway_output_latency_ms", "gauge", s["latency_ms"], lab)
            # staleness companion: the latency gauge freezes at the last
            # commit's value; its age tells "fast" from "stalled"
            r.add(
                "pathway_output_latency_age_seconds",
                "gauge",
                s.get("latency_age_s", 0.0),
                lab,
            )
        if labeled:
            # frontier lag vs the most advanced worker: a worker whose
            # logical time trails its peers is the backpressured one
            r.add(
                "pathway_frontier_lag_ms",
                "gauge",
                max(0, max_last_time - s.get("last_time", 0)),
                lab,
            )
        r.add(
            "pathway_exchange_rows_total", "counter",
            s.get("exchange_rows_out", 0), {**lab, "direction": "out"},
        )
        r.add(
            "pathway_exchange_rows_total", "counter",
            s.get("exchange_rows_in", 0), {**lab, "direction": "in"},
        )
        r.add(
            "pathway_exchange_batches_total", "counter",
            s.get("exchange_batches", 0), lab,
        )
        for op, count in sorted(s.get("rows_by_node", {}).items()):
            r.add(
                "pathway_operator_rows_total", "counter", count,
                {**lab, "operator": op},
            )
        if s.get("tick_duration"):
            render_histogram(r, "pathway_tick_duration_seconds",
                             s["tick_duration"], lab)
        if s.get("latency_hist") and s["latency_hist"]["count"]:
            render_histogram(r, "pathway_output_latency_seconds",
                             s["latency_hist"], lab)
        if s.get("e2e_latency_hist") and s["e2e_latency_hist"]["count"]:
            # connector-ingest → output-emit latency (end-to-end through
            # the dataflow, stamped by the connectors)
            render_histogram(r, "pathway_ingest_to_emit_seconds",
                             s["e2e_latency_hist"], lab)
        for op, hsnap in sorted(s.get("node_time_hist", {}).items()):
            render_histogram(
                r, "pathway_operator_processing_seconds", hsnap,
                {**lab, "operator": op},
            )
        for stage, hsnap in sorted(s.get("stage_hists", {}).items()):
            # staged decomposition of ingest→emit (executor.E2E_STAGES):
            # every e2e observation lands once per stage, so the staged
            # sums add up to pathway_ingest_to_emit_seconds_sum and a p99
            # move decomposes into the stage that caused it
            if hsnap and hsnap.get("count"):
                render_histogram(
                    r, "pathway_ingest_to_emit_stage_seconds", hsnap,
                    {**lab, "stage": stage},
                )
        # commit-wave critical path (async plane, observability/critpath)
        if s.get("waves_total"):
            r.add("pathway_waves_total", "counter", s["waves_total"], lab)
            if s.get("wave_duration") and s["wave_duration"]["count"]:
                render_histogram(
                    r, "pathway_wave_duration_seconds",
                    s["wave_duration"], lab,
                )
            for stage, ns in sorted(s.get("wave_stage_ns", {}).items()):
                r.add(
                    "pathway_wave_stage_seconds_total", "counter",
                    int(ns) / 1e9, {**lab, "stage": stage},
                )
            for holder, n in sorted(s.get("wave_held_total", {}).items()):
                # which worker's frontier arrived last (held the wave)
                r.add(
                    "pathway_wave_held_total", "counter", int(n),
                    {**lab, "holder": str(holder)},
                )
        kl = s.get("keyload")
        if kl and kl.get("rows_total"):
            # key-group heavy hitters (observability/keyload.py): top
            # tracked groups' share of routed rows — bounded label
            # cardinality (top 8 of a capacity-bounded sketch)
            r.add(
                "pathway_keyload_rows_total", "counter",
                kl["rows_total"], lab,
            )
            for entry in (kl.get("top") or [])[:8]:
                r.add(
                    "pathway_key_group_share", "gauge",
                    round(float(entry.get("share", 0.0)), 4),
                    {**lab, "group": str(entry.get("group"))},
                )
    for proc, gauges in sorted((comm_stats or {}).items()):
        plab = {"process": str(proc)}
        for key, value in sorted(gauges.items()):
            # OpenMetrics convention: a `_total` suffix names a counter
            # (pathway_comm_bytes_total / frames_coalesced_total /
            # encode_seconds_total from the pipelined data plane);
            # everything else in comm_stats is a point-in-time gauge
            # (queue depths, broken flag)
            kind = "counter" if key.endswith("_total") else "gauge"
            r.add(f"pathway_comm_{key}", kind, value, plab)
    for proc, gauges in sorted((memory_stats or {}).items()):
        # memory-at-scale surface (engine/spill.py memory_snapshot):
        # process RSS, state-budget occupancy, spill counters and the
        # two-tier key registry — per process, like the comm gauges
        plab = {"process": str(proc)}
        for key, value in sorted(gauges.items()):
            if key.startswith("key_registry"):
                name = f"pathway_{key}"
            elif key == "rss_bytes":
                name = "pathway_process_rss_bytes"
            elif key.endswith("_total"):
                name = f"pathway_state_{key}"  # spill/load event counters
            else:
                name = f"pathway_{key}"  # state_*_bytes gauges
            kind = "counter" if name.endswith("_total") else "gauge"
            r.add(name, kind, value, plab)
    for proc, sinks in sorted((sink_stats or {}).items()):
        # output plane (io/delivery.py): per-sink delivery counters. The
        # process label keeps a muted worker's zeroed copy of a sink from
        # colliding with the delivering worker's live series
        for sink, gauges in sorted(sinks.items()):
            slab = {"process": str(proc), "sink": str(sink)}
            for key, value in sorted(gauges.items()):
                kind = "counter" if key.endswith("_total") else "gauge"
                r.add(f"pathway_sink_{key}", kind, value, slab)
    for proc, gauges in sorted((udf_stats or {}).items()):
        # UDF execution-path counters (internals/expression_compiler.py):
        # lifted / traced plans built and rows that ran per-row Python —
        # the rowwise-tax visibility surface. Process-scoped like the
        # memory gauges.
        plab = {"process": str(proc)}
        for key, value in sorted(gauges.items()):
            kind = "counter" if key.endswith("_total") else "gauge"
            r.add(f"pathway_udf_{key}", kind, value, plab)
    for proc, gauges in sorted((fusion_stats or {}).items()):
        # kernel-fusion counters (engine/fusion.py): chains compiled,
        # member operators they absorbed, batches that fell back to the
        # per-node path, whole-chain XLA compiles, key-reuse hits —
        # the pathway_fusion_{chains,fused_ops,fallbacks}_total surface
        plab = {"process": str(proc)}
        for key, value in sorted(gauges.items()):
            kind = "counter" if key.endswith("_total") else "gauge"
            r.add(f"pathway_fusion_{key}", kind, value, plab)
    for proc, gauges in sorted((ingest_stats or {}).items()):
        # staged ingest cost split (io/python.INGEST_STAGE_STATS): the
        # parse | hash | delta seconds per connector flush, as one
        # stage-labeled family so dashboards stack the split directly
        for key, value in sorted(gauges.items()):
            if key == "connectors":
                # nested per-connector split: one connector-labeled
                # family so the bottleneck connector is nameable from
                # the dashboard, not just "ingest is slow somewhere"
                for cname, cg in sorted(value.items()):
                    for ckey, cval in sorted(cg.items()):
                        if ckey.endswith("_s"):
                            r.add(
                                "pathway_ingest_connector_stage_seconds_total",
                                "counter",
                                cval,
                                {
                                    "process": str(proc),
                                    "connector": str(cname),
                                    "stage": ckey[:-2],
                                },
                            )
                        else:
                            kind = (
                                "counter" if ckey.endswith("_total")
                                else "gauge"
                            )
                            r.add(
                                f"pathway_ingest_connector_{ckey}",
                                kind,
                                cval,
                                {
                                    "process": str(proc),
                                    "connector": str(cname),
                                },
                            )
                continue
            if key.endswith("_s"):
                r.add(
                    "pathway_ingest_stage_seconds_total",
                    "counter",
                    value,
                    {"process": str(proc), "stage": key[:-2]},
                )
            else:
                kind = "counter" if key.endswith("_total") else "gauge"
                r.add(
                    f"pathway_ingest_{key}",
                    kind,
                    value,
                    {"process": str(proc)},
                )
    for proc, gauges in sorted((serve_stats or {}).items()):
        # serve-plane counters + gauges (serve/stats.py): queries
        # admitted / rejected / degraded, scatter posts, shard searches,
        # plus the live in-flight and queue-depth admission gauges — the
        # pathway_serve_* overload-visibility surface
        plab = {"process": str(proc)}
        for key, value in sorted(gauges.items()):
            kind = "counter" if key.endswith("_total") else "gauge"
            r.add(f"pathway_serve_{key}", kind, value, plab)
    for proc, gauges in sorted((profile_stats or {}).items()):
        # continuous-profiling scalars (observability/profiler.py):
        # samples taken, distinct collapsed stacks, top-frame share and
        # the op-tagged share of engine-thread samples — the health
        # gauges of the flamegraph plane (the flamegraph itself lives at
        # /profile, not in the exposition)
        plab = {"process": str(proc)}
        for key, value in sorted(gauges.items()):
            kind = "counter" if key.endswith("_total") else "gauge"
            r.add(f"pathway_profile_{key}", kind, value, plab)
    r.add("pathway_cluster_workers", "gauge", len(snapshots))
    if stale_workers:
        # a peer whose /snapshot scrape failed: its workers are reported
        # as STALE (last-seen age from the roll-up's cache) instead of
        # silently vanishing from the merged view
        for wid, age in sorted(stale_workers.items()):
            r.add(
                "pathway_worker_last_seen_seconds", "gauge",
                round(float(age), 3), {"worker": str(wid)},
            )
        r.add("pathway_cluster_stale_workers", "gauge", len(stale_workers))
    if bottleneck:
        # info-style gauge: which operator currently owns the largest
        # share of windowed tick processing time (signals plane)
        r.add(
            "pathway_bottleneck_operator", "gauge", 1,
            {"operator": str(bottleneck)},
        )
    if alerts_fired:
        for sev, n in sorted(alerts_fired.items()):
            r.add(
                "pathway_alerts_fired_total", "counter", int(n),
                {"severity": str(sev)},
            )
    if alerts_active is not None:
        r.add("pathway_alerts_active", "gauge", int(alerts_active))
    if scrape_errors:
        r.add("pathway_cluster_scrape_errors", "counter", scrape_errors)
    if trace_dropped is not None:
        # tracer ring-buffer overflow: a timeline missing its head is
        # distinguishable from one that was simply quiet. Cluster callers
        # pass a per-process dict — like the comm gauges, a transiently
        # unreachable peer must DROP its series, not decrease a summed
        # counter (which Prometheus would read as a reset)
        if isinstance(trace_dropped, dict):
            for proc, v in sorted(trace_dropped.items()):
                r.add(
                    "pathway_trace_dropped_events_total", "counter",
                    int(v), {"process": str(proc)},
                )
        else:
            r.add(
                "pathway_trace_dropped_events_total", "counter",
                int(trace_dropped),
            )
    if supervisor is not None:
        # self-healing surface (spawn --supervise): restart generation +
        # why the supervisor last bounced the ensemble (info-style series,
        # value always 1, reason as a label) + armed-chaos fire count.
        # A rescale-only snapshot carries no "restarts" key — an elastic
        # boot outside supervision must not mint pathway_restarts_total
        if supervisor.get("restarts") is not None:
            r.add(
                "pathway_restarts_total", "counter",
                int(supervisor["restarts"]),
            )
        reason = supervisor.get("reason")
        if reason:
            r.add(
                "pathway_last_restart_reason", "gauge", 1,
                {"reason": str(reason)},
            )
        if supervisor.get("chaos_injections") is not None:
            r.add(
                "pathway_chaos_injections_total", "counter",
                int(supervisor["chaos_injections"]),
            )
        if supervisor.get("flight_dumps") is not None:
            # crash-forensic bundles harvested by the supervisor so far
            # (flight recorder, stamped as PATHWAY_FLIGHT_DUMPS)
            r.add(
                "pathway_flight_recorder_dumps_total", "counter",
                int(supervisor["flight_dumps"]),
            )
        if supervisor.get("rescales") is not None:
            # elastic rescaling: state resharder runs completed in this
            # process (spawn --elastic boot) + cumulative wall time
            r.add(
                "pathway_rescale_total", "counter",
                int(supervisor["rescales"]),
            )
            r.add(
                "pathway_rescale_duration_seconds", "gauge",
                float(supervisor.get("rescale_duration_s", 0.0)),
            )
        if supervisor.get("upgrades") is not None:
            # graph-version migrations completed in this process
            # (pathway-tpu upgrade --apply / spawn --upgrade-to) +
            # cumulative wall time + per-verb operator counts
            r.add(
                "pathway_upgrade_total", "counter",
                int(supervisor["upgrades"]),
            )
            r.add(
                "pathway_upgrade_duration_seconds", "gauge",
                float(supervisor.get("upgrade_duration_s", 0.0)),
            )
            verbs = supervisor.get("upgrade_operators") or {}
            for verb in ("carried", "remapped", "new", "dropped"):
                if verbs.get(verb) is not None:
                    r.add(
                        "pathway_upgrade_operators_total", "counter",
                        int(verbs[verb]), {"verb": verb},
                    )
        if supervisor.get("window_failures") is not None:
            # circuit-breaker window position: failures inside the
            # sliding window at this generation's launch vs the restart
            # budget — a restart storm building reads as the failure
            # count climbing toward the budget BEFORE the breaker trips;
            # open=1 means the LAST-CHANCE generation is running (one
            # more failure and the supervisor gives up, exit 75)
            r.add(
                "pathway_restart_window_failures", "gauge",
                int(supervisor["window_failures"]),
            )
            if supervisor.get("window_budget") is not None:
                r.add(
                    "pathway_restart_window_budget", "gauge",
                    int(supervisor["window_budget"]),
                )
            r.add(
                "pathway_circuit_open", "gauge",
                1 if supervisor.get("circuit_open") else 0,
            )
    if autoscale is not None:
        # closed-loop autoscaler (spawn --autoscale MIN..MAX): scale
        # events executed so far and the latest event's pause — stamped
        # into child environments by the controller per generation
        r.add(
            "pathway_autoscale_events_total", "counter",
            int(autoscale.get("events", 0)),
            {"range": str(autoscale.get("range", ""))},
        )
        if autoscale.get("last_pause_ms") is not None:
            r.add(
                "pathway_autoscale_last_pause_ms", "gauge",
                float(autoscale["last_pause_ms"]),
            )
        if autoscale.get("last_decision"):
            # label only the bounded "from->to" head: the full reason
            # string embeds measured values (unique per event = unbounded
            # series cardinality) and already lives in the event log,
            # /query document and `top` line
            r.add(
                "pathway_autoscale_last_decision", "gauge", 1,
                {
                    "decision": str(autoscale["last_decision"])
                    .partition(":")[0].strip()
                },
            )
    return r.text()


def parse_exposition(text: str) -> dict[tuple[str, tuple], float]:
    """Minimal exposition-text parser for validation (obs_smoke + tests):
    returns {(metric_name, sorted label items): value}. Raises ValueError
    on malformed lines — the smoke test's correctness check."""
    out: dict[tuple[str, tuple], float] = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        name_part, _, value_part = line.rpartition(" ")
        if not name_part:
            raise ValueError(f"malformed exposition line: {line!r}")
        labels: dict[str, str] = {}
        name = name_part
        if "{" in name_part:
            if not name_part.endswith("}"):
                raise ValueError(f"malformed labels in line: {line!r}")
            name, _, rest = name_part.partition("{")
            body = rest[:-1]
            try:
                _parse_label_body(body, labels)
            except (IndexError, ValueError) as e:
                raise ValueError(
                    f"malformed labels in line: {line!r}"
                ) from e
        try:
            value = float(value_part)
        except ValueError:
            raise ValueError(f"non-numeric sample value: {line!r}") from None
        out[(name, tuple(sorted(labels.items())))] = value
    return out


def _parse_label_body(body: str, labels: dict[str, str]) -> None:
    i = 0
    while i < len(body):
        eq = body.index("=", i)
        key = body[i:eq]
        if body[eq + 1] != '"':
            raise ValueError("unquoted label value")
        j = eq + 2
        val: list[str] = []
        while True:
            c = body[j]
            if c == "\\":
                nxt = body[j + 1]
                val.append({"\\": "\\", '"': '"', "n": "\n"}.get(nxt, nxt))
                j += 2
            elif c == '"':
                j += 1
                break
            else:
                val.append(c)
                j += 1
        labels[key] = "".join(val)
        if j < len(body) and body[j] == ",":
            j += 1
        i = j
