"""``pathway-tpu top`` — live terminal dashboard over ``/query``.

Polls the hub's merged windowed-signals endpoint (process 0 under
``spawn -n M``) and redraws a plain-text dashboard: per-worker tick
rate, row rates, frontier lag, tick/e2e latency percentiles, comm queue
depth + send MB/s, the current bottleneck operator, and firing alerts.
Plain ANSI redraw (no curses dependency): each frame repaints from the
home position, so it works in every terminal the test rig has — and
:func:`render_frame` is a pure function of the ``/query`` document, so
tests and the signals smoke assert rendering without a TTY.

Copy of ``pathway_tpu/observability/top.py``: the same frames, byte for byte,
from the same ``/query`` document (``python -m pathway_tpu_torch.cli top``).
"""

from __future__ import annotations

import json
import sys
import time
import urllib.request
from typing import Any

__all__ = ["fetch_query", "render_frame", "run_top"]

_CLEAR = "\x1b[H\x1b[2J"


def fetch_query(url: str, timeout: float = 5.0) -> dict:
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read().decode())


def _fmt(v: Any, unit: str = "", nd: int = 1) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.{nd}f}{unit}"
    return f"{v}{unit}"


def _keyload_line(kl: dict | None) -> str | None:
    """The shard-skew line (observability/keyload.py skew_line)."""
    if not kl:
        return None
    from .keyload import skew_line

    return skew_line(kl)


def render_frame(doc: dict, now: float | None = None) -> str:
    """One dashboard frame from a ``/query`` document."""
    if now is None:
        now = time.time()
    lines: list[str] = []
    procs = doc.get("processes", [doc.get("process_id", 0)])
    lines.append(
        f"pathway-tpu top — {len(doc.get('workers', {}))} worker(s), "
        f"{len(procs)} process(es), window {_fmt(doc.get('window_s'), 's')}"
        f", sampled every {_fmt(doc.get('sample_s'), 's')}"
    )
    lines.append("")
    header = (
        f"{'WORKER':>6} {'TICK/S':>8} {'ROWS/S':>10} {'OUT/S':>10} "
        f"{'LAG MS':>9} {'TICK P95':>9} {'E2E P95':>9}"
    )
    lines.append(header)
    workers = doc.get("workers", {})
    for wid in sorted(workers, key=lambda w: int(w) if w.isdigit() else 0):
        w = workers[wid]
        lag = w.get("frontier_lag_vs_max_ms")
        if lag is None:
            lag = w.get("frontier_lag_ms")
        stale = w.get("stale_s")
        lines.append(
            f"{wid:>6} {_fmt(w.get('tick_rate')):>8} "
            f"{_fmt(w.get('row_rate')):>10} "
            f"{_fmt(w.get('output_rate')):>10} "
            f"{_fmt(lag):>9} "
            f"{_fmt(w.get('tick_p95_ms'), nd=2):>9} "
            f"{_fmt(w.get('e2e_p95_ms'), nd=2):>9}"
            + (f"  STALE {stale:.0f}s" if stale is not None else "")
        )
    if not workers:
        lines.append("  (no worker series yet — sampler warming up)")
    lines.append("")
    comm = doc.get("comm", {})
    # merged docs key comm by process; single-process docs are flat
    comm_by_proc = (
        comm
        if comm and all(isinstance(v, dict) for v in comm.values())
        else {str(doc.get("process_id", 0)): comm}
    )
    for proc in sorted(comm_by_proc):
        c = comm_by_proc[proc] or {}
        if not c:
            continue
        lines.append(
            f"comm p{proc}: send queue {_fmt(c.get('send_queue_depth'), nd=0)}"
            f" frames, {_fmt(c.get('send_mb_per_sec'), ' MB/s', 2)}, "
            f"inbox {_fmt(c.get('cluster_inbox_depth'), nd=0)}"
        )
    mem = doc.get("memory", {})
    # merged docs key memory by process; single-process docs are flat
    mem_by_proc = (
        mem
        if mem and all(isinstance(v, dict) for v in mem.values())
        else {str(doc.get("process_id", 0)): mem}
    )
    for proc in sorted(mem_by_proc):
        m = mem_by_proc[proc] or {}
        if not m:
            continue
        line = (
            f"mem p{proc}: rss {_fmt(m.get('rss_bytes', 0) / 1e6, ' MB', 0)}"
        )
        if m.get("state_budget_bytes"):
            line += (
                f", state {_fmt(m.get('state_resident_bytes', 0) / 1e6, nd=1)}"
                f"/{_fmt(m['state_budget_bytes'] / 1e6, ' MB', 1)} resident"
                f", {_fmt(m.get('state_spilled_bytes', 0) / 1e6, ' MB', 1)}"
                f" spilled ({_fmt(m.get('spill_events_total'), nd=0)} spills)"
            )
        entries = m.get("key_registry_entries", 0)
        if entries:
            line += f", registry {entries:.0f} key(s)"
            if m.get("key_registry_cold_entries"):
                line += f" ({m['key_registry_cold_entries']:.0f} cold)"
            if m.get("key_registry_frozen"):
                line += " FROZEN"
        lines.append(line)
    sinks = doc.get("sinks", {})
    # merged docs key sinks by process; single-process docs are flat
    # (sink name -> counters). Flat docs have dicts of floats one level
    # down, merged docs dicts of dicts.
    flat: dict[str, dict] = {}

    def _absorb(name: str, counters: dict) -> None:
        # a sink is constructed (with zeroed counters) on EVERY worker but
        # delivers on one — keep the copy that has actually moved, never
        # let a muted peer's zeros shadow the live series
        cur = flat.get(name)
        if cur is None or (counters or {}).get(
            "delivered_rows_total", 0
        ) >= (cur or {}).get("delivered_rows_total", 0):
            flat[name] = counters

    for k, v in (sinks or {}).items():
        if v and all(isinstance(x, dict) for x in v.values()):
            for name, counters in v.items():  # process-keyed: union
                _absorb(name, counters)
        elif isinstance(v, dict):
            _absorb(k, v)
    for sname in sorted(flat):
        s = flat[sname] or {}
        if not s:
            continue
        line = (
            f"sink {sname}: {_fmt(s.get('delivered_rows_total'), nd=0)} "
            f"row(s) delivered, queue {_fmt(s.get('queue_depth'), nd=0)}"
        )
        if s.get("retries_total"):
            line += f", {s['retries_total']:.0f} retr(ies)"
        if s.get("dlq_total"):
            line += f", DLQ {s['dlq_total']:.0f}"
        if s.get("breaker_open"):
            line += ", breaker OPEN"
        lines.append(line)
    udf = doc.get("udf", {})
    # merged docs key udf by process; single-process docs are flat
    udf_by_proc = (
        udf
        if udf and all(isinstance(v, dict) for v in udf.values())
        else {str(doc.get("process_id", 0)): udf}
    )
    for proc in sorted(udf_by_proc):
        u = udf_by_proc[proc] or {}
        if not any(u.values()):
            continue
        lines.append(
            f"udf p{proc}: {_fmt(u.get('lifted_total'), nd=0)} lifted, "
            f"{_fmt(u.get('traced_total'), nd=0)} traced, "
            f"{_fmt(u.get('perrow_rows_total'), nd=0)} row(s) per-row"
        )
    fus = doc.get("fusion", {})
    # merged docs key fusion by process; single-process docs are flat
    fus_by_proc = (
        fus
        if fus and all(isinstance(v, dict) for v in fus.values())
        else {str(doc.get("process_id", 0)): fus}
    )
    for proc in sorted(fus_by_proc):
        f = fus_by_proc[proc] or {}
        if not any(f.values()):
            continue
        line = (
            f"fusion p{proc}: {_fmt(f.get('chains_total'), nd=0)} chain(s) "
            f"({_fmt(f.get('fused_ops_total'), nd=0)} ops), "
            f"{_fmt(f.get('preambles_total'), nd=0)} preamble(s), "
            f"{_fmt(f.get('fallbacks_total'), nd=0)} fallback(s)"
        )
        if f.get("jit_chains_total"):
            line += f", {_fmt(f.get('jit_chains_total'), nd=0)} XLA"
        lines.append(line)
    srv = doc.get("serve", {})
    # merged docs key serve by process; single-process docs are flat
    srv_by_proc = (
        srv
        if srv and all(isinstance(v, dict) for v in srv.values())
        else {str(doc.get("process_id", 0)): srv}
    )
    for proc in sorted(srv_by_proc):
        s = srv_by_proc[proc] or {}
        if not any(s.values()):
            continue
        line = (
            f"serve p{proc}: {_fmt(s.get('queries_total'), nd=0)} "
            f"quer(ies), inflight {_fmt(s.get('inflight'), nd=0)}/"
            f"{_fmt(s.get('max_inflight'), nd=0)}, "
            f"queue {_fmt(s.get('queue_depth'), nd=0)}, "
            f"{_fmt(s.get('rejected_total'), nd=0)} rejected"
        )
        if s.get("degraded_total"):
            line += f", {s['degraded_total']:.0f} degraded"
        if s.get("deadline_dropped_total"):
            line += (
                f", {s['deadline_dropped_total']:.0f} deadline-dropped"
            )
        lines.append(line)
    ing = doc.get("ingest", {})
    # merged docs key ingest by process; single-process docs are flat
    ing_by_proc = (
        ing
        if ing and all(isinstance(v, dict) for v in ing.values())
        else {str(doc.get("process_id", 0)): ing}
    )
    for proc in sorted(ing_by_proc):
        g = ing_by_proc[proc] or {}
        if not any(g.values()):
            continue
        total = (
            g.get("parse_s", 0) + g.get("hash_s", 0) + g.get("delta_s", 0)
        )

        def _pct(v: float) -> str:
            return f"{v / total * 100:.0f}%" if total else "-"

        lines.append(
            f"ingest p{proc}: parse {_fmt(g.get('parse_s'), 's', 3)} "
            f"({_pct(g.get('parse_s', 0))}), "
            f"hash {_fmt(g.get('hash_s'), 's', 3)} "
            f"({_pct(g.get('hash_s', 0))}), "
            f"delta {_fmt(g.get('delta_s'), 's', 3)} "
            f"({_pct(g.get('delta_s', 0))}) over "
            f"{_fmt(g.get('rows_total'), nd=0)} row(s)/"
            f"{_fmt(g.get('flushes_total'), nd=0)} flush(es)"
        )
        # per-connector stage split, costliest first: names the
        # bottleneck connector instead of one anonymous ingest total
        conns = g.get("connectors") or {}

        def _conn_total(c: dict) -> float:
            return (
                c.get("parse_s", 0) + c.get("hash_s", 0) + c.get("delta_s", 0)
            )

        for cname in sorted(conns, key=lambda n: -_conn_total(conns[n])):
            c = conns[cname]
            lines.append(
                f"  {cname}: parse {_fmt(c.get('parse_s'), 's', 3)}, "
                f"hash {_fmt(c.get('hash_s'), 's', 3)}, "
                f"delta {_fmt(c.get('delta_s'), 's', 3)} over "
                f"{_fmt(c.get('rows_total'), nd=0)} row(s)"
            )
    prof = doc.get("profile", {})
    # merged docs key profile by process; single-process docs are flat
    prof_by_proc = (
        prof
        if prof and all(isinstance(v, dict) for v in prof.values())
        else {str(doc.get("process_id", 0)): prof}
    )
    for proc in sorted(prof_by_proc):
        p = prof_by_proc[proc] or {}
        if not any(p.values()):
            continue
        tagged = p.get("op_tagged_share")
        lines.append(
            f"profile p{proc}: {_fmt(p.get('samples_total'), nd=0)} "
            f"sample(s), {_fmt(p.get('distinct_frames'), nd=0)} frame(s)"
            + (
                f", {tagged * 100:.0f}% op-tagged"
                if tagged is not None
                else ""
            )
        )
    waves = doc.get("waves")
    if waves and waves.get("last"):
        last = waves["last"]
        share = waves.get("holder_share") or {}
        holder = last.get("holder")
        held = (
            f", w{holder} holds {share.get(str(holder), 0) * 100:.0f}% "
            "of waves"
            if holder is not None
            else ""
        )
        lines.append(
            f"waves: {_fmt(waves.get('waves'), nd=0)} recorded, last "
            f"{_fmt(last.get('duration_ms'), ' ms', 1)} "
            f"(critical {last.get('critical_stage')}, "
            f"holder w{holder if holder is not None else '?'}{held})"
        )
    kl_line = _keyload_line(doc.get("keyload"))
    if kl_line:
        lines.append(kl_line)
    sup = doc.get("supervisor")
    if sup is not None and sup.get("window_failures") is not None:
        budget = sup.get("window_budget")
        breaker = (
            "OPEN" if sup.get("circuit_open")
            else f"{sup['window_failures']}/{_fmt(budget, nd=0)} window"
        )
        lines.append(
            f"supervisor: {_fmt(sup.get('restarts'), nd=0)} restart(s), "
            f"breaker {breaker}"
            + (f" — last: {sup['reason']}" if sup.get("reason") else "")
        )
    auto = doc.get("autoscale")
    if auto is not None:
        line = (
            f"autoscale [{auto.get('range')}]: "
            f"{_fmt(auto.get('events'), nd=0)} scale event(s)"
        )
        if auto.get("last_decision"):
            line += f", last {auto['last_decision']}"
        if auto.get("last_pause_ms") is not None:
            line += f" (pause {auto['last_pause_ms']:.0f} ms)"
        lines.append(line)
    att = doc.get("attribution") or {}
    bottleneck = att.get("bottleneck")
    if bottleneck:
        ranked = att.get("ranked", [])
        share = ranked[0].get("share") if ranked else None
        lines.append(
            f"bottleneck: {bottleneck}"
            + (f" ({share * 100:.0f}% of busy time)" if share else "")
        )
    alerts = doc.get("alerts", {}) or {}
    active = alerts.get("active", [])
    if active:
        lines.append("")
        lines.append(f"ALERTS ({len(active)} firing):")
        for ev in active[-8:]:
            age = max(0.0, now - ev.get("t", now))
            lines.append(
                f"  [{ev.get('severity', '?'):>8}] {ev.get('rule')}: "
                f"{ev.get('expr')} {ev.get('op')} {ev.get('threshold')} "
                f"(value {_fmt(ev.get('value'), nd=3)}, {age:.0f}s ago)"
            )
    else:
        lines.append("alerts: none firing")
    return "\n".join(lines) + "\n"


def run_top(
    url: str,
    interval_s: float = 1.0,
    frames: int = 0,
    clear: bool = True,
    out=None,
) -> int:
    """Poll ``url`` and redraw; ``frames=0`` runs until interrupted.
    Returns a process exit code (0 on success, 1 when the endpoint never
    answered)."""
    out = out or sys.stdout
    drawn = 0
    ok = False
    while True:
        try:
            doc = fetch_query(url)
        except Exception as e:
            out.write(f"pathway-tpu top: {url} unreachable ({e})\n")
            out.flush()
            if frames and drawn + 1 >= frames:
                return 0 if ok else 1
            drawn += 1
            time.sleep(interval_s)
            continue
        ok = True
        frame = render_frame(doc)
        if clear:
            out.write(_CLEAR)
        out.write(frame)
        out.flush()
        drawn += 1
        if frames and drawn >= frames:
            return 0
        try:
            time.sleep(interval_s)
        except KeyboardInterrupt:  # pragma: no cover — interactive exit
            return 0
