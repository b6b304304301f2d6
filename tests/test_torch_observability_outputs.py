"""The observability plane's documents, the port's against the JAX package's, on the CPU.

- The same inputs, made from a seeded numpy generator, give the same bytes or documents in both
  packages: ``render_snapshots`` over ``stats_snapshot`` of each package's ``EngineStats`` fed the
  same observations (the time-dependent ages fixed), ``SpaceSaving`` merges, ``Signals`` queries
  and ``SloEngine``'s sequence of firings, ``collapsed_text`` and ``speedscope_document`` of
  merged profiles, ``critpath.render_report``, and the OTLP payloads of the same tracer events
  (ids and the host's resource attributes taken out).
- A flight ring written by either package is harvested by the other to the same records.
- A live run: one 2-worker streaming program (a python subject with retractions, a groupby and a
  join) in each package with the monitoring server on, async and under BSP (``device="cpu"`` on
  the port), the process-wide counters that earlier tests may have moved emptied first. The
  final ``/metrics`` (read over HTTP after every worker joined, before the server
  stops) has the same families and label names in both packages, and the same operators on the
  same workers; per-operator row counts are equal under BSP, where a commit is one lock-step tick.
  Under async the sources' counts are equal; the operators after a groupby emit as many rows as
  the sweeps into which arrivals happened to group, in either package. Every key group the load sketch tracks lies within its bound of the true count
  (``true <= estimate <= true + N / capacity``), the truth counted with numpy from the route
  keys each exchange saw; under BSP those true counts are equal in both packages.
- ``pw.run(with_http_server=True)`` serves all eight endpoints, ``monitoring_level`` draws the
  dashboard, and ``PATHWAY_PROFILE`` and ``PATHWAY_KEYLOAD`` default on, in the port.

Tolerance: none; every document is compared exactly.
"""

from __future__ import annotations

import importlib
import json
import socket
import threading
import time
import urllib.request

import numpy as np
import pytest

PACKAGES = ("pathway_tpu", "pathway_tpu_torch")
_OPENER = urllib.request.build_opener(urllib.request.ProxyHandler({}))


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _kw(pkg: str) -> dict:
    return {"device": "cpu"} if pkg == "pathway_tpu_torch" else {}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(port: int, path: str) -> tuple[int, str]:
    try:
        with _OPENER.open(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in ("PATHWAY_THREADS", "PATHWAY_FLIGHT_DIR", "PATHWAY_TRACE_FILE",
                "PATHWAY_MONITORING_SERVER", "PATHWAY_TELEMETRY_SERVER", "PATHWAY_SLO_RULES",
                "PATHWAY_PROFILE", "PATHWAY_KEYLOAD", "PATHWAY_MONITORING_HTTP_SERVER",
                "PATHWAY_ASYNC_EXEC", "PATHWAY_KEYLOAD_CAPACITY", "PATHWAY_KEYLOAD_GROUPS",
                "PATHWAY_RESTART_COUNT", "PATHWAY_SUPERVISED", "PATHWAY_FLIGHT_DUMPS",
                "PATHWAY_AUTOSCALE"):
        monkeypatch.delenv(var, raising=False)
    yield
    for pkg in PACKAGES:
        _mod(pkg, "internals.parse_graph").G.clear()
        _mod(pkg, "internals.tracing").deactivate()


# -- byte-equal documents from seeded inputs ----------------------------------------------------


def _fed_stats(pkg: str, rng_seed: int, worker: int) -> dict:
    """``stats_snapshot`` of ``pkg``'s ``EngineStats`` after a seeded stream of observations, its
    ages fixed."""
    rng = np.random.default_rng(rng_seed)
    ex = _mod(pkg, "engine.executor")
    hub = _mod(pkg, "observability.hub")
    s = ex.EngineStats()
    s.detailed = True
    nodes = [type(name, (), {"node_id": i})() for i, name in
             enumerate(["PythonSubjectSource", "Rowwise", "Exchange", "GroupByReduce", "Join"])]
    for _ in range(60):
        node = nodes[int(rng.integers(len(nodes)))]
        s.note_node(node, int(rng.integers(1, 500)), is_source=node.node_id == 0)
        s.note_node_time(node, int(rng.integers(1_000, 50_000_000)))
        s.tick_duration.observe(int(rng.integers(10_000, 80_000_000)))
        s.note_exchange(int(rng.integers(0, 300)), int(rng.integers(0, 300)))
        s.note_tick(int(rng.integers(1, 10_000)) * 2)
    if s.keyload is not None:
        for _ in range(5):
            rk = rng.integers(0, 2**63, size=int(rng.integers(10, 400)), dtype=np.uint64)
            s.keyload.observe_exchange(rk, rng.integers(0, 2, size=len(rk)), int(rk.nbytes))
    s.latency_ms = float(rng.integers(1, 100))
    snap = hub.stats_snapshot(s, worker)
    snap.update(uptime_s=12.5, heartbeat_age_s=0.25)
    if "latency_age_s" in snap:
        snap["latency_age_s"] = 0.5
    return snap


def test_render_snapshots_is_byte_equal():
    rng = np.random.default_rng(7)
    comm = {"0": {k: float(v) for k, v in zip(
        ("cluster_inbox_depth", "send_queue_depth", "mesh_rows_moved"),
        rng.integers(0, 1000, 3))}}
    memory = {"0": {"rss_bytes": float(rng.integers(1, 2**30)), "spill_bytes": 0.0}}
    sinks = {"0": {"csv": {"delivered_total": 10.0, "retries_total": 1.0}}}
    bodies = {}
    for pkg in PACKAGES:
        prom = _mod(pkg, "observability.prometheus")
        snaps = [_fed_stats(pkg, 11, 0), _fed_stats(pkg, 12, 1)]
        bodies[pkg] = prom.render_snapshots(
            snaps, comm, scrape_errors=2, worker_labels=True, trace_dropped={"0": 3},
            stale_workers={"1": 1.5}, bottleneck="GroupByReduce#3",
            alerts_fired={"warning": 2}, alerts_active=1, memory_stats=memory,
            sink_stats=sinks)
        one = prom.render_snapshots([_fed_stats(pkg, 13, 0)])
        bodies[pkg] += one
        prom.parse_exposition(bodies[pkg])  # well-formed
    assert bodies["pathway_tpu_torch"] == bodies["pathway_tpu"]
    assert "pathway_keyload" in bodies["pathway_tpu"]


def test_space_saving_merges_are_equal():
    rng = np.random.default_rng(3)
    streams = [rng.zipf(1.3, size=2_000) % 97 for _ in range(4)]
    docs = {}
    for pkg in PACKAGES:
        kl = _mod(pkg, "observability.keyload")
        sketches = []
        for st in streams:
            sk = kl.SpaceSaving(capacity=16)
            for k in st:
                sk.observe(int(k))
            sketches.append(sk)
        merged = sketches[0].merge(sketches[1]).merge(sketches[2].merge(sketches[3]))
        merged.decay(0.5)
        accts = []
        for i, st in enumerate(streams):
            a = kl.KeyLoadAccount(capacity=8, n_groups=32, decay_s=0.0)
            keys = (st.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15))
            a.observe_exchange(keys, st % 4, int(keys.nbytes))
            accts.append(a.snapshot())
        docs[pkg] = json.dumps([merged.snapshot(), sorted(merged.items(), key=repr),
                                kl.merge_snapshots(accts)], sort_keys=True)
    assert docs["pathway_tpu_torch"] == docs["pathway_tpu"]


def _signals_doc(pkg: str) -> str:
    ts = _mod(pkg, "observability.timeseries")
    slo = _mod(pkg, "observability.slo")
    hist = _mod(pkg, "observability.histogram")
    rng = np.random.default_rng(5)
    store = ts.TimeSeriesStore(capacity=128)
    h = hist.LogHistogram()
    t0 = 1000.0
    for i in range(80):
        t = t0 + i * 0.5
        for w in (0, 1):
            store.record("engine_ticks", float(i * (3 + w)), w, t)
            store.record("frontier_lag_ms", float(rng.integers(0, 400)), w, t)
        h.observe(int(rng.integers(100_000, 90_000_000)))
        store.record("tick_duration", h.snapshot()["counts"], 0, t)
    sig = ts.Signals(store)
    answers = [sig.rate("engine_ticks", 10.0, 1), sig.delta("engine_ticks", 7.0, 0),
               sig.last("frontier_lag_ms", 1), sig.agg("frontier_lag_ms", 20.0, max, 0),
               sig.percentile("tick_duration", 0.95, 15.0, 0),
               sig.eval("p50(tick_duration)", 15.0, 0),
               sig.eval_worst("avg(frontier_lag_ms)", 12.0),
               sig.sustained_above("frontier_lag_ms", 50.0, 3.0, 0)]
    rules = slo.load_rules(json.dumps({"rules": [
        {"name": "lag", "expr": "last(frontier_lag_ms)", "op": ">", "threshold": 200.0,
         "for_s": 1.0, "severity": "critical"},
        {"name": "slow", "expr": "p95(tick_duration_ms)", "op": ">", "threshold": 40.0},
        {"name": "never", "expr": "rate(engine_ticks)", "op": "<", "threshold": -1.0}]}))
    engine = slo.SloEngine(rules, default_window_s=10.0)
    for i in range(40):
        part = ts.TimeSeriesStore(capacity=128)
        for name in ("frontier_lag_ms", "engine_ticks", "tick_duration"):
            for w in (0, 1):
                for t, v in store.points(name, w)[: 2 * i + 2]:
                    part.record(name, v, w, t)
        engine.evaluate(ts.Signals(part), now=t0 + i)
    return json.dumps([answers, engine.alerts.document()], sort_keys=True)


def test_signals_queries_and_slo_firings_are_equal():
    got, want = _signals_doc("pathway_tpu_torch"), _signals_doc("pathway_tpu")
    assert got == want
    assert '"firing"' in want and '"resolved"' in want


def _profile(pkg: str, pid: int, rng) -> dict:
    kl = _mod(pkg, "observability.keyload")
    frames = ["run;_run_inner;_tick", "run;_tick;process", "op:GroupByReduce#3;process;arrange",
              "op:Join#4;process;probe", "thread:Thread-1;wait", "op:Rowwise#1;eval"]
    wall, cpu = kl.SpaceSaving(32), kl.SpaceSaving(32)
    total = 0
    for _ in range(300):
        key = frames[int(rng.integers(len(frames)))] + f";leaf{int(rng.integers(5))}"
        w = int(rng.integers(1, 4))
        wall.observe(key, w)
        cpu.observe(key, w // 2 + 1)
        total += w
    return {"enabled": True, "process_id": pid, "hz": 19.0, "capacity": 32,
            "duration_s": 2.0, "samples_total": total, "engine_samples": total // 2,
            "op_tagged": total // 3, "errors_total": 0, "threads": 3,
            "cpu_supported": True, "wall": wall.snapshot(), "cpu": cpu.snapshot()}


def test_profile_renderings_are_equal():
    docs = {}
    for pkg in PACKAGES:
        pm = _mod(pkg, "observability.profile_merge")
        rng = np.random.default_rng(9)
        merged = pm.merge_snapshots([_profile(pkg, p, rng) for p in range(3)] + [None])
        docs[pkg] = (pm.collapsed_text(merged), pm.collapsed_text(merged, mode="cpu"),
                     json.dumps(pm.speedscope_document(merged), sort_keys=True),
                     json.dumps(pm.top_frames(merged, 7), sort_keys=True),
                     pm.render_top(merged, 5))
    assert docs["pathway_tpu_torch"] == docs["pathway_tpu"]


def test_critpath_report_is_equal():
    out = {}
    for pkg in PACKAGES:
        cp = _mod(pkg, "observability.critpath")
        rng = np.random.default_rng(4)
        snaps = {}
        for w in range(3):
            rec = cp.WaveRecorder(w)
            for epoch in range(6):
                phases = {p: float(rng.integers(0, 50)) for p in cp.PHASES}
                rec.record_wave(epoch=epoch, T=2 * epoch + 2, t=1000.0 + epoch,
                                duration_ms=float(sum(phases.values())), interval_ms=5.0,
                                phases_ms=phases, settle_rounds=int(rng.integers(1, 4)),
                                ready_order=[(v, 2 * epoch, 1000.0 + v * 0.01) for v in range(3)],
                                busy_ms={v: float(rng.integers(0, 30)) for v in range(3)},
                                fin=epoch == 5)
            snaps[str(w)] = rec.snapshot()
        out[pkg] = cp.render_report(cp.merge_worker_waves(snaps), top_k=4)
    assert out["pathway_tpu_torch"] == out["pathway_tpu"]
    assert "holder=w" in out["pathway_tpu"]


def _strip_ids(doc):
    if isinstance(doc, dict):
        return {k: _strip_ids(v) for k, v in doc.items()
                if k not in ("traceId", "spanId", "parentSpanId")}
    if isinstance(doc, list):
        return [_strip_ids(v) for v in doc
                if not (isinstance(v, dict) and v.get("key") == "service.instance.id")]
    return doc


def test_otlp_payloads_are_equal_up_to_ids():
    rng = np.random.default_rng(21)
    events = []
    for i in range(40):
        ts = float(i * 1000 + int(rng.integers(0, 500)))
        events.append({"name": ["tick", "GroupByReduce#3", "wave.commit"][i % 3], "ph": "X",
                       "ts": ts, "dur": float(rng.integers(1, 900)), "pid": 1, "tid": 2,
                       "args": {"time": int(rng.integers(0, 99)), "rows": i, "ok": bool(i % 2),
                                "share": 0.25 * i, "label": f"w{i % 2}"}})
        events.append({"name": f"engine_rows.w{i % 2}", "ph": "C", "ts": ts + 1.0, "pid": 1,
                       "args": {"input": float(i * 10), "output": float(i * 7)}})
    out = {}
    for pkg in PACKAGES:
        tel = _mod(pkg, "internals.telemetry")
        h = _mod(pkg, "observability.histogram").LogHistogram()
        for v in np.random.default_rng(2).integers(1_000, 10**9, 200):
            h.observe(int(v))
        hist_snap = h.snapshot()
        exp = tel.OtlpExporter("http://127.0.0.1:1", run_id="run-1")
        origin = 1_700_000_000_000_000_000
        out[pkg] = json.dumps(_strip_ids([
            exp.spans_payload(events, origin), exp.metrics_payload(events, origin),
            exp.histograms_payload([("pathway_tick_duration", {"worker": 0}, hist_snap)],
                                   origin)]), sort_keys=True)
    assert out["pathway_tpu_torch"] == out["pathway_tpu"]


def test_flight_rings_cross_harvest(tmp_path):
    records = [("run.start", {"worker": 0, "n_workers": 2}),
               ("tick", {"worker": 1, "time": 4, "seq": 3, "dur_ms": 1.5}),
               ("async.commit", {"worker": 0, "epoch": 2, "holder": 1, "critical": "sweep"}),
               ("slo.alert", {"rule": "lag", "value": 0.25, "labels": ["a", "b"]}),
               ("run.end", {"worker": 0, "ticks": 9, "rows": 120})]
    harvested = {}
    for writer in PACKAGES:
        fr = _mod(writer, "observability.flightrecorder")
        path = str(tmp_path / f"{writer}.ring")
        rec = fr.FlightRecorder(path, capacity_bytes=4096, process_id=1, run_id="r7")
        for _ in range(12):  # wraps the 4 KiB ring
            for kind, fields in records:
                rec.record(kind, **fields)
        rec.close()
        for reader in PACKAGES:
            doc = _mod(reader, "observability.flightrecorder").harvest(path)
            harvested[(writer, reader)] = doc
    for writer in PACKAGES:
        docs = [harvested[(writer, r)] for r in PACKAGES]
        assert docs[0] == docs[1]
        assert docs[0]["wrapped"] and docs[0]["run_id"] == "r7"
    strip = [[{k: v for k, v in r.items() if k != "t"} for r in harvested[(w, w)]["records"]]
             for w in PACKAGES]
    assert strip[0] == strip[1]


# -- a live 2-worker run with the server on -----------------------------------------------------


_N_COMMITS, _ROWS = 12, 40


def _rows(commit: int) -> tuple[list[tuple[int, int, int]], list[tuple[int, int, int]]]:
    """(inserted, deleted) rows (id, k, v) of a commit: seeded, the deletions taken from the
    rows inserted two commits before."""
    rng = np.random.default_rng(100 + commit)
    ins = [(commit * _ROWS + i, int(rng.integers(0, 9)), int(rng.integers(-50, 50)))
           for i in range(_ROWS)]
    dels = []
    if commit >= 2:
        old = _rows(commit - 2)[0]
        dels = [old[i] for i in range(0, _ROWS, 3)]
    return ins, dels


def _fresh_process_sections(pkg: str, monkeypatch) -> None:
    """Empty the process-wide counters whose ``/metrics`` families appear only once something has
    moved them (the serve plane, the delivery sinks, the ingest split, the rescales; in the
    reference also an armed fault plan and the upgrades), so that what earlier tests in this
    process did with either package does not show in this run's exposition."""
    resharder = _mod(pkg, "rescale.resharder")
    monkeypatch.setattr(resharder, "_STATS", {"total": 0, "duration_s": 0.0, "last": None})
    if pkg == "pathway_tpu":
        monkeypatch.setattr(_mod(pkg, "chaos.injector"), "ARMED", None)
        migrator = _mod(pkg, "upgrade.migrator")
        monkeypatch.setattr(migrator, "_STATS", {k: 0 if isinstance(v, (int, float)) else v
                                                 for k, v in migrator._STATS.items()})
    serve = _mod(pkg, "serve.stats")
    monkeypatch.setattr(serve, "SERVE_STATS", {k: 0 for k in serve.SERVE_STATS})
    monkeypatch.setattr(serve, "_gauge_providers", [])
    monkeypatch.setattr(_mod(pkg, "io.delivery"), "_STATS", {})
    py = _mod(pkg, "io.python")
    monkeypatch.setattr(py, "INGEST_STAGE_STATS", {k: 0 for k in py.INGEST_STAGE_STATS})
    monkeypatch.setattr(py, "INGEST_CONNECTOR_STATS", {})


def _live_run(pkg: str, monkeypatch, async_exec: bool) -> dict:
    _fresh_process_sections(pkg, monkeypatch)
    pw = importlib.import_module(pkg)
    gr = _mod(pkg, "internals.graph_runner")
    kl = _mod(pkg, "observability.keyload")
    pw.G.clear()
    port = _free_port()
    monkeypatch.setenv("PATHWAY_THREADS", "2")
    monkeypatch.setenv("PATHWAY_MONITORING_HTTP_PORT", str(port))
    monkeypatch.setenv("PATHWAY_ASYNC_EXEC", "1" if async_exec else "0")
    monkeypatch.setenv("PATHWAY_KEYLOAD_CAPACITY", "6")
    monkeypatch.setenv("PATHWAY_KEYLOAD_GROUPS", "16")
    routed: list[np.ndarray] = []
    lock = threading.Lock()
    observe = kl.KeyLoadAccount.observe_exchange

    def record(self, route_keys, shards, nbytes=0, now=None):
        with lock:
            routed.append(np.asarray(route_keys, dtype=np.uint64).copy())
        observe(self, route_keys, shards, nbytes, now)

    monkeypatch.setattr(kl.KeyLoadAccount, "observe_exchange", record)
    got: dict = {}
    stop = gr.GraphRunner._stop_observability

    def final_read(http_server, flusher, hub=None):
        # every worker has joined and the server still listens
        got["metrics"] = _get(port, "/metrics")[1]
        got["snapshot"] = json.loads(_get(port, "/snapshot")[1])
        stop(http_server, flusher, hub)

    monkeypatch.setattr(gr.GraphRunner, "_stop_observability", staticmethod(final_read))
    seen = threading.Condition()
    state = {"n": 0}

    class Subject(pw.io.python.ConnectorSubject):
        def run(self):
            want = 0
            for c in range(_N_COMMITS):
                ins, dels = _rows(c)
                for i, k, v in ins:
                    self.next(id=i, k=k, v=v)
                for i, k, v in dels:
                    self._remove(id=i, k=k, v=v)
                self.commit()
                want += len(ins) + len(dels)
                # one commit at a time: the next waits until this one reached the output
                with seen:
                    seen.wait_for(lambda: state["n"] >= want, timeout=30)

    schema = pw.schema_from_types(id=int, k=int, v=int)
    t = pw.io.python.read(Subject(), schema=schema, autocommit_duration_ms=None)
    dim = pw.debug.table_from_markdown("k | name\n" + "\n".join(f"{k} | n{k}" for k in range(9)))
    g = t.groupby(pw.this.k).reduce(pw.this.k, s=pw.reducers.sum(pw.this.v),
                                    c=pw.reducers.count())
    j = g.join(dim, pw.left.k == pw.right.k).select(pw.left.k, pw.left.s, pw.left.c,
                                                    pw.right.name)

    def on_input(key, row, time, is_addition):
        with seen:
            state["n"] += 1
            seen.notify_all()

    final: dict = {}

    def on_out(key, row, time, is_addition):
        with seen:
            if is_addition:
                final[row["k"]] = (row["s"], row["c"], row["name"])
            elif final.get(row["k"]) == (row["s"], row["c"], row["name"]):
                del final[row["k"]]

    pw.io.subscribe(t.select(pw.this.k), on_change=on_input)
    pw.io.subscribe(j, on_change=on_out)
    pw.run(with_http_server=True, **_kw(pkg))
    pw.G.clear()
    got["final"] = final
    got["routed"] = routed
    return got


def _families(text: str, parse) -> set:
    return {(name, tuple(k for k, _ in labels)) for name, labels in parse(text)}


def _op_rows(text: str, parse) -> dict:
    """{(operator type, ordinal of its node id among that type's, worker): rows}."""
    rows = {(dict(lab)["operator"], dict(lab).get("worker")): v
            for (name, lab), v in parse(text).items() if name == "pathway_operator_rows_total"}
    ids = sorted({op for op, _ in rows}, key=lambda op: int(op.split("#")[1]))
    by_type: dict = {}
    names = {}
    for op in ids:
        typ = op.split("#")[0]
        names[op] = (typ, by_type.setdefault(typ, 0))
        by_type[typ] += 1
    return {(*names[op], w): v for (op, w), v in rows.items()}


def _expected_final() -> dict:
    live: dict = {}
    for c in range(_N_COMMITS):
        ins, dels = _rows(c)
        for i, k, v in ins:
            live[i] = (k, v)
        for i, _k, _v in dels:
            del live[i]
    arr = np.array(list(live.values()))
    return {int(k): (int(arr[arr[:, 0] == k, 1].sum()), int((arr[:, 0] == k).sum()), f"n{k}")
            for k in np.unique(arr[:, 0])}


@pytest.mark.parametrize("async_exec", [True, False], ids=["async", "bsp"])
def test_live_run_metrics_match_the_reference(monkeypatch, async_exec):
    runs = {pkg: _live_run(pkg, monkeypatch, async_exec) for pkg in PACKAGES}
    want = _expected_final()
    parsed = {}
    for pkg, run in runs.items():
        assert run["final"] == want, pkg
        parse = _mod(pkg, "observability.prometheus").parse_exposition
        parsed[pkg] = (_families(run["metrics"], parse), _op_rows(run["metrics"], parse))
        workers = {dict(lab).get("worker") for _, lab in parse(run["metrics"])}
        assert {"0", "1"} <= workers
        # every tracked key group within the sketch's bound of the true count
        kl = _mod(pkg, "observability.keyload")
        K = _mod(pkg, "engine.keys")
        n_groups = 16
        true = np.bincount(
            np.concatenate([K.shard_of(rk, n_groups) for rk in run["routed"]]),
            minlength=n_groups)
        merged = kl.merge_snapshots([w["keyload"] for w in run["snapshot"]["workers"]])
        sketch = kl.SpaceSaving.from_snapshot(merged["sketch"])
        assert sketch.total == true.sum()
        per_worker = [kl.SpaceSaving.from_snapshot(w["keyload"]["sketch"])
                      for w in run["snapshot"]["workers"]]
        assert sum(s.total for s in per_worker) == true.sum()
        for s in per_worker + [sketch]:
            for g, est, _err in s.items():
                assert 0 < est
            bound = sketch.total / sketch.capacity
            for g, est, _err in sketch.items():
                assert true[int(g)] <= est <= true[int(g)] + bound, (pkg, g)
        run["true"] = true
    (fam_w, ops_w), (fam_g, ops_g) = parsed["pathway_tpu"], parsed["pathway_tpu_torch"]
    assert fam_g == fam_w
    assert set(ops_g) == set(ops_w)
    if not async_exec:
        assert ops_g == ops_w
        np.testing.assert_array_equal(runs["pathway_tpu_torch"]["true"],
                                      runs["pathway_tpu"]["true"])
    else:
        sources = {k: v for k, v in ops_w.items() if k[0] == "PythonSubjectSource"}
        assert sources and {k: ops_g[k] for k in sources} == sources


# -- the port's surface -------------------------------------------------------------------------


def test_port_all_equals_the_reference():
    assert _mod("pathway_tpu_torch", "observability").__all__ == \
        _mod("pathway_tpu", "observability").__all__


def test_defaults_profile_and_keyload_on():
    import pathway_tpu_torch.engine.executor as ex
    from pathway_tpu_torch.observability import keyload, profiler

    assert profiler.enabled() and keyload.enabled()
    assert ex.EngineStats().keyload is not None


def test_run_serves_every_endpoint(monkeypatch):
    import pathway_tpu_torch as pw

    port = _free_port()
    monkeypatch.setenv("PATHWAY_THREADS", "2")
    monkeypatch.setenv("PATHWAY_MONITORING_HTTP_PORT", str(port))
    monkeypatch.setenv("PATHWAY_SIGNALS_SAMPLE_S", "0.05")
    monkeypatch.setenv("PATHWAY_SLO_RULES", json.dumps([
        {"name": "ticks", "expr": "p95(tick_duration_ms)", "op": ">", "threshold": 0.0}]))
    answers: dict = {}
    paths = ("/metrics", "/snapshot", "/query", "/attribution", "/alerts", "/profile",
             "/healthz", "/readyz")

    class Subject(pw.io.python.ConnectorSubject):
        def run(self):
            for i in range(30):
                self.next(k=i % 5, v=i)
            self.commit()
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline and _get(port, "/readyz")[0] != 200:
                time.sleep(0.05)
            while time.monotonic() < deadline and '"ticks"' not in _get(port, "/alerts")[1]:
                time.sleep(0.05)
            for path in paths:
                answers[path] = _get(port, path)

    t = pw.io.python.read(Subject(), schema=pw.schema_from_types(k=int, v=int))
    g = t.groupby(pw.this.k).reduce(pw.this.k, s=pw.reducers.sum(pw.this.v))
    pw.io.subscribe(g, on_change=lambda **kw: None)
    pw.run(device="cpu", with_http_server=True)
    assert {p: code for p, (code, _) in answers.items()} == {p: 200 for p in paths}
    series = pw.observability.parse_exposition(answers["/metrics"][1])
    assert series[("pathway_input_rows", (("worker", "0"),))] + \
        series[("pathway_input_rows", (("worker", "1"),))] >= 30
    assert json.loads(answers["/alerts"][1])["active"][0]["rule"] == "ticks"
    assert json.loads(answers["/attribution"][1])["ranked"]
    assert json.loads(answers["/profile"][1])["enabled"]
    assert json.loads(answers["/query"][1])["signals"]


def test_monitoring_level_draws_the_dashboard(capsys, monkeypatch):
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.internals import monitoring

    start = monitoring.start_dashboard
    monkeypatch.setattr(monitoring, "start_dashboard",
                        lambda stats, level: start(stats, level, refresh_s=0.05))

    class Subject(pw.io.python.ConnectorSubject):
        def run(self):
            for i in range(8):
                self.next(a=i)
                self.commit()
                time.sleep(0.05)

    t = pw.io.python.read(Subject(), schema=pw.schema_from_types(a=int))
    pw.io.subscribe(t.select(b=pw.this.a * 2), on_change=lambda **kw: None)
    pw.run(device="cpu", monitoring_level=pw.MonitoringLevel.ALL)
    err = capsys.readouterr().err
    assert "[pathway monitoring]" in err and "rows ingested=" in err
    assert "Rowwise#" in err  # the ALL level lists the operators
