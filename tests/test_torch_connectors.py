"""The rest of ``pw.io`` (the connectors, ``http``'s ``read`` and ``write``), ``xpacks.connectors``
and ``pw.demo`` of the port against the JAX package's, on the CPU.

- The reference's own cases: ``tests/test_connectors.py``, ``test_connectors_destubbed.py``
  (SharePoint among them), ``test_mongodb_sink.py`` and ``test_ported_demo.py``, each run through
  both packages (``tests/torch_case_runs.py``). Each case's own assertions hold in both; every
  table it computes is equal row key by row key, and so is every update that a source's ``poll``
  returns to the case itself (the cases that drive a source by hand), but for the wall-clock
  fields of the object scanner's ``_metadata`` (``seen_at``, ``modified_at``) and the keys of the
  rows that carry them, which both packages hash over those fields. The NATS case's fake client
  keeps what is published before the source subscribes (``_nats_backlog``).
- The seven outcomes of ``tests/test_sink_chaos.py`` (the port has no chaos plane), with client
  fakes that fail by themselves: twice and then succeed, reject a row, or fail a commit after
  staging it. The rows delivered, the dead-letter entries and the rollbacks are equal in both
  packages and as that file holds them.
- ``http.read`` and ``http.write`` against a local server.
- SQLite and Delta Lake streaming programs with inserts, updates and deletes, a writer waiting
  for each transaction's tick: at 1 worker the port's tables equal the reference's; at 2 and 4
  workers (async, the default) and at 2 under BSP (``PATHWAY_ASYNC_EXEC=0``) they equal the
  reference's 1-worker tables.
- A Delta table written by one package and read by the other, and Debezium envelopes made from
  one package's SQLite change stream read by the other.
- Each gated connector, its client module blocked, raises the reference's ``ImportError`` when
  called and never on import; ``pw.io.__all__`` is the reference's.

Tolerance: none; every table is compared exactly.
"""

from __future__ import annotations

import ast
import contextlib
import http.server
import importlib
import json
import os
import sqlite3
import subprocess
import sys
import threading
import time
import types
from collections import Counter

import pyarrow.parquet  # noqa: F401  (first imported here: see io/deltalake.py::_import_pyarrow)
import pytest

from torch_case_runs import TESTS, Side, cases, norm, run_case
from torch_io_runs import run_bounded
from torch_state_runs import PACKAGES, ns

ROOT = os.path.dirname(TESTS)

CASES = cases(["test_connectors", "test_connectors_destubbed", "test_mongodb_sink",
               "test_ported_demo"])


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch, tmp_path):
    for var in ("PATHWAY_ASYNC_EXEC", "PATHWAY_MESH_EXCHANGE", "PATHWAY_FUSION"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("PATHWAY_THREADS", "1")
    monkeypatch.setenv("PATHWAY_SINK_DLQ_DIR", str(tmp_path / "dlq"))
    monkeypatch.setenv("PATHWAY_SINK_RETRY_FIRST_DELAY_MS", "1")
    monkeypatch.setenv("PATHWAY_SINK_RETRY_JITTER_MS", "0")
    for pkg in PACKAGES:
        importlib.import_module(f"{pkg}.io.delivery")._reset_stats_for_tests()


# -- the reference's cases ---------------------------------------------------------------------


def _case_args(module: str, name: str) -> list[str]:
    with open(os.path.join(TESTS, module + ".py")) as f:
        tree = ast.parse(f.read())
    (fn,) = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == name]
    return [a.arg for a in fn.args.args]


PARAMS = []
for _m, _n in CASES:
    if "offset" in _case_args(_m, _n):  # test_ported_demo.py's range stream, at its offsets
        PARAMS += [(_m, _n, {"offset": o}) for o in (0, 10, -10)]
    else:
        PARAMS.append((_m, _n, {}))

#: the realtime sources that reference cases poll by hand
_SOURCES = ("io._object_scanner.ObjectScanSource", "io.deltalake.DeltaStreamSource",
            "io.airbyte.AirbyteSource", "io.nats.NatsSource", "io.sqlite.SqliteStreamSource")


@contextlib.contextmanager
def _recorded_polls(pkg: str, into: Counter):
    """Count every (key, row, diff) that a source's ``poll`` returns on the main thread (a case
    driving the source itself; the engine's polls run on its worker threads)."""
    with pytest.MonkeyPatch.context() as mp:
        for path in _SOURCES:
            mod, cls = path.rsplit(".", 1)
            klass = getattr(importlib.import_module(f"{pkg}.{mod}"), cls)

            def poll(self, _real=klass.poll):
                out = _real(self)
                if threading.current_thread() is threading.main_thread():
                    for d in out:
                        for key, row, diff in d.iter_rows():
                            into[(int(key), norm(tuple(row)), int(diff))] += 1
                return out

            mp.setattr(klass, "poll", poll)
        yield


#: the object scanner's metadata fields that hold the wall clock of a poll or a file's write
_CLOCK_FIELDS = ("seen_at", "modified_at")


def _untimed(value):
    """``value`` with the wall-clock fields taken out of a ``_metadata`` JSON string: the two
    packages' runs poll (and write their files) at different seconds."""
    if isinstance(value, tuple):
        return tuple(_untimed(v) for v in value)
    if isinstance(value, str) and value.startswith("{") and "seen_at" in value:
        meta = json.loads(value)
        return json.dumps({k: v for k, v in meta.items() if k not in _CLOCK_FIELDS},
                          sort_keys=True)
    return value


def _fake_pymongo(monkeypatch):
    """``test_mongodb_sink.py``'s ``fake_pymongo`` fixture, over the executed module's classes."""
    def prepare(env):
        return {"fake_pymongo": next(env["fake_pymongo"].__wrapped__(monkeypatch))}

    return prepare


def _nats_backlog(env):
    """``FakeNats`` keeping what is published to a topic before its first subscriber, and
    handing it to that subscriber: the NATS case publishes after a fixed 0.15 s, which a run on a
    loaded host may not have reached yet (a NATS stream with a durable consumer replays so)."""
    cls = env["FakeNats"]
    real_subscribe, real_publish = cls.subscribe, cls.publish
    lock = threading.Lock()

    def publish(self, topic, payload):
        with lock:
            if not self.subs.get(topic):
                self.__dict__.setdefault("backlog", []).append((topic, payload))
        real_publish(self, topic, payload)

    def subscribe(self, topic, callback):
        with lock:
            real_subscribe(self, topic, callback)
            held = [p for t, p in self.__dict__.get("backlog", []) if t == topic]
            self.backlog = [(t, p) for t, p in self.__dict__.get("backlog", []) if t != topic]
        for payload in held:
            callback(payload)

    cls.publish, cls.subscribe = publish, subscribe
    return {}


@pytest.mark.parametrize("module,name,extra", PARAMS,
                         ids=[f"{m}::{n}" + "".join(f"[{v}]" for v in x.values())
                              for m, n, x in PARAMS])
def test_reference_case_through_both_packages(module, name, extra, tmp_path, monkeypatch):
    args = _case_args(module, name)
    got = {}
    for pkg in PACKAGES:
        fixtures = dict(extra)
        if "tmp_path" in args:
            fixtures["tmp_path"] = tmp_path / pkg
            fixtures["tmp_path"].mkdir()
        if "monkeypatch" in args:
            fixtures["monkeypatch"] = monkeypatch
        prepare = _fake_pymongo(monkeypatch) if "fake_pymongo" in args else \
            _nats_backlog if name == "test_nats_read_write_roundtrip" else None
        polls: Counter = Counter()
        with _recorded_polls(pkg, polls):
            tables = run_case(module, name, Side(pkg), prepare=prepare, **fixtures)
        # a row that carries the wall clock has a key hashed over it too: compare it without
        got[pkg] = ([{k: _untimed(r) for k, r in t.items()} for t in tables],
                    Counter({(k if _untimed(r) == r else None, _untimed(r), d): n
                             for (k, r, d), n in polls.items()}))
    assert got["pathway_tpu_torch"] == got["pathway_tpu"]


# -- the sink outcomes of test_sink_chaos.py, with fakes that fail by themselves ----------------


def _table(pw, rows: int = 3):
    return pw.debug.table_from_rows(pw.schema_from_types(x=int, label=str),
                                    [(i, f"row-{i}") for i in range(rows)])


class _Failing:
    """Raises ``error()`` on the first ``times`` calls, then lets them through."""

    def __init__(self, times: int, error):
        self.left = times
        self.error = error

    def __call__(self) -> None:
        if self.left > 0:
            self.left -= 1
            raise self.error()


def _transient():
    return RuntimeError("transient: the client failed")


def _rejecting(pkg: str):
    rejected = importlib.import_module(f"{pkg}.io.delivery").SinkRejectedError
    return lambda: rejected("reject: the client refused row 0", row_indices=[0])


def _dlq(tmp_path, sink: str) -> list:
    path = tmp_path / "dlq" / f"{sink}.jsonl"
    return [json.loads(line) for line in path.open()] if path.exists() else []


def _run_sink(pkg: str, write) -> None:
    p = ns(pkg)
    p.pw.G.clear()
    try:
        write(p.pw)
        p.pw.run(**p.run)
    finally:
        p.pw.G.clear()


def _mongo(monkeypatch, fail):
    calls: list = []

    class Coll:
        def insert_many(self, docs):
            fail()
            calls.append([dict(d) for d in docs])

    coll = Coll()
    mod = types.ModuleType("pymongo")
    mod.MongoClient = lambda uri: {"db": {"events": coll}}
    monkeypatch.setitem(sys.modules, "pymongo", mod)
    return calls


class _PgConn:
    def __init__(self, fail_stage, fail_commit):
        self.staged: list = []
        self.committed: list = []
        self.rollbacks = 0
        self.fail_stage, self.fail_commit = fail_stage, fail_commit

    def cursor(self):
        conn = self

        class Cursor:
            def __enter__(self):
                return self

            def __exit__(self, *a):
                return False

            def execute(self, sql, params=None):
                conn.fail_stage()
                conn.staged.append((sql, list(params or [])))

            def executemany(self, sql, rows):
                conn.fail_stage()
                conn.staged.extend((sql, list(r)) for r in rows)

        return Cursor()

    def commit(self):
        self.fail_commit()
        self.committed.extend(self.staged)
        self.staged = []

    def rollback(self):
        self.rollbacks += 1
        self.staged = []

    def close(self):
        pass


def _pg(monkeypatch, fail_stage=lambda: None, fail_commit=lambda: None):
    conn = _PgConn(fail_stage, fail_commit)
    mod = types.ModuleType("psycopg")
    mod.connect = lambda **kw: conn
    monkeypatch.setitem(sys.modules, "psycopg", mod)
    return conn


def _es(monkeypatch, fail):
    indexed: list = []

    class Es:
        def __init__(self, **kw):
            pass

        def index(self, index, document):
            fail()
            indexed.append((index, dict(document)))

    mod = types.ModuleType("elasticsearch")
    mod.Elasticsearch = Es
    monkeypatch.setitem(sys.modules, "elasticsearch", mod)
    return indexed


def _outcome(pkg, tmp_path, sink, rows) -> tuple:
    entries = _dlq(tmp_path / pkg, sink)
    stats = importlib.import_module(f"{pkg}.io.delivery").sink_stats_snapshot()
    return (sorted(rows), [(e["row"], e["error"]) for e in entries],
            stats.get(sink, {}).get("dlq_total"))


def _each_package(monkeypatch, tmp_path, run_one) -> dict:
    out = {}
    for pkg in PACKAGES:
        monkeypatch.setenv("PATHWAY_SINK_DLQ_DIR", str(tmp_path / pkg / "dlq"))
        out[pkg] = run_one(pkg)
    assert out["pathway_tpu_torch"] == out["pathway_tpu"]
    return out["pathway_tpu_torch"]


def test_mongodb_transient_fail_twice_delivered_once(monkeypatch, tmp_path):
    def one(pkg):
        calls = _mongo(monkeypatch, _Failing(2, _transient))
        _run_sink(pkg, lambda pw: pw.io.mongodb.write(_table(pw), "mongodb://fake", "db",
                                                      "events"))
        return _outcome(pkg, tmp_path, "mongodb-db.events", [d["x"] for c in calls for d in c])

    rows, dead, _ = _each_package(monkeypatch, tmp_path, one)
    assert rows == [0, 1, 2] and dead == []  # once each, no dupes


def test_mongodb_reject_goes_to_dlq(monkeypatch, tmp_path):
    def one(pkg):
        calls = _mongo(monkeypatch, _Failing(1, _rejecting(pkg)))
        _run_sink(pkg, lambda pw: pw.io.mongodb.write(_table(pw), "mongodb://fake", "db",
                                                      "events", name="mongo-sink"))
        return _outcome(pkg, tmp_path, "mongo-sink", [d["x"] for c in calls for d in c])

    rows, dead, dlq_total = _each_package(monkeypatch, tmp_path, one)
    assert len(dead) == 1 and "reject" in dead[0][1] and dlq_total == 1
    assert sorted(rows + [dead[0][0]["x"]]) == [0, 1, 2]  # nothing silently dropped


def test_postgres_transient_fail_twice_delivered_once(monkeypatch, tmp_path):
    def one(pkg):
        conn = _pg(monkeypatch, fail_stage=_Failing(2, _transient))
        _run_sink(pkg, lambda pw: pw.io.postgres.write(_table(pw), {}, "tbl"))
        return _outcome(pkg, tmp_path, "postgres-tbl", [p[0] for _, p in conn.committed])

    rows, dead, _ = _each_package(monkeypatch, tmp_path, one)
    assert rows == [0, 1, 2] and dead == []


def test_postgres_reject_goes_to_dlq(monkeypatch, tmp_path):
    def one(pkg):
        conn = _pg(monkeypatch, fail_stage=_Failing(1, _rejecting(pkg)))
        _run_sink(pkg, lambda pw: pw.io.postgres.write(_table(pw), {}, "tbl", name="pg-sink"))
        return _outcome(pkg, tmp_path, "pg-sink", [p[0] for _, p in conn.committed])

    rows, dead, _ = _each_package(monkeypatch, tmp_path, one)
    assert len(dead) == 1 and dead[0][0]["label"].startswith("row-")
    assert sorted(rows + [dead[0][0]["x"]]) == [0, 1, 2]


def test_postgres_write_snapshot_retries_rollback_server_side(monkeypatch, tmp_path):
    """A commit that fails after its rows were staged rolls the transaction back before the
    retry: the committed rows appear once."""
    def one(pkg):
        conn = _pg(monkeypatch, fail_commit=_Failing(1, _transient))
        _run_sink(pkg, lambda pw: pw.io.postgres.write_snapshot(_table(pw), {}, "tbl", ["x"]))
        upserts = [p[0] for sql, p in conn.committed if "INSERT" in sql]
        return _outcome(pkg, tmp_path, "postgres-snapshot-tbl", upserts) + (conn.rollbacks,)

    rows, dead, _, rollbacks = _each_package(monkeypatch, tmp_path, one)
    assert rollbacks >= 1 and rows == [0, 1, 2] and dead == []


def test_elasticsearch_transient_fail_twice_delivered_once(monkeypatch, tmp_path):
    def one(pkg):
        indexed = _es(monkeypatch, _Failing(2, _transient))
        _run_sink(pkg, lambda pw: pw.io.elasticsearch.write(_table(pw), host="http://x",
                                                            index_name="idx"))
        assert all(i == "idx" for i, _ in indexed)
        return _outcome(pkg, tmp_path, "elasticsearch-idx", [d["x"] for _, d in indexed])

    rows, dead, _ = _each_package(monkeypatch, tmp_path, one)
    assert rows == [0, 1, 2] and dead == []


def test_elasticsearch_reject_goes_to_dlq(monkeypatch, tmp_path):
    def one(pkg):
        indexed = _es(monkeypatch, _Failing(1, _rejecting(pkg)))
        _run_sink(pkg, lambda pw: pw.io.elasticsearch.write(_table(pw), host="http://x",
                                                            index_name="idx", name="es-sink"))
        return _outcome(pkg, tmp_path, "es-sink", [d["x"] for _, d in indexed])

    rows, dead, _ = _each_package(monkeypatch, tmp_path, one)
    assert len(dead) == 1
    assert sorted(rows + [dead[0][0]["x"]]) == [0, 1, 2]


# -- http.read and http.write against a local server -------------------------------------------


class _Server:
    """A local HTTP server: GET streams ``lines`` as JSON lines; POST records each body."""

    def __init__(self, lines: list):
        posted = self.posted = []

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                body = "".join(json.dumps(x) + "\n" for x in lines).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                n = int(self.headers["Content-Length"])
                posted.append(json.loads(self.rfile.read(n)))
                self.send_response(200)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def log_message(self, *a):
                pass

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}/"
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()


@pytest.fixture
def _local_only(monkeypatch):
    for var in ("HTTP_PROXY", "HTTPS_PROXY", "ALL_PROXY", "http_proxy", "https_proxy",
                "all_proxy"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("NO_PROXY", "127.0.0.1,localhost")


def test_http_read_and_write_against_a_local_server(_local_only):
    lines = [{"word": w, "n": i} for i, w in enumerate(["ab", "cd", "ab", "ef", "ab"])]
    got = {}
    for pkg in PACKAGES:
        server = _Server(lines)
        side = Side(pkg)
        pw = side.pw
        try:
            pw.G.clear()
            t = pw.io.http.read(server.url, schema=pw.schema_from_types(word=str, n=int),
                                autocommit_duration_ms=None)
            counts = t.groupby(pw.this.word).reduce(pw.this.word, c=pw.reducers.count(),
                                                    s=pw.reducers.sum(pw.this.n))
            table, _ = side.run_table(counts)
            pw.G.clear()
            t = pw.io.http.read(server.url, schema=pw.schema_from_types(word=str, n=int),
                                autocommit_duration_ms=None)
            pw.io.http.write(t.groupby(pw.this.word).reduce(pw.this.word, c=pw.reducers.count(),
                                                            s=pw.reducers.sum(pw.this.n)),
                             server.url + "sink", name="http-sink")
            run_bounded(pw, 60, **ns(pkg).run)
        finally:
            pw.G.clear()
            server.close()
        net = Counter()
        for body in server.posted:
            net[(body["word"], body["c"], body["s"])] += body["diff"]
        got[pkg] = ({int(k): norm(tuple(r)) for k, r in table.items()}, +net)
    assert got["pathway_tpu_torch"] == got["pathway_tpu"]
    assert got["pathway_tpu"][1] == Counter({("ab", 3, 6): 1, ("cd", 1, 1): 1, ("ef", 1, 3): 1})


# -- streaming programs: SQLite CDC and Delta Lake ---------------------------------------------


class _Live:
    """``on_change`` keeping a table's final rows {key: row}; fails on a negative multiplicity."""

    def __init__(self, names):
        self.names = names
        self.acc: Counter = Counter()
        self.lock = threading.Lock()

    def __call__(self, key, row, time, is_addition):
        with self.lock:
            self.acc[(int(key), tuple(row[c] for c in self.names))] += 1 if is_addition else -1

    def rows(self) -> dict:
        with self.lock:
            assert all(n >= 0 for n in self.acc.values()), -self.acc
            return {k: r for (k, r), n in self.acc.items() if n > 0}


def _wait_until(live: _Live, want_rows: set, timeout: float = 60.0) -> None:
    deadline = time.monotonic() + timeout
    while set(live.rows().values()) != want_rows:
        assert time.monotonic() < deadline, "the tick of the last write did not come"
        time.sleep(0.02)


def _per_auction(pw, t):
    q1 = t.select(pw.this.auction, pw.this.price, price_eur=pw.this.price * 0.908)
    return q1.groupby(pw.this.auction).reduce(pw.this.auction, n=pw.reducers.count(),
                                              top=pw.reducers.max(pw.this.price_eur),
                                              s=pw.reducers.sum(pw.this.price))


BIDS = [(i, i % 7, (i * 7919) % 1000 + 100) for i in range(240)]
#: the writes, each (rows inserted or replaced, keys deleted): inserts, then updates and deletes,
#: then a key deleted before inserted again
SQL_WRITES = [(BIDS[:80], []), (BIDS[80:160], []),
              ([(i, a, p + 1) for i, a, p in BIDS[:160:5]], list(range(3, 160, 9))),
              (BIDS[160:], [0, 5, 170]), ([(3, 2, 999), (170, 6, 5)], list(range(200, 240, 3)))]


def _final_after(writes) -> dict:
    rows: dict = {}
    for upserts, deletes in writes:
        rows.update({r[0]: r for r in upserts})
        for i in deletes:
            rows.pop(i, None)
    return rows


def _sqlite_program(pkg: str, work, workers: int, async_exec: str | None, monkeypatch,
                    stream: list | None = None) -> dict:
    """The SQLite CDC program on a fresh database; returns its final tables (the bids, the per
    auction aggregate). ``stream`` gets each tick's updates of the bids as (time, key, row, diff)."""
    p = ns(pkg)
    pw = p.pw
    db = str(work / f"{pkg}-{workers}-{async_exec}.db")
    con = sqlite3.connect(db, check_same_thread=False)
    con.execute("PRAGMA journal_mode=WAL")
    con.execute("CREATE TABLE bids (i INTEGER PRIMARY KEY, auction INTEGER, price INTEGER)")
    con.commit()
    pw.G.clear()
    schema = pw.schema_builder({"i": pw.column_definition(dtype=int, primary_key=True),
                                "auction": pw.column_definition(dtype=int),
                                "price": pw.column_definition(dtype=int)})
    t = pw.io.sqlite.read(db, "bids", schema, mode="streaming")
    raw, agg = _Live(["i", "auction", "price"]), _Live(["auction", "n", "top", "s"])
    pw.io.subscribe(t, on_change=raw)
    pw.io.subscribe(_per_auction(pw, t), on_change=agg)
    if stream is not None:
        pw.io.subscribe(t, on_change=lambda key, row, time, is_addition: stream.append(
            (time, int(key), (row["i"], row["auction"], row["price"]), 1 if is_addition else -1)))
    errors: list = []

    def writer():
        try:
            for k, (upserts, deletes) in enumerate(SQL_WRITES):
                con.executemany("INSERT OR REPLACE INTO bids VALUES (?, ?, ?)", upserts)
                con.executemany("DELETE FROM bids WHERE i = ?", [(i,) for i in deletes])
                con.commit()
                _wait_until(raw, set(_final_after(SQL_WRITES[:k + 1]).values()))
            _wait_until(agg, set(_plain_per_auction(_final_after(SQL_WRITES).values())))
        except BaseException as e:
            errors.append(e)
        finally:
            pw.request_stop()

    monkeypatch.setenv("PATHWAY_THREADS", str(workers))
    if async_exec is not None:
        monkeypatch.setenv("PATHWAY_ASYNC_EXEC", async_exec)
    th = threading.Thread(target=writer, daemon=True)
    try:
        th.start()
        run_bounded(pw, 120, **p.run)
    finally:
        th.join(60)
        con.close()
        monkeypatch.setenv("PATHWAY_THREADS", "1")
        monkeypatch.delenv("PATHWAY_ASYNC_EXEC", raising=False)
        pw.G.clear()
    if errors:
        raise errors[0]
    return {"bids": raw.rows(), "per_auction": agg.rows()}


def _plain_per_auction(rows) -> set:
    out: dict = {}
    for _, a, price in rows:
        n, top, s = out.get(a, (0, float("-inf"), 0))
        out[a] = (n + 1, max(top, price * 0.908), s + price)
    return {(a,) + v for a, v in out.items()}


DELTA_NAMES = ["i", "auction", "price"]


def _delta_writes(writer_cls, uri):
    """Versions 1-3 inserts; 4 retracts and replaces rows through the ``diff`` column; 5 removes
    version 2's file; 6 inserts again."""
    from types import SimpleNamespace

    w = writer_cls(uri, DELTA_NAMES, None, min_commit_frequency_ms=None)

    def add(rows, diffs, time_):
        w.add_batch(time_, SimpleNamespace(data={c: [r[j] for r in rows]
                                                 for j, c in enumerate(DELTA_NAMES)},
                                           diffs=diffs))
        w.flush()

    steps = []
    for k in range(3):
        part = BIDS[k * 60:(k + 1) * 60]
        steps.append(lambda part=part, k=k: add(part, [1] * len(part), 2 * k + 2))
    changed = BIDS[:60:4]
    steps.append(lambda: add(changed + [(i, a, p + 3) for i, a, p in changed],
                             [-1] * len(changed) + [1] * len(changed), 8))
    steps.append(lambda: w._commit_actions([{"remove": {"path": _file_of(uri, 2),
                                                        "dataChange": True}}]))
    steps.append(lambda: add(BIDS[180:], [1] * 60, 12))
    return steps


def _file_of(uri: str, version: int) -> str:
    with open(os.path.join(uri, "_delta_log", f"{version:020d}.json")) as f:
        return next(json.loads(x)["add"]["path"] for x in f if '"add"' in x)


def _delta_states() -> list[set]:
    """The table's rows after each of ``_delta_writes``' steps."""
    rows: Counter = Counter()
    states = []
    changed = BIDS[:60:4]
    for k in range(3):
        rows.update(BIDS[k * 60:(k + 1) * 60])
        states.append(set(+rows))
    rows.subtract(changed)
    rows.update((i, a, p + 3) for i, a, p in changed)
    states.append(set(+rows))
    rows.subtract(BIDS[60:120])
    states.append(set(+rows))
    rows.update(BIDS[180:])
    states.append(set(+rows))
    return states


def _delta_program(pkg: str, work, workers: int, async_exec: str | None, monkeypatch) -> dict:
    """The Delta Lake program: version 0 and 1 written before the run, the rest while the
    streaming read runs; returns its final tables."""
    p = ns(pkg)
    pw = p.pw
    writer_cls = importlib.import_module(f"{pkg}.io.deltalake").DeltaTableWriter
    uri = str(work / f"{pkg}-{workers}-{async_exec}-delta")
    steps = _delta_writes(writer_cls, uri)
    states = _delta_states()
    steps[0]()
    pw.G.clear()
    t = pw.io.deltalake.read(uri, schema=pw.schema_from_types(i=int, auction=int, price=int),
                             mode="streaming", autocommit_duration_ms=20)
    raw, agg = _Live(DELTA_NAMES), _Live(["auction", "n", "top", "s"])
    pw.io.subscribe(t, on_change=raw)
    pw.io.subscribe(_per_auction(pw, t), on_change=agg)
    errors: list = []

    def writer():
        try:
            _wait_until(raw, states[0])
            for step, state in zip(steps[1:], states[1:]):
                step()
                _wait_until(raw, state)
            _wait_until(agg, _plain_per_auction(states[-1]))
        except BaseException as e:
            errors.append(e)
        finally:
            pw.request_stop()

    monkeypatch.setenv("PATHWAY_THREADS", str(workers))
    if async_exec is not None:
        monkeypatch.setenv("PATHWAY_ASYNC_EXEC", async_exec)
    th = threading.Thread(target=writer, daemon=True)
    try:
        th.start()
        run_bounded(pw, 120, **p.run)
    finally:
        th.join(60)
        monkeypatch.setenv("PATHWAY_THREADS", "1")
        monkeypatch.delenv("PATHWAY_ASYNC_EXEC", raising=False)
        pw.G.clear()
    if errors:
        raise errors[0]
    return {"bids": raw.rows(), "per_auction": agg.rows()}


PROGRAMS = {"sqlite": _sqlite_program, "delta": _delta_program}
_REFERENCE: dict = {}


def _reference(prog: str, tmp_path_factory, monkeypatch) -> dict:
    if prog not in _REFERENCE:
        work = tmp_path_factory.mktemp(f"reference-{prog}")
        _REFERENCE[prog] = PROGRAMS[prog]("pathway_tpu", work, 1, None, monkeypatch)
    return _REFERENCE[prog]


@pytest.mark.parametrize("prog", list(PROGRAMS))
def test_streaming_one_worker(prog, tmp_path, tmp_path_factory, monkeypatch):
    want = _reference(prog, tmp_path_factory, monkeypatch)
    assert want["bids"] and want["per_auction"]
    assert PROGRAMS[prog]("pathway_tpu_torch", tmp_path, 1, None, monkeypatch) == want


@pytest.mark.parametrize("workers,async_exec", [(2, None), (4, None), (2, "0")],
                         ids=["2-async", "4-async", "2-bsp"])
@pytest.mark.parametrize("prog", list(PROGRAMS))
def test_streaming_sharded_equals_the_reference_one_worker(prog, workers, async_exec, tmp_path,
                                                           tmp_path_factory, monkeypatch):
    want = _reference(prog, tmp_path_factory, monkeypatch)
    assert PROGRAMS[prog]("pathway_tpu_torch", tmp_path, workers, async_exec,
                          monkeypatch) == want


# -- one package writes, the other reads -------------------------------------------------------


@pytest.mark.parametrize("writer,reader", [PACKAGES, PACKAGES[::-1]],
                         ids=["reference-to-port", "port-to-reference"])
def test_a_delta_table_written_by_one_package_reads_in_the_other(writer, reader, tmp_path):
    """``pw.io.deltalake.write`` of a stream with retractions by ``writer``; the static read of
    each package over it, and the reader's streaming source over it, give equal tables."""
    uri = str(tmp_path / "table")
    w = ns(writer)
    pw = w.pw
    pw.G.clear()
    batches = [({"i": [r[0] for r in BIDS[s:s + 60]], "auction": [r[1] for r in BIDS[s:s + 60]],
                 "price": [r[2] for r in BIDS[s:s + 60]]}, 1) for s in range(0, 240, 60)]
    batches.append(({"i": [r[0] for r in BIDS[::9]], "auction": [r[1] for r in BIDS[::9]],
                     "price": [r[2] for r in BIDS[::9]]}, -1))

    class Feed(pw.io.python.ConnectorSubject):
        def run(self):
            for cols, diff in batches:
                self.next_batch(cols, diffs=[diff] * len(cols["i"]))
                self.commit()

    src = pw.io.python.read(Feed(), schema=pw.schema_from_types(i=int, auction=int, price=int),
                            autocommit_duration_ms=None)
    pw.io.deltalake.write(src, uri, min_commit_frequency=None)
    try:
        pw.run(**w.run)
    finally:
        pw.G.clear()
    want = {r for r in BIDS if r not in BIDS[::9]}
    tables = {}
    for pkg in PACKAGES:
        side = Side(pkg)
        side.pw.G.clear()
        try:
            table, _ = side.run_table(side.pw.io.deltalake.read(uri, mode="static"))
        finally:
            side.pw.G.clear()
        tables[pkg] = {int(k): norm(tuple(r)) for k, r in table.items()}
    assert tables["pathway_tpu_torch"] == tables["pathway_tpu"]
    assert set(tables[reader].values()) == want
    streamed = {}
    for pkg in PACKAGES:
        source = importlib.import_module(f"{pkg}.io.deltalake").DeltaStreamSource(
            uri, DELTA_NAMES, poll_interval_s=0)
        net: Counter = Counter()
        for d in source.poll():
            for key, row, diff in d.iter_rows():
                net[(int(key), norm(tuple(row)))] += int(diff)
        assert all(n in (0, 1) for n in net.values())
        streamed[pkg] = {k: r for (k, r), n in net.items() if n > 0}
    assert streamed["pathway_tpu_torch"] == streamed["pathway_tpu"]
    assert set(streamed[reader].values()) == want


def _envelopes(stream: list) -> list:
    """A SQLite change stream (time, key, row, diff) as Debezium envelopes, a tick's retraction
    and insertion under one key an update."""
    by_tick: dict = {}
    for t, key, row, diff in stream:
        by_tick.setdefault(t, {}).setdefault(key, {})[diff] = dict(zip(DELTA_NAMES, row))
    out = []
    for t in sorted(by_tick):
        for key, change in by_tick[t].items():
            before, after = change.get(-1), change.get(1)
            op = "u" if before and after else ("c" if after else "d")
            payload = {"op": op}
            if before:
                payload["before"] = before
            if after:
                payload["after"] = after
            out.append(json.dumps({"payload": payload}))
    return out


@pytest.mark.parametrize("writer,reader", [PACKAGES, PACKAGES[::-1]],
                         ids=["reference-to-port", "port-to-reference"])
def test_debezium_envelopes_of_one_package_read_by_the_other(writer, reader, tmp_path,
                                                            monkeypatch):
    """``writer``'s SQLite change stream as Debezium envelopes; ``reader``'s
    ``pw.io.debezium.read`` of them ends at the writer's final table of bids, key by key."""
    stream: list = []
    final = _sqlite_program(writer, tmp_path, 1, None, monkeypatch, stream=stream)["bids"]
    path = tmp_path / "cdc.jsonl"
    path.write_text("\n".join(_envelopes(stream)) + "\n")
    r = ns(reader)
    pw = r.pw
    pw.G.clear()
    schema = pw.schema_builder({"i": pw.column_definition(dtype=int, primary_key=True),
                                "auction": pw.column_definition(dtype=int),
                                "price": pw.column_definition(dtype=int)})
    t = pw.io.debezium.read(input_file=str(path), schema=schema, autocommit_duration_ms=None)
    raw = _Live(DELTA_NAMES)
    pw.io.subscribe(t, on_change=raw)
    try:
        run_bounded(pw, 60, **r.run)
    finally:
        pw.G.clear()
    assert raw.rows() == final


# -- the gated connectors ----------------------------------------------------------------------


def _airbyte_docker_yaml(tmp_path) -> str:
    path = tmp_path / "connection.yaml"
    path.write_text("source:\n  docker_image: airbyte/source-faker\n  config: {}\n")
    return str(path)


#: (connector, client modules blocked, the call)
GATED = [
    ("kafka.read", ("confluent_kafka",),
     lambda pw, t, d: pw.io.kafka.read({"bootstrap.servers": "x"}, "topic")),
    ("kafka.write", ("confluent_kafka",),
     lambda pw, t, d: pw.io.kafka.write(t, {"bootstrap.servers": "x"}, "topic")),
    ("redpanda.read", ("confluent_kafka",),
     lambda pw, t, d: pw.io.redpanda.read({"bootstrap.servers": "x"}, "topic")),
    ("debezium.read (kafka)", ("confluent_kafka",),
     lambda pw, t, d: pw.io.debezium.read(rdkafka_settings={"bootstrap.servers": "x"},
                                          topic_name="t", schema=pw.schema_from_types(x=int))),
    ("postgres.write", ("psycopg", "psycopg2"),
     lambda pw, t, d: pw.io.postgres.write(t, {}, "tbl")),
    ("postgres.write_snapshot", ("psycopg", "psycopg2"),
     lambda pw, t, d: pw.io.postgres.write_snapshot(t, {}, "tbl", ["x"])),
    ("mongodb.write", ("pymongo",),
     lambda pw, t, d: pw.io.mongodb.write(t, "mongodb://x", "db", "coll")),
    ("elasticsearch.write", ("elasticsearch",),
     lambda pw, t, d: pw.io.elasticsearch.write(t, host="x", index_name="i")),
    ("nats.read", ("nats",),
     lambda pw, t, d: pw.io.nats.read("nats://x:4222", "topic", format="plaintext")),
    ("nats.write", ("nats",), lambda pw, t, d: pw.io.nats.write(t, "nats://x:4222", "topic")),
    ("airbyte.read (docker)", ("airbyte_serverless",),
     lambda pw, t, d: pw.io.airbyte.read(_airbyte_docker_yaml(d), ["users"])),
    ("bigquery.write", ("google.cloud", "google.oauth2"),
     lambda pw, t, d: pw.io.bigquery.write(t, "ds", "tbl")),
    ("gdrive.read", ("googleapiclient", "google.oauth2"),
     lambda pw, t, d: pw.io.gdrive.read("folder-id")),
    ("s3.read", ("boto3",), lambda pw, t, d: pw.io.s3.read("s3://bucket/x")),
    ("minio.read", ("boto3",),
     lambda pw, t, d: pw.io.minio.read("path", minio_settings=pw.io.minio.MinIOSettings(
         endpoint="http://127.0.0.1:1", bucket_name="b", access_key="k",
         secret_access_key="s"))),
    ("sharepoint.read", ("office365",),
     lambda pw, t, d: pw.xpacks.connectors.sharepoint.read(
         "https://example.sharepoint.com/sites/x", tenant="t", client_id="c", cert_path="p",
         thumbprint="tp", root_path="Shared Documents")),
]


@pytest.mark.parametrize("label,blocked,call", GATED, ids=[g[0] for g in GATED])
def test_a_gated_connector_raises_the_reference_message(label, blocked, call, monkeypatch,
                                                        tmp_path):
    for mod in blocked:
        monkeypatch.setitem(sys.modules, mod, None)
    messages = {}
    for pkg in PACKAGES:
        pw = importlib.import_module(pkg)
        importlib.import_module(f"{pkg}.xpacks.connectors")
        pw.G.clear()
        t = pw.debug.table_from_rows(pw.schema_from_types(x=int), [(1,)])
        try:
            with pytest.raises(ImportError) as e:
                call(pw, t, tmp_path)
        finally:
            pw.G.clear()
        messages[pkg] = str(e.value)
    assert messages["pathway_tpu_torch"] == messages["pathway_tpu"]
    assert "requires the" in messages["pathway_tpu_torch"]


@pytest.mark.parametrize("label,call", [
    ("http.read", lambda pw, t: pw.io.http.read("http://127.0.0.1:1/",
                                                schema=pw.schema_from_types(x=int))),
    ("http.write", lambda pw, t: pw.io.http.write(t, "http://127.0.0.1:1/")),
    ("logstash.write", lambda pw, t: pw.io.logstash.write(t, "http://127.0.0.1:1/")),
], ids=["http.read", "http.write", "logstash.write"])
def test_http_without_requests_raises_the_gate_message(label, call, monkeypatch):
    """The reference imports ``requests`` unguarded; the port gates it as the other clients."""
    import pathway_tpu_torch as pw

    monkeypatch.setitem(sys.modules, "requests", None)
    pw.G.clear()
    t = pw.debug.table_from_rows(pw.schema_from_types(x=int), [(1,)])
    feature = "pw.io.http.read" if label == "http.read" else "pw.io.http.write"
    try:
        with pytest.raises(ImportError, match=f"^{feature} requires the 'requests' package"):
            call(pw, t)
    finally:
        pw.G.clear()


def test_the_connectors_import_without_their_clients_and_without_the_reference():
    blocked = sorted({m for _, mods, _ in GATED for m in mods} | {"requests", "fs"})
    code = (
        "import sys\n"
        f"for m in {blocked!r}:\n"
        "    sys.modules[m] = None\n"
        "sys.modules['jax'] = None\n"
        "import pathway_tpu_torch as pw\n"
        "import pathway_tpu_torch.xpacks.connectors.sharepoint\n"
        "from pathway_tpu_torch import demo\n"
        "for n in pw.io.__all__:\n"
        "    getattr(pw.io, n)\n"
        "assert pw.demo is demo and 'demo' in pw.__all__\n"
        "bad = [m for m in sys.modules if m == 'pathway_tpu' or m.startswith('pathway_tpu.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_the_port_io_lists_the_reference_connectors():
    import pathway_tpu
    import pathway_tpu_torch

    import pathway_tpu_torch.xpacks.connectors  # noqa: F401

    assert pathway_tpu_torch.io.__all__ == pathway_tpu.io.__all__
    for name in pathway_tpu.io.__all__:
        assert hasattr(pathway_tpu_torch.io, name), name
    assert pathway_tpu_torch.xpacks.connectors.__all__ == ["sharepoint"]
