"""The frontier-driven async plane of the port (``parallel/asyncplane.py``, ``LocalComm``'s async
plane, ``Exchange``'s async branch, the executor's async loop with its commit waves, the delivery
sinks' boundary-only acks) against the JAX package's, on the CPU.

- The loop selection (``tests/test_async_exec.py:50-66``): a sharded streaming run over
  ``LocalComm`` is async by default, ``PATHWAY_ASYNC_EXEC=0`` restores BSP, a run over
  ``MeshComm`` stays BSP unless ``=1`` (and then posts through the inner ``LocalComm``: no
  device collective runs), one worker and static runs never go async.
- Parity: ``tests/test_async_exec.py``'s streaming programs at 1, 2 and 4 workers, async and BSP,
  fusion on and off, give the same final table as the JAX package's run of the same
  configuration (exact multisets). Their tables do not depend on arrival order within a tick.
- The plane itself on one event sequence in both packages: the dedup by sequence number,
  ``hold_above``, backpressure, frontier and status merging, the vote log, the poisoned plane.
- A commit wave that cannot collect every ready clock raises, in both packages.
- A strict ``ix`` at 2 and 4 workers, async and BSP, gives the reference's 1-worker table: the
  port's end-of-stream check keys both its inputs by the probe row, where the reference's raises a
  false ``KeyError`` (``ROADMAP.md`` Queue 3, item 19). A key that is really missing still raises
  at 1, 2 and 4 workers.
- Exactly-once under async: a persisted transactional csv at 2 workers, in child processes,
  across a stop and a restart, and across a SIGKILL; every leg ran commit waves. Only the port
  runs these: the reference's transactional csv writes nothing in a restarted async run
  (``ROADMAP.md`` Queue 3, "Not port faults").
- A store written under async at 2 workers, rescaled offline to 1 and run on: the csv holds each
  count once and the final table equals the JAX package's over the same words.

Every run has a time limit. Tolerances: tables, counts and rows exact.
"""

from __future__ import annotations

import csv
import importlib
import json
import os
import signal
import subprocess
import sys
import textwrap
import threading
import time
from collections import Counter

import pytest

from torch_io_runs import run_bounded
from torch_state_runs import ns, reset_state_tiers, stream_run

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = ("pathway_tpu", "pathway_tpu_torch")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in ("PATHWAY_ASYNC_EXEC", "PATHWAY_MESH_EXCHANGE", "PATHWAY_FUSION",
                "PATHWAY_ASYNC_QUEUE_BATCHES", "PATHWAY_COLLECTIVE_TIMEOUT_S"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("PATHWAY_THREADS", "1")


# -- the loop selection ------------------------------------------------------------------------


def _executor(pkg: str, n_workers: int = 2, mesh: bool = False, comm: bool = True):
    comm_mod = importlib.import_module(f"{pkg}.parallel.comm")
    ex_mod = importlib.import_module(f"{pkg}.engine.executor")
    c = comm_mod.LocalComm(n_workers) if comm else None
    if mesh:
        if pkg == "pathway_tpu_torch":
            from pathway_tpu_torch.parallel.meshcomm import MeshComm

            c = MeshComm(c, device="cpu")
        else:
            c.exchange_deltas = lambda *a, **k: []  # quacks like MeshComm, as the reference's test
    ex = ex_mod.Executor.__new__(ex_mod.Executor)
    ex.ctx = comm_mod.WorkerContext(0, n_workers, c)
    return ex


@pytest.mark.parametrize("mesh", [False, True], ids=["local", "mesh"])
@pytest.mark.parametrize("env", [None, "0", "1", "false", "off", "no", "yes", "true"])
def test_selection_follows_the_reference(monkeypatch, env, mesh):
    if env is not None:
        monkeypatch.setenv("PATHWAY_ASYNC_EXEC", env)
    want = (not mesh) if env is None else env not in ("0", "false", "no", "off")
    assert _executor("pathway_tpu_torch", mesh=mesh)._use_async() is want
    assert _executor("pathway_tpu", mesh=mesh)._use_async() is want


@pytest.mark.parametrize("env", [None, "1"])
def test_one_worker_and_no_comm_never_go_async(monkeypatch, env):
    if env is not None:
        monkeypatch.setenv("PATHWAY_ASYNC_EXEC", env)
    for pkg in PACKAGES:
        assert not _executor(pkg, n_workers=1)._use_async()
        assert not _executor(pkg, comm=False)._use_async()


def _spy_loops(monkeypatch, ex_mod) -> Counter:
    calls: Counter = Counter()
    for name in ("_stream_loop_sharded", "_stream_loop_sharded_async", "_async_commit_wave"):
        orig = getattr(ex_mod.Executor, name)

        def spy(self, *a, _orig=orig, _name=name, **k):
            calls[_name] += 1
            return _orig(self, *a, **k)

        monkeypatch.setattr(ex_mod.Executor, name, spy)
    return calls


def test_static_runs_never_go_async(monkeypatch):
    p = ns("pathway_tpu_torch")
    calls = _spy_loops(monkeypatch, p.ex)
    monkeypatch.setenv("PATHWAY_ASYNC_EXEC", "1")
    monkeypatch.setenv("PATHWAY_THREADS", "2")
    p.pw.G.clear()
    t = p.pw.debug.table_from_markdown("w\na\nb\na\nc\na")
    got = p.pw.debug.table_to_pandas(t.groupby(p.pw.this.w).reduce(
        p.pw.this.w, n=p.pw.reducers.count()), device="cpu")
    p.pw.G.clear()
    assert dict(zip(got["w"], got["n"])) == {"a": 3, "b": 1, "c": 1}
    assert not calls


@pytest.mark.parametrize("env,want_async", [(None, False), ("1", True)])
def test_mesh_exchange_run_stays_bsp_unless_asked(monkeypatch, env, want_async):
    """Over ``MeshComm`` the default is BSP with the device collective as record exchange; with
    ``PATHWAY_ASYNC_EXEC=1`` the posts go through the inner ``LocalComm`` and the collective
    (the ``bucket_exchange`` kernel on the card) moves no row: only the END_TIME flush sweep,
    lock-step in both modes, enters it, with nothing to send."""
    from pathway_tpu_torch.engine.mesh_exchange import MeshExchangeRunner

    p = ns("pathway_tpu_torch")
    calls = _spy_loops(monkeypatch, p.ex)
    collectives = Counter()
    orig = MeshExchangeRunner.note_collective

    def counting(self, rows):
        collectives["exchange_deltas"] += 1
        return orig(self, rows)

    monkeypatch.setattr(MeshExchangeRunner, "note_collective", counting)
    if env is not None:
        monkeypatch.setenv("PATHWAY_ASYNC_EXEC", env)
    final, _ = stream_run(p, _count_words, [{"word": _WORDS[s:s + 40]} for s in range(0, 200, 40)],
                          2, mesh=True, schema={"word": str})
    assert sorted(final.values()) == sorted(Counter(_WORDS[:200]).items())
    assert (calls["_stream_loop_sharded_async"] == 2) is want_async
    assert (calls["_stream_loop_sharded"] == 0) is want_async
    assert (collectives["exchange_deltas"] == 0) is want_async


# -- parity with the JAX package ---------------------------------------------------------------

_WORDS = [f"w{(i * 7) % 53}" for i in range(4_000)]


def _count_words(pw, t):
    return t.groupby(pw.this.word).reduce(pw.this.word, c=pw.reducers.count())


def _wordcount_prog(pw):
    n, batch = 4_000, 250

    class Feed(pw.io.python.ConnectorSubject):
        def run(self):
            for s in range(0, n, batch):
                self.next_batch({"word": _WORDS[s:s + batch]})
                self.commit()

    t = pw.io.python.read(Feed(), schema=pw.schema_from_types(word=str),
                          autocommit_duration_ms=None)
    return _count_words(pw, t)


def _join_retract_prog(pw):
    # a streaming fact feed WITH retractions joined to a static dimension table, grouped —
    # ("column",) and ("mix",) exchange routes plus negative diffs through the async data plane
    right = pw.debug.table_from_rows(pw.schema_from_types(rid=int, grp=int),
                                     [(i, i % 5) for i in range(40)])

    class Facts(pw.io.python.ConnectorSubject):
        def run(self):
            for i in range(600):
                self.next(fid=i % 40, seq=i)
                if i % 7 == 3:
                    self._remove(fid=(i - 3) % 40, seq=i - 3)
                if i % 25 == 24:
                    self.commit()
            self.commit()

    facts = pw.io.python.read(Facts(), schema=pw.schema_from_types(fid=int, seq=int),
                              autocommit_duration_ms=None)
    joined = facts.join(right, facts.fid == right.rid).select(grp=right.grp, seq=facts.seq)
    return joined.groupby(pw.this.grp).reduce(
        pw.this.grp, n=pw.reducers.count(), s=pw.reducers.sum(pw.this.seq))


def _filter_ix_prog(pw):
    # a filtered stream read back through an optional ix on a static table: the ("key",) route,
    # a stateless filter between two exchanges, and a pointer lookup. Optional: the reference's
    # strict ix raises a false KeyError at 2 workers (``ROADMAP.md`` Queue 3, "Not port
    # faults"); the port's strict ix is held by ``_strict_ix_prog`` below
    labels = pw.debug.table_from_rows(pw.schema_from_types(k=int, label=str),
                                      [(i, f"l{i % 3}") for i in range(30)])
    labels = labels.with_id_from(labels.k)

    class Feed(pw.io.python.ConnectorSubject):
        def run(self):
            for s in range(0, 900, 60):
                self.next_batch({"k": [i % 30 for i in range(s, s + 60)],
                                 "v": list(range(s, s + 60))})
                self.commit()

    t = pw.io.python.read(Feed(), schema=pw.schema_from_types(k=int, v=int),
                          autocommit_duration_ms=None)
    kept = t.filter(pw.this.v % 4 != 1)
    named = kept.select(pw.this.v, label=labels.ix(labels.pointer_from(kept.k), optional=True).label)
    return named.groupby(pw.this.label).reduce(
        pw.this.label, n=pw.reducers.count(), top=pw.reducers.max(pw.this.v))


PROGRAMS = {"wordcount": _wordcount_prog, "join_retract": _join_retract_prog,
            "filter_ix": _filter_ix_prog}


def _strict_ix_prog(pw, missing: bool = False):
    # 300 rows in 5 commits read through a strict ix on a 30-row static table; with
    # ``missing``, one row of the third commit points at a key the table does not hold
    labels = pw.debug.table_from_rows(pw.schema_from_types(k=int, label=str),
                                      [(i, f"l{i % 3}") for i in range(30)])
    labels = labels.with_id_from(labels.k)

    class Feed(pw.io.python.ConnectorSubject):
        def run(self):
            for s in range(0, 300, 60):
                ks = [(i * 7) % 30 for i in range(s, s + 60)]
                if missing and s == 120:
                    ks[5] = 31
                self.next_batch({"k": ks, "v": list(range(s, s + 60))})
                self.commit()

    t = pw.io.python.read(Feed(), schema=pw.schema_from_types(k=int, v=int),
                          autocommit_duration_ms=None)
    return t.select(pw.this.v, label=labels.ix(labels.pointer_from(t.k)).label)


def _final_table(pkg: str, prog, monkeypatch, threads: int, async_exec: str, fusion: str):
    p = ns(pkg)
    pw = p.pw
    pw.G.clear()
    acc: Counter = Counter()
    lock = threading.Lock()
    table = prog(pw)
    cols = table.column_names()

    def on_change(key, row, time, is_addition):
        with lock:
            acc[tuple(row[c] for c in cols)] += 1 if is_addition else -1

    pw.io.subscribe(table, on_change=on_change)
    monkeypatch.setenv("PATHWAY_THREADS", str(threads))
    monkeypatch.setenv("PATHWAY_ASYNC_EXEC", async_exec)
    monkeypatch.setenv("PATHWAY_FUSION", fusion)
    try:
        run_bounded(pw, 120, **p.run)
    finally:
        monkeypatch.setenv("PATHWAY_THREADS", "1")
        pw.G.clear()
    assert all(v >= 0 for v in acc.values()), f"negative multiplicity: {acc}"
    return +acc


@pytest.mark.parametrize("workers,async_exec", [(1, "0"), (2, "0"), (2, "1"), (4, "0"),
                                                (4, "1")])
@pytest.mark.parametrize("fusion", ["1", "0"])
@pytest.mark.parametrize("prog", list(PROGRAMS))
def test_tables_equal_the_reference(monkeypatch, prog, fusion, workers, async_exec):
    ours = _final_table("pathway_tpu_torch", PROGRAMS[prog], monkeypatch, workers, async_exec,
                        fusion)
    theirs = _final_table("pathway_tpu", PROGRAMS[prog], monkeypatch, workers, async_exec, fusion)
    assert ours == theirs
    assert ours


@pytest.mark.parametrize("workers,async_exec", [(2, "1"), (2, "0"), (4, "1"), (4, "0")])
def test_strict_ix_sharded_equals_the_reference_one_worker(monkeypatch, workers, async_exec):
    """The strict ix's end-of-stream check keys both its inputs by the probe row (``ROADMAP.md``
    Queue 3, item 19): sharded, the port gives the reference's 1-worker table, where the
    reference's check raises a false KeyError."""
    want = _final_table("pathway_tpu", _strict_ix_prog, monkeypatch, 1, "0", "1")
    got = _final_table("pathway_tpu_torch", _strict_ix_prog, monkeypatch, workers, async_exec,
                       "1")
    assert got == want
    assert sum(got.values()) == 300 and len({label for _, label in got}) == 3


@pytest.mark.parametrize("workers,async_exec", [(1, "0"), (2, "1"), (2, "0"), (4, "1")])
def test_strict_ix_missing_key_still_raises(monkeypatch, workers, async_exec):
    prog = lambda pw: _strict_ix_prog(pw, missing=True)  # noqa: E731
    with pytest.raises(KeyError, match="1 row"):
        _final_table("pathway_tpu_torch", prog, monkeypatch, workers, async_exec, "1")
    if workers == 1:
        with pytest.raises(KeyError, match="1 row"):
            _final_table("pathway_tpu", prog, monkeypatch, workers, async_exec, "1")


def test_async_run_records_its_loop_and_exchange(monkeypatch):
    """A 2-worker wordcount under the default selection takes the async loop on both workers and
    moves rows through the plane: each worker's ``EngineStats`` counts exchanged rows, and the
    plane's sent and received data events balance."""
    p = ns("pathway_tpu_torch")
    seen: list = []
    orig = p.ex.Executor._stream_loop_sharded_async

    def spy(self, realtime, clock):
        from pathway_tpu_torch.parallel import asyncplane

        planes: list = []
        orig_init = asyncplane.AsyncPlane.__init__

        def keep(plane, *a, **k):
            orig_init(plane, *a, **k)
            planes.append(plane)

        with monkeypatch.context() as m:
            m.setattr(asyncplane.AsyncPlane, "__init__", keep)
            try:
                return orig(self, realtime, clock)
            finally:
                seen.append((self, planes[0]))

    monkeypatch.setattr(p.ex.Executor, "_stream_loop_sharded_async", spy)
    assert _final_table("pathway_tpu_torch", _wordcount_prog, monkeypatch, 2, "1", "1") \
        == +Counter(Counter(_WORDS).items())
    assert len(seen) == 2
    assert sum(ex.stats.exchange_rows_in for ex, _ in seen) > 0
    sent = sum(plane.sent_events for _, plane in seen)
    recv = sum(plane.recv_events for _, plane in seen)
    assert sent == recv > 0
    assert all(ex.ctx.async_plane is None for ex, _ in seen)  # the END sweep ran BSP


# -- the plane on one event sequence -----------------------------------------------------------


def _plane_trace(pkg: str, monkeypatch) -> list:
    comm_mod = importlib.import_module(f"{pkg}.parallel.comm")
    ap = importlib.import_module(f"{pkg}.parallel.asyncplane")
    monkeypatch.setenv("PATHWAY_ASYNC_QUEUE_BATCHES", "2")
    comm = comm_mod.LocalComm(2)
    a, b = ap.AsyncPlane(comm, 0, 2), ap.AsyncPlane(comm, 1, 2)
    out: list = [comm.supports_async()]
    out.append(a.post(7, 10, ["own", "x10"]))  # own slot: the caller's business
    out.append(a.post(7, 14, [None, "x14"]))
    out.append(a.post(7, 16, [None, None]))  # nothing to send: no sequence number spent
    out.append(a.congested())  # worker 1's inbox holds 2 data events: at the bound
    # a duplicated frame (the sender's sequence number 0 again) is dropped by the receiver
    comm.async_post_exchange(0, 7, 10, [None, "dup"], None, 0, None)
    out.append(b.drain())
    out.append(a.congested())
    b.hold_above = 12  # a commit wave at T=12: later arrivals wait for the next window
    out.append((b.take(7)[0], b.releasable(), b.take(7)[0], b.take(8)))
    b.hold_above = None
    out.append((b.releasable(), b.take(7)[0], b.releasable()))
    a.tracker.advance_local(20)
    a.broadcast_status({"ep": 0})
    a.broadcast_status({"vote": ("term", 0, 2, 0, True)})
    a.broadcast_status({"vote": ("cw1", 0, 2, 0, False)})
    out.append(a.broadcast_status({"ep": 1}, min_interval_s=3600.0))  # throttled
    b.drain()
    out.append((b.tracker.frontiers(), {k: v for k, v in b.peer_status[0].items()}))
    out.append((b.take_votes("term"), b.take_votes("term"), b.take_votes("cw1")))
    out.append((a.take_activity(), a.take_activity(), b.take_activity()))
    st = b.stats()
    out.append({k: st[k] for k in ("arrivals_pending", "sent_events", "recv_events", "frontier",
                                   "global_frontier")})
    out.append(a.stats()["sent_events"])
    out.append(sorted(comm.comm_stats()))
    comm.abort()
    with pytest.raises(RuntimeError, match="peer worker failed"):
        b.drain()
    with pytest.raises(RuntimeError, match="peer worker failed"):
        a.post(7, 30, [None, "late"])
    return out


def test_plane_dedup_hold_and_status_match_the_reference(monkeypatch):
    ours = _plane_trace("pathway_tpu_torch", monkeypatch)
    assert ours == _plane_trace("pathway_tpu", monkeypatch)
    assert ours[1:5] == [1, 1, 0, True]
    assert ours[7] == (["x10"], False, [], ([], None))
    assert ours[8] == (True, ["x14"], False)


def _timed_out_wave(pkg: str, monkeypatch) -> str:
    comm_mod = importlib.import_module(f"{pkg}.parallel.comm")
    ex_mod = importlib.import_module(f"{pkg}.engine.executor")
    ap = importlib.import_module(f"{pkg}.parallel.asyncplane")
    crit = importlib.import_module(f"{pkg}.observability.critpath")
    ex = ex_mod.Executor([], ctx=comm_mod.WorkerContext(0, 2, comm_mod.LocalComm(2)))
    plane = ap.AsyncPlane(ex.ctx.comm, 0, 2)
    ex.stats._waves = crit.WaveRecorder(0)
    ex._wave_mark = None
    ex._async_timeout_s = 0.05
    with pytest.raises(RuntimeError) as err:
        ex._async_commit_wave(plane, 100, 0)
    return str(err.value)


def test_a_commit_wave_that_times_out_raises(monkeypatch):
    msg = _timed_out_wave("pathway_tpu_torch", monkeypatch)
    assert msg == _timed_out_wave("pathway_tpu", monkeypatch)
    assert "commit wave 0 timed out collecting ready clocks (1/2; waiting on w1 (never heard)" \
        in msg


# -- exactly-once under async in child processes -----------------------------------------------

_CSV_PROGRAM = """
import json, os, sys, threading, time

import pathway_tpu_torch as pw
from pathway_tpu_torch.engine import executor as E
from pathway_tpu_torch.persistence import Backend, Config

out, pstate, n_words, waves_path = sys.argv[1], sys.argv[2], int(sys.argv[3]), sys.argv[4]
waves = []
lock = threading.Lock()
orig = E.Executor._async_commit_wave


def counting(self, plane, clock, epoch, fin=False):
    result = orig(self, plane, clock, epoch, fin)
    with lock:  # both worker threads record their waves here
        waves.append((self.ctx.worker_id, epoch))
        with open(waves_path + ".tmp", "w") as f:
            json.dump(waves, f)
        os.replace(waves_path + ".tmp", waves_path)
    return result


E.Executor._async_commit_wave = counting


class S(pw.io.python.ConnectorSubject):
    def run(self):
        for i in range(n_words):
            self.next(word=f"w{i % 5}")
            self.commit()
            time.sleep(0.01)


t = pw.io.python.read(S(), schema=pw.schema_from_types(word=str), name="src",
                      autocommit_ms=None)
counts = t.groupby(pw.this.word).reduce(pw.this.word, c=pw.reducers.count())
pw.io.csv.write(counts, out, name="out")
cfg = Config.simple_config(Backend.filesystem(pstate), snapshot_interval_ms=20)
pw.run(device="cpu", persistence_config=cfg)
"""


def _csv_rows(path) -> list:
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [(r["word"], int(r["c"]), int(r["time"]), int(r["diff"]))
                for r in csv.DictReader(f)]


def _assert_exactly_once(rows, n_words: int):
    assert len(rows) == len(set(rows)), rows  # no batch was delivered twice
    net: Counter = Counter()
    for w, c, _t, d in rows:
        net[(w, c)] += d
    want = Counter(f"w{i % 5}" for i in range(n_words))
    assert +net == Counter(dict.fromkeys(want.items(), 1)), net


def _child(tmp_path):
    prog = tmp_path / "prog.py"
    prog.write_text(textwrap.dedent(_CSV_PROGRAM))
    env = {**os.environ, "PYTHONPATH": ROOT, "PATHWAY_THREADS": "2",
           "PATHWAY_SINK_DLQ_DIR": str(tmp_path / "dlq")}
    for var in ("PATHWAY_ASYNC_EXEC", "PATHWAY_MESH_EXCHANGE"):
        env.pop(var, None)
    return prog, env


def _waves(path) -> list:
    with open(path) as f:
        return json.load(f)


def test_transactional_csv_exactly_once_across_a_stop(tmp_path):
    prog, env = _child(tmp_path)
    out, pstate = tmp_path / "counts.csv", tmp_path / "ps"
    for leg, n in enumerate((30, 60)):  # the second run's source seeks past the first 30 words
        waves = tmp_path / f"waves{leg}.json"
        subprocess.run([sys.executable, str(prog), str(out), str(pstate), str(n), str(waves)],
                       env=env, check=True, timeout=120)
        assert {w for w, _ in _waves(waves)} == {0, 1}  # both workers ran commit waves
        _assert_exactly_once(_csv_rows(out), n)


def test_transactional_csv_exactly_once_across_sigkill(tmp_path):
    prog, env = _child(tmp_path)
    out, pstate = tmp_path / "counts.csv", tmp_path / "ps"
    args = [sys.executable, str(prog), str(out), str(pstate), "60"]
    p = subprocess.Popen(args + [str(tmp_path / "waves0.json")], env=env)
    try:
        deadline = time.monotonic() + 60
        # a wave's release writes the rows before the child logs the wave: wait for both
        while time.monotonic() < deadline and (
                len(_csv_rows(out)) < 10 or not os.path.exists(tmp_path / "waves0.json")):
            if p.poll() is not None:
                raise AssertionError("program finished before the kill")
            time.sleep(0.01)
        os.kill(p.pid, signal.SIGKILL)
        p.wait(timeout=30)
    finally:
        if p.poll() is None:
            p.kill()
    assert _csv_rows(out), "the kill landed before any row was written"
    assert _waves(tmp_path / "waves0.json")  # killed after at least one commit wave
    subprocess.run(args + [str(tmp_path / "waves1.json")], env=env, check=True, timeout=120)
    _assert_exactly_once(_csv_rows(out), 60)


# -- a rescale of a store written under async --------------------------------------------------


def test_store_written_under_async_rescales(tmp_path, monkeypatch):
    reset_state_tiers(monkeypatch)
    words = [f"w{(i * 3) % 11}" for i in range(330)]
    batches = [{"word": words[s:s + 30]} for s in range(0, 330, 30)]
    p = ns("pathway_tpu_torch")
    calls = _spy_loops(monkeypatch, p.ex)
    store, out = str(tmp_path / "pstate"), str(tmp_path / "counts.csv")
    cfg = p.persistence.Config.simple_config(p.persistence.Backend.filesystem(store),
                                             snapshot_interval_ms=20)

    def with_csv(pw, t):
        counts = _count_words(pw, t)
        pw.io.csv.write(counts, out, name="counts")
        return counts

    stream_run(p, with_csv, batches[:6], 2, cfg, name="words", schema={"word": str})
    assert calls["_stream_loop_sharded_async"] == 2 and calls["_async_commit_wave"] >= 2
    report = p.rescale.rescale(p.backends.FilesystemBackend(store), 1, log=lambda msg: None)
    assert (report["from"], report["to"]) == (2, 1)
    final, _ = stream_run(p, with_csv, batches, 1, cfg, name="words", schema={"word": str})
    ref, _ = stream_run(ns("pathway_tpu"), _count_words, batches, 1, schema={"word": str})
    assert final == ref
    assert sorted(final.values()) == sorted(Counter(words).items())
    net: Counter = Counter()
    rows = [(r["word"], int(r["c"]), int(r["time"]), int(r["diff"]))
            for r in csv.DictReader(open(out))]
    assert len(rows) == len(set(rows))
    for w, c, _t, d in rows:
        net[(w, c)] += d
    assert +net == Counter(dict.fromkeys(Counter(words).items(), 1))


def test_async_stress_more_workers_than_cores(monkeypatch):
    """Eight async workers with a short switch interval, so the threads interleave inside the
    plane's and the inboxes' read-modify-write steps: a lost post, a lost count or a double
    delivery changes a count."""
    monkeypatch.setenv("PATHWAY_ASYNC_QUEUE_BATCHES", "4")  # backpressure engages too
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        got = _final_table("pathway_tpu_torch", _wordcount_prog, monkeypatch, 8, "1", "1")
    finally:
        sys.setswitchinterval(saved)
    assert got == +Counter(Counter(_WORDS).items())
