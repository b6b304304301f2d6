"""Crash recovery of the port (``pw.run(persistence_config=...)`` with ``device="cpu"``) against the
JAX package's, on the CPU.

- A SIGKILL mid-stream in a child process, then a restart over the same store
  (``tests/test_recovery_sigkill.py``): the final counts are exact in both packages.
- A seeded recovery fuzz at a small size (``tests/test_recovery_fuzz.py``): kills at random
  points, snapshot intervals jittered, at 1 worker, 4 sharded workers and 2 workers over the mesh
  exchange; every restart converges to the exact counts.
- A persisted ``pw.indexing`` program stopped and restored: the index engine comes back from its
  snapshot with the embedder grafted on, and the answers after the restart equal a run that was
  never stopped and the reference's (brute-force scores within one bf16 ulp,
  ``test_torch_indexing.assert_knn_close``).
- Exactly-once transactional csv output across a SIGKILL, and across a death between the first
  metadata commit and its release: the rows net of their diffs equal a clean run's, and no batch
  is written twice.
- A store the JAX package wrote makes the port raise, naming the store, without importing the
  reference (checked in a child whose imports of ``jax`` and ``pathway_tpu`` are blocked).
- A stopped and restarted persisted program delivers, summed over both runs net of diffs, what a
  clean run delivers. Before the port had persistence, ``persistence_config`` was ignored and the
  restart delivered the first run's output a second time.

Every operator-snapshot blob the port writes, in this process and in its child programs, is
checked to hold no tensor (``torch_persist_checks``). Every child process and every run has a
time limit. Tolerances: counts and rows exact; brute-force scores within one bf16 ulp.
"""

from __future__ import annotations

import csv
import importlib
import json
import os
import random
import signal
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

from test_torch_indexing import assert_knn_close
from torch_io_runs import run_bounded
from torch_persist_checks import guard_snapshot_blobs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = ("pathway_tpu", "pathway_tpu_torch")


@pytest.fixture(autouse=True)
def _snapshot_guard(monkeypatch):
    """Every operator-snapshot blob the port writes in this process holds no tensor."""
    return guard_snapshot_blobs(monkeypatch)


def _run_kw(pkg: str) -> str:
    return 'device="cpu", ' if pkg == "pathway_tpu_torch" else ""


def _guard(pkg: str) -> str:
    """The child program's first lines: in the port, every snapshot blob is checked for
    tensors (``torch_persist_checks.install_guard``)."""
    if pkg != "pathway_tpu_torch":
        return ""
    return (f"import sys; sys.path.insert(0, {os.path.join(ROOT, 'tests')!r})\n"
            "from torch_persist_checks import install_guard; install_guard()\n")


def _env(extra: dict | None = None) -> dict:
    return {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": ROOT, "PATHWAY_THREADS": "1",
            **(extra or {})}


# -- a SIGKILL mid-run --------------------------------------------------------------------------

_SIGKILL_PROGRAM = """
import json, sys, time

import {pkg} as pw
from {pkg}.persistence import Backend, Config

out_path, pstate = sys.argv[1], sys.argv[2]
WORDS = ["foo", "bar", "foo", "baz"] * 5  # foo:10 bar:5 baz:5


class S(pw.io.python.ConnectorSubject):
    def run(self):
        for w in WORDS:
            self.next(word=w)
            self.commit()
            time.sleep(0.03)


t = pw.io.python.read(S(), schema=pw.schema_from_types(word=str), name="words",
                      autocommit_ms=None)
counts = t.groupby(pw.this.word).reduce(pw.this.word, c=pw.reducers.count())
f = open(out_path, "a")


def on_change(key, row, time, is_addition):
    f.write(json.dumps([row["word"], int(row["c"]), bool(is_addition)]) + "\\n")
    f.flush()


pw.io.subscribe(counts, on_change=on_change)
cfg = Config.simple_config(Backend.filesystem(pstate), snapshot_interval_ms=20)
pw.run({run_kw}persistence_config=cfg)
"""


def _events(path) -> list:
    if not os.path.exists(path):
        return []
    out = []
    with open(path) as f:
        for line in f:
            try:  # the SIGKILL may tear the last line mid-write
                w, c, add = json.loads(line)
                out.append((w, int(c), bool(add)))
            except (json.JSONDecodeError, ValueError):
                pass
    return out


@pytest.mark.parametrize("pkg", PACKAGES)
def test_sigkill_mid_run_recovery(tmp_path, pkg):
    prog = tmp_path / "prog.py"
    prog.write_text(_guard(pkg) + textwrap.dedent(
        _SIGKILL_PROGRAM.format(pkg=pkg, run_kw=_run_kw(pkg))))
    out, pstate = tmp_path / "events.jsonl", tmp_path / "pstate"
    p = subprocess.Popen([sys.executable, str(prog), str(out), str(pstate)], env=_env())
    try:
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            if len([e for e in _events(out) if e[2]]) >= 6:
                break
            if p.poll() is not None:
                raise AssertionError("program finished before the kill")
            time.sleep(0.02)
        else:
            raise AssertionError(f"no progress before kill: {_events(out)}")
        os.kill(p.pid, signal.SIGKILL)
        p.wait(timeout=30)
    finally:
        if p.poll() is None:
            p.kill()
    persisted = [os.path.join(dp, f) for dp, _, fs in os.walk(pstate) for f in fs]
    assert any("meta" in pth for pth in persisted), persisted
    killed = {w: c for w, c, add in _events(out) if add}
    assert killed and killed != {"foo": 10, "bar": 5, "baz": 5}, killed
    subprocess.run([sys.executable, str(prog), str(out), str(pstate)], env=_env(), check=True,
                   timeout=120)
    assert {w: c for w, c, add in _events(out) if add} == {"foo": 10, "bar": 5, "baz": 5}


# -- the seeded fuzz ------------------------------------------------------------------------

_FUZZ_PROGRAM = """
import json, sys, time

import {pkg} as pw
from {pkg}.persistence import Backend, Config

out_path, pstate, n_rows, snap_ms, delay_ms = (
    sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), float(sys.argv[5]))
WORDS = [f"w{{i % 7}}" for i in range(n_rows)]


class S(pw.io.python.ConnectorSubject):
    def run(self):
        for w in WORDS:
            self.next(word=w)
            self.commit()
            if delay_ms:
                time.sleep(delay_ms / 1000.0)


t = pw.io.python.read(S(), schema=pw.schema_from_types(word=str), name="words",
                      autocommit_ms=None)
counts = t.groupby(pw.this.word).reduce(pw.this.word, c=pw.reducers.count())
f = open(out_path, "a")


def on_change(key, row, time, is_addition):
    if is_addition:
        f.write(json.dumps([row["word"], int(row["c"])]) + "\\n")
        f.flush()


pw.io.subscribe(counts, on_change=on_change)
cfg = Config.simple_config(Backend.filesystem(pstate), snapshot_interval_ms=snap_ms)
pw.run({run_kw}persistence_config=cfg)
"""

N_ROWS = 140  # 7 words x 20 each


@pytest.mark.parametrize("pkg,workers,mesh,seed", [
    ("pathway_tpu_torch", 1, False, 11), ("pathway_tpu_torch", 1, False, 12),
    ("pathway_tpu_torch", 4, False, 21), ("pathway_tpu_torch", 4, False, 22),
    ("pathway_tpu_torch", 2, True, 31),
    ("pathway_tpu", 1, False, 11), ("pathway_tpu", 2, True, 31),
])
def test_recovery_fuzz(tmp_path, pkg, workers, mesh, seed):
    rng = random.Random(seed)
    prog = tmp_path / "prog.py"
    prog.write_text(_guard(pkg) + textwrap.dedent(
        _FUZZ_PROGRAM.format(pkg=pkg, run_kw=_run_kw(pkg))))
    out, pstate = tmp_path / "events.jsonl", tmp_path / "pstate"
    snap_ms = rng.choice([5, 20, 60])
    delay_ms = 4.0
    env = _env({"PATHWAY_THREADS": str(workers), "PATHWAY_MESH_EXCHANGE": "1" if mesh else "0"})
    args = [sys.executable, str(prog), str(out), str(pstate), str(N_ROWS), str(snap_ms),
            str(delay_ms)]
    # a kill point anywhere in the stream's expected duration, counted from its first output
    # (the interpreter's start differs between the packages), including points before the
    # first snapshot and past the stream's end
    kill_after_s = rng.uniform(0.0, 1.2) * (N_ROWS * delay_ms / 1000.0)
    p = subprocess.Popen(args, env=env)
    try:
        deadline = time.monotonic() + 60
        while not out.exists() and p.poll() is None and time.monotonic() < deadline:
            time.sleep(0.005)
        t0 = time.monotonic()
        while time.monotonic() - t0 < kill_after_s and p.poll() is None:
            time.sleep(0.01)
        if p.poll() is None:
            os.kill(p.pid, signal.SIGKILL)
        p.wait(timeout=60)
    finally:
        if p.poll() is None:
            p.kill()
    subprocess.run(args, env=env, check=True, timeout=180)
    finals: dict = {}
    with open(out) as f:
        for line in f:
            try:
                w, c = json.loads(line)
                finals[w] = int(c)
            except (json.JSONDecodeError, ValueError):
                pass
    assert finals == {f"w{i}": 20 for i in range(7)}, (snap_ms, kill_after_s, finals)


# -- a persisted pw.indexing program, restored ------------------------------------------------

DIM = 16


def _text_vec(text: str) -> np.ndarray:
    """A deterministic text embedder: a vector seeded from the text's bytes."""
    seed = int.from_bytes(text.encode()[:8].ljust(8, b"\0"), "little")
    return np.random.default_rng(seed).standard_normal(DIM).astype(np.float32)


def _index_leg(pw, run_kw, cfg, vecs, commits: int, queries: list[str]) -> dict:
    """A ``DataIndex`` over the first ``commits`` commits of 16 vectors (a named python source),
    then, once every row is in, text queries through ``query_as_of_now``; the answers by query."""
    pw.G.clear()
    n_rows = 16 * commits
    run_mod = importlib.import_module(f"{pw.__name__}.internals.run")

    def held() -> int:
        # the running index's rows: the node's engine is the restored one after a recovery
        runner = run_mod._current["runner"]
        nodes = runner._nodes if runner is not None else []
        return max([len(n.engine._slots.key_to_slot) for n in nodes
                    if type(n).__name__ == "ExternalIndexNode"] or [0])

    class Rows(pw.io.python.ConnectorSubject):
        def run(self):
            for s in range(0, n_rows, 16):
                self.next_batch({"rid": list(range(s, s + 16)), "data": list(vecs[s:s + 16])})
                self.commit()

    class Queries(pw.io.python.ConnectorSubject):
        def run(self):
            deadline = time.monotonic() + 60
            while held() < n_rows and time.monotonic() < deadline:
                time.sleep(0.005)
            if queries:
                self.next_batch({"qid": list(range(len(queries))), "q": queries})
                self.commit()

    data = pw.io.python.read(Rows(), schema=pw.schema_from_types(rid=int, data=object),
                             autocommit_duration_ms=None, name="rows")
    qt = pw.io.python.read(Queries(), schema=pw.schema_from_types(qid=int, q=str),
                           autocommit_duration_ms=None, name="queries")
    factory = pw.indexing.BruteForceKnnFactory(dimensions=DIM, reserved_space=64,
                                               embedder=_text_vec)
    index = factory.build_index(data.data, data)
    res = index.query_as_of_now(qt.q, number_of_matches=3).select(
        qid=pw.left.qid, rid=pw.right.rid, score=pw.right._pw_index_reply_score)
    answers: dict = {}
    pw.io.subscribe(res, on_change=lambda key, row, time, is_addition: answers.__setitem__(
        row["qid"], (list(row["rid"]), [float(s) for s in row["score"]])) if is_addition else None)
    kw = {"persistence_config": cfg} if cfg is not None else {}
    run_bounded(pw, 60, **kw, **run_kw)
    pw.G.clear()
    return answers


def test_persisted_index_restored(tmp_path, _snapshot_guard):
    vecs = np.random.default_rng(5).standard_normal((64, DIM)).astype(np.float32)
    queries = ["alpha", "beta gamma", "delta"]
    got = {}
    checked = _snapshot_guard
    for pkg in PACKAGES:
        pw = importlib.import_module(pkg)
        ps = importlib.import_module(f"{pkg}.persistence")
        run_kw = {"device": "cpu"} if pkg == "pathway_tpu_torch" else {}
        cfg = ps.Config.simple_config(ps.Backend.filesystem(str(tmp_path / pkg)))
        # the first leg holds 48 rows and no query; the restart feeds all 64 and asks
        assert _index_leg(pw, run_kw, cfg, vecs, 3, []) == {}
        m = ps.PersistenceManager(cfg)
        assert any(d["cls"] == "ExternalIndexNode"
                   for d in m.op_snapshots[-1]["ops"].values())
        m.close()
        restored = _index_leg(pw, run_kw, cfg, vecs, 4, queries)
        clean = _index_leg(pw, run_kw, None, vecs, 4, queries)
        assert sorted(restored) == sorted(clean) == [0, 1, 2]
        for q in clean:
            assert_knn_close(restored[q][0], restored[q][1], clean[q][0], clean[q][1])
        got[pkg] = restored
    assert checked, "the port wrote no operator snapshot"
    for q in got["pathway_tpu"]:
        assert_knn_close(got["pathway_tpu_torch"][q][0], got["pathway_tpu_torch"][q][1],
                         got["pathway_tpu"][q][0], got["pathway_tpu"][q][1])


# -- exactly-once csv output -------------------------------------------------------------------

_CSV_PROGRAM = """
import os, sys, time

import {pkg} as pw
from {pkg}.persistence import Backend, Config

out, pstate = sys.argv[1], sys.argv[2]
if os.environ.get("DIE_AT_FIRST_RELEASE") == "1":
    from {pkg}.io.delivery import DeliveryManager

    def dying_on_commit(self, up_to_time):
        # the metadata commit (snapshot included) just landed; die before any release or ack
        os._exit(17)

    DeliveryManager.on_commit = dying_on_commit


class S(pw.io.python.ConnectorSubject):
    def run(self):
        for i in range(60):
            self.next(word=f"w{{i % 5}}")
            self.commit()
            time.sleep(0.01)


t = pw.io.python.read(S(), schema=pw.schema_from_types(word=str), name="src",
                      autocommit_ms=None)
counts = t.groupby(pw.this.word).reduce(pw.this.word, c=pw.reducers.count())
pw.io.csv.write(counts, out, name="out")
cfg = Config.simple_config(Backend.filesystem(pstate), snapshot_interval_ms=20)
pw.run({run_kw}persistence_config=cfg)
"""


def _csv_rows(path) -> list:
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [(r["word"], int(r["c"]), int(r["time"]), int(r["diff"]))
                for r in csv.DictReader(f)]


def _assert_exactly_once(rows):
    # no batch was delivered twice: each (row, time, diff) appears once
    assert len(rows) == len(set(rows)), rows
    net: dict = {}
    for w, c, _t, d in rows:
        net[(w, c)] = net.get((w, c), 0) + d
    assert {k: v for k, v in net.items() if v} == {(f"w{i}", 12): 1 for i in range(5)}, net


@pytest.mark.parametrize("pkg", PACKAGES)
def test_transactional_csv_exactly_once_across_sigkill(tmp_path, pkg):
    prog = tmp_path / "prog.py"
    prog.write_text(_guard(pkg) + textwrap.dedent(
        _CSV_PROGRAM.format(pkg=pkg, run_kw=_run_kw(pkg))))
    out, pstate = tmp_path / "counts.csv", tmp_path / "ps"
    env = _env({"PATHWAY_SINK_DLQ_DIR": str(tmp_path / "dlq")})
    p = subprocess.Popen([sys.executable, str(prog), str(out), str(pstate)], env=env)
    try:
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and len(_csv_rows(out)) < 10:
            if p.poll() is not None:
                raise AssertionError("program finished before the kill")
            time.sleep(0.01)
        os.kill(p.pid, signal.SIGKILL)
        p.wait(timeout=30)
    finally:
        if p.poll() is None:
            p.kill()
    before = _csv_rows(out)
    assert before, "the kill landed before any row was written"
    subprocess.run([sys.executable, str(prog), str(out), str(pstate)], env=env, check=True,
                   timeout=120)
    _assert_exactly_once(_csv_rows(out))


@pytest.mark.parametrize("pkg", PACKAGES)
def test_kill_between_first_commit_and_release_loses_nothing(tmp_path, pkg):
    """Death after the FIRST metadata commit but before its release: recovery replays the input
    log from scratch (restores nothing), so the never-released output still delivers once."""
    prog = tmp_path / "prog.py"
    prog.write_text(_guard(pkg) + textwrap.dedent(
        _CSV_PROGRAM.format(pkg=pkg, run_kw=_run_kw(pkg))))
    out, pstate = tmp_path / "counts.csv", tmp_path / "ps"
    env = _env({"PATHWAY_SINK_DLQ_DIR": str(tmp_path / "dlq")})
    p1 = subprocess.run([sys.executable, str(prog), str(out), str(pstate)],
                        env={**env, "DIE_AT_FIRST_RELEASE": "1"}, capture_output=True,
                        timeout=120)
    assert p1.returncode == 17, p1.stderr.decode(errors="replace")[-3000:]
    assert not _csv_rows(out)
    p2 = subprocess.run([sys.executable, str(prog), str(out), str(pstate)], env=env,
                        capture_output=True, timeout=120)
    assert p2.returncode == 0, p2.stderr.decode(errors="replace")[-3000:]
    _assert_exactly_once(_csv_rows(out))


# -- a store the JAX package wrote -------------------------------------------------------------

_PORT_ON_FOREIGN_STORE = """
import importlib.abc, sys

sys.modules["jax"] = None


class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "pathway_tpu" or name.startswith("pathway_tpu."):
            raise ImportError("blocked: " + name)
        return None


sys.meta_path.insert(0, Block())

import pathway_tpu_torch as pw
from pathway_tpu_torch.persistence import Backend, Config
from pathway_tpu_torch.persistence.snapshots import PersistenceFormatError

pstate = sys.argv[1]
{program}
try:
    pw.run(device="cpu", persistence_config=Config.simple_config(Backend.filesystem(pstate)))
except PersistenceFormatError as e:
    assert pstate in str(e) and "pathway_tpu." in str(e), str(e)
    assert not any(m == "pathway_tpu" or m.startswith("pathway_tpu.") for m in sys.modules
                   if sys.modules[m] is not None)
    print("REFUSED")
"""

_JOIN_PROGRAM = """
class L(pw.io.python.ConnectorSubject):
    def run(self):
        for i in range(8):
            self.next(k=i, a=f"l{i}")
            self.commit()


lt = pw.io.python.read(L(), schema=pw.schema_from_types(k=int, a=str), name="left",
                       autocommit_ms=None)
rt = pw.debug.table_from_rows(pw.schema_from_types(k=int, b=str),
                              [(i, f"r{i}") for i in range(0, 8, 2)])
pw.io.subscribe(lt.join(rt, lt.k == rt.k).select(pw.this.a, pw.this.b),
                on_change=lambda **kw: None)
"""


def test_port_refuses_a_store_the_jax_package_wrote(tmp_path):
    import pathway_tpu as rpw
    from pathway_tpu.persistence import Backend, Config

    pstate = str(tmp_path / "ps")
    rpw.G.clear()
    exec(textwrap.dedent(_JOIN_PROGRAM), {"pw": rpw})
    rpw.run(persistence_config=Config.simple_config(Backend.filesystem(pstate)))
    rpw.G.clear()
    proc = subprocess.run(
        [sys.executable, "-c", _PORT_ON_FOREIGN_STORE.format(program=_JOIN_PROGRAM), pstate],
        env=_env(), capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "REFUSED" in proc.stdout


# -- the fault the port had before persistence -------------------------------------------------


def _net_stream(pw, run_kw, cfg, words) -> dict:
    pw.G.clear()

    class S(pw.io.python.ConnectorSubject):
        def run(self):
            for w in words:
                self.next(word=w)
                self.commit()

    t = pw.io.python.read(S(), schema=pw.schema_from_types(word=str), name="words")
    counts = t.groupby(pw.this.word).reduce(pw.this.word, c=pw.reducers.count())
    net: dict = {}

    def on_change(key, row, time, is_addition):
        k = (row["word"], int(row["c"]))
        net[k] = net.get(k, 0) + (1 if is_addition else -1)

    pw.io.subscribe(counts, on_change=on_change)
    kw = {"persistence_config": cfg} if cfg is not None else {}
    run_bounded(pw, 60, **kw, **run_kw)
    pw.G.clear()
    return net


@pytest.mark.parametrize("pkg", PACKAGES)
def test_restarted_program_delivers_what_a_clean_run_does(tmp_path, pkg):
    pw = importlib.import_module(pkg)
    ps = importlib.import_module(f"{pkg}.persistence")
    run_kw = {"device": "cpu"} if pkg == "pathway_tpu_torch" else {}
    words = ["foo", "bar", "foo", "baz", "foo", "bar", "qux", "foo", "bar", "baz"]
    cfg = ps.Config.simple_config(ps.Backend.filesystem(str(tmp_path / "ps")))
    total: dict = {}
    for part in (_net_stream(pw, run_kw, cfg, words[:6]), _net_stream(pw, run_kw, cfg, words)):
        for k, v in part.items():
            total[k] = total.get(k, 0) + v
    clean = _net_stream(pw, run_kw, None, words)
    assert {k: v for k, v in total.items() if v} == {k: v for k, v in clean.items() if v} == {
        ("foo", 4): 1, ("bar", 3): 1, ("baz", 2): 1, ("qux", 1): 1}
