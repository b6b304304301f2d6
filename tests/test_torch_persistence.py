"""The port's persistence (``pathway_tpu_torch.persistence``, the executor's recovery, the sources'
offsets and the transactional delivery plane) against the JAX package's, on the CPU: the cases of
``tests/test_persistence.py`` and the persistence-gated cases of ``tests/test_delivery.py``, each
run through both packages (the port with ``device="cpu"``), which must give the same results.

- Key-value round trips of the memory, filesystem and faked-S3 backends, worker namespaces, and
  each backend's ``describe``.
- Recovery of the python subject and of the fs tail stream: a persisted program run, stopped and
  run again with more input gives the reference's update stream (replayed ticks suppressed, counts
  continued), at 1 worker and sharded at 2 and 4 workers over ``LocalComm`` and ``MeshComm``.
- Restart in O(state): operator snapshots written, input chunks truncated once covered.
- Offsets: the python source counts only delivered rows; the tail stream's truncation, partial
  lines, and a resumed stream that re-reads neither a counted row nor a partial last line; the
  close flush pinned to the delivery boundary.
- The cluster marker: a worker-count mismatch names the store's location, a crashed first boot is
  adopted, ``PATHWAY_ELASTIC=1`` raises in the port (rescale is not ported).
- The ack cursor and the commit protocol of ``DeliverySink`` and ``DeliveryManager``.

Every operator-snapshot blob the port writes is checked to hold no tensor and no module
(``torch_persist_checks.guard_snapshot_blobs``). Tolerance: none; every result compares exactly.
Every streaming run has a time limit of its own.
"""

from __future__ import annotations

import importlib
import json
import os
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from torch_io_runs import run_bounded
from torch_persist_checks import FakeS3Client, guard_snapshot_blobs

PACKAGES = ("pathway_tpu", "pathway_tpu_torch")
WORDS = ["foo", "bar", "foo", "baz", "foo", "bar", "qux", "foo", "bar", "baz"]


@pytest.fixture(params=PACKAGES)
def p(request, monkeypatch):
    pkg = request.param
    ns = SimpleNamespace(
        name=pkg,
        pw=importlib.import_module(pkg),
        ps=importlib.import_module(f"{pkg}.persistence"),
        backends=importlib.import_module(f"{pkg}.persistence.backends"),
        dlv=importlib.import_module(f"{pkg}.io.delivery"),
        Delta=importlib.import_module(f"{pkg}.engine.delta").Delta,
        fs=importlib.import_module(f"{pkg}.io.fs"),
        pysrc=importlib.import_module(f"{pkg}.io.python"),
        run={"device": "cpu"} if pkg == "pathway_tpu_torch" else {},
        checked=None,
    )
    if pkg == "pathway_tpu_torch":
        ns.checked = guard_snapshot_blobs(monkeypatch)
    ns.pw.G.clear()
    ns.dlv._reset_stats_for_tests()
    yield ns
    ns.pw.G.clear()
    ns.dlv._reset_stats_for_tests()


def _emitter(p, words, upto):
    class Emitter(p.pw.io.python.ConnectorSubject):
        """Deterministic stream: emits ``words[:upto]``, one commit per row."""

        def run(self):
            for w in words[:upto]:
                self.next(word=w)
                self.commit()

    return Emitter()


def _word_pipeline(p, subject):
    t = p.pw.io.python.read(subject, schema=p.pw.schema_from_types(word=str), name="words")
    return t.groupby(p.pw.this.word).reduce(p.pw.this.word, c=p.pw.reducers.count())


def _persisted_wordcount(p, cfg, upto: int) -> list:
    """One persisted run of the word pipeline over ``WORDS[:upto]``; its update stream as
    (word, count, is_addition) in arrival order."""
    p.pw.G.clear()
    seen: list = []
    counts = _word_pipeline(p, _emitter(p, WORDS, upto))
    p.pw.io.subscribe(counts, on_change=lambda key, row, time, is_addition:
                      seen.append((row["word"], int(row["c"]), is_addition)))
    run_bounded(p.pw, 60, persistence_config=cfg, **p.run)
    return seen


def _finals(seen) -> dict:
    return {w: c for w, c, add in seen if add}


# -- backends -------------------------------------------------------------------------------


def test_backend_kv_roundtrip(p, tmp_path):
    b = p.backends.FilesystemBackend(tmp_path / "kv")
    b.put_value("meta/meta-00000001", b"hello")
    b.put_value("chunks/chunk-00000000", b"\x00\x01")
    assert b.get_value("meta/meta-00000001") == b"hello"
    assert b.list_keys() == ["chunks/chunk-00000000", "meta/meta-00000001"]
    b.remove_key("meta/meta-00000001")
    assert b.list_keys() == ["chunks/chunk-00000000"]
    m = p.backends.MemoryBackend()
    m.put_value("a/b", b"x")
    assert m.list_keys() == ["a/b"] and m.get_value("a/b") == b"x"
    assert m.size_of("a/b") == 1


def test_s3_backend_kv_roundtrip(p):
    client = FakeS3Client(page_size=2)
    b = p.backends.S3Backend("s3://state-bucket/pipeline/a", client=client)
    b.put_value("meta/offsets", b"o1")
    b.put_value("snap/chunk-0", b"c0")
    b.put_value("snap/chunk-1", b"c1")
    b.put_value("snap/chunk-2", b"c2")
    # paginated listing (page_size 2 forces the continuation loop)
    assert b.list_keys() == ["meta/offsets", "snap/chunk-0", "snap/chunk-1", "snap/chunk-2"]
    assert b.get_value("snap/chunk-1") == b"c1"
    b.put_value("snap/chunk-1", b"c1v2")  # overwrite
    assert b.get_value("snap/chunk-1") == b"c1v2"
    b.remove_key("snap/chunk-0")
    assert "snap/chunk-0" not in b.list_keys()
    with pytest.raises(KeyError):
        b.get_value("snap/chunk-0")
    # prefix isolation: another pipeline's state is invisible
    assert p.backends.S3Backend("s3://state-bucket/pipeline/b", client=client).list_keys() == []


def test_s3_backend_sharded_worker_namespaces(p):
    client = FakeS3Client()
    shared = p.backends.S3Backend("s3://pstate/cluster", client=client)
    w0 = p.backends.PrefixBackend(shared, "worker-0/")
    w1 = p.backends.PrefixBackend(shared, "worker-1/")
    w0.put_value("snap", b"zero")
    w1.put_value("snap", b"one")
    assert w0.get_value("snap") == b"zero"
    assert w1.get_value("snap") == b"one"
    assert w0.list_keys() == ["snap"]
    assert shared.list_keys() == ["worker-0/snap", "worker-1/snap"]


def test_backend_describe_locations(p, tmp_path):
    b = p.backends
    fs = b.FilesystemBackend(tmp_path / "x")
    assert str(tmp_path / "x") == fs.describe()
    assert b.PrefixBackend(fs, "worker-1/").describe().endswith("worker-1/")
    assert b.MemoryBackend("named").describe() == "memory://named"
    assert b.S3Backend("s3://bucket/pre", client=object()).describe() == "s3://bucket/pre/"


def test_open_backend_by_kind(p, tmp_path):
    B = p.ps.Backend
    assert type(p.backends.open_backend(B.filesystem(str(tmp_path / "f")))).__name__ == \
        "FilesystemBackend"
    assert type(p.backends.open_backend(B.memory("k"))).__name__ == "MemoryBackend"
    assert type(p.backends.open_backend(B.s3("s3://b/x", _client=FakeS3Client()))).__name__ == \
        "S3Backend"
    with pytest.raises(ValueError, match="unknown persistence backend"):
        p.backends.open_backend(B("tape"))


# -- recovery through pw.run -------------------------------------------------------------------


def _recovery_streams(p, cfg) -> tuple[list, list]:
    seen1 = _persisted_wordcount(p, cfg, 6)
    seen2 = _persisted_wordcount(p, cfg, 10)
    return seen1, seen2


def _assert_reference_recovery(seen1, seen2):
    assert _finals(seen1) == {"foo": 3, "bar": 2, "baz": 1}
    # replayed times are suppressed: only the 4 new rows' updates emitted
    assert {w for w, _, add in seen2 if add} == {"qux", "foo", "bar", "baz"}
    # counts continue from the persisted state — no double counting
    assert _finals(seen2) == {"foo": 4, "bar": 3, "baz": 2, "qux": 1}
    assert [c for w, c, add in seen2 if w == "foo" and add] == [4]


def test_python_subject_recovery_memory_backend(p):
    p.backends.MemoryBackend.drop("t1")
    cfg = p.ps.Config.simple_config(p.ps.Backend.memory("t1"))
    seen1, seen2 = _recovery_streams(p, cfg)
    _assert_reference_recovery(seen1, seen2)
    # the whole update stream, in order, is the reference's (the JAX run asserts it too)
    assert seen2 == [("qux", 1, True), ("foo", 4, True), ("foo", 3, False), ("bar", 3, True),
                     ("bar", 2, False), ("baz", 2, True), ("baz", 1, False)]
    if p.checked is not None:
        assert p.checked, "no operator snapshot was written"


def test_s3_backend_streaming_recovery(p):
    client = FakeS3Client(page_size=3)
    cfg = p.ps.Config.simple_config(p.ps.Backend.s3("s3://pstate/wordcount", _client=client))
    seen1, seen2 = _recovery_streams(p, cfg)
    assert client.objects  # snapshots actually landed in the object store
    _assert_reference_recovery(seen1, seen2)


def test_filesystem_backend_recovery(p, tmp_path):
    cfg = p.ps.Config.simple_config(p.ps.Backend.filesystem(str(tmp_path / "ps")))
    seen1, seen2 = _recovery_streams(p, cfg)
    _assert_reference_recovery(seen1, seen2)
    # a third run with no new input replays nothing and emits nothing
    assert _persisted_wordcount(p, cfg, 10) == []


def test_operator_snapshots_make_restart_o_of_state(p):
    """With operator snapshots, restart restores state directly and replays only the input
    tail — the full history is neither kept nor re-read."""
    p.backends.MemoryBackend.drop("opsnap")
    cfg = p.ps.Config.simple_config(p.ps.Backend.memory("opsnap"))
    _persisted_wordcount(p, cfg, 6)

    m = p.ps.PersistenceManager(cfg)
    times = m.available_op_times()
    assert times, "commit must write an operator snapshot catalog"
    # everything recorded is covered by the newest snapshot: zero tail
    assert list(m.replay_batches(after_time=max(times))) == []
    # input chunks below the oldest retained snapshot were truncated
    store = p.backends.MemoryBackend("opsnap")._store
    chunk_keys = [k for k in store if k.startswith("chunks/")]
    assert all(int(k.rsplit("-", 1)[1]) >= m._first_chunk for k in chunk_keys)
    newest = m.op_snapshots[-1]["ops"]
    assert any(d["cls"] == "GroupByReduce" for d in newest.values())
    assert all(d.get("fmt") == "parts" for d in newest.values()
               if d["cls"] == "GroupByReduce")

    # restart: correctness must come from restored state, not replay
    seen2 = _persisted_wordcount(p, cfg, 10)
    assert _finals(seen2) == {"foo": 4, "bar": 3, "baz": 2, "qux": 1}
    assert [c for w, c, add in seen2 if w == "foo" and add] == [4]


@pytest.mark.parametrize("workers,mesh", [(2, False), (4, False), (2, True), (4, True)])
def test_sharded_persistence_recovery(p, monkeypatch, workers, mesh):
    """Per-worker namespaces, coordinated snapshot commits, lock-step tail replay; a different
    worker count against the state is refused."""
    name = f"shard-{workers}-{int(mesh)}"
    p.backends.MemoryBackend.drop(name)
    cfg = p.ps.Config.simple_config(p.ps.Backend.memory(name))
    monkeypatch.setenv("PATHWAY_THREADS", str(workers))
    monkeypatch.setenv("PATHWAY_MESH_EXCHANGE", "1" if mesh else "0")
    seen1, seen2 = _recovery_streams(p, cfg)
    _assert_reference_recovery(seen1, seen2)
    keys = p.backends.MemoryBackend(name).list_keys()
    assert {k.split("/")[0] for k in keys if k.startswith("worker-")} == {
        f"worker-{w}" for w in range(workers)}

    monkeypatch.setenv("PATHWAY_THREADS", str(workers + 1))
    p.pw.G.clear()
    counts = _word_pipeline(p, _emitter(p, WORDS, 10))
    p.pw.io.subscribe(counts, on_change=lambda **kw: None)
    with pytest.raises(RuntimeError, match=f"{workers} worker"):
        p.pw.run(persistence_config=cfg, **p.run)


def _fs_run_until(p, data_dir: str, cfg, n_events: int) -> list:
    """A persisted streaming wordcount over a csv directory, stopped once ``n_events`` additions
    arrived (and their commit tick finished)."""
    p.pw.G.clear()
    seen: list = []
    done = threading.Event()
    t = p.pw.io.fs.read(data_dir, format="csv", schema=p.pw.schema_from_types(word=str),
                        mode="streaming", name="words")
    counts = t.groupby(p.pw.this.word).reduce(p.pw.this.word, c=p.pw.reducers.count())

    def on_change(key, row, time, is_addition):
        seen.append((row["word"], int(row["c"]), is_addition))
        if sum(1 for _, _, add in seen if add) >= n_events:
            done.set()

    p.pw.io.subscribe(counts, on_change=on_change)

    def stopper():
        done.wait(timeout=30)
        time.sleep(0.3)  # let the commit tick finish
        p.pw.request_stop()

    th = threading.Thread(target=stopper, daemon=True)
    th.start()
    run_bounded(p.pw, 60, persistence_config=cfg, **p.run)
    th.join(5)
    return seen


def test_fs_streaming_recovery(p, tmp_path):
    """Stream a csv directory, stop, add data while the engine is down, restart: old rows are
    not re-read (offsets) and old output is not re-emitted."""
    data = tmp_path / "data"
    data.mkdir()
    cfg = p.ps.Config.simple_config(p.ps.Backend.filesystem(os.fspath(tmp_path / "pstate")))
    (data / "a.csv").write_text("word\nfoo\nbar\nfoo\n")
    seen1 = _fs_run_until(p, os.fspath(data), cfg, 2)
    assert _finals(seen1) == {"foo": 2, "bar": 1}
    with (data / "a.csv").open("a") as f:
        f.write("baz\n")
    (data / "b.csv").write_text("word\nfoo\n")
    seen2 = _fs_run_until(p, os.fspath(data), cfg, 2)
    final2 = _finals(seen2)
    assert final2.get("baz") == 1
    assert final2.get("foo") == 3
    assert all(w in ("baz", "foo") for w, _, _ in seen2)


# -- offsets ----------------------------------------------------------------------------------


def test_python_source_offset_counts_only_delivered_rows(p):
    """Offset must not cover rows still buffered (pre-commit) — a persisted offset past
    unsnapshotted input would lose them on recovery."""

    class S(p.pysrc.ConnectorSubject):
        def run(self):
            pass

    s = S()
    src = p.pysrc.PythonSubjectSource(s, ["word"], {}, None, autocommit_ms=10_000_000)
    s.next(word="a")
    s.next(word="b")
    assert src.poll() == []  # drained into the partial buffer, not committed
    assert src.offset_state() == {"rows": 0}
    s.commit()
    deltas = src.poll()
    assert len(deltas) == 1 and len(deltas[0]) == 2
    assert src.offset_state() == {"rows": 2}
    # a restarted source seeks past the delivered rows: the same subject's first two rows
    # are skipped, the third is new
    s2 = S()
    src2 = p.pysrc.PythonSubjectSource(s2, ["word"], {}, None, autocommit_ms=10_000_000)
    src2.seek(src.offset_state())
    for w in ("a", "b", "c"):
        s2.next(word=w)
    s2.commit()
    (d,) = src2.poll()
    assert list(d.data["word"]) == ["c"]
    assert src2.offset_state() == {"rows": 3}


def test_fs_stream_truncation_and_partial_lines(p, tmp_path):
    f = tmp_path / "log.csv"
    f.write_text("word\nfoo\nbar\n")
    src = p.fs.FsStreamSource(os.fspath(tmp_path), "csv", None, ["word"], autocommit_ms=None)
    (d,) = src.poll()
    assert len(d) == 2

    # partial (no trailing newline) line is not consumed until completed
    with f.open("a") as h:
        h.write("ba")
    assert src.poll() == []
    with f.open("a") as h:
        h.write("z\n")
    (d,) = src.poll()
    assert list(d.data["word"]) == ["baz"]

    # truncation/rotation: shorter rewrite is re-read from scratch
    f.write_text("word\nqux\n")
    (d,) = src.poll()
    assert list(d.data["word"]) == ["qux"]


def test_fs_stream_resume_skips_counted_rows_and_partial_lines(p, tmp_path):
    """A tail stream restarted from its persisted offsets re-reads no delivered row, keeps the
    header, and still waits for a partial last line to complete."""
    f = tmp_path / "log.csv"
    f.write_text("word\nfoo\nbar\nba")
    src = p.fs.FsStreamSource(os.fspath(tmp_path), "csv", None, ["word"], autocommit_ms=None)
    (d,) = src.poll()
    assert list(d.data["word"]) == ["foo", "bar"]
    state = json.loads(json.dumps(src.offset_state()))  # as the metadata stores it
    assert state == {"files": {os.fspath(f): len("word\nfoo\nbar\n")}}

    resumed = p.fs.FsStreamSource(os.fspath(tmp_path), "csv", None, ["word"],
                                  autocommit_ms=None)
    resumed.seek(state)
    assert resumed.poll() == []  # only the partial line lies past the offset
    with f.open("a") as h:
        h.write("z\nqux\n")
    (d,) = resumed.poll()
    assert list(d.data["word"]) == ["baz", "qux"]
    assert resumed.offset_state()["files"][os.fspath(f)] == f.stat().st_size


def test_close_flush_pins_offsets_to_delivery_boundary(p):
    """A crash mid-cycle must not persist the live offset: close() flushes exactly the last
    delivery-boundary prefix with the offsets snapshotted there."""
    p.backends.MemoryBackend.drop("boundary")
    cfg = p.ps.Config.simple_config(p.ps.Backend.memory("boundary"),
                                    snapshot_interval_ms=3_600_000)
    m = p.ps.PersistenceManager(cfg)

    class FakeSource:
        persistent_id = "s"
        rows = 0

        def offset_state(self):
            return {"rows": self.rows}

    def row_delta():
        return p.Delta(keys=np.array([1], dtype=np.uint64),
                       data={"w": np.array(["x"], dtype=object)})

    src = FakeSource()
    m.begin_recording([src])
    src.rows = 1
    m.record(10, "s", row_delta())
    m.on_time_end(10)
    m.note_delivery_boundary()
    # the source hands out two more rows; the first is recorded at a tick that dies mid-sweep,
    # the second's round never runs
    src.rows = 3
    m.record(12, "s", row_delta())
    m.close()

    m2 = p.ps.PersistenceManager(cfg)
    assert m2.offset_for("s") == {"rows": 1}  # not the live 3
    assert [t for t, _pid, _d in m2.replay_batches()] == [10]
    m2.close()


# -- the cluster marker ----------------------------------------------------------------------


def test_cluster_marker_mismatch_names_backend_location(p, tmp_path):
    path = str(tmp_path / "pstate")
    cfg = p.ps.Config.simple_config(p.ps.Backend.filesystem(path))
    m = p.ps.PersistenceManager(cfg, worker_id=0, n_workers=2)
    root = p.backends.FilesystemBackend(path)
    root.put_value("worker-0/meta/meta-00000000", b'{"last_time": 4}')
    m.close()
    with pytest.raises(RuntimeError) as ei:
        p.ps.PersistenceManager(cfg, worker_id=0, n_workers=3)
    msg = str(ei.value)
    assert path in msg, msg
    assert "2 worker(s)" in msg and "has 3" in msg


def test_cluster_marker_tolerates_crashed_first_boot(p, tmp_path):
    path = str(tmp_path / "pstate")
    cfg = p.ps.Config.simple_config(p.ps.Backend.filesystem(path))
    p.backends.FilesystemBackend(path).put_value("cluster", b'{"n_workers": 4}')
    m = p.ps.PersistenceManager(cfg, worker_id=0, n_workers=2)  # no raise
    m.close()
    assert json.loads(p.backends.FilesystemBackend(path).get_value("cluster")) == {
        "n_workers": 2}
    p.backends.FilesystemBackend(path).put_value("worker-0/meta/meta-00000000",
                                                 b'{"last_time": 0}')
    with pytest.raises(RuntimeError, match="2 worker"):
        p.ps.PersistenceManager(cfg, worker_id=0, n_workers=4)


def test_elastic_rescale_is_not_ported(tmp_path, monkeypatch):
    """The port refuses ``PATHWAY_ELASTIC=1`` against a mismatched layout and names the
    roadmap item; without it, the reference's refusal."""
    from pathway_tpu_torch.persistence import Backend, Config, PersistenceManager
    from pathway_tpu_torch.persistence.backends import FilesystemBackend

    path = str(tmp_path / "pstate")
    cfg = Config.simple_config(Backend.filesystem(path))
    PersistenceManager(cfg, worker_id=0, n_workers=2).close()
    FilesystemBackend(path).put_value("worker-0/meta/meta-00000000", b'{"last_time": 0}')
    monkeypatch.setenv("PATHWAY_ELASTIC", "1")
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        PersistenceManager(cfg, worker_id=0, n_workers=3)
    monkeypatch.delenv("PATHWAY_ELASTIC")
    with pytest.raises(RuntimeError, match="2 worker"):
        PersistenceManager(cfg, worker_id=0, n_workers=3)


# -- the transactional delivery plane --------------------------------------------------------


def _batch(p, vals):
    return p.Delta(keys=np.arange(len(vals), dtype=np.uint64), data={"x": np.asarray(vals)},
                   diffs=np.ones(len(vals), dtype=np.int64))


def _sink(p, fn, tmp_path, *, backend=None, transactional=False, queue_batches=8, name="t"):
    return p.dlv.DeliverySink(
        p.dlv.CallableAdapter(fn, name), name,
        policy=p.dlv.RetryPolicy(first_delay_ms=1, jitter_ms=0, max_retries=2),
        dlq=p.dlv.DeadLetterQueue(str(tmp_path / "dlq")),
        queue_batches=queue_batches, backend=backend, transactional=transactional,
    )


def test_ack_cursor_persists_and_skips_replayed_batches(p, tmp_path):
    backend = p.backends.MemoryBackend()
    delivered = []
    s = _sink(p, lambda b: delivered.append(b.time), tmp_path, backend=backend,
              transactional=True, name="ack")
    assert json.loads(backend.get_value("delivery/ack"))["acked_time"] == -1
    s.on_batch(2, _batch(p, [1]))
    s.on_batch(4, _batch(p, [2]))
    s.release(4)
    assert s.drain(timeout=10, bump_to=6)
    s.shutdown()
    assert delivered == [2, 4]
    doc = json.loads(backend.get_value("delivery/ack"))
    assert doc["acked_time"] == 6  # heartbeat bump to the commit tick
    assert doc["worker"] == 0

    delivered2 = []
    s2 = _sink(p, lambda b: delivered2.append(b.time), tmp_path, backend=backend,
               transactional=True, name="ack")
    assert s2.recovery_floor() == 6
    s2.on_batch(2, _batch(p, [1]))   # replay — skipped
    s2.on_batch(4, _batch(p, [2]))   # replay — skipped
    s2.on_batch(8, _batch(p, [3]))   # fresh
    s2.release_all()
    assert s2.drain(timeout=10)
    s2.shutdown()
    assert delivered2 == [8]


def test_transactional_batches_wait_for_release(p, tmp_path):
    delivered = []
    s = _sink(p, lambda b: delivered.append(b.time), tmp_path,
              backend=p.backends.MemoryBackend(), transactional=True, name="rel")
    s.on_batch(2, _batch(p, [1]))
    s.on_batch(4, _batch(p, [2]))
    time.sleep(0.1)
    assert delivered == []  # input not committed yet — nothing delivered
    s.release(2)
    assert s.drain(timeout=10)
    assert delivered == [2]
    s.release(4)
    assert s.drain(timeout=10)
    s.shutdown()
    assert delivered == [2, 4]


def test_manager_commit_protocol_and_floor(p, tmp_path):
    mgr = p.dlv.DeliveryManager(worker_id=0)
    delivered = []
    s = _sink(p, lambda b: delivered.append(b.time), tmp_path,
              backend=p.backends.MemoryBackend(), transactional=True, name="mgr")
    mgr.add(s)
    assert mgr.recovery_floor() == -1
    s.on_batch(2, _batch(p, [1]))
    mgr.pre_commit_barrier()  # nothing released yet — no-op
    mgr.on_commit(2)
    assert delivered == [2]
    assert mgr.recovery_floor() == 2
    s.on_batch(4, _batch(p, [2]))
    mgr.on_commit(4)
    assert mgr.recovery_floor() == 4
    mgr.finish()
    assert delivered == [2, 4]


def test_manager_want_early_commit(p, tmp_path):
    mgr = p.dlv.DeliveryManager(worker_id=0)
    s = _sink(p, lambda b: None, tmp_path, backend=p.backends.MemoryBackend(),
              transactional=True, queue_batches=2, name="early")
    mgr.add(s)
    assert not mgr.want_early_commit()
    s.on_batch(2, _batch(p, [1]))
    s.on_batch(4, _batch(p, [1]))
    assert mgr.want_early_commit()
    mgr.on_commit(4)
    assert not mgr.want_early_commit()
    mgr.finish()


def test_end_time_batch_skips_when_already_acked(p, tmp_path):
    backend = p.backends.MemoryBackend()
    END = 1 << 62
    delivered = []
    s = _sink(p, lambda b: delivered.append(b.time), tmp_path, backend=backend,
              transactional=True, name="endt")
    s.on_batch(END, _batch(p, [1]))
    s.release_all()
    assert s.drain(timeout=10)
    s.shutdown()
    s2 = _sink(p, lambda b: delivered.append(("dup", b.time)), tmp_path, backend=backend,
               transactional=True, name="endt")
    assert s2.acked_time == END
    s2.on_batch(END, _batch(p, [1]))  # regenerated on restart — skipped
    s2.release_all()
    assert s2.drain(timeout=10)
    s2.shutdown()
    assert delivered == [END]


def test_drain_interrupted_by_stop_never_bumps_cursor(p, tmp_path):
    backend = p.backends.MemoryBackend()
    hold = threading.Event()
    s = _sink(p, lambda b: hold.wait(10), tmp_path, backend=backend, transactional=True,
              name="intr")
    s.on_batch(2, _batch(p, [1]))
    s.release_all()
    done: list = []
    th = threading.Thread(target=lambda: done.append(s.drain(timeout=None, bump_to=99)),
                          daemon=True)
    th.start()
    time.sleep(0.2)
    s._stop.set()  # teardown races the drain
    th.join(timeout=10)
    hold.set()
    s.shutdown()
    assert done == [False]
    assert s.acked_time < 99
    assert json.loads(backend.get_value("delivery/intr"))["acked_time"] < 99


def test_cursor_transient_read_error_propagates(p, tmp_path):
    class FlakyBackend(p.backends.MemoryBackend):
        def get_value(self, key):
            raise OSError("EIO")

    with pytest.raises(OSError, match="EIO"):
        _sink(p, lambda b: None, tmp_path, backend=FlakyBackend(), transactional=True,
              name="flaky-cur")


def test_cursor_corrupt_blob_not_overwritten(p, tmp_path):
    backend = p.backends.MemoryBackend()
    backend.put_value("delivery/corr", b"\xff not json")
    s = _sink(p, lambda b: None, tmp_path, backend=backend, transactional=True, name="corr")
    assert s.acked_time == -1  # conservative floor in memory
    assert backend.get_value("delivery/corr") == b"\xff not json"
    s.shutdown()


def test_persisted_csv_write_is_transactional(p, tmp_path):
    """``pw.io.csv.write`` under persistence: the sink's cursor lives in the store, a restart
    with more input appends only the new rows' updates, and the file's rows net of their diffs
    equal the clean counts."""
    cfg = p.ps.Config.simple_config(p.ps.Backend.filesystem(str(tmp_path / "ps")))
    out = tmp_path / "counts.csv"
    for upto in (6, 10):
        p.pw.G.clear()
        counts = _word_pipeline(p, _emitter(p, WORDS, upto))
        p.pw.io.csv.write(counts, str(out), name="counts")
        run_bounded(p.pw, 60, persistence_config=cfg, **p.run)
    assert "delivery/counts" in p.backends.FilesystemBackend(str(tmp_path / "ps")).list_keys()
    import csv

    net: dict = {}
    with open(out) as f:
        for row in csv.DictReader(f):
            key = (row["word"], int(row["c"]))
            net[key] = net.get(key, 0) + int(row["diff"])
    assert {k: v for k, v in net.items() if v} == {
        ("foo", 4): 1, ("bar", 3): 1, ("baz", 2): 1, ("qux", 1): 1}
    assert all(v in (0, 1) for v in net.values())
