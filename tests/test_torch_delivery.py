"""The port's output plane (``io/delivery.py``) on the CPU: the cases of ``tests/test_delivery.py``
that need neither the chaos plane nor persistence, each run on the port and on the JAX package,
which must behave alike: the retry policy's backoff, retries then one delivery, the dead-letter
queue (part of a batch and all of it), the circuit breaker, the timeout watchdog and its adapter
reset, a drain that times out or that a shutdown interrupts, bounded buffering that blocks the
engine thread (backpressure), name de-collision, the fs adapter's reopen, the stats surface, a
fatal writer failure, and ``csv.write`` through ``pw.run``.

Every wait is bounded: a drain has a timeout, and a hung writer fails its test, not the suite.
"""

from __future__ import annotations

import importlib
import json
import random
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from torch_io_runs import run_bounded

PACKAGES = ("pathway_tpu", "pathway_tpu_torch")


@pytest.fixture(params=PACKAGES)
def p(request):
    pkg = request.param
    ns = SimpleNamespace(
        pw=importlib.import_module(pkg),
        dlv=importlib.import_module(f"{pkg}.io.delivery"),
        Delta=importlib.import_module(f"{pkg}.engine.delta").Delta,
        fs=importlib.import_module(f"{pkg}.io.fs"),
        run={"device": "cpu"} if pkg == "pathway_tpu_torch" else {},
    )
    ns.pw.G.clear()
    ns.dlv._reset_stats_for_tests()
    yield ns
    ns.pw.G.clear()
    ns.dlv._reset_stats_for_tests()


def _batch(p, vals: list[int]):
    return p.Delta(keys=np.arange(len(vals), dtype=np.uint64), data={"x": np.asarray(vals)},
                   diffs=np.ones(len(vals), dtype=np.int64))


def _sink(p, fn, tmp_path, *, policy=None, queue_batches=8, name="t"):
    return p.dlv.DeliverySink(
        p.dlv.CallableAdapter(fn, name), name,
        policy=policy or p.dlv.RetryPolicy(first_delay_ms=1, jitter_ms=0, max_retries=2),
        dlq=p.dlv.DeadLetterQueue(str(tmp_path / "dlq")),
        queue_batches=queue_batches,
    )


# -- RetryPolicy ------------------------------------------------------------------------------


def test_retry_policy_backoff_shape(p):
    pol = p.dlv.RetryPolicy(first_delay_ms=100, backoff_factor=3.0, jitter_ms=0)
    assert pol.delay_s(1) == pytest.approx(0.1)
    assert pol.delay_s(2) == pytest.approx(0.3)
    assert pol.delay_s(3) == pytest.approx(0.9)
    assert pol.attempts() == 6  # max_retries=5 default


def test_retry_policy_jitter_bounded(p):
    pol = p.dlv.RetryPolicy(first_delay_ms=10, jitter_ms=50)
    rng = random.Random(1)
    for _ in range(50):
        assert 0.01 <= pol.delay_s(1, rng) <= 0.06


def test_retry_policy_from_env(p, monkeypatch):
    monkeypatch.setenv("PATHWAY_SINK_RETRY_MAX", "7")
    monkeypatch.setenv("PATHWAY_SINK_RETRY_FIRST_DELAY_MS", "5")
    pol = p.dlv.RetryPolicy.from_env()
    assert (pol.max_retries, pol.first_delay_ms, pol.jitter_ms) == (7, 5, 20)


def test_retry_policy_http_reexport(p):
    http = importlib.import_module(f"{p.pw.__name__}.io.http")
    assert http.RetryPolicy is p.dlv.RetryPolicy


def test_sanitize(p):
    assert p.dlv._sanitize("fs-/tmp/out file.csv") == "fs-_tmp_out_file.csv"
    assert p.dlv._sanitize("///") == "sink"


# -- delivery: retries, DLQ, breaker, watchdog ----------------------------------------------


def test_transient_failures_retry_then_deliver_once(p, tmp_path):
    calls = []

    def fn(batch):
        calls.append(batch.time)
        if len(calls) <= 2:
            raise ConnectionError("transient")

    s = _sink(p, fn, tmp_path)
    s.on_batch(2, _batch(p, [1]))
    assert s.drain(timeout=10)
    s.shutdown()
    assert calls == [2, 2, 2]  # two failures, one success — delivered once
    assert s.stats.retries_total == 2
    assert s.stats.delivered_total == 1


def test_reject_routes_rows_to_dlq_and_delivers_rest(p, tmp_path):
    delivered = []

    def fn(batch):
        vals = list(batch.delta.data["x"])
        if 13 in vals:
            raise p.dlv.SinkRejectedError("bad row", row_indices=[vals.index(13)])
        delivered.extend(vals)

    s = _sink(p, fn, tmp_path, name="rj")
    s.on_batch(2, _batch(p, [7, 13, 9]))
    assert s.drain(timeout=10)
    s.shutdown()
    assert sorted(delivered) == [7, 9]
    assert s.stats.dlq_total == 1
    entries = [json.loads(line) for line in open(tmp_path / "dlq" / "rj.jsonl")]
    assert len(entries) == 1
    assert entries[0]["row"] == {"x": 13, "diff": 1}
    assert "bad row" in entries[0]["error"]
    assert entries[0]["stamp"][2] == 2  # the tick time


def test_whole_batch_reject_is_fully_dead_lettered_and_acked(p, tmp_path):
    def fn(batch):
        raise p.dlv.SinkRejectedError("all bad")

    s = _sink(p, fn, tmp_path, name="allbad")
    s.on_batch(4, _batch(p, [1, 2]))
    assert s.drain(timeout=10)
    s.shutdown()
    assert s.stats.dlq_total == 2
    assert s.acked_time == 4  # accounted for


def test_dead_letters_of_numpy_and_bytes_values(p, tmp_path):
    d = p.Delta(keys=np.arange(2, dtype=np.uint64),
                data={"b": np.array([b"\xffz", b"ok"], dtype=object),
                      "v": np.array([[1, 2], [3, 4]], dtype=object)[:, 0],
                      "f": np.array([1.5, np.float32(2.25)])},
                diffs=np.array([1, -1], dtype=np.int64))

    def fn(batch):
        vals = list(batch.delta.data["b"])
        if b"ok" in vals:
            raise p.dlv.SinkRejectedError("no", row_indices=[vals.index(b"ok")])

    s = _sink(p, fn, tmp_path, name="np")
    s.on_batch(3, d)
    assert s.drain(timeout=10)
    s.shutdown()
    [entry] = [json.loads(line) for line in open(tmp_path / "dlq" / "np.jsonl")]
    assert entry["row"] == {"b": "ok", "v": 3, "f": 2.25, "diff": -1}


def test_breaker_opens_and_recovers(p, tmp_path):
    down = threading.Event()
    down.set()
    delivered = []

    def fn(batch):
        if down.is_set():
            raise ConnectionError("down")
        delivered.append(batch.time)

    s = _sink(p, fn, tmp_path, name="brk",
              policy=p.dlv.RetryPolicy(first_delay_ms=1, jitter_ms=0, max_retries=0))
    s._breaker.cooldown_s = 0.02
    s._breaker.threshold = 2
    s.on_batch(2, _batch(p, [1]))
    deadline = time.monotonic() + 10
    while s.stats.breaker_open == 0 and time.monotonic() < deadline:
        time.sleep(0.005)
    assert s.stats.breaker_open == 1
    assert s.stats.breaker_opens_total >= 1
    down.clear()
    assert s.drain(timeout=10)
    s.shutdown()
    assert delivered == [2]
    assert s.stats.breaker_open == 0


def test_timeout_watchdog_turns_hang_into_retry(p, tmp_path, monkeypatch):
    monkeypatch.setenv("PATHWAY_SINK_TIMEOUT_S", "0.1")
    calls = []

    def fn(batch):
        calls.append(1)
        if len(calls) == 1:
            time.sleep(5)  # a wedged external client
        return None

    s = _sink(p, fn, tmp_path, name="hang")
    assert s.timeout_s == pytest.approx(0.1)
    s.on_batch(2, _batch(p, [1]))
    assert s.drain(timeout=15)
    s.shutdown()
    assert len(calls) == 2
    assert s.stats.delivered_total == 1


def test_timeout_resets_adapter_before_retry(p, tmp_path, monkeypatch):
    monkeypatch.setenv("PATHWAY_SINK_TIMEOUT_S", "0.1")
    events = []
    calls = [0]

    def fn(batch):
        calls[0] += 1
        if calls[0] == 1:
            time.sleep(5)  # zombie
        events.append(("write", batch.time))

    adapter = p.dlv.CallableAdapter(fn, "tz")
    adapter.open = lambda tok: events.append(("open", tok))
    adapter.on_timeout = lambda: events.append(("on_timeout",))
    s = p.dlv.DeliverySink(
        adapter, "tz",
        policy=p.dlv.RetryPolicy(first_delay_ms=1, jitter_ms=0, max_retries=2),
        dlq=p.dlv.DeadLetterQueue(str(tmp_path / "dlq")),
    )
    s.on_batch(2, _batch(p, [1]))
    assert s.drain(timeout=15)
    s.shutdown()
    assert ("on_timeout",) in events
    reset_ix = events.index(("on_timeout",))
    assert ("open", None) in events[reset_ix:]  # reopened from the last acked token
    assert events[-1] == ("write", 2)


# -- draining and backpressure ----------------------------------------------------------------


def test_on_end_drain_timeout_raises_not_drops(p, tmp_path, monkeypatch):
    monkeypatch.setenv("PATHWAY_SINK_DRAIN_TIMEOUT_S", "0.2")

    def fn(batch):
        raise ConnectionError("down forever")

    s = _sink(p, fn, tmp_path, name="stuck",
              policy=p.dlv.RetryPolicy(first_delay_ms=1, jitter_ms=0, max_retries=0))
    s._breaker.cooldown_s = 0.01
    s.on_batch(2, _batch(p, [1]))
    with pytest.raises(RuntimeError, match="failed to drain"):
        s.on_end()


def test_drain_interrupted_by_stop_reports_undelivered(p, tmp_path):
    """A shutdown racing a drain: the drain says the batch was not delivered."""
    hold = threading.Event()
    s = _sink(p, lambda b: hold.wait(10), tmp_path, name="intr")
    s.on_batch(2, _batch(p, [1]))
    done: list[bool] = []
    th = threading.Thread(target=lambda: done.append(s.drain(timeout=None)), daemon=True)
    th.start()
    time.sleep(0.2)
    s._stop.set()  # teardown races the drain
    th.join(timeout=10)
    assert done == [False]
    assert s.acked_time < 2  # the held batch is not acked
    hold.set()
    s.shutdown()


def test_full_queue_blocks_the_engine_thread(p, tmp_path):
    """Backpressure: with a queue of one batch and the writer held inside its first write, the
    third ``on_batch`` blocks until the writer moves on; nothing is dropped."""
    hold = threading.Event()
    delivered = []

    def fn(batch):
        hold.wait(10)
        delivered.append(batch.time)

    s = _sink(p, fn, tmp_path, name="bp", queue_batches=1)
    s.on_batch(2, _batch(p, [1]))  # taken by the writer, which holds it
    deadline = time.monotonic() + 10
    while s._in_flight is None and time.monotonic() < deadline:
        time.sleep(0.005)
    s.on_batch(4, _batch(p, [2]))  # fills the queue
    third = threading.Thread(target=s.on_batch, args=(6, _batch(p, [3])), daemon=True)
    third.start()
    third.join(0.3)
    assert third.is_alive(), "on_batch returned past a full queue"
    assert s.stats.queue_depth == 1
    hold.set()
    third.join(10)
    assert not third.is_alive()
    assert s.drain(timeout=10)
    s.shutdown()
    assert delivered == [2, 4, 6]


def test_fatal_writer_failure_surfaces_on_engine_thread(p, tmp_path):
    s = _sink(p, lambda b: None, tmp_path, name="fatal")
    s._failure = RuntimeError("writer died")
    with pytest.raises(RuntimeError, match="delivery failed"):
        s.on_batch(2, _batch(p, [1]))


def test_sink_stats_snapshot_surface(p, tmp_path):
    s = _sink(p, lambda b: None, tmp_path, name="stats")
    s.on_batch(2, _batch(p, [1, 2]))
    assert s.drain(timeout=10)
    s.shutdown()
    snap = p.dlv.sink_stats_snapshot()
    assert snap["stats"]["delivered_total"] == 1
    assert snap["stats"]["delivered_rows_total"] == 2
    assert snap["stats"]["acked_time"] == 2


# -- registration and the fs adapter ----------------------------------------------------------


def test_duplicate_sink_names(p, tmp_path):
    pw = p.pw
    t = pw.debug.table_from_rows(pw.schema_from_types(a=int), [(1,)])
    # derived defaults de-collide with a deterministic suffix
    pw.io.csv.write(t, str(tmp_path / "a" / "out.csv"))
    pw.io.csv.write(t, str(tmp_path / "b" / "out.csv"))
    names = [s["delivery"]["name"] for s in pw.G.sinks]
    assert names == ["fs-out.csv", "fs-out.csv-2"]
    # explicit duplicate names are refused
    pw.io.csv.write(t, str(tmp_path / "c" / "out.csv"), name="mine")
    with pytest.raises(ValueError, match="already registered"):
        pw.io.csv.write(t, str(tmp_path / "d" / "out.csv"), name="mine")


class _SinkBatchStub:
    def __init__(self, p, t, vals):
        self.time = t
        self.delta = _batch(p, vals)

    def __len__(self):
        return len(self.delta)


def test_fs_adapter_on_timeout_reopen_keeps_file_exact(p, tmp_path):
    path = tmp_path / "o.csv"
    a = p.fs._FsSinkAdapter(str(path), "csv", ["x"])
    a.open(None)
    tok = a.write_batch(_SinkBatchStub(p, 2, [1, 2]))
    a.on_timeout()  # zombie cutoff: handles closed
    a.open(tok)  # delivery reopens from the last acked token
    a.write_batch(_SinkBatchStub(p, 4, [3]))
    a.close()
    assert path.read_text().strip().splitlines() == ["x,time,diff", "1,2,1", "2,2,1", "3,4,1"]


def test_fs_adapter_rollback_cuts_a_torn_write(p, tmp_path):
    path = tmp_path / "o.jsonl"
    a = p.fs._FsSinkAdapter(str(path), "json", ["x"])
    a.open(None)
    tok = a.write_batch(_SinkBatchStub(p, 2, [1]))
    a.write_batch(_SinkBatchStub(p, 4, [2, 3]))  # not acked
    a.rollback(tok)
    a.write_batch(_SinkBatchStub(p, 4, [2, 3]))
    a.close()
    assert [json.loads(line)["x"] for line in path.read_text().splitlines()] == [1, 2, 3]


def test_pw_run_static_table_through_delivery(p, tmp_path):
    pw = p.pw
    out = tmp_path / "out.csv"
    t = pw.debug.table_from_rows(pw.schema_from_types(a=int, b=str), [(1, "x"), (2, "y")])
    pw.io.csv.write(t, str(out), name="e2e")
    run_bounded(pw, 60, **p.run)
    lines = out.read_text().strip().splitlines()
    assert lines[0] == "a,b,time,diff"
    assert len(lines) == 3
    assert p.dlv.sink_stats_snapshot()["e2e"]["delivered_rows_total"] == 2
