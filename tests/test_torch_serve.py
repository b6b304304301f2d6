"""The port's serve plane and REST edge against the JAX package's on the CPU.

Three parts, then one HTTP round trip:

- ``tests/test_serve.py``'s admission controller, top-k merge, gather state, deadline helpers and
  status channel, on the port's ``serve`` modules (the router is not ported);
- ``tests/test_streaming_io.py``'s REST tests on the port: a round trip, a missing field's 400,
  the quiescent writer (the reference's legacy first-emission writer is not ported);
- ``tests/test_ported_openapi.py``'s five OpenAPI descriptions, equal in both packages;
- a ``DocumentStoreServer`` of each package over the same documents on a free port each, the same
  ``/v1/retrieve`` (with and without a glob), ``/v1/statistics`` and ``/v1/inputs`` requests:
  the JSON bodies equal, dists within one bf16 ulp (ROADMAP Queue 3 item 3), texts and metadata
  equal where the dists are clear; a saturated admission controller
  (``PATHWAY_SERVE_MAX_INFLIGHT=1``, ``PATHWAY_SERVE_QUEUE_BOUND=0``, its one slot taken) answers
  429 with ``Retry-After`` in both.

Every server binds a free port and every client is ``urllib`` without a proxy; each engine and
HTTP thread is stopped and joined within a bounded time.
"""

from __future__ import annotations

import json
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import pathway_tpu as rpw
import pathway_tpu_torch as pw
from pathway_tpu.internals.parse_graph import G as RG
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.io.http import _server as tserver
from pathway_tpu_torch.serve import admission as adm
from pathway_tpu_torch.serve import status as serve_status
from pathway_tpu_torch.serve.admission import AdmissionController, shared_controller
from pathway_tpu_torch.serve.merge import (
    GatherState,
    deadline_from_ms,
    default_deadline_ms,
    expired,
    merge_topk,
)
from pathway_tpu_torch.serve.registry import registry
from pathway_tpu_torch.serve.stats import (
    SERVE_STATS,
    reset_serve_stats,
    serve_stats_snapshot,
)
from torch_topk_checks import assert_docs_close


@pytest.fixture(autouse=True)
def _clean_serve_plane():
    reset_serve_stats()
    registry().clear()
    G.clear()
    RG.clear()
    yield
    tserver.terminate_all()
    reset_serve_stats()
    registry().clear()
    G.clear()
    RG.clear()


def _stat(key: str) -> int:
    return SERVE_STATS[key]


# ---------------------------------------------------------------------------
# the serve plane's pure components (tests/test_serve.py)
# ---------------------------------------------------------------------------


class TestAdmissionController:
    def test_fast_admit_below_inflight(self):
        c = AdmissionController(max_inflight=2, queue_bound=4)
        s1 = c.try_admit()
        s2 = c.try_admit(timeout_s=0)
        assert s1 is not None and not s1.queued
        assert s2 is not None and not s2.queued
        assert _stat("queries_total") == 2
        c.release(s1)
        c.release(s2)

    def test_saturated_queue_at_bound_rejects(self):
        c = AdmissionController(max_inflight=1, queue_bound=0)
        slot = c.try_admit()
        assert slot is not None
        # queue bound 0: nothing may wait, even with an unbounded timeout
        assert c.try_admit() is None
        assert _stat("rejected_total") == 1
        assert _stat("queued_total") == 0
        c.release(slot)

    def test_zero_timeout_never_queues(self):
        c = AdmissionController(max_inflight=1, queue_bound=8)
        slot = c.try_admit()
        assert c.try_admit(timeout_s=0) is None
        assert _stat("queued_total") == 0
        assert _stat("rejected_total") == 1
        c.release(slot)

    def test_queued_waiter_admitted_on_release(self):
        c = AdmissionController(max_inflight=1, queue_bound=2)
        first = c.try_admit()
        got: list = []

        def waiter():
            got.append(c.try_admit(timeout_s=5.0))

        t = threading.Thread(target=waiter)
        t.start()
        deadline = time.monotonic() + 2.0
        while c.gauges()["queue_depth"] < 1 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert c.gauges()["queue_depth"] == 1
        c.release(first, service_s=0.01)
        t.join(timeout=5.0)
        assert not t.is_alive()
        (slot,) = got
        assert slot is not None and slot.queued
        assert _stat("queued_total") == 1
        c.release(slot)

    def test_wait_timeout_rejects(self):
        c = AdmissionController(max_inflight=1, queue_bound=2)
        slot = c.try_admit()
        t0 = time.monotonic()
        assert c.try_admit(timeout_s=0.05) is None
        assert time.monotonic() - t0 < 2.0
        assert _stat("rejected_total") == 1
        c.release(slot)

    def test_retry_after_floor_and_scaling(self):
        c = AdmissionController(max_inflight=2, queue_bound=4)
        # no history: floored so clients can't busy-retry
        assert c.retry_after_s() == pytest.approx(0.05)
        s = c.try_admit()
        c.release(s, service_s=10.0)
        # ewma 10 s over 2 slots -> one queue position costs 5 s
        assert c.retry_after_s() == pytest.approx(5.0)

    def test_cancel_frees_slot_and_counts(self):
        c = AdmissionController(max_inflight=1, queue_bound=0)
        slot = c.try_admit()
        c.cancel(slot)
        assert _stat("cancelled_total") == 1
        assert c.gauges()["inflight"] == 0
        assert c.try_admit() is not None

    def test_shared_controller_singleton_registers_gauges(self):
        a = shared_controller()
        b = shared_controller()
        assert a is b
        snap = serve_stats_snapshot()
        assert "inflight" in snap and "queue_bound" in snap
        # module singleton survives reset; re-arming is idempotent
        reset_serve_stats()
        assert shared_controller() is a
        assert "inflight" in serve_stats_snapshot()

    def test_floors_on_bad_knobs(self):
        c = AdmissionController(max_inflight=0, queue_bound=-3)
        assert c.max_inflight == 1
        assert c.queue_bound == 0


# ---------------------------------------------------------------------------
# merge + gather state
# ---------------------------------------------------------------------------


class TestMergeTopk:
    def test_global_order_and_truncation(self):
        merged = merge_topk(
            [[("a", 0.9), ("b", 0.5)], [("c", 0.7), ("d", 0.1)]], 3
        )
        assert merged == [("a", 0.9), ("c", 0.7), ("b", 0.5)]

    def test_duplicate_keys_keep_best_score(self):
        merged = merge_topk([[("a", 0.3)], [("a", 0.8), ("b", 0.4)]], 5)
        assert merged == [("a", 0.8), ("b", 0.4)]

    def test_score_ties_break_by_key(self):
        merged = merge_topk([[("b", 0.5)], [("a", 0.5)]], 2)
        assert merged == [("a", 0.5), ("b", 0.5)]

    def test_ops_layer_alias(self):
        # the single-host gather in ops/knn.py and the wire gather share
        # one merge
        from pathway_tpu_torch.ops.knn import merge_shard_topk

        assert merge_shard_topk([[("a", 1.0)], [("b", 2.0)]], 1) == [
            ("b", 2.0)
        ]


class TestGatherState:
    def test_complete_gather_not_degraded(self):
        g = GatherState(("q", 0), shards=[0, 1], limits=[2])
        g.add(0, [[("a", 0.9)]])
        g.add(1, [[("b", 0.8)]])
        assert g.wait(timeout_s=1.0)
        res = g.result()
        assert res["hits"] == [[("a", 0.9), ("b", 0.8)]]
        assert not res["degraded"]
        assert res["missing_shards"] == []
        assert not res["deadline_exceeded"]

    def test_partial_gather_timeout_degrades(self):
        g = GatherState(("q", 1), shards=[0, 1], limits=[2])
        g.add(0, [[("a", 0.9)]])
        t0 = time.monotonic()
        assert not g.wait(timeout_s=0.05)
        assert time.monotonic() - t0 < 2.0
        res = g.result()
        assert res["degraded"]
        assert res["missing_shards"] == [1]
        assert res["hits"] == [[("a", 0.9)]]
        assert _stat("degraded_total") == 1

    def test_duplicate_and_unexpected_answers_dropped(self):
        g = GatherState(("q", 2), shards=[0], limits=[1])
        assert g.add(0, [[("a", 0.9)]])
        assert not g.add(0, [[("a", 0.1)]])  # duplicate delivery
        assert not g.add(7, [[("x", 1.0)]])  # never scattered there
        assert _stat("duplicate_results_total") == 2
        assert g.result()["hits"] == [[("a", 0.9)]]

    def test_failed_shard_completes_gather(self):
        g = GatherState(("q", 3), shards=[0, 1], limits=[1])
        g.add(0, [[("a", 0.9)]])
        g.fail(1)
        assert g.wait(timeout_s=1.0)
        res = g.result()
        assert res["degraded"] and res["missing_shards"] == [1]

    def test_wait_clamped_to_deadline(self):
        past = time.time_ns() - 1
        g = GatherState(("q", 4), shards=[0], limits=[1], deadline_ns=past)
        t0 = time.monotonic()
        assert not g.wait(timeout_s=30.0)
        assert time.monotonic() - t0 < 2.0
        assert g.result()["deadline_exceeded"]

    def test_per_query_limits(self):
        g = GatherState(("q", 5), shards=[0], limits=[1, 2])
        g.add(0, [[("a", 0.9), ("b", 0.8)], [("c", 0.7), ("d", 0.6)]])
        res = g.result()
        assert res["hits"] == [
            [("a", 0.9)],
            [("c", 0.7), ("d", 0.6)],
        ]


class TestDeadlineHelpers:
    def test_deadline_from_ms(self):
        base = 1_000_000
        assert deadline_from_ms(2.5, now_ns=base) == base + 2_500_000

    def test_expired(self):
        assert not expired(None)
        assert expired(time.time_ns() - 1)
        assert not expired(time.time_ns() + 10**12)
        assert expired(100, now_ns=100)

    def test_default_deadline_env(self, monkeypatch):
        monkeypatch.setenv("PATHWAY_SERVE_DEADLINE_MS", "2500")
        assert default_deadline_ms() == 2500.0
        monkeypatch.setenv("PATHWAY_SERVE_DEADLINE_MS", "-5")
        assert default_deadline_ms() == 1.0  # floored


class TestStatusChannel:
    def test_deadline_round_trip_is_take_once(self):
        serve_status.note_deadline("k1", 42)
        assert serve_status.take_deadline("k1") == 42
        assert serve_status.take_deadline("k1") is None

    def test_status_round_trip(self):
        st = {"degraded": True, "missing_shards": [1]}
        serve_status.note_status("k2", st)
        assert serve_status.take_status("k2") == st
        assert serve_status.take_status("k2") is None

    def test_bounded_eviction(self):
        for i in range(serve_status._MAX_ENTRIES + 10):
            serve_status.note_deadline(("evict", i), i)
        assert serve_status.take_deadline(("evict", 0)) is None
        last = serve_status._MAX_ENTRIES + 9
        assert serve_status.take_deadline(("evict", last)) == last


def test_ops_knn_merges_with_the_serve_plane_merge(monkeypatch):
    """``ops.knn.merge_shard_topk`` is ``serve.merge.merge_topk``: the port holds one copy."""
    from pathway_tpu_torch.ops import knn
    from pathway_tpu_torch.serve import merge

    calls = []
    monkeypatch.setattr(merge, "merge_topk", lambda parts, k: calls.append(k) or [])
    knn.merge_shard_topk([[("a", 1.0)]], 1)
    assert calls == [1]


# ---------------------------------------------------------------------------
# the REST edge (tests/test_streaming_io.py)
# ---------------------------------------------------------------------------

_OPENER = urllib.request.build_opener(urllib.request.ProxyHandler({}))


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def post(port: int, route: str, body: dict, timeout: float = 30.0):
    """One JSON POST: (status, parsed body, headers)."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}{route}", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with _OPENER.open(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"null"), dict(e.headers)


def post_when_up(port: int, route: str, body: dict, deadline_s: float = 20.0):
    """``post`` once the server listens (retried while the connection is refused)."""
    deadline = time.monotonic() + deadline_s
    while True:
        try:
            return post(port, route, body)
        except OSError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.05)


def client_then_stop(port: int, route: str, body: dict, into: list) -> threading.Thread:
    """A client thread: one request once the server is up, then ``terminate_all()``, which ends
    the REST source and so ``pw.run``."""
    def client():
        try:
            status, answer, _ = post_when_up(port, route, body)
            into.append((status, answer))
        finally:
            tserver.terminate_all()

    th = threading.Thread(target=client, daemon=True)
    th.start()
    return th


def test_rest_connector_roundtrip():
    port = free_port()
    queries, writer = pw.io.http.rest_connector(host="127.0.0.1", port=port,
                                                schema=pw.schema_from_types(query=str))
    writer(queries.select(result=pw.apply(lambda q: q[::-1], pw.this.query)))
    answers: list = []
    th = client_then_stop(port, "/", {"query": "abc"}, answers)
    pw.run(device="cpu")
    th.join(10)
    assert not th.is_alive()
    assert answers == [(200, "cba")]


def test_rest_connector_missing_field_400():
    port = free_port()
    queries, writer = pw.io.http.rest_connector(host="127.0.0.1", port=port,
                                                schema=pw.schema_from_types(query=str))
    writer(queries.select(result=pw.this.query))
    answers: list = []
    th = client_then_stop(port, "/", {"wrong": 1}, answers)
    pw.run(device="cpu")
    th.join(10)
    assert not th.is_alive()
    assert answers == [(400, {"error": "missing field 'query'"})]


class _FakeWebserver:
    """Just enough surface for rest_connector's unit tests: route registry and terminate hook,
    no sockets."""

    def __init__(self):
        self._routes = {}
        self._loop = None

    def _add_route(self, route, methods, handler):
        pass

    def terminate(self):
        pass


class TestServeQuiescent:
    def _capture_writer(self, monkeypatch):
        """A rest (queries, writer) pair on a fake webserver, the writer's ``subscribe`` routed
        into captured closures and ``_complete`` into a recorded list."""
        import pathway_tpu_torch.io as pwio

        captured = {}
        monkeypatch.setattr(pwio, "subscribe", lambda table, **kwargs: captured.update(kwargs))
        completed = []
        monkeypatch.setattr(tserver._RestSubject, "_complete",
                            lambda self, key, value: completed.append((key, value)))
        queries, writer = pw.io.http.rest_connector(webserver=_FakeWebserver(),
                                                    schema=pw.schema_from_types(query=str))
        writer(queries.select(result=pw.this.query))
        return captured, completed

    def test_quiescent_holds_until_frontier(self, monkeypatch):
        captured, completed = self._capture_writer(monkeypatch)
        on_change, on_time_end = captured["on_change"], captured["on_time_end"]
        on_change(7, {"result": "partial"}, 1, True)
        assert completed == []  # held: the frontier has not passed
        on_change(7, {"result": "partial"}, 1, False)
        on_change(7, {"result": "full"}, 1, True)
        assert completed == []
        on_time_end(1)
        assert completed == [(7, "full")]
        on_time_end(2)  # the buffer drained: a later tick does not complete it again
        assert completed == [(7, "full")]

    def test_quiescent_keeps_the_row_another_retraction_does_not_name(self, monkeypatch):
        """A retraction of another value leaves the buffered row; each key of the tick answers
        once, with its settled row."""
        captured, completed = self._capture_writer(monkeypatch)
        on_change, on_time_end = captured["on_change"], captured["on_time_end"]
        on_change(7, {"result": "full"}, 1, True)
        on_change(7, {"result": "stale"}, 1, False)
        on_change(8, {"result": "other"}, 1, True)
        assert completed == []
        on_time_end(1)
        assert sorted(completed) == [(7, "full"), (8, "other")]

    def test_quiescent_rest_over_collapsed_index_join(self):
        """The settled top-k row of a BM25 ``DataIndex`` join answers, not an interim one."""
        from pathway_tpu_torch.internals.table_io import rows_to_table

        port = free_port()
        queries, writer = pw.io.http.rest_connector(host="127.0.0.1", port=port,
                                                    schema=pw.schema_from_types(query=str))
        docs = rows_to_table(["name", "text"], [
            ("a", "the quick brown fox jumps over the lazy dog"),
            ("b", "pack my box with five dozen liquor jugs"),
            ("c", "the brown dog sleeps by the fire"),
        ])
        inner = pw.indexing.TantivyBM25(data_column=docs.text)
        jr = pw.indexing.DataIndex(docs, inner).query_as_of_now(queries.query,
                                                                number_of_matches=2)
        writer(jr.select(result=pw.right.name))
        answers: list = []
        th = client_then_stop(port, "/", {"query": "brown dog"}, answers)
        pw.run(device="cpu")
        th.join(10)
        assert not th.is_alive()
        [(code, body)] = answers
        assert code == 200 and sorted(body) == ["a", "c"]


# ---------------------------------------------------------------------------
# OpenAPI descriptions (tests/test_ported_openapi.py), in both packages
# ---------------------------------------------------------------------------


def _schemas(p):
    class OneEndpoint(p.Schema):
        k: int
        v: int

    class Additional(p.Schema):
        k: int
        v: dict

    class Optional(p.Schema):
        k: int
        v: str = p.column_definition(default_value="hello")

    class NoRequired(p.Schema):
        k: int = p.column_definition(default_value=1)
        v: str = p.column_definition(default_value="hello")

    return {"one": [OneEndpoint], "additional": [Additional], "optional": [Optional],
            "two": [OneEndpoint, OneEndpoint], "none_required": [NoRequired]}


@pytest.mark.parametrize("case", ["one", "additional", "optional", "two", "none_required"])
def test_openapi_description_equal_in_both_packages(case):
    described = []
    for p in (rpw, pw):
        # never started: the description needs no socket
        webserver = p.io.http.PathwayWebserver(host="127.0.0.1", port=0)
        schemas = _schemas(p)[case]
        for i, schema in enumerate(schemas):
            p.io.http.rest_connector(webserver=webserver, schema=schema,
                                     route=f"/r{i}" if len(schemas) > 1 else "/",
                                     delete_completed_queries=False)
        described.append(webserver.openapi_description_json("127.0.0.1:28997"))
        webserver.terminate()
    want, got = described
    assert got == want
    body = got["paths"]["/r0" if case == "two" else "/"]["post"]["requestBody"]["content"][
        "application/json"]["schema"]
    assert body["additionalProperties"] == (case == "additional")
    assert ("required" in body) == (case != "none_required")


# ---------------------------------------------------------------------------
# DocumentStoreServer over HTTP, in both packages
# ---------------------------------------------------------------------------


def fake_embed(text: str) -> np.ndarray:
    v = np.zeros(16)
    for ch in str(text)[:400]:
        v[ord(ch) % 16] += 1.0
    return v / (np.linalg.norm(v) or 1.0)


DOCS = [
    ("TPUs multiply matrices on a systolic array called the MXU.", {"path": "tpu.txt", "modified_at": 3}),
    ("Kafka is a distributed message broker for event streams.", {"path": "kafka.txt", "modified_at": 7}),
    ("Croissants are made with laminated butter dough.", {"path": "food.txt", "modified_at": 5}),
    ("Streaming dataflow keeps an index live as documents change.", {"path": "notes.md", "modified_at": 9}),
]
REQUESTS = [
    ("/v1/retrieve", {"query": "systolic array MXU matrices", "k": 2}),
    ("/v1/retrieve", {"query": "systolic array MXU matrices", "k": 3, "filepath_globpattern": "*.txt"}),
    ("/v1/retrieve", {"query": "event streams", "k": 4, "metadata_filter": "modified_at > `4`"}),
    ("/v1/statistics", {}),
    ("/v1/inputs", {}),
    ("/v1/inputs", {"filepath_globpattern": "k*"}),
]


def _serve_and_ask(p, run_kwargs: dict) -> tuple[list, tuple]:
    """``p``'s ``DocumentStoreServer`` over DOCS on a free port: the answers to REQUESTS, then
    one request while the single admission slot is taken."""
    from importlib import import_module

    name = p.__name__
    servers = import_module(f"{name}.xpacks.llm.servers")
    ds = import_module(f"{name}.xpacks.llm.document_store")
    knn = import_module(f"{name}.stdlib.indexing.nearest_neighbors")
    http = import_module(f"{name}.io.http._server")
    run = import_module(f"{name}.internals.run")
    admission = import_module(f"{name}.serve.admission")

    docs = p.debug.table_from_rows(p.schema_from_types(data=str, _metadata=dict), DOCS)
    store = ds.DocumentStore(docs, knn.BruteForceKnnFactory(dimensions=16, embedder=fake_embed))
    port = free_port()
    server = servers.DocumentStoreServer("127.0.0.1", port, store)
    server.run(threaded=True, **run_kwargs)
    try:
        status, stats, _ = post_when_up(port, "/v1/statistics", {})
        assert (status, stats["file_count"]) == (200, len(DOCS))
        answers = [post(port, route, body)[:2] for route, body in REQUESTS]
        slot = admission.shared_controller().try_admit(timeout_s=0)
        assert slot is not None
        try:
            status, body, headers = post(port, "/v1/retrieve", {"query": "x", "k": 1})
        finally:
            admission.shared_controller().release(slot)
    finally:
        run.request_stop()
        http.terminate_all()
        server._thread.join(30)
    assert not server._thread.is_alive()
    return answers, (status, body, headers.get("Retry-After"))


def test_document_store_server_http_round_trip_in_both_packages(monkeypatch):
    import pathway_tpu.serve.admission as radm

    monkeypatch.setenv("PATHWAY_SERVE_MAX_INFLIGHT", "1")
    monkeypatch.setenv("PATHWAY_SERVE_QUEUE_BOUND", "0")
    monkeypatch.setattr(radm, "_shared", None)  # each package's edge reads the knobs anew
    monkeypatch.setattr(adm, "_shared", None)
    want, want_busy = _serve_and_ask(rpw, {})
    got, got_busy = _serve_and_ask(pw, {"device": "cpu"})
    for (route, _), (g_status, g), (w_status, w) in zip(REQUESTS, got, want):
        assert g_status == w_status == 200
        if route == "/v1/retrieve":
            assert_docs_close(g, w)
        else:
            assert g == w
    assert [len(body) for _, body in got[:3]] == [2, 3, 3]
    assert got[3][1] == {"file_count": 4, "last_modified": 9}
    assert sorted(f["path"] for f in got[4][1]) == sorted(m["path"] for _, m in DOCS)
    assert got_busy[0] == want_busy[0] == 429
    assert got_busy[1]["error"] == want_busy[1]["error"] == "saturated"
    assert got_busy[2] == want_busy[2] == "1"
