"""The port's dataflow engine against the JAX package's, on the CPU.

The same engine-level graphs (sources -> operators -> ``Capture``), built from the same seeded
numpy inputs, run in both packages at 1, 2, 4 and 8 workers (threads), over ``LocalComm`` and
over ``MeshComm`` (the JAX package's on as many of the 8 virtual CPU devices, the port's with
``device="cpu"``, where the ``bucket_exchange`` kernel's plain version runs). The graphs cover a
groupby over dense and string columns, an inner join, concat with update rows, deduplicate, and
a schedule of several commits with retractions.

Tolerance: none. The captured tables are compared exactly, as multisets of (row key, row); the
keys are bit-for-bit the JAX engine's, which hashes with its C extension where it is built.
``ExternalIndexNode`` at 2 workers with mesh exchange answers as the JAX node does: ids exact,
scores within one bf16 ulp (ROADMAP Queue 3 item 3). A live source through the streaming loop,
the key registry's cap and a traced run are checked as well.
"""

from __future__ import annotations

import importlib
import threading
from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from torch_topk_checks import bf16_ulp

WORKERS = (1, 2, 4, 8)
JOIN_TIMEOUT_S = 120


def _ns(package: str) -> SimpleNamespace:
    mod = lambda m: importlib.import_module(f"{package}.{m}")  # noqa: E731
    return SimpleNamespace(
        package=package,
        ops=mod("engine.operators"),
        red=mod("engine.reducers"),
        K=mod("engine.keys"),
        Delta=mod("engine.delta").Delta,
        Executor=mod("engine.executor").Executor,
        comm=mod("parallel.comm"),
        meshcomm=mod("parallel.meshcomm"),
        xidx=mod("engine.external_index"),
    )


def _rows_keys(ns, n: int, salt: int) -> np.ndarray:
    return ns.K.mix_columns([np.arange(n, dtype=np.int64)], n, salt=salt, register=False)


def _commits(ns, cols: dict, keys: np.ndarray, sizes: list[int], retract_every: int | None):
    """Batches of the rows in commits of ``sizes``; every ``retract_every``-th row of a commit
    is retracted again in the commit after it (none when ``retract_every`` is None)."""
    out, start, prev = [], 0, None
    for t, size in enumerate(sizes):
        sl = slice(start, start + size)
        keys_t = keys[sl]
        data = {c: v[sl] for c, v in cols.items()}
        diffs = np.ones(size, dtype=np.int64)
        if prev is not None and retract_every is not None:
            pk, pd = prev
            ix = np.arange(0, len(pk), retract_every)
            keys_t = np.concatenate([keys_t, pk[ix]])
            data = {c: np.concatenate([data[c], pd[c][ix]]) for c in cols}
            diffs = np.concatenate([diffs, -np.ones(len(ix), dtype=np.int64)])
        out.append((2 * t + 2, ns.Delta(keys=keys_t, data=data, diffs=diffs)))
        prev = (keys[sl], {c: v[sl] for c, v in cols.items()})
        start += size
    return out


def _inputs(seed: int = 0):
    rng = np.random.default_rng(seed)
    n = 600
    words = np.array([f"w{i}" for i in range(37)] + ["", "ünï", "a b"], dtype=object)
    return {
        "word": words[rng.integers(0, len(words), n)],
        "g": rng.integers(0, 23, n).astype(np.int64),
        "v": rng.integers(-500, 500, n).astype(np.int64),
        # multiples of 1/64: float sums are exact in any order, so every sharding agrees
        "x": np.where(rng.random(n) < 0.05, -0.0, rng.integers(-4096, 4096, n) / 64),
        "dim_g": np.arange(0, 30, dtype=np.int64),
        "sizes": [150, 200, 100, 150],
    }


def _jk(ns, col: str):
    return lambda c, k: ns.K.mix_columns([c[col]], len(k), register=False)


def _graph(ns, which: str):
    """(nodes, capture) of graph ``which``, built afresh (each worker builds its own)."""
    ops, red, inp = ns.ops, ns.red, _inputs()
    n = len(inp["g"])
    cols = {c: inp[c] for c in ("word", "g", "v", "x")}
    src = ops.ScheduledSource(list(cols), _commits(ns, cols, _rows_keys(ns, n, 1),
                                                   inp["sizes"], 3))
    nodes = [src]
    if which == "groupby_dense":
        out = ops.GroupByReduce(src, ["g"], [
            ("s", red.make_reducer("sum"), ["v"]), ("sx", red.make_reducer("sum"), ["x"]),
            ("c", red.make_reducer("count"), []),
        ])
    elif which == "groupby_string":
        out = ops.GroupByReduce(src, ["word"], [
            ("c", red.make_reducer("count"), []), ("lo", red.make_reducer("min"), ["v"]),
            ("hi", red.make_reducer("max"), ["g"]),
        ])
    elif which == "join":
        dim_g = inp["dim_g"]
        dim = ops.StaticSource(_rows_keys(ns, len(dim_g), 2),
                               {"g": dim_g, "label": np.array([f"L{g}" for g in dim_g],
                                                              dtype=object)})
        left = ops.Rowwise(src, {"jk": _jk(ns, "g"), "v": lambda c, k: c["v"],
                                 "word": lambda c, k: c["word"]})
        right = ops.Rowwise(dim, {"jk": _jk(ns, "g"), "label": lambda c, k: c["label"]})
        out = ops.Join(left, right, "jk", "jk", ["v", "word"], ["label"],
                       ["v", "word", "label"])
        nodes += [dim, left, right]
    elif which == "concat_update":
        keys_b = _rows_keys(ns, 40, 3)
        other = ops.StaticSource(keys_b, {c: inp[c][:40] for c in ("word", "g", "v", "x")})
        evens = ops.Filter(src, lambda c, k: c["v"] % 2 == 0)
        odds = ops.Filter(src, lambda c, k: c["v"] % 2 != 0)
        cat = ops.Concat([evens, odds])
        upd_src = ops.StaticSource(_rows_keys(ns, 600, 1)[::7],
                                   {"word": inp["word"][:86], "g": inp["g"][:86],
                                    "v": -inp["v"][:86], "x": inp["x"][:86]})
        out = ops.UpdateRows(ops.Concat([cat, other]), upd_src)
        nodes += [other, evens, odds, cat, upd_src, out.inputs[0]]
    elif which == "deduplicate":
        # insertions only: the operator takes a tick's rows in arrival order, and with
        # retractions among them the accepted row would depend on the sharding
        src = ops.ScheduledSource(list(cols), _commits(ns, cols, _rows_keys(ns, n, 1),
                                                       inp["sizes"], None))
        nodes = [src]
        out = ops.Deduplicate(src, "v", "g", lambda new, old: new > old)
    else:
        raise ValueError(which)
    cap = ops.Capture(out)
    return nodes + [out, cap], cap


GRAPHS = ("groupby_dense", "groupby_string", "join", "concat_update", "deduplicate")


def _run(ns, build, n_workers: int, mesh: bool):
    """Run ``build()``'s graph on ``n_workers`` worker threads; worker 0's Capture state."""
    if n_workers == 1:
        nodes, cap = build()
        ns.Executor(nodes).run()
        return cap
    comm = ns.comm.LocalComm(n_workers)
    if mesh:
        comm = (ns.meshcomm.MeshComm(comm, device="cpu") if ns.package == "pathway_tpu_torch"
                else ns.meshcomm.MeshComm(comm))
    executors, caps = [], []
    for w in range(n_workers):
        nodes, cap = build()
        executors.append(ns.Executor(nodes, ctx=ns.comm.WorkerContext(w, n_workers, comm)))
        caps.append(cap)
    errors: list[BaseException] = []

    def work(ex):
        try:
            ex.run()
        except BaseException as e:  # noqa: BLE001 — re-raised below, after the join
            errors.append(e)
            comm.abort()

    threads = [threading.Thread(target=work, args=(ex,), daemon=True) for ex in executors]
    for t in threads:
        t.start()
    for t in threads:
        t.join(JOIN_TIMEOUT_S)
    assert not any(t.is_alive() for t in threads), "a worker hung"
    comm.close()
    if errors:
        raise errors[0]
    return caps[0]


def _table(cap) -> Counter:
    def norm(v):
        if isinstance(v, (float, np.floating)):
            return ("f", np.float64(v).view(np.uint64).item())  # bits: -0.0 and NaN exact
        return v.item() if isinstance(v, np.generic) else v

    return Counter((int(k), tuple(norm(v) for v in row)) for k, row in cap.state.iter_items())


RUNS = [(n, mesh) for n in WORKERS for mesh in ((False, True) if n > 1 else (False,))]


@pytest.fixture(scope="module")
def tables():
    jx, pt = _ns("pathway_tpu"), _ns("pathway_tpu_torch")
    out = {}
    for which in GRAPHS:
        for n, mesh in RUNS:
            for ns in (jx, pt):
                cap = _run(ns, lambda: _graph(ns, which), n, mesh)
                out[(ns.package, which, n, mesh)] = _table(cap)
    return out


@pytest.mark.parametrize("which", GRAPHS)
@pytest.mark.parametrize("n,mesh", RUNS, ids=[f"{n}w-{'mesh' if m else 'local'}"
                                              for n, m in RUNS])
def test_port_engine_equals_jax_engine(tables, which, n, mesh):
    ours = tables[("pathway_tpu_torch", which, n, mesh)]
    theirs = tables[("pathway_tpu", which, n, mesh)]
    assert ours == theirs
    assert ours == tables[("pathway_tpu_torch", which, 1, False)]  # any sharding, one answer
    assert len(ours) > 5


def test_mesh_runs_moved_rows_through_the_exchange():
    pt = _ns("pathway_tpu_torch")
    from pathway_tpu_torch.parallel.exchange import bucket_exchange

    comm = pt.meshcomm.MeshComm(pt.comm.LocalComm(4), device="cpu")
    caps = []
    threads = []
    for w in range(4):
        nodes, cap = _graph(pt, "groupby_string")
        ex = pt.Executor(nodes, ctx=pt.comm.WorkerContext(w, 4, comm))
        caps.append(cap)
        threads.append(threading.Thread(target=ex.run, daemon=True))
    for t in threads:
        t.start()
    for t in threads:
        t.join(JOIN_TIMEOUT_S)
    assert not any(t.is_alive() for t in threads)
    stats = comm.comm_stats()
    assert stats["mesh_collectives"] > 0 and stats["mesh_rows_moved"] > 0
    assert bucket_exchange.launches == 0  # CPU tensors: the plain version
    assert len(caps[1].state) == 0 and len(caps[0].state) > 0  # Capture gathers to worker 0


def test_meshcomm_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    pt = _ns("pathway_tpu_torch")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.meshcomm.MeshComm(pt.comm.LocalComm(2))


@pytest.mark.parametrize("salt", [0, 5])
def test_keys_bitwise_equal_to_the_jax_engine(salt):
    jx, pt = _ns("pathway_tpu"), _ns("pathway_tpu_torch")
    inp = _inputs(1)
    cols = [inp["word"], inp["g"], inp["x"], inp["g"] % 2 == 0, inp["v"].astype(np.int32)]
    n = len(inp["g"])
    rows = [tuple(c[i] for c in cols) + (None, (1, "t")) for i in range(50)]
    for a, b in (
        (jx.K.mix_columns(cols, n, salt=salt), pt.K.mix_columns(cols, n, salt=salt)),
        (jx.K.mix_columns(cols, n, salt=salt, register=False),
         pt.K.mix_columns(cols, n, salt=salt, register=False)),
        (jx.K.hash_values(rows, salt=salt), pt.K.hash_values(rows, salt=salt)),
        (jx.K.hash_values(rows, salt=salt, register=False),
         pt.K.hash_values(rows, salt=salt, register=False)),
        (jx.K.pointer_from_ints(inp["v"]), pt.K.pointer_from_ints(inp["v"])),
        (jx.K.derive(inp["v"].view(np.uint64), salt), pt.K.derive(inp["v"].view(np.uint64), salt)),
        (jx.K.hash_column(inp["word"]), pt.K.hash_column(inp["word"])),
    ):
        assert a.dtype == b.dtype == np.uint64
        np.testing.assert_array_equal(a, b)
    assert jx.K.ref_scalar("a", 1, salt=salt) == pt.K.ref_scalar("a", 1, salt=salt)


def test_python_hi_lane_matches_the_native_registry():
    """The port registers (lo, hi) pairs from its Python HI lane; a clash with the JAX engine's
    pairs (native where built) would mean the two lanes disagree."""
    jx, pt = _ns("pathway_tpu"), _ns("pathway_tpu_torch")
    words = np.array([f"k{i}" for i in range(300)] + [None, 3, 2.5, (1, "x")], dtype=object)
    lo_j, hi_j = jx.K._hash_object_column2(words)
    lo_p, hi_p = pt.K._hash_object_column2(words)
    np.testing.assert_array_equal(lo_j, lo_p)
    np.testing.assert_array_equal(hi_j, hi_p)


def test_key_registry_refuses_past_its_cap(monkeypatch):
    pt = _ns("pathway_tpu_torch")
    reg = pt.K._KeyRegistry(4, allow=False)
    lo = np.arange(6, dtype=np.uint64)
    with pytest.raises(pt.K.KeyRegistryOverflowError):
        reg.register(lo, lo)
    assert pt.K._KeyRegistry(4, allow=True).register(lo, lo) == -1
    clash = pt.K._KeyRegistry(16, allow=False)
    assert clash.register(lo, lo) == -1
    assert clash.register(lo[2:3], lo[2:3] + np.uint64(1)) == 0


# -- ExternalIndexNode over the brute-force engine, 2 workers, mesh exchange -------------------


def _index_graph(ns, engine, data: np.ndarray, queries: np.ndarray):
    ops = ns.ops
    docs = ops.ScheduledSource(["__data__"], [
        (2 * t + 2, ns.Delta(keys=_rows_keys(ns, len(data), 4)[s:s + 16],
                             data={"__data__": _obj_rows(data[s:s + 16])}))
        for t, s in enumerate(range(0, len(data), 16))
    ])
    qs = ops.ScheduledSource(["__query__", "__limit__"], [
        (40, ns.Delta(keys=_rows_keys(ns, len(queries), 5),
                      data={"__query__": _obj_rows(queries),
                            "__limit__": np.full(len(queries), 4, dtype=np.int64)})),
    ])
    node = ns.xidx.ExternalIndexNode(docs, qs, engine, asof_now=True)
    cap = ops.Capture(node)
    return [docs, qs, node, cap], cap


def _obj_rows(a: np.ndarray) -> np.ndarray:
    out = np.empty(len(a), dtype=object)
    for i, row in enumerate(a):
        out[i] = row
    return out


def test_external_index_matches_jax_at_two_workers_with_mesh_exchange():
    from pathway_tpu.ops.index_engines import BruteForceKnnEngine as JaxEngine
    from pathway_tpu_torch.ops.index_engines import BruteForceKnnEngine

    rng = np.random.default_rng(4)
    data = rng.standard_normal((64, 16)).astype(np.float32)
    queries = data[[3, 17, 40]] + 0.05 * rng.standard_normal((3, 16)).astype(np.float32)
    jx, pt = _ns("pathway_tpu"), _ns("pathway_tpu_torch")
    replies = {}
    for ns, make in ((jx, lambda: JaxEngine(16, reserved_space=64)),
                     (pt, lambda: BruteForceKnnEngine(16, reserved_space=64, device="cpu"))):
        cap = _run(ns, lambda: _index_graph(ns, make(), data, queries), 2, True)
        replies[ns.package] = {int(k): row[0] for k, row in cap.state.iter_items()}
    ours, theirs = replies["pathway_tpu_torch"], replies["pathway_tpu"]
    assert ours.keys() == theirs.keys() and len(ours) == 3
    doc_key = {int(k): i for i, k in enumerate(_rows_keys(pt, len(data), 4))}
    for q in ours:
        assert [k for k, _ in ours[q]] == [k for k, _ in theirs[q]]
        s_o = np.array([s for _, s in ours[q]], dtype=np.float32)
        s_t = np.array([s for _, s in theirs[q]], dtype=np.float32)
        assert np.all(np.abs(s_o - s_t) <= bf16_ulp(s_t))
        assert {doc_key[k] for k, _ in ours[q]} & {3, 17, 40}


def test_trace_records_ticks_and_the_exchange_flows(tmp_path):
    """With a tracer active, a 2-worker mesh run writes tick spans, node spans, the driver's
    collective and the deposit/result flows that link the workers to it."""
    import json

    from pathway_tpu_torch.internals import tracing

    pt = _ns("pathway_tpu_torch")
    path = tmp_path / "run.json"
    tracer = tracing.activate(str(path))
    try:
        _run(pt, lambda: _graph(pt, "groupby_dense"), 2, True)
    finally:
        tracing.deactivate()
    assert tracer.flush() == str(path)
    events = json.loads(path.read_text())["traceEvents"]
    names = Counter(e["name"] for e in events)
    assert names["tick"] >= 2 * len(_inputs()["sizes"])
    assert names["mesh.collective"] > 0
    flows = [e for e in events if e.get("cat") == "comm"]
    starts = {e["id"] for e in flows if e["ph"] == "s"}
    ends = {e["id"] for e in flows if e["ph"] == "f"}
    assert starts and starts == ends  # every arrow that leaves a worker arrives


def _feed(ns, commits: list):
    """A live source that hands out one commit a poll (the streaming loop mints a tick each)."""
    executor = importlib.import_module(f"{ns.package}.engine.executor")

    class Feed(executor.RealtimeSource):
        def __init__(self):
            super().__init__(["word", "v"])
            self._left = list(commits)

        def poll(self):
            return [self._left.pop(0)] if self._left else []

        def is_finished(self):
            return not self._left

    return Feed()


@pytest.mark.parametrize("n,mesh", [(1, False), (2, False), (2, True)])
def test_streaming_loop_matches_jax(monkeypatch, n, mesh):
    """A realtime source through the streaming loop (its owner polls it, its rows spread to their
    shards), grouped: the final table equals the JAX engine's, run on its BSP loop."""
    monkeypatch.setenv("PATHWAY_ASYNC_EXEC", "0")  # the JAX engine's BSP loop, as the port's
    inp = _inputs(2)
    tables = {}
    for ns in (_ns("pathway_tpu"), _ns("pathway_tpu_torch")):
        cols = {"word": inp["word"], "v": inp["v"]}
        commits = [d for _, d in _commits(ns, cols, _rows_keys(ns, len(inp["v"]), 6),
                                          inp["sizes"], 4)]

        def build(ns=ns, commits=commits):
            src = _feed(ns, commits)
            out = ns.ops.GroupByReduce(src, ["word"], [("s", ns.red.make_reducer("sum"), ["v"]),
                                                       ("c", ns.red.make_reducer("count"), [])])
            cap = ns.ops.Capture(out)
            return [src, out, cap], cap

        tables[ns.package] = _table(_run(ns, build, n, mesh))
    assert tables["pathway_tpu_torch"] == tables["pathway_tpu"]
    assert len(tables["pathway_tpu"]) == len(set(inp["word"]))
