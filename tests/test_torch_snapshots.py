"""The port's chunked operator snapshots (``persistence/snapshots.py``) against the JAX package's,
on the CPU: the cases of ``tests/test_snapshot_stream.py`` that do not need the spill tier (the
port has none), each through both packages.

- ``OperatorSnapshots.write_parts``/``read_parts`` framing: many chunks, zero and one part,
  chunks flushed between parts, a truncated stream, and the monolithic format without ``fmt``.
- ``GroupByReduce`` (the dense arena and the general path) and ``Join``: the parts stream read
  back equals the monolithic snapshot, and the port's snapshot equals the reference's field by
  field (the same keys, slots and accumulators); a persisted groupby restored from its snapshot
  continues exactly, in both packages alike.

Every state the port writes is checked to hold no tensor (``torch_persist_checks``). Tolerance:
none; arrays compare exactly.
"""

from __future__ import annotations

import importlib
import pickle
from types import SimpleNamespace

import numpy as np
import pytest

from torch_persist_checks import assert_host_only, guard_snapshot_blobs

PACKAGES = ("pathway_tpu", "pathway_tpu_torch")


def _ns(pkg):
    return SimpleNamespace(
        name=pkg,
        pw=importlib.import_module(pkg),
        snaps=importlib.import_module(f"{pkg}.persistence.snapshots"),
        backends=importlib.import_module(f"{pkg}.persistence.backends"),
        executor=importlib.import_module(f"{pkg}.engine.executor"),
        run={"device": "cpu"} if pkg == "pathway_tpu_torch" else {},
    )


@pytest.fixture(autouse=True)
def _snapshot_guard(monkeypatch):
    """Every operator-snapshot blob the port writes holds no tensor."""
    return guard_snapshot_blobs(monkeypatch)


@pytest.fixture(params=PACKAGES)
def p(request):
    ns = _ns(request.param)
    ns.pw.G.clear()
    yield ns
    ns.pw.G.clear()


# -- framing ----------------------------------------------------------------------------------


def test_write_read_parts_roundtrip_multi_chunk(p):
    ops = p.snaps.OperatorSnapshots(p.backends.MemoryBackend())
    ops.CHUNK_BYTES = 256  # force many chunks
    parts = [{"head": True, "n": 3}, np.arange(100, dtype=np.int64), b"x" * 1000,
             ("tail", [1, 2, 3])]
    n = ops.write_parts(0, 7, iter(parts))
    assert n > 1  # genuinely chunked
    got = list(ops.read_parts(0, 7, n))
    assert got[0] == parts[0]
    np.testing.assert_array_equal(got[1], parts[1])
    assert got[2] == parts[2]
    assert got[3] == parts[3]


def test_write_parts_zero_and_single_part(p):
    ops = p.snaps.OperatorSnapshots(p.backends.MemoryBackend())
    assert ops.write_parts(1, 2, iter([])) == 1  # one empty chunk
    assert list(ops.read_parts(1, 2, 1)) == []
    n = ops.write_parts(2, 2, iter(["only"]))
    assert list(ops.read_parts(2, 2, n)) == ["only"]


def test_write_parts_flushes_chunks_between_parts(p):
    backend = p.backends.MemoryBackend()
    ops = p.snaps.OperatorSnapshots(backend)
    ops.CHUNK_BYTES = 1024
    puts_at_yield: list[int] = []

    def gen():
        for _ in range(4):
            puts_at_yield.append(len(backend.list_keys()))
            yield b"y" * 4096  # each part spans multiple chunks

    ops.write_parts(0, 1, gen())
    assert puts_at_yield[0] == 0
    assert all(b > a for a, b in zip(puts_at_yield, puts_at_yield[1:])), puts_at_yield


def test_read_parts_truncated_stream_raises(p):
    ops = p.snaps.OperatorSnapshots(p.backends.MemoryBackend())
    ops.CHUNK_BYTES = 128
    n = ops.write_parts(0, 3, iter([b"a" * 500, b"b" * 500]))
    with pytest.raises(EOFError, match="truncated"):
        list(ops.read_parts(0, 3, n - 1))


def test_read_op_state_monolithic_without_fmt(p):
    ops = p.snaps.OperatorSnapshots(p.backends.MemoryBackend())
    state = {"_live": {1: "a", 2: "b"}}
    n = ops.write(4, 9, state)
    assert p.snaps.read_op_state(ops, 4, {"cls": "X", "at": 9, "chunks": n},
                                 p.executor.Node) == state


def test_operator_snapshot_chunks_at_eight_mib(p):
    ops = p.snaps.OperatorSnapshots(p.backends.MemoryBackend())
    assert ops.CHUNK_BYTES == 8 << 20
    blob = np.arange((9 << 20) // 8, dtype=np.int64)  # 9 MiB: two chunks
    n = ops.write(0, 1, {"a": blob})
    assert n == 2
    np.testing.assert_array_equal(ops.read(0, 1, n)["a"], blob)


# -- the stateful operators' parts ------------------------------------------------------------


def _run_groupby(p, reducer: str):
    """A streamed groupby over 600 words in 6 commits; the run's GroupByReduce node."""
    pw = p.pw

    class S(pw.io.python.ConnectorSubject):
        def run(self):
            for start in range(0, 600, 100):
                self.next_batch({"g": [f"w{i % 37}" for i in range(start, start + 100)],
                                 "v": list(range(start, start + 100))})
                self.commit()

    t = pw.io.python.read(S(), schema=pw.schema_from_types(g=str, v=int),
                          autocommit_duration_ms=None)
    red = {"count": pw.reducers.count(), "sum": pw.reducers.sum(pw.this.v),
           "min": pw.reducers.min(pw.this.v)}[reducer]
    counts = t.groupby(pw.this.g).reduce(pw.this.g, r=red)
    runner = importlib.import_module(f"{p.name}.internals.graph_runner").GraphRunner(**p.run)
    caps = runner.run_tables(counts)
    node = next(n for n in runner.executor.nodes if type(n).__name__ == "GroupByReduce")
    return node, caps[0]


def _streamed(p, node, cls_name):
    ops = p.snaps.OperatorSnapshots(p.backends.MemoryBackend())
    n = ops.write_parts(0, 1, node.snapshot_state_parts())
    return p.snaps.read_op_state(ops, 0, {"cls": cls_name, "at": 1, "chunks": n, "fmt": "parts"},
                                 type(node))


def _assert_arena_equal(a, b):
    for key in ("_counts", "_gkey_by_slot", "_emitted"):
        np.testing.assert_array_equal(a[key], b[key])
    for group in ("_accs", "_prev", "_gvals"):
        assert len(a[group]) == len(b[group])
        for x, y in zip(a[group], b[group]):
            if x is None or y is None:
                assert x is None and y is None
            else:
                np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("reducer", ["count", "sum", "min"])
def test_groupby_parts_equal_monolithic_and_reference(reducer):
    states = {}
    for pkg in PACKAGES:
        p = _ns(pkg)
        p.pw.G.clear()
        node, _ = _run_groupby(p, reducer)
        streamed = _streamed(p, node, "GroupByReduce")
        mono = node.snapshot_state()
        if pkg == "pathway_tpu_torch":
            assert_host_only(mono)
        assert streamed["dense"] == mono["dense"] == (reducer != "min")
        assert streamed["gerrs"] == mono["gerrs"]
        # the general path's accumulators define no __eq__: compare their bytes
        assert pickle.dumps(streamed["_state"]) == pickle.dumps(mono["_state"])
        if mono["dense"]:
            _assert_arena_equal(streamed["arena"], mono["arena"])
        states[pkg] = mono
        p.pw.G.clear()
    ref, port = states["pathway_tpu"], states["pathway_tpu_torch"]
    assert ref["dense"] == port["dense"]
    if ref["dense"]:
        _assert_arena_equal(ref["arena"], port["arena"])
    else:
        assert sorted(ref["_state"]) == sorted(port["_state"])


def _persisted_groupby_leg(p, cfg, reducer: str, commits: int) -> list:
    """One persisted run of a groupby over the first ``commits`` of six 100-row commits; its
    update stream as (group, value, diff), sorted within the run."""
    pw = p.pw
    pw.G.clear()

    class S(pw.io.python.ConnectorSubject):
        def run(self):
            for start in range(0, 100 * commits, 100):
                self.next_batch({"g": [f"w{i % 37}" for i in range(start, start + 100)],
                                 "v": list(range(start, start + 100))})
                self.commit()

    t = pw.io.python.read(S(), schema=pw.schema_from_types(g=str, v=int),
                          autocommit_duration_ms=None, name="rows")
    red = {"count": pw.reducers.count(), "sum": pw.reducers.sum(pw.this.v),
           "min": pw.reducers.min(pw.this.v)}[reducer]
    out = t.groupby(pw.this.g).reduce(pw.this.g, r=red)
    seen: list = []
    pw.io.subscribe(out, on_change=lambda key, row, time, is_addition: seen.append(
        (row["g"], int(row["r"]), 1 if is_addition else -1)))
    pw.run(persistence_config=cfg, **p.run)
    pw.G.clear()
    return sorted(seen)


@pytest.mark.parametrize("reducer", ["count", "sum", "min"])
def test_groupby_restored_from_its_snapshot(reducer, tmp_path):
    """A persisted groupby stopped after three commits and restarted over six: the restored
    state (the dense arena with its native slot map rebuilt from the keys in slot order, or the
    general path's accumulators) continues exactly, in both packages alike."""
    streams = {}
    for pkg in PACKAGES:
        p = _ns(pkg)
        ps = importlib.import_module(f"{pkg}.persistence")
        cfg = ps.Config.simple_config(ps.Backend.filesystem(str(tmp_path / pkg)))
        leg1 = _persisted_groupby_leg(p, cfg, reducer, 3)
        leg2 = _persisted_groupby_leg(p, cfg, reducer, 6)
        m = ps.PersistenceManager(cfg)
        assert m.op_snapshots, "no operator snapshot was committed"
        m.close()
        streams[pkg] = (leg1, leg2)
    assert streams["pathway_tpu"] == streams["pathway_tpu_torch"]
    leg1, leg2 = streams["pathway_tpu_torch"]
    net: dict = {}
    for g, r, d in leg1 + leg2:
        net[(g, r)] = net.get((g, r), 0) + d
    want = {}
    for g in range(37):
        vals = [i for i in range(600) if i % 37 == g]
        want[(f"w{g}", {"count": len(vals), "sum": sum(vals), "min": min(vals)}[reducer])] = 1
    assert {k: v for k, v in net.items() if v} == want


def _run_join(p):
    pw = p.pw

    class L(pw.io.python.ConnectorSubject):
        def run(self):
            for start in range(0, 400, 100):
                self.next_batch({"k": list(range(start, start + 100)),
                                 "a": [f"left-{i}" for i in range(start, start + 100)]})
                self.commit()

    lt = pw.io.python.read(L(), schema=pw.schema_from_types(k=int, a=str),
                           autocommit_duration_ms=None)
    rt = pw.debug.table_from_rows(pw.schema_from_types(k=int, b=str),
                                  [(i, f"right-{i}") for i in range(0, 400, 4)])
    joined = lt.join(rt, lt.k == rt.k).select(pw.this.a, pw.this.b)
    runner = importlib.import_module(f"{p.name}.internals.graph_runner").GraphRunner(**p.run)
    caps = runner.run_tables(joined)
    assert len(caps[0].state._rows) == 100
    return next(n for n in runner.executor.nodes if type(n).__name__ == "Join")


def test_join_parts_equal_monolithic_and_reference():
    sides = {}
    for pkg in PACKAGES:
        p = _ns(pkg)
        p.pw.G.clear()
        node = _run_join(p)
        streamed = _streamed(p, node, "Join")
        mono = node.snapshot_state()
        if pkg == "pathway_tpu_torch":
            assert_host_only(mono)
        assert sorted(streamed) == sorted(mono)
        for f in ("_cleft", "_cright"):
            if f not in mono:
                continue
            a = pickle.loads(pickle.dumps(streamed[f]))
            b = pickle.loads(pickle.dumps(mono[f]))
            assert len(a) == len(b)
            assert len(a._runs) == len(b._runs)
            for ra, rb in zip(a._runs, b._runs):
                for j in (0, 1, 3):
                    np.testing.assert_array_equal(ra[j], rb[j])
            # the unpickled arrangement carries no identity-keyed memo
            assert a._range_cache == {} and a._pending == []
        sides[pkg] = {f: pickle.loads(pickle.dumps(mono[f])) for f in ("_cleft", "_cright")
                      if f in mono}
        p.pw.G.clear()
    ref, port = sides["pathway_tpu"], sides["pathway_tpu_torch"]
    assert sorted(ref) == sorted(port)
    for f in ref:
        assert len(ref[f]) == len(port[f])
        rk = np.sort(np.concatenate([r[1] for r in ref[f]._runs]))
        pk = np.sort(np.concatenate([r[1] for r in port[f]._runs]))
        np.testing.assert_array_equal(rk, pk)
