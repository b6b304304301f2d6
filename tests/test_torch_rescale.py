"""The port's elastic rescale (``pathway_tpu_torch/rescale/``, ``split_state``/``merge_states`` of
the engine's nodes and operators, ``PATHWAY_ELASTIC`` in ``persistence/manager.py``) against the
JAX package's, on the CPU: the cases of ``tests/test_rescale.py`` and
``tests/test_rescale_roundtrip.py`` that do not need the reference's chaos plan, CLI or metrics,
each run through both packages (the port with ``device="cpu"``), which must give the same
results.

- A persisted wordcount 1 -> 3 -> 1 workers with exact segment outputs; the wordcount and the
  wordcount join 2 -> 4 -> 1 against one unsharded run.
- The elastic boot in process, and the refusal without ``PATHWAY_ELASTIC``; peers waiting for
  worker 0's promote, and giving up after ``PATHWAY_RESCALE_WAIT_S``.
- An empty store, a same-count no-op, a target below 1.
- ``split_state``/``merge_states`` of ``GroupByReduce`` (dense and general), ``Join``, a pinned
  node and a replicated source: each destination's piece holds the same keys and values in both
  packages, and the pieces merge back to the state; the port's join also splits its pad ledgers
  (a NameError in the reference).
- The dry run's plan; the offset union on a conflict; the resharder's destination of a state key
  equal to the live ``Exchange``'s at M = 1, 2, 3, 4 and 8.
- A crash at each phase (a test backend raising on the n-th write): the store boots at the old
  count, or at the new one once the marker moved, and counts exactly.
- A transactional csv sink across a rescale, written exactly once; a small persisted
  ``pw.indexing`` store at 1 worker restored at 2 through ``PATHWAY_ELASTIC=1``; a store the JAX
  package wrote refused by the port's resharder.

Tolerance: tables, keys and offsets exactly; index answers within one bf16 ulp
(``test_torch_indexing.assert_knn_close``). Every streaming run has a time limit of its own.
"""

from __future__ import annotations

import csv
import os
import threading
import time
from collections import Counter

import numpy as np
import pytest

from test_torch_indexing import assert_knn_close
from test_torch_recovery import DIM, _text_vec
from torch_io_runs import run_bounded
from torch_state_runs import PACKAGES, ns, reset_state_tiers, stream_run


@pytest.fixture(autouse=True)
def _tiers(monkeypatch):
    reset_state_tiers(monkeypatch)


def _mem_cfg(p, name: str):
    p.backends.MemoryBackend.drop(name)
    return p.persistence.Config.simple_config(p.persistence.Backend.memory(name),
                                              snapshot_interval_ms=5)


def _quiet(_msg: str) -> None:
    pass


# -- the wordcount through rescales --------------------------------------------------------------

WORDS = ["a", "b", "a", "c"] * 3 + ["a", "c", "d"] * 4 + ["d", "b"] * 2


def _wordcount(pw, t):
    return t.groupby(pw.this.word).reduce(pw.this.word, c=pw.reducers.count())


def _words(upto: int, words=WORDS) -> list:
    return [{"word": [w]} for w in words[:upto]]


def _segment(p, upto: int, workers: int, cfg, words=WORDS, build=_wordcount) -> dict:
    """One persisted segment over ``words[:upto]`` (the subject re-sends from the start; the
    source's seek skips what the store holds); its rows as {word: count}."""
    final, _ = stream_run(p, build, _words(upto, words), workers, cfg, name="words",
                          schema={"word": str})
    return {row[0]: row[1] for row in final.values()}


def test_rescale_1_to_3_to_1_exact_segment_outputs():
    segs = {}
    for pkg in PACKAGES:
        p = ns(pkg)
        cfg = _mem_cfg(p, "resc-core")
        root = p.backends.MemoryBackend("resc-core")
        seg1 = _segment(p, 12, 1, cfg)
        assert seg1 == {"a": 6, "b": 3, "c": 3}
        report = p.rescale.rescale(root, 3, log=_quiet)
        assert (report["from"], report["to"], report["epoch"]) == (1, 3, 1)
        assert p.layout.read_marker(root) == (3, 1)
        for j in range(3):
            assert any(k.startswith(f"epoch-1/worker-{j}/meta/") for k in root.list_keys())
        seg2 = _segment(p, 24, 3, cfg)
        assert seg2 == {"a": 10, "c": 7, "d": 4}  # only the words of the new ticks
        p.rescale.rescale(root, 1, log=_quiet)
        seg3 = _segment(p, 28, 1, cfg)
        assert {**seg1, **seg2, **seg3} == dict(Counter(WORDS))
        segs[pkg] = (seg1, seg2, seg3)
    assert segs["pathway_tpu"] == segs["pathway_tpu_torch"]


RT_WORDS = (["foo", "bar", "foo", "baz", "qux"] * 3 + ["foo", "qux", "zap"] * 4
            + ["zap", "bar", "baz"] * 3)
WEIGHTS = {"foo": 2, "bar": 3, "baz": 5, "qux": 7, "zap": 11}


def _wordcount_join(pw, t):
    lines = ["word | weight"] + [f"{w} | {x}" for w, x in WEIGHTS.items()]
    weights = pw.debug.table_from_markdown("\n".join(lines))
    return _wordcount(pw, t).join(weights, pw.left.word == pw.right.word).select(
        pw.left.word, score=pw.left.c * pw.right.weight)


@pytest.mark.parametrize("name", ["wordcount", "wordcount_join"])
def test_rescaled_segments_match_unsharded_run(name):
    build = {"wordcount": _wordcount, "wordcount_join": _wordcount_join}[name]
    batches = _words(len(RT_WORDS), RT_WORDS)
    finals = {}
    for pkg in PACKAGES:
        p = ns(pkg)
        _, expected = stream_run(p, build, batches, 1, _mem_cfg(p, f"rt-base-{name}"),
                                 name="words", schema={"word": str})
        cfg = _mem_cfg(p, f"rt-seg-{name}")
        acc: Counter = Counter()
        prev = None
        for upto, workers in ((15, 2), (27, 4), (len(RT_WORDS), 1)):
            if prev is not None:
                report = p.rescale.rescale(p.backends.MemoryBackend(f"rt-seg-{name}"), workers,
                                           log=_quiet)
                assert (report["from"], report["to"]) == (prev, workers)
            _, seg = stream_run(p, build, batches[:upto], workers, cfg, name="words",
                                schema={"word": str})
            acc.update(seg)
            prev = workers
        assert +acc == +expected, pkg
        truth = Counter(RT_WORDS)
        scale = WEIGHTS if name == "wordcount_join" else dict.fromkeys(WEIGHTS, 1)
        assert +acc == Counter({(w, c * scale[w]): 1 for w, c in truth.items()})
        finals[pkg] = +acc
    assert finals["pathway_tpu"] == finals["pathway_tpu_torch"]


def test_elastic_boot_reshards_in_process(monkeypatch):
    segs = {}
    for pkg in PACKAGES:
        p = ns(pkg)
        cfg = _mem_cfg(p, "resc-elastic")
        _segment(p, 12, 2, cfg)
        remedy = "pathway-tpu rescale" if pkg == "pathway_tpu" else \
            r"pathway_tpu_torch\.rescale\.rescale\(backend, 4\)"
        with pytest.raises(RuntimeError, match=remedy):
            _segment(p, 24, 4, cfg)
        monkeypatch.setenv("PATHWAY_ELASTIC", "1")
        before = p.rescale.stats()["total"]
        segs[pkg] = _segment(p, 24, 4, cfg)
        monkeypatch.delenv("PATHWAY_ELASTIC")
        assert p.rescale.stats()["total"] == before + 1
        assert segs[pkg] == {"a": 10, "c": 7, "d": 4}
        assert p.layout.read_marker(p.backends.MemoryBackend("resc-elastic")) == (4, 1)
    assert segs["pathway_tpu"] == segs["pathway_tpu_torch"]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_peers_wait_for_worker_0s_promote(pkg, monkeypatch):
    p = ns(pkg)
    cfg = _mem_cfg(p, "resc-wait")
    _segment(p, 12, 1, cfg)
    root = p.backends.MemoryBackend("resc-wait")
    monkeypatch.setenv("PATHWAY_ELASTIC", "1")
    monkeypatch.setenv("PATHWAY_RESCALE_WAIT_S", "0.3")
    resolve = p.persistence.PersistenceManager._resolve_layout
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="PATHWAY_RESCALE_WAIT_S"):
        resolve(root, 2, 1)  # no worker 0 promotes: the peer gives up
    assert 0.3 <= time.monotonic() - t0 < 5
    assert p.layout.read_marker(root) == (1, 0)
    monkeypatch.setenv("PATHWAY_RESCALE_WAIT_S", "30")
    got: list = []
    peer = threading.Thread(target=lambda: got.append(resolve(root, 2, 1)))
    peer.start()
    time.sleep(0.3)
    assert peer.is_alive() and not got  # still waiting for the marker
    assert resolve(root, 2, 0) == 1  # worker 0 reshards and promotes epoch 1
    peer.join(30)
    assert got == [1]
    monkeypatch.delenv("PATHWAY_ELASTIC")
    assert _segment(p, 24, 2, cfg) == {"a": 10, "c": 7, "d": 4}


@pytest.mark.parametrize("pkg", PACKAGES)
def test_rescale_empty_store_noop_and_bad_target(pkg):
    p = ns(pkg)
    with pytest.raises(p.rescale.NoClusterMarker, match="no cluster marker"):
        p.rescale.rescale(p.backends.MemoryBackend(), 3, log=_quiet)
    assert issubclass(p.rescale.NoClusterMarker, p.rescale.RescaleError)
    cfg = _mem_cfg(p, "resc-noop")
    _segment(p, 12, 1, cfg)
    root = p.backends.MemoryBackend("resc-noop")
    keys = sorted(root.list_keys())
    assert p.rescale.rescale(root, 1, log=_quiet)["noop"] is True
    assert sorted(root.list_keys()) == keys
    for bad in (0, -2):
        with pytest.raises(p.rescale.RescaleError, match=f"cannot rescale to {bad} workers"):
            p.rescale.rescale(root, bad, log=_quiet)
    # a marker with no committed state behind it is adopted, not resharded
    fresh = p.backends.MemoryBackend()
    p.layout.write_marker(fresh, 2, 0)
    assert p.rescale.rescale(fresh, 3, log=_quiet)["noop"] is True
    assert p.layout.read_marker(fresh) == (3, 0)


# -- split and merge ----------------------------------------------------------------------------

MIXED_WORDS = ["foo", "bar", "baz", "qux", "zap", "foo", "bar", "w1", "w2", "w3"] * 4


def _mixed(pw, t):
    """A dense groupby (count, sum), a general one (min) and an inner join of the two."""
    t = t.select(pw.this.word, v=pw.apply_with_type(len, int, pw.this.word))
    dense = t.groupby(pw.this.word).reduce(pw.this.word, c=pw.reducers.count(),
                                           s=pw.reducers.sum(pw.this.v))
    general = t.groupby(pw.this.word).reduce(pw.this.word, m=pw.reducers.min(pw.this.v))
    return dense.join(general, pw.left.word == pw.right.word).select(
        pw.left.word, pw.left.c, pw.left.s, pw.right.m)


def _canon(v):
    """A package-free form of a piece of operator state: arrangements as multisets of their
    rows, arenas by group key, containers by key, numbers as Python numbers."""
    name = type(v).__name__
    if name == "_SortedSide":
        rows: Counter = Counter()
        for run in v._runs:
            for i in range(len(run[0])):
                rows[(int(run[0][i]), int(run[1][i]),
                      *(_canon(np.asarray(c)[i]) for c in run[2]))] += int(run[3][i])
        return ("sorted", frozenset((+rows).items()))
    if name == "MultiIndex":
        return ("multi", frozenset((int(jk), int(rk), _canon(entries))
                                   for jk, grp in v._index.items()
                                   for rk, entries in grp.items()))
    if name == "RowState":
        return ("rows", frozenset((int(k), _canon(r)) for k, r in v.iter_items()))
    if isinstance(v, dict) and "arena" in v and "dense" in v:
        a = v["arena"]
        slots = []
        for i, gk in enumerate(np.asarray(a["_gkey_by_slot"]).tolist()):
            slots.append((gk, int(a["_counts"][i]), bool(a["_emitted"][i]),
                          tuple(None if x is None else _canon(x[i]) for x in a["_accs"]),
                          tuple(_canon(x[i]) for x in a["_prev"]),
                          tuple(None if x is None else _canon(x[i]) for x in a["_gvals"])))
        rest = {k: _canon(x) for k, x in v.items() if k != "arena"}
        return ("arena", frozenset(slots), frozenset(rest.items()))
    if isinstance(v, dict):
        return ("dict", frozenset((_canon(k), _canon(x)) for k, x in v.items()
                                  if not (isinstance(k, str) and k.startswith("__"))))
    if isinstance(v, (list, tuple)):
        return tuple(_canon(x) for x in v)
    if isinstance(v, np.ndarray):
        return tuple(_canon(x) for x in v.tolist())
    if isinstance(v, np.generic):
        return v.item()
    return v


def _mask(M: int, j: int, K):
    return lambda keys: K.shard_of(np.asarray(keys, dtype=np.uint64), M) == j


def _op_states(p, root) -> list:
    """(class, state) of each stateful operator in a one-worker store's newest snapshot."""
    meta = p.snapshots.MetadataAccessor(root).current
    ops = meta["op_snapshots"][-1]["ops"]
    out = []
    for rank in sorted(ops, key=int):
        desc = ops[rank]
        cls = p.resharder._node_class(desc["cls"])
        out.append((cls, p.snapshots.read_op_state(p.snapshots.OperatorSnapshots(root),
                                                    int(rank), desc, cls)))
    return out


def test_split_merge_pieces_equal_the_reference():
    pieces = {}
    for pkg in PACKAGES:
        p = ns(pkg)
        cfg = _mem_cfg(p, "resc-split")
        stream_run(p, _mixed, _words(len(MIXED_WORDS), MIXED_WORDS), 1, cfg, name="words",
                   schema={"word": str})
        states = _op_states(p, p.backends.MemoryBackend("resc-split"))
        names = sorted(cls.__name__ for cls, _ in states)
        assert names == ["GroupByReduce", "GroupByReduce", "Join"], names
        dense = [s for cls, s in states if cls.__name__ == "GroupByReduce" and s["dense"]]
        assert len(dense) == 1  # one arena, one general state
        got = []
        for cls, state in states:
            for M in (2, 3, 4):
                parts = [cls.split_state(state, _mask(M, j, p.K)) for j in range(M)]
                got.append((cls.__name__, M, tuple(_canon(x) for x in parts)))
                merged = cls.merge_states(parts)
                assert _canon(merged) == _canon(state), (cls.__name__, M)
        pieces[pkg] = got
    assert pieces["pathway_tpu"] == pieces["pathway_tpu_torch"]


def _row_path_join(p):
    """A left join on the row path (``react_to_right=False``, as ``asof_now`` joins run, the
    index's repack among them), fed so that its pad ledger ``_lpad`` holds rows."""
    D = p.delta.Delta
    left = p.ops.StaticSource(np.zeros(0, np.uint64), {"jk": np.zeros(0, np.uint64),
                                                        "x": np.zeros(0, np.int64)})
    right = p.ops.StaticSource(np.zeros(0, np.uint64), {"jk": np.zeros(0, np.uint64),
                                                         "y": np.zeros(0, np.int64)})
    j = p.ops.Join(left, right, "jk", "jk", ["x"], ["y"], ["x", "y"], mode="left",
                   react_to_right=False)
    lk = p.K.mix_columns([np.arange(40, dtype=np.int64)], 40, salt=7, register=False)
    jk = p.K.mix_columns([np.arange(40, dtype=np.int64) % 9], 40, salt=8, register=False)
    j.process(2, [D(keys=lk[:20], data={"jk": jk[:20], "x": np.arange(20)}), None])
    j.process(4, [None, D(keys=jk[:3] + np.uint64(1), data={"jk": jk[:3], "y": np.arange(3)})])
    j.process(6, [D(keys=lk[20:], data={"jk": jk[20:], "x": np.arange(20, 40)}), None])
    return j


def test_join_pad_ledgers_split_and_merge():
    """A row-path join's pad ledger (row-keyed, routed by the rk -> jk map) splits by the join
    key's shard and merges back in the port. The reference's ``_split_rk_dict`` reads an unbound
    name there, so on the same state it raises ``NameError``: the port's repair."""
    for pkg in PACKAGES:
        p = ns(pkg)
        j = _row_path_join(p)
        state = j.snapshot_state()
        assert len(state["_lpad"]) > 10  # left rows padded for want of a right row
        if pkg == "pathway_tpu":
            with pytest.raises(NameError):
                type(j).split_state(dict(state), _mask(2, 0, p.K))
            continue
        for M in (2, 3, 4):
            parts = [type(j).split_state(state, _mask(M, jj, p.K)) for jj in range(M)]
            assert sum(len(x["_lpad"]) for x in parts) == len(state["_lpad"])
            for jj, part in enumerate(parts):
                rk2jk = type(j)._row_jk_map(state)
                assert all(p.K.shard_of(np.array([rk2jk[rk]], np.uint64), M)[0] == jj
                           for rk in part["_lpad"])
            assert _canon(type(j).merge_states(parts)) == _canon(state)


def test_join_rk_to_jk_map_is_built_once_a_piece(monkeypatch):
    """The resharder splits one source piece once per destination; the join's row-key ->
    join-key scan over every arranged row runs once a piece (its cache), not once a
    destination, in both packages."""
    for pkg in PACKAGES:
        p = ns(pkg)
        j = _row_path_join(p)
        cls = type(j)
        built = []
        scan = cls._row_jk_map.__func__
        monkeypatch.setattr(cls, "_row_jk_map", classmethod(
            lambda c, state: built.append(1) or scan(c, state)))
        state = j.snapshot_state()
        if pkg == "pathway_tpu":
            state["_lpad"] = {}  # the reference's split cannot take a pad (see above)
        for jj in range(4):
            cls.split_state(state, _mask(4, jj, p.K))
        assert len(built) == 1, pkg


def test_pinned_and_replicated_state():
    got = {}
    for pkg in PACKAGES:
        p = ns(pkg)
        assert p.ops.Capture.RESHARD == p.ops.GradualBroadcast.RESHARD == "pinned"
        assert importlib_ext(pkg).ExternalIndexNode.RESHARD == "pinned"
        assert p.ex.RealtimeSource.RESHARD == "replicate"
        real, pristine = {"state": "full"}, {"state": "empty"}
        everyone = lambda keys: np.ones(len(keys), dtype=bool)  # noqa: E731
        assert p.ops.Capture.split_state(real, everyone) is real
        assert p.ops.Capture.merge_states([real, pristine]) is real
        owner = {"_seen": {"a.txt", "b.txt"}, "_last": {"k": 4}}
        fresh = {"_seen": set(), "_last": {}}
        assert p.ex.RealtimeSource.merge_states([fresh, owner]) == owner
        stale = {"_seen": {"a.txt"}, "_file_rows": {"f": 999}, "n": 3}
        advanced = {"_seen": {"a.txt"}, "_file_rows": {"f": 1500}, "n": 7}
        got[pkg] = p.ex.RealtimeSource.merge_states([stale, advanced])
        assert got[pkg] == {"_seen": {"a.txt"}, "_file_rows": {"f": 1500}, "n": 7}
    assert got["pathway_tpu"] == got["pathway_tpu_torch"]
    scanner = ns("pathway_tpu_torch")
    from pathway_tpu_torch.io._object_scanner import ObjectScanSource

    assert ObjectScanSource.RESHARD == "replicate"
    assert scanner.resharder._node_class("ObjectScanSource") is ObjectScanSource


def importlib_ext(pkg: str):
    import importlib

    return importlib.import_module(f"{pkg}.engine.external_index")


def test_temporal_buffers_split_by_row_key_and_merge():
    """``BufferUntil``/``ForgetAfter`` keep their rows under event-time thresholds: the split
    routes each entry by its row key, the merge takes the least watermark, in both packages."""
    keys = [int(k) for k in ns("pathway_tpu_torch").K.mix_columns(
        [np.arange(12, dtype=np.int64)], 12, register=False)]
    state = {"_buffer": {10: [(keys[i], (i,), 1) for i in range(6)],
                         20: [(keys[i], (i,), 1) for i in range(6, 12)]}, "_watermark": 7}
    got = {}
    for pkg in PACKAGES:
        p = ns(pkg)
        for cls in (p.ops.BufferUntil, p.ops.ForgetAfter):
            parts = [cls.split_state(state, _mask(3, j, p.K)) for j in range(3)]
            assert sorted(e for part in parts for es in part["_buffer"].values() for e in es) \
                == sorted(e for es in state["_buffer"].values() for e in es)
            for j, part in enumerate(parts):
                ks = [e[0] for es in part["_buffer"].values() for e in es]
                assert all(p.K.shard_of(np.array(ks, np.uint64), 3) == j) if ks else True
            merged = cls.merge_states(parts + [{"_buffer": {}, "_watermark": 5}])
            assert merged["_watermark"] == 5
            got[(pkg, cls.__name__)] = _canon(parts)
    assert got[("pathway_tpu", "BufferUntil")] == got[("pathway_tpu_torch", "BufferUntil")]
    assert got[("pathway_tpu", "ForgetAfter")] == got[("pathway_tpu_torch", "ForgetAfter")]


def test_dry_run_plan_equals_the_reference():
    plans = {}
    for pkg in PACKAGES:
        p = ns(pkg)
        cfg = _mem_cfg(p, "resc-dry")
        stream_run(p, _wordcount_join, _words(len(RT_WORDS), RT_WORDS), 2, cfg, name="words",
                   schema={"word": str})
        root = p.backends.MemoryBackend("resc-dry")
        keys = {k: root.get_value(k) for k in root.list_keys()}
        report = p.rescale.rescale(root, 3, dry_run=True, log=_quiet)
        assert {k: root.get_value(k) for k in root.list_keys()} == keys  # nothing written
        assert report["dry_run"] is True and report["ranks"] == 2
        assert report["state_bytes_total"] == sum(o["state_bytes"] for o in report["operators"])
        assert all(o["state_bytes"] > 0 for o in report["operators"])
        # the tail's chunk counts follow the commits' timing, so only their number compares
        assert len(report["tail_chunks_per_source"]) == 2
        plans[pkg] = (report["from"], report["to"], report["epoch"], report["ranks"],
                      [(o["rank"], o["cls"], o["mode"], o["action"], o["chunks_per_source"])
                       for o in report["operators"]])
    assert plans["pathway_tpu"] == plans["pathway_tpu_torch"]


def test_offset_union_on_a_conflict():
    metas = [
        {"offsets": {"s": {"rows": 12}, "t": {"rows": 3}}},
        {"offsets": {"s": {"rows": 40}, "u": {"rows": 999}}},
        {"offsets": {"u": {"rows": 1000}, "v": None}},
    ]
    got = {}
    for pkg in PACKAGES:
        logs: list = []
        got[pkg] = ns(pkg).resharder._merge_offsets(metas, logs.append)
        assert len(logs) == 1 and "conflict" in logs[0] and "['s', 'u']" in logs[0]
    assert got["pathway_tpu"] == got["pathway_tpu_torch"] == {
        "s": {"rows": 40}, "t": {"rows": 3}, "u": {"rows": 1000}}


@pytest.mark.parametrize("M", [1, 2, 3, 4, 8])
def test_resharder_routes_state_as_the_live_exchange(M):
    """Each group key of a rescaled groupby lands on the worker that the live ``Exchange`` at M
    workers sends the group's rows to: the resharder's ``shard_rows`` and the Exchange's
    ``shard_of`` are one function of the key."""
    from types import SimpleNamespace

    p = ns("pathway_tpu_torch")
    words = [f"w{i}" for i in range(300)]
    name = f"resc-route-{M}"
    cfg = _mem_cfg(p, name)
    stream_run(p, _wordcount, [{"word": words[s:s + 50]} for s in range(0, 300, 50)],
               1 if M != 1 else 2, cfg, name="words", schema={"word": str})
    root = p.backends.MemoryBackend(name)
    p.rescale.rescale(root, M, log=_quiet)
    # the live exchange at M workers: a GroupByReduce's spec over the grouped column
    gb = p.ops.GroupByReduce(p.ops.StaticSource(np.zeros(0, np.uint64), {"word": np.array([])}),
                             ["word"], [("c", p.reducers.CountReducer(), [])])
    sent: list = []
    comm = SimpleNamespace(exchange=lambda ch, t, w, buckets: sent.append(buckets) or [])
    ex = p.ops.Exchange(gb.inputs[0], gb.exchange_specs()[0], SimpleNamespace(
        n_workers=M, worker_id=0, comm=comm))
    col = np.array(words, dtype=object)
    ex.process(2, [p.delta.Delta(keys=np.arange(300, dtype=np.uint64), data={"word": col})])
    live = {}
    for w, bucket in enumerate(sent[0]):
        for v in ([] if bucket is None else bucket.data["word"].tolist()):
            live[v] = w
    assert len(live) == 300
    held = {}
    for j in range(M):
        view = p.backends.PrefixBackend(root, p.layout.worker_namespace(1, M, j)) \
            if p.layout.worker_namespace(1, M, j) else root
        (cls, state), = _op_states(p, view)
        for v in state["arena"]["_gvals"][0].tolist():
            held[v] = j
    assert held == live


# -- what the resharder reads: metadata and the input tail ------------------------------------


@pytest.mark.parametrize("pkg", PACKAGES)
def test_metadata_accessor_falls_back_from_a_torn_newest_version(pkg):
    p = ns(pkg)
    b = p.backends.MemoryBackend()
    b.put_value("meta/meta-00000000", b'{"last_time": 4}')
    b.put_value("meta/meta-00000001", b'{"last_time": 9')  # torn mid-write
    acc = p.snapshots.MetadataAccessor(b)
    assert (acc.current, acc.fell_back_from) == ({"last_time": 4}, 1)
    acc.commit({"last_time": 12})  # the next commit rewrites the torn version number
    again = p.snapshots.MetadataAccessor(b)
    assert (again.current, again.fell_back_from) == ({"last_time": 12}, None)


def test_snapshot_reader_batches_is_a_generator():
    """The input tail the resharder routes comes through ``SnapshotReader.batches``: a
    generator over the chunks (one decoded at a time) that skips entries at or before
    ``after_time``, in commit order, in both packages."""
    import types

    tails = {}
    for pkg in PACKAGES:
        p = ns(pkg)
        b = p.backends.MemoryBackend()
        w = p.snapshots.SnapshotWriter(b, 0)
        for t, words in ((2, ["a", "b"]), (4, ["c"]), (6, ["d", "e", "f"])):
            keys = p.K.mix_columns([np.array(words, dtype=object)], len(words), register=False)
            w.record(t, "words", p.delta.Delta(keys=keys, data={"word": np.array(words, object)}))
            if t != 4:
                w.flush()
        out = p.snapshots.SnapshotReader(b, w.n_chunks).batches(after_time=2)
        assert isinstance(out, types.GeneratorType) and w.n_chunks == 2
        tails[pkg] = [(t, pid, d.keys.tolist(), d.data["word"].tolist()) for t, pid, d in out]
        assert [t for t, *_ in tails[pkg]] == [4, 6]
    assert tails["pathway_tpu"] == tails["pathway_tpu_torch"]


# -- a crash at each phase ---------------------------------------------------------------------


class _Crash(RuntimeError):
    pass


def _crashing(p, inner, crash_at: int | None, log: list):
    """``inner`` wrapped: every write and removal is appended to ``log`` as (op, key), and the
    ``crash_at``-th one (from 0) raises instead of running."""

    class Crashing(p.backends.PersistenceBackend):
        def describe(self):
            return inner.describe()

        def get_value(self, key):
            return inner.get_value(key)

        def list_keys(self):
            return inner.list_keys()

        def size_of(self, key):
            return inner.size_of(key)

        def _op(self, op, key):
            if crash_at is not None and len(log) == crash_at:
                raise _Crash(f"crash at {op} {key}")
            log.append((op, key))

        def put_value(self, key, value):
            self._op("put", key)
            inner.put_value(key, value)

        def remove_key(self, key):
            self._op("remove", key)
            inner.remove_key(key)

    return Crashing()


def _copy_store(p, src: str, dst: str):
    p.backends.MemoryBackend.drop(dst)
    a, b = p.backends.MemoryBackend(src), p.backends.MemoryBackend(dst)
    for k in a.list_keys():
        b.put_value(k, a.get_value(k))


def test_crash_at_each_phase_leaves_a_bootable_store():
    outcomes = {}
    for pkg in PACKAGES:
        p = ns(pkg)
        _segment(p, 12, 1, _mem_cfg(p, "resc-crash"))
        # the writes of a clean 1 -> 3 rescale, in order
        _copy_store(p, "resc-crash", "resc-crash-clean")
        ops: list = []
        p.rescale.rescale(_crashing(p, p.backends.MemoryBackend("resc-crash-clean"), None, ops),
                          3, log=_quiet)
        marker = ops.index(("put", "cluster"))
        points = {
            "stage": next(i for i, (_, k) in enumerate(ops) if k.startswith("rescale-tmp/")),
            "promote": next(i for i, (o, k) in enumerate(ops)
                            if o == "put" and not k.startswith("rescale-tmp/") and k != "cluster"),
            "marker": marker,
            "cleanup": next(i for i in range(marker + 1, len(ops)) if ops[i][0] == "remove"),
        }
        assert points["stage"] < points["promote"] < points["marker"] < points["cleanup"]
        seen = {}
        for phase, at in points.items():
            store = f"resc-crash-{phase}"
            _copy_store(p, "resc-crash", store)
            cfg = p.persistence.Config.simple_config(p.persistence.Backend.memory(store),
                                                     snapshot_interval_ms=5)
            with pytest.raises(_Crash):
                p.rescale.rescale(_crashing(p, p.backends.MemoryBackend(store), at, []), 3,
                                  log=_quiet)
            n = p.layout.read_marker(p.backends.MemoryBackend(store))[0]
            assert n == (3 if phase == "cleanup" else 1), phase
            seen[phase] = (n, _segment(p, 24, n, cfg))
            assert seen[phase][1] == {"a": 10, "c": 7, "d": 4}, phase
            # the next clean rescale sweeps what the crashed one left
            p.rescale.rescale(p.backends.MemoryBackend(store), 2, log=_quiet)
            left = [k for k in p.backends.MemoryBackend(store).list_keys()
                    if k.startswith(("rescale-tmp/", "meta/", "chunks/", "ops/", "epoch-1/"))
                    and not k.startswith(f"epoch-{p.layout.read_marker(p.backends.MemoryBackend(store))[1]}/")]
            assert left == [], (phase, left)
        outcomes[pkg] = seen
    assert outcomes["pathway_tpu"] == outcomes["pathway_tpu_torch"]


# -- delivery, indexing, a foreign store -------------------------------------------------------


def _csv_rows(path) -> list:
    with open(path) as f:
        return [(r["word"], int(r["c"]), int(r["time"]), int(r["diff"]))
                for r in csv.DictReader(f)]


def test_transactional_csv_across_a_rescale(tmp_path, monkeypatch):
    """The port's csv, written by a transactional sink over 2 workers, 4 (the elastic boot) and
    1 (after an offline rescale), holds every count once and nets to the clean counts. The
    JAX package's sink writes nothing in a restarted run whose store was written at 2 or more
    workers (with or without a rescale), so its csv is held only to no batch written twice; the
    subscribed tables of both packages must agree."""
    finals = {}
    for pkg in PACKAGES:
        p = ns(pkg)
        out = str(tmp_path / pkg / "counts.csv")
        store = str(tmp_path / pkg / "pstate")
        cfg = p.persistence.Config.simple_config(p.persistence.Backend.filesystem(store),
                                                 snapshot_interval_ms=5)

        def with_csv(pw_, t, out=out):
            counts = _wordcount(pw_, t)
            pw_.io.csv.write(counts, out, name="counts")
            return counts

        seen: Counter = Counter()
        seen.update(stream_run(p, with_csv, _words(12), 2, cfg, name="words",
                               schema={"word": str})[1])
        monkeypatch.setenv("PATHWAY_ELASTIC", "1")
        seen.update(stream_run(p, with_csv, _words(20), 4, cfg, name="words",
                               schema={"word": str})[1])
        monkeypatch.delenv("PATHWAY_ELASTIC")
        p.rescale.rescale(p.backends.FilesystemBackend(store), 1, log=_quiet)
        seen.update(stream_run(p, with_csv, _words(len(WORDS)), 1, cfg, name="words",
                               schema={"word": str})[1])
        finals[pkg] = +seen
        rows = _csv_rows(out)
        assert len(rows) == len(set(rows)), "a batch was written twice"
        if pkg == "pathway_tpu_torch":
            net: Counter = Counter()
            for w, c, _t, d in rows:
                net[(w, c)] += d
            assert +net == Counter(dict.fromkeys(Counter(WORDS).items(), 1))
            assert all(v in (0, 1) for v in net.values())
    assert finals["pathway_tpu"] == finals["pathway_tpu_torch"] == Counter(
        dict.fromkeys(Counter(WORDS).items(), 1))


def _index_leg(p, cfg, vecs, commits: int, queries: list, workers: int) -> dict:
    """A ``DataIndex`` over the first ``commits`` commits of 16 vectors (a python source named
    ``rows``), then, once worker 0's index holds them, text queries through
    ``query_as_of_now`` (k=3); the answers by query."""
    pw = p.pw
    pw.G.clear()
    n_rows = 16 * commits
    import importlib

    run_mod = importlib.import_module(f"{p.name}.internals.run")

    def held() -> int:
        runner = run_mod._current["runner"]
        peers = getattr(runner, "_peer_executors", None) if runner is not None else None
        nodes = peers[0].nodes if peers else (runner._nodes if runner is not None else [])
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
                           autocommit_duration_ms=None, name=f"queries{len(queries)}")
    factory = pw.indexing.BruteForceKnnFactory(dimensions=DIM, reserved_space=64,
                                               embedder=_text_vec)
    index = factory.build_index(data.data, data)
    res = index.query_as_of_now(qt.q, number_of_matches=3).select(
        qid=pw.left.qid, rid=pw.right.rid, score=pw.right._pw_index_reply_score)
    answers: dict = {}
    pw.io.subscribe(res, on_change=lambda key, row, time, is_addition: answers.__setitem__(
        row["qid"], (list(row["rid"]), [float(s) for s in row["score"]])) if is_addition else None)
    saved = os.environ.get("PATHWAY_THREADS")
    os.environ["PATHWAY_THREADS"] = str(workers)
    try:
        kw = {"persistence_config": cfg} if cfg is not None else {}
        run_bounded(pw, 60, **kw, **p.run)
    finally:
        os.environ["PATHWAY_THREADS"] = saved or "1"
        pw.G.clear()
    return answers


def test_indexing_store_restored_at_2_workers(tmp_path, monkeypatch):
    vecs = np.random.default_rng(5).standard_normal((64, DIM)).astype(np.float32)
    queries = ["alpha", "beta gamma", "delta"]
    got = {}
    for pkg in PACKAGES:
        p = ns(pkg)
        cfg = p.persistence.Config.simple_config(
            p.persistence.Backend.filesystem(str(tmp_path / pkg)))
        assert _index_leg(p, cfg, vecs, 3, [], 1) == {}
        monkeypatch.setenv("PATHWAY_ELASTIC", "1")
        restored = _index_leg(p, cfg, vecs, 4, queries, 2)
        monkeypatch.delenv("PATHWAY_ELASTIC")
        root = p.backends.FilesystemBackend(str(tmp_path / pkg))
        assert p.layout.read_marker(root) == (2, 1)
        clean = _index_leg(p, None, vecs, 4, queries, 1)
        assert sorted(restored) == sorted(clean) == [0, 1, 2]
        for q in clean:
            assert_knn_close(restored[q][0], restored[q][1], clean[q][0], clean[q][1])
        got[pkg] = restored
    for q in got["pathway_tpu"]:
        assert_knn_close(got["pathway_tpu_torch"][q][0], got["pathway_tpu_torch"][q][1],
                         got["pathway_tpu"][q][0], got["pathway_tpu"][q][1])


def test_port_resharder_refuses_a_store_the_jax_package_wrote(tmp_path):
    jax_side = ns("pathway_tpu")
    path = str(tmp_path / "jax-store")
    cfg = jax_side.persistence.Config.simple_config(
        jax_side.persistence.Backend.filesystem(path), snapshot_interval_ms=5)
    stream_run(jax_side, _wordcount_join, _words(len(RT_WORDS), RT_WORDS), 1, cfg, name="words",
               schema={"word": str})
    port = ns("pathway_tpu_torch")
    root = port.backends.FilesystemBackend(path)
    keys = sorted(root.list_keys())
    with pytest.raises(port.snapshots.PersistenceFormatError, match="written by the JAX package"):
        port.rescale.rescale(root, 2, log=_quiet)
    assert port.layout.read_marker(root) == (1, 0)
    assert not [k for k in root.list_keys() if k not in keys and not k.startswith("rescale-tmp/")]
