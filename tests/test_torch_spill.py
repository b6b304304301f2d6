"""The port's spill tier of engine state (``pathway_tpu_torch/engine/spill.py``, the spillable
stores of ``engine/operators.py``, the key registry's cold tier in ``engine/keys.py``) against the
JAX package's, on the CPU: the cases of ``tests/test_spill.py`` and
``tests/test_key_registry_overflow.py`` that do not need the reference's chaos plan or metrics
plane, each run through both packages, which must give the same results.

- ``SpillStore``: blobs round trip, generations, chunking; a failed put leaves the previous
  generation readable.
- ``_SortedSide``: probe hits and totals equal with and without spilled runs; its pickle (a
  snapshot) materializes the spilled runs; a failed spill leaves the runs resident; compaction
  loads them back.
- ``GroupByReduce``: the dense arena's cold block spills and faults back in, general groups go to
  cold buckets; snapshots, monolithic and in parts, materialize both.
- ``StateBudget``: the largest store sheds first, a store that cannot spill warns once, the env
  knob parses; ``memory_snapshot``; the sweep of dead processes' scratch directories.
- The key registry past its cap: with a spill directory the cold tier keeps the 128-bit check (a
  forged collision is caught, hot or cold, from memory or disk, under concurrent threads);
  without one it raises; ``allow`` passes unchecked.
- Whole ``pw.run``s under a budget of a few KiB at 1, 2 and 4 workers (a wordcount join and
  groupbys over 2^14 groups on the dense and the general path), a spilled store rescaled 2 -> 4:
  the tables equal the JAX package's and an unbudgeted run's, and the spill counters moved.

Every test resets both packages' budgets and registries after itself (``reset_state_tiers``),
and every spill directory lies under ``tmp_path``. Tolerance: none; every result compares
exactly (floats are multiples of 1/16).
"""

from __future__ import annotations

import logging
import os
import pickle
import threading

import numpy as np
import pytest

from torch_state_runs import PACKAGES, arm_budget, ns, reset_state_tiers, stream_run


@pytest.fixture(autouse=True)
def _tiers(monkeypatch):
    reset_state_tiers(monkeypatch)
    yield
    for pkg in PACKAGES:
        ns(pkg).spill._reset_for_tests()


@pytest.fixture(params=PACKAGES)
def p(request):
    return ns(request.param)


class _FailingBackend:
    """A scratch backend whose ``put_value`` raises from the ``fail_from``-th call on."""

    def __init__(self, p, fail_from: int = 1):
        self._inner = p.backends.MemoryBackend()
        self._n = 0
        self._fail_from = fail_from

    def put_value(self, key, value):
        self._n += 1
        if self._n >= self._fail_from:
            raise OSError(f"put {self._n} refused")
        self._inner.put_value(key, value)

    def __getattr__(self, name):
        return getattr(self._inner, name)


# -- SpillStore ------------------------------------------------------------------------------


def test_spillstore_roundtrip_and_generations(p):
    store = p.spill.SpillStore(p.backends.MemoryBackend())
    h1 = store.put_blob("x", {"a": 1})
    assert store.get_blob(h1) == {"a": 1}
    h2 = store.put_blob("x", {"a": 2}, prev=h1)
    assert store.get_blob(h2) == {"a": 2}
    with pytest.raises(KeyError):
        store.get_blob(h1)  # the previous generation goes only after the new one landed
    c = p.spill.spill_counters()
    assert c["spill_events_total"] == 2 and c["load_events_total"] == 2
    assert h2["key"].endswith("/g2") and h2["chunks"] == 1


def test_spillstore_chunks_large_blobs(p, monkeypatch):
    monkeypatch.setattr(p.spill, "CHUNK_BYTES", 1024)
    store = p.spill.SpillStore(p.backends.MemoryBackend())
    payload = np.arange(2000, dtype=np.int64)
    h = store.put_blob("big", payload)
    assert h["chunks"] == -(-h["bytes"] // 1024) > 1
    np.testing.assert_array_equal(store.get_blob(h), payload)


def test_failed_put_keeps_previous_generation(p):
    backend = _FailingBackend(p, fail_from=2)
    store = p.spill.SpillStore(backend)
    h1 = store.put_blob("seg", [1, 2, 3])
    with pytest.raises(OSError):
        store.put_blob("seg", [4, 5, 6], prev=h1)
    assert store.get_blob(h1) == [1, 2, 3]


# -- _SortedSide ------------------------------------------------------------------------------


def _apply_batch(side, start, n, tag):
    jks = np.arange(start, start + n, dtype=np.uint64)
    side.apply(jks, jks + np.uint64(1000), [np.full(n, tag, dtype=np.int64)],
               np.ones(n, dtype=np.int64))


def _probe_all(side, qjks):
    hits = []
    for q_idx, keys, cols, counts in side.probe(qjks):
        for i in range(len(q_idx)):
            hits.append((int(qjks[q_idx[i]]), int(keys[i]), int(cols[0][i]), int(counts[i])))
    return sorted(hits)


BATCHES = [(0, 500), (500, 300), (800, 50), (100, 200)]
QUERIES = np.array([0, 123, 499, 700, 820, 9999, 150], dtype=np.uint64)


def _sides(p):
    side, ref = p.ops._SortedSide(1), p.ops._SortedSide(1)
    for b, (s, n) in enumerate(BATCHES):
        _apply_batch(side, s, n, b)
        _apply_batch(ref, s, n, b)
    return side, ref


def test_sorted_side_probe_totals_equal_with_and_without_spilling(monkeypatch, tmp_path):
    arm_budget(monkeypatch, tmp_path)
    got = {}
    for pkg in PACKAGES:
        p = ns(pkg)
        side, ref = _sides(p)
        freed = side.spill(1 << 30)
        assert freed > 0 and side._spilled and side.spilled_bytes() > 0
        assert len(side) == len(ref) == sum(n for _, n in BATCHES)
        np.testing.assert_array_equal(side.totals(QUERIES), ref.totals(QUERIES))
        assert _probe_all(side, QUERIES) == _probe_all(ref, QUERIES)
        c = p.spill.spill_counters()
        assert c["spill_events_total"] > 0 and c["load_events_total"] > 0
        got[pkg] = (_probe_all(side, QUERIES), side.totals(QUERIES).tolist(), freed)
    assert got["pathway_tpu"] == got["pathway_tpu_torch"]


def test_sorted_side_pickle_materializes_spilled_runs(p, monkeypatch, tmp_path):
    arm_budget(monkeypatch, tmp_path)
    side = p.ops._SortedSide(1)
    _apply_batch(side, 0, 400, 7)
    side.spill(1 << 30)
    assert side._spilled
    clone = pickle.loads(pickle.dumps(side))
    assert not clone._spilled and len(clone) == 400
    q = np.array([5, 399], dtype=np.uint64)
    np.testing.assert_array_equal(clone.totals(q), side.totals(q))
    assert _probe_all(side, q) == _probe_all(clone, q)  # the live side still serves


def test_sorted_side_failed_spill_keeps_runs_resident(p, monkeypatch, tmp_path):
    arm_budget(monkeypatch, tmp_path, mb="0.001")
    budget = p.spill.get_budget()
    budget._spill_store = p.spill.SpillStore(_FailingBackend(p))
    side = p.ops._SortedSide(1)
    _apply_batch(side, 0, 300, 1)
    n_runs = len(side._runs)
    assert budget.maybe_spill([side]) == 0  # the failure is counted, never raised
    assert len(side._runs) == n_runs and not side._spilled
    assert side.totals(np.array([0, 299], dtype=np.uint64)).sum() == 2
    assert p.spill.spill_counters()["spill_errors_total"] >= 1


def test_sorted_side_compaction_loads_spilled_runs(p, monkeypatch, tmp_path):
    arm_budget(monkeypatch, tmp_path)
    side = p.ops._SortedSide(1)
    _apply_batch(side, 0, 512, 0)
    side.spill(1 << 30)
    jks = np.arange(512, dtype=np.uint64)
    side.apply(jks, jks + np.uint64(1000), [np.zeros(512, dtype=np.int64)],
               np.full(512, -1, np.int64))
    side._compact()
    assert not side._spilled
    assert side.totals(jks).sum() == 0


# -- GroupByReduce ----------------------------------------------------------------------------


def _source(p):
    src = p.ex.SourceNode.__new__(p.ex.SourceNode)
    src.node_id, src.column_names, src.inputs = 0, ["k", "v"], []
    return src


def _groupby(p, general: bool = False):
    R = p.reducers
    reducers = ([("m", R.MinReducer(), ["v"]), ("c", R.CountReducer(), [])] if general
                else [("c", R.CountReducer(), []), ("s", R.SumReducer(), ["v"])])
    return p.ops.GroupByReduce(_source(p), ["k"], reducers)


def _delta(p, gks, vals, diffs=None):
    n = len(gks)
    return p.delta.Delta(
        keys=np.arange(n, dtype=np.uint64),
        data={"k": np.asarray(gks, dtype=np.int64), "v": np.asarray(vals, dtype=np.int64)},
        diffs=np.ones(n, np.int64) if diffs is None else np.asarray(diffs, dtype=np.int64))


def _rows(out) -> list:
    if out is None:
        return []
    cols = list(out.data)
    return sorted((int(k), int(d), *(int(out.data[c][i]) for c in cols))
                  for i, (k, d) in enumerate(zip(out.keys, out.diffs)))


#: ticks over moving group ranges (the early groups go cold), then touches of old groups
TICKS = [np.arange(t * 200, (t + 1) * 200) for t in range(6)] + [np.array([5, 150, 1199])]


def _drive(p, g, spill_at: int | None = None) -> list:
    outs = []
    for t, gks in enumerate(TICKS):
        if t == spill_at:
            freed = g.spill(1 << 30)
            assert freed > 0
        outs.append(_rows(g.process(2 + 2 * t, [_delta(p, gks, gks * 10 + t)])))
    return outs


@pytest.mark.parametrize("general", [False, True], ids=["dense", "general"])
def test_groupby_spills_and_faults_in_as_the_reference(general, monkeypatch, tmp_path):
    """Both packages spill the same state at the same tick and emit the same updates as an
    unbudgeted node; the old groups' retractions come from the faulted-in state."""
    arm_budget(monkeypatch, tmp_path)
    outs = {}
    for pkg in PACKAGES:
        p = ns(pkg)
        g = _groupby(p, general)
        assert g._dense is not general
        spilled = _drive(p, g, spill_at=len(TICKS) - 1)
        loads = p.spill.spill_counters()["load_events_total"]
        monkeypatch.delenv("PATHWAY_STATE_MEMORY_BUDGET_MB")
        p.spill._reset_for_tests()
        plain = _drive(p, _groupby(p, general))
        monkeypatch.setenv("PATHWAY_STATE_MEMORY_BUDGET_MB", "0.01")
        p.spill._reset_for_tests()
        assert spilled == plain
        if general:
            assert len(g._cold_set) == 798  # groups 5 and 150 came back, the rest stay cold
        else:
            assert g._arena_base == 0  # a touch below the cold block faulted it all back
        assert loads > 0
        outs[pkg] = spilled
    assert outs["pathway_tpu"] == outs["pathway_tpu_torch"]


def test_groupby_dense_snapshot_materializes_cold_block(p, monkeypatch, tmp_path):
    arm_budget(monkeypatch, tmp_path)
    g = _groupby(p)
    for t, gks in enumerate(TICKS[:-1]):
        g.process(2 + 2 * t, [_delta(p, gks, gks)])
    before = g.snapshot_state()
    assert g.spill(1 << 30) > 0 and g._arena_base > 0 and g._arena_cold
    snap = g.snapshot_state()
    parts = type(g).state_from_parts(iter(list(g.snapshot_state_parts())))
    for st in (snap, parts):
        for f in ("_counts", "_gkey_by_slot", "_emitted"):
            np.testing.assert_array_equal(before["arena"][f], st["arena"][f])
        for j in range(2):
            np.testing.assert_array_equal(before["arena"]["_prev"][j], st["arena"]["_prev"][j])
    assert g._arena_base > 0  # snapshotting left the live operator spilled
    g2 = _groupby(p)
    g2.restore_state(pickle.loads(pickle.dumps(snap)))
    assert _rows(g2.process(50, [_delta(p, [0], [7])])) == [
        (int(g2._gkey_by_slot[0]), -1, 0, 1, 0), (int(g2._gkey_by_slot[0]), 1, 0, 2, 7)]


def test_groupby_general_snapshot_materializes_cold_buckets(p, monkeypatch, tmp_path):
    arm_budget(monkeypatch, tmp_path)
    g = _groupby(p, general=True)
    for t, gks in enumerate(TICKS[:3]):
        g.process(2 + 2 * t, [_delta(p, gks, gks + 5)])
    n_resident = len(g._state)
    assert g.spill(1 << 30) > 0 and g._cold_set and len(g._state) < n_resident
    assert len(g.snapshot_state()["_state"]) == 600
    parts = type(g).state_from_parts(iter(list(g.snapshot_state_parts())))
    assert parts["_state"] == g.snapshot_state()["_state"]


# -- StateBudget ------------------------------------------------------------------------------


class _FakeStore:
    def __init__(self, resident):
        self.resident, self.disk = resident, 0

    def spillable_bytes(self):
        return self.resident

    def spilled_bytes(self):
        return self.disk

    def spill(self, want):
        moved = min(self.resident, want)
        self.resident -= moved
        self.disk += moved
        return moved


def test_budget_sheds_largest_first(p):
    budget = p.spill.StateBudget(1000)
    small, big = _FakeStore(400), _FakeStore(5000)
    budget.register(small)
    budget.register(big)
    assert budget.maybe_spill() == 4400
    assert (small.resident, big.resident) == (400, 600)
    assert budget.maybe_spill() == 0
    assert (budget.resident_bytes(), budget.spilled_bytes()) == (1000, 4400)


def test_budget_unspillable_warns_once(p, caplog):
    class _Stuck(_FakeStore):
        def spill(self, want):
            return 0

    budget = p.spill.StateBudget(10)
    stuck = _Stuck(1000)  # a strong reference: the registration is weak
    budget.register(stuck)
    with caplog.at_level(logging.WARNING, logger=p.spill.log.name):
        budget.maybe_spill()
        budget.maybe_spill()
    assert len([r for r in caplog.records if "could spill" in r.getMessage()]) == 1


def test_budget_env_parsing(p, monkeypatch):
    assert p.spill.get_budget() is None
    for raw, want in (("bogus", None), ("0", None), ("2.5", int(2.5 * (1 << 20)))):
        monkeypatch.setenv("PATHWAY_STATE_MEMORY_BUDGET_MB", raw)
        p.spill._reset_for_tests()
        budget = p.spill.get_budget()
        assert (budget.budget_bytes if budget is not None else None) == want


def test_memory_snapshot_shape(p, monkeypatch, tmp_path):
    arm_budget(monkeypatch, tmp_path)
    snap = p.spill.memory_snapshot()
    for key in ("rss_bytes", "state_budget_bytes", "state_resident_bytes",
                "state_spilled_bytes", "spill_events_total", "key_registry_entries",
                "key_registry_cold_entries", "key_registry_frozen",
                "key_registry_spilled_total"):
        assert isinstance(snap[key], (int, float))
    assert snap["rss_bytes"] > 0 and snap["state_budget_bytes"] == int(0.01 * (1 << 20))


def test_dead_pid_scratch_swept(p, monkeypatch, tmp_path):
    root = tmp_path / "spillroot"
    dead = root / "p999999999"  # no such process
    mine = root / f"p{os.getpid()}"
    for d in (dead, mine):
        d.mkdir(parents=True)
        (d / "junk").write_bytes(b"x")
    (root / "pnot-a-pid").mkdir()
    monkeypatch.setenv("PATHWAY_STATE_SPILL_DIR", str(root))
    assert p.spill._default_spill_root() == str(mine)
    assert not dead.exists() and mine.exists() and (root / "pnot-a-pid").exists()


def test_collect_spillable_takes_groupbys_and_join_sides(p, monkeypatch, tmp_path):
    arm_budget(monkeypatch, tmp_path)
    g = _groupby(p)
    holder = type("JoinLike", (), {})()
    holder._cleft, holder._cright = p.ops._SortedSide(1), p.ops._SortedSide(1)
    stores = p.spill.collect_spillable([g, holder, _source(p)])
    assert stores == [g, holder._cleft, holder._cright]


# -- the key registry's cold tier -------------------------------------------------------------


def _registry(p, monkeypatch, tmp_path, cap: int, *, overflow=None, spill=True):
    monkeypatch.setattr(p.K, "_REGISTRY", None)
    monkeypatch.setenv("PATHWAY_KEY_REGISTRY_CAP", str(cap))
    if overflow is not None:
        monkeypatch.setenv("PATHWAY_KEY_REGISTRY_OVERFLOW", overflow)
    else:
        monkeypatch.delenv("PATHWAY_KEY_REGISTRY_OVERFLOW", raising=False)
    if spill:
        monkeypatch.setenv("PATHWAY_KEY_REGISTRY_SPILL_DIR", str(tmp_path / p.name / "kreg"))
    else:
        monkeypatch.delenv("PATHWAY_KEY_REGISTRY_SPILL_DIR", raising=False)
    return p.K._get_registry()


def _pairs(start, n):
    lo = np.arange(start, start + n, dtype=np.uint64)
    return lo, lo + np.uint64(10_000_000)


def test_registry_past_its_cap_keeps_the_128_bit_check(monkeypatch, tmp_path):
    stats = {}
    for pkg in PACKAGES:
        p = ns(pkg)
        reg = _registry(p, monkeypatch, tmp_path, 64)
        lo, hi = _pairs(0, 1000)
        assert reg.register(lo, hi) == -1
        assert reg.register(lo, hi) == -1  # a replay is clean, hot and cold
        forged = np.array([5, 900], dtype=np.uint64)  # 5 hot, 900 cold: the first clash wins
        assert reg.register(forged, forged + np.uint64(1)) == 0
        assert reg.register(forged[1:], forged[1:]) == 0
        reg._cold.flush()  # from the disk buckets, not the pending tier or the cache
        reg._cold._cache.clear()
        assert reg.register(lo, hi) == -1
        assert reg.register(forged[1:], forged[1:] + np.uint64(7)) == 0
        st = reg.detailed_stats()
        assert (st["entries"], st["hot_entries"], st["mode"], st["frozen"]) == (
            1000, 64, "spill", 0)
        assert st["cold_entries"] == st["spilled_total"] == 936
        with pytest.raises(p.K.KeyCollisionError):
            p.K._register_keys(np.array([950], np.uint64), np.array([3], np.uint64))
        stats[pkg] = {k: st[k] for k in ("entries", "hot_entries", "cold_entries",
                                         "spilled_total", "cap", "mode")}
    assert stats["pathway_tpu"] == stats["pathway_tpu_torch"]


@pytest.mark.parametrize("overflow", [None, "error", "allow"])
def test_registry_past_its_cap_without_spill_or_allowed(overflow, monkeypatch, tmp_path):
    """Without a spill directory (or with ``error`` over one) the registry raises past its
    cap, as before the cold tier; ``allow`` lets new keys pass unchecked."""
    for pkg in PACKAGES:
        p = ns(pkg)
        reg = _registry(p, monkeypatch, tmp_path, 16, overflow=overflow,
                        spill=overflow == "error")
        lo, hi = _pairs(0, 16)
        assert reg.register(lo, hi) == -1
        over_lo, over_hi = _pairs(100, 8)
        if overflow == "allow":
            assert reg.register(over_lo, over_hi) == -1
            assert reg.register(over_lo, over_hi + np.uint64(1)) == -1  # unchecked
            assert reg.register(lo[:1], hi[:1] + np.uint64(1)) == 0  # the hot keys still check
            assert reg.detailed_stats()["frozen"] == 1
        else:
            with pytest.raises(p.K.KeyRegistryOverflowError, match="PATHWAY_KEY_REGISTRY_CAP"):
                reg.register(over_lo, over_hi)
            assert reg.register(lo, hi) == -1


def test_registry_state_spill_dir_is_the_fallback(monkeypatch, tmp_path):
    p = ns("pathway_tpu_torch")
    monkeypatch.setattr(p.K, "_REGISTRY", None)
    monkeypatch.setenv("PATHWAY_KEY_REGISTRY_CAP", "8")
    monkeypatch.setenv("PATHWAY_STATE_SPILL_DIR", str(tmp_path / "state"))
    reg = p.K._get_registry()
    assert reg.mode == "spill"
    assert reg._spill_dir == str(tmp_path / "state" / f"p{os.getpid()}" / "keyreg")
    lo, hi = _pairs(0, 100)
    assert reg.register(lo, hi) == -1


def test_registry_cold_tier_under_threads(monkeypatch, tmp_path):
    """Eight threads register the same cold LO lanes, each with its own HI lane: one critical
    section per registration, so each LO lane keeps exactly one HI lane and every other
    thread's batch is refused."""
    p = ns("pathway_tpu_torch")
    reg = _registry(p, monkeypatch, tmp_path, 32)
    lo_hot, hi_hot = _pairs(0, 32)
    assert reg.register(lo_hot, hi_hot) == -1
    lo = np.arange(1000, 3000, dtype=np.uint64)
    results = [None] * 8
    start = threading.Barrier(8)

    def work(i):
        start.wait()
        results[i] = reg.register(lo, lo + np.uint64(i))

    threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert sorted(results) == [-1] + [0] * 7
    assert reg.detailed_stats()["cold_entries"] == len(lo)
    winner = results.index(-1)
    assert reg.register(lo, lo + np.uint64(winner)) == -1


# -- whole runs under a budget ----------------------------------------------------------------


WEIGHTS = {"foo": 2, "bar": 3, "baz": 5, "qux": 7, "zap": 11}
N_GROUPS, N_ROWS, COMMIT = 1 << 14, 1 << 15, 2048


def _group_batches():
    """2^15 rows over 2^14 groups in commits of 2048: each commit's groups drift forward (the
    early ones go cold and spill), and in commits 10 and 13 64 rows touch old groups (a
    fault-in)."""
    rng = np.random.default_rng(14)
    i = np.arange(N_ROWS)
    g = i // 2
    for c in (10, 13):
        g[c * COMMIT:c * COMMIT + 64] = rng.integers(0, 2048, 64)
    v = rng.integers(-1000, 1000, N_ROWS)
    return [{"g": g[s:s + COMMIT].tolist(), "v": v[s:s + COMMIT].tolist()}
            for s in range(0, N_ROWS, COMMIT)]


def _word_batches():
    words = (["foo", "bar", "foo", "baz", "qux"] * 3 + ["foo", "qux", "zap"] * 4
             + ["zap", "bar", "baz"] * 3) * 8
    return [{"word": words[s:s + 16]} for s in range(0, len(words), 16)]


def _wordcount_join(pw, t):
    counts = t.groupby(pw.this.word).reduce(pw.this.word, c=pw.reducers.count())
    lines = ["word | weight"] + [f"{w} | {x}" for w, x in WEIGHTS.items()]
    weights = pw.debug.table_from_markdown("\n".join(lines))
    return counts.join(weights, pw.left.word == pw.right.word).select(
        pw.left.word, score=pw.left.c * pw.right.weight)


def _groupby_dense(pw, t):
    return t.groupby(pw.this.g).reduce(pw.this.g, n=pw.reducers.count(),
                                       s=pw.reducers.sum(pw.this.v))


def _groupby_general(pw, t):
    return t.groupby(pw.this.g).reduce(pw.this.g, lo=pw.reducers.min(pw.this.v),
                                       hi=pw.reducers.max(pw.this.v))


PIPELINES = {
    "wordcount_join": (_wordcount_join, _word_batches, {"word": str}),
    "groupby_dense": (_groupby_dense, _group_batches, {"g": int, "v": int}),
    "groupby_general": (_groupby_general, _group_batches, {"g": int, "v": int}),
}


@pytest.mark.parametrize("workers", [1, 2, 4])
@pytest.mark.parametrize("name", sorted(PIPELINES))
def test_budgeted_run_gives_the_reference_table(name, workers, monkeypatch, tmp_path):
    build, batches, schema = PIPELINES[name]
    data = batches()
    plain, _ = stream_run(ns("pathway_tpu_torch"), build, data, workers, schema=schema)
    tables = {}
    for pkg in PACKAGES:
        p = ns(pkg)
        arm_budget(monkeypatch, tmp_path, mb="0.004", registry_cap=1 << 12, pkgs=(pkg,))
        tables[pkg], _ = stream_run(p, build, data, workers, schema=schema)
        c = p.spill.spill_counters()
        assert c["spill_bytes_total"] > 0, pkg
        if name != "wordcount_join":
            assert c["load_events_total"] > 0, pkg
            assert p.K.registry_stats()["cold_entries"] > 0, pkg
    assert tables["pathway_tpu_torch"] == tables["pathway_tpu"] == plain


def test_spilled_store_rescaled_2_to_4(monkeypatch, tmp_path):
    """A persisted groupby under the budget at 2 workers, rescaled offline to 4 and run on under
    the budget: the snapshots materialized the spilled state, so the rescaled run ends at the
    table of one unbudgeted, unsharded run, in both packages."""
    data = _group_batches()
    half = len(data) // 2
    _, want = stream_run(ns("pathway_tpu_torch"), _groupby_dense, data, 1,
                         schema={"g": int, "v": int})
    for pkg in PACKAGES:
        p = ns(pkg)
        arm_budget(monkeypatch, tmp_path, mb="0.004", pkgs=(pkg,))
        store = str(tmp_path / pkg / "pstate")
        cfg = p.persistence.Config.simple_config(p.persistence.Backend.filesystem(store),
                                                 snapshot_interval_ms=0)
        _, first = stream_run(p, _groupby_dense, data[:half], 2, cfg, name="rows",
                              schema={"g": int, "v": int})
        assert p.spill.spill_counters()["spill_bytes_total"] > 0
        report = p.rescale.rescale(p.backends.FilesystemBackend(store), 4, log=lambda m: None)
        assert (report["from"], report["to"], report["ranks"]) == (2, 4, 1)
        _, second = stream_run(p, _groupby_dense, data, 4, cfg, name="rows",
                               schema={"g": int, "v": int})
        first.update(second)
        assert +first == +want, pkg
