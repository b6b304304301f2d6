"""``pw.iterate`` in the port (``internals/iterate.py``, ``engine/iterate.py``) against the JAX
package's, on the CPU.

- ``tests/test_iterate.py``'s cases (a single table to fixpoint, kept keys, ``iteration_limit``,
  a bad limit, a fed-back table beside a constant one, an input that changes at a later time),
  plus several fed-back tables with and without a limit, a namedtuple result, a placeholder
  that escapes its body, and min-label propagation (connected components) on a seeded graph:
  each program runs in both packages and the keyed tables must be equal, exactly; the known
  answers of ``tests/test_iterate.py`` are held too, and the components against scipy's.
- A streaming input that changes between ticks through ``pw.io.python``, at 1 worker and at 2
  (async and BSP; the ``Iterate`` node gathers its inputs to worker 0): the final table equals
  the reference's.
- The pinned node under the rescale protocol: ``RESHARD = "pinned"``, ``split_state`` hands
  every destination its piece unchanged and ``merge_states`` keeps source worker 0's, as in the
  reference; a persisted iterate written at 2 workers under async, rescaled offline to 1 and
  run on, gives the reference's table over all the input.
"""

from __future__ import annotations

import collections
import importlib
import threading
import time

import numpy as np
import pytest

from torch_io_runs import run_bounded
from torch_state_runs import ns, reset_state_tiers

PACKAGES = ("pathway_tpu", "pathway_tpu_torch")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in ("PATHWAY_ASYNC_EXEC", "PATHWAY_MESH_EXCHANGE"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("PATHWAY_THREADS", "1")


def _keyed(pkg: str, build) -> dict:
    """``build(pw)``'s table in package ``pkg``: {row key: row tuple} and the column names."""
    pw = importlib.import_module(pkg)
    testing = importlib.import_module(f"{pkg}.testing")
    pw.G.clear()
    try:
        table = build(pw)
        kw = {"device": "cpu"} if pkg == "pathway_tpu_torch" else {}
        rows, names = testing.run_table(table, **kw)
    finally:
        pw.G.clear()
    return {int(k): tuple(v) for k, v in rows.items()}, list(names)


def _both(build) -> tuple[dict, list]:
    ours = _keyed("pathway_tpu_torch", build)
    assert ours == _keyed("pathway_tpu", build)
    return ours


def _values(rows: dict) -> list:
    return sorted(rows.values())


# -- tests/test_iterate.py's cases ------------------------------------------------------------


def single_table_fixpoint(pw):
    t = pw.debug.table_from_markdown("a\n1\n3\n50")
    return pw.iterate(lambda t: t.select(a=pw.if_else(t.a < 100, t.a * 2, t.a)), t=t)


def preserves_keys(pw):
    t = pw.debug.table_from_markdown("a\n1\n2")
    res = pw.iterate(lambda t: t.select(a=pw.if_else(t.a < 8, t.a * 2, t.a)), t=t)
    return t.join(res, t.id == res.id, how=pw.JoinMode.INNER).select(orig=t.a, final=res.a)


def iteration_limit(pw):
    t = pw.debug.table_from_markdown("a\n1")
    return pw.iterate(lambda t: t.select(a=t.a * 2), iteration_limit=3, t=t)


def _chain_step(pw):
    def step(values, edges):
        cand = edges.select(dst=values.pointer_from(edges.w),
                            cv=values.ix(values.pointer_from(edges.u)).v)
        best = cand.groupby(id=cand.dst).reduce(m=pw.reducers.min(cand.cv))
        cand_m = pw.coalesce(best.ix(values.id, optional=True).m, values.v)
        return dict(values=values.select(values.i,
                                         v=pw.if_else(cand_m < values.v, cand_m, values.v)))

    return step


def dict_with_constant_input(pw):
    values = pw.debug.table_from_markdown("i | v\n1 | 10\n2 | 5\n3 | 7", id_from=["i"])
    edges = pw.debug.table_from_markdown("u | w\n1 | 2\n2 | 3\n3 | 1")
    return pw.iterate(_chain_step(pw), values=values, edges=edges)["values"]


def incremental_update(pw):
    t = pw.debug.table_from_markdown(
        """
        a | __time__ | __diff__
        1 |     2    |    1
        4 |     2    |    1
        1 |     4    |   -1
        3 |     4    |    1
        """
    )
    return pw.iterate(lambda t: t.select(a=pw.if_else(t.a < 10, t.a * 2, t.a)), t=t)


def _two_tables(pw, limit):
    a = pw.debug.table_from_markdown("x\n1\n2\n3")
    b = pw.debug.table_from_markdown("y\n100\n70")

    def step(a, b):
        # a doubles up to 40; b halves down to 5 — two fed-back tables, one body
        return {"a": a.select(x=pw.if_else(a.x < 40, a.x * 2, a.x)),
                "b": b.select(y=pw.if_else(b.y > 5, b.y // 2, b.y))}

    res = pw.iterate(step, iteration_limit=limit, a=a, b=b)
    return res["a"].concat_reindex(res["b"].select(x=pw.this.y))


def several_fed_back_tables(pw):
    return _two_tables(pw, None)


def several_fed_back_tables_with_limit(pw):
    return _two_tables(pw, 2)


def namedtuple_result(pw):
    Out = collections.namedtuple("Out", ["t", "side"])
    t = pw.debug.table_from_markdown("a\n3\n5")

    def step(t):
        nxt = t.select(a=pw.if_else(t.a < 20, t.a + 4, t.a))
        return Out(t=nxt, side=nxt.select(b=nxt.a * 10))

    res = pw.iterate(step, t=t)
    return res.side


def _edges_graph(n: int, m: int, seed: int):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n, m)
    v = rng.integers(0, n, m)
    return u, v


def connected_components_builder(n: int, m: int, seed: int):
    u, v = _edges_graph(n, m, seed)

    def build(pw):
        nodes = pw.debug.table_from_rows(pw.schema_from_types(node=int, label=int),
                                         [(i, i) for i in range(n)])
        nodes = nodes.with_id_from(nodes.node)
        pairs = [(int(a), int(b)) for a, b in zip(u, v)]
        edges = pw.debug.table_from_rows(pw.schema_from_types(a=int, b=int),
                                         pairs + [(b, a) for a, b in pairs])

        def step(labels, edges):
            cand = edges.select(dst=labels.pointer_from(edges.b),
                                lab=labels.ix(labels.pointer_from(edges.a)).label)
            best = cand.groupby(id=cand.dst).reduce(m=pw.reducers.min(cand.lab))
            m_ = pw.coalesce(best.ix(labels.id, optional=True).m, labels.label)
            return dict(labels=labels.select(labels.node, label=pw.if_else(
                m_ < labels.label, m_, labels.label)))

        return pw.iterate(step, labels=nodes, edges=edges)["labels"]

    return build


def connected_components(pw):
    return connected_components_builder(300, 240, 3)(pw)


CASES = {
    "single_table_fixpoint": (single_table_fixpoint, [(100,), (128,), (192,)]),
    "preserves_keys": (preserves_keys, [(1, 8), (2, 8)]),
    "iteration_limit": (iteration_limit, [(8,)]),
    "dict_with_constant_input": (dict_with_constant_input, [(1, 5), (2, 5), (3, 5)]),
    "incremental_update": (incremental_update, [(12,), (16,)]),
    "several_fed_back_tables": (several_fed_back_tables, [(3,), (4,), (48,), (64,), (64,)]),
    "several_fed_back_tables_with_limit": (several_fed_back_tables_with_limit,
                                           [(4,), (8,), (12,), (17,), (25,)]),
    "namedtuple_result": (namedtuple_result, [(230,), (210,)]),
    "connected_components": (connected_components, None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_tables_equal_the_reference(case):
    build, want = CASES[case]
    rows, _ = _both(build)
    if want is not None:
        assert _values(rows) == sorted(want)


def test_connected_components_equal_scipy():
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components as scipy_cc

    n, m, seed = 300, 240, 3
    rows, names = _keyed("pathway_tpu_torch", connected_components_builder(n, m, seed))
    assert names == ["node", "label"]
    label = {node: lab for node, lab in rows.values()}
    u, v = _edges_graph(n, m, seed)
    _, comp = scipy_cc(coo_matrix((np.ones(m), (u, v)), shape=(n, n)), directed=False)
    # a component's label is its smallest node
    smallest = {}
    for node in range(n):
        smallest.setdefault(comp[node], node)
    assert [label[i] for i in range(n)] == [smallest[comp[i]] for i in range(n)]


def test_bad_limit_and_escaped_placeholder_raise_in_both_packages():
    for pkg in PACKAGES:
        pw = importlib.import_module(pkg)
        testing = importlib.import_module(f"{pkg}.testing")
        kw = {"device": "cpu"} if pkg == "pathway_tpu_torch" else {}
        pw.G.clear()
        t = pw.debug.table_from_markdown("a\n1")
        with pytest.raises(ValueError, match="wrong value of iteration_limit"):
            pw.iterate(lambda t: t, iteration_limit=0, t=t)
        with pytest.raises(ValueError, match="at least one Table"):
            pw.iterate(lambda x: x, x=3)
        with pytest.raises(TypeError, match="must return a Table"):
            pw.iterate(lambda t: 5, t=t)
        escaped = {}

        def leak(t):
            escaped["t"] = t
            return t.select(a=t.a + 1)

        pw.iterate(leak, iteration_limit=1, t=t)
        with pytest.raises(RuntimeError, match="placeholder table used outside"):
            testing.run_table(escaped["t"].select(b=pw.this.a), **kw)
        pw.G.clear()
        assert pw.iterate_universe(t) is t


# -- a streaming input through pw.io.python ---------------------------------------------------


def _streamed(pkg: str, monkeypatch, threads: int, async_exec: str) -> dict:
    p = ns(pkg)
    pw = p.pw
    pw.G.clear()
    final: dict = {}
    lock = threading.Lock()

    class Feed(pw.io.python.ConnectorSubject):
        def run(self):
            for s in range(0, 40, 8):  # each commit changes the iterated input
                self.next_batch({"k": list(range(s, s + 8)), "a": [1 + i % 9 for i in
                                                                   range(s, s + 8)]})
                self.commit()
                time.sleep(0.02)
            self._remove(k=3, a=4)
            self.commit()

    t = pw.io.python.read(Feed(), schema=pw.schema_from_types(k=int, a=int),
                          autocommit_duration_ms=None)
    res = pw.iterate(lambda t: t.select(t.k, a=pw.if_else(t.a < 50, t.a * 3, t.a)), t=t)

    def on_change(key, row, time, is_addition):
        with lock:
            if is_addition:
                final[int(key)] = (row["k"], row["a"])
            elif final.get(int(key)) == (row["k"], row["a"]):
                del final[int(key)]

    pw.io.subscribe(res, on_change=on_change)
    monkeypatch.setenv("PATHWAY_THREADS", str(threads))
    monkeypatch.setenv("PATHWAY_ASYNC_EXEC", async_exec)
    try:
        run_bounded(pw, 120, **p.run)
    finally:
        pw.G.clear()
    return final


@pytest.mark.parametrize("threads,async_exec", [(1, "0"), (2, "1"), (2, "0")])
def test_streaming_input_changing_between_ticks(monkeypatch, threads, async_exec):
    ours = _streamed("pathway_tpu_torch", monkeypatch, threads, async_exec)
    assert ours == _streamed("pathway_tpu", monkeypatch, threads, async_exec)
    want = {}
    for i in range(40):
        a = 1 + i % 9
        while a < 50:
            a *= 3
        want[i] = a
    del want[3]
    assert sorted(ours.values()) == sorted(want.items())


# -- the pinned node under the rescale protocol ------------------------------------------------


def test_pinned_node_splits_and_merges_as_the_reference():
    from pathway_tpu.engine.iterate import Iterate as JIterate
    from pathway_tpu_torch.engine.iterate import Iterate, IterateOutput
    from pathway_tpu_torch.engine.state import RowState

    assert Iterate.RESHARD == JIterate.RESHARD == "pinned"
    assert Iterate.STATE_FIELDS == JIterate.STATE_FIELDS
    assert IterateOutput.RESHARD == "keyed" and not IterateOutput.STATE_FIELDS
    pieces = []
    for w in range(3):
        st = RowState(["a"])
        st._rows, st._counts = {w + 1: (w,)}, {w + 1: 1}
        pieces.append({"_in_state": {"t": st}, "_out_last": {"t": {w + 1: (w * 2,)}}})
    never = lambda keys: np.zeros(len(keys), dtype=bool)  # noqa: E731
    for piece in pieces:
        assert Iterate.split_state(piece, never) is piece  # every destination, unchanged
        assert JIterate.split_state(piece, never) is piece
    assert Iterate.merge_states(pieces) is pieces[0]  # source worker 0's piece
    assert JIterate.merge_states(pieces) is pieces[0]
    from pathway_tpu_torch.rescale.resharder import _node_class

    assert _node_class("Iterate") is Iterate


def test_persisted_iterate_rescaled_from_two_workers(tmp_path, monkeypatch):
    reset_state_tiers(monkeypatch)
    p = ns("pathway_tpu_torch")
    store = str(tmp_path / "pstate")
    cfg = p.persistence.Config.simple_config(p.persistence.Backend.filesystem(store),
                                             snapshot_interval_ms=20)
    batches = [{"k": list(range(s, s + 6)), "a": [1 + i % 7 for i in range(s, s + 6)]}
               for s in range(0, 36, 6)]

    def run(pkg, threads, n_batches, persisted):
        q = ns(pkg)
        pw = q.pw
        pw.G.clear()
        final: dict = {}

        class Feed(pw.io.python.ConnectorSubject):
            def run(self):
                for b in batches[:n_batches]:
                    self.next_batch(b)
                    self.commit()
                    time.sleep(0.02)

        t = pw.io.python.read(Feed(), schema=pw.schema_from_types(k=int, a=int), name="feed",
                              autocommit_duration_ms=None)
        res = pw.iterate(lambda t: t.select(t.k, a=pw.if_else(t.a < 30, t.a * 2, t.a)), t=t)

        def on_change(key, row, time, is_addition):
            if is_addition:
                final[int(key)] = (row["k"], row["a"])
            elif final.get(int(key)) == (row["k"], row["a"]):
                del final[int(key)]

        pw.io.subscribe(res, on_change=on_change)
        monkeypatch.setenv("PATHWAY_THREADS", str(threads))
        kw = dict(q.run)
        if persisted:
            kw["persistence_config"] = cfg
        try:
            run_bounded(pw, 120, **kw)
        finally:
            pw.G.clear()
        return final

    first = run("pathway_tpu_torch", 2, 3, True)
    assert len(first) == 18
    report = p.rescale.rescale(p.backends.FilesystemBackend(store), 1, log=lambda msg: None)
    assert (report["from"], report["to"]) == (2, 1)
    second = run("pathway_tpu_torch", 1, len(batches), True)
    # the restored node holds the first run's input and output: the restarted run emits only
    # the rows of the new keys, and a fresh run over everything agrees with the reference's
    whole = run("pathway_tpu_torch", 1, len(batches), False)
    assert whole == run("pathway_tpu", 1, len(batches), False)
    assert len(whole) == 36
    assert {k: v for k, v in whole.items() if v[0] < 18} == first
    assert second == {k: v for k, v in whole.items() if v[0] >= 18}
