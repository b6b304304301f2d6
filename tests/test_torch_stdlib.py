"""``pw.utils``, ``pw.graphs`` and ``pw.ml`` of the port against the JAX package's, on the CPU.

- The cases of ``tests/test_graphs.py``, ``test_ml_utils.py``, ``test_ported_ml_index.py``,
  ``test_ported_async_transformer.py`` and ``test_table_surface2.py``'s fuzzy-match case, each run
  through both packages (``tests/torch_case_runs.py``: the reference's ``pw.run()`` and the port's
  ``pw.run(device="cpu")``). Each case's own assertions hold in both, and every table it computes
  is equal, row key by row key.
- Streaming programs over python subjects of seeded numpy rows, a commit a batch, with
  retractions: PageRank and Bellman-Ford over an edge stream that deletes edges, the kNN
  classifier with training rows arriving between queries, ``pandas_transformer``,
  ``AsyncTransformer``, ``groupby_reduce_majority`` and ``argmax_rows``. At 1 worker the port's
  table equals the reference's; at 2 and 4 workers (async, the default) and at 2 under BSP
  (``PATHWAY_ASYNC_EXEC=0``) it equals the reference's 1-worker table.
- ``pw.utils`` is the stdlib's utils, the filter compiler stays importable under its own name,
  and importing the new modules loads neither ``jax`` nor ``pathway_tpu``.

Tolerance: none. Floats are multiples of a power of two, so sums are exact in any order; the kNN
classifier's classes lie far apart, so no vote turns on one bf16 ulp of a score.
"""

from __future__ import annotations

import asyncio
import os
import subprocess
import sys
from collections import Counter

import numpy as np
import pandas  # noqa: F401  (first imported here: see pandas_transformer._import_pandas)
import pytest

from torch_case_runs import Side, cases, run_case
from torch_state_runs import (PACKAGES, final_table, held_open_feed, keyed_feed as _feed,
                              raises_before_the_stream_ends)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CASES = cases(["test_graphs", "test_ml_utils", "test_ported_ml_index",
               "test_ported_async_transformer"])
CASES.append(("test_table_surface2", "test_fuzzy_match_mutual_best_is_intersection"))


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in ("PATHWAY_ASYNC_EXEC", "PATHWAY_MESH_EXCHANGE", "PATHWAY_FUSION"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("PATHWAY_THREADS", "1")


# The port keys ``knn_lsh_classify``'s predictions by the query, so that they share the queries'
# universe; the reference keys them by the join's pair of ids (ROADMAP, Queue 3): the query's key
# paired with the key of its one-row lookup table, a global reduce. Its tables are held equal
# query by query, the reference's keys mapped back to the port's.
_KEYED_BY_QUERY = {"test_knn_classifier", "knn_classify"}


def _by_query(want: dict, got: dict) -> dict:
    """The reference's table ``want`` with each key ``derive_pair(q, global reduce key)`` put
    back as the key ``q`` of ``got`` that it pairs; any other key stays."""
    from pathway_tpu.engine import keys as K

    lookup = K.ref_scalar()  # a global reduce's one row hashes the empty tuple
    pair = {K.derive_pair_scalar(q, lookup): q for q in got}
    return {pair.get(k, k): row for k, row in want.items()}


@pytest.mark.parametrize("module,name", CASES, ids=[f"{m}::{n}" for m, n in CASES])
def test_reference_case_through_both_packages(module, name):
    want = run_case(module, name, Side("pathway_tpu"))
    got = run_case(module, name, Side("pathway_tpu_torch"))
    if name in _KEYED_BY_QUERY:
        assert len(got) == len(want)
        want = [_by_query(w, g) for w, g in zip(want, got)]
    assert got == want
    assert want, "the case computed no table"


# -- streaming programs ------------------------------------------------------------------------


def _edge_batches(n: int, m: int, seed: int, *, weights: bool = False) -> list:
    """``m`` random edges over ``n`` vertices in 5 commits, then a commit deleting every 7th."""
    rng = np.random.default_rng(seed)
    a, b = rng.integers(0, n, m), rng.integers(0, n, m)
    w = rng.integers(1, 16, m).astype(float)

    def cols(idx):
        out = {"i": idx.tolist(), "a": a[idx].tolist(), "b": b[idx].tolist()}
        if weights:
            out["w"] = w[idx].tolist()
        return out

    idx = np.arange(m)
    return [(cols(part), 1) for part in np.array_split(idx, 5)] + [(cols(idx[::7]), -1)]


EDGES = _edge_batches(40, 160, 5)
WEIGHTED = _edge_batches(30, 90, 6, weights=True)


def _pagerank(pw):
    raw = _feed(pw, EDGES, i=int, a=int, b=int)
    edges = raw.select(u=raw.pointer_from(raw.a), v=raw.pointer_from(raw.b))
    return pw.graphs.pagerank.pagerank(edges, steps=5)


def _bellman_ford(pw):
    nodes = pw.debug.table_from_rows(pw.schema_from_types(node=int, is_source=bool),
                                     [(i, i in (0, 17)) for i in range(30)])
    vertices = nodes.with_id_from(nodes.node).select(is_source=pw.this.is_source)
    raw = _feed(pw, WEIGHTED, i=int, a=int, b=int, w=float)
    edges = raw.select(u=vertices.pointer_from(raw.a), v=vertices.pointer_from(raw.b),
                       dist=raw.w)
    return pw.graphs.bellman_ford.bellman_ford(vertices, edges)


DIM, N_CLASSES = 8, 4
_rng = np.random.default_rng(7)
CENTRES = _rng.integers(-8, 9, (N_CLASSES, DIM)) * 16.0


def _points(n: int, seed: int) -> tuple[list, list]:
    rng = np.random.default_rng(seed)
    label = rng.integers(0, N_CLASSES, n)
    vecs = CENTRES[label] + rng.integers(-8, 9, (n, DIM)) / 4.0
    return [v for v in vecs], label.tolist()


def _knn_classify(pw, with_label: bool = False):
    train_v, train_l = _points(120, 8)
    query_v, query_l = _points(48, 9)
    train_batches = [({"i": list(range(s, s + 30)), "data": train_v[s:s + 30],
                       "label": train_l[s:s + 30]}, 1) for s in range(0, 120, 30)]
    query_batches = [({"i": list(range(s, s + 12)), "data": query_v[s:s + 12],
                       "label": query_l[s:s + 12]}, 1) for s in range(0, 48, 12)]
    train = _feed(pw, train_batches, i=int, data=np.ndarray, label=int)
    queries = _feed(pw, query_batches, i=int, data=np.ndarray, label=int)
    model = pw.ml.knn_lsh_classifier_train(train.select(data=pw.this.data), L=20,
                                           type="euclidean", d=DIM)
    labels = train.select(label=pw.this.label)
    predicted = pw.ml.knn_lsh_classify(model, labels, queries.select(data=pw.this.data), k=3)
    if not with_label:
        return predicted
    return predicted.select(i=queries.ix(predicted.id).i,
                            predicted_label=predicted.predicted_label,
                            label=queries.ix(predicted.id).label)


ROWS = [({"i": list(range(s, s + 20)), "g": [j % 5 for j in range(s, s + 20)],
          "v": [((j * 37) % 23) / 4.0 for j in range(s, s + 20)]}, 1) for s in range(0, 100, 20)]
ROWS.append(({"i": [3, 44, 61], "g": [3, 4, 1], "v": [((j * 37) % 23) / 4.0
                                                      for j in (3, 44, 61)]}, -1))


def _rows(pw):
    return _feed(pw, ROWS, i=int, g=int, v=float)


def _pandas_transformer(pw):
    t = _rows(pw)

    @pw.utils.pandas_transformer(output_schema=pw.schema_from_types(v=float, share=float))
    def shares(df):
        import pandas as pd

        return pd.DataFrame({"v": df["v"], "share": df["v"] / df["v"].sum()}, index=df.index)

    return shares(t.select(v=pw.this.v))


def _async_transformer(pw):
    t = _rows(pw)

    class Scaled(pw.AsyncTransformer, output_schema=pw.schema_from_types(g=int, w=float)):
        async def invoke(self, g, v):
            await asyncio.sleep(0)
            if g == 2 and v > 4.0:
                raise ValueError("rejected")
            return {"g": g, "w": v * 4.0 + g}

    return Scaled(t.select(g=pw.this.g, v=pw.this.v)).successful


def _majority(pw):
    t = _rows(pw)
    return pw.utils.col.groupby_reduce_majority(t.g, t.select(b=pw.this.v > 2.0).b)


def _argmax(pw):
    t = _rows(pw)
    return pw.utils.filtering.argmax_rows(t, t.g, what=t.v)


PROGRAMS = {
    "pagerank": _pagerank, "bellman_ford": _bellman_ford, "knn_classify": _knn_classify,
    "pandas_transformer": _pandas_transformer, "async_transformer": _async_transformer,
    "groupby_reduce_majority": _majority, "argmax_rows": _argmax,
}

_REFERENCE: dict[str, dict] = {}


def _reference_one_worker(prog: str, monkeypatch) -> dict:
    if prog not in _REFERENCE:
        _REFERENCE[prog] = final_table("pathway_tpu", PROGRAMS[prog], monkeypatch)
    return _REFERENCE[prog]


@pytest.mark.parametrize("prog", list(PROGRAMS))
def test_streaming_one_worker(monkeypatch, prog):
    want = _reference_one_worker(prog, monkeypatch)
    assert want
    _assert_equal(final_table("pathway_tpu_torch", PROGRAMS[prog], monkeypatch), want, prog)


def _assert_equal(got: dict, want: dict, prog: str) -> None:
    if prog in _KEYED_BY_QUERY:
        want = _by_query(want, got)
    assert got == want


@pytest.mark.parametrize("workers,async_exec", [(2, None), (4, None), (2, "0")],
                         ids=["2-async", "4-async", "2-bsp"])
@pytest.mark.parametrize("prog", list(PROGRAMS))
def test_streaming_sharded_equals_the_reference_one_worker(monkeypatch, prog, workers,
                                                           async_exec):
    want = _reference_one_worker(prog, monkeypatch)
    got = final_table("pathway_tpu_torch", PROGRAMS[prog], monkeypatch, workers, async_exec)
    _assert_equal(got, want, prog)


def test_knn_classifier_votes_as_numpy(monkeypatch):
    """Each streamed query's label is the majority of numpy's 3 nearest training points."""
    got = final_table("pathway_tpu_torch", lambda pw: _knn_classify(pw, with_label=True),
                      monkeypatch)
    train_v, train_l = _points(120, 8)
    query_v, query_l = _points(48, 9)
    d = ((np.stack(query_v)[:, None, :] - np.stack(train_v)[None]) ** 2).sum(-1)
    nearest = np.asarray(train_l)[np.argsort(d, axis=1, kind="stable")[:, :3]]
    # the most common of the three, a tie going to the nearest
    want = sorted((i, Counter(v.tolist()).most_common(1)[0][0], lab)
                  for i, (v, lab) in enumerate(zip(nearest, query_l)))
    assert sorted(got.values()) == want


def test_pw_utils_is_the_stdlib_utils_and_the_filters_still_import():
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.utils.filters import compile_metadata_filter

    assert pw.utils is sys.modules["pathway_tpu_torch.stdlib.utils"]
    assert pw.compile_metadata_filter is compile_metadata_filter
    for name in ("col", "filtering", "AsyncTransformer", "pandas_transformer", "argmax_rows",
                 "unpack_col", "groupby_reduce_majority"):
        assert getattr(pw.utils, name) is not None


def test_imports_load_neither_jax_nor_the_reference():
    code = (
        "import sys\n"
        "import pathway_tpu_torch.stdlib.utils, pathway_tpu_torch.stdlib.graphs\n"
        "import pathway_tpu_torch.stdlib.ml, pathway_tpu_torch.internals.sql\n"
        "import pathway_tpu_torch.internals.row_transformer\n"
        "import pathway_tpu_torch as pw\n"
        "from pathway_tpu_torch.utils.filters import compile_metadata_filter\n"
        "assert pw.utils is sys.modules['pathway_tpu_torch.stdlib.utils']\n"
        "for n in ('sql', 'graphs', 'ml', 'utils', 'AsyncTransformer', 'ClassArg', 'attribute',\n"
        "          'input_attribute', 'input_method', 'method', 'output_attribute',\n"
        "          'transformer'):\n"
        "    assert n in pw.__all__, n\n"
        "    getattr(pw, n)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'pathway_tpu' or m.startswith('pathway_tpu.')\n"
        "       or m in ('pandas', 'networkx')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_the_port_lacks_only_the_names_of_later_slices():
    import pathway_tpu
    import pathway_tpu_torch

    # every root name is ported: the last eight came with pw.analyze, load_yaml, the error-log
    # tables, LiveTable with interactive mode and pw.viz
    missing = {n for n in pathway_tpu.__all__ if not hasattr(pathway_tpu_torch, n)}
    assert missing == set()


def test_a_dangling_ix_in_an_iterate_body_still_raises():
    """The port's ``Iterate`` withholds a round whose strict ``ix`` dangles, for the inputs that
    the async plane brings late; a pointer still dangling when the stream ends raises as in the
    reference."""
    for pkg in ("pathway_tpu", "pathway_tpu_torch"):
        side = Side(pkg)
        pw = side.pw
        pw.G.clear()
        t = pw.debug.table_from_rows(pw.schema_from_types(k=int, to=int), [(1, 2), (2, 9)])
        t = t.with_id_from(t.k)

        def step(t):
            return t.select(t.k, to=t.ix(t.pointer_from(t.to)).to)

        out = pw.iterate(step, iteration_limit=2, t=t)
        try:
            with pytest.raises(KeyError, match="missing from the indexed table"):
                side.run_table(out)
        finally:
            pw.G.clear()


def _dangling_iterate(pw):
    raw = held_open_feed(pw, {"i": [0, 1], "k": [1, 2], "to": [2, 9]}, i=int, k=int, to=int)
    t = raw.with_id_from(raw.k).select(k=pw.this.k, to=pw.this.to)

    def step(t):
        return t.select(t.k, to=t.ix(t.pointer_from(t.to)).to)

    return pw.iterate(step, iteration_limit=2, t=t)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_a_dangling_ix_in_an_iterate_body_raises_at_once_on_one_worker(pkg):
    """Outside the async plane every input of a tick has arrived, so the port's ``Iterate``
    raises a dangling round in the tick that made it, as the reference does, and does not wait
    for the stream to end."""
    raises_before_the_stream_ends(pkg, _dangling_iterate, "missing from the indexed table")
