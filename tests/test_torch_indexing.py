"""``pw.indexing`` and ``Table.sort``: the port against the JAX package on the CPU.

The programs of ``tests/test_indexing.py``, ``tests/test_ported_ml_index.py`` and
``tests/test_ported_sorting.py`` are built in both packages from the same seeded inputs and run
through the JAX package's ``pw.run()`` and the port's ``pw.run(device="cpu")``. Row keys are the
same bits in both packages, so whole result tables are compared, key by key.

Tolerances:
- brute-force KNN scores within one bf16 ulp of the reference's, and ids equal wherever the
  reference's scores are clear of their neighbours by more than that (ROADMAP Queue 3 item 3:
  the port's scorer rounds products to bf16 as the JAX program's types say, jitted XLA on the
  CPU keeps the f32 sum);
- BM25, LSH and the hybrid's reciprocal-rank fusion: exact, since both run the same host numpy
  and Python code;
- sorting: exact.
"""

from __future__ import annotations

import math
import time

import numpy as np
import pytest

import pathway_tpu as rpw
import pathway_tpu_torch as tpw
from pathway_tpu.internals.parse_graph import G as RG
from pathway_tpu.internals.table_io import rows_to_table as r_rows
from pathway_tpu.ops import index_engines as RE
from pathway_tpu.stdlib.ml.index import KNNIndex
from pathway_tpu_torch.internals import dtype as tdt
from pathway_tpu_torch.internals.parse_graph import G as TG
from pathway_tpu_torch.internals.table_io import rows_to_table as t_rows
from pathway_tpu_torch.ops import index_engines as TE


@pytest.fixture(autouse=True)
def _clear_graphs():
    RG.clear()
    TG.clear()
    yield
    RG.clear()
    TG.clear()


class Side:
    """One package: its ``pw``, its ``rows_to_table`` and how it computes a table."""

    def __init__(self, pw, rows, dicts, run):
        self.pw, self.rows, self._dicts, self.run = pw, rows, dicts, run

    def dicts(self, table):
        keys, cols = self._dicts(table)
        return sorted(int(k) for k in keys), cols


REF = Side(rpw, r_rows, rpw.debug.table_to_dicts, lambda: rpw.run())
PORT = Side(tpw, t_rows, lambda t: tpw.debug.table_to_dicts(t, device="cpu"),
            lambda: tpw.run(device="cpu"))


def both(program):
    """``program(side)`` built and computed in each package: (reference's, port's)."""
    return REF.dicts(program(REF)), PORT.dicts(program(PORT))


def unit_rows(seed: int, n: int, d: int) -> np.ndarray:
    v = np.random.default_rng(seed).standard_normal((n, d))
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def bf16_ulp(x: float) -> float:
    return 0.0 if x == 0 else 2.0 ** (math.floor(math.log2(abs(x))) - 7)


def assert_knn_close(got_ids, got_scores, want_ids, want_scores):
    """One query's answer: the same length, scores within one bf16 ulp, and ids equal wherever
    the reference's score is clear of its neighbours' by more than one ulp."""
    assert len(got_ids) == len(want_ids), (got_ids, want_ids)
    for i, (g, w) in enumerate(zip(got_scores, want_scores)):
        assert abs(float(g) - float(w)) <= bf16_ulp(float(w)), (i, g, w)
    for i, (g, w) in enumerate(zip(got_ids, want_ids)):
        near = [abs(float(want_scores[i]) - float(want_scores[j])) <= 2 * bf16_ulp(
            float(want_scores[i])) for j in (i - 1, i + 1) if 0 <= j < len(want_scores)]
        if not any(near):
            assert g == w, (i, got_ids, want_ids)


def vec_table(side, vecs, names=None, extra=None):
    names = names or [f"d{i}" for i in range(len(vecs))]
    rows = [(n, np.asarray(v, dtype=np.float64)) + ((extra[i],) if extra else ())
            for i, (n, v) in enumerate(zip(names, vecs))]
    return side.rows(["name", "vec"] + (["meta"] if extra else []), rows)


def stream(side, entries, names):
    """entries: [(time, row, diff)]."""
    return side.rows(names, [r for _, r, _ in entries], times=[t for t, _, _ in entries],
                     diffs=[d for _, _, d in entries])


# -- brute-force KNN: collapsed and flat, as-of-now and maintained, filters, deletions ----------


@pytest.mark.parametrize("metric", ["cos", "l2"])
@pytest.mark.parametrize("asof_now", [True, False])
def test_knn_collapsed_against_the_reference(metric, asof_now):
    docs_v, q_v = unit_rows(3, 64, 16), unit_rows(4, 6, 16)

    def program(side):
        ix = side.pw.indexing
        docs = vec_table(side, docs_v)
        queries = side.rows(["qname", "qvec"], [(f"q{i}", q) for i, q in enumerate(q_v)])
        inner = ix.BruteForceKnn(data_column=docs.vec, dimensions=16, reserved_space=16,
                                 metric=metric)
        index = ix.DataIndex(docs, inner)
        query = index.query_as_of_now if asof_now else index.query
        jr = query(queries.qvec, number_of_matches=4)
        return jr.select(side.pw.left.qname, names=side.pw.right.name,
                         scores=side.pw.right._pw_index_reply_score)

    (rk, ref), (pk, got) = both(program)
    assert rk == pk
    for k in rk:
        assert got["qname"][k] == ref["qname"][k]
        assert_knn_close(got["names"][k], got["scores"][k], ref["names"][k], ref["scores"][k])


def test_knn_flat_mode_against_the_reference():
    docs_v, q_v = unit_rows(5, 30, 8), unit_rows(6, 3, 8)

    def program(side):
        ix = side.pw.indexing
        docs = vec_table(side, docs_v)
        queries = side.rows(["qname", "qvec"], [(f"q{i}", q) for i, q in enumerate(q_v)])
        inner = ix.BruteForceKnn(data_column=docs.vec, dimensions=8, reserved_space=16)
        jr = ix.DataIndex(docs, inner).query_as_of_now(queries.qvec, number_of_matches=3,
                                                       collapse_rows=False)
        return jr.select(side.pw.left.qname, side.pw.right.name,
                         score=side.pw.right._pw_index_reply_score)

    (rk, ref), (pk, got) = both(program)
    assert len(rk) == len(pk) == 9
    by_query = lambda d: {q: sorted((d["score"][k], d["name"][k]) for k in d["qname"]  # noqa: E731
                                    if d["qname"][k] == q)[::-1] for q in set(d["qname"].values())}
    want, have = by_query(ref), by_query(got)
    assert want.keys() == have.keys()
    for q in want:
        assert_knn_close([n for _, n in have[q]], [s for s, _ in have[q]],
                         [n for _, n in want[q]], [s for s, _ in want[q]])


@pytest.mark.parametrize("case", ["maintained_new_doc", "asof_now_not_revisited",
                                  "deletion_maintained", "no_match"])
def test_knn_streams_against_the_reference(case):
    """The streaming programs of ``tests/test_indexing.py``: answers equal exactly (their scores
    are exact in bf16)."""

    def program(side):
        ix = side.pw.indexing
        if case == "no_match":
            docs = vec_table(side, [[0.0, 0.0, 1.0]], ["pad"]).filter(side.pw.this.name != "pad")
        else:
            late = (2, ("x", np.array([1.0, 0.0, 0.0])), -1) if case == "deletion_maintained" \
                else (2, ("best", np.array([0.0, 1.0, 0.0])), 1)
            docs = stream(side, [(0, ("x", np.array([1.0, 0.0, 0.0])), 1),
                                 (0, ("z", np.array([0.9, 0.1, 0.0])), 1), late],
                          ["name", "vec"])
        q = [1.0, 0.0, 0.0] if case == "deletion_maintained" else [0.0, 1.0, 0.0]
        queries = stream(side, [(1, ("q1", np.array(q)), 1)], ["qname", "qvec"])
        inner = ix.BruteForceKnn(data_column=docs.vec, dimensions=3, reserved_space=16)
        index = ix.DataIndex(docs, inner)
        query = index.query_as_of_now if case == "asof_now_not_revisited" else index.query
        return query(queries.qvec, number_of_matches=1).select(
            side.pw.left.qname, matches=side.pw.right.name)

    ref, got = both(program)
    assert got == ref
    want = {"maintained_new_doc": ("best",), "asof_now_not_revisited": ("z",),
            "deletion_maintained": ("z",), "no_match": ()}[case]
    assert list(got[1]["matches"].values()) == [want]


def test_knn_metadata_filter_against_the_reference():
    docs_v = unit_rows(8, 24, 4)
    owners = [f'{{"owner": "{"alice" if i % 3 else "bob"}", "n": {i}}}' for i in range(24)]

    def program(side):
        ix = side.pw.indexing
        docs = vec_table(side, docs_v, extra=owners)
        queries = side.rows(["qname", "qvec", "flt"], [
            ("q0", docs_v[1], "owner == 'bob'"), ("q1", docs_v[2], "n > `20`"),
            ("q2", docs_v[3], None)])
        inner = ix.BruteForceKnn(data_column=docs.vec, metadata_column=docs.meta,
                                 dimensions=4, reserved_space=16)
        jr = ix.DataIndex(docs, inner).query_as_of_now(queries.qvec, number_of_matches=3,
                                                       metadata_filter=queries.flt)
        return jr.select(side.pw.left.qname, names=side.pw.right.name,
                         scores=side.pw.right._pw_index_reply_score)

    (rk, ref), (pk, got) = both(program)
    assert rk == pk
    for k in rk:
        assert_knn_close(got["names"][k], got["scores"][k], ref["names"][k], ref["scores"][k])
    q0 = next(k for k in pk if got["qname"][k] == "q0")
    assert all(int(n[1:]) % 3 == 0 for n in got["names"][q0])


def test_usearch_and_vector_document_index_map_to_brute_force():
    docs_v, q_v = unit_rows(9, 20, 8), unit_rows(10, 2, 8)

    def program(side):
        ix = side.pw.indexing
        docs = vec_table(side, docs_v)
        queries = side.rows(["qname", "qvec"], [(f"q{i}", q) for i, q in enumerate(q_v)])
        a = ix.DataIndex(docs, ix.USearchKnn(data_column=docs.vec, dimensions=8)) \
            .query_as_of_now(queries.qvec, number_of_matches=2)
        b = ix.default_vector_document_index(docs.vec, docs, dimensions=8) \
            .query_as_of_now(queries.qvec, number_of_matches=2)
        return a.select(side.pw.left.qname, a_names=side.pw.right.name) + \
            b.select(b_names=side.pw.right.name)

    (rk, ref), (pk, got) = both(program)
    assert rk == pk
    for k in pk:
        assert got["a_names"][k] == got["b_names"][k]
        assert set(got["a_names"][k]) == set(ref["a_names"][k])


# -- LSH, BM25 and the hybrid: exact ------------------------------------------------------------


def test_lsh_against_the_reference_exactly():
    vecs = unit_rows(7, 40, 8)

    def program(side):
        ix = side.pw.indexing
        docs = vec_table(side, vecs)
        queries = side.rows(["qname", "qvec"], [(f"q{i}", vecs[i * 7]) for i in range(5)])
        inner = ix.LshKnn(data_column=docs.vec, dimensions=8, n_or=6, n_and=4, seed=3)
        return ix.DataIndex(docs, inner).query_as_of_now(queries.qvec, number_of_matches=3) \
            .select(side.pw.left.qname, names=side.pw.right.name,
                    scores=side.pw.right._pw_index_reply_score)

    ref, got = both(program)
    assert got == ref
    for k in got[0]:  # each query is a document: its own row comes first
        assert got[1]["names"][k][0] == f"d{int(got[1]['qname'][k][1:]) * 7}"


BM25_DOCS = [
    ("a", "the quick brown fox jumps over the lazy dog"),
    ("b", "pack my box with five dozen liquor jugs"),
    ("c", "the brown dog sleeps by the fire"),
    ("d", "a dog and a fox and a box"),
]


@pytest.mark.parametrize("query", ["brown dog", "zebra", "liquor jugs", "box fox the"])
def test_bm25_against_the_reference_exactly(query):
    def program(side):
        ix = side.pw.indexing
        docs = side.rows(["name", "text"], BM25_DOCS)
        queries = side.rows(["qname", "qtext"], [("q1", query)])
        a = ix.DataIndex(docs, ix.TantivyBM25(data_column=docs.text)).query_as_of_now(
            queries.qtext, number_of_matches=3)
        b = ix.default_full_text_document_index(docs.text, docs).query_as_of_now(
            queries.qtext, number_of_matches=1)
        return a.select(side.pw.left.qname, names=side.pw.right.name,
                        scores=side.pw.right._pw_index_reply_score) + \
            b.select(top=side.pw.right.name)

    ref, got = both(program)
    assert got == ref
    if query == "zebra":
        assert list(got[1]["names"].values()) == [()]


WORDS = "alpha beta gamma delta epsilon zeta eta theta".split()


def _text_vector(text: str) -> np.ndarray:
    """A deterministic text embedder for both packages: coordinate j is 1 when word j of
    ``WORDS`` is in the text, so inner products of these vectors are small integers, exact in
    bf16."""
    toks = set(text.split())
    return np.array([1.0 if w in toks else 0.0 for w in WORDS])


HYBRID_TEXTS = [(f"t{i}", " ".join(w for j, w in enumerate(
    "alpha beta gamma delta epsilon zeta eta theta".split()) if (i >> (j % 4)) & 1 or j == i % 8))
    for i in range(16)]
HYBRID_QUERIES = [("q0", "alpha beta"), ("q1", "gamma theta")]


@pytest.mark.parametrize("vector_index", ["lsh", "brute_force"])
def test_hybrid_rrf_against_the_reference_exactly(vector_index):
    """BM25 fused with a vector index over an embedder: the fused scores are equal exactly. With
    LSH both sub-rankings are host numpy. The brute-force index ranks by inner products that are
    exact in bf16 (``_text_vector``), so its ranking, ties ordered by row, is the reference's."""

    def program(side):
        ix = side.pw.indexing
        docs = side.rows(["name", "text"], HYBRID_TEXTS)
        queries = side.rows(["qname", "qtext"], HYBRID_QUERIES)
        vector = ix.LshKnnFactory(dimensions=8, n_or=4, n_and=2, embedder=_text_vector) \
            if vector_index == "lsh" else \
            ix.BruteForceKnnFactory(dimensions=8, metric="ip", embedder=_text_vector)
        factory = ix.HybridIndexFactory([ix.TantivyBM25Factory(), vector], k=60)
        return factory.build_index(docs.text, docs).query_as_of_now(
            queries.qtext, number_of_matches=4).select(
                side.pw.left.qname, names=side.pw.right.name,
                scores=side.pw.right._pw_index_reply_score)

    ref, got = both(program)
    assert got == ref
    assert all(len(v) == 4 for v in got[1]["names"].values())


@pytest.mark.parametrize("engine", ["lsh", "bm25", "hybrid"])
def test_host_engines_against_the_reference_directly(engine):
    """The engines called directly, with adds, removals and re-adds: exact equality."""
    vecs = unit_rows(12, 50, 6).astype(np.float32)
    words = "red green blue cyan magenta yellow black white".split()
    rng = np.random.default_rng(13)
    texts = [" ".join(rng.choice(words, 5)) for _ in range(50)]

    def make(mod):
        if engine == "lsh":
            return mod.LshKnnEngine(6, n_or=3, n_and=3, seed=1, **(
                {"device": "cpu"} if mod is TE else {}))
        if engine == "bm25":
            return mod.BM25Engine()
        return mod.HybridEngine([mod.BM25Engine(), mod.BM25Engine(k1=2.0, b=0.5)], rrf_k=10)

    data = list(vecs) if engine == "lsh" else texts
    queries = list(vecs[:6]) if engine == "lsh" else ["red blue", "white", "cyan cyan magenta"]
    out = []
    for mod in (RE, TE):
        eng = make(mod)
        for i, d in enumerate(data):
            eng.add(1000 + i, d, '{"i": %d}' % i)
        for i in range(0, 50, 7):
            eng.remove(1000 + i)
        eng.add(1003, data[40], None)
        out.append(eng.search(queries, [5] * len(queries), [None, "i < `30`", None][
            :len(queries)] + [None] * max(0, len(queries) - 3)))
    assert out[1] == out[0]


# -- sorting ------------------------------------------------------------------------------------


def test_sort_prev_next_against_the_reference():
    def program(side):
        t = side.rows(["v"], [(3,), (1,), (2,), (7,), (5,)])
        return t + t.sort(key=side.pw.this.v)

    ref, got = both(program)
    assert got == ref
    (keys, cols) = got
    by_v = {cols["v"][k]: k for k in keys}
    assert cols["prev"][by_v[1]] is None and cols["next"][by_v[1]] == by_v[2]
    assert cols["next"][by_v[7]] is None


@pytest.mark.parametrize("instances", [1, 2])
def test_prevnext_instances_against_the_reference(instances):
    """``tests/test_ported_sorting.py``'s programs: one instance and many."""
    md = """
          | key | instance
        1 |  1  | 42
        2 |  5  | 42
        3 |  3  | 42
        4 |  8  | 42
        5 |  2  | 42
    """ if instances == 1 else """
          | key | instance
        1 |  1  | 42
        2 |  1  | 28
        3 |  5  | 42
        4 |  5  | 28
        5 |  3  | 42
        6 |  3  | 28
        7 |  8  | 42
        8 |  8  | 28
        9 |  2  | 42
        10|  2  | 28
    """

    def program(side):
        nodes = side.pw.debug.table_from_markdown(md)
        return nodes.sort(key=nodes.key, instance=nodes.instance)

    ref, got = both(program)
    assert got == ref


def test_argmin_pointer_against_the_reference():
    """``tests/test_ported_sorting.py::test_argmin``'s program."""

    def program(side):
        t = side.pw.debug.table_from_markdown("""
            hash
            931894100059286216
            1339595727108001898
            1793254503348522670
            97653197660818656
            301593703415097707
        """)
        return t.reduce(key=side.pw.reducers.argmin(t.hash))

    ref, got = both(program)
    assert got == ref


def test_retrieve_prev_next_values_against_the_reference():
    def program(side):
        t = side.rows(["ts", "val"], [(1, 10.0), (2, None), (3, 30.0), (4, None), (5, None)])
        chained = t + t.sort(key=side.pw.this.ts)
        return chained + side.pw.indexing.retrieve_prev_next_values(chained, value=chained.val)

    ref, got = both(program)
    assert got == ref
    by_ts = {got[1]["ts"][k]: (got[1]["prev_value"][k], got[1]["next_value"][k])
             for k in got[0]}
    assert by_ts[2] == (10.0, 30.0) and by_ts[5] == (30.0, None)


def test_sorted_index_helpers_against_the_reference():
    def program(side):
        ix = side.pw.indexing
        nodes = side.rows(["key", "instance"], [(5, 1), (2, 1), (9, 2), (1, 2), (4, 1)])
        return ix.build_sorted_index(nodes)["index"]

    ref, got = both(program)
    assert got == ref


# -- the ml KNN-index programs (``tests/test_ported_ml_index.py``) -------------------------------

POINTS = [(2, 2, 0), (3, -2, 0), (0, 0, 1), (-1, 0, 0), (2, -2, 1), (1, 2, 0), (-1, 1, 1),
          (-3, 1, 0), (-2, -3, 1), (1, -4, 0)]


def _points(side):
    rows = [((float(x), float(y)), bool(q)) for x, y, q in POINTS]
    table = side.rows(["coords", "is_query"], rows)
    points = table.filter(~side.pw.this.is_query).without(side.pw.this.is_query)
    queries = table.filter(side.pw.this.is_query).without(side.pw.this.is_query)
    return points, queries


def _nearest(side, points, queries, k, *, metadata=None, metadata_filter=None):
    """What ``KNNIndex(points.coords, points, n_dimensions=2).get_nearest_items(...)`` runs:
    the reference through ``KNNIndex`` itself, the port through the same ``DataIndex`` over a
    brute-force index with the squared-l2 metric (``stdlib/ml`` is not ported)."""
    if side is REF:
        return KNNIndex(points.coords, points, n_dimensions=2, metadata=metadata) \
            .get_nearest_items(queries.coords, k=k, with_distances=True,
                               metadata_filter=metadata_filter)
    ix = side.pw.indexing
    inner = ix.BruteForceKnn(data_column=points.coords, metadata_column=metadata,
                             dimensions=2, metric="l2sq")
    jr = ix.DataIndex(points, inner).query(queries.coords, number_of_matches=k,
                                           metadata_filter=metadata_filter)
    return jr.select(coords=side.pw.right.coords, dist=side.pw.apply_with_type(
        lambda scores: tuple(-float(s) for s in (scores or ())), tdt.ANY,
        side.pw.right._pw_index_reply_score))


@pytest.mark.parametrize("case", ["all_at_once", "metadata_filter", "no_match"])
def test_ml_index_programs_against_the_reference(case):
    def program(side):
        points, queries = _points(side)
        meta = flt = None
        if case == "metadata_filter":
            points = points.with_columns(meta=side.pw.apply_with_type(
                lambda c: {"x": float(c[0])}, dict, side.pw.this.coords))
            queries = queries.with_columns(flt="x < `0`")
            meta, flt = points.meta, queries.flt
        if case == "no_match":
            points = points.filter(side.pw.this.coords != side.pw.this.coords)
        res = _nearest(side, points, queries, 2, metadata=meta, metadata_filter=flt)
        return queries + res.select(nn=side.pw.this.coords, dist=side.pw.this.dist)

    (rk, ref), (pk, got) = both(program)
    assert rk == pk
    for k in rk:
        assert got["coords"][k] == ref["coords"][k]
        assert_knn_close(got["nn"][k], [-d for d in got["dist"][k]], ref["nn"][k],
                         [-d for d in ref["dist"][k]])
    if case == "all_at_once":
        origin = next(k for k in pk if got["coords"][k] == (0.0, 0.0))
        assert sorted(got["nn"][origin]) == [(-1.0, 0.0), (1.0, 2.0)]
        assert got["dist"][origin][0] == 1.0
    if case == "no_match":
        assert all(v == () for v in got["nn"].values())


def test_ml_index_update_old_against_the_reference():
    """``test_update_old``: a closer point that arrives after the query was answered retracts
    the old answer; the maintained answers' history is the same in both packages."""

    def program(side):
        pw = side.pw

        class Points(pw.io.python.ConnectorSubject):
            def run(self):
                self.next(x=2.0, y=2.0)
                self.next(x=3.0, y=-2.0)
                self.commit()
                time.sleep(0.1)
                self.next(x=0.1, y=0.1)  # late, closer to the query point
                self.commit()

        pts = pw.io.python.read(Points(), schema=pw.schema_from_types(x=float, y=float),
                                autocommit_duration_ms=None)
        pts = pts.select(coords=pw.apply_with_type(lambda x, y: (x, y), tuple, pw.this.x,
                                                   pw.this.y))
        queries = pw.debug.table_from_rows(pw.schema_from_types(qc=tuple), [((0.0, 0.0),)])
        ix = pw.indexing
        jr = ix.DataIndex(pts, ix.BruteForceKnn(data_column=pts.coords, dimensions=2,
                                                metric="l2sq")).query(queries.qc,
                                                                      number_of_matches=1)
        res = jr.select(nn=pw.right.coords)
        history = []
        pw.io.subscribe(res, on_change=lambda key, row, time, is_addition: history.append(
            (int(key), row["nn"], is_addition)))
        side.run()
        return history

    ref, got = program(REF), program(PORT)
    assert got == ref
    net: dict = {}
    for _, nn, add in got:
        net[nn] = net.get(nn, 0) + (1 if add else -1)
    assert {nn for nn, c in net.items() if c > 0} == {((0.1, 0.1),)}
    assert (((2.0, 2.0),), True) in [r[1:] for r in got]
    assert any(nn == ((2.0, 2.0),) and not add for _, nn, add in got)


def test_index_engines_default_to_the_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TE.LshKnnEngine(8)
    docs = vec_table(PORT, unit_rows(1, 4, 3))
    ix = tpw.indexing
    jr = ix.DataIndex(docs, ix.BruteForceKnn(data_column=docs.vec, dimensions=3)) \
        .query_as_of_now(docs.vec, number_of_matches=1)
    tpw.io.subscribe(jr.select(m=tpw.right.name), on_change=lambda **kw: None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpw.run()
