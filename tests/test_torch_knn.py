"""The PyTorch port's KNN scorer against the JAX package's, on the CPU at a small size.

``topk_scores`` (the kernel's plain version on CPU tensors), ``ShardedKnnIndex`` and
``merge_shard_topk`` get the same numpy inputs as ``pathway_tpu.ops.knn``. Scores agree within one
bf16 ulp of the dot product; ids agree wherever a score stands more than that from its
neighbours; equal scores (duplicated rows, rows masked to -inf) give identical ids, lower row
first, as ``lax.top_k`` orders them.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.ops import knn as jknn
from pathway_tpu_torch.ops import knn as tknn
from torch_topk_checks import assert_topk_equal, bf16_ulp, topk_tol


def _data(seed: int = 0, n: int = 1000, d: int = 48, q: int = 7, metric: str = "cos"):
    rng = np.random.default_rng(seed)
    index = rng.standard_normal((n, d)).astype(np.float32)
    if metric == "cos":
        index /= np.linalg.norm(index, axis=1, keepdims=True)
    index[n // 2 : n // 2 + 40] = index[:40]  # duplicated rows: exact ties
    queries = index[rng.integers(0, 40, q)] + 0.05 * rng.standard_normal((q, d)).astype(np.float32)
    valid = rng.random(n) > 0.2
    valid[:40] = True
    valid[n // 2 : n // 2 + 40] = True
    return queries.astype(np.float32), index, valid


@pytest.mark.parametrize("metric", ["cos", "ip", "l2"])
@pytest.mark.parametrize("k", [1, 10, 64])
def test_topk_scores_matches_jax(metric, k):
    queries, index, valid = _data(metric=metric)
    js, ji = jknn.topk_scores(jnp.asarray(queries), jnp.asarray(index), k + 1, metric,
                              valid=jnp.asarray(valid))
    ts, ti = tknn.topk_scores(torch.from_numpy(queries), torch.from_numpy(index), k, metric,
                              valid=torch.from_numpy(valid))
    assert ts.dtype == torch.float32 and ti.dtype == torch.int64
    js = np.asarray(js)
    pairs = assert_topk_equal(ts.numpy(), ti.numpy(), js, np.asarray(ji),
                              topk_tol(js, queries, index, metric))
    if k >= 10:  # duplicated rows tied, and came in the same order on both sides
        assert pairs > 0


@pytest.mark.parametrize("metric", ["cos", "l2"])
def test_topk_scores_k_past_valid_count_fills_minus_inf(metric):
    queries, index, _ = _data(seed=1, n=300, metric=metric)
    valid = np.zeros(300, bool)
    valid[[3, 250, 17, 299]] = True
    js, ji = jknn.topk_scores(jnp.asarray(queries), jnp.asarray(index), 13, metric,
                              valid=jnp.asarray(valid))
    ts, ti = tknn.topk_scores(torch.from_numpy(queries), torch.from_numpy(index), 12, metric,
                              valid=torch.from_numpy(valid))
    js = np.asarray(js)
    assert np.isneginf(ts.numpy()[:, 4:]).all()
    assert_topk_equal(ts.numpy(), ti.numpy(), js, np.asarray(ji), topk_tol(js, queries, index, metric))
    np.testing.assert_array_equal(ti.numpy()[:, 4:], np.asarray(ji)[:, 4:12])  # ids 0, 1, 2, 4...


def test_topk_scores_unmasked_ties_are_lower_index_first():
    index = np.array([[1, 0], [1, 0], [2, 0], [2, 0], [3, 0]], np.float32)
    queries = np.array([[1, 0]], np.float32)
    js, ji = jknn.topk_scores(jnp.asarray(queries), jnp.asarray(index), 3, "ip")
    ts, ti = tknn.topk_scores(torch.from_numpy(queries), torch.from_numpy(index), 3, "ip")
    assert ti.tolist() == np.asarray(ji).tolist() == [[4, 2, 3]]
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_knn_search_matches_jax():
    queries, index, _ = _data(seed=2, n=500)
    js, ji = jknn.knn_search(queries, index, 6)
    ts, ti = tknn.knn_search(queries, index, 5, device="cpu")
    assert_topk_equal(ts, ti, js, ji, bf16_ulp(js))


def test_sharded_knn_index_matches_jax():
    rng = np.random.default_rng(3)
    ours = tknn.ShardedKnnIndex(16, capacity=256, device="cpu")
    theirs = jknn.ShardedKnnIndex(16, capacity=256)
    for n in (30, 1, 90):
        vecs = rng.standard_normal((n, 16)).astype(np.float32)
        keys = [f"doc{ours.size + i}" for i in range(n)]
        ours.add(vecs, keys)
        theirs.add(vecs, keys)
    ours.add(rng.standard_normal((4, 16)).astype(np.float32))  # default keys: the row numbers
    theirs.add(ours._data[121:125].numpy())
    queries = rng.standard_normal((5, 16)).astype(np.float32)
    s_o, i_o = ours.query(queries, 8)
    s_t, i_t = theirs.query(queries, 9)
    assert_topk_equal(s_o, i_o, s_t, i_t, bf16_ulp(s_t))
    assert ours.keys_of(i_o) == theirs.keys_of(i_t[:, :8])
    assert ours.keys_of(np.array([[0, 124, 125, -1]])) == [["doc0", 124, None, None]]
    with pytest.raises(ValueError, match="capacity"):
        ours.add(np.zeros((200, 16), np.float32))


def test_sharded_knn_index_empty_and_mesh():
    ours = tknn.ShardedKnnIndex(8, capacity=32, device="cpu")
    theirs = jknn.ShardedKnnIndex(8, capacity=32)
    q = np.ones((2, 8), np.float32)
    s_o, i_o = ours.query(q, 3)
    s_t, i_t = theirs.query(q, 3)
    assert s_o.shape == s_t.shape == (2, 1)
    assert np.isneginf(s_o).all() and np.isneginf(s_t).all()
    np.testing.assert_array_equal(i_o, i_t)
    # a mesh is taken now (tests/test_torch_sharded_knn.py runs it on gloo ranks); one laid over
    # another device type than the index's is refused
    card_mesh = type("CardMesh", (), {"device_type": "cuda"})()
    with pytest.raises(ValueError, match="mesh on 'cuda', index on 'cpu'"):
        tknn.ShardedKnnIndex(8, capacity=32, mesh=card_mesh, device="cpu")


def test_merge_shard_topk_matches_jax():
    rng = np.random.default_rng(4)
    parts = []
    for shard in range(4):
        keys = rng.choice(40, size=12, replace=False).tolist()
        scores = np.round(rng.standard_normal(12), 1).tolist()  # rounded: ties across shards
        parts.append(sorted(zip(keys, scores), key=lambda kv: -kv[1]))
    for k in (1, 5, 30, 100):
        assert tknn.merge_shard_topk(parts, k) == jknn.merge_shard_topk(parts, k)


def test_kernel_plan_and_limits():
    p = tknn.plan(64, 1 << 20, 384, 10, 132)
    assert p.route == "stream" and p.qc == 64 and p.tiles_per_range == 0
    assert p.grid == 132 and p.blocks_per_sm == 1  # one persistent block on each of 132 SMs
    assert tknn.plan(1, 1000, 3, 10, 132).qc == 16  # the tile route, one query: small chunks
    assert tknn.plan(64, 1000, 384, 1024, 132).qc == 16  # large k: lists fit in shared memory
    p = tknn.plan(64, 100, 8, 5, 132)
    assert p.route == "stream" and p.grid == 1  # one tile of 128 rows, one block
    p = tknn.plan(64, 100, 3, 5, 132)
    assert p.route == "tile" and p.grid == 2 and p.tiles_per_range == 1  # two tiles of 64 rows
    with pytest.raises(ValueError, match="no kernel"):
        tknn.topk_scores(torch.zeros((1, 8), device="meta"), torch.zeros((4, 8), device="meta"), 1)


def test_knn_search_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tknn.knn_search(np.zeros((1, 4), np.float32), np.zeros((2, 4), np.float32), 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tknn.ShardedKnnIndex(4, capacity=8)


@pytest.mark.parametrize("metric", ["cos", "l2"])
def test_k_zero_gives_no_column_as_lax_top_k(metric):
    """k = 0: ``[q, 0]`` scores and ids from ``topk_scores``, its plain version, ``knn_search``
    and ``ShardedKnnIndex.query``, as the JAX package's ``lax.top_k`` gives."""
    queries, index, valid = _data(seed=5, n=100, metric=metric)
    js, ji = jknn.topk_scores(jnp.asarray(queries), jnp.asarray(index), 0, metric,
                              valid=jnp.asarray(valid))
    for fn in (tknn.topk_scores, tknn.topk_scores_plain):
        ts, ti = fn(torch.from_numpy(queries), torch.from_numpy(index), 0, metric,
                    valid=torch.from_numpy(valid))
        assert ts.shape == ti.shape == np.asarray(js).shape == np.asarray(ji).shape == (7, 0)
        assert ts.dtype == torch.float32 and ti.dtype == torch.int64
    ks, ki = tknn.knn_search(queries, index, 0, metric, device="cpu")
    assert ks.shape == ki.shape == jknn.knn_search(queries, index, 0, metric)[0].shape
    ours = tknn.ShardedKnnIndex(index.shape[1], capacity=128, metric=metric, device="cpu")
    theirs = jknn.ShardedKnnIndex(index.shape[1], capacity=128, metric=metric)
    ours.add(index)
    theirs.add(index)
    assert ours.query(queries, 0)[0].shape == np.asarray(theirs.query(queries, 0)[0]).shape


def test_k_past_the_rows_raises_as_lax_top_k():
    """k above the rows: ``ValueError`` from the JAX package and from every entry of the port;
    a negative k too. Before, the plain version returned n columns."""
    queries, index, _ = _data(seed=6, n=80)
    index = index[:4]
    with pytest.raises(ValueError, match="no larger than"):
        jknn.topk_scores(jnp.asarray(queries), jnp.asarray(index), 5)
    with pytest.raises(ValueError, match="no larger than"):
        jknn.knn_search(queries, index, 5)
    for fn in (tknn.topk_scores, tknn.topk_scores_plain):
        with pytest.raises(ValueError, match="no larger than"):
            fn(torch.from_numpy(queries), torch.from_numpy(index), 5)
        with pytest.raises(ValueError, match="nonnegative"):
            fn(torch.from_numpy(queries), torch.from_numpy(index), -1)
    with pytest.raises(ValueError, match="no larger than"):
        tknn.knn_search(queries, index, 5, device="cpu")
    s, _ = tknn.knn_search(queries, index, 4, device="cpu")  # k = n is taken
    assert s.shape == (7, 4)


def _edge_data(n: int, d: int, seed: int):
    """Rows of width d with copies that tie across the 64-row and 128-row tile borders of the
    two routes (rows 63/64, 127/128 and 255/256 equal), and queries equal to those rows."""
    rng = np.random.default_rng(seed)
    index = rng.standard_normal((n, d)).astype(np.float32)
    pairs = [(63, 64), (127, 128), (255, 256)]
    for a, b in pairs:
        if b < n:
            index[b] = index[a]
    queries = np.stack([index[a] for a, b in pairs if b < n] + [index[n - 1]])
    return queries.astype(np.float32), index


@pytest.mark.parametrize("metric", ["cos", "ip", "l2"])
@pytest.mark.parametrize("n,d,k", [(300, 1, 5), (1077, 1030, 10), (100, 8, 3), (2000, 96, 16),
                                   (16973, 12, 17)])
def test_plain_scorer_matches_jax_at_the_routes_edges(metric, n, d, k):
    """Rows not a multiple of either route's tile, widths 1 and past ``MAX_DIM``, k at and past
    the stream route's limit, and exact ties across tile borders (lower row first)."""
    queries, index = _edge_data(n, d, seed=n + d)
    valid = np.random.default_rng(d).random(n) > 0.1
    for a, b in [(63, 64), (127, 128), (255, 256)]:
        if b < n:
            valid[[a, b]] = True
    js, ji = jknn.topk_scores(jnp.asarray(queries), jnp.asarray(index), k + 1, metric,
                              valid=jnp.asarray(valid))
    ts, ti = tknn.topk_scores(torch.from_numpy(queries), torch.from_numpy(index), k, metric,
                              valid=torch.from_numpy(valid))
    js = np.asarray(js)
    assert_topk_equal(ts.numpy(), ti.numpy(), js, np.asarray(ji),
                      topk_tol(js, queries, index, metric))
    seen = 0  # the copied rows tie: where both are in the answer, the lower row comes first
    for r, (a, b) in enumerate(p for p in [(63, 64), (127, 128), (255, 256)] if p[1] < n):
        got = ti[r].tolist()
        if a in got and b in got:
            assert got.index(a) < got.index(b)
            seen += 1
    assert seen > 0 or metric != "l2"  # under l2 a query's copies are its nearest rows
