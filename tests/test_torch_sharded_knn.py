"""The port's sharded KNN search against the JAX package's, on the CPU.

``ShardedKnnIndex(mesh=...)`` and ``sharded_knn_search`` run on 2 and 4 ranks of a gloo group, one
process each (``torch_dist_child.py``, without JAX), against ``pathway_tpu.ops.knn`` on meshes of
as many CPU devices; the cases of ``tests/test_multichip.py`` (equal to one device, padding never
returned, the k clamp), an l2 index with capacity padding, and exact duplicate rows in two shards.
The merge (``topk_merge``, its plain version on CPU tensors) runs in this process against the JAX
merge, ``lax.top_k`` over the gathered candidates.

Tolerances: the sharded answer equals the port's one-device answer exactly. Against JAX, scores
within one bf16 ulp of the dot and ids equal wherever a score is clear of its neighbours by more
(``torch_topk_checks``: jitted XLA on the CPU keeps the f32 accumulator where the port rounds the
product to bf16); exact ties in ``lax.top_k``'s order, lower row first. The merge is exact.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from pathway_tpu.internals.jax_compat import shard_map
from pathway_tpu.ops import knn as jknn
from pathway_tpu_torch.ops.knn import (
    topk_merge, topk_merge_plain, topk_merge_shards, topk_merge_shards_plain,
)
from torch_dist_child import RankRun
from torch_topk_checks import assert_topk_equal, topk_tol

WORLDS = (2, 4)


def _unit(x: np.ndarray) -> np.ndarray:
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


@functools.cache
def _inputs() -> dict:
    rng = np.random.default_rng(0)
    docs = _unit(rng.standard_normal((256, 32)))
    raw = rng.standard_normal((200, 24)).astype(np.float32)
    dups = _unit(rng.standard_normal((60, 16)))
    dups[35] = dups[3]  # shard 0 and shard 1 (2 ranks) or 2 (4 ranks)
    dups[50] = dups[20]  # shard 0 and 1 (2 ranks), 1 and 3 (4 ranks)
    clamp = rng.standard_normal((6, 8)).astype(np.float32)
    index = {
        # tests/test_multichip.py::test_sharded_knn_matches_single_device, added in two calls
        "match": dict(dim=32, capacity=256, metric="cos", batches=[docs[:100], docs[100:]],
                      queries=_unit(rng.standard_normal((5, 32))), k=7),
        # an l2 index a quarter empty: capacity padding in the last shard(s)
        "l2": dict(dim=24, capacity=256, metric="l2", batches=[raw],
                   queries=raw[[5, 150]] + 0.1 * rng.standard_normal((2, 24)).astype(np.float32),
                   k=9),
        # test_knn_capacity_padding_never_returned: real scores below the padding rows' zero
        "padding": dict(dim=8, capacity=64, metric="cos", batches=[-np.eye(8, dtype=np.float32)[:5]],
                        queries=np.ones((1, 8), np.float32) / np.sqrt(8), k=5),
        # test_knn_sharded_k_clamp: k clamped to the rows per shard
        "clamp": dict(dim=8, capacity=16, metric="cos", batches=[clamp], queries=clamp[:2], k=5),
        "dups": dict(dim=16, capacity=64, metric="cos", batches=[dups],
                     queries=dups[[3, 20]] + 0.01 * rng.standard_normal((2, 16)).astype(np.float32),
                     k=5),
    }
    return {"index": index}


@functools.cache
def _jax(name: str, world: int, extra: int = 1) -> tuple[np.ndarray, np.ndarray]:
    """The JAX index of case ``name`` on a mesh of ``world`` CPU devices, queried for k +
    ``extra`` (clamped as its query clamps)."""
    case = _inputs()["index"][name]
    mesh = Mesh(np.array(jax.devices()[:world]), ("data",))
    idx = jknn.ShardedKnnIndex(dim=case["dim"], capacity=case["capacity"],
                               metric=case["metric"], mesh=mesh)
    for batch in case["batches"]:
        idx.add(batch)
    s, i = idx.query(case["queries"], case["k"] + extra)
    return np.asarray(s), np.asarray(i)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """For each world size, the ranks' results; the rank processes run while the JAX references
    are computed."""
    started = {w: RankRun("knn", w, tmp_path_factory.mktemp(f"knn{w}"), _inputs())
               for w in WORLDS}
    for w in WORLDS:
        for name in _inputs()["index"]:
            _jax(name, w)
    return {w: run.results() for w, run in started.items()}


@pytest.fixture(params=WORLDS, ids=lambda w: f"{w}ranks")
def ranks(request, runs):
    return request.param, runs[request.param]


@pytest.mark.parametrize("name", ["match", "l2", "padding", "clamp", "dups"])
def test_sharded_equals_one_device_exactly(ranks, name):
    _, results = ranks
    k = results[0][f"{name}_s"].shape[1]  # below the one-device k where the mesh clamps it
    for r in results:  # every rank answers, and answers the same
        np.testing.assert_array_equal(r[f"{name}_s"], results[0][f"{name}_single_s"][:, :k])
        np.testing.assert_array_equal(r[f"{name}_i"], results[0][f"{name}_single_i"][:, :k])


@pytest.mark.parametrize("name", ["match", "l2", "padding", "dups"])
def test_sharded_matches_jax(ranks, name):
    world, results = ranks
    case = _inputs()["index"][name]
    s_j, i_j = _jax(name, world)
    tol = topk_tol(s_j, case["queries"], np.concatenate(case["batches"]), case["metric"])
    pairs = assert_topk_equal(results[0][f"{name}_s"], results[0][f"{name}_i"], s_j, i_j, tol)
    if name == "dups":  # the duplicated rows tie, and come lower shard first on both sides
        assert pairs == 2
        np.testing.assert_array_equal(results[0]["dups_i"][:, :2], [[3, 35], [20, 50]])


def test_padding_never_returned(ranks):
    _, results = ranks
    s, i = results[0]["padding_s"], results[0]["padding_i"]
    assert set(i[0].tolist()) <= set(range(5))
    assert np.all(np.isfinite(s))


def test_k_clamp(ranks):
    world, results = ranks
    s_j, i_j = _jax("clamp", world, extra=0)
    s, i = results[0]["clamp_s"], results[0]["clamp_i"]
    assert s.shape == s_j.shape == (2, min(5, 16 // world))
    case = _inputs()["index"]["clamp"]
    assert_topk_equal(s, i, s_j, i_j, topk_tol(s_j, case["queries"], case["batches"][0], "cos"))


def test_k_zero_gives_no_column_on_every_rank(ranks):
    """k = 0 through ``ShardedKnnIndex(mesh=...).query``: [q, 0] on every rank, as the JAX
    index's ``lax.top_k(..., 0)`` gives."""
    world, results = ranks
    case = _inputs()["index"]["match"]
    mesh = Mesh(np.array(jax.devices()[:world]), ("data",))
    idx = jknn.ShardedKnnIndex(dim=case["dim"], capacity=case["capacity"],
                               metric=case["metric"], mesh=mesh)
    for batch in case["batches"]:
        idx.add(batch)
    s_j, i_j = (np.asarray(x) for x in idx.query(case["queries"], 0))
    for r in results:
        assert r["match_k0_s"].shape == s_j.shape == (len(case["queries"]), 0)
        assert r["match_k0_i"].shape == i_j.shape


def test_what_the_mesh_refuses(ranks):
    _, results = ranks
    for r in results:
        assert r["k_over_shard_raised"]  # k above the rows per shard, as JAX raises
        assert r["uneven_capacity_raised"]
        assert r["axes_not_covering_raised"]
        assert r["loaded_reference_modules"].size == 0, r["loaded_reference_modules"]


def _candidates(seed: int, q: int, shards: int, k: int):
    """Gathered candidates as the sharded search builds them: per shard a best-first list of k
    (score, id), shard-major; scores from a few values (many ties) with -inf tails."""
    rng = np.random.default_rng(seed)
    s = rng.choice(np.array([0.5, 0.25, 0.0, -0.25], np.float32), size=(q, shards, k))
    s[rng.random((q, shards, k)) < 0.2] = -np.inf
    s = -np.sort(-s, axis=2)
    ids = np.stack([rng.permutation(1000)[: shards * k].reshape(shards, k) for _ in range(q)])
    return s.reshape(q, shards * k), ids.reshape(q, shards * k).astype(np.int64)


@pytest.mark.parametrize("q,shards,k", [(6, 2, 5), (4, 4, 16), (3, 8, 1), (2, 3, 7)])
def test_merge_matches_jax_top_k(q, shards, k):
    s, ids = _candidates(q * 31 + shards * 7 + k, q, shards, k)
    js, jpos = jax.lax.top_k(jnp.asarray(s), k)
    ji = np.take_along_axis(ids, np.asarray(jpos), axis=1)
    ts, ti = topk_merge(torch.from_numpy(s), torch.from_numpy(ids), k)
    assert topk_merge.launches == 0  # CPU tensors run the plain version
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(ti.numpy(), ji)
    ps, pi = topk_merge_plain(torch.from_numpy(s), torch.from_numpy(ids), shards * k)
    np.testing.assert_array_equal(ps.numpy(), -np.sort(-s, axis=1))  # k = m: all, sorted
    assert sorted(pi.numpy()[0].tolist()) == sorted(ids[0].tolist())


def test_init_from_env_reads_the_pathway_layout(monkeypatch):
    from pathway_tpu_torch.parallel.distributed import _Layout

    monkeypatch.setenv("PATHWAY_PROCESSES", "4")
    monkeypatch.setenv("PATHWAY_PROCESS_ID", "2")
    monkeypatch.setenv("PATHWAY_FIRST_PORT", "23000")
    assert _Layout() == _Layout(processes=4, process_id=2, first_port=23000)
    monkeypatch.delenv("PATHWAY_PROCESSES")
    monkeypatch.setenv("PATHWAY_PROCESS_ID", "x")
    assert (_Layout().processes, _Layout().process_id) == (1, 0)


@pytest.mark.parametrize("k", [0, 3])
def test_merge_k_zero_and_k_past_the_candidates_as_lax_top_k(k):
    """k = 0 gives [q, 0]; k above the candidates raises ``ValueError``, as ``lax.top_k`` does."""
    s, ids = _candidates(5, 4, 2, 3)
    js, jpos = jax.lax.top_k(jnp.asarray(s), k)
    ts, ti = topk_merge(torch.from_numpy(s), torch.from_numpy(ids), k)
    assert ts.shape == ti.shape == js.shape == (4, k)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(ti.numpy(), np.take_along_axis(ids, np.asarray(jpos), axis=1))
    with pytest.raises(ValueError, match="no larger than"):
        jax.lax.top_k(jnp.asarray(s), 7)
    for merge in (topk_merge, topk_merge_plain):
        with pytest.raises(ValueError, match="no larger than"):
            merge(torch.from_numpy(s), torch.from_numpy(ids), 7)
        with pytest.raises(ValueError, match="nonnegative"):
            merge(torch.from_numpy(s), torch.from_numpy(ids), -1)
    shard_s = torch.from_numpy(s).view(4, 2, 3).transpose(0, 1).contiguous()
    shard_i = torch.from_numpy(ids).view(4, 2, 3).transpose(0, 1).contiguous()
    with pytest.raises(ValueError, match="no larger than"):
        topk_merge_shards(shard_s, shard_i, 7, 100)
    assert topk_merge_shards(shard_s, shard_i, 0, 100)[0].shape == (4, 0)


@functools.cache
def _jax_gather_merge(world: int, k: int, rows_per_shard: int):
    """Lines 121-126 of ``pathway_tpu/ops/knn.py::sharded_knn_search`` inside a ``shard_map``
    over ``world`` CPU devices, from each shard's local (scores, ids) [q, kk]: ids shifted to
    global rows, both all-gathered shard-major, ``lax.top_k`` and ``take_along_axis``."""
    mesh = Mesh(np.array(jax.devices()[:world]), ("data",))

    @functools.partial(shard_map, mesh=mesh, in_specs=(P("data"), P("data")),
                       out_specs=(P(), P()), check_vma=False)
    def merge(s, i):
        s, i = s[0], i[0]
        i = i + jax.lax.axis_index("data") * rows_per_shard
        all_s = jax.lax.all_gather(s, "data", axis=1).reshape(s.shape[0], -1)
        all_i = jax.lax.all_gather(i, "data", axis=1).reshape(s.shape[0], -1)
        gs, gpos = jax.lax.top_k(all_s, k)
        return gs, jnp.take_along_axis(all_i, gpos, axis=1)

    return jax.jit(merge)


@pytest.mark.parametrize("world,q,kk,k", [(1, 5, 10, 10), (2, 6, 5, 5), (4, 4, 16, 9),
                                          (8, 3, 7, 7), (8, 2, 1, 1)])
def test_shard_major_merge_matches_the_jax_gather_and_top_k(world, q, kk, k):
    """``topk_merge_shards`` (its plain version on CPU tensors) on [P, q, kk] buffers as the
    all-gather lands them, against the JAX search's own gather-and-merge on the same numpy
    inputs: equal exactly, ties lower shard first."""
    rows_per_shard = 1000
    flat_s, flat_i = _candidates(world * 13 + q + kk, q, world, kk)
    s = np.ascontiguousarray(flat_s.reshape(q, world, kk).transpose(1, 0, 2))  # [P, q, kk]
    ids = np.ascontiguousarray(flat_i.reshape(q, world, kk).transpose(1, 0, 2) % rows_per_shard)
    js, ji = _jax_gather_merge(world, k, rows_per_shard)(
        jnp.asarray(s), jnp.asarray(ids.astype(np.int32)))
    for merge in (topk_merge_shards, topk_merge_shards_plain):
        ts, ti = merge(torch.from_numpy(s), torch.from_numpy(ids), k, rows_per_shard)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert topk_merge.launches == 0  # CPU tensors run the plain version
