"""The port's training step on a (data, model) mesh (``pathway_tpu_torch.models.pipeline``'s
``make_step(..., mesh=data_model_mesh(n))``) and ``graft_entry`` against the JAX package's
``make_step(data_model_mesh(n), ...)`` and ``__graft_entry__.py``, on the CPU at a small size.

The port's ranks are gloo processes (``tests/torch_dist_child.py``'s ``pipeline`` and ``dryrun``
suites, with JAX and the JAX package blocked): worlds of 2 (a 1 x 2 mesh) and 4 (2 x 2). The
JAX side runs in the test process on its fake CPU devices, jitted over the first n of them, from
the same weights (the JAX package's ``init_params``, carried across with ``params_from_jax``) and
the same numpy inputs. Each case runs twice: its insert at row 0, and at a row whose batch spans
the first two shards of ``data`` (at world 4).

Tolerances, those of ``tests/test_torch_pipeline.py`` (jitted JAX keeps f32 where the program
types bf16, and the port's row-split products sum bf16 partials over ``model``):

- loss: absolute ``LOSS_ATOL``;
- each gathered parameter's update ``p_new - p``: cosine at least ``UPDATE_MIN_COS`` and norm of
  the difference at most ``UPDATE_MAX_REL`` of JAX's norm;
- index rows (unit vectors) and search scores: absolute ``EMB_ATOL``; scores also one bf16 ulp;
  ids equal wherever JAX's k + 1 scores leave a gap wider than that.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.models import embedder as jemb
from pathway_tpu.models import pipeline as jpipe
from pathway_tpu.parallel.mesh import data_model_mesh as jax_data_model_mesh
from pathway_tpu_torch.models import embedder as temb
from pathway_tpu_torch.models import pipeline as tpipe
from torch_dist_child import RankRun
from torch_topk_checks import assert_topk_equal, bf16_ulp

ROOT = Path(__file__).resolve().parents[1]
LOSS_ATOL = 1e-2
UPDATE_MIN_COS, UPDATE_MAX_REL = 0.999, 0.05
EMB_ATOL = 1e-2

BATCH, SEQ, K, LR, CAPACITY = 8, 16, 2, 1e-3, 32
CFG = dict(vocab_size=1024, dim=64, n_layers=2, n_heads=4, max_len=SEQ)
WORLDS = (2, 4)
#: insert rows: at 0, and 12 (rows 12-19: the last 4 of shard 0 and the first 4 of shard 1
#: when ``data`` has 2 ranks of 16 rows)
INSERTS = {"at0": 0, "span": 12}
#: a case whose search takes more rows than were written: the zero rows tie at score 0
TIES = {"ties": (12, 12)}  # name: (insert row, k)


def _inputs():
    rng = np.random.default_rng(0)
    tokens = rng.integers(1, CFG["vocab_size"], (BATCH, SEQ)).astype(np.int32)
    tokens_aug = np.where(tokens % 7 == 0, 1, tokens).astype(np.int32)
    queries = rng.integers(1, CFG["vocab_size"], (4, SEQ)).astype(np.int32)
    return tokens, tokens_aug, queries


def _cases() -> dict:
    return {**{name: (at, K) for name, at in INSERTS.items()}, **TIES}


def _numpy_tree(tree):
    """``tree`` with numpy leaves and the same key order."""
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy_tree(v) for v in tree]
    return np.asarray(tree)


def _walk(tree, order):
    """``tree``'s leaves in the order the port walks ``order`` (dicts in their own key order, as
    ``params_from_jax`` keeps it)."""
    if isinstance(order, dict):
        for key in order:
            yield from _walk(tree[key], order[key])
    elif isinstance(order, (list, tuple)):
        for a, b in zip(tree, order):
            yield from _walk(a, b)
    else:
        yield tree


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both worlds' rank processes, started at once; the JAX steps computed meanwhile."""
    params = jemb.init_params(jemb.EmbedderConfig(**CFG), 0)
    tokens, tokens_aug, queries = _inputs()
    np_params = _numpy_tree(params)
    cases = {name: dict(cfg=CFG, params=np_params, tokens=tokens, tokens_aug=tokens_aug,
                        queries=queries, capacity=CAPACITY, insert_at=at, k=k, lr=LR)
             for name, (at, k) in _cases().items()}
    procs = {n: RankRun("pipeline", n, tmp_path_factory.mktemp(f"mesh{n}"), {"cases": cases})
             for n in WORLDS}
    theirs = {}
    for n in WORLDS:
        for name, (at, k) in _cases().items():
            step = jpipe.make_step(jax_data_model_mesh(n), jemb.EmbedderConfig(**CFG), k=k + 1,
                                   lr=LR)
            out = step(params, jnp.asarray(tokens), jnp.asarray(tokens_aug),
                       jnp.zeros((CAPACITY, CFG["dim"]), jnp.float32), at, jnp.asarray(queries))
            theirs[n, name] = (out[0],) + tuple(np.asarray(x) for x in out[1:])
    return params, theirs, {n: p.results() for n, p in procs.items()}


@pytest.mark.parametrize("name", list(INSERTS))
@pytest.mark.parametrize("world", WORLDS)
def test_mesh_step_matches_jax(runs, world, name):
    params, theirs, ours = runs
    jp, jidx, jloss, js, ji = theirs[world, name]
    ranks = ours[world]
    r0 = ranks[0]
    assert list(r0["mesh"][:2]) == [world // 2, 2]
    assert bool(r0[f"{name}_in_place"])
    assert abs(float(r0[f"{name}_loss"]) - float(jloss)) <= LOSS_ATOL

    leaves = list(_walk(params, params))
    assert len(leaves) == len([k for k in r0 if k.startswith(f"{name}_p")])
    for j, (p0, pj) in enumerate(zip(leaves, _walk(jp, params))):
        p0 = np.asarray(p0, np.float32)
        dj, dt = np.asarray(pj, np.float32) - p0, r0[f"{name}_p{j}"] - p0
        nj = np.linalg.norm(dj)
        assert nj > 0, j
        cos = float((dj * dt).sum() / (nj * np.linalg.norm(dt)))
        rel = float(np.linalg.norm(dj - dt) / nj)
        assert cos >= UPDATE_MIN_COS and rel <= UPDATE_MAX_REL, (j, cos, rel)

    np.testing.assert_allclose(r0[f"{name}_index"], jidx, atol=EMB_ATOL, rtol=0)
    written = np.flatnonzero(np.abs(r0[f"{name}_index"]).sum(1))
    np.testing.assert_array_equal(written, np.arange(INSERTS[name], INSERTS[name] + BATCH))
    assert r0[f"{name}_scores"].shape == (4, K)
    assert_topk_equal(r0[f"{name}_scores"], r0[f"{name}_ids"], js, ji, bf16_ulp(js) + EMB_ATOL)
    # every rank returns the same global results
    for r in ranks[1:]:
        for key in ("loss", "scores", "ids", "index"):
            np.testing.assert_array_equal(r[f"{name}_{key}"], r0[f"{name}_{key}"])


def test_mesh_step_insert_spans_two_shards(runs):
    """At world 4 the 8 rows written at 12 fall in both shards of ``data`` (16 rows each), and
    the gathered index equals the JAX package's ``dynamic_update_slice`` of the global batch."""
    _, theirs, ours = runs
    idx = ours[4][0]["span_index"]
    assert np.abs(idx[12:16]).sum(1).all() and np.abs(idx[16:20]).sum(1).all()
    assert not idx[:12].any() and not idx[20:].any()
    np.testing.assert_allclose(idx, theirs[4, "span"][1], atol=EMB_ATOL, rtol=0)


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_step_ties_at_zero_come_in_global_id_order(runs, world):
    """k = 12 over 8 written rows: the zero rows fill the rest of the list at score 0, in the
    reference's order (global ids, shard by shard), and the written rows match JAX's as above."""
    _, theirs, ours = runs
    _, jidx, _, js, ji = theirs[world, "ties"]
    r0 = ours[world][0]
    s, i = r0["ties_scores"], r0["ties_ids"]
    k = TIES["ties"][1]
    assert s.shape == (4, k)
    np.testing.assert_allclose(r0["ties_index"], jidx, atol=EMB_ATOL, rtol=0)
    assert_topk_equal(s, i, js, ji, bf16_ulp(js) + EMB_ATOL)
    zero = (s == 0) & (js[:, :k] == 0)
    assert zero.sum() >= 4 * (k - BATCH)  # every query's list reaches the zero rows
    np.testing.assert_array_equal(i[zero], ji[:, :k][zero])
    written = set(range(12, 12 + BATCH))
    for row_ids, row_s in zip(i, s):
        tied = [int(x) for x, v in zip(row_ids, row_s) if v == 0 and int(x) not in written]
        assert tied == sorted(tied)


def test_param_shardings_give_each_rank_whole_heads(runs):
    """Each rank of ``model`` holds half of ``qkv``'s columns (two of the four heads of each of
    q, k and v), and ``gather_params`` puts the full tree back bit for bit."""
    _, _, ours = runs
    for world in WORLDS:
        for r in ours[world]:
            assert list(r["at0_qkv_shape"]) == [CFG["dim"], 3 * CFG["dim"] // 2]
            assert bool(r["at0_roundtrip"])


def test_param_shardings_cut_heads_of_q_k_and_v():
    """The cut on one rank of a 2-rank ``model`` axis, on a tree whose ``qkv`` columns hold
    their own index: rank r takes columns ``[r dim/2, (r+1) dim/2)`` of each of q, k and v."""
    dim = 8
    qkv = torch.arange(3 * dim, dtype=torch.float32).repeat(dim, 1)
    got = [tpipe._cut("qkv", qkv, 2, r)[0].tolist() for r in (0, 1)]
    assert got == [[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 19],
                   [4, 5, 6, 7, 12, 13, 14, 15, 20, 21, 22, 23]]
    proj = torch.arange(dim, dtype=torch.float32)[:, None].repeat(1, dim)
    assert tpipe._cut("proj", proj, 2, 1)[:, 0].tolist() == [4, 5, 6, 7]
    assert tpipe._cut("ln1_scale", proj, 2, 1) is proj


def test_mesh_step_refuses_heads_the_model_axis_does_not_divide(runs):
    _, _, ours = runs
    for world in WORLDS:
        msg = str(ours[world][0]["odd_heads_refused"])
        assert "n_heads=3" in msg and "model axis" in msg, msg


def test_mesh_ranks_load_neither_jax_nor_the_reference(runs):
    _, _, ours = runs
    for world in WORLDS:
        for r in ours[world]:
            assert not r["loaded_reference_modules"].size


def test_entry_forward_matches_jax():
    """``graft_entry.entry()``'s forward against ``__graft_entry__.entry()``'s, from the same
    weights and tokens: bf16 products, so within ``EMB_ATOL`` (unit vectors)."""
    import importlib.util

    from pathway_tpu_torch import graft_entry

    spec = importlib.util.spec_from_file_location("__graft_entry__", ROOT / "__graft_entry__.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)

    jfn, (jparams, jtokens) = ref.entry()
    want = np.asarray(jax.jit(jfn)(jparams, jtokens))
    fn, (params, tokens) = graft_entry.entry(device="cpu")
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(jtokens))
    got = fn(temb.params_from_jax(jparams, device="cpu"), tokens)
    assert got.shape == want.shape == (8, 128)
    np.testing.assert_allclose(got.numpy(), want, atol=EMB_ATOL, rtol=0)


def test_dryrun_multichip_at_two_ranks(tmp_path):
    ranks = RankRun("dryrun", 2, tmp_path, {}).results()
    r0 = ranks[0]
    assert list(r0["mesh"]) == [1, 2]
    assert np.isfinite(r0["loss"]) and r0["topk_ids"].shape == (2,)
    assert list(r0["dataflow"]) == [2, 7] and list(r0["recovery"]) == [2, 5]
    np.testing.assert_array_equal(ranks[1]["loss"], r0["loss"])
    assert not any(r["loaded_reference_modules"].size for r in ranks)


def test_graft_entry_main_on_the_host():
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    for k in ("PATHWAY_PROCESSES", "PATHWAY_THREADS", "PATHWAY_MESH_EXCHANGE"):
        env.pop(k, None)
    r = subprocess.run([sys.executable, "-m", "pathway_tpu_torch.graft_entry", "--device", "cpu"],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "entry OK: (8, 128) torch.float32" in r.stdout
    assert "dryrun_multichip OK: mesh={'data': 1, 'model': 1}" in r.stdout


def test_mesh_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from pathway_tpu_torch import graft_entry

    with pytest.raises(RuntimeError, match="device='cpu'"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        graft_entry.dryrun_multichip(1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        graft_entry.main([])
