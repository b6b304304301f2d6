"""The port's ring attention and long-context embedding against the JAX package's, on the CPU.

``full_attention`` and the ring's block step (the kernel's plain version on CPU tensors) folded
over the blocks run in this process. ``ring_attention`` and ``embed_tokens_long`` run on 1, 2 and
4 ranks of a gloo group, one process each (``torch_dist_child.py``, without JAX), against the
JAX functions on meshes of as many CPU devices; the ranks' blocks are joined along the sequence.
The JAX functions run under ``jax.jit``: called eagerly, their ``shard_map`` compiles each
primitive on its own, some 5 s a call on the CPU.

Tolerances: attention in f32 within rtol = atol = 2e-5 (the JAX ring test's own); the f32
long-context embedding within 5e-5 (the JAX test's tolerance between meshes); the bf16 one within
3e-2 with a cosine of at least 0.999 (the bf16 tolerance of the port's embedder tests).
"""

from __future__ import annotations

import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from pathway_tpu.models import embedder as jemb
from pathway_tpu.models import ring_attention as jring
from pathway_tpu_torch.models import ring_attention as tring
from pathway_tpu_torch.models.embedder import EmbedderConfig
from pathway_tpu_torch.ops.ring import init_state, ring_block_attention
from torch_dist_child import RankRun

ROOT = Path(__file__).resolve().parents[1]
RING_TOL = 2e-5
EMB_F32_TOL = 5e-5
EMB_ATOL, EMB_MIN_COS = 3e-2, 0.999
WORLDS = (1, 2, 4)


def _attention_inputs(seed: int = 0, b: int = 3, s: int = 64, h: int = 4, d: int = 16) -> dict:
    """Row 0 has every key masked; row 1 its first quarter (rank 0's block on 4 ranks)."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, s, h, d)).astype(np.float32) for _ in range(3))
    mask = rng.random((b, s)) > 0.2
    mask[0] = False
    mask[1, : s // 4] = False
    return {"q": q, "k": k, "v": v, "mask": mask, "scale": float(1.0 / np.sqrt(d))}


def _jax_mesh(n: int) -> Mesh:
    return Mesh(np.array(jax.devices()[:n]), ("data",))


def _embed_cases() -> dict:
    """The JAX ring test's f32 config, and a bf16 one of head width 32; S = 4 x max_len, so the
    positions wrap. Ragged padded tails, one document all padding."""
    cases = {}
    for name, cfg, dtype, seed in (
        ("f32", dict(vocab_size=512, dim=32, n_layers=2, n_heads=4, max_len=64), "float32", 0),
        ("bf16", dict(vocab_size=512, dim=64, n_layers=2, n_heads=2, max_len=64), "bfloat16", 3),
    ):
        jcfg = jemb.EmbedderConfig(**cfg, dtype=getattr(jnp, dtype))
        params = jax.tree_util.tree_map(np.asarray, jemb.init_params(jcfg, seed))
        rng = np.random.default_rng(seed + 1)
        s = 256
        tokens = rng.integers(1, cfg["vocab_size"], (3, s)).astype(np.int32)
        tokens[0, s // 2 :] = 0
        tokens[1, 200:] = 0
        tokens[2] = 0
        cases[name] = {"cfg": cfg, "dtype": dtype, "params": params, "tokens": tokens}
    return cases


@functools.cache
def _inputs() -> dict:
    return {"attn": _attention_inputs(), "embed": _embed_cases()}


_jax_ring = jax.jit(jring.ring_attention, static_argnums=(4, 5, 6))
_jax_embed_long = jax.jit(jring.embed_tokens_long, static_argnums=(2, 3, 4))


def _jax_results(world: int) -> dict:
    inp, mesh = _inputs(), _jax_mesh(world)
    a = inp["attn"]
    out = {"ring": np.asarray(_jax_ring(
        *(jnp.asarray(a[n]) for n in ("q", "k", "v", "mask")), mesh, "data", a["scale"]))}
    for name, case in inp["embed"].items():
        jcfg = jemb.EmbedderConfig(**case["cfg"], dtype=getattr(jnp, case["dtype"]))
        out[f"embed_{name}"] = np.asarray(_jax_embed_long(
            case["params"], jnp.asarray(case["tokens"]), jcfg, mesh, "data"))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """For each world size: the ranks' results and the JAX package's. All the rank processes
    start first and run while the JAX references are computed here."""
    started = {w: RankRun("ring", w, tmp_path_factory.mktemp(f"ring{w}"), _inputs())
               for w in WORLDS}
    want = {w: _jax_results(w) for w in WORLDS}
    return {w: (run.results(), want[w]) for w, run in started.items()}


@pytest.fixture(params=WORLDS, ids=lambda w: f"{w}ranks")
def ranks(request, runs):
    return runs[request.param]


def test_full_attention_matches_jax():
    a = _attention_inputs(seed=1)
    args = [a[n] for n in ("q", "k", "v", "mask")]
    want = np.asarray(jring.full_attention(*map(jnp.asarray, args), a["scale"]))
    got = tring.full_attention(*map(torch.from_numpy, args), a["scale"]).numpy()
    np.testing.assert_allclose(got, want, rtol=RING_TOL, atol=RING_TOL)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("order", [(0,), (0, 1, 2, 3), (0, 3, 2, 1), (1, 0, 3, 2)],
                         ids=["1block", "4blocks", "rank0order", "rank1order"])
def test_block_step_folded_matches_jax_full_attention(order):
    """The block step folded over the key blocks in ``order`` equals JAX's full attention: one
    block, four in sequence, and four as ranks 0 and 1 of a 4-rank ring meet them. Row 0 has no
    real key; where the order starts with block 0, row 1's first block has none either."""
    a = _attention_inputs(seed=2)
    want = np.asarray(jring.full_attention(
        *(jnp.asarray(a[n]) for n in ("q", "k", "v", "mask")), a["scale"]))
    q, k, v, mask = (torch.from_numpy(a[n]) for n in ("q", "k", "v", "mask"))
    qh = q.transpose(1, 2)
    o, m, l = init_state(qh)
    out = torch.empty(q.shape)
    n = len(order)
    blk = q.shape[1] // n
    for step, j in enumerate(order):
        part = slice(j * blk, (j + 1) * blk)
        ring_block_attention(qh, k[:, part].transpose(1, 2), v[:, part].transpose(1, 2),
                             mask[:, part], o, m, l, a["scale"],
                             out=out.transpose(1, 2) if step == n - 1 else None)
    assert ring_block_attention.launches == 0  # CPU tensors run the plain version
    np.testing.assert_allclose(out.numpy(), want, rtol=RING_TOL, atol=RING_TOL)


def test_ring_attention_matches_jax(ranks):
    results, want = ranks
    got = np.concatenate([r["ring"] for r in results], axis=1)
    np.testing.assert_allclose(got, want["ring"], rtol=RING_TOL, atol=RING_TOL)
    assert np.isfinite(got).all()


def test_embed_tokens_long_f32_matches_jax(ranks):
    results, want = ranks
    want = want["embed_f32"]
    for r in results:  # every rank returns the whole pooled embedding
        np.testing.assert_allclose(r["embed_f32"], want, rtol=EMB_F32_TOL, atol=EMB_F32_TOL)
    norms = np.linalg.norm(results[0]["embed_f32"], axis=-1)
    np.testing.assert_allclose(norms[:2], 1.0, rtol=1e-5)
    assert norms[2] == 0.0  # the all-pad document pools to zero, as in JAX


def test_embed_tokens_long_bf16_matches_jax(ranks):
    results, want = ranks
    want = want["embed_bf16"]
    for r in results:
        got = r["embed_bf16"]
        np.testing.assert_allclose(got, want, rtol=0, atol=EMB_ATOL)
        cos = (got[:2] * want[:2]).sum(-1) / (
            np.linalg.norm(got[:2], axis=-1) * np.linalg.norm(want[:2], axis=-1))
        assert cos.min() >= EMB_MIN_COS, cos


def test_ranks_load_neither_jax_nor_pathway_tpu(ranks):
    results, _ = ranks
    for r in results:
        assert r["loaded_reference_modules"].size == 0, r["loaded_reference_modules"]


def test_ring_attention_refuses_what_it_does_not_take():
    cfg = EmbedderConfig(vocab_size=16, dim=8, n_layers=1, n_heads=1, max_len=8, arch="bert")
    with pytest.raises(ValueError, match="preln"):
        tring.embed_tokens_long({}, torch.ones((1, 8), dtype=torch.long), cfg, None)


_IMPORT = re.compile(r"^\s*(?:import|from)\s+(jax|jaxlib|pathway_tpu)(?:[.\s]|$)", re.M)


def test_static_scan_covers_the_parallel_modules():
    """The modules of the sequence- and index-parallel paths, and the rank script that runs them
    in the tests, import neither JAX nor the JAX package (the rank processes also block both at
    run time: ``test_ranks_load_neither_jax_nor_pathway_tpu``)."""
    files = [ROOT / "pathway_tpu_torch" / rel for rel in (
        "parallel/__init__.py", "parallel/mesh.py", "parallel/distributed.py", "ops/ring.py",
        "models/ring_attention.py", "ops/knn.py")] + [ROOT / "tests" / "torch_dist_child.py"]
    for path in files:
        src = path.read_text()
        assert not _IMPORT.findall(src), path
        assert "import_module(" not in src and "__import__(" not in src, path
