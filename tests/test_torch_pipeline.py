"""The port's training step (``pathway_tpu_torch.models.pipeline``) against the JAX package's
(``pathway_tpu.models.pipeline``), on the CPU at a small size.

The same weights (the JAX package's ``init_params``, carried across with ``params_from_jax``) and
the same numpy inputs of ``run_one_step`` (seed 0) go through one ``make_step`` of each: the JAX
one jitted on a one-device (data, model) mesh, the port's with ``device="cpu"``, where each kernel
runs its plain version. Jitted JAX on the CPU keeps f32 where the program types bf16 (ROADMAP.md
Queue 3 item 3) and the port rounds to bf16, so the two agree to bf16 accuracy, not exactly.

Tolerances, each stated once:

- loss: absolute ``LOSS_ATOL``;
- each parameter's update ``p_new - p`` (``-lr`` times its gradient): cosine at least
  ``UPDATE_MIN_COS`` and norm of the difference at most ``UPDATE_MAX_REL`` of JAX's norm;
- index rows (unit vectors) and search scores: absolute ``EMB_ATOL``; scores also one bf16 ulp of
  the score, the port's rounding of the dot; ids equal wherever JAX's scores are clear of their
  neighbours by more than that;
- the attention VJP and the InfoNCE gradient against eager JAX: f32 absolute ``F32_ATOL`` (the
  InfoNCE loss relative ``F32_ATOL``); bf16 one bf16 ulp of the value plus ``BF16_GRAD_ATOL``.
"""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from pathway_tpu.models import embedder as jemb
from pathway_tpu.models import pipeline as jpipe
from pathway_tpu_torch.models import embedder as temb
from pathway_tpu_torch.models import pipeline as tpipe
from pathway_tpu_torch.ops.attention import masked_attention_bwd_plain
from pathway_tpu_torch.ops.infonce import infonce, infonce_plain
from torch_topk_checks import assert_topk_equal, bf16_ulp

ROOT = Path(__file__).resolve().parents[1]
LOSS_ATOL = 1e-2
UPDATE_MIN_COS, UPDATE_MAX_REL = 0.999, 0.05
EMB_ATOL = 1e-2
F32_ATOL = 1e-6
BF16_GRAD_ATOL = 1e-3

BATCH, SEQ, K, LR = 8, 16, 2, 1e-3
# run_one_step's default config (head width 16), and one of head width 32
CONFIGS = {"head16": dict(dim=64, n_heads=4), "head32": dict(dim=128, n_heads=4)}


def _inputs(vocab: int):
    """run_one_step's token ids, made as it makes them from numpy's seed 0."""
    rng = np.random.default_rng(0)
    tokens = rng.integers(1, vocab, (BATCH, SEQ)).astype(np.int32)
    tokens_aug = np.where(tokens % 7 == 0, 1, tokens).astype(np.int32)
    queries = rng.integers(1, vocab, (4, SEQ)).astype(np.int32)
    return tokens, tokens_aug, queries


def _both_steps(shape: dict, insert_at: int):
    """One step of each package from the same weights and inputs. JAX's runs with k + 1, so that
    the gap below its k-th score is known."""
    kw = dict(vocab_size=1024, n_layers=2, max_len=SEQ, **shape)
    jcfg, tcfg = jemb.EmbedderConfig(**kw), temb.EmbedderConfig(**kw)
    capacity = 4 * BATCH
    params = jemb.init_params(jcfg, 0)
    tokens, tokens_aug, queries = _inputs(jcfg.vocab_size)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jstep = jpipe.make_step(mesh, jcfg, k=K + 1, lr=LR)
    theirs = jstep(params, jnp.asarray(tokens), jnp.asarray(tokens_aug),
                   jnp.zeros((capacity, jcfg.dim), jnp.float32), insert_at, jnp.asarray(queries))
    tstep = tpipe.make_step(tcfg, k=K, lr=LR, device="cpu")
    tparams = temb.params_from_jax(params, device="cpu")
    index = torch.zeros((capacity, tcfg.dim))
    ours = tstep(tparams, torch.from_numpy(tokens), torch.from_numpy(tokens_aug), index,
                 insert_at, torch.from_numpy(queries))
    assert ours[1] is index  # updated in place, as the reference donates it
    return params, tparams, theirs, ours


def _pairs(tree_a, tree_b, tree_c, name=""):
    if isinstance(tree_a, dict):
        for key in tree_a:
            yield from _pairs(tree_a[key], tree_b[key], tree_c[key], f"{name}/{key}")
    elif isinstance(tree_a, list):
        for i, (a, b, c) in enumerate(zip(tree_a, tree_b, tree_c)):
            yield from _pairs(a, b, c, f"{name}/{i}")
    else:
        yield name, tree_a, tree_b, tree_c


@pytest.mark.parametrize("shape", list(CONFIGS), ids=list(CONFIGS))
def test_make_step_matches_jax(shape):
    params, tparams, theirs, ours = _both_steps(CONFIGS[shape], insert_at=0)
    jp, jidx, jloss, js, ji = theirs
    tp, tidx, tloss, ts, ti = ours
    assert abs(float(tloss) - float(jloss)) <= LOSS_ATOL

    n_checked = 0
    for name, p0, pj, pt in _pairs(params, jp, tp):
        p0 = np.asarray(p0, np.float32)
        dj, dt = np.asarray(pj, np.float32) - p0, pt.numpy() - p0
        nj = np.linalg.norm(dj)
        assert nj > 0, name  # every parameter learns, the attention's qkv included
        cos = float((dj * dt).sum() / (nj * np.linalg.norm(dt)))
        rel = float(np.linalg.norm(dj - dt) / nj)
        assert cos >= UPDATE_MIN_COS and rel <= UPDATE_MAX_REL, (name, cos, rel)
        n_checked += 1
    assert n_checked == len(list(tpipe._leaves(tparams)))
    # the caller's weights are left as they were
    np.testing.assert_array_equal(tparams["tok_emb"].numpy(), np.asarray(params["tok_emb"]))

    np.testing.assert_allclose(tidx.numpy(), np.asarray(jidx), atol=EMB_ATOL, rtol=0)
    assert (np.abs(tidx.numpy()[:BATCH]).sum(1) > 0).all()
    assert not tidx.numpy()[BATCH:].any()

    js, ji = np.asarray(js), np.asarray(ji)
    assert ts.shape == ti.shape == (4, K)
    assert_topk_equal(ts.numpy(), ti.numpy(), js, ji, bf16_ulp(js) + EMB_ATOL)


def test_make_step_clamps_the_insert_like_dynamic_update_slice():
    capacity = 4 * BATCH
    _, _, theirs, ours = _both_steps(CONFIGS["head16"], insert_at=capacity - 3)
    jidx, tidx = np.asarray(theirs[1]), ours[1].numpy()
    written = np.flatnonzero(np.abs(tidx).sum(1))
    np.testing.assert_array_equal(written, np.arange(capacity - BATCH, capacity))
    np.testing.assert_array_equal(np.flatnonzero(np.abs(jidx).sum(1)), written)
    np.testing.assert_allclose(tidx, jidx, atol=EMB_ATOL, rtol=0)


def test_make_step_refuses_k_above_the_rows():
    cfg = temb.EmbedderConfig(vocab_size=64, dim=32, n_layers=1, n_heads=2, max_len=8)
    step = tpipe.make_step(cfg, k=9, device="cpu")
    params = temb.init_params(cfg, 0, device="cpu")
    toks = torch.ones((2, 8), dtype=torch.int32)
    index = torch.zeros((8, 32))
    with pytest.raises(ValueError, match="exceeds rows"):
        step(params, toks, toks, index, 0, toks)
    assert not index.any()


def test_run_one_step_on_the_host():
    loss, scores, ids = tpipe.run_one_step(device="cpu")
    assert np.isfinite(loss) and loss > 0
    assert scores.shape == ids.shape == (4, 2)
    assert np.isfinite(scores).all() and ((0 <= ids) & (ids < 32)).all()
    # the four queries' best rows are among the 8 just written, above the zero rows
    assert (ids[:, 0] < BATCH).all() and (scores[:, 0] > 0).all()


def _jax_attention(q, k, v, mask):
    """The attention expression of ``pathway_tpu/models/embedder.py:98-101``, before the head
    merge, in q's dtype."""
    scores = (q @ k.transpose(0, 1, 3, 2)).astype(jnp.float32) / np.sqrt(q.shape[-1])
    scores = jnp.where(mask[:, None, None, :], scores, -1e30)
    att = jax.nn.softmax(scores, axis=-1).astype(q.dtype)
    return att @ v


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("D", [16, 32, 64])
def test_attention_vjp_matches_jax(dtype, D):
    rng = np.random.default_rng(D)
    B, H, S = 3, 2, 20
    q, k, v, dout = (rng.standard_normal((B, H, S, D)).astype(np.float32) for _ in range(4))
    mask = np.arange(S)[None, :] < np.array([S, 7, 0])[:, None]  # the last row is all pad
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    _, vjp = jax.vjp(lambda a, b, c: _jax_attention(a, b, c, jnp.asarray(mask)),
                     *(jnp.asarray(t, jdt) for t in (q, k, v)))
    theirs = vjp(jnp.asarray(dout, jdt))
    ours = masked_attention_bwd_plain(*(torch.from_numpy(t).to(tdt) for t in (q, k, v, dout)),
                                      torch.from_numpy(mask))
    for name, t, o in zip("qkv", theirs, ours):
        t, o = np.asarray(t.astype(jnp.float32)), o.float().numpy()
        assert np.abs(t).max() > 0, name
        if dtype == "f32":
            np.testing.assert_allclose(o, t, atol=F32_ATOL, rtol=0, err_msg=name)
        else:
            np.testing.assert_allclose(o, t, atol=BF16_GRAD_ATOL, rtol=2.0 ** -7, err_msg=name)
    # no key of the all-pad row gets a gradient through the scores: dq and dk are zero there
    assert not ours[0][2].any() and not ours[1][2].any()


def _jax_loss(logits):
    """The loss of ``pathway_tpu/models/pipeline.py:61-67``."""
    labels = jnp.arange(logits.shape[0])
    return (-jax.nn.log_softmax(logits, axis=-1)[labels, labels].mean()
            - jax.nn.log_softmax(logits.T, axis=-1)[labels, labels].mean())


@pytest.mark.parametrize("B", [1, 16, 70])
def test_infonce_matches_jax_value_and_grad(B):
    rng = np.random.default_rng(B)
    ea = rng.standard_normal((B, 8)).astype(np.float32)
    eb = ea + 0.3 * rng.standard_normal((B, 8)).astype(np.float32)
    ea /= np.linalg.norm(ea, axis=1, keepdims=True)
    eb /= np.linalg.norm(eb, axis=1, keepdims=True)
    logits = (ea @ eb.T) / tpipe.TAU
    value, grad = jax.value_and_grad(_jax_loss)(jnp.asarray(logits))
    t = torch.from_numpy(logits).requires_grad_()
    loss = infonce(t)  # CPU tensor: the plain version
    (tgrad,) = torch.autograd.grad(loss, t)
    np.testing.assert_allclose(float(loss.detach()), float(value), rtol=F32_ATOL)
    np.testing.assert_allclose(tgrad.numpy(), np.asarray(grad), atol=F32_ATOL, rtol=0)
    assert float(infonce_plain(torch.from_numpy(logits))) == float(loss.detach())


_BLOCKED_STEP = textwrap.dedent("""
    import importlib.abc
    import sys

    sys.modules["jax"] = None

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name == "pathway_tpu" or name.startswith("pathway_tpu."):
                raise ImportError("blocked: " + name)
            return None

    sys.meta_path.insert(0, Block())

    import numpy as np
    import pathway_tpu_torch as pt

    loss, scores, ids = pt.run_one_step(device="cpu")
    assert np.isfinite(loss) and scores.shape == ids.shape == (4, 2)
    loaded = [m for m, mod in sys.modules.items() if mod is not None
              and (m.startswith("jax") or m.split(".")[0] == "pathway_tpu")]
    assert not loaded, loaded
    print("STEP-OK", loss)
""")


def test_step_runs_with_jax_and_pathway_tpu_blocked():
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_STEP], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "STEP-OK" in proc.stdout


def test_step_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpipe.make_step(temb.EmbedderConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpipe.run_one_step()
