"""The port's hand-written CUDA kernels against their plain PyTorch versions, on the card.

These need a CUDA card and nvcc (the kernels have no CPU mode) and skip elsewhere. On a machine
with a card and without JAX, run them without the repository's conftest, which imports JAX:

    python -m pytest --noconftest tests/test_torch_cuda.py

Tolerances: attention output and its gradients within 1e-2 plus one bf16 ulp of the value (both
routes of the forward: the persistent one for S <= 128, the per-head one above; both routes of the
backward: the fused one for S <= 128, the two kernels above); top-k
scores within one bf16 ulp of the dot product, ids equal wherever a score is clear of its
neighbours by more than that, equal scores lower row first; encoder embeddings within 3e-2 with a
cosine of at least 0.999 against the same weights on the host; the InfoNCE loss and gradient
within 1e-5 of the value (f32, sums in another order); the training step's parameter gradients
against the host's with a cosine of at least 0.999; the ring's block step in f32 within 2e-5 plus
2e-5 of the value on both routes (bf16 inputs on the tensor cores, f32 on the CUDA cores; every
product exact, the sums in another order, no TF32); the top-k merge and the bucketed
exchange exactly, its per-bucket counts included (the exchange moves bits), the runner's readback
of only the arrived rows into pinned buffers equal to the host's, and the engine with its exchange
on the card equals the engine on the host; the expression machine bit for bit against its plain version (float
``**`` within 2 ulp), and the Table API's ``pw.run(device="cuda")`` equal to numpy; a persisted
index restored on the card answers bit for bit as a run that was not stopped; a persisted groupby
rescaled 2 -> 4 workers on the card ends at the host's table; the RAG through the engine at 2
workers under the async loop answers as a direct search of its index; a 2-worker run on the card
with the monitoring server on serves a ``/metrics`` that parses and counts every input row, its
table equal to numpy's.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pathway_tpu_torch.models import pipeline
from pathway_tpu_torch.models.embedder import Embedder, EmbedderConfig, embed_tokens, init_params
from pathway_tpu_torch.ops import attention as attention_ops
from pathway_tpu_torch.ops.attention import (
    FUSED_BWD_MAX_SEQ,
    PERSISTENT_MAX_SEQ,
    backward_blocks_per_sm,
    backward_shared_memory_bytes,
    masked_attention,
    masked_attention_bwd,
    masked_attention_bwd_plain,
    masked_attention_plain,
    persistent_ctas_per_sm,
    shared_memory_bytes,
)
from pathway_tpu_torch.ops import knn as knn_ops
from pathway_tpu_torch.ops.infonce import CLUSTER_MAX_B, infonce, infonce_plain
from pathway_tpu_torch.ops.index_engines import BruteForceKnnEngine
from pathway_tpu_torch.models import ring_attention as ring_model
from pathway_tpu_torch.ops.knn import (
    MAX_CANDIDATES,
    MAX_K,
    STREAM_MAX_DIM,
    STREAM_MAX_K,
    ShardedKnnIndex,
    topk_merge,
    topk_merge_plain,
    topk_merge_shards,
    topk_merge_shards_plain,
    topk_scores,
    topk_scores_plain,
)
from pathway_tpu_torch.ops.ring import init_state, ring_block_attention, ring_block_attention_plain
from pathway_tpu_torch.parallel.exchange import (
    MAX_SHARDS,
    bucket_exchange,
    bucket_exchange_plain,
    bucketed_all_to_all,
)
from torch_topk_checks import assert_topk_equal, topk_tol

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain ring step's f32 products
    return torch.device("cuda")


ATTN_ATOL, ATTN_RTOL = 1e-2, 2.0 ** -7


def _close(got, want):
    got, want = got.float(), want.float()
    return bool(((got - want).abs() <= ATTN_ATOL + ATTN_RTOL * want.abs()).all())


def _attention_inputs(B, H, S, device, seed=0, D=32):
    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn((B, H, S, D), generator=gen, device=device).to(torch.bfloat16)
               for _ in range(3))
    lengths = torch.randint(1, S + 1, (B,), generator=gen, device=device)
    lengths[0] = 0
    return q, k, v, torch.arange(S, device=device)[None, :] < lengths[:, None]


def _kernel_names(fn, part: str, sessions: int = 3):
    """The names of the CUDA kernels whose name holds ``part`` that one call of ``fn`` launches,
    from the profiler; and fn's result. The tracer sometimes records none of a session's kernels,
    so a session that records none is run again, up to ``sessions`` times."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(sessions):
        with torch.profiler.profile(activities=acts) as prof:
            out = fn()
            torch.cuda.synchronize()
        names = sorted(e.key for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA and part in e.key)
        if names:
            break
    return names, out


@pytest.mark.parametrize("S", [1, 16, 33, 128, 512])
def test_masked_attention_kernel_matches_plain(cuda, S):
    q, k, v, mask = _attention_inputs(3, 5, S, cuda)
    before = masked_attention.launches
    got = masked_attention(q, k, v, mask).float()
    assert masked_attention.launches == before + 1
    want = masked_attention_plain(q, k, v, mask).float()
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert ((got - want).abs() <= 1e-2 + 2.0 ** -7 * want.abs()).all()


def _fused_views(B, H, S, D, device, seed):
    """q, k, v as the encoder passes them: views of one [B, S, 3 H D] product."""
    gen = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn((B, S, 3 * H * D), generator=gen, device=device).to(torch.bfloat16)
    return tuple(t.view(B, S, H, D).transpose(1, 2) for t in qkv.split(H * D, dim=-1))


@pytest.mark.parametrize("layout", ["contiguous", "fused"])
@pytest.mark.parametrize("D", [16, 32, 64])
@pytest.mark.parametrize("S", [1, 16, 33, 128])
def test_masked_attention_persistent_route_matches_plain(cuda, S, D, layout):
    """S <= 128 takes the persistent route (TMA-fed stages, scores in registers), on contiguous
    inputs and on views of the fused qkv product; ragged lengths and an all-pad row."""
    q, k, v, mask = _attention_inputs(4, 6, S, cuda, seed=S + D, D=D)
    if layout == "fused":
        q, k, v = _fused_views(4, 6, S, D, cuda, seed=S * D)
    before = masked_attention.launches
    got = masked_attention(q, k, v, mask)
    assert masked_attention.launches == before + 1
    want = masked_attention_plain(q, k, v, mask)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all() and _close(got, want)


@pytest.mark.parametrize("B,H", [(37, 11), (300, 7)])
def test_masked_attention_persistent_grid_walks_any_tile_count(cuda, B, H):
    """B * H not a multiple of the persistent grid (CTAs per SM times the SMs): every (b, h)
    tile is computed once."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert (B * H) % (persistent_ctas_per_sm(32, 128) * sms) != 0
    q, k, v = _fused_views(B, H, 128, 32, cuda, seed=B)
    _, _, _, mask = _attention_inputs(B, 1, 128, cuda, seed=H)
    got = masked_attention(q, k, v, mask)
    want = masked_attention_plain(q, k, v, mask)
    torch.cuda.synchronize()
    assert _close(got, want)


@pytest.mark.parametrize("D", [16, 32, 64])
def test_masked_attention_all_pad_and_scattered_keys(cuda, D):
    """All-pad rows (uniform weights over the masked keys, none over the pad past S), a row with
    one real key, keys masked at random (tiles that mix real and masked keys), and a row whose
    real keys end early (every key tile is still computed, the masked keys at -1e30): all as the
    plain version."""
    B, H, S = 6, 3, 120
    q, k, v = _fused_views(B, H, S, D, cuda, seed=D)
    gen = torch.Generator(device=cuda).manual_seed(D)
    mask = torch.rand((B, S), generator=gen, device=cuda) > 0.5
    mask[0] = False
    mask[1] = False
    mask[1, 77] = True
    mask[2, 20:] = False
    mask[3] = True
    got = masked_attention(q, k, v, mask)
    want = masked_attention_plain(q, k, v, mask)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all() and _close(got, want)
    uniform = v[0].float().mean(dim=1, keepdim=True).expand(H, S, D)
    assert _close(got[0], uniform)


def test_masked_attention_statistic_on_the_persistent_route(cuda):
    """The gradient through autograd at S = 128 on fused-qkv views, with an all-pad row and
    scattered keys: the persistent forward writes the row statistic, and the backward kernel's
    recomputation from it agrees with autograd of the plain version."""
    B, H, S, D = 4, 4, 128, 32
    qkv = torch.randn((B, S, 3 * H * D), device=cuda).to(torch.bfloat16).requires_grad_()
    q, k, v = (t.view(B, S, H, D).transpose(1, 2) for t in qkv.split(H * D, dim=-1))
    gen = torch.Generator(device=cuda).manual_seed(3)
    mask = torch.rand((B, S), generator=gen, device=cuda) > 0.3
    mask[0] = False
    mask[1, 40:] = False
    dout = torch.randn((B, H, S, D), device=cuda).to(torch.bfloat16)
    fwd, bwd = masked_attention.launches, masked_attention_bwd.launches
    (got,) = torch.autograd.grad(masked_attention(q, k, v, mask), qkv, dout)
    assert (masked_attention.launches, masked_attention_bwd.launches) == (fwd + 1, bwd + 1)
    want = torch.cat([g.transpose(1, 2).reshape(B, S, H * D) for g in
                      masked_attention_bwd_plain(q, k, v, dout, mask)], dim=-1)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all() and _close(got, want)


@pytest.mark.parametrize("S,route", [(PERSISTENT_MAX_SEQ, "masked_attention_tma_kernel"),
                                     (PERSISTENT_MAX_SEQ + 1, "masked_attention_kernel"),
                                     (512, "masked_attention_kernel")])
def test_masked_attention_route_by_sequence_length(cuda, S, route):
    """S up to 128 launches the persistent kernel, a longer S (to 512) the per-head one: the
    profiler's kernel names, and the output as the plain version's."""
    q, k, v, mask = _attention_inputs(2, 3, S, cuda, seed=S, D=64)
    names, got = _kernel_names(lambda: masked_attention(q, k, v, mask), "masked_attention")
    assert len(names) == 1 and f"{route}<" in names[0], names
    assert _close(got, masked_attention_plain(q, k, v, mask))
    assert 0 < shared_memory_bytes(64, S) <= 232448  # within a block's limit on sm_90


def test_masked_attention_kernel_takes_strided_heads(cuda):
    B, S, H = 2, 24, 3
    qkv = torch.randn((B, S, 3 * H * 32), device=cuda).to(torch.bfloat16)
    q, k, v = (t.view(B, S, H, 32).transpose(1, 2) for t in qkv.split(H * 32, dim=-1))
    mask = torch.ones((B, S), dtype=torch.bool, device=cuda)
    got = masked_attention(q, k, v, mask)
    assert got.transpose(1, 2).is_contiguous()  # laid out for a free head merge
    want = masked_attention_plain(q, k, v, mask)
    assert ((got.float() - want.float()).abs() <= 1e-2 + 2.0 ** -7 * want.float().abs()).all()


def test_masked_attention_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v, mask = _attention_inputs(1, 1, 16, cuda)
    with pytest.raises(ValueError, match="bf16"):
        masked_attention(q.float(), k, v, mask)
    with pytest.raises(ValueError, match="S <= 512"):
        masked_attention(*(torch.zeros((1, 1, 513, 32), dtype=torch.bfloat16, device=cuda)
                           for _ in range(3)), torch.ones((1, 513), dtype=torch.bool,
                                                          device=cuda))


@pytest.mark.parametrize("metric", ["cos", "ip", "l2"])
@pytest.mark.parametrize("n_queries,k", [(1, 1), (5, 10), (64, 100), (70, 1024)])
def test_knn_topk_kernel_matches_plain(cuda, metric, n_queries, k):
    gen = torch.Generator(device=cuda).manual_seed(k)
    n, d = 20000, 96
    index = torch.randn((n, d), generator=gen, device=cuda)
    index[n // 2 : n // 2 + 500] = index[:500]
    valid = torch.rand((n,), generator=gen, device=cuda) > 0.1
    queries = index[torch.randint(0, 500, (n_queries,), generator=gen, device=cuda)]
    queries = queries + 0.05 * torch.randn(queries.shape, generator=gen, device=cuda)
    before = topk_scores.launches
    s_k, i_k = topk_scores(queries, index, k, metric, valid=valid)
    assert topk_scores.launches == before + 1
    s_p, i_p = topk_scores_plain(queries, index, k + 1, metric, valid=valid)
    s_p = s_p.cpu().numpy()
    assert_topk_equal(s_k.cpu().numpy(), i_k.cpu().numpy(), s_p, i_p.cpu().numpy(),
                      topk_tol(s_p, queries.cpu().numpy(), index.cpu().numpy(), metric))


@pytest.mark.parametrize("n_queries,k", [(64, 128), (20, 1024)])
def test_knn_topk_kernel_at_the_largest_width(cuda, n_queries, k):
    """d = MAX_DIM with the largest k of each query chunk: the most shared memory it asks for."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    index = torch.randn((5000, 1024), generator=gen, device=cuda)
    queries = torch.randn((n_queries, 1024), generator=gen, device=cuda)
    s_k, i_k = topk_scores(queries, index, k, "ip")
    s_p, i_p = topk_scores_plain(queries, index, k + 1, "ip")
    s_p = s_p.cpu().numpy()
    assert_topk_equal(s_k.cpu().numpy(), i_k.cpu().numpy(), s_p, i_p.cpu().numpy(),
                      topk_tol(s_p, queries.cpu().numpy(), index.cpu().numpy(), "ip"))


def test_knn_topk_kernel_fills_minus_inf_past_the_valid_rows(cuda):
    index = torch.randn((300, 64), device=cuda)
    valid = torch.zeros((300,), dtype=torch.bool, device=cuda)
    valid[[3, 250, 17]] = True
    s, i = topk_scores(index[:2].contiguous(), index, 6, "cos", valid=valid)
    s_p, i_p = topk_scores_plain(index[:2], index, 6, "cos", valid=valid)
    assert torch.isneginf(s[:, 3:]).all()
    assert i[:, 3:].tolist() == i_p[:, 3:].tolist() == [[0, 1, 2]] * 2


def test_knn_topk_kernel_refuses_what_it_does_not_take(cuda):
    index = torch.randn((2000, 64), device=cuda)
    with pytest.raises(ValueError, match=str(MAX_K)):
        topk_scores(index[:1], index, MAX_K + 1)
    with pytest.raises(ValueError, match="differ in width"):
        topk_scores(torch.randn((1, 6), device=cuda), torch.randn((10, 7), device=cuda), 1)


def test_embedder_and_engine_on_the_card_match_the_host(cuda):
    cfg = EmbedderConfig(vocab_size=500, dim=64, n_layers=2, n_heads=2, max_len=128)
    card = Embedder(cfg, seed=1, device=cuda)
    host = Embedder(cfg, params=card.params, device="cpu")
    texts = ["a short one", "a longer text " * 20, "", "mid length text " * 6]
    got, want = card.embed_texts(texts), host.embed_texts(texts)
    assert np.abs(got - want).max() <= 3e-2
    live = np.linalg.norm(want, axis=1) > 0
    assert ((got[live] * want[live]).sum(1) >= 0.999).all()
    engine = BruteForceKnnEngine(64, embedder=card, device=cuda)
    engine.add_batch(list(range(4)), texts, [None] * 4)
    rows = engine.search(texts[:2], [2, 2], [None, None])
    assert [row[0][0] for row in rows] == [0, 1]


@pytest.mark.parametrize("D", [16, 64])
@pytest.mark.parametrize("S", [1, 33, 128, 512])
def test_masked_attention_kernel_other_head_widths(cuda, D, S):
    q, k, v, mask = _attention_inputs(3, 5, S, cuda, seed=S, D=D)
    got = masked_attention(q, k, v, mask)
    want = masked_attention_plain(q, k, v, mask)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all() and _close(got, want)


@pytest.mark.parametrize("D", [16, 32, 64])
@pytest.mark.parametrize("S", [1, 16, 33, 128, 512])
def test_masked_attention_backward_kernel_matches_plain(cuda, D, S):
    """Ragged masks with an all-pad row (the first): the gradient through autograd on the card
    launches both kernels, and agrees with autograd of the plain version."""
    q, k, v, mask = _attention_inputs(3, 4, S, cuda, seed=D + S, D=D)
    dout = torch.randn(q.shape, device=cuda).to(torch.bfloat16)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fwd, bwd = masked_attention.launches, masked_attention_bwd.launches
    out = masked_attention(*leaves, mask)
    assert out.grad_fn is not None  # part of the graph
    got = torch.autograd.grad(out, leaves, dout)
    assert (masked_attention.launches, masked_attention_bwd.launches) == (fwd + 1, bwd + 1)
    want = masked_attention_bwd_plain(q, k, v, dout, mask)
    torch.cuda.synchronize()
    for name, g, w in zip("qkv", got, want):
        assert torch.isfinite(g.float()).all(), name
        assert _close(g, w), (name, (g.float() - w.float()).abs().max().item())
    assert not got[0][0].any() and not got[1][0].any()  # all-pad row: no score gradient
    if S > 1:
        assert all(g[1:].float().abs().max() > 0 for g in got)


def test_masked_attention_backward_kernel_takes_strided_heads(cuda):
    B, S, H, D = 2, 40, 3, 64
    qkv = torch.randn((B, S, 3 * H * D), device=cuda).to(torch.bfloat16).requires_grad_()
    q, k, v = (t.view(B, S, H, D).transpose(1, 2) for t in qkv.split(H * D, dim=-1))
    mask = torch.ones((B, S), dtype=torch.bool, device=cuda)
    mask[1, 25:] = False
    dout = torch.randn((B, H, S, D), device=cuda).to(torch.bfloat16)
    (got,) = torch.autograd.grad(masked_attention(q, k, v, mask), qkv, dout)
    want = torch.cat([g.transpose(1, 2).reshape(B, S, H * D) for g in
                      masked_attention_bwd_plain(q, k, v, dout, mask)], dim=-1)
    assert _close(got, want)


def _backward_against_plain(q, k, v, mask, dout):
    """The backward kernel from the forward's statistic against autograd of the plain version;
    one launch of the wrapper; returns the kernel's (dq, dk, dv)."""
    _, stat = attention_ops._forward(q, k, v, mask, with_stat=True)
    before = masked_attention_bwd.launches
    got = masked_attention_bwd(q, k, v, dout, mask, stat)
    assert masked_attention_bwd.launches == before + 1
    want = masked_attention_bwd_plain(q, k, v, dout, mask)
    torch.cuda.synchronize()
    for name, g, w in zip("qkv", got, want):
        assert torch.isfinite(g.float()).all(), name
        assert _close(g, w), (name, (g.float() - w.float()).abs().max().item())
    return got


@pytest.mark.parametrize("layout", ["contiguous", "fused"])
@pytest.mark.parametrize("D", [16, 32, 64])
@pytest.mark.parametrize("S", [1, 16, 33, 128])
def test_masked_attention_backward_fused_route_matches_plain(cuda, S, D, layout):
    """S <= 128 takes the fused backward (each score's s, dp and exponential once), on contiguous
    heads and on views of the fused qkv product; ragged lengths and an all-pad row, whose score
    gradients are zero."""
    q, k, v, mask = _attention_inputs(4, 6, S, cuda, seed=3 * S + D, D=D)
    if layout == "fused":
        q, k, v = _fused_views(4, 6, S, D, cuda, seed=S * D + 1)
    dout = torch.randn(q.shape, device=cuda).to(torch.bfloat16)
    dq, dk, dv = _backward_against_plain(q, k, v, mask, dout)
    assert not dq[0].any() and not dk[0].any()
    if S > 1:
        assert all(g[1:].float().abs().max() > 0 for g in (dq, dk, dv))


@pytest.mark.parametrize("B,H", [(37, 11), (300, 7)])
def test_masked_attention_backward_fused_route_at_any_head_count(cuda, B, H):
    """B * H blocks, more than the card holds at once and not a multiple of its SMs: every
    (b, h) head's gradient is computed once, on fused-qkv views."""
    q, k, v = _fused_views(B, H, 128, 32, cuda, seed=B + H)
    _, _, _, mask = _attention_inputs(B, 1, 128, cuda, seed=H)
    dout = torch.randn(q.shape, device=cuda).to(torch.bfloat16)
    _backward_against_plain(q, k, v, mask, dout)


@pytest.mark.parametrize("D", [16, 32, 64])
def test_masked_attention_backward_all_pad_and_scattered_keys(cuda, D):
    """All-pad rows (uniform weights over the masked keys: dv gets them, dq and dk nothing), a
    row with one real key, keys masked at random, a row whose real keys end early, and a row with
    every key real; S = 120, so the pad from S to 128 is in the last key tile."""
    B, H, S = 6, 3, 120
    q, k, v = _fused_views(B, H, S, D, cuda, seed=D + 5)
    gen = torch.Generator(device=cuda).manual_seed(D + 5)
    mask = torch.rand((B, S), generator=gen, device=cuda) > 0.5
    mask[0] = False
    mask[1] = False
    mask[1, 77] = True
    mask[2, 20:] = False
    mask[3] = True
    dout = torch.randn(q.shape, device=cuda).to(torch.bfloat16)
    dq, dk, dv = _backward_against_plain(q, k, v, mask, dout)
    assert not dq[0].any() and not dk[0].any() and dv[0].float().abs().max() > 0
    assert not dq[1].any() and not dk[1].any()


@pytest.mark.parametrize("S,kernels", [
    (FUSED_BWD_MAX_SEQ, ["attention_bwd_fused_kernel"]),
    (FUSED_BWD_MAX_SEQ + 1, ["attention_bwd_dkv_kernel", "attention_bwd_dq_kernel"]),
])
def test_masked_attention_backward_route_by_sequence_length(cuda, S, kernels):
    """S up to 128 launches the fused backward kernel alone, a longer S the two kernels: the
    profiler's kernel names, and the gradients as the plain version's. The fused route's block
    fits twice on an SM at D = 32."""
    q, k, v, mask = _attention_inputs(2, 3, S, cuda, seed=S + 2, D=32)
    dout = torch.randn(q.shape, device=cuda).to(torch.bfloat16)
    _, stat = attention_ops._forward(q, k, v, mask, with_stat=True)
    torch.cuda.synchronize()
    names, got = _kernel_names(lambda: masked_attention_bwd(q, k, v, dout, mask, stat),
                               "attention_bwd")
    assert len(names) == len(kernels) and all(f"{n}<" in x for n, x in zip(kernels, names)), names
    for g, w in zip(got, masked_attention_bwd_plain(q, k, v, dout, mask)):
        assert _close(g, w)
    assert 0 < backward_shared_memory_bytes(32, S) <= 232448  # within a block's limit on sm_90
    if S <= FUSED_BWD_MAX_SEQ:
        assert backward_blocks_per_sm(32, S) == 2 and backward_blocks_per_sm(64, S) >= 1
    else:
        assert backward_blocks_per_sm(32, S) == 0


def test_masked_attention_without_grad_launches_no_statistic(cuda):
    q, k, v, mask = _attention_inputs(2, 2, 16, cuda)
    out = masked_attention(q.requires_grad_(), k, v, mask)
    assert out.grad_fn is not None
    with torch.no_grad():
        assert masked_attention(q, k, v, mask).grad_fn is None


def test_masked_attention_bwd_refuses_what_it_does_not_take(cuda):
    q, k, v, mask = _attention_inputs(1, 1, 16, cuda)
    stat = torch.zeros((1, 1, 16, 2), device=cuda)
    with pytest.raises(ValueError, match="stat"):
        masked_attention_bwd(q, k, v, q, mask, stat[..., :1])
    with pytest.raises(ValueError, match="head widths"):
        bad = torch.zeros((1, 1, 16, 48), dtype=torch.bfloat16, device=cuda)
        masked_attention_bwd(bad, bad, bad, bad, mask, stat)


@pytest.mark.parametrize("B", [1, 7, 256, 1100, 8, 255, 257, CLUSTER_MAX_B, CLUSTER_MAX_B + 1])
def test_infonce_kernel_matches_plain(cuda, B):
    """Both routes: the cluster route up to ``CLUSTER_MAX_B``, the one-block route past it."""
    gen = torch.Generator(device=cuda).manual_seed(B)
    ea = torch.nn.functional.normalize(torch.randn((B, 64), generator=gen, device=cuda), dim=1)
    eb = torch.nn.functional.normalize(ea + 0.3 * torch.randn((B, 64), generator=gen,
                                                              device=cuda), dim=1)
    logits = ((ea @ eb.T) / pipeline.TAU).requires_grad_()
    before = infonce.launches
    loss = infonce(logits)
    assert infonce.launches == before + 1
    (grad,) = torch.autograd.grad(3.0 * loss, logits)
    want = infonce_plain(logits)
    (want_grad,) = torch.autograd.grad(3.0 * want, logits)
    torch.cuda.synchronize()
    assert abs(loss.item() - want.item()) <= 1e-5 * max(1.0, abs(want.item()))
    assert ((grad - want_grad).abs() <= 1e-5 * (1.0 / B + want_grad.abs())).all()


def test_attention_gradients_reach_the_weights_on_the_card(cuda):
    """The qkv weights get their gradient only through attention: on the card it is non-zero
    and agrees with the host's, from the same weights and tokens."""
    cfg = EmbedderConfig(vocab_size=500, dim=128, n_layers=2, n_heads=4, max_len=64)
    params = init_params(cfg, 3, device=cuda)
    rng = np.random.default_rng(4)
    tokens = rng.integers(1, cfg.vocab_size, (16, 64)).astype(np.int32)
    tokens[rng.random(tokens.shape) < 0.2] = 0
    ids = torch.from_numpy(tokens)
    aug = torch.where(ids % 7 == 0, 1, ids)
    loss_c, _, grads_c = pipeline.value_and_grad(params, ids.to(cuda), aug.to(cuda), cfg)
    host = pipeline._rebuild(params, (t.cpu() for t in pipeline._leaves(params)))
    loss_h, _, grads_h = pipeline.value_and_grad(host, ids, aug, cfg)
    assert abs(loss_c.item() - loss_h.item()) <= 1e-2 * max(1.0, abs(loss_h.item()))
    for i, (layer_c, layer_h) in enumerate(zip(grads_c["layers"], grads_h["layers"])):
        g_c, g_h = layer_c["qkv"].cpu(), layer_h["qkv"]
        assert g_c.abs().max() > 0, i
        cos = (g_c * g_h).sum() / (g_c.norm() * g_h.norm())
        assert cos >= 0.999, (i, cos.item())


@pytest.mark.parametrize("d", [3, 385, 1030])
def test_knn_topk_kernel_at_any_width(cuda, d):
    gen = torch.Generator(device=cuda).manual_seed(d)
    index = torch.randn((3000, d), generator=gen, device=cuda)
    index[1500:1600] = index[:100]
    queries = index[:20] + 0.05 * torch.randn((20, d), generator=gen, device=cuda)
    for metric in ("ip", "l2"):
        s_k, i_k = topk_scores(queries, index, 10, metric)
        s_p, i_p = topk_scores_plain(queries, index, 11, metric)
        s_p = s_p.cpu().numpy()
        assert_topk_equal(s_k.cpu().numpy(), i_k.cpu().numpy(), s_p, i_p.cpu().numpy(),
                          topk_tol(s_p, queries.cpu().numpy(), index.cpu().numpy(), metric))


def _knn_held(cuda, queries, index, k, metric, valid=None):
    """One call of the scorer against its plain version on the same inputs, one launch counted;
    returns the pairs of tied duplicates it saw in order."""
    before = topk_scores.launches
    s_k, i_k = topk_scores(queries, index, k, metric, valid=valid)
    assert topk_scores.launches == before + 1
    s_p, i_p = topk_scores_plain(queries, index, min(k + 1, index.shape[0]), metric, valid=valid)
    s_p = s_p.cpu().numpy()
    return assert_topk_equal(s_k.cpu().numpy(), i_k.cpu().numpy(), s_p, i_p.cpu().numpy(),
                             topk_tol(s_p, queries.cpu().numpy(), index.cpu().numpy(), metric))


def _knn_data(cuda, Q, N, d, seed):
    """Index rows of width d, the first half of them copied to rows N // 2 on (exact ties), and
    queries near copied rows."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    index = torch.randn((N, d), generator=gen, device=cuda)
    dup = min(N // 2, 500)
    index[N // 2 : N // 2 + dup] = index[:dup]
    pick = torch.randint(0, max(dup, 1), (Q,), generator=gen, device=cuda)
    queries = index[pick] + 0.05 * torch.randn((Q, d), generator=gen, device=cuda)
    return queries.contiguous(), index


@pytest.mark.parametrize("metric", ["cos", "ip", "l2"])
@pytest.mark.parametrize("Q,N,d,k", [
    (64, 50, 384, 10),  # fewer rows than one tile of either route
    (65, 16973, 96, STREAM_MAX_K),  # rows not a multiple of a tile or of the grid's stride
    (1, 20000, 4, 1),
    (63, 3000, STREAM_MAX_DIM, STREAM_MAX_K + 1),  # the first k of the tile route
    (130, 5000, 384, 10),
    (64, 20000, 1, 10),
    (64, 20000, 3, 10),
    (64, 4000, 1030, 10),
    (20, 3000, STREAM_MAX_DIM + 4, 10),  # the first width past the stream route
    (64, 3000, 384, MAX_K),
])
def test_knn_topk_routes_match_plain(cuda, metric, Q, N, d, k):
    queries, index = _knn_data(cuda, Q, N, d, seed=Q + N + d + k)
    valid = torch.rand((N,), generator=torch.Generator(device=cuda).manual_seed(d),
                       device=cuda) > 0.1
    _knn_held(cuda, queries, index, k, metric, valid)
    _knn_held(cuda, queries, index, k, metric)


@pytest.mark.parametrize("k", [1, 10, STREAM_MAX_K, STREAM_MAX_K + 1])
def test_knn_topk_mask_that_empties_whole_tiles(cuda, k):
    """The valid mask drops whole 128-row tiles of the stream route (and whole 64-row tiles of
    the tile route), all of one block's first tile, and all but a few rows of the rest."""
    queries, index = _knn_data(cuda, 64, 40000, 384, seed=k)
    valid = torch.ones((40000,), dtype=torch.bool, device=cuda)
    valid[: 128 * 3] = False
    valid[128 * 132 : 128 * 140] = False
    valid[30000:] = False
    valid[30000::997] = True
    _knn_held(cuda, queries, index, k, "cos", valid)
    _knn_held(cuda, queries, index, k, "l2", valid)


@pytest.mark.parametrize("metric", ["cos", "ip", "l2"])
@pytest.mark.parametrize("k", [10, STREAM_MAX_K, STREAM_MAX_K + 1])
def test_knn_topk_ties_across_blocks_come_lower_row_first(cuda, metric, k):
    """Rows copied 128 rows and one grid's stride of tiles apart, so that a row and its copies
    lie in other blocks' tiles (and in other tile-route ranges): each query is one of them, and
    every copy ties in the kernel's order, the lower row first."""
    gen = torch.Generator(device=cuda).manual_seed(k)
    N, d = 128 * 132 * 3, 384
    index = torch.randn((N, d), generator=gen, device=cuda)
    src = torch.arange(0, 64, device=cuda) * 97
    for shift in (128, 128 * 132, 128 * 133 + 5):
        index[src + shift] = index[src]
    queries = index[src].clone()
    _knn_held(cuda, queries, index, k, metric)
    s, i = topk_scores(queries, index, 4, metric)
    want = torch.stack([src, src + 128, src + 128 * 132, src + 128 * 133 + 5], dim=1)
    assert torch.equal(i, want)
    assert (s[:, 1:] == s[:, :1]).all()


@pytest.mark.parametrize("d,k,route,kernels", [
    (384, 10, "stream", ("knn_stream_kernel", "knn_stream_merge_kernel")),
    (384, STREAM_MAX_K, "stream", ("knn_stream_kernel", "knn_stream_merge_kernel")),
    (384, STREAM_MAX_K + 1, "tile", ("knn_score_topk_kernel", "knn_merge_kernel")),
    (STREAM_MAX_DIM + 4, 10, "tile", ("knn_score_topk_kernel", "knn_merge_kernel")),
    (98, 10, "tile", ("knn_score_topk_kernel", "knn_merge_kernel")),
])
def test_knn_topk_route_by_shape(cuda, d, k, route, kernels):
    """The plan's route is the pair of kernels that runs (the profiler's names)."""
    queries, index = _knn_data(cuda, 64, 5000, d, seed=d + k)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert knn_ops.plan(64, 5000, d, k, sms).route == route
    names, _ = _kernel_names(lambda: topk_scores(queries, index, k), "knn_")
    assert len(names) == 2 and all(any(f"::{kn}" in n for n in names) for kn in kernels), names


@pytest.mark.parametrize("Q,d,k", [(64, 384, 10), (130, 384, 10), (64, 384, STREAM_MAX_K),
                                   (64, 384, 100), (64, 384, MAX_K), (1, 3, 10),
                                   (64, 1030, 10)])
def test_knn_topk_plan_fits_one_wave_on_the_card(cuda, Q, d, k):
    """The plan's blocks per SM, from the layout, are no more than the occupancy API gives with
    registers counted, and its layout is the source's: every block of a launch is resident at
    once."""
    import ctypes

    from pathway_tpu_torch import _kernels

    lib = _kernels.load("knn_topk")
    for name in ("knn_topk_smem_bytes", "knn_topk_blocks_per_sm"):
        getattr(lib, name).argtypes = [ctypes.c_int] * 4
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    p = knn_ops.plan(Q, 1 << 20, d, k, sms)
    route = 1 if p.route == "stream" else 0
    assert lib.knn_topk_smem_bytes(route, p.qc, d, k) == knn_ops.shared_memory_bytes(
        p.route, p.qc, d, k)
    resident = lib.knn_topk_blocks_per_sm(route, p.qc, d, k)
    assert 1 <= p.blocks_per_sm <= resident
    assert p.grid * -(-Q // p.qc) <= resident * sms


@pytest.mark.parametrize("B,kernel", [(256, "infonce_cluster_kernel"),
                                      (CLUSTER_MAX_B, "infonce_cluster_kernel"),
                                      (CLUSTER_MAX_B + 1, "infonce_kernel")])
def test_infonce_route_by_batch(cuda, B, kernel):
    logits = torch.randn((B, B), generator=torch.Generator(device=cuda).manual_seed(1),
                         device=cuda)
    names, loss = _kernel_names(lambda: infonce(logits), "infonce")
    assert len(names) == 1 and f"{kernel}(" in names[0], names
    assert torch.isfinite(loss)


def test_infonce_takes_an_unaligned_view(cuda):
    """A [B, B] view 4 bytes past a 16-byte boundary: the wrapper copies it, the loss agrees."""
    flat = torch.randn((256 * 256 + 1,), generator=torch.Generator(device=cuda).manual_seed(2),
                       device=cuda)
    logits = flat[1:].view(256, 256)
    assert logits.data_ptr() % 16
    assert abs(infonce(logits).item() - infonce_plain(logits).item()) <= 1e-5 * max(
        1.0, abs(infonce_plain(logits).item()))


RING_TOL = 2e-5


def _ring_inputs(B, H, S, D, dtype, device, seed):
    """Row 0 has no real key; row 1 none in its first quarter (the first block of four)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn((B, H, S, D), generator=gen, device=device).to(dtype)
               for _ in range(3))
    mask = torch.rand((B, S), generator=gen, device=device) > 0.2
    mask[0] = False
    mask[1, : S // 4] = False
    return q, k, v, mask


def _fold(step_fn, q, k, v, mask, order):
    """The ring's block step folded over the key blocks in ``order``: the normalised output and
    the state."""
    o, m, l = init_state(q)
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    blk = q.shape[2] // len(order)
    scale = 1.0 / q.shape[-1] ** 0.5
    for step, j in enumerate(order):
        part = slice(j * blk, (j + 1) * blk)
        step_fn(q, k[:, :, part], v[:, :, part], mask[:, part], o, m, l, scale,
                out=out if step == len(order) - 1 else None)
    return out, (o, m, l)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("D", [8, 16, 32, 64])
@pytest.mark.parametrize("order", [(0,), (0, 3, 2, 1)], ids=["1block", "4blocks"])
def test_ring_block_kernel_matches_plain(cuda, dtype, D, order):
    """S = 260: blocks of 65 keys end in a partial tile, 260 query rows in a partial block of
    rows; the fold of four blocks starts with row 1's fully masked one."""
    q, k, v, mask = _ring_inputs(3, 4, 260, D, dtype, cuda, seed=D)
    before = ring_block_attention.launches
    got, (o, m, l) = _fold(ring_block_attention, q, k, v, mask, order)
    assert ring_block_attention.launches == before + len(order)
    want, (o_p, m_p, l_p) = _fold(ring_block_attention_plain, q, k, v, mask, order)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert ((got - want).abs() <= RING_TOL + RING_TOL * want.abs()).all(), (
        (got - want).abs().max().item())
    assert ((l - l_p).abs() <= RING_TOL * l_p.abs()).all()
    assert ((m - m_p).abs() <= RING_TOL * (1 + m_p.abs())).all()


@pytest.mark.parametrize("D", [8, 16, 32, 64])
@pytest.mark.parametrize("order", [(0,), (0, 3, 2, 1)], ids=["1block", "4blocks"])
def test_ring_block_tensor_core_route_matches_plain(cuda, D, order):
    """bf16 takes the tensor-core route: S = 4000, so blocks of 1000 keys end in a partial tile
    of 64 and the 4000 query rows in a partial block of 128; row 0 has no real key and row 1's
    first block of four is fully masked."""
    q, k, v, mask = _ring_inputs(2, 3, 4000, D, torch.bfloat16, cuda, seed=D + 40)
    before = ring_block_attention.launches
    got, (o, m, l) = _fold(ring_block_attention, q, k, v, mask, order)
    assert ring_block_attention.launches == before + len(order)
    want, (o_p, m_p, l_p) = _fold(ring_block_attention_plain, q, k, v, mask, order)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert ((got - want).abs() <= RING_TOL + RING_TOL * want.abs()).all(), (
        (got - want).abs().max().item())
    assert ((l - l_p).abs() <= RING_TOL * l_p.abs()).all()
    assert ((m - m_p).abs() <= RING_TOL * (1 + m_p.abs())).all()


@pytest.mark.parametrize("dtype,kernel", [(torch.bfloat16, "ring_block_tc_kernel"),
                                          (torch.float32, "ring_block_kernel")],
                         ids=["bf16", "f32"])
def test_ring_block_route_by_dtype(cuda, dtype, kernel):
    """bf16 inputs launch the tensor-core kernel, f32 inputs the CUDA-core one: the profiler's
    kernel names, and the output as the plain version's."""
    q, k, v, mask = _ring_inputs(2, 2, 300, 32, dtype, cuda, seed=7)
    names, (got, _) = _kernel_names(lambda: _fold(ring_block_attention, q, k, v, mask, (0,)),
                                    "ring_block")
    assert len(names) == 1 and f"{kernel}<" in names[0], names
    want, _ = _fold(ring_block_attention_plain, q, k, v, mask, (0,))
    assert ((got - want).abs() <= RING_TOL + RING_TOL * want.abs()).all()


def test_ring_block_tensor_core_route_copies_unaligned_rows(cuda):
    """bf16 rows that do not start 16 bytes apart (a row stride of 33 values) are copied before
    the launch: the output as the plain version's."""
    B, H, S, D = 2, 3, 200, 32
    wide = [torch.randn((B, H, S, D + 1), device=cuda).to(torch.bfloat16) for _ in range(3)]
    q, k, v = (t[..., :D] for t in wide)
    mask = torch.ones((B, S), dtype=torch.bool, device=cuda)
    mask[1, 150:] = False
    got, _ = _fold(ring_block_attention, q, k, v, mask, (0, 1))
    want, _ = _fold(ring_block_attention_plain, q, k, v, mask, (0, 1))
    assert ((got - want).abs() <= RING_TOL + RING_TOL * want.abs()).all()


def test_ring_block_kernel_takes_strided_heads(cuda):
    """q, k and v as views of [B, S, H, D] tensors, the output written into one such view."""
    B, S, H, D = 2, 100, 3, 32
    q, k, v = (torch.randn((B, S, H, D), device=cuda) for _ in range(3))
    mask = torch.ones((B, S), dtype=torch.bool, device=cuda)
    mask[1, 60:] = False
    o, m, l = init_state(q.transpose(1, 2))
    out = torch.empty((B, S, H, D), device=cuda)
    ring_block_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                         mask.to(torch.uint8), o, m, l, D ** -0.5, out=out.transpose(1, 2))
    want = ring_model.full_attention(q, k, v, mask, D ** -0.5)
    assert ((out - want).abs() <= RING_TOL + RING_TOL * want.abs()).all()


def test_ring_block_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.zeros((1, 1, 8, 48), device=cuda)
    o, m, l = init_state(q)
    mask = torch.ones((1, 8), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="head width"):
        ring_block_attention(q, q, q, mask, o, m, l, 1.0)
    q = torch.zeros((1, 1, 8, 32), device=cuda)
    o, m, l = init_state(q)
    with pytest.raises(ValueError, match="k_blk"):
        ring_block_attention(q, q.to(torch.bfloat16), q, mask, o, m, l, 1.0)


def _merge_inputs(q, m, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    values = torch.tensor([0.5, 0.25, 0.0, -0.0, -0.25, 1e-3], device=device)
    scores = values[torch.randint(0, len(values), (q, m), generator=gen, device=device)]
    scores[torch.rand((q, m), generator=gen, device=device) < 0.2] = -torch.inf
    ids = torch.stack([torch.randperm(10 * m, generator=gen, device=device)[:m]
                       for _ in range(q)])
    return scores, ids


@pytest.mark.parametrize("q,m,k", [(1, 1, 1), (5, 20, 10), (64, 400, 100), (7, 3000, 3000),
                                   (3, MAX_CANDIDATES, 1024)])
def test_topk_merge_kernel_matches_plain(cuda, q, m, k):
    """Ties (also between -0 and +0) keep the lower position first; -inf never passes a real
    score; 8192 candidates take 64 KB of shared memory."""
    scores, ids = _merge_inputs(q, m, cuda, seed=m)
    before = topk_merge.launches
    s_k, i_k = topk_merge(scores, ids, k)
    assert topk_merge.launches == before + 1
    s_p, i_p = topk_merge_plain(scores, ids, k)
    torch.cuda.synchronize()
    assert torch.equal(s_k, s_p) and torch.equal(i_k, i_p)


@pytest.mark.parametrize("m", [2, 32, 33, 64, 65, 128, 129, 256, 257])
def test_topk_merge_warp_route_matches_plain(cuda, m):
    """Up to 256 candidates a warp sorts a query's keys in registers (8 a lane at most), above
    it a block in shared memory: both sides of each register count, and k of 1, m / 2 and m."""
    scores, ids = _merge_inputs(9, m, cuda, seed=m + 1)
    for k in sorted({1, max(1, m // 2), m}):
        got = topk_merge(scores, ids, k)
        want = topk_merge_plain(scores, ids, k)
        torch.cuda.synchronize()
        assert all(torch.equal(g, w) for g, w in zip(got, want)), k


@pytest.mark.parametrize("P,q,kk,k", [(1, 64, 10, 10), (1, 3, 1024, 1024), (2, 5, 16, 7),
                                      (2, 4, 128, 200), (8, 64, 10, 10), (8, 7, 32, 32),
                                      (8, 3, 1024, 1024)])
def test_topk_merge_shards_matches_plain(cuda, P, q, kk, k):
    """The shard-major entry on [P, q, kk] buffers as the all-gather lands them (each shard's
    list best-first, ties, -0 and -inf), against ``topk_merge_plain`` on the reshaped buffers
    with the ids shifted by shard: equal exactly, one launch."""
    scores, ids = _merge_inputs(P * q, kk, cuda, seed=P * kk + k)
    scores = scores.sort(dim=1, descending=True).values.view(P, q, kk)
    ids = ids.view(P, q, kk)
    before = topk_merge.launches
    got = topk_merge_shards(scores, ids, k, 4096)
    assert topk_merge.launches == before + 1
    shift = torch.arange(P, device=cuda).view(P, 1, 1) * 4096
    want = topk_merge_plain(scores.transpose(0, 1).reshape(q, P * kk),
                            (ids + shift).transpose(0, 1).reshape(q, P * kk), k)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert all(torch.equal(g, w) for g, w in zip(got, topk_merge_shards_plain(scores, ids, k,
                                                                             4096)))


def test_k_zero_launches_nothing_and_k_past_the_candidates_raises(cuda, world_one):
    """k = 0 gives [q, 0] from the scorer, both merge entries and the sharded index, and no
    kernel runs; k above the rows or the candidates raises, as ``lax.top_k`` does."""
    index = torch.randn((50, 16), device=cuda)
    queries = index[:3]
    scores, ids = _merge_inputs(3, 20, cuda, seed=4)
    sharded = ShardedKnnIndex(16, capacity=64, mesh=world_one, device=cuda)
    sharded.add(index.cpu().numpy())
    counts = (topk_scores.launches, topk_merge.launches)
    outs = [topk_scores(queries, index, 0), topk_merge(scores, ids, 0),
            topk_merge_shards(scores.view(1, 3, 20), ids.view(1, 3, 20), 0, 64),
            sharded.query(queries.cpu().numpy(), 0)]
    torch.cuda.synchronize()
    assert (topk_scores.launches, topk_merge.launches) == counts
    assert all(tuple(x.shape) == (3, 0) for out in outs for x in out)
    with pytest.raises(ValueError, match="no larger than"):
        topk_scores(queries, index, 51)
    with pytest.raises(ValueError, match="no larger than"):
        topk_merge(scores, ids, 21)
    with pytest.raises(ValueError, match="no larger than"):
        topk_merge_shards(scores.view(1, 3, 20), ids.view(1, 3, 20), 21, 64)


def test_topk_merge_kernel_refuses_what_it_does_not_take(cuda):
    scores, ids = _merge_inputs(1, MAX_CANDIDATES + 1, cuda, seed=0)
    with pytest.raises(ValueError, match=str(MAX_CANDIDATES)):
        topk_merge(scores, ids, 1)
    with pytest.raises(ValueError, match="int64"):
        topk_merge(scores[:, :10], ids[:, :10].int(), 1)


@pytest.fixture
def world_one(cuda):
    """A mesh of one rank on the card (NCCL, a group of world size 1)."""
    from pathway_tpu_torch.parallel.distributed import global_mesh

    return global_mesh({"data": 1}, device="cuda")


def test_long_context_embedding_on_the_card(cuda, world_one, monkeypatch):
    """S = 6 x max_len at world size 1: the kernel route against the plain route on the card,
    one launch per layer; the all-pad document pools to zero."""
    cfg = EmbedderConfig(vocab_size=500, dim=64, n_layers=2, n_heads=2, max_len=32)
    params = init_params(cfg, 5, device=cuda)
    rng = np.random.default_rng(6)
    tokens = torch.from_numpy(rng.integers(1, 500, (3, 192))).to(cuda)
    tokens[0, 100:] = 0
    tokens[2] = 0
    before = ring_block_attention.launches
    got = ring_model.embed_tokens_long(params, tokens, cfg, world_one)
    assert ring_block_attention.launches == before + cfg.n_layers
    monkeypatch.setattr(ring_model, "ring_block_attention", ring_block_attention_plain)
    want = ring_model.embed_tokens_long(params, tokens, cfg, world_one)
    assert (got - want).abs().max() <= 3e-2
    assert ((got[:2] * want[:2]).sum(1) >= 0.999).all()
    assert not got[2].any()


def test_sharded_index_at_world_size_one_on_the_card(cuda, world_one):
    rng = np.random.default_rng(7)
    rows = rng.standard_normal((3000, 48)).astype(np.float32)
    queries = rows[:5] + 0.05 * rng.standard_normal((5, 48)).astype(np.float32)
    sharded = ShardedKnnIndex(48, capacity=4096, mesh=world_one, device=cuda)
    single = ShardedKnnIndex(48, capacity=4096, device=cuda)
    for idx in (sharded, single):
        idx.add(rows[:1000])
        idx.add(rows[1000:])
    before = topk_merge.launches
    s, i = sharded.query(queries, 10)
    assert topk_merge.launches == before + 1
    s1, i1 = single.query(queries, 10)
    np.testing.assert_array_equal(s, s1)
    np.testing.assert_array_equal(i, i1)


def _exchange_case(n_src: int, cap_in: int, w: int, n_dst: int, seed: int):
    """Words with the high bit set, a fifth of the rows without a destination, the rest skewed to
    destination 0 so that small buckets overflow."""
    gen = torch.Generator().manual_seed(seed)
    words = torch.randint(-2**31, 2**31 - 1, (n_src, cap_in, w), generator=gen,
                          dtype=torch.int64).to(torch.int32)
    words[..., 1::2] |= torch.tensor(-2**31, dtype=torch.int32)  # high word of each pair
    dest = torch.randint(0, n_dst, (n_src, cap_in), generator=gen, dtype=torch.int32)
    dest[torch.rand((n_src, cap_in), generator=gen) < 0.3] = 0
    dest[torch.rand((n_src, cap_in), generator=gen) < 0.2] = -1
    return words, dest


@pytest.mark.parametrize("n,cap_in,w,cap_bucket", [
    (2, 8, 4, 8), (2, 1000, 4, 2), (4, 4096, 6, 4096), (4, 3000, 16, 512),
    (8, 65536, 10, 65536), (8, 65536, 16, 1024), (8, 1, 4, 1),
])
def test_bucket_exchange_kernel_equals_plain_bitwise(cuda, n, cap_in, w, cap_bucket):
    words, dest = _exchange_case(n, cap_in, w, n, seed=n * cap_in + w)
    before = bucket_exchange.launches
    out, valid = bucket_exchange(words.to(cuda), dest.to(cuda), n, cap_bucket)
    torch.cuda.synchronize()
    assert bucket_exchange.launches == before + 1
    want, want_valid = bucket_exchange_plain(words, dest, n, cap_bucket)
    assert torch.equal(out.cpu(), want) and torch.equal(valid.cpu(), want_valid)


def _exchange_held(cuda, words, dest, n_dst, cap_bucket):
    """The kernel (buckets, validity and counts) against its plain version, bitwise, with the
    launch count moved by one; returns the plain counts."""
    before = bucket_exchange.launches
    got = bucket_exchange(words.to(cuda), dest.to(cuda), n_dst, cap_bucket, return_counts=True)
    torch.cuda.synchronize()
    assert bucket_exchange.launches == before + 1
    want = bucket_exchange_plain(words, dest, n_dst, cap_bucket, return_counts=True)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w)
    return want[2]


@pytest.mark.parametrize("n_src,cap_in,w,n_dst,cap_bucket", [
    (3, 1000, 4, 3, 1000),      # under one tile of 1024 rows
    (2, 3000, 6, 2, 4096),      # three tiles, the last one partial
    (5, 2500, 2, 1, 1024),      # one destination, overflowing
    (4, 5000, 8, 32, 512),      # 32 destinations
    (8, 4096, 7, 8, 4096),      # odd width: single words
    (2, 2049, 5, 4, 16),        # odd width, tiny buckets
    (1, 65536, 16, 8, 65536),   # the rank form's one source
])
def test_bucket_exchange_kernel_at_edge_shapes(cuda, n_src, cap_in, w, n_dst, cap_bucket):
    words, dest = _exchange_case(n_src, cap_in, w, n_dst, seed=n_src * cap_in + w + n_dst)
    _exchange_held(cuda, words, dest, n_dst, cap_bucket)


def test_bucket_exchange_kernel_every_row_to_one_destination_overflows(cuda):
    words, _ = _exchange_case(4, 3000, 4, 4, seed=3)
    dest = torch.full((4, 3000), 2, dtype=torch.int32)
    counts = _exchange_held(cuda, words, dest, 4, 1024)
    assert counts[2].tolist() == [1024] * 4 and not counts[[0, 1, 3]].any()


def test_bucket_exchange_kernel_with_no_destination_writes_zeros(cuda):
    words, _ = _exchange_case(3, 2000, 6, 3, seed=4)
    dest = torch.full((3, 2000), -1, dtype=torch.int32)
    dest[0, ::7] = 3  # past n_dst: dropped too
    counts = _exchange_held(cuda, words, dest, 3, 512)
    assert not counts.any()


def test_bucket_exchange_kernel_on_the_capture_gather_shape(cuda):
    """The dense path's largest launch: 8 sources of up to 16,384 rows of 14 words, nearly every
    row to destination 0 (a Capture's gather), buckets of 16,384 slots."""
    gen = torch.Generator().manual_seed(14)
    words = torch.randint(-2**31, 2**31 - 1, (8, 16384, 14), generator=gen,
                          dtype=torch.int64).to(torch.int32)
    dest = torch.zeros((8, 16384), dtype=torch.int32)
    dest[torch.rand((8, 16384), generator=gen) < 0.01] = 5
    for s, rows in enumerate((16384, 9000, 8191, 8192, 1, 0, 12000, 16383)):
        dest[s, rows:] = -1
    counts = _exchange_held(cuda, words, dest, 8, 16384)
    assert int(counts.sum()) == int((dest >= 0).sum())


def test_bucket_exchange_kernel_reads_unaligned_words(cuda):
    """Words whose base is 4 bytes past a 16-byte boundary: the copy takes single words."""
    words, dest = _exchange_case(4, 1500, 8, 4, seed=6)
    flat = torch.empty(words.numel() + 1, dtype=torch.int32, device=cuda)
    shifted = flat[1:].view(words.shape)
    shifted.copy_(words.to(cuda))
    assert shifted.data_ptr() % 16 == 4
    before = bucket_exchange.launches
    got = bucket_exchange(shifted, dest.to(cuda), 4, 2048, return_counts=True)
    torch.cuda.synchronize()
    assert bucket_exchange.launches == before + 1
    for g, w in zip(got, bucket_exchange_plain(words, dest, 4, 2048, return_counts=True)):
        assert torch.equal(g.cpu(), w)


def test_runner_readback_on_the_card_equals_the_host(cuda):
    """The mesh exchange's driver tick with its readback of the arrived rows (pinned buffers) on
    the card against the same on the host: the same counts and the same rows; nothing is read
    back for a worker with no arrivals."""
    from pathway_tpu_torch.engine import mesh_exchange as tmx
    from pathway_tpu_torch.engine.delta import Delta

    rng = np.random.default_rng(15)
    n, cols = 4, ["i", "f"]
    payloads = []
    for w in range(n):
        m = 300 + 50 * w
        d = Delta(keys=rng.integers(0, 2**64, m, dtype=np.uint64),
                  data={"i": rng.integers(-2**62, 2**62, m), "f": rng.standard_normal(m)},
                  diffs=rng.integers(-2, 3, m))
        dest = rng.choice([0, 1, 3], m).astype(np.int32)  # none to worker 2
        payloads.append((tmx.local_signature(d, cols), np.bincount(dest, minlength=n), d, dest))
    results = []
    for device in (cuda, torch.device("cpu")):
        runner = tmx.MeshExchangeRunner(n, device)
        kinds, _, rows, arrived = runner.run_tick(payloads, cols)
        results.append((arrived, [r.copy() for r in rows]))
    (arrived, rows), (host_arrived, host_rows) = results
    np.testing.assert_array_equal(arrived, host_arrived)
    assert rows[2].shape[0] == 0 and not arrived[2].any()
    for g, w in zip(rows, host_rows):
        np.testing.assert_array_equal(g, w)


def test_bucketed_all_to_all_on_the_card_keeps_64_bit_values(cuda):
    rng = np.random.default_rng(8)
    vals = np.stack([(-rng.integers(1, 2**62, 64)).astype(np.int64),
                     np.full(64, np.nan).view(np.int64) | 5], 1)
    words = vals.view(np.uint32).reshape(64, 4)
    dest = rng.integers(-1, 2, 64).astype(np.int32)
    out, valid = bucketed_all_to_all(words, dest, 2, 2 * 32)
    got = out.cpu().numpy().view(np.uint32).reshape(2, 64, 4)[valid.cpu().numpy()]
    want = np.concatenate([words[:32][dest[:32] == 0], words[32:][dest[32:] == 0],
                           words[:32][dest[:32] == 1], words[32:][dest[32:] == 1]])
    np.testing.assert_array_equal(got, want)


def test_bucket_exchange_kernel_refuses_what_it_does_not_take(cuda):
    words, dest = _exchange_case(2, 8, 4, 2, seed=0)
    with pytest.raises(ValueError):
        bucket_exchange(words.to(cuda).long(), dest.to(cuda), 2, 8)
    with pytest.raises(ValueError):
        bucket_exchange(words.to(cuda), dest.to(cuda), MAX_SHARDS + 1, 8)


def test_engine_with_the_exchange_on_the_card_equals_the_host(cuda):
    """A 4-worker groupby whose exchange runs through MeshComm on the card against the same
    graph on the host: equal tables, and the kernel launched."""
    import threading

    from pathway_tpu_torch.engine import keys as K, operators as ops
    from pathway_tpu_torch.engine.delta import Delta
    from pathway_tpu_torch.engine.executor import Executor
    from pathway_tpu_torch.engine.reducers import make_reducer
    from pathway_tpu_torch.parallel.comm import LocalComm, WorkerContext
    from pathway_tpu_torch.parallel.meshcomm import MeshComm

    rng = np.random.default_rng(9)
    g = rng.integers(0, 50, 4000).astype(np.int64)
    v = (-rng.integers(0, 2**40, 4000)).astype(np.int64)
    word = np.array([f"w{x}" for x in rng.integers(0, 30, 4000)], dtype=object)
    keys = K.mix_columns([np.arange(4000)], 4000, register=False)

    def run(device):
        comm = MeshComm(LocalComm(4), device=device)
        caps, exs = [], []
        for w in range(4):
            src = ops.ScheduledSource(["g", "v", "word"], [
                (2 * t + 2, Delta(keys=keys[s:s + 1000], data={
                    "g": g[s:s + 1000], "v": v[s:s + 1000], "word": word[s:s + 1000]}))
                for t, s in enumerate(range(0, 4000, 1000))])
            gb = ops.GroupByReduce(src, ["g"], [("s", make_reducer("sum"), ["v"]),
                                                ("w", make_reducer("max"), ["word"])])
            caps.append(ops.Capture(gb))
            exs.append(Executor([src, gb, caps[-1]], ctx=WorkerContext(w, 4, comm)))
        threads = [threading.Thread(target=e.run, daemon=True) for e in exs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
        return sorted((k, tuple(r)) for k, r in caps[0].state.iter_items())

    before = bucket_exchange.launches
    on_card = run(cuda)
    assert bucket_exchange.launches > before
    assert on_card == run("cpu")


def test_rag_through_the_engine_under_async_on_the_card(cuda, monkeypatch):
    """Phase 16 (c)'s graph at a small size: chunks from a realtime source embedded by a
    ``Rowwise`` into ``ExternalIndexNode`` (gathered to worker 0), queries once the index holds
    every chunk, at 2 workers over ``LocalComm``, where the loop is async by default: the plane
    carries the exchange, both kernels launch, and every answer equals a direct search of the same
    index."""
    import threading

    from pathway_tpu_torch.engine import keys as K, operators as ops
    from pathway_tpu_torch.engine.delta import Delta
    from pathway_tpu_torch.engine.executor import Executor, RealtimeSource
    from pathway_tpu_torch.engine.external_index import ExternalIndexNode
    from pathway_tpu_torch.parallel.comm import LocalComm, WorkerContext

    monkeypatch.delenv("PATHWAY_ASYNC_EXEC", raising=False)
    emb = Embedder(EmbedderConfig(vocab_size=30522, dim=64, n_layers=2, n_heads=2, max_len=64),
                   seed=0, device=cuda)
    texts = np.array([f"chunk {i} about topic {i % 17} and word {i * 7 % 31}" for i in range(512)],
                     dtype=object)
    queries = np.array([f"topic {i} and word {i}" for i in range(8)], dtype=object)
    doc_keys = K.mix_columns([np.arange(512)], 512, salt=4, register=False)
    q_keys = K.mix_columns([np.arange(8)], 8, salt=5, register=False)
    index = BruteForceKnnEngine(64, reserved_space=512, embedder=emb, device=cuda)

    def feed(columns, batches, ready=None):
        class Feed(RealtimeSource):
            def __init__(self):
                super().__init__(columns)
                self._left = list(batches)

            def poll(self):
                if not self._left or (ready is not None and not ready()):
                    return []
                return [self._left.pop(0)]

            def is_finished(self):
                return not self._left

        return Feed()

    comm = LocalComm(2)
    caps, exs = [], []
    for w in range(2):
        docs = feed(["text"], [Delta(keys=doc_keys[s:s + 64], data={"text": texts[s:s + 64]})
                               for s in range(0, 512, 64)])
        embedded = ops.Rowwise(docs, {"__data__": lambda c, k: emb.embed_texts(list(c["text"]))})
        qs = feed(["__query__", "__limit__"], [Delta(
            keys=q_keys, data={"__query__": queries, "__limit__": np.full(8, 5, np.int64)})],
            ready=lambda: index._slots.high >= 512)
        engine = index if w == 0 else BruteForceKnnEngine(64, reserved_space=1, device=cuda)
        node = ExternalIndexNode(embedded, qs, engine, asof_now=True)
        caps.append(ops.Capture(node))
        exs.append(Executor([docs, embedded, qs, node, caps[-1]], ctx=WorkerContext(w, 2, comm)))
    assert all(ex._use_async() for ex in exs)
    before = (masked_attention.launches, topk_scores.launches)
    threads = [threading.Thread(target=e.run, daemon=True) for e in exs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    assert not any(t.is_alive() for t in threads)
    assert "async_inbox_depth" in comm.comm_stats()
    assert masked_attention.launches > before[0] and topk_scores.launches > before[1]
    replies = {int(k): row[0] for k, row in caps[0].state.iter_items()}
    direct = index.search(list(queries), [5] * 8, [None] * 8)
    assert [replies[int(k)] for k in q_keys] == [
        tuple((int(a), float(b)) for a, b in row) for row in direct]


def _vm_table():
    import pathway_tpu_torch as pw

    pw.G.clear()
    return pw, pw.debug.table_from_rows(
        pw.schema_from_types(a=int, b=int, x=float, y=float, p=bool), [(0, 0, 0.0, 0.0, False)])


VM_EXPRESSIONS = {
    "int arithmetic": lambda pw, t: (t.a * 3 + 7) - (t.b << 2) + (t.a >> t.b),
    "float arithmetic": lambda pw, t: t.x * 2.0 - 1.0 + t.x * t.y,
    "mixed and pow": lambda pw, t: t.a * 2.5 + t.x ** 2 + (abs(t.y) + 1.0) ** 0.5,
    "compare and select": lambda pw, t: pw.if_else((t.a > t.b) & t.p, t.x, -t.y),
    "casts": lambda pw, t: pw.cast(int, t.x * 1e17) + pw.cast(int, pw.cast(bool, t.y)),
    "int pow": lambda pw, t: t.a ** (t.b & 7) + 2 ** (t.b & 63),
}


@pytest.mark.parametrize("name", sorted(VM_EXPRESSIONS))
def test_expression_vm_kernel_equals_plain(cuda, name):
    """The expression machine's kernel against its plain version on the card: bits equal, float
    ``**`` within 2 ulp."""
    from pathway_tpu_torch.internals import expression_compiler as ec
    from pathway_tpu_torch.ops.expression_kernel import (
        expression_vm, run_program, run_program_plain,
    )

    pw, t = _vm_table()
    rng = np.random.default_rng(12)
    n = 70001
    cols = {"a": rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64),
            "b": rng.integers(-100, 100, n).astype(np.int64),
            "x": rng.standard_normal(n) * 1e3, "y": rng.standard_normal(n),
            "p": rng.random(n) < 0.5}
    cols["x"][:5] = [np.nan, np.inf, -np.inf, -0.0, 1e-310]
    env = ec.ColumnEnv(device=cuda)
    env.add_table(t)
    prog = ec.expression_program(VM_EXPRESSIONS[name](pw, t), env,
                                 ec._input_kinds(list(cols), cols), {})
    inputs = [torch.from_numpy(cols[c]).to(cuda) for c, _ in prog.inputs]
    before = expression_vm.launches
    (got,) = run_program(prog, inputs)
    (want,) = run_program_plain(prog, inputs)
    torch.cuda.synchronize()
    assert expression_vm.launches == before + 1
    assert got.dtype == want.dtype
    if got.dtype == torch.float64:
        nan = torch.isnan(want)
        assert torch.equal(torch.isnan(got), nan)
        gi, wi = got[~nan].view(torch.int64), want[~nan].view(torch.int64)
        if "pow" in name:
            assert (gi - wi).abs().max().item() <= 2
        else:
            assert torch.equal(gi, wi)
    else:
        assert torch.equal(got, want)
    pw.G.clear()


def _vm_held(cuda, prog, cols: dict, n: int):
    """``prog`` over ``n`` rows of ``cols`` through the kernel against its plain version, bitwise,
    with the launch count moved by one."""
    from pathway_tpu_torch.ops.expression_kernel import expression_vm, run_program, run_program_plain

    inputs = [torch.from_numpy(np.ascontiguousarray(cols[c][:n])).to(cuda) for c, _ in prog.inputs]
    before = expression_vm.launches
    got = run_program(prog, inputs)
    want = run_program_plain(prog, inputs)
    torch.cuda.synchronize()
    assert expression_vm.launches == before + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == (n,)
        assert torch.equal(g.view(torch.int64) if g.dtype == torch.float64 else g,
                           w.view(torch.int64) if w.dtype == torch.float64 else w)


def _vm_columns(n: int) -> dict:
    rng = np.random.default_rng(16)
    x = rng.standard_normal(n) * 1e3
    x[:4] = [np.nan, -0.0, np.inf, 1e-310][:min(4, n)]
    return {"a": rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64),
            "b": rng.integers(-100, 100, n).astype(np.int64), "x": x,
            "y": rng.standard_normal(n), "p": rng.random(n) < 0.5}


@pytest.mark.parametrize("n", [1, 3, 511, 513, 4097, 65537])
def test_expression_vm_kernel_at_any_row_count(cuda, n):
    """Row counts of one, below and past one block's 512 rows and past four rows a thread."""
    from pathway_tpu_torch.internals import expression_compiler as ec

    pw, t = _vm_table()
    cols = _vm_columns(n)
    env = ec.ColumnEnv(device=cuda)
    env.add_table(t)
    expr = pw.if_else((t.a > t.b) & t.p, t.x * 2.0 - 1.0, -t.y) + pw.cast(float, t.b << 3)
    prog = ec.expression_program(expr, env, ec._input_kinds(list(cols), cols), {})
    _vm_held(cuda, prog, cols, n)
    pw.G.clear()


def test_expression_vm_kernel_at_the_register_limit(cuda):
    """A program that needs all MAX_REGS registers (its register file at 32 threads a block)."""
    from pathway_tpu_torch.ops.expression_kernel import MAX_REGS, ProgramBuilder

    def build(k):
        b = ProgramBuilder({"a": "I", "x": "F"})
        a, x = b.load("a"), b.load("x")
        vals = [b.binop("+", a, b.const(i + 1)) for i in range(k)]
        vals.append(b.convert(b.binop("*", x, b.const(3.0)), "I"))
        acc = vals[0]
        for v in vals[1:]:
            acc = b.binop("^", b.binop("*", acc, v), v)
        b.store("out", acc)
        return b.finish()

    prog = next(p for p in map(build, range(MAX_REGS)) if p.n_regs == MAX_REGS)
    _vm_held(cuda, prog, _vm_columns(70001), 70001)


def test_expression_vm_kernel_near_the_instruction_limit(cuda):
    """A program of close to MAX_INSNS instructions, every one of them live."""
    from pathway_tpu_torch.ops.expression_kernel import MAX_INSNS, ProgramBuilder

    b = ProgramBuilder({"a": "I", "x": "F", "p": "B"})
    acc, f, p = b.load("a"), b.load("x"), b.load("p")
    step = 0
    while len(b._code) < MAX_INSNS - 8:
        acc = b.binop("^", b.binop("+", b.binop("*", acc, b.const(3)), b.const(step % 5)),
                      b.binop(">>", acc, b.const(7)))
        f = b.where(p, b.binop("-", b.binop("*", f, b.const(0.5)), b.const(1.25)), f)
        step += 1
    b.store("i", acc)
    b.store("f", f)
    prog = b.finish()
    assert MAX_INSNS - 16 <= prog.code.shape[0] <= MAX_INSNS
    _vm_held(cuda, prog, _vm_columns(70001), 70001)


def test_expression_vm_refuses_what_it_does_not_take(cuda):
    from pathway_tpu_torch.internals import expression_compiler as ec
    from pathway_tpu_torch.ops.expression_kernel import expression_vm, layout

    pw, t = _vm_table()
    env = ec.ColumnEnv(device=cuda)
    env.add_table(t)
    cols = {"a": np.arange(10, dtype=np.int64)}
    prog = ec.expression_program(t.a + 1, env, ec._input_kinds(["a"], cols), {})
    _, in_bytes, _, out_bytes = layout(prog, 10)
    good_in = torch.zeros(in_bytes, dtype=torch.uint8, device=cuda)
    good_out = torch.zeros(out_bytes, dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):
        expression_vm(prog, good_in[:8], good_out, 10)  # too small
    with pytest.raises(ValueError):
        expression_vm(prog, good_in.to(torch.int32), good_out, 10)
    with pytest.raises(ValueError):
        expression_vm(prog, good_in, good_out.cpu(), 10)
    pw.G.clear()


def test_table_api_runs_on_the_card(cuda, monkeypatch):
    """``pw.run(device="cuda")`` of a streaming select/filter/groupby past the expression tier's
    gates: the table equals numpy's, and the kernel launched."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.internals import expression_compiler as ec
    from pathway_tpu_torch.ops.expression_kernel import expression_vm

    monkeypatch.setattr(ec, "JIT_THRESHOLD", 64)
    monkeypatch.setattr(ec, "JIT_WARMUP_BATCHES", 2)
    rng = np.random.default_rng(13)
    a = rng.integers(-2**31, 2**31, 8000)
    g = rng.integers(0, 50, 8000)
    x = rng.integers(-1024, 1024, 8000) / 16.0

    class Feed(pw.io.python.ConnectorSubject):
        def run(self):
            for s in range(0, 8000, 1000):
                self.next_batch({"a": a[s:s + 1000], "g": g[s:s + 1000], "x": x[s:s + 1000]})
                self.commit()

    pw.G.clear()
    src = pw.io.python.read(Feed(), schema=pw.schema_from_types(a=int, g=int, x=float),
                            autocommit_duration_ms=None)
    res = (src.select(g=pw.this.g, y=pw.apply_with_type(lambda a: a * 3 + 7, int, pw.this.a),
                      z=pw.this.x * 2.0 - 1.0)
           .filter(pw.this.z > -32.0)
           .select(g=pw.this.g, w=pw.if_else(pw.this.y > 1000,
                                             pw.cast(float, pw.this.y & 1023) * pw.this.z,
                                             -pw.this.z))
           .groupby(pw.this.g).reduce(pw.this.g, s=pw.reducers.sum(pw.this.w)))
    got = {}

    def on_change(key, row, time, is_addition):
        if is_addition:
            got[row["g"]] = row["s"]

    pw.io.subscribe(res, on_change=on_change)
    before = expression_vm.launches
    pw.run(device="cuda")
    pw.G.clear()
    assert expression_vm.launches > before
    z = x * 2.0 - 1.0
    y = a * 3 + 7
    w = np.where(y > 1000, (y & 1023) * z, -z)
    want = {}
    for gg, ww in zip(g[z > -32.0], w[z > -32.0]):
        want[int(gg)] = want.get(int(gg), 0.0) + ww
    assert got == want


def test_native_module_builds_and_loads_on_the_card_machine(cuda):
    """The engine's keyspace module builds with the host C compiler there and hashes as the
    Python path does."""
    from pathway_tpu_torch import native
    from pathway_tpu_torch.engine import keys as K
    from pathway_tpu_torch.engine.slotmap import SlotMap, SlotMapPlain

    module = native.load()
    assert module.__name__ == "_pathway_torch_native"
    words = np.array([f"w{i % 97}" for i in range(5000)] + [None, 3, 2.5, (1, "x")],
                     dtype=object)
    np.testing.assert_array_equal(K._hash_object_column(words),
                                  K._hash_object_column_plain(words))
    rows = [(w, i) for i, w in enumerate(words[:500])]
    np.testing.assert_array_equal(K.hash_values(rows, register=False),
                                  K._hash_values_plain(rows, register=False))
    keys = K.mix_columns([np.arange(3000) % 700], 3000, register=False)
    np.testing.assert_array_equal(SlotMap().lookup_or_insert(keys)[0],
                                  SlotMapPlain().lookup_or_insert(keys)[0])


@pytest.mark.parametrize("workers", [1, 2])
def test_data_index_query_on_the_card_launches_the_scorer(cuda, workers, monkeypatch):
    """A ``pw.indexing.DataIndex`` query through ``pw.run(device="cuda")``: the scorer launches,
    and the answers equal ``BruteForceKnnEngine.search`` on an engine filled with the same rows
    (scores within one bf16 ulp, ids where the scores are clear)."""
    import pathway_tpu_torch as pw

    rng = np.random.default_rng(21)
    n, d, q, k = 20000, 384, 16, 10
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((q, d)).astype(np.float32)

    class Rows(pw.io.python.ConnectorSubject):
        def run(self):
            for s in range(0, n, 5000):
                self.next_batch({"rid": list(range(s, s + 5000)), "vec": list(vecs[s:s + 5000])})
                self.commit()

    pw.G.clear()
    data = pw.io.python.read(Rows(), schema=pw.schema_from_types(rid=int, vec=object),
                             autocommit_duration_ms=None)
    qt = pw.debug.table_from_rows(pw.schema_from_types(qi=int, qv=object),
                                  [(i, queries[i]) for i in range(q)])
    index = pw.indexing.BruteForceKnnFactory(dimensions=d, reserved_space=n).build_index(
        data.vec, data)
    res = index.query(qt.qv, number_of_matches=k).select(
        qi=pw.left.qi, rid=pw.right.rid, score=pw.right._pw_index_reply_score)
    got = {}

    def on_change(key, row, time, is_addition):
        if is_addition:
            got[row["qi"]] = (list(row["rid"]), list(row["score"]))

    pw.io.subscribe(res, on_change=on_change)
    before = topk_scores.launches
    monkeypatch.setenv("PATHWAY_THREADS", str(workers))
    monkeypatch.setenv("PATHWAY_MESH_EXCHANGE", str(int(workers > 1)))
    try:
        pw.run(device="cuda")
    finally:
        pw.G.clear()
    assert topk_scores.launches > before
    direct = BruteForceKnnEngine(d, reserved_space=n, device=cuda)
    direct.add_batch(list(range(n)), list(vecs), [None] * n)
    want = direct.search(list(queries), [k + 1] * q, [None] * q)  # one more: the k-th's gap
    assert sorted(got) == list(range(q))
    s_ours = np.array([got[i][1] for i in range(q)])
    i_ours = np.array([got[i][0] for i in range(q)])
    s_want = np.array([[s for _, s in row] for row in want])
    i_want = np.array([[key for key, _ in row] for row in want])[:, :k]
    tol = topk_tol(s_want[:, :k], queries, vecs, "cos")
    assert (np.abs(s_ours - s_want[:, :k]) <= tol).all()
    gap_prev = np.concatenate([np.full((q, 1), np.inf), s_want[:, :k - 1] - s_want[:, 1:k]], 1)
    clear = (gap_prev > tol) & (s_want[:, :k] - s_want[:, 1:] > tol)
    np.testing.assert_array_equal(i_ours[clear], i_want[clear])


def test_persisted_data_index_restored_on_the_card(cuda, monkeypatch, tmp_path):
    """A ``pw.indexing.DataIndex`` persisted with ``device="cuda"``: a first run takes three of
    four commits and stops; the restarted run restores the engine from its snapshot (no tensor
    in any snapshot blob), takes the fourth commit and answers the queries. Its first query
    launches the scorer, and its answers equal, bit for bit, those of a run that was not
    stopped."""
    import time as _time

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.internals import run as run_mod
    from pathway_tpu_torch.persistence import Backend, Config
    from torch_persist_checks import guard_snapshot_blobs

    checked = guard_snapshot_blobs(monkeypatch)
    rng = np.random.default_rng(23)
    n, d, q, k = 20000, 384, 16, 10
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((q, d)).astype(np.float32)

    def leg(commits: int, ask: bool, cfg) -> tuple[dict, int]:
        rows = 5000 * commits

        def held() -> int:
            runner = run_mod._current["runner"]
            return max([len(nd.engine._slots.key_to_slot) for nd in runner._nodes
                        if type(nd).__name__ == "ExternalIndexNode"] or [0])

        class Rows(pw.io.python.ConnectorSubject):
            def run(self):
                for s in range(0, rows, 5000):
                    self.next_batch({"rid": list(range(s, s + 5000)),
                                     "vec": list(vecs[s:s + 5000])})
                    self.commit()

        class Queries(pw.io.python.ConnectorSubject):
            def run(self):
                deadline = _time.monotonic() + 120
                while held() < rows and _time.monotonic() < deadline:
                    _time.sleep(0.005)
                if ask:
                    launches["before"] = topk_scores.launches
                    self.next_batch({"qi": list(range(q)), "qv": list(queries)})
                    self.commit()

        pw.G.clear()
        data = pw.io.python.read(Rows(), schema=pw.schema_from_types(rid=int, vec=object),
                                 autocommit_duration_ms=None, name="rows")
        qt = pw.io.python.read(Queries(), schema=pw.schema_from_types(qi=int, qv=object),
                               autocommit_duration_ms=None, name="queries")
        index = pw.indexing.BruteForceKnnFactory(dimensions=d, reserved_space=n).build_index(
            data.vec, data)
        res = index.query_as_of_now(qt.qv, number_of_matches=k).select(
            qi=pw.left.qi, rid=pw.right.rid, score=pw.right._pw_index_reply_score)
        got, launches = {}, {}

        def on_change(key, row, time, is_addition):
            if is_addition:
                got[row["qi"]] = (list(row["rid"]), list(row["score"]))
                launches.setdefault("after", topk_scores.launches)

        pw.io.subscribe(res, on_change=on_change)
        try:
            pw.run(device="cuda", **({"persistence_config": cfg} if cfg else {}))
        finally:
            pw.G.clear()
        return got, launches.get("after", 0) - launches.get("before", 0)

    monkeypatch.setenv("PATHWAY_THREADS", "1")
    cfg = Config.simple_config(Backend.filesystem(str(tmp_path / "ps")))
    assert leg(3, False, cfg)[0] == {}
    assert checked, "the first run wrote no operator snapshot"
    restored, restored_launches = leg(4, True, cfg)
    clean, _ = leg(4, True, None)
    assert restored_launches > 0
    assert sorted(restored) == list(range(q))
    assert restored == clean


def test_persisted_groupby_rescaled_on_the_card(cuda, monkeypatch, tmp_path):
    """A persisted groupby at 2 workers with the mesh exchange on ``cuda`` (half the feed, then
    stopped), rescaled offline to 4 and run on over the whole feed: the rows summed over both
    runs equal the same program's ``device="cpu"`` table over the same feed, and
    ``bucket_exchange`` launches in the rescaled run."""
    from collections import Counter

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.parallel import exchange
    from pathway_tpu_torch.persistence import Backend, Config
    from pathway_tpu_torch.persistence.backends import FilesystemBackend
    from pathway_tpu_torch.rescale import rescale

    rng = np.random.default_rng(41)
    g = rng.integers(0, 5000, 40000).tolist()
    v = rng.integers(-1000, 1000, 40000).tolist()

    def run(upto: int, device: str, workers: int, cfg) -> Counter:
        class Feed(pw.io.python.ConnectorSubject):
            def run(self):
                for s in range(0, upto, 4000):
                    self.next_batch({"g": g[s:s + 4000], "v": v[s:s + 4000]})
                    self.commit()

        pw.G.clear()
        t = pw.io.python.read(Feed(), schema=pw.schema_from_types(g=int, v=int),
                              autocommit_duration_ms=None, name="feed")
        res = t.groupby(pw.this.g).reduce(pw.this.g, n=pw.reducers.count(),
                                          s=pw.reducers.sum(pw.this.v))
        seen: Counter = Counter()
        pw.io.subscribe(res, on_change=lambda key, row, time, is_addition: seen.update(
            {(row["g"], row["n"], row["s"]): 1 if is_addition else -1}))
        monkeypatch.setenv("PATHWAY_THREADS", str(workers))
        monkeypatch.setenv("PATHWAY_MESH_EXCHANGE", "1" if workers > 1 else "0")
        try:
            pw.run(device=device, **({"persistence_config": cfg} if cfg else {}))
        finally:
            pw.G.clear()
        return seen

    store = str(tmp_path / "ps")
    cfg = Config.simple_config(Backend.filesystem(store), snapshot_interval_ms=0)
    seen = run(20000, "cuda", 2, cfg)
    report = rescale(FilesystemBackend(store), 4, log=lambda msg: None)
    assert (report["from"], report["to"], report["ranks"]) == (2, 4, 1)
    before = exchange.bucket_exchange.launches
    seen.update(run(40000, "cuda", 4, cfg))
    assert exchange.bucket_exchange.launches > before
    assert +seen == +run(40000, "cpu", 1, None)


def test_document_store_server_on_the_card_launches_both_kernels(cuda, monkeypatch):
    """A ``DocumentStoreServer`` on the card over a few hundred chunks (``ParseLocal``,
    ``TokenCountSplitter``, the default encoder) answers one ``/v1/retrieve`` over HTTP, and both
    kernels of the serve path, the attention and the scorer, launch for it."""
    import json
    import socket
    import sys
    import threading
    import time
    import urllib.request

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.io.http._server import terminate_all
    from pathway_tpu_torch.xpacks.llm import DocumentStore, DocumentStoreServer
    from pathway_tpu_torch.xpacks.llm.embedders import TorchEmbedder
    from pathway_tpu_torch.xpacks.llm.parsers import ParseLocal
    from pathway_tpu_torch.xpacks.llm.splitters import TokenCountSplitter

    monkeypatch.setitem(sys.modules, "tiktoken", None)  # its encodings come over the network
    rng = np.random.default_rng(23)
    words = [f"w{i}" for i in range(500)]
    docs_in = []
    for i in range(40):
        text = " ".join(" ".join(rng.choice(words, size=12)) + "." for _ in range(60))
        data = (f"<html><title>d{i}</title><body><p>{text}</p></body></html>" if i % 2
                else text)
        docs_in.append((data.encode(), {"path": f"d{i}.txt", "modified_at": i}))
    pw.G.clear()
    docs = pw.debug.table_from_rows(pw.schema_from_types(data=bytes, _metadata=dict), docs_in)
    embedder = TorchEmbedder(device=cuda)
    store = DocumentStore(docs, pw.indexing.BruteForceKnnFactory(
        dimensions=embedder.embedder.cfg.dim, embedder=embedder.embedder),
        parser=ParseLocal(), splitter=TokenCountSplitter(min_tokens=20, max_tokens=64))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    server = DocumentStoreServer("127.0.0.1", port, store)
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))

    def post(route, body):
        req = urllib.request.Request(f"http://127.0.0.1:{port}{route}",
                                     data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        with opener.open(req, timeout=60) as resp:
            return json.loads(resp.read())

    server.run(threaded=True, device=cuda)
    try:
        deadline = time.monotonic() + 120
        while True:
            try:
                if post("/v1/statistics", {}).get("file_count") == len(docs_in):
                    break
            except OSError:
                pass
            assert time.monotonic() < deadline and server.run_error is None
            time.sleep(0.1)
        before = (masked_attention.launches, topk_scores.launches)
        answer = post("/v1/retrieve", {"query": "w1 w2 w3", "k": 5})
        after = (masked_attention.launches, topk_scores.launches)
    finally:
        pw.request_stop()
        terminate_all()
        server._thread.join(60)
        pw.G.clear()
    assert not server._thread.is_alive() and server.run_error is None
    assert len(answer) == 5 and all(np.isfinite(d["dist"]) for d in answer)
    assert [d["dist"] for d in answer] == sorted(d["dist"] for d in answer)
    assert after[0] > before[0] and after[1] > before[1], (before, after)


def test_example_serves_a_file_directory_on_the_card(cuda, monkeypatch, tmp_path):
    """The ported example (``examples/rag_server/serve.py``) over a directory of text and HTML
    files on the card: ``/v1/retrieve`` answers, and its request launches the attention (the
    query's forward) and the scorer."""
    import json
    import socket
    import sys
    import time
    import urllib.request

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.examples.rag_server import serve
    from pathway_tpu_torch.io.http._server import terminate_all

    monkeypatch.setitem(sys.modules, "tiktoken", None)  # its encodings come over the network
    rng = np.random.default_rng(29)
    words = [f"w{i}" for i in range(400)]
    for i in range(24):
        text = " ".join(" ".join(rng.choice(words, size=10)) + "." for _ in range(40))
        body = f"<html><title>d{i}</title><body><p>{text}</p></body></html>" if i % 2 else text
        (tmp_path / f"d{i:02d}.{'html' if i % 2 else 'txt'}").write_text(body)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    pw.G.clear()
    server = serve.build_server(str(tmp_path), "127.0.0.1", port, 64, cuda)
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))

    def post(route, body):
        req = urllib.request.Request(f"http://127.0.0.1:{port}{route}",
                                     data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        with opener.open(req, timeout=60) as resp:
            return json.loads(resp.read())

    server.run(threaded=True, device=cuda)
    try:
        deadline = time.monotonic() + 120
        while True:
            try:
                if post("/v1/statistics", {}).get("file_count") == 24:
                    break
            except OSError:
                pass
            assert time.monotonic() < deadline and server.run_error is None
            time.sleep(0.1)
        before = (masked_attention.launches, topk_scores.launches)
        answer = post("/v1/retrieve", {"query": "w1 w2 w3", "k": 3})
        after = (masked_attention.launches, topk_scores.launches)
        inputs = post("/v1/inputs", {})
    finally:
        pw.request_stop()
        terminate_all()
        server._thread.join(60)
        pw.G.clear()
    assert not server._thread.is_alive() and server.run_error is None
    assert len(answer) == 3 and all(np.isfinite(d["dist"]) for d in answer)
    assert [d["dist"] for d in answer] == sorted(d["dist"] for d in answer)
    assert inputs == [{"path": None}] * 24  # the binary read carries no _metadata
    assert after[0] > before[0] and after[1] == before[1] + 1, (before, after)


def test_knn_index_on_the_card_launches_the_scorer(cuda):
    """``pw.ml.KNNIndex`` (``distance_type="euclidean"``, the ``l2sq`` metric) at MNIST's width
    through ``pw.run(device="cuda")``: the scorer launches, and each query's nearest item is the
    training row it was drawn next to, at numpy's squared distance within two bf16 ulps of the
    largest possible dot (``topk_tol``: the scorer's dot products are bf16)."""
    import pathway_tpu_torch as pw

    rng = np.random.default_rng(29)
    n, d, q, k = 4096, 784, 16, 3
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    near = rng.choice(n, q, replace=False)
    queries = vecs[near] + 0.01 * rng.standard_normal((q, d)).astype(np.float32)

    class Rows(pw.io.python.ConnectorSubject):
        def run(self):
            for s in range(0, n, 1024):
                self.next_batch({"rid": list(range(s, s + 1024)), "data": list(vecs[s:s + 1024])})
                self.commit()

    pw.G.clear()
    data = pw.io.python.read(Rows(), schema=pw.schema_from_types(rid=int, data=object),
                             autocommit_duration_ms=None)
    qt = pw.debug.table_from_rows(pw.schema_from_types(qi=int, data=object),
                                  [(i, queries[i]) for i in range(q)])
    index = pw.ml.KNNIndex(data.data, data, n_dimensions=d, distance_type="euclidean")
    res = index.get_nearest_items(qt.data, k=k, with_distances=True)
    res = res.select(qi=qt.ix(res.id).qi, rid=res.rid, dist=res.dist)
    got = {}

    def on_change(key, row, time, is_addition):
        if is_addition:
            got[row["qi"]] = (list(row["rid"]), list(row["dist"]))

    pw.io.subscribe(res, on_change=on_change)
    before = topk_scores.launches
    try:
        pw.run(device="cuda")
    finally:
        pw.G.clear()
    assert topk_scores.launches > before
    assert sorted(got) == list(range(q))
    for i in range(q):
        rids, dists = got[i]
        assert len(rids) == k and rids[0] == near[i]
        want = np.array([[((queries[i] - vecs[near[i]]) ** 2).sum()]])
        tol = topk_tol(-want, queries[i:i + 1], vecs, "l2sq")
        assert abs(dists[0] - want[0, 0]) <= tol[0, 0]


def _bid_rows(n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [(i, int(a), int(p)) for i, (a, p) in
            enumerate(zip(rng.integers(0, 40, n), rng.integers(100, 10**6, n)))]


def _per_auction(pw, bids):
    q1 = bids.select(pw.this.auction, price_eur=pw.this.price * 0.908)
    return q1.groupby(pw.this.auction).reduce(pw.this.auction, n=pw.reducers.count(),
                                              top=pw.reducers.max(pw.this.price_eur))


def _plain_per_auction(rows: list) -> dict:
    out: dict = {}
    for _, a, p in rows:
        n, top = out.get(a, (0, -1.0))
        out[a] = (n + 1, max(top, p * 0.908))
    return out


def _live(pw, table) -> dict:
    """The final table {row key: row} of ``table``'s subscription."""
    live: dict = {}
    names = table.column_names()

    def on_change(key, row, time, is_addition):
        tup = tuple(row[c] for c in names)
        if is_addition:
            live[int(key)] = tup
        elif live.get(int(key)) == tup:
            del live[int(key)]

    pw.io.subscribe(table, on_change=on_change)
    return live


def _run_while(pw, write, seen: dict, n_rows: int) -> None:
    """``pw.run(device="cuda")`` while ``write()`` runs on a thread; stopped once ``seen`` (a
    final table) holds ``n_rows`` rows after the write, within 60 s."""
    import threading
    import time

    def writer():
        try:
            write()
            deadline = time.monotonic() + 60
            while len(seen) != n_rows and time.monotonic() < deadline:
                time.sleep(0.05)
            time.sleep(0.3)
        finally:
            pw.request_stop()

    th = threading.Thread(target=writer, daemon=True)
    th.start()
    try:
        pw.run(device="cuda")
    finally:
        th.join(60)
        pw.G.clear()


def test_sqlite_cdc_on_the_card_launches_expression_vm(cuda, monkeypatch, tmp_path):
    """``pw.io.sqlite.read(mode="streaming")`` into Nexmark Q1's conversion and a count and
    maximum per auction on the card, past the expression tier's gates: inserts, updates and
    deletes in transactions; the tables equal Python's over the database's final rows, and the
    kernel launched."""
    import sqlite3

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.internals import expression_compiler as ec
    from pathway_tpu_torch.ops.expression_kernel import expression_vm

    monkeypatch.setattr(ec, "JIT_THRESHOLD", 64)
    monkeypatch.setattr(ec, "JIT_WARMUP_BATCHES", 2)
    rows = _bid_rows(3000, 41)
    db = str(tmp_path / "bids.db")
    con = sqlite3.connect(db, check_same_thread=False)
    con.execute("PRAGMA journal_mode=WAL")
    con.execute("CREATE TABLE bids (i INTEGER PRIMARY KEY, auction INTEGER, price INTEGER)")
    con.commit()
    pw.G.clear()
    schema = pw.schema_builder({"i": pw.column_definition(dtype=int, primary_key=True),
                                "auction": pw.column_definition(dtype=int),
                                "price": pw.column_definition(dtype=int)})
    t = pw.io.sqlite.read(db, "bids", schema, mode="streaming")
    raw = _live(pw, t)
    agg = _live(pw, _per_auction(pw, t))
    final = {r[0]: r for r in rows}

    def write():
        import time

        for s in range(0, 3000, 500):
            con.executemany("INSERT INTO bids VALUES (?, ?, ?)", rows[s:s + 500])
            con.commit()
            time.sleep(0.3)
        con.executemany("UPDATE bids SET price = price + 1 WHERE i = ?",
                        [(i,) for i in range(0, 3000, 7)])
        con.executemany("DELETE FROM bids WHERE i = ?", [(i,) for i in range(3, 3000, 11)])
        con.commit()
        for i in range(0, 3000, 7):
            final[i] = (i, final[i][1], final[i][2] + 1)
        for i in range(3, 3000, 11):
            final.pop(i)

    before = expression_vm.launches
    _run_while(pw, write, raw, 3000 - len(range(3, 3000, 11)))
    con.close()
    assert expression_vm.launches > before
    assert sorted(raw.values()) == sorted(final.values())
    assert {r[0]: (r[1], r[2]) for r in agg.values()} == _plain_per_auction(final.values())


def test_delta_streaming_read_on_the_card(cuda, monkeypatch, tmp_path):
    """``pw.io.deltalake.write`` on the card, then ``read(mode="streaming")`` while versions with
    retractions and a file's removal are appended: the tables equal Python's, and the kernel
    launched on the read."""
    from types import SimpleNamespace

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.internals import expression_compiler as ec
    from pathway_tpu_torch.io.deltalake import DeltaTableWriter, _list_versions, _version_actions
    from pathway_tpu_torch.ops.expression_kernel import expression_vm

    monkeypatch.setattr(ec, "JIT_THRESHOLD", 64)
    monkeypatch.setattr(ec, "JIT_WARMUP_BATCHES", 2)
    rows = _bid_rows(3000, 43)
    uri = str(tmp_path / "bids_delta")

    class Feed(pw.io.python.ConnectorSubject):
        def run(self):
            for s in range(0, 3000, 500):
                part = rows[s:s + 500]
                self.next_batch({"i": [r[0] for r in part], "auction": [r[1] for r in part],
                                 "price": [r[2] for r in part]})
                self.commit()

    pw.G.clear()
    src = pw.io.python.read(Feed(), schema=pw.schema_from_types(i=int, auction=int, price=int),
                            autocommit_duration_ms=None)
    pw.io.deltalake.write(src, uri, min_commit_frequency=None)
    pw.run(device="cuda")
    pw.G.clear()
    (first_file,), _ = _version_actions(uri, _list_versions(uri)[1])
    t = pw.io.deltalake.read(uri, schema=pw.schema_from_types(i=int, auction=int, price=int),
                             mode="streaming", autocommit_duration_ms=100)
    raw = _live(pw, t)
    agg = _live(pw, _per_auction(pw, t))
    gone = [r for r in rows[1000:] if r[0] % 9 == 0]
    final = [r for r in rows[500:] if r not in gone]

    def write():
        writer = DeltaTableWriter(uri, ["i", "auction", "price"], None, None)
        cols = {"i": [r[0] for r in gone], "auction": [r[1] for r in gone],
                "price": [r[2] for r in gone]}
        writer.add_batch(100, SimpleNamespace(data=cols, diffs=[-1] * len(gone)))
        writer.flush()
        writer._commit_actions([{"remove": {"path": first_file, "dataChange": True}}])

    before = expression_vm.launches
    _run_while(pw, write, raw, len(final))
    assert expression_vm.launches > before
    assert sorted(raw.values()) == sorted(final)
    assert {r[0]: (r[1], r[2]) for r in agg.values()} == _plain_per_auction(final)


def test_debezium_replay_on_the_card(cuda, tmp_path):
    """``pw.io.debezium.read`` of create, update and delete envelopes on the card: the table equals
    the rows they leave, keyed by the primary key, and the count and maximum per auction equal
    Python's."""
    import json

    import pathway_tpu_torch as pw

    rows = _bid_rows(400, 47)
    final = {r[0]: r for r in rows}
    lines = [{"payload": {"op": "c", "after": dict(zip(("i", "auction", "price"), r))}}
             for r in rows]
    for r in rows[::5]:
        after = (r[0], r[1], r[2] + 3)
        lines.append({"payload": {"op": "u", "before": dict(zip(("i", "auction", "price"), r)),
                                  "after": dict(zip(("i", "auction", "price"), after))}})
        final[r[0]] = after
    for r in rows[1::7]:
        lines.append({"payload": {"op": "d", "before": dict(zip(("i", "auction", "price"),
                                                               final[r[0]]))}})
        final.pop(r[0])
    path = tmp_path / "cdc.jsonl"
    path.write_text("\n".join(json.dumps(x) for x in lines))
    pw.G.clear()
    schema = pw.schema_builder({"i": pw.column_definition(dtype=int, primary_key=True),
                                "auction": pw.column_definition(dtype=int),
                                "price": pw.column_definition(dtype=int)})
    t = pw.io.debezium.read(input_file=str(path), schema=schema, autocommit_duration_ms=None)
    raw = _live(pw, t)
    agg = _live(pw, _per_auction(pw, t))
    try:
        pw.run(device="cuda")
    finally:
        pw.G.clear()
    assert sorted(raw.values()) == sorted(final.values())
    assert {r[0]: (r[1], r[2]) for r in agg.values()} == _plain_per_auction(final.values())


def test_observed_run_on_the_card_serves_metrics(cuda, monkeypatch):
    """A 2-worker streaming run on the card with the monitoring server on: the chain runs on the
    expression machine, ``/metrics`` (scraped after every worker joined, before the server stops)
    parses, carries both workers and counts every input row, and the table equals numpy's."""
    import socket
    import urllib.request

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.internals import expression_compiler as ec
    from pathway_tpu_torch.internals import graph_runner as gr
    from pathway_tpu_torch.observability import parse_exposition
    from pathway_tpu_torch.ops.expression_kernel import expression_vm

    monkeypatch.setattr(ec, "JIT_THRESHOLD", 64)
    monkeypatch.setattr(ec, "JIT_WARMUP_BATCHES", 2)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    monkeypatch.setenv("PATHWAY_THREADS", "2")
    monkeypatch.setenv("PATHWAY_MONITORING_HTTP_PORT", str(port))
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    scraped = []
    stop = gr.GraphRunner._stop_observability

    def scrape_then_stop(http_server, flusher, hub=None):
        with opener.open(f"http://127.0.0.1:{port}/metrics", timeout=10) as r:
            scraped.append(r.read().decode())
        stop(http_server, flusher, hub)

    monkeypatch.setattr(gr.GraphRunner, "_stop_observability", staticmethod(scrape_then_stop))
    rng = np.random.default_rng(17)
    g = rng.integers(0, 40, 8000)
    x = rng.integers(-1024, 1024, 8000) / 16.0

    class Feed(pw.io.python.ConnectorSubject):
        def run(self):
            for s in range(0, 8000, 1000):
                self.next_batch({"g": g[s:s + 1000], "x": x[s:s + 1000]})
                self.commit()

    pw.G.clear()
    src = pw.io.python.read(Feed(), schema=pw.schema_from_types(g=int, x=float),
                            autocommit_duration_ms=None)
    res = (src.select(g=pw.this.g, z=pw.this.x * 2.0 - 1.0).filter(pw.this.z > -32.0)
           .groupby(pw.this.g).reduce(pw.this.g, s=pw.reducers.sum(pw.this.z)))
    got = {}
    pw.io.subscribe(res, on_change=lambda key, row, time, is_addition:
                    got.__setitem__(row["g"], row["s"]) if is_addition else None)
    before = expression_vm.launches
    try:
        pw.run(device="cuda", with_http_server=True)
    finally:
        pw.G.clear()
    assert expression_vm.launches > before
    z = x * 2.0 - 1.0
    want = {}
    for gg, zz in zip(g[z > -32.0], z[z > -32.0]):
        want[int(gg)] = want.get(int(gg), 0.0) + zz
    assert got == want
    series = parse_exposition(scraped[0])
    inputs = {dict(lab)["worker"]: v for (name, lab), v in series.items()
              if name == "pathway_input_rows"}
    assert set(inputs) == {"0", "1"} and sum(inputs.values()) == 8000


_CLI_CHAIN = '''
import json
import sys

import numpy as np
import pathway_tpu_torch as pw
from pathway_tpu_torch.ops.expression_kernel import expression_vm

rng = np.random.default_rng(5)
g, x = rng.integers(0, 64, 81920), rng.integers(-1024, 1024, 81920) / 16.0


class Feed(pw.io.python.ConnectorSubject):
    def run(self):
        for s in range(0, 81920, 4096):
            self.next_batch({"g": g[s:s + 4096], "x": x[s:s + 4096]})
            self.commit()


src = pw.io.python.read(Feed(), schema=pw.schema_from_types(g=int, x=float),
                        autocommit_duration_ms=None)
res = (src.select(g=pw.this.g, z=pw.this.x * 2.0 - 1.0).filter(pw.this.z > -32.0)
       .groupby(pw.this.g).reduce(pw.this.g, s=pw.reducers.sum(pw.this.z)))
got = {}
pw.io.subscribe(res, on_change=lambda key, row, time, is_addition:
                got.__setitem__(row["g"], row["s"]) if is_addition else None)
pw.run()
z = x * 2.0 - 1.0
want = {}
for gg, zz in zip(g[z > -32.0], z[z > -32.0]):
    want[int(gg)] = want.get(int(gg), 0.0) + zz
with open(sys.argv[1], "w") as f:
    json.dump({"launches": expression_vm.launches, "equal": got == want}, f)
'''


def test_cli_spawn_runs_a_chain_on_the_card(cuda, tmp_path):
    """A short chain program (20 commits of 4,096 rows, past the expression machine's gate and
    warm-up) through ``python -m pathway_tpu_torch.cli spawn`` in a fresh interpreter: its own
    ``pw.run()`` takes the default device, the card, and the chain launches ``expression_vm``;
    the table equals numpy's."""
    import json
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    prog, out = tmp_path / "chain.py", tmp_path / "out.json"
    prog.write_text(_CLI_CHAIN)
    r = subprocess.run([sys.executable, "-m", "pathway_tpu_torch.cli", "spawn", sys.executable,
                        str(prog), str(out)], cwd=root, capture_output=True, text=True,
                       timeout=300, env={**os.environ, "PYTHONPATH": root,
                                         "PATHWAY_INGEST_COALESCE_WINDOWS": "0"})
    assert r.returncode == 0, r.stderr[-3000:]
    doc = json.loads(out.read_text())
    assert doc["equal"] and doc["launches"] > 0, doc
