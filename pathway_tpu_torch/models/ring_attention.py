"""Ring attention, sequence-parallel attention over a ``torch.distributed`` mesh: port of
``pathway_tpu/models/ring_attention.py``.

A long document embeds as one sequence split over a mesh axis: each rank holds its block of
queries, keys and values; the key and value blocks go round the ring, one hop a step, and each
step folds the block it holds into the running online-softmax state with the hand-written kernel
of ``ops/ring.py``. No rank ever holds the whole score matrix. Numerics as in the JAX program:
scores and accumulators in f32, inputs in the working dtype.

Torch has no global sharded array: :func:`ring_attention` and :func:`ring_encoder_block` take
and return this rank's blocks. :func:`embed_tokens_long` keeps the JAX signature: it takes the
whole ``[B, S]`` ids on every rank and returns the pooled embedding on every rank.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..ops.ring import NEG, init_state, ring_block_attention
from .embedder import EmbedderConfig, _layernorm

__all__ = ["full_attention", "ring_attention", "ring_encoder_block", "embed_tokens_long"]


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
                   scale: float) -> torch.Tensor:
    """Plain single-device attention, the ring's correctness oracle. q, k, v ``[B, S, H, D]``;
    mask bool ``[B, S]`` (key padding). Returns f32 ``[B, S, H, D]``."""
    qh, kh, vh = (t.transpose(1, 2).float() for t in (q, k, v))
    scores = (qh @ kh.transpose(-1, -2)) * scale
    scores = torch.where(mask[:, None, None, :], scores, NEG)
    return (torch.softmax(scores, dim=-1) @ vh).transpose(1, 2)


def _ring(mesh: Any, axis: str):
    """(group, size, global rank of the next rank, global rank of the previous rank)."""
    group = mesh.get_group(axis)
    n, r = dist.get_world_size(group), dist.get_rank(group)
    return (group, n, dist.get_global_rank(group, (r + 1) % n),
            dist.get_global_rank(group, (r - 1) % n))


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
                   mesh: Any, axis: str, scale: float) -> torch.Tensor:
    """Sequence-parallel attention over the mesh axis ``axis``.

    q, k, v: this rank's blocks ``[B, S/P, H, D]`` of a sequence split over the P ranks of the
    axis in rank order; mask: bool ``[B, S/P]``, split the same way. Returns this rank's block
    ``[B, S/P, H, D]`` f32.

    The blocks travel as the JAX ``ppermute`` moves them: each step sends to rank r + 1 and
    receives from rank r - 1, so rank r meets the key blocks r, r - 1, ..., r + 1, in the JAX
    order. P - 1 rotations and P folds; the next block's transfer is issued before the current
    fold, into a second set of buffers, so the two overlap."""
    group, n, nxt, prv = _ring(mesh, axis)
    qh = q.transpose(1, 2)
    o, m, l = init_state(qh)
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    # the key mask travels as bytes: NCCL and gloo do not treat bool alike
    blocks = (k.contiguous(), v.contiguous(), mask.to(torch.uint8).contiguous())
    for step in range(n):
        pending = []
        if step < n - 1:
            incoming = tuple(torch.empty_like(t) for t in blocks)
            ops = [dist.P2POp(dist.isend, t, nxt, group, tag) for tag, t in enumerate(blocks)]
            ops += [dist.P2POp(dist.irecv, t, prv, group, tag) for tag, t in enumerate(incoming)]
            pending = dist.batch_isend_irecv(ops)
        kb, vb, mb = blocks
        ring_block_attention(qh, kb.transpose(1, 2), vb.transpose(1, 2), mb, o, m, l, scale,
                             out=out.transpose(1, 2) if step == n - 1 else None)
        for req in pending:
            req.wait()
        if pending:
            blocks = incoming
    return out


def ring_encoder_block(x: torch.Tensor, mask: torch.Tensor, layer: dict, cfg: EmbedderConfig,
                       mesh: Any, axis: str) -> torch.Tensor:
    """One encoder block with sequence-parallel attention, the long-context variant of
    ``models/embedder.py::_block`` (the same params). x: this rank's block ``[B, S/P, dim]``."""
    dt = cfg.dtype
    b, s, d = x.shape
    h = _layernorm(x, layer["ln1_scale"], layer["ln1_bias"])
    q, k, v = (t.reshape(b, s, cfg.n_heads, cfg.head_dim)
               for t in (h @ layer["qkv"].to(dt)).split(cfg.dim, dim=-1))
    att = ring_attention(q, k, v, mask, mesh, axis, scale=1.0 / float(cfg.head_dim) ** 0.5)
    x = x + att.reshape(b, s, d).to(dt) @ layer["proj"].to(dt)
    h = _layernorm(x, layer["ln2_scale"], layer["ln2_bias"])
    h = F.gelu(h @ layer["mlp_in"].to(dt), approximate="tanh")
    return x + h @ layer["mlp_out"].to(dt)


def embed_tokens_long(params: dict, token_ids: torch.Tensor, cfg: EmbedderConfig, mesh: Any,
                      axis: str = "data") -> torch.Tensor:
    """Long-context embedding forward, the sequence split over ``axis``.

    token_ids: int ``[B, S]`` (0 = pad), the whole batch on every rank, S divisible by the axis
    size; this rank embeds its slice. Positions wrap modulo the position table for S beyond
    ``cfg.max_len``. The masked mean pool sums over the whole sequence (an all-reduce of the sums
    and the counts), then L2-normalises. Returns f32 ``[B, dim]`` on every rank. The preln
    architecture only, as in the JAX package."""
    if cfg.arch != "preln":
        raise ValueError(f"embed_tokens_long: the preln architecture only, got {cfg.arch!r}")
    group, n, _, _ = _ring(mesh, axis)
    rank = dist.get_rank(group)
    dev = params["tok_emb"].device
    if mesh.device_type != dev.type:
        raise ValueError(f"embed_tokens_long: mesh on {mesh.device_type!r}, params on {dev.type!r}")
    token_ids = token_ids.to(dev).long()
    S = token_ids.shape[1]
    if S % n:
        raise ValueError(f"embed_tokens_long: S={S} does not split over {n} ranks")
    s = S // n
    ids = token_ids[:, rank * s : (rank + 1) * s]
    mask = ids > 0
    pos = torch.arange(rank * s, (rank + 1) * s, device=dev) % params["pos_emb"].shape[0]
    dt = cfg.dtype
    x = F.embedding(ids, params["tok_emb"]).to(dt) + params["pos_emb"][pos].to(dt)[None, :, :]
    for layer in params["layers"]:
        x = ring_encoder_block(x, mask, layer, cfg, mesh, axis)
    x = _layernorm(x, params["ln_f_scale"], params["ln_f_bias"])
    m = mask[:, :, None].float()
    total = torch.cat([(x.float() * m).sum(1), m.sum(1)], dim=1)  # [B, dim + 1]: sums, count
    dist.all_reduce(total, group=group)
    pooled = total[:, :-1] / total[:, -1:].clamp_min(1.0)
    return pooled / torch.linalg.vector_norm(pooled, dim=-1, keepdim=True).clamp_min(1e-9)
