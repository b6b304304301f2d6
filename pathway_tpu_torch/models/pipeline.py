"""The training step on one device: port of ``pathway_tpu/models/pipeline.py``.

One tick of the north-star pipeline with learning: embed a batch of token pairs, take the
symmetric InfoNCE loss and its gradient through the whole encoder, update the f32 master weights
by SGD, write the batch's embeddings into the index, and search it with queries embedded by the
updated weights. The reference jits this over a 2-D (data, model) mesh; the port runs it on one
device. ``param_shardings`` (the tensor-parallel layout), the mesh and the all-gather of
``sharded_knn_search`` are not ported yet (ROADMAP.md, Queue 1 item 10).

The device work goes through the port's kernels: masked attention forward and backward
(``ops.attention``), the fused InfoNCE loss and gradient (``ops.infonce``) and the fused score +
top-k (``ops.knn``). The logits' product, the encoder's matmuls and elementwise passes and the SGD
update are PyTorch ops, as XLA left them outside any kernel of the JAX package's own.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator

import numpy as np
import torch

from .._device import resolve_device
from ..ops.infonce import infonce
from ..ops.knn import topk_scores
from .embedder import EmbedderConfig, embed_tokens, init_params

__all__ = ["TAU", "value_and_grad", "make_step", "run_one_step"]

#: the InfoNCE temperature of the reference's loss
TAU = 0.07


def _leaves(tree: Any) -> Iterator[torch.Tensor]:
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _rebuild(tree: Any, leaves: Iterator[torch.Tensor]) -> Any:
    """``tree``'s structure with its leaves taken in order from ``leaves``."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_rebuild(v, leaves) for v in tree]
    return next(leaves)


def value_and_grad(params: dict, tokens_a: torch.Tensor, tokens_b: torch.Tensor,
                   cfg: EmbedderConfig) -> tuple[torch.Tensor, torch.Tensor, dict]:
    """``jax.value_and_grad(loss_fn, has_aux=True)`` of the reference: (the symmetric InfoNCE
    loss at temperature ``TAU`` of the two views' embeddings, the embeddings of ``tokens_a``, the
    gradient of the loss as a tree shaped like ``params``), all detached. Each view is embedded
    on its own, as ``loss_fn`` does."""
    live = [p.detach().requires_grad_() for p in _leaves(params)]
    with torch.enable_grad():
        tracked = _rebuild(params, iter(live))
        ea = embed_tokens(tracked, tokens_a, cfg)
        eb = embed_tokens(tracked, tokens_b, cfg)
        loss = infonce((ea @ eb.T) / TAU)
        grads = torch.autograd.grad(loss, live)
    return loss.detach(), ea.detach(), _rebuild(params, iter(grads))


def make_step(cfg: EmbedderConfig, k: int = 4, lr: float = 1e-3, *,
              device: str | torch.device = "cuda") -> Callable:
    """The full step on ``device``: ``step(params, tokens, tokens_aug, index, insert_at, queries)
    -> (params, index, loss, scores, ids)``, with the reference's semantics.

    - The gradient comes from :func:`value_and_grad`; the update is ``p - lr * g`` over the
      f32 master weights, into new tensors (the caller's ``params`` are left as they were).
    - The rows inserted are the embeddings of ``tokens`` from the loss, taken before the update,
      cast to ``index.dtype``. They go in at ``insert_at`` clamped as ``dynamic_update_slice``
      clamps it, to ``[0, capacity - batch]``. The index is updated in place (the reference
      donates it) and returned.
    - The queries are embedded with the updated parameters and searched over every row of the
      index with no valid mask, so zero rows are candidates at score 0, as
      ``sharded_knn_search`` on a one-shard mesh returns them.

    Raises ``ValueError`` for k larger than the index's rows, as the reference does per shard."""
    dev = resolve_device(device)

    def step(params: dict, tokens, tokens_aug, index: torch.Tensor, insert_at, queries):
        tokens, tokens_aug, queries = (torch.as_tensor(t, device=dev)
                                       for t in (tokens, tokens_aug, queries))
        rows, n = index.shape[0], tokens.shape[0]
        if k > rows:
            raise ValueError(
                f"k={k} exceeds rows per shard ({rows}); raise index capacity or lower k"
            )
        if n > rows:
            raise ValueError(f"a batch of {n} rows does not fit an index of {rows}")
        loss, emb, grads = value_and_grad(params, tokens, tokens_aug, cfg)
        updated = torch._foreach_add(
            [p.detach() for p in _leaves(params)], list(_leaves(grads)), alpha=-lr
        )
        new_params = _rebuild(params, iter(updated))
        start = min(max(int(insert_at), 0), rows - n)
        with torch.no_grad():
            index[start : start + n] = emb.to(index.dtype)
            qe = embed_tokens(new_params, queries, cfg)
            scores, ids = topk_scores(qe, index, k)
        return new_params, index, loss, scores, ids

    return step


def run_one_step(cfg: EmbedderConfig | None = None, batch: int = 8, seq: int = 16, k: int = 2,
                 *, device: str | torch.device = "cuda"):
    """Build the reference's tiny inputs from numpy's seed 0 and run one full step: (loss,
    scores ``[4, k]``, ids ``[4, k]``). The weights are :func:`init_params` of seed 0, which
    differ from the JAX package's for the same seed."""
    dev = resolve_device(device)
    cfg = cfg or EmbedderConfig(vocab_size=1024, dim=64, n_layers=2, n_heads=4, max_len=seq)
    capacity = max(4 * batch, 8)
    params = init_params(cfg, 0, device=dev)
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(1, cfg.vocab_size, (batch, seq)), dtype=torch.int32)
    tokens_aug = torch.where(tokens % 7 == 0, 1, tokens)
    index = torch.zeros((capacity, cfg.dim), dtype=torch.float32, device=dev)
    queries = torch.as_tensor(rng.integers(1, cfg.vocab_size, (4, seq)), dtype=torch.int32)
    step = make_step(cfg, k=k, device=dev)
    _, _, loss, scores, ids = step(params, tokens, tokens_aug, index, 0, queries)
    return float(loss), scores.cpu().numpy(), ids.cpu().numpy()
