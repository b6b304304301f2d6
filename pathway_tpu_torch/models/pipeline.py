"""The training step: port of ``pathway_tpu/models/pipeline.py``.

One tick of the north-star pipeline with learning: embed a batch of token pairs, take the
symmetric InfoNCE loss and its gradient through the whole encoder, update the f32 master weights
by SGD, write the batch's embeddings into the index, and search it with queries embedded by the
updated weights. The reference jits this over a 2-D (data, model) mesh; the port runs it on one
device, or with ``make_step(..., mesh=data_model_mesh(n))`` over ``torch.distributed`` ranks:

- the token rows and the index rows are split over ``data``;
- the encoder's weights are split over ``model`` by :func:`param_shardings` (``qkv`` and
  ``mlp_in`` by columns, whole heads a rank; ``proj`` and ``mlp_out`` by rows; the rest whole),
  with the Megatron pair around each split product: an identity whose backward sums over
  ``model`` before a column-split product, and a sum over ``model`` after a row-split one;
- the loss spans the global batch, as the reference's ``ea @ eb.T`` does: each rank gathers both
  views' embeddings over ``data`` (the gather's backward keeps the rank's own rows, since every
  rank takes the same loss), and the weights' gradients are summed over ``data``;
- the search is ``sharded_knn_search`` over ``data``: the scorer on each rank's rows, an
  all-gather and the merge.

The device work goes through the port's kernels: masked attention forward and backward
(``ops.attention``), the fused InfoNCE loss and gradient (``ops.infonce``), the fused score +
top-k (``ops.knn``) and, on a mesh, the merge of the shards' candidates (``topk_merge``). The
encoder's matmuls and elementwise passes, the collectives and the SGD update are PyTorch ops, as
XLA left them outside any kernel of the JAX package's own.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator

import numpy as np
import torch
import torch.distributed as dist

from .._device import resolve_device
from ..ops.infonce import infonce
from ..ops.knn import _all_gather, sharded_knn_search, topk_scores
from .embedder import EmbedderConfig, embed_tokens, init_params

__all__ = [
    "TAU", "LAYOUT", "value_and_grad", "param_shardings", "gather_params", "make_step",
    "run_one_step",
]

#: the InfoNCE temperature of the reference's loss
TAU = 0.07

#: the tensor-parallel layout of a layer's weights (``pipeline.py:31-53``): ``qkv`` by columns,
#: heads ``[r H/m, (r+1) H/m)`` of each of q, k and v on rank r of ``model``; ``mlp_in`` by
#: columns; ``proj`` and ``mlp_out`` by rows. Every other weight is whole on every rank.
LAYOUT = {"qkv": "heads", "mlp_in": "cols", "proj": "rows", "mlp_out": "rows"}


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


# -- the mesh's axes ---------------------------------------------------------------------------


def _sum_over(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over the ranks of ``group``, in f32 and back to ``t``'s dtype (one rounding
    of the sum of the ranks' partial products)."""
    acc = t.to(torch.float32, copy=True)
    dist.all_reduce(acc, group=group)
    return acc.to(t.dtype)


class _EnterModel(torch.autograd.Function):
    """Before a column-split product: the identity, whose backward sums the ranks' partial
    gradients of its (whole) input over ``model``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_over(g, ctx.group), None


class _ExitModel(torch.autograd.Function):
    """After a row-split product: the sum of the ranks' partial products over ``model``, whose
    backward hands each rank the whole gradient."""

    @staticmethod
    def forward(ctx, y, group):
        return _sum_over(y, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ModelAxis:
    """The ``tp`` of ``embed_tokens``: the Megatron pair over one ``model`` group."""

    def __init__(self, group) -> None:
        self.group = group

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return _EnterModel.apply(x, self.group)

    def exit(self, y: torch.Tensor) -> torch.Tensor:
        return _ExitModel.apply(y, self.group)


class _GatherRows(torch.autograd.Function):
    """This rank's rows ``[n, ...]`` -> every rank's ``[size * n, ...]`` over ``data``, rank-major.
    Every rank takes the same loss of the gathered rows, so the gradient arriving here is the
    same on every rank, and its slice for this rank's rows is this rank's whole share: the
    backward keeps it (a sum over the ranks would count the loss ``size`` times)."""

    @staticmethod
    def forward(ctx, x, group, size, rank):
        ctx.rows, ctx.rank = x.shape[0], rank
        out = torch.empty((size * x.shape[0], *x.shape[1:]), dtype=x.dtype, device=x.device)
        _all_gather(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        n = ctx.rows
        return g[ctx.rank * n:(ctx.rank + 1) * n], None, None, None


class _Axes:
    """A (data, model) mesh as the step uses it: each axis' group, size and this rank's place."""

    def __init__(self, mesh) -> None:
        names = tuple(mesh.mesh_dim_names or ())
        if names != ("data", "model"):
            raise ValueError(f"make_step takes a (data, model) mesh (data_model_mesh), got axes "
                             f"{names}")
        self.mesh = mesh
        self.data, self.model = mesh.get_group("data"), mesh.get_group("model")
        self.n_data, self.n_model = mesh.size(0), mesh.size(1)
        self.d, self.m = mesh.get_local_rank("data"), mesh.get_local_rank("model")


def _check_layout(cfg: EmbedderConfig, n_model: int) -> None:
    """Refuse a config whose heads or MLP width the model axis does not divide."""
    if cfg.n_heads % n_model:
        raise ValueError(
            f"n_heads={cfg.n_heads} is not divisible by the model axis' {n_model} ranks: each "
            "rank takes whole heads of q, k and v"
        )
    if (cfg.dim * cfg.mlp_ratio) % n_model:
        raise ValueError(f"the MLP width {cfg.dim * cfg.mlp_ratio} is not divisible by the model "
                         f"axis' {n_model} ranks")


def _cut(name: str, t: torch.Tensor, n: int, r: int) -> torch.Tensor:
    kind = LAYOUT.get(name)
    if kind == "heads":
        return torch.cat([part.chunk(n, dim=1)[r] for part in t.chunk(3, dim=1)], dim=1)
    if kind == "cols":
        return t.chunk(n, dim=1)[r].contiguous()
    if kind == "rows":
        return t.chunk(n, dim=0)[r].contiguous()
    return t


def param_shardings(mesh, params: dict, cfg: EmbedderConfig) -> dict:
    """This rank's shard of the full tree ``params`` under :data:`LAYOUT`, over ``mesh``'s
    ``model`` axis (every rank of an axis ``data`` holds the same shard). The port of
    ``pipeline.py:31-53``: where the reference names a ``NamedSharding`` for each leaf and lets
    XLA place the collectives, the port cuts the leaf. Raises ``ValueError`` when ``model``'s
    size does not divide ``cfg.n_heads`` (or the MLP width)."""
    ax = _Axes(mesh)
    _check_layout(cfg, ax.n_model)
    out = {k: v for k, v in params.items() if k != "layers"}
    out["layers"] = [{k: _cut(k, v, ax.n_model, ax.m) for k, v in layer.items()}
                     for layer in params["layers"]]
    return out


def gather_params(mesh, shards: dict) -> dict:
    """The inverse of :func:`param_shardings`: the full tree, on every rank, gathered over
    ``model``."""
    ax = _Axes(mesh)

    def whole(name: str, t: torch.Tensor) -> torch.Tensor:
        kind = LAYOUT.get(name)
        if kind is None or ax.n_model == 1:
            return t
        parts = [torch.empty_like(t) for _ in range(ax.n_model)]
        dist.all_gather(parts, t.contiguous(), group=ax.model)
        if kind == "heads":
            return torch.cat([torch.cat([p.chunk(3, dim=1)[i] for p in parts], dim=1)
                              for i in range(3)], dim=1)
        return torch.cat(parts, dim=1 if kind == "cols" else 0)

    out = {k: v for k, v in shards.items() if k != "layers"}
    out["layers"] = [{k: whole(k, v) for k, v in layer.items()} for layer in shards["layers"]]
    return out


# -- the step ----------------------------------------------------------------------------------


def _value_and_grad(params: dict, tokens_a: torch.Tensor, tokens_b: torch.Tensor,
                    cfg: EmbedderConfig, ax: _Axes | None = None):
    live = [p.detach().requires_grad_() for p in _leaves(params)]
    tp = _ModelAxis(ax.model) if ax is not None and ax.n_model > 1 else None
    with torch.enable_grad():
        tracked = _rebuild(params, iter(live))
        ea = embed_tokens(tracked, tokens_a, cfg, tp=tp)
        eb = embed_tokens(tracked, tokens_b, cfg, tp=tp)
        if ax is not None and ax.n_data > 1:
            ea = _GatherRows.apply(ea, ax.data, ax.n_data, ax.d)
            eb = _GatherRows.apply(eb, ax.data, ax.n_data, ax.d)
        loss = infonce((ea @ eb.T) / TAU)
        grads = torch.autograd.grad(loss, live)
    if ax is not None and ax.n_data > 1:
        # each rank's gradients hold its rows' share of the global loss's: their sum is the
        # whole (one collective over the flattened tree)
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=ax.data)
        grads = [f.view_as(g) for f, g in zip(flat.split([g.numel() for g in grads]), grads)]
    return loss.detach(), ea.detach(), _rebuild(params, iter(grads))


def value_and_grad(params: dict, tokens_a: torch.Tensor, tokens_b: torch.Tensor,
                   cfg: EmbedderConfig) -> tuple[torch.Tensor, torch.Tensor, dict]:
    """``jax.value_and_grad(loss_fn, has_aux=True)`` of the reference: (the symmetric InfoNCE
    loss at temperature ``TAU`` of the two views' embeddings, the embeddings of ``tokens_a``, the
    gradient of the loss as a tree shaped like ``params``), all detached. Each view is embedded
    on its own, as ``loss_fn`` does."""
    return _value_and_grad(params, tokens_a, tokens_b, cfg)


def make_step(cfg: EmbedderConfig, k: int = 4, lr: float = 1e-3, *, mesh=None,
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
      ``sharded_knn_search`` returns them.

    With ``mesh`` (a ``data_model_mesh`` over the ranks of the default group) the arguments are
    this rank's parts, as ``sharded_knn_search`` takes them: ``params`` the rank's shard
    (:func:`param_shardings`), ``tokens`` and ``tokens_aug`` its rows of the global batch (data
    rank d holds rows ``[d * n, (d + 1) * n)``), ``index`` its rows of the global index; the
    queries are whole on every rank. The step returns the rank's updated shard and index rows,
    and the global loss, scores and ids, the same on every rank. ``insert_at`` is a global row:
    each rank writes the part of the gathered batch that falls in its rows.

    Raises ``ValueError`` for k larger than the index's rows (a shard's, on a mesh), as the
    reference does per shard, and on a mesh for heads the model axis does not divide."""
    dev = resolve_device(device)
    ax = None
    if mesh is not None:
        ax = _Axes(mesh)
        _check_layout(cfg, ax.n_model)

    def step(params: dict, tokens, tokens_aug, index: torch.Tensor, insert_at, queries):
        tokens, tokens_aug, queries = (torch.as_tensor(t, device=dev)
                                       for t in (tokens, tokens_aug, queries))
        rows, n = index.shape[0], tokens.shape[0]
        shards = 1 if ax is None else ax.n_data
        capacity, batch = rows * shards, n * shards
        if k > rows:
            raise ValueError(
                f"k={k} exceeds rows per shard ({rows}); raise index capacity or lower k"
            )
        if batch > capacity:
            raise ValueError(f"a batch of {batch} rows does not fit an index of {capacity}")
        loss, emb, grads = _value_and_grad(params, tokens, tokens_aug, cfg, ax)
        updated = torch._foreach_add(
            [p.detach() for p in _leaves(params)], list(_leaves(grads)), alpha=-lr
        )
        new_params = _rebuild(params, iter(updated))
        start = min(max(int(insert_at), 0), capacity - batch)
        first = 0 if ax is None else ax.d * rows  # this rank's first global row
        lo, hi = max(start, first), min(start + batch, first + rows)
        tp = _ModelAxis(ax.model) if ax is not None and ax.n_model > 1 else None
        with torch.no_grad():
            if lo < hi:
                index[lo - first:hi - first] = emb[lo - start:hi - start].to(index.dtype)
            qe = embed_tokens(new_params, queries, cfg, tp=tp)
            if ax is None:
                scores, ids = topk_scores(qe, index, k)
            else:
                scores, ids = sharded_knn_search(mesh, "data", qe, index, k)
        return new_params, index, loss, scores, ids

    return step


def run_one_step(cfg: EmbedderConfig | None = None, batch: int = 8, seq: int = 16, k: int = 2,
                 *, mesh=None, device: str | torch.device = "cuda"):
    """Build the reference's tiny inputs from numpy's seed 0 and run one full step: (loss,
    scores ``[4, k]``, ids ``[4, k]``). The weights are :func:`init_params` of seed 0, which
    differ from the JAX package's for the same seed. With ``mesh``, the batch and the capacity
    round to the data axis as the reference's do (``pipeline.py:95-122``), and each rank takes
    its shard and rows of them."""
    dev = resolve_device(device)
    cfg = cfg or EmbedderConfig(vocab_size=1024, dim=64, n_layers=2, n_heads=4, max_len=seq)
    shards = 1 if mesh is None else _Axes(mesh).n_data
    batch = max(batch, shards)
    batch -= batch % shards
    capacity = max(4 * batch, shards * 8)
    capacity -= capacity % shards
    params = init_params(cfg, 0, device=dev)
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(1, cfg.vocab_size, (batch, seq)), dtype=torch.int32)
    tokens_aug = torch.where(tokens % 7 == 0, 1, tokens)
    queries = torch.as_tensor(rng.integers(1, cfg.vocab_size, (4, seq)), dtype=torch.int32)
    if mesh is not None:
        ax = _Axes(mesh)
        params = param_shardings(mesh, params, cfg)
        mine = slice(ax.d * (batch // shards), (ax.d + 1) * (batch // shards))
        tokens, tokens_aug = tokens[mine], tokens_aug[mine]
    index = torch.zeros((capacity // shards, cfg.dim), dtype=torch.float32, device=dev)
    step = make_step(cfg, k=k, mesh=mesh, device=dev)
    _, _, loss, scores, ids = step(params, tokens, tokens_aug, index, 0, queries)
    return float(loss), scores.cpu().numpy(), ids.cpu().numpy()
