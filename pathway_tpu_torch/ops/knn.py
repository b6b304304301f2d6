"""Brute-force KNN on the card: port of ``pathway_tpu/ops/knn.py``.

``topk_scores`` scores queries against the whole index and keeps the best k per query. On CUDA
tensors it launches the hand-written kernel ``csrc/knn_topk.cu``, which fuses the scoring with the
top-k and never builds the ``[queries, rows]`` score matrix; on CPU tensors it runs the plain
version, which computes the same function step by step.

``sharded_knn_search`` is the index split by rows over a ``torch.distributed`` mesh axis: each
rank scores its rows with that kernel, the ranks all-gather their candidates, and
``topk_merge`` (kernel ``csrc/topk_merge.cu``, or its plain version on CPU tensors) keeps the
global top k in ``lax.top_k``'s order. ``ShardedKnnIndex`` holds the index on one device, or
with ``mesh=`` one shard of it on each rank.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Any, Iterable, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .. import _kernels
from .._device import resolve_device

__all__ = [
    "topk_scores", "topk_scores_plain", "knn_search", "ShardedKnnIndex", "merge_shard_topk",
    "sharded_knn_search", "topk_merge", "topk_merge_plain", "MAX_K", "MAX_DIM",
    "MAX_CANDIDATES",
]

#: largest k the kernel keeps per query: its per-query lists live in shared memory, and longer
#: ones would need another selection algorithm
MAX_K = 1024
#: columns of its queries the kernel keeps in shared memory at once; a wider index is walked in
#: chunks of this width (kQW in csrc/knn_topk.cu)
MAX_DIM = 1024
#: candidates per query the merge kernel sorts in shared memory (kMaxCandidates in
#: csrc/topk_merge.cu): 8 shards of ``MAX_K``
MAX_CANDIDATES = 8192
_ROWS_PER_TILE = 64  # kR in csrc/knn_topk.cu
_BLOCKS_PER_SM = 4


def _merge_topk(
    parts: Iterable[Sequence[tuple[Any, float]]], k: int
) -> list[tuple[Any, float]]:
    """Copy of ``pathway_tpu/serve/merge.py::merge_topk``.

    Merge per-shard (key, score) candidate lists into a global best-first top-k. Scores compare
    higher-is-better. Duplicate keys keep their best score only."""
    best: dict[Any, float] = {}
    for part in parts:
        for key, score in part:
            prev = best.get(key)
            if prev is None or score > prev:
                best[key] = score
    ranked = sorted(best.items(), key=lambda kv: (-kv[1], kv[0]))
    return [(key, score) for key, score in ranked[:k]]


def merge_shard_topk(
    parts: "list[list[tuple[Any, float]]]", k: int
) -> "list[tuple[Any, float]]":
    """Merge per-shard best-first (key, score) candidate lists into a global top-k on the host
    (scores compare higher-is-better; duplicate keys keep their best score)."""
    return _merge_topk(parts, k)


def topk_scores_plain(
    queries: torch.Tensor,
    index: torch.Tensor,
    k: int,
    metric: str = "cos",
    valid: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """queries ``[q, d]``, index ``[n, d]`` -> (scores f32 ``[q, k]``, ids int64 ``[q, k]``).

    cos / ip: the dot product of the bf16-rounded vectors, itself rounded to bf16 (JAX's
    bf16 @ bf16 is bf16) before the cast to f32. l2: ``-((|q|^2 - 2 dot) + |i|^2)``, the norms
    in f32. Rows where ``valid`` is False score -inf. The order is that of ``lax.top_k``: higher
    score first, the lower row first among equal scores (a stable descending sort)."""
    qb = queries.to(torch.bfloat16)
    ib = index.to(torch.bfloat16)
    dots = (qb @ ib.T).float()
    if metric in ("cos", "ip"):
        scores = dots
    else:
        sq_i = (index.float() ** 2).sum(-1)
        sq_q = (queries.float() ** 2).sum(-1, keepdim=True)
        scores = -(sq_q - 2 * dots + sq_i[None, :])
    if valid is not None:
        scores = torch.where(valid[None, :], scores, -math.inf)
    s, i = torch.sort(scores, dim=1, descending=True, stable=True)
    return s[:, :k], i[:, :k]


@functools.cache
def _launcher():
    lib = _kernels.load("knn_topk")
    fn = lib.knn_topk
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def plan(n_queries: int, n_rows: int, k: int, sm_count: int) -> tuple[int, int, int]:
    """The kernel's launch shape: (query chunk of pass 1, number of row ranges, tiles of 64 rows
    per range). Large k or few queries take chunks of 16 queries, so the per-query lists fit in
    shared memory; the row ranges give about ``_BLOCKS_PER_SM`` blocks per SM."""
    qc = 64 if (k <= 128 and n_queries > 16) else 16
    tiles = -(-n_rows // _ROWS_PER_TILE)
    chunks = -(-n_queries // qc)
    ranges = max(1, min(tiles, _BLOCKS_PER_SM * sm_count // chunks))
    tiles_per_range = -(-tiles // ranges)
    return qc, -(-tiles // tiles_per_range), tiles_per_range


def topk_scores(
    queries: torch.Tensor,
    index: torch.Tensor,
    k: int,
    metric: str = "cos",
    valid: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Best k rows of ``index`` per query, as :func:`topk_scores_plain` computes them.

    On CUDA tensors it launches the fused score + top-k kernel (rows of any width, cast to f32,
    and 1 <= k <= min(n, ``MAX_K``)); on CPU tensors it runs the plain version."""
    if queries.device.type == "cpu":
        return topk_scores_plain(queries, index, k, metric, valid)
    if queries.device.type != "cuda":
        raise ValueError(f"topk_scores: no kernel for device {queries.device}")
    queries = queries.to(torch.float32).contiguous()
    index = index.to(torch.float32).contiguous()
    (Q, d), (N, d_index) = queries.shape, index.shape
    if d != d_index or index.device != queries.device:
        raise ValueError("topk_scores: queries and index differ in width or device")
    if not 1 <= k <= min(N, MAX_K):
        raise ValueError(f"topk_scores: kernel takes 1 <= k <= min(rows, {MAX_K}), got k={k}")
    if d < 1:
        raise ValueError("topk_scores: kernel takes widths of at least 1")
    if valid is not None:
        if valid.dtype != torch.bool or valid.shape != (N,) or valid.device != queries.device:
            raise ValueError("topk_scores: valid must be bool [n] on the device of the queries")
        valid = valid.contiguous()
    dev = queries.device
    if Q == 0:
        return (torch.empty((0, k), dtype=torch.float32, device=dev),
                torch.empty((0, k), dtype=torch.int64, device=dev))
    if index.data_ptr() % 16:  # the kernel reads rows 16 bytes at a time
        index = index.clone()
    sm_count = torch.cuda.get_device_properties(queries.device).multi_processor_count
    qc, ranges, tiles_per_range = plan(Q, N, k, sm_count)
    cand_s = torch.empty((Q, ranges, k), dtype=torch.float32, device=dev)
    cand_i = torch.empty((Q, ranges, k), dtype=torch.int32, device=dev)
    out_s = torch.empty((Q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((Q, k), dtype=torch.int64, device=dev)
    err = _launcher()(
        queries.data_ptr(), index.data_ptr(), None if valid is None else valid.data_ptr(),
        cand_s.data_ptr(), cand_i.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
        Q, N, d, k, 0 if metric in ("cos", "ip") else 1, qc, ranges, tiles_per_range,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _kernels.check(err, "knn_topk")
    topk_scores.launches += 1
    return out_s, out_i


topk_scores.launches = 0


def knn_search(queries: np.ndarray, index: np.ndarray, k: int, metric: str = "cos",
               *, device: str | torch.device = "cuda"):
    """numpy in, numpy out: (scores ``[q, k]``, ids ``[q, k]``)."""
    dev = resolve_device(device)
    s, i = topk_scores(
        torch.as_tensor(np.asarray(queries, np.float32), device=dev),
        torch.as_tensor(np.asarray(index, np.float32), device=dev), k, metric,
    )
    return s.cpu().numpy(), i.cpu().numpy()


def topk_merge_plain(scores: torch.Tensor, ids: torch.Tensor,
                     k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """scores f32 ``[q, m]``, ids int64 ``[q, m]`` -> the k best (scores, ids) per row in
    ``lax.top_k``'s order: higher score first, the lower position first among equal scores (a
    stable descending sort)."""
    s, pos = torch.sort(scores, dim=1, descending=True, stable=True)
    return s[:, :k], torch.gather(ids, 1, pos[:, :k])


@functools.cache
def _merge_launcher():
    fn = _kernels.load("topk_merge").topk_merge
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    return fn


def topk_merge(scores: torch.Tensor, ids: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The top k of gathered candidates, as :func:`topk_merge_plain` computes them.

    On CUDA tensors (f32 scores and int64 ids ``[q, m]``, 1 <= k <= m <= ``MAX_CANDIDATES``) one
    launch of the merge kernel does it; on CPU tensors it runs the plain version."""
    if scores.device.type == "cpu":
        return topk_merge_plain(scores, ids, k)
    if scores.device.type != "cuda":
        raise ValueError(f"topk_merge: no kernel for device {scores.device}")
    if (scores.dtype != torch.float32 or ids.dtype != torch.int64 or scores.dim() != 2
            or ids.shape != scores.shape or ids.device != scores.device):
        raise ValueError("topk_merge: kernel takes f32 scores and int64 ids of one shape [q, m] "
                         "on one device")
    Q, M = scores.shape
    if not 1 <= k <= M <= MAX_CANDIDATES:
        raise ValueError(f"topk_merge: kernel takes 1 <= k <= m <= {MAX_CANDIDATES}, got k={k}, "
                         f"m={M}")
    out_s = torch.empty((Q, k), dtype=torch.float32, device=scores.device)
    out_i = torch.empty((Q, k), dtype=torch.int64, device=scores.device)
    if Q == 0:
        return out_s, out_i
    scores, ids = scores.contiguous(), ids.contiguous()
    err = _merge_launcher()(
        scores.data_ptr(), ids.data_ptr(), Q, M, k, out_s.data_ptr(), out_i.data_ptr(),
        torch.cuda.current_stream(scores.device).cuda_stream,
    )
    _kernels.check(err, "topk_merge")
    topk_merge.launches += 1
    return out_s, out_i


topk_merge.launches = 0

# torch 2.13 deprecates all_gather_into_tensor (a FutureWarning at each call) for all_gather_single,
# the same collective under a new name, which earlier releases do not have
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def sharded_knn_search(
    mesh: Any,
    axis: str,
    queries: torch.Tensor,
    index_sharded: torch.Tensor,
    k: int,
    metric: str = "cos",
    valid_sharded: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Port of ``pathway_tpu/ops/knn.py::sharded_knn_search``: the index rows split over the
    mesh axis ``axis`` (a ``torch.distributed.device_mesh.DeviceMesh``), the queries the same on
    every rank.

    Torch has no global sharded array: ``index_sharded`` ``[rows_per_shard, d]`` and
    ``valid_sharded`` ``[rows_per_shard]`` are this rank's rows, rank r holding the global rows
    ``[r * rows_per_shard, (r + 1) * rows_per_shard)``. Each rank takes its local top k with
    :func:`topk_scores`, shifts the ids to global rows, all-gathers scores and ids over the axis
    and keeps the global top k with :func:`topk_merge`. Every rank returns the same (scores f32
    ``[q, k]``, global ids int64 ``[q, k]``). k must be at most the rows per shard."""
    group = mesh.get_group(axis)
    n_shards, rank = dist.get_world_size(group), dist.get_rank(group)
    rows_per_shard = index_sharded.shape[0]
    if k > rows_per_shard:
        raise ValueError(
            f"k={k} exceeds rows per shard ({rows_per_shard}); "
            "raise index capacity or lower k"
        )
    s, i = topk_scores(queries, index_sharded, k, metric, valid=valid_sharded)
    i = i + rank * rows_per_shard
    q = s.shape[0]
    all_s = torch.empty((n_shards * q, k), dtype=s.dtype, device=s.device)
    all_i = torch.empty((n_shards * q, k), dtype=i.dtype, device=i.device)
    _all_gather(all_s, s.contiguous(), group=group)
    _all_gather(all_i, i.contiguous(), group=group)
    # [P, q, k] -> [q, P * k]: shard-major within each query's row, as the JAX all_gather(axis=1)
    all_s = all_s.view(n_shards, q, k).transpose(0, 1).reshape(q, n_shards * k)
    all_i = all_i.view(n_shards, q, k).transpose(0, 1).reshape(q, n_shards * k)
    return topk_merge(all_s, all_i, k)


class ShardedKnnIndex:
    """Device-resident brute-force index with insert/query (host API).

    Capacity-padded: rows beyond ``size`` are masked by a -inf score through a validity column.
    On one device by default. With ``mesh=`` (a ``DeviceMesh`` whose ``device_type`` is that of
    ``device``) rank r of the axis keeps the rows ``[r * capacity / P, (r + 1) * capacity / P)``
    and their validity column; every rank is given the same calls (``add`` takes the whole batch
    and writes the part in its range) and returns the same answers, through
    :func:`sharded_knn_search`."""

    def __init__(
        self,
        dim: int,
        capacity: int = 1 << 20,
        metric: str = "cos",
        mesh: Any = None,
        axis: str = "data",
        *,
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        self.dim = dim
        self.capacity = capacity
        self.metric = metric
        self.mesh = mesh
        self.axis = axis
        self.size = 0
        self._lo, rows = 0, capacity  # the global rows this process holds: [lo, lo + rows)
        if mesh is not None:
            if mesh.device_type != self.device.type:
                raise ValueError(f"ShardedKnnIndex: mesh on {mesh.device_type!r}, index on "
                                 f"{self.device.type!r}")
            group = mesh.get_group(axis)
            n_shards = dist.get_world_size(group)
            if capacity % n_shards:
                raise ValueError(f"capacity {capacity} does not split over {n_shards} shards")
            rows = capacity // n_shards
            self._lo = dist.get_rank(group) * rows
        self._data = torch.zeros((rows, dim), dtype=torch.float32, device=self.device)
        self._valid_d = torch.zeros((rows,), dtype=torch.bool, device=self.device)
        self._keys: list[Any] = []

    def add(self, vectors: np.ndarray, keys: list[Any] | None = None) -> None:
        n = len(vectors)
        if self.size + n > self.capacity:
            raise ValueError("index capacity exceeded")
        # the part of the global rows [size, size + n) that falls in [lo, lo + rows)
        lo = max(self.size, self._lo)
        hi = min(self.size + n, self._lo + self._data.shape[0])
        if lo < hi:
            self._data[lo - self._lo : hi - self._lo] = torch.as_tensor(
                np.asarray(vectors[lo - self.size : hi - self.size], np.float32),
                device=self.device,
            )
            self._valid_d[lo - self._lo : hi - self._lo] = True
        self._keys.extend(keys if keys is not None else range(self.size, self.size + n))
        self.size += n

    def query(self, queries: np.ndarray, k: int):
        k_eff = min(k, max(self.size, 1))
        q = torch.as_tensor(np.asarray(queries, np.float32), device=self.device)
        if self.mesh is not None:
            # the sharded merge needs k candidates from every shard
            k_eff = min(k_eff, self._data.shape[0])
            s, i = sharded_knn_search(self.mesh, self.axis, q, self._data, k_eff, self.metric,
                                      valid_sharded=self._valid_d)
        else:
            s, i = topk_scores(q, self._data, k_eff, self.metric, valid=self._valid_d)
        return s.cpu().numpy(), i.cpu().numpy()

    def keys_of(self, ids: np.ndarray):
        return [
            [self._keys[j] if 0 <= j < len(self._keys) else None for j in row]
            for row in ids
        ]
