"""Brute-force KNN on the card: port of ``pathway_tpu/ops/knn.py``.

``topk_scores`` scores queries against the whole index and keeps the best k per query. On CUDA
tensors it launches the hand-written kernel ``csrc/knn_topk.cu``, which fuses the scoring with the
top-k and never builds the ``[queries, rows]`` score matrix; on CPU tensors it runs the plain
version, which computes the same function step by step. The kernel has two routes, chosen by
shape alone (:func:`plan`): the stream route (k <= ``STREAM_MAX_K``, d <= ``STREAM_MAX_DIM`` and
a multiple of 4: every launch of the main paths), a persistent grid of one block an SM fed by
TMA; and the tile route for the rest, the kernel of the first versions.

``sharded_knn_search`` is the index split by rows over a ``torch.distributed`` mesh axis: each
rank scores its rows with that kernel, the ranks all-gather their candidates, and
``topk_merge_shards`` (kernel ``csrc/topk_merge.cu``, or its plain version on CPU tensors) keeps
the global top k in ``lax.top_k``'s order, reading the gathered buffers as they land.

Every entry takes k as ``lax.top_k`` does: k = 0 gives ``[q, 0]`` without a launch, and a k below
0 or above the candidates raises ``ValueError`` on every device. ``ShardedKnnIndex`` holds the
index on one device, or with ``mesh=`` one shard of it on each rank.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from .. import _kernels
from .._device import resolve_device

__all__ = [
    "topk_scores", "topk_scores_plain", "knn_search", "ShardedKnnIndex", "merge_shard_topk",
    "sharded_knn_search", "topk_merge", "topk_merge_plain", "topk_merge_shards",
    "topk_merge_shards_plain", "MAX_K", "MAX_DIM", "MAX_CANDIDATES", "STREAM_MAX_K",
    "STREAM_MAX_DIM", "Plan", "plan", "shared_memory_bytes", "blocks_per_sm",
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
#: largest k of the stream route (kStreamMaxK in csrc/knn_topk.cu): each of its warps keeps a list
#: of k entries for each of the 64 queries of its block in shared memory
STREAM_MAX_K = 16
#: widest index of the stream route (kStreamMaxDim): its queries fit in shared memory beside the
#: ring of index tiles. The route also takes only widths divisible by 4 (16-byte rows for TMA).
STREAM_MAX_DIM = 384

# the layouts of csrc/knn_topk.cu, for the launch plan (tests/test_torch_kernel_routes.py holds
# each against the source)
_ROWS_PER_TILE = 64  # kR: the tile route's rows a tile
_TILE_THREADS = 256  # kThreads
_TILE_MIN_BLOCKS = 2  # kTileMinBlocks: the blocks an SM its registers are bounded for
_TILE_DK = 128  # kDK: its columns a load step
_TILE_XS = 136  # kXS: its padded bf16 tile row
_STREAM_QC = 64  # kStreamQC: queries a block of the stream route
_STREAM_ROWS = 128  # kStreamRows: rows a stage, the stride of a block's walk
_STREAM_COLS = 64  # kStreamCols: f32 columns a stage
_STREAM_STAGES = 4  # kStreamStages
_STREAM_CONSUMERS = 4  # kStreamConsumers: consumer warps, and one producer warp
_STREAM_QPAD = 8  # kQPad
_STREAM_STAGING = 256  # kStaging
_STREAM_GROUPS = 32  # kGroups: the group maxima a query the blocks share
#: an SM's shared memory and what the card keeps of it for each block (H100: 228 KB, 1 KB)
_SMEM_PER_SM = 233472
_SMEM_PER_BLOCK_RESERVED = 1024
_THREADS_PER_SM = 2048


def _check_k(name: str, k: int, n: int) -> None:
    """Refuse k as ``lax.top_k`` does: below 0, or above the ``n`` values along the axis."""
    if k < 0:
        raise ValueError(f"{name}: k argument to top_k must be nonnegative, got {k}")
    if k > n:
        raise ValueError(f"{name}: k argument to top_k must be no larger than size along axis; "
                         f"got k={k} with {n} candidates")


def merge_shard_topk(
    parts: "list[list[tuple[Any, float]]]", k: int
) -> "list[tuple[Any, float]]":
    """Merge per-shard best-first (key, score) candidate lists into a global top-k on the host
    (scores compare higher-is-better; duplicate keys keep their best score): the serve plane's
    ``serve/merge.py::merge_topk``, as in the JAX package."""
    from ..serve.merge import merge_topk

    return merge_topk(parts, k)


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
    score first, the lower row first among equal scores (a stable descending sort). k as
    ``lax.top_k`` takes it: 0 <= k <= n."""
    _check_k("topk_scores", k, index.shape[0])
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


@functools.cache
def _stream_launcher():
    fn = _kernels.load("knn_topk").knn_topk_stream
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _device_limits(index: int) -> tuple[int, int]:
    """(SMs, shared memory bytes a SM) of card ``index``, read once."""
    props = torch.cuda.get_device_properties(index)
    return props.multi_processor_count, props.shared_memory_per_multiprocessor


def _align16(n: int) -> int:
    return (n + 15) & ~15


def shared_memory_bytes(route: str, qc: int, d: int, k: int) -> int:
    """The dynamic shared memory a block of pass 1 asks for, as ``csrc/knn_topk.cu`` lays it out
    (``stream_layout`` and ``layout``; ``knn_topk_smem_bytes`` there returns the same)."""
    if route == "stream":
        dpad = -(-d // _STREAM_COLS) * _STREAM_COLS
        at = _STREAM_STAGES * _STREAM_ROWS * _STREAM_COLS * 4  # the ring
        at = _align16(at + 2 * _STREAM_QC * (dpad + _STREAM_QPAD))  # bf16 queries
        at = _align16(at + 4 * _STREAM_QC)  # |q|^2
        at = _align16(at + 4 * _STREAM_CONSUMERS * _STREAM_QC * k)  # each warp's list scores
        at = _align16(at + 4 * _STREAM_CONSUMERS * _STREAM_QC * k)  # and rows
        at = _align16(at + 8 * _STREAM_QC)  # the block's thresholds
        at = _align16(at + 8 * _STREAM_STAGING * _STREAM_CONSUMERS)  # staging
        at = _align16(at + 8 * 2 * _STREAM_STAGES)  # mbarriers
        return at + 128  # aligning the base
    dpad = -(-d // _TILE_DK) * _TILE_DK
    qw = min(dpad, MAX_DIM)
    at = _align16(2 * qc * (qw + 8))  # bf16 queries
    at = _align16(at + 2 * _ROWS_PER_TILE * _TILE_XS)  # bf16 tile
    at = _align16(at + 4 * qc)  # |q|^2
    at = _align16(at + 4 * _ROWS_PER_TILE)  # |x|^2
    at = _align16(at + 4 * qc * _ROWS_PER_TILE)  # scores
    at = _align16(at + 4 * qc * k)  # list scores
    return _align16(at + 4 * qc * k)  # list rows


def blocks_per_sm(route: str, qc: int, d: int, k: int, smem_per_sm: int = _SMEM_PER_SM) -> int:
    """Blocks of pass 1 that one SM holds at once by their shared memory and threads, and for
    the tile route no more than its launch bounds leave registers for (on the card,
    ``knn_topk_blocks_per_sm`` asks the occupancy API, which counts the registers used)."""
    smem = shared_memory_bytes(route, qc, d, k) + _SMEM_PER_BLOCK_RESERVED
    if route == "stream":
        return max(1, min(smem_per_sm // smem, _THREADS_PER_SM // ((_STREAM_CONSUMERS + 1) * 32)))
    return max(1, min(smem_per_sm // smem, _THREADS_PER_SM // _TILE_THREADS, _TILE_MIN_BLOCKS))


class Plan(NamedTuple):
    """The kernel's launch shape: the route, the query chunk, the blocks a chunk (the stream
    route's persistent grid, or the tile route's row ranges), the tile route's 64-row tiles a
    range (0 on the stream route), and the blocks an SM holds."""

    route: str
    qc: int
    grid: int
    tiles_per_range: int
    blocks_per_sm: int


def plan(n_queries: int, n_rows: int, d: int, k: int, sm_count: int,
         smem_per_sm: int = _SMEM_PER_SM) -> Plan:
    """The route and launch shape of ``topk_scores`` on a card of ``sm_count`` SMs with
    ``smem_per_sm`` bytes of shared memory each, from the shape alone. k <= ``STREAM_MAX_K`` and
    d <= ``STREAM_MAX_DIM``, divisible by 4, take the stream route: chunks of 64 queries, and a
    persistent grid of as many blocks as the SMs hold at once, each walking 128-row tiles with a
    stride of the grid. The rest take the tile route: chunks of 64 queries, or of 16 where k is
    large or the queries few (the lists fit in shared memory), and row ranges of 64-row tiles, as
    many as the SMs hold at once. Either way the blocks of all chunks go in one wave, unless the
    chunks alone outnumber what the SMs hold."""
    if k <= STREAM_MAX_K and d <= STREAM_MAX_DIM and d % 4 == 0:
        per_sm = blocks_per_sm("stream", _STREAM_QC, d, k, smem_per_sm)
        tiles = -(-n_rows // _STREAM_ROWS)
        chunks = -(-n_queries // _STREAM_QC)
        grid = max(1, min(tiles, per_sm * sm_count // chunks))
        return Plan("stream", _STREAM_QC, grid, 0, per_sm)
    qc = 64 if (k <= 128 and n_queries > 16) else 16
    per_sm = blocks_per_sm("tile", qc, d, k, smem_per_sm)
    tiles = -(-n_rows // _ROWS_PER_TILE)
    chunks = -(-n_queries // qc)
    ranges = max(1, min(tiles, per_sm * sm_count // chunks))
    tiles_per_range = -(-tiles // ranges)
    return Plan("tile", qc, -(-tiles // tiles_per_range), tiles_per_range, per_sm)


def topk_scores(
    queries: torch.Tensor,
    index: torch.Tensor,
    k: int,
    metric: str = "cos",
    valid: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Best k rows of ``index`` per query, as :func:`topk_scores_plain` computes them.

    On CUDA tensors it launches the fused score + top-k kernel on the route :func:`plan` gives
    the shape (rows of any width, cast to f32, and k <= ``MAX_K``); on CPU tensors it runs the
    plain version. On every device k = 0 gives ``[q, 0]`` without a launch and k above the rows
    raises, as ``lax.top_k`` does."""
    _check_k("topk_scores", k, index.shape[0])
    if k == 0:
        return (torch.empty((queries.shape[0], 0), dtype=torch.float32, device=queries.device),
                torch.empty((queries.shape[0], 0), dtype=torch.int64, device=queries.device))
    if queries.device.type == "cpu":
        return topk_scores_plain(queries, index, k, metric, valid)
    if queries.device.type != "cuda":
        raise ValueError(f"topk_scores: no kernel for device {queries.device}")
    queries = queries.to(torch.float32).contiguous()
    index = index.to(torch.float32).contiguous()
    (Q, d), (N, d_index) = queries.shape, index.shape
    if d != d_index or index.device != queries.device:
        raise ValueError("topk_scores: queries and index differ in width or device")
    if k > MAX_K:
        raise ValueError(f"topk_scores: kernel takes k <= {MAX_K}, got k={k}")
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
    p = plan(Q, N, d, k, *_device_limits(
        torch.cuda.current_device() if dev.index is None else dev.index))
    lists = p.grid * (_STREAM_CONSUMERS if p.route == "stream" else 1)  # lists a query
    cand_s = torch.empty((Q, lists, k), dtype=torch.float32, device=dev)
    cand_i = torch.empty((Q, lists, k), dtype=torch.int32, device=dev)
    out_s = torch.empty((Q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((Q, k), dtype=torch.int64, device=dev)
    ptrs = (queries.data_ptr(), index.data_ptr(), None if valid is None else valid.data_ptr())
    outs = (cand_s.data_ptr(), cand_i.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
            Q, N, d, k, 0 if metric in ("cos", "ip") else 1)
    if p.route == "stream":
        # what the blocks share per query: a threshold, a count of candidates, group maxima
        shared = torch.zeros((Q * (2 + _STREAM_GROUPS),), dtype=torch.int64, device=dev)
        err = _stream_launcher()(*ptrs, shared.data_ptr(), *outs, p.grid, _kernels.stream(dev))
    else:
        err = _launcher()(*ptrs, *outs, p.qc, p.grid, p.tiles_per_range, _kernels.stream(dev))
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
    stable descending sort). k as ``lax.top_k`` takes it: 0 <= k <= m."""
    _check_k("topk_merge", k, scores.shape[1])
    s, pos = torch.sort(scores, dim=1, descending=True, stable=True)
    return s[:, :k], torch.gather(ids, 1, pos[:, :k])


def topk_merge_shards_plain(scores: torch.Tensor, ids: torch.Tensor, k: int,
                            rows_per_shard: int) -> tuple[torch.Tensor, torch.Tensor]:
    """scores f32 ``[P, q, kk]`` and local ids int64 ``[P, q, kk]``, shard-major as the all-gather
    of the shards' lists lands -> the k best of each query's ``P * kk`` candidates, as the JAX
    search merges them (``pathway_tpu/ops/knn.py:121-126``): shard p's ids shifted by
    ``p * rows_per_shard``, the rows gathered shard-major, then ``lax.top_k``."""
    P, q, kk = scores.shape
    shift = torch.arange(P, dtype=ids.dtype, device=ids.device).view(P, 1, 1) * rows_per_shard
    return topk_merge_plain(scores.transpose(0, 1).reshape(q, P * kk),
                            (ids + shift).transpose(0, 1).reshape(q, P * kk), k)


@functools.cache
def _merge_launcher():
    fn = _kernels.load("topk_merge").topk_merge_shards
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_longlong] + [
        ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    return fn


def topk_merge(scores: torch.Tensor, ids: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The top k of gathered candidates, as :func:`topk_merge_plain` computes them.

    Scores f32 and ids int64 ``[q, m]``: the candidates of one shard, so
    :func:`topk_merge_shards` with P = 1 and no id shift. On CUDA tensors (k <= m <=
    ``MAX_CANDIDATES``) that is one launch of the merge kernel; on CPU tensors the plain
    version. k = 0 gives ``[q, 0]`` without a launch, and k above m raises, on every device."""
    if scores.dim() != 2:
        raise ValueError("topk_merge: scores and ids must be [q, m]")
    return topk_merge_shards(scores[None], ids[None], k, 0)


def topk_merge_shards(scores: torch.Tensor, ids: torch.Tensor, k: int,
                      rows_per_shard: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The global top k of the shards' gathered lists, as :func:`topk_merge_shards_plain`
    computes it: scores f32 and local ids int64 ``[P, q, kk]``, shard-major as the all-gather
    lands them, ids shifted by ``shard * rows_per_shard``.

    On CUDA tensors (``P * kk <= MAX_CANDIDATES``) one launch of the merge kernel reads the
    buffers where they lie, with no copy before it; on CPU tensors it runs the plain version.
    It counts its launches in ``topk_merge.launches`` (the same kernel). k = 0 gives ``[q, 0]``
    without a launch, and k above ``P * kk`` raises, on every device."""
    if scores.dim() != 3:
        raise ValueError("topk_merge_shards: scores and ids must be [P, q, kk]")
    P, Q, KK = scores.shape
    _check_k("topk_merge_shards", k, P * KK)
    if scores.device.type == "cpu":
        return topk_merge_shards_plain(scores, ids, k, rows_per_shard)
    if scores.device.type != "cuda":
        raise ValueError(f"topk_merge_shards: no kernel for device {scores.device}")
    if (scores.dtype != torch.float32 or ids.dtype != torch.int64 or ids.shape != scores.shape
            or ids.device != scores.device):
        raise ValueError("topk_merge_shards: kernel takes f32 scores and int64 ids of one shape "
                         "on one device")
    if P * KK > MAX_CANDIDATES:
        raise ValueError(f"topk_merge_shards: kernel takes P * kk <= {MAX_CANDIDATES}, got "
                         f"{P} x {KK}")
    scores = scores if scores.is_contiguous() else scores.contiguous()
    ids = ids if ids.is_contiguous() else ids.contiguous()
    out_s = torch.empty((Q, k), dtype=torch.float32, device=scores.device)
    out_i = torch.empty((Q, k), dtype=torch.int64, device=scores.device)
    if Q == 0 or k == 0:
        return out_s, out_i
    err = _merge_launcher()(
        scores.data_ptr(), ids.data_ptr(), P, Q, KK, k, rows_per_shard, out_s.data_ptr(),
        out_i.data_ptr(), _kernels.stream(scores.device),
    )
    _kernels.check(err, "topk_merge_shards")
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
    :func:`topk_scores`, all-gathers scores and local ids over the axis and keeps the global top
    k with :func:`topk_merge_shards`, which shifts the ids to global rows as it reads the gathered
    buffers. Every rank returns the same (scores f32 ``[q, k]``, global ids int64 ``[q, k]``).
    k must be at most the rows per shard; k = 0 gives ``[q, 0]`` with no collective."""
    group = mesh.get_group(axis)
    n_shards = dist.get_world_size(group)
    rows_per_shard = index_sharded.shape[0]
    if k > rows_per_shard:
        raise ValueError(
            f"k={k} exceeds rows per shard ({rows_per_shard}); "
            "raise index capacity or lower k"
        )
    s, i = topk_scores(queries, index_sharded, k, metric, valid=valid_sharded)
    if k == 0:  # every rank takes this branch: k is the same on all of them
        return s, i
    q = s.shape[0]
    # [P * q, k]: rank p's [q, k] block at p, shard-major as the JAX all_gather(axis=1) reads
    all_s = torch.empty((n_shards * q, k), dtype=s.dtype, device=s.device)
    all_i = torch.empty((n_shards * q, k), dtype=i.dtype, device=i.device)
    _all_gather(all_s, s, group=group)
    _all_gather(all_i, i, group=group)
    return topk_merge_shards(all_s.view(n_shards, q, k), all_i.view(n_shards, q, k), k,
                             rows_per_shard)


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
