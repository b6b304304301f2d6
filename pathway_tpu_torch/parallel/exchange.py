"""Record exchange by key: the bucketed all-to-all of the engine's mesh exchange.

The reference exchanges records between timely workers through channel allocators; keys route by
their low bits (``value.rs:38``). The JAX package (``pathway_tpu/parallel/exchange.py``) does the
same routing as a bucketed all-to-all inside ``shard_map``: rows are counted per destination
shard, padded to a static per-shard capacity, and swapped with ``lax.all_to_all``. Here the
bucketing is a hand-written kernel, ``bucket_exchange`` (``csrc/bucket_exchange.cu``), with its
plain PyTorch version beside it, and the swap is either a layout (every source block on one
device) or ``torch.distributed``'s ``all_to_all_single`` (one rank per device).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from .. import _kernels
from .._device import resolve_device
from ..engine import keys as K

__all__ = [
    "shard_rows", "bucketed_all_to_all", "bucket_exchange", "bucket_exchange_plain",
    "MAX_SHARDS",
]

#: destinations the kernel buckets in shared memory (kMaxDst in csrc/bucket_exchange.cu)
MAX_SHARDS = 32
#: source rows a block of the kernel takes (kTileRows), and the grid's other limits
TILE_ROWS = 1024
MAX_SOURCES = 65535
MAX_WORDS = (1 << 21) - 1


def shard_rows(keys: np.ndarray, n_shards: int) -> np.ndarray:
    """Destination shard per row (low key bits, reference SHARD_MASK)."""
    return K.shard_of(keys, n_shards)


def bucket_exchange_plain(
    values: torch.Tensor, dest: torch.Tensor, n_dst: int, cap_bucket: int, *,
    return_counts: bool = False,
) -> tuple[torch.Tensor, ...]:
    """values ``[n_src, cap_in, w]``, dest int ``[n_src, cap_in]`` -> (out ``[n_dst, n_src *
    cap_bucket, w]`` of values' dtype, valid bool ``[n_dst, n_src * cap_bucket]``), and with
    ``return_counts`` also counts int32 ``[n_dst, n_src]``: the rows of each source kept in each
    destination's bucket, which fill its first slots.

    A row's slot is the running count of the earlier rows of its source block with the same
    destination (one_hot + cumsum, as ``exchange.py:55-58`` of the JAX package); rows with a
    destination outside ``[0, n_dst)`` or a slot past ``cap_bucket`` are dropped. Source ``s``'s
    rows for destination ``d`` land at ``out[d, s * cap_bucket + slot]``; every other slot is
    zero."""
    n_src, cap_in, w = values.shape
    d = dest.long()
    in_range = (d >= 0) & (d < n_dst)
    d_safe = torch.where(in_range, d, 0)
    one_hot = F.one_hot(d_safe, n_dst) * in_range[..., None]
    within = one_hot.cumsum(1) - 1
    pos = within.gather(2, d_safe[..., None]).squeeze(-1)
    ok = in_range & (pos < cap_bucket)
    slot = torch.arange(n_src, device=values.device)[:, None] * cap_bucket + pos
    out = torch.zeros((n_dst, n_src * cap_bucket, w), dtype=values.dtype, device=values.device)
    valid = torch.zeros((n_dst, n_src * cap_bucket), dtype=torch.bool, device=values.device)
    out.index_put_((d[ok], slot[ok]), values[ok])
    valid.index_put_((d[ok], slot[ok]), torch.ones((), dtype=torch.bool, device=values.device))
    if not return_counts:
        return out, valid
    return out, valid, valid.view(n_dst, n_src, cap_bucket).sum(-1, dtype=torch.int32)


@functools.cache
def _launcher():
    fn = _kernels.load("bucket_exchange").bucket_exchange
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 5
    fn.restype = ctypes.c_int
    return fn


def bucket_exchange(
    values: torch.Tensor, dest: torch.Tensor, n_dst: int, cap_bucket: int, *,
    return_counts: bool = False,
) -> tuple[torch.Tensor, ...]:
    """The buckets of :func:`bucket_exchange_plain` (and its counts with ``return_counts``).

    On CUDA tensors (int32 words ``[n_src, cap_in, w]`` and int32 destinations, ``n_dst`` at
    most ``MAX_SHARDS``) the bucketing kernel computes them, in two launches (the count pass and
    the scatter); on CPU tensors the plain version runs."""
    if values.device.type == "cpu":
        return bucket_exchange_plain(values, dest, n_dst, cap_bucket, return_counts=return_counts)
    if values.device.type != "cuda":
        raise ValueError(f"bucket_exchange: no kernel for device {values.device}")
    if (values.dtype != torch.int32 or dest.dtype != torch.int32 or values.dim() != 3
            or dest.shape != values.shape[:2] or dest.device != values.device):
        raise ValueError("bucket_exchange: kernel takes int32 words [n_src, cap_in, w] and int32 "
                         "destinations [n_src, cap_in] on one device")
    n_src, cap_in, w = values.shape
    if (not 1 <= n_dst <= MAX_SHARDS or cap_bucket < 1 or min(n_src, cap_in, w) < 1
            or n_src > MAX_SOURCES or w > MAX_WORDS):
        raise ValueError(f"bucket_exchange: kernel takes 1 <= n_dst <= {MAX_SHARDS}, "
                         f"cap_bucket >= 1, n_src <= {MAX_SOURCES}, w <= {MAX_WORDS} and no "
                         f"empty dimension, got n_dst={n_dst}, cap_bucket={cap_bucket}, shape "
                         f"{tuple(values.shape)}")
    values, dest = values.contiguous(), dest.contiguous()
    dev = values.device
    out = torch.empty((n_dst, n_src * cap_bucket, w), dtype=torch.int32, device=dev)
    valid = torch.empty((n_dst, n_src * cap_bucket), dtype=torch.bool, device=dev)
    # the counts [n_dst, n_src], then the count pass's scratch [n_src, tiles, n_dst]
    tiles = -(-cap_in // TILE_ROWS)
    ints = torch.empty(n_dst * n_src * (1 + tiles), dtype=torch.int32, device=dev)
    err = _launcher()(
        values.data_ptr(), dest.data_ptr(), n_src, cap_in, w, n_dst, cap_bucket,
        out.data_ptr(), valid.data_ptr(), ints.data_ptr(), ints.data_ptr() + 4 * n_dst * n_src,
        _kernels.stream(dev),
    )
    _kernels.check(err, "bucket_exchange")
    bucket_exchange.launches += 1
    if not return_counts:
        return out, valid
    return out, valid, ints[: n_dst * n_src].view(n_dst, n_src)


bucket_exchange.launches = 0


def _words(arr, device: torch.device) -> torch.Tensor:
    """uint32 or int32 words (numpy or torch) as an int32 tensor on ``device``: the same bits."""
    if isinstance(arr, np.ndarray):
        arr = torch.from_numpy(np.ascontiguousarray(arr).view(np.int32))
    elif arr.dtype == torch.uint32:
        arr = arr.view(torch.int32)
    return arr.to(device)


def bucketed_all_to_all(
    values, dest, n_shards: int, cap_out: int, *, group=None,
    device: str | torch.device = "cuda",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exchange rows to their destination shards (``cap_out`` = ``n_shards * cap_bucket``, the
    JAX function's per-device output capacity).

    Without ``group``, every source block lives on ``device``: ``values`` is ``[n_shards *
    cap_in, w]`` words (uint32 or int32, numpy or torch; block ``s`` is source shard ``s``'s
    rows) and ``dest`` ``[n_shards * cap_in]`` (-1 = empty). Returns (words int32 ``[n_shards,
    cap_out, w]``, valid bool ``[n_shards, cap_out]``): block ``d`` is what device ``d`` holds
    after the JAX function's ``all_to_all``, its arrivals source-major.

    With ``group`` (a ``torch.distributed`` group of ``n_shards`` ranks), ``values`` ``[cap_in,
    w]`` and ``dest`` ``[cap_in]`` are this rank's rows; the rank buckets them and
    ``all_to_all_single`` swaps the buckets. Returns this rank's arrivals (``[cap_out, w]``,
    ``[cap_out]``), the JAX function's device block of this rank."""
    dev = resolve_device(device)
    v = _words(values, dev)
    dst = _words(dest, dev)
    w = v.shape[-1]
    if cap_out % n_shards:
        raise ValueError(f"cap_out {cap_out} is not a multiple of {n_shards} shards")
    cap_bucket = cap_out // n_shards
    if group is None:
        return bucket_exchange(v.reshape(n_shards, -1, w), dst.reshape(n_shards, -1), n_shards,
                               cap_bucket)
    if dist.get_world_size(group) != n_shards:
        raise ValueError("bucketed_all_to_all: the group's size must be n_shards")
    buckets, valid = bucket_exchange(v.reshape(1, -1, w), dst.reshape(1, -1), n_shards,
                                     cap_bucket)
    recv = torch.empty_like(buckets)
    recv_valid = torch.empty_like(valid)
    dist.all_to_all_single(recv, buckets, group=group)
    dist.all_to_all_single(recv_valid.view(torch.uint8), valid.view(torch.uint8), group=group)
    return recv.reshape(cap_out, w), recv_valid.reshape(cap_out)
