"""The host side of the kernels' routes, on the CPU: the route limits the wrappers use match the
constants the CUDA sources choose by, the scorer's launch plan (from the source's shared-memory
layout) puts every block of a launch on the SMs at once, and the ring wrapper's layout rule for
its tensor-core route (16-byte rows) copies exactly the bf16 layouts that the kernel cannot
read."""

from __future__ import annotations

import re
from pathlib import Path

import pytest
import torch

from pathway_tpu_torch.ops import attention, infonce, knn, ring
from pathway_tpu_torch.parallel import exchange

CSRC = Path(attention.__file__).resolve().parent.parent / "csrc"


@pytest.mark.parametrize("source,constant,value", [
    ("masked_attention.cu", "kTmaMaxSeq", attention.PERSISTENT_MAX_SEQ),
    ("masked_attention_bwd.cu", "kFusedMaxSeq", attention.FUSED_BWD_MAX_SEQ),
    ("bucket_exchange.cu", "kTileRows", exchange.TILE_ROWS),
    ("bucket_exchange.cu", "kMaxDst", exchange.MAX_SHARDS),
    ("knn_topk.cu", "kStreamMaxK", knn.STREAM_MAX_K),
    ("knn_topk.cu", "kStreamMaxDim", knn.STREAM_MAX_DIM),
    ("knn_topk.cu", "kQW", knn.MAX_DIM),
    ("infonce.cu", "kClusterMaxB", infonce.CLUSTER_MAX_B),
])
def test_route_limits_match_the_kernel_sources(source, constant, value):
    found = re.search(rf"constexpr int {constant} = (\d+);", (CSRC / source).read_text())
    assert found and int(found.group(1)) == value


@pytest.mark.parametrize("constant,value", [
    ("kR", knn._ROWS_PER_TILE), ("kThreads", knn._TILE_THREADS), ("kDK", knn._TILE_DK),
    ("kXS", knn._TILE_XS), ("kTileMinBlocks", knn._TILE_MIN_BLOCKS), ("kStreamQC", knn._STREAM_QC),
    ("kStreamRows", knn._STREAM_ROWS), ("kStreamCols", knn._STREAM_COLS),
    ("kStreamStages", knn._STREAM_STAGES), ("kStreamConsumers", knn._STREAM_CONSUMERS),
    ("kQPad", knn._STREAM_QPAD), ("kStaging", knn._STREAM_STAGING),
    ("kGroups", knn._STREAM_GROUPS),
])
def test_scorer_layout_constants_match_the_kernel_source(constant, value):
    """The constants ``ops/knn.py`` lays out the scorer's shared memory with, for the plan."""
    test_route_limits_match_the_kernel_sources("knn_topk.cu", constant, value)


SMS, SMEM_PER_SM = 132, 233472  # an H100: its SMs, and 228 KB of shared memory each


@pytest.mark.parametrize("Q,N,d,k", [
    (64, 1 << 20, 384, 10),  # the main paths' searches
    (64, 1 << 20, 384, knn.STREAM_MAX_K),
    (130, 1 << 20, 384, 10),
    (64, 1 << 20, 384, knn.STREAM_MAX_K + 1),
    (64, 1 << 20, 384, knn.MAX_K),
    (20, 1 << 20, 1030, knn.MAX_K),
    (1, 1000, 3, 10),
    (64, 1 << 20, knn.STREAM_MAX_DIM + 4, 10),
])
def test_scorer_plan_fits_one_wave(Q, N, d, k):
    """Every block of a launch is resident at once: the plan's blocks a SM fit the SM's shared
    memory at the source's layout (and 1 KB the card keeps for each block), and the grid over all
    query chunks is no more than that many blocks on every SM."""
    p = knn.plan(Q, N, d, k, SMS, SMEM_PER_SM)
    smem = knn.shared_memory_bytes(p.route, p.qc, d, k)
    assert smem <= 232448  # a block's most
    assert p.blocks_per_sm >= 1 and p.blocks_per_sm * (smem + 1024) <= SMEM_PER_SM
    assert p.grid * -(-Q // p.qc) <= p.blocks_per_sm * SMS
    rows = 128 if p.route == "stream" else 64 * p.tiles_per_range
    assert p.grid * rows >= N or p.route == "stream"  # the tile route's ranges cover every row
    assert p.route == ("stream" if k <= knn.STREAM_MAX_K and d <= knn.STREAM_MAX_DIM and d % 4 == 0
                       else "tile")


def test_scorer_plan_main_shape_is_one_persistent_block_an_sm():
    p = knn.plan(64, 1 << 20, 384, 10, SMS, SMEM_PER_SM)
    assert (p.route, p.grid, p.blocks_per_sm) == ("stream", SMS, 1)
    assert knn.shared_memory_bytes("stream", 64, 384, 10) == 210880
    # the tile route at MAX_K: one block of 16 queries a SM, 4 chunks of 33 blocks
    p = knn.plan(64, 1 << 20, 384, knn.MAX_K, SMS, SMEM_PER_SM)
    assert (p.route, p.qc, p.blocks_per_sm, p.grid) == ("tile", 16, 1, 33)


def test_infonce_cluster_route_holds_its_rows_in_shared_memory():
    """At the cluster route's limit a block's ceil(B / 8) rows of B f32 logits, and its column
    statistics, fit in a block's 227 KB."""
    B = infonce.CLUSTER_MAX_B
    rows = -(-B // 8) * B * 4
    assert rows + 3 * B * 4 <= 232448
    assert infonce.CLUSTER_MAX_B >= 256  # the training step's batch takes the cluster route


def _wide(shape, dtype, extra):
    """A view of the last dim of a wider tensor: rows ``extra`` values apart beyond the width."""
    *lead, d = shape
    return torch.randn((*lead, d + extra), generator=torch.Generator().manual_seed(d)).to(
        dtype)[..., :d]


@pytest.mark.parametrize("case", ["contiguous", "heads_view", "row_of_33", "offset_base"])
def test_ring_wrapper_copies_only_what_the_tensor_core_route_cannot_read(case):
    B, H, S, D = 2, 3, 40, 32
    if case == "contiguous":
        t, copied = torch.randn((B, H, S, D)).to(torch.bfloat16), False
    elif case == "heads_view":  # [B, S, H, D] seen as [B, H, S, D], as the long path passes it
        t, copied = torch.randn((B, S, H, D)).to(torch.bfloat16).transpose(1, 2), False
    elif case == "row_of_33":
        t, copied = _wide((B, H, S, D), torch.bfloat16, 1), True
    else:  # every stride a multiple of 8, the base 2 bytes past a 16-byte boundary
        t, copied = torch.randn((B, H, S, D + 8)).to(torch.bfloat16)[..., 1 : D + 1], True
    got = ring._aligned(t)
    assert (got is not t) == copied
    assert torch.equal(got, t)
    assert got.stride(-1) == 1 and all(st % 8 == 0 for st in got.stride()[:3])
    if copied:
        assert got.data_ptr() % 16 == 0


def test_ring_wrapper_leaves_f32_layouts_alone():
    """The CUDA-core route reads any strides: an f32 view is passed as it is."""
    t = _wide((2, 3, 40, 32), torch.float32, 1)
    assert ring._aligned(t) is t
