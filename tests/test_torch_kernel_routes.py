"""The host side of the kernels' routes, on the CPU: the route limits the wrappers use match the
constants the CUDA sources choose by, and the ring wrapper's layout rule for its tensor-core
route (16-byte rows) copies exactly the bf16 layouts that the kernel cannot read."""

from __future__ import annotations

import re
from pathlib import Path

import pytest
import torch

from pathway_tpu_torch.ops import attention, ring
from pathway_tpu_torch.parallel import exchange

CSRC = Path(attention.__file__).resolve().parent.parent / "csrc"


@pytest.mark.parametrize("source,constant,value", [
    ("masked_attention.cu", "kTmaMaxSeq", attention.PERSISTENT_MAX_SEQ),
    ("masked_attention_bwd.cu", "kFusedMaxSeq", attention.FUSED_BWD_MAX_SEQ),
    ("bucket_exchange.cu", "kTileRows", exchange.TILE_ROWS),
    ("bucket_exchange.cu", "kMaxDst", exchange.MAX_SHARDS),
])
def test_route_limits_match_the_kernel_sources(source, constant, value):
    found = re.search(rf"constexpr int {constant} = (\d+);", (CSRC / source).read_text())
    assert found and int(found.group(1)) == value


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
