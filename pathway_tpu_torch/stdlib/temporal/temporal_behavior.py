"""Temporal behaviors (reference ``temporal_behavior.py:21-99``).

- ``common_behavior(delay, cutoff, keep_results)``: delay buffers window
  updates until the watermark reaches window_start + delay; cutoff ignores
  updates arriving after window_end + cutoff; keep_results=False frees and
  retracts a window's contribution once it is past its cutoff.
- ``exactly_once_behavior(shift)``: each window emits exactly one output, at
  window_end + shift (buffer-to-close + ignore-late).

Copy of ``pathway_tpu/stdlib/temporal/temporal_behavior.py``, over the port's Table API and engine nodes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

__all__ = [
    "CommonBehavior",
    "ExactlyOnceBehavior",
    "common_behavior",
    "exactly_once_behavior",
]


@dataclass(frozen=True)
class CommonBehavior:
    delay: Any = None
    cutoff: Any = None
    keep_results: bool = True


@dataclass(frozen=True)
class ExactlyOnceBehavior:
    shift: Any = None


def common_behavior(
    delay: Any = None, cutoff: Any = None, keep_results: bool = True
) -> CommonBehavior:
    return CommonBehavior(delay=delay, cutoff=cutoff, keep_results=keep_results)


def exactly_once_behavior(shift: Any = None) -> ExactlyOnceBehavior:
    return ExactlyOnceBehavior(shift=shift)
