"""Custom reducer accumulators (reference ``internals/custom_reducers.py``).

Copy of ``pathway_tpu/internals/custom_reducers.py``: the accumulator base
class the engine's ``CustomAccumulatorReducer`` folds; the Table API's
reducer factories are left out.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any


class BaseCustomAccumulator(ABC):
    """Subclass with ``from_row``, ``update`` (mutating), ``compute_result``,
    and optionally ``retract`` to support deletions
    (reference custom_reducers.py:271)."""

    @classmethod
    @abstractmethod
    def from_row(cls, row: list) -> "BaseCustomAccumulator": ...

    @abstractmethod
    def update(self, other: "BaseCustomAccumulator") -> None: ...

    def retract(self, other: "BaseCustomAccumulator") -> None:
        raise NotImplementedError(
            f"{type(self).__name__} does not support retractions; "
            "override retract() to handle deletions"
        )

    @abstractmethod
    def compute_result(self) -> Any: ...

