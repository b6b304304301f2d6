"""BM25 full-text inner index (reference ``stdlib/indexing/bm25.py``).

The reference delegates to the Tantivy library
(``src/external_integration/tantivy_integration.rs``); here the inverted
index + Okapi BM25 scoring is the in-process host engine
``ops/index_engines.BM25Engine`` — text scoring is branchy and string-heavy,
so it stays on the host, as in the JAX package. Class names keep the reference
surface. Copy of ``pathway_tpu/stdlib/indexing/bm25.py``.
"""

from __future__ import annotations

from dataclasses import dataclass

from ...internals.expression import ColumnExpression, ColumnReference
from ...ops.index_engines import BM25Engine
from .data_index import InnerIndex, InnerIndexFactory

__all__ = ["TantivyBM25", "TantivyBM25Factory", "BM25"]


@dataclass(kw_only=True)
class TantivyBM25(InnerIndex):
    """BM25 ranking over ``data_column`` text (reference bm25.py:41)."""

    ram_budget: int = 50_000_000  # accepted for parity; in-memory engine
    in_memory_index: bool = True
    k1: float = 1.2
    b: float = 0.75

    def _make_engine(self, device):
        return BM25Engine(
            ram_budget=self.ram_budget,
            in_memory_index=self.in_memory_index,
            k1=self.k1,
            b=self.b,
        )


BM25 = TantivyBM25


@dataclass
class TantivyBM25Factory(InnerIndexFactory):
    ram_budget: int = 50_000_000
    in_memory_index: bool = True

    def build_inner_index(
        self,
        data_column: ColumnReference,
        metadata_column: ColumnExpression | None = None,
    ) -> InnerIndex:
        return TantivyBM25(
            data_column=data_column,
            metadata_column=metadata_column,
            ram_budget=self.ram_budget,
            in_memory_index=self.in_memory_index,
        )
