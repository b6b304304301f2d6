"""Hybrid index — reciprocal-rank fusion over inner indexes
(reference ``stdlib/indexing/hybrid_index.py``). Copy of
``pathway_tpu/stdlib/indexing/hybrid_index.py``; the sub-engines are built on
the run's device."""

from __future__ import annotations

from dataclasses import dataclass, field

from ...internals.expression import ColumnExpression, ColumnReference
from ...ops.index_engines import HybridEngine
from .data_index import InnerIndex, InnerIndexFactory

__all__ = ["HybridIndex", "HybridIndexFactory"]


@dataclass(kw_only=True)
class HybridIndex(InnerIndex):
    """Fuses the rankings of several inner indexes with reciprocal rank
    fusion: score(doc) = Σ_i 1 / (k + rank_i(doc))."""

    inner_indexes: list[InnerIndex] = field(default_factory=list)
    k: int = 60

    def __post_init__(self):
        if not self.inner_indexes:
            raise ValueError("HybridIndex needs at least one inner index")

    def _make_engine(self, device):
        return HybridEngine(
            [ix._make_engine(device) for ix in self.inner_indexes], rrf_k=self.k
        )


@dataclass
class HybridIndexFactory(InnerIndexFactory):
    retriever_factories: list[InnerIndexFactory]
    k: int = 60

    def build_inner_index(
        self,
        data_column: ColumnReference,
        metadata_column: ColumnExpression | None = None,
    ) -> InnerIndex:
        inner = [
            f.build_inner_index(data_column, metadata_column)
            for f in self.retriever_factories
        ]
        return HybridIndex(
            data_column=data_column,
            metadata_column=metadata_column,
            inner_indexes=inner,
            k=self.k,
        )
