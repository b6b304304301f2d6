"""KNN inner indexes (reference ``stdlib/indexing/nearest_neighbors.py``).

``BruteForceKnn`` — exact KNN; the reference scores on CPU
(``brute_force_knn_integration.rs``), here scoring with top-k is the fused
kernel on the card (``ops/index_engines.BruteForceKnnEngine``, ``ops/knn.py``).
``USearchKnn`` — the reference wraps the USearch HNSW graph
(``usearch_integration.rs``); this class keeps the USearch API surface (metric
kinds, reserved space) over the same exact brute-force engine, as the JAX
package does.
``LshKnn`` — random-hyperplane LSH bucketing with exact scoring of the
candidate set on the host (reference ``LshKnn``; classic impl
``stdlib/ml/index.py``).

Copy of ``pathway_tpu/stdlib/indexing/nearest_neighbors.py``; each engine is
built on the device of the run that lowers it.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Callable

from ...internals.expression import ColumnExpression, ColumnReference
from ...ops.index_engines import BruteForceKnnEngine, LshKnnEngine
from .data_index import DataIndex, InnerIndex, InnerIndexFactory

__all__ = [
    "BruteForceKnnMetricKind",
    "USearchMetricKind",
    "BruteForceKnn",
    "BruteForceKnnFactory",
    "USearchKnn",
    "UsearchKnnFactory",
    "LshKnn",
    "LshKnnFactory",
]


class BruteForceKnnMetricKind(enum.Enum):
    """Metric for brute-force KNN (reference engine BruteForceKnnMetricKind)."""

    COS = "cos"
    L2SQ = "l2"


class USearchMetricKind(enum.Enum):
    """Metric kinds mirroring the USearch surface (reference USearchMetricKind)."""

    IP = "ip"  # raw inner product — inputs are NOT normalized
    COS = "cos"
    L2SQ = "l2"


def _metric_str(metric) -> str:
    return metric.value if isinstance(metric, enum.Enum) else str(metric)


@dataclass(kw_only=True)
class BruteForceKnn(InnerIndex):
    """Exact nearest neighbors over ``data_column`` vectors — the fused
    score + top-k kernel per query batch (reference nearest_neighbors.py:170)."""

    dimensions: int
    reserved_space: int = 1024
    metric: BruteForceKnnMetricKind | str = BruteForceKnnMetricKind.COS
    embedder: Callable | None = None

    def _make_engine(self, device):
        return BruteForceKnnEngine(
            self.dimensions,
            metric=_metric_str(self.metric),
            reserved_space=self.reserved_space,
            embedder=self.embedder,
            device=device,
        )


@dataclass(kw_only=True)
class USearchKnn(InnerIndex):
    """USearch-surface KNN (reference nearest_neighbors.py:65). Exact
    brute-force scoring stands in for the HNSW graph — see module docstring."""

    dimensions: int
    reserved_space: int = 1024
    metric: USearchMetricKind | str = USearchMetricKind.COS
    connectivity: int = 0  # accepted for API parity; no-op on the exact kernel
    expansion_add: int = 0
    expansion_search: int = 0
    embedder: Callable | None = None

    def _make_engine(self, device):
        return BruteForceKnnEngine(
            self.dimensions,
            metric=_metric_str(self.metric),
            reserved_space=self.reserved_space,
            embedder=self.embedder,
            device=device,
        )


@dataclass(kw_only=True)
class LshKnn(InnerIndex):
    """Locality-sensitive-hashing approximate KNN
    (reference nearest_neighbors.py:262)."""

    dimensions: int
    reserved_space: int = 1024
    metric: BruteForceKnnMetricKind | str = BruteForceKnnMetricKind.COS
    n_or: int = 4
    n_and: int = 8
    bucket_length: float = 10.0
    seed: int = 0
    embedder: Callable | None = None

    def _make_engine(self, device):
        return LshKnnEngine(
            self.dimensions,
            metric=_metric_str(self.metric),
            reserved_space=self.reserved_space,
            n_or=self.n_or,
            n_and=self.n_and,
            seed=self.seed,
            embedder=self.embedder,
            device=device,
        )


@dataclass
class BruteForceKnnFactory(InnerIndexFactory):
    dimensions: int
    reserved_space: int = 1024
    metric: BruteForceKnnMetricKind | str = BruteForceKnnMetricKind.COS
    embedder: Callable | None = None

    def build_inner_index(
        self,
        data_column: ColumnReference,
        metadata_column: ColumnExpression | None = None,
    ) -> InnerIndex:
        return BruteForceKnn(
            data_column=data_column,
            metadata_column=metadata_column,
            dimensions=self.dimensions,
            reserved_space=self.reserved_space,
            metric=self.metric,
            embedder=self.embedder,
        )


@dataclass
class UsearchKnnFactory(InnerIndexFactory):
    dimensions: int
    reserved_space: int = 1024
    metric: USearchMetricKind | str = USearchMetricKind.COS
    connectivity: int = 0
    expansion_add: int = 0
    expansion_search: int = 0
    embedder: Callable | None = None

    def build_inner_index(
        self,
        data_column: ColumnReference,
        metadata_column: ColumnExpression | None = None,
    ) -> InnerIndex:
        return USearchKnn(
            data_column=data_column,
            metadata_column=metadata_column,
            dimensions=self.dimensions,
            reserved_space=self.reserved_space,
            metric=self.metric,
            connectivity=self.connectivity,
            expansion_add=self.expansion_add,
            expansion_search=self.expansion_search,
            embedder=self.embedder,
        )


@dataclass
class LshKnnFactory(InnerIndexFactory):
    dimensions: int
    reserved_space: int = 1024
    metric: BruteForceKnnMetricKind | str = BruteForceKnnMetricKind.COS
    n_or: int = 4
    n_and: int = 8
    seed: int = 0
    embedder: Callable | None = None

    def build_inner_index(
        self,
        data_column: ColumnReference,
        metadata_column: ColumnExpression | None = None,
    ) -> InnerIndex:
        return LshKnn(
            data_column=data_column,
            metadata_column=metadata_column,
            dimensions=self.dimensions,
            reserved_space=self.reserved_space,
            metric=self.metric,
            n_or=self.n_or,
            n_and=self.n_and,
            seed=self.seed,
            embedder=self.embedder,
        )
