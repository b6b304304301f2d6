"""Default vector document indexes (reference
``stdlib/indexing/vector_document_index.py:34-160``): convenience builders
producing a ``DataIndex`` with a KNN inner index over a text column, using an
embedder to map text → vectors. The embedder can be the encoder of
``models/embedder.py``, so the whole retrieve path (embed → score → top-k)
stays on the card. Copy of
``pathway_tpu/stdlib/indexing/vector_document_index.py``."""

from __future__ import annotations

from typing import Any

from ...internals.expression import ColumnExpression, ColumnReference
from ...internals.table import Table
from .data_index import DataIndex
from .bm25 import TantivyBM25
from .nearest_neighbors import BruteForceKnn, LshKnn, USearchKnn

__all__ = [
    "default_vector_document_index",
    "default_brute_force_knn_document_index",
    "default_lsh_knn_document_index",
    "default_usearch_knn_document_index",
]


def _as_callable(embedder: Any):
    """Accept a pw.UDF or a plain callable as the text→vector embedder."""
    if embedder is None:
        return None
    for attr in ("func", "__wrapped__"):
        f = getattr(embedder, attr, None)
        if callable(f):
            return f
    if callable(embedder):
        return embedder
    raise TypeError(f"embedder must be callable or a UDF, got {type(embedder)}")


def default_vector_document_index(
    data_column: ColumnReference,
    data_table: Table,
    *,
    dimensions: int,
    embedder: Any | None = None,
    metadata_column: ColumnExpression | None = None,
) -> DataIndex:
    """An arbitrary good-default vector index (reference picks LSH; the JAX
    package and this port pick the exact brute-force kernel)."""
    return default_brute_force_knn_document_index(
        data_column,
        data_table,
        dimensions=dimensions,
        embedder=embedder,
        metadata_column=metadata_column,
    )


def default_brute_force_knn_document_index(
    data_column: ColumnReference,
    data_table: Table,
    *,
    dimensions: int,
    embedder: Any | None = None,
    metadata_column: ColumnExpression | None = None,
) -> DataIndex:
    inner = BruteForceKnn(
        data_column=data_column,
        metadata_column=metadata_column,
        dimensions=dimensions,
        reserved_space=1024,
        embedder=_as_callable(embedder),
    )
    return DataIndex(data_table, inner)


def default_lsh_knn_document_index(
    data_column: ColumnReference,
    data_table: Table,
    *,
    dimensions: int,
    embedder: Any | None = None,
    metadata_column: ColumnExpression | None = None,
) -> DataIndex:
    inner = LshKnn(
        data_column=data_column,
        metadata_column=metadata_column,
        dimensions=dimensions,
        reserved_space=1024,
        embedder=_as_callable(embedder),
    )
    return DataIndex(data_table, inner)


def default_usearch_knn_document_index(
    data_column: ColumnReference,
    data_table: Table,
    dimensions: int,
    *,
    embedder: Any | None = None,
    metadata_column: ColumnExpression | None = None,
) -> DataIndex:
    inner = USearchKnn(
        data_column=data_column,
        metadata_column=metadata_column,
        dimensions=dimensions,
        reserved_space=1024,
        embedder=_as_callable(embedder),
    )
    return DataIndex(data_table, inner)
