"""``pw.indexing`` — live KNN / BM25 / hybrid indexes and sortedness
(reference ``python/pathway/stdlib/indexing``). Copy of
``pathway_tpu/stdlib/indexing``. The KNN scoring path runs on the card, through
the fused score + top-k kernel (``ops/knn.py``, ``ops/index_engines.py``) and
the encoder for text, replacing the reference's native USearch/Tantivy
integrations (``src/external_integration/``); BM25, LSH and the hybrid's
fusion are host code, as in the JAX package. An index's engine is built when
``pw.run(device=...)`` lowers the graph, on that device."""

from __future__ import annotations

from .bm25 import BM25, TantivyBM25, TantivyBM25Factory
from .data_index import DataIndex, InnerIndex, InnerIndexFactory
from .full_text_document_index import default_full_text_document_index
from .hybrid_index import HybridIndex, HybridIndexFactory
from .nearest_neighbors import (
    BruteForceKnn,
    BruteForceKnnFactory,
    BruteForceKnnMetricKind,
    LshKnn,
    LshKnnFactory,
    USearchKnn,
    USearchMetricKind,
    UsearchKnnFactory,
)
from .retrievers import AbstractRetrieverFactory
from .sorting import (
    SortedIndex,
    build_sorted_index,
    retrieve_prev_next_values,
    sort_from_index,
)
from .vector_document_index import (
    default_brute_force_knn_document_index,
    default_lsh_knn_document_index,
    default_usearch_knn_document_index,
    default_vector_document_index,
)

__all__ = [
    "AbstractRetrieverFactory",
    "DataIndex",
    "InnerIndex",
    "InnerIndexFactory",
    "USearchKnn",
    "UsearchKnnFactory",
    "USearchMetricKind",
    "BruteForceKnn",
    "BruteForceKnnFactory",
    "BruteForceKnnMetricKind",
    "LshKnn",
    "LshKnnFactory",
    "TantivyBM25",
    "TantivyBM25Factory",
    "BM25",
    "HybridIndex",
    "HybridIndexFactory",
    "SortedIndex",
    "default_vector_document_index",
    "default_lsh_knn_document_index",
    "default_usearch_knn_document_index",
    "default_brute_force_knn_document_index",
    "default_full_text_document_index",
    "retrieve_prev_next_values",
    "sort_from_index",
    "build_sorted_index",
]
