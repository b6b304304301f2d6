"""Default full-text document index (reference
``stdlib/indexing/full_text_document_index.py``). Copy of
``pathway_tpu/stdlib/indexing/full_text_document_index.py``."""

from __future__ import annotations

from ...internals.expression import ColumnExpression, ColumnReference
from ...internals.table import Table
from .bm25 import TantivyBM25
from .data_index import DataIndex

__all__ = ["default_full_text_document_index"]


def default_full_text_document_index(
    data_column: ColumnReference,
    data_table: Table,
    *,
    metadata_column: ColumnExpression | None = None,
) -> DataIndex:
    inner = TantivyBM25(
        data_column=data_column,
        metadata_column=metadata_column,
    )
    return DataIndex(data_table, inner)
