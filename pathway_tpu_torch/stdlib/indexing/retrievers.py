"""Retriever factory surface (reference ``stdlib/indexing/retrievers.py``).
Copy of ``pathway_tpu/stdlib/indexing/retrievers.py``."""

from __future__ import annotations

from .data_index import InnerIndexFactory

__all__ = ["AbstractRetrieverFactory", "InnerIndexFactory"]

# the reference exposes the factory protocol under this name for xpack configs
AbstractRetrieverFactory = InnerIndexFactory
