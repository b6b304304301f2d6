"""Standard library (reference ``pathway_tpu/stdlib``). Ported so far: ``indexing`` (KNN, BM25,
hybrid and sorted indexes) and ``_sorted``, the sorted-group transform behind ``Table.sort``; the
rest waits for later slices (ROADMAP, Queue 1 item 5(e))."""

from . import indexing

__all__ = ["indexing"]
