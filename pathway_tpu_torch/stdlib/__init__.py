"""Standard library (reference ``pathway_tpu/stdlib``). Ported so far: ``indexing`` (KNN, BM25,
hybrid and sorted indexes); ``temporal`` (windows, the interval, window and as-of joins and their
behaviours); ``ordered`` (``diff``), ``statistical`` (``interpolate``) and ``stateful``
(``deduplicate``); and ``_sorted``, the sorted-group transform behind ``Table.sort``, ``diff``
and ``interpolate``. The rest waits for later slices (ROADMAP, Queue 1 item 5(e))."""

from . import indexing, ordered, stateful, statistical, temporal

__all__ = ["indexing", "ordered", "stateful", "statistical", "temporal"]
