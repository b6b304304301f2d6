"""Standard library (reference ``pathway_tpu/stdlib``). Ported so far: ``indexing`` (KNN, BM25,
hybrid and sorted indexes); ``temporal`` (windows, the interval, window and as-of joins and their
behaviours); ``ordered`` (``diff``), ``statistical`` (``interpolate``) and ``stateful``
(``deduplicate``); ``utils`` (column helpers, ``argmax_rows``/``argmin_rows``, the async and
pandas transformers); ``graphs`` (PageRank, Bellman-Ford, Louvain); ``ml`` (``KNNIndex``, the kNN
classifiers, the HMM reducer, the fuzzy joins); and ``_sorted``, the sorted-group transform behind
``Table.sort``, ``diff`` and ``interpolate``. ``viz`` waits for a later slice (ROADMAP, Queue 1
item 5(e))."""

from . import graphs, indexing, ml, ordered, stateful, statistical, temporal, utils

__all__ = ["graphs", "indexing", "ml", "ordered", "stateful", "statistical", "temporal", "utils"]
