"""Standard library (reference ``pathway_tpu/stdlib``). Ported so far: ``indexing`` (KNN, BM25,
hybrid and sorted indexes); ``temporal`` (windows, the interval, window and as-of joins and their
behaviours); ``ordered`` (``diff``), ``statistical`` (``interpolate``) and ``stateful``
(``deduplicate``); ``utils`` (column helpers, ``argmax_rows``/``argmin_rows``, the async and
pandas transformers); ``graphs`` (PageRank, Bellman-Ford, Louvain); ``ml`` (``KNNIndex``, the kNN
classifiers, the HMM reducer, the fuzzy joins); ``viz`` (the live mirror behind ``Table.plot`` and
``Table.show``; its Bokeh and Panel render layer needs those packages); and ``_sorted``, the
sorted-group transform behind ``Table.sort``, ``diff`` and ``interpolate``."""

from . import graphs, indexing, ml, ordered, stateful, statistical, temporal, utils, viz

__all__ = ["graphs", "indexing", "ml", "ordered", "stateful", "statistical", "temporal", "utils",
           "viz"]
