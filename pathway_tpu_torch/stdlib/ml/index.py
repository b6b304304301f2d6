"""``pw.ml.index.KNNIndex`` (reference
``python/pathway/stdlib/ml/index.py:9`` — the classic LSH-based KNN
surface). Wraps the KNN engines of ``stdlib/indexing``:
the distance math runs in the ``knn_topk`` kernel instead of the
reference's pure-python LSH bucket scans.

Copy of ``pathway_tpu/stdlib/ml/index.py``, over the port's Table API and engine nodes.
"""

from __future__ import annotations

from typing import Any

from ...internals.expression import ColumnExpression, ColumnReference
from ...internals.table import Table
from ..indexing.data_index import DataIndex
from ..indexing.nearest_neighbors import BruteForceKnn, LshKnn

__all__ = ["KNNIndex"]


class KNNIndex:
    """K nearest neighbours over an embedding column (reference index.py:9).

    ``bucketing_params`` selects the LSH engine (reference parity); without
    it the exact brute-force kernel is used — at reference scales the
    exact kernel is faster than approximate bucketing.
    """

    def __init__(
        self,
        data_embedding: ColumnReference,
        data: Table,
        n_dimensions: int,
        n_or: int = 20,
        n_and: int = 10,
        bucket_length: float = 10.0,
        distance_type: str = "euclidean",
        metadata: ColumnExpression | None = None,
    ):
        metric = {"euclidean": "l2sq", "cosine": "cos"}.get(
            distance_type, distance_type
        )
        if n_or != 20 or n_and != 10:  # explicit LSH request
            inner = LshKnn(
                data_column=data_embedding,
                metadata_column=metadata,
                dimensions=n_dimensions,
                metric=metric,
                n_or=n_or,
                n_and=n_and,
            )
        else:
            inner = BruteForceKnn(
                data_column=data_embedding,
                metadata_column=metadata,
                dimensions=n_dimensions,
                metric=metric,
            )
        self._index = DataIndex(data, inner)
        self._data = data

    def get_nearest_items(
        self,
        query_embedding: ColumnReference,
        k: ColumnExpression | int = 3,
        collapse_rows: bool = True,
        with_distances: bool = False,
        metadata_filter: ColumnExpression | None = None,
    ) -> Table:
        """Maintained KNN answers (reference index.py:54)."""
        return self._package(
            self._index.query(
                query_embedding,
                number_of_matches=k,
                collapse_rows=collapse_rows,
                metadata_filter=metadata_filter,
            ),
            collapse_rows,
            with_distances,
        )

    def get_nearest_items_asof_now(
        self,
        query_embedding: ColumnReference,
        k: ColumnExpression | int = 3,
        collapse_rows: bool = True,
        with_distances: bool = False,
        metadata_filter: ColumnExpression | None = None,
    ) -> Table:
        """As-of-now answers: not revisited when data changes later
        (reference index.py:194)."""
        return self._package(
            self._index.query_as_of_now(
                query_embedding,
                number_of_matches=k,
                collapse_rows=collapse_rows,
                metadata_filter=metadata_filter,
            ),
            collapse_rows,
            with_distances,
        )

    def _package(self, join_result, collapse_rows: bool, with_distances: bool) -> Table:
        from ...internals.thisclass import right as r_
        from ..indexing.data_index import _SCORE

        cols = {c: getattr(r_, c) for c in self._data.column_names()}
        if with_distances:
            from ...internals import dtype as dt
            from ...internals.expression import apply_with_type

            if collapse_rows:
                cols["dist"] = apply_with_type(
                    lambda scores: tuple(-float(s) for s in (scores or ())),
                    dt.ANY, getattr(r_, _SCORE),
                )
            else:
                cols["dist"] = apply_with_type(
                    lambda s: -float(s) if s is not None else None,
                    dt.Optional(dt.FLOAT), getattr(r_, _SCORE),
                )
        # the collapsed DataIndex result is a LEFT join keyed by
        # pw.left.id, so join_select already carries the queries' universe
        # (joins.py) — `queries + result` zips with no promise needed here
        return join_result.select(**cols)
