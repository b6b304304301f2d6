"""kNN-LSH classifiers (reference
``python/pathway/stdlib/ml/classifiers/_knn_lsh.py``):
``knn_lsh_classifier_train`` builds an index over training points,
``knn_lsh_classify`` labels queries by majority vote of their k nearest
training points. The distance scoring runs through ``pw.ml.index``
(the ``knn_topk`` kernel on the card).

Copy of ``pathway_tpu/stdlib/ml/classifiers.py``, over the port's Table API and engine nodes.
"""

from __future__ import annotations

from typing import Any

from ...internals import dtype as dt
from ...internals.expression import ColumnReference, apply_with_type
from ...internals.table import Table
from ...internals.thisclass import this
from .index import KNNIndex

__all__ = [
    "knn_lsh_classifier_train",
    "knn_lsh_train",
    "knn_lsh_classify",
    "knn_lsh_generic_classifier_train",
    "knn_lsh_euclidean_classifier_train",
]


def knn_lsh_classifier_train(
    data: Table,
    L: int = 20,
    type: str = "euclidean",  # noqa: A002 - reference parameter name
    **kwargs: Any,
) -> KNNIndex:
    """Index training vectors (column ``data``); returns the queryable
    model (reference _knn_lsh.py knn_lsh_classifier_train)."""
    d = kwargs.get("d")
    if d is None:
        raise ValueError("pass d= (embedding dimensionality)")
    return KNNIndex(
        ColumnReference(data, "data"),
        data,
        n_dimensions=d,
        n_or=L,
        n_and=kwargs.get("M", 10),
        bucket_length=kwargs.get("A", 10.0),
        distance_type=type,
    )


knn_lsh_train = knn_lsh_classifier_train
knn_lsh_generic_classifier_train = knn_lsh_classifier_train


def knn_lsh_euclidean_classifier_train(data: Table, d: int, M: int = 10, L: int = 20, A: float = 10.0) -> KNNIndex:
    return knn_lsh_classifier_train(data, L=L, type="euclidean", d=d, M=M, A=A)


def knn_lsh_classify(
    knn_model: KNNIndex, data_labels: Table, queries: Table, k: int = 3
) -> Table:
    """Majority label among the k nearest training points
    (reference _knn_lsh.py knn_lsh_classify), a tie going to the nearest.

    The reference joins every query row with one tuple of all (training id, label) pairs and
    builds a dict from it a row, so each query costs the training set's size (and, keyed by the
    query, the join's uniqueness check hashes that tuple a row). Here each (query, neighbour)
    pair is a row of its own, joined with its training row's label and grouped back by the
    query: the same labels, and each query's cost its k neighbours. The predictions are keyed by
    the query, so they share the queries' universe and
    ``classifier_accuracy(predicted.predicted_label, queries.label)`` lines up; the reference
    keys them by its join's pair of ids (ROADMAP, Queue 3)."""
    from ... import reducers
    from ..indexing.data_index import _MATCHED_ID
    from ...internals.thisclass import left as l_, right as r_

    # collapsed matches with the training row ids (the classify path needs
    # ids, which the user-facing get_nearest_items projection drops)
    hits = knn_model._index.query(
        ColumnReference(queries, "data"),
        number_of_matches=k,
        collapse_rows=True,
    ).select(**{"__ids": getattr(r_, _MATCHED_ID)})

    # one row a (query, neighbour): the neighbour's rank and training row id
    ranked = hits.select(
        __q=hits.id,
        __hit=apply_with_type(
            lambda ids: tuple(enumerate(ids or ())), dt.ANY, this["__ids"]
        ),
    ).flatten(this["__hit"])
    pairs = ranked.select(
        __q=this["__q"],
        __rank=apply_with_type(lambda h: h[0], dt.INT, this["__hit"]),
        __train=apply_with_type(lambda h: int(h[1]), dt.ANY, this["__hit"]),
    )
    label_col = data_labels.column_names()[0]
    labels = data_labels.select(
        __train=apply_with_type(int, dt.ANY, data_labels.id),
        __label=data_labels[label_col],
    )
    # neighbours without a label row cast no vote, as the reference's dict lookup skips them
    labelled = pairs.join(labels, l_["__train"] == r_["__train"]).select(
        __q=l_["__q"], __rank=l_["__rank"], __label=r_["__label"]
    )
    votes = labelled.groupby(id=this["__q"]).reduce(
        __labels=reducers.tuple_by(this["__rank"], this["__label"])
    )

    def vote(labels):
        from collections import Counter

        if not labels:
            return None
        return Counter(labels).most_common(1)[0][0]

    return hits.select(
        predicted_label=apply_with_type(
            vote, dt.ANY, votes.ix(hits.id, optional=True)["__labels"]
        )
    )
