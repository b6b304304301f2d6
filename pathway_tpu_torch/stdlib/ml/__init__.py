"""``pw.ml`` (reference ``python/pathway/stdlib/ml``): KNN index,
LSH classifiers, fuzzy joins, HMM decoding, dataset helpers.

Copy of ``pathway_tpu/stdlib/ml/__init__.py``, over the port's Table API and engine nodes.
"""

from . import classifiers, datasets, hmm, index, smart_table_ops, utils  # noqa: F401
from .classifiers import (  # noqa: F401
    knn_lsh_classifier_train,
    knn_lsh_classify,
    knn_lsh_euclidean_classifier_train,
    knn_lsh_generic_classifier_train,
    knn_lsh_train,
)
from .hmm import create_hmm_reducer  # noqa: F401
from .index import KNNIndex  # noqa: F401
from .smart_table_ops import (  # noqa: F401
    fuzzy_match,
    fuzzy_match_tables,
    fuzzy_self_match,
    smart_fuzzy_match,
)
from .utils import classifier_accuracy  # noqa: F401

__all__ = [
    "index",
    "classifiers",
    "smart_table_ops",
    "hmm",
    "datasets",
    "utils",
    "KNNIndex",
    "create_hmm_reducer",
    "classifier_accuracy",
    "knn_lsh_classifier_train",
    "knn_lsh_train",
    "knn_lsh_classify",
    "knn_lsh_generic_classifier_train",
    "knn_lsh_euclidean_classifier_train",
    "fuzzy_match",
    "fuzzy_self_match",
    "fuzzy_match_tables",
    "smart_fuzzy_match",
]
