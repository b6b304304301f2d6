"""ML helpers (reference ``python/pathway/stdlib/ml/utils.py``).

Copy of ``pathway_tpu/stdlib/ml/utils.py``, over the port's Table API and engine nodes.
"""

from __future__ import annotations

from ... import reducers
from ...internals import dtype as dt
from ...internals.expression import ColumnReference, apply_with_type
from ...internals.table import Table
from ...internals.thisclass import left as l_, right as r_, this

__all__ = ["classifier_accuracy"]


def classifier_accuracy(
    predicted_labels: ColumnReference, exact_labels: ColumnReference
) -> Table:
    """Count of correct vs incorrect predictions
    (reference ml/utils.py:13)."""
    pt = predicted_labels.table
    joined = pt.select(
        __pred=predicted_labels,
        __exact=exact_labels,
    )
    flagged = joined.select(
        ok=apply_with_type(
            lambda p, e: bool(p == e), dt.BOOL, this["__pred"], this["__exact"]
        )
    )
    return flagged.groupby(this.ok).reduce(
        cnt=reducers.count(), value=this.ok
    )
