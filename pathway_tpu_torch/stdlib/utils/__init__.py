"""``pw.utils`` stdlib (reference ``python/pathway/stdlib/utils``):
column helpers, row filters, AsyncTransformer, pandas_transformer.

Copy of ``pathway_tpu/stdlib/utils/__init__.py``, over the port's Table API and engine nodes.
"""

from . import col, filtering  # noqa: F401
from .async_transformer import AsyncTransformer  # noqa: F401
from .col import (  # noqa: F401
    apply_all_rows,
    flatten_column,
    groupby_reduce_majority,
    multiapply_all_rows,
    unpack_col,
)
from .filtering import argmax_rows, argmin_rows  # noqa: F401
from .pandas_transformer import pandas_transformer  # noqa: F401

__all__ = [
    "col",
    "filtering",
    "AsyncTransformer",
    "pandas_transformer",
    "unpack_col",
    "flatten_column",
    "apply_all_rows",
    "multiapply_all_rows",
    "groupby_reduce_majority",
    "argmax_rows",
    "argmin_rows",
]
