"""``pw.ordered`` — order-based transforms (reference
``python/pathway/stdlib/ordered/diff.py:10``).

Copy of ``pathway_tpu/stdlib/ordered/__init__.py``, over the port's Table API and engine nodes.
"""

from __future__ import annotations

from typing import Any

from ...internals import dtype as dt
from ...internals.expression import ColumnReference, smart_coerce
from ...internals.table import Table
from ...internals.thisclass import substitute, this
from .._sorted import sorted_group_transform

__all__ = ["diff"]


def diff(
    self: Table,
    timestamp: Any,
    *values: Any,
    instance: Any = None,
) -> Table:
    """Per-row difference of `values` columns vs the previous row ordered by
    `timestamp` (first row per instance gets None)."""
    ts = substitute(smart_coerce(timestamp), {this: self})
    vals = [substitute(smart_coerce(v), {this: self}) for v in values]
    names = []
    for v in vals:
        if not isinstance(v, ColumnReference):
            raise ValueError("diff values must be column references")
        names.append(f"diff_{v.name}")
    inst = substitute(smart_coerce(instance), {this: self}) if instance is not None else None

    def fn(entries):
        out = []
        prev = None
        for rk, order, payload in entries:
            if prev is None:
                out.append((rk, tuple([None] * len(payload))))
            else:
                out.append((rk, tuple(
                    None if (a is None or b is None) else a - b
                    for a, b in zip(payload, prev)
                )))
            prev = payload
        return out

    env_types = {
        n: dt.Optional(self.schema.columns()[v.name].dtype)
        for n, v in zip(names, vals)
    }
    return sorted_group_transform(self, ts, vals, inst, env_types, fn)
