"""``pw.statistical`` — interpolation (reference
``python/pathway/stdlib/statistical/_interpolate.py:33``).

Copy of ``pathway_tpu/stdlib/statistical/__init__.py``, over the port's Table API and engine nodes.
"""

from __future__ import annotations

import enum
from typing import Any

from ...internals import dtype as dt
from ...internals.expression import ColumnReference, smart_coerce
from ...internals.table import Table
from ...internals.thisclass import substitute, this
from .._sorted import sorted_group_transform

__all__ = ["interpolate", "InterpolateMode"]


class InterpolateMode(enum.Enum):
    LINEAR = "linear"


def interpolate(
    self: Table,
    timestamp: Any,
    *values: Any,
    mode: InterpolateMode = InterpolateMode.LINEAR,
) -> Table:
    """Fill None values by linear interpolation between the previous and next
    non-None values ordered by `timestamp`; boundary Nones stay None."""
    if mode != InterpolateMode.LINEAR:
        raise ValueError("only InterpolateMode.LINEAR is supported")
    ts = substitute(smart_coerce(timestamp), {this: self})
    vals = [substitute(smart_coerce(v), {this: self}) for v in values]
    names = []
    for v in vals:
        if not isinstance(v, ColumnReference):
            raise ValueError("interpolate values must be column references")
        names.append(v.name)

    def fn(entries):
        n = len(entries)
        cols = list(zip(*[p for _, _, p in entries])) if n else []
        times = [order for _, order, _ in entries]
        out_cols = []
        for series in cols:
            series = list(series)
            known = [i for i, v in enumerate(series) if v is not None]
            for i, v in enumerate(series):
                if v is not None:
                    continue
                import bisect

                j = bisect.bisect_left(known, i)
                lo = known[j - 1] if j > 0 else None
                hi = known[j] if j < len(known) else None
                if lo is not None and hi is not None:
                    t0, t1, t = times[lo], times[hi], times[i]
                    v0, v1 = series[lo], series[hi]
                    series[i] = v0 + (v1 - v0) * (t - t0) / (t1 - t0)
            out_cols.append(series)
        ts_col = [order for _, order, _ in entries]
        out = []
        for i, (rk, order, _) in enumerate(entries):
            out.append((rk, (order,) + tuple(c[i] for c in out_cols)))
        return out

    ts_name = ts.name if isinstance(ts, ColumnReference) else "timestamp"
    out_types = {ts_name: self.schema.columns()[ts_name].dtype if ts_name in self.schema.__columns__ else dt.ANY}
    for nm, v in zip(names, vals):
        t = self.schema.columns()[v.name].dtype
        u = dt.unoptionalize(t)
        out_types[nm] = dt.Optional(dt.FLOAT if u in (dt.INT, dt.FLOAT) else u)
    return sorted_group_transform(self, ts, vals, None, out_types, fn)
