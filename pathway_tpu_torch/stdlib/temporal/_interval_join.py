"""interval_join — band joins on time columns.

Re-design of ``python/pathway/stdlib/temporal/_interval_join.py:577``.
TPU-first shape: instead of the reference's dedicated engine operator, the
band condition compiles to *bucketized equi-joins* over the existing
incremental Join — each left row expands to the (≤2 when the band fits one
bucket width) time buckets its band overlaps, right rows live in their own
bucket, and an exact post-filter trims the band edges. Outer modes derive
pads with an anti-join (difference) against the matched side.

Copy of ``pathway_tpu/stdlib/temporal/_interval_join.py``, over the port's Table API and engine nodes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

from ...internals import dtype as dt
from ...internals.expression import (
    ApplyExpression,
    ColumnExpression,
    ColumnReference,
    smart_coerce,
)
from ...internals.joins import JoinMode
from ...internals.table import Table
from ...internals.thisclass import left as pw_left, right as pw_right, substitute, this
from ._shared import this_side as _this_side

__all__ = [
    "interval",
    "interval_join",
    "interval_join_inner",
    "interval_join_left",
    "interval_join_right",
    "interval_join_outer",
]


@dataclass(frozen=True)
class Interval:
    lower_bound: Any
    upper_bound: Any


def interval(lower_bound, upper_bound) -> Interval:
    if lower_bound > upper_bound:
        # reference temporal/test_interval_joins.py:286 — an empty interval
        # is a build-time error, not a silent never-matching join
        raise ValueError(
            "interval: lower_bound has to be less than or equal to "
            "upper_bound"
        )
    return Interval(lower_bound, upper_bound)


def _bucket_of(value, width):
    return int(math.floor(value / width))


def _expand_buckets(table: Table, time_expr, lo, up, col: str) -> Table:
    """Add a flattened bucket column covering [t+lo, t+up] per row."""
    width = _bucket_width(lo, up)

    def buckets(t):
        b0 = _bucket_of(t + lo, width)
        b1 = _bucket_of(t + up, width)
        return tuple(range(b0, b1 + 1))

    return table.with_columns(
        **{col: ApplyExpression(buckets, dt.List(dt.INT), (time_expr,), {})}
    ).flatten(this[col])


def _bucket_width(lo, up):
    span = up - lo
    if hasattr(span, "total_seconds"):
        span = span.total_seconds()
    return max(float(span), 1.0) if isinstance(span, float) else max(int(span), 1)


def _apply_side_behavior(table: Table, time_col: str, behavior) -> Table:
    """Per-side temporal behavior for interval joins (reference
    ``_interval_join.py`` behavior param): judged against each side's OWN
    event-time watermark — ``cutoff`` drops rows arriving after
    ``t + cutoff`` has passed (and with ``keep_results=False`` retracts
    them from join state, bounding memory); ``delay`` buffers rows until
    the watermark reaches ``t + delay``."""
    if behavior is None:
        return table
    from ._shared import apply_behavior_nodes
    from .temporal_behavior import CommonBehavior

    if not isinstance(behavior, CommonBehavior):
        raise TypeError(
            "interval_join behavior must be pw.temporal.common_behavior(...)"
        )
    return apply_behavior_nodes(
        table,
        this[time_col] + behavior.delay if behavior.delay is not None else None,
        this[time_col] + behavior.cutoff if behavior.cutoff is not None else None,
        time_col,
        behavior.keep_results,
    )


class IntervalJoinResult:
    def __init__(self, left_t: Table, right_t: Table, left_time, right_time,
                 iv: Interval, on: tuple, mode: JoinMode, behavior=None):
        self._left = left_t
        self._right = right_t
        self._left_time = substitute(smart_coerce(left_time), {this: left_t, pw_left: left_t, pw_right: right_t})
        self._right_time = substitute(smart_coerce(right_time), {this: right_t, pw_left: left_t, pw_right: right_t})
        self._iv = iv
        self._on = on
        self._mode = mode
        self._behavior = behavior

    def select(self, *args: Any, **kwargs: Any) -> Table:
        lt, rt = self._left, self._right
        lo, up = self._iv.lower_bound, self._iv.upper_bound
        width = _bucket_width(lo, up)

        # working copies with private time/bucket columns; behavior wraps
        # apply BEFORE expansion and are ALSO the pad sources — a row the
        # behavior dropped/forgot must not resurface as an outer pad
        lb = lt.with_columns(_pw_lt=self._left_time, _pw_lid=this.id)
        lb = _apply_side_behavior(lb, "_pw_lt", self._behavior)
        lt2 = _expand_buckets(lb, this._pw_lt, lo, up, "_pw_b")
        rb = rt.with_columns(_pw_rt=self._right_time, _pw_rid=this.id)
        rb = _apply_side_behavior(rb, "_pw_rt", self._behavior)
        rt2 = rb.with_columns(
            _pw_b=ApplyExpression(
                lambda t: _bucket_of(t, width), dt.INT, (this._pw_rt,), {}
            ),
        )
        conditions = [lt2._pw_b == rt2._pw_b]
        for cond in self._on:
            lexpr = substitute(cond._left, {pw_left: lt2, pw_right: rt2, this: lt2})
            rexpr = substitute(cond._right, {pw_left: lt2, pw_right: rt2, this: rt2})
            conditions.append(lexpr == rexpr)
        joined = lt2.join(rt2, *conditions)
        inner_sel: dict[str, ColumnExpression] = {
            "_pw_lid": ColumnReference(lt2, "_pw_lid"),
            "_pw_rid": ColumnReference(rt2, "_pw_rid"),
            "_pw_lt": ColumnReference(lt2, "_pw_lt"),
            "_pw_rt": ColumnReference(rt2, "_pw_rt"),
        }
        for c in lt.column_names():
            inner_sel[f"l.{c}"] = ColumnReference(lt2, c)
        for c in rt.column_names():
            inner_sel[f"r.{c}"] = ColumnReference(rt2, c)
        matched = joined.select(**inner_sel).filter(
            (this._pw_rt - this._pw_lt >= lo) & (this._pw_rt - this._pw_lt <= up)
        )

        # user select expressions over matched rows
        def out_of(matched_t, l_prefix=True, r_prefix=True):
            exprs = {}
            for arg in args:
                resolved = self._resolve(arg, matched_t, lt, rt)
                if not isinstance(resolved, tuple):
                    raise ValueError("positional args must be column references")
                name, e = resolved
                exprs[name] = e
            for name, e in kwargs.items():
                exprs[name] = self._resolve_expr(e, matched_t, lt, rt)
            return exprs

        result = matched.select(**out_of(matched))

        # pad keys are salt-derived from the unmatched side's row keys and
        # can never collide with the pair-derived match keys
        if self._mode in (JoinMode.LEFT, JoinMode.OUTER):
            pads = self._pads(matched, lt, rt, "left", args, kwargs, src=lb)
            result = result.promise_universes_are_disjoint(pads).concat(pads)
        if self._mode in (JoinMode.RIGHT, JoinMode.OUTER):
            pads = self._pads(matched, lt, rt, "right", args, kwargs, src=rb)
            result = result.promise_universes_are_disjoint(pads).concat(pads)
        return result

    # -- helpers --------------------------------------------------------

    def _resolve(self, arg, matched_t, lt, rt):
        e = self._resolve_expr(arg, matched_t, lt, rt)
        if isinstance(arg, ColumnReference):
            return arg.name, e
        raise ValueError("positional args must be column references")

    def _resolve_expr(self, e, matched_t, lt, rt):
        e = smart_coerce(e)

        def rewrite(x):
            import copy

            if isinstance(x, ColumnReference):
                if x.table is lt or x.table is pw_left or (isinstance(x.table, type(pw_left)) and x.table is pw_left):
                    return ColumnReference(matched_t, f"l.{x.name}")
                if x.table is rt or x.table is pw_right:
                    return ColumnReference(matched_t, f"r.{x.name}")
                if x.table is this:
                    # pw.this desugars by column-name side lookup, exactly
                    # like the plain-join result (joins.py _lookup)
                    side = _this_side(x.name, lt, rt, "interval_join")
                    return ColumnReference(matched_t, f"{side}.{x.name}")
                return x
            if not getattr(x, "_deps", ()):
                return x
            clone = copy.copy(x)
            for attr, value in list(vars(clone).items()):
                if isinstance(value, ColumnExpression):
                    setattr(clone, attr, rewrite(value))
                elif isinstance(value, tuple) and any(isinstance(v, ColumnExpression) for v in value):
                    setattr(clone, attr, tuple(
                        rewrite(v) if isinstance(v, ColumnExpression) else v for v in value
                    ))
            return clone

        return rewrite(substitute(e, {pw_left: lt, pw_right: rt}))

    def _pads(self, matched, lt, rt, side, args, kwargs, src=None):
        """Unmatched rows of one side, padded with None on the other side.
        ``src`` is the behavior-wrapped side (defaults to the raw table
        when no behavior is set)."""
        if src is None:
            src = lt if side == "left" else rt
        id_col = "_pw_lid" if side == "left" else "_pw_rid"
        # anti-join: source rows whose id is not among matched ids
        unmatched = _anti_join_by_pointer(src, matched, id_col)
        exprs = {}
        for arg in args:
            if not isinstance(arg, ColumnReference):
                raise ValueError("positional args must be column references")
            exprs[arg.name] = self._pad_expr(arg, unmatched, src, side, lt, rt)
        for name, e in kwargs.items():
            exprs[name] = self._pad_expr(e, unmatched, src, side, lt, rt)
        pads = unmatched.select(**exprs)
        # rekey with a side marker: pad rows keep their source row key
        # otherwise, so a row unmatched on BOTH sides of a self-join (or of
        # two tables sharing an ancestor) would collide between the left-pad
        # and right-pad concat inputs (reference derives distinct pad keys
        # the same way)
        return pads.with_id_from(pads.id, f"_pw_{side}_pad")

    def _pad_expr(self, e, unmatched, src, side, lt, rt):
        from ...internals.expression import ColumnConstExpression

        e = smart_coerce(e)

        def rewrite(x):
            import copy

            if isinstance(x, ColumnReference):
                if x.table is this:
                    # same side lookup as the matched path — an own-side
                    # pw.this column keeps its value in pad rows
                    this_side_ = _this_side(x.name, lt, rt, "interval_join")
                    own = (this_side_ == "l") == (side == "left")
                    if own:
                        return ColumnReference(unmatched, x.name)
                    return ColumnConstExpression(None)
                own = (x.table is lt or x.table is pw_left) if side == "left" else (
                    x.table is rt or x.table is pw_right
                )
                if own:
                    return ColumnReference(unmatched, x.name)
                return ColumnConstExpression(None)
            if not getattr(x, "_deps", ()):
                return x
            clone = copy.copy(x)
            for attr, value in list(vars(clone).items()):
                if isinstance(value, ColumnExpression):
                    setattr(clone, attr, rewrite(value))
                elif isinstance(value, tuple) and any(isinstance(v, ColumnExpression) for v in value):
                    setattr(clone, attr, tuple(
                        rewrite(v) if isinstance(v, ColumnExpression) else v for v in value
                    ))
            return clone

        return rewrite(e)


def _anti_join_by_pointer(src: Table, matched: Table, id_col: str) -> Table:
    """Rows of src whose id does not appear in matched[id_col]."""
    from ...engine import operators as ops
    from ...internals.parse_graph import Universe

    def lower(runner, tbl):
        src_node = runner.lower(src)
        m_node = runner.lower(matched)
        from ...internals.graph_runner import _colref

        m_ids = runner._add(ops.Rowwise(m_node, {"__p": _colref(id_col)}))
        cols = src.column_names()
        return runner._add(ops.Join(
            src_node, m_ids, None, "__p",
            left_cols=cols, right_cols=[], out_names=cols,
            mode="left", key_mode="left", emit_matched=False,
        ))

    return Table(
        "custom", [src, matched], {"lower": lower}, src.schema,
        Universe(parent=src._universe),
    )


def interval_join(
    self: Table, other: Table, self_time, other_time, interval: Interval,
    *on: Any, behavior=None, how: JoinMode = JoinMode.INNER,
) -> IntervalJoinResult:
    return IntervalJoinResult(self, other, self_time, other_time, interval, on, how, behavior)


def interval_join_inner(self, other, self_time, other_time, iv, *on, behavior=None):
    return IntervalJoinResult(self, other, self_time, other_time, iv, on, JoinMode.INNER, behavior)


def interval_join_left(self, other, self_time, other_time, iv, *on, behavior=None):
    return IntervalJoinResult(self, other, self_time, other_time, iv, on, JoinMode.LEFT, behavior)


def interval_join_right(self, other, self_time, other_time, iv, *on, behavior=None):
    return IntervalJoinResult(self, other, self_time, other_time, iv, on, JoinMode.RIGHT, behavior)


def interval_join_outer(self, other, self_time, other_time, iv, *on, behavior=None):
    return IntervalJoinResult(self, other, self_time, other_time, iv, on, JoinMode.OUTER, behavior)
