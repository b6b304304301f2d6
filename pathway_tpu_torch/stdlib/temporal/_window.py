"""Windows: tumbling / sliding / session / intervals_over + windowby.

Re-design of ``python/pathway/stdlib/temporal/_window.py`` (Window ABC :42,
windowby :595-865). Tumbling/sliding windows are stateless row expansions
(flatten) followed by an ordinary incremental groupby — no dedicated window
operator needed; the engine's retraction machinery maintains window results.
Session windows need cross-row grouping and ride GroupedRecompute.

Copy of ``pathway_tpu/stdlib/temporal/_window.py``, over the port's Table API and engine nodes.
"""

from __future__ import annotations

import math
from abc import ABC, abstractmethod
from typing import Any

import numpy as np

from ...internals import dtype as dt
from ...internals.expression import (
    ApplyExpression,
    ColumnReference,
    MakeTupleExpression,
    smart_coerce,
)
from ...internals.parse_graph import Universe
from ...internals.schema import ColumnSchema, schema_from_columns
from ...internals.table import Table
from ...internals.thisclass import substitute, this
from .temporal_behavior import CommonBehavior, ExactlyOnceBehavior

__all__ = ["Window", "tumbling", "sliding", "session", "intervals_over", "windowby"]


class Window(ABC):
    @abstractmethod
    def _assign(self, table: Table, time_expr, instance_expr, behavior) -> Table:
        """Return the expanded table with _pw_window_start/_pw_window_end
        (+ _pw_instance) columns, one row per (row, window) membership."""


def _to_number(v: Any) -> Any:
    import datetime

    if isinstance(v, datetime.timedelta):
        return v
    return v


class _FixedWindow(Window):
    """Common machinery for tumbling/sliding: per-row window assignment."""

    def _windows_of(self, t):
        raise NotImplementedError

    def _assign(self, table, time_expr, instance_expr, behavior):
        win_fn = self._windows_of
        first_cols = {
            "_pw_windows": ApplyExpression(
                lambda t: tuple(win_fn(t)), dt.List(dt.ANY), (time_expr,), {}
            )
        }
        if instance_expr is not None:
            # instance references the source table — compute before flatten
            first_cols["_pw_instance"] = instance_expr
        expanded = table.with_columns(**first_cols).flatten(this._pw_windows)
        expanded = expanded.with_columns(
            _pw_window_start=ApplyExpression(
                lambda w: w[0], dt.ANY, (this._pw_windows,), {}
            ),
            _pw_window_end=ApplyExpression(
                lambda w: w[1], dt.ANY, (this._pw_windows,), {}
            ),
        ).without("_pw_windows")
        return _apply_behavior(expanded, behavior)


class TumblingWindow(_FixedWindow):
    def __init__(self, duration, origin=None):
        self.duration = duration
        self.origin = origin

    def _windows_of(self, t):
        d = self.duration
        origin = self.origin if self.origin is not None else (t - t) if not isinstance(t, (int, float)) else 0
        if self.origin is None and not isinstance(t, (int, float)):
            import datetime

            origin = datetime.datetime(1970, 1, 1, tzinfo=getattr(t, "tzinfo", None))
        k = math.floor((t - origin) / d)
        if self.origin is not None and k < 0:
            # an explicit origin is the FIRST window's start (reference
            # temporal/_window.py): earlier times belong to no window
            return ()
        start = origin + k * d
        return ((start, start + d),)


class SlidingWindow(_FixedWindow):
    def __init__(self, hop, duration, origin=None):
        self.hop = hop
        self.duration = duration
        self.origin = origin

    def _windows_of(self, t):
        h, d = self.hop, self.duration
        origin = self.origin
        if origin is None:
            if isinstance(t, (int, float)):
                origin = 0
            else:
                import datetime

                origin = datetime.datetime(1970, 1, 1, tzinfo=getattr(t, "tzinfo", None))
        # latest window start <= t
        s = origin + math.floor((t - origin) / h) * h
        out = []
        while s + d > t:
            if s <= t and (self.origin is None or s >= origin):
                # explicit origin truncates: no window starts before it
                # (reference sliding origin semantics, test_windows.py:430)
                out.append((s, s + d))
            s = s - h
        out.reverse()
        return tuple(out)


class SessionWindow(Window):
    def __init__(self, predicate=None, max_gap=None):
        if (predicate is None) == (max_gap is None):
            raise ValueError("session window needs exactly one of predicate / max_gap")
        self.predicate = predicate
        self.max_gap = max_gap

    def _assign(self, table, time_expr, instance_expr, behavior):
        from ...engine import keys as K
        from ...engine import operators as ops
        from ...internals.expression_compiler import compile_expr

        base_cols = table.column_names()
        out_cols = base_cols + ["_pw_window_start", "_pw_window_end"] + (
            ["_pw_instance"] if instance_expr is not None else []
        )
        cols = {
            **{n: c for n, c in table.schema.columns().items()},
            "_pw_window_start": ColumnSchema(name="_pw_window_start", dtype=dt.ANY),
            "_pw_window_end": ColumnSchema(name="_pw_window_end", dtype=dt.ANY),
        }
        if instance_expr is not None:
            cols["_pw_instance"] = ColumnSchema(name="_pw_instance", dtype=dt.ANY)
        schema = schema_from_columns(cols, name="SessionAssigned")
        predicate, max_gap = self.predicate, self.max_gap
        has_instance = instance_expr is not None

        def lower(runner, tbl):
            exprs = {"__t": time_expr}
            if has_instance:
                exprs["__i"] = instance_expr
            node, env = runner._zip_env(table, exprs)
            rw_cols = {c: (lambda cols_, keys_, n=c: cols_[n]) for c in base_cols}
            rw_cols["__t"] = compile_expr(time_expr, env).fn
            if has_instance:
                inst_fn = compile_expr(instance_expr, env).fn

                def g_fn(cols_, keys_, f=inst_fn):
                    vals = f(cols_, keys_)
                    if not isinstance(vals, np.ndarray):
                        arr = np.empty(len(keys_), dtype=object)
                        arr[:] = [vals] * len(keys_)
                        vals = arr
                    return K.mix_columns([vals], len(keys_))

                rw_cols["__g"] = g_fn
                rw_cols["__i"] = inst_fn
            pre = runner._add(ops.Rowwise(node, rw_cols))
            t_ix = len(base_cols)  # position of __t in rows
            i_ix = t_ix + 2 if has_instance else None

            def compute(gk, rows, time):
                # rows: {row_key: (base..., __t, [__g, __i])}
                entries = sorted(rows.items(), key=lambda kv: (kv[1][t_ix], kv[0]))
                out = []
                cluster: list = []

                def flush():
                    if not cluster:
                        return
                    start = cluster[0][1][t_ix]
                    end = cluster[-1][1][t_ix]
                    for rk, row in cluster:
                        base = row[:t_ix]
                        extra = (start, end)
                        if has_instance:
                            extra = extra + (row[i_ix],)
                        out.append((K.derive_scalar(rk, 0x5E55), base + extra))
                    cluster.clear()

                for rk, row in entries:
                    if cluster:
                        prev_t = cluster[-1][1][t_ix]
                        t = row[t_ix]
                        joined = (
                            predicate(prev_t, t)
                            if predicate is not None
                            else (t - prev_t) <= max_gap
                        )
                        if not joined:
                            flush()
                    cluster.append((rk, row))
                flush()
                return out

            gr = runner._add(ops.GroupedRecompute(
                [pre], ["__g" if has_instance else None], out_cols, compute,
            ))
            return gr

        expanded = Table("custom", [table], {"lower": lower}, schema, Universe())
        return _apply_behavior(expanded, behavior)


class IntervalsOverWindow(Window):
    def __init__(self, at, lower_bound, upper_bound, is_outer=True):
        self.at = at
        self.lower_bound = lower_bound
        self.upper_bound = upper_bound
        self.is_outer = is_outer

    def _assign(self, table, time_expr, instance_expr, behavior):
        from ._interval_join import _expand_buckets

        at_ref = self.at
        if not isinstance(at_ref, ColumnReference):
            raise ValueError("intervals_over(at=...) takes a column reference")
        anchors = at_ref.table.groupby(at_ref).reduce(
            **{"_pw_anchor": at_ref}
        )
        lo, up = self.lower_bound, self.upper_bound
        # anchor a matches rows with time in [a+lo, a+up]
        from ._interval_join import interval, interval_join_inner

        expanded = interval_join_inner(
            anchors, table, anchors._pw_anchor, time_expr, interval(lo, up)
        ).select(
            *[ColumnReference(table, c) for c in table.column_names()],
            _pw_window_start=anchors._pw_anchor + lo,
            _pw_window_end=anchors._pw_anchor + up,
            _pw_instance=anchors._pw_anchor,
            # the probe point itself (reference intervals_over exposes
            # `_pw_window_location`, temporal/test_windows.py:961)
            _pw_window_location=anchors._pw_anchor,
        )
        return _apply_behavior(expanded, behavior)


def tumbling(duration, origin=None) -> TumblingWindow:
    return TumblingWindow(duration, origin)


def sliding(hop, duration=None, ratio=None, origin=None) -> SlidingWindow:
    if duration is None and ratio is not None:
        duration = hop * ratio
    return SlidingWindow(hop, duration, origin)


def session(*, predicate=None, max_gap=None) -> SessionWindow:
    return SessionWindow(predicate=predicate, max_gap=max_gap)


def intervals_over(*, at, lower_bound, upper_bound, is_outer=True) -> IntervalsOverWindow:
    return IntervalsOverWindow(at, lower_bound, upper_bound, is_outer)


class WindowedTable:
    """Result of windowby — reduce() aggregates per (instance, window)."""

    def __init__(self, table: Table, expanded: Table, has_instance: bool):
        self._table = table
        self._expanded = expanded
        self._has_instance = has_instance

    def reduce(self, *args: Any, **kwargs: Any) -> Table:
        exp = self._expanded
        group_cols = [exp._pw_window_start, exp._pw_window_end]
        if self._has_instance:
            group_cols.append(exp._pw_instance)
        if "_pw_window_location" in exp.column_names():
            # intervals_over: the probe point is constant per window and
            # selectable in reduce (reference _pw_window_location)
            group_cols.append(exp._pw_window_location)
        grouped = exp.groupby(*group_cols)
        # rewrite pw.this references against the expanded table; synthesize
        # the _pw_window tuple from the grouping columns
        new_kwargs = {}
        for name, e in kwargs.items():
            e = _rewrite_window_tuple(smart_coerce(e), exp, self._has_instance)
            new_kwargs[name] = substitute(e, {this: exp})
        new_args = [
            substitute(_rewrite_window_tuple(smart_coerce(a), exp, self._has_instance), {this: exp})
            for a in args
        ]
        return grouped.reduce(*new_args, **new_kwargs)


def _rewrite_window_tuple(expr, exp, has_instance):
    if isinstance(expr, ColumnReference) and expr.name == "_pw_window":
        parts = [ColumnReference(exp, "_pw_window_start"), ColumnReference(exp, "_pw_window_end")]
        if has_instance:
            parts = [ColumnReference(exp, "_pw_instance")] + parts
        return MakeTupleExpression(*parts)
    import copy

    if not getattr(expr, "_deps", ()):
        return expr
    clone = copy.copy(expr)
    from ...internals.expression import ColumnExpression

    for attr, value in list(vars(clone).items()):
        if isinstance(value, ColumnExpression):
            setattr(clone, attr, _rewrite_window_tuple(value, exp, has_instance))
        elif isinstance(value, tuple) and any(isinstance(v, ColumnExpression) for v in value):
            setattr(clone, attr, tuple(
                _rewrite_window_tuple(v, exp, has_instance) if isinstance(v, ColumnExpression) else v
                for v in value
            ))
    return clone


def windowby(
    table: Table,
    time_expr: Any,
    *,
    window: Window,
    instance: Any = None,
    behavior: Any = None,
) -> WindowedTable:
    time_expr = substitute(smart_coerce(time_expr), {this: table})
    if behavior is not None:
        # carry the event time as a column: behaviors' buffer/forget
        # watermark is the max TIME-COLUMN value seen (reference
        # time_column.rs frontier), not the engine's processing time
        table = table.with_columns(_pw_t=time_expr)
        time_expr = ColumnReference(table, "_pw_t")
    instance_expr = (
        substitute(smart_coerce(instance), {this: table}) if instance is not None else None
    )
    expanded = window._assign(table, time_expr, instance_expr, behavior)
    return WindowedTable(table, expanded, instance_expr is not None)


def _apply_behavior(expanded: Table, behavior) -> Table:
    """Wrap the expanded window-membership stream with buffer/forget engine
    nodes per the behavior (reference: engine buffer/forget/freeze). The
    watermark is the max EVENT time seen (the ``_pw_t`` column threaded
    through by windowby)."""
    if behavior is None:
        return expanded
    from ._shared import apply_behavior_nodes

    if isinstance(behavior, ExactlyOnceBehavior):
        shift = behavior.shift or 0
        buffer_expr = this._pw_window_end + shift
        # lateness is inclusive at the threshold (ForgetAfter keeps
        # thr >= watermark), so the released batch itself passes through
        cutoff_expr = this._pw_window_end + shift
        keep_results = True
    else:
        buffer_expr = (
            this._pw_window_start + behavior.delay if behavior.delay is not None else None
        )
        cutoff_expr = (
            this._pw_window_end + behavior.cutoff
            if behavior.cutoff is not None
            else None
        )
        keep_results = behavior.keep_results

    return apply_behavior_nodes(
        expanded, buffer_expr, cutoff_expr, "_pw_t", keep_results
    )
