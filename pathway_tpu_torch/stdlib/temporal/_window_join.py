"""window_join — join rows that fall into the same window
(reference ``_window_join.py:156``): both sides expand to their window
memberships, then equi-join on (window_start, window_end) + extra conditions.

Copy of ``pathway_tpu/stdlib/temporal/_window_join.py``, over the port's Table API and engine nodes.
"""

from __future__ import annotations

from typing import Any

from ...internals.expression import ColumnReference, smart_coerce
from ...internals.joins import JoinMode
from ...internals.table import Table
from ...internals.thisclass import left as pw_left, right as pw_right, substitute, this

__all__ = [
    "window_join", "window_join_inner", "window_join_left",
    "window_join_right", "window_join_outer", "WindowJoinResult",
]


def _refs_table(expr: Any, table: Table) -> bool:
    """True when the expression contains a direct ColumnReference to the
    given concrete table (pw.left/pw.right placeholders do not count)."""
    if isinstance(expr, ColumnReference):
        return expr.table is table
    return any(
        _refs_table(d, table) for d in getattr(expr, "_deps", ())
    )


class WindowJoinResult:
    def __init__(self, left_t, right_t, left_time, right_time, window, on, mode):
        self._left = left_t
        self._right = right_t
        self._lexp = window._assign(
            left_t,
            substitute(smart_coerce(left_time), {this: left_t, pw_left: left_t}),
            None, None,
        )
        self._rexp = window._assign(
            right_t,
            substitute(
                smart_coerce(right_time), {this: right_t, pw_right: right_t}
            ),
            None, None,
        )
        self._on = on
        self._mode = mode

    def select(self, *args: Any, **kwargs: Any) -> Table:
        le, re_ = self._lexp, self._rexp
        conditions = [
            le._pw_window_start == re_._pw_window_start,
            le._pw_window_end == re_._pw_window_end,
        ]
        # conditions may reference pw.left/pw.right OR the original
        # tables directly (reference t1.k == t2.k style)
        if self._left is self._right and any(
            _refs_table(c, self._left) for c in self._on
        ):
            # a self-join collapses both table keys to one mapping entry,
            # which would silently rewrite a direct reference to one side;
            # pw.left/pw.right conditions stay unambiguous and allowed
            raise ValueError(
                "window self-join conditions must use pw.left/pw.right "
                "(direct table references are ambiguous)"
            )
        cond_map = {
            pw_left: le, pw_right: re_,
            self._left: le, self._right: re_,
        }
        for cond in self._on:
            lexpr = substitute(cond._left, cond_map)
            rexpr = substitute(cond._right, cond_map)
            conditions.append(lexpr == rexpr)
        jr = {
            JoinMode.INNER: le.join,
            JoinMode.LEFT: le.join_left,
            JoinMode.RIGHT: le.join_right,
            JoinMode.OUTER: le.join_outer,
        }[self._mode](re_, *conditions)

        def rewrite(e):
            import copy

            from ...internals.expression import ColumnExpression

            e = smart_coerce(e)
            if isinstance(e, ColumnReference):
                if e.table is self._left or e.name == "_pw_window" and e.table is this:
                    return ColumnReference(le, e.name)
                if e.table is self._right:
                    return ColumnReference(re_, e.name)
                return e
            if not getattr(e, "_deps", ()):
                return e
            clone = copy.copy(e)
            for attr, value in list(vars(clone).items()):
                if isinstance(value, ColumnExpression):
                    setattr(clone, attr, rewrite(value))
                elif isinstance(value, tuple) and any(isinstance(v, ColumnExpression) for v in value):
                    setattr(clone, attr, tuple(
                        rewrite(v) if isinstance(v, ColumnExpression) else v for v in value
                    ))
            return clone

        new_args = [rewrite(substitute(smart_coerce(a), {pw_left: le, pw_right: re_})) for a in args]
        new_kwargs = {
            n: rewrite(substitute(smart_coerce(e), {pw_left: le, pw_right: re_}))
            for n, e in kwargs.items()
        }
        return jr.select(*new_args, **new_kwargs)


def window_join(
    self: Table, other: Table, self_time, other_time, window,
    *on: Any, how: JoinMode = JoinMode.INNER,
) -> WindowJoinResult:
    return WindowJoinResult(self, other, self_time, other_time, window, on, how)


def window_join_inner(self, other, self_time, other_time, window, *on):
    return window_join(self, other, self_time, other_time, window, *on,
                       how=JoinMode.INNER)


def window_join_left(self, other, self_time, other_time, window, *on):
    return window_join(self, other, self_time, other_time, window, *on,
                       how=JoinMode.LEFT)


def window_join_right(self, other, self_time, other_time, window, *on):
    return window_join(self, other, self_time, other_time, window, *on,
                       how=JoinMode.RIGHT)


def window_join_outer(self, other, self_time, other_time, window, *on):
    return window_join(self, other, self_time, other_time, window, *on,
                       how=JoinMode.OUTER)
