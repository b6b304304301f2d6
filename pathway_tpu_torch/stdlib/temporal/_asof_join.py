"""asof_join / asof_now_join.

Re-design of ``python/pathway/stdlib/temporal/_asof_join.py:479`` (sortedness
via the reference's prev_next.rs operator) and ``_asof_now_join.py:176``.
asof_join rides the engine's GroupedRecompute (sort the key group, match
each left row to the latest/nearest right row); asof_now_join is the
engine Join with ``react_to_right=False`` — queries join the current right
state and are never retracted by later right-side changes.

Copy of ``pathway_tpu/stdlib/temporal/_asof_join.py``, over the port's Table API and engine nodes.
"""

from __future__ import annotations

import enum
from typing import Any

import numpy as np

from ...engine import keys as K
from ...internals import dtype as dt
from ...internals.expression import ColumnExpression, ColumnReference, smart_coerce
from ...internals.joins import JoinMode
from ...internals.parse_graph import Universe
from ...internals.schema import ColumnSchema, schema_from_columns
from ...internals.table import Table
from ...internals.thisclass import left as pw_left, right as pw_right, substitute, this

__all__ = ["Direction", "asof_join", "asof_join_left", "asof_now_join", "AsofJoinResult"]


class Direction(enum.Enum):
    BACKWARD = "backward"
    FORWARD = "forward"
    NEAREST = "nearest"


class AsofJoinResult:
    def __init__(self, left_t, right_t, left_time, right_time, on, mode, direction, defaults):
        self._left = left_t
        self._right = right_t
        self._ltime = substitute(smart_coerce(left_time), {this: left_t, pw_left: left_t})
        self._rtime = substitute(smart_coerce(right_time), {this: right_t, pw_right: right_t})
        self._on = on
        self._mode = mode
        self._direction = direction
        self._defaults = defaults or {}

    def select(self, *args: Any, **kwargs: Any) -> Table:
        from ...engine import operators as ops
        from ...internals.expression_compiler import ColumnEnv, compile_expr
        from ...internals.graph_runner import _colref

        lt, rt = self._left, self._right
        lcols, rcols = lt.column_names(), rt.column_names()
        combined_cols = (
            [f"l.{c}" for c in lcols] + ["l.__id__"]
            + [f"r.{c}" for c in rcols] + ["r.__id__"]
        )
        mode, direction = self._mode, self._direction
        on = self._on
        ltime_e, rtime_e = self._ltime, self._rtime

        def make_lower(out_exprs):
            def lower(runner, tbl):
                # per side: group key col, time col, payload
                def side(table, time_e, conds_side, prefix):
                    exprs = {"__t": time_e}
                    node, env = runner._zip_env(table, {**exprs, **{f"__c{i}": c for i, c in enumerate(conds_side)}})
                    rw = {f"{prefix}.{c}": _colref(c) for c in table.column_names()}
                    rw[f"{prefix}.__id__"] = lambda cols_, keys_: keys_
                    rw["__t"] = compile_expr(time_e, env).fn
                    cond_fns = [compile_expr(c, env).fn for c in conds_side]

                    def g_fn(cols_, keys_):
                        if not cond_fns:
                            return np.zeros(len(keys_), dtype=np.uint64)
                        from ...internals.expression_compiler import _materialize

                        vals = [np.asarray(_materialize(f(cols_, keys_), len(keys_))) for f in cond_fns]
                        return K.mix_columns(vals, len(keys_))

                    rw["__g"] = g_fn
                    return runner._add(ops.Rowwise(node, rw))

                lconds = [substitute(c._left, {pw_left: lt, this: lt}) for c in on]
                rconds = [substitute(c._right, {pw_right: rt, this: rt}) for c in on]
                lnode = side(lt, ltime_e, lconds, "l")
                rnode = side(rt, rtime_e, rconds, "r")
                n_l = len(lcols)
                lt_ix = n_l + 1  # l cols, l.__id__, then __t, __g
                n_r = len(rcols)

                def compute(gk, lrows, rrows, time):
                    # row layouts: left = (l.*, l.__id__, __t, __g);
                    #              right = (r.*, r.__id__, __t, __g)
                    rs = sorted(rrows.items(), key=lambda kv: (kv[1][n_r + 1], kv[0]))
                    rtimes = [r[1][n_r + 1] for r in rs]
                    out = []
                    import bisect

                    for lrk, lrow in sorted(lrows.items(), key=lambda kv: (kv[1][lt_ix], kv[0])):
                        t = lrow[lt_ix]
                        match = None
                        if rs:
                            if direction == Direction.BACKWARD:
                                i = bisect.bisect_right(rtimes, t) - 1
                                match = rs[i] if i >= 0 else None
                            elif direction == Direction.FORWARD:
                                i = bisect.bisect_left(rtimes, t)
                                match = rs[i] if i < len(rs) else None
                            else:  # NEAREST
                                i = bisect.bisect_left(rtimes, t)
                                cands = []
                                if i > 0:
                                    cands.append(rs[i - 1])
                                if i < len(rs):
                                    cands.append(rs[i])
                                match = min(
                                    cands, key=lambda kv: abs(kv[1][n_r + 1] - t)
                                ) if cands else None
                        if match is None:
                            if mode == JoinMode.INNER:
                                continue
                            rpart = (None,) * (n_r + 1)
                            okey = K.derive_scalar(lrk, 0xA50F)
                        else:
                            rrk, rrow = match
                            rpart = rrow[: n_r + 1]
                            okey = K.derive_pair_scalar(lrk, rrk)
                        out.append((okey, lrow[: n_l + 1] + rpart))
                    return out

                gr = runner._add(ops.GroupedRecompute(
                    [lnode, rnode], ["__g", "__g"], combined_cols, compute,
                ))
                env = ColumnEnv()
                l_opt = False
                r_opt = mode in (JoinMode.LEFT, JoinMode.OUTER)
                for c, cs in lt.schema.columns().items():
                    env.add(lt, c, f"l.{c}", cs.dtype)
                env.add(lt, "id", "l.__id__", dt.POINTER)
                for c, cs in rt.schema.columns().items():
                    env.add(rt, c, f"r.{c}", dt.Optional(cs.dtype) if r_opt else cs.dtype)
                env.add(rt, "id", "r.__id__", dt.Optional(dt.POINTER) if r_opt else dt.POINTER)
                post = {name: compile_expr(e, env).fn for name, e in out_exprs.items()}
                return runner._add(ops.Rowwise(gr, post))

            return lower

        out_exprs: dict[str, ColumnExpression] = {}
        for arg in args:
            resolved = self._resolve(arg)
            if not isinstance(resolved, ColumnReference):
                raise ValueError("positional args must be column references")
            out_exprs[resolved.name] = resolved
        for name, e in kwargs.items():
            out_exprs[name] = self._resolve(e)

        cols = {}
        from ...internals.expression_compiler import ColumnEnv, infer_dtype

        env = ColumnEnv()
        env.add_table(lt, prefix="l.")
        env.add_table(rt, prefix="r.")
        for name, e in out_exprs.items():
            try:
                cols[name] = ColumnSchema(name=name, dtype=infer_dtype(e, env))
            except Exception:
                cols[name] = ColumnSchema(name=name, dtype=dt.ANY)
        schema = schema_from_columns(cols, name="AsofJoined")
        return Table(
            "custom", [lt, rt], {"lower": make_lower(out_exprs)}, schema, Universe()
        )

    def _resolve(self, e):
        e = smart_coerce(e)

        def rewrite(x):
            import copy

            if isinstance(x, ColumnReference):
                if x.table is pw_left:
                    return ColumnReference(self._left, x.name)
                if x.table is pw_right:
                    return ColumnReference(self._right, x.name)
                if x.table is this:
                    from ._shared import this_side as _this_side

                    side = _this_side(
                        x.name, self._left, self._right, "asof_join"
                    )
                    return ColumnReference(
                        self._left if side == "l" else self._right, x.name
                    )
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

        return rewrite(e)


def asof_join(
    self: Table, other: Table, self_time, other_time, *on: Any,
    how: JoinMode = JoinMode.LEFT, defaults: dict | None = None,
    direction: Direction = Direction.BACKWARD, behavior=None,
) -> AsofJoinResult:
    return AsofJoinResult(self, other, self_time, other_time, on, how, direction, defaults)


def asof_join_left(self, other, self_time, other_time, *on, **kw):
    return asof_join(self, other, self_time, other_time, *on, how=JoinMode.LEFT, **kw)


def asof_now_join(self: Table, other: Table, *on: Any, how: JoinMode = JoinMode.INNER, **kwargs):
    """Join each (query) row of self against other's CURRENT state; later
    changes to `other` never retract past outputs (reference
    ``_asof_now_join.py:176`` / UseExternalIndexAsOfNow semantics)."""
    from ...internals.joins import JoinResult

    jr = JoinResult(self, other, on, mode=how)
    jr._asof_now = True
    return jr
