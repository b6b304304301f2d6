"""Shared helpers for the temporal family (joins + window behaviors).

Copy of ``pathway_tpu/stdlib/temporal/_shared.py``, over the port's Table API and engine nodes.
"""

from __future__ import annotations

from typing import Any

from ...internals.table import Table

__all__ = ["this_side", "apply_behavior_nodes"]


def apply_behavior_nodes(
    table: Table,
    buffer_expr: Any,
    cutoff_expr: Any,
    watermark_col: str,
    keep_results: bool,
) -> Table:
    """Wrap ``table`` with the engine's temporal behavior nodes: rows whose
    ``cutoff_expr`` lies before the event-time watermark (max value of
    ``watermark_col`` seen) are dropped (and, with ``keep_results=False``,
    retracted once passed); rows are buffered until the watermark reaches
    ``buffer_expr``. Shared scaffold for windowby behaviors and the
    per-side interval_join behaviors."""
    from ...engine import operators as ops
    from ...internals.expression_compiler import compile_expr
    from ...internals.parse_graph import Universe
    from ...internals.expression import smart_coerce
    from ...internals.thisclass import substitute, this

    if buffer_expr is None and cutoff_expr is None:
        return table
    base_cols = table.column_names()
    schema = table.schema

    def lower(runner, tbl):
        inner = table
        exprs = {}
        if buffer_expr is not None:
            exprs["__buf"] = substitute(smart_coerce(buffer_expr), {this: inner})
        if cutoff_expr is not None:
            exprs["__cut"] = substitute(smart_coerce(cutoff_expr), {this: inner})
        node, env = runner._zip_env(inner, exprs)
        rw = {c: (lambda cols_, keys_, n=c: cols_[n]) for c in base_cols}
        for name, e in exprs.items():
            rw[name] = compile_expr(e, env).fn
        node = runner._add(ops.Rowwise(node, rw))
        # cutoff BEFORE buffer: lateness is judged at arrival time, and
        # buffered rows released later must still pass through
        if cutoff_expr is not None:
            node = runner._add(ops.ForgetAfter(
                node, "__cut", forget_state=not keep_results,
                watermark_col=watermark_col,
            ))
        if buffer_expr is not None:
            node = runner._add(ops.BufferUntil(
                node, "__buf", watermark_col=watermark_col
            ))
        return runner._add(ops.Rowwise(
            node, {c: (lambda cols_, keys_, n=c: cols_[n]) for c in base_cols}
        ))

    return Table("custom", [table], {"lower": lower}, schema, Universe())


def this_side(name: str, lt: Table, rt: Table, ctx: str) -> str:
    """Which side a ``pw.this.name`` reference means in a two-sided join
    result: 'l' or 'r' by column-name lookup, refusing ambiguity (the
    plain-join model: joins.py ``_lookup``)."""
    in_l = name in lt.column_names()
    in_r = name in rt.column_names()
    if in_l and in_r:
        raise ValueError(
            f"column {name!r} exists on both sides of the {ctx}; "
            "use pw.left / pw.right to disambiguate"
        )
    if in_l:
        return "l"
    if in_r:
        return "r"
    raise AttributeError(f"{ctx} result has no column {name!r}")
