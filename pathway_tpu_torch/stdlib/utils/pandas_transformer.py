"""``pandas_transformer`` (reference
``python/pathway/stdlib/utils/pandas_transformer.py:124``): run a
pandas-DataFrame function over live tables.

The engine node keeps the consolidated state of every input table; on any
change it rebuilds the input DataFrames (indexed by row key), re-runs the
user function, and emits the diff between the new and previous output —
so the pandas computation behaves incrementally at table granularity.

Copy of ``pathway_tpu/stdlib/utils/pandas_transformer.py``, over the port's Table API and engine nodes.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np

from ...engine.delta import Delta, rows_to_columns
from ...engine.executor import Node
from ...engine.state import RowState
from ...internals.parse_graph import Universe
from ...internals.schema import SchemaMetaclass
from ...internals.table import Table
from ...io._gated import unavailable

__all__ = ["pandas_transformer"]


class _PandasRecomputeNode(Node):
    def __init__(self, inputs: list[Node], fn: Callable, out_names: list[str]):
        super().__init__(inputs, list(out_names))
        self._states = [RowState(inp.column_names) for inp in inputs]
        self._fn = fn
        self._prev: dict[int, tuple] = {}

    def exchange_specs(self):
        # the function sees whole tables: every input row goes to worker 0 (the reference
        # routes none, so at 2 and more workers each worker there sees its own shard)
        return [("gather",) for _ in self.inputs]

    def _frames(self):
        import pandas as pd

        frames = []
        for st in self._states:
            keys = list(st._rows.keys())
            keys = [k for k in keys if st._counts.get(k, 0) > 0]
            data = {
                c: [st.get(k)[i] for k in keys]
                for i, c in enumerate(st.columns)
            }
            frames.append(pd.DataFrame(data, index=pd.Index(keys, dtype=np.uint64)))
        return frames

    def process(self, time: int, ins: list[Delta | None]) -> Delta | None:
        changed = False
        for st, d in zip(self._states, ins):
            if d is not None and len(d):
                st.apply(d.consolidated())
                changed = True
        if not changed:
            return None
        out_df = self._fn(*self._frames())
        current: dict[int, tuple] = {}
        for key, row in zip(out_df.index, out_df.itertuples(index=False, name=None)):
            current[int(key)] = tuple(
                row[out_df.columns.get_loc(c)] for c in self.column_names
            )
        events: list[tuple[int, tuple, int]] = []
        for key, row in current.items():
            old = self._prev.get(key)
            if old is None:
                events.append((key, row, 1))
            elif old != row:
                events.append((key, old, -1))
                events.append((key, row, 1))
        for key, old in self._prev.items():
            if key not in current:
                events.append((key, old, -1))
        self._prev = current
        if not events:
            return None
        keys = np.array([k for k, _, _ in events], dtype=np.uint64)
        diffs = np.array([d for _, _, d in events], dtype=np.int64)
        rows = [r for _, r, _ in events]
        return Delta(
            keys=keys, data=rows_to_columns(rows, self.column_names), diffs=diffs
        )


def _import_pandas() -> None:
    """Import pandas on the caller's thread, or raise in the port's words where it is missing.
    The engine's workers import it again when they build the frames; a first import there, on a
    thread that ends with the run, left pyarrow's string arrays to crash the next run."""
    try:
        import pandas  # noqa: F401
    except ImportError:
        unavailable("pw.utils.pandas_transformer", "pandas")


def pandas_transformer(
    output_schema: SchemaMetaclass,
    output_universe: Any = None,
) -> Callable:
    """Decorator: a function of DataFrames (indexed by row key) becomes a
    function of Tables returning a Table (reference :124). The returned
    DataFrame's index determines output row keys — keep the input index to
    stay aligned with an input universe."""

    _import_pandas()

    def wrapper(fn: Callable) -> Callable:
        def wrapped(*tables: Table) -> Table:
            out_names = output_schema.column_names()

            def lower(runner, tbl):
                in_nodes = [runner.lower(t) for t in tables]
                return runner._add(
                    _PandasRecomputeNode(in_nodes, fn, out_names)
                )

            return Table(
                "custom", list(tables), {"lower": lower}, output_schema, Universe()
            )

        return wrapped

    return wrapper
