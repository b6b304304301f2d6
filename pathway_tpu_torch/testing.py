"""Test utilities mirroring the reference's behavioral-spec style
(``python/pathway/tests/utils.py:531-556``): markdown tables in, run the
whole engine in-process, assert captured streams equal.

Copy of ``pathway_tpu/testing.py``. Every helper that runs a graph takes
``device=`` (default ``"cuda"``, as ``pw.run``).
"""

from __future__ import annotations

from typing import Any

import numpy as np

from .debug import table_from_markdown
from .internals.graph_runner import GraphRunner
from .internals.table import Table

__all__ = [
    "T",
    "run_table",
    "assert_table_equality",
    "assert_table_equality_wo_index",
    "assert_table_equality_wo_types",
    "assert_table_equality_wo_index_types",
    "assert_stream_equality",
]


def T(*args: Any, **kwargs: Any) -> Table:
    return table_from_markdown(*args, **kwargs)


def run_table(table: Table, *, device: str = "cuda"):
    """Run the graph and return {key: row_tuple} + column names."""
    (cap,) = GraphRunner(device).run_tables(table)
    return dict(cap.state.iter_items()), cap.column_names


def run_tables(*tables: Table, device: str = "cuda"):
    caps = GraphRunner(device).run_tables(*tables)
    return [(dict(c.state.iter_items()), c.column_names) for c in caps]


def _norm(v: Any) -> Any:
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, np.ndarray):
        return ("ndarray", v.shape, tuple(v.reshape(-1).tolist()))
    if isinstance(v, tuple):
        return tuple(_norm(x) for x in v)
    return v


def _norm_row(row: tuple) -> tuple:
    return tuple(_norm(v) for v in row)


def assert_table_equality(
    t1: Table, t2: Table, check_types: bool = True, *, device: str = "cuda"
) -> None:
    """Equality including row keys (ids)."""
    (d1, names1), (d2, names2) = run_tables(t1, t2, device=device)
    assert names1 == names2, f"column names differ: {names1} vs {names2}"
    if check_types:
        _check_types(t1, t2)
    r1 = {k: _norm_row(v) for k, v in d1.items()}
    r2 = {k: _norm_row(v) for k, v in d2.items()}
    assert r1 == r2, _diff_msg(r1, r2, names1)


def assert_table_equality_wo_index(
    t1: Table, t2: Table, check_types: bool = True, *, device: str = "cuda"
) -> None:
    """Equality of row multisets, ignoring ids."""
    (d1, names1), (d2, names2) = run_tables(t1, t2, device=device)
    assert names1 == names2, f"column names differ: {names1} vs {names2}"
    if check_types:
        _check_types(t1, t2)
    from collections import Counter

    c1 = Counter(_norm_row(v) for v in d1.values())
    c2 = Counter(_norm_row(v) for v in d2.values())
    assert c1 == c2, f"rows differ:\n only-left={c1 - c2}\n only-right={c2 - c1}"


def assert_table_equality_wo_types(t1: Table, t2: Table, *, device: str = "cuda") -> None:
    assert_table_equality(t1, t2, check_types=False, device=device)


def assert_table_equality_wo_index_types(
    t1: Table, t2: Table, *, device: str = "cuda"
) -> None:
    assert_table_equality_wo_index(t1, t2, check_types=False, device=device)


def assert_stream_equality(t1: Table, t2: Table, *, device: str = "cuda") -> None:
    """Equality of the full (time, key, row, diff) update streams."""
    caps = GraphRunner(device).run_tables(t1, t2)
    s1 = sorted((t, int(k), _norm_row(r), d) for t, k, r, d in caps[0].stream)
    s2 = sorted((t, int(k), _norm_row(r), d) for t, k, r, d in caps[1].stream)
    assert s1 == s2, f"streams differ:\n{s1}\nvs\n{s2}"


def _check_types(t1: Table, t2: Table) -> None:
    from .internals import dtype as dt

    d1, d2 = t1.schema.dtypes(), t2.schema.dtypes()
    for name in d1:
        a, b = d1[name], d2[name]
        if a == dt.ANY or b == dt.ANY:
            continue
        assert a == b or dt.unoptionalize(a) == dt.unoptionalize(b), (
            f"column {name!r}: dtype {a!r} != {b!r}"
        )


def _diff_msg(r1: dict, r2: dict, names: list[str]) -> str:
    only1 = {k: v for k, v in r1.items() if r2.get(k) != v}
    only2 = {k: v for k, v in r2.items() if r1.get(k) != v}
    return (
        f"tables differ (columns {names}):\n"
        f"  left-only/changed: {dict(list(only1.items())[:5])}\n"
        f"  right-only/changed: {dict(list(only2.items())[:5])}"
    )
