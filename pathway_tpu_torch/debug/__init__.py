"""``pw.debug`` — markdown tables, compute_and_print, pandas round-trips.

Re-design of ``python/pathway/debug/__init__.py`` (table_from_markdown :429,
compute_and_print :207, compute_and_print_update_stream :235, pandas
round-trips :270,343, StreamGenerator :496).

Copy of ``pathway_tpu/debug/__init__.py``. Every function that runs a graph
takes ``device=`` (default ``"cuda"``, as ``pw.run``); pandas is imported
inside the functions that use it.
"""

from __future__ import annotations

import re
from typing import Any, Iterable

import numpy as np

from ..internals import dtype as dt
from ..internals.graph_runner import GraphRunner
from ..internals.schema import SchemaMetaclass
from ..internals.table import Table
from ..internals.table_io import rows_to_table

__all__ = [
    "table_from_markdown",
    "parse_to_table",
    "table_from_rows",
    "table_from_pandas",
    "table_to_pandas",
    "table_from_parquet",
    "table_to_parquet",
    "table_from_dicts",
    "compute_and_print",
    "compute_and_print_update_stream",
    "table_to_dicts",
    "StreamGenerator",
]

_SPECIAL = ("__time__", "__diff__")


def _parse_value(tok: str) -> Any:
    if tok in ("", "None", "NA", "NULL", "NaN", "nan"):
        return None
    if tok == "True" or tok == "true":
        return True
    if tok == "False" or tok == "false":
        return False
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        return float(tok)
    except ValueError:
        pass
    return tok


def table_from_markdown(
    table_def: str,
    id_from: Any = None,
    unsafe_trusted_ids: bool = False,
    schema: SchemaMetaclass | None = None,
    *,
    _stacklevel: int = 1,
    split_on_whitespace: bool = True,
) -> Table:
    """Markdown/whitespace table definition → static (or scheduled) table.

    Special columns: ``__time__`` batches rows by timestamp, ``__diff__``
    (+1/-1) marks insert/delete — together they define an update stream.
    An empty-named or ``id`` first column provides trusted integer ids.
    """
    lines = [ln for ln in table_def.strip("\n").splitlines() if ln.strip()]
    sep = r"\s*\|\s*|\s+" if split_on_whitespace else r"\s*\|\s*"

    def split(line: str) -> list[str]:
        if split_on_whitespace and "|" in line:
            # pipe-delimited: EMPTY cells are meaningful (None values) —
            # "1 |  5  |" is id=1, next=5, prev=None (reference prev/next
            # tables); a leading empty header cell marks the id column
            return [t.strip() for t in line.strip().split("|")]
        toks = re.split(sep, line.strip())
        if split_on_whitespace:
            return [t for t in toks if t != ""]
        if toks and toks[0] == "":
            toks = toks[1:]
        if toks and toks[-1] == "":
            toks = toks[:-1]
        return toks

    names = split(lines[0])
    # leading empty / "id" header column = trusted integer ids
    has_id_col = bool(names) and names[0] in ("id", "")
    if has_id_col:
        names = names[1:]

    body_lines = [ln for ln in lines[1:] if not set(ln.strip()) <= set("-| ")]
    if not has_id_col and body_lines:
        # unnamed index column: rows have one extra leading value
        if all(len(split(ln)) == len(names) + 1 for ln in body_lines):
            probe = [split(ln)[0] for ln in body_lines]
            if all(re.fullmatch(r"-?\d+", t) for t in probe):
                has_id_col = True

    body_rows: list[list[Any]] = []
    id_values: list[int] = []
    for ln in body_lines:
        toks = split(ln)
        if has_id_col:
            id_values.append(int(toks[0]))
            toks = toks[1:]
        vals = [_parse_value(t) for t in toks]
        if len(vals) != len(names):
            raise ValueError(f"row {ln!r} has {len(vals)} values, expected {len(names)}")
        body_rows.append(vals)

    times = diffs = None
    if "__time__" in names:
        ti = names.index("__time__")
        times = [int(r[ti]) for r in body_rows]
    if "__diff__" in names:
        di = names.index("__diff__")
        diffs = [int(r[di]) for r in body_rows]
        if times is None:
            times = [0] * len(body_rows)
    keep = [i for i, nm in enumerate(names) if nm not in _SPECIAL]
    clean_names = [names[i] for i in keep]
    clean_rows = [tuple(r[i] for i in keep) for r in body_rows]

    if isinstance(id_from, str):
        id_from = [id_from]
    return rows_to_table(
        clean_names,
        clean_rows,
        id_values=id_values if has_id_col else None,
        id_from=id_from,
        schema=schema,
        times=times,
        diffs=diffs,
    )


def parse_to_table(*args: Any, **kwargs: Any) -> Table:
    return table_from_markdown(*args, **kwargs)


def table_from_rows(
    schema: SchemaMetaclass,
    rows: list[tuple],
    unsafe_trusted_ids: bool = False,
    is_stream: bool = False,
) -> Table:
    names = schema.column_names()
    if is_stream:
        times = [r[len(names)] for r in rows]
        diffs = [r[len(names) + 1] for r in rows] if len(rows) and len(rows[0]) > len(names) + 1 else None
        clean = [tuple(r[: len(names)]) for r in rows]
        return rows_to_table(names, clean, schema=schema, times=times, diffs=diffs)
    return rows_to_table(names, [tuple(r) for r in rows], schema=schema)


def table_from_pandas(
    df: Any,
    id_from: Any = None,
    unsafe_trusted_ids: bool = False,
    schema: SchemaMetaclass | None = None,
    _stacklevel: int = 1,
) -> Table:
    names = [str(c) for c in df.columns if str(c) not in _SPECIAL]
    # columnar extraction (iterrows is ~100x slower and upcasts dtypes)
    cols = []
    for c in names:
        arr = df[c].to_numpy()
        if arr.dtype.kind in ("i", "u", "b"):
            cols.append([v.item() for v in arr])
        elif arr.dtype.kind == "f":
            cols.append([None if np.isnan(v) else v.item() for v in arr])
        elif arr.dtype.kind in ("M", "m"):
            # datetime64/timedelta64: iterate the Series so pandas yields
            # Timestamp/Timedelta (.item() on ns precision returns raw ints)
            cols.append([_from_pandas_value(v) for v in df[c]])
        else:
            cols.append([_from_pandas_value(v) for v in arr])
    rows = list(zip(*cols)) if names else [() for _ in range(len(df))]
    times = [int(t) for t in df["__time__"]] if "__time__" in df.columns else None
    diffs = [int(d) for d in df["__diff__"]] if "__diff__" in df.columns else None
    id_values = None
    if df.index.name in ("id",) or (id_from is None and _looks_like_ids(df.index)):
        try:
            id_values = [int(i) for i in df.index]
        except (TypeError, ValueError):
            id_values = None
    if isinstance(id_from, str):
        id_from = [id_from]
    return rows_to_table(
        names, rows, id_values=id_values, id_from=id_from, schema=schema,
        times=times, diffs=diffs,
    )


def _looks_like_ids(index: Any) -> bool:
    try:
        arr = np.asarray(index)
        if arr.dtype.kind not in "iu":
            arr = arr.astype(np.int64)
        return not np.array_equal(arr, np.arange(len(arr)))
    except (TypeError, ValueError, KeyError, OverflowError):
        # e.g. python ints beyond int64 in the index: treat as opaque
        return False


def _from_pandas_value(v: Any) -> Any:
    if v is None:
        return None
    if isinstance(v, float) and np.isnan(v):
        return None
    if isinstance(v, np.generic):
        if isinstance(v, np.floating) and np.isnan(v):
            return None
        return v.item()
    return v


def _run_capture(table: Table, device: str = "cuda"):
    (cap,) = GraphRunner(device).run_tables(table)
    return cap


def _format_pointer(key: int) -> str:
    return "^" + format(int(key), "016X")


def compute_and_print(
    table: Table,
    *,
    include_id: bool = True,
    short_pointers: bool = True,
    n_rows: int | None = None,
    squash_updates: bool = True,
    terminate_on_error: bool = True,
    device: str = "cuda",
) -> None:
    """Run the graph and print the consolidated table (reference :207)."""
    cap = _run_capture(table, device)
    names = table.column_names()
    items = sorted(cap.state.iter_items(), key=lambda kv: kv[0])
    if n_rows is not None:
        items = items[:n_rows]
    header = (["id"] if include_id else []) + names
    rows = []
    for key, row in items:
        cells = [_format_pointer(key)] if include_id else []
        cells += [_format_cell(v, short_pointers) for v in row]
        rows.append(cells)
    _print_table(header, rows)


def compute_and_print_update_stream(
    table: Table,
    *,
    include_id: bool = True,
    short_pointers: bool = True,
    n_rows: int | None = None,
    device: str = "cuda",
    **kwargs: Any,
) -> None:
    """Run the graph and print the full (time, diff) update stream."""
    cap = _run_capture(table, device)
    names = table.column_names()
    header = (["id"] if include_id else []) + names + ["__time__", "__diff__"]
    rows = []
    stream = cap.stream if n_rows is None else cap.stream[:n_rows]
    for time, key, row, diff in stream:
        cells = [_format_pointer(key)] if include_id else []
        cells += [_format_cell(v, short_pointers) for v in row]
        cells += [str(time), str(diff)]
        rows.append(cells)
    _print_table(header, rows)


def _format_cell(v: Any, short_pointers: bool) -> str:
    if isinstance(v, (np.uint64,)) and short_pointers:
        return _format_pointer(int(v))
    if isinstance(v, np.generic):
        v = v.item()
    return repr(v) if isinstance(v, str) else str(v)


def _render_table(header: list[str], rows: list[list[str]]) -> str:
    widths = [len(h) for h in header]
    for r in rows:
        widths = [max(w, len(c)) for w, c in zip(widths, r)]
    lines = [" | ".join(h.ljust(w) for h, w in zip(header, widths))]
    lines += [" | ".join(c.ljust(w) for c, w in zip(r, widths)) for r in rows]
    return "\n".join(lines)


def _print_table(header: list[str], rows: list[list[str]]) -> None:
    print(_render_table(header, rows))


def table_to_dicts(table: Table, *, device: str = "cuda"):
    cap = _run_capture(table, device)
    names = table.column_names()
    keys = []
    cols: dict[str, dict] = {n: {} for n in names}
    for key, row in cap.state.iter_items():
        keys.append(key)
        for n, v in zip(names, row):
            cols[n][key] = v
    return keys, cols


def table_from_dicts(data: dict[str, dict], schema: SchemaMetaclass | None = None) -> Table:
    names = list(data.keys())
    all_keys = sorted({k for col in data.values() for k in col})
    rows = [tuple(data[n][k] for n in names) for k in all_keys]
    return rows_to_table(names, rows, id_values=list(all_keys), schema=schema)


def table_to_pandas(table: Table, *, include_id: bool = True, device: str = "cuda"):
    import pandas as pd

    import datetime as _datetime

    cap = _run_capture(table, device)
    names = table.column_names()
    items = sorted(cap.state.iter_items(), key=lambda kv: kv[0])
    data: dict[str, Any] = {}
    for i, n in enumerate(names):
        col = [row[i] for _, row in items]
        # keep datetime cells as python objects: pandas would coerce them
        # to datetime64[ns], and numpy 2 renders ns-precision items back
        # as raw integer nanoseconds under .values.tolist() — the
        # reference hands out Timestamp-like objects here, so tests (and
        # users) call .hour/.year on the cells
        if any(isinstance(v, _datetime.datetime) for v in col):
            data[n] = pd.Series(col, dtype=object, index=[k for k, _ in items])
        else:
            data[n] = col
    if include_id:
        return pd.DataFrame(data, index=[k for k, _ in items])
    return pd.DataFrame(
        {
            n: (c.reset_index(drop=True) if isinstance(c, pd.Series) else c)
            for n, c in data.items()
        }
    )


class StreamGenerator:
    """Deterministic artificial timestamped streams (reference :496)."""

    def __init__(self) -> None:
        self._time = 0

    def table_from_list_of_batches_by_workers(
        self, batches: list[dict[int, list[dict[str, Any]]]], schema: SchemaMetaclass
    ) -> Table:
        rows: list[tuple] = []
        times: list[int] = []
        names = schema.column_names()
        for t, batch in enumerate(batches):
            for _worker, entries in batch.items():
                for entry in entries:
                    rows.append(tuple(entry[n] for n in names))
                    times.append(2 * (t + 1))
        return rows_to_table(names, rows, schema=schema, times=times)

    def table_from_list_of_batches(
        self, batches: list[list[dict[str, Any]]], schema: SchemaMetaclass
    ) -> Table:
        return self.table_from_list_of_batches_by_workers(
            [{0: b} for b in batches], schema
        )


def _format_snapshot(names: list[str], rows: dict[int, tuple], frontier: int) -> str:
    """Render a LiveTable snapshot (internals/interactive.py) in the same
    table format compute_and_print uses, returned as a string."""
    header = ["id"] + names
    lines = [
        [_format_pointer(key)] + [_format_cell(v, True) for v in row]
        for key, row in sorted(rows.items())
    ]
    return _render_table(header, lines) + f"\n[frontier {frontier}]"


def table_from_parquet(path, id_from=None, unsafe_trusted_ids=False):
    """Static table from a parquet file (reference debug/__init__.py
    table_from_parquet — pandas/pyarrow round-trip)."""
    import pandas as pd

    df = pd.read_parquet(path)
    return table_from_pandas(
        df, id_from=id_from, unsafe_trusted_ids=unsafe_trusted_ids
    )


def table_to_parquet(table, path, *, device: str = "cuda"):
    """Write a (finite) table to a parquet file (reference
    table_to_parquet)."""
    df = table_to_pandas(table, include_id=False, device=device)
    df = df.reset_index(drop=True)
    return df.to_parquet(path)
