"""Columnar-native ingest parsing — chunked readers that go straight
from raw connector bytes/lines into typed column buffers.

The reference's Rust connector driver parses straight into typed
``Value``s with no per-row Python anywhere (``data_format.rs`` DsvParser
/ JsonLinesParser); this module is that property from Python: one
``csv.reader`` / ``json.loads`` pass per CHUNK, then schema-aware dtype
promotion per COLUMN (numpy's str→int64/float64 element conversion
delegates to Python's ``int()``/``float()``, so a promoted cell is
bit-identical to the per-row ``_convert`` path — verified by the
dtype-promotion parity matrix in tests/test_columnar_ingest.py).

The contract with the legacy per-row dict path is *refusal, never
divergence*: any chunk whose columnar parse cannot be proven
bit-identical (ragged rows, empty cells with default/optional
semantics, a mixed int/float JSON column whose whole-column promotion
would batch-poison the row keys, a cell numpy's parser rejects) raises
:class:`ParseRefusal` and the caller re-parses THAT chunk per row —
same values, same keys, same exceptions as before the columnar plane
existed. ``PATHWAY_INGEST_COLUMNAR=0`` turns the whole plane off.

Copy of ``pathway_tpu/io/columnar.py`` without its ``pyarrow.csv`` fast path
and the ``PATHWAY_INGEST_PYARROW`` switch: on the H100 machine's host that
path parsed the csv lane about 14x slower than ``csv.reader`` and numpy for
the same table (``PERF.md``, the files phase), so csv chunks take the numpy path. The
remaining switches hide no device and no kernel.
"""

from __future__ import annotations

import csv as _csv
import json
import os
from typing import Any

import numpy as np

__all__ = [
    "ParseRefusal",
    "enabled",
    "chunk_rows",
    "csv_plan",
    "parse_csv_chunk",
    "parse_json_chunk",
    "parse_plaintext_chunk",
]


class ParseRefusal(Exception):
    """A chunk the columnar parser cannot prove bit-identical to the
    per-row dict path — the caller falls back to row-at-a-time parsing
    for exactly this chunk (errors and values land as they always did)."""


def enabled() -> bool:
    """Escape hatch for the whole columnar ingest plane
    (``PATHWAY_INGEST_COLUMNAR``, default on)."""
    from ..internals.config import _env_bool

    return _env_bool("PATHWAY_INGEST_COLUMNAR", True)


def chunk_rows() -> int:
    """Rows per columnar parse chunk (``PATHWAY_INGEST_CHUNK``): bounds
    both the transient parse buffers and the blast radius of one
    :class:`ParseRefusal` fallback."""
    try:
        return max(1, int(os.environ.get("PATHWAY_INGEST_CHUNK", "32768")))
    except ValueError:
        return 32768


# -- CSV ---------------------------------------------------------------

#: truthy spellings of fs._convert's BOOL parse — must stay in lockstep
_TRUE_SET = ("true", "1", "yes", "on")


def csv_plan(schema, names: list[str]) -> list[tuple[str, str, bool]]:
    """Per-column parse plan ``(name, kind, empty_special)`` derived from
    the declared schema. ``kind`` mirrors fs._convert's dispatch (INT /
    FLOAT / BOOL parse, everything else passes the cell string through);
    ``empty_special`` marks columns where an empty cell means "use the
    schema default / None" rather than "parse the empty string" — those
    chunks must take the per-row path."""
    from ..internals import dtype as dt

    plan = []
    cols = schema.columns()
    for n in names:
        col = cols[n]
        u = dt.unoptionalize(col.dtype)
        if u == dt.INT:
            kind = "int"
        elif u == dt.FLOAT:
            kind = "float"
        elif u == dt.BOOL:
            kind = "bool"
        else:
            kind = "str"  # _convert's fallthrough: cell string unchanged
        empty_special = bool(getattr(col, "has_default", False)) or bool(
            getattr(col.dtype, "is_optional", False)
        )
        plan.append((n, kind, empty_special))
    return plan


def _promote_cells(cells: list[str], kind: str, empty_special: bool) -> np.ndarray:
    """One column of raw CSV cell strings → a typed array with
    fs._convert semantics. numpy's element-wise str conversion calls
    Python's ``int()``/``float()``, so values are bit-identical; any
    cell it rejects raises ValueError → refusal → the per-row fallback
    re-raises the same error the dict path always raised."""
    if empty_special and "" in cells:
        # empty cell → schema default / None: per-row semantics, refuse
        raise ParseRefusal("empty cell with default/optional semantics")
    if kind == "int":
        try:
            return np.array(cells, dtype=np.int64)
        except (ValueError, OverflowError) as e:
            raise ParseRefusal(str(e))
    if kind == "float":
        try:
            return np.array(cells, dtype=np.float64)
        except (ValueError, OverflowError) as e:
            raise ParseRefusal(str(e))
    if kind == "bool":
        return np.array(
            [c.strip().lower() in _TRUE_SET for c in cells], dtype=np.bool_
        )
    out = np.empty(len(cells), dtype=object)
    out[:] = cells
    return out


def parse_csv_chunk(
    lines: list[str],
    header: list[str],
    plan: list[tuple[str, str, bool]],
    delimiter: str = ",",
) -> tuple[dict[str, np.ndarray], int]:
    """A chunk of raw CSV data lines (newline-stripped) → typed columns.

    One ``csv.reader`` pass over the whole chunk, then per-column
    declared-dtype promotion.
    Raises :class:`ParseRefusal` when bit-parity with the per-line
    ``dict(zip(header, cells))`` path cannot be guaranteed."""
    n = len(lines)
    rows = list(_csv.reader(lines, delimiter=delimiter))
    if len(rows) != n:
        # an unterminated quote merges records across lines — the
        # per-line reader sees something else entirely
        raise ParseRefusal("csv record count mismatch")
    # duplicate header names: dict(zip(...)) keeps the LAST occurrence,
    # and so does this forward-build index
    idx = {h: i for i, h in enumerate(header)}
    data: dict[str, np.ndarray] = {}
    for name, kind, empty_special in plan:
        j = idx.get(name)
        if j is None:
            cells = [""] * n
        else:
            try:
                cells = [r[j] for r in rows]
            except IndexError:
                # short rows: zip() semantics pad missing cells with ""
                cells = [r[j] if j < len(r) else "" for r in rows]
        data[name] = _promote_cells(cells, kind, empty_special)
    return data, n


# -- jsonlines ---------------------------------------------------------


def parse_json_chunk(
    lines: list[str], names: list[str]
) -> tuple[dict[str, np.ndarray], int]:
    """A chunk of jsonlines → columns via ONE ``json.loads`` over the
    comma-joined chunk (C-speed; no per-line decode). Value and dtype
    parity with the per-line path comes from running the same
    ``column_of_values`` promotion over the same extracted values —
    except a mixed int/float column, which is REFUSED: whole-column
    float64 promotion would hash this chunk's int cells as floats while
    the dict path hashes the raw per-row scalars (batch-dependent keys,
    whose retractions then miss the rows they name)."""
    from ..engine.delta import column_of_values

    try:
        objs = json.loads("[" + ",".join(lines) + "]")
    except ValueError as e:
        raise ParseRefusal(str(e))
    if len(objs) != len(lines):
        # a line holding several JSON docs parses differently per line
        raise ParseRefusal("json doc count mismatch")
    data: dict[str, np.ndarray] = {}
    for n_ in names:
        try:
            vals = [o.get(n_) for o in objs]
        except AttributeError:
            raise ParseRefusal("non-object json line")
        arr = column_of_values(vals)
        if arr.dtype == np.float64 and any(type(v) is int for v in vals):
            raise ParseRefusal("mixed int/float json column")
        data[n_] = arr
    return data, len(objs)


# -- plaintext ---------------------------------------------------------


def parse_plaintext_chunk(
    lines: list[str], name: str = "data"
) -> tuple[dict[str, np.ndarray], int]:
    """Plaintext chunk → one object column of the line strings (exactly
    what ``column_of_values`` over per-row ``(line,)`` tuples builds)."""
    out = np.empty(len(lines), dtype=object)
    out[:] = lines
    return {name: out}, len(lines)
