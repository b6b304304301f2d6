"""Static / scheduled table construction (datasource layer).

Re-design of ``internals/table_io.py`` + ``datasource.py``: static tables
become engine StaticSource batches; definitions with ``__time__``/``__diff__``
columns become ScheduledSource schedules (the debug/stream-generator path).

Key derivation rules (match the reference's observable behavior):
- explicit integer ``id`` column → deterministic pointer per id
  (``unsafe_trusted_ids``, debug/__init__.py + python_api key for_value);
- ``id_from`` columns → pointer from those values (``Key::for_values``);
- otherwise content-fingerprint + row sequence, so identical definitions
  produce identical keys (what makes id-sensitive equality asserts work —
  reference caches static tables by content, debug/__init__.py:396-403).
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np

from ..engine import keys as K
from ..engine.delta import column_of_values
from . import dtype as dt
from .parse_graph import G, Universe
from .schema import ColumnSchema, SchemaMetaclass, schema_from_columns
from .table import Table


#: python types whose dtype depends only on the TYPE, so a column scan can
#: dedupe by set(map(type, ...)) (C-speed) instead of per-value inference —
#: datetimes excluded (naive vs utc depends on tzinfo), tuples excluded
#: (Tuple(args) depends on the content)
_TYPE_ONLY_DTYPES: dict[type, dt.DType] = {
    t: dt._FROM_PY[t]
    for t in (str, bool, int, float, bytes, type(None), dict)
}


def _infer_dtype_of_column(arr: "np.ndarray", vals: list) -> dt.DType:
    if arr.dtype == np.int64:
        return dt.INT
    if arr.dtype == np.float64:
        return dt.FLOAT
    if arr.dtype == np.bool_:
        return dt.BOOL
    if not vals:
        return dt.ANY
    types = set(map(type, vals))
    if all(t in _TYPE_ONLY_DTYPES for t in types):
        return dt.types_lca_many([_TYPE_ONLY_DTYPES[t] for t in types])
    # mixed/complex values (tuples, datetimes, arrays): per-value inference
    return dt.types_lca_many([dt.dtype_of_value(v) for v in vals])


def _infer_dtypes(
    names: list[str], data: dict[str, "np.ndarray"]
) -> dict[str, dt.DType]:
    return {
        name: _infer_dtype_of_column(
            data[name],
            list(data[name]) if data[name].dtype == object else [],
        )
        for name in names
    }


def _coerce_column(col: np.ndarray, target: dt.DType) -> np.ndarray:
    """Coerce parsed values to the declared schema dtype (reference: schema-
    driven conversion in table_from_pandas / connector parsers)."""
    u = dt.unoptionalize(target)
    conv = None
    if u == dt.STR:
        conv = str
    elif u == dt.INT:
        conv = int
    elif u == dt.FLOAT:
        conv = float
    elif u == dt.BOOL:
        conv = bool
    if conv is not None:
        if col.dtype == object or (u == dt.STR and col.dtype != object):
            out = np.empty(len(col), dtype=object)
            for i, v in enumerate(col):
                if isinstance(v, np.generic):
                    v = v.item()
                out[i] = None if v is None else conv(v)
            col = out
        elif u == dt.FLOAT and col.dtype == np.int64:
            return col.astype(np.float64)
        elif u == dt.INT and col.dtype == np.float64:
            return col.astype(np.int64)
        else:
            return col
    if col.dtype == object and not target.is_optional and target.numpy_dtype != np.dtype(object):
        try:
            return col.astype(target.numpy_dtype)
        except (ValueError, TypeError, OverflowError):
            # e.g. a python int beyond int64: the engine's general paths
            # handle big ints exactly as objects (vs the reference's hard
            # i64 Value::Int) — degrade, don't crash ingestion
            return col
    return col


def rows_to_table(
    names: list[str],
    rows: list[tuple],
    *,
    id_values: list[int] | None = None,
    id_from: Sequence[str] | None = None,
    schema: SchemaMetaclass | None = None,
    times: list[int] | None = None,
    diffs: list[int] | None = None,
) -> Table:
    """Build a static (or scheduled, when times given) table from rows."""
    if schema is not None:
        dtypes = schema.dtypes()
        names = [n for n in names if n in dtypes] + [n for n in dtypes if n not in names]
        col_order = list(dtypes.keys())
        if id_from is None:
            id_from = schema.primary_key_columns()
    else:
        col_order = names

    n = len(rows)
    _ix = {name: names.index(name) for name in col_order}
    data = {
        name: column_of_values([r[_ix[name]] for r in rows])
        for name in col_order
    }
    if schema is None:
        # infer from the BUILT columns: dense dtypes read off the array,
        # object columns dedupe by value type — O(distinct types), not
        # O(rows) python-level dtype_of_value calls
        dtypes = _infer_dtypes(col_order, data)
    for name in col_order:
        data[name] = _coerce_column(data[name], dtypes[name])

    if id_values is not None:
        keys = K.pointer_from_ints(np.asarray(id_values, dtype=np.int64))
    elif id_from:
        keys = K.mix_columns([data[c] for c in id_from], n)
    elif times is not None:
        # update streams: a __diff__=-1 row must retract the key of the
        # matching earlier insert, so keys derive from row CONTENT
        # (reference: content-fingerprint ids in table_from_pandas,
        # debug/__init__.py:380-384)
        keys = K.mix_columns([data[c] for c in col_order], n)
    else:
        # row-ordinal ids, exactly the reference's unindexed-table rule
        # (ids hash pandas' RangeIndex, debug/__init__.py:373-375): the
        # Nth row of ANY unindexed static table gets the same id as an
        # explicit integer index N. Content-independent — so a table
        # derived by select() compares index-equal to a freshly built
        # expected table, the contract the reference test corpus leans on.
        keys = K.pointer_from_ints(np.arange(n, dtype=np.int64))

    schema_obj = schema if schema is not None else schema_from_columns(
        {name: ColumnSchema(name=name, dtype=dtypes[name]) for name in col_order},
        name="Static",
    )

    if times is not None:
        diffs_arr = np.asarray(diffs if diffs is not None else [1] * n, dtype=np.int64)
        times_arr = np.asarray(times, dtype=np.int64)
        batches = []
        for t in sorted(set(times_arr.tolist())):
            idx = np.flatnonzero(times_arr == t)
            batches.append((
                int(t),
                keys[idx],
                {c: data[c][idx] for c in col_order},
                diffs_arr[idx],
            ))
        return Table(
            "scheduled",
            [],
            {"columns": col_order, "batches": batches},
            schema_obj,
            Universe(),
        )

    # the reference's static-tables universe cache (debug/__init__.py:
    # 384-401): two static tables built with the SAME id material — equal
    # explicit ids, equal id_from key columns, or equal unindexed row
    # counts — share one Universe, so columns of one are selectable into
    # the other without an explicit promise (the test-corpus contract).
    from .parse_graph import G

    if id_values is not None:
        cache_key = ("ids", tuple(id_values))
    elif id_from:
        cache_key = ("id_from", tuple(np.asarray(keys).tolist()))
    else:
        cache_key = ("ordinal", n)
    universe = G.static_tables_cache.get(cache_key)
    if universe is None:
        universe = Universe()
        G.static_tables_cache[cache_key] = universe
    return Table("static", [], {"keys": keys, "data": data}, schema_obj, universe)


def empty_table(schema: SchemaMetaclass) -> Table:
    return rows_to_table(schema.column_names(), [], schema=schema)


def table_from_datasource(datasource: Any) -> Table:
    """Source-node table: datasource.build() -> engine SourceNode."""
    return Table(
        "source",
        [],
        {"build": datasource.build, "datasource": datasource},
        datasource.schema,
        Universe(),
    )
