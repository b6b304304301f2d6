"""pw.demo — synthetic streams (reference python/pathway/demo:28-240).

Copy of ``pathway_tpu/demo/__init__.py``.
"""

from __future__ import annotations

from typing import Any, Callable

from ..internals.schema import SchemaMetaclass, schema_from_types
from ..internals.table import Table
from ..internals.table_io import rows_to_table


def generate_custom_stream(
    value_generators: dict[str, Callable[[int], Any]],
    *,
    schema: SchemaMetaclass,
    nb_rows: int | None = 10,
    autocommit_duration_ms: int = 1000,
    input_rate: float = 1.0,
    persistent_storage: Any = None,
) -> Table:
    names = schema.column_names()
    rows = []
    times = []
    n = nb_rows if nb_rows is not None else 10
    for i in range(n):
        rows.append(tuple(value_generators[name](i) for name in names))
        times.append(2 * (i + 1))
    return rows_to_table(names, rows, schema=schema, times=times)


def range_stream(nb_rows: int = 30, offset: int = 0, **kwargs) -> Table:
    # reference demo/__init__.py range_stream: FLOAT values
    schema = schema_from_types(value=float)
    return generate_custom_stream(
        {"value": lambda i: float(i + offset)}, schema=schema, nb_rows=nb_rows
    )


def noisy_linear_stream(nb_rows: int = 10, **kwargs) -> Table:
    import random

    rng = random.Random(0)
    schema = schema_from_types(x=float, y=float)
    return generate_custom_stream(
        {"x": lambda i: float(i), "y": lambda i: i + rng.uniform(-1, 1)},
        schema=schema,
        nb_rows=nb_rows,
    )


def replay_csv(path: str, *, schema: SchemaMetaclass, input_rate: float = 1.0) -> Table:
    from ..io import csv as io_csv

    return io_csv.read(path, schema=schema, mode="static")
