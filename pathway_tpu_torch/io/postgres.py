"""``pw.io.postgres`` — PostgreSQL sink.

Re-design of the Rust ``PsqlWriter`` + ``PsqlUpdates``/``PsqlSnapshotFormatter``
(``src/connectors/data_storage.rs:1072``, ``data_format.rs:1632,1691``):
``write`` appends the full update stream (time/diff columns); ``write_snapshot``
maintains the current table state via per-key upserts/deletes. Gated on a
postgres client library (psycopg), matching the reference API.

Copy of ``pathway_tpu/io/postgres.py``, gated on ``psycopg``/``psycopg2``, without the
``write_torn`` hook of the ``sink.write`` chaos site (the port's delivery layer has none).
"""

from __future__ import annotations

from typing import Any

from ..internals.table import Table
from ._gated import require

__all__ = ["write", "write_snapshot"]


_SQL_TYPES = {
    "INT": "BIGINT", "FLOAT": "DOUBLE PRECISION", "BOOL": "BOOLEAN",
    "STR": "TEXT", "BYTES": "BYTEA", "POINTER": "BIGINT", "ANY": "TEXT",
    "JSON": "JSONB",
}


def _sql_type(dtype) -> str:
    from ..internals import dtype as dt

    u = dt.unoptionalize(dtype)
    return _SQL_TYPES.get(getattr(u, "name", str(u)), "TEXT")


def _init_table(conn, table, table_name: str, init_mode: str,
                extra_cols: list[str], primary_key: list[str] | None) -> None:
    """init_mode: default (table must exist) | create_if_not_exists |
    replace (reference data_storage.rs table init modes)."""
    if init_mode == "default":
        return
    cols = [
        f'{n} {_sql_type(cs.dtype)}'
        for n, cs in table.schema.columns().items()
    ] + extra_cols
    if primary_key:
        cols.append(f"PRIMARY KEY ({', '.join(primary_key)})")
    ddl = f"CREATE TABLE IF NOT EXISTS {table_name} ({', '.join(cols)})"
    with conn.cursor() as cur:
        if init_mode == "replace":
            cur.execute(f"DROP TABLE IF EXISTS {table_name}")
        cur.execute(ddl)
    conn.commit()


def _connect(postgres_settings: dict):
    try:
        import psycopg
    except ImportError:
        psycopg = None
    if psycopg is not None:
        return psycopg.connect(**postgres_settings)
    with require("psycopg2", "pw.io.postgres"):
        import psycopg2
    return psycopg2.connect(**postgres_settings)


def write(
    table: Table,
    postgres_settings: dict,
    table_name: str,
    *,
    max_batch_size: int | None = None,
    init_mode: str = "default",
    name: str | None = None,
    retry_policy: Any = None,
    **kwargs: Any,
) -> None:
    """Append every row update with time/diff (reference PsqlUpdates).
    Rows are batched per commit tick (and by max_batch_size) instead of
    one transaction per row."""
    conn = _connect(postgres_settings)
    _init_table(conn, table, table_name, init_mode,
                ["time BIGINT", "diff BIGINT"], None)
    from .delivery import CallableAdapter, deliver

    names = table.column_names()
    cols = ", ".join(names + ["time", "diff"])
    ph = ", ".join(["%s"] * (len(names) + 2))
    sql = f"INSERT INTO {table_name} ({cols}) VALUES ({ph})"

    def stage(batch):
        params = [
            [row[n] for n in names] + [batch.time, 1 if diff > 0 else -1]
            for row, diff in batch.rows()
        ]
        step = (
            max_batch_size
            if max_batch_size and max_batch_size > 0
            else len(params)
        )
        with conn.cursor() as cur:
            for i in range(0, len(params), max(1, step)):
                cur.executemany(sql, params[i : i + max(1, step)])

    def write_batch(batch):
        # ONE SQL transaction per sink batch: conn.commit() only after
        # every row landed, so a failed/torn attempt rolls back server-
        # side and the delivery layer's retry starts clean (genuinely
        # transactional re-delivery, the PsqlWriter analog)
        stage(batch)
        conn.commit()
        return None

    def rollback(_resume_token=None):
        try:
            conn.rollback()
        except Exception:
            pass

    def adapter():
        a = CallableAdapter(write_batch, "postgres", on_close=conn.close)
        a.rollback = rollback
        return a

    deliver(
        table, adapter,
        name=name,
        default_name=f"postgres-{table_name}",
        retry_policy=retry_policy,
    )


def write_snapshot(
    table: Table,
    postgres_settings: dict,
    table_name: str,
    primary_key: list[str],
    *,
    max_batch_size: int | None = None,
    init_mode: str = "default",
    name: str | None = None,
    retry_policy: Any = None,
    **kwargs: Any,
) -> None:
    """Maintain the current state: upsert on addition, delete on retraction
    (reference PsqlSnapshotFormatter). One SQL transaction per sink batch,
    delivered through the transactional output plane (io/delivery)."""
    conn = _connect(postgres_settings)
    _init_table(conn, table, table_name, init_mode, [], primary_key)
    from .delivery import CallableAdapter, deliver

    names = table.column_names()
    cols = ", ".join(names)
    ph = ", ".join(["%s"] * len(names))
    conflict = ", ".join(primary_key)
    updates = ", ".join(f"{n} = EXCLUDED.{n}" for n in names if n not in primary_key)
    upsert = (
        f"INSERT INTO {table_name} ({cols}) VALUES ({ph}) "
        f"ON CONFLICT ({conflict}) DO UPDATE SET {updates}"
    )
    where = " AND ".join(f"{k} = %s" for k in primary_key)
    delete = f"DELETE FROM {table_name} WHERE {where}"

    def stage(batch):
        with conn.cursor() as cur:
            for row, diff in batch.rows():
                if diff > 0:
                    cur.execute(upsert, [row[n] for n in names])
                else:
                    cur.execute(delete, [row[k] for k in primary_key])

    def write_batch(batch):
        stage(batch)
        conn.commit()
        return None

    def rollback(_resume_token=None):
        try:
            conn.rollback()
        except Exception:
            pass

    def adapter():
        a = CallableAdapter(write_batch, "postgres", on_close=conn.close)
        a.rollback = rollback
        return a

    deliver(
        table, adapter,
        name=name,
        default_name=f"postgres-snapshot-{table_name}",
        retry_policy=retry_policy,
    )
