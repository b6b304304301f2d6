"""``pw.io.bigquery`` — BigQuery sink.

Re-design of ``python/pathway/io/bigquery``: streams the table's changes
into a BigQuery table via ``insert_rows_json``, with the reference's
``time``/``diff`` fields appended to every row. The connector logic is
complete and unit-tested with a fake client; only the real
``google-cloud-bigquery`` client construction is gated.

Copy of ``pathway_tpu/io/bigquery.py``, gated on ``google-cloud-bigquery``.
"""

from __future__ import annotations

from typing import Any

from ..internals.table import Table
from ._gated import unavailable

__all__ = ["write"]


def _bq_client(service_user_credentials_file: str | None):
    try:
        from google.cloud import bigquery  # type: ignore[attr-defined]
        from google.oauth2.service_account import (  # type: ignore[import-not-found]
            Credentials,
        )
    except ImportError:
        unavailable("pw.io.bigquery.write", "google-cloud-bigquery")
    creds = (
        Credentials.from_service_account_file(service_user_credentials_file)
        if service_user_credentials_file is not None else None
    )
    return bigquery.Client(credentials=creds)


def write(table: Table, dataset_name: str, table_name: str, *,
          service_user_credentials_file: str | None = None,
          name: str | None = None, _client: Any = None,
          **kwargs: Any) -> None:
    """Write ``table``'s change stream into ``dataset.table``; target schema
    must include integral ``time`` and ``diff`` fields (reference
    io/bigquery/__init__.py:55). ``_client`` injects anything exposing
    ``insert_rows_json(table_ref, rows) -> errors`` (tests use a fake)."""
    from .delivery import CallableAdapter, SinkRejectedError, deliver
    from .fs import _jsonable

    client = _client if _client is not None else _bq_client(
        service_user_credentials_file
    )
    table_ref = f"{dataset_name}.{table_name}"
    names = table.column_names()

    def write_batch(batch):
        cols = [batch.delta.data[n] for n in names]
        rows = []
        for vals, diff in zip(zip(*cols), batch.delta.diffs):
            row = {n: _jsonable(v) for n, v in zip(names, vals)}
            row["time"] = int(batch.time)
            row["diff"] = int(diff)
            rows.append(row)
        errors = client.insert_rows_json(table_ref, rows)
        if errors:
            # per-row insert errors are schema rejects, not transient
            # failures: dead-letter them instead of retrying forever.
            # BigQuery reports VALID rows of a failed insertAll with
            # reason "stopped" — those must redeliver, never dead-letter
            def _poison(entry) -> bool:
                errs = entry.get("errors") if isinstance(entry, dict) else None
                if not errs:
                    return True  # shapeless entry: treat as poison
                return any(
                    (e or {}).get("reason") != "stopped" for e in errs
                )

            indexed = [
                e for e in errors
                if isinstance(e, dict) and e.get("index") is not None
            ]
            bad = [int(e["index"]) for e in indexed if _poison(e)]
            stopped = {int(e["index"]) for e in indexed if not _poison(e)}
            unattributed_poison = any(
                not (isinstance(e, dict) and e.get("index") is not None)
                and _poison(e)
                for e in errors
            )
            if not bad and not unattributed_poison:
                # every entry is a "stopped" echo of some upstream failure
                # — nothing identifiably poison, so retry the whole batch
                raise RuntimeError(f"bigquery insert failed: {errors}")
            if unattributed_poison:
                # poison exists but can't be pinned to a row: dead-letter
                # everything EXCEPT the rows BigQuery explicitly marked
                # "stopped" (those are valid and must redeliver)
                bad = sorted(
                    set(range(len(rows))) - stopped | set(bad)
                )
            raise SinkRejectedError(
                f"bigquery insert failed: {errors}",
                row_indices=bad or None,
            )
        return None

    deliver(
        table,
        lambda: CallableAdapter(write_batch, "bigquery"),
        name=name,
        default_name=f"bigquery-{dataset_name}.{table_name}",
        retry_policy=kwargs.get("retry_policy"),
    )
