"""``pw.io.elasticsearch`` — Elasticsearch sink (reference Rust
``ElasticSearchWriter``, ``src/connectors/data_storage.rs:1328``). Gated on
the ``elasticsearch`` client library.

Copy of ``pathway_tpu/io/elasticsearch.py``, gated on ``elasticsearch``.
"""

from __future__ import annotations

from typing import Any

from ..internals.table import Table
from ._gated import require

__all__ = ["write", "ElasticSearchAuth", "ElasticSearchParams"]


class ElasticSearchAuth:
    def __init__(self, kind: str, **kwargs: Any):
        self.kind = kind
        self.options = kwargs

    @classmethod
    def basic(cls, username: str, password: str) -> "ElasticSearchAuth":
        return cls("basic", username=username, password=password)

    @classmethod
    def apikey(cls, apikey_id: str, apikey: str) -> "ElasticSearchAuth":
        return cls("apikey", apikey_id=apikey_id, apikey=apikey)

    @classmethod
    def bearer(cls, bearer: str) -> "ElasticSearchAuth":
        return cls("bearer", bearer=bearer)


class ElasticSearchParams:
    def __init__(self, host: str, index_name: str, auth: ElasticSearchAuth):
        self.host = host
        self.index_name = index_name
        self.auth = auth


def write(table: Table, host: str | None = None, auth: ElasticSearchAuth | None = None,
          index_name: str | None = None, name: str | None = None,
          retry_policy: Any = None, **kwargs: Any) -> None:
    with require("elasticsearch", "pw.io.elasticsearch"):
        import elasticsearch as es_mod
    client_kwargs: dict[str, Any] = {"hosts": [host]}
    if auth is not None:
        if auth.kind == "basic":
            client_kwargs["basic_auth"] = (
                auth.options["username"], auth.options["password"]
            )
        elif auth.kind == "apikey":
            client_kwargs["api_key"] = (
                auth.options["apikey_id"], auth.options["apikey"]
            )
        elif auth.kind == "bearer":
            client_kwargs["bearer_auth"] = auth.options["bearer"]
    client = es_mod.Elasticsearch(**client_kwargs)
    from .delivery import CallableAdapter, deliver

    names = table.column_names()

    def write_batch(batch):
        for row, diff in batch.rows():
            if diff > 0:
                client.index(
                    index=index_name, document={n: row[n] for n in names}
                )
        return None

    deliver(
        table,
        lambda: CallableAdapter(write_batch, "elasticsearch"),
        name=name,
        default_name=f"elasticsearch-{index_name}",
        retry_policy=retry_policy,
    )
