"""``pw.io.logstash`` — Logstash HTTP-input sink
(reference ``python/pathway/io/logstash``: a thin wrapper over the HTTP
writer pointing at Logstash's http input plugin).

Copy of ``pathway_tpu/io/logstash.py``.
"""

from __future__ import annotations

from typing import Any

from ..internals.table import Table
from . import http as _http

__all__ = ["write"]


def write(
    table: Table,
    endpoint: str,
    n_retries: int = 0,
    retry_policy: Any = None,
    **kwargs: Any,
) -> None:
    _http.write(
        table, endpoint, method="POST", format="json",
        n_retries=n_retries, retry_policy=retry_policy, **kwargs,
    )
