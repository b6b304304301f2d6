"""``pw.io.http`` — HTTP streaming client + REST server connector
(reference ``python/pathway/io/http``).

Copy of ``pathway_tpu/io/http/__init__.py``: ``read`` and ``write`` are gated on ``requests``.
The retry surface is the shared :class:`pathway_tpu_torch.io.delivery.RetryPolicy`
(re-exported here for the reference-compatible import path); both the
streaming reader below and the delivery-managed writer ride it instead of
hand-rolled backoff loops."""

from __future__ import annotations

import json
import time as _time
from typing import Any, Callable

from ...internals.schema import SchemaMetaclass
from ...internals.table import Table
from .._gated import require
from ..delivery import RetryPolicy
from ._server import PathwayWebserver, rest_connector

__all__ = ["rest_connector", "PathwayWebserver", "read", "write", "RetryPolicy"]


def _retrying(attempts: int, policy: RetryPolicy):
    """Shared attempt loop: yields attempt indices, sleeping the policy's
    jittered backoff between them. The caller breaks on success; the last
    attempt's exception propagates (the generator simply runs out)."""
    for attempt in range(1, attempts + 1):
        if attempt > 1:
            _time.sleep(policy.delay_s(attempt - 1))
        yield attempt


def read(
    url: str,
    *,
    schema: SchemaMetaclass | None = None,
    method: str = "GET",
    payload: Any = None,
    headers: dict[str, str] | None = None,
    response_mapper: Callable[[bytes], dict] | None = None,
    format: str = "json",
    delimiter: str | None = None,
    n_retries: int = 0,
    autocommit_duration_ms: int | None = 1000,
    allow_redirects: bool = True,
    retry_policy: RetryPolicy | None = None,
    content_type: str = "application/json",
) -> Table:
    """Streaming HTTP read: long-poll ``url`` and emit one row per
    JSON line / delimiter chunk (reference io/http streaming client)."""
    with require("requests", "pw.io.http.read"):
        import requests as _requests

    from ..python import ConnectorSubject, read as python_read

    if schema is None:
        raise ValueError("schema is required")

    policy = retry_policy or RetryPolicy.default()
    attempts = max(1, n_retries + 1)
    sep = delimiter.encode() if isinstance(delimiter, str) else delimiter

    class _HttpSubject(ConnectorSubject):
        def run(self) -> None:
            last: BaseException | None = None
            for _attempt in _retrying(attempts, policy):
                try:
                    resp = _requests.request(
                        method, url, json=payload, headers=headers, stream=True,
                        allow_redirects=allow_redirects, timeout=300,
                    )
                    resp.raise_for_status()
                    for line in resp.iter_lines(delimiter=sep):
                        if not line:
                            continue
                        if response_mapper is not None:
                            row = response_mapper(line)
                        elif format == "json":
                            row = json.loads(line)
                        else:
                            row = {"data": line.decode()}
                        if row is not None:
                            self.next(**row)
                    last = None
                    break
                except Exception as e:
                    last = e
            if last is not None:
                raise last
            self.close()

    return python_read(
        _HttpSubject(), schema=schema,
        autocommit_duration_ms=autocommit_duration_ms,
    )


def write(
    table: Table,
    url: str,
    *,
    method: str = "POST",
    format: str = "json",
    request_payload_template: str | None = None,
    n_retries: int = 0,
    headers: dict[str, str] | None = None,
    retry_policy: RetryPolicy | None = None,
    name: str | None = None,
) -> None:
    """POST one request per row change, through the delivery layer: the
    writer thread, retry/backoff, circuit breaker, bounded buffering and
    the dead-letter queue all come from ``io/delivery`` (the reference
    likewise runs sink I/O off the worker loop). ``n_retries`` folds into
    the policy for reference-surface compatibility."""
    with require("requests", "pw.io.http.write"):
        import requests as _requests

    from ..delivery import CallableAdapter, deliver
    from ._server import _dumps

    if retry_policy is None and n_retries:
        retry_policy = RetryPolicy(max_retries=n_retries)

    def write_batch(batch):
        for row, diff in batch.rows():
            body = dict(row)
            body["diff"] = 1 if diff > 0 else -1
            body["time"] = batch.time
            _requests.request(
                method, url, data=_dumps(body),
                headers={
                    "Content-Type": "application/json",
                    **(headers or {}),
                },
                timeout=30,
            ).raise_for_status()
        return None

    deliver(
        table,
        lambda: CallableAdapter(write_batch, "http"),
        name=name,
        default_name="http",
        retry_policy=retry_policy,
    )
