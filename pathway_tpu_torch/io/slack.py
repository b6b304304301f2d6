"""``pw.io.slack`` — Slack alert sink (reference ``python/pathway/io/slack``:
posts one chat.postMessage per row of a single-text-column table).

Copy of ``pathway_tpu/io/slack.py``.
"""

from __future__ import annotations

from typing import Any

from ..internals.table import Table

__all__ = ["send_alerts"]

_SLACK_URL = "https://slack.com/api/chat.postMessage"


def send_alerts(
    messages: Table,
    slack_channel_id: str,
    slack_token: str,
    **kwargs: Any,
) -> None:
    """Each addition in the (single text column) table becomes one Slack
    message to the channel (delivered through the retrying output plane)."""
    from .delivery import CallableAdapter, deliver

    (col,) = messages.column_names()

    def write_batch(batch):
        import json
        import urllib.request

        for row, diff in batch.rows():
            if diff <= 0:
                continue
            req = urllib.request.Request(
                _SLACK_URL,
                data=json.dumps(
                    {"channel": slack_channel_id, "text": str(row[col])}
                ).encode(),
                headers={
                    "Content-Type": "application/json",
                    "Authorization": f"Bearer {slack_token}",
                },
                method="POST",
            )
            urllib.request.urlopen(req, timeout=30)
        return None

    deliver(
        messages,
        lambda: CallableAdapter(write_batch, "slack"),
        name=kwargs.get("name"),
        default_name=f"slack-{slack_channel_id}",
        retry_policy=kwargs.get("retry_policy"),
    )
