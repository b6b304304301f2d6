"""Shared helpers for the llm xpack (HTTP client base, result packing, the servers' engine
thread).

Copy of ``pathway_tpu/xpacks/llm/_utils.py``, with ``run_on_thread``, which the servers'
``run(threaded=True)`` and ``run_server(threaded=True)`` share.
"""

from __future__ import annotations

import json as _json
import threading
import urllib.request
from typing import Any

from ...internals.run import run as pw_run


def run_on_thread(owner: Any, **run_kwargs: Any) -> threading.Thread:
    """``run(**run_kwargs)`` on a started daemon thread; what it raises is kept in
    ``owner.run_error`` for the caller, who joins the thread."""

    def target() -> None:
        try:
            pw_run(**run_kwargs)
        except BaseException as e:  # kept for the caller, who joins the thread
            owner.run_error = e
            raise

    t = threading.Thread(target=target, daemon=True)
    t.start()
    return t


def doc_dicts(texts, metas, scores) -> tuple[dict, ...]:
    """Collapsed index reply columns -> tuple of {text, metadata, dist}
    dicts, best-first (dist = negated similarity, reference convention)."""
    return tuple(
        {"text": t, "metadata": m, "dist": -float(s)}
        for t, m, s in zip(texts or (), metas or (), scores or ())
    )


class HttpClientBase:
    """stdlib-urllib JSON POST client (no extra dependencies)."""

    def __init__(
        self,
        host: str | None = None,
        port: int | None = None,
        url: str | None = None,
        timeout: float = 15.0,
    ):
        self.url = url or f"http://{host}:{port}"
        self.timeout = timeout

    def _post(self, route: str, payload: dict) -> Any:
        req = urllib.request.Request(
            self.url + route,
            data=_json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            return _json.loads(resp.read().decode())
