"""``pw.run`` — execute all registered outputs (reference internals/run.py:42).

Copy of ``pathway_tpu/internals/run.py``. ``run`` takes ``device=``
(default ``"cuda"``), the device of the expression kernels and of the mesh
exchange; with no card it raises unless the caller passes ``device="cpu"``.
Left out: the lint mode's build-only run, persistence and replay, the
monitoring dashboard and HTTP server, and the supervised SIGTERM wind-down.
"""

from __future__ import annotations

import threading
from typing import Any

import torch

from .graph_runner import GraphRunner

_current: dict[str, GraphRunner | None] = {"runner": None}
_lock = threading.Lock()


def run(*, device: str | torch.device = "cuda", **kwargs: Any) -> None:
    """Build and run the whole dataflow (all sinks registered so far) on
    ``device``. Blocks until all sources finish (streaming sources may run
    forever — stop from another thread with ``request_stop()``). Other
    keyword arguments of the reference (``debug``, ``monitoring_level``, ...)
    are accepted and have no effect."""
    runner = GraphRunner(device=device)
    with _lock:
        _current["runner"] = runner
    try:
        runner.run()
    finally:
        with _lock:
            _current["runner"] = None


def request_stop() -> None:
    """Ask the currently running streaming engine loop to wind down after
    the in-flight tick (callable from any thread)."""
    with _lock:
        runner = _current["runner"]
    if runner is not None:
        runner.stop_requested = True
        for ex in getattr(runner, "_peer_executors", None) or (
            [runner.executor] if runner.executor is not None else []
        ):
            ex.request_stop()


def run_all(**kwargs: Any) -> None:
    run(**kwargs)
