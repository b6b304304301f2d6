"""``pw.run`` — execute all registered outputs (reference internals/run.py:42).

Copy of ``pathway_tpu/internals/run.py``. ``run`` takes ``device=``
(default ``"cuda"``), the device of the expression kernels and of the mesh
exchange; with no card it raises unless the caller passes ``device="cpu"``.
``persistence_config=`` runs the graph under ``persistence.run_with_persistence``
(durable state, exactly-once delivery-managed output, recovery on restart).
Under lint mode (``internals/lintmode.py``, armed by ``analysis/lint.py``)
``run`` records its ``persistence_config`` and returns without building a
runner. Left out: the CLI's record/replay environment, the monitoring
dashboard and HTTP server, and the supervised SIGTERM wind-down.
"""

from __future__ import annotations

import threading
from typing import Any

import torch

from .graph_runner import GraphRunner

_current: dict[str, GraphRunner | None] = {"runner": None}
_lock = threading.Lock()


def run(
    *,
    device: str | torch.device = "cuda",
    persistence_config: Any = None,
    **kwargs: Any,
) -> None:
    """Build and run the whole dataflow (all sinks registered so far) on
    ``device``. Blocks until all sources finish (streaming sources may run
    forever — stop from another thread with ``request_stop()``). With
    ``persistence_config`` (``pw.persistence.Config``) the run records its
    input, snapshots operator state and recovers from the backend's state.
    The reference's display keywords (``debug``, ``monitoring_level``,
    ``with_http_server``, ...) are accepted and have no effect."""
    from . import lintmode

    if lintmode.ACTIVE:
        # `pw.analyze` under lint mode drives the script only to BUILD its
        # graph; execution (and every side effect behind it) is skipped and
        # the analyzer reads the parse graph + this captured config
        lintmode.note_run(persistence_config)
        return
    runner = GraphRunner(device=device)
    with _lock:
        _current["runner"] = runner
    try:
        if persistence_config is not None:
            from ..persistence import run_with_persistence

            run_with_persistence(runner, persistence_config)
        else:
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
