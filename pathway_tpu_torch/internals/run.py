"""``pw.run`` — execute all registered outputs (reference internals/run.py:42).

Copy of ``pathway_tpu/internals/run.py``. ``run`` takes ``device=``
(default ``"cuda"``), the device of the expression kernels and of the mesh
exchange; with no card it raises unless the caller passes ``device="cpu"``.
``persistence_config=`` runs the graph under ``persistence.run_with_persistence``
(durable state, exactly-once delivery-managed output, recovery on restart).
Under lint mode (``internals/lintmode.py``, armed by ``analysis/lint.py``)
``run`` records its ``persistence_config`` and returns without building a
runner. ``monitoring_level=`` draws the dashboard (``internals/monitoring.py``)
and ``with_http_server=True`` serves the monitoring endpoints
(``engine/http_server.py``), as in the reference; each run re-reads
``PATHWAY_TRACE_FILE`` (``tracing.init_from_env``). With no
``persistence_config`` and the command line's record/replay environment set
(``spawn --record``, ``replay``), ``run`` persists to
``PATHWAY_REPLAY_STORAGE`` itself; under ``spawn --supervise``
(``PATHWAY_SUPERVISED=1``) a SIGTERM becomes ``request_stop()``, as in the
reference.
"""

from __future__ import annotations

import threading
from typing import Any

import torch

from .graph_runner import GraphRunner
from .monitoring import MonitoringLevel

_current: dict[str, GraphRunner | None] = {"runner": None}
_lock = threading.Lock()


def run(
    *,
    device: str | torch.device = "cuda",
    monitoring_level: int = MonitoringLevel.NONE,
    with_http_server: bool = False,
    persistence_config: Any = None,
    **kwargs: Any,
) -> None:
    """Build and run the whole dataflow (all sinks registered so far) on
    ``device``. Blocks until all sources finish (streaming sources may run
    forever — stop from another thread with ``request_stop()``). With
    ``persistence_config`` (``pw.persistence.Config``) the run records its
    input, snapshots operator state and recovers from the backend's state.
    ``monitoring_level`` (``MonitoringLevel``) draws the live dashboard on
    stderr; ``with_http_server`` serves ``/metrics``, ``/snapshot``,
    ``/query``, ``/attribution``, ``/alerts``, ``/profile``, ``/healthz``
    and ``/readyz`` on ``PATHWAY_MONITORING_HTTP_PORT`` (default 20000).
    The reference's other keywords (``debug``, ``default_logging``,
    ``runtime_typechecking``) are accepted and have no effect, as there."""
    from . import lintmode

    if lintmode.ACTIVE:
        # `pw.analyze` under lint mode drives the script only to BUILD its
        # graph; execution (and every side effect behind it) is skipped and
        # the analyzer reads the parse graph + this captured config
        lintmode.note_run(persistence_config)
        return
    from .tracing import init_from_env

    init_from_env()  # each pw.run re-reads PATHWAY_TRACE_FILE
    runner = GraphRunner(device=device)
    runner.monitoring_level = monitoring_level
    runner.with_http_server = with_http_server
    with _lock:
        _current["runner"] = runner
    restore_sigterm = _install_supervised_sigterm()
    try:
        if persistence_config is None:
            # the CLI's record/replay env (spawn --record /
            # replay --mode ...) must work WITHOUT program changes
            # (reference run.py reads the replay config from env)
            from .config import get_pathway_config

            cfg = get_pathway_config()
            if cfg.replay_storage and cfg.snapshot_access in (
                "record", "replay"
            ):
                from ..persistence import Backend, Config

                persistence_config = Config.simple_config(
                    Backend.filesystem(cfg.replay_storage)
                )
        if persistence_config is not None:
            from ..persistence import run_with_persistence

            run_with_persistence(runner, persistence_config)
        else:
            runner.run()
    finally:
        restore_sigterm()
        with _lock:
            _current["runner"] = None


def _install_supervised_sigterm():
    """Under ``spawn --supervise`` (PATHWAY_SUPERVISED=1) a SIGTERM is the
    supervisor's cooperative teardown request: translate it into
    ``request_stop()`` so the streaming loop winds down and the persistence
    manager's ``close()`` flushes the recorded input tail before exit.
    Returns a restore callback; a no-op off the main thread or when not
    supervised."""
    import os

    if not os.environ.get("PATHWAY_SUPERVISED"):
        return lambda: None
    import signal

    try:
        prev = signal.signal(
            signal.SIGTERM, lambda signum, frame: request_stop()
        )
    except ValueError:  # not the main thread — supervisor falls back to kill
        return lambda: None
    return lambda: signal.signal(signal.SIGTERM, prev)


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
