"""Env-first engine configuration (reference
``python/pathway/internals/config.py:35-121`` ``PathwayConfig`` +
``src/engine/dataflow/config.rs:62-128`` worker config).

Copy of ``pathway_tpu/internals/config.py`` with the knobs the port's runner
reads: the worker layout (``PATHWAY_THREADS``, ``PATHWAY_PROCESSES``) and
``PATHWAY_MESH_EXCHANGE``, read as the reference reads them, and the readers
(``_env_bool``, ``_env_int``, ``_env_float``) that the serve plane's knobs go
through (``PATHWAY_ELASTIC``, ``PATHWAY_RESCALE_WAIT_S`` and the sink knobs
among them). The spill tier reads ``PATHWAY_STATE_MEMORY_BUDGET_MB`` and
``PATHWAY_STATE_SPILL_DIR`` (``engine/spill.py``), the key registry
``PATHWAY_KEY_REGISTRY_CAP``, ``PATHWAY_KEY_REGISTRY_OVERFLOW`` and
``PATHWAY_KEY_REGISTRY_SPILL_DIR`` (``engine/keys.py``), where and as the
reference reads them. The monitoring fields (``PATHWAY_TRACE_FILE``,
``PATHWAY_MONITORING_SERVER``, ``PATHWAY_MONITORING_HTTP_SERVER``,
``PATHWAY_MONITORING_HTTP_HOST``, ``PATHWAY_MONITORING_HTTP_PORT``,
``PATHWAY_TELEMETRY_FLUSH_S``, ``PATHWAY_HEALTH_WEDGE_S``) are the
reference's, with ``process_id`` (``PATHWAY_PROCESS_ID``), which the hub and
the HTTP server's port read. The command line's record and replay fields
(``PATHWAY_REPLAY_STORAGE``, ``PATHWAY_SNAPSHOT_ACCESS``,
``PATHWAY_PERSISTENCE_MODE``, ``PATHWAY_CONTINUE_AFTER_REPLAY``, with the
``replay_mode`` accessor) and the supervisor's stamps (``PATHWAY_SUPERVISED``,
``PATHWAY_RESTART_COUNT``, ``PATHWAY_LAST_RESTART_REASON``) are the
reference's, and so is the cluster's layout: ``PATHWAY_FIRST_PORT``, the
address book ``PATHWAY_ADDRESSES`` with its validation, and the timeouts
``PATHWAY_COLLECTIVE_TIMEOUT_S`` and ``PATHWAY_CONNECT_TIMEOUT_S``
(``parallel/cluster.py``). Fault plans are left out with ``chaos/``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

__all__ = ["PathwayConfig", "get_pathway_config", "MAX_WORKERS"]

#: reference free-tier cap (dataflow/config.rs:7-11)
MAX_WORKERS = 8


def _env_bool(name: str, default: bool = False) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v.strip().lower() in ("1", "true", "yes", "on")


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    try:
        return int(v) if v is not None else default
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    v = os.environ.get(name)
    try:
        return float(v) if v is not None else default
    except ValueError:
        return default


def _env_addresses(name: str) -> list[str] | None:
    v = os.environ.get(name)
    if not v or not v.strip():
        return None
    return [a.strip() for a in v.split(",") if a.strip()]


@dataclass
class PathwayConfig:
    replay_storage: str | None = field(
        default_factory=lambda: os.environ.get("PATHWAY_REPLAY_STORAGE"))
    snapshot_access: str | None = field(
        default_factory=lambda: os.environ.get("PATHWAY_SNAPSHOT_ACCESS"))
    persistence_mode: str | None = field(
        default_factory=lambda: os.environ.get("PATHWAY_PERSISTENCE_MODE"))
    monitoring_server: str | None = field(
        default_factory=lambda: os.environ.get("PATHWAY_MONITORING_SERVER"))
    continue_after_replay: bool = field(
        default_factory=lambda: _env_bool("PATHWAY_CONTINUE_AFTER_REPLAY"))
    #: span tracing → Chrome-trace JSON (internals/tracing.py; the OTLP
    #: telemetry analog of src/engine/telemetry.rs for a no-egress world)
    trace_file: str | None = field(
        default_factory=lambda: os.environ.get("PATHWAY_TRACE_FILE"))
    # NOTE: PATHWAY_RUN_ID / PATHWAY_FLIGHT_DIR / PATHWAY_FLIGHT_RING_KB are
    # deliberately NOT snapshotted here — the tracer must initialize even
    # when config validation refuses the worker layout, and the flight
    # recorder re-reads its env per restart generation; both read the
    # environment directly (internals/tracing.py,
    # observability/flightrecorder.py).
    # observability (engine/http_server.py + observability/)
    #: force the monitoring HTTP server on without a code change (the
    #: with_http_server=True analog for spawn-style deployments)
    monitoring_http_server: bool = field(
        default_factory=lambda: _env_bool("PATHWAY_MONITORING_HTTP_SERVER"))
    #: bind host for /metrics + probes; loopback unless opted into
    monitoring_http_host: str = field(
        default_factory=lambda: os.environ.get(
            "PATHWAY_MONITORING_HTTP_HOST", "127.0.0.1"))
    #: base port; process p serves on base + p (http_server.rs convention)
    monitoring_http_port: int = field(
        default_factory=lambda: _env_int(
            "PATHWAY_MONITORING_HTTP_PORT", 20000))
    #: periodic telemetry flush cadence (observability/exporter.py);
    #: 0 disables, leaving only the end-of-run export
    telemetry_flush_s: float = field(
        default_factory=lambda: _env_float("PATHWAY_TELEMETRY_FLUSH_S", 60.0))
    #: /healthz fails when an unfinished executor's heartbeat is older
    health_wedge_timeout_s: float = field(
        default_factory=lambda: _env_float("PATHWAY_HEALTH_WEDGE_S", 30.0))
    #: how long a blocked cluster collective waits before declaring the
    #: mesh dead (peer-death propagation normally fires in milliseconds —
    #: this is the backstop for silent stalls)
    collective_timeout_s: float = field(
        default_factory=lambda: _env_float(
            "PATHWAY_COLLECTIVE_TIMEOUT_S", 600.0))
    #: per-peer mesh-establishment budget (jittered-backoff retries within)
    connect_timeout_s: float = field(
        default_factory=lambda: _env_float("PATHWAY_CONNECT_TIMEOUT_S", 30.0))
    #: set by `spawn --supervise` on children: enables cooperative SIGTERM
    #: wind-down so the supervisor's teardown flushes the persistence tail
    supervised: bool = field(
        default_factory=lambda: _env_bool("PATHWAY_SUPERVISED"))
    #: restart generation (0 = first boot), stamped by the supervisor;
    #: feeds pathway_restarts_total
    restart_count: int = field(
        default_factory=lambda: _env_int("PATHWAY_RESTART_COUNT", 0))
    #: why the supervisor last restarted the ensemble (metrics label)
    last_restart_reason: str | None = field(
        default_factory=lambda: os.environ.get("PATHWAY_LAST_RESTART_REASON"))
    #: route dense Exchange columns through the card (parallel/meshcomm.py)
    #: instead of host memory
    mesh_exchange: bool = field(
        default_factory=lambda: _env_bool("PATHWAY_MESH_EXCHANGE"))
    threads: int = field(default_factory=lambda: _env_int("PATHWAY_THREADS", 1))
    processes: int = field(default_factory=lambda: _env_int("PATHWAY_PROCESSES", 1))
    process_id: int = field(default_factory=lambda: _env_int("PATHWAY_PROCESS_ID", 0))
    first_port: int = field(default_factory=lambda: _env_int("PATHWAY_FIRST_PORT", 10000))
    #: multi-host cluster address book: comma-separated host[:port], one per
    #: process (the timely hostfile analog — communication/src/initialize.rs);
    #: unset = all processes on 127.0.0.1 at first_port+pid
    addresses: list[str] | None = field(
        default_factory=lambda: _env_addresses("PATHWAY_ADDRESSES"))

    def __post_init__(self) -> None:
        if self.threads * self.processes > MAX_WORKERS:
            raise RuntimeError(
                f"too many workers: {self.threads}×{self.processes} > "
                f"{MAX_WORKERS} (reference free-tier limit, "
                "dataflow/config.rs:7-11)"
            )
        if self.addresses is not None and len(self.addresses) != self.processes:
            raise RuntimeError(
                f"PATHWAY_ADDRESSES lists {len(self.addresses)} hosts for "
                f"{self.processes} processes — one host[:port] per process"
            )

    @property
    def total_workers(self) -> int:
        return self.threads * self.processes

    @property
    def replay_mode(self) -> str | None:
        return self.persistence_mode


def get_pathway_config() -> PathwayConfig:
    """Fresh config snapshot from the current environment."""
    return PathwayConfig()
