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
reference reads them. The replay
storage (the CLI's record/replay), fault plans, supervision, monitoring and the
cluster address book are left out with the runner branches that use them;
persistence takes its settings from ``pw.persistence.Config``.
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


@dataclass
class PathwayConfig:
    #: route dense Exchange columns through the card (parallel/meshcomm.py)
    #: instead of host memory
    mesh_exchange: bool = field(
        default_factory=lambda: _env_bool("PATHWAY_MESH_EXCHANGE"))
    threads: int = field(default_factory=lambda: _env_int("PATHWAY_THREADS", 1))
    processes: int = field(default_factory=lambda: _env_int("PATHWAY_PROCESSES", 1))

    def __post_init__(self) -> None:
        if self.threads * self.processes > MAX_WORKERS:
            raise RuntimeError(
                f"too many workers: {self.threads}×{self.processes} > "
                f"{MAX_WORKERS} (reference free-tier limit, "
                "dataflow/config.rs:7-11)"
            )

    @property
    def total_workers(self) -> int:
        return self.threads * self.processes


def get_pathway_config() -> PathwayConfig:
    """Fresh config snapshot from the current environment."""
    return PathwayConfig()
