"""``pw.persistence`` — checkpoint/recovery.

User-facing config mirrors ``python/pathway/persistence/__init__.py:13-60``
(``Backend.filesystem/s3``, ``Config.simple_config``); the mechanism
(KV backends, input snapshots, versioned metadata, offsets) mirrors
``src/persistence/`` — see backends.py / snapshots.py / manager.py.

Copy of ``pathway_tpu/persistence/__init__.py``, with the command line's
record/replay environment (``apply_replay_env``: ``spawn --record`` and
``replay --mode``).
"""

from dataclasses import dataclass
from typing import Any

from .backends import (
    FilesystemBackend,
    MemoryBackend,
    PersistenceBackend,
    S3Backend,
)
from .manager import PersistenceManager

__all__ = [
    "Backend",
    "Config",
    "PersistenceBackend",
    "FilesystemBackend",
    "MemoryBackend",
    "S3Backend",
    "PersistenceManager",
    "run_with_persistence",
]


class Backend:
    """Descriptor of where persisted state lives
    (reference persistence/__init__.py:13)."""

    def __init__(self, kind: str, **kwargs: Any):
        self.kind = kind
        self.options = kwargs

    @classmethod
    def filesystem(cls, path: str) -> "Backend":
        return cls("filesystem", path=path)

    @classmethod
    def memory(cls, name: str | None = None) -> "Backend":
        """In-process backend; a `name` makes state visible to a later run
        in the same process (test/mock backend)."""
        return cls("memory", name=name)

    @classmethod
    def s3(cls, root_path: str, bucket_settings: Any = None,
           _client: Any = None) -> "Backend":
        """``root_path`` = ``s3://bucket/prefix``; ``_client`` injects a
        boto3-surface client (tests run against an in-memory fake)."""
        return cls("s3", root_path=root_path,
                   bucket_settings=bucket_settings, _client=_client)


@dataclass
class Config:
    """reference persistence/__init__.py:34 (`Config.simple_config`)."""

    backend: Backend | None = None
    snapshot_interval_ms: int = 0

    @classmethod
    def simple_config(cls, backend: Backend, snapshot_interval_ms: int = 0) -> "Config":
        return cls(backend=backend, snapshot_interval_ms=snapshot_interval_ms)


def apply_replay_env(manager: "PersistenceManager", pw_cfg: Any) -> None:
    """CLI record/replay env (PATHWAY_SNAPSHOT_ACCESS / PERSISTENCE_MODE /
    CONTINUE_AFTER_REPLAY, set by ``replay``) onto a manager."""
    if pw_cfg.snapshot_access == "record":
        manager.record_replay = True
    elif pw_cfg.snapshot_access == "replay":
        manager.replay_mode = pw_cfg.persistence_mode or "batch"
        manager.continue_after_replay = bool(pw_cfg.continue_after_replay)


def run_with_persistence(runner: Any, config: Config) -> None:
    """Attach persistence to the GraphRunner and run (called from pw.run
    when persistence_config is given). Sharded runs build one per-worker
    PersistenceManager inside ``GraphRunner._run_sharded`` (reference:
    per-worker WorkerPersistentStorage, tracker.rs:47)."""
    from ..internals.config import get_pathway_config

    runner.persistence_config = config
    pw_cfg = get_pathway_config()
    if pw_cfg.total_workers > 1:
        runner.run()
        return
    manager = PersistenceManager(config)
    apply_replay_env(manager, pw_cfg)
    runner.persistence = manager
    try:
        runner.run()
    finally:
        manager.close()
