"""Persistence KV backends.

Re-design of the reference ``src/persistence/backends/`` —
``PersistenceBackend`` trait (``backends/mod.rs:47``) with filesystem
(``backends/file.rs:19``), S3 (``backends/s3.rs:34``), memory and mock
backends. The backend is a flat key → bytes store; all snapshot/metadata
layout policy lives above it (snapshots.py), exactly as in the reference.

Copy of ``pathway_tpu/persistence/backends.py``. ``S3Backend`` imports
``boto3`` only when no client is injected.
"""

from __future__ import annotations

import os
import threading
from typing import Any

__all__ = [
    "PersistenceBackend",
    "MemoryBackend",
    "FilesystemBackend",
    "S3Backend",
    "PrefixBackend",
    "open_backend",
]


class PersistenceBackend:
    """Flat key-value store of byte blobs (backends/mod.rs:47)."""

    def describe(self) -> str:
        """Human-readable location (path/URI) for error messages — which
        store a mismatched cluster marker or torn snapshot lives in."""
        return type(self).__name__

    def get_value(self, key: str) -> bytes:
        raise NotImplementedError

    def put_value(self, key: str, value: bytes) -> None:
        raise NotImplementedError

    def list_keys(self) -> list[str]:
        raise NotImplementedError

    def remove_key(self, key: str) -> None:
        raise NotImplementedError

    def size_of(self, key: str) -> int:
        """Blob size in bytes without necessarily reading it (stat where
        the backend can; this fallback reads)."""
        return len(self.get_value(key))

    def close(self) -> None:
        pass


class MemoryBackend(PersistenceBackend):
    """In-process backend. A named registry lets a 'restarted' engine in the
    same process find prior state (the reference's mock backend role,
    ``src/persistence/backends/mock.rs:12``)."""

    _registry: dict[str, dict[str, bytes]] = {}
    _lock = threading.Lock()

    def __init__(self, name: str | None = None):
        self._name = name
        if name is None:
            self._store: dict[str, bytes] = {}
        else:
            with MemoryBackend._lock:
                self._store = MemoryBackend._registry.setdefault(name, {})

    @classmethod
    def drop(cls, name: str) -> None:
        with cls._lock:
            cls._registry.pop(name, None)

    def describe(self) -> str:
        return f"memory://{self._name}" if self._name else "memory://(anonymous)"

    def get_value(self, key: str) -> bytes:
        return self._store[key]

    def put_value(self, key: str, value: bytes) -> None:
        self._store[key] = value

    def list_keys(self) -> list[str]:
        return sorted(self._store.keys())

    def remove_key(self, key: str) -> None:
        self._store.pop(key, None)


class FilesystemBackend(PersistenceBackend):
    """Local-filesystem backend (``backends/file.rs:19``). Writes are
    atomic-by-rename so a crash mid-write never leaves a torn blob."""

    #: staging files older than this are crash leftovers (no live writer
    #: holds an open rename this long) and are swept at open
    _STALE_TMP_S = 60.0

    def __init__(self, root: str | os.PathLike):
        self.root = os.fspath(root)
        os.makedirs(self.root, exist_ok=True)
        self._sweep_stale_tmp()

    def _sweep_stale_tmp(self) -> None:
        """Delete staging files orphaned by a crash mid-put. Age-gated:
        a CONCURRENTLY booting peer may be inside its own write→rename
        window right now, and sweeping its fresh .tmp would reintroduce
        the vanished-staging-file crash the per-pid names fixed."""
        import time as _t

        cutoff = _t.time() - self._STALE_TMP_S
        for dirpath, _, files in os.walk(self.root):
            for fn in files:
                if not (fn.endswith(".tmp") or ".tmp." in fn):
                    continue
                path = os.path.join(dirpath, fn)
                try:
                    if os.path.getmtime(path) < cutoff:
                        os.remove(path)
                except OSError:
                    pass  # raced with another sweeper / writer

    def describe(self) -> str:
        return self.root

    def _path(self, key: str) -> str:
        # keys may contain '/' segments — map to subdirectories
        p = os.path.join(self.root, *key.split("/"))
        return p

    def get_value(self, key: str) -> bytes:
        with open(self._path(key), "rb") as f:
            return f.read()

    def put_value(self, key: str, value: bytes) -> None:
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        # per-process staging name: two workers first-booting the same
        # store write the cluster marker concurrently — a SHARED .tmp
        # would make one os.replace steal the other's staging file and
        # crash it with FileNotFoundError (last-writer-wins is fine; a
        # vanished staging file is not)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(value)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def list_keys(self) -> list[str]:
        out = []
        for dirpath, _, files in os.walk(self.root):
            rel = os.path.relpath(dirpath, self.root)
            for fn in files:
                if fn.endswith(".tmp") or ".tmp." in fn:
                    continue
                key = fn if rel == "." else "/".join(rel.split(os.sep) + [fn])
                out.append(key)
        return sorted(out)

    def remove_key(self, key: str) -> None:
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass

    def size_of(self, key: str) -> int:
        return os.path.getsize(self._path(key))


class PrefixBackend(PersistenceBackend):
    """View of another backend under a key prefix. Sharded runs give every
    worker its own ``worker-{id}/`` namespace in one shared store (the
    reference's per-worker WorkerPersistentStorage, tracker.rs:47)."""

    def __init__(self, inner: PersistenceBackend, prefix: str):
        self._inner = inner
        self._prefix = prefix

    def describe(self) -> str:
        return f"{self._inner.describe()}/{self._prefix}"

    def get_value(self, key: str) -> bytes:
        return self._inner.get_value(self._prefix + key)

    def put_value(self, key: str, value: bytes) -> None:
        self._inner.put_value(self._prefix + key, value)

    def list_keys(self) -> list[str]:
        p = self._prefix
        return [k[len(p):] for k in self._inner.list_keys() if k.startswith(p)]

    def remove_key(self, key: str) -> None:
        self._inner.remove_key(self._prefix + key)

    def size_of(self, key: str) -> int:
        return self._inner.size_of(self._prefix + key)

    def close(self) -> None:
        self._inner.close()


class S3Backend(PersistenceBackend):
    """S3/GCS object-store backend (``backends/s3.rs:34``).

    ``root_path`` is ``s3://bucket/prefix``; keys map to objects under the
    prefix. Speaks the boto3 S3 client surface (``get_object`` /
    ``put_object`` / ``delete_object`` / paginated ``list_objects_v2``) —
    the client is injectable (``client=``) so the backend is fully
    exercisable against a fake without credentials, matching the repo's
    other client-gated connectors; without one, boto3 is required (not in
    the baked environment)."""

    def __init__(self, root_path: str, bucket_settings: Any = None,
                 client: Any = None):
        if root_path.startswith("s3://"):
            rest = root_path[len("s3://"):]
            bucket, _, prefix = rest.partition("/")
        else:
            bucket, _, prefix = root_path.partition("/")
        if not bucket:
            raise ValueError(f"S3 root_path has no bucket: {root_path!r}")
        self._bucket = bucket
        self._prefix = prefix.strip("/")
        if self._prefix:
            self._prefix += "/"
        self._uri = f"s3://{self._bucket}/{self._prefix}"
        if client is None:
            try:
                import boto3  # type: ignore[import-not-found]
            except ImportError as e:  # pragma: no cover - env has no boto3
                raise ImportError(
                    "pw.persistence.Backend.s3 requires the 'boto3' package "
                    "(or pass client=)"
                ) from e
            kwargs: dict[str, Any] = {}
            s = bucket_settings
            if s is not None:  # reference AwsCredentials/endpoint analog
                for attr, kw in (
                    ("endpoint", "endpoint_url"),
                    ("region", "region_name"),
                    ("access_key", "aws_access_key_id"),
                    ("secret_access_key", "aws_secret_access_key"),
                ):
                    v = getattr(s, attr, None) if not isinstance(s, dict) else s.get(attr)
                    if v is not None:
                        kwargs[kw] = v
            client = boto3.client("s3", **kwargs)
        self._client = client

    def describe(self) -> str:
        return self._uri

    def _obj_key(self, key: str) -> str:
        return self._prefix + key

    def get_value(self, key: str) -> bytes:
        try:
            resp = self._client.get_object(
                Bucket=self._bucket, Key=self._obj_key(key)
            )
        except Exception as e:
            # ONLY a genuinely-missing object maps to KeyError; auth /
            # throttling / availability ClientErrors must surface, or
            # recovery would silently restart from scratch on an expired
            # credential (review finding)
            if isinstance(e, KeyError) or type(e).__name__ == "NoSuchKey":
                raise KeyError(key) from e
            code = (
                getattr(e, "response", None) or {}
            ).get("Error", {}).get("Code")
            if code in ("NoSuchKey", "404", "NotFound"):
                raise KeyError(key) from e
            raise
        body = resp["Body"]
        return body.read() if hasattr(body, "read") else body

    def put_value(self, key: str, value: bytes) -> None:
        self._client.put_object(
            Bucket=self._bucket, Key=self._obj_key(key), Body=value
        )

    def list_keys(self) -> list[str]:
        out: list[str] = []
        token: str | None = None
        while True:
            kwargs: dict[str, Any] = {
                "Bucket": self._bucket, "Prefix": self._prefix,
            }
            if token:
                kwargs["ContinuationToken"] = token
            resp = self._client.list_objects_v2(**kwargs)
            for entry in resp.get("Contents", []):
                out.append(entry["Key"][len(self._prefix):])
            if not resp.get("IsTruncated"):
                break
            token = resp.get("NextContinuationToken")
        return sorted(out)

    def remove_key(self, key: str) -> None:
        self._client.delete_object(Bucket=self._bucket, Key=self._obj_key(key))


def open_backend(backend_spec: Any) -> PersistenceBackend:
    """Instantiate a backend from the user-facing ``pw.persistence.Backend``
    descriptor (persistence/__init__.py)."""
    kind = backend_spec.kind
    if kind == "filesystem":
        return FilesystemBackend(backend_spec.options["path"])
    if kind == "memory":
        return MemoryBackend(backend_spec.options.get("name"))
    if kind == "s3":
        return S3Backend(
            backend_spec.options["root_path"],
            backend_spec.options.get("bucket_settings"),
            client=backend_spec.options.get("_client"),
        )
    raise ValueError(f"unknown persistence backend kind {kind!r}")
