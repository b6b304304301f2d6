"""``pw.io.pyfilesystem`` — PyFilesystem source.

Re-design of ``python/pathway/io/pyfilesystem``: reads any `fs`-protocol
filesystem object (OSFS, MemoryFS, FTPFS, ZipFS, …) through the shared
object-store scanner. The ``source`` argument already IS the filesystem
object — nothing to gate; the scanner only needs its ``walk``/
``readbytes``/``getinfo`` surface, so tests drive it with a minimal fake.

Copy of ``pathway_tpu/io/pyfilesystem.py``.
"""

from __future__ import annotations

from typing import Any

from ..internals.schema import SchemaMetaclass
from ..internals.table import Table
from ._object_scanner import ObjectMeta

__all__ = ["read"]


class FsObjectClient:
    """ObjectStoreClient over the PyFilesystem surface."""

    def __init__(self, source: Any, path: str):
        self.fs = source
        self.path = path or "/"

    def list_objects(self):
        for dirpath, _dirs, files in self.fs.walk(self.path):
            for f in files:
                fpath = f"{dirpath.rstrip('/')}/{f.name}"
                try:
                    info = self.fs.getinfo(fpath, namespaces=["details"])
                    size = info.size
                    mtime = info.modified
                except Exception:
                    size, mtime = None, None
                yield ObjectMeta(
                    key=fpath,
                    version=f"{size}:{mtime}",
                    size=size,
                    modified_at=(
                        mtime.timestamp() if hasattr(mtime, "timestamp") else None
                    ),
                )

    def read_object(self, key: str) -> bytes:
        return self.fs.readbytes(key)


def read(source: Any, *, path: str | None = None, format: str = "binary",
         mode: str = "streaming", refresh_interval: int = 30,
         with_metadata: bool = False, name: str | None = None,
         schema: SchemaMetaclass | None = None, **kwargs: Any) -> Table:
    """Read every file of a PyFilesystem ``source`` (reference
    io/pyfilesystem: streaming mode re-scans for added/changed/removed
    files; static reads once)."""
    from .s3 import _default_schema, object_source_table

    schema = _default_schema(format, schema, "pw.io.pyfilesystem.read")
    client = FsObjectClient(source, path or "/")
    return object_source_table(
        client, format, schema,
        mode=mode, with_metadata=with_metadata,
        refresh_interval_ms=refresh_interval * 1000,
        autocommit_duration_ms=1500, name=name,
    )
