"""SharePoint source (reference ``xpacks/connectors/sharepoint``:
a polling scanner over a SharePoint document library).

Rides the shared object-store scanner (``io/_object_scanner.py``) like the
s3/gdrive/pyfilesystem sources: listing + version change detection +
deleted-file retraction + optional ``_metadata``. Only the Office365 client
construction is gated on the ``office365`` package (absent here — no
egress); the scanner logic is exercised through the injectable client in
``tests/test_connectors_destubbed.py``.

Copy of ``pathway_tpu/xpacks/connectors/sharepoint.py``, gated on
``Office365-REST-Python-Client``.
"""

from __future__ import annotations

from typing import Any

from ...internals.schema import SchemaMetaclass
from ...internals.table import Table
from ...io._gated import unavailable
from ...io._object_scanner import ObjectMeta

__all__ = ["read"]


class SharePointClient:
    """ObjectStoreClient over Office365-REST-Python-Client (gated)."""

    def __init__(self, url: str, tenant: str, client_id: str, cert_path: str,
                 thumbprint: str, root_path: str, recursive: bool,
                 object_size_limit: int | None):
        try:
            from office365.sharepoint.client_context import (  # type: ignore[import-not-found]
                ClientContext,
            )
        except ImportError:
            unavailable(
                "pw.xpacks.connectors.sharepoint.read",
                "Office365-REST-Python-Client",
            )
        self._ctx = ClientContext(url).with_client_certificate(
            tenant=tenant, client_id=client_id,
            cert_path=cert_path, thumbprint=thumbprint,
        )
        self.root_path = root_path
        self.recursive = recursive
        self.size_limit = object_size_limit

    def _walk(self, folder):
        self._ctx.load(folder.files).execute_query()
        for f in folder.files:
            yield f
        if self.recursive:
            self._ctx.load(folder.folders).execute_query()
            for sub in folder.folders:
                yield from self._walk(sub)

    def list_objects(self):
        root = self._ctx.web.get_folder_by_server_relative_url(self.root_path)
        for f in self._walk(root):
            size = int(f.length or 0)
            if self.size_limit is not None and size > self.size_limit:
                continue
            yield ObjectMeta(
                key=f.serverRelativeUrl,
                version=str(f.properties.get("UniqueId", ""))
                + str(f.time_last_modified),
                size=size,
            )

    def read_object(self, key: str) -> bytes:
        return (
            self._ctx.web.get_file_by_server_relative_url(key)
            .get_content().execute_query().value
        )


def read(
    url: str,
    *,
    tenant: str,
    client_id: str,
    cert_path: str,
    thumbprint: str,
    root_path: str,
    mode: str = "streaming",
    recursive: bool = True,
    object_size_limit: int | None = None,
    with_metadata: bool = False,
    refresh_interval: int = 30,
    schema: SchemaMetaclass | None = None,
    format: str = "binary",
    name: str | None = None,
    _client: Any = None,
    **kwargs: Any,
) -> Table:
    """Read files of a SharePoint site directory as a streaming table of
    binary ``data`` rows (reference sharepoint/__init__.py:249). ``_client``
    injects any ObjectStoreClient (tests use a filesystem-backed fake)."""
    from ...io.s3 import _default_schema, object_source_table

    schema = _default_schema(format, schema, "sharepoint.read")
    client = _client if _client is not None else SharePointClient(
        url, tenant, client_id, cert_path, thumbprint, root_path,
        recursive, object_size_limit,
    )
    return object_source_table(
        client, format, schema,
        mode=mode, with_metadata=with_metadata,
        refresh_interval_ms=refresh_interval * 1000,
        autocommit_duration_ms=1500, name=name,
    )
