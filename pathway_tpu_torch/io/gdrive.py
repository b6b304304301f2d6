"""``pw.io.gdrive`` — Google Drive source.

Re-design of ``python/pathway/io/gdrive`` (a polling scanner over the
Drive API). Reuses the shared object-store scanner: the Drive folder is
listed recursively, file versions come from the Drive revision/modified
fields, and new/changed/deleted files become row insertions/retractions.
The scanner logic is unit-tested with a fake Drive client; only the real
``google-api-python-client`` service construction is gated.

Copy of ``pathway_tpu/io/gdrive.py``, gated on ``google-api-python-client``.
"""

from __future__ import annotations

from typing import Any

from ..internals.schema import SchemaMetaclass
from ..internals.table import Table
from ._gated import unavailable
from ._object_scanner import ObjectMeta

__all__ = ["read"]


class GDriveClient:
    """ObjectStoreClient over the Drive v3 API (the gated dependency)."""

    _FOLDER = "application/vnd.google-apps.folder"

    def __init__(self, object_id: str, credentials_file: str | None,
                 object_size_limit: int | None):
        try:
            from google.oauth2.service_account import (  # type: ignore[import-not-found]
                Credentials,
            )
            from googleapiclient.discovery import (  # type: ignore[import-not-found]
                build,
            )
        except ImportError:
            unavailable("pw.io.gdrive.read", "google-api-python-client")
        creds = Credentials.from_service_account_file(
            credentials_file,
            scopes=["https://www.googleapis.com/auth/drive.readonly"],
        )
        self._service = build("drive", "v3", credentials=creds)
        self.root = object_id
        self.size_limit = object_size_limit

    def _list_dir(self, folder_id: str):
        page_token = None
        while True:
            resp = self._service.files().list(
                q=f"'{folder_id}' in parents and trashed = false",
                fields="nextPageToken, files(id, name, mimeType, version, size, modifiedTime)",
                pageToken=page_token,
            ).execute()
            yield from resp.get("files", [])
            page_token = resp.get("nextPageToken")
            if page_token is None:
                break

    def list_objects(self):
        stack = [self.root]
        while stack:
            folder = stack.pop()
            for f in self._list_dir(folder):
                if f.get("mimeType") == self._FOLDER:
                    stack.append(f["id"])
                    continue
                size = int(f.get("size", 0) or 0)
                if self.size_limit is not None and size > self.size_limit:
                    continue
                yield ObjectMeta(
                    key=f["id"],
                    version=str(f.get("version") or f.get("modifiedTime", "")),
                    size=size,
                )

    def read_object(self, key: str) -> bytes:
        return self._service.files().get_media(fileId=key).execute()


def read(object_id: str, *, mode: str = "streaming", format: str = "binary",
         object_size_limit: int | None = None, refresh_interval: int = 30,
         service_user_credentials_file: str | None = None,
         with_metadata: bool = False, name: str | None = None,
         schema: SchemaMetaclass | None = None, _client: Any = None,
         **kwargs: Any) -> Table:
    """Read files under a Drive folder/file id. ``_client`` injects any
    ObjectStoreClient (tests use a fake Drive)."""
    from .s3 import _default_schema, object_source_table

    schema = _default_schema(format, schema, "pw.io.gdrive.read")
    client = _client if _client is not None else GDriveClient(
        object_id, service_user_credentials_file, object_size_limit
    )
    return object_source_table(
        client, format, schema,
        mode=mode, with_metadata=with_metadata,
        refresh_interval_ms=refresh_interval * 1000,
        autocommit_duration_ms=1500, name=name,
    )
