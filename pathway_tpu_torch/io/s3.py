"""``pw.io.s3`` (+ ``minio``/DigitalOcean/Wasabi) — S3-compatible
object-store source.

Re-design of the reference's Rust S3 scanner
(``src/connectors/scanner/s3.rs`` + ``python/pathway/io/s3``): a polling
``ObjectScanSource`` over an S3 client with object-version (etag) change
detection and deleted-object retraction. The full connector logic lives
here and is unit-tested against a filesystem-backed fake client
(``tests/test_connectors_destubbed.py``); only the boto3 client itself is
gated on the package being installed.

Copy of ``pathway_tpu/io/s3.py``: ``fs.read``'s object stream goes through
``object_source_table``; ``read`` and ``BotoS3Client`` stay behind ``_gated``
as the reference has them (``boto3`` is on neither machine).
"""

from __future__ import annotations

from typing import Any

from ..internals.parse_graph import Universe
from ..internals.schema import SchemaMetaclass, schema_from_types
from ..internals.table import Table
from ..internals.table_io import rows_to_table
from ._gated import unavailable
from ._object_scanner import ObjectMeta, ObjectScanSource, parse_object

__all__ = [
    "read",
    "AwsS3Settings",
    "DigitalOceanS3Settings",
    "WasabiS3Settings",
]


class AwsS3Settings:
    def __init__(self, *, bucket_name: str | None = None, access_key: str | None = None,
                 secret_access_key: str | None = None, with_path_style: bool = False,
                 region: str | None = None, endpoint: str | None = None, **kwargs: Any):
        self.bucket_name = bucket_name
        self.access_key = access_key
        self.secret_access_key = secret_access_key
        self.with_path_style = with_path_style
        self.region = region
        self.endpoint = endpoint


DigitalOceanS3Settings = AwsS3Settings
WasabiS3Settings = AwsS3Settings


def _split_s3_path(path: str) -> tuple[str | None, str]:
    """'s3://bucket/prefix' -> (bucket, prefix); bare 'prefix' -> (None, prefix)."""
    if "://" in path:
        rest = path.split("://", 1)[1]
        bucket, _, prefix = rest.partition("/")
        return bucket, prefix
    return None, path


class BotoS3Client:
    """ObjectStoreClient over boto3 (the gated dependency)."""

    def __init__(self, settings: AwsS3Settings, bucket: str, prefix: str):
        try:
            import boto3  # type: ignore[import-not-found]
        except ImportError:
            unavailable("pw.io.s3.read", "boto3")
        self._client = boto3.client(
            "s3",
            aws_access_key_id=settings.access_key,
            aws_secret_access_key=settings.secret_access_key,
            region_name=settings.region,
            endpoint_url=settings.endpoint,
        )
        self.bucket = bucket
        self.prefix = prefix

    def list_objects(self):
        paginator = self._client.get_paginator("list_objects_v2")
        for page in paginator.paginate(Bucket=self.bucket, Prefix=self.prefix):
            for obj in page.get("Contents", []):
                yield ObjectMeta(
                    key=obj["Key"],
                    version=obj.get("ETag") or str(obj.get("LastModified", "")),
                    size=obj.get("Size"),
                    modified_at=(
                        obj["LastModified"].timestamp()
                        if obj.get("LastModified") is not None else None
                    ),
                )

    def read_object(self, key: str) -> bytes:
        return self._client.get_object(Bucket=self.bucket, Key=key)["Body"].read()


def _default_schema(format: str, schema: SchemaMetaclass | None, who: str):
    if schema is not None:
        return schema
    if format == "binary":
        return schema_from_types(data=bytes)
    if format in ("plaintext", "plaintext_by_object"):
        return schema_from_types(data=str)
    raise ValueError(f"{who}(format={format!r}) requires schema=")


def _with_metadata_schema(schema: SchemaMetaclass) -> SchemaMetaclass:
    from ..internals import dtype as dt
    from ..internals.schema import column_definition, schema_builder

    cols: dict[str, Any] = {
        n: column_definition(dtype=cs.dtype)
        for n, cs in schema.columns().items()
    }
    cols["_metadata"] = column_definition(dtype=dt.STR)
    return schema_builder(cols)


def object_source_table(
    client: Any,
    format: str,
    schema: SchemaMetaclass,
    *,
    mode: str,
    with_metadata: bool,
    refresh_interval_ms: int,
    autocommit_duration_ms: int | None,
    name: str | None,
    delimiter: str = ",",
) -> Table:
    """Shared source construction for all object-store connectors (s3,
    minio, gdrive, pyfilesystem)."""
    names = schema.column_names()
    if mode == "static":
        import json as _json
        import time as __time

        rows: list[tuple] = []
        for meta in sorted(client.list_objects(), key=lambda m: m.key):
            data = client.read_object(meta.key)
            parsed = parse_object(data, format, schema, names, delimiter)
            if with_metadata:
                md = _json.dumps({
                    "path": meta.key,
                    "size": meta.size if meta.size is not None else len(data),
                    "seen_at": int(__time.time()),
                    "modified_at": (
                        int(meta.modified_at)
                        if meta.modified_at is not None else None
                    ),
                })
                parsed = [r + (md,) for r in parsed]
            rows.extend(parsed)
        if with_metadata:
            out_schema = _with_metadata_schema(schema)
            return rows_to_table(
                out_schema.column_names(), rows, schema=out_schema
            )
        return rows_to_table(names, rows, schema=schema)

    def build():
        src = ObjectScanSource(
            client, format, schema, names,
            with_metadata=with_metadata,
            delimiter=delimiter,
            refresh_interval_s=refresh_interval_ms / 1000.0,
            autocommit_ms=autocommit_duration_ms,
        )
        src.persistent_id = name
        return src

    out_schema = _with_metadata_schema(schema) if with_metadata else schema
    return Table("source", [], {"build": build}, out_schema, Universe())


def read(
    path: str,
    *,
    aws_s3_settings: AwsS3Settings | None = None,
    format: str = "binary",
    schema: SchemaMetaclass | None = None,
    mode: str = "streaming",
    with_metadata: bool = False,
    autocommit_duration_ms: int | None = 1500,
    refresh_interval_ms: int = 1000,
    name: str | None = None,
    _client: Any = None,
    **kwargs: Any,
) -> Table:
    """Read objects under an S3 path. ``_client`` injects any
    ObjectStoreClient (tests use a filesystem-backed fake; the default is
    boto3 against the real endpoint)."""
    schema = _default_schema(format, schema, "pw.io.s3.read")
    if _client is None:
        bucket, prefix = _split_s3_path(path)
        settings = aws_s3_settings or AwsS3Settings()
        bucket = bucket or settings.bucket_name
        if bucket is None:
            raise ValueError(
                "no bucket: pass 's3://bucket/prefix' or "
                "AwsS3Settings(bucket_name=...)"
            )
        _client = BotoS3Client(settings, bucket, prefix)
    return object_source_table(
        _client, format, schema,
        mode=mode, with_metadata=with_metadata,
        refresh_interval_ms=refresh_interval_ms,
        autocommit_duration_ms=autocommit_duration_ms, name=name,
    )
