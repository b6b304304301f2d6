"""``pw.io.minio`` — MinIO source (reference
``python/pathway/io/minio``): S3 connector with path-style addressing.

Copy of ``pathway_tpu/io/minio.py``.
"""

from __future__ import annotations

from typing import Any

from .s3 import AwsS3Settings, read as _s3_read

__all__ = ["read", "MinIOSettings"]


class MinIOSettings:
    def __init__(self, endpoint: str, bucket_name: str, access_key: str,
                 secret_access_key: str, *, with_path_style: bool = True,
                 **kwargs: Any):
        self.endpoint = endpoint
        self.bucket_name = bucket_name
        self.access_key = access_key
        self.secret_access_key = secret_access_key
        self.with_path_style = with_path_style

    def create_aws_settings(self) -> AwsS3Settings:
        return AwsS3Settings(
            bucket_name=self.bucket_name, access_key=self.access_key,
            secret_access_key=self.secret_access_key,
            with_path_style=self.with_path_style, endpoint=self.endpoint,
        )


def read(path: str, minio_settings: MinIOSettings, **kwargs: Any):
    return _s3_read(path, aws_s3_settings=minio_settings.create_aws_settings(), **kwargs)
