"""``pw.io.jsonlines`` — wrapper over ``pw.io.fs`` with format=json
(reference ``python/pathway/io/jsonlines``).

Copy of ``pathway_tpu/io/jsonlines.py``."""

from __future__ import annotations

from typing import Any

from . import fs


def read(path, *, schema=None, mode: str = "streaming", json_field_paths=None, **kwargs: Any):
    return fs.read(path, format="json", schema=schema, mode=mode,
                   json_field_paths=json_field_paths, **kwargs)


def write(table, filename, **kwargs: Any) -> None:
    fs.write(table, filename, format="json", **kwargs)
