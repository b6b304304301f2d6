"""``pw.io.plaintext`` (reference ``python/pathway/io/plaintext``).

Copy of ``pathway_tpu/io/plaintext.py``."""

from __future__ import annotations

from typing import Any

from . import fs


def read(path, *, mode: str = "streaming", **kwargs: Any):
    return fs.read(path, format="plaintext", mode=mode, **kwargs)
