"""``pw.io.http`` — the REST server connector.

Port of ``pathway_tpu/io/http/__init__.py`` without the streaming client ``read`` and the
delivery-managed ``write``: both need ``io/delivery.py`` and ``requests`` (ROADMAP Queue 3).
"""

from __future__ import annotations

from ._server import PathwayWebserver, rest_connector

__all__ = ["rest_connector", "PathwayWebserver"]
