"""``pw.io.http`` — the REST server connector.

Port of ``pathway_tpu/io/http/__init__.py`` without the streaming client ``read`` and the
delivery-managed ``write``: both need ``requests`` (ROADMAP Queue 3). The retry surface is the
shared :class:`pathway_tpu_torch.io.delivery.RetryPolicy`, re-exported here as the reference
does.
"""

from __future__ import annotations

from ..delivery import RetryPolicy
from ._server import PathwayWebserver, rest_connector

__all__ = ["rest_connector", "PathwayWebserver", "RetryPolicy"]
