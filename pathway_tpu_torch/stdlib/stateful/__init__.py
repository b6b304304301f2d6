"""pw.stateful (reference python/pathway/stdlib/stateful/deduplicate.py:9).

Copy of ``pathway_tpu/stdlib/stateful/__init__.py``, over the port's Table API and engine nodes.
"""

from __future__ import annotations

from typing import Any, Callable


def deduplicate(
    table,
    *,
    col=None,
    value=None,
    instance=None,
    acceptor: Callable[[Any, Any], bool],
    persistent_id: str | None = None,
):
    """``col=`` is the reference keyword (deduplicate.py:9); ``value=``
    is kept as an alias matching ``Table.deduplicate``."""
    if (col is None) == (value is None):
        raise TypeError("deduplicate needs exactly one of col= / value=")
    return table.deduplicate(
        value=col if col is not None else value,
        instance=instance,
        acceptor=acceptor,
    )
