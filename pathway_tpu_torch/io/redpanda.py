"""``pw.io.redpanda`` — Redpanda is Kafka-protocol compatible
(reference ``python/pathway/io/redpanda`` re-exports kafka).

Copy of ``pathway_tpu/io/redpanda.py``.
"""

from .kafka import read, simple_read, write  # noqa: F401

__all__ = ["read", "write", "simple_read"]
