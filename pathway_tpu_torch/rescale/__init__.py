"""Elastic rescaling — repartition persisted cluster state N → M workers.

``rescale(backend, M)`` (or an elastic boot with ``PATHWAY_ELASTIC=1``) runs
the offline resharder in :mod:`resharder`: it opens every ``worker-{i}/``
namespace of the persisted layout, picks the newest operator-snapshot time
common to all workers, splits each stateful operator's state and each live
input chunk by row key with the engine's own ``shard_rows`` hash, merges the
per-destination pieces, and writes a complete layout for M workers under the
next epoch's namespaces — staged under ``rescale-tmp/`` and promoted by one
atomic ``cluster``-marker rewrite.

Copy of ``pathway_tpu/rescale/__init__.py``; the command line's ``rescale``
is not ported.
"""

from .resharder import NoClusterMarker, RescaleError, rescale, stats

__all__ = ["rescale", "stats", "RescaleError", "NoClusterMarker"]
