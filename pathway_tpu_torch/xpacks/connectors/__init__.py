"""``pw.xpacks.connectors`` — service connectors beyond ``pw.io``
(reference ``python/pathway/xpacks/connectors``).

Copy of ``pathway_tpu/xpacks/connectors/__init__.py``.
"""

from . import sharepoint

__all__ = ["sharepoint"]
