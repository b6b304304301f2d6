"""``pw.MonitoringLevel`` (reference ``python/pathway/internals/monitoring.py``).

Copy of the class of five constants in ``pathway_tpu/internals/monitoring.py``. ``pw.run``
accepts ``monitoring_level=`` and has no dashboard yet: the monitoring table waits for a later
slice (ROADMAP.md, Queue 1 item 13).
"""

from __future__ import annotations

__all__ = ["MonitoringLevel"]


class MonitoringLevel:
    NONE = 0
    IN_OUT = 1
    ALL = 2
    AUTO = 3
    AUTO_ALL = 4
