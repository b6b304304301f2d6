"""``pw.temporal`` — windows, temporal joins, behaviors.

Re-design of ``python/pathway/stdlib/temporal`` (windows ``_window.py:42-865``,
interval_join ``_interval_join.py:577``, window_join ``_window_join.py:156``,
asof joins ``_asof_join.py:479`` / ``_asof_now_join.py:176``, behaviors
``temporal_behavior.py:29,83``). Tumbling/sliding windows compile to a
flatten+groupby pipeline over the existing engine ops; session windows and
asof joins ride the GroupedRecompute operator; behaviors map to the engine's
BufferUntil/ForgetAfter nodes (the ``time_column.rs`` analogs).

Copy of ``pathway_tpu/stdlib/temporal/__init__.py``, over the port's Table API and engine nodes.
"""

from ._window import (
    Window,
    intervals_over,
    session,
    sliding,
    tumbling,
    windowby,
)
from ._interval_join import (
    interval,
    interval_join,
    interval_join_inner,
    interval_join_left,
    interval_join_outer,
    interval_join_right,
)
from ._window_join import (
    window_join,
    window_join_inner,
    window_join_left,
    window_join_outer,
    window_join_right,
)
from ._asof_join import Direction, asof_join, asof_join_left, asof_now_join
from .temporal_behavior import (
    CommonBehavior,
    ExactlyOnceBehavior,
    common_behavior,
    exactly_once_behavior,
)

__all__ = [
    "Window",
    "tumbling",
    "sliding",
    "session",
    "intervals_over",
    "windowby",
    "interval",
    "interval_join",
    "interval_join_inner",
    "interval_join_left",
    "interval_join_right",
    "interval_join_outer",
    "window_join",
    "window_join_inner",
    "window_join_left",
    "window_join_right",
    "window_join_outer",
    "asof_join",
    "asof_join_left",
    "asof_now_join",
    "Direction",
    "CommonBehavior",
    "ExactlyOnceBehavior",
    "common_behavior",
    "exactly_once_behavior",
]
