"""Shared lint-mode state — armed by ``pathway_tpu_torch.analysis.lint``.

Copy of ``pathway_tpu/internals/lintmode.py``.

When the static analyzer drives a user script (``analysis.lint.lint_script``), the
script must BUILD its dataflow without EXECUTING it, and diagnostics
should point at the script line that created each table. Both behaviors
live behind this tiny module so ``internals/run.py`` and
``internals/table.py`` can consult it without importing the analysis
package (no import cycles, zero cost when lint mode is off):

- ``ACTIVE`` — lint mode armed; ``pw.run()`` becomes a no-op that
  records its ``persistence_config`` into ``CAPTURE`` instead of
  executing, and ``Table.__init__`` records the creating script line.
- ``SCRIPT`` — absolute path of the script being linted; stack frames
  from this file are the ones recorded as creation sites.
- ``LOCATIONS`` — ``table_seq -> (filename, lineno)`` creation sites.
- ``CAPTURE`` — what the stubbed ``pw.run`` observed (persistence
  config, number of run calls).
"""

from __future__ import annotations

import sys
from typing import Any

ACTIVE: bool = False
SCRIPT: str | None = None
LOCATIONS: dict[int, tuple[str, int]] = {}
CAPTURE: dict[str, Any] = {"persistence_config": None, "runs": 0}


def arm(script: str | None) -> None:
    global ACTIVE, SCRIPT
    ACTIVE = True
    SCRIPT = script
    LOCATIONS.clear()
    CAPTURE.update(persistence_config=None, runs=0)


def disarm() -> None:
    global ACTIVE, SCRIPT
    ACTIVE = False
    SCRIPT = None


def script_location(start_depth: int = 2) -> tuple[str, int] | None:
    """(filename, lineno) of the first stack frame belonging to the
    linted SCRIPT, walking outward from ``start_depth`` (capped) — the
    one place that knows the sys._getframe walk."""
    if SCRIPT is None:
        return None
    frame = sys._getframe(start_depth)
    depth = 0
    while frame is not None and depth < 40:
        if frame.f_code.co_filename == SCRIPT:
            return (frame.f_code.co_filename, frame.f_lineno)
        frame = frame.f_back
        depth += 1
    return None


def note_table(table_seq: int) -> None:
    """Record the linted script's frame that created a table."""
    loc = script_location(start_depth=3)
    if loc is not None:
        LOCATIONS[table_seq] = loc


def note_run(persistence_config: Any) -> None:
    CAPTURE["runs"] = CAPTURE.get("runs", 0) + 1
    if persistence_config is not None:
        CAPTURE["persistence_config"] = persistence_config
