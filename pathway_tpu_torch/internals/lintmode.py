"""Shared lint-mode state — armed by ``pathway_tpu_torch.analysis.lint``.

Copy of ``pathway_tpu/internals/lintmode.py``, with ``DEVICE``.

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
- ``DEVICE`` — the device the analysis lowers the graph on (``lint
  --device``); the port's examples take it as their ``--device`` default
  while they are linted (``device()``), so that a lint on the host builds
  their encoders on the host.
"""

from __future__ import annotations

import sys
from typing import Any

ACTIVE: bool = False
SCRIPT: str | None = None
LOCATIONS: dict[int, tuple[str, int]] = {}
CAPTURE: dict[str, Any] = {"persistence_config": None, "runs": 0}
DEVICE: str | None = None


def arm(script: str | None, device: Any = None) -> None:
    global ACTIVE, SCRIPT, DEVICE
    ACTIVE = True
    SCRIPT = script
    DEVICE = None if device is None else str(device)
    LOCATIONS.clear()
    CAPTURE.update(persistence_config=None, runs=0)


def disarm() -> None:
    global ACTIVE, SCRIPT, DEVICE
    ACTIVE = False
    SCRIPT = None
    DEVICE = None


def device(default: str = "cuda") -> str:
    """The lint's device while a script is linted, else ``default``."""
    return DEVICE if ACTIVE and DEVICE is not None else default


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
