"""Liveness/readiness probe logic (kubernetes-style semantics).

- ``/healthz`` — the process is alive AND no executor thread is wedged: a
  worker whose event loop has neither finished nor heartbeat within the
  wedge timeout (a stuck collective, a deadlocked UDF, a hung connector)
  fails the probe so the orchestrator can restart the process. The
  executor heartbeats every tick AND every idle park cycle
  (``engine/executor.py``), so an idle-but-live stream stays healthy.
- ``/readyz`` — the dataflow is serving: every worker's sources are
  connected and its first frontier has advanced (at least one tick swept,
  or the run already finished — an empty batch run is trivially ready).
  Load balancers use this to gate traffic during startup/recovery replay.

Copy of ``pathway_tpu/observability/health.py``.
"""

from __future__ import annotations

from typing import Any

__all__ = ["health_status", "ready_status"]


def health_status(
    stats_list: list[Any], wedge_timeout_s: float
) -> tuple[bool, dict]:
    import time

    now = time.time()
    wedged = []
    for s in stats_list:
        if s.finished:
            continue
        age = now - s.last_heartbeat
        if age > wedge_timeout_s:
            wedged.append({"heartbeat_age_s": round(age, 3)})
    if not stats_list:
        # server up before any executor registered: alive, not wedged
        return True, {"status": "ok", "workers": 0}
    if wedged:
        return False, {"status": "wedged", "wedged_workers": wedged}
    return True, {"status": "ok", "workers": len(stats_list)}


def ready_status(stats_list: list[Any]) -> tuple[bool, dict]:
    if not stats_list:
        return False, {"status": "starting", "reason": "no executor yet"}
    not_ready = []
    for s in stats_list:
        if not s.sources_connected:
            not_ready.append("sources not connected")
        elif s.ticks == 0 and not s.finished:
            not_ready.append("first frontier not advanced")
    if not_ready:
        return False, {"status": "starting", "reasons": not_ready}
    return True, {"status": "ready", "workers": len(stats_list)}
