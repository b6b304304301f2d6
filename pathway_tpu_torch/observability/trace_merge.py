"""Assemble per-process trace files into one cluster timeline.

A multi-process run writes ``<PATHWAY_TRACE_FILE>.p<N>`` per process
(``internals/tracing.py``), each with timestamps relative to that
process's own ``perf_counter`` origin — N disconnected files with
unaligned clocks. This module (behind ``pathway-tpu trace merge``) joins
them into one Chrome/Perfetto JSON:

- every part's relative timestamps are anchored to the unix clock via the
  ``trace.clock_sync`` metadata its tracer wrote (origin_unix_ns);
- cross-host clock skew is corrected with the per-peer offset estimates
  the cluster handshake ping measured (``ClusterComm
  ._measure_clock_offsets``): process p's own estimate of its offset to
  the reference process wins, the reference's estimate of p is the
  fallback, raw unix anchoring the last resort;
- ``pid`` fields are rewritten to the engine process id (with
  ``process_name`` metadata), so Perfetto shows one labeled track group
  per worker process;
- comm flow events (``ph: s``/``f``) keep their cluster-unique ids and
  now bind across the merged tracks — the arrows that attribute a
  collective stall on worker 3 from worker 0's timeline.

Merging parts from different runs is refused (unless forced): their flow
ids and clocks share nothing.
Copy of ``pathway_tpu/observability/trace_merge.py``: the same merged
document (``python -m pathway_tpu_torch.cli trace merge``). Until the
multi-process cluster is ported a run of the port writes one part.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Any

__all__ = ["discover_parts", "merge_trace", "wave_spans"]


def discover_parts(base: str) -> list[str]:
    """The trace files belonging to ``base`` (a PATHWAY_TRACE_FILE value):
    the ``base.p<N>`` per-process parts when present, else ``base``
    itself. Sorted by process suffix."""
    parts = glob.glob(glob.escape(base) + ".p*")

    def _suffix(p: str) -> int:
        try:
            return int(p.rsplit(".p", 1)[1])
        except (IndexError, ValueError):
            return 1 << 30

    parts = [p for p in parts if _suffix(p) < 1 << 30]
    if parts:
        return sorted(parts, key=_suffix)
    if os.path.exists(base):
        return [base]
    raise OSError(
        f"no trace parts found: neither {base!r} nor {base!r}.p<N> exist"
    )


def _load_part(path: str) -> dict:
    with open(path) as f:
        doc = json.load(f)
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        raise ValueError(f"{path!r} is not a Chrome trace file")
    sync: dict[str, Any] = {}
    for ev in events:
        if ev.get("name") == "trace.clock_sync":
            sync = ev.get("args") or {}
            break
    return {"path": path, "events": events, "sync": sync}


def _offset_to_ref(part: dict, ref: dict) -> float:
    """Unix-clock correction (ns) to add to ``part``'s times to land on
    the reference process's clock."""
    my_id = str(part["sync"].get("process_id", ""))
    ref_id = str(ref["sync"].get("process_id", ""))
    if my_id == ref_id:
        return 0.0
    # own measurement: offsets[ref] = ref_clock - my_clock
    own = (part["sync"].get("clock_offsets") or {}).get(ref_id)
    if own:
        return float(own[0])
    # reference's measurement of us: offsets[me] = my_clock - ref_clock
    theirs = (ref["sync"].get("clock_offsets") or {}).get(my_id)
    if theirs:
        return -float(theirs[0])
    return 0.0  # same-host clocks (or no estimate): raw unix anchoring


def merge_trace(
    base: str,
    output: str | None = None,
    allow_mixed_runs: bool = False,
) -> tuple[str, dict]:
    """Merge ``base``'s parts; returns ``(output_path, report)``."""
    parts = [_load_part(p) for p in discover_parts(base)]
    run_ids = {
        p["sync"].get("run_id") for p in parts if p["sync"].get("run_id")
    }
    if len(run_ids) > 1 and not allow_mixed_runs:
        raise ValueError(
            f"trace parts carry different run ids {sorted(run_ids)} — "
            "either these are genuinely different runs, or a multi-host "
            "ensemble was spawned without exporting the same "
            "PATHWAY_RUN_ID on every machine (--allow-mixed-runs to "
            "merge anyway)"
        )
    ref = parts[0]
    merged: list[dict] = []
    n_flows = 0
    abs_times: list[float] = []
    prepared: list[tuple[dict, float, int]] = []
    for i, part in enumerate(parts):
        origin_ns = float(part["sync"].get("origin_unix_ns") or 0.0)
        corr_ns = _offset_to_ref(part, ref)
        origin_us = (origin_ns + corr_ns) / 1e3
        proc = part["sync"].get("process_id")
        proc = int(proc) if proc is not None else i
        prepared.append((part, origin_us, proc))
        for ev in part["events"]:
            if "ts" in ev and ev.get("ph") != "M":
                abs_times.append(origin_us + float(ev["ts"]))
    t0_us = min(abs_times) if abs_times else 0.0
    for part, origin_us, proc in prepared:
        merged.append(
            {
                "name": "process_name",
                "ph": "M",
                "pid": proc,
                "args": {"name": f"pathway_tpu process {proc}"},
            }
        )
        for ev in part["events"]:
            if ev.get("name") == "process_name" and ev.get("ph") == "M":
                continue  # replaced above with the process-id-keyed one
            out = dict(ev)
            out["pid"] = proc
            if "ts" in out and out.get("ph") != "M":
                out["ts"] = origin_us + float(out["ts"]) - t0_us
            if out.get("ph") in ("s", "t", "f"):
                n_flows += 1
            merged.append(out)
    merged.sort(key=lambda e: (e.get("ts", -1.0), e.get("pid", 0)))
    doc = {
        "traceEvents": merged,
        "displayTimeUnit": "ms",
        "otherData": {
            "run_id": next(iter(run_ids)) if run_ids else None,
            "merged_from": [p["path"] for p in parts],
        },
    }
    out_path = output or f"{base}.merged.json"
    with open(out_path, "w") as f:
        json.dump(doc, f)
    return out_path, {
        "n_parts": len(parts),
        "n_events": len(merged),
        "n_flows": n_flows,
        "run_id": next(iter(run_ids)) if run_ids else None,
    }


def wave_spans(doc: dict, top_k: int = 10) -> list[dict]:
    """Offline critical-path view over a merged trace document: the
    ``wave.commit`` spans (engine/executor.py ``_async_commit_wave``),
    slowest first, each carrying its pid, epoch, holding worker, and
    critical stage from the span args. Complements the live
    ``pathway-tpu critpath`` report when all that's left of a run is
    its trace."""
    spans: list[dict] = []
    for ev in doc.get("traceEvents", []):
        if ev.get("name") != "wave.commit" or ev.get("ph") != "X":
            continue
        args = ev.get("args") or {}
        spans.append(
            {
                "pid": ev.get("pid"),
                "ts_us": float(ev.get("ts", 0.0)),
                "dur_ms": float(ev.get("dur", 0.0)) / 1e3,
                "epoch": args.get("epoch"),
                "T": args.get("T"),
                "holder": args.get("holder"),
                "critical": args.get("critical"),
            }
        )
    spans.sort(key=lambda s: s["dur_ms"], reverse=True)
    return spans[: max(0, top_k)]
