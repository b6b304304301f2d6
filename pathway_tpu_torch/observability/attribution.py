"""Per-operator bottleneck attribution over the signals window.

Answers "which operator is the pipeline slow *in* right now": for every
operator the sampler tracked (``op_time_ns:<Op#id>`` series,
``observability/timeseries.py``), the windowed delta of its cumulative
processing time is its share of the tick sweep's busy time over the
window. The top share — weighted up when the worker's frontier lag is
*growing*, i.e. the slowness is backing real input up rather than just
burning idle headroom — is named ``pathway_bottleneck_operator`` on
``/metrics`` and ranked first in the ``/attribution`` view.

Rows/s per operator rides along so the view distinguishes "slow because
it does all the work" from "slow per row".

Exchange nodes rank like any other operator. Under frontier-driven
asynchronous execution (the default for sharded streaming —
``PATHWAY_ASYNC_EXEC``, engine/executor.py) their per-node time is
genuine work: bucketing, posting, and merging arrivals, with no
blocked-in-collective component — so it belongs in the ranking. Their
aggregate still rides along as ``exchange_wait_ms`` so a comm-bound
pipeline is visible at a glance. (Before async execution this module
EXCLUDED Exchange nodes: under the BSP tick barrier their time measured
waiting for the slowest peer — the symptom of another operator's
slowness, not a cause. ``PATHWAY_ASYNC_EXEC=0`` runs re-inherit that
caveat: read large Exchange shares there as barrier wait.)

Copy of ``pathway_tpu/observability/attribution.py``.
"""

from __future__ import annotations

from typing import Any

from .timeseries import OP_ROWS_PREFIX, OP_TIME_PREFIX, Signals

__all__ = [
    "attribution_document",
    "bottleneck_operator",
    "merge_attribution_documents",
]


def _worker_attribution(
    signals: Signals, worker: int, window_s: float,
) -> list[dict[str, Any]]:
    store = signals.store
    out: list[dict[str, Any]] = []
    for metric in store.metrics(worker):
        if not metric.startswith(OP_TIME_PREFIX):
            continue
        op = metric[len(OP_TIME_PREFIX):]
        busy_ns = signals.delta(metric, window_s, worker)
        if busy_ns is None:
            continue
        rows_rate = signals.rate(OP_ROWS_PREFIX + op, window_s, worker)
        out.append(
            {
                "operator": op,
                "worker": worker,
                "busy_ms": busy_ns / 1e6,
                "rows_per_sec": rows_rate,
            }
        )
    return out


def attribution_document(
    signals: Signals, window_s: float,
) -> dict[str, Any]:
    """Ranked per-operator attribution across every local worker.

    ``share`` is each operator's fraction of the total busy time the
    window saw (summed across workers — an operator sharded over N
    workers aggregates, exactly like its wall-clock footprint).
    ``backlogged`` marks workers whose frontier lag GREW over the window
    — the signature separating "bottleneck holding back the stream" from
    "slow but keeping up"."""
    per_op: dict[str, dict[str, Any]] = {}
    backlogged: list[int] = []
    exchange_wait_ms = 0.0
    wave_stages: dict[str, float] = {}
    for worker in signals.store.workers():
        # commit-wave phase attribution (async plane): cumulative
        # per-phase seconds sampled by the signals plane — the
        # cluster-level complement of the per-operator ranking (which
        # stage of the wave pipeline the cluster's wall time went to)
        for metric in signals.store.metrics(worker):
            if metric.startswith("wave.stage_") and metric.endswith("_s"):
                v = signals.last(metric, worker)
                if v:
                    phase = metric[len("wave.stage_"):-2]
                    wave_stages[phase] = (
                        wave_stages.get(phase, 0.0) + float(v)
                    )
        lag_pts = signals.store.points("frontier_lag_ms", worker, window_s)
        if (
            len(lag_pts) >= 2
            and float(lag_pts[-1][1]) > float(lag_pts[0][1]) + 1.0
        ):
            backlogged.append(worker)
        for entry in _worker_attribution(signals, worker, window_s):
            if entry["operator"].startswith("Exchange#"):
                # ranked AND aggregated: async execution made this real
                # per-operator work (see module docstring)
                exchange_wait_ms += entry["busy_ms"]
            doc = per_op.setdefault(
                entry["operator"],
                {
                    "operator": entry["operator"],
                    "busy_ms": 0.0,
                    "rows_per_sec": 0.0,
                    "workers": {},
                },
            )
            doc["busy_ms"] += entry["busy_ms"]
            if entry["rows_per_sec"] is not None:
                doc["rows_per_sec"] += entry["rows_per_sec"]
            doc["workers"][str(worker)] = round(entry["busy_ms"], 3)
    return _finalize(
        per_op, exchange_wait_ms, backlogged, window_s,
        wave_stages=wave_stages,
    )


def _finalize(
    per_op: dict[str, dict[str, Any]],
    exchange_wait_ms: float,
    backlogged: list,
    window_s: Any,
    wave_stages: dict[str, float] | None = None,
) -> dict[str, Any]:
    """Rank, compute shares, round — THE one place the attribution
    document takes its final shape (single- and merged-process paths)."""
    total = sum(d["busy_ms"] for d in per_op.values())
    ranked = sorted(
        per_op.values(), key=lambda d: d["busy_ms"], reverse=True
    )
    for doc in ranked:
        doc["share"] = round(doc["busy_ms"] / total, 4) if total > 0 else 0.0
        doc["busy_ms"] = round(doc["busy_ms"], 3)
        doc["rows_per_sec"] = round(doc["rows_per_sec"], 1)
    out = {
        "window_s": window_s,
        "total_busy_ms": round(total, 3),
        "exchange_wait_ms": round(exchange_wait_ms, 3),
        "backlogged_workers": sorted(set(backlogged)),
        "bottleneck": ranked[0]["operator"] if ranked else None,
        "ranked": ranked,
    }
    if wave_stages:
        out["wave_stages_s"] = {
            p: round(v, 3) for p, v in sorted(wave_stages.items())
        }
        out["wave_critical_stage"] = max(
            wave_stages, key=lambda p: wave_stages[p]
        )
    return out


def merge_attribution_documents(docs: list[dict]) -> dict:
    """Merge per-process attribution documents (the process-0 ``/query``
    roll-up): an operator sharded over several processes aggregates its
    busy time, exactly like its wall-clock footprint, and the ranking is
    recomputed cluster-wide through the same :func:`_finalize`."""
    docs = [d for d in docs if d]
    if not docs:
        return _finalize({}, 0.0, [], None)
    if len(docs) == 1:
        return docs[0]
    per_op: dict[str, dict[str, Any]] = {}
    backlogged: list = []
    exchange_wait_ms = 0.0
    wave_stages: dict[str, float] = {}
    for doc in docs:
        backlogged.extend(doc.get("backlogged_workers", []))
        exchange_wait_ms += float(doc.get("exchange_wait_ms", 0.0))
        for p, v in (doc.get("wave_stages_s") or {}).items():
            wave_stages[p] = wave_stages.get(p, 0.0) + float(v)
        for entry in doc.get("ranked", []):
            agg = per_op.setdefault(
                entry["operator"],
                {
                    "operator": entry["operator"],
                    "busy_ms": 0.0,
                    "rows_per_sec": 0.0,
                    "workers": {},
                },
            )
            agg["busy_ms"] += float(entry.get("busy_ms", 0.0))
            agg["rows_per_sec"] += float(entry.get("rows_per_sec") or 0.0)
            agg["workers"].update(entry.get("workers", {}))
    return _finalize(
        per_op, exchange_wait_ms, backlogged, docs[0].get("window_s"),
        wave_stages=wave_stages,
    )


def bottleneck_operator(
    signals: Signals, window_s: float,
) -> str | None:
    """Just the top-ranked operator label (the /metrics gauge value)."""
    doc = attribution_document(signals, window_s)
    return doc["bottleneck"]
