"""Commit-wave critical-path attribution for the async execution plane.

The frontier-driven loop dissolved "the tick" into a pipeline of
stages that no existing surface could separate: a worker sweeps, posts
exchange buckets into peer inboxes, waits for every frontier to agree on
a commit time T, drives quiesce vote rounds, snapshots, and releases the
delivery boundary. When p99 moves, the question is *which stage* — and
*which worker held the wave* (Naiad-style frontier introspection,
SURVEY §2.9).

The executor stamps wall-clock phase marks through every commit wave
(``Executor._async_commit_wave``) and hands them here. This module is
the pure half: holding-worker election, stage-split math, the per-wave
document, the bounded per-worker history ring, cluster merge, and the
``critpath`` report renderer — unit-testable without threads or comm
(``tests/test_torch_frontier.py``, ``tests/test_torch_observability.py``).

Wave phases (``PHASES`` order is also the tie-break order):

- ``sweep`` — busy tick time accumulated since the previous wave ended
  (includes the settle sweeps this wave ran);
- ``inbox_dwell`` — summed enqueue->drain->take latency of exchange
  arrivals since the previous wave (frame meta carries the sender's
  enqueue stamp; a sum over rows, so it can exceed wall time — it is a
  load measure, like CPU-seconds);
- ``frontier_wait`` — wall time collecting every worker's ready clock
  (the wave's coordination stall);
- ``settle`` — quiesce wall time minus the busy sweep time inside it
  (pure waiting for vote rounds to go clean);
- ``snapshot`` — operator-state flush + snapshot + meta commit;
- ``release`` — delivery barrier + post-commit release
  (``io/delivery.py`` boundary acks).

Holding-worker election. Every ready broadcast carries the sender's
wave-entry wall time and its pre-wave busy time, so all workers elect
from IDENTICAL data and the verdicts agree by construction. When the
entry spread exceeds the arrival floor (``PATHWAY_WAVE_ARRIVAL_FLOOR_MS``)
the wave had a genuine straggler and the LAST frontier to arrive is the
holder. Below the floor (timer-driven waves: everyone joins within
scheduling jitter) arrival order is noise, so attribution falls to the
worker with the largest pre-wave pipeline occupancy — the frontier the
cluster would wait on under any load increase.

Copy of ``pathway_tpu/observability/critpath.py``; the ``critpath`` command
of the reference's CLI, which prints ``render_report``, stays out with the
CLI.
"""

from __future__ import annotations

import collections
from typing import Any

__all__ = [
    "PHASES",
    "WaveRecorder",
    "elect_holder",
    "attribute_holder",
    "stage_split",
    "merge_worker_waves",
    "merge_process_waves",
    "render_report",
]

PHASES = (
    "sweep",
    "inbox_dwell",
    "frontier_wait",
    "settle",
    "snapshot",
    "release",
)

DEFAULT_HISTORY = 128
DEFAULT_ARRIVAL_FLOOR_MS = 25.0


def elect_holder(
    order: list[tuple[int, int, float]],
) -> int | None:
    """Name the holding worker of a wave from the ready-arrival order.

    ``order`` holds ``(worker, ready_clock, arrival)`` triples —
    ``arrival`` is the sender's wave-entry wall time carried in its
    ready broadcast (any monotone-comparable number works). The holder
    is the LAST frontier to arrive (largest ``arrival``). Ties break by
    the larger ``ready_clock`` (the worker that forced T higher held
    the wave longer), then by the smaller worker id, so every worker
    elects the same holder from the same votes."""
    best: tuple[int, int, float] | None = None
    for w, rc, seq in order:
        key = (seq, rc, -int(w))
        if best is None or key > (best[2], best[1], -best[0]):
            best = (int(w), int(rc), float(seq))
    return best[0] if best is not None else None


def attribute_holder(
    order: list[tuple[int, int, float]],
    busy_ms: dict[int, float] | None = None,
    floor_ms: float = DEFAULT_ARRIVAL_FLOOR_MS,
) -> tuple[int | None, str]:
    """(holder, elected_by) for one wave.

    Primary signal: ready-arrival order. When the entry-time spread in
    ``order`` reaches ``floor_ms`` the wave had a real straggler —
    someone the whole cluster measurably waited for — and the last
    arrival is the holder (``elected_by == "arrival"``). Below the
    floor every worker joined within scheduler jitter (the common case
    for snapshot-timer-driven waves), so arrival order carries no
    lineage; the wave is attributed to the worker with the largest
    pre-wave busy time in ``busy_ms`` (``elected_by == "busy"``) —
    ties break toward the later arrival, then the smaller id. Without
    busy data the arrival election stands."""
    if not order:
        return None, "arrival"
    entries = [float(seq) for _w, _rc, seq in order]
    spread_ms = (max(entries) - min(entries)) * 1000.0
    if spread_ms >= float(floor_ms) or not busy_ms:
        return elect_holder(order), "arrival"
    entry_of = {int(w): float(seq) for w, _rc, seq in order}
    holder = max(
        busy_ms,
        key=lambda w: (
            float(busy_ms[w]),
            entry_of.get(int(w), 0.0),
            -int(w),
        ),
    )
    return int(holder), "busy"


def stage_split(
    phases_ms: dict[str, float],
) -> tuple[str | None, dict[str, float]]:
    """(critical stage, per-stage share of the phase total). The
    critical stage is the largest phase; ties break in ``PHASES`` order
    so the verdict is deterministic. Shares are fractions of the summed
    phase time (0.0 when nothing was measured)."""
    total = sum(max(0.0, phases_ms.get(p, 0.0)) for p in PHASES)
    shares = {
        p: (max(0.0, phases_ms.get(p, 0.0)) / total if total else 0.0)
        for p in PHASES
    }
    critical: str | None = None
    best = -1.0
    for p in PHASES:
        v = max(0.0, phases_ms.get(p, 0.0))
        if v > best:
            best, critical = v, p
    if best <= 0.0:
        critical = None
    return critical, shares


class WaveRecorder:
    """Bounded per-worker ring of wave documents + holder tally.

    One per worker, owned by the executor while the async loop is live
    (``EngineStats._waves``). ``record_wave`` builds the per-wave doc
    (election + stage split), appends it, and returns it so the caller
    can fold the numbers into its counters."""

    def __init__(
        self,
        worker_id: int,
        history: int | None = None,
        arrival_floor_ms: float | None = None,
    ):
        from ..internals.config import _env_float, _env_int

        if history is None:
            history = _env_int("PATHWAY_WAVE_HISTORY", DEFAULT_HISTORY)
        if arrival_floor_ms is None:
            arrival_floor_ms = _env_float(
                "PATHWAY_WAVE_ARRIVAL_FLOOR_MS", DEFAULT_ARRIVAL_FLOOR_MS
            )
        self.worker_id = worker_id
        self.arrival_floor_ms = float(arrival_floor_ms)
        self.recent: collections.deque = collections.deque(
            maxlen=max(1, int(history))
        )
        self.held_total: dict[str, int] = {}

    def record_wave(
        self,
        *,
        epoch: int,
        T: int,
        t: float,
        duration_ms: float,
        interval_ms: float,
        phases_ms: dict[str, float],
        settle_rounds: int,
        ready_order: list[tuple[int, int, float]],
        busy_ms: dict[int, float] | None = None,
        fin: bool = False,
    ) -> dict:
        holder, elected_by = attribute_holder(
            ready_order, busy_ms, self.arrival_floor_ms
        )
        critical, shares = stage_split(phases_ms)
        doc = {
            "epoch": int(epoch),
            "worker": self.worker_id,
            "T": int(T),
            "t": float(t),
            "duration_ms": round(float(duration_ms), 3),
            "interval_ms": round(float(interval_ms), 3),
            "phases_ms": {
                p: round(float(phases_ms.get(p, 0.0)), 3) for p in PHASES
            },
            "settle_rounds": int(settle_rounds),
            "holder": holder,
            "elected_by": elected_by,
            "critical_stage": critical,
            "shares": {p: round(s, 4) for p, s in shares.items()},
            "ready_order": [
                (int(w), int(rc), round(float(seq), 6))
                for w, rc, seq in ready_order
            ],
        }
        if fin:
            doc["fin"] = True
        self.recent.append(doc)
        if holder is not None:
            k = str(holder)
            self.held_total[k] = self.held_total.get(k, 0) + 1
        return doc

    def snapshot(self) -> dict:
        """JSON form shipped per worker in the hub snapshot/query docs."""
        return {
            "worker": self.worker_id,
            "last": self.recent[-1] if self.recent else None,
            "recent": list(self.recent),
            "held_total": dict(self.held_total),
        }


def _merge_epoch(docs: list[dict]) -> dict:
    """One cluster-wide wave doc from every worker's view of the same
    epoch. The holder is elected by majority over the per-worker
    verdicts (every ready broadcast carries the same entry/busy data,
    so disagreement normally means a stale or partial view — ties
    break toward the smaller worker id); ``agreed`` records unanimity,
    the condition under which crash bundles may name the holder."""
    votes: dict[int, int] = {}
    for d in docs:
        h = d.get("holder")
        if h is not None:
            votes[int(h)] = votes.get(int(h), 0) + 1
    holder = None
    if votes:
        holder = min(
            votes, key=lambda w: (-votes[w], w)
        )
    phases = {
        p: max(float(d.get("phases_ms", {}).get(p, 0.0)) for d in docs)
        for p in PHASES
    }
    critical, shares = stage_split(phases)
    head = max(docs, key=lambda d: d.get("duration_ms", 0.0))
    return {
        "epoch": head.get("epoch"),
        "T": head.get("T"),
        "t": min(d.get("t", 0.0) for d in docs),
        "duration_ms": head.get("duration_ms", 0.0),
        "holder": holder,
        "agreed": len(votes) == 1 and holder is not None,
        "critical_stage": critical,
        "shares": {p: round(s, 4) for p, s in shares.items()},
        "settle_rounds": max(
            int(d.get("settle_rounds", 0)) for d in docs
        ),
        "workers": {
            str(d.get("worker", "?")): {
                "duration_ms": d.get("duration_ms", 0.0),
                "phases_ms": d.get("phases_ms", {}),
                "critical_stage": d.get("critical_stage"),
                "holder": d.get("holder"),
            }
            for d in docs
        },
    }


def merge_worker_waves(worker_snaps: dict[str, dict | None]) -> dict:
    """Merge per-worker :meth:`WaveRecorder.snapshot` docs (one process)
    into the process-level ``waves`` document served on ``/query``."""
    by_epoch: dict[int, list[dict]] = {}
    held: dict[str, int] = {}
    for snap in worker_snaps.values():
        if not snap:
            continue
        for d in snap.get("recent") or []:
            by_epoch.setdefault(int(d.get("epoch", -1)), []).append(d)
        for w, n in (snap.get("held_total") or {}).items():
            held[w] = held.get(w, 0) + int(n)
    recent = [
        _merge_epoch(docs) for _, docs in sorted(by_epoch.items())
    ]
    return _finish_waves_doc(recent, held)


def merge_process_waves(docs: list[dict | None]) -> dict:
    """Cluster merge of per-process ``waves`` documents (process 0's
    /query roll-up — the same shape back, so it re-merges)."""
    by_epoch: dict[int, dict] = {}
    held: dict[str, int] = {}
    for doc in docs:
        if not doc:
            continue
        for w, n in (doc.get("held_total") or {}).items():
            held[w] = held.get(w, 0) + int(n)
        for wave in doc.get("recent") or []:
            ep = int(wave.get("epoch", -1))
            cur = by_epoch.get(ep)
            if cur is None:
                by_epoch[ep] = dict(wave)
                by_epoch[ep]["workers"] = dict(wave.get("workers", {}))
                continue
            cur["workers"].update(wave.get("workers", {}))
            if wave.get("duration_ms", 0.0) > cur.get("duration_ms", 0.0):
                for k in ("duration_ms", "critical_stage", "shares"):
                    cur[k] = wave.get(k)
            # holder re-election over the union of worker verdicts
            votes: dict[int, int] = {}
            for w in cur["workers"].values():
                h = w.get("holder")
                if h is not None:
                    votes[int(h)] = votes.get(int(h), 0) + 1
            if votes:
                cur["holder"] = min(votes, key=lambda x: (-votes[x], x))
                cur["agreed"] = len(votes) == 1
    recent = [by_epoch[ep] for ep in sorted(by_epoch)]
    return _finish_waves_doc(recent, held)


def _finish_waves_doc(recent: list[dict], held: dict[str, int]) -> dict:
    total_held = sum(held.values()) or 0
    return {
        "waves": len(recent),
        "recent": recent,
        "held_total": held,
        "holder_share": {
            w: round(n / total_held, 4) for w, n in sorted(held.items())
        }
        if total_held
        else {},
        "last": recent[-1] if recent else None,
    }


def render_report(waves_doc: dict | None, top_k: int = 10) -> str:
    """The ``pathway-tpu critpath`` report: top-K slowest waves with
    their holding worker and stage split, plus the holder tally."""
    if not waves_doc or not waves_doc.get("recent"):
        return "critpath: no commit waves recorded (async plane idle?)"
    lines = []
    held = waves_doc.get("holder_share") or {}
    if held:
        tally = "  ".join(
            f"w{w}:{share * 100:.0f}%"
            for w, share in sorted(
                held.items(), key=lambda kv: (-kv[1], kv[0])
            )
        )
        lines.append(
            f"waves held ({sum((waves_doc.get('held_total') or {}).values())}"
            f" waves): {tally}"
        )
    ranked = sorted(
        waves_doc["recent"],
        key=lambda d: -float(d.get("duration_ms", 0.0)),
    )[: max(1, int(top_k))]
    lines.append(
        f"top {len(ranked)} slowest waves "
        f"(of {len(waves_doc['recent'])} recorded):"
    )
    for d in ranked:
        split = " ".join(
            f"{p}={d.get('shares', {}).get(p, 0.0) * 100:.0f}%"
            for p in PHASES
            if d.get("shares", {}).get(p, 0.0) >= 0.005
        )
        holder = d.get("holder")
        agreed = "" if d.get("agreed", True) else " (disputed)"
        lines.append(
            f"  wave {d.get('epoch')} T={d.get('T')} "
            f"{d.get('duration_ms', 0.0):.1f}ms "
            f"holder=w{holder if holder is not None else '?'}{agreed} "
            f"critical={d.get('critical_stage')} "
            f"rounds={d.get('settle_rounds', 0)} [{split}]"
        )
    return "\n".join(lines)
