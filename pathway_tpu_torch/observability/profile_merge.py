"""Cluster merge + rendering for profiler snapshots.

Per-process profile documents (``Profiler.snapshot()``) carry their
collapsed-stack tables as :class:`~.keyload.SpaceSaving` wire forms, so
merging peers is the sketch merge — associative in any grouping, exact
while the union of tracked stacks fits capacity, epsilon-bounded beyond
it. A merged document has the *same shape* as a per-process one (plus
``processes``/``merged`` provenance), so it can be merged again: the hub
on process 0 merges scraped peers, a fleet aggregator could merge hubs.

Renderers:

- :func:`collapsed_text` — classic folded-stack lines
  (``frame;frame;... count``), pipe straight into any flamegraph tool;
- :func:`speedscope_document` — https://www.speedscope.app sampled
  profile (paste the JSON, get the interactive flamegraph);
- :func:`top_frames` — self-time ranking by leaf frame, each with its
  dominant operator tag;
- :func:`operator_shares` / :func:`top_operator` — per-operator weight,
  the join surface against ``/attribution``'s ranking;
- :func:`render_top` — the ``pathway-tpu profile`` terminal table.

Copy of ``pathway_tpu/observability/profile_merge.py``.
"""

from __future__ import annotations

from typing import Any

from .keyload import SpaceSaving

__all__ = [
    "merge_snapshots",
    "collapsed_text",
    "speedscope_document",
    "top_frames",
    "operator_shares",
    "top_operator",
    "render_top",
    "split_stack_key",
]

_SUM_KEYS = ("samples_total", "engine_samples", "op_tagged", "errors_total")


def _empty_doc() -> dict:
    return {
        "enabled": False,
        "samples_total": 0,
        "engine_samples": 0,
        "op_tagged": 0,
        "errors_total": 0,
        "duration_s": 0.0,
        "cpu_supported": False,
        "wall": SpaceSaving(1).snapshot(),
        "cpu": SpaceSaving(1).snapshot(),
        "processes": [],
    }


def merge_snapshots(snaps: list[dict | None]) -> dict:
    """Merge per-process (or already-merged) profile documents into one
    cluster document; ``None``/empty peers are skipped."""
    live = [s for s in snaps if s and s.get("wall")]
    if not live:
        return _empty_doc()
    wall = SpaceSaving.from_snapshot(live[0]["wall"])
    cpu = SpaceSaving.from_snapshot(live[0].get("cpu") or {"capacity": 1})
    for s in live[1:]:
        wall = wall.merge(SpaceSaving.from_snapshot(s["wall"]))
        if s.get("cpu"):
            cpu = cpu.merge(SpaceSaving.from_snapshot(s["cpu"]))
    out: dict[str, Any] = {
        "enabled": any(s.get("enabled") for s in live),
        "merged": True,
        "hz": live[0].get("hz"),
        "capacity": min(int(s.get("capacity") or wall.capacity) for s in live),
        "duration_s": max(float(s.get("duration_s") or 0.0) for s in live),
        "cpu_supported": any(s.get("cpu_supported") for s in live),
        "wall": wall.snapshot(),
        "cpu": cpu.snapshot(),
    }
    for k in _SUM_KEYS:
        out[k] = sum(int(s.get(k) or 0) for s in live)
    procs: list[int] = []
    for s in live:
        sub = s.get("processes")
        if sub:
            procs.extend(int(p) for p in sub)
        elif s.get("process_id") is not None:
            procs.append(int(s["process_id"]))
    out["processes"] = sorted(set(procs))
    eng = out["engine_samples"]
    out["op_tagged_share"] = round(out["op_tagged"] / eng, 4) if eng else 0.0
    return out


# -- stack-key helpers --------------------------------------------------


def split_stack_key(key: str) -> tuple[str | None, str | None, list[str]]:
    """Collapsed key -> ``(thread, op, frames)``; the thread/op head
    segments are optional and order-fixed (thread first)."""
    parts = key.split(";")
    thread: str | None = None
    op: str | None = None
    i = 0
    if i < len(parts) and parts[i].startswith("thread:"):
        thread = parts[i][7:]
        i += 1
    if i < len(parts) and parts[i].startswith("op:"):
        op = parts[i][3:]
        i += 1
    return thread, op, parts[i:]


def _sketch(doc: dict, mode: str) -> SpaceSaving:
    snap = doc.get(mode) or {"capacity": 1}
    return SpaceSaving.from_snapshot(snap)


def collapsed_text(doc: dict, mode: str = "wall") -> str:
    """Folded-stack lines, heaviest first — flamegraph.pl input. Wall
    counts are samples; cpu counts are seconds (rendered in ms so the
    integer-weight convention of folded files survives)."""
    scale = 1000.0 if mode == "cpu" else 1.0
    lines = []
    for key, count, _err in _sketch(doc, mode).items():
        w = int(round(count * scale))
        if w > 0:
            lines.append(f"{key} {w}")
    return "\n".join(lines) + ("\n" if lines else "")


def speedscope_document(
    doc: dict, mode: str = "wall", name: str = "pathway-tpu"
) -> dict:
    """A speedscope ``sampled`` profile: shared frame table + one entry
    per distinct collapsed stack, weighted by its fold count."""
    frame_index: dict[str, int] = {}
    frames: list[dict] = []
    samples: list[list[int]] = []
    weights: list[float] = []
    for key, count, _err in _sketch(doc, mode).items():
        thread, op, stack = split_stack_key(key)
        labels = []
        if thread:
            labels.append(f"[thread {thread}]")
        if op:
            labels.append(f"[op {op}]")
        labels.extend(stack)
        idxs = []
        for label in labels:
            at = frame_index.get(label)
            if at is None:
                at = frame_index[label] = len(frames)
                frames.append({"name": label})
            idxs.append(at)
        samples.append(idxs)
        weights.append(round(count, 4))
    total = round(sum(weights), 4)
    return {
        "$schema": "https://www.speedscope.app/file-format-schema.json",
        "shared": {"frames": frames},
        "profiles": [
            {
                "type": "sampled",
                "name": f"{name} ({mode})",
                "unit": "seconds" if mode == "cpu" else "none",
                "startValue": 0,
                "endValue": total,
                "samples": samples,
                "weights": weights,
            }
        ],
        "exporter": "pathway-tpu-profiler",
    }


def top_frames(doc: dict, n: int = 15, mode: str = "wall") -> list[dict]:
    """Self-time ranking: weight folded onto each stack's LEAF frame,
    with the frame's dominant operator tag riding along (the
    flamegraph-to-attribution join, row by row)."""
    self_w: dict[str, float] = {}
    by_op: dict[str, dict[str, float]] = {}
    total = 0.0
    for key, count, _err in _sketch(doc, mode).items():
        _thread, op, stack = split_stack_key(key)
        if not stack:
            continue
        leaf = stack[-1]
        self_w[leaf] = self_w.get(leaf, 0.0) + count
        total += count
        ops = by_op.setdefault(leaf, {})
        ops[op or "-"] = ops.get(op or "-", 0.0) + count
    ranked = sorted(self_w.items(), key=lambda t: (-t[1], t[0]))[: max(1, n)]
    out = []
    for frame, w in ranked:
        ops = by_op.get(frame) or {}
        dominant = max(ops, key=lambda o: (ops[o], o)) if ops else "-"
        out.append(
            {
                "frame": frame,
                "self": round(w, 4),
                "share": round(w / total, 4) if total else 0.0,
                "op": dominant,
            }
        )
    return out


def operator_shares(doc: dict, mode: str = "wall") -> dict[str, float]:
    """op label -> share of op-tagged weight (untagged stacks excluded —
    this ranks *operators*, matching what /attribution ranks)."""
    w: dict[str, float] = {}
    for key, count, _err in _sketch(doc, mode).items():
        _thread, op, _stack = split_stack_key(key)
        if op is not None:
            w[op] = w.get(op, 0.0) + count
    total = sum(w.values())
    if not total:
        return {}
    return {
        op: round(v / total, 4)
        for op, v in sorted(w.items(), key=lambda t: (-t[1], t[0]))
    }


def top_operator(doc: dict, mode: str = "wall") -> str | None:
    shares = operator_shares(doc, mode)
    return next(iter(shares), None)


def render_top(doc: dict, n: int = 15, mode: str = "wall") -> str:
    """Terminal table for ``pathway-tpu profile`` — header summary plus
    the self-time leaderboard with operator tags."""
    unit = "s" if mode == "cpu" else "samples"
    lines = [
        (
            f"profile [{mode}]  samples={int(doc.get('samples_total') or 0)}"
            f"  duration={float(doc.get('duration_s') or 0.0):.1f}s"
            f"  op-tagged={100.0 * _tagged_share(doc):.1f}%"
            f"  processes={doc.get('processes') or [doc.get('process_id', 0)]}"
        ),
        f"{'SELF%':>6}  {'SELF(' + unit + ')':>12}  {'OPERATOR':<18} FRAME",
    ]
    for row in top_frames(doc, n=n, mode=mode):
        lines.append(
            f"{100.0 * row['share']:>5.1f}%  {row['self']:>12.2f}  "
            f"{row['op']:<18} {row['frame']}"
        )
    stale = doc.get("stale")
    if stale:
        lines.append(f"stale peers: {stale}")
    return "\n".join(lines) + "\n"


def _tagged_share(doc: dict) -> float:
    eng = int(doc.get("engine_samples") or 0)
    if not eng:
        return float(doc.get("op_tagged_share") or 0.0)
    return int(doc.get("op_tagged") or 0) / eng
