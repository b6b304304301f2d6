"""Heavy-hitter key-load accounting over routed exchange buckets.

Skew rebalancing needs a decider-visible answer to
"which key-groups make a shard hot" — provable-cardinality guesses from
the static planner (``analysis/passes.py`` shard-skew lint) cannot see
the actual data. This module measures it at the one place every routed
row passes: the Exchange node's bucketing step.

Design (SpaceSaving, Metwally et al. 2005; merge discipline from
"Mergeable Summaries", Agarwal et al. 2012):

- rows are coarsened to **key-groups** (``K.shard_of(route_keys, G)``
  with ``G = PATHWAY_KEYLOAD_GROUPS``): the same hash family that picks
  the destination shard, over more buckets — so a hot group maps to a
  unique destination and the future rebalancer can move *groups*, not
  individual keys;
- a bounded :class:`SpaceSaving` sketch (``PATHWAY_KEYLOAD_CAPACITY``
  counters) tracks per-group row counts with the classic guarantee
  ``true <= estimate <= true + err`` and ``err <= N / capacity``;
- per-destination row counts ride alongside for tracked groups only
  (bounded by capacity x n_workers), so the report reads "group 17:
  41% of rows, all landing on worker 3";
- sketches merge associatively while the union of tracked groups fits
  capacity (then exactly — the usual case, G is small); beyond it the
  SpaceSaving merge keeps the epsilon bound in any merge order;
- optional exponential decay (``PATHWAY_KEYLOAD_DECAY_S``): counts
  halve every interval, so the ranking reflects the recent window
  rather than the whole run.

The accounting is windowed OFF with ``PATHWAY_KEYLOAD=0`` — the bench's
accounting A/B (``bench.py`` sharded lanes) holds the on/off throughput
delta under 3%.

Everything here is pure (no threads, no comm): per-worker accounts live
on ``EngineStats.keyload``, ship in the hub snapshot like every other
counter, and merge cluster-wide on process 0 (``merge_snapshots``).

Copy of ``pathway_tpu/observability/keyload.py``. ``observe_exchange``
counts a batch's rows by (key group, destination) in one pass, where the
reference makes a mask pass over the batch for each tracked group (64 by
default): the same sketch and per-destination split, at a pass a batch
instead of one a group.
"""

from __future__ import annotations

from typing import Any

__all__ = [
    "SpaceSaving",
    "KeyLoadAccount",
    "maybe_account",
    "merge_snapshots",
    "skew_line",
]

DEFAULT_CAPACITY = 64
DEFAULT_GROUPS = 64


class SpaceSaving:
    """Bounded heavy-hitter sketch: at most ``capacity`` counters.

    ``observe(key, w)`` either bumps a tracked counter or evicts the
    minimum counter ``m`` and admits ``key`` at ``m + w`` with error
    ``m`` — the overestimate discipline that keeps every true heavy
    hitter tracked. ``items()`` returns ``(key, count, err)`` sorted by
    count descending; for any tracked key,
    ``count - err <= true <= count``, and ``err <= total / capacity``.
    """

    __slots__ = ("capacity", "_counts", "_errs", "total")

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._counts: dict[Any, float] = {}
        self._errs: dict[Any, float] = {}
        #: total observed weight (the N of the epsilon bound)
        self.total = 0.0

    def __len__(self) -> int:
        return len(self._counts)

    def observe(self, key: Any, weight: float = 1.0) -> None:
        if weight <= 0:
            return
        self.total += weight
        counts = self._counts
        if key in counts:
            counts[key] += weight
            return
        if len(counts) < self.capacity:
            counts[key] = weight
            self._errs[key] = 0.0
            return
        evict = min(counts, key=lambda k: (counts[k], str(k)))
        floor = counts.pop(evict)
        self._errs.pop(evict, None)
        counts[key] = floor + weight
        self._errs[key] = floor

    def _floor(self) -> float:
        """Estimate for an untracked key: 0 while the sketch has room
        (untracked really means unseen), else the minimum counter."""
        if len(self._counts) < self.capacity:
            return 0.0
        return min(self._counts.values())

    def estimate(self, key: Any) -> tuple[float, float]:
        """(count, err) for ``key`` — tracked or the untracked floor."""
        c = self._counts.get(key)
        if c is not None:
            return c, self._errs.get(key, 0.0)
        f = self._floor()
        return f, f

    def items(self) -> list[tuple[Any, float, float]]:
        """Tracked ``(key, count, err)`` sorted by count descending
        (ties broken by key string for determinism)."""
        return sorted(
            (
                (k, c, self._errs.get(k, 0.0))
                for k, c in self._counts.items()
            ),
            key=lambda t: (-t[1], str(t[0])),
        )

    def error_bound(self) -> float:
        """The sketch-wide overestimate bound: N / capacity."""
        return self.total / self.capacity

    def merge(self, other: "SpaceSaving") -> "SpaceSaving":
        """Combined sketch at ``min`` of the two capacities. Exact (and
        therefore associative in any grouping) while the union of
        tracked keys fits capacity; otherwise the SpaceSaving merge:
        untracked keys contribute the donor sketch's floor, the union is
        truncated to the top ``capacity`` counters, and the epsilon
        bound ``err <= (N1 + N2) / capacity`` holds in any order."""
        cap = min(self.capacity, other.capacity)
        out = SpaceSaving(cap)
        out.total = self.total + other.total
        keys = set(self._counts) | set(other._counts)
        merged: list[tuple[Any, float, float]] = []
        for k in keys:
            c1, e1 = self.estimate(k)
            c2, e2 = other.estimate(k)
            merged.append((k, c1 + c2, e1 + e2))
        merged.sort(key=lambda t: (-t[1], str(t[0])))
        for k, c, e in merged[:cap]:
            out._counts[k] = c
            out._errs[k] = e
        return out

    def decay(self, factor: float) -> None:
        """Scale every counter (window semantics: ``factor=0.5`` halves
        the influence of everything observed so far)."""
        if not 0.0 <= factor <= 1.0:
            raise ValueError(f"decay factor must be in [0,1], got {factor}")
        for k in self._counts:
            self._counts[k] *= factor
        for k in self._errs:
            self._errs[k] *= factor
        self.total *= factor

    # -- wire form (hub snapshot / cluster merge) -----------------------

    def snapshot(self) -> dict:
        return {
            "capacity": self.capacity,
            "total": self.total,
            "counts": {str(k): c for k, c in self._counts.items()},
            "errs": {str(k): e for k, e in self._errs.items()},
        }

    @classmethod
    def from_snapshot(cls, snap: dict) -> "SpaceSaving":
        out = cls(int(snap.get("capacity", DEFAULT_CAPACITY)))
        out.total = float(snap.get("total", 0.0))
        out._counts = {k: float(v) for k, v in (snap.get("counts") or {}).items()}
        out._errs = {k: float(v) for k, v in (snap.get("errs") or {}).items()}
        return out


def _env_knobs() -> tuple[int, int, float]:
    from ..internals.config import _env_float, _env_int

    cap = max(1, _env_int("PATHWAY_KEYLOAD_CAPACITY", DEFAULT_CAPACITY))
    groups = max(2, _env_int("PATHWAY_KEYLOAD_GROUPS", DEFAULT_GROUPS))
    decay_s = max(0.0, _env_float("PATHWAY_KEYLOAD_DECAY_S", 0.0))
    return cap, groups, decay_s


def enabled() -> bool:
    from ..internals.config import _env_bool

    return _env_bool("PATHWAY_KEYLOAD", True)


def maybe_account() -> "KeyLoadAccount | None":
    """One per-worker account when accounting is on (``PATHWAY_KEYLOAD``,
    default on), else None — the single branch the Exchange hot path
    pays when the operator is disabled."""
    return KeyLoadAccount() if enabled() else None


class KeyLoadAccount:
    """Per-worker key-group load ledger fed by Exchange routing."""

    def __init__(
        self,
        capacity: int | None = None,
        n_groups: int | None = None,
        decay_s: float | None = None,
    ):
        env_cap, env_groups, env_decay = _env_knobs()
        self.capacity = capacity if capacity is not None else env_cap
        self.n_groups = n_groups if n_groups is not None else env_groups
        self.decay_s = decay_s if decay_s is not None else env_decay
        self.sketch = SpaceSaving(self.capacity)
        #: group -> destination worker -> rows (tracked groups only)
        self.dest_rows: dict[int, dict[int, int]] = {}
        self.rows_total = 0
        self.bytes_total = 0
        self.batches = 0
        self._last_decay: float | None = None

    def observe_exchange(
        self, route_keys, shards, nbytes: int = 0, now: float | None = None
    ) -> None:
        """One routed Exchange batch: ``route_keys`` (uint64 per row) and
        ``shards`` (destination worker per row), plus the batch's
        approximate byte size. Vectorized per batch — the per-row cost is
        one extra hash pass over keys the router already materialized."""
        import numpy as np

        from ..engine import keys as K

        n = len(shards)
        if n == 0:
            return
        self._maybe_decay(now)
        self.batches += 1
        self.rows_total += n
        self.bytes_total += int(nbytes)
        groups = K.shard_of(route_keys, self.n_groups)
        per_group = np.bincount(groups, minlength=0)
        hot = np.nonzero(per_group)[0]
        for g in hot:
            self.sketch.observe(int(g), int(per_group[g]))
        # per-destination split, bounded to groups the sketch tracks: one
        # count over (group, destination) pairs, where the reference makes a
        # mask pass over the batch for each tracked group
        tracked = self.sketch._counts
        n_dest = int(shards.max()) + 1
        by_dest = np.bincount(
            groups.astype(np.int64) * n_dest + shards,
            minlength=self.n_groups * n_dest,
        ).reshape(self.n_groups, n_dest)
        for g in hot:
            gi = int(g)
            if gi not in tracked:
                continue
            dests = self.dest_rows.setdefault(gi, {})
            for w in np.flatnonzero(by_dest[gi]):
                dests[int(w)] = dests.get(int(w), 0) + int(by_dest[gi, w])
        if len(self.dest_rows) > 2 * self.capacity:
            # evicted groups leave their per-dest split behind — prune to
            # what the sketch still tracks so memory stays bounded
            self.dest_rows = {
                g: d for g, d in self.dest_rows.items() if g in tracked
            }

    def _maybe_decay(self, now: float | None) -> None:
        if self.decay_s <= 0:
            return
        import time as _time

        if now is None:
            now = _time.monotonic()
        if self._last_decay is None:
            self._last_decay = now
            return
        while now - self._last_decay >= self.decay_s:
            self.sketch.decay(0.5)
            for dests in self.dest_rows.values():
                for w in dests:
                    dests[w] = int(dests[w] * 0.5)
            self._last_decay += self.decay_s

    def snapshot(self) -> dict:
        """JSON-serializable account (rides the hub /snapshot document
        under ``"keyload"``; ``merge_snapshots`` rebuilds and merges)."""
        bytes_per_row = (
            self.bytes_total / self.rows_total if self.rows_total else 0.0
        )
        top = []
        total = self.sketch.total or 1.0
        for g, c, e in self.sketch.items():
            top.append(
                {
                    "group": int(g) if not isinstance(g, str) else g,
                    "rows": c,
                    "err": e,
                    "share": c / total,
                    "bytes_est": int(c * bytes_per_row),
                    "dest_rows": {
                        str(w): n
                        for w, n in sorted(
                            self.dest_rows.get(
                                int(g) if not isinstance(g, str) else -1, {}
                            ).items()
                        )
                    },
                }
            )
        return {
            "groups": self.n_groups,
            "capacity": self.capacity,
            "rows_total": self.rows_total,
            "bytes_total": self.bytes_total,
            "batches": self.batches,
            "error_bound": self.sketch.error_bound(),
            "top": top,
            "sketch": self.sketch.snapshot(),
        }


def merge_snapshots(snaps: list[dict | None]) -> dict | None:
    """Cluster-wide ranking: merge per-worker account snapshots (the
    process-0 roll-up, same pull direction as /snapshot). Returns the
    same document shape as :meth:`KeyLoadAccount.snapshot` minus the
    raw sketch wire form, plus ``skew`` — the top group's share times
    the group count (1.0 == perfectly uniform)."""
    snaps = [s for s in snaps if s]
    if not snaps:
        return None
    merged: SpaceSaving | None = None
    dest: dict[str, dict[str, int]] = {}
    rows_total = bytes_total = batches = 0
    groups = max(int(s.get("groups", DEFAULT_GROUPS)) for s in snaps)
    for s in snaps:
        sk = s.get("sketch")
        if sk:
            one = SpaceSaving.from_snapshot(sk)
            merged = one if merged is None else merged.merge(one)
        rows_total += int(s.get("rows_total", 0))
        bytes_total += int(s.get("bytes_total", 0))
        batches += int(s.get("batches", 0))
        for entry in s.get("top") or []:
            d = dest.setdefault(str(entry.get("group")), {})
            for w, n in (entry.get("dest_rows") or {}).items():
                d[w] = d.get(w, 0) + int(n)
    if merged is None:
        return None
    total = merged.total or 1.0
    bytes_per_row = bytes_total / rows_total if rows_total else 0.0
    top = [
        {
            "group": g,
            "rows": c,
            "err": e,
            "share": c / total,
            "bytes_est": int(c * bytes_per_row),
            "dest_rows": dest.get(str(g), {}),
        }
        for g, c, e in merged.items()
    ]
    doc = {
        "groups": groups,
        "capacity": merged.capacity,
        "rows_total": rows_total,
        "bytes_total": bytes_total,
        "batches": batches,
        "error_bound": merged.error_bound(),
        "top": top,
        # the merged sketch's wire form rides along so process-level
        # documents re-merge into the cluster roll-up (associativity:
        # merging merges == merging the originals)
        "sketch": merged.snapshot(),
    }
    if top:
        doc["skew"] = round(top[0]["share"] * groups, 3)
    return doc


def skew_line(doc: dict | None) -> str | None:
    """One-line operator rendering for ``top`` (and the lint note): the
    hottest key-group, its row share, and where it lands."""
    if not doc or not doc.get("top"):
        return None
    head = doc["top"][0]
    dests = head.get("dest_rows") or {}
    where = (
        "->w" + max(dests, key=lambda w: dests[w]) if dests else "->?"
    )
    return (
        f"keyload: group {head['group']} {head['share'] * 100:.1f}% of "
        f"{doc['rows_total']} routed rows {where} "
        f"(x{doc.get('skew', 0):.1f} vs uniform, "
        f"±{doc['error_bound']:.0f} rows)"
    )
