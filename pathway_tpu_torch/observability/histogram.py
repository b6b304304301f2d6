"""Lock-cheap log-bucketed latency histogram.

The reference engine reports distribution-level operator latency through
its OTLP metrics pipeline (``src/engine/telemetry.rs:47-156``); the seed
only kept scalar sums and a last-value gauge, which cannot distinguish a
steady p99 regression from one slow outlier. ``LogHistogram`` fills that
gap with the classic HdrHistogram-style trick reduced to its cheapest
form: values are non-negative integer nanoseconds and the bucket index is
``value.bit_length()`` — one CPython int op, no float math, no search.
Bucket ``i`` therefore covers ``[2**(i-1), 2**i)`` ns, a ~2x resolution
geometric ladder spanning 1 ns to ~290 years in 64 buckets.

Thread-safety: the hot path (``observe``) deliberately takes no lock.
Under the GIL ``list[i] += 1`` can lose an increment when two executor
threads collide on the same bucket, which skews a count by at most the
collision rate — acceptable for telemetry, and the reason the executor
can afford to observe every tick. ``snapshot()`` copies the bucket array
and derives the total from it, so the buckets and ``count`` a reader
(the /metrics endpoint, the OTLP flusher, cluster roll-up) sees are
always mutually consistent even when taken mid-observe.

Snapshots are plain JSON dicts so mesh workers can ship them across
processes (``parallel/cluster.py`` frames or an HTTP scrape) and process
0 can :func:`merge` them into a cluster-level distribution.

Copy of ``pathway_tpu/observability/histogram.py``.
"""

from __future__ import annotations

import threading

__all__ = ["LogHistogram", "merge_snapshots", "quantile_from_snapshot"]

N_BUCKETS = 64


class LogHistogram:
    """Log2-bucketed histogram of non-negative integer values (nanoseconds
    by convention for all engine latency series)."""

    __slots__ = ("_counts", "_sum", "_count", "_lock")

    def __init__(self) -> None:
        self._counts = [0] * N_BUCKETS
        self._sum = 0
        self._count = 0
        self._lock = threading.Lock()

    # -- hot path ------------------------------------------------------

    def observe(self, value_ns: int) -> None:
        """Record one value. No lock: a lost increment under thread
        collision is an accepted telemetry-grade error."""
        v = int(value_ns)
        if v < 0:
            v = 0
        i = v.bit_length()
        if i >= N_BUCKETS:
            i = N_BUCKETS - 1
        self._counts[i] += 1
        self._sum += v
        self._count += 1

    def __len__(self) -> int:
        return self._count

    # -- read side -----------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-serializable state: ``{"counts", "sum", "count"}`` (counts
        per log2 bucket, sum in ns). ``count`` is derived from the bucket
        array, not ``_count``: observe() is lock-free, so a snapshot taken
        mid-observe could otherwise see a bucket increment whose ``_count``
        update is still pending — and a cumulative ``_bucket`` series
        exceeding its ``+Inf``/``_count`` total is non-monotone exposition
        text. Deriving keeps buckets and total self-consistent by
        construction (``sum`` may trail by the in-flight value, which only
        skews the mean — telemetry-grade)."""
        with self._lock:
            counts = list(self._counts)
            return {
                "counts": counts,
                "sum": int(self._sum),
                "count": sum(counts),
            }

    def quantile(self, q: float) -> float:
        """Approximate q-quantile in nanoseconds (geometric bucket
        midpoint; ~±41% worst case, exact enough for p50/p95/p99 trend
        lines)."""
        return quantile_from_snapshot(self.snapshot(), q)

    def percentiles(self) -> dict[str, float]:
        snap = self.snapshot()
        return {
            "p50": quantile_from_snapshot(snap, 0.50),
            "p95": quantile_from_snapshot(snap, 0.95),
            "p99": quantile_from_snapshot(snap, 0.99),
        }


def merge_snapshots(snaps: list[dict]) -> dict:
    """Pointwise sum of histogram snapshots — the cluster roll-up merge.
    Log buckets share boundaries across workers, so merging is exact."""
    counts = [0] * N_BUCKETS
    total_sum = 0
    total_count = 0
    for s in snaps:
        for i, c in enumerate(s.get("counts", ())[:N_BUCKETS]):
            counts[i] += int(c)
        total_sum += int(s.get("sum", 0))
        total_count += int(s.get("count", 0))
    return {"counts": counts, "sum": total_sum, "count": total_count}


def quantile_from_snapshot(snap: dict, q: float) -> float:
    counts = snap["counts"]
    total = snap["count"]
    if total <= 0:
        return 0.0
    rank = max(1, int(q * total + 0.5))
    seen = 0
    for i, c in enumerate(counts):
        seen += c
        if seen >= rank:
            if i == 0:
                return 0.0
            lo = 1 << (i - 1)
            hi = 1 << i
            # geometric midpoint of the bucket
            return float((lo * hi) ** 0.5)
    return float(1 << (N_BUCKETS - 1))
