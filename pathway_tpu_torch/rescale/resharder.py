"""The offline state resharder: ``rescale(backend, M)``, and the elastic boot
(``PATHWAY_ELASTIC=1``) of ``persistence/manager.py``.

Checkpoint resharding for a streaming engine — the analog of resharding
model checkpoints across device meshes in JAX training stacks: persisted
operator state is hash-sharded by worker count (``keys.shard_of``, the
reference SHARD_MASK routing), so changing the cluster size means
repartitioning every keyed container and every live input chunk.

Protocol (each phase traced as a ``rescale.*`` span when a tracer is active,
and timed into the report's ``phase_s``):

1. **plan** — read the ``cluster`` marker, every worker's newest
   metadata, and pick the snapshot time ``T``: the newest
   operator-snapshot time present on EVERY worker (the same choice
   recovery makes). Falls back to full-tail replay (``T = -1``) only
   when no input chunk was ever truncated.
2. **stage** — for each stateful-operator rank, read the N per-worker
   state pieces, ``split_state`` each by destination key-shard,
   ``merge_states`` per destination, and write M complete
   ``worker-{j}/`` namespaces (operator blobs at time ``T``, one input
   chunk holding the post-``T`` tail rows routed by ``shard_rows``, a
   single metadata version) under ``rescale-tmp/``.
3. **promote** — copy the staged keys to the next epoch's namespaces
   (fresh keys: the old layout is never touched), then rewrite the
   ``cluster`` marker in ONE put. The marker write is the commit point:
   a crash at any earlier moment leaves the old marker pointing at the
   old, intact layout.
4. **cleanup** — delete the staging keys and the superseded layout.

The report also carries the bytes the run read and wrote through the store
(``bytes_read``, ``bytes_written``) and the store's bytes after cleanup
(``store_bytes``).

Offset carry-over: per-source offsets are unioned across workers and the
union is replicated into every destination's metadata (the post-rescale
owner — source index mod M — is not derivable from a pid name offline,
so every candidate owner must find the offset). The union is exact for
state written by this engine: each source's offset is recorded only by
its owner worker (``Executor._recover`` hands ``begin_recording`` the
owned subset) and — via the delivery-boundary close protocol — never
covers input that was not recorded. When copies conflict (legacy layouts
that recorded every source everywhere, or replicas left by a previous
rescale that a worker never overwrote with a commit), the LARGEST offset
under a structural numeric-aware order wins: offsets advance
monotonically and only on the owner, so the max copy IS the owner's and
exactly covers the recorded input — a smaller stale copy would
re-deliver rows already incorporated into the snapshot/tail.

Copy of ``pathway_tpu/rescale/resharder.py``. Left out: the ``rescale``
chaos site, the ``pathway_rescale_*`` metrics that read :func:`stats`, and
the graph's fingerprint manifest, which the port's manager does not write
(so the dry run's rows carry no ``fingerprint``/``name`` identities and no
manifest is carried to the new layout). Every blob is read through the
port's unpickler: a store that the JAX package wrote raises
``PersistenceFormatError``. Routing is ``parallel/exchange.py::shard_rows``,
the live Exchange's own function of the key.
"""

from __future__ import annotations

import contextlib
import json
import pickle
import sys
import time as _time
from typing import Any, Callable

import numpy as np

from ..persistence import layout as _layout
from ..persistence.backends import (
    CountingBackend,
    PersistenceBackend,
    PrefixBackend,
    open_backend,
)
from ..persistence.snapshots import (
    MetadataAccessor,
    OperatorSnapshots,
    SnapshotReader,
    _delta_parts,
)

__all__ = ["rescale", "stats", "RescaleError", "NoClusterMarker"]


class RescaleError(RuntimeError):
    pass


class NoClusterMarker(RescaleError):
    """The store has no cluster marker: nothing was ever persisted, so
    there is nothing to rescale. Consumers that can proceed without
    state (the autoscale controller: the next generation simply boots at
    the target count and writes the marker) catch THIS, not a message
    substring."""


#: process-local counters: rescales run and their seconds, and the last report
_STATS: dict[str, Any] = {"total": 0, "duration_s": 0.0, "last": None}


def stats() -> dict[str, Any]:
    return dict(_STATS)


def _default_log(msg: str) -> None:
    print(f"[rescale] {msg}", file=sys.stderr)


def rescale(
    backend: Any, to_workers: int, *,
    log: Callable[[str], Any] | None = None, dry_run: bool = False,
) -> dict:
    """Repartition the persisted state in ``backend`` to ``to_workers``
    workers. ``backend`` is a ``PersistenceBackend`` instance or a
    ``pw.persistence.Backend`` descriptor. Returns a report dict.

    ``dry_run`` stops after the plan phase: the report carries the
    per-operator split/merge plan (rank, class, reshard mode, source
    chunk counts) and nothing — not even staging keys — is written."""
    log = log or _default_log
    t0 = _time.monotonic()
    close_after = False
    if isinstance(backend, PersistenceBackend):
        root = backend
    else:
        root = open_backend(backend)
        close_after = True
    try:
        report = _rescale_root(root, int(to_workers), log, dry_run=dry_run)
    finally:
        if close_after:
            root.close()
    dt = _time.monotonic() - t0
    report["duration_s"] = round(dt, 6)
    if not report.get("noop") and not dry_run:
        _STATS["total"] += 1
        _STATS["duration_s"] += dt
        _STATS["last"] = report
    return report


@contextlib.contextmanager
def _phase(report: dict, name: str, **args: Any):
    """One phase of the run: a ``rescale.<name>`` span on the active tracer,
    and its seconds added to ``report["phase_s"][name]``."""
    from ..internals.tracing import get_tracer

    tracer = get_tracer()
    t0 = _time.perf_counter()
    cm = (
        tracer.span(f"rescale.{name}", **args)
        if tracer is not None else contextlib.nullcontext()
    )
    try:
        with cm:
            yield
    finally:
        phases = report.setdefault("phase_s", {})
        phases[name] = phases.get(name, 0.0) + _time.perf_counter() - t0


def _worker_view(root: PersistenceBackend, ns: str) -> PersistenceBackend:
    return PrefixBackend(root, ns) if ns else root


def _node_class(name: str):
    """Resolve a snapshot descriptor's operator class name against every
    loaded ``Node`` subclass (engine operators, the iterate and
    external-index composites, the stateful object scanner)."""
    from ..engine import external_index as _ei  # noqa: F401
    from ..engine import iterate as _it  # noqa: F401
    from ..engine import operators as _ops  # noqa: F401
    from ..engine.executor import Node
    from ..io import _object_scanner as _scan  # noqa: F401

    stack = [Node]
    while stack:
        c = stack.pop()
        if c.__name__ == name:
            return c
        stack.extend(c.__subclasses__())
    raise RescaleError(
        f"persisted snapshot names stateful operator class {name!r}, which "
        "this build does not define — cannot reshard its state"
    )


def _offset_sort_key(off: Any):
    """Deterministic structural total order over offset states, with
    NUMBERS compared numerically — a lexicographic JSON comparison would
    rank {"rows": 1000} below {"rows": 999}. Larger key = later resume
    position."""
    if isinstance(off, bool):
        return ("b", off)
    if isinstance(off, (int, float)):
        return ("n", off)
    if isinstance(off, str):
        return ("s", off)
    if isinstance(off, (list, tuple)):
        return ("l", tuple(_offset_sort_key(v) for v in off))
    if isinstance(off, dict):
        return (
            "d",
            tuple(
                (k, _offset_sort_key(v)) for k, v in sorted(off.items())
            ),
        )
    return ("x", repr(off))


def _merge_offsets(metas: list[dict], log: Callable[[str], Any]) -> dict:
    merged: dict = {}
    conflicts: set[str] = set()
    for m in metas:
        for pid, off in (m.get("offsets") or {}).items():
            if off is None:
                continue
            if pid not in merged:
                merged[pid] = off
            elif merged[pid] != off:
                conflicts.add(pid)
                if _offset_sort_key(off) > _offset_sort_key(merged[pid]):
                    merged[pid] = off
    if conflicts:
        log(
            f"offset conflict for source(s) {sorted(conflicts)}: kept the "
            "LARGEST offset — a source's offset advances monotonically and "
            "only on its owner worker, so the max copy is the owner's, "
            "which exactly covers the recorded input (a smaller stale copy "
            "would re-deliver rows already in the snapshot/tail)"
        )
    return merged


def _pick_snapshot_time(metas: list[dict]) -> int:
    snap_sets = [
        {int(e["time"]) for e in (m.get("op_snapshots") or [])} for m in metas
    ]
    if all(not s for s in snap_sets):
        return -1
    common = set.intersection(*snap_sets)
    if common:
        return max(common)
    # no common snapshot (a crash mid-commit-wave with retention 1):
    # full-tail replay is sound only while no chunk was ever truncated
    if any(int(m.get("first_chunk", 0)) > 0 for m in metas):
        raise RescaleError(
            "no operator-snapshot time is common to every worker and the "
            "input history was already truncated — boot once with the "
            "original worker count (recovery will re-establish a common "
            "snapshot), then rescale"
        )
    return -1


def _op_chunk_bytes(view: PersistenceBackend, rank: int, desc: dict) -> int:
    """Size of one operator's persisted snapshot (stat-only where the
    backend can): resident AND spilled state — the spill tier
    materializes into snapshots, so this is the full per-operator state
    footprint the target workers must absorb."""
    from ..persistence.snapshots import OperatorSnapshots

    total = 0
    at = int(desc.get("at", desc.get("time", 0)))
    for c in range(int(desc["chunks"])):
        try:
            total += view.size_of(OperatorSnapshots._key(rank, at, c))
        except (OSError, KeyError):
            pass  # chunk pruned mid-report; keep the estimate partial
    return total


def _dry_run_report(
    report: dict, metas: list[dict], snap_time: int,
    n_from: int, to_workers: int, views: list[PersistenceBackend],
) -> dict:
    """Fill the plan-only report: per-operator split/merge actions by
    reshard mode, per-operator persisted state bytes (so an operator can
    size the target worker count before committing), plus the input-tail
    chunks each worker would replay.

    Refuses exactly what the real run refuses (per-worker operator-count
    mismatch): a dry run that prints a confident plan for a store the
    real rescale would reject defeats its preview purpose."""
    ops_plan: list[dict] = []
    if snap_time >= 0:
        entries = [
            next(
                e["ops"] for e in (m.get("op_snapshots") or [])
                if int(e["time"]) == snap_time
            )
            for m in metas
        ]
        rank_counts = {len(e) for e in entries}
        if len(rank_counts) > 1:
            raise RescaleError(
                f"workers disagree on the stateful-operator count at "
                f"snapshot time {snap_time}: {sorted(rank_counts)} — the "
                "dataflow changed between workers?"
            )
        n_ranks = max(len(e) for e in entries)
        for rank in range(n_ranks):
            descs = [e.get(str(rank)) or e.get(rank) for e in entries]
            present = [d for d in descs if d is not None]
            cls_name = present[0]["cls"] if present else "?"
            try:
                mode = getattr(_node_class(cls_name), "RESHARD", "keyed")
            except RescaleError:
                mode = "unresolved"
            action = {
                "keyed": (
                    f"split {n_from} piece(s) by key shard, merge into "
                    f"{to_workers} worker(s)"
                ),
                "pinned": "keep worker-0 piece (single-owner composite)",
                "replicate": (
                    f"field-wise union replicated to all {to_workers} "
                    "worker(s)"
                ),
            }.get(mode, f"cannot plan (mode {mode})")
            bytes_per_source = [
                _op_chunk_bytes(views[i], rank, d) if d is not None else None
                for i, d in enumerate(descs)
            ]
            ops_plan.append({
                "rank": rank,
                "cls": cls_name,
                "mode": mode,
                "action": action,
                "chunks_per_source": [
                    int(d["chunks"]) if d is not None else None
                    for d in descs
                ],
                "state_bytes_per_source": bytes_per_source,
                "state_bytes": sum(b or 0 for b in bytes_per_source),
            })
    report["ranks"] = len(ops_plan)
    report["operators"] = ops_plan
    report["state_bytes_total"] = sum(o["state_bytes"] for o in ops_plan)
    report["tail_chunks_per_source"] = [
        max(0, int(m.get("n_chunks", 0)) - int(m.get("first_chunk", 0)))
        for m in metas
    ]
    report["dry_run"] = True
    return report


def _rescale_root(
    root: PersistenceBackend, to_workers: int, log: Callable[[str], Any],
    dry_run: bool = False,
) -> dict:
    # the canonical routing hash (identical to the live exchange's)
    from ..parallel.exchange import shard_rows
    from ..persistence.snapshots import read_op_state

    if to_workers < 1:
        raise RescaleError(f"cannot rescale to {to_workers} workers")
    marker = _layout.read_marker(root)
    if marker is None:
        raise NoClusterMarker(
            f"no cluster marker at {root.describe()}: nothing to rescale"
        )
    n_from, epoch = marker
    report: dict[str, Any] = {
        "from": n_from, "to": to_workers, "snapshot_time": None,
        "ranks": 0, "tail_entries": 0, "epoch": epoch,
    }
    if n_from == to_workers:
        report["noop"] = True
        return report

    metered = CountingBackend(root)
    root = metered
    with _phase(report, "plan", from_workers=n_from, to_workers=to_workers):
        views: list[PersistenceBackend] = []
        metas: list[dict] = []
        missing: list[int] = []
        for i in range(n_from):
            ns = _layout.worker_namespace(epoch, n_from, i)
            view = _worker_view(root, ns)
            views.append(view)
            cur = MetadataAccessor(view).current
            if cur is None:
                missing.append(i)
            metas.append(cur or {})
        if len(missing) == n_from:
            # marker without any committed state: adopt the new count
            # (a dry run must not write even this)
            if not dry_run:
                _layout.write_marker(root, to_workers, epoch)
            report["noop"] = True
            return report
        if missing:
            raise RescaleError(
                f"worker(s) {missing} have no committed metadata while "
                "others do — the store is torn mid-first-commit; boot with "
                f"the original count ({n_from}) once, then rescale"
            )
        snap_time = _pick_snapshot_time(metas)
        report["snapshot_time"] = snap_time
    if dry_run:
        # plan only: name what the real run WOULD do per operator, write
        # nothing (no staging keys, no marker)
        return _dry_run_report(
            report, metas, snap_time, n_from, to_workers, views
        )
    stage_t0 = _time.perf_counter()

    # stale staging from a previously crashed attempt is garbage — clear it
    for key in root.list_keys():
        if key.startswith(_layout.STAGING_PREFIX):
            root.remove_key(key)

    new_epoch = epoch + 1
    staged = [
        _worker_view(
            root,
            _layout.STAGING_PREFIX
            + _layout.worker_namespace(new_epoch, to_workers, j),
        )
        for j in range(to_workers)
    ]

    def mask_for(j: int):
        def mask(keys: np.ndarray) -> np.ndarray:
            return shard_rows(np.asarray(keys, dtype=np.uint64), to_workers) == j

        return mask

    ops_per_dest: list[dict] = [{} for _ in range(to_workers)]
    if snap_time >= 0:
        entries = []
        for i, m in enumerate(metas):
            entry = next(
                (
                    e for e in m["op_snapshots"]
                    if int(e["time"]) == snap_time
                ),
                None,
            )
            assert entry is not None  # snap_time came from the intersection
            entries.append(entry["ops"])
        n_ranks = {len(e) for e in entries}
        if len(n_ranks) != 1:
            raise RescaleError(
                f"workers disagree on the stateful-operator count at "
                f"snapshot time {snap_time}: {sorted(n_ranks)} — the "
                "dataflow changed between workers?"
            )
        report["ranks"] = n_ranks = n_ranks.pop()
        with _phase(report, "operators", ranks=n_ranks, at=snap_time):
            for rank in range(n_ranks):
                descs = [
                    e.get(str(rank)) or e.get(rank) for e in entries
                ]
                if any(d is None for d in descs):
                    raise RescaleError(
                        f"operator snapshot is missing rank {rank} on some "
                        "worker"
                    )
                cls_names = {d["cls"] for d in descs}
                if len(cls_names) != 1:
                    raise RescaleError(
                        f"rank {rank} names different operator classes "
                        f"across workers: {sorted(cls_names)}"
                    )
                cls = _node_class(descs[0]["cls"])
                pieces = [
                    read_op_state(OperatorSnapshots(view), rank, d, cls)
                    for view, d in zip(views, descs)
                ]
                for j in range(to_workers):
                    mask = mask_for(j)
                    merged = cls.merge_states(
                        [cls.split_state(p, mask) for p in pieces]
                    )
                    n_chunks = OperatorSnapshots(staged[j]).write(
                        rank, snap_time, merged
                    )
                    ops_per_dest[j][str(rank)] = {
                        "cls": descs[0]["cls"],
                        "at": snap_time,
                        "chunks": n_chunks,
                    }

    # live input tail: rows recorded after the chosen snapshot, re-routed
    # to their destination shard by row key (the same hash the exchange
    # uses, so replay re-enters the dataflow exactly as live rows would)
    tails: list[list] = [[] for _ in range(to_workers)]
    with _phase(report, "chunks", after=snap_time):
        for view, m in zip(views, metas):
            reader = SnapshotReader(
                view, int(m.get("n_chunks", 0)), int(m.get("first_chunk", 0))
            )
            for t, pid, delta in reader.batches(after_time=snap_time):
                shards = shard_rows(delta.keys, to_workers)
                for j in range(to_workers):
                    ix = np.flatnonzero(shards == j)
                    if len(ix):
                        tails[j].append(
                            (t, pid, _delta_parts(delta.take(ix)))
                        )
        for j in range(to_workers):
            tails[j].sort(key=lambda e: e[0])  # stable: commit order kept
        report["tail_entries"] = sum(len(t) for t in tails)

    offsets = _merge_offsets(metas, log)
    last_time = max(int(m.get("last_time", -1)) for m in metas)
    for j in range(to_workers):
        if tails[j]:
            staged[j].put_value(
                "chunks/chunk-00000000",
                pickle.dumps(tails[j], protocol=pickle.HIGHEST_PROTOCOL),
            )
        meta = {
            "last_time": last_time,
            "n_chunks": 1 if tails[j] else 0,
            "first_chunk": 0,
            "chunk_spans": (
                {"0": max(int(e[0]) for e in tails[j])} if tails[j] else {}
            ),
            "offsets": offsets,
            "n_workers": to_workers,
            "op_snapshots": (
                [{"time": snap_time, "ops": ops_per_dest[j]}]
                if snap_time >= 0
                else []
            ),
        }
        staged[j].put_value("meta/meta-00000000", json.dumps(meta).encode())

    # carry the output plane's ack cursors (io/delivery.py delivery/<sink>
    # keys): sinks gather to worker 0 in every layout, so destination
    # worker 0 inherits each sink's cursor — dropping them would reset the
    # recovery floor to -1 and re-deliver the whole replayed tail after
    # every rescale (duplicate external output). If several source workers
    # carry a cursor for one sink (residue of an older layout), the
    # highest acked_time wins — cursors only ever advance, on the single
    # delivering worker, exactly like offsets.
    delivery_cursors: dict[str, tuple[int, bytes]] = {}
    for view in views:
        for key in view.list_keys():
            if not key.startswith("delivery/"):
                continue
            blob = view.get_value(key)
            try:
                acked = int(json.loads(blob).get("acked_time", -1))
            except (ValueError, TypeError):
                continue  # torn cursor: the other copies (if any) win
            cur = delivery_cursors.get(key)
            if cur is None or acked > cur[0]:
                delivery_cursors[key] = (acked, blob)
    for key, (_acked, blob) in sorted(delivery_cursors.items()):
        staged[0].put_value(key, blob)
    if delivery_cursors:
        report["delivery_cursors"] = len(delivery_cursors)

    report["phase_s"]["stage"] = _time.perf_counter() - stage_t0
    staged_keys = [
        k for k in root.list_keys() if k.startswith(_layout.STAGING_PREFIX)
    ]
    with _phase(report, "promote", staged_keys=len(staged_keys)):
        # leftovers of a crashed attempt under the target epoch would
        # otherwise survive next to the fresh copy as unreferenced orphans
        tgt = _layout.epoch_prefix(new_epoch)
        for key in root.list_keys():
            if tgt and key.startswith(tgt):
                root.remove_key(key)
        for key in staged_keys:
            root.put_value(
                key[len(_layout.STAGING_PREFIX):], root.get_value(key)
            )
        # THE commit point: one atomic marker rewrite flips the cluster to
        # the new layout; everything before this line left the old layout
        # untouched
        _layout.write_marker(root, to_workers, new_epoch)
    with _phase(report, "cleanup"):
        # sweep staging plus EVERY superseded layout — including orphans a
        # previously crashed cleanup left behind (epochs older than the one
        # just promoted)
        tgt = _layout.epoch_prefix(new_epoch)
        store_bytes = 0
        for key in root.list_keys():
            if key == _layout.MARKER_KEY or key.startswith(tgt):
                store_bytes += root.size_of(key)
                continue
            if key.startswith(
                (_layout.STAGING_PREFIX, _layout.UPGRADE_STAGING_PREFIX)
            ) or key.startswith(
                ("epoch-", "meta/", "chunks/", "ops/", "worker-", "delivery/",
                 "graph/")
            ):
                root.remove_key(key)
            else:
                store_bytes += root.size_of(key)
    report["epoch"] = new_epoch
    report["bytes_read"] = metered.get_bytes
    report["bytes_written"] = metered.put_bytes
    report["store_bytes"] = store_bytes
    log(
        f"rescaled {n_from} -> {to_workers} workers at {root.describe()} "
        f"(snapshot time {snap_time}, {report['ranks']} stateful operator"
        f"(s), {report['tail_entries']} tail entries, epoch {new_epoch})"
    )
    return report
