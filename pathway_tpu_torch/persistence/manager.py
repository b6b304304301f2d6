"""PersistenceManager — the engine side of checkpoint/recovery.

Re-design of the reference's per-worker persistent storage tracker
(``src/persistence/tracker.rs:47``) + the connector replay protocol
(``src/connectors/mod.rs:108-152`` PersistenceMode / SnapshotAccess) + the
operator snapshot machinery (``src/persistence/operator_snapshot.rs``):

1. During a run, every committed source batch is recorded to the input
   snapshot (``record``); on the snapshot interval the chunk is flushed,
   every *dirty* stateful operator's state is written as a chunked blob,
   and metadata (last finalized time + per-source offsets + the operator
   snapshot catalog) is committed. Input chunks wholly covered by the
   oldest retained operator snapshot are deleted — restart cost stays
   O(operator state) + O(input tail), never O(history).
2. On restart, the executor restores operator state from the newest
   snapshot available on every worker (two versions are retained so a
   crash mid-commit-wave in a sharded run still leaves a common one),
   replays only the recorded input tail after it, seeks each source past
   its persisted offset, and resumes recording.

Sharded runs give each worker its own ``worker-{id}/`` namespace in the
shared backend (``PrefixBackend``); a root-level ``cluster`` marker pins
the worker count and layout epoch (see ``layout.py``). A worker-count
mismatch against real state is refused, unless ``PATHWAY_ELASTIC=1``: then
worker 0 reshards the store in process (``rescale/resharder.py``) and its
peers wait up to ``PATHWAY_RESCALE_WAIT_S`` for the new marker.

Copy of ``pathway_tpu/persistence/manager.py``, with the command line's
record and replay modes (``replay_mode``, ``continue_after_replay``,
``record_replay``). Left out: the chaos wrap of the backend and the graph's
fingerprint manifest (advisory metadata for the upgrade planner).
"""

from __future__ import annotations

import contextlib
import time as _time
from collections import deque
from typing import Any, Iterator

from ..engine.delta import Delta
from . import layout as _layout
from .backends import CountingBackend, PersistenceBackend, PrefixBackend, open_backend
from .snapshots import (
    MetadataAccessor,
    OperatorSnapshots,
    SnapshotReader,
    SnapshotWriter,
)

__all__ = ["PersistenceManager", "KEEP_OP_VERSIONS"]

#: operator snapshot versions retained (reference keeps enough history for
#: all workers to agree on a complete snapshot, worker-architecture doc)
KEEP_OP_VERSIONS = 2

#: commits kept in ``PersistenceManager.commit_log``
COMMIT_LOG_LEN = 256

class PersistenceManager:
    def __init__(self, config: Any, worker_id: int = 0, n_workers: int = 1):
        self.config = config
        self.worker_id = worker_id
        self.n_workers = n_workers
        root: PersistenceBackend = open_backend(config.backend)
        self._root = root
        self.epoch = self._resolve_layout(root, n_workers, worker_id)
        ns = _layout.worker_namespace(self.epoch, n_workers, worker_id)
        self.backend: CountingBackend = CountingBackend(
            PrefixBackend(root, ns) if ns else root
        )
        self.snapshot_interval_s = (config.snapshot_interval_ms or 0) / 1000.0
        self._meta = MetadataAccessor(self.backend)
        meta = self._meta.current or {}
        self.last_time: int = int(meta.get("last_time", -1))
        self.offsets: dict[str, Any] = dict(meta.get("offsets", {}))
        n_chunks = int(meta.get("n_chunks", 0))
        first_chunk = int(meta.get("first_chunk", 0))
        #: live input chunk seq -> max time recorded in it
        self.chunk_spans: dict[int, int] = {
            int(k): int(v) for k, v in meta.get("chunk_spans", {}).items()
        }
        #: snapshot catalog, ascending by time; each entry:
        #: {"time": T, "ops": {rank: {"cls", "at", "chunks"}}}
        self.op_snapshots: list[dict] = list(meta.get("op_snapshots", []))
        self._reader = SnapshotReader(self.backend, n_chunks, first_chunk)
        self._writer = SnapshotWriter(self.backend, n_chunks)
        self._first_chunk = first_chunk
        self._ops = OperatorSnapshots(self.backend)
        self._recording = False
        self._sources: list[Any] = []  # RealtimeSources with persistent ids
        self._last_flush = _time.monotonic()
        self._dirty = False
        self._last_recorded_time = self.last_time
        #: newest tick whose topological sweep COMPLETED (on_time_end).
        #: May lag _last_recorded_time: record() runs at tick start, so a
        #: worker dying mid-sweep holds rows recorded at a tick that never
        #: emitted downstream — the close() flush must not stamp that tick
        #: into last_time, or skip_until would suppress the replayed rows'
        #: output on recovery (a lost, never-delivered callback)
        self._last_completed_time = self.last_time
        # delivery-boundary snapshot backing the close() flush (see
        # note_delivery_boundary)
        self._safe_offsets: dict[str, Any] = dict(self.offsets)
        self._safe_recorded = 0
        self._safe_time = self.last_time
        #: single-worker mode commits on its own wall-clock interval;
        #: sharded mode commits only when the workers collectively agree
        self.auto_commit = True
        self._stateful: list[Any] = []  # rank -> node
        self._dirty_ranks: set[int] = set()
        #: the output plane (io/delivery.DeliveryManager) when this
        #: worker owns delivery-managed sinks: commits barrier on the
        #: previous release, then release acked output up to the
        #: committed frontier (exactly-once sinks — see delivery.py)
        self.delivery: Any = None
        self._closing = False
        #: per-phase split of the last commit() call, ns — barrier
        #: (waiting on the previous release's sink acks), snapshot
        #: (flush + operator snapshots + metadata), release (delivery
        #: release + drain).
        self.last_commit_phase_ns: dict[str, int] | None = None
        #: the last commits' time, phase split (ns), bytes written, and their
        #: parts (the input flush, each operator snapshot written) with their ns
        #: and bytes; bounded, as a run may commit for days
        self.commit_log: deque[dict] = deque(maxlen=COMMIT_LOG_LEN)
        self._parts: list[dict] = []
        #: what this run's recovery did: the restored snapshot's time, the
        #: seconds restore_operators took, and the replayed tail's size
        self.recovery_stats: dict[str, Any] = {}
        #: CLI replay mode (replay --mode): None = normal
        #: persistence (record + snapshot + resume); "batch" coalesces the
        #: whole recorded history into ONE tick, "speedrun" preserves the
        #: recorded tick boundaries. In either replay mode operator
        #: snapshots are ignored (full input replay), nothing re-records,
        #: and sources are not seeked (reference cli replay semantics).
        self.replay_mode: str | None = None
        self.continue_after_replay = True
        #: recording FOR REPLAY (spawn --record): keep the
        #: full input history — no operator snapshots, no chunk
        #: truncation (crash-recovery persistence truncates input once a
        #: snapshot covers it, which would erase the replay tape)
        self.record_replay = False

    @staticmethod
    def _resolve_layout(
        root: PersistenceBackend, n_workers: int, worker_id: int
    ) -> int:
        """Reconcile this run's worker count with the persisted layout
        marker; returns the layout epoch to mount. A mismatch against real
        state either triggers an in-process rescale (elastic mode, worker
        0), waits for worker 0's rescale to promote (elastic mode, other
        workers), or refuses."""
        marker = _layout.read_marker(root)
        if marker is None:
            _layout.write_marker(root, n_workers, 0)
            return 0
        cur_n, epoch = marker
        if cur_n == n_workers:
            return epoch
        # a marker with ZERO committed metadata versions behind it is the
        # residue of a first boot that crashed between writing the marker
        # and the first commit — there is no state to reshard, so adopt
        # the new layout instead of refusing to ever start again under a
        # different worker count
        if not _layout.has_layout_meta(root, epoch, cur_n):
            _layout.write_marker(root, n_workers, epoch)
            return epoch
        from ..internals.config import _env_bool, _env_float

        if _env_bool("PATHWAY_ELASTIC"):
            if worker_id == 0:
                # elastic boot: worker 0 repartitions the persisted state
                # to this run's worker count before mounting it
                from ..rescale import rescale as _rescale

                _rescale(root, n_workers)
                marker = _layout.read_marker(root)
                assert marker is not None and marker[0] == n_workers
                return marker[1]
            # peers wait for worker 0's rescale to promote the new marker
            deadline = _time.monotonic() + _env_float(
                "PATHWAY_RESCALE_WAIT_S", 120.0
            )
            while _time.monotonic() < deadline:
                marker = _layout.read_marker(root)
                if marker is not None and marker[0] == n_workers:
                    return marker[1]
                _time.sleep(0.1)
            raise RuntimeError(
                f"elastic rescale to {n_workers} workers did not complete "
                f"within PATHWAY_RESCALE_WAIT_S (worker {worker_id} waited "
                "for worker 0's resharder to promote the new layout)"
            )
        where = root.describe()
        raise RuntimeError(
            f"persisted state at {where} was written by "
            f"{cur_n} worker(s) but this run has "
            f"{n_workers}: operator state is hash-sharded by worker "
            "count and cannot be resharded on recovery — restart "
            "with the original worker count, run "
            f"`pathway_tpu_torch.rescale.rescale(backend, {n_workers})` "
            "(or boot with PATHWAY_ELASTIC=1), or clear the persistence "
            "backend"
        )

    # -- recovery side ----------------------------------------------------

    def attach_nodes(self, nodes: list[Any]) -> None:
        """Register the executor's nodes; stateful ones get stable ranks by
        deterministic build order (same program -> same ranks on restart)."""
        ordered = sorted(nodes, key=lambda n: n.node_id)
        self._stateful = [n for n in ordered if n.has_state()]
        self._rank_of = {id(n): r for r, n in enumerate(self._stateful)}

    def mark_dirty(self, node: Any) -> None:
        rank = self._rank_of.get(id(node))
        if rank is not None:
            self._dirty_ranks.add(rank)

    def available_op_times(self) -> list[int]:
        return [int(e["time"]) for e in self.op_snapshots]

    def restore_operators(self, at_time: int) -> None:
        """Load the state of every operator registered via ``attach_nodes``
        from the snapshot taken at ``at_time`` (one of
        ``available_op_times()``)."""
        entry = next(
            (e for e in self.op_snapshots if int(e["time"]) == at_time), None
        )
        if entry is None:
            raise RuntimeError(f"no operator snapshot at time {at_time}")
        ops = entry["ops"]
        if len(ops) != len(self._stateful):
            raise RuntimeError(
                f"operator snapshot has {len(ops)} stateful operators but the "
                f"program builds {len(self._stateful)} — the dataflow changed "
                "since the snapshot was taken; clear the persistence backend"
            )
        t0 = _time.perf_counter()
        for rank, node in enumerate(self._stateful):
            desc = ops.get(str(rank)) or ops.get(rank)
            cls = type(node).__name__
            if desc is None or desc["cls"] != cls:
                raise RuntimeError(
                    f"operator snapshot mismatch at rank {rank}: snapshot has "
                    f"{desc and desc['cls']!r}, program builds {cls!r} — the "
                    "dataflow changed since the snapshot was taken"
                )
            from .snapshots import read_op_state

            node.restore_state(
                read_op_state(self._ops, rank, desc, type(node))
            )
        self.recovery_stats["restore_s"] = _time.perf_counter() - t0

    def replay_batches(
        self, after_time: int = -1
    ) -> Iterator[tuple[int, str, Delta]]:
        """Recorded input entries after ``after_time`` — a generator
        (memory stays O(chunk), never O(history))."""
        return self._reader.batches(after_time)

    def offset_for(self, pid: str) -> Any | None:
        return self.offsets.get(pid)

    # -- recording side ---------------------------------------------------

    def begin_recording(self, sources: list[Any]) -> None:
        """Replay done; start capturing live input. `sources` are the
        realtime source nodes whose offsets go into each metadata commit."""
        self._sources = [s for s in sources if s.persistent_id is not None]
        self._recording = True
        self.note_delivery_boundary()

    def note_delivery_boundary(self) -> None:
        """Every row the sources have handed out so far has been DELIVERED
        to the dataflow (its tick ran and recorded it). Snapshot per-source
        offsets + the writer position here: connector offsets advance when
        rows are drained from the producer queue, which can be several
        not-yet-ticked rounds ahead of what was recorded — a crash then
        makes the live offset cover input that exists nowhere. The close()
        flush commits exactly this snapshot's prefix, keeping offsets ==
        recorded input (persisting a live offset would silently SKIP the
        undelivered rows on resume; persisting an old offset with a longer
        tail would replay rows the resumed source re-emits — duplicates).
        Called by the streaming loops after each poll cycle's rounds all
        ticked, and by commit() itself (commits only happen at delivery
        boundaries)."""
        if not self._recording:
            return
        self._safe_offsets = {
            s.persistent_id: s.offset_state() for s in self._sources
        }
        self._safe_recorded = self._writer.buffered_count
        self._safe_time = self._last_completed_time

    def record(self, time: int, pid: str, delta: Delta) -> None:
        if not self._recording:
            return
        self._writer.record(time, pid, delta)
        self._dirty = True
        self._last_recorded_time = max(self._last_recorded_time, int(time))

    def should_commit(self) -> bool:
        if not (self._recording and self._dirty):
            return False
        if _time.monotonic() - self._last_flush >= self.snapshot_interval_s:
            return True
        # output pressure: delivery-managed sinks hold their batches until
        # the commit that makes the batches' input durable — when that
        # pending buffer passes its bound, commit EARLY so output releases
        # (growing it unboundedly would trade backpressure for OOM)
        return self.delivery is not None and self.delivery.want_early_commit()

    def on_time_end(self, time: int) -> None:
        self._last_completed_time = max(
            self._last_completed_time, int(time)
        )
        if self.auto_commit and self.should_commit():
            self.commit(time)

    def commit(
        self,
        time: int,
        *,
        with_operators: bool = True,
        offsets: dict[str, Any] | None = None,
    ) -> None:
        """Flush the pending input chunk, snapshot dirty operator state, and
        finalize metadata (the consistency point — reference `finalize`,
        tracker.rs). In sharded runs this is called collectively at one
        agreed tick on every worker.

        ``with_operators=False`` persists only the input tail + offsets —
        used by ``close()`` after abnormal exits, where operator state may
        be torn mid-tick and must NOT be snapshotted. ``offsets`` overrides
        the live source offsets (close() passes its delivery-boundary
        snapshot; normal commits run AT a boundary, where live is exact)."""
        if not self._recording:
            return
        t0 = _time.perf_counter_ns()
        put_before = self.backend.put_bytes
        barrier_ns = 0
        delivery = None if self._closing else self.delivery
        if delivery is not None:
            # the previous release must be fully acked before a NEW
            # snapshot commits: recovery restores the newest snapshot
            # at-or-below the ack floor, and retention keeps two versions
            # — a release lagging more than one commit would strand
            # unacked output below every restorable snapshot. A down sink
            # blocks here: that block IS the engine's backpressure.
            delivery.pre_commit_barrier()
            barrier_ns = _time.perf_counter_ns() - t0
        self._parts = []
        with self._timed_part("input"):
            written = self._writer.flush()
        if written is not None:
            seq, max_t = written
            self.chunk_spans[seq] = max_t
        self.last_time = max(self.last_time, int(time))
        self.offsets = (
            dict(offsets)
            if offsets is not None
            else {s.persistent_id: s.offset_state() for s in self._sources}
        )
        if self.record_replay:
            with_operators = False  # the input history IS the artifact
        if with_operators:
            self._snapshot_operators(self.last_time)
        covered = [] if self.record_replay else self._plan_chunk_truncation()
        self._meta.commit({
            "last_time": self.last_time,
            "n_chunks": self._writer.n_chunks,
            "first_chunk": self._first_chunk,
            "chunk_spans": {str(k): v for k, v in self.chunk_spans.items()},
            "offsets": self.offsets,
            "n_workers": self.n_workers,
            "op_snapshots": self.op_snapshots,
        })
        self._meta.prune(keep=2)  # superseded metadata versions
        # deletions run strictly AFTER the metadata commit that stops
        # referencing the deleted blobs: a crash in between leaves orphan
        # blobs (harmless), never a metadata version pointing at removed
        # chunks (unrecoverable)
        for seq in covered:
            self.backend.remove_key(f"chunks/chunk-{seq:08d}")
        self._prune_op_blobs()
        self._dirty = False
        self._last_flush = _time.monotonic()
        # a commit IS a delivery boundary: refresh the close-path snapshot
        # (buffer just flushed; the offsets just persisted are exact)
        self._safe_offsets = dict(self.offsets)
        self._safe_recorded = 0
        self._safe_time = self.last_time
        release_ns = 0
        if delivery is not None:
            # input through last_time is durable — release the sink
            # batches it produced and drain them now, so their acks (and
            # the commit-tick cursor heartbeat) land while this commit is
            # the newest: at any later crash, acked >= this commit's
            # predecessor, keeping a restorable snapshot under the floor
            t_rel = _time.perf_counter_ns()
            delivery.on_commit(self.last_time)
            release_ns = _time.perf_counter_ns() - t_rel
        end = _time.perf_counter_ns()
        self.last_commit_phase_ns = {
            "barrier": barrier_ns,
            "snapshot": max(0, end - t0 - barrier_ns - release_ns),
            "release": release_ns,
        }
        self.commit_log.append({
            "time": self.last_time, "ns": dict(self.last_commit_phase_ns),
            "bytes": self.backend.put_bytes - put_before,
            "operators": with_operators, "parts": self._parts,
        })

    def _snapshot_operators(self, time: int) -> None:
        if self.op_snapshots and int(self.op_snapshots[-1]["time"]) == time:
            # same-tick re-commit (e.g. final commit right after an interval
            # commit): the existing snapshot already covers this time
            return
        from ..engine.executor import Node

        prev_ops = self.op_snapshots[-1]["ops"] if self.op_snapshots else {}
        ops: dict[str, dict] = {}
        for rank, node in enumerate(self._stateful):
            prev = prev_ops.get(str(rank))
            if prev is not None and rank not in self._dirty_ranks:
                ops[str(rank)] = prev  # unchanged state: re-reference blob
                continue
            with self._timed_part(f"{rank}:{type(node).__name__}"):
                if (
                    type(node).snapshot_state_parts
                    is not Node.snapshot_state_parts
                ):
                    # operators with a parts protocol (GroupByReduce, Join)
                    # stream their snapshot part by part
                    n_chunks = self._ops.write_parts(
                        rank, time, node.snapshot_state_parts()
                    )
                    ops[str(rank)] = {
                        "cls": type(node).__name__, "at": time,
                        "chunks": n_chunks, "fmt": "parts",
                    }
                    continue
                n_chunks = self._ops.write(rank, time, node.snapshot_state())
                ops[str(rank)] = {
                    "cls": type(node).__name__, "at": time, "chunks": n_chunks,
                }
        self.op_snapshots.append({"time": time, "ops": ops})
        self._dirty_ranks.clear()

    @contextlib.contextmanager
    def _timed_part(self, what: str):
        """One part of the commit in progress (the input flush, an operator's
        snapshot): its ns and the bytes it put, into the commit's log entry."""
        t0, b0 = _time.perf_counter_ns(), self.backend.put_bytes
        try:
            yield
        finally:
            self._parts.append({
                "what": what, "ns": _time.perf_counter_ns() - t0,
                "bytes": self.backend.put_bytes - b0,
            })

    def _plan_chunk_truncation(self) -> list[int]:
        """Input chunks whose every entry predates the oldest retained
        operator snapshot are dead weight — no recovery path reads them.
        Updates the live-chunk bookkeeping and returns the seqs to delete
        (deletion itself happens after the metadata commit)."""
        keep_from = len(self.op_snapshots) - KEEP_OP_VERSIONS
        self._drop_versions = self.op_snapshots[:max(0, keep_from)]
        self.op_snapshots = self.op_snapshots[max(0, keep_from):]
        if not self.op_snapshots:
            return []
        if self.n_workers > 1 and len(self.op_snapshots) < KEEP_OP_VERSIONS:
            # sharded: a crash between two workers' commits in the same wave
            # leaves them one version apart; recovery then restores the
            # older common snapshot — or, if a worker has none yet, falls
            # back to full replay. Either way history below the newest
            # snapshot may still be needed, so truncation waits until a
            # full retention window exists.
            return []
        min_op_time = int(self.op_snapshots[0]["time"])
        if self.delivery is not None and self.delivery.has_sinks():
            # delivery sinks regenerate unacked output by REPLAYING input:
            # a chunk whose output is not yet acked must survive even when
            # an operator snapshot covers it (acute for stateless
            # pipelines, where the empty snapshot trivially "covers"
            # everything at the very first commit — before the first
            # post-commit drain has acked anything)
            floor = self.delivery.recovery_floor()
            if floor is not None:
                min_op_time = min(min_op_time, floor)
        covered = [
            seq for seq, max_t in self.chunk_spans.items() if max_t <= min_op_time
        ]
        for seq in covered:
            del self.chunk_spans[seq]
        live = [s for s in self.chunk_spans]
        self._first_chunk = min(live) if live else self._writer.n_chunks
        return covered

    def _prune_op_blobs(self) -> None:
        """After metadata no longer references dropped snapshot versions,
        delete their blobs (unless a retained version still re-references
        the same (rank, at) write)."""
        dropped = getattr(self, "_drop_versions", [])
        if not dropped:
            return
        referenced = {
            (r, int(d["at"]))
            for e in self.op_snapshots
            for r, d in e["ops"].items()
        }
        for e in dropped:
            for r, d in e["ops"].items():
                if (r, int(d["at"])) not in referenced:
                    self._ops.drop(int(r), int(d["at"]), int(d["chunks"]))
        self._drop_versions = []

    def close(self) -> None:
        """Flush any uncommitted tail (covers abnormal executor exits —
        a raising connector unwinds past _finish) and release the backend.
        Operator state is NOT snapshotted here: after an exception the
        executor may have died mid-tick, with some operators having applied
        the tick's deltas and others not — recovery instead restores the
        last complete snapshot and replays the flushed tail through it.

        The flush is pinned to the last DELIVERY BOUNDARY (see
        note_delivery_boundary): only input recorded up to that point is
        flushed, with the offsets snapshotted there — rows the sources
        handed out afterwards (recorded-at-a-died-tick, or drained into
        rounds whose tick never ran) are dropped from the tail and
        re-read live on resume. Offsets == recorded input, always:
        neither silent input loss (live offsets covering unrecorded rows)
        nor duplicates (stale offsets under a longer tail). The commit
        time is likewise the boundary's last COMPLETED tick, so replayed
        rows sit above skip_until and re-emit (at-least-once output,
        exactly-once state)."""
        self._closing = True  # abnormal path: no delivery barrier/release
        # (unacked output re-delivers on recovery, deduped by ack cursor)
        if self._dirty:
            self._writer.truncate(self._safe_recorded)
            self.commit(
                self._safe_time,
                with_operators=False,
                offsets=self._safe_offsets,
            )
        if self.delivery is not None:
            self.delivery.abort()
        self.backend.close()
