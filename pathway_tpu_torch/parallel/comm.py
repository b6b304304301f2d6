"""Worker communication backends for the sharded dataflow engine.

The reference exchanges records between timely workers through channel
allocators (``external/timely-dataflow/communication/src/allocator/``). Here:

- :class:`LocalComm` — N worker threads in one process; exchange is direct
  in-memory handoff behind a barrier (the ``thread`` allocator analog).
- :class:`~pathway_tpu_torch.parallel.cluster.ClusterComm` — full-mesh TCP
  between processes, columnar frames (the ``zero_copy`` analog).
- :class:`~pathway_tpu_torch.parallel.meshcomm.MeshComm` — wraps LocalComm;
  the dense numeric columns of Exchange frames ride the bucketed all-to-all
  on the card (``parallel/exchange.py``, ``engine/mesh_exchange.py``); object
  columns take the host path. Across processes,
  :class:`~pathway_tpu_torch.parallel.meshcomm.MultiHostMeshComm` wraps
  ClusterComm the same way.

Two progress protocols share these backends:

- **Bulk-synchronous lock-step** (``PATHWAY_ASYNC_EXEC=0``): every worker
  sweeps the same node order for the same tick sequence, and every
  exchange is a blocking all-to-all — when a tick's sweep finishes on
  all workers, that logical time is complete everywhere.
- **Frontier-driven asynchronous execution** (the default for sharded
  streaming over ``LocalComm`` and ``ClusterComm``): exchanges become fire-and-forget *posts*
  into per-worker inboxes (``async_post_exchange``/``async_drain``),
  workers advance on data availability, and consistency comes from
  frontier broadcasts riding the same wire (``async_broadcast``). The
  blocking collectives above remain in use for recovery replay, the
  END_TIME flush sweep, and ``PATHWAY_ASYNC_EXEC=0``.

Copy of ``pathway_tpu/parallel/comm.py`` (``Comm`` with its async API,
``LocalComm`` with its async plane, ``WorkerContext`` with
``async_plane``, ``single_worker_context``, ``async_queue_bound``,
``serve_queue_bound``) without ``LocalComm``'s serve plane (it waits with
sharded serving) and the chaos site.
"""

from __future__ import annotations

import collections
import threading
from typing import Any, Sequence

__all__ = ["Comm", "LocalComm", "WorkerContext", "single_worker_context"]

#: default bound of each worker's async DATA inbox, in posted batches;
#: the knob is PATHWAY_ASYNC_QUEUE_BATCHES. Posts themselves NEVER block
#: (two workers mid-sweep posting into each other's full inboxes would
#: deadlock) — the bound is enforced by the executor pausing its source
#: polls while any destination sits at it (Comm.async_congested locally,
#: peer-status inbox depths otherwise), which keeps a fast worker from
#: buffering a slow peer's whole backlog in memory
ASYNC_QUEUE_BATCHES = 256


def async_queue_bound() -> int:
    from ..internals.config import _env_int

    return max(1, _env_int("PATHWAY_ASYNC_QUEUE_BATCHES", ASYNC_QUEUE_BATCHES))


def serve_queue_bound() -> int:
    from ..internals.config import _env_int

    return max(1, _env_int("PATHWAY_SERVE_QUEUE_BOUND", 256))


class Comm:
    """Blocking collectives among ``n_workers`` equal participants."""

    n_workers: int

    def exchange(self, channel: int, tick: int, worker_id: int,
                 buckets: Sequence[Any]) -> list[Any]:
        """All-to-all: ``buckets[w]`` is this worker's payload destined for
        worker ``w`` (None = nothing). Returns the payloads every worker
        destined for *this* worker, in sender order. Blocks until all
        workers contributed to (channel, tick)."""
        raise NotImplementedError

    def allgather(self, tag: Any, worker_id: int, obj: Any) -> list[Any]:
        """Every worker contributes ``obj``; all receive the full list."""
        raise NotImplementedError

    def barrier(self, worker_id: int) -> None:
        raise NotImplementedError

    def abort(self) -> None:
        """Unblock peers waiting in a collective after a local failure."""

    def close(self) -> None:
        pass

    def comm_stats(self) -> dict[str, float]:
        """Backpressure/throughput gauges. Best-effort reads of live
        structures — no locks the data plane would contend on."""
        return {}

    # -- asynchronous (frontier-driven) plane ---------------------------
    #
    # Events are plain tuples:
    #   ("x", channel, time, src_worker, delta, ingest_ns, seq, enq_ns)
    #                                                           — data
    #   ("c", src_worker, payload)                              — control
    # ``enq_ns`` is the sender's wall-clock enqueue stamp (time_ns at
    # post): the receiver's drain measures the enqueue→drain inbox dwell
    # from it — the per-frame meta behind the commit-wave ``inbox_dwell``
    # phase (observability/critpath.py). ``seq`` is the sender's per-post
    # counter: the receiver dedupes duplicated frames by (src, seq), the
    # async analog of the BSP rendezvous slot where a duplicate
    # overwrote its own slot. Control broadcasts are never bounded (the
    # progress protocol must not deadlock behind the data it is trying to
    # drain); data backpressure is async_congested below.

    def supports_async(self) -> bool:
        return False

    def async_attach(self, worker_id: int, waker: Any) -> None:
        """Register ``worker_id``'s inbox + wake event (set on every
        delivery so the executor's idle park ends at data arrival)."""
        raise NotImplementedError

    def async_post_exchange(
        self, worker_id: int, channel: int, time: int,
        buckets: Sequence[Any], ingest_ns: "int | None" = None,
        seq: "int | None" = None, enq_ns: "int | None" = None,
    ) -> int:
        """Fire-and-forget exchange: ``buckets[w]`` goes to worker ``w``'s
        async inbox (None/own slot skipped). Never waits for peers.
        Returns the number of data events that WILL be delivered — the
        quiesce ledger (sent/received totals) counts exactly these."""
        raise NotImplementedError

    def async_broadcast(self, worker_id: int, payload: Any) -> None:
        """Deliver a control event to every OTHER worker's inbox."""
        raise NotImplementedError

    def async_drain(self, worker_id: int) -> list:
        """Everything delivered to ``worker_id`` since the last drain, in
        arrival order. Raises RuntimeError once the mesh is broken —
        the async path's failure-propagation hook."""
        raise NotImplementedError

    def async_congested(self, worker_id: int) -> bool:
        """True when some destination's data backlog sits at the
        PATHWAY_ASYNC_QUEUE_BATCHES bound. Posts themselves never block
        (two workers mid-sweep posting to each other's full inboxes
        would deadlock); instead the executor checks this BEFORE polling
        its sources — ingestion pauses, queued work drains, and the
        backlog stays bounded by what was already in flight."""
        return False



class LocalComm(Comm):
    """In-process comm for worker threads (timely ``thread`` allocator)."""

    def __init__(self, n_workers: int):
        self.n_workers = n_workers
        self._barrier = threading.Barrier(n_workers)
        self._lock = threading.Lock()
        self._slots: dict[Any, list] = {}
        # tracing site: None unless span tracing is on — worker threads
        # share one tracer, so exchange flows link sender/receiver tick
        # spans across tids with deterministic ids (no context to ship)
        from ..internals.tracing import get_tracer, mint_flow_tag

        self._tracer = get_tracer()
        self._flow_tag = mint_flow_tag()

    def _flow_id(self, channel: int, tick: int, src: int, dst: int) -> str:
        from ..internals.tracing import make_flow_id

        return make_flow_id(
            self._tracer, self._flow_tag,
            f"x{channel}", f"t{tick}", f"{src}>{dst}",
        )

    def _rendezvous(self, key: Any, worker_id: int, payload: Any) -> list[Any]:
        try:
            with self._lock:
                slot = self._slots.setdefault(key, [None] * self.n_workers)
                slot[worker_id] = payload
            self._barrier.wait()
            out = self._slots[key]
            # second barrier before cleanup so no worker reads a reused slot
            self._barrier.wait()
        except threading.BrokenBarrierError:
            raise RuntimeError(
                "a peer worker failed — aborting this worker's dataflow "
                "(reference cross-worker panic propagation, dataflow.rs:5674)"
            ) from None
        with self._lock:
            self._slots.pop(key, None)
        return out

    def abort(self) -> None:
        """Break all barriers so peers blocked in a collective unwind
        instead of deadlocking (worker panic propagation) — and poison
        the async plane so drains/posts raise instead of parking."""
        self._barrier.abort()
        st = getattr(self, "_async", None)
        if st is not None:
            with st["cond"]:
                if st["broken"] is None:
                    st["broken"] = (
                        "a peer worker failed — aborting this worker's "
                        "dataflow (cross-worker panic propagation)"
                    )
                st["cond"].notify_all()
            for waker in st["wakers"].values():
                waker.set()

    def exchange(self, channel, tick, worker_id, buckets):
        """In-process all-to-all. Frames pass **by reference** — the
        returned payloads are the very objects peers deposited (asserted
        below): the thread allocator's contract is zero serialization,
        zero copies."""
        buckets = list(buckets)
        tracer = self._tracer
        if tracer is not None:
            # both ends compute the same deterministic id, so each sender's
            # tick span links to every receiver's
            for dst, payload in enumerate(buckets):
                if dst != worker_id and payload is not None:
                    tracer.flow_start(
                        "comm.local",
                        self._flow_id(channel, tick, worker_id, dst),
                        channel=channel,
                        tick=tick,
                    )
        all_buckets = self._rendezvous(("x", channel, tick), worker_id, buckets)
        # no-serialization invariant: our own deposit must come back as
        # the identical list object (debug builds only)
        assert all_buckets[worker_id] is buckets, (
            "LocalComm must pass frames by reference, never serialize"
        )
        if tracer is not None:
            for src in range(self.n_workers):
                if src != worker_id and all_buckets[src][worker_id] is not None:
                    tracer.flow_end(
                        "comm.local",
                        self._flow_id(channel, tick, src, worker_id),
                    )
        return [
            all_buckets[src][worker_id]
            for src in range(self.n_workers)
            if all_buckets[src][worker_id] is not None
        ]

    def allgather(self, tag, worker_id, obj):
        return list(self._rendezvous(("g", tag), worker_id, obj))

    def barrier(self, worker_id: int):
        self._barrier.wait()

    # -- async plane (frontier-driven execution) ------------------------

    def supports_async(self) -> bool:
        return True

    def _async_state(self):
        # lazy (BSP runs never pay for the structures), created under the
        # slot lock so concurrent workers agree on ONE state dict
        st = getattr(self, "_async", None)
        if st is None:
            with self._lock:
                st = getattr(self, "_async", None)
                if st is None:
                    st = self._async = {
                        "cond": threading.Condition(),
                        "q": {
                            w: collections.deque()
                            for w in range(self.n_workers)
                        },
                        "data": {w: 0 for w in range(self.n_workers)},
                        "wakers": {},
                        "broken": None,
                        "bound": async_queue_bound(),
                    }
        return st

    def async_attach(self, worker_id: int, waker: Any) -> None:
        self._async_state()["wakers"][worker_id] = waker

    def _async_deliver(self, dest: int, event: tuple, is_data: bool) -> None:
        # never blocks: backpressure is the executor's async_congested
        # check before source polls (a blocking post here could deadlock
        # two workers mid-sweep posting into each other's full inboxes)
        st = self._async_state()
        with st["cond"]:
            if st["broken"] is not None:
                raise RuntimeError(st["broken"])
            st["q"][dest].append(event)
            if is_data:
                st["data"][dest] += 1
            st["cond"].notify_all()
        waker = st["wakers"].get(dest)
        if waker is not None:
            waker.set()

    def async_congested(self, worker_id: int) -> bool:
        st = self._async_state()
        return any(
            n >= st["bound"] for w, n in st["data"].items() if w != worker_id
        )

    def async_post_exchange(self, worker_id, channel, time, buckets,
                            ingest_ns=None, seq=None, enq_ns=None):
        delivered = 0
        for dest, payload in enumerate(buckets):
            if payload is None or dest == worker_id:
                continue
            self._async_deliver(
                dest,
                ("x", channel, time, worker_id, payload, ingest_ns, seq,
                 enq_ns),
                is_data=True,
            )
            delivered += 1
        return delivered

    def async_broadcast(self, worker_id, payload):
        for dest in range(self.n_workers):
            if dest != worker_id:
                self._async_deliver(
                    dest, ("c", worker_id, payload), is_data=False
                )

    def async_drain(self, worker_id: int) -> list:
        st = self._async_state()
        with st["cond"]:
            if st["broken"] is not None:
                raise RuntimeError(st["broken"])
            q = st["q"][worker_id]
            out = list(q)
            q.clear()
            st["data"][worker_id] = 0
            st["cond"].notify_all()
        return out

    def comm_stats(self) -> dict[str, float]:
        # slots outstanding = collectives some worker entered but not all
        # left — a sustained nonzero depth means a straggler worker
        out = {"pending_collectives": float(len(self._slots))}
        st = getattr(self, "_async", None)
        if st is not None:
            out["async_inbox_depth"] = float(
                sum(len(q) for q in st["q"].values())
            )
            out["async_inbox_capacity"] = float(
                st["bound"] * self.n_workers
            )
        return out


class WorkerContext:
    """Identity + comm handle handed to each worker's Executor."""

    def __init__(self, worker_id: int, n_workers: int, comm: Comm | None):
        self.worker_id = worker_id
        self.n_workers = n_workers
        self.comm = comm
        #: set by the executor while the frontier-driven streaming loop is
        #: live (parallel/asyncplane.AsyncPlane); None = blocking BSP
        #: collectives (batch mode, recovery replay, END_TIME flush,
        #: PATHWAY_ASYNC_EXEC=0). Exchange nodes consult this per call.
        self.async_plane: Any = None

    @property
    def is_sharded(self) -> bool:
        return self.n_workers > 1


def single_worker_context() -> WorkerContext:
    return WorkerContext(0, 1, None)
