"""Worker communication backends for the sharded dataflow engine.

The reference exchanges records between timely workers through channel
allocators (``external/timely-dataflow/communication/src/allocator/``). Here:

- :class:`LocalComm` — N worker threads in one process; exchange is direct
  in-memory handoff behind a barrier (the ``thread`` allocator analog).
- :class:`~pathway_tpu_torch.parallel.meshcomm.MeshComm` — wraps LocalComm;
  the dense numeric columns of Exchange frames ride the bucketed all-to-all
  on the card (``parallel/exchange.py``, ``engine/mesh_exchange.py``); object
  columns take the host path.

Every worker sweeps the same node order for the same tick sequence and every
exchange is a blocking all-to-all: when a tick's sweep finishes on all
workers, that logical time is complete everywhere.

Copy of ``pathway_tpu/parallel/comm.py`` (``Comm``, ``LocalComm``,
``WorkerContext``, ``single_worker_context``) without the async plane, the
serve plane and the chaos site.
"""

from __future__ import annotations

import threading
from typing import Any, Sequence

__all__ = ["Comm", "LocalComm", "WorkerContext", "single_worker_context"]


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
        instead of deadlocking (worker panic propagation)."""
        self._barrier.abort()

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

    def comm_stats(self) -> dict[str, float]:
        # slots outstanding = collectives some worker entered but not all
        # left — a sustained nonzero depth means a straggler worker
        return {"pending_collectives": float(len(self._slots))}


class WorkerContext:
    """Identity + comm handle handed to each worker's Executor."""

    def __init__(self, worker_id: int, n_workers: int, comm: Comm | None):
        self.worker_id = worker_id
        self.n_workers = n_workers
        self.comm = comm

    @property
    def is_sharded(self) -> bool:
        return self.n_workers > 1


def single_worker_context() -> WorkerContext:
    return WorkerContext(0, 1, None)
