"""Per-worker hub of the frontier-driven execution mode.

One :class:`AsyncPlane` is owned by each worker's executor while the
asynchronous sharded streaming loop is live (``ctx.async_plane``). It
glues three things together:

- the **data plane**: Exchange nodes call :meth:`post` (fire-and-forget
  bucket delivery through ``Comm.async_post_exchange``) and
  :meth:`take` (arrivals queued for their channel — delivered eagerly
  on arrival, the timely model where *data* moves asynchronously and
  only *notifications* follow the frontier);
- the **progress protocol**: :meth:`drain` files incoming events,
  merges peer frontier broadcasts into the
  :class:`~pathway_tpu_torch.engine.frontier.FrontierTracker`, and keeps the
  latest per-peer status document (finished/stop flags, commit-wave
  state, quiesce votes);
- **observability**: arrival-queue latency is accumulated as the REAL
  ``exchange wait`` (time rows sat queued between arrival and
  delivery), replacing the BSP artifact where Exchange time measured
  blocked-in-collective peers.

The plane is deliberately thin — protocol *decisions* live in the
executor loop and the pure components (``engine/frontier.py``), so they
stay unit-testable without threads or sockets.

Copy of ``pathway_tpu/parallel/asyncplane.py``.
"""

from __future__ import annotations

import collections
import threading
import time as _time
from typing import Any

from ..engine.frontier import FrontierTracker

__all__ = ["AsyncPlane"]


def _min_opt(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return min(a, b)


class AsyncPlane:
    def __init__(self, comm: Any, worker_id: int, n_workers: int):
        self.comm = comm
        self.worker_id = worker_id
        self.n_workers = n_workers
        self.tracker = FrontierTracker(n_workers, worker_id)
        self.waker = threading.Event()
        comm.async_attach(worker_id, self.waker)
        #: channel -> deque[(time, delta, ingest_ns, recv_perf_ns,
        #: route_ns, dwell0_ns)] — route_ns is the sender-side
        #: ingest→post latency carried in the frame meta, dwell0_ns the
        #: enqueue→drain inbox dwell measured on arrival; take() adds the
        #: drain→delivery queue wait to complete the dwell
        self._arrivals: dict[int, collections.deque] = {}
        self._arrivals_pending = 0
        #: running min of queued arrivals' ingest stamps, maintained on
        #: append and invalidated only when the minimum itself departs —
        #: pending_ingest_ns() is asked before every sweep, and a full
        #: rescan of a held backlog would go quadratic over commit-wave
        #: settles
        self._ingest_min: int | None = None
        self._ingest_min_dirty = False
        #: hold boundary during a commit wave: arrivals with time > hold
        #: stay queued (they belong to the NEXT commit window and must
        #: not enter operator state before this wave's snapshot)
        self.hold_above: int | None = None
        #: latest status document per peer worker (merged by drain)
        self.peer_status: dict[int, dict] = {}
        #: phase -> [(src, vote payload)] — quiesce votes awaiting their
        #: consumer (see drain)
        self._votes: dict[str, list] = {}
        #: per-post sequence (rides data events; receivers dedup by it)
        self._post_seq = 0
        #: src worker -> highest data seq seen (duplicate-frame dedup —
        #: the async analog of the BSP rendezvous slot overwrite)
        self._seen_seq: dict[int, int] = {}
        from .comm import async_queue_bound

        self._queue_bound = async_queue_bound()
        #: quiesce counters: data events posted / delivered-to-operators
        self.sent_events = 0
        self.recv_events = 0
        #: activity marker consumed by quiesce voting (any post or take)
        self.activity = False
        #: ingest stamp of the CURRENT local sweep (set by the executor's
        #: _tick so Exchange posts forward the origin's stamp, keeping the
        #: ingest→emit histogram honest across workers)
        self.cur_ingest_ns: int | None = None
        # wait accounting: ns arrivals spent queued before delivery —
        # the genuine per-operator exchange wait of the async mode
        self.arrival_wait_ns = 0
        #: cumulative enqueue→drain→delivery dwell across ALL arrivals
        #: (commit waves read deltas of this for the inbox_dwell phase)
        self.dwell_total_ns = 0
        #: (ingest_ns, route_ns, dwell_ns) of the OLDEST arrival taken
        #: during the current sweep — the stamps behind the staged
        #: ingest→emit decomposition; _tick resets it per sweep
        self.sweep_oldest: "tuple[int, int, int] | None" = None
        self.last_broadcast = 0.0

    # -- data plane ------------------------------------------------------

    def post(self, channel: int, time: int, buckets: list) -> int:
        """Route ``buckets`` to peers (own slot is the caller's business).
        Returns the number of data events that will be delivered.

        The sent counter records what the comm layer says will actually
        arrive, so the quiesce ledger (global sent == received) balances;
        a duplicated frame is deduped receiver-side by ``seq``, so it
        stays 1."""
        n = sum(
            1 for i, b in enumerate(buckets)
            if b is not None and i != self.worker_id
        )
        if not n:
            return 0
        seq = self._post_seq
        self._post_seq += 1
        delivered = self.comm.async_post_exchange(
            self.worker_id, channel, time, buckets, self.cur_ingest_ns, seq,
            _time.time_ns(),
        )
        self.sent_events += delivered
        self.activity = True
        return delivered

    def take(self, channel: int) -> tuple[list, "int | None"]:
        """Arrivals released for delivery on ``channel`` (respecting the
        commit-wave hold) -> (deltas, oldest ingest stamp)."""
        q = self._arrivals.get(channel)
        if not q:
            return [], None
        out: list = []
        ingest: int | None = None
        hold = self.hold_above
        now = _time.perf_counter_ns()
        while q:
            t, delta, ing, recv_ns, route_ns, dwell0_ns = q[0]
            if hold is not None and t > hold:
                break  # FIFO per sender; later entries are >= t anyway
            q.popleft()
            out.append(delta)
            ingest = _min_opt(ingest, ing)
            if ing is not None and ing == self._ingest_min:
                self._ingest_min_dirty = True  # the minimum departed
            wait_ns = now - recv_ns
            self.arrival_wait_ns += wait_ns
            dwell_ns = dwell0_ns + wait_ns
            self.dwell_total_ns += dwell_ns
            if ing is not None and (
                self.sweep_oldest is None or ing < self.sweep_oldest[0]
            ):
                self.sweep_oldest = (ing, route_ns, dwell_ns)
            self.recv_events += 1
            self._arrivals_pending -= 1
        if out:
            self.activity = True
        return out, ingest

    def releasable(self) -> bool:
        hold = self.hold_above
        if hold is None:
            return self._arrivals_pending > 0
        return any(q and q[0][0] <= hold for q in self._arrivals.values())

    def pending_ingest_ns(self) -> "int | None":
        """Oldest ingest stamp among queued arrivals (sweep stamping).
        O(1) from the running min unless the minimum was consumed since
        the last query (then one rescan of what remains queued)."""
        if self._arrivals_pending == 0:
            self._ingest_min = None
            self._ingest_min_dirty = False
            return None
        if self._ingest_min_dirty:
            out: int | None = None
            for q in self._arrivals.values():
                for item in q:
                    out = _min_opt(out, item[2])
            self._ingest_min = out
            self._ingest_min_dirty = False
        return self._ingest_min

    # -- control plane ---------------------------------------------------

    def drain(self) -> bool:
        """Pull everything the comm delivered since the last drain; file
        data arrivals, merge statuses/frontiers. Raises when the mesh is
        broken (failure propagation). Returns True if anything arrived."""
        events = self.comm.async_drain(self.worker_id)
        if not events:
            return False
        now_ns = _time.perf_counter_ns()
        now_wall = _time.time_ns()
        now = _time.monotonic()
        for ev in events:
            if ev[0] == "x":
                _, channel, t, src, delta, ingest_ns, seq = ev[:7]
                enq_ns = ev[7] if len(ev) > 7 else None
                if seq is not None:
                    # FIFO per sender link: a seq at or below the highest
                    # seen is a duplicated frame — drop the copy
                    if seq <= self._seen_seq.get(src, -1):
                        continue
                    self._seen_seq[src] = seq
                # frame-meta stamps: sender-side ingest→post (route) and
                # post→drain inbox dwell, both wall-clock and clamped so
                # cross-process skew can only shrink them
                route_ns = dwell0_ns = 0
                if enq_ns is not None:
                    dwell0_ns = max(0, now_wall - enq_ns)
                    if ingest_ns is not None:
                        route_ns = max(0, enq_ns - ingest_ns)
                self._arrivals.setdefault(
                    channel, collections.deque()
                ).append(
                    (t, delta, ingest_ns, now_ns, route_ns, dwell0_ns)
                )
                self._arrivals_pending += 1
                if ingest_ns is not None and (
                    self._ingest_min is None or ingest_ns < self._ingest_min
                ):
                    self._ingest_min = ingest_ns
            else:
                _, src, payload = ev
                cur = self.peer_status.setdefault(src, {})
                cur.update(payload)
                f = payload.get("f")
                if f is not None:
                    self.tracker.observe(src, f, now=now)
                v = payload.get("vote")
                if v is not None:
                    # votes must not overwrite each other (a peer can cast
                    # two rounds between my drains) and must survive being
                    # delivered while a DIFFERENT phase is consuming — a
                    # per-phase log holds every vote until its consumer
                    # takes it (commit-wave settle vs termination)
                    self._votes.setdefault(v[0], []).append((src, tuple(v)))
        return True

    def take_votes(self, phase: str) -> list:
        """Unconsumed peer votes for ``phase`` (quiesce protocol)."""
        return self._votes.pop(phase, [])

    def broadcast_status(self, payload: dict, min_interval_s: float = 0.0,
                        ) -> bool:
        """Broadcast this worker's status document (frontier piggybacked
        under ``"f"``), throttled to ``min_interval_s``. Forced when the
        interval is 0."""
        now = _time.monotonic()
        if min_interval_s and now - self.last_broadcast < min_interval_s:
            return False
        payload = dict(payload)
        payload["f"] = self.tracker.local()
        # inbox depth rides every status: remote senders consult it in
        # congested() — the cross-process half of the async queue bound
        # (in-process depth is visible directly; a reader thread must
        # never block, so the remote bound is this advisory loop)
        payload["q"] = self._arrivals_pending
        self.comm.async_broadcast(self.worker_id, payload)
        # own status is merged locally so protocol code can treat
        # peer_status[worker_id] uniformly
        self.peer_status.setdefault(self.worker_id, {}).update(payload)
        self.last_broadcast = now
        return True

    def congested(self) -> bool:
        """Should this worker pause ingesting? True when any destination
        sits at the PATHWAY_ASYNC_QUEUE_BATCHES bound — same-process
        inboxes and outbound pipelines via the comm's direct view, remote
        workers via the inbox depth their status broadcasts carry
        (advisory: stale by at most a frontier-cadence interval, so the
        effective remote bound is the knob plus one broadcast window)."""
        if self.comm.async_congested(self.worker_id):
            return True
        return any(
            st.get("q", 0) >= self._queue_bound
            for w, st in self.peer_status.items()
            if w != self.worker_id
        )

    def take_activity(self) -> bool:
        a = self.activity
        self.activity = False
        return a

    def stats(self) -> dict[str, float]:
        return {
            "arrivals_pending": float(self._arrivals_pending),
            "sent_events": float(self.sent_events),
            "recv_events": float(self.recv_events),
            "arrival_wait_ms": self.arrival_wait_ns / 1e6,
            "dwell_total_ms": self.dwell_total_ns / 1e6,
            "frontier": float(self.tracker.local()),
            "global_frontier": float(self.tracker.global_frontier()),
        }
