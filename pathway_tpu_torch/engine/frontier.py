"""Frontier tracking for asynchronous sharded execution.

The reference engine sits on timely dataflow's progress protocol: each
worker advances independently and coordination happens through
*frontiers* — per-worker promises of the form "every future message I
send carries a timestamp strictly greater than f" (SURVEY §0, §2.5).
Under this repo's total-order timestamps a worker's frontier is a single
scalar, which keeps the whole protocol embarrassingly small:

- :class:`FrontierTracker` — one worker's view of the cluster: its own
  frontier (monotone), the merged broadcast frontiers of its peers, the
  global frontier (min over workers), stall detection, and the
  frontier-derived commit boundary that replaces the BSP tick counter
  as the consistency anchor.
- :class:`QuiesceVotes` — the settle protocol used by commit waves and
  termination: counter-based rounds (sent/received data events +
  an activity flag per round) that declare quiescence only after TWO
  consecutive clean rounds with stable, balanced totals. Two rounds are
  load-bearing: a single balanced round can be forged by one in-flight
  message masked by another that was received-but-not-yet-counted-sent
  (the classic Safra asymmetry); any such message surfaces as activity
  or imbalance in the following round.

Both are pure components — no comm, no threads — so the protocol is
unit-testable in isolation (``tests/test_torch_frontier.py``).

Copy of ``pathway_tpu/engine/frontier.py``.
"""

from __future__ import annotations

__all__ = ["FrontierTracker", "QuiesceVotes"]


class FrontierTracker:
    """One worker's frontier bookkeeping.

    ``advance_local(t)`` records the promise "this worker will never
    again send data at a time <= t"; ``observe(w, t)`` merges a peer's
    broadcast promise. Frontiers are monotone by construction — a local
    regression is a protocol bug and raises; a stale peer observation
    (re-broadcast of an old status) is lawful and ignored.
    """

    def __init__(self, n_workers: int, worker_id: int):
        if not 0 <= worker_id < n_workers:
            raise ValueError(f"worker {worker_id} outside 0..{n_workers - 1}")
        self.n_workers = n_workers
        self.worker_id = worker_id
        self._f = [-1] * n_workers
        #: monotonic wall time (seconds) of each worker's last advance;
        #: None = never advanced. Fed by the caller so tests inject time.
        self._advanced_at: list[float | None] = [None] * n_workers

    # -- advancing -------------------------------------------------------

    def advance_local(self, t: int, now: float | None = None) -> None:
        """Advance this worker's own frontier. Equal re-advance is a
        no-op; going backwards would un-promise already-broadcast
        progress and raises."""
        cur = self._f[self.worker_id]
        if t < cur:
            raise ValueError(
                f"frontier regression on worker {self.worker_id}: "
                f"{cur} -> {t}"
            )
        if t > cur:
            self._f[self.worker_id] = int(t)
            if now is not None:
                self._advanced_at[self.worker_id] = now

    def observe(self, worker: int, t: int, now: float | None = None) -> bool:
        """Merge one peer broadcast; returns True when it advanced the
        peer's frontier (stale/duplicate broadcasts return False)."""
        if not 0 <= worker < self.n_workers:
            raise ValueError(f"unknown worker {worker}")
        if t <= self._f[worker]:
            return False
        self._f[worker] = int(t)
        if now is not None:
            self._advanced_at[worker] = now
        return True

    # -- reading ---------------------------------------------------------

    def local(self) -> int:
        return self._f[self.worker_id]

    def frontiers(self) -> list[int]:
        return list(self._f)

    def global_frontier(self) -> int:
        """The cluster-wide lower bound: no worker will ever send data
        at a time <= this. -1 until every worker has broadcast once."""
        return min(self._f)

    def commit_boundary(self) -> int:
        """Largest even logical time covered by the global frontier —
        the frontier-derived replacement for the BSP "agreed tick"
        consistency point (commit timestamps are even by the engine's
        timestamp discipline, reference timestamp.rs:22-28). On a
        synchronous schedule (every worker advancing through the same
        tick sequence) this equals the tick-derived boundary exactly."""
        g = self.global_frontier()
        if g < 0:
            return -1
        return g & ~1

    def ages(self, now: float) -> dict[int, float | None]:
        """Seconds since each worker's last frontier advance (None =
        never advanced). The commit-wave timeout uses this to name WHO
        the wave was waiting on and for how long — the crash-side
        counterpart of the per-wave holding-worker election
        (observability/critpath.py)."""
        return {
            w: (None if a is None else max(0.0, now - a))
            for w, a in enumerate(self._advanced_at)
        }

    def stalled(self, now: float, timeout_s: float) -> list[int]:
        """Workers that look wedged: their frontier sits strictly behind
        the most advanced worker AND they have not advanced for
        ``timeout_s`` while someone else has. A uniformly-idle cluster
        (nobody advancing) is parked, not stalled."""
        lead = max(self._f)
        freshest = max(
            (a for a in self._advanced_at if a is not None), default=None
        )
        if freshest is None or now - freshest > timeout_s:
            return []
        out = []
        for w in range(self.n_workers):
            a = self._advanced_at[w]
            if self._f[w] < lead and (a is None or now - a > timeout_s):
                out.append(w)
        return out


class QuiesceVotes:
    """Counter-based quiescence detection over a broadcast-only plane.

    Used twice by the async executor: commit-wave settle ("all data at
    times <= T has been processed everywhere") and termination ("the
    dataflow is drained"). Each worker repeatedly casts a vote for the
    current round — ``(sent_total, recv_total, active_since_last_vote)``
    over *data* events — and collects every peer's vote for that round.
    A round is clean when all votes are inactive and the sent/received
    sums balance; quiescence is declared only after two consecutive
    clean rounds with identical totals (see module docstring for why
    one round is unsound). All workers see the same votes, so they
    reach the same verdict at the same round without any extra
    acknowledgement traffic.
    """

    def __init__(self, n_workers: int, worker_id: int, phase: str):
        self.n_workers = n_workers
        self.worker_id = worker_id
        self.phase = phase
        self.round = 0
        #: round -> worker -> (sent, recv, active)
        self._votes: dict[int, dict[int, tuple[int, int, bool]]] = {}
        self._cast_rounds: set[int] = set()
        self._prev_clean: tuple[int, int] | None = None

    def needs_cast(self) -> bool:
        return self.round not in self._cast_rounds

    def cast(self, sent: int, recv: int, active: bool) -> tuple:
        """Vote for the current round; returns the broadcast payload
        ``(phase, round, sent, recv, active)``. Idempotent per round."""
        if self.round not in self._cast_rounds:
            self._cast_rounds.add(self.round)
            self._votes.setdefault(self.round, {})[self.worker_id] = (
                int(sent), int(recv), bool(active)
            )
        return (self.phase, self.round, int(sent), int(recv), bool(active))

    def observe(self, worker: int, payload: tuple) -> None:
        """Record a peer's vote (must match this phase; rounds other
        than the current one are kept — a fast peer may run ahead)."""
        phase, rnd, sent, recv, active = payload
        if phase != self.phase:
            return
        self._votes.setdefault(int(rnd), {}).setdefault(
            int(worker), (int(sent), int(recv), bool(active))
        )

    def step(self) -> bool:
        """Evaluate the current round if complete. Returns True once
        quiescence is established; otherwise advances to the next round
        (when complete) and returns False."""
        votes = self._votes.get(self.round, {})
        if len(votes) < self.n_workers:
            return False
        sent = sum(v[0] for v in votes.values())
        recv = sum(v[1] for v in votes.values())
        clean = sent == recv and not any(v[2] for v in votes.values())
        if clean and self._prev_clean == (sent, recv):
            return True
        self._prev_clean = (sent, recv) if clean else None
        self._votes.pop(self.round - 2, None)  # bounded memory
        self.round += 1
        return False
