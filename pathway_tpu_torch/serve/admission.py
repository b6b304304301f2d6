"""Admission control for the serve plane (copy of ``pathway_tpu/serve/admission.py``).

Two bounds, both knob-driven: at most ``PATHWAY_SERVE_MAX_INFLIGHT``
queries execute concurrently, and at most ``PATHWAY_SERVE_QUEUE_BOUND``
more may wait for a slot. A query arriving with the queue at its bound
is REJECTED immediately (the HTTP edge turns that into 429 with a
Retry-After computed from the measured service time), so the
accepted-query tail stays bounded instead of collapsing under overload
— load shedding at the door, not timeouts in the hall.

Pure component: no sockets, no event loop, no clocks it didn't take as
arguments beyond an EWMA of observed service times. The HTTP edge calls
it from executor threads; unit tests drive it directly.
"""

from __future__ import annotations

import threading
from typing import Optional

from .stats import bump

__all__ = ["AdmissionController", "Slot", "shared_controller"]


class Slot:
    """Opaque token for one admitted query (identity-compared)."""

    __slots__ = ("queued",)

    def __init__(self, queued: bool):
        #: whether this query waited for a slot before admission
        self.queued = queued


class AdmissionController:
    def __init__(
        self,
        max_inflight: int | None = None,
        queue_bound: int | None = None,
    ):
        from ..internals.config import _env_int

        self.max_inflight = max(
            1,
            max_inflight
            if max_inflight is not None
            else _env_int("PATHWAY_SERVE_MAX_INFLIGHT", 64),
        )
        self.queue_bound = max(
            0,
            queue_bound
            if queue_bound is not None
            else _env_int("PATHWAY_SERVE_QUEUE_BOUND", 256),
        )
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._inflight = 0
        self._queued = 0
        #: EWMA of observed service time (seconds); seeds Retry-After
        self._ewma_s: float | None = None

    # -- admission -----------------------------------------------------

    def try_admit(self, timeout_s: float | None = None) -> Optional[Slot]:
        """Admit one query, waiting up to ``timeout_s`` for a slot.

        Returns a :class:`Slot` on admission. Returns ``None`` — reject,
        the caller answers 429 — when the wait queue is already at its
        bound, or the wait timed out. ``timeout_s=0`` never queues.
        """
        with self._cond:
            if self._inflight < self.max_inflight:
                self._inflight += 1
                bump("queries_total")
                return Slot(queued=False)
            if self._queued >= self.queue_bound or (
                timeout_s is not None and timeout_s <= 0
            ):
                bump("rejected_total")
                return None
            self._queued += 1
            bump("queued_total")
            try:
                remaining = (
                    threading.TIMEOUT_MAX if timeout_s is None else timeout_s
                )
                import time as _time

                t0 = _time.monotonic()
                while self._inflight >= self.max_inflight:
                    if not self._cond.wait(timeout=remaining):
                        bump("rejected_total")
                        return None
                    if timeout_s is not None:
                        remaining = timeout_s - (_time.monotonic() - t0)
                        if remaining <= 0 and (
                            self._inflight >= self.max_inflight
                        ):
                            bump("rejected_total")
                            return None
                self._inflight += 1
                bump("queries_total")
                return Slot(queued=True)
            finally:
                self._queued -= 1

    def release(self, slot: Slot, service_s: float | None = None) -> None:
        """Return a slot; ``service_s`` feeds the Retry-After estimate."""
        with self._cond:
            self._inflight = max(0, self._inflight - 1)
            if service_s is not None and service_s >= 0:
                self._ewma_s = (
                    service_s
                    if self._ewma_s is None
                    else 0.8 * self._ewma_s + 0.2 * service_s
                )
            self._cond.notify()

    def cancel(self, slot: Slot) -> None:
        """Client disconnected mid-flight: free the slot, count it."""
        bump("cancelled_total")
        self.release(slot)

    # -- advice --------------------------------------------------------

    def retry_after_s(self) -> float:
        """How long a 429'd client should back off: the time for the
        current queue (plus itself) to drain at the measured service
        rate. Never below 50 ms so clients can't busy-retry."""
        with self._lock:
            ewma = self._ewma_s if self._ewma_s is not None else 0.05
            queued = self._queued
        per_slot = ewma / float(self.max_inflight)
        return max(0.05, (queued + 1) * per_slot)

    def gauges(self) -> dict[str, float]:
        with self._lock:
            return {
                "inflight": float(self._inflight),
                "queue_depth": float(self._queued),
                "max_inflight": float(self.max_inflight),
                "queue_bound": float(self.queue_bound),
            }


_shared_lock = threading.Lock()
_shared: AdmissionController | None = None


def shared_controller() -> AdmissionController:
    """The process's edge controller (every REST route shares one slot
    pool); created lazily so the knobs are read at first serve, and
    registered as a gauge provider so its in-flight / queue depth ride
    the ``serve.*`` snapshot."""
    global _shared
    from .stats import register_gauge_provider

    with _shared_lock:
        if _shared is None:
            _shared = AdmissionController()
        # idempotent, and re-arms after a reset_serve_stats() in tests
        register_gauge_provider(_shared.gauges)
        return _shared
