"""Supervised cluster runtime — restart-from-snapshot on worker death.

``python -m pathway_tpu_torch.cli spawn --supervise`` wraps the process
ensemble in a :class:`Supervisor`: it watches every child for death (exit
code) and wedge (the ``/healthz`` heartbeat probe), and on any failure

1. tears the surviving peers down **cooperatively** — SIGTERM first, which
   the children translate into ``request_stop()`` (``internals/run.py``)
   so their persistence managers flush the recorded input tail via
   ``close()`` before exiting; SIGKILL only after a grace period;
2. **harvests the dead workers' flight-recorder rings**
   (``observability/flightrecorder.py``, ``PATHWAY_FLIGHT_DIR``) into
   ``crash-<generation>-<process>.json`` forensic bundles — the crashed
   worker's final ticks, chaos injections fired, comm-break reasons and
   exit reason — and stamps the bundle path into the restart reason (so
   it reaches ``PATHWAY_LAST_RESTART_REASON`` and the
   ``pathway_last_restart_reason`` metric label); harvested bundle count
   is exported as ``pathway_flight_recorder_dumps_total`` via
   ``PATHWAY_FLIGHT_DUMPS``;
3. restarts the WHOLE ensemble (the engine recovers from the last
   snapshot common to every worker — ``Executor._recover``) after a
   jittered exponential backoff, stamping each generation's environment
   with ``PATHWAY_RESTART_COUNT`` / ``PATHWAY_LAST_RESTART_REASON`` so
   fault plans gate per generation and ``/metrics`` exports
   ``pathway_restarts_total`` + ``pathway_last_restart_reason``;
4. gives up when the crash-loop circuit breaker trips: more than
   ``max_restarts`` restarts inside a ``window_s`` sliding window means
   the program dies deterministically (a poisoned input, a broken
   deploy) and restarting is harm, not healing.

The reference treats restart-with-recovery as the fault-tolerance
contract (wordcount's ``run_pw_program_suddenly_terminate`` SIGKILLs the
engine and reruns it in a loop, demanding exact final output); this
module is that loop, productized.

Env knobs (CLI flags override): ``PATHWAY_SUPERVISE_MAX_RESTARTS`` (5),
``PATHWAY_SUPERVISE_WINDOW_S`` (60), ``PATHWAY_SUPERVISE_BACKOFF_S``
(0.5 initial, doubling), ``PATHWAY_SUPERVISE_BACKOFF_MAX_S`` (30),
``PATHWAY_SUPERVISE_GRACE_S`` (5).

Copy of ``pathway_tpu/parallel/supervisor.py``. The port has no fault plan
(``chaos/`` is not ported), so the two carve-outs that let an injected
``ChaosInjected`` crash the loop (at the planned stop and at the poll hook)
have nothing to catch and are left out: every exception there takes the
reference's ordinary branch.
"""

from __future__ import annotations

import json
import os
import random
import signal
import subprocess
import sys
import time
from collections import deque
from typing import Any, Callable, Sequence

__all__ = ["Supervisor", "RestartBudgetExceeded"]

#: circuit breaker opened — the ensemble is crash-looping
EXIT_CIRCUIT_OPEN = 75  # EX_TEMPFAIL

#: ring record kinds emitted continuously during a healthy run — these
#: dominate the ring byte-for-byte and are only interesting near the
#: moment of death, so the crash bundle keeps just their recent tail
#: (rare forensic kinds — slo.alert, chaos.fired, comm.broken — are
#: kept in full regardless of age)
_FREQUENT_RECORD_KINDS = frozenset(
    {"tick", "wave.phase", "async.commit", "profile.top"}
)


class RestartBudgetExceeded(RuntimeError):
    pass


class Supervisor:
    """Run ``launch`` generations of a process ensemble until clean exit,
    restarting on failure with backoff + a sliding-window circuit breaker.

    ``launch(generation, reason)`` must return the ensemble's
    ``subprocess.Popen`` handles; ``reason`` is None for generation 0 and
    the previous generation's failure description afterwards.
    """

    def __init__(
        self,
        launch: Callable[[int, str | None], Sequence[subprocess.Popen]],
        *,
        max_restarts: int | None = None,
        window_s: float | None = None,
        backoff_s: float | None = None,
        backoff_max_s: float | None = None,
        grace_s: float | None = None,
        health_ports: Sequence[int] | None = None,
        health_interval_s: float = 1.0,
        poll_interval_s: float = 0.05,
        rng: Callable[[], float] | None = None,
        log: Callable[[str], Any] | None = None,
        labels: Sequence[str] | None = None,
        flight_dir: str | None = None,
        process_ids: Sequence[int] | None = None,
        run_id: str | None = None,
        poll_hook: Callable[[], str | None] | None = None,
        planned_stop: Callable[[str], Any] | None = None,
    ):
        from ..internals.config import _env_float, _env_int

        self.launch = launch
        self.max_restarts = (
            max_restarts
            if max_restarts is not None
            else _env_int("PATHWAY_SUPERVISE_MAX_RESTARTS", 5)
        )
        self.window_s = (
            window_s
            if window_s is not None
            else _env_float("PATHWAY_SUPERVISE_WINDOW_S", 60.0)
        )
        self.backoff_s = (
            backoff_s
            if backoff_s is not None
            else _env_float("PATHWAY_SUPERVISE_BACKOFF_S", 0.5)
        )
        self.backoff_max_s = (
            backoff_max_s
            if backoff_max_s is not None
            else _env_float("PATHWAY_SUPERVISE_BACKOFF_MAX_S", 30.0)
        )
        self.grace_s = (
            grace_s
            if grace_s is not None
            else _env_float("PATHWAY_SUPERVISE_GRACE_S", 5.0)
        )
        #: per-process /healthz ports (monitoring base + pid); empty =
        #: exit-code supervision only
        self.health_ports = list(health_ports or [])
        self.health_interval_s = health_interval_s
        self.poll_interval_s = poll_interval_s
        #: display names aligned with launch()'s Popen order — the CLI
        #: passes real process ids so failure reasons name the right
        #: worker even under a -p id subset
        self.labels = list(labels or [])
        self._rng = rng if rng is not None else random.random
        self._log = log if log is not None else (
            lambda msg: print(f"[supervisor] {msg}", file=sys.stderr)
        )
        #: where the children's flight-recorder rings (and the crash
        #: bundles harvested from them) live; None/empty = no forensics
        self.flight_dir = (
            flight_dir
            if flight_dir is not None
            else os.environ.get("PATHWAY_FLIGHT_DIR")
        )
        #: real process ids aligned with launch()'s Popen order (ring files
        #: are named flight-p<process_id>.ring); default 0..N-1 by index
        self.process_ids = list(process_ids or [])
        #: the ensemble's PATHWAY_RUN_ID: a harvested ring must carry it,
        #: or it is a stale leftover of a PREVIOUS run in the same
        #: flight dir (a child that dies before arming its recorder never
        #: overwrites the old ring) and bundling it would misattribute
        #: another run's forensics to this one
        self.run_id = (
            run_id
            if run_id is not None
            else os.environ.get("PATHWAY_RUN_ID")
        )
        #: called every watch poll while the generation is healthy; a
        #: non-None token requests a PLANNED stop: cooperative teardown
        #: (the drain-to-delivery-boundary the persistence close protocol
        #: guarantees), then ``planned_stop(token)``, then relaunch —
        #: without burning restart budget. The autoscale controller's
        #: seam into the supervision loop.
        self.poll_hook = poll_hook
        self.planned_stop = planned_stop
        self._planned: str | None = None
        self.restarts_total = 0
        self.last_restart_reason: str | None = None
        self.flight_dumps_total = 0
        #: failures inside the current circuit-breaker window at the
        #: moment the current generation launched — the CLI stamps it
        #: into child environments (PATHWAY_SUPERVISE_WINDOW_FAILURES) so
        #: /metrics shows a restart storm building BEFORE the breaker
        #: trips (pathway_circuit_open / pathway_restart_window_failures)
        self.window_failures = 0
        #: Popen indices implicated in the current generation's failure
        #: (dead exit code or served-503 wedge) — the rings worth harvesting
        self._failed_indices: list[int] = []

    # -- lifecycle -------------------------------------------------------

    def child_env(self, generation: int, reason: str | None) -> dict[str, str]:
        """The supervision stamps every launched child must carry — the
        observability hub reads exactly these keys for /metrics
        (pathway_restarts_total, pathway_flight_recorder_dumps_total,
        pathway_restart_window_failures / pathway_circuit_open,
        pathway_last_restart_reason). One source of truth for every
        launcher (cli ``spawn --supervise`` and the autoscale
        controller), so supervised and autoscaled runs cannot drift
        apart in what they export."""
        env = {
            "PATHWAY_SUPERVISED": "1",
            "PATHWAY_RESTART_COUNT": str(generation),
            # forensic-bundle count so far
            "PATHWAY_FLIGHT_DUMPS": str(self.flight_dumps_total),
            # circuit-breaker window position at launch: a restart storm
            # is visible on the children's /metrics BEFORE it trips
            "PATHWAY_SUPERVISE_WINDOW_FAILURES": str(self.window_failures),
        }
        if reason is not None:
            env["PATHWAY_LAST_RESTART_REASON"] = reason
        return env

    def run(self) -> int:
        restart_times: deque[float] = deque()
        generation = 0
        reason: str | None = None
        while True:
            now = time.monotonic()
            while restart_times and now - restart_times[0] > self.window_s:
                restart_times.popleft()
            self.window_failures = len(restart_times)
            procs = list(self.launch(generation, reason))
            reason = self._watch(procs)
            if self._planned is not None:
                # a PLANNED stop (autoscale rescale): cooperative teardown
                # drains every worker to its delivery boundary, then the
                # planned_stop hook runs (state resharding) and the next
                # generation launches immediately — no backoff, and no
                # restart-budget burn (a scale event is not a failure)
                token, self._planned = self._planned, None
                self._teardown(procs)
                try:
                    if self.planned_stop is not None:
                        self.planned_stop(token)
                except Exception as e:
                    # no fault plan in the port, so no injected crash to
                    # re-raise here (the reference's ChaosInjected
                    # carve-out). A failed planned stop (resharder
                    # refused, store gone) IS a failure: fall through to
                    # the budgeted
                    # restart path so a broken rescale loop trips the
                    # breaker instead of spinning forever
                    reason = f"planned stop failed ({token}): {e}"
                else:
                    self._log(f"planned restart: {token}")
                    generation += 1
                    reason = token
                    continue
            if reason is None:
                return 0  # every process exited 0 — the run completed
            self._teardown(procs)
            # harvest after teardown (every ring is final) and before the
            # relaunch truncates them for the next generation
            bundles = self._harvest_flight(generation, reason)
            if bundles:
                reason = f"{reason} [flight recorder: {', '.join(bundles)}]"
            self._log(f"generation {generation} failed: {reason}")
            now = time.monotonic()
            restart_times.append(now)
            while restart_times and now - restart_times[0] > self.window_s:
                restart_times.popleft()
            if len(restart_times) > self.max_restarts:
                self._log(
                    f"circuit breaker open: {len(restart_times)} restarts "
                    f"inside {self.window_s:.0f}s (max {self.max_restarts}) "
                    "— giving up"
                )
                return EXIT_CIRCUIT_OPEN
            self.restarts_total += 1
            self.last_restart_reason = reason
            delay = min(
                self.backoff_max_s,
                self.backoff_s * (2 ** (self.restarts_total - 1)),
            ) * (0.5 + self._rng())  # jitter in [0.5, 1.5): no thundering herd
            self._log(
                f"restarting from last common snapshot in {delay:.2f}s "
                f"(restart #{self.restarts_total})"
            )
            time.sleep(delay)
            generation += 1

    def _label(self, i: int) -> str:
        return self.labels[i] if i < len(self.labels) else f"process {i}"

    def _watch(self, procs: Sequence[subprocess.Popen]) -> str | None:
        """Block until the generation resolves: None = all exited cleanly,
        else the failure reason (``_failed_indices`` names the culprits)."""
        self._failed_indices = []
        next_health = time.monotonic() + self.health_interval_s
        while True:
            codes = [p.poll() for p in procs]
            failed = [
                i for i, c in enumerate(codes) if c is not None and c != 0
            ]
            if failed:
                # settle pass: fast failure propagation can take down peers
                # within milliseconds of the first death — catch them now so
                # the ACTUAL crash victim's flight ring gets harvested, not
                # just the lowest-index casualty
                time.sleep(self.poll_interval_s)
                codes = [p.poll() for p in procs]
                self._failed_indices = [
                    i for i, c in enumerate(codes)
                    if c is not None and c != 0
                ]
                # headline the likeliest root cause: a signal death
                # (negative code, e.g. SIGKILL) over a peer that exited
                # nonzero because the mesh broke under it
                i = min(
                    self._failed_indices,
                    key=lambda j: (codes[j] >= 0, j),
                )
                reason = (
                    f"{self._label(i)} (pid {procs[i].pid}) "
                    f"exited with {codes[i]}"
                )
                others = [
                    f"{self._label(j)} exited with {codes[j]}"
                    for j in self._failed_indices
                    if j != i
                ]
                if others:
                    reason += f" (also: {'; '.join(others)})"
                return reason
            if all(c == 0 for c in codes):
                return None
            if self.health_ports and time.monotonic() >= next_health:
                wedged = self._check_health()
                if wedged is not None:
                    return wedged
                next_health = time.monotonic() + self.health_interval_s
            if self.poll_hook is not None:
                try:
                    token = self.poll_hook()
                except Exception as e:
                    # no fault plan in the port, so no injected controller
                    # crash to re-raise here (the reference's
                    # ChaosInjected carve-out). An ordinary hook failure
                    # (signal fetch + decision) must never take the supervision loop down with it
                    self._log(f"poll hook failed: {e}")
                    token = None
                if token:
                    self._planned = token
                    return None
            time.sleep(self.poll_interval_s)

    def _check_health(self) -> str | None:
        """Probe each child's /healthz. Only a *served, failing* probe is
        fatal (a wedged executor thread); an unreachable port is not — the
        server may be disabled, still booting, or already shut down."""
        import urllib.error
        import urllib.request

        for i, port in enumerate(self.health_ports):
            try:
                with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/healthz", timeout=2.0
                ) as r:
                    if r.status != 200:  # pragma: no cover — urllib raises
                        return f"{self._label(i)} wedged (healthz {r.status})"
            except urllib.error.HTTPError as e:
                if e.code == 503:
                    self._failed_indices = [i]
                    return (
                        f"{self._label(i)} wedged (healthz 503: "
                        f"{e.read(200).decode(errors='replace')})"
                    )
            except Exception:
                pass  # unreachable — not evidence of a wedge
        return None

    def _teardown(self, procs: Sequence[subprocess.Popen]) -> None:
        """Cooperative stop of the survivors: SIGTERM (children flush their
        persistence input tail on the way out), grace, then SIGKILL."""
        for p in procs:
            if p.poll() is None:
                try:
                    p.send_signal(signal.SIGTERM)
                except OSError:
                    pass
        deadline = time.monotonic() + self.grace_s
        for p in procs:
            remaining = deadline - time.monotonic()
            if remaining > 0 and p.poll() is None:
                try:
                    p.wait(timeout=remaining)
                except subprocess.TimeoutExpired:
                    pass
        for p in procs:
            if p.poll() is None:
                self._log(f"pid {p.pid} ignored SIGTERM for "
                          f"{self.grace_s:.0f}s — SIGKILL")
                try:
                    p.kill()
                except OSError:
                    pass
                p.wait()

    # -- crash forensics (flight-recorder harvest) -----------------------

    def _harvest_flight(self, generation: int, reason: str) -> list[str]:
        """Read the failed workers' flight-recorder rings into
        ``crash-<generation>-<process>.json`` bundles; returns the bundle
        paths. Never raises — forensics must not block the restart loop."""
        if not self.flight_dir:
            return []
        from ..observability import flightrecorder

        if self._failed_indices:
            targets = [
                self.process_ids[i] if i < len(self.process_ids) else i
                for i in self._failed_indices
            ]
        else:
            # failure without a named culprit (e.g. an external teardown):
            # every ring present is evidence
            targets = self.process_ids or self._discover_rings()
        bundles: list[str] = []
        for proc in targets:
            ring = flightrecorder.ring_path(self.flight_dir, proc)
            try:
                doc = flightrecorder.harvest(ring)
            except (OSError, ValueError):
                continue  # no ring (flight recorder off in the child)
            if self.run_id and doc["run_id"] != self.run_id[:16]:
                # ring header stores 16 run-id bytes; a mismatch means the
                # ring predates this run (the child died before arming its
                # recorder) — not this run's evidence
                continue
            records = doc["records"]
            # a flat tail cap would let high-frequency progress records
            # (ticks at up to 100/s, wave phases, periodic profile
            # deposits) rotate the rare forensic records — fired alerts,
            # chaos injections, comm.broken attributions — out of any
            # bundle harvested more than a few seconds after the event.
            # Keep every rare record plus the most recent tail.
            tail = records[-400:]
            rare = [
                r
                for r in records[: len(records) - len(tail)]
                if r.get("kind") not in _FREQUENT_RECORD_KINDS
            ]
            bundle = {
                "generation": generation,
                "process": proc,
                "exit_reason": reason,
                "harvested_at": time.time(),
                "run_id": doc["run_id"],
                "ring_wrapped": doc["wrapped"],
                "chaos_armed": bool(os.environ.get("PATHWAY_FAULT_PLAN")),
                "chaos_fired": [
                    r for r in records if r.get("kind") == "chaos.fired"
                ],
                "last_ticks": [
                    r for r in records if r.get("kind") == "tick"
                ][-50:],
                # the in-flight commit wave at death: the last wave-phase
                # transition stamp ("wave.phase") or completed wave record
                # ("async.commit", which names the holding worker) —
                # answers "which wave, which phase, who was it waiting on"
                "last_wave": next(
                    (
                        r for r in reversed(records)
                        if str(r.get("kind", "")).startswith("wave")
                        or r.get("kind") == "async.commit"
                    ),
                    None,
                ),
                "records": rare + tail,
            }
            path = os.path.join(
                self.flight_dir, f"crash-{generation}-{proc}.json"
            )
            try:
                with open(path, "w") as f:
                    json.dump(bundle, f)
            except OSError as e:
                self._log(f"could not write crash bundle {path}: {e}")
                continue
            self.flight_dumps_total += 1
            bundles.append(path)
        # consume every ring (harvested or not): a child of the NEXT
        # generation that dies before reaching Executor init never
        # re-creates its ring, and a later harvest would otherwise read
        # THIS generation's records and misattribute them (the bundle
        # preserves the evidence that matters)
        for proc in self._discover_rings():
            try:
                os.remove(flightrecorder.ring_path(self.flight_dir, proc))
            except OSError:
                pass
        return bundles

    def _discover_rings(self) -> list[int]:
        try:
            names = os.listdir(self.flight_dir)
        except OSError:
            return []
        out = []
        for n in names:
            if n.startswith("flight-p") and n.endswith(".ring"):
                try:
                    out.append(int(n[len("flight-p"):-len(".ring")]))
                except ValueError:
                    pass
        return sorted(out)
