"""Always-on sampling profiler — frame-level continuous profiling.

The observability stack can *name* a bottleneck (``/attribution`` ranks
operators, the wave critical path ranks phases) but not show *which code
inside it* burns the time. This module closes that gap with the classic
continuous-profiling design (low-frequency stack sampling, collapsed
folds, cluster merge — the Google-Wide Profiling / parca lineage): a
background sampler thread walks ``sys._current_frames()`` at
``PATHWAY_PROFILE_HZ`` (default 19 Hz — a prime, so the sampler never
phase-locks with periodic engine work) and folds every thread's stack
into a bounded collapsed-stack table.

Two tables per process, both :class:`~.keyload.SpaceSaving` sketches
(``PATHWAY_PROFILE_STACKS`` counters), so eviction provably keeps the
heaviest stacks and cluster merge is associative with the usual epsilon
bound:

- **wall**: weight 1 per sample — where threads *are* (includes blocking:
  sleeps, queue waits, socket reads);
- **cpu**: weight = the thread's CPU-time delta since the previous sample
  (per-thread utime+stime via ``/proc/self/task/<tid>/stat``; Linux only,
  degrades to wall-only elsewhere) — where cycles *go*.

Every sample is tagged with the executing operator / fused-chain member
label by reading a per-thread op slot the executor updates as it sweeps
nodes — the same labels ``EngineStats.note_op_time`` feeds
``/attribution``, so profiles join against the attribution ranking
instead of floating beside it. Stack keys are collapsed-stack lines::

    thread:<name>;op:<Label#id>;root_fn (file.py:12);...;leaf_fn (f.py:9)

The profiler is ON by default and OFF with ``PATHWAY_PROFILE=0`` — the
kill switch silences everything at once: no sampler thread, no op slots
(``current_op_slot()`` returns ``None`` — one branch per node on the
executor hot path), no ingest stage counters, no ``pathway_profile_*``
metric families, no ``profile.*`` signals series. The bench A/B
(``bench.py ingest_stage_split`` lane) holds the on/off throughput delta
under 3%.

The sampler also deposits its top-K collapsed stacks into the mmap
flight ring (``flightrecorder.py``) every ``PATHWAY_PROFILE_FLIGHT_S``
seconds, so a supervisor crash bundle carries what the worker was
executing when it died. ``heap_document()`` adds the on-demand
``tracemalloc`` view (``/profile?heap=1``) for the memory plane.

Copy of ``pathway_tpu/observability/profiler.py``.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Any

from .keyload import SpaceSaving

__all__ = [
    "Profiler",
    "current_op_slot",
    "release_op_slot",
    "enabled",
    "heap_document",
    "THREAD_NAME",
]

DEFAULT_HZ = 19.0
DEFAULT_STACKS = 512
DEFAULT_HEAP_FRAMES = 16
DEFAULT_FLIGHT_S = 5.0
#: sampler thread name — smoke tests assert zero of these when disabled
THREAD_NAME = "pathway-profiler"
#: stacks deeper than this fold to their leaf-most suffix (bounded keys)
_MAX_DEPTH = 48
#: collapsed stacks deposited into the flight ring per flush
_FLIGHT_TOP_K = 8


def enabled() -> bool:
    """The plane-wide kill switch (``PATHWAY_PROFILE``, default on).
    Re-read per call like ``keyload.enabled()`` so tests that flip the
    env in-process see the change."""
    from ..internals.config import _env_bool

    return _env_bool("PATHWAY_PROFILE", True)


# -- per-thread operator context ---------------------------------------
#
# The executor cannot hand labels to the sampler through a thread-local
# (thread-locals are invisible cross-thread); instead each engine thread
# registers a slot object here and mutates its ``label`` attribute as it
# sweeps nodes. Attribute stores on a fixed slot are single bytecodes
# (GIL-atomic), so the hot path pays one attribute write per node and
# the sampler reads whatever label was live at sample time.


class _OpSlot:
    __slots__ = ("label",)

    def __init__(self) -> None:
        #: the /attribution label of the operator executing NOW
        #: (``Type#node_id`` — fused chains publish MEMBER labels), or
        #: None between sweeps
        self.label: str | None = None


_OP_SLOTS: dict[int, _OpSlot] = {}
_SLOTS_LOCK = threading.Lock()


def current_op_slot() -> _OpSlot | None:
    """The calling thread's operator-context slot (registered on first
    use), or ``None`` when profiling is off — callers keep the returned
    slot and null-check it once per node."""
    if not enabled():
        return None
    ident = threading.get_ident()
    slot = _OP_SLOTS.get(ident)
    if slot is None:
        slot = _OpSlot()
        with _SLOTS_LOCK:
            _OP_SLOTS[ident] = slot
    return slot


def release_op_slot() -> None:
    """Drop the calling thread's slot (executor run teardown): a parked
    pool thread no longer counts as an engine thread in the op-tagged
    share, and reused thread idents never inherit stale slots."""
    with _SLOTS_LOCK:
        _OP_SLOTS.pop(threading.get_ident(), None)


# -- the sampler --------------------------------------------------------


class Profiler:
    """Per-process sampling profiler; one instance per worker process,
    owned by the observability hub (started with the signals plane,
    stopped in ``hub.close()``)."""

    def __init__(
        self,
        hz: float | None = None,
        capacity: int | None = None,
        flight_interval_s: float | None = None,
        process_id: int = 0,
    ):
        from ..internals.config import _env_float, _env_int

        self.hz = (
            hz
            if hz is not None
            else max(0.1, _env_float("PATHWAY_PROFILE_HZ", DEFAULT_HZ))
        )
        self.capacity = (
            capacity
            if capacity is not None
            else max(8, _env_int("PATHWAY_PROFILE_STACKS", DEFAULT_STACKS))
        )
        self.flight_interval_s = (
            flight_interval_s
            if flight_interval_s is not None
            else _env_float("PATHWAY_PROFILE_FLIGHT_S", DEFAULT_FLIGHT_S)
        )
        self.process_id = int(process_id)
        self.wall = SpaceSaving(self.capacity)
        self.cpu = SpaceSaving(self.capacity)
        self.samples_total = 0
        #: AWAKE samples from threads holding an op slot (engine
        #: threads); parked waits (label-less, blocked in a scheduler
        #: wait) fold into the wall table but stay out of this
        #: denominator — an idle engine is not untagged work
        self.engine_samples = 0
        #: engine-thread samples that carried a live operator label
        self.op_tagged = 0
        self.errors_total = 0
        self.threads_last = 0
        self.cpu_supported = os.path.isdir("/proc/self/task")
        self._cpu_prev: dict[int, float] = {}
        try:
            self._clk_tck = float(os.sysconf("SC_CLK_TCK")) or 100.0
        except (AttributeError, ValueError, OSError):
            self._clk_tck = 100.0
        self._lock = threading.Lock()
        self._stop_evt = threading.Event()
        self._thread: threading.Thread | None = None
        self._started_at = time.monotonic()

    # -- lifecycle --

    def start(self) -> "Profiler":
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop_evt.clear()
        t = threading.Thread(target=self._run, name=THREAD_NAME, daemon=True)
        self._thread = t
        t.start()
        return self

    def stop(self) -> None:
        """Stop and join the sampler; bounded join so a wedged sample
        read can never wedge engine shutdown (the thread is a daemon)."""
        self._stop_evt.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=2.0)
        self._thread = None

    def _run(self) -> None:
        period = 1.0 / self.hz
        next_flight = time.monotonic() + max(0.05, self.flight_interval_s)
        while not self._stop_evt.wait(period):
            try:
                self.sample_once()
            except Exception:
                self.errors_total += 1
            if self.flight_interval_s > 0:
                now = time.monotonic()
                if now >= next_flight:
                    next_flight = now + self.flight_interval_s
                    try:
                        self._deposit_flight()
                    except Exception:
                        self.errors_total += 1
        # final deposit so a clean stop leaves the last profile in the ring
        try:
            self._deposit_flight()
        except Exception:
            pass

    # -- sampling --

    def sample_once(self) -> int:
        """Walk every live thread's stack once; returns threads sampled.
        Public so tests drive the fold deterministically without timing."""
        me = threading.get_ident()
        names: dict[int, tuple[str, int | None]] = {}
        for t in threading.enumerate():
            if t.ident is not None:
                names[t.ident] = (t.name, getattr(t, "native_id", None))
        frames = sys._current_frames()
        cpu_now = self._cpu_times(names) if self.cpu_supported else {}
        n = 0
        with self._lock:
            for ident, frame in frames.items():
                if ident == me:
                    continue
                name, _tid = names.get(ident, (f"thread-{ident}", None))
                slot = _OP_SLOTS.get(ident)
                op = slot.label if slot is not None else None
                key = _fold_stack(frame, name, op)
                self.wall.observe(key, 1.0)
                self.samples_total += 1
                n += 1
                if slot is not None:
                    if op is not None:
                        self.engine_samples += 1
                        self.op_tagged += 1
                    elif not _is_parked(frame):
                        self.engine_samples += 1
                delta = cpu_now.get(ident)
                if delta:
                    self.cpu.observe(key, delta)
            self.threads_last = n
        return n

    def _cpu_times(
        self, names: dict[int, tuple[str, int | None]]
    ) -> dict[int, float]:
        """ident -> CPU seconds burned since the previous sample. The
        first sighting of a thread establishes its baseline (no delta)."""
        out: dict[int, float] = {}
        for ident, (_name, tid) in names.items():
            if tid is None:
                continue
            try:
                with open(f"/proc/self/task/{tid}/stat", "rb") as f:
                    stat = f.read()
                # fields after the parenthesized comm; utime+stime are
                # fields 14/15 of the full line = 12/13 post-comm (1-based)
                rest = stat.rsplit(b")", 1)[1].split()
                cpu = (int(rest[11]) + int(rest[12])) / self._clk_tck
            except (OSError, ValueError, IndexError):
                continue
            prev = self._cpu_prev.get(ident)
            self._cpu_prev[ident] = cpu
            if prev is not None and cpu > prev:
                out[ident] = cpu - prev
        return out

    # -- wire forms --

    def snapshot(self) -> dict:
        """JSON-serializable profile document — the per-process half of
        ``/profile`` (``profile_merge.merge_snapshots`` combines peers)."""
        with self._lock:
            return {
                "enabled": True,
                "process_id": self.process_id,
                "hz": self.hz,
                "capacity": self.capacity,
                "duration_s": round(time.monotonic() - self._started_at, 3),
                "samples_total": self.samples_total,
                "engine_samples": self.engine_samples,
                "op_tagged": self.op_tagged,
                "errors_total": self.errors_total,
                "threads": self.threads_last,
                "cpu_supported": self.cpu_supported,
                "wall": self.wall.snapshot(),
                "cpu": self.cpu.snapshot(),
            }

    def metrics_snapshot(self) -> dict[str, float]:
        """Small scalar surface for /metrics + the signals plane
        (``pathway_profile_*`` families, ``profile.*`` series)."""
        with self._lock:
            total = self.wall.total
            leaf: dict[str, float] = {}
            for key, count, _err in self.wall.items():
                fr = key.rsplit(";", 1)[-1]
                leaf[fr] = leaf.get(fr, 0.0) + count
            top_share = max(leaf.values()) / total if total and leaf else 0.0
            tagged_share = (
                self.op_tagged / self.engine_samples
                if self.engine_samples
                else 0.0
            )
            return {
                "samples_total": float(self.samples_total),
                "engine_samples_total": float(self.engine_samples),
                "errors_total": float(self.errors_total),
                "distinct_frames": float(len(self.wall)),
                "top_frame_share": round(top_share, 4),
                "op_tagged_share": round(tagged_share, 4),
            }

    def _deposit_flight(self) -> None:
        """Top-K collapsed stacks into the mmap flight ring — crash
        bundles then carry what the worker was executing when it died."""
        from .flightrecorder import get_recorder

        rec = get_recorder()
        if rec is None:
            return
        with self._lock:
            top = [
                [_trim_stack(key), round(count, 3)]
                for key, count, _err in self.wall.items()[:_FLIGHT_TOP_K]
            ]
            samples = self.samples_total
        if top:
            rec.record(
                "profile.top",
                process=self.process_id,
                samples=samples,
                top=top,
            )


def _is_parked(frame: Any) -> bool:
    """True when a label-less engine thread's leaf frame is a scheduler
    wait (``threading.Event``/``Condition`` wait, selector poll) or
    blocking transport socket I/O: the executor parks in the former
    between ticks, and stalls in the latter on peer backpressure —
    neither is *executing* Python-level work. Parked wall time still
    shows in the flamegraph (the ``wait``/``_send_vectored`` frames rank
    by self-time like any other); it just doesn't count against the
    op-tag coverage denominator, which answers "of the engine's executed
    samples, how many carried an operator label"."""
    code = frame.f_code
    fn = os.path.basename(code.co_filename)
    return (
        (fn == "threading.py" and code.co_name == "wait")
        or (fn == "selectors.py" and code.co_name == "select")
        or (
            fn == "cluster.py"
            and code.co_name in ("_send_vectored", "_recv_into")
        )
    )


def _fold_stack(frame: Any, thread_name: str, op: str | None) -> str:
    """One thread's stack -> collapsed-stack key, root-first. Frame
    labels use ``co_firstlineno`` (the def site, stable across samples)
    so identical logical stacks fold to one table entry."""
    parts: list[str] = []
    f = frame
    while f is not None and len(parts) < _MAX_DEPTH:
        code = f.f_code
        parts.append(
            f"{code.co_name} "
            f"({os.path.basename(code.co_filename)}:{code.co_firstlineno})"
        )
        f = f.f_back
    parts.reverse()
    head = [f"thread:{thread_name}"]
    if op is not None:
        head.append(f"op:{op}")
    return ";".join(head + parts)


def _trim_stack(key: str, keep: int = 6) -> str:
    """Flight-ring form: thread/op head + the leaf-most frames — rings
    are small (256 KB default) and the leaf end is the forensic signal."""
    parts = key.split(";")
    head = [p for p in parts[:2] if p.startswith(("thread:", "op:"))]
    frames = parts[len(head):]
    if len(frames) > keep:
        frames = ["..."] + frames[-keep:]
    return ";".join(head + frames)


# -- on-demand heap snapshot (tracemalloc) ------------------------------


def heap_document(top: int = 25) -> dict:
    """The memory-plane companion: arm ``tracemalloc`` on first call
    (``PATHWAY_PROFILE_HEAP_FRAMES`` frames of allocation traceback) and
    return the top allocation sites. First call returns ``armed_now:
    true`` with near-empty stats — allocations are traced from arming
    onward; call again after the suspect workload."""
    import tracemalloc

    from ..internals.config import _env_int

    frames = max(1, _env_int("PATHWAY_PROFILE_HEAP_FRAMES", DEFAULT_HEAP_FRAMES))
    armed_now = False
    if not tracemalloc.is_tracing():
        tracemalloc.start(frames)
        armed_now = True
    current, peak = tracemalloc.get_traced_memory()
    entries = []
    try:
        snap = tracemalloc.take_snapshot()
        for st in snap.statistics("traceback")[: max(1, top)]:
            entries.append(
                {
                    "size_kb": round(st.size / 1024.0, 1),
                    "count": st.count,
                    "stack": [
                        f"{os.path.basename(fr.filename)}:{fr.lineno}"
                        for fr in st.traceback
                    ],
                }
            )
    except Exception:
        pass  # heap view is best-effort; never fail the endpoint
    return {
        "armed_now": armed_now,
        "frames": frames,
        "traced_current_kb": round(current / 1024.0, 1),
        "traced_peak_kb": round(peak / 1024.0, 1),
        "top": entries,
    }
