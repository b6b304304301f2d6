"""Always-on crash-safe flight recorder — the engine's black box.

The tracer (``internals/tracing.py``) buffers spans in memory and writes
them at flush points, so a SIGKILL'd or wedged worker leaves nothing
behind — exactly the runs worth explaining. This module keeps a small
**mmap-backed ring buffer per process** (``flight-p<N>.ring`` under
``PATHWAY_FLIGHT_DIR``) recording the last K ticks of span/event/log
records *as they happen*: every write lands in the page cache through the
mapping, so the tail survives SIGKILL, ``os._exit``, and a supervisor's
SIGKILL-after-wedge without any flush discipline. The reference's analog
is timely's always-streaming event log (``DIFFERENTIAL_LOG_ADDR``,
``dataflow.rs:5540-5548``) — a record stream that exists whether or not
anyone is watching.

On worker death the supervisor (``parallel/supervisor.py``) harvests the
dead process's ring into a ``crash-<generation>-<process>.json`` forensic
bundle and stamps the bundle path into the restart reason.

Record producers (each one ``is None`` check when disarmed):

- ``engine/executor.py`` — per-tick records (time, duration, row totals)
  plus run start/end/error;
- ``parallel/cluster.py`` — mesh-broken reasons (peer death attribution);
- ``chaos/injector.py`` — every fired injection, written *before* the
  fault executes, so a chaos SIGKILL is self-documenting.

Ring format: a 64-byte header (magic, version, capacity, head, wrapped,
process id, os pid, run id) followed by ``capacity`` bytes of ring data
holding newline-delimited JSON records. Harvest linearizes the ring from
the head and drops unparseable boundary lines (a torn record at the wrap
point, a record cut mid-write by SIGKILL) — forensics never raise.

Copy of ``pathway_tpu/observability/flightrecorder.py``.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
import threading
import time
from typing import Any

__all__ = [
    "FlightRecorder",
    "get_recorder",
    "harvest",
    "ring_path",
]

_MAGIC = b"PWFLIGHT"
#: magic, version, capacity, head, wrapped, process_id, os_pid, run_id
_HDR = struct.Struct("<8s6I16s")
_HDR_SIZE = 64
_VERSION = 1
_DEFAULT_RING_KB = 256


def ring_path(flight_dir: str, process_id: int) -> str:
    return os.path.join(flight_dir, f"flight-p{process_id}.ring")


class FlightRecorder:
    """Fixed-size mmap ring of JSON-line records; thread-safe, never
    raises out of :meth:`record` — the black box must not fail (or slow
    down by raising into) the run it observes."""

    def __init__(
        self,
        path: str,
        capacity_bytes: int = _DEFAULT_RING_KB * 1024,
        process_id: int = 0,
        run_id: str = "",
    ):
        self.path = path
        self._cap = max(4096, int(capacity_bytes))
        self.process_id = process_id
        self.run_id = run_id
        self._lock = threading.Lock()
        self._head = 0
        self._wrapped = 0
        self.records_written = 0
        self._closed = False
        fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
        try:
            os.ftruncate(fd, _HDR_SIZE + self._cap)
            self._mm = mmap.mmap(fd, _HDR_SIZE + self._cap)
        finally:
            os.close(fd)
        self._write_header()

    def _write_header(self) -> None:
        _HDR.pack_into(
            self._mm,
            0,
            _MAGIC,
            _VERSION,
            self._cap,
            self._head,
            self._wrapped,
            self.process_id,
            os.getpid() & 0xFFFFFFFF,
            self.run_id.encode()[:16].ljust(16, b"\0"),
        )

    def record(self, kind: str, **fields: Any) -> None:
        """Append one record; timestamps are unix seconds so bundles read
        directly. Oversized or unserializable records are dropped, I/O
        errors are swallowed — see class docstring."""
        if self._closed:
            return
        try:
            rec = {"t": round(time.time(), 4), "kind": kind, **fields}
            line = (json.dumps(rec, default=str) + "\n").encode()
        except (TypeError, ValueError):
            return
        if len(line) >= self._cap:
            return
        try:
            with self._lock:
                head, cap = self._head, self._cap
                end = head + len(line)
                if end <= cap:
                    self._mm[_HDR_SIZE + head : _HDR_SIZE + end] = line
                    if end == cap:
                        # head resets to 0 below — without the wrap flag a
                        # harvest would read data[:0] and lose the full ring
                        self._wrapped = 1
                else:
                    first = cap - head
                    self._mm[_HDR_SIZE + head : _HDR_SIZE + cap] = line[:first]
                    self._mm[_HDR_SIZE : _HDR_SIZE + end - cap] = line[first:]
                    self._wrapped = 1
                self._head = end % cap
                self.records_written += 1
                # header updated after the payload: a harvest that races a
                # write sees the previous consistent head at worst
                self._write_header()
        except (ValueError, OSError):
            pass

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            try:
                self._mm.flush()
                self._mm.close()
            except (ValueError, OSError):
                pass


def harvest(path: str) -> dict:
    """Read a ring file (live, crashed, or torn) into
    ``{process_id, pid, run_id, wrapped, records}``; unparseable boundary
    lines (wrap-point garbage, a record cut mid-write) are skipped.
    Raises ``OSError``/``ValueError`` only for a missing or non-ring file."""
    with open(path, "rb") as f:
        blob = f.read()
    if len(blob) < _HDR_SIZE or not blob.startswith(_MAGIC):
        raise ValueError(f"{path!r} is not a flight-recorder ring")
    (_, version, cap, head, wrapped, process_id, pid, run_id) = _HDR.unpack_from(
        blob, 0
    )
    data = blob[_HDR_SIZE : _HDR_SIZE + cap]
    head = min(head, len(data))
    buf = data[head:] + data[:head] if wrapped else data[:head]
    records: list[dict] = []
    for line in buf.split(b"\n"):
        if not line or b"\0" in line:
            continue
        try:
            rec = json.loads(line)
        except (json.JSONDecodeError, UnicodeDecodeError, ValueError):
            continue  # torn boundary record
        if isinstance(rec, dict):
            records.append(rec)
    return {
        "path": path,
        "version": version,
        "process_id": process_id,
        "pid": pid,
        "run_id": run_id.rstrip(b"\0").decode(errors="replace"),
        "wrapped": bool(wrapped),
        "records": records,
    }


_active: FlightRecorder | None = None
_env_sig: tuple | None = None
#: arm/re-arm must be serialized: callers include concurrent ClusterComm
#: reader threads (_break) and chaos sites — an unlocked first call could
#: mmap the same ring twice with independent write heads
_arm_lock = threading.Lock()


def get_recorder() -> FlightRecorder | None:
    """The process's flight recorder, armed from ``PATHWAY_FLIGHT_DIR``
    (``pathway-tpu spawn --supervise`` sets a default; any run may opt in).
    Re-reads the environment like the chaos injector's ``current()``, so a
    test that flips the env gets a fresh ring instead of a stale one."""
    global _active, _env_sig
    sig = (
        os.environ.get("PATHWAY_FLIGHT_DIR"),
        os.environ.get("PATHWAY_PROCESS_ID", "0"),
        os.environ.get("PATHWAY_RESTART_COUNT", "0"),
    )
    if sig == _env_sig:
        return _active
    with _arm_lock:
        if sig == _env_sig:  # another thread armed while we waited
            return _active
        if _active is not None:
            _active.close()
            _active = None
        flight_dir = sig[0]
        if not flight_dir:
            _env_sig = sig
            return None
        try:
            process_id = int(sig[1] or 0)
        except ValueError:
            process_id = 0
        try:
            size_kb = int(
                os.environ.get(
                    "PATHWAY_FLIGHT_RING_KB", str(_DEFAULT_RING_KB)
                )
            )
        except ValueError:
            size_kb = _DEFAULT_RING_KB
        try:
            os.makedirs(flight_dir, exist_ok=True)
            _active = FlightRecorder(
                ring_path(flight_dir, process_id),
                capacity_bytes=size_kb * 1024,
                process_id=process_id,
                run_id=os.environ.get("PATHWAY_RUN_ID", ""),
            )
            _active.record(
                "recorder.start",
                process=process_id,
                generation=int(sig[2] or 0),
            )
        except (OSError, ValueError) as e:
            import warnings

            warnings.warn(
                f"flight recorder disabled ({e})", RuntimeWarning
            )
            _active = None
        # publish the signature only after the recorder is fully built, so
        # a racing lock-free fast-path read never sees a half-armed state
        _env_sig = sig
        return _active
