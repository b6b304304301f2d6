"""Spill-to-disk state tier: per-process memory budget + scratch blob store.

Copy of ``pathway_tpu/engine/spill.py``. :func:`memory_snapshot` feeds the
``/metrics`` memory gauges and the signals plane (``observability/hub.py``).
Left out: the ``state.spill`` chaos site, and the ``top`` command's memory
line.

The two unbounded per-operator stores (``_SortedSide`` join runs and
groupby arenas, ``engine/operators.py``) and the key registry's cold tier
(``engine/keys.py``) spill cold segments through this module when
``PATHWAY_STATE_MEMORY_BUDGET_MB`` is set, so state larger than RAM
degrades to O(working set) disk traffic instead of an OOM kill.

Design contract:

- **Spill is a cache, snapshots are the truth.** The spill directory is
  per-process scratch; operator snapshots (``persistence/snapshots.py``)
  always materialize spilled segments back into the resident
  representation, so ``split_state``/``merge_states``, the resharder and
  recovery read spilled and resident state identically — and a SIGKILL
  mid-spill recovers from the last snapshot, never from scratch files.
- **Fail/torn writes never corrupt resident state.** A spiller drops its
  resident copy only after the blob write returns; blob writes are
  generation-versioned (new key first, old generation deleted after), so
  a torn write leaves the previous generation readable.
- **Budget enforcement is best-effort, visible, and loud.** Every spill/
  load moves counters (:func:`spill_counters`); a spill failure logs,
  counts, and leaves the state resident (the run keeps its memory, not
  its corruption).

Knobs: ``PATHWAY_STATE_MEMORY_BUDGET_MB`` (0/unset = unlimited — spill
machinery entirely disarmed, one None check per tick),
``PATHWAY_STATE_SPILL_DIR`` (scratch root; default: a per-pid directory
under the system temp dir, stale dead-pid siblings swept at startup).
"""

from __future__ import annotations

import logging
import os
import pickle
import threading
import weakref
from typing import Any

__all__ = [
    "SpillStore",
    "StateBudget",
    "get_budget",
    "spill_counters",
    "memory_snapshot",
]

log = logging.getLogger("pathway_tpu_torch.spill")

#: chunk size for spilled blobs — the operator-snapshot chunk format
#: (persistence/snapshots.py OperatorSnapshots.CHUNK_BYTES)
CHUNK_BYTES = 8 << 20

_COUNTERS = {
    "spill_events_total": 0,
    "spill_bytes_total": 0,
    "load_events_total": 0,
    "load_bytes_total": 0,
    "spill_errors_total": 0,
}
_COUNTER_LOCK = threading.Lock()


def _count(key: str, n: int = 1) -> None:
    with _COUNTER_LOCK:
        _COUNTERS[key] += n


def spill_counters() -> dict[str, int]:
    with _COUNTER_LOCK:
        return dict(_COUNTERS)


class SpillStore:
    """Generation-versioned blob store over a ``PersistenceBackend``
    scratch directory.

    A blob is pickled and written in operator-snapshot-format chunks
    under ``{name}/g{gen}/c{chunk:04d}``; the handle returned by
    :meth:`put_blob` is all a caller needs to load or drop it. Writing a
    new generation of ``name`` deletes the previous one only AFTER the
    new chunks all landed — a torn write (a crash or a failed put) leaves
    the old generation intact and the caller's resident copy untouched."""

    def __init__(self, backend: Any, worker_id: int = 0):
        self._backend = backend
        self._lock = threading.Lock()
        self._gen = 0

    def _put(self, key: str, value: bytes) -> None:
        self._backend.put_value(key, value)

    def put_blob(self, name: str, payload: Any,
                 prev: dict | None = None) -> dict:
        """Spill one payload; returns its handle. ``prev`` (an earlier
        handle for the same logical segment) is deleted after the new
        generation is fully written. Raises on write failure — the
        caller must keep its resident copy in that case."""
        blob = pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL)
        with self._lock:
            self._gen += 1
            gen = self._gen
        n_chunks = max(1, -(-len(blob) // CHUNK_BYTES))
        base = f"{name}/g{gen}"
        for c in range(n_chunks):
            self._put(
                f"{base}/c{c:04d}",
                blob[c * CHUNK_BYTES:(c + 1) * CHUNK_BYTES],
            )
        handle = {"key": base, "chunks": n_chunks, "bytes": len(blob)}
        _count("spill_events_total")
        _count("spill_bytes_total", len(blob))
        if prev is not None:
            self.drop_blob(prev)
        return handle

    def get_blob(self, handle: dict) -> Any:
        blob = b"".join(
            self._backend.get_value(f"{handle['key']}/c{c:04d}")
            for c in range(handle["chunks"])
        )
        _count("load_events_total")
        _count("load_bytes_total", len(blob))
        return pickle.loads(blob)

    def drop_blob(self, handle: dict) -> None:
        for c in range(handle["chunks"]):
            try:
                self._backend.remove_key(f"{handle['key']}/c{c:04d}")
            except Exception:
                pass  # scratch cleanup is best-effort


def per_pid_scratch(root: str) -> str:
    """This process's scratch dir under ``root``: workers sharing one
    root must not collide, and a SIGKILLed process's leftovers are
    identifiable — and swept here — by pid."""
    _sweep_dead_pid_dirs(root)
    return os.path.join(root, f"p{os.getpid()}")


def _default_spill_root() -> str:
    import tempfile

    configured = os.environ.get("PATHWAY_STATE_SPILL_DIR")
    root = configured or os.path.join(
        tempfile.gettempdir(), "pathway-spill"
    )
    return per_pid_scratch(root)


def _sweep_dead_pid_dirs(root: str) -> None:
    """Best-effort removal of scratch left by dead processes (SIGKILL
    mid-spill leaves orphans; the spill tier must not leak disk)."""
    import shutil

    try:
        entries = os.listdir(root)
    except OSError:
        return
    for entry in entries:
        if not entry.startswith("p"):
            continue
        try:
            pid = int(entry[1:])
        except ValueError:
            continue
        if pid == os.getpid():
            continue
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            shutil.rmtree(os.path.join(root, entry), ignore_errors=True)
        except OSError:
            pass  # alive but not ours, or no permission to signal


class StateBudget:
    """Spillable-state budget, enforced per WORKER (each executor sheds
    its own stores until they fit ``budget_bytes``; a process running T
    worker threads holds at most T × budget resident spillable state).

    Stores implementing the spillable protocol —

    - ``spillable_bytes() -> int`` (estimated resident bytes that COULD
      move to disk),
    - ``spilled_bytes() -> int`` (bytes currently on disk), and
    - ``spill(want_bytes) -> int`` (move ~want_bytes of the coldest
      segments to the spill store; return bytes actually freed)

    — register themselves at construction; :meth:`maybe_spill` (called
    by the executor at tick boundaries) walks live stores and sheds the
    largest spillable holdings until the total fits the budget."""

    def __init__(self, budget_bytes: int, worker_id: int = 0):
        self.budget_bytes = int(budget_bytes)
        self.worker_id = worker_id
        self._stores: "weakref.WeakSet[Any]" = weakref.WeakSet()
        self._lock = threading.Lock()
        self._spill_store: SpillStore | None = None
        self._spill_dir: str | None = None
        self._warned_unspillable = False

    # -- spill store (lazy: no disk touch until the first over-budget) --

    def spill_store(self) -> SpillStore:
        with self._lock:
            if self._spill_store is None:
                from ..persistence.backends import FilesystemBackend

                self._spill_dir = _default_spill_root()
                self._spill_store = SpillStore(
                    FilesystemBackend(self._spill_dir), self.worker_id
                )
            return self._spill_store

    # -- registration ---------------------------------------------------
    #
    # The WeakSet is the process-wide METRICS view (memory_snapshot sums
    # resident/spilled bytes over it). Enforcement never walks it in a
    # live engine: each executor passes its OWN nodes' stores to
    # maybe_spill, so a worker thread never spills (and races) a store
    # another worker is probing — the budget is per-worker by contract.

    def register(self, store: Any) -> None:
        with self._lock:
            self._stores.add(store)

    def stores(self) -> list[Any]:
        with self._lock:
            return list(self._stores)

    # -- enforcement ----------------------------------------------------

    @staticmethod
    def _safe_sum(stores: list[Any], attr: str) -> int:
        total = 0
        for s in stores:
            try:
                total += int(getattr(s, attr)())
            except Exception:
                # metrics read racing the owner thread's mutation: a
                # stale/partial number, never a failed scrape
                pass
        return total

    def resident_bytes(self) -> int:
        return self._safe_sum(self.stores(), "spillable_bytes")

    def spilled_bytes(self) -> int:
        return self._safe_sum(self.stores(), "spilled_bytes")

    def maybe_spill(self, stores: list[Any] | None = None) -> int:
        """Shed state until resident spillable bytes fit the budget.
        Returns bytes freed. Never raises: a failing spill write logs,
        counts, and leaves state resident.

        ``stores`` scopes enforcement to the caller's own stores (the
        executor passes its nodes'); None falls back to every registered
        store — single-owner callers and tests only."""
        if self.budget_bytes <= 0:
            return 0
        if stores is None:
            stores = self.stores()
        sized = [(s.spillable_bytes(), s) for s in stores]
        total = sum(b for b, _ in sized)
        if total <= self.budget_bytes:
            return 0
        freed = 0
        # largest holdings first: fewest spill calls to get under budget
        for b, store in sorted(sized, key=lambda x: -x[0]):
            if total - freed <= self.budget_bytes:
                break
            want = min(b, (total - freed) - self.budget_bytes)
            if want <= 0:
                continue
            try:
                freed += int(store.spill(want))
            except Exception:
                _count("spill_errors_total")
                log.warning(
                    "spill failed for %s; state kept resident",
                    type(store).__name__, exc_info=True,
                )
        if freed == 0 and not self._warned_unspillable:
            self._warned_unspillable = True
            log.warning(
                "state memory budget (%d bytes) exceeded by resident "
                "state (%d bytes) but nothing could spill — the budget "
                "is advisory for unspillable stores",
                self.budget_bytes, total,
            )
        return freed


def collect_spillable(nodes: list[Any]) -> list[Any]:
    """The spillable stores owned by one executor's node list: groupby
    operators themselves plus each join side's arrangement. Recomputed
    per enforcement pass — restore_state swaps arrangement objects, so a
    cached list would go stale after recovery."""
    stores: list[Any] = []
    for node in nodes:
        if hasattr(node, "spillable_bytes") and hasattr(node, "spill"):
            stores.append(node)
        for field in ("_cleft", "_cright"):
            side = getattr(node, field, None)
            if side is not None and hasattr(side, "spill"):
                stores.append(side)
    return stores


_BUDGET: StateBudget | None = None
_BUDGET_RESOLVED = False
_BUDGET_LOCK = threading.Lock()


def get_budget() -> StateBudget | None:
    """The process's armed budget, or None when the knob is unset (the
    common case — resolved once, then a module-global None check)."""
    global _BUDGET, _BUDGET_RESOLVED
    if _BUDGET_RESOLVED:
        return _BUDGET
    with _BUDGET_LOCK:
        if _BUDGET_RESOLVED:
            return _BUDGET
        raw = os.environ.get("PATHWAY_STATE_MEMORY_BUDGET_MB", "")
        try:
            mb = float(raw) if raw.strip() else 0.0
        except ValueError:
            log.warning(
                "PATHWAY_STATE_MEMORY_BUDGET_MB=%r is not a number; "
                "state memory budget disabled", raw,
            )
            mb = 0.0
        if mb > 0:
            try:
                worker = int(os.environ.get("PATHWAY_PROCESS_ID", "0") or 0)
            except ValueError:
                worker = 0
            _BUDGET = StateBudget(int(mb * (1 << 20)), worker)
        _BUDGET_RESOLVED = True
        return _BUDGET


def _reset_for_tests() -> None:
    global _BUDGET, _BUDGET_RESOLVED
    with _BUDGET_LOCK:
        _BUDGET = None
        _BUDGET_RESOLVED = False
    with _COUNTER_LOCK:
        for k in _COUNTERS:
            _COUNTERS[k] = 0


# -- process memory snapshot ----------------------------------------------


def _rss_bytes() -> int:
    """Resident set size of THIS process — /proc on Linux, getrusage
    fallback elsewhere (no psutil dependency)."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * (os.sysconf("SC_PAGE_SIZE"))
    except (OSError, ValueError, IndexError):
        try:
            import resource
            import sys

            # peak (not current) RSS — the best portable fallback.
            # ru_maxrss is KiB on Linux, bytes on macOS.
            scale = 1 if sys.platform == "darwin" else 1024
            return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * scale
        except Exception:
            return 0


def memory_snapshot() -> dict[str, float]:
    """Process-wide memory/spill/registry gauges (one flat dict, all
    numeric)."""
    from . import keys as K

    out: dict[str, float] = dict(spill_counters())
    out["rss_bytes"] = float(_rss_bytes())
    budget = get_budget()
    out["state_budget_bytes"] = float(
        budget.budget_bytes if budget is not None else 0
    )
    out["state_resident_bytes"] = float(
        budget.resident_bytes() if budget is not None else 0
    )
    out["state_spilled_bytes"] = float(
        budget.spilled_bytes() if budget is not None else 0
    )
    reg = K.registry_stats()
    out["key_registry_entries"] = float(reg["entries"])
    out["key_registry_hot_entries"] = float(reg["hot_entries"])
    out["key_registry_cold_entries"] = float(reg["cold_entries"])
    out["key_registry_frozen"] = float(reg["frozen"])
    out["key_registry_spilled_total"] = float(reg["spilled_total"])
    return out
