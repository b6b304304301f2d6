"""Vectorized 128-bit keyspace for the engine.

Re-design of the reference's ``Key(u128)`` xxh3 keyspace
(``src/engine/value.rs:30-75``). Keys are derived as **128-bit values** —
two independent 64-bit lanes (LO: splitmix64 folds / BLAKE2b-8; HI:
moremur folds / the second word of BLAKE2b-16) — and the engine transports
the LO lane in numpy ``uint64`` arrays so key derivation, resharding and
grouping stay vectorized. The shard of a key is its low bits (reference
``SHARD_MASK``, ``value.rs:38``). All derivation is deterministic across
runs and processes.

Why not two-lane arrays end to end: numpy structured/void 16-byte dtypes
lose 7-20x on ``unique``/``argsort``/``tolist`` (measured on this host),
which would tax every groupby/join/consolidation tick far beyond the
<10 ms budgets the engine runs at. Instead, every key-creation batch
registers its (lo, hi) pair in a process-wide registry: two distinct 128-bit keys colliding on
the 64-bit transport lane are DETECTED and fail the run (the reference
never conflates because it keys by the full u128; we fail-stop at the
same probability scale, ~n^2/2^129 for a silent miss, instead of
~n^2/2^65 for silent conflation). Derived keys (``derive``/
``derive_pair`` salts) occupy structurally disjoint salted domains and
are not re-registered. The registry is bounded
(``PATHWAY_KEY_REGISTRY_CAP`` entries, default 4M): at cap a batch with an
unknown key raises unless a spill directory takes it into the cold tier, or
``PATHWAY_KEY_REGISTRY_OVERFLOW=allow`` lets new keys pass unchecked.

Copy of ``pathway_tpu/engine/keys.py``. Object columns, row tuples and
ingest columns hash in the port's native module (``pathway_tpu_torch/native``,
a copy of the reference's C extension), and the registry's table is its
``KeyRegistry``, where the reference takes them when its extension is built.
The pure-Python versions stay beside them as the plain versions that the
tests hold the native paths against, bit for bit (``*_plain``); nothing else
calls them. The registry's cold tier is the reference's: with
``PATHWAY_KEY_REGISTRY_SPILL_DIR`` (or ``PATHWAY_STATE_SPILL_DIR``) set, keys
past the cap keep their 128-bit check in hashed blobs on disk
(``_ColdKeyTier``) instead of raising. The first cap hit is logged and
recorded in the flight ring (``keyreg.cap_hit``), as the reference does.
"""

from __future__ import annotations

import hashlib
import weakref
from typing import Any, Iterable

import numpy as np

from ..native import load as _native

__all__ = [
    "KeyArray",
    "KeyCollisionError",
    "SHARD_BITS",
    "shard_of",
    "mix_columns",
    "mix_columns_fused",
    "hash_values",
    "pointer_from_ints",
    "derive",
    "derive_pair",
    "derive_scalar",
    "derive_pair_scalar",
    "ref_scalar",
]

KeyArray = np.ndarray  # alias: uint64[n]

SHARD_BITS = 16  # reference: shard = low 16 bits of the key (value.rs:38)

_GOLDEN = np.uint64(0x9E3779B97F4A7C15)
_MIX1 = np.uint64(0xBF58476D1CE4E5B9)
_MIX2 = np.uint64(0x94D049BB133111EB)

# HI-lane (moremur-family) constants — independent of the LO-lane mix so
# the two lanes of a 128-bit key never co-collide
_GOLDEN_H = np.uint64(0xD1B54A32D192ED03)
_MIXH1 = np.uint64(0xAEF17502108EF2D9)
_MIXH2 = np.uint64(0xD1342543DE82EF95)
#: HI-lane seeds
_NONE_TAG_HI = 0x6E6F6E655F686921
_TUPLE_SEED_HI = 0xD1B5
_ROW_SEED_HI = 0xE7037ED1A0B428DB


def _splitmix(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer — full-avalanche 64-bit mix."""
    with np.errstate(over="ignore"):
        x = (x + _GOLDEN).astype(np.uint64)
        x = (x ^ (x >> np.uint64(30))) * _MIX1
        x = (x ^ (x >> np.uint64(27))) * _MIX2
        x = x ^ (x >> np.uint64(31))
    return x


def _splitmix2(x: np.ndarray) -> np.ndarray:
    """Vectorized HI-lane finalizer."""
    with np.errstate(over="ignore"):
        x = (x + _GOLDEN_H).astype(np.uint64)
        x = (x ^ (x >> np.uint64(32))) * _MIXH1
        x = (x ^ (x >> np.uint64(29))) * _MIXH2
        x = x ^ (x >> np.uint64(32))
    return x


def shard_of(keys: KeyArray, num_shards: int) -> np.ndarray:
    """Route each key to a worker shard by its low bits."""
    return (keys & np.uint64((1 << SHARD_BITS) - 1)).astype(np.int64) % num_shards


#: per-array hash memo: the SAME column array object commonly gets hashed
#: several times per tick (ingestion row keys, groupby routing, exchange
#: specs), and string hashing dominates the stream hot path. Keyed by
#: id() with a weakref liveness guard (ids recycle); columns are
#: immutable by engine convention.
_OBJ_HASH_CACHE: dict[int, tuple] = {}
_OBJ_HASH_CACHE_MIN_ROWS = 128
_OBJ_HASH_CACHE_MAX = 64

#: value-level string digest memos consumed by the native kernels: the
#: stream hot path hashes the same (equal-valued) words every tick, and a
#: dict probe replaces the BLAKE2b digest(s). Bounded in C (cleared at
#: 64k entries).
_STR_MEMO: dict = {}
_STR_MEMO2: dict = {}


def _hash_object_column(col: np.ndarray) -> np.ndarray:
    cache_key = None
    if len(col) >= _OBJ_HASH_CACHE_MIN_ROWS:
        cache_key = id(col)
        hit = _OBJ_HASH_CACHE.get(cache_key)
        if hit is not None and hit[0]() is col:
            return hit[1]

    out = np.empty(len(col), dtype=np.uint64)
    _native().hash_scalars(list(col), _hash_scalar, out, _STR_MEMO)
    if cache_key is not None:
        try:
            # callback evicts promptly when the column is collected — no
            # dead entries pinning big hash arrays in a long-lived stream
            ref = weakref.ref(
                col, lambda _r, k=cache_key: _OBJ_HASH_CACHE.pop(k, None)
            )
        except TypeError:
            return out
        if len(_OBJ_HASH_CACHE) >= _OBJ_HASH_CACHE_MAX:
            _OBJ_HASH_CACHE.clear()  # bounded: reset rather than grow
        out.flags.writeable = False  # shared across callers from now on
        _OBJ_HASH_CACHE[cache_key] = (ref, out)
    return out


def _hash_object_column_plain(col: np.ndarray) -> np.ndarray:
    """The plain version of :func:`_hash_object_column` (no cache, no memo)."""
    return np.fromiter((_hash_scalar(v) for v in col), np.uint64, len(col))


_OBJ_HASH2_CACHE: dict[int, tuple] = {}


def _hash_object_column2(col: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Both lanes of the 128-bit hash for an object column (one native
    pass; strings memoized value-wise)."""
    cache_key = None
    if len(col) >= _OBJ_HASH_CACHE_MIN_ROWS:
        cache_key = id(col)
        hit = _OBJ_HASH2_CACHE.get(cache_key)
        if hit is not None and hit[0]() is col:
            return hit[1], hit[2]

    lo = np.empty(len(col), dtype=np.uint64)
    hi = np.empty(len(col), dtype=np.uint64)
    _native().hash_scalars2(list(col), _hash_scalar, _hash_scalar_hi, _STR_MEMO2, lo, hi)
    if cache_key is not None:
        try:
            ref = weakref.ref(
                col, lambda _r, k=cache_key: _OBJ_HASH2_CACHE.pop(k, None)
            )
        except TypeError:
            return lo, hi
        if len(_OBJ_HASH2_CACHE) >= _OBJ_HASH_CACHE_MAX:
            _OBJ_HASH2_CACHE.clear()
        lo.flags.writeable = False
        hi.flags.writeable = False
        _OBJ_HASH2_CACHE[cache_key] = (ref, lo, hi)
    return lo, hi


def _hash_object_column2_plain(col: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The plain version of :func:`_hash_object_column2`."""
    lo = np.fromiter((_hash_scalar(v) for v in col), np.uint64, len(col))
    hi = np.fromiter((_hash_scalar_hi(v) for v in col), np.uint64, len(col))
    return lo, hi


_M64_ = (1 << 64) - 1


def _splitmix2_int(x: int) -> int:
    x = (x + 0xD1B54A32D192ED03) & _M64_
    x = ((x ^ (x >> 32)) * 0xAEF17502108EF2D9) & _M64_
    x = ((x ^ (x >> 29)) * 0xD1342543DE82EF95) & _M64_
    return x ^ (x >> 32)


def _hash_scalar_hi(v: Any) -> int:
    """HI lane of the 128-bit scalar hash."""
    if v is None:
        return _NONE_TAG_HI
    if isinstance(v, (bool, np.bool_)):
        return _splitmix2_int(int(v) + 0xB001)
    if isinstance(v, (int, np.integer)):
        x = (
            int(np.int64(v).view(np.uint64))
            if isinstance(v, np.integer)
            else int(v) & _M64_
        )
        return _splitmix2_int(x)
    if isinstance(v, (float, np.floating)):
        return _splitmix2_int(int(np.float64(v).view(np.uint64)))
    if isinstance(v, str):
        return _blake16hi(v.encode("utf-8"))
    if isinstance(v, bytes):
        return _blake16hi(v)
    if isinstance(v, tuple):
        acc = _TUPLE_SEED_HI
        for x in v:
            acc = _splitmix2_int(acc ^ _hash_scalar_hi(x))
        return acc
    if isinstance(v, np.ndarray):
        return _blake16hi(v.tobytes()) ^ _blake16hi(str(v.shape).encode())
    return _blake16hi(repr(v).encode("utf-8"))


def _blake16hi(data: bytes) -> int:
    """Second word of the 16-byte BLAKE2b digest — the HI string lane.
    A separate digest from the LO lane's 8-byte one (the blake2b param
    block folds digest length into the IV), so lanes are independent."""
    return int.from_bytes(
        hashlib.blake2b(data, digest_size=16).digest()[8:16], "little"
    )


def _hash_scalar(v: Any) -> int:
    if v is None:
        return 0x736E6F6E65736E6F  # fixed tag
    if isinstance(v, (bool, np.bool_)):
        # must match hash_column's dense-bool path exactly
        return int(_splitmix(np.uint64(int(v)) + np.uint64(0xB001)))
    if isinstance(v, (int, np.integer)):
        return int(_splitmix(np.uint64(np.int64(v).view(np.uint64) if isinstance(v, np.integer) else np.uint64(int(v) & 0xFFFFFFFFFFFFFFFF))))
    if isinstance(v, (float, np.floating)):
        return int(_splitmix(np.float64(v).view(np.uint64)))
    if isinstance(v, str):
        return _fnv1a(v.encode("utf-8"))
    if isinstance(v, bytes):
        return _fnv1a(v)
    if isinstance(v, tuple):
        acc = np.uint64(0x9E37)
        for x in v:
            acc = _splitmix(acc ^ np.uint64(_hash_scalar(x)))
        return int(acc)
    if isinstance(v, np.ndarray):
        return _fnv1a(v.tobytes()) ^ _fnv1a(str(v.shape).encode())
    # datetimes, Json wrappers, arbitrary objects
    return _fnv1a(repr(v).encode("utf-8"))


def _fnv1a(data: bytes) -> int:
    # C-speed 64-bit digest over bytes (blake2b-8); name kept for history.
    return int.from_bytes(hashlib.blake2b(data, digest_size=8).digest(), "little")


def hash_column(col: np.ndarray) -> np.ndarray:
    """Hash one column of values to uint64, vectorized for numeric dtypes.
    Narrow dtypes widen first so a value hashes identically whatever width
    it arrived in (int32 5 == int 5 — matches ``_hash_scalar``)."""
    if col.dtype == np.uint64:
        return _splitmix(col)
    if col.dtype == np.int64:
        return _splitmix(col.view(np.uint64))
    if col.dtype == np.float64:
        return _splitmix(col.view(np.uint64))
    if col.dtype == np.bool_:
        return _splitmix(col.astype(np.uint64) + np.uint64(0xB001))
    if col.dtype.kind in ("i", "u"):
        return _splitmix(col.astype(np.int64).view(np.uint64))
    if col.dtype.kind == "f":
        return _splitmix(col.astype(np.float64).view(np.uint64))
    return _hash_object_column(col)


def _column_lanes(col: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(LO, HI) lanes of one column's 128-bit hashes, vectorized."""
    if col.dtype == np.uint64:
        return _splitmix(col), _splitmix2(col)
    if col.dtype == np.int64:
        u = col.view(np.uint64)
        return _splitmix(u), _splitmix2(u)
    if col.dtype == np.float64:
        u = col.view(np.uint64)
        return _splitmix(u), _splitmix2(u)
    if col.dtype == np.bool_:
        u = col.astype(np.uint64) + np.uint64(0xB001)
        return _splitmix(u), _splitmix2(u)
    if col.dtype.kind in ("i", "u"):
        u = col.astype(np.int64).view(np.uint64)
        return _splitmix(u), _splitmix2(u)
    if col.dtype.kind == "f":
        u = col.astype(np.float64).view(np.uint64)
        return _splitmix(u), _splitmix2(u)
    return _hash_object_column2(col)


#: reserved join-key sentinel for rows whose key expression evaluated to an
#: Error: deterministic (retraction-consistent) yet never entered into join
#: state — the Join node drops sentinel rows with a log entry, so Error
#: keys match nothing, including each other (reference: Error == nothing)
ERROR_KEY = np.uint64(0xE707_0E0E_DEAD_0001)


class KeyCollisionError(RuntimeError):
    """Two distinct 128-bit keys collided on the 64-bit transport lane.

    Probability ~n^2/2^65 per creation domain; the reference keys by the
    full u128 (value.rs:30-47) and never conflates — we fail-stop instead
    of silently merging two rows' state."""


_REGISTRY = None
#: THREAD-LOCAL suspension: while the executor running on THIS thread has
#: a stateless dataflow (no keyed operator state — nothing two conflated
#: keys could corrupt), key creation skips the registry probe, which
#: costs ~150ns/row of random DRAM access on unique-key streams. Thread-
#: local (not process-global) so a concurrent STATEFUL run on another
#: thread — e.g. a threaded REST server's pipeline — keeps the full
#: 128-bit fail-stop guarantee (review finding). Managed by
#: engine/executor.py; key creation happens on the executor's own thread
#: (source polls, ticks), so the thread is the right scope.
import threading as _threading

_suspend_local = _threading.local()


def _registration_suspended_here() -> bool:
    return getattr(_suspend_local, "n", 0) > 0


def _suspend_registration(delta: int) -> None:
    _suspend_local.n = getattr(_suspend_local, "n", 0) + delta


class KeyRegistryOverflowError(RuntimeError):
    """The key registry hit ``PATHWAY_KEY_REGISTRY_CAP`` with no spill
    path configured. Silently downgrading to 64-bit collision safety at
    exactly the scale where 128-bit detection matters is the one thing
    this error exists to prevent: either point
    ``PATHWAY_KEY_REGISTRY_SPILL_DIR`` (or ``PATHWAY_STATE_SPILL_DIR``)
    at scratch disk to keep full detection past the cap, raise the cap,
    or set ``PATHWAY_KEY_REGISTRY_OVERFLOW=allow`` to accept the old
    freeze-open behavior explicitly."""


def _overflow_error(cap: int) -> KeyRegistryOverflowError:
    return KeyRegistryOverflowError(
        f"key registry is full ({cap} keys, "
        "PATHWAY_KEY_REGISTRY_CAP) and no spill path is configured: "
        "refusing to silently degrade 128-bit conflation detection. Set "
        "PATHWAY_KEY_REGISTRY_SPILL_DIR (or PATHWAY_STATE_SPILL_DIR) to "
        "spill cold entries to disk, raise the cap, or set "
        "PATHWAY_KEY_REGISTRY_OVERFLOW=allow to let new keys pass "
        "unchecked."
    )


class _ColdKeyTier:
    """Disk-backed LO→HI map for keys past the hot-table cap.

    Hash-bucketed (top 8 bits of the LO lane → 256 buckets) pickled
    dicts written through :class:`engine.spill.SpillStore` (the
    persistence-backend interface) with write-behind batching: probes check the in-memory pending tier, then
    a small loaded-bucket LRU, then the bucket file. Only keys the hot
    tier MISSES ever reach here, so the common case past the cap is one
    numpy mask check per batch."""

    N_BUCKETS = 256
    _FLUSH_TOTAL = 65536  # pending entries across buckets → write-behind
    _CACHE_BUCKETS = 4

    def __init__(self, store):
        self._store = store  # engine.spill.SpillStore
        self._pending: dict[int, dict[int, int]] = {}
        self._pending_n = 0
        #: bucket id -> blob handles, oldest first: one base blob plus a
        #: tail of per-flush delta blobs (folded by :meth:`_compact`)
        self._handles: dict[int, list[dict]] = {}
        #: tiny LRU of loaded (merged) bucket dicts
        self._cache: dict[int, dict[int, int]] = {}
        self.total = 0  # entries owned by the cold tier (pending + disk)

    @staticmethod
    def _bucket(lo: int) -> int:
        return (lo >> 56) & 0xFF

    def _load_bucket(self, b: int) -> dict[int, int]:
        cached = self._cache.get(b)
        if cached is not None:
            self._cache[b] = self._cache.pop(b)  # refresh LRU recency
            return cached
        loaded: dict[int, int] = {}
        for handle in self._handles.get(b, ()):
            loaded.update(self._store.get_blob(handle))
        if len(self._cache) >= self._CACHE_BUCKETS:
            self._cache.pop(next(iter(self._cache)))
        self._cache[b] = loaded
        return loaded

    def register(self, lo: list[int], hi: list[int]) -> int:
        """Probe/insert (lo, hi) pairs; returns a conflicting index (the
        smallest found) or -1. The batch is grouped by bucket so each
        bucket's blobs load at most once per batch — per-key loads would
        make cold-tier ingest quadratic with only a 4-bucket cache.
        Insertions are write-behind — they live in the pending tier
        until the next flush."""
        by_bucket: dict[int, list[int]] = {}
        for i, l in enumerate(lo):
            by_bucket.setdefault(self._bucket(l), []).append(i)
        conflict = -1
        for b in sorted(by_bucket):
            pend = self._pending.get(b)
            disk = None  # loaded lazily, once per bucket per batch
            for i in by_bucket[b]:
                l, h = lo[i], hi[i]
                cur = pend.get(l) if pend is not None else None
                if cur is None:
                    if disk is None:
                        disk = self._load_bucket(b)
                    cur = disk.get(l)
                if cur is None:
                    if pend is None:
                        pend = self._pending[b] = {}
                    pend[l] = h
                    self._pending_n += 1
                    self.total += 1
                elif cur != h:
                    # the run dies on any conflict; keys inserted after
                    # it in other buckets are moot, so the rest of THIS
                    # bucket is simply skipped
                    if conflict < 0 or i < conflict:
                        conflict = i
                    break
        if conflict >= 0:
            return conflict
        if self._pending_n >= self._FLUSH_TOTAL:
            self.flush()
        return -1

    def flush(self) -> None:
        """Write-behind flush: each dirty bucket's pending entries go to
        disk as one DELTA blob (LSM-style — rewriting the whole bucket
        per flush would make ingest I/O quadratic in cold-tier size);
        :meth:`_compact` folds a bucket when its delta tail outweighs the
        base, so every entry is rewritten O(log n) times total. A failed
        write keeps that bucket's entries pending — resident state stays
        authoritative, nothing is lost."""
        for b in sorted(self._pending):
            pend = self._pending[b]
            if not pend:
                continue
            try:
                handle = self._store.put_blob(f"kreg/b{b:02x}", pend)
            except Exception:
                from .spill import _count, log as _slog

                _count("spill_errors_total")
                _slog.warning(
                    "key-registry cold bucket %02x flush failed; "
                    "%d entr(ies) stay pending in memory",
                    b, len(pend), exc_info=True,
                )
                continue
            handles = self._handles.setdefault(b, [])
            handles.append(handle)
            cached = self._cache.get(b)
            if cached is not None:
                cached.update(pend)
            self._pending_n -= len(pend)
            self._pending[b] = {}
            self._compact(b)

    def _compact(self, b: int) -> None:
        """Fold a bucket's base + deltas into one blob once the delta
        tail has grown to the base's size (geometric trigger) or the
        handle list is long enough to tax probes. Failure keeps the
        delta handles — the merged view is unchanged either way."""
        handles = self._handles.get(b, [])
        if len(handles) < 2:
            return
        delta_bytes = sum(h["bytes"] for h in handles[1:])
        if delta_bytes < handles[0]["bytes"] and len(handles) < 16:
            return
        merged = self._load_bucket(b)
        try:
            base = self._store.put_blob(f"kreg/b{b:02x}", merged)
        except Exception:
            from .spill import _count, log as _slog

            _count("spill_errors_total")
            _slog.warning(
                "key-registry cold bucket %02x compaction failed; "
                "keeping %d delta blob(s)", b, len(handles) - 1,
                exc_info=True,
            )
            return
        for h in handles:
            self._store.drop_blob(h)
        self._handles[b] = [base]


class _KeyRegistry:
    """The process-wide LO -> HI lane map: the native ``KeyRegistry`` as
    the hot table, bounded at ``cap`` entries, with the reference's
    ``_TwoTierRegistry`` behaviour past it. ``register_overflow`` flags the
    keys a full table does not hold; then

    - ``allow`` → they pass unchecked (64-bit collision safety only);
    - a ``spill_dir`` → they keep the full 128-bit check in the disk-backed
      :class:`_ColdKeyTier`;
    - otherwise → :class:`KeyRegistryOverflowError`.

    Registration runs concurrently from sharded worker threads. One native
    ``register_overflow`` call never releases the interpreter's lock, so it
    is one critical section; the cold tier's probe-and-insert runs under
    its own lock. Either way no two threads can insert two different HI
    lanes for one LO lane."""

    def __init__(self, cap: int, allow: bool, spill_dir: str | None = None):
        self._hot = _native().KeyRegistry(cap)
        self._cap = cap
        self._allow = allow
        self._spill_dir = spill_dir
        self._cold: _ColdKeyTier | None = None
        self._cold_lock = _threading.Lock()
        self._cap_hit_announced = False
        self.spilled_total = 0  # keys ever routed to the cold tier

    @property
    def frozen(self) -> bool:
        return bool(self._hot.stats()[1])

    @property
    def mode(self) -> str:
        if self._allow:
            return "allow"
        return "spill" if self._spill_dir is not None else "error"

    def _announce_cap_hit(self) -> None:
        if self._cap_hit_announced:
            return
        self._cap_hit_announced = True
        import logging

        what = {
            "spill": (
                "spilling cold entries to %r — 128-bit conflation "
                "detection continues past the cap" % self._spill_dir
            ),
            "allow": (
                "PATHWAY_KEY_REGISTRY_OVERFLOW=allow: detection is "
                "FROZEN to the first %d keys; new keys pass unchecked "
                "(64-bit collision safety only)" % self._hot.stats()[0]
            ),
            "error": "no spill path configured — refusing new keys",
        }[self.mode]
        logging.getLogger("pathway_tpu_torch.keys").warning(
            "key registry reached PATHWAY_KEY_REGISTRY_CAP (%d): %s",
            self._cap, what,
        )
        from ..observability.flightrecorder import get_recorder

        rec = get_recorder()
        if rec is not None:
            rec.record(
                "keyreg.cap_hit",
                cap=self._cap,
                mode=self.mode,
                entries=self._hot.stats()[0],
            )

    def register(self, lo: np.ndarray, hi: np.ndarray) -> int:
        """Index of the first pair whose LO lane is known under another HI
        lane, or -1. ``lo`` and ``hi`` are contiguous uint64."""
        miss = np.zeros(len(lo), dtype=np.uint8)
        idx = self._hot.register_overflow(lo, hi, miss)
        if idx >= 0:
            return int(idx)
        if not miss.any():
            return -1
        # the hot table is frozen and this batch carries unknown keys
        self._announce_cap_hit()
        if self._allow:
            return -1
        if self._spill_dir is None:
            raise _overflow_error(self._cap)
        mix = np.flatnonzero(miss)
        with self._cold_lock:
            if self._cold is None:
                from ..persistence.backends import FilesystemBackend
                from .spill import SpillStore

                self._cold = _ColdKeyTier(
                    SpillStore(FilesystemBackend(self._spill_dir))
                )
            before = self._cold.total
            cold_idx = self._cold.register(lo[mix].tolist(), hi[mix].tolist())
            # keys newly owned by the cold tier, not probe traffic
            self.spilled_total += self._cold.total - before
        if cold_idx >= 0:
            return int(mix[cold_idx])
        return -1

    def stats(self) -> tuple[int, int]:
        size, frozen = self._hot.stats()
        cold = self._cold.total if self._cold is not None else 0
        return size + cold, int(frozen)

    def detailed_stats(self) -> dict:
        size, frozen = self._hot.stats()
        cold = self._cold.total if self._cold is not None else 0
        return {
            "entries": size + cold,
            "hot_entries": size,
            "cold_entries": cold,
            "frozen": int(bool(frozen) and self._allow),
            "spilled_total": self.spilled_total,
            "cap": self._cap,
            "mode": self.mode,
        }


class _KeyRegistryPlain:
    """The plain version of :class:`_KeyRegistry`: a dict under a lock, with
    the same insert, freeze and overflow behaviour."""

    def __init__(self, cap: int, allow: bool):
        self._map: dict[int, int] = {}
        self._cap = cap
        self._allow = allow
        self.frozen = False
        self._lock = _threading.Lock()

    def register(self, lo: np.ndarray, hi: np.ndarray) -> int:
        missed = False
        with self._lock:
            m = self._map
            for i, (l, h) in enumerate(zip(lo.tolist(), hi.tolist())):
                cur = m.get(l)
                if cur is None:
                    if not self.frozen:
                        m[l] = h
                        if len(m) >= self._cap:
                            self.frozen = True
                    else:
                        missed = True
                elif cur != h:
                    return i
        if missed and not self._allow:
            raise _overflow_error(self._cap)
        return -1


_REGISTRY_LOCK = _threading.Lock()


def _registry_spill_dir() -> str | None:
    import os

    configured = os.environ.get("PATHWAY_KEY_REGISTRY_SPILL_DIR")
    if configured:
        # per-pid like every other spill root: processes pointed at one
        # dir must not clobber each other's bucket generations
        from .spill import per_pid_scratch

        return per_pid_scratch(configured)
    state_dir = os.environ.get("PATHWAY_STATE_SPILL_DIR")
    if state_dir:
        # ride the state spill tier's scratch root, per-pid like it does
        from .spill import per_pid_scratch

        return os.path.join(per_pid_scratch(state_dir), "keyreg")
    return None


def _get_registry() -> _KeyRegistry:
    global _REGISTRY
    if _REGISTRY is not None:
        return _REGISTRY
    with _REGISTRY_LOCK:  # worker threads may ask for it first at once
        if _REGISTRY is not None:
            return _REGISTRY
        import os

        cap = int(os.environ.get("PATHWAY_KEY_REGISTRY_CAP", 1 << 22))
        overflow = (
            os.environ.get("PATHWAY_KEY_REGISTRY_OVERFLOW", "").strip().lower()
        )
        if overflow not in ("", "allow", "error", "spill"):
            import logging

            logging.getLogger("pathway_tpu_torch.keys").warning(
                "unknown PATHWAY_KEY_REGISTRY_OVERFLOW=%r (valid: "
                "allow | error | spill); using the default cap-hit "
                "behavior (spill when a spill dir is configured, "
                "hard error otherwise)", overflow,
            )
        spill_dir = None if overflow in ("allow", "error") else _registry_spill_dir()
        _REGISTRY = _KeyRegistry(cap, overflow == "allow", spill_dir)
    return _REGISTRY


def registry_stats() -> dict:
    """Key-registry gauges; cheap, and does NOT instantiate the registry
    on an idle process."""
    reg = _REGISTRY
    if reg is None:
        return {
            "entries": 0, "hot_entries": 0, "cold_entries": 0,
            "frozen": 0, "spilled_total": 0, "cap": 0, "mode": "unarmed",
        }
    return reg.detailed_stats()


def _register_keys(lo: np.ndarray, hi: np.ndarray) -> None:
    reg = _get_registry()
    idx = reg.register(
        np.ascontiguousarray(lo, dtype=np.uint64),
        np.ascontiguousarray(hi, dtype=np.uint64),
    )
    if idx >= 0:
        raise KeyCollisionError(
            f"64-bit key-lane collision between two distinct 128-bit keys "
            f"(lane value {int(lo[idx]):#x}). Two different rows would have "
            "been silently conflated; rerun with distinct key columns or "
            "raise PATHWAY_KEY_REGISTRY_CAP if this is a re-keyed replay."
        )


def mix_columns(
    cols: list[np.ndarray], n: int, salt: int = 0, register: bool = True
) -> KeyArray:
    """Derive a key per row from the given columns (vectorized) — the
    analog of the reference's ``Key::for_values`` over its u128 space.

    Used for group keys, reindexing (``with_id_from``), pointer
    expressions and row ingestion. ``register=True`` (the default for
    identity-creating callers) computes the HI lane of the 128-bit key as
    well and registers the pair for conflation detection; sig-only callers
    (consolidation row sigs) pass ``register=False`` and pay one lane.
    """
    acc = np.full(n, np.uint64(0xA076_1D64_78BD_642F) ^ np.uint64(salt), dtype=np.uint64)
    if register and _registration_suspended_here():
        register = False
    if register:
        acc_hi = np.full(
            n, np.uint64(_ROW_SEED_HI) ^ np.uint64(salt), dtype=np.uint64
        )
        with np.errstate(over="ignore"):
            for col in cols:
                lo, hi = _column_lanes(np.asarray(col))
                acc = _splitmix(acc ^ lo)
                acc_hi = _splitmix2(acc_hi ^ hi)
        _register_keys(acc, acc_hi)
        return acc
    with np.errstate(over="ignore"):
        for col in cols:
            acc = _splitmix(acc ^ hash_column(np.asarray(col)))
    return acc


def mix_columns_fused(
    cols: list[np.ndarray], n: int, salt: int = 0, register: bool = True
) -> KeyArray:
    """Ingest-path variant of :func:`mix_columns`: when every key column
    is an OBJECT column (string-heavy sources — wordcount lines, str
    CSV keys), fold all of them through the native ``mix_cols2`` kernel
    in ONE pass: no per-column lane arrays, no row tuples, strings
    memoized value-wise. Bit-identical to ``mix_columns`` (same
    per-scalar lanes, same splitmix fold per column), which takes dense
    columns and unregistered keys. Ingest columns are freshly parsed
    buffers, so the per-array lane cache is deliberately skipped — it
    could never hit."""
    if register and _registration_suspended_here():
        register = False
    arrs = [np.asarray(c) for c in cols]
    if not register or not arrs or any(a.dtype != object for a in arrs):
        return mix_columns(arrs, n, salt, register)
    lo = np.empty(n, dtype=np.uint64)
    hi = np.empty(n, dtype=np.uint64)
    salt64 = int(salt) & _M64_
    _native().mix_cols2(
        arrs, n, salt64, salt64, _hash_scalar, _hash_scalar_hi,
        _STR_MEMO2, lo, hi,
    )
    _register_keys(lo, hi)
    return lo


def _hash_values_py(rows: list[tuple], salt: int = 0) -> KeyArray:
    base = np.uint64(0xA076_1D64_78BD_642F) ^ np.uint64(salt)
    out = []
    for row in rows:
        acc = base
        for v in row:
            acc = _splitmix(acc ^ np.uint64(_hash_scalar(v)))
        out.append(int(acc))
    return np.array(out, dtype=np.uint64)


def hash_values(
    rows: Iterable[tuple], salt: int = 0, register: bool = True
) -> KeyArray:
    """Hash python row tuples — the row-ingestion hot path, in the native
    kernel (the reference's Rust xxh3-u128 keyspace analog,
    value.rs:30-75). ``register=True`` also derives the HI lane and
    registers the 128-bit pair for conflation detection."""
    rows = rows if isinstance(rows, list) else list(rows)
    salt64 = int(salt) & _M64_
    if register and _registration_suspended_here():
        register = False
    if not register:
        out = np.empty(len(rows), dtype=np.uint64)
        _native().hash_rows(rows, salt64, _hash_scalar, out)
        return out
    lo = np.empty(len(rows), dtype=np.uint64)
    hi = np.empty(len(rows), dtype=np.uint64)
    _native().hash_rows2(
        rows, salt64, salt64, _hash_scalar, _hash_scalar_hi,
        _STR_MEMO2, lo, hi,
    )
    _register_keys(lo, hi)
    return lo


def _hash_values_plain(
    rows: Iterable[tuple], salt: int = 0, register: bool = True
) -> KeyArray:
    """The plain version of :func:`hash_values`."""
    rows = rows if isinstance(rows, list) else list(rows)
    lo = _hash_values_py(rows, salt)
    if register and _registration_suspended_here():
        register = False
    if not register:
        return lo
    hi = np.empty(len(rows), dtype=np.uint64)
    base = _ROW_SEED_HI ^ (int(salt) & _M64_)
    for i, row in enumerate(rows):
        acc = base
        for v in row:
            acc = _splitmix2_int(acc ^ _hash_scalar_hi(v))
        hi[i] = acc
    _register_keys(lo, hi)
    return lo


def pointer_from_ints(vals: np.ndarray) -> KeyArray:
    """Deterministic pointer from user-provided integer ids
    (reference: unsafe_trusted_ids / ``Key::for_value``). MUST agree with
    ``mix_columns`` over a single int column: the reference keys explicit
    markdown indices through the same value hash as ``pointer_from``, so
    ``t.ix(other.pointer_from(n))`` reaches the row indexed ``n``
    (test_common.py:817)."""
    arr = np.asarray(vals, dtype=np.int64)
    return mix_columns([arr], len(arr))


def all_unique(keys: KeyArray) -> bool:
    """True when no key repeats — O(n) native open-addressing probe
    (engine keys are already avalanche-mixed, so masked-key slots
    distribute uniformly). Used by the consolidation identity fast path
    (engine/delta.py) to prove an all-insertions batch is already
    consolidated."""
    if len(keys) < 2:
        return True
    return bool(_native().all_unique_u64(np.ascontiguousarray(keys, dtype=np.uint64)))


def all_unique_plain(keys: KeyArray) -> bool:
    """The plain version of :func:`all_unique`."""
    return len(np.unique(keys)) == len(keys)


def derive(keys: KeyArray, salt: int) -> KeyArray:
    """Derive child keys from parent keys (concat_reindex, flatten branches)."""
    return derive_each(keys, np.full(len(keys), np.uint64(salt), dtype=np.uint64))


def derive_each(keys: KeyArray, salts: np.ndarray) -> KeyArray:
    """``derive`` with a salt for each key: ``derive_each(k, s)[i] == derive(k[i:i+1], s[i])``."""
    return _splitmix(keys ^ _splitmix(salts.astype(np.uint64)))


def derive_pair(left: KeyArray, right: KeyArray) -> KeyArray:
    """Key for a joined row from the two source row keys."""
    with np.errstate(over="ignore"):
        return _splitmix(_splitmix(left) ^ (right * _GOLDEN))


# -- scalar fast paths (bit-identical to the vectorized forms above) --------
# per-row compute functions (asof/session-window recompute, join row path)
# derive one key at a time; building a 1-element ndarray per call costs ~10x
# the mix itself, so these run the same splitmix in plain int arithmetic.

_M64 = (1 << 64) - 1
# single source of truth: int views of the vectorized constants
_GOLDEN_I = int(_GOLDEN)
_MIX1_I = int(_MIX1)
_MIX2_I = int(_MIX2)


def _splitmix_int(x: int) -> int:
    x = (x + _GOLDEN_I) & _M64
    x = ((x ^ (x >> 30)) * _MIX1_I) & _M64
    x = ((x ^ (x >> 27)) * _MIX2_I) & _M64
    return x ^ (x >> 31)


def derive_scalar(key: int, salt: int) -> int:
    return _splitmix_int(key ^ _splitmix_int(salt))


def derive_pair_scalar(left: int, right: int) -> int:
    return _splitmix_int(_splitmix_int(left) ^ ((right * _GOLDEN_I) & _M64))


def ref_scalar(*values: Any, salt: int = 0) -> int:
    """Hash a single row of values — python-side ``Table.pointer_from``."""
    return int(hash_values([tuple(values)], salt=salt)[0])


def fmt_key(key: int) -> str:
    """Render a key the way pointers print (debug ``^HEX`` form)."""
    return "^" + format(int(key), "016X")
