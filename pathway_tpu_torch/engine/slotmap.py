"""SlotMap — dense slot ids for uint64 keys, batch-vectorized.

The reference engine holds per-key operator state in differential
arrangements (indexed batches); here keyed state lives in columnar numpy
arrays indexed by a dense *slot* id per key. The key→slot map is the native
open-addressing ``KeyTable`` (``native/native.c``; slot assignment order:
first occurrence wins). A ``SlotMap`` belongs to one operator, so to one
worker thread.

Copy of ``pathway_tpu/engine/slotmap.py``. Its dict path is
:class:`SlotMapPlain`, the plain version that the tests hold the native
table against (the same slot order); nothing else uses it.
"""

from __future__ import annotations

import numpy as np

from ..native import load as _native

__all__ = ["SlotMap", "SlotMapPlain"]


class SlotMap:
    def __init__(self) -> None:
        self._table = _native().KeyTable()

    def __len__(self) -> int:
        return len(self._table)

    def lookup_or_insert(self, keys: np.ndarray) -> tuple[np.ndarray, int]:
        """Slot per key (dense ids in first-seen order); returns
        (slots int64[n], n_new)."""
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        out = np.empty(len(keys), dtype=np.int64)
        n_new = self._table.lookup_or_insert(keys, out)
        return out, n_new

    def lookup(self, keys: np.ndarray) -> np.ndarray:
        """Slot per key; -1 where absent."""
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        out = np.empty(len(keys), dtype=np.int64)
        self._table.lookup(keys, out)
        return out

    @classmethod
    def rebuild(cls, keys_in_slot_order: np.ndarray) -> "SlotMap":
        """A map whose slot assignment follows ``keys_in_slot_order`` (the
        arena's compaction renumbers live groups this way)."""
        m = cls()
        if len(keys_in_slot_order):
            slots, _ = m.lookup_or_insert(
                np.asarray(keys_in_slot_order, dtype=np.uint64)
            )
            if slots[-1] != len(keys_in_slot_order) - 1:
                raise ValueError("SlotMap.rebuild: keys repeat")
        return m


class SlotMapPlain(SlotMap):
    """The plain version of :class:`SlotMap`: a Python dict."""

    def __init__(self) -> None:
        self._dict: dict[int, int] = {}

    def __len__(self) -> int:
        return len(self._dict)

    def lookup_or_insert(self, keys: np.ndarray) -> tuple[np.ndarray, int]:
        d = self._dict
        n_before = len(d)
        keys = np.ascontiguousarray(keys, dtype=np.uint64).tolist()
        # setdefault evaluates len(d) before inserting: a new key takes the
        # next dense id, a known key keeps its own
        out = np.fromiter((d.setdefault(k, len(d)) for k in keys), np.int64, len(keys))
        return out, len(d) - n_before

    def lookup(self, keys: np.ndarray) -> np.ndarray:
        d = self._dict
        keys = np.ascontiguousarray(keys, dtype=np.uint64).tolist()
        return np.fromiter((d.get(k, -1) for k in keys), np.int64, len(keys))
