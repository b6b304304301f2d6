"""Host-side arrangements (indexed operator state).

The reference keeps operator state in differential-dataflow *arrangements*
(shared, multiversioned indexes). Here stateful operators keep consolidated
host-side indexes keyed by the 64-bit keyspace; dense numeric per-group state
(sums/counts) additionally lives in numpy arrays so reducer updates run as
vectorized segment ops.

Copy of ``pathway_tpu/engine/state.py``.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator

import numpy as np

from .delta import Delta, column_of_values, rows_equal

__all__ = ["RowState", "MultiIndex"]


class RowState:
    """key -> row (a table: each key has exactly one current row).

    Supports multiplicity bookkeeping so out-of-order retract/insert within a
    tick stays consistent (counts other than 0/1 indicate an upstream bug and
    raise on read).
    """

    def __init__(self, columns: list[str]):
        self.columns = columns
        self._rows: dict[int, tuple] = {}
        self._counts: dict[int, int] = {}

    def __len__(self) -> int:
        return len(self._rows)

    def __contains__(self, key: int) -> bool:
        return self._counts.get(key, 0) > 0

    def get(self, key: int) -> tuple | None:
        if self._counts.get(key, 0) > 0:
            return self._rows[key]
        return None

    def apply(self, delta: Delta) -> None:
        # Net out per (key, row) first — a delta may carry both the retract
        # of the old row and the insert of the new one in any order.
        per_key: dict[int, list[list]] = {}
        for key, row, diff in delta.iter_rows():
            entries = per_key.setdefault(key, [])
            for e in entries:
                if rows_equal(e[0], row):
                    e[1] += diff
                    break
            else:
                entries.append([row, diff])
        for key, entries in per_key.items():
            if self._counts.get(key, 0) > 0:
                cur = self._rows[key]
                for e in entries:
                    if rows_equal(e[0], cur):
                        e[1] += 1
                        break
                else:
                    entries.append([cur, 1])
            positive = [e for e in entries if e[1] > 0]
            if any(e[1] < 0 for e in entries) or len(positive) > 1 or any(
                e[1] > 1 for e in positive
            ):
                raise ValueError(
                    f"inconsistent multiplicity for key {key} "
                    "(table keys must be unique and diffs consistent)"
                )
            if positive:
                self._rows[key] = positive[0][0]
                self._counts[key] = 1
            else:
                self._rows.pop(key, None)
                self._counts.pop(key, None)

    def iter_items(self) -> Iterator[tuple[int, tuple]]:
        for k, c in self._counts.items():
            if c > 0:
                yield k, self._rows[k]

    def as_delta(self) -> Delta:
        items = list(self.iter_items())
        keys = np.array([k for k, _ in items], dtype=np.uint64)
        data = {
            name: column_of_values([row[i] for _, row in items])
            for i, name in enumerate(self.columns)
        }
        return Delta(keys=keys, data=data)


class MultiIndex:
    """index_key -> {row_key: [[row, count], ...]} — a join/groupby arrangement.

    ``index_key`` is the exchange key (join key / group key); many rows may
    share it. Rows are identified by their own row key. A row key may
    transiently hold two entries within a tick (the retract of the old row
    and the insert of the new one arrive in arbitrary order after
    consolidation), so entries net by row VALUE, never by key alone.
    """

    def __init__(self, columns: list[str]):
        self.columns = columns
        self._index: dict[int, dict[int, list[list]]] = {}

    def __len__(self) -> int:
        return len(self._index)

    def group(self, index_key: int) -> dict[int, list[list]]:
        return self._index.get(index_key, {})

    def group_keys(self) -> Iterator[int]:
        return iter(self._index.keys())

    def apply_one(self, index_key: int, row_key: int, row: tuple, diff: int) -> None:
        grp = self._index.get(index_key)
        if grp is None:
            grp = {}
            self._index[index_key] = grp
        entries = grp.get(row_key)
        if entries is None:
            grp[row_key] = [[row, diff]]
        else:
            for e in entries:
                if rows_equal(e[0], row):
                    e[1] += diff
                    if e[1] == 0:
                        entries.remove(e)
                    break
            else:
                entries.append([row, diff])
            if not entries:
                del grp[row_key]
        if not grp:
            del self._index[index_key]

    def apply(self, index_keys: np.ndarray, delta: Delta) -> None:
        cols = list(delta.data.values())
        for i in range(len(delta)):
            row = tuple(c[i] for c in cols)
            self.apply_one(
                int(index_keys[i]), int(delta.keys[i]), row, int(delta.diffs[i])
            )

    def iter_group_rows(self, index_key: int) -> Iterator[tuple[int, tuple, int]]:
        for row_key, entries in self.group(index_key).items():
            for row, count in entries:
                yield row_key, row, count

    def total_count(self, index_key: int) -> int:
        return sum(c for _, _, c in self.iter_group_rows(index_key))
