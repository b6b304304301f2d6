"""Columnar delta batches — the unit of dataflow in the engine.

Where the reference engine streams row-at-a-time ``(key, value, time, diff)``
updates through differential-dataflow operators (``src/engine/dataflow.rs``),
this engine moves **columnar batches**: a ``Delta`` is a struct-of-arrays
(numpy on the host). Diffs are ±k multiplicity weights,
exactly like differential dataflow's ``diff`` field.

Copy of ``pathway_tpu/engine/delta.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Iterator

import numpy as np

from . import keys as K

__all__ = ["Delta", "concat_deltas", "rows_to_columns", "column_of_values", "rows_equal"]


def rows_equal(a: tuple | None, b: tuple | None) -> bool:
    """ENGINE-side tuple equality: tolerates ndarray-valued cells, and two
    Error cells compare equal — the reference's engine ``Value::Error``
    implements ``Eq`` so arrangements can consolidate/retract error rows
    (value.rs); only USER-level comparisons make Error equal to nothing.
    Without this, retracting a row whose content holds an Error never
    matches the stored row and state bookkeeping breaks."""
    if a is None or b is None:
        return a is b
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            if not (
                isinstance(x, np.ndarray)
                and isinstance(y, np.ndarray)
                and x.shape == y.shape
                and bool(np.all(x == y))
            ):
                return False
        elif x != y and not (x is None and y is None):
            from .error import Error as _Err

            if not (type(x) is _Err and type(y) is _Err):
                return False
    return True


def column_of_values(values: list[Any]) -> np.ndarray:
    """Build a column array from python values, picking the densest dtype.

    Dispatches on ONE C-speed ``set(map(type, ...))`` pass instead of
    several per-value ``any``/``all`` generator scans — this sits on the
    per-row ingestion hot path (ConnectorSubject.next → rows_to_columns)."""
    if not values:
        return np.empty(0, dtype=object)
    types = set(map(type, values))
    if len(types) == 1:
        t = next(iter(types))
        if t is int:
            try:
                return np.array(values, dtype=np.int64)
            except OverflowError:
                return _object_column(values)
        if t is float:
            return np.array(values, dtype=np.float64)
        if t is bool:
            return np.array(values, dtype=np.bool_)
    if any(issubclass(t, np.generic) for t in types):
        # unwrap numpy scalars so cells extracted from dense arrays
        # (groupby/join rebuilds) re-densify instead of degrading every
        # column to object dtype
        return column_of_values(
            [v.item() if isinstance(v, np.generic) else v for v in values]
        )
    if types == {int, float}:
        return np.array(values, dtype=np.float64)
    return _object_column(values)


def _object_column(values: list[Any]) -> np.ndarray:
    out = np.empty(len(values), dtype=object)
    try:
        # C-speed bulk assignment; raises for sequence-valued cells (tuples,
        # ndarrays) that numpy would try to broadcast elementwise
        out[:] = values
    except (ValueError, TypeError):
        for i, v in enumerate(values):
            out[i] = v
    return out


@dataclass
class Delta:
    """A batch of keyed row updates: (keys[i], {col: data[col][i]}, diffs[i])."""

    keys: np.ndarray  # uint64[n]
    data: dict[str, np.ndarray] = field(default_factory=dict)  # each [n]
    diffs: np.ndarray = None  # type: ignore[assignment]  # int64[n]

    #: key provenance (engine/fusion.py content-key reuse): the ordered
    #: column names this batch's keys were derived from via
    #: ``K.mix_columns(data[c] for c in cols, salt=0)`` — set by the io
    #: ingest paths on purely content-keyed batches (no explicit keys),
    #: carried through row-subset operations, dropped by anything that
    #: changes keys or data. A groupby/join whose key expressions are
    #: exactly these column references can then reuse the row keys as
    #: group/join keys BIT-FOR-BIT instead of re-hashing the columns.
    #: Class-level default (not a dataclass field) so Deltas pickled
    #: before this attribute existed — recorded input logs, snapshots —
    #: deserialize cleanly and simply skip the fast path.
    keys_content_cols = None  # type: tuple | None

    def __post_init__(self) -> None:
        self.keys = np.asarray(self.keys, dtype=np.uint64)
        if self.diffs is None:
            self.diffs = np.ones(len(self.keys), dtype=np.int64)
        else:
            self.diffs = np.asarray(self.diffs, dtype=np.int64)

    def __len__(self) -> int:
        return len(self.keys)

    @property
    def columns(self) -> list[str]:
        return list(self.data.keys())

    @staticmethod
    def empty(columns: list[str]) -> "Delta":
        return Delta(
            keys=np.empty(0, dtype=np.uint64),
            data={c: np.empty(0, dtype=object) for c in columns},
            diffs=np.empty(0, dtype=np.int64),
        )

    def take(self, idx: np.ndarray) -> "Delta":
        out = Delta(
            keys=self.keys[idx],
            data={c: a[idx] for c, a in self.data.items()},
            diffs=self.diffs[idx],
        )
        # a row subset keeps every row's key/content relationship
        out.keys_content_cols = self.keys_content_cols
        return out

    def replace_data(self, data: dict[str, np.ndarray]) -> "Delta":
        return Delta(keys=self.keys, data=data, diffs=self.diffs)

    def with_keys(self, new_keys: np.ndarray) -> "Delta":
        return Delta(keys=new_keys, data=self.data, diffs=self.diffs)

    def negated(self) -> "Delta":
        return Delta(keys=self.keys, data=self.data, diffs=-self.diffs)

    def row(self, i: int) -> tuple:
        return tuple(self.data[c][i] for c in self.data)

    def iter_rows(self) -> Iterator[tuple[int, tuple, int]]:
        """Yield (key, row_values_tuple, diff) per entry.

        Bulk-converts each column once (``tolist`` is C-speed and yields
        plain python scalars) and zips rows in C instead of building one
        genexpr tuple per row — ~4× on the per-row API path (Subscribe
        on_change, RowState.apply)."""
        n = len(self.keys)
        if not n:
            return
        keys = self.keys.tolist()
        diffs = self.diffs.tolist()
        col_lists = [list(c) if c.dtype == object else c.tolist()
                     for c in self.data.values()]
        if len(diffs) != n:
            raise ValueError(
                f"corrupted Delta: {len(diffs)} diffs for {n} keys"
            )
        for name, col in zip(self.data, col_lists):
            if len(col) != n:
                # zip() would silently truncate a ragged (corrupted) batch
                raise ValueError(
                    f"corrupted Delta: column {name!r} has {len(col)} "
                    f"entries for {n} keys"
                )
        if not col_lists:
            for i in range(n):
                yield keys[i], (), diffs[i]
            return
        yield from zip(keys, zip(*col_lists), diffs)

    def select_columns(self, names: list[str]) -> "Delta":
        return Delta(keys=self.keys, data={n: self.data[n] for n in names}, diffs=self.diffs)

    def consolidated(self, multiset_ok: bool = False) -> "Delta":
        """Sum diffs of identical (key, row) entries; drop zero-diff entries.

        The analog of differential's ``consolidate``; output ops use it so a
        retract+insert of an unchanged row cancels out within a tick.

        Fast paths (fusion subsystem, ``PATHWAY_FUSION=0`` disables):
        an all-insertions batch can neither cancel nor go negative, so

        - with unique keys it is PROVABLY already consolidated — the
          batch returns as-is, skipping the row-signature hash + sort of
          every column (the chain-exit/sink-side cost the fusion work
          targets);
        - ``multiset_ok=True`` (engine-internal edges: the join output
          feeding downstream operators) returns it as-is even with
          duplicate keys — duplicate (key, row) entries at +1/+1 are the
          same multiset as one entry at +2, and every engine operator
          folds diffs.
        """
        if len(self) <= 1:
            if len(self) == 1 and self.diffs[0] == 0:
                return self.take(np.array([], dtype=np.int64))
            return self
        from .fusion import FUSION_STATS, fusion_enabled

        if fusion_enabled() and int(self.diffs.min()) > 0:
            if multiset_ok or K.all_unique(self.keys):
                FUSION_STATS["consolidation_skips_total"] += 1
                return self
        # asymmetric combine — a plain xor would zero out whenever row keys
        # are themselves content-derived (same mix as the row hash)
        row_sig = K.derive_pair(
            self.keys,
            K.mix_columns(list(self.data.values()), len(self), register=False),
        )
        order = np.argsort(row_sig, kind="stable")
        sig_sorted = row_sig[order]
        boundaries = np.flatnonzero(np.diff(sig_sorted) != 0) + 1
        starts = np.concatenate([[0], boundaries])
        sums = np.add.reduceat(self.diffs[order], starts)
        keep = sums != 0
        reps = order[starts[keep]]
        out = self.take(reps)
        out.diffs = sums[keep]
        return out


def concat_deltas(deltas: list[Delta], columns: list[str] | None = None) -> Delta:
    deltas = [d for d in deltas if d is not None and len(d) > 0]
    if not deltas:
        return Delta.empty(columns or [])
    if len(deltas) == 1:
        return deltas[0]
    cols = columns if columns is not None else deltas[0].columns
    out = Delta(
        keys=np.concatenate([d.keys for d in deltas]),
        data={
            c: _concat_cols([d.data[c] for d in deltas]) for c in cols
        },
        diffs=np.concatenate([d.diffs for d in deltas]),
    )
    # key provenance survives concatenation only when every part agrees
    prov = deltas[0].keys_content_cols
    if prov is not None and all(d.keys_content_cols == prov for d in deltas):
        out.keys_content_cols = prov
    return out


def _concat_cols(arrs: list[np.ndarray]) -> np.ndarray:
    if len({a.dtype for a in arrs}) > 1:
        arrs = [a.astype(object) for a in arrs]
    return np.concatenate(arrs)


def rows_to_columns(rows: list[tuple], names: list[str]) -> dict[str, np.ndarray]:
    return {
        name: column_of_values([r[i] for r in rows]) for i, name in enumerate(names)
    }
