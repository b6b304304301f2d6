"""Reducer implementations with retraction correctness.

Re-design of ``src/engine/reduce.rs:22-61``: semigroup reducers (count, sum)
keep O(1) state updated by ±diff; order-sensitive reducers (min/max/argmin/
argmax/unique/any/tuple variants) keep multisets so retractions restore the
correct next-best value — the same split the reference draws between
``SemigroupReducerImpl`` and full-state reducers.

Copy of ``pathway_tpu/engine/reducers.py``.
"""

from __future__ import annotations

from typing import Any

import numpy as np

__all__ = ["ReducerImpl", "REDUCERS", "make_reducer"]


def _encode(v: Any) -> Any:
    """Structural, hashable encoding of a value (multiset dict key)."""
    if isinstance(v, np.ndarray):
        return ("\x00nd", v.shape, str(v.dtype), v.tobytes())
    if isinstance(v, dict):
        return ("\x00d", tuple(sorted((k, _encode(x)) for k, x in v.items())))
    if isinstance(v, (list, tuple)):
        return ("\x00t", tuple(_encode(x) for x in v))
    if isinstance(v, set):
        return ("\x00s", tuple(sorted(map(_encode, v))))
    return v


class _H:
    """Unhashable value (ndarray/dict/list) boxed for multiset membership:
    hashes/orders by structural encoding, extract() unwraps the original."""

    __slots__ = ("k", "v")

    def __init__(self, v: Any):
        self.v = v
        self.k = _encode(v)

    def __hash__(self):
        return hash(self.k)

    def __eq__(self, other):
        return isinstance(other, _H) and self.k == other.k

    def _cmp(self, other) -> int:
        a = self.k
        b = other.k if isinstance(other, _H) else _encode(other)
        try:
            if a == b:
                return 0
            return -1 if a < b else 1
        except TypeError:
            # heterogeneous multiset (e.g. int vs list under min/max):
            # total-order by type name, then repr — deterministic, arbitrary
            ka, kb = (type(a).__name__, repr(a)), (type(b).__name__, repr(b))
            return -1 if ka < kb else (0 if ka == kb else 1)

    def __lt__(self, other):
        return self._cmp(other) < 0

    def __gt__(self, other):
        return self._cmp(other) > 0

    def __le__(self, other):
        return self._cmp(other) <= 0

    def __ge__(self, other):
        return self._cmp(other) >= 0

    def __repr__(self):
        return f"_H({self.v!r})"


def _hashable(v: Any) -> Any:
    if isinstance(v, (np.ndarray, dict, list, set)):
        return _H(v)
    if isinstance(v, tuple):
        # tuples are hashable only if their elements are (e.g. not a
        # tuple of dicts, which index reply columns produce)
        try:
            hash(v)
        except TypeError:
            return _H(v)
    return v


def _unwrap(v: Any) -> Any:
    return v.v if isinstance(v, _H) else v


class ReducerImpl:
    name = "reducer"

    def make(self) -> Any:
        raise NotImplementedError

    def update(self, acc: Any, values: tuple, diff: int, row_key: int, time: int) -> Any:
        raise NotImplementedError

    def extract(self, acc: Any) -> Any:
        raise NotImplementedError


class CountReducer(ReducerImpl):
    name = "count"

    def make(self):
        return 0

    def update(self, acc, values, diff, row_key, time):
        return acc + diff

    def extract(self, acc):
        return acc


class SumReducer(ReducerImpl):
    """Semigroup sum. Works for ints, floats and ndarrays (ArraySum)."""

    name = "sum"

    def make(self):
        return None

    def update(self, acc, values, diff, row_key, time):
        (v,) = values
        if isinstance(v, np.integer):
            # exact arbitrary-precision sums: np.uint64 * -1 raises under
            # numpy 2.x and wraps mod 2^64 on overflow — Python ints don't
            v = int(v)
        elif isinstance(v, np.ndarray) and v.dtype.kind == "u":
            # same for ArraySum retractions: uint_array * -1 raises
            v = v.astype(object)
        contrib = v * diff
        if acc is None:
            return contrib
        return acc + contrib

    def extract(self, acc):
        return acc


class _MultisetReducer(ReducerImpl):
    """Base: multiset of (value-ish entries) with counts."""

    def make(self):
        return {}

    def _entry(self, values: tuple, row_key: int, time: int):
        raise NotImplementedError

    def update(self, acc, values, diff, row_key, time):
        e = self._entry(values, row_key, time)
        c = acc.get(e, 0) + diff
        if c == 0:
            acc.pop(e, None)
        else:
            acc[e] = c
        return acc


class MinReducer(_MultisetReducer):
    name = "min"

    def _entry(self, values, row_key, time):
        return _hashable(values[0])

    def extract(self, acc):
        return _unwrap(min(acc.keys())) if acc else None


class MaxReducer(MinReducer):
    name = "max"

    def extract(self, acc):
        return _unwrap(max(acc.keys())) if acc else None


class ArgMinReducer(_MultisetReducer):
    name = "argmin"

    def _entry(self, values, row_key, time):
        return (_hashable(values[0]), row_key)

    def _pick(self, acc):
        return min(acc.keys()) if acc else None

    def extract(self, acc):
        e = self._pick(acc)
        return np.uint64(e[1]) if e is not None else None


class ArgMaxReducer(ArgMinReducer):
    name = "argmax"

    def _pick(self, acc):
        return max(acc.keys()) if acc else None


class UniqueReducer(_MultisetReducer):
    """Exactly-one-distinct-value reducer (errors otherwise)."""

    name = "unique"

    def _entry(self, values, row_key, time):
        return _hashable(values[0])

    def extract(self, acc):
        if not acc:
            return None
        if len(acc) > 1:
            raise ValueError(
                f"More than one distinct value passed to the unique reducer: {sorted(map(repr, acc))[:2]}"
            )
        return _unwrap(next(iter(acc.keys())))


class AnyReducer(_MultisetReducer):
    """Deterministic 'any': smallest (row_key) entry's value."""

    name = "any"

    def _entry(self, values, row_key, time):
        return (row_key, _hashable(values[0]))

    def extract(self, acc):
        if not acc:
            return None
        return _unwrap(min(acc.keys())[1])


class SortedTupleReducer(_MultisetReducer):
    name = "sorted_tuple"

    def __init__(self, skip_nones: bool = False):
        self._skip_nones = skip_nones

    def _entry(self, values, row_key, time):
        return _hashable(values[0])

    def extract(self, acc):
        items = []
        for v, c in acc.items():
            if v is None and self._skip_nones:
                continue
            items.extend([v] * c)
        return tuple(
            _unwrap(x) for x in sorted(items, key=lambda x: (x is None, x))
        )


class TupleReducer(_MultisetReducer):
    """Values ordered deterministically by source row key (the reference
    orders by the grouping source order; row-key order is our analog)."""

    name = "tuple"

    def __init__(self, skip_nones: bool = False):
        self._skip_nones = skip_nones

    def _entry(self, values, row_key, time):
        return (row_key, _hashable(values[0]))

    def extract(self, acc):
        items = []
        for (rk, v), c in sorted(acc.items(), key=lambda kv: kv[0][0]):
            if v is None and self._skip_nones:
                continue
            items.extend([_unwrap(v)] * c)
        return tuple(items)


class TupleByReducer(_MultisetReducer):
    """Tuple of values ordered by an explicit sort key (args: sort_key, value).
    Backs rank-ordered collapse in the index repack path — the analog of the
    reference's ``groupby(sort_by=...)`` + tuple reducer
    (``stdlib/indexing/data_index.py:150-165``)."""

    name = "tuple_by"

    def _entry(self, values, row_key, time):
        return ((_hashable(values[0]), row_key), _hashable(values[1]))

    def extract(self, acc):
        items = []
        for (_sk, v), c in sorted(acc.items(), key=lambda kv: kv[0][0]):
            items.extend([_unwrap(v)] * c)
        return tuple(items)


class NdarrayReducer(TupleReducer):
    name = "ndarray"

    def extract(self, acc):
        vals = super().extract(acc)
        return np.array(vals)


class EarliestReducer(_MultisetReducer):
    name = "earliest"

    def _entry(self, values, row_key, time):
        return (time, row_key, _hashable(values[0]))

    def extract(self, acc):
        if not acc:
            return None
        return _unwrap(min(acc.keys())[2])


class LatestReducer(EarliestReducer):
    name = "latest"

    def extract(self, acc):
        if not acc:
            return None
        return _unwrap(max(acc.keys())[2])


class StatefulReducer(ReducerImpl):
    """Custom python accumulator (reference ``Reducer::Stateful`` +
    ``custom_reducers.py``): combine-only (no retraction) semantics."""

    name = "stateful"

    def __init__(self, combine_fn):
        self._combine = combine_fn

    def make(self):
        return None

    def update(self, acc, values, diff, row_key, time):
        return self._combine(acc, values, diff)

    def extract(self, acc):
        return acc


class CustomAccumulatorReducer(ReducerImpl):
    """BaseCustomAccumulator-driven reducer (reference
    ``custom_reducers.py:108`` ``udf_reducer``): ``from_row`` builds a
    partial accumulator per row; ``update``/``retract`` fold them.

    Accumulators WITHOUT an overridden ``retract`` still handle
    retractions: the group's row multiset is kept alongside the
    accumulator and the fold is rebuilt from the remaining rows
    (reference custom_reducers.py:332 keeps positive_updates and
    re-folds when retract is unavailable)."""

    name = "custom_accumulator"

    def __init__(self, acc_cls):
        self._cls = acc_cls
        from ..internals.custom_reducers import BaseCustomAccumulator

        self._retractable = (
            getattr(acc_cls, "retract", None)
            is not BaseCustomAccumulator.retract
        )

    def make(self):
        return None

    def _fold(self, rows):
        acc = None
        for row in rows:
            other = self._cls.from_row(list(row))
            if acc is None:
                acc = other
            else:
                acc.update(other)
        return acc

    def update(self, acc, values, diff, row_key, time):
        count = abs(diff)
        if self._retractable:
            for _ in range(count):
                other = self._cls.from_row(list(values))
                if diff > 0:
                    if acc is None:
                        acc = other
                    else:
                        acc.update(other)
                else:
                    if acc is None:
                        raise ValueError(
                            "retract before any insert in custom reducer"
                        )
                    acc.retract(other)
            return acc
        # retract-less accumulator: (accumulator, row multiset)
        folded, rows = acc if acc is not None else (None, [])
        row = tuple(values)
        if diff > 0:
            for _ in range(count):
                rows.append(row)
                other = self._cls.from_row(list(row))
                if folded is None:
                    folded = other
                else:
                    folded.update(other)
            return (folded, rows)
        from .delta import rows_equal

        for _ in range(count):
            for i, r in enumerate(rows):
                if rows_equal(r, row):
                    del rows[i]
                    break
            else:
                raise ValueError(
                    "retraction of a row never inserted in custom reducer"
                )
        if not rows:
            return None
        return (self._fold(rows), rows)

    def extract(self, acc):
        if acc is None:
            return None
        if not self._retractable:
            acc = acc[0]
        return acc.compute_result() if acc is not None else None


REDUCERS: dict[str, type[ReducerImpl]] = {
    "count": CountReducer,
    "sum": SumReducer,
    "min": MinReducer,
    "max": MaxReducer,
    "argmin": ArgMinReducer,
    "argmax": ArgMaxReducer,
    "unique": UniqueReducer,
    "any": AnyReducer,
    "sorted_tuple": SortedTupleReducer,
    "tuple": TupleReducer,
    "tuple_by": TupleByReducer,
    "ndarray": NdarrayReducer,
    "earliest": EarliestReducer,
    "latest": LatestReducer,
}


def make_reducer(name: str, **kwargs) -> ReducerImpl:
    return REDUCERS[name](**kwargs)
