"""``pw.reducers`` — reducer expression constructors.

Re-design of ``python/pathway/internals/reducers.py`` (723 LoC). Each call
builds a ReducerExpression; the engine implementations live in
``engine/reducers.py``.
"""

from __future__ import annotations

from typing import Any

from .internals.expression import ColumnExpression, ReducerExpression

__all__ = [
    "count",
    "sum",
    "min",
    "max",
    "argmin",
    "argmax",
    "avg",
    "unique",
    "any",
    "sorted_tuple",
    "tuple",
    "tuple_by",
    "ndarray",
    "earliest",
    "latest",
    "stateful_single",
    "stateful_many",
    "udf_reducer",
]


def count(*args: Any) -> ReducerExpression:
    return ReducerExpression("count", args)


def sum(arg: Any) -> ReducerExpression:
    return ReducerExpression("sum", (arg,))


def min(arg: Any) -> ReducerExpression:
    return ReducerExpression("min", (arg,))


def max(arg: Any) -> ReducerExpression:
    return ReducerExpression("max", (arg,))


def argmin(arg: Any) -> ReducerExpression:
    return ReducerExpression("argmin", (arg,))


def argmax(arg: Any) -> ReducerExpression:
    return ReducerExpression("argmax", (arg,))


def avg(arg: Any) -> ReducerExpression:
    return ReducerExpression("avg", (arg,))


def unique(arg: Any) -> ReducerExpression:
    return ReducerExpression("unique", (arg,))


def any(arg: Any) -> ReducerExpression:
    return ReducerExpression("any", (arg,))


def sorted_tuple(arg: Any, *, skip_nones: bool = False) -> ReducerExpression:
    return ReducerExpression("sorted_tuple", (arg,), skip_nones=skip_nones)


def tuple(arg: Any, *, skip_nones: bool = False) -> ReducerExpression:
    return ReducerExpression("tuple", (arg,), skip_nones=skip_nones)


def ndarray(arg: Any, *, skip_nones: bool = False) -> ReducerExpression:
    return ReducerExpression("ndarray", (arg,), skip_nones=skip_nones)


def tuple_by(sort_key: Any, arg: Any) -> ReducerExpression:
    """Tuple of ``arg`` values ordered ascending by ``sort_key`` (ties by
    row key). Used by the indexing repack path; the reference spells this
    ``groupby(sort_by=...)`` + ``reducers.tuple``."""
    return ReducerExpression("tuple_by", (sort_key, arg))


def earliest(arg: Any) -> ReducerExpression:
    return ReducerExpression("earliest", (arg,))


def latest(arg: Any) -> ReducerExpression:
    return ReducerExpression("latest", (arg,))


def stateful_single(combine_fn, *args: Any):
    """Custom stateful reducer.

    Decorator form (reference ``custom_reducers.py`` stateful_single):
    ``@pw.reducers.stateful_single`` over ``fn(state, *row_values)`` —
    the returned factory is called with column args in ``reduce``.
    Append-only (retractions raise, as in the reference).

    Legacy direct form: ``stateful_single(fn, *cols)`` with
    ``fn(state, values, diff)``.
    """
    if args:
        return ReducerExpression("stateful", args, combine_fn=combine_fn)

    def make(*cols: Any) -> ReducerExpression:
        def adapter(state, values, diff):
            if diff < 0:
                raise ValueError(
                    "stateful_single reducer cannot process retractions; "
                    "use stateful_many or a BaseCustomAccumulator with "
                    "retract()"
                )
            for _ in range(diff):
                state = combine_fn(state, *values)
            return state

        return ReducerExpression("stateful", cols, combine_fn=adapter)

    return make


def stateful_many(combine_fn, *args: Any):
    """Decorator form (reference): ``fn(state, rows)`` with
    ``rows = [(row_values_list, count)]`` — counts may be negative
    (retractions). Legacy direct form: ``stateful_many(fn, *cols)`` with
    ``fn(state, values, diff)``."""
    if args:
        return ReducerExpression("stateful", args, combine_fn=combine_fn)

    def make(*cols: Any) -> ReducerExpression:
        def adapter(state, values, diff):
            return combine_fn(state, [(list(values), diff)])

        return ReducerExpression("stateful", cols, combine_fn=adapter)

    return make


def udf_reducer(reducer_cls):
    """Decorator-style custom reducer from a BaseCustomAccumulator subclass."""

    def make(*args: Any) -> ReducerExpression:
        return ReducerExpression("custom_accumulator", args, accumulator=reducer_cls)

    return make
