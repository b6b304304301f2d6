"""``AsyncTransformer`` (reference
``python/pathway/stdlib/utils/async_transformer.py:282``).

Subclass with an ``async def invoke(**input_row) -> dict`` and an
``output_schema``; ``.successful`` is the table of completed results.
The reference runs a connector thread + event loop and re-ingests results
as-of their completion time; here invocation rides the engine's async
apply machinery (rows of a batch are awaited concurrently, results land
at the batch's logical time), with the same retry/cache options.

Copy of ``pathway_tpu/stdlib/utils/async_transformer.py``, over the port's Table API and engine nodes.
"""

from __future__ import annotations

import asyncio
from abc import ABC, abstractmethod
from typing import Any, ClassVar

from ...internals import dtype as dt
from ...internals.expression import AsyncApplyExpression, apply_with_type
from ...internals.schema import SchemaMetaclass
from ...internals.table import Table
from ...internals.thisclass import this
from ...udfs import (
    AsyncRetryStrategy,
    CacheStrategy,
    with_cache_strategy,
    with_capacity,
    with_retry_strategy,
    with_timeout,
)

__all__ = ["AsyncTransformer"]

_FAILED = object()


class AsyncTransformer(ABC):
    output_schema: ClassVar[SchemaMetaclass]

    def __init_subclass__(cls, output_schema: Any = None, **kw: Any) -> None:
        # reference form: class X(pw.AsyncTransformer, output_schema=Schema)
        super().__init_subclass__(**kw)
        if output_schema is not None:
            if not isinstance(output_schema, SchemaMetaclass):
                raise TypeError(
                    f"output_schema must be a pw.Schema subclass, got "
                    f"{output_schema!r}"
                )
            cls.output_schema = output_schema

    def __init__(self, input_table: Table, *, instance: Any = None, **kwargs: Any):
        if not hasattr(self, "output_schema"):
            raise ValueError("AsyncTransformer subclass must set output_schema")
        self._input_table = input_table
        self._retry_strategy: AsyncRetryStrategy | None = None
        self._cache_strategy: CacheStrategy | None = None
        self._capacity: int | None = None
        self._timeout: float | None = None
        self._result: Table | None = None
        self._failed: Table | None = None

    @abstractmethod
    async def invoke(self, *args: Any, **kwargs: Any) -> dict: ...

    # -- reference fluent config (with_options) --

    def with_options(
        self,
        capacity: int | None = None,
        timeout: float | None = None,
        retry_strategy: AsyncRetryStrategy | None = None,
        cache_strategy: CacheStrategy | None = None,
    ) -> "AsyncTransformer":
        self._capacity = capacity
        self._timeout = timeout
        self._retry_strategy = retry_strategy
        self._cache_strategy = cache_strategy
        return self

    # -- execution --

    def _wrapped_invoke(self):
        names = self._input_table.column_names()

        expected_cols = set(self.output_schema.column_names())

        async def call(*values):
            result = dict(await self.invoke(**dict(zip(names, values))))
            if set(result) != expected_cols:
                # reference asserts the result matches output_schema
                # (test_async_transformer.py:188) — the row lands in
                # .failed, not in .successful with nulls
                raise ValueError(
                    f"AsyncTransformer.invoke returned columns "
                    f"{sorted(result)}, expected {sorted(expected_cols)}"
                )
            return result

        # exceptions must still RAISE through cache/retry (retry fires on
        # exceptions; the cache must not memoize failures) — only the
        # outermost wrapper converts a final failure into the _FAILED row
        fn = call
        if self._cache_strategy is not None:
            fn = self._cache_strategy.wrap(fn)
        if self._retry_strategy is not None:
            fn = with_retry_strategy(fn, self._retry_strategy)
        if self._timeout is not None:
            fn = with_timeout(fn, self._timeout)
        if self._capacity is not None:
            fn = with_capacity(fn, self._capacity)

        async def safe(*values):
            try:
                return await fn(*values)
            except Exception:
                return _FAILED

        return safe

    def _run(self) -> None:
        if self._result is not None:
            return
        names = self._input_table.column_names()
        cols = [self._input_table[n] for n in names]
        raw = self._input_table.select(
            __res=AsyncApplyExpression(self._wrapped_invoke(), dt.ANY, tuple(cols), {}),
        )
        ok = raw.filter(
            apply_with_type(lambda r: r is not _FAILED, dt.BOOL, this["__res"])
        )
        out_names = self.output_schema.column_names()
        self._result = ok.select(**{
            n: apply_with_type(lambda r, n=n: r.get(n), dt.ANY, this["__res"])
            for n in out_names
        })
        self._failed = raw.filter(
            apply_with_type(lambda r: r is _FAILED, dt.BOOL, this["__res"])
        ).select()

    @property
    def successful(self) -> Table:
        """Table of completed invocations (reference .successful)."""
        self._run()
        assert self._result is not None
        return self._result

    @property
    def failed(self) -> Table:
        """Rows whose invocation raised (reference .failed)."""
        self._run()
        assert self._failed is not None
        return self._failed

    @property
    def output_table(self) -> Table:
        return self.successful
