"""``pw.udfs`` / ``@pw.udf`` — user-defined functions over columns.

Re-design of ``python/pathway/internals/udfs/`` (``__init__.py:68-461``):
sync and async UDFs with optional caching and retry policies. Async UDFs are
gathered per batch on an event loop (the reference ships rows to a Python
event loop via ``async_apply_table``, graph.rs:744).
"""

from __future__ import annotations

import asyncio
import functools
import time as _time
import typing
from typing import Any, Callable

from .internals import dtype as dt
from .internals.expression import ApplyExpression, AsyncApplyExpression

__all__ = [
    "UDF",
    "udf",
    "udf_async",
    "CacheStrategy",
    "InMemoryCache",
    "DiskCache",
    "DefaultCache",
    "AsyncRetryStrategy",
    "ExponentialBackoffRetryStrategy",
    "FixedDelayRetryStrategy",
    "NoRetryStrategy",
    "async_executor",
    "coerce_async",
    "with_cache_strategy",
    "with_retry_strategy",
    "with_capacity",
    "with_timeout",
]


class CacheStrategy:
    def wrap(self, fn: Callable) -> Callable:
        return fn


class InMemoryCache(CacheStrategy):
    """Memoize UDF results in process memory (reference caches.py:23-91)."""

    def wrap(self, fn: Callable) -> Callable:
        cache: dict = {}
        if asyncio.iscoroutinefunction(fn):
            @functools.wraps(fn)
            async def awrapper(*args):
                key = args
                if key not in cache:
                    # cache the TASK, not the value: concurrent async calls
                    # for one key must coalesce into a single execution
                    # (reference caches.py in-flight dedup)
                    cache[key] = asyncio.ensure_future(fn(*args))
                try:
                    return await cache[key]
                except BaseException:
                    cache.pop(key, None)  # do not cache failures
                    raise

            return awrapper

        @functools.wraps(fn)
        def wrapper(*args):
            key = args
            if key not in cache:
                cache[key] = fn(*args)
            return cache[key]

        return wrapper


class DiskCache(CacheStrategy):
    """Persist UDF results on disk (reference uses diskcache; here a simple
    shelve-backed store under PATHWAY_PERSISTENT_STORAGE)."""

    def __init__(self, name: str | None = None):
        self._name = name

    #: one open shelf per path per process: gdbm holds an exclusive lock, so
    #: a second wrap() of the same cache (engine restart in-process, two
    #: UDFs sharing a name) must reuse the handle instead of re-opening
    _open_stores: dict[str, Any] = {}

    def wrap(self, fn: Callable) -> Callable:
        import hashlib
        import os
        import pickle
        import shelve

        root = os.environ.get("PATHWAY_PERSISTENT_STORAGE", "/tmp/pathway_tpu_cache")
        os.makedirs(root, exist_ok=True)
        path = os.path.join(root, self._name or fn.__name__)
        store = DiskCache._open_stores.get(path)
        if store is None:
            store = shelve.open(path)
            DiskCache._open_stores[path] = store

        # the function identity is part of the key: two UDFs resolving to
        # the same store path (shared __name__, no explicit cache name)
        # must never serve each other's results; the line number separates
        # same-scope lambdas, and is stable across restarts of one source
        code = getattr(fn, "__code__", None)
        fn_id = (
            getattr(fn, "__module__", ""),
            getattr(fn, "__qualname__", ""),
            getattr(code, "co_firstlineno", 0),
        )

        def key_of(args):
            return hashlib.blake2b(
                pickle.dumps((fn_id, args)), digest_size=16
            ).hexdigest()

        if asyncio.iscoroutinefunction(fn):
            @functools.wraps(fn)
            async def awrapper(*args):
                k = key_of(args)
                if k not in store:
                    store[k] = await fn(*args)
                    store.sync()  # durable without close (process may be killed)
                return store[k]

            return awrapper

        @functools.wraps(fn)
        def wrapper(*args):
            k = key_of(args)
            if k not in store:
                store[k] = fn(*args)
                store.sync()  # durable without close (process may be killed)
            return store[k]

        return wrapper


class DefaultCache(DiskCache):
    pass


class AsyncRetryStrategy:
    async def invoke(self, fn: Callable, *args, **kwargs):
        return await fn(*args, **kwargs)


class NoRetryStrategy(AsyncRetryStrategy):
    pass


class FixedDelayRetryStrategy(AsyncRetryStrategy):
    def __init__(self, max_retries: int = 3, delay_ms: int = 1000):
        self._max_retries = max_retries
        self._delay = delay_ms / 1000

    async def invoke(self, fn: Callable, *args, **kwargs):
        last: Exception | None = None
        for attempt in range(self._max_retries):
            try:
                return await fn(*args, **kwargs)
            except Exception as e:  # noqa: BLE001 — retry everything like the reference
                last = e
                if attempt + 1 < self._max_retries:
                    await asyncio.sleep(self._next_delay(attempt))
        assert last is not None
        raise last

    def _next_delay(self, attempt: int) -> float:
        return self._delay


class ExponentialBackoffRetryStrategy(FixedDelayRetryStrategy):
    def __init__(self, max_retries: int = 3, initial_delay: int = 1000, backoff_factor: float = 2.0):
        super().__init__(max_retries, initial_delay)
        self._factor = backoff_factor

    def _next_delay(self, attempt: int) -> float:
        return self._delay * self._factor**attempt


def coerce_async(fn: Callable) -> Callable:
    if asyncio.iscoroutinefunction(fn):
        return fn

    @functools.wraps(fn)
    async def wrapper(*args, **kwargs):
        return fn(*args, **kwargs)

    return wrapper


def with_cache_strategy(fn: Callable, cache_strategy: CacheStrategy) -> Callable:
    return cache_strategy.wrap(fn)


def with_retry_strategy(fn: Callable, retry_strategy: AsyncRetryStrategy) -> Callable:
    fn = coerce_async(fn)

    @functools.wraps(fn)
    async def wrapper(*args, **kwargs):
        return await retry_strategy.invoke(fn, *args, **kwargs)

    return wrapper


def with_capacity(fn: Callable, capacity: int) -> Callable:
    fn = coerce_async(fn)
    semaphore = asyncio.Semaphore(capacity)

    @functools.wraps(fn)
    async def wrapper(*args, **kwargs):
        async with semaphore:
            return await fn(*args, **kwargs)

    return wrapper


def with_timeout(fn: Callable, timeout: float) -> Callable:
    fn = coerce_async(fn)

    @functools.wraps(fn)
    async def wrapper(*args, **kwargs):
        return await asyncio.wait_for(fn(*args, **kwargs), timeout=timeout)

    return wrapper


class Executor:
    pass


class AutoExecutor(Executor):
    pass


class AsyncExecutor(Executor):
    def __init__(self, capacity: int | None = None, timeout: float | None = None,
                 retry_strategy: AsyncRetryStrategy | None = None):
        self.capacity = capacity
        self.timeout = timeout
        self.retry_strategy = retry_strategy


def async_executor(capacity: int | None = None, timeout: float | None = None,
                   retry_strategy: AsyncRetryStrategy | None = None) -> AsyncExecutor:
    return AsyncExecutor(capacity, timeout, retry_strategy)


class UDF:
    """Base class for user-defined functions (reference udfs/__init__.py:68).

    Subclass and override ``__wrapped__``, or use the ``@pw.udf`` decorator.
    """

    def __init__(
        self,
        *,
        return_type: Any = None,
        propagate_none: bool = False,
        deterministic: bool = False,
        executor: Executor | None = None,
        cache_strategy: CacheStrategy | None = None,
    ):
        self._return_type = return_type
        self._propagate_none = propagate_none
        self._deterministic = deterministic
        self._executor = executor
        self._cache_strategy = cache_strategy

    def __wrapped__(self, *args, **kwargs):
        raise NotImplementedError

    def _prepare(self) -> Callable:
        fn = self.__wrapped__
        if self._cache_strategy is not None:
            fn = self._cache_strategy.wrap(fn)
        if isinstance(self._executor, AsyncExecutor):
            ex = self._executor
            if ex.retry_strategy is not None:
                fn = with_retry_strategy(fn, ex.retry_strategy)
            if ex.timeout is not None:
                fn = with_timeout(fn, ex.timeout)
            if ex.capacity is not None:
                fn = with_capacity(fn, ex.capacity)
        return fn

    def _ret_type(self) -> Any:
        if self._return_type is not None:
            return self._return_type
        hints = typing.get_type_hints(self.__wrapped__)
        return hints.get("return", dt.ANY)

    def __call__(self, *args: Any, **kwargs: Any):
        fn = self._prepare()
        if asyncio.iscoroutinefunction(self.__wrapped__) or isinstance(self._executor, AsyncExecutor):
            return AsyncApplyExpression(
                coerce_async(fn), self._ret_type(), args, kwargs,
                propagate_none=self._propagate_none,
                deterministic=self._deterministic,
            )
        return ApplyExpression(
            fn, self._ret_type(), args, kwargs,
            propagate_none=self._propagate_none,
            deterministic=self._deterministic,
        )


class _FunctionUDF(UDF):
    def __init__(self, fn: Callable, **kwargs: Any):
        super().__init__(**kwargs)
        self._fn = fn
        self.__name__ = getattr(fn, "__name__", "udf")
        self.__doc__ = getattr(fn, "__doc__", None)

    @property
    def __wrapped__(self):  # type: ignore[override]
        return self._fn

    def func(self, *args, **kwargs):
        return self._fn(*args, **kwargs)


def udf(
    fn: Callable | None = None,
    /,
    *,
    return_type: Any = None,
    propagate_none: bool = False,
    deterministic: bool = False,
    executor: Executor | None = None,
    cache_strategy: CacheStrategy | None = None,
):
    """Decorator turning a python function into a column UDF."""

    def wrap(f: Callable) -> _FunctionUDF:
        return _FunctionUDF(
            f,
            return_type=return_type,
            propagate_none=propagate_none,
            deterministic=deterministic,
            executor=executor,
            cache_strategy=cache_strategy,
        )

    if fn is None:
        return wrap
    return wrap(fn)


def udf_async(fn: Callable | None = None, **kwargs: Any):
    kwargs.setdefault("executor", async_executor())  # caller's executor wins
    if fn is None:
        return lambda f: udf(f, **kwargs)
    return udf(fn, **kwargs)


UDFSync = UDF
UDFAsync = UDF
