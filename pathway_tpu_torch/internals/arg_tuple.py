"""ArgTuple — named/positional result wrapper (reference
``internals/arg_tuple.py``): functions returning a dict or iterable get
their result wrapped so callers can unpack positionally, index by name,
or use attribute access; single-element results collapse to the bare
value, scalars pass through."""

from __future__ import annotations

from typing import Any, Callable

__all__ = ["ArgTuple", "wrap_arg_tuple"]


class ArgTuple:
    def __init__(self, entries: dict[str, Any]):
        self._entries = dict(entries)

    def __iter__(self):
        return iter(self._entries.values())

    def __len__(self) -> int:
        return len(self._entries)

    def __getitem__(self, key: str) -> Any:
        return self._entries[str(key)]

    def __getattr__(self, name: str) -> Any:
        if name.startswith("_"):
            raise AttributeError(name)
        try:
            return self._entries[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __eq__(self, other: object) -> bool:
        if isinstance(other, ArgTuple):
            return self._entries == other._entries
        return NotImplemented

    def __repr__(self) -> str:
        inner = ", ".join(f"{k}={v!r}" for k, v in self._entries.items())
        return f"ArgTuple({inner})"

    def to_dict(self) -> dict[str, Any]:
        return dict(self._entries)


def as_arg_tuple(result: Any) -> Any:
    """Wrap a dict/iterable result as an ArgTuple; collapse one-element
    results to the bare value; scalars pass through unchanged."""
    if isinstance(result, ArgTuple):
        entries = result.to_dict()
    elif isinstance(result, dict):
        entries = dict(result)
    elif isinstance(result, (list, tuple)):
        entries = {str(i): v for i, v in enumerate(result)}
    else:
        return result
    if len(entries) == 1:
        (only,) = entries.values()
        if isinstance(only, (dict, list, tuple)):
            # keep structure when the single element is itself structured
            return ArgTuple(entries)
        # single-element collapse still supports name/index access
        wrapped = ArgTuple(entries)
        return _Scalarish(only, wrapped)
    return ArgTuple(entries)


class _Scalarish:
    """A single-element result: compares/acts like the bare value but
    keeps the name/index access of its ArgTuple."""

    __slots__ = ("_value", "_tuple")

    def __init__(self, value: Any, tup: ArgTuple):
        object.__setattr__(self, "_value", value)
        object.__setattr__(self, "_tuple", tup)

    def __eq__(self, other: object) -> bool:
        if isinstance(other, _Scalarish):
            other = other._value
        return self._value == other

    def __getattr__(self, name: str) -> Any:
        try:
            return getattr(object.__getattribute__(self, "_tuple"), name)
        except AttributeError:
            return getattr(object.__getattribute__(self, "_value"), name)

    def __getitem__(self, key: Any) -> Any:
        try:
            return self._tuple[key]
        except (KeyError, TypeError):
            return self._value[key]

    def __repr__(self) -> str:
        return repr(self._value)

    def __hash__(self) -> int:
        return hash(self._value)

    def __iter__(self):
        return iter(self._tuple)


def wrap_arg_tuple(fn: Callable[..., Any]) -> Callable[..., Any]:
    """Decorator: the function's result goes through ``as_arg_tuple``."""

    def wrapped(*args: Any, **kwargs: Any) -> Any:
        return as_arg_tuple(fn(*args, **kwargs))

    return wrapped
