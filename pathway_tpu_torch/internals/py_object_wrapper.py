"""``pw.PyObjectWrapper`` — carry an arbitrary python object as a column
value (reference ``internals/api`` PyObjectWrapper + ``value.rs``
Value::PyObjectWrapper): the engine treats it as an opaque value that
survives serialization (pickle), groups by content, and round-trips
through UDFs via ``.value``. Type annotations may parameterize it
(``pw.PyObjectWrapper[MyClass]``) — the schema layer checks the wrapped
object's class."""

from __future__ import annotations

from typing import Generic, TypeVar

T = TypeVar("T")

__all__ = ["PyObjectWrapper"]


class PyObjectWrapper(Generic[T]):
    __slots__ = ("value",)

    def __init__(self, value: T):
        self.value = value

    def __repr__(self) -> str:
        # content-based repr: the engine's object hash falls back to repr,
        # so equal-valued wrappers key identically (groupby by wrapper)
        return f"PyObjectWrapper({self.value!r})"

    def __eq__(self, other: object) -> bool:
        return isinstance(other, PyObjectWrapper) and self.value == other.value

    def __ne__(self, other: object) -> bool:
        return not self.__eq__(other)

    def __hash__(self) -> int:
        try:
            return hash(("PyObjectWrapper", self.value))
        except TypeError:
            return hash(("PyObjectWrapper", repr(self.value)))

    # pickle via __slots__
    def __getstate__(self):
        return self.value

    def __setstate__(self, state):
        self.value = state

    def __copy__(self):
        return PyObjectWrapper(self.value)

    def __deepcopy__(self, memo):
        import copy

        return PyObjectWrapper(copy.deepcopy(self.value, memo))
