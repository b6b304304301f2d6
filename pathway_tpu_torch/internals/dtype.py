"""DType lattice for the declarative layer and the engine.

TPU-native re-design of the reference's type system (reference:
``python/pathway/internals/dtype.py`` and ``src/engine/value.rs:507-524``).
Unlike the reference, a single module serves both the Python API layer and the
engine: columns are numpy/JAX arrays, so each DType also knows its storage
representation (``numpy_dtype``; ``object`` for irregular data).
"""

from __future__ import annotations

import datetime
import typing
from abc import ABC
from typing import Any

import numpy as np

from .json import Json

__all__ = [
    "DType",
    "ANY",
    "NONE",
    "INT",
    "FLOAT",
    "BOOL",
    "STR",
    "BYTES",
    "POINTER",
    "DATE_TIME_NAIVE",
    "DATE_TIME_UTC",
    "DURATION",
    "JSON",
    "Optional",
    "Tuple",
    "List",
    "Array",
    "Callable",
    "PyObjectWrapper",
    "wrap",
    "unoptionalize",
    "types_lca",
    "dtype_issubclass",
]


class DType(ABC):
    """Base of the dtype lattice."""

    _name: str = "DType"

    @property
    def numpy_dtype(self) -> np.dtype:
        return np.dtype(object)

    @property
    def is_optional(self) -> bool:
        return False

    def to_python_type(self) -> Any:
        return object

    def __repr__(self) -> str:
        return self._name

    def typehint(self) -> Any:
        return self.to_python_type()


class _SimpleDType(DType):
    def __init__(self, name: str, np_dtype: Any, py_type: Any):
        self._name = name
        self._np_dtype = np.dtype(np_dtype)
        self._py_type = py_type

    @property
    def numpy_dtype(self) -> np.dtype:
        return self._np_dtype

    def to_python_type(self) -> Any:
        return self._py_type

    def __eq__(self, other: object) -> bool:
        return isinstance(other, _SimpleDType) and other._name == self._name

    def __hash__(self) -> int:
        return hash(("dtype", self._name))


class _AnyDType(_SimpleDType):
    pass


ANY = _AnyDType("ANY", object, object)
NONE = _SimpleDType("NONE", object, type(None))
INT = _SimpleDType("INT", np.int64, int)
FLOAT = _SimpleDType("FLOAT", np.float64, float)
BOOL = _SimpleDType("BOOL", np.bool_, bool)
STR = _SimpleDType("STR", object, str)
BYTES = _SimpleDType("BYTES", object, bytes)
# Pointers (row keys) are engine 64-bit hashes; see engine/keys.py.
POINTER = _SimpleDType("POINTER", np.uint64, int)


class Pointer(int):
    """Typehint for pointer (row-key) columns — ``pw.Pointer[Any]`` in
    schemas (reference ``internals/api.py`` Pointer)."""

    def __class_getitem__(cls, item: Any) -> type:
        return cls
# datetimes/durations stored as int64 nanoseconds (epoch / delta).
DATE_TIME_NAIVE = _SimpleDType("DATE_TIME_NAIVE", np.int64, datetime.datetime)
DATE_TIME_UTC = _SimpleDType("DATE_TIME_UTC", np.int64, datetime.datetime)
DURATION = _SimpleDType("DURATION", np.int64, datetime.timedelta)
JSON = _SimpleDType("JSON", object, object)


class Optional(DType):
    def __init__(self, wrapped: DType):
        # collapse Optional(Optional(x)) and Optional(ANY/NONE)
        while isinstance(wrapped, Optional):
            wrapped = wrapped.wrapped
        self.wrapped = wrapped
        self._name = f"Optional({wrapped!r})"

    def __new__(cls, wrapped: DType):
        if isinstance(wrapped, Optional):
            return wrapped
        if wrapped is ANY or wrapped is NONE:
            return wrapped  # type: ignore[return-value]
        return super().__new__(cls)

    @property
    def is_optional(self) -> bool:
        return True

    @property
    def numpy_dtype(self) -> np.dtype:
        return np.dtype(object)

    def to_python_type(self) -> Any:
        return typing.Optional[self.wrapped.to_python_type()]

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Optional) and other.wrapped == self.wrapped

    def __hash__(self) -> int:
        return hash(("Optional", self.wrapped))


class Tuple(DType):
    def __new__(cls, *args: Any):
        # Tuple(T, ...) IS List(T) (reference dtype identity,
        # test_dtypes.py: dt.Tuple(dt.INT, ...) is dt.List(dt.INT))
        if len(args) == 2 and args[1] is Ellipsis:
            return List(args[0])  # type: ignore[return-value]
        return super().__new__(cls)

    def __init__(self, *args: DType):
        if len(args) == 2 and args[1] is Ellipsis:
            return  # __new__ returned a List; skip Tuple init
        self.args = tuple(args)
        self._name = f"Tuple({', '.join(map(repr, args))})"

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Tuple) and other.args == self.args

    def __hash__(self) -> int:
        return hash(("Tuple", self.args))

    def to_python_type(self) -> Any:
        return tuple


class List(DType):
    def __init__(self, wrapped: DType):
        self.wrapped = wrapped
        self._name = f"List({wrapped!r})"

    def __eq__(self, other: object) -> bool:
        return isinstance(other, List) and other.wrapped == self.wrapped

    def __hash__(self) -> int:
        return hash(("List", self.wrapped))

    def to_python_type(self) -> Any:
        return list


class Array(DType):
    """ndarray column type (reference value.rs:507-524 `Type::Array`)."""

    def __init__(self, n_dim: int | None = None, wrapped: DType = FLOAT):
        self.n_dim = n_dim
        self.wrapped = wrapped
        self._name = f"Array({n_dim}, {wrapped!r})"

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, Array)
            and other.n_dim == self.n_dim
            and other.wrapped == self.wrapped
        )

    def __hash__(self) -> int:
        return hash(("Array", self.n_dim, self.wrapped))

    def to_python_type(self) -> Any:
        return np.ndarray


class Callable(DType):
    _name = "Callable"

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Callable)

    def __hash__(self) -> int:
        return hash("Callable")


class PyObjectWrapper(DType):
    """Opaque wrapped-python-object dtype; optionally parameterized with
    the wrapped class (``pw.PyObjectWrapper[MyClass]`` annotations)."""

    _name = "PyObjectWrapper"

    def __init__(self, wrapped: Any = None):
        self.wrapped = wrapped

    def __repr__(self) -> str:
        if self.wrapped is None:
            return self._name
        return f"PyObjectWrapper[{getattr(self.wrapped, '__name__', self.wrapped)!s}]"

    def __eq__(self, other: object) -> bool:
        return isinstance(other, PyObjectWrapper)

    def __hash__(self) -> int:
        return hash("PyObjectWrapper")

    def is_value_compatible(self, value: Any) -> bool:
        from .py_object_wrapper import PyObjectWrapper as _Wrapper

        if not isinstance(value, _Wrapper):
            return False
        if self.wrapped is None:
            return True
        return type(value.value) is self.wrapped or isinstance(
            value.value, self.wrapped
        )


_FROM_PY: dict[Any, DType] = {
    int: INT,
    float: FLOAT,
    bool: BOOL,
    str: STR,
    bytes: BYTES,
    type(None): NONE,
    datetime.datetime: DATE_TIME_NAIVE,
    datetime.timedelta: DURATION,
    np.ndarray: Array(),
    Any: ANY,
    object: ANY,
    dict: JSON,
    Json: JSON,
    list: List(ANY),
    tuple: Tuple(),
}


def wrap(t: Any) -> DType:
    """Convert a python type / typing annotation / DType into a DType.
    String type names ("int", "str", "float", ...) are accepted too, for
    schemas loaded from JSON/YAML (reference schema.py:783: "both int and
    'int' are accepted"); unrecognized strings degrade to ANY like any
    other unresolvable annotation (e.g. an unevaluated forward ref)."""
    if isinstance(t, DType):
        return t
    if t is None:
        return NONE
    if isinstance(t, str):
        return _FROM_NAME.get(t.strip().lower(), ANY)
    origin = typing.get_origin(t)
    if origin is typing.Union:
        args = typing.get_args(t)
        non_none = [a for a in args if a is not type(None)]
        inner = types_lca_many([wrap(a) for a in non_none]) if non_none else NONE
        if type(None) in args:
            return Optional(inner)
        return inner
    if origin in (tuple,):
        args = typing.get_args(t)
        if len(args) == 2 and args[1] is Ellipsis:
            return List(wrap(args[0]))
        return Tuple(*[wrap(a) for a in args])
    if origin in (list,):
        args = typing.get_args(t)
        return List(wrap(args[0]) if args else ANY)
    if isinstance(t, type) and issubclass(t, Pointer):
        return POINTER
    from .py_object_wrapper import PyObjectWrapper as _PyObjWrapper

    if t is _PyObjWrapper:
        return PyObjectWrapper()
    if origin is _PyObjWrapper:  # PyObjectWrapper[MyClass]
        args = typing.get_args(t)
        return PyObjectWrapper(args[0] if args else None)
    if t in _FROM_PY:
        return _FROM_PY[t]
    if isinstance(t, type) and issubclass(t, np.integer):
        return INT
    if isinstance(t, type) and issubclass(t, np.floating):
        return FLOAT
    return ANY


#: string type names for JSON/YAML-loaded schemas (wrap() docstring)
_FROM_NAME = {
    "int": INT, "float": FLOAT, "str": STR, "string": STR,
    "bool": BOOL, "bytes": BYTES, "any": ANY, "json": JSON,
    "pointer": POINTER, "datetime": DATE_TIME_NAIVE,
    "datetimenaive": DATE_TIME_NAIVE, "datetimeutc": DATE_TIME_UTC,
    "duration": DURATION,
}


def unoptionalize(t: DType) -> DType:
    return t.wrapped if isinstance(t, Optional) else t


def dtype_of_value(v: Any) -> DType:
    if v is None:
        return NONE
    if isinstance(v, bool) or isinstance(v, np.bool_):
        return BOOL
    if isinstance(v, (int, np.integer)):
        return INT
    if isinstance(v, (float, np.floating)):
        return FLOAT
    if isinstance(v, str):
        return STR
    if isinstance(v, bytes):
        return BYTES
    if isinstance(v, datetime.timedelta):
        return DURATION
    if isinstance(v, datetime.datetime):
        return DATE_TIME_UTC if v.tzinfo is not None else DATE_TIME_NAIVE
    if isinstance(v, np.ndarray):
        return Array(v.ndim, wrap(type(v.reshape(-1)[0].item())) if v.size else FLOAT)
    if isinstance(v, tuple):
        return Tuple(*[dtype_of_value(x) for x in v])
    if isinstance(v, (dict, Json)):
        return JSON
    from .py_object_wrapper import PyObjectWrapper as _PyObjWrapper

    if isinstance(v, _PyObjWrapper):
        return PyObjectWrapper(type(v.value))
    return ANY


def dtype_issubclass(sub: DType, sup: DType) -> bool:
    if sup == ANY or sub == sup:
        return True
    if sub == NONE:
        return isinstance(sup, Optional) or sup == NONE
    if isinstance(sup, Optional):
        return dtype_issubclass(sub, sup.wrapped) or sub == NONE
    if isinstance(sub, Optional):
        return False
    if sub == INT and sup == FLOAT:
        return True
    if sub == BOOL and sup == INT:
        return True
    if isinstance(sub, Tuple) and isinstance(sup, Tuple):
        return len(sub.args) == len(sup.args) and all(
            dtype_issubclass(a, b) for a, b in zip(sub.args, sup.args)
        )
    if isinstance(sub, Array) and isinstance(sup, Array):
        return (sup.n_dim is None or sub.n_dim == sup.n_dim) and dtype_issubclass(
            sub.wrapped, sup.wrapped
        )
    return False


def types_lca(a: DType, b: DType) -> DType:
    """Least common ancestor in the lattice."""
    if a == b:
        return a
    if dtype_issubclass(a, b):
        return b
    if dtype_issubclass(b, a):
        return a
    if a == NONE:
        return Optional(b)
    if b == NONE:
        return Optional(a)
    ua, ub = unoptionalize(a), unoptionalize(b)
    opt = isinstance(a, Optional) or isinstance(b, Optional)
    if ua != a or ub != b:
        inner = types_lca(ua, ub)
        return Optional(inner) if opt else inner
    if {ua, ub} == {INT, FLOAT}:
        return FLOAT
    if {ua, ub} == {BOOL, INT}:
        return INT
    return ANY


def types_lca_many(ts: list[DType]) -> DType:
    out = ts[0]
    for t in ts[1:]:
        out = types_lca(out, t)
    return out


def numpy_storage_dtype(t: DType) -> np.dtype:
    return t.numpy_dtype
