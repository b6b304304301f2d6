"""``pw.Json`` — JSON value wrapper (reference ``internals/json.py``)."""

from __future__ import annotations

import json as _json
from typing import Any

import numpy as np


class Json:
    """Immutable wrapper for a JSON value held in a column."""

    NULL: "Json"

    def __init__(self, value: Any = None):
        if isinstance(value, Json):
            value = value.value
        self._value = value

    @property
    def value(self) -> Any:
        return self._value

    @staticmethod
    def parse(s: str | bytes) -> "Json":
        return Json(_json.loads(s))

    @staticmethod
    def dumps(obj: Any) -> str:
        if isinstance(obj, Json):
            obj = obj.value
        return _json.dumps(obj)

    def __getitem__(self, key: Any) -> "Json":
        """Null-safe traversal (reference json access semantics,
        test_json.py:185-230): a missing key, an out-of-bounds / negative
        array index, or indexing a non-container all yield ``Json(None)``
        instead of raising — chained paths degrade to null."""
        v = self._value
        if isinstance(v, dict):
            return Json(v.get(key)) if isinstance(key, str) else Json(None)
        if isinstance(v, list):
            if isinstance(key, (int, np.integer)) and not isinstance(
                key, bool
            ) and 0 <= key < len(v):
                return Json(v[int(key)])
            return Json(None)
        return Json(None)

    def get(self, key: Any, default: Any = None) -> Any:
        if isinstance(self._value, dict) and isinstance(key, str):
            v = self._value.get(key, default)
        elif (
            isinstance(self._value, list)
            and isinstance(key, (int, np.integer))
            and not isinstance(key, bool)
            and 0 <= key < len(self._value)
        ):
            v = self._value[int(key)]
        else:
            v = default
        return Json(v) if not isinstance(v, Json) else v

    def as_int(self) -> int:
        if isinstance(self._value, bool) or not isinstance(
            self._value, (int, float)
        ) or (isinstance(self._value, float) and not self._value.is_integer()):
            raise ValueError(f"not an int: {self._value!r}")
        return int(self._value)

    def as_float(self) -> float:
        if isinstance(self._value, bool) or not isinstance(
            self._value, (int, float)
        ):
            raise ValueError(f"not a float: {self._value!r}")
        return float(self._value)

    def as_str(self) -> str:
        if not isinstance(self._value, str):
            raise ValueError(f"not a str: {self._value!r}")
        return self._value

    def as_bool(self) -> bool:
        if not isinstance(self._value, bool):
            raise ValueError(f"not a bool: {self._value!r}")
        return self._value

    def as_list(self) -> list:
        return list(self._value)

    def as_dict(self) -> dict:
        return dict(self._value)

    def __eq__(self, other: object) -> bool:
        if isinstance(other, Json):
            return self._value == other._value
        return self._value == other

    def __hash__(self) -> int:
        return hash(_json.dumps(self._value, sort_keys=True, default=str))

    def __repr__(self) -> str:
        return f"pw.Json({self._value!r})"

    def __str__(self) -> str:
        return _json.dumps(self._value)

    def __len__(self) -> int:
        return len(self._value)

    def __iter__(self):
        return iter(self._value)


Json.NULL = Json(None)
