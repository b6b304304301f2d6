"""``pw.Schema`` — typed table schemas.

Re-design of ``python/pathway/internals/schema.py`` (947 LoC in the
reference): a Schema subclass's annotations define column names and dtypes;
``column_definition`` adds per-column options (primary keys, defaults).
"""

from __future__ import annotations

import typing
from dataclasses import dataclass, field
from typing import Any

from . import dtype as dt

__all__ = [
    "Schema",
    "SchemaProperties",
    "ColumnDefinition",
    "column_definition",
    "schema_from_types",
    "schema_from_dict",
    "schema_builder",
    "assert_table_has_schema",
]


@dataclass(frozen=True)
class ColumnSchema:
    name: str
    dtype: dt.DType
    primary_key: bool = False
    default_value: Any = None
    has_default: bool = False
    #: reference column property: the column never retracts (connector
    #: hint + optimization flag; carried as metadata here)
    append_only: bool = False


@dataclass(frozen=True)
class SchemaProperties:
    """Schema-wide properties (reference internals/schema.py
    SchemaProperties): ``append_only`` marks every column append-only."""

    append_only: bool = False


@dataclass
class ColumnDefinition:
    primary_key: bool = False
    default_value: Any = None
    dtype: Any = None
    name: str | None = None
    _has_default: bool = False
    append_only: bool | None = None


_NO_DEFAULT = object()


def column_definition(
    *,
    primary_key: bool = False,
    default_value: Any = _NO_DEFAULT,
    dtype: Any = None,
    name: str | None = None,
    append_only: bool | None = None,
) -> Any:
    return ColumnDefinition(
        primary_key=primary_key,
        default_value=None if default_value is _NO_DEFAULT else default_value,
        dtype=dtype,
        name=name,
        _has_default=default_value is not _NO_DEFAULT,
        append_only=append_only,
    )


class SchemaMetaclass(type):
    __columns__: dict[str, ColumnSchema]

    def __new__(mcls, name, bases, namespace, **kwargs):
        # class keywords (append_only=...) are schema properties, not
        # __init_subclass__ arguments
        return super().__new__(mcls, name, bases, namespace)

    def __init__(cls, name, bases, namespace, **kwargs):
        super().__init__(name, bases, namespace)
        # ``class S(pw.Schema, append_only=True)`` (reference schema
        # class-keyword properties)
        schema_ao = bool(kwargs.get("append_only", False)) or any(
            getattr(base, "__append_only__", False) for base in bases
        )
        cls.__append_only__ = schema_ao
        columns: dict[str, ColumnSchema] = {}
        for base in reversed(bases):
            columns.update(getattr(base, "__columns__", {}))
        try:
            hints = typing.get_type_hints(cls)
        except Exception:
            hints = dict(namespace.get("__annotations__", {}))
        for col_name, annotation in namespace.get("__annotations__", {}).items():
            if col_name.startswith("__"):
                continue
            resolved = hints.get(col_name, annotation)
            definition = namespace.get(col_name)
            if isinstance(definition, ColumnDefinition):
                out_name = definition.name or col_name
                columns[out_name] = ColumnSchema(
                    name=out_name,
                    dtype=dt.wrap(definition.dtype) if definition.dtype is not None else dt.wrap(resolved),
                    primary_key=definition.primary_key,
                    default_value=definition.default_value,
                    has_default=definition._has_default,
                    append_only=(
                        schema_ao
                        if definition.append_only is None
                        else definition.append_only
                    ),
                )
            else:
                columns[col_name] = ColumnSchema(
                    name=col_name, dtype=dt.wrap(resolved),
                    append_only=schema_ao,
                )
        cls.__columns__ = columns

    def column_names(cls) -> list[str]:
        return list(cls.__columns__.keys())

    def columns(cls) -> dict[str, ColumnSchema]:
        return dict(cls.__columns__)

    def properties(cls) -> "SchemaProperties":
        return SchemaProperties(
            append_only=bool(getattr(cls, "__append_only__", False))
            or (
                bool(cls.__columns__)
                and all(c.append_only for c in cls.__columns__.values())
            )
        )

    def primary_key_columns(cls) -> list[str] | None:
        pks = [c.name for c in cls.__columns__.values() if c.primary_key]
        return pks or None

    def typehints(cls) -> dict[str, Any]:
        return {n: c.dtype.typehint() for n, c in cls.__columns__.items()}

    def dtypes(cls) -> dict[str, dt.DType]:
        return {n: c.dtype for n, c in cls.__columns__.items()}

    def __or__(cls, other: "SchemaMetaclass") -> "SchemaMetaclass":  # type: ignore[override]
        merged = dict(cls.__columns__)
        merged.update(other.__columns__)
        return schema_from_columns(merged, name=f"{cls.__name__}|{other.__name__}")

    def update_types(cls, **kwargs: Any) -> "SchemaMetaclass":
        cols = dict(cls.__columns__)
        for name, t in kwargs.items():
            if name not in cols:
                raise ValueError(f"Schema has no column {name!r}")
            old = cols[name]
            cols[name] = ColumnSchema(
                name=name, dtype=dt.wrap(t), primary_key=old.primary_key,
                default_value=old.default_value, has_default=old.has_default,
            )
        return schema_from_columns(cols, name=cls.__name__)

    def without(cls, *names: str) -> "SchemaMetaclass":
        cols = {n: c for n, c in cls.__columns__.items() if n not in names}
        return schema_from_columns(cols, name=cls.__name__)

    def __repr__(cls) -> str:
        inner = ", ".join(f"{n}: {c.dtype!r}" for n, c in cls.__columns__.items())
        return f"<pw.Schema {cls.__name__}({inner})>"


class Schema(metaclass=SchemaMetaclass):
    pass


def schema_from_columns(
    columns: dict[str, ColumnSchema], name: str = "Schema"
) -> SchemaMetaclass:
    cls = SchemaMetaclass(name, (Schema,), {})
    cls.__columns__ = dict(columns)
    return cls


def schema_from_types(_name: str = "Schema", **kwargs: Any) -> SchemaMetaclass:
    return schema_from_columns(
        {n: ColumnSchema(name=n, dtype=dt.wrap(t)) for n, t in kwargs.items()},
        name=_name,
    )


def schema_from_dict(
    types: dict[str, Any], name: str = "Schema"
) -> SchemaMetaclass:
    cols: dict[str, ColumnSchema] = {}
    for col, spec in types.items():
        if isinstance(spec, dict):
            cols[col] = ColumnSchema(
                name=col,
                dtype=dt.wrap(spec.get("dtype", dt.ANY)),
                primary_key=spec.get("primary_key", False),
                default_value=spec.get("default_value"),
                has_default="default_value" in spec,
            )
        else:
            cols[col] = ColumnSchema(name=col, dtype=dt.wrap(spec))
    return schema_from_columns(cols, name=name)


def schema_builder(
    columns: dict[str, Any], *, name: str = "Schema", properties: Any = None
) -> SchemaMetaclass:
    schema_ao = bool(getattr(properties, "append_only", False))
    cols: dict[str, ColumnSchema] = {}
    for col, definition in columns.items():
        if isinstance(definition, ColumnDefinition):
            # column_definition(name=...) renames the column (reference
            # schema_builder/class parity)
            cols[definition.name or col] = ColumnSchema(
                name=definition.name or col,
                dtype=dt.wrap(definition.dtype) if definition.dtype is not None else dt.ANY,
                primary_key=definition.primary_key,
                default_value=definition.default_value,
                has_default=definition._has_default,
                append_only=(
                    schema_ao
                    if definition.append_only is None
                    else definition.append_only
                ),
            )
        else:
            cols[col] = ColumnSchema(
                name=col, dtype=dt.wrap(definition), append_only=schema_ao
            )
    out = schema_from_columns(cols, name=name)
    out.__append_only__ = schema_ao
    return out


def assert_table_has_schema(
    table: Any,
    schema: SchemaMetaclass,
    *,
    allow_superset: bool = True,
    ignore_primary_keys: bool = True,
) -> None:
    actual = table.schema.dtypes()
    for name, expected in schema.dtypes().items():
        if name not in actual:
            raise AssertionError(f"table is missing column {name!r}")
        if expected != dt.ANY and actual[name] != expected:
            raise AssertionError(
                f"column {name!r} has dtype {actual[name]!r}, expected {expected!r}"
            )
    if not allow_superset:
        extra = set(actual) - set(schema.dtypes())
        if extra:
            raise AssertionError(f"table has extra columns: {sorted(extra)}")
