"""TableSlice — a manipulable collection of column references.

Re-design of ``python/pathway/internals/table_slice.py``: created by the
``Table.slice`` property; supports ``without``/``rename``/``with_prefix``/
``with_suffix``/``ix``/``ix_ref`` and unpacks into ``select`` (each yielded
reference remembers the slice's name for it).
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Iterator

from .expression import ColumnReference
from .thisclass import ThisPlaceholder

if TYPE_CHECKING:
    from .table import Table

__all__ = ["TableSlice"]


class RenamedReference(ColumnReference):
    """A column reference carrying a different output name — produced by
    renamed slices so ``select(*slice)`` lands on the slice's names."""

    def __init__(self, source: ColumnReference, name: str):
        super().__init__(source.table, name)
        self._source = source


class TableSlice:
    def __init__(self, mapping: dict[str, ColumnReference], table: "Table"):
        self._mapping = mapping
        self._table = table

    def __iter__(self) -> Iterator[ColumnReference]:
        for name, ref in self._mapping.items():
            yield ref if ref.name == name else RenamedReference(ref, name)

    def __repr__(self) -> str:
        return f"TableSlice({self._mapping})"

    def keys(self):
        return self._mapping.keys()

    def __getitem__(self, arg):
        if isinstance(arg, (ColumnReference, str)):
            return self._mapping[self._normalize(arg)]
        return TableSlice(
            {self._normalize(k): self[k] for k in arg}, self._table
        )

    def __getattr__(self, name: str):
        from .table import Table

        if name.startswith("_"):
            raise AttributeError(name)
        if hasattr(Table, name) and name != "id":
            raise ValueError(
                f"{name!r} is a method name. It is discouraged to use it as "
                f"a column name. If you really want to use it, use [{name!r}]."
            )
        if name not in self._mapping:
            raise AttributeError(f"Column name {name!r} not found in {self!r}.")
        return self._mapping[name]

    def without(self, *cols) -> "TableSlice":
        mapping = dict(self._mapping)
        for col in cols:
            colname = self._normalize(col)
            if colname not in mapping:
                raise KeyError(f"Column name {colname!r} not found in a {self}.")
            mapping.pop(colname)
        return TableSlice(mapping, self._table)

    def rename(self, rename_dict: dict) -> "TableSlice":
        normalized = {
            self._normalize(old): self._normalize(new)
            for old, new in rename_dict.items()
        }
        mapping = dict(self._mapping)
        for old in normalized:
            if old not in mapping:
                raise KeyError(f"Column name {old!r} not found in a {self}.")
            mapping.pop(old)
        for old, new in normalized.items():
            mapping[new] = self._mapping[old]
        return TableSlice(mapping, self._table)

    def with_prefix(self, prefix: str) -> "TableSlice":
        return self.rename({name: prefix + name for name in self.keys()})

    def with_suffix(self, suffix: str) -> "TableSlice":
        return self.rename({name: name + suffix for name in self.keys()})

    def ix(self, expression, *, optional: bool = False, context=None) -> "TableSlice":
        new_table = self._table.ix(expression, optional=optional, context=context)
        return TableSlice(
            {
                name: ColumnReference(new_table, ref.name)
                for name, ref in self._mapping.items()
            },
            new_table,
        )

    def ix_ref(self, *args, optional: bool = False, context=None) -> "TableSlice":
        new_table = self._table.ix_ref(*args, optional=optional, context=context)
        return TableSlice(
            {
                name: ColumnReference(new_table, ref.name)
                for name, ref in self._mapping.items()
            },
            new_table,
        )

    @property
    def slice(self) -> "TableSlice":
        return self

    def _normalize(self, arg) -> str:
        if isinstance(arg, ColumnReference):
            if isinstance(arg.table, ThisPlaceholder):
                return arg.name
            if arg.table is not self._table:
                raise ValueError(
                    "TableSlice method arguments should refer to table of "
                    "which the slice was created."
                )
            return arg.name
        return arg
