"""``pw.indexing.DataIndex`` / ``InnerIndex`` — live index query surface.

Re-design of the reference ``python/pathway/stdlib/indexing/data_index.py``
(``InnerIndex`` :206, ``DataIndex`` :278). An ``InnerIndex`` wires an
indexed-data column and a query column into the engine's
``ExternalIndexNode`` (our analog of ``UseExternalIndexAsOfNow``,
``src/engine/dataflow/operators/external_index.rs:38``); ``DataIndex``
repacks the raw ``(id, score)`` replies into a JoinResult against the data
table — collapsed (one row per query, tuple-valued columns, best-first) or
flat (one row per match) — mirroring ``_extract_data_collapsed_rows`` /
``_extract_data_flat`` (data_index.py:46,91).

Copy of ``pathway_tpu/stdlib/indexing/data_index.py``. ``_make_engine`` takes
the device of the run that lowers the graph (``GraphRunner.device``): no
engine exists before ``pw.run(device=...)``, and each run builds its own.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import Any, Callable

from ... import reducers
from ...internals import dtype as dt
from ...internals.expression import (
    ColumnExpression,
    ColumnReference,
    apply_with_type,
    smart_coerce,
)
from ...internals.joins import JoinMode, JoinResult
from ...internals.parse_graph import Universe
from ...internals.schema import ColumnSchema, schema_from_columns
from ...internals.table import Table
from ...internals.thisclass import this, substitute

__all__ = [
    "DataIndex",
    "InnerIndex",
    "InnerIndexFactory",
    "_INDEX_REPLY",
    "_QUERY_ID",
    "_MATCHED_ID",
    "_SCORE",
]

# special column names, kept verbatim for parity (indexing/colnames.py)
_INDEX_REPLY = "_pw_index_reply"
_QUERY_ID = "_pw_query_id"
_MATCHED_ID = "_pw_index_reply_id"
_SCORE = "_pw_index_reply_score"


@dataclass(kw_only=True)
class InnerIndex(ABC):
    """Base of index implementations over ``data_column``
    (reference data_index.py:206)."""

    data_column: ColumnReference
    metadata_column: ColumnExpression | None = None

    @abstractmethod
    def _make_engine(self, device: Any) -> Any:
        """Fresh index engine (engine.external_index.IndexEngine) on ``device``."""

    def _prep_data(self) -> Table:
        t = self.data_column.table
        exprs: dict[str, Any] = {"__data__": self.data_column}
        if self.metadata_column is not None:
            exprs["__filter_data__"] = self.metadata_column
        return t.select(**exprs)

    def _raw(
        self,
        query_column: ColumnReference,
        number_of_matches: ColumnExpression | int,
        metadata_filter: ColumnExpression | None,
        asof_now: bool,
    ) -> Table:
        """Reply table keyed by query id with one tuple column
        ``_pw_index_reply`` of (id, score) pairs, best first."""
        from ...engine.external_index import ExternalIndexNode

        qt = query_column.table
        qexprs: dict[str, Any] = {
            "__query__": query_column,
            "__limit__": smart_coerce(number_of_matches),
        }
        if metadata_filter is not None:
            qexprs["__filter__"] = metadata_filter
        prep_q = qt.select(**qexprs)
        prep_d = self._prep_data()
        make_engine = self._make_engine

        def lower(runner, tbl):
            from ...engine import operators as ops

            # query chain first: source ownership round-robins in lowering
            # order, so this keeps a REST query edge on worker 0 — the same
            # worker the serve plane's scatter origin, the response sink's
            # gather and the degraded-status side channel all live on
            query_node = runner.lower(prep_q)
            data_node = runner.lower(prep_d)
            return runner._add(
                ExternalIndexNode(
                    data_node, query_node, make_engine(runner.device),
                    asof_now=asof_now,
                )
            )

        schema = schema_from_columns(
            {_INDEX_REPLY: ColumnSchema(name=_INDEX_REPLY, dtype=dt.List(dt.ANY))},
            name="IndexReply",
        )
        return Table("custom", [prep_d, prep_q], {"lower": lower}, schema, Universe())

    def query(
        self,
        query_column: ColumnReference,
        *,
        number_of_matches: ColumnExpression | int = 3,
        metadata_filter: ColumnExpression | None = None,
    ) -> Table:
        return self._raw(query_column, number_of_matches, metadata_filter, False)

    def query_as_of_now(
        self,
        query_column: ColumnReference,
        *,
        number_of_matches: ColumnExpression | int = 3,
        metadata_filter: ColumnExpression | None = None,
    ) -> Table:
        return self._raw(query_column, number_of_matches, metadata_filter, True)


class InnerIndexFactory(ABC):
    """Builds an InnerIndex given the data columns
    (reference retrievers.py InnerIndexFactory)."""

    @abstractmethod
    def build_inner_index(
        self,
        data_column: ColumnReference,
        metadata_column: ColumnExpression | None = None,
    ) -> InnerIndex: ...

    def build_index(
        self,
        data_column: ColumnReference,
        data_table: Table,
        metadata_column: ColumnExpression | None = None,
    ) -> "DataIndex":
        return DataIndex(
            data_table, self.build_inner_index(data_column, metadata_column)
        )


@dataclass
class DataIndex:
    """Augments InnerIndex replies with the data table's columns
    (reference data_index.py:278)."""

    data_table: Table
    inner_index: InnerIndex

    def query(
        self,
        query_column: ColumnReference,
        *,
        number_of_matches: ColumnExpression | int = 3,
        collapse_rows: bool = True,
        metadata_filter: ColumnExpression | None = None,
    ) -> JoinResult:
        """Maintained matches: answers update when the index data changes."""
        raw = self.inner_index.query(
            query_column,
            number_of_matches=number_of_matches,
            metadata_filter=metadata_filter,
        )
        return self._repack(raw, query_column.table, collapse_rows)

    def query_as_of_now(
        self,
        query_column: ColumnReference,
        *,
        number_of_matches: ColumnExpression | int = 3,
        collapse_rows: bool = True,
        metadata_filter: ColumnExpression | None = None,
    ) -> JoinResult:
        """Answers reflect the index at query arrival and are not revisited."""
        raw = self.inner_index.query_as_of_now(
            query_column,
            number_of_matches=number_of_matches,
            metadata_filter=metadata_filter,
        )
        return self._repack(raw, query_column.table, collapse_rows)

    # ------------------------------------------------------------------

    def _matching(self, raw: Table) -> Table:
        """One row per (query, match): _pw_query_id, _pw_index_reply_id,
        _pw_index_reply_score (reference's flatten+unpack,
        data_index.py:294-345)."""
        flat = raw.flatten(this[_INDEX_REPLY], origin_id=_QUERY_ID)
        return flat.select(
            **{
                _QUERY_ID: this[_QUERY_ID],
                _MATCHED_ID: apply_with_type(
                    lambda p: int(p[0]), dt.POINTER, this[_INDEX_REPLY]
                ),
                _SCORE: apply_with_type(
                    lambda p: float(p[1]), dt.FLOAT, this[_INDEX_REPLY]
                ),
            }
        )

    def _repack(
        self, raw: Table, query_table: Table, collapse_rows: bool
    ) -> JoinResult:
        from ...internals.thisclass import left as l_, right as r_

        data_cols = self.data_table.column_names()
        matching = self._matching(raw)
        docs = JoinResult(
            matching,
            self.data_table,
            (ColumnReference(matching, _MATCHED_ID) == _id_of(self.data_table),),
            JoinMode.INNER,
        ).select(
            *(getattr(r_, c) for c in data_cols),
            **{
                _QUERY_ID: getattr(l_, _QUERY_ID),
                _SCORE: getattr(l_, _SCORE),
                _MATCHED_ID: getattr(l_, _MATCHED_ID),
            },
        )
        if not collapse_rows:
            jr = JoinResult(
                query_table,
                docs,
                (_id_of(query_table) == ColumnReference(docs, _QUERY_ID),),
                JoinMode.LEFT,
            )
            return jr

        order = -ColumnReference(docs, _SCORE)
        grouped = docs.groupby(id=ColumnReference(docs, _QUERY_ID)).reduce(
            **{
                _SCORE: reducers.tuple_by(order, ColumnReference(docs, _SCORE)),
                _MATCHED_ID: reducers.tuple_by(
                    order, ColumnReference(docs, _MATCHED_ID)
                ),
                **{
                    c: reducers.tuple_by(order, ColumnReference(docs, c))
                    for c in data_cols
                },
            }
        )
        # every query gets a row; unmatched queries carry empty tuples
        defaults = query_table.select(
            **{
                _SCORE: (),
                _MATCHED_ID: (),
                **{c: () for c in data_cols},
            }
        )
        collapsed = defaults.update_rows(grouped)
        return JoinResult(
            query_table,
            collapsed,
            (_id_of(query_table) == _id_of(collapsed),),
            JoinMode.LEFT,
            # output rows keep the QUERY row ids (reference: a maintained
            # query() result is keyed by its query table, so
            # `queries + index.get_nearest_items(...)` zips directly)
            id=_id_of(query_table),
        )


def _id_of(table: Table):
    from ...internals.expression import IdReference

    return IdReference(table)
