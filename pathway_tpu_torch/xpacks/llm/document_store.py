"""DocumentStore — live parse→split→index retrieval over any connector.

Port of ``pathway_tpu/xpacks/llm/document_store.py``: documents stream in from connectors
(``data`` bytes + optional ``_metadata``), are parsed and chunked by UDFs, and indexed by an
``InnerIndexFactory`` (brute-force KNN on the card, LSH, BM25, or hybrid —
``pathway_tpu_torch/stdlib/indexing``). Retrieval/statistics/inputs queries are live tables, so
answers update as documents change. The pipeline is the reference's, line for line; the names
come from the port's modules instead of ``import pathway_tpu as pw``.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable

from ... import reducers
from ...internals import dtype as dt
from ...internals.expression import ColumnReference, apply_with_type
from ...internals.schema import Schema, column_definition
from ...internals.table import Table
from ...internals.thisclass import left, right, this
from ...stdlib.indexing.data_index import _SCORE
from ._utils import doc_dicts

__all__ = ["DocumentStore", "SlidesDocumentStore"]


class DocumentStore:
    """parse → (post-process) → split → index; query surfaces mirroring the
    reference: ``retrieve_query``, ``statistics_query``, ``inputs_query``."""

    class RetrieveQuerySchema(Schema):
        query: str
        k: int
        metadata_filter: str | None = column_definition(default_value=None)
        filepath_globpattern: str | None = column_definition(default_value=None)

    class StatisticsQuerySchema(Schema):
        pass

    class InputsQuerySchema(Schema):
        metadata_filter: str | None = column_definition(default_value=None)
        filepath_globpattern: str | None = column_definition(default_value=None)

    def __init__(
        self,
        docs: Table | Iterable[Table],
        retriever_factory: Any,
        parser: Callable | None = None,
        splitter: Callable | None = None,
        doc_post_processors: list[Callable] | None = None,
        vector_column: str | None = None,
    ):
        from .splitters import NullSplitter

        if isinstance(docs, Table):
            docs_list = [docs]
        else:
            docs_list = list(docs)
        if not docs_list:
            raise ValueError("DocumentStore needs at least one docs table")
        self.docs = (
            docs_list[0]
            if len(docs_list) == 1
            else docs_list[0].concat_reindex(*docs_list[1:])
        )
        self.parser = parser or self.default_parser()
        self.splitter = splitter or NullSplitter()
        self.doc_post_processors = doc_post_processors or []
        self.retriever_factory = retriever_factory
        #: pre-embedded mode: when set, ``docs`` rows are already chunks and
        #: this column holds their embedding vectors — parse/split are
        #: skipped and the index is built over the vectors directly (the
        #: retriever's embedder then only embeds queries). The common
        #: "embeddings computed offline / by another pipeline" deployment.
        self.vector_column = vector_column
        self.build_pipeline()

    @staticmethod
    def default_parser():
        from .parsers import ParseUtf8

        return ParseUtf8()

    # ------------------------------------------------------------------

    def _ensure_metadata(self, table: Table) -> Table:
        if "_metadata" in table.column_names():
            return table
        return table.with_columns(_metadata=apply_with_type(
            lambda d: {}, dt.ANY, this.data
        ))

    def build_pipeline(self) -> None:
        docs = self._ensure_metadata(self.docs)

        if self.vector_column is not None:
            # pre-embedded chunks: index straight over the vector column
            chunked = docs.select(
                text=this.data,
                _metadata=this._metadata,
                _pw_vector=this[self.vector_column],
            )
            self.parsed_documents = chunked.select(
                text=this.text, _metadata=this._metadata
            )
            self.chunked_documents = chunked
            self.index = self.retriever_factory.build_index(
                ColumnReference(chunked, "_pw_vector"),
                chunked,
                metadata_column=this._metadata,
            )
            return

        # parse: data -> [(text, meta)]; one row per parsed part
        parsed = docs.select(
            parts=self.parser(this.data), _metadata=this._metadata
        ).flatten(this.parts)
        parsed = parsed.select(
            text=apply_with_type(lambda p: p[0], dt.STR, this.parts),
            _metadata=apply_with_type(
                lambda p, m: {**(m or {}), **(p[1] or {})},
                dt.ANY, this.parts, this._metadata,
            ),
        )
        for post in self.doc_post_processors:
            parsed = parsed.select(
                text=apply_with_type(post, dt.STR, this.text),
                _metadata=this._metadata,
            )
        self.parsed_documents = parsed

        # split: text -> [(chunk, meta)]; one row per chunk
        chunked = parsed.select(
            chunks=self.splitter(this.text), _metadata=this._metadata
        ).flatten(this.chunks)
        chunked = chunked.select(
            text=apply_with_type(lambda c: c[0], dt.STR, this.chunks),
            _metadata=apply_with_type(
                lambda c, m: {**(m or {}), **(c[1] or {})},
                dt.ANY, this.chunks, this._metadata,
            ),
        )
        self.chunked_documents = chunked

        self.index = self.retriever_factory.build_index(
            ColumnReference(chunked, "text"),
            chunked,
            metadata_column=this._metadata,
        )

    # ------------------------------------------------------------------

    @staticmethod
    def merge_filters(metadata_filter: str | None, globpattern: str | None) -> str | None:
        """Combine a metadata filter and a path glob into one filter string
        (reference document_store.py _get_jmespath_filter)."""
        parts = []
        if metadata_filter:
            parts.append(f"({metadata_filter})")
        if globpattern:
            if "'" in globpattern:
                # the filter grammar's string literals have no escape form
                raise ValueError(
                    "filepath_globpattern must not contain single quotes"
                )
            parts.append(f"globmatch('{globpattern}', path)")
        return " && ".join(parts) if parts else None

    def retrieve_query(self, retrieval_queries: Table) -> Table:
        """One row per query: ``result`` = tuple of doc dicts
        (text/metadata/score as ``dist``), most relevant first."""
        queries = retrieval_queries.with_columns(
            __filter=apply_with_type(
                self.merge_filters, dt.Optional(dt.STR),
                this.metadata_filter, this.filepath_globpattern,
            ),
        )
        res = self.index.query_as_of_now(
            ColumnReference(queries, "query"),
            number_of_matches=this.k,
            collapse_rows=True,
            metadata_filter=this["__filter"],
        ).select(
            qid=left.id,
            result=apply_with_type(
                doc_dicts, dt.ANY,
                right.text, right._metadata, right[_SCORE],
            )
        )
        # key results by the incoming query rows (REST writers complete
        # responses by row key)
        return res.with_id(this.qid).select(result=this.result)

    def statistics_query(self, info_queries: Table) -> Table:
        """Global doc-count/last-modified stats per query row
        (reference document_store.py statistics_query)."""
        docs = self._ensure_metadata(self.docs)
        counts = docs.reduce(
            count=reducers.count(),
            last_modified=reducers.max(apply_with_type(
                lambda m: int((m or {}).get("modified_at", 0)), dt.INT,
                this._metadata,
            )),
        )
        stats = counts.select(
            __one=0,
            result=apply_with_type(
                lambda c, lm: {"file_count": int(c), "last_modified": int(lm)},
                dt.ANY, this.count, this.last_modified,
            )
        )
        tagged = info_queries.with_columns(__one=0)
        joined = tagged.join_left(
            stats, left["__one"] == right["__one"]
        ).select(qid=left.id, result=right.result)
        return joined.with_id(this.qid).select(result=this.result)

    def inputs_query(self, input_queries: Table) -> Table:
        """List indexed input files (path + metadata) per query row."""
        from ...utils.filters import compile_metadata_filter

        docs = self._ensure_metadata(self.docs)
        files = docs.reduce(
            metas=reducers.tuple(this._metadata),
        ).select(__one=0, metas=this.metas)

        def list_files(metas, metadata_filter, globpattern):
            flt = DocumentStore.merge_filters(metadata_filter, globpattern)
            pred = compile_metadata_filter(flt) if flt else None
            out = []
            for m in metas or ():
                m = m or {}
                if pred is None or pred(m):
                    out.append({"path": m.get("path"), **m})
            return tuple(out)

        tagged = input_queries.with_columns(__one=0)
        joined = tagged.join_left(
            files, left["__one"] == right["__one"]
        ).select(
            qid=left.id,
            result=apply_with_type(
                list_files, dt.ANY,
                right.metas, left.metadata_filter,
                left.filepath_globpattern,
            ),
        )
        return joined.with_id(this.qid).select(result=this.result)


class SlidesDocumentStore(DocumentStore):
    """Slide-deck flavor of the store (reference document_store.py:471):
    identical pipeline whose default parser is the slide pipeline
    (``parsers.SlideParser`` — per-slide parts with title/notes metadata,
    vision stage injectable), so decks land one searchable part per slide."""

    @staticmethod
    def default_parser():
        from .parsers import SlideParser

        return SlideParser()

    def parsed_documents_with_metadata(self) -> Table:
        return self.parsed_documents
