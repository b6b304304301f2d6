"""RAG question answering (reference
``python/pathway/xpacks/llm/question_answering.py``): ``BaseRAGQuestionAnswerer``
(:289), ``AdaptiveRAGQuestionAnswerer`` (:574) with the geometric-k retry
strategy (:97), summarization, and the HTTP ``RAGClient``.

Copy of ``pathway_tpu/xpacks/llm/question_answering.py``, with the port's
names instead of ``import pathway_tpu as pw``. Each question's embed and its
search run in the store's index (the encoder's attention kernel and the
scorer kernel on the card); the chat runs on the host, through the UDF's
cache. ``run_server`` takes ``device=`` (default ``"cuda"``) and passes it to
``pw.run``; with no card it raises unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import threading
from typing import Any

import torch

from ...internals import dtype as dt
from ...internals.expression import ColumnReference, apply_with_type
from ...internals.run import run as pw_run
from ...internals.schema import Schema, column_definition
from ...internals.table import Table
from ...internals.thisclass import left, right, this
from ...stdlib.indexing.data_index import _SCORE
from . import prompts
from ._utils import HttpClientBase, doc_dicts
from .prompts import NO_INFO_ANSWER

__all__ = [
    "answer_with_geometric_rag_strategy",
    "answer_with_geometric_rag_strategy_from_index",
    "BaseRAGQuestionAnswerer",
    "AdaptiveRAGQuestionAnswerer",
    "SummaryQuestionAnswerer",
    "RAGClient",
]


def answer_with_geometric_rag_strategy(
    question: str,
    documents: list[str],
    llm_chat: Any,
    n_starting_documents: int = 2,
    factor: int = 2,
    max_iterations: int = 4,
    strict_prompt: bool = False,
) -> str:
    """Adaptive RAG (reference question_answering.py:97): try the cheapest
    context first (n_starting_documents), re-ask with geometrically more
    documents only when the model says it can't answer. Saves tokens on easy
    questions while keeping recall on hard ones."""
    docs = list(documents or ())
    n = n_starting_documents
    for _ in range(max_iterations):
        chunk = docs[:n]
        prompt = prompts.prompt_qa_geometric_rag(question, chunk)
        answer = llm_chat.__wrapped__(prompt)
        text = str(answer).strip()
        if text and NO_INFO_ANSWER.lower() not in text.lower():
            return text
        if n >= len(docs):
            break
        n *= factor
    return NO_INFO_ANSWER


def answer_with_geometric_rag_strategy_from_index(
    questions,
    index,
    documents_column_name: str,
    llm_chat,
    n_starting_documents: int = 2,
    factor: int = 2,
    max_iterations: int = 4,
) -> Table:
    """Column-level form: retrieve max-needed docs once, then run the
    geometric strategy per row (reference :201)."""
    max_docs = n_starting_documents * factor ** (max_iterations - 1)
    hits = index.query_as_of_now(
        ColumnReference(questions.table, questions.name)
        if hasattr(questions, "table") else questions,
        number_of_matches=max_docs,
        collapse_rows=True,
    ).select(
        query=left[questions.name if hasattr(questions, "name") else "query"],
        docs=right[documents_column_name],
    )
    return hits.select(
        result=apply_with_type(
            lambda q, docs: answer_with_geometric_rag_strategy(
                q, list(docs or ()), llm_chat,
                n_starting_documents, factor, max_iterations,
            ),
            dt.STR, this.query, this.docs,
        )
    )


class _CallableChat:
    """Adapter: a plain prompt->reply callable with the BaseChat call
    surface expected by answer_with_geometric_rag_strategy."""

    def __init__(self, fn):
        self.__wrapped__ = fn


class BaseRAGQuestionAnswerer:
    """Standard RAG: retrieve top-k chunks, fill the prompt template, ask
    the chat (reference question_answering.py:289). Exposes the live query
    surfaces used by the REST servers: ``answer_query``, ``retrieve``,
    ``statistics``, ``list_documents``, ``summarize_query``."""

    class AnswerQuerySchema(Schema):
        prompt: str
        filters: str | None = column_definition(default_value=None)
        model: str | None = column_definition(default_value=None)
        return_context_docs: bool | None = column_definition(default_value=False)

    class SummarizeQuerySchema(Schema):
        text_list: Any

    def __init__(
        self,
        llm: Any,
        indexer: Any,  # DocumentStore | VectorStoreServer
        *,
        default_llm_name: str | None = None,
        prompt_template: Any = None,
        search_topk: int = 6,
    ):
        self.llm = llm
        self.indexer = indexer
        self.prompt_template = prompt_template or prompts.prompt_qa
        self.search_topk = search_topk
        self._server = None
        self._server_thread = None
        self._llm_fn_cached = None

    def _llm_fn(self):
        """The chat as a plain callable, routed through the UDF's
        cache/retry pipeline (``UDF._prepare``) so ``with_cache`` works."""
        if self._llm_fn_cached is None:
            from ...udfs import AsyncExecutor

            prepare = getattr(self.llm, "_prepare", None)
            if prepare is not None and not isinstance(
                getattr(self.llm, "_executor", None), AsyncExecutor
            ):
                self._llm_fn_cached = prepare()
            else:
                # async retry/capacity wrappers can't be driven from this
                # synchronous call path, but the cache wrapper can — don't
                # silently drop with_cache for async-executor chats
                fn = self.llm.__wrapped__
                cache = getattr(self.llm, "_cache_strategy", None)
                if cache is not None:
                    fn = cache.wrap(fn)
                self._llm_fn_cached = fn
        return self._llm_fn_cached

    def _enable_cache(self, cache_backend: Any) -> None:
        """reference run_server(with_cache=True): cache LLM replies."""
        from ...udfs import CacheStrategy, DiskCache, InMemoryCache

        if getattr(self.llm, "_cache_strategy", None) is None:
            if cache_backend is None:
                strategy: CacheStrategy = InMemoryCache()
            elif isinstance(cache_backend, CacheStrategy):
                strategy = cache_backend
            else:
                strategy = DiskCache()
            self.llm._cache_strategy = strategy
        self._llm_fn_cached = None  # rebuild with the cache wrapper

    # -- dataflows -----------------------------------------------------------

    def _retrieve_for_answer(self, pw_ai_queries: Table, k: int) -> Table:
        """One row per query: prompt, return_context_docs, docs(tuple of
        {text, metadata, dist} dicts best-first) — via a collapsed
        query_as_of_now over the store's index."""
        store = self.indexer
        q = pw_ai_queries.select(
            query=this.prompt,
            prompt=this.prompt,
            return_context_docs=this.return_context_docs,
            __filter=this.filters,
        )
        hits = store.index.query_as_of_now(
            ColumnReference(q, "query"),
            number_of_matches=k,
            collapse_rows=True,
            metadata_filter=this["__filter"],
        )
        picked = hits.select(
            qid=left.id,
            prompt=left.prompt,
            return_context_docs=left.return_context_docs,
            docs=apply_with_type(
                doc_dicts, dt.ANY,
                right.text, right._metadata, right[_SCORE],
            ),
        )
        # responses must be keyed by the incoming query rows (the REST
        # writer completes futures by row key) — restore the query ids
        return picked.with_id(this.qid).select(
            prompt=this.prompt,
            return_context_docs=this.return_context_docs,
            docs=this.docs,
        )

    def answer_query(self, pw_ai_queries: Table) -> Table:
        """result column = answer string (+ context docs when asked)."""
        q = self._retrieve_for_answer(pw_ai_queries, self.search_topk)
        template = self.prompt_template

        llm_fn = self._llm_fn()

        def _answer(prompt, docs, return_ctx):
            texts = [d.get("text") if isinstance(d, dict) else str(d) for d in docs or ()]
            reply = llm_fn(template(prompt, texts))
            if return_ctx:
                return {"response": str(reply), "context_docs": list(docs or ())}
            return str(reply)

        return q.select(
            result=apply_with_type(
                _answer, dt.ANY, this.prompt, this.docs, this.return_context_docs,
            )
        )

    def summarize_query(self, summarize_queries: Table) -> Table:
        llm_fn = self._llm_fn()

        def _sum(text_list):
            return str(llm_fn(prompts.prompt_summarize(text_list)))

        return summarize_queries.select(
            result=apply_with_type(_sum, dt.STR, this.text_list)
        )

    def retrieve(self, queries: Table) -> Table:
        return self.indexer.retrieve_query(queries)

    def statistics(self, queries: Table) -> Table:
        return self.indexer.statistics_query(queries)

    def list_documents(self, queries: Table) -> Table:
        return self.indexer.inputs_query(queries)

    # -- serving ----------------------------------------------------------

    def build_server(self, host: str, port: int, **rest_kwargs: Any) -> None:
        """Register every REST route on one webserver (reference
        question_answering.py build_server / servers.py QARestServer)."""
        from ...io.http._server import PathwayWebserver, rest_connector
        from .document_store import DocumentStore

        webserver = PathwayWebserver(host, port)
        self._server = webserver

        routes: list[tuple[str, Any, Any]] = [
            ("/v1/pw_ai_answer", self.AnswerQuerySchema, self.answer_query),
            ("/v2/answer", self.AnswerQuerySchema, self.answer_query),
            ("/v1/pw_ai_summary", self.SummarizeQuerySchema, self.summarize_query),
            ("/v2/summarize", self.SummarizeQuerySchema, self.summarize_query),
            ("/v1/retrieve", DocumentStore.RetrieveQuerySchema, self.retrieve),
            ("/v2/retrieve", DocumentStore.RetrieveQuerySchema, self.retrieve),
            ("/v1/statistics", DocumentStore.StatisticsQuerySchema, self.statistics),
            ("/v1/pw_list_documents", DocumentStore.InputsQuerySchema, self.list_documents),
            ("/v2/list_documents", DocumentStore.InputsQuerySchema, self.list_documents),
        ]
        for route, schema, handler in routes:
            queries, writer = rest_connector(
                webserver=webserver, route=route, schema=schema,
                delete_completed_queries=True, **rest_kwargs,
            )
            writer(handler(queries))

    def run_server(
        self,
        host: str | None = None,
        port: int | None = None,
        *,
        threaded: bool = False,
        with_cache: bool = False,
        cache_backend: Any = None,
        device: str | torch.device = "cuda",
        **kwargs: Any,
    ):
        if with_cache:
            self._enable_cache(cache_backend)
        if self._server is None:
            if host is None or port is None:
                raise ValueError("pass host and port (or call build_server first)")
            self.build_server(host, port)
        if threaded:
            t = threading.Thread(target=lambda: pw_run(device=device, **kwargs), daemon=True)
            t.start()
            self._server_thread = t
            return t
        pw_run(device=device, **kwargs)


class AdaptiveRAGQuestionAnswerer(BaseRAGQuestionAnswerer):
    """Geometric-k adaptive retrieval (reference :574): answer first from a
    small context, expand ×factor only on 'no information' replies."""

    def __init__(
        self,
        llm: Any,
        indexer: Any,
        *,
        n_starting_documents: int = 2,
        factor: int = 2,
        max_iterations: int = 4,
        **kwargs: Any,
    ):
        super().__init__(llm, indexer, **kwargs)
        self.n_starting_documents = n_starting_documents
        self.factor = factor
        self.max_iterations = max_iterations

    def answer_query(self, pw_ai_queries: Table) -> Table:
        max_docs = self.n_starting_documents * self.factor ** (
            self.max_iterations - 1
        )
        q = self._retrieve_for_answer(pw_ai_queries, max_docs)

        llm_shim = _CallableChat(self._llm_fn())

        def _answer(prompt, docs, return_ctx):
            texts = [d.get("text") if isinstance(d, dict) else str(d) for d in docs or ()]
            reply = answer_with_geometric_rag_strategy(
                prompt, texts, llm_shim,
                self.n_starting_documents, self.factor, self.max_iterations,
            )
            if return_ctx:
                return {"response": reply, "context_docs": list(docs or ())}
            return reply

        return q.select(
            result=apply_with_type(
                _answer, dt.ANY, this.prompt, this.docs, this.return_context_docs,
            )
        )


class SummaryQuestionAnswerer(BaseRAGQuestionAnswerer):
    """Alias surface whose primary endpoint is summarization."""


class RAGClient(HttpClientBase):
    """HTTP client for the QA servers (reference question_answering.py
    RAGClient) — stdlib urllib, no extra deps."""

    def __init__(self, host: str | None = None, port: int | None = None, url: str | None = None, timeout: float = 90.0):
        super().__init__(host, port, url, timeout)

    def answer(self, prompt: str, filters: str | None = None, return_context_docs: bool = False) -> Any:
        payload: dict[str, Any] = {"prompt": prompt}
        if filters is not None:
            payload["filters"] = filters
        if return_context_docs:
            payload["return_context_docs"] = True
        return self._post("/v2/answer", payload)

    pw_ai_answer = answer

    def summarize(self, text_list: list[str]) -> Any:
        return self._post("/v2/summarize", {"text_list": list(text_list)})

    pw_ai_summary = summarize

    def retrieve(self, query: str, k: int = 6, metadata_filter: str | None = None, filepath_globpattern: str | None = None) -> Any:
        return self._post("/v2/retrieve", {
            "query": query, "k": k,
            "metadata_filter": metadata_filter,
            "filepath_globpattern": filepath_globpattern,
        })

    def statistics(self) -> Any:
        return self._post("/v1/statistics", {})

    def list_documents(self, filters: str | None = None) -> Any:
        return self._post("/v2/list_documents", {"metadata_filter": filters})

    pw_list_documents = list_documents
