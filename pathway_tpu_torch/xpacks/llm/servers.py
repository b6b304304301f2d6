"""REST serving wrappers over the streaming ``rest_connector``: port of
``pathway_tpu/xpacks/llm/servers.py`` (``DocumentStoreServer``, ``QARestServer``,
``QASummaryRestServer``).

``run`` takes ``device=`` (default ``"cuda"``) and passes it to the port's ``run``; with no card
it raises unless the caller passes ``device="cpu"``. ``run(threaded=True)`` runs the engine on a
daemon thread and keeps what it raised in ``run_error``. The QA servers serve the routes of
``question_answering.py``'s answerers.
"""

from __future__ import annotations

import threading
from typing import Any

import torch

from ...internals.run import run as pw_run
from ._utils import run_on_thread
from .document_store import DocumentStore

__all__ = ["BaseRestServer", "DocumentStoreServer", "QARestServer", "QASummaryRestServer"]


class BaseRestServer:
    """Owns one PathwayWebserver; subclasses register routes then
    ``run()`` executes the engine (reference servers.py BaseRestServer)."""

    def __init__(self, host: str, port: int, **rest_kwargs: Any):
        from ...io.http._server import PathwayWebserver

        self.host = host
        self.port = port
        self.webserver = PathwayWebserver(host, port)
        self.rest_kwargs = rest_kwargs
        self._thread: threading.Thread | None = None
        self.run_error: BaseException | None = None

    def serve(self, route: str, schema: Any, handler: Any, **kwargs: Any) -> None:
        from ...io.http._server import rest_connector

        queries, writer = rest_connector(
            webserver=self.webserver, route=route, schema=schema,
            delete_completed_queries=True, **{**self.rest_kwargs, **kwargs},
        )
        writer(handler(queries))

    def run(self, *, threaded: bool = False, with_cache: bool = False,
            cache_backend: Any = None, device: str | torch.device = "cuda", **kwargs: Any):
        if with_cache:
            enable = getattr(
                getattr(self, "rag", None) or getattr(self, "document_store", None),
                "_enable_cache", None,
            )
            if enable is None:
                raise NotImplementedError(
                    "with_cache is supported for QA servers (LLM reply "
                    "caching); this server has no cacheable UDF surface"
                )
            enable(cache_backend)
        if threaded:
            self._thread = run_on_thread(self, device=device, **kwargs)
            return self._thread
        pw_run(device=device, **kwargs)


class DocumentStoreServer(BaseRestServer):
    """/v1/retrieve /v1/statistics /v1/inputs over a DocumentStore
    (reference servers.py:16)."""

    def __init__(self, host: str, port: int, document_store: DocumentStore, **kwargs: Any):
        super().__init__(host, port, **kwargs)
        self.document_store = document_store
        self.serve("/v1/retrieve", DocumentStore.RetrieveQuerySchema,
                   document_store.retrieve_query)
        self.serve("/v1/statistics", DocumentStore.StatisticsQuerySchema,
                   document_store.statistics_query)
        self.serve("/v1/inputs", DocumentStore.InputsQuerySchema,
                   document_store.inputs_query)


class QARestServer(BaseRestServer):
    """/v1/pw_ai_answer + retrieval/statistics/list endpoints over a
    RAG question answerer (reference servers.py:91)."""

    def __init__(self, host: str, port: int, rag_question_answerer: Any, **kwargs: Any):
        super().__init__(host, port, **kwargs)
        self.rag = rag_question_answerer
        self.serve("/v1/pw_ai_answer", rag_question_answerer.AnswerQuerySchema,
                   rag_question_answerer.answer_query)
        self.serve("/v2/answer", rag_question_answerer.AnswerQuerySchema,
                   rag_question_answerer.answer_query)
        self.serve("/v1/retrieve", DocumentStore.RetrieveQuerySchema,
                   rag_question_answerer.retrieve)
        self.serve("/v2/retrieve", DocumentStore.RetrieveQuerySchema,
                   rag_question_answerer.retrieve)
        self.serve("/v1/statistics", DocumentStore.StatisticsQuerySchema,
                   rag_question_answerer.statistics)
        self.serve("/v1/pw_list_documents", DocumentStore.InputsQuerySchema,
                   rag_question_answerer.list_documents)
        self.serve("/v2/list_documents", DocumentStore.InputsQuerySchema,
                   rag_question_answerer.list_documents)


class QASummaryRestServer(QARestServer):
    """QARestServer + the summarization endpoint (reference servers.py:160)."""

    def __init__(self, host: str, port: int, rag_question_answerer: Any, **kwargs: Any):
        super().__init__(host, port, rag_question_answerer, **kwargs)
        self.serve("/v1/pw_ai_summary", rag_question_answerer.SummarizeQuerySchema,
                   rag_question_answerer.summarize_query)
        self.serve("/v2/summarize", rag_question_answerer.SummarizeQuerySchema,
                   rag_question_answerer.summarize_query)
