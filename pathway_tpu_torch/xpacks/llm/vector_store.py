"""VectorStoreServer / VectorStoreClient.

Re-design of ``python/pathway/xpacks/llm/vector_store.py`` (server :38,
client :629): live document ingestion → parse → split → embed → KNN index,
served over the REST connector.

Copy of ``pathway_tpu/xpacks/llm/vector_store.py``. The default embedder is
the port's ``TorchEmbedder(device=...)`` (the encoder's attention kernel on
the card) feeding the brute-force index's scorer kernel (``ops/knn.py``).
``VectorStoreServer(device=)`` and ``run_server(device=)`` default to
``"cuda"``; with no card they raise unless the caller passes
``device="cpu"``. ``run_server(threaded=True)`` keeps what the engine's
thread raised in ``run_error``, as the QA servers' ``run`` does.
"""

from __future__ import annotations

import threading
from typing import Any, Callable

import torch

from ...internals.run import run as pw_run
from ...internals.table import Table
from ...stdlib.indexing.nearest_neighbors import BruteForceKnnFactory
from ._utils import HttpClientBase, run_on_thread
from .document_store import DocumentStore

__all__ = ["VectorStoreServer", "VectorStoreClient"]


class VectorStoreServer:
    """DocumentStore + an embedder-backed KNN index + REST endpoints
    (/v1/retrieve, /v1/statistics, /v1/inputs)."""

    def __init__(
        self,
        *docs: Table,
        embedder: Callable | None = None,
        parser: Callable | None = None,
        splitter: Callable | None = None,
        doc_post_processors: list[Callable] | None = None,
        index_factory: Any = None,
        device: str | torch.device = "cuda",
    ):
        if embedder is None and index_factory is None:
            from .embedders import TorchEmbedder

            embedder = TorchEmbedder(device=device)
        self.embedder = embedder
        if index_factory is None:
            dim = self._embedding_dimension(embedder)
            index_factory = BruteForceKnnFactory(
                dimensions=dim, embedder=self._embed_fn(embedder)
            )
        self.store = DocumentStore(
            list(docs),
            index_factory,
            parser=parser,
            splitter=splitter,
            doc_post_processors=doc_post_processors,
        )
        self._threads: list[threading.Thread] = []
        self.run_error: BaseException | None = None

    @classmethod
    def from_langchain_components(
        cls,
        *docs: Table,
        embedder: Any,
        parser: Callable | None = None,
        splitter: Any = None,
        **kwargs: Any,
    ) -> "VectorStoreServer":
        """Build from LangChain components (reference vector_store.py:92):
        the embedder's ``embed_documents`` backs the index, a LangChain
        document transformer becomes the splitter. Client-gated on
        ``langchain_core`` like the reference."""
        try:
            from langchain_core.documents import Document  # type: ignore[import-not-found]
        except ImportError as e:
            raise ImportError(
                "Please install langchain_core: `pip install langchain_core`"
            ) from e

        generic_splitter = None
        if splitter is not None:
            def generic_splitter(x: str) -> list[tuple[str, dict]]:
                return [
                    (doc.page_content, dict(doc.metadata))
                    for doc in splitter.transform_documents(
                        [Document(page_content=x)]
                    )
                ]

        def generic_embedder(x: str) -> list[float]:
            return embedder.embed_documents([x])[0]

        return cls(
            *docs,
            embedder=generic_embedder,
            parser=parser,
            splitter=generic_splitter,
            **kwargs,
        )

    @classmethod
    def from_llamaindex_components(
        cls,
        *docs: Table,
        transformations: list[Any],
        parser: Callable | None = None,
        **kwargs: Any,
    ) -> "VectorStoreServer":
        """Build from LlamaIndex TransformComponents (reference
        vector_store.py:135): the last transformation must be an embedding
        component; the prefix becomes the splitter pipeline. Client-gated
        on ``llama-index-core``."""
        try:
            from llama_index.core.base.embeddings.base import (  # type: ignore[import-not-found]
                BaseEmbedding,
            )
            from llama_index.core.ingestion.pipeline import (  # type: ignore[import-not-found]
                run_transformations,
            )
            from llama_index.core.schema import (  # type: ignore[import-not-found]
                MetadataMode,
                TextNode,
            )
        except ImportError as e:
            raise ImportError(
                "Please install llama-index-core: "
                "`pip install llama-index-core`"
            ) from e
        if not transformations:
            raise ValueError("Transformations list cannot be None or empty.")
        if not isinstance(transformations[-1], BaseEmbedding):
            raise ValueError(
                "The last transformation must be a LlamaIndex BaseEmbedding"
            )
        embedding = transformations[-1]
        prefix = list(transformations[:-1])

        def generic_splitter(x: str) -> list[tuple[str, dict]]:
            nodes = run_transformations([TextNode(text=x)], prefix)
            return [
                (
                    node.get_content(metadata_mode=MetadataMode.NONE),
                    dict(node.extra_info or {}),
                )
                for node in nodes
            ]

        def generic_embedder(x: str) -> list[float]:
            return embedding.get_text_embedding(x)

        return cls(
            *docs,
            embedder=generic_embedder,
            parser=parser,
            splitter=generic_splitter if prefix else None,
            **kwargs,
        )

    @staticmethod
    def _embed_fn(embedder: Any) -> Callable:
        for attr in ("func", "__wrapped__"):
            f = getattr(embedder, attr, None)
            if callable(f):
                return f
        return embedder

    @classmethod
    def _embedding_dimension(cls, embedder: Any) -> int:
        probe = getattr(embedder, "get_embedding_dimension", None)
        if probe is not None:
            return int(probe())
        return len(cls._embed_fn(embedder)("."))

    # -- query surfaces (DocumentStore pass-throughs) ---------------------

    RetrieveQuerySchema = DocumentStore.RetrieveQuerySchema
    StatisticsQuerySchema = DocumentStore.StatisticsQuerySchema
    InputsQuerySchema = DocumentStore.InputsQuerySchema

    @property
    def index(self):
        return self.store.index

    def retrieve_query(self, queries: Table) -> Table:
        return self.store.retrieve_query(queries)

    def statistics_query(self, queries: Table) -> Table:
        return self.store.statistics_query(queries)

    def inputs_query(self, queries: Table) -> Table:
        return self.store.inputs_query(queries)

    # -- serving ----------------------------------------------------------

    def build_server(self, host: str, port: int, **rest_kwargs: Any) -> None:
        from ...io.http._server import PathwayWebserver, rest_connector

        webserver = PathwayWebserver(host, port)
        routes = [
            ("/v1/retrieve", self.RetrieveQuerySchema, self.retrieve_query),
            ("/v1/statistics", self.StatisticsQuerySchema, self.statistics_query),
            ("/v1/inputs", self.InputsQuerySchema, self.inputs_query),
        ]
        for route, schema, handler in routes:
            queries, writer = rest_connector(
                webserver=webserver, route=route, schema=schema,
                delete_completed_queries=True, **rest_kwargs,
            )
            writer(handler(queries))

    def run_server(
        self,
        host: str,
        port: int,
        *,
        threaded: bool = False,
        with_cache: bool = False,
        cache_backend: Any = None,
        device: str | torch.device = "cuda",
        **kwargs: Any,
    ):
        if with_cache:
            raise NotImplementedError(
                "with_cache caches LLM replies in the QA servers; the vector "
                "store has no LLM surface — wrap your embedder in a "
                "pw.udfs CacheStrategy instead"
            )
        self.build_server(host, port)
        if threaded:
            t = run_on_thread(self, device=device, **kwargs)
            self._threads.append(t)
            return t
        pw_run(device=device, **kwargs)


class VectorStoreClient(HttpClientBase):
    """stdlib-urllib client for VectorStoreServer (reference :629)."""

    def query(
        self,
        query: str,
        k: int = 3,
        metadata_filter: str | None = None,
        filepath_globpattern: str | None = None,
    ) -> list[dict]:
        return self._post("/v1/retrieve", {
            "query": query, "k": k,
            "metadata_filter": metadata_filter,
            "filepath_globpattern": filepath_globpattern,
        })

    __call__ = query

    def get_vectorstore_statistics(self) -> dict:
        return self._post("/v1/statistics", {})

    def get_input_files(
        self,
        metadata_filter: str | None = None,
        filepath_globpattern: str | None = None,
    ) -> list:
        return self._post("/v1/inputs", {
            "metadata_filter": metadata_filter,
            "filepath_globpattern": filepath_globpattern,
        })
