"""``pw.xpacks.llm`` — the RAG toolkit: port of ``pathway_tpu/xpacks/llm/__init__.py``.

Chats (``llms``; the hosted ones need their client packages), prompts, parsers, splitters,
embedders (``TorchEmbedder`` on the card), rerankers, the live ``DocumentStore`` and
``VectorStoreServer``, the RAG question answerers and the REST servers.
"""

from . import (  # noqa: F401
    document_store,
    embedders,
    llms,
    parsers,
    prompts,
    question_answering,
    rerankers,
    servers,
    splitters,
    vector_store,
)
from .document_store import DocumentStore, SlidesDocumentStore  # noqa: F401
from .question_answering import (  # noqa: F401
    AdaptiveRAGQuestionAnswerer,
    BaseRAGQuestionAnswerer,
    RAGClient,
)
from .servers import DocumentStoreServer  # noqa: F401
from .vector_store import VectorStoreClient, VectorStoreServer  # noqa: F401

__all__ = [
    "llms",
    "embedders",
    "splitters",
    "parsers",
    "rerankers",
    "prompts",
    "document_store",
    "vector_store",
    "question_answering",
    "servers",
    "DocumentStore",
    "SlidesDocumentStore",
    "VectorStoreServer",
    "VectorStoreClient",
    "BaseRAGQuestionAnswerer",
    "AdaptiveRAGQuestionAnswerer",
    "RAGClient",
    "DocumentStoreServer",
]
