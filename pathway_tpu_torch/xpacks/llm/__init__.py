"""``pw.xpacks.llm`` — the RAG toolkit: port of ``pathway_tpu/xpacks/llm/__init__.py``.

Ported: parsers, splitters, embedders (``TorchEmbedder`` on the card), the live
``DocumentStore`` and the REST servers. Not ported yet (ROADMAP Queue 1 item 13): ``llms``,
``prompts``, ``question_answering``, ``rerankers`` and ``vector_store``.
"""

from . import document_store, embedders, parsers, servers, splitters  # noqa: F401
from .document_store import DocumentStore, SlidesDocumentStore  # noqa: F401
from .servers import DocumentStoreServer  # noqa: F401

__all__ = [
    "embedders",
    "splitters",
    "parsers",
    "document_store",
    "servers",
    "DocumentStore",
    "SlidesDocumentStore",
    "DocumentStoreServer",
]
