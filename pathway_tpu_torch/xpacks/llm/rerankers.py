"""Rerankers (reference ``python/pathway/xpacks/llm/rerankers.py``):
LLM-as-judge, encoder similarity, cross-encoder (gated), plus the
``rerank_topk_filter`` post-processing helper.

Copy of ``pathway_tpu/xpacks/llm/rerankers.py``. ``EncoderReranker`` over the
port's ``TorchEmbedder`` embeds the document and the query one text at a time,
as the reference does: each call is two one-row encoder forwards.
"""

from __future__ import annotations

import re
from typing import Any

import numpy as np

from ...internals import dtype as dt
from ...internals.expression import apply_with_type
from ...udfs import UDF

__all__ = [
    "LLMReranker",
    "EncoderReranker",
    "CrossEncoderReranker",
    "rerank_topk_filter",
]


class LLMReranker(UDF):
    """Ask a chat model to score doc/query relevance 1-5
    (reference rerankers.py LLMReranker)."""

    PROMPT = (
        "Given a query and a document, rate on an integer scale of 1 to 5 "
        "how relevant the document is to the query. Answer with only the "
        "number.\n\nDocument: {doc}\n\nQuery: {query}\nScore:"
    )

    def __init__(self, llm: Any, **kwargs: Any):
        super().__init__(**kwargs)
        self.llm = llm

    def __wrapped__(self, doc: str, query: str, **kwargs: Any) -> float:
        reply = self.llm.__wrapped__(self.PROMPT.format(doc=doc, query=query))
        m = re.search(r"[1-5]", str(reply))
        return float(m.group()) if m else 1.0


class EncoderReranker(UDF):
    """Cosine similarity of embedder outputs
    (reference rerankers.py EncoderReranker)."""

    def __init__(self, embedder: Any, **kwargs: Any):
        super().__init__(**kwargs)
        self.embedder = embedder

    def __wrapped__(self, doc: str, query: str, **kwargs: Any) -> float:
        dv = np.asarray(self.embedder.__wrapped__(doc), dtype=np.float64)
        qv = np.asarray(self.embedder.__wrapped__(query), dtype=np.float64)
        denom = float(np.linalg.norm(dv) * np.linalg.norm(qv)) or 1e-12
        return float(dv @ qv / denom)


class CrossEncoderReranker(UDF):
    """reference rerankers.py CrossEncoderReranker — requires
    ``sentence_transformers`` (not baked in)."""

    def __init__(self, model_name: str, **kwargs: Any):
        try:
            from sentence_transformers import CrossEncoder  # type: ignore[import-not-found]
        except ImportError as e:
            raise ImportError(
                "CrossEncoderReranker requires 'sentence_transformers'; "
                "EncoderReranker (with TorchEmbedder) is the native path"
            ) from e
        super().__init__(**kwargs)
        self.model = CrossEncoder(model_name)

    def __wrapped__(self, doc: str, query: str, **kwargs: Any) -> float:
        return float(self.model.predict([[query, doc]])[0])


def rerank_topk_filter(docs, scores, k: int = 5):
    """Sort (docs, scores) by score desc and keep top-k — used as an apply
    over collapsed match tuples (reference rerankers.py:rerank_topk_filter)."""
    pairs = sorted(zip(docs or (), scores or ()), key=lambda p: -p[1])[:k]
    if not pairs:
        return ((), ())
    top_docs, top_scores = zip(*pairs)
    return (tuple(top_docs), tuple(top_scores))


def rerank_topk_filter_expr(docs_col, scores_col, k: int = 5):
    """Expression form of rerank_topk_filter."""
    return apply_with_type(
        lambda d, s: rerank_topk_filter(d, s, k), dt.ANY, docs_col, scores_col
    )
