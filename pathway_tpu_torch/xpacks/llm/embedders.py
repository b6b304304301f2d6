"""Embedder UDFs: port of ``pathway_tpu/xpacks/llm/embedders.py``.

``TorchEmbedder`` is the counterpart of the reference's ``TpuEmbedder``: sentence embeddings from
the port's encoder (``models/embedder.py``) on the card. As a UDF, calling it on a column builds
an expression; ``__wrapped__`` (or ``_embed``) embeds one text, ``embed_batch`` a list in one
forward per length bucket. The client embedders need their packages (and a network) and raise
``ImportError`` without them, as the reference's do.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..._device import resolve_device
from ...udfs import UDF, CacheStrategy, Executor

__all__ = [
    "BaseEmbedder",
    "TorchEmbedder",
    "SentenceTransformerEmbedder",
    "OpenAIEmbedder",
    "LiteLLMEmbedder",
    "GeminiEmbedder",
]


class BaseEmbedder(UDF):
    """text -> np.ndarray[float] column UDF. Subclasses implement ``_embed(text) -> np.ndarray``;
    ``get_embedding_dimension`` probes with a sample call."""

    def __init__(
        self,
        *,
        cache_strategy: CacheStrategy | None = None,
        executor: Executor | None = None,
        **kwargs: Any,
    ):
        super().__init__(cache_strategy=cache_strategy, executor=executor)
        self.kwargs = kwargs

    def _embed(self, text: str, **kwargs: Any) -> np.ndarray:
        raise NotImplementedError

    def __wrapped__(self, text: str, **kwargs: Any) -> np.ndarray:
        return self._embed(text or ".", **{**self.kwargs, **kwargs})

    def get_embedding_dimension(self, **kwargs: Any) -> int:
        return len(self.__wrapped__(".", **kwargs))


class TorchEmbedder(BaseEmbedder):
    """Sentence embeddings from the port's encoder on ``device`` (default the card; with no
    card it raises unless the caller passes ``device="cpu"``)."""

    def __init__(self, embedder: Any = None, *, model_path: str | None = None,
                 max_len: int = 128, device: str | torch.device = "cuda", **kwargs: Any):
        """``model_path``: a local directory with a MiniLM-class HF checkpoint
        (``pytorch_model.bin`` + ``config.json``, optionally ``vocab.txt``): loads the pretrained
        weights and the WordPiece tokenizer. Default: the seeded-init encoder."""
        super().__init__(**kwargs)
        self.device = resolve_device(device)
        if embedder is None:
            from ...models.embedder import Embedder

            if model_path is not None:
                embedder = Embedder.from_pretrained(model_path, device=self.device)
            else:
                embedder = Embedder(device=self.device)
        self.embedder = embedder
        self.max_len = max_len

    def _embed(self, text: str, **kwargs: Any) -> np.ndarray:
        return self.embedder.embed_texts([text], max_len=self.max_len)[0]

    def embed_batch(self, texts: list[str]) -> np.ndarray:
        return self.embedder.embed_texts(list(texts), max_len=self.max_len)


class SentenceTransformerEmbedder(BaseEmbedder):
    """Needs ``sentence_transformers`` (TorchEmbedder is the native equivalent). Runs on
    ``device`` (default the card; with no card it raises unless the caller passes
    ``device="cpu"``)."""

    def __init__(self, model: str, call_kwargs: dict = {}, device: str | torch.device = "cuda",
                 **kwargs: Any):
        self.device = resolve_device(device)
        try:
            import sentence_transformers  # type: ignore[import-not-found]
        except ImportError as e:
            raise ImportError(
                "SentenceTransformerEmbedder requires the "
                "'sentence_transformers' package; TorchEmbedder is the native "
                "on-device equivalent"
            ) from e
        super().__init__(**kwargs)
        self.model = sentence_transformers.SentenceTransformer(model, device=str(self.device))
        self.call_kwargs = call_kwargs

    def _embed(self, text: str, **kwargs: Any) -> np.ndarray:
        return self.model.encode(text, **{**self.call_kwargs, **kwargs})


class OpenAIEmbedder(BaseEmbedder):
    """Needs ``openai`` and a network."""

    def __init__(self, model: str | None = "text-embedding-3-small", **kwargs: Any):
        try:
            import openai  # type: ignore[import-not-found]  # noqa: F401
        except ImportError as e:
            raise ImportError("OpenAIEmbedder requires the 'openai' package") from e
        super().__init__(**kwargs)
        self.model = model

    def _embed(self, text: str, **kwargs: Any) -> np.ndarray:
        import openai  # type: ignore[import-not-found]

        client = openai.OpenAI()
        ret = client.embeddings.create(
            input=[text], model=kwargs.pop("model", self.model), **kwargs
        )
        return np.asarray(ret.data[0].embedding)


class LiteLLMEmbedder(BaseEmbedder):
    """Needs ``litellm``."""

    def __init__(self, model: str | None = None, **kwargs: Any):
        try:
            import litellm  # type: ignore[import-not-found]  # noqa: F401
        except ImportError as e:
            raise ImportError("LiteLLMEmbedder requires the 'litellm' package") from e
        super().__init__(**kwargs)
        self.model = model

    def _embed(self, text: str, **kwargs: Any) -> np.ndarray:
        import litellm  # type: ignore[import-not-found]

        ret = litellm.embedding(
            input=[text], model=kwargs.pop("model", self.model), **kwargs
        )
        return np.asarray(ret.data[0]["embedding"])


class GeminiEmbedder(BaseEmbedder):
    """Needs ``google.generativeai``."""

    def __init__(self, model: str | None = "models/text-embedding-004", **kwargs: Any):
        try:
            import google.generativeai  # type: ignore[import-not-found]  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "GeminiEmbedder requires the 'google-generativeai' package"
            ) from e
        super().__init__(**kwargs)
        self.model = model

    def _embed(self, text: str, **kwargs: Any) -> np.ndarray:
        import google.generativeai as genai  # type: ignore[import-not-found]

        ret = genai.embed_content(
            model=kwargs.pop("model", self.model), content=text, **kwargs
        )
        return np.asarray(ret["embedding"])
