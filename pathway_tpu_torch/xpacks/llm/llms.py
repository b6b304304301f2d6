"""Chat wrappers as column UDFs.

Re-design of ``python/pathway/xpacks/llm/llms.py`` (``BaseChat`` :27,
``OpenAIChat`` :84, ``LiteLLMChat`` :313, ``HFPipelineChat`` :441,
``CohereChat`` :544). A chat is a ``pw.UDF`` mapping a message list (or a
plain prompt string) to the model's reply, so it composes with async
executors, retries and caching from ``pw.udfs``.

Copy of ``pathway_tpu/xpacks/llm/llms.py``. Hosted-API chats
(OpenAI/LiteLLM/Cohere) are gated imports: they raise the reference's
``ImportError`` at construction when their client library is missing.
``HFPipelineChat`` runs a local ``transformers`` pipeline (model weights
must be local) on ``device=`` (default ``"cuda"``; with no card it raises
unless the caller passes ``device="cpu"``).
"""

from __future__ import annotations

from typing import Any

import torch

from ..._device import resolve_device
from ...udfs import UDF, AsyncExecutor, CacheStrategy, Executor

__all__ = [
    "BaseChat",
    "OpenAIChat",
    "LiteLLMChat",
    "HFPipelineChat",
    "CohereChat",
    "prompt_chat_single_qa",
]


def _as_messages(prompt: Any) -> list[dict]:
    """Accept a plain string, a message dict, or a message list."""
    if isinstance(prompt, str):
        return [{"role": "user", "content": prompt}]
    if isinstance(prompt, dict):
        return [prompt]
    if isinstance(prompt, (list, tuple)):
        return [m if isinstance(m, dict) else {"role": "user", "content": str(m)}
                for m in prompt]
    return [{"role": "user", "content": str(prompt)}]


class BaseChat(UDF):
    """Common chat surface (reference llms.py:27). Subclasses implement
    ``_call_model(messages, **kwargs) -> str``."""

    def __init__(
        self,
        *,
        capacity: int | None = None,
        retry_strategy: Any = None,
        cache_strategy: CacheStrategy | None = None,
        executor: Executor | None = None,
        **model_kwargs: Any,
    ):
        if executor is None and (capacity or retry_strategy):
            executor = AsyncExecutor(capacity=capacity, retry_strategy=retry_strategy)
        super().__init__(executor=executor, cache_strategy=cache_strategy)
        self.model_kwargs = model_kwargs

    def _call_model(self, messages: list[dict], **kwargs: Any) -> str:
        raise NotImplementedError

    def __wrapped__(self, prompt: Any, **kwargs: Any) -> str:
        merged = {**self.model_kwargs, **kwargs}
        return self._call_model(_as_messages(prompt), **merged)


class OpenAIChat(BaseChat):
    """reference llms.py:84 — requires the ``openai`` client (not baked in)."""

    def __init__(self, model: str | None = "gpt-4o-mini", **kwargs: Any):
        try:
            import openai  # type: ignore[import-not-found]  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "OpenAIChat requires the 'openai' package (and network "
                "egress); use HFPipelineChat for a local model"
            ) from e
        super().__init__(**kwargs)
        self.model = model

    def _call_model(self, messages: list[dict], **kwargs: Any) -> str:
        import openai  # type: ignore[import-not-found]

        client = openai.OpenAI()
        ret = client.chat.completions.create(
            model=kwargs.pop("model", self.model), messages=messages, **kwargs
        )
        return ret.choices[0].message.content


class LiteLLMChat(BaseChat):
    """reference llms.py:313 — requires ``litellm`` (not baked in)."""

    def __init__(self, model: str | None = None, **kwargs: Any):
        try:
            import litellm  # type: ignore[import-not-found]  # noqa: F401
        except ImportError as e:
            raise ImportError("LiteLLMChat requires the 'litellm' package") from e
        super().__init__(**kwargs)
        self.model = model

    def _call_model(self, messages: list[dict], **kwargs: Any) -> str:
        import litellm  # type: ignore[import-not-found]

        ret = litellm.completion(
            model=kwargs.pop("model", self.model), messages=messages, **kwargs
        )
        return ret.choices[0].message.content


class CohereChat(BaseChat):
    """reference llms.py:544 — requires ``cohere`` (not baked in)."""

    def __init__(self, model: str = "command", **kwargs: Any):
        try:
            import cohere  # type: ignore[import-not-found]  # noqa: F401
        except ImportError as e:
            raise ImportError("CohereChat requires the 'cohere' package") from e
        super().__init__(**kwargs)
        self.model = model

    def _call_model(self, messages: list[dict], **kwargs: Any) -> str:
        import cohere  # type: ignore[import-not-found]

        client = cohere.Client()
        message = messages[-1]["content"]
        history = [
            {"role": m["role"], "message": m["content"]} for m in messages[:-1]
        ]
        ret = client.chat(
            message=message, chat_history=history,
            model=kwargs.pop("model", self.model), **kwargs,
        )
        return ret.text


class HFPipelineChat(BaseChat):
    """Local HuggingFace ``transformers`` pipeline chat (reference
    llms.py:441). Accepts either a model name/path (loaded lazily) or a
    ready pipeline object via ``pipeline=`` (handy for tests / preloaded
    weights — no network needed)."""

    def __init__(
        self,
        model: str | None = None,
        *,
        pipeline: Any = None,
        call_kwargs: dict | None = None,
        device: str | torch.device = "cuda",
        **kwargs: Any,
    ):
        pipeline_kwargs = {
            k: kwargs.pop(k) for k in list(kwargs)
            if k not in ("capacity", "retry_strategy", "cache_strategy", "executor")
        }
        super().__init__(**kwargs)
        self.model = model
        self._pipeline = pipeline
        self._pipeline_kwargs = pipeline_kwargs
        self.call_kwargs = call_kwargs or {}
        self.device = resolve_device(device)

    @property
    def pipeline(self) -> Any:
        if self._pipeline is None:
            from transformers import pipeline as hf_pipeline

            self._pipeline = hf_pipeline(
                "text-generation", model=self.model, device=str(self.device),
                **self._pipeline_kwargs,
            )
        return self._pipeline

    def _call_model(self, messages: list[dict], **kwargs: Any) -> str:
        out = self.pipeline(messages, **{**self.call_kwargs, **kwargs})
        # HF chat pipelines return [{generated_text: [... {role, content}]}]
        if isinstance(out, list) and out:
            gen = out[0].get("generated_text")
            if isinstance(gen, list) and gen:
                last = gen[-1]
                return last.get("content", str(last)) if isinstance(last, dict) else str(last)
            if isinstance(gen, str):
                return gen
        return str(out)

    def crop_to_max_length(self, text: str, max_prompt_length: int = 500) -> str:
        words = text.split()
        return " ".join(words[:max_prompt_length])


def prompt_chat_single_qa(question: Any):
    """Column helper: wrap a question string column into a message list
    (reference llms.py prompt_chat_single_qa)."""
    from ... import apply_with_type
    from ...internals import dtype as dt

    return apply_with_type(
        lambda q: [{"role": "user", "content": q}], dt.ANY, question
    )
