"""Text splitters: port of ``pathway_tpu/xpacks/llm/splitters.py``.

A splitter is a UDF ``text -> list[(chunk, metadata)]``, so its output column flattens into one
row per chunk. Called on a column it builds an expression; ``__wrapped__`` (or ``_split``) is the
function on one text. ``TokenCountSplitter`` counts tokens with tiktoken when it is installed and
its encoding loads, else by a deterministic whitespace approximation.
"""

from __future__ import annotations

import re
from typing import Any

from ...udfs import UDF

__all__ = ["BaseSplitter", "NullSplitter", "TokenCountSplitter"]


class BaseSplitter(UDF):
    def _split(self, text: str, **kwargs: Any) -> list[tuple[str, dict]]:
        raise NotImplementedError

    def __wrapped__(self, text: str, **kwargs: Any) -> list[tuple[str, dict]]:
        return self._split(text or "", **kwargs)


class NullSplitter(BaseSplitter):
    """One chunk per document."""

    def _split(self, text: str, **kwargs: Any) -> list[tuple[str, dict]]:
        return [(text, {})]


_WORD_RE = re.compile(r"\S+")


class TokenCountSplitter(BaseSplitter):
    """Greedy sentence-boundary packing into [min_tokens, max_tokens] windows."""

    def __init__(self, min_tokens: int = 50, max_tokens: int = 500,
                 encoding_name: str = "cl100k_base", **kwargs: Any):
        super().__init__(**kwargs)
        self.min_tokens = min_tokens
        self.max_tokens = max_tokens
        self.encoding_name = encoding_name
        self._enc = None
        try:
            import tiktoken  # type: ignore[import-not-found]

            self._enc = tiktoken.get_encoding(encoding_name)
        except Exception:  # not installed, or its encoding files are absent (no network)
            self._enc = None  # fall back to whitespace token counts

    def _count(self, text: str) -> int:
        if self._enc is not None:
            return len(self._enc.encode(text))
        return len(_WORD_RE.findall(text))

    def _split(self, text: str, **kwargs: Any) -> list[tuple[str, dict]]:
        if not text.strip():
            return []
        # sentence-ish boundaries; fall back to hard cuts for huge sentences
        pieces = re.split(r"(?<=[.!?])\s+|\n{2,}", text)
        chunks: list[tuple[str, dict]] = []
        current: list[str] = []
        count = 0
        for piece in pieces:
            if not piece:
                continue
            n = self._count(piece)
            if n > self.max_tokens:
                # flush, then hard-cut the oversized piece by words
                if current:
                    chunks.append((" ".join(current), {}))
                    current, count = [], 0
                words = _WORD_RE.findall(piece)
                for i in range(0, len(words), self.max_tokens):
                    chunks.append((" ".join(words[i : i + self.max_tokens]), {}))
                continue
            if count + n > self.max_tokens and count >= self.min_tokens:
                chunks.append((" ".join(current), {}))
                current, count = [], 0
            current.append(piece)
            count += n
        if current:
            chunks.append((" ".join(current), {}))
        return chunks
