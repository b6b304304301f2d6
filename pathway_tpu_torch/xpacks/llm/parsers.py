"""Document parsers: port of ``pathway_tpu/xpacks/llm/parsers.py``.

A parser is a UDF ``bytes -> list[(text, metadata)]``. ``ParseUtf8`` is always available; the
``ParsePdf`` / ``ParseHtml`` / ``ParseMarkdown`` / ``ParseDocx`` / ``ParseLocal`` family runs on
the standard library alone (``_local_parsers.py``). ``ParseUnstructured`` and ``OpenParse`` need
their packages and raise ``ImportError`` without them, as the reference's do. The classes below
are the reference's, unchanged.
"""

from __future__ import annotations

from typing import Any

from ...udfs import UDF
from . import _local_parsers as LP

__all__ = [
    "ParseUtf8",
    "ParsePdf",
    "ParsePdfLayout",
    "ParseHtml",
    "ParseMarkdown",
    "ParseDocx",
    "ParseLocal",
    "SlideParser",
    "ImageParser",
    "ParseUnstructured",
    "OpenParse",
]


class ParseUtf8(UDF):
    """Decode raw bytes as one UTF-8 text document
    (reference parsers.py ParseUtf8)."""

    def __wrapped__(self, contents: Any, **kwargs: Any) -> list[tuple[str, dict]]:
        if isinstance(contents, bytes):
            text = contents.decode("utf-8", errors="replace")
        else:
            text = str(contents)
        return [(text, {})]


class ParsePdf(UDF):
    """Pure-stdlib PDF text extraction (content-stream text operators +
    FlateDecode; ``_local_parsers.pdf_extract_text``). Layout-free — the
    local stand-in for the reference's openparse/unstructured PDF path."""

    def __wrapped__(self, contents: Any, **kwargs: Any) -> list[tuple[str, dict]]:
        data = contents if isinstance(contents, bytes) else str(contents).encode()
        return [(LP.pdf_extract_text(data), {"format": "pdf"})]


class ParseHtml(UDF):
    """Stdlib ``html.parser`` text extraction with block-level structure;
    the page title lands in metadata."""

    def __wrapped__(self, contents: Any, **kwargs: Any) -> list[tuple[str, dict]]:
        text, meta = LP.html_extract_text(
            contents if isinstance(contents, (bytes, str)) else str(contents)
        )
        return [(text, {"format": "html", **meta})]


class ParseMarkdown(UDF):
    """Markdown split into heading-delimited sections, one part per
    section with its heading as metadata."""

    def __wrapped__(self, contents: Any, **kwargs: Any) -> list[tuple[str, dict]]:
        sections = LP.markdown_extract_sections(
            contents if isinstance(contents, (bytes, str)) else str(contents)
        )
        return [
            (text, {"format": "markdown", **meta}) for text, meta in sections
        ]


class ParseDocx(UDF):
    """DOCX paragraph text from the zip container's document.xml."""

    def __wrapped__(self, contents: Any, **kwargs: Any) -> list[tuple[str, dict]]:
        data = contents if isinstance(contents, bytes) else str(contents).encode()
        return [(LP.docx_extract_text(data), {"format": "docx"})]


class ParseLocal(UDF):
    """Auto-dispatching local parser: sniffs PDF / DOCX / HTML / Markdown /
    plain text by magic bytes + content and routes to the matching
    extractor — the default choice for mixed-format document folders."""

    def __wrapped__(self, contents: Any, **kwargs: Any) -> list[tuple[str, dict]]:
        fmt = LP.sniff_format(
            contents if isinstance(contents, (bytes, str)) else str(contents)
        )
        if fmt == "pdf":
            return ParsePdf.__wrapped__(self, contents)
        if fmt == "docx":
            return ParseDocx.__wrapped__(self, contents)
        if fmt == "pptx":
            data = contents if isinstance(contents, bytes) else str(contents).encode()
            return LP.pptx_extract_slides(data)
        if fmt == "image":
            data = contents if isinstance(contents, bytes) else str(contents).encode()
            return [("", LP.image_metadata(data) or {})]
        if fmt == "html":
            return ParseHtml.__wrapped__(self, contents)
        if fmt == "markdown":
            return ParseMarkdown.__wrapped__(self, contents)
        return ParseUtf8.__wrapped__(self, contents)


class ParsePdfLayout(UDF):
    """PDF layout parser (the reference's OpenParse table/layout role,
    ``parsers.py:235`` — rebuilt locally from the PDF text-positioning
    operators, no dependencies): emits one part per layout node, with
    tables reconstructed as markdown from column alignment and headings
    detected by font size. ``mode="single"`` joins all nodes into one
    document part."""

    def __init__(self, mode: str = "elements"):
        super().__init__()
        if mode not in ("elements", "single"):
            raise ValueError("mode must be 'elements' or 'single'")
        self.mode = mode

    def __wrapped__(self, contents: Any, **kwargs: Any) -> list[tuple[str, dict]]:
        data = contents if isinstance(contents, bytes) else str(contents).encode()
        nodes = LP.pdf_extract_layout(data)
        if self.mode == "single":
            text = "\n\n".join(n["text"] for n in nodes)
            return [(text, {"format": "pdf"})]
        return [
            (n["text"], {"format": "pdf", "node_type": n["type"],
                         "page": n["page"]})
            for n in nodes
        ]


class SlideParser(UDF):
    """Slide deck parser (reference parsers.py:569): PPTX decks yield one
    part per slide — shape text in document order, the title and speaker
    notes in metadata — extracted locally from the slide XML. A vision/OCR
    stage over rendered slide images plugs in via ``vision_fn`` (called
    with the raw deck bytes and the slide index, its text is appended):
    rendering engines (libreoffice) and vision LLMs are not baked into
    this environment, so that stage is injectable rather than vendored,
    like every other client-gated integration here. PDFs fall back to the
    per-page layout parser."""

    def __init__(self, vision_fn: Any = None):
        super().__init__()
        self.vision_fn = vision_fn

    def __wrapped__(self, contents: Any, **kwargs: Any) -> list[tuple[str, dict]]:
        data = contents if isinstance(contents, bytes) else str(contents).encode()
        fmt = LP.sniff_format(data)
        if fmt == "pdf":
            nodes = LP.pdf_extract_layout(data)
            pages: dict[int, list[str]] = {}
            for n in nodes:
                pages.setdefault(n["page"], []).append(n["text"])
            return [
                ("\n".join(texts), {"format": "pdf", "slide": page + 1})
                for page, texts in sorted(pages.items())
            ]
        parts = LP.pptx_extract_slides(data)
        if self.vision_fn is not None:
            enriched = []
            for text, meta in parts:
                extra = self.vision_fn(data, meta["slide"])
                if extra:
                    text = (text + "\n\n" + str(extra)).strip()
                enriched.append((text, meta))
            parts = enriched
        return parts


class ImageParser(UDF):
    """Image parser (reference parsers.py:396): dimensions/format land in
    metadata from the file header (PNG/JPEG/GIF, stdlib); the text comes
    from an injectable ``ocr_fn(image_bytes) -> str`` (an OCR engine or a
    vision LLM — client-gated like the reference's)."""

    def __init__(self, ocr_fn: Any = None):
        super().__init__()
        self.ocr_fn = ocr_fn

    def __wrapped__(self, contents: Any, **kwargs: Any) -> list[tuple[str, dict]]:
        data = contents if isinstance(contents, bytes) else str(contents).encode()
        meta = LP.image_metadata(data) or {"format": "unknown"}
        text = ""
        if self.ocr_fn is not None:
            text = str(self.ocr_fn(data) or "")
        return [(text, meta)]


class ParseUnstructured(UDF):
    """reference parsers.py ParseUnstructured — requires ``unstructured``
    (not baked in)."""

    def __init__(self, mode: str = "single", **kwargs: Any):
        try:
            import unstructured.partition.auto  # type: ignore[import-not-found]  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "ParseUnstructured requires the 'unstructured' package; "
                "ParseUtf8 handles plain-text documents"
            ) from e
        super().__init__()
        self.mode = mode
        self.kwargs = kwargs

    def __wrapped__(self, contents: bytes, **kwargs: Any) -> list[tuple[str, dict]]:
        import io

        from unstructured.partition.auto import partition  # type: ignore[import-not-found]

        elements = partition(file=io.BytesIO(contents), **{**self.kwargs, **kwargs})
        if self.mode == "single":
            return [("\n\n".join(str(e) for e in elements), {})]
        return [(str(e), getattr(e, "metadata", None) and e.metadata.to_dict() or {})
                for e in elements]


class OpenParse(UDF):
    """reference parsers.py OpenParse (PDF layout parser) — requires
    ``openparse`` (not baked in)."""

    def __init__(self, **kwargs: Any):
        try:
            import openparse  # type: ignore[import-not-found]  # noqa: F401
        except ImportError as e:
            raise ImportError("OpenParse requires the 'openparse' package") from e
        super().__init__()
        self.kwargs = kwargs

    def __wrapped__(self, contents: bytes, **kwargs: Any) -> list[tuple[str, dict]]:
        raise NotImplementedError("openparse unavailable in this environment")
