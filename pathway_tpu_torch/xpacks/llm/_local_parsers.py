"""Pure-stdlib document text extraction — the local fallback parsers.

Copy of ``pathway_tpu/xpacks/llm/_local_parsers.py``, unchanged below this paragraph.

The reference ships 928 LoC of parsers built on unstructured/openparse/OCR
(``python/pathway/xpacks/llm/parsers.py``), none of which are installable
in a no-egress environment. These extractors cover the common formats with
ONLY the standard library, so the RAG ingest path handles more than UTF-8
text without gated clients (VERDICT r4 item 9):

- PDF: scan content streams (FlateDecode via zlib), evaluate the text
  operators (Tj / TJ / ' / ") with PDF string escapes; layout-free but
  reading-ordered for the single-column documents generators emit.
- HTML: ``html.parser`` strip of script/style/head with block-level
  newlines and heading capture.
- Markdown: syntax strip + heading-section splitting.
- DOCX: the document.xml inside the zip container, ``w:p`` paragraphs and
  ``w:t`` runs.
"""

from __future__ import annotations

import re
import zlib
from html.parser import HTMLParser
from typing import Any

__all__ = [
    "pdf_extract_text",
    "pdf_extract_layout",
    "html_extract_text",
    "markdown_extract_sections",
    "docx_extract_text",
    "pptx_extract_slides",
    "image_metadata",
    "sniff_format",
]


# ---------------------------------------------------------------------------
# PDF
# ---------------------------------------------------------------------------

_STREAM_RE = re.compile(rb"stream\r?\n(.*?)endstream", re.DOTALL)


def _pdf_streams(data: bytes) -> list[bytes]:
    """All content streams, decompressed when FlateDecode."""
    out = []
    pos = 0
    while True:
        m = _STREAM_RE.search(data, pos)
        if m is None:
            break
        raw = m.group(1)
        head = data[max(0, m.start() - 400) : m.start()]
        if b"FlateDecode" in head:
            try:
                raw = zlib.decompress(raw)
            except zlib.error:
                try:  # stream may carry trailing EOL garbage
                    raw = zlib.decompressobj().decompress(raw)
                except zlib.error:
                    raw = b""
        out.append(raw)
        pos = m.end()
    return out


def _pdf_unescape(s: bytes) -> str:
    out = []
    i = 0
    n = len(s)
    while i < n:
        c = s[i]
        if c == 0x5C and i + 1 < n:  # backslash
            nxt = s[i + 1]
            mapped = {
                0x6E: "\n", 0x72: "\r", 0x74: "\t", 0x62: "\b",
                0x66: "\f", 0x28: "(", 0x29: ")", 0x5C: "\\",
            }.get(nxt)
            if mapped is not None:
                out.append(mapped)
                i += 2
                continue
            if 0x30 <= nxt <= 0x37:  # octal escape, up to 3 digits
                j = i + 1
                digits = b""
                while j < n and len(digits) < 3 and 0x30 <= s[j] <= 0x37:
                    digits += bytes([s[j]])
                    j += 1
                out.append(chr(int(digits, 8)))
                i = j
                continue
            if nxt == 0x0A:  # line continuation
                i += 2
                continue
        out.append(chr(c))
        i += 1
    return "".join(out)


_TEXT_OP_RE = re.compile(
    rb"(\((?:[^()\\]|\\.)*\))\s*(Tj|'|\")"  # (string) Tj / ' / "
    rb"|(<[0-9A-Fa-f\s]*>)\s*(Tj|'|\")"  # <hex> Tj / ' / "
    rb"|(\[(?:[^\]\\]|\\.)*\])\s*TJ"  # [(a) -120 (b) <hex>] TJ
    rb"|(T\*|TD|Td|BT|ET)"  # line/positioning breaks
)
#: strings inside a TJ array — paren or hex form
_INNER_STR_RE = re.compile(
    rb"\((?:[^()\\]|\\.)*\)|<[0-9A-Fa-f\s]+>"
)


def _decode_hex_string(hexbody: bytes) -> str:
    hexstr = re.sub(rb"\s", b"", hexbody)
    if len(hexstr) % 2:
        hexstr += b"0"
    try:
        raw = bytes.fromhex(hexstr.decode())
    except ValueError:
        return ""
    # UTF-16BE when BOM'd (common for CID fonts), else latin
    return (
        raw.decode("utf-16-be", errors="replace")
        if raw[:2] == b"\xfe\xff"
        else raw.decode("latin-1")
    )


def pdf_extract_text(data: bytes) -> str:
    """Text of all content streams, newline-separated at line operators."""
    parts: list[str] = []
    for stream in _pdf_streams(data):
        if b"Tj" not in stream and b"TJ" not in stream and b"'" not in stream:
            continue
        for m in _TEXT_OP_RE.finditer(stream):
            if m.group(1) is not None:
                parts.append(_pdf_unescape(m.group(1)[1:-1]))
            elif m.group(3) is not None:
                parts.append(_decode_hex_string(m.group(3)[1:-1]))
            elif m.group(5) is not None:
                for sm in _INNER_STR_RE.finditer(m.group(5)):
                    tok = sm.group(0)
                    if tok[:1] == b"(":
                        parts.append(_pdf_unescape(tok[1:-1]))
                    else:
                        parts.append(_decode_hex_string(tok[1:-1]))
            else:
                op = m.group(6)
                if op in (b"T*", b"TD", b"Td", b"ET") and parts and not (
                    parts and parts[-1] == "\n"
                ):
                    parts.append("\n")
    text = "".join(parts)
    # collapse intra-line runs the positioning ops produced
    return re.sub(r"\n{3,}", "\n\n", text).strip()


# ---------------------------------------------------------------------------
# PDF layout: positioned runs -> lines -> table/heading/text nodes
# (the local OpenParse-class engine; reference parsers.py:235)
# ---------------------------------------------------------------------------

#: one positioned token stream: strings + the positioning/font operators
_LAYOUT_OP_RE = re.compile(
    rb"(\((?:[^()\\]|\\.)*\))\s*(Tj|'|\")"
    rb"|(<[0-9A-Fa-f\s]*>)\s*(Tj|'|\")"
    rb"|(\[(?:[^\]\\]|\\.)*\])\s*TJ"
    rb"|(-?[\d.]+)\s+(-?[\d.]+)\s+(-?[\d.]+)\s+(-?[\d.]+)\s+(-?[\d.]+)\s+(-?[\d.]+)\s+Tm"
    rb"|(-?[\d.]+)\s+(-?[\d.]+)\s+(TD|Td)"
    rb"|/(\w+)\s+(-?[\d.]+)\s+Tf"
    rb"|(T\*|BT|ET)"
)


def _pdf_positioned_runs(stream: bytes) -> list[tuple[float, float, float, str]]:
    """(x, y, font_size, text) for every shown string, tracking the text
    matrix (Tm), line translations (Td/TD/T*) and font size (Tf)."""
    runs: list[tuple[float, float, float, str]] = []
    x = y = 0.0
    lx = ly = 0.0  # line start (Td/TD translate from here)
    leading = 14.0
    size = 12.0
    for m in _LAYOUT_OP_RE.finditer(stream):
        if m.group(1) is not None or m.group(3) is not None:
            s = (
                _pdf_unescape(m.group(1)[1:-1])
                if m.group(1) is not None
                else _decode_hex_string(m.group(3)[1:-1])
            )
            if s.strip():
                runs.append((x, y, size, s))
            # crude advance so same-line strings keep their order
            x += max(len(s), 1) * size * 0.5
        elif m.group(5) is not None:
            parts = []
            for sm in _INNER_STR_RE.finditer(m.group(5)):
                tok = sm.group(0)
                parts.append(
                    _pdf_unescape(tok[1:-1]) if tok[:1] == b"(" else
                    _decode_hex_string(tok[1:-1])
                )
            s = "".join(parts)
            if s.strip():
                runs.append((x, y, size, s))
            x += max(len(s), 1) * size * 0.5
        elif m.group(6) is not None:  # Tm: full matrix, e/f are x/y
            x = lx = float(m.group(10))
            y = ly = float(m.group(11))
        elif m.group(12) is not None:  # Td / TD
            tx, ty = float(m.group(12)), float(m.group(13))
            if m.group(14) == b"TD":
                leading = -ty if ty else leading
            lx, ly = lx + tx, ly + ty
            x, y = lx, ly
        elif m.group(15) is not None:  # Tf
            size = float(m.group(16)) or size
        else:
            op = m.group(17)
            if op == b"T*":
                ly -= leading
                x, y = lx, ly
            elif op == b"BT":
                x = y = lx = ly = 0.0
    return runs


def _cluster_lines(
    runs: list[tuple[float, float, float, str]], tol: float = 3.0
) -> list[list[tuple[float, float, float, str]]]:
    """Group runs into visual lines by y (descending page order)."""
    lines: list[list[tuple[float, float, float, str]]] = []
    for run in sorted(runs, key=lambda r: (-r[1], r[0])):
        if lines and abs(lines[-1][0][1] - run[1]) <= tol:
            lines[-1].append(run)
        else:
            lines.append([run])
    for line in lines:
        line.sort(key=lambda r: r[0])
    return lines


def _columns_of(line: list[tuple[float, float, float, str]]) -> list[float]:
    return [r[0] for r in line]


def _aligned(a: list[float], b: list[float], tol: float = 6.0) -> bool:
    if len(a) != len(b) or len(a) < 2:
        return False
    return all(abs(x - y) <= tol for x, y in zip(a, b))


def pdf_extract_layout(data: bytes) -> list[dict]:
    """Layout nodes from a PDF: ``{"type": "table"|"heading"|"text",
    "text": str, "page": int}`` in reading order.

    Tables are reconstructed from column alignment — ≥2 consecutive lines
    with the same ≥2 x-positions become one node whose text is a markdown
    table (the role of the reference's OpenParse table extraction,
    ``parsers.py:235``, rebuilt from PDF text-positioning operators).
    Headings are lines whose font size exceeds the page median."""
    nodes: list[dict] = []
    for page_no, stream in enumerate(_pdf_streams(data)):
        if b"BT" not in stream:
            continue
        runs = _pdf_positioned_runs(stream)
        if not runs:
            continue
        lines = _cluster_lines(runs)
        sizes = sorted(r[2] for r in runs)
        median = sizes[len(sizes) // 2]
        i = 0
        while i < len(lines):
            cols = _columns_of(lines[i])
            block = [lines[i]]
            j = i + 1
            while (
                len(cols) >= 2
                and j < len(lines)
                and _aligned(cols, _columns_of(lines[j]))
            ):
                block.append(lines[j])
                j += 1
            if len(block) >= 2 and len(cols) >= 2:
                header, *rows = [
                    [r[3].strip() for r in line] for line in block
                ]
                md = ["| " + " | ".join(header) + " |",
                      "|" + "---|" * len(header)]
                md += ["| " + " | ".join(row) + " |" for row in rows]
                nodes.append({
                    "type": "table", "text": "\n".join(md), "page": page_no,
                })
                i = j
                continue
            text = " ".join(r[3] for r in lines[i]).strip()
            if text:
                kind = (
                    "heading"
                    if lines[i][0][2] > median and len(text) < 120
                    else "text"
                )
                # merge runs of plain text lines into one node
                if (
                    kind == "text" and nodes
                    and nodes[-1]["type"] == "text"
                    and nodes[-1]["page"] == page_no
                ):
                    nodes[-1]["text"] += "\n" + text
                else:
                    nodes.append({"type": kind, "text": text, "page": page_no})
            i += 1
    return nodes


# ---------------------------------------------------------------------------
# PPTX slides (slide text + speaker notes; reference parsers.py:569)
# ---------------------------------------------------------------------------


def pptx_extract_slides(data: bytes) -> list[tuple[str, dict]]:
    """One ``(text, metadata)`` per slide: shape text in document order
    with the title separated, plus speaker notes under
    ``metadata["notes"]``."""
    import io
    import zipfile
    from xml.etree import ElementTree

    A = "{http://schemas.openxmlformats.org/drawingml/2006/main}"
    P = "{http://schemas.openxmlformats.org/presentationml/2006/main}"

    def shape_texts(root) -> tuple[str | None, list[str]]:
        title = None
        bodies = []
        for sp in root.iter(f"{P}sp"):
            is_title = False
            for ph in sp.iter(f"{P}ph"):
                if ph.get("type") in ("title", "ctrTitle"):
                    is_title = True
            paras = []
            for para in sp.iter(f"{A}p"):
                text = "".join(t.text or "" for t in para.iter(f"{A}t"))
                if text.strip():
                    paras.append(text.strip())
            if not paras:
                continue
            if is_title and title is None:
                title = " ".join(paras)
            else:
                bodies.append("\n".join(paras))
        return title, bodies

    out: list[tuple[str, dict]] = []
    with zipfile.ZipFile(io.BytesIO(data)) as zf:
        slide_names = sorted(
            (n for n in zf.namelist()
             if re.fullmatch(r"ppt/slides/slide\d+\.xml", n)),
            key=lambda n: int(re.search(r"\d+", n.rsplit("/", 1)[1]).group()),
        )
        for idx, name in enumerate(slide_names, start=1):
            with zf.open(name) as f:
                root = ElementTree.parse(f).getroot()
            title, bodies = shape_texts(root)
            meta: dict = {"slide": idx, "format": "pptx"}
            if title:
                meta["title"] = title
            notes_name = f"ppt/notesSlides/notesSlide{idx}.xml"
            if notes_name in zf.namelist():
                with zf.open(notes_name) as f:
                    nroot = ElementTree.parse(f).getroot()
                _, notes = shape_texts(nroot)
                notes_text = "\n".join(notes).strip()
                if notes_text:
                    meta["notes"] = notes_text
            text = "\n\n".join(([title] if title else []) + bodies).strip()
            out.append((text, meta))
    return out


# ---------------------------------------------------------------------------
# image metadata (dimensions/format by magic bytes; OCR/vision is the
# client-gated layer above — reference ImageParser, parsers.py:396)
# ---------------------------------------------------------------------------


def image_metadata(data: bytes) -> dict | None:
    """``{"format", "width", "height"}`` for PNG/JPEG/GIF, else None."""
    import struct

    if data[:8] == b"\x89PNG\r\n\x1a\n" and len(data) >= 24:
        w, h = struct.unpack(">II", data[16:24])
        return {"format": "png", "width": int(w), "height": int(h)}
    if data[:6] in (b"GIF87a", b"GIF89a") and len(data) >= 10:
        w, h = struct.unpack("<HH", data[6:10])
        return {"format": "gif", "width": int(w), "height": int(h)}
    if data[:2] == b"\xff\xd8":  # JPEG: walk segments to a SOFn frame
        i = 2
        while i + 9 < len(data):
            if data[i] != 0xFF:
                i += 1
                continue
            marker = data[i + 1]
            if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
                h, w = struct.unpack(">HH", data[i + 5:i + 9])
                return {"format": "jpeg", "width": int(w), "height": int(h)}
            seg_len = struct.unpack(">H", data[i + 2:i + 4])[0]
            i += 2 + seg_len
        return {"format": "jpeg", "width": None, "height": None}
    return None


# ---------------------------------------------------------------------------
# HTML
# ---------------------------------------------------------------------------

_BLOCK_TAGS = {
    "p", "div", "br", "li", "tr", "h1", "h2", "h3", "h4", "h5", "h6",
    "section", "article", "header", "footer", "blockquote", "pre",
    "table", "ul", "ol",
}
_SKIP_TAGS = {"script", "style", "head", "noscript", "template"}


class _TextHTMLParser(HTMLParser):
    def __init__(self) -> None:
        super().__init__(convert_charrefs=True)
        self.parts: list[str] = []
        self.title: str | None = None
        self._skip_depth = 0
        self._in_title = False

    def handle_starttag(self, tag, attrs):
        if tag in _SKIP_TAGS:
            self._skip_depth += 1
        elif tag == "title":
            self._in_title = True
        elif tag in _BLOCK_TAGS:
            self.parts.append("\n")

    def handle_endtag(self, tag):
        if tag in _SKIP_TAGS and self._skip_depth:
            self._skip_depth -= 1
        elif tag == "title":
            self._in_title = False
        elif tag in _BLOCK_TAGS:
            self.parts.append("\n")

    def handle_data(self, data):
        if self._in_title:
            # title sits inside <head>, which is otherwise skipped
            self.title = (self.title or "") + data
            return
        if self._skip_depth:
            return
        self.parts.append(data)


def html_extract_text(data: bytes | str) -> tuple[str, dict]:
    if isinstance(data, bytes):
        data = data.decode("utf-8", errors="replace")
    p = _TextHTMLParser()
    p.feed(data)
    p.close()
    text = re.sub(r"[ \t]+", " ", "".join(p.parts))
    text = re.sub(r" ?\n ?", "\n", text)
    text = re.sub(r"\n{3,}", "\n\n", text).strip()
    meta = {"title": p.title.strip()} if p.title else {}
    return text, meta


# ---------------------------------------------------------------------------
# Markdown
# ---------------------------------------------------------------------------

_MD_HEADING_RE = re.compile(r"^(#{1,6})\s+(.*)$")


def _md_strip(text: str) -> str:
    text = re.sub(r"```.*?```", "", text, flags=re.DOTALL)  # fenced code
    text = re.sub(r"`([^`]*)`", r"\1", text)  # inline code
    text = re.sub(r"!\[([^\]]*)\]\([^)]*\)", r"\1", text)  # images
    text = re.sub(r"\[([^\]]*)\]\([^)]*\)", r"\1", text)  # links
    text = re.sub(r"(\*\*|__)(.*?)\1", r"\2", text)  # bold
    text = re.sub(r"(\*|_)(.*?)\1", r"\2", text)  # italics
    text = re.sub(r"^\s{0,3}([-*+]|\d+\.)\s+", "", text, flags=re.MULTILINE)
    text = re.sub(r"^\s{0,3}>\s?", "", text, flags=re.MULTILINE)  # quotes
    text = re.sub(r"^\s*([-*_]\s*){3,}$", "", text, flags=re.MULTILINE)
    return text


def markdown_extract_sections(data: bytes | str) -> list[tuple[str, dict]]:
    """Split by headings; each section carries its heading as metadata."""
    if isinstance(data, bytes):
        data = data.decode("utf-8", errors="replace")
    sections: list[tuple[str, dict]] = []
    heading: str | None = None
    buf: list[str] = []

    def flush():
        body = _md_strip("\n".join(buf)).strip()
        if body or heading:
            meta = {"heading": heading} if heading else {}
            sections.append((body, meta))

    for line in data.splitlines():
        m = _MD_HEADING_RE.match(line)
        if m:
            flush()
            buf = []
            heading = m.group(2).strip()
        else:
            buf.append(line)
    flush()
    if not sections:
        sections.append(("", {}))
    return sections


# ---------------------------------------------------------------------------
# DOCX
# ---------------------------------------------------------------------------


def docx_extract_text(data: bytes) -> str:
    import io
    import zipfile
    from xml.etree import ElementTree

    ns = "{http://schemas.openxmlformats.org/wordprocessingml/2006/main}"
    with zipfile.ZipFile(io.BytesIO(data)) as zf:
        with zf.open("word/document.xml") as f:
            root = ElementTree.parse(f).getroot()
    paras = []
    for p in root.iter(f"{ns}p"):
        runs = [t.text or "" for t in p.iter(f"{ns}t")]
        paras.append("".join(runs))
    return "\n".join(paras).strip()


# ---------------------------------------------------------------------------
# format sniffing
# ---------------------------------------------------------------------------


def sniff_format(data: Any) -> str:
    """'pdf' | 'docx' | 'pptx' | 'image' | 'html' | 'markdown' | 'text'."""
    if isinstance(data, str):
        head = data[:2048].lstrip().lower()
        if head.startswith("<!doctype html") or head.startswith("<html"):
            return "html"
        if _looks_markdown(data):
            return "markdown"
        return "text"
    if data[:5] == b"%PDF-":
        return "pdf"
    if data[:4] == b"PK\x03\x04" and b"word/" in data[:4096]:
        return "docx"
    if data[:4] == b"PK\x03\x04" and b"ppt/" in data[:4096]:
        return "pptx"
    if image_metadata(data[:64] if len(data) > 64 else data) is not None:
        return "image"
    head = data[:2048].lstrip().lower()
    if head.startswith(b"<!doctype html") or head.startswith(b"<html"):
        return "html"
    try:
        text = data.decode("utf-8")
    except UnicodeDecodeError:
        return "text"
    return "markdown" if _looks_markdown(text) else "text"


def _looks_markdown(text: str) -> bool:
    sample = text[:4000]
    signals = 0
    if re.search(r"^#{1,6}\s+\S", sample, re.MULTILINE):
        signals += 2
    if re.search(r"^\s{0,3}[-*+]\s+\S", sample, re.MULTILINE):
        signals += 1
    if re.search(r"\[[^\]]+\]\([^)]+\)", sample):
        signals += 1
    if re.search(r"```", sample):
        signals += 1
    return signals >= 2
