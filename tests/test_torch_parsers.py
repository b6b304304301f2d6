"""The port's local parsers (``xpacks/llm/_local_parsers.py``, ``parsers.py``) against the JAX
package's on the CPU.

Every case of ``tests/test_local_parsers.py`` and ``tests/test_parsers_layout.py`` goes through
both packages' functions and UDFs (``__wrapped__``) on the same bytes, built by those files' own
fixtures; the outputs must be equal, and the cases' own checks hold on the port's. The store
cases run through both packages' ``DocumentStore`` (``fake_embed``, dists within one bf16 ulp,
texts and metadata equal).
"""

from __future__ import annotations

import struct

import numpy as np
import pytest

import pathway_tpu as rpw
import pathway_tpu_torch as tpw
from pathway_tpu.internals.parse_graph import G as RG
from pathway_tpu.stdlib.indexing.nearest_neighbors import BruteForceKnnFactory as RefFactory
from pathway_tpu.xpacks.llm import _local_parsers as RLP
from pathway_tpu.xpacks.llm import document_store as rds
from pathway_tpu.xpacks.llm import parsers as rparsers
from pathway_tpu_torch.internals.parse_graph import G as TG
from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import BruteForceKnnFactory
from pathway_tpu_torch.xpacks.llm import _local_parsers as TLP
from pathway_tpu_torch.xpacks.llm import document_store as tds
from pathway_tpu_torch.xpacks.llm import parsers as tparsers
from test_local_parsers import _make_docx, _make_pdf
from test_parsers_layout import TABLE_PDF_STREAM, _pdf_with, _png, _pptx
from torch_topk_checks import assert_docs_close


@pytest.fixture(autouse=True)
def _clean():
    RG.clear()
    TG.clear()
    yield
    RG.clear()
    TG.clear()


def both(fn_name: str, *args, **kwargs):
    """``_local_parsers.<fn_name>`` of each package on the same input: equal, the port's
    returned."""
    want = getattr(RLP, fn_name)(*args, **kwargs)
    got = getattr(TLP, fn_name)(*args, **kwargs)
    assert got == want
    return got


def both_udf(cls_name: str, data, *init, **init_kw):
    """``parsers.<cls_name>(...).__wrapped__(data)`` of each package: equal, the port's
    returned."""
    want = getattr(rparsers, cls_name)(*init, **init_kw).__wrapped__(data)
    got = getattr(tparsers, cls_name)(*init, **init_kw).__wrapped__(data)
    assert got == want
    return got


JPEG = (b"\xff\xd8" + b"\xff\xe0" + struct.pack(">H", 16) + b"JFIF\x00" + b"\x00" * 10
        + b"\xff\xc0" + struct.pack(">H", 11) + b"\x08" + struct.pack(">HH", 33, 44) + b"\x03")
GIF = b"GIF89a" + struct.pack("<HH", 7, 9)
TJ_PDF = (b"%PDF-1.4\n4 0 obj << /Length 44 >> stream\n"
          b"BT [(Hel) -120 (lo)] TJ <20776F726C64> Tj ET\nendstream endobj\n%%EOF")
QUOTE_CONTENT = b'BT (first) " [(a) -10 <20> (b)] TJ ET'
QUOTE_PDF = (b"%PDF-1.4\n4 0 obj << /Length " + str(len(QUOTE_CONTENT)).encode()
             + b" >> stream\n" + QUOTE_CONTENT + b"\nendstream endobj\n%%EOF")
HTML = b"""<!DOCTYPE html><html><head><title>My Page</title>
    <style>body { color: red }</style><script>var x = 1;</script></head>
    <body><h1>Heading</h1><p>First para.</p><p>Second para.</p></body></html>"""
MARKDOWN = ("# Title\n\nIntro with a [link](http://x) and `code`.\n\n"
            "## Second\n\n- item one\n- item two\n\n```\nignored code\n```\n")
DECK = _pptx([("Intro", ["Welcome to the deck", "Agenda below"], "greet the room"),
              ("Results", ["Revenue up 20%"], None)])

#: every input of the two files' cases, by name
INPUTS = {
    "pdf": _make_pdf(["Hello PDF world", "second (line)"], compress=False),
    "pdf_flate": _make_pdf(["compressed stream text"], compress=True),
    "pdf_tj_hex": TJ_PDF,
    "pdf_quote": QUOTE_PDF,
    "html": HTML,
    "markdown": MARKDOWN.encode(),
    "docx": _make_docx(["First paragraph", "Second paragraph"]),
    "layout_pdf": _pdf_with(TABLE_PDF_STREAM),
    "layout_pdf_flate": _pdf_with(TABLE_PDF_STREAM, compress=True),
    "pptx": DECK,
    "png": _png(),
    "jpeg": JPEG,
    "gif": GIF,
    "text": b"plain text about streaming dataflow",
    "binary": b"\xff\xfe binary ish",
}


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_every_udf_on_every_input(name):
    """Each parser UDF of both packages on each of the cases' inputs: equal parts, or the same
    exception."""
    data = INPUTS[name]
    for cls in ("ParseUtf8", "ParsePdf", "ParseHtml", "ParseMarkdown", "ParseDocx", "ParseLocal",
                "ParsePdfLayout", "SlideParser", "ImageParser"):
        try:
            want = getattr(rparsers, cls)().__wrapped__(data)
        except Exception as e:  # noqa: BLE001 - the port must raise the same
            with pytest.raises(type(e)):
                getattr(tparsers, cls)().__wrapped__(data)
            continue
        assert getattr(tparsers, cls)().__wrapped__(data) == want, cls
    assert both("sniff_format", data) == RLP.sniff_format(data)


def test_pdf_extract_uncompressed():
    text = both("pdf_extract_text", INPUTS["pdf"])
    assert "Hello PDF world" in text and "second (line)" in text


def test_pdf_extract_flate():
    assert "compressed stream text" in both("pdf_extract_text", INPUTS["pdf_flate"])


def test_pdf_tj_array_and_hex():
    text = both("pdf_extract_text", TJ_PDF)
    assert "Hel" in text and "lo" in text and "world" in text


def test_pdf_double_quote_and_hex_in_tj():
    text = both("pdf_extract_text", QUOTE_PDF)
    assert "first" in text and "a b" in text


def test_html_extract():
    text, meta = both("html_extract_text", HTML)
    assert "Heading" in text and "First para." in text
    assert "color: red" not in text and "var x" not in text
    assert meta["title"] == "My Page"


def test_markdown_sections():
    sections = both("markdown_extract_sections", MARKDOWN)
    heads = [m.get("heading") for _, m in sections]
    assert "Title" in heads and "Second" in heads
    joined = " ".join(t for t, _ in sections)
    assert "link" in joined and "code" in joined
    assert "http://x" not in joined and "ignored code" not in joined


def test_docx_extract():
    assert both("docx_extract_text", INPUTS["docx"]) == "First paragraph\nSecond paragraph"


SNIFFED = {
    "pdf": "pdf", "docx": "docx", "html_empty": "html", "markdown_str": "markdown",
    "text_str": "text", "binary": "text", "pptx": "pptx", "png": "image",
}
MORE_INPUTS = {"html_empty": b"<!DOCTYPE html><html></html>",
               "markdown_str": "# Head\n\n- a\n- b\n", "text_str": "just plain text"}


# parametrized by name: the zip containers' bytes hold their build time, and the ids of every
# test process must agree
@pytest.mark.parametrize("name", sorted(SNIFFED))
def test_sniff_format(name):
    assert both("sniff_format", {**INPUTS, **MORE_INPUTS}[name]) == SNIFFED[name]


@pytest.mark.parametrize("compress", [False, True])
def test_pdf_layout_extracts_table_heading_and_text(compress):
    nodes = both("pdf_extract_layout", _pdf_with(TABLE_PDF_STREAM, compress=compress))
    assert [n["type"] for n in nodes] == ["heading", "text", "table", "text"]
    assert nodes[0]["text"] == "Quarterly Report"
    assert nodes[2]["text"].splitlines()[2] == "| EMEA | 10 | 14 |"
    assert "Revenue grew" in nodes[1]["text"] and "table below" in nodes[1]["text"]


def test_parse_pdf_layout_udf_modes():
    parts = both_udf("ParsePdfLayout", INPUTS["layout_pdf"])
    assert any(m["node_type"] == "table" for _, m in parts)
    assert all(m["page"] == 0 for _, m in parts)
    (single, _), = both_udf("ParsePdfLayout", INPUTS["layout_pdf"], mode="single")
    assert "| EMEA | 10 | 14 |" in single and "Quarterly Report" in single
    for module in (rparsers, tparsers):
        with pytest.raises(ValueError, match="mode"):
            module.ParsePdfLayout(mode="pages")


def test_pptx_slides_with_titles_and_notes():
    parts = both_udf("SlideParser", DECK)
    assert len(parts) == 2
    text1, meta1 = parts[0]
    assert meta1 == {**meta1, "slide": 1, "title": "Intro", "notes": "greet the room"}
    assert "Welcome to the deck" in text1 and text1.startswith("Intro")
    assert parts[1][1]["slide"] == 2 and "notes" not in parts[1][1]
    assert both("pptx_extract_slides", DECK) == parts


def test_slide_parser_vision_stage_injectable():
    deck = _pptx([("T", ["body"], None)])
    calls = []

    def vision(deck_bytes, slide_no):
        calls.append(slide_no)
        return f"ocr text {slide_no}"

    parts = both_udf("SlideParser", deck, vision_fn=vision)
    assert calls == [1, 1]  # once for each package
    assert parts[0][0].endswith("ocr text 1")


def test_slide_parser_pdf_pages_as_slides():
    parts = both_udf("SlideParser", INPUTS["layout_pdf"])
    assert len(parts) == 1 and parts[0][1]["slide"] == 1
    assert "Quarterly Report" in parts[0][0]


def test_image_parser_metadata_and_ocr_hook():
    (text, meta), = both_udf("ImageParser", INPUTS["png"])
    assert meta == {"format": "png", "width": 64, "height": 48} and text == ""
    (text2, _), = both_udf("ImageParser", INPUTS["png"], ocr_fn=lambda b: "seen text")
    assert text2 == "seen text"


def test_image_metadata_jpeg_gif():
    assert both("image_metadata", JPEG) == {"format": "jpeg", "width": 44, "height": 33}
    assert both("image_metadata", GIF) == {"format": "gif", "width": 7, "height": 9}
    assert both("image_metadata", b"not an image") is None


def test_parse_local_routes_pptx_and_images():
    parts = both_udf("ParseLocal", _pptx([("T", ["hello body"], None)]))
    assert parts[0][1]["format"] == "pptx" and "hello body" in parts[0][0]
    (_, meta), = both_udf("ParseLocal", INPUTS["png"])
    assert meta["format"] == "png"


def test_gated_parsers_raise_without_their_packages():
    for module in (rparsers, tparsers):
        with pytest.raises(ImportError, match="unstructured"):
            module.ParseUnstructured()
        with pytest.raises(ImportError, match="openparse"):
            module.OpenParse()


def test_slides_document_store_defaults_to_slide_parser():
    assert isinstance(tds.SlidesDocumentStore.default_parser(), tparsers.SlideParser)
    assert isinstance(tds.DocumentStore.default_parser(), tparsers.ParseUtf8)


def fake_embed(text: str) -> np.ndarray:
    v = np.zeros(16)
    for ch in str(text)[:400]:
        v[ord(ch) % 16] += 1.0
    return v / (np.linalg.norm(v) or 1.0)


def test_parse_local_mixed_document_store():
    docs_in = [
        (_make_pdf(["quarterly revenue grew ten percent"], True), {"path": "report.pdf"}),
        (b"<html><title>K8s</title><body><p>kubernetes cluster nodes</p></body></html>",
         {"path": "infra.html"}),
        ("# Recipes\n\nbutter croissant lamination\n".encode(), {"path": "food.md"}),
        (b"plain text about streaming dataflow", {"path": "notes.txt"}),
    ]
    answers = []
    for pw, ds, parsers, factory, run in (
            (rpw, rds, rparsers, RefFactory, rpw.debug.table_to_pandas),
            (tpw, tds, tparsers, BruteForceKnnFactory,
             lambda t: tpw.debug.table_to_pandas(t, device="cpu"))):
        docs = pw.debug.table_from_rows(pw.schema_from_types(data=bytes, _metadata=dict), docs_in)
        store = ds.DocumentStore(docs, factory(dimensions=16, embedder=fake_embed),
                                 parser=parsers.ParseLocal())
        queries = pw.debug.table_from_rows(ds.DocumentStore.RetrieveQuerySchema,
                                           [("quarterly revenue percent grew", 4, None, None)])
        [row] = run(store.retrieve_query(queries))["result"].tolist()
        answers.append(row)
    want, got = answers
    assert_docs_close(got, want)
    assert got[0]["metadata"] == {"path": "report.pdf", "format": "pdf"}
    assert "revenue" in got[0]["text"]
