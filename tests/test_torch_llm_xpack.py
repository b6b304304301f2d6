"""``xpacks/llm`` of the port against the JAX package on the CPU: splitters, the live
``DocumentStore`` (retrieval with and without a path glob, statistics, inputs, the pre-embedded
mode, the local parsers and the encoder) and the brute-force engine's bulk path.

The programs of ``tests/test_llm_xpack.py`` and ``tests/test_local_parsers.py`` are built in both
packages from the same inputs (``fake_embed``: a 16-wide character histogram) and computed by the
JAX package's engine and the port's ``device="cpu"`` run.

Tolerances: every ``dist`` within one bf16 ulp of the reference's (ROADMAP Queue 3 item 3: the
port's scorer rounds products to bf16), texts and metadata equal wherever the reference's dists
are clear of their neighbours'; splits, statistics and input listings exactly equal. With the
encoder (f32, shared weights) the embeddings agree within 2e-5, which the same rule covers.
"""

from __future__ import annotations

import io
import sys
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pathway_tpu as rpw
import pathway_tpu_torch as tpw
from pathway_tpu.internals.parse_graph import G as RG
from pathway_tpu.models import embedder as jemb
from pathway_tpu.ops.index_engines import BruteForceKnnEngine as RefEngine
from pathway_tpu.stdlib.indexing.nearest_neighbors import BruteForceKnnFactory as RefFactory
from pathway_tpu.xpacks.llm import document_store as rds
from pathway_tpu.xpacks.llm import parsers as rparsers
from pathway_tpu.xpacks.llm import splitters as rsplit
from pathway_tpu.xpacks.llm.embedders import TpuEmbedder
from pathway_tpu_torch.internals.parse_graph import G as TG
from pathway_tpu_torch.models.embedder import Embedder, EmbedderConfig, params_from_jax
from pathway_tpu_torch.ops.index_engines import BruteForceKnnEngine
from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import BruteForceKnnFactory
from pathway_tpu_torch.xpacks.llm import document_store as tds
from pathway_tpu_torch.xpacks.llm import parsers as tparsers
from pathway_tpu_torch.xpacks.llm import splitters as tsplit
from pathway_tpu_torch.xpacks.llm.embedders import TorchEmbedder
from torch_topk_checks import assert_docs_close, assert_topk_equal, bf16_ulp


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    # tiktoken fetches its encodings over the network: both splitters count words instead
    monkeypatch.setitem(sys.modules, "tiktoken", None)
    RG.clear()
    TG.clear()
    yield
    RG.clear()
    TG.clear()


class Side:
    """One package: its ``pw``, its llm modules, its factory and how it computes a table."""

    def __init__(self, pw, ds, parsers, splitters, factory, to_pandas):
        self.pw, self.ds, self.parsers, self.splitters = pw, ds, parsers, splitters
        self.factory, self.to_pandas = factory, to_pandas

    def results(self, table) -> list:
        return self.to_pandas(table)["result"].tolist()


REF = Side(rpw, rds, rparsers, rsplit, RefFactory, rpw.debug.table_to_pandas)
PORT = Side(tpw, tds, tparsers, tsplit, BruteForceKnnFactory,
            lambda t: tpw.debug.table_to_pandas(t, device="cpu"))


def both(program) -> tuple:
    """``program(side)``'s result column computed in each package: (reference's, port's)."""
    want = program(REF)
    RG.clear()
    got = program(PORT)
    TG.clear()
    return want, got


def fake_embed(text: str) -> np.ndarray:
    v = np.zeros(16)
    for ch in str(text)[:400]:
        v[ord(ch) % 16] += 1.0
    return v / (np.linalg.norm(v) or 1.0)


DOCS = [
    ("TPUs multiply matrices on a systolic array called the MXU.", {"path": "tpu.txt", "modified_at": 3}),
    ("Kafka is a distributed message broker for event streams.", {"path": "kafka.txt", "modified_at": 7}),
    ("Croissants are made with laminated butter dough.", {"path": "food.txt", "modified_at": 5}),
]


def store(side, splitter=None, docs=DOCS, **kwargs):
    table = side.pw.debug.table_from_rows(
        side.pw.schema_from_types(data=str, _metadata=dict), docs)
    return side.ds.DocumentStore(table, side.factory(dimensions=16, embedder=fake_embed),
                                 splitter=splitter or side.splitters.NullSplitter(), **kwargs)


def test_token_count_splitter_bounds():
    text = "one two three. four five six. seven eight. nine ten eleven twelve."
    want = rsplit.TokenCountSplitter(min_tokens=3, max_tokens=6).__wrapped__(text)
    ours = tsplit.TokenCountSplitter(min_tokens=3, max_tokens=6)
    chunks = ours.__wrapped__(text)
    assert chunks == want
    assert len(chunks) >= 2 and all(len(c.split()) <= 6 for c, _ in chunks)
    assert " ".join(c for c, _ in chunks).split() == text.split()
    assert ours._split("   ") == [] and tsplit.NullSplitter().__wrapped__("x") == [("x", {})]


@pytest.mark.parametrize("glob", [None, "kafka*"])
def test_document_store_retrieve_and_filter(glob):
    def program(side):
        s = store(side)
        q = side.pw.debug.table_from_rows(side.ds.DocumentStore.RetrieveQuerySchema,
                                          [("systolic array MXU matrices", 2, None, glob)])
        return side.results(s.retrieve_query(q))

    (want,), (got,) = both(program)
    assert_docs_close(got, want)
    paths = [d["metadata"]["path"] for d in got]
    assert paths == (["kafka.txt"] if glob else ["tpu.txt", "kafka.txt"])


def test_document_store_statistics_and_inputs():
    def stats(side):
        q = side.pw.debug.table_from_rows(side.ds.DocumentStore.StatisticsQuerySchema, [()])
        return side.results(store(side).statistics_query(q))

    def inputs(side):
        q = side.pw.debug.table_from_rows(side.ds.DocumentStore.InputsQuerySchema,
                                          [(None, None), ("modified_at > `4`", None),
                                           (None, "*.txt")])
        return sorted(side.results(store(side).inputs_query(q)), key=lambda r: (len(r), repr(r)))

    want, got = both(stats)
    assert got == want == [{"file_count": 3, "last_modified": 7}]
    want, got = both(inputs)
    assert got == want
    assert [len(files) for files in got] == [2, 3, 3]


def test_document_store_pre_embedded_mode():
    def program(side):
        rows = [(text, meta, fake_embed(text)) for text, meta in DOCS]
        docs = side.pw.debug.table_from_rows(
            side.pw.schema_from_types(data=str, _metadata=dict, vec=np.ndarray), rows)
        s = side.ds.DocumentStore(docs, side.factory(dimensions=16, embedder=fake_embed),
                                  vector_column="vec")
        q = side.pw.debug.table_from_rows(side.ds.DocumentStore.RetrieveQuerySchema,
                                          [("systolic array MXU matrices", 2, None, None)])
        return side.results(s.retrieve_query(q))

    (want,), (got,) = both(program)
    assert_docs_close(got, want)
    assert got[0]["metadata"]["path"] == "tpu.txt" and got[0]["text"].startswith("TPUs multiply")


def test_brute_force_bulk_add_matches_per_row():
    """The port's engine filled row by row and in bulk (updates replace, filters survive) gives
    the same answers; the bulk-filled one against the JAX package's bulk-filled engine."""
    rng = np.random.default_rng(5)
    vecs = rng.standard_normal((300, 16)).astype(np.float32)
    metas = [{"path": f"{i}.txt"} if i % 3 == 0 else None for i in range(300)]
    q = rng.standard_normal((4, 16)).astype(np.float32)
    per_row = BruteForceKnnEngine(16, reserved_space=16, device="cpu")
    bulk = BruteForceKnnEngine(16, reserved_space=16, device="cpu")
    ref = RefEngine(16, reserved_space=16)
    for i, v in enumerate(vecs):
        per_row.add(i, v, metas[i])
    for engine in (bulk, ref):
        engine.add_batch(list(range(300)), list(vecs), metas)
        engine.add_batch([7, 8], [vecs[7], vecs[8]], [None, None])
    per_row.add(7, vecs[7], None)
    per_row.add(8, vecs[8], None)
    got = bulk.search(list(q), [5] * 4, [None] * 4)
    assert per_row.search(list(q), [5] * 4, [None] * 4) == got
    want = ref.search(list(q), [6] * 4, [None] * 4)  # one more: the 5th score's gap
    s_want = np.array([[s for _, s in row] for row in want])
    assert_topk_equal(np.array([[s for _, s in row] for row in got]),
                      np.array([[k for k, _ in row] for row in got]), s_want,
                      np.array([[k for k, _ in row] for row in want]), bf16_ulp(s_want))
    flt = ["globmatch('9.txt', path)"]
    answers = [e.search([q[0]], [3], flt) for e in (per_row, bulk, ref)]
    assert [[k for k, _ in a[0]] for a in answers] == [[9]] * 3


# -- local parsers through the store -----------------------------------------------------------


def _pptx(slides: list[tuple[str, str]]) -> bytes:
    ns_a = "http://schemas.openxmlformats.org/drawingml/2006/main"
    ns_p = "http://schemas.openxmlformats.org/presentationml/2006/main"
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        zf.writestr("[Content_Types].xml", "<Types/>")
        for i, (title, body) in enumerate(slides, start=1):
            zf.writestr(f"ppt/slides/slide{i}.xml", (
                f'<?xml version="1.0"?><p:sld xmlns:a="{ns_a}" xmlns:p="{ns_p}"><p:cSld>'
                f'<p:spTree><p:sp><p:nvSpPr><p:nvPr><p:ph type="title"/></p:nvPr></p:nvSpPr>'
                f"<p:txBody><a:p><a:r><a:t>{title}</a:t></a:r></a:p></p:txBody></p:sp>"
                f"<p:sp><p:txBody><a:p><a:r><a:t>{body}</a:t></a:r></a:p></p:txBody></p:sp>"
                f"</p:spTree></p:cSld></p:sld>"))
    return buf.getvalue()


def test_slides_document_store_default_parser():
    deck = _pptx([("Intro", "welcome to the streaming deck"),
                  ("Results", "revenue grew across regions"), ("Plan", "hire kernel writers")])

    def program(side):
        assert isinstance(side.ds.SlidesDocumentStore.default_parser(),
                          side.parsers.SlideParser)
        docs = side.pw.debug.table_from_rows(
            side.pw.schema_from_types(data=bytes, _metadata=dict), [(deck, {"path": "d.pptx"})])
        s = side.ds.SlidesDocumentStore(docs, side.factory(dimensions=16, embedder=fake_embed))
        q = side.pw.debug.table_from_rows(side.ds.DocumentStore.RetrieveQuerySchema,
                                          [("revenue regions", 3, None, None)])
        return side.results(s.retrieve_query(q))

    (want,), (got,) = both(program)
    assert_docs_close(got, want)
    assert sorted(d["metadata"]["slide"] for d in got) == [1, 2, 3]


SMALL = dict(vocab_size=64, dim=32, n_layers=2, n_heads=4, max_len=48)
WORDS = ["stream", "index", "vector", "engine", "query", "token", "state", "chunk", "embed",
         "score", "table", "window", "join", "key", "row", "tick"]


def _mixed_docs(seed: int) -> list:
    rng = np.random.default_rng(seed)

    def para(n):
        return " ".join(" ".join(rng.choice(WORDS, size=int(rng.integers(4, 12)))) + "."
                        for _ in range(n))

    return [
        (para(12).encode(), {"path": "a.txt", "modified_at": 1}),
        (f"<!DOCTYPE html><html><head><title>T</title></head><body><p>{para(6)}</p>"
         f"<p>{para(6)}</p></body></html>".encode(), {"path": "b.html", "modified_at": 2}),
        (f"# Head\n\n{para(5)}\n\n## Second\n\n{para(7)}\n".encode(),
         {"path": "c.md", "modified_at": 3}),
        (para(20).encode(), {"path": "d.txt", "modified_at": 4}),
    ]


def test_document_store_with_local_parser_splitter_and_encoder():
    """``ParseLocal`` and ``TokenCountSplitter`` over text, HTML and Markdown, the small f32
    encoder (``TorchEmbedder`` against ``TpuEmbedder``, the same weights) as the index's
    embedder: the same chunks, the same answers."""
    jcfg = jemb.EmbedderConfig(**SMALL, dtype=jnp.float32)
    params = jemb.init_params(jcfg, seed=11)
    embedders = {
        "ref": TpuEmbedder(jemb.Embedder(jcfg, params=params), max_len=48).embedder,
        "port": TorchEmbedder(Embedder(EmbedderConfig(**SMALL, dtype=torch.float32),
                                       params=params_from_jax(params, device="cpu"),
                                       device="cpu"), max_len=48, device="cpu").embedder,
    }
    docs_in = _mixed_docs(12)
    queries = [("stream index vector", 4, None, None), ("token chunk embed", 3, None, "*.md"),
               ("join key row tick", 5, "modified_at > `2`", None)]

    def program(side):
        docs = side.pw.debug.table_from_rows(
            side.pw.schema_from_types(data=bytes, _metadata=dict), docs_in)
        s = side.ds.DocumentStore(
            docs, side.factory(dimensions=32, embedder=embedders["ref" if side is REF else "port"]),
            parser=side.parsers.ParseLocal(),
            splitter=side.splitters.TokenCountSplitter(min_tokens=8, max_tokens=24))
        q = side.pw.debug.table_from_rows(side.ds.DocumentStore.RetrieveQuerySchema, queries)
        return sorted(side.results(s.retrieve_query(q)), key=len)

    want, got = both(program)
    assert [len(r) for r in got] == [3, 4, 5]
    for g, w in zip(got, want):
        assert_docs_close(g, w)
    assert all(d["metadata"]["path"] == "c.md" for d in got[0])
