"""The rest of ``xpacks/llm`` of the port (chats, prompts, rerankers, the vector store and the
RAG question answerers) against the JAX package's, on the CPU.

- The reference's cases of ``tests/test_llm_xpack.py`` that need these modules run through both
  packages (``tests/torch_case_runs.py``): the answerers' queries, the geometric strategy, the
  reranker and its top-k filter, summarization, the QA REST roundtrip and the vector store's
  gated constructors. Each case's own assertions hold in both, and every table it computes is
  the reference's: answers equal; a ``context_docs`` list by ``assert_docs_close``. On the
  port the servers run with ``device="cpu"``.
- The QA REST roundtrip on its own free port in each package: every route's answer equal.
- ``VectorStoreServer`` with ``VectorStoreClient`` in each package: the same answers.
- ``EncoderReranker`` over the encoder with shared weights (``params_from_jax``, f32): its
  scores within 2e-5 of the reference's, two one-row forwards a pair; ``LLMReranker``,
  ``rerank_topk_filter`` and its expression form equal.
- Every prompt template equal; each gated chat and the cross-encoder, its client blocked, raise
  at construction, the chats with the reference's message.
- ``answer_with_geometric_rag_strategy_from_index`` over ``DataIndex`` equal in both.

Tolerances: every ``dist`` within one bf16 ulp of the reference's (the port's scorer rounds
products to bf16, ROADMAP Queue 3 item 3), texts and metadata equal where the reference's dists
are clear of their neighbours'; 2e-5 for f32 embeddings and the cosines made from them; the
rest exact.
"""

from __future__ import annotations

import importlib
import json
import socket
import sys
import time

import numpy as np
import pytest

from torch_case_runs import Side, case_args, cases, run_case
from torch_topk_checks import assert_docs_close

PACKAGES = ("pathway_tpu", "pathway_tpu_torch")
EMB_ATOL = 2e-5

#: the cases of test_llm_xpack.py over question_answering, rerankers, llms and vector_store
NAMES = ("test_base_rag_answer_query", "test_base_rag_answer_returns_context_docs",
         "test_geometric_rag_strategy_expands_until_answer",
         "test_geometric_rag_strategy_gives_up", "test_adaptive_rag_answer_query",
         "test_encoder_reranker_and_topk", "test_summarize_query", "test_qa_rest_server_roundtrip",
         "test_vector_store_adapter_constructors_gated")
CASES = [c for c in cases(["test_llm_xpack"]) if c[1] in NAMES]


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    # tiktoken fetches its encodings over the network: the splitters count words instead
    monkeypatch.setitem(sys.modules, "tiktoken", None)
    monkeypatch.setenv("PATHWAY_THREADS", "1")
    for pkg in PACKAGES:
        importlib.import_module(pkg).G.clear()
    yield
    for pkg in PACKAGES:
        importlib.import_module(pkg).G.clear()


def _assert_close(got, want) -> None:
    """Two recorded values: dicts with ``context_docs`` by ``assert_docs_close``, the rest
    equal."""
    if isinstance(want, dict) and "context_docs" in want:
        assert set(got) == set(want)
        assert got["response"] == want["response"]
        assert_docs_close(got["context_docs"], want["context_docs"])
    elif isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_close(g, w)
    else:
        assert got == want


@pytest.mark.parametrize("module,name", CASES, ids=[n for _, n in CASES])
def test_reference_case(module, name):
    runs = {}
    for pkg in PACKAGES:
        with pytest.MonkeyPatch.context() as mp:
            side = Side(pkg)
            if side.port:
                servers = importlib.import_module("pathway_tpu_torch.xpacks.llm.servers")
                run = servers.BaseRestServer.run
                mp.setattr(servers.BaseRestServer, "run",
                           lambda self, *a, device="cpu", **k: run(self, *a, device=device, **k))
            assert case_args(module, name) == []
            runs[pkg] = run_case(module, name, side)
    want, got = runs["pathway_tpu"], runs["pathway_tpu_torch"]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in w:
            _assert_close(g[key], w[key])


# -- shared programs ---------------------------------------------------------------------------


def fake_embed(text: str) -> np.ndarray:
    """``tests/test_llm_xpack.py``'s embedder: a 16-wide character histogram."""
    v = np.zeros(16)
    for ch in str(text)[:400]:
        v[ord(ch) % 16] += 1.0
    return v / (np.linalg.norm(v) or 1.0)


DOCS = [
    ("TPUs multiply matrices on a systolic array called the MXU.", {"path": "tpu.txt", "modified_at": 3}),
    ("Kafka is a distributed message broker for event streams.", {"path": "kafka.txt", "modified_at": 7}),
    ("Croissants are made with laminated butter dough.", {"path": "food.txt", "modified_at": 5}),
    ("The MXU is fed from vector memory by the systolic data path.", {"path": "mxu.txt", "modified_at": 9}),
]


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _chat_class(pkg: str):
    llms = importlib.import_module(f"{pkg}.xpacks.llm.llms")
    prompts = importlib.import_module(f"{pkg}.xpacks.llm.prompts")

    class FactChat(llms.BaseChat):
        def _call_model(self, messages, **kw):
            c = messages[-1]["content"]
            if "MXU" in c and "systolic" in c:
                return "The MXU is the systolic array."
            return prompts.NO_INFO_ANSWER

    return FactChat


def _serve_and_ask(pkg: str) -> dict:
    pw = importlib.import_module(pkg)
    llm = importlib.import_module(f"{pkg}.xpacks.llm")
    from_index = importlib.import_module(f"{pkg}.stdlib.indexing.nearest_neighbors")
    servers = importlib.import_module(f"{pkg}.xpacks.llm.servers")
    http = importlib.import_module(f"{pkg}.io.http._server")
    pw.G.clear()
    docs = pw.debug.table_from_rows(pw.schema_from_types(data=str, _metadata=dict), DOCS)
    store = llm.DocumentStore(docs, from_index.BruteForceKnnFactory(dimensions=16,
                                                                    embedder=fake_embed))
    rag = llm.AdaptiveRAGQuestionAnswerer(_chat_class(pkg)(), store, n_starting_documents=1,
                                          factor=2, max_iterations=3)
    port = _free_port()
    server = servers.QASummaryRestServer("127.0.0.1", port, rag)
    kw = {"device": "cpu"} if pkg == "pathway_tpu_torch" else {}
    server.run(threaded=True, **kw)
    try:
        client = llm.RAGClient(url=f"http://127.0.0.1:{port}", timeout=20)
        deadline = time.time() + 30
        while True:
            try:
                stats = client.statistics()
                break
            except OSError:
                if time.time() > deadline:
                    raise
                time.sleep(0.1)
        return {
            "answer": client.answer("what is the MXU?"),
            "answer_ctx": client.answer("what is the MXU?", return_context_docs=True),
            "no_info": client.answer("how are croissants laminated?"),
            "retrieve": client.retrieve("systolic array MXU matrices", k=3),
            "filtered": client.retrieve("systolic array", k=3, filepath_globpattern="k*"),
            "statistics": stats,
            "list": sorted(d["path"] for d in client.list_documents()),
            "summary": client.summarize(["one MXU text", "two systolic texts"]),
            "v1_answer": client._post("/v1/pw_ai_answer", {"prompt": "what is the MXU?"}),
        }
    finally:
        pw.request_stop()
        http.terminate_all()
        if server._thread is not None:
            server._thread.join(timeout=20)
        pw.G.clear()


def test_qa_rest_roundtrip_each_on_its_own_port():
    want, got = _serve_and_ask("pathway_tpu"), _serve_and_ask("pathway_tpu_torch")
    for key in ("answer", "no_info", "statistics", "list", "summary", "v1_answer"):
        assert got[key] == want[key], key
    assert got["answer"] == "The MXU is the systolic array."
    assert_docs_close(got["retrieve"], want["retrieve"])
    assert_docs_close(got["filtered"], want["filtered"])
    assert [d["metadata"]["path"] for d in got["filtered"]] == ["kafka.txt"]
    _assert_close(got["answer_ctx"], want["answer_ctx"])


def _vector_store_answers(pkg: str) -> list:
    pw = importlib.import_module(pkg)
    vs = importlib.import_module(f"{pkg}.xpacks.llm.vector_store")
    http = importlib.import_module(f"{pkg}.io.http._server")
    pw.G.clear()
    docs = pw.debug.table_from_rows(pw.schema_from_types(data=str, _metadata=dict), DOCS)
    server = vs.VectorStoreServer(docs, embedder=fake_embed)
    port = _free_port()
    kw = {"device": "cpu"} if pkg == "pathway_tpu_torch" else {}
    server.run_server("127.0.0.1", port, threaded=True, **kw)
    try:
        client = vs.VectorStoreClient(url=f"http://127.0.0.1:{port}", timeout=20)
        deadline = time.time() + 30
        while True:
            try:
                stats = client.get_vectorstore_statistics()
                break
            except OSError:
                if time.time() > deadline:
                    raise
                time.sleep(0.1)
        return [stats, sorted(f["path"] for f in client.get_input_files()),
                client.query("systolic array MXU", k=2), client("broker for streams", k=3),
                client.query("dough", k=4, metadata_filter="modified_at >= `5`")]
    finally:
        pw.request_stop()
        http.terminate_all()
        for t in server._threads:
            t.join(timeout=20)
        pw.G.clear()


def test_vector_store_server_and_client():
    want = _vector_store_answers("pathway_tpu")
    got = _vector_store_answers("pathway_tpu_torch")
    assert got[:2] == want[:2]
    assert want[0] == {"file_count": 4, "last_modified": 9}
    for g, w in zip(got[2:], want[2:]):
        assert_docs_close(g, w)
    assert {d["metadata"]["path"] for d in got[4]} <= {"food.txt", "kafka.txt", "mxu.txt"}


@pytest.mark.parametrize("kind", ["qa", "vector_store"])
def test_threaded_run_keeps_what_the_engine_raised(kind, monkeypatch):
    """``run(threaded=True)`` of a QA server and ``run_server(threaded=True)`` of the vector
    store keep the engine thread's exception in ``run_error``, so a caller polling the server
    fails at once."""
    import threading

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.io.http import _server as http
    from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import BruteForceKnnFactory
    from pathway_tpu_torch.xpacks import llm
    from pathway_tpu_torch.xpacks.llm import servers, vector_store

    monkeypatch.setattr(threading, "excepthook", lambda args: None)
    docs = pw.debug.table_from_rows(pw.schema_from_types(data=str, _metadata=dict), DOCS)
    port = _free_port()
    if kind == "qa":
        store = llm.DocumentStore(docs, BruteForceKnnFactory(dimensions=16,
                                                             embedder=fake_embed))
        server = servers.QARestServer("127.0.0.1", port, llm.BaseRAGQuestionAnswerer(
            _chat_class("pathway_tpu_torch")(), store))
        assert server.run_error is None
        thread = server.run(threaded=True, device="no-such-device")
    else:
        server = vector_store.VectorStoreServer(docs, embedder=fake_embed, device="cpu")
        assert server.run_error is None
        thread = server.run_server("127.0.0.1", port, threaded=True, device="no-such-device")
    try:
        thread.join(timeout=20)
    finally:
        http.terminate_all()
    assert not thread.is_alive()
    assert isinstance(server.run_error, RuntimeError)
    assert "no-such-device" in str(server.run_error)


def test_vector_store_defaults_to_the_card_encoder():
    import torch

    from pathway_tpu_torch.xpacks.llm.vector_store import VectorStoreServer

    import pathway_tpu_torch as pw

    docs = pw.debug.table_from_rows(pw.schema_from_types(data=str, _metadata=dict), DOCS)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            VectorStoreServer(docs)


# -- rerankers ---------------------------------------------------------------------------------

SMALL = dict(vocab_size=30522, dim=32, n_layers=2, n_heads=2, max_len=64)
PAIRS = [("The MXU is a systolic array of multipliers.", "what is the MXU?"),
         ("Kafka keeps partitions of an event log.", "what is the MXU?"),
         ("short", "a much longer query that needs a longer bucket than the document")]


def _embedders():
    import jax.numpy as jnp
    import torch

    from pathway_tpu.models import embedder as jemb
    from pathway_tpu.xpacks.llm.embedders import TpuEmbedder
    from pathway_tpu_torch.models.embedder import Embedder, EmbedderConfig, params_from_jax
    from pathway_tpu_torch.xpacks.llm.embedders import TorchEmbedder

    jcfg = jemb.EmbedderConfig(**SMALL, dtype=jnp.float32)
    params = jemb.init_params(jcfg, 5)
    return (TpuEmbedder(jemb.Embedder(jcfg, params=params), max_len=48),
            TorchEmbedder(Embedder(EmbedderConfig(**SMALL, dtype=torch.float32),
                                   params=params_from_jax(params, device="cpu"), device="cpu"),
                          max_len=48, device="cpu"))


def test_encoder_reranker_over_the_encoder():
    from pathway_tpu.xpacks.llm.rerankers import EncoderReranker as RefReranker
    from pathway_tpu_torch.xpacks.llm.rerankers import EncoderReranker

    ref_emb, port_emb = _embedders()
    calls = []
    embed_texts = port_emb.embedder.embed_texts

    def counted(texts, **k):
        calls.append(len(texts))
        return embed_texts(texts, **k)

    port_emb.embedder.embed_texts = counted
    want = [RefReranker(ref_emb).__wrapped__(d, q) for d, q in PAIRS]
    got = [EncoderReranker(port_emb).__wrapped__(d, q) for d, q in PAIRS]
    np.testing.assert_allclose(got, want, rtol=0, atol=EMB_ATOL)
    assert calls == [1] * (2 * len(PAIRS))  # a one-row forward for each text of each pair


def test_llm_reranker_and_the_top_k_filter():
    scores = {}
    for pkg in PACKAGES:
        rr = importlib.import_module(f"{pkg}.xpacks.llm.rerankers")
        llms = importlib.import_module(f"{pkg}.xpacks.llm.llms")

        class Judge(llms.BaseChat):
            def _call_model(self, messages, **kw):
                c = messages[-1]["content"]
                return "Score: 5" if "MXU" in c.split("Query:")[0] else "2, I think"

        reranker = rr.LLMReranker(Judge())
        pw = importlib.import_module(pkg)
        pw.G.clear()
        t = pw.debug.table_from_rows(pw.schema_from_types(docs=tuple, scores=tuple), [
            (("a", "b", "c", "d"), (0.1, 0.9, 0.5, 0.7)), ((), ())])
        res = t.select(top=rr.rerank_topk_filter_expr(pw.this.docs, pw.this.scores, k=2))
        kw = {"device": "cpu"} if pkg == "pathway_tpu_torch" else {}
        keys, cols = pw.debug.table_to_dicts(res, **kw)
        pw.G.clear()
        scores[pkg] = ([reranker.__wrapped__(d, q) for d, q in PAIRS],
                       rr.rerank_topk_filter(["x", "y", "z"], [3, 1, 2], k=2),
                       sorted(cols["top"][k] for k in keys))
    assert scores["pathway_tpu_torch"] == scores["pathway_tpu"]
    assert scores["pathway_tpu"][0] == [5.0, 2.0, 2.0]


# -- prompts and gated chats -------------------------------------------------------------------


def test_prompts_equal_the_reference():
    from pathway_tpu.xpacks.llm import prompts as rp
    from pathway_tpu_torch.xpacks.llm import prompts as tp

    docs = [{"text": "first"}, "second", {"path": "no text"}]
    assert tp.__all__ == rp.__all__ and tp.NO_INFO_ANSWER == rp.NO_INFO_ANSWER
    for name in rp.__all__:
        args = (["a", "b"],) if name == "prompt_summarize" else ("why?", docs)
        assert getattr(tp, name)(*args) == getattr(rp, name)(*args), name
    assert tp.prompt_qa("q", docs, "nothing", " Be kind.") == \
        rp.prompt_qa("q", docs, "nothing", " Be kind.")


@pytest.mark.parametrize("cls,module", [("OpenAIChat", "openai"), ("LiteLLMChat", "litellm"),
                                        ("CohereChat", "cohere")])
def test_gated_chats_raise_the_reference_message(cls, module, monkeypatch):
    monkeypatch.setitem(sys.modules, module, None)
    messages = []
    for pkg in PACKAGES:
        llms = importlib.import_module(f"{pkg}.xpacks.llm.llms")
        with pytest.raises(ImportError) as e:
            getattr(llms, cls)()
        messages.append(str(e.value))
    assert messages[0] == messages[1] and module in messages[0]


def test_cross_encoder_and_hf_chat_gates(monkeypatch):
    import torch

    from pathway_tpu_torch.xpacks.llm import llms, rerankers

    monkeypatch.setitem(sys.modules, "sentence_transformers", None)
    with pytest.raises(ImportError, match="sentence_transformers"):
        rerankers.CrossEncoderReranker("any-model")
    # the HF chat runs a local pipeline on the caller's device; a pipeline object is used as is
    chat = llms.HFPipelineChat(pipeline=lambda messages, **kw: [
        {"generated_text": messages + [{"role": "assistant", "content": "local"}]}],
        device="cpu")
    assert chat.__wrapped__("hi") == "local"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            llms.HFPipelineChat(pipeline=object())


def test_chat_cache_through_the_answerer(tmp_path, monkeypatch):
    """``run_server(with_cache=True)``'s cache: each prompt reaches the model once."""
    monkeypatch.setenv("PATHWAY_PERSISTENT_STORAGE", str(tmp_path))
    out = {}
    for pkg in PACKAGES:
        pw = importlib.import_module(pkg)
        llm = importlib.import_module(f"{pkg}.xpacks.llm")
        from_index = importlib.import_module(f"{pkg}.stdlib.indexing.nearest_neighbors")
        FactChat = _chat_class(pkg)
        calls = []

        class Counting(FactChat):
            def _call_model(self, messages, **kw):
                calls.append(messages[-1]["content"])
                return super()._call_model(messages, **kw)

        pw.G.clear()
        docs = pw.debug.table_from_rows(pw.schema_from_types(data=str, _metadata=dict), DOCS)
        store = llm.DocumentStore(docs, from_index.BruteForceKnnFactory(dimensions=16,
                                                                        embedder=fake_embed))
        rag = llm.BaseRAGQuestionAnswerer(Counting(), store, search_topk=2)
        rag._enable_cache(None)
        q = pw.debug.table_from_rows(rag.AnswerQuerySchema, [
            ("what is the MXU?", None, None, False), ("what is the MXU?", None, None, False)])
        kw = {"device": "cpu"} if pkg == "pathway_tpu_torch" else {}
        answers = pw.debug.table_to_pandas(rag.answer_query(q), **kw)["result"].tolist()
        pw.G.clear()
        out[pkg] = (answers, len(calls))
    assert out["pathway_tpu_torch"] == out["pathway_tpu"]
    assert out["pathway_tpu"][1] == 1


def test_geometric_strategy_from_index():
    out = {}
    for pkg in PACKAGES:
        pw = importlib.import_module(pkg)
        qa = importlib.import_module(f"{pkg}.xpacks.llm.question_answering")
        nn = importlib.import_module(f"{pkg}.stdlib.indexing.nearest_neighbors")
        di = importlib.import_module(f"{pkg}.stdlib.indexing.data_index")
        pw.G.clear()
        docs = pw.debug.table_from_rows(pw.schema_from_types(text=str), [(t,) for t, _ in DOCS])
        index = di.DataIndex(docs, nn.BruteForceKnn(data_column=docs.text, dimensions=16,
                                                    embedder=fake_embed))
        questions = pw.debug.table_from_rows(pw.schema_from_types(query=str),
                                             [("what is the MXU?",), ("systolic",)])
        res = qa.answer_with_geometric_rag_strategy_from_index(
            questions.query, index, "text", _chat_class(pkg)(), n_starting_documents=1,
            factor=2, max_iterations=3)
        kw = {"device": "cpu"} if pkg == "pathway_tpu_torch" else {}
        out[pkg] = sorted(pw.debug.table_to_pandas(res, **kw)["result"].tolist())
        pw.G.clear()
    assert out["pathway_tpu_torch"] == out["pathway_tpu"]
    assert out["pathway_tpu"] == ["The MXU is the systolic array."] * 2


def test_llm_exports_the_reference_names():
    from pathway_tpu.xpacks import llm as rl
    from pathway_tpu_torch.xpacks import llm as tl

    assert set(rl.__all__) <= set(tl.__all__)
    for name in rl.__all__:
        assert hasattr(tl, name), name
    for mod in ("llms", "prompts", "rerankers", "question_answering", "vector_store"):
        r, t = (importlib.import_module(f"{p}.xpacks.llm.{mod}") for p in PACKAGES)
        assert set(r.__all__) == set(t.__all__), mod
    assert json.loads(json.dumps(sorted(tl.__all__)))
