"""The ported slice as a whole: corpus -> splitter -> embedder -> index engine -> answers, the
PyTorch port against the JAX package on the CPU at a small size; and the port's independence:
it loads neither JAX nor ``pathway_tpu``, and its entry points need a card unless the caller
asks for the CPU.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.models import embedder as jemb
from pathway_tpu.ops.index_engines import BruteForceKnnEngine as JaxEngine
from pathway_tpu.xpacks.llm.embedders import TpuEmbedder
from pathway_tpu.xpacks.llm.splitters import TokenCountSplitter as JaxSplitter
from pathway_tpu_torch import (
    BruteForceKnnEngine,
    Embedder,
    EmbedderConfig,
    UDF,
    TokenCountSplitter,
    TorchEmbedder,
    params_from_jax,
)
from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder
from torch_topk_checks import assert_topk_equal, bf16_ulp

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "pathway_tpu_torch"
SMALL = dict(vocab_size=64, dim=32, n_layers=2, n_heads=4, max_len=48)
EMB_F32_ATOL = 2e-5


def _corpus(seed: int, n_docs: int) -> list[str]:
    rng = np.random.default_rng(seed)
    words = ["stream", "index", "vector", "engine", "query", "token", "state", "chunk",
             "embed", "score", "table", "window", "join", "key", "row", "tick"]
    docs = []
    for _ in range(n_docs):
        sentences = [
            " ".join(rng.choice(words, size=int(rng.integers(3, 14)))) + "."
            for _ in range(int(rng.integers(2, 12)))
        ]
        docs.append(" ".join(sentences) + ("\n\n" if rng.random() < 0.3 else ""))
    return docs


def test_slice_end_to_end_matches_jax():
    docs = _corpus(0, 40)
    ours_split = TokenCountSplitter(min_tokens=8, max_tokens=24)
    theirs_split = JaxSplitter(min_tokens=8, max_tokens=24)
    chunks = []
    for doc in docs:
        mine = ours_split.__wrapped__(doc)
        assert mine == theirs_split._split(doc)
        chunks.extend(text for text, _ in mine)
    assert ours_split.__wrapped__("   ") == theirs_split._split("   ") == []
    assert len(chunks) > 60

    jcfg = jemb.EmbedderConfig(**SMALL, dtype=jnp.float32)
    params = jemb.init_params(jcfg, seed=9)
    jax_emb = jemb.Embedder(jcfg, params=params)
    torch_emb = Embedder(EmbedderConfig(**SMALL, dtype=torch.float32),
                         params=params_from_jax(params, device="cpu"), device="cpu")
    ours = BruteForceKnnEngine(SMALL["dim"], reserved_space=32, embedder=torch_emb,
                               device="cpu")
    theirs = JaxEngine(SMALL["dim"], reserved_space=32, embedder=jax_emb)
    for start in range(0, len(chunks), 16):  # ticks, as the ingest path feeds them
        part = chunks[start : start + 16]
        keys = list(range(start, start + len(part)))
        ours.add_batch(keys, part, [None] * len(part))
        theirs.add_batch(keys, part, [None] * len(part))
    np.testing.assert_allclose(ours._host, theirs._host, atol=EMB_F32_ATOL, rtol=0)

    queries = [c.split(".")[0] for c in chunks[::7]]
    limits = [5] * len(queries)
    rows_o = ours.search(queries, limits, [None] * len(queries))
    rows_t = theirs.search(queries, [6] * len(queries), [None] * len(queries))
    for r_o, r_t in zip(rows_o, rows_t):
        assert len(r_o) == 5
        s_o = np.array([[s for _, s in r_o]])
        s_t = np.array([[s for _, s in r_t]])
        i_o = np.array([[ours._slots.key_to_slot[k] for k, _ in r_o]])
        i_t = np.array([[theirs._slots.key_to_slot[k] for k, _ in r_t]])
        assert_topk_equal(s_o, i_o, s_t, i_t, bf16_ulp(s_t))


def test_torch_embedder_matches_tpu_embedder():
    jcfg = jemb.EmbedderConfig(**SMALL, dtype=jnp.float32)
    params = jemb.init_params(jcfg, seed=10)
    theirs = TpuEmbedder(jemb.Embedder(jcfg, params=params), max_len=48)
    ours = TorchEmbedder(
        Embedder(EmbedderConfig(**SMALL, dtype=torch.float32),
                 params=params_from_jax(params, device="cpu"), device="cpu"),
        max_len=48, device="cpu",
    )
    texts = ["a short text", "a somewhat longer text about stream engines " * 3, ""]
    np.testing.assert_allclose(ours.embed_batch(texts), theirs.embed_batch(texts),
                               atol=EMB_F32_ATOL, rtol=0)
    np.testing.assert_allclose(ours._embed(texts[1]), theirs._embed(texts[1]),
                               atol=EMB_F32_ATOL, rtol=0)
    np.testing.assert_allclose(ours.__wrapped__(""), theirs.__wrapped__(""), atol=EMB_F32_ATOL,
                               rtol=0)
    assert ours.get_embedding_dimension() == SMALL["dim"]


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    for make in (Embedder, lambda: BruteForceKnnEngine(8), TorchEmbedder,
                 lambda: SentenceTransformerEmbedder("all-MiniLM-L6-v2")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchEmbedder(embedder=object())
    assert issubclass(TorchEmbedder, UDF)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchEmbedder(embedder=object(), max_len=32)
    # the Table API: pw.run(), the graph runner and the debug entry points
    import pathway_tpu_torch as pt
    from pathway_tpu_torch.internals.graph_runner import GraphRunner

    with pytest.raises(RuntimeError, match="device='cpu'"):
        GraphRunner()
    t = pt.debug.table_from_rows(pt.schema_from_types(a=int), [(1,)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.debug.table_to_dicts(t)
    pt.G.clear()
    # the REST servers: run() without device= is a run on the card
    from pathway_tpu_torch.io.http._server import terminate_all
    from pathway_tpu_torch.xpacks.llm import DocumentStore, DocumentStoreServer

    docs = pt.debug.table_from_rows(pt.schema_from_types(data=str, _metadata=dict),
                                    [("a text", {"path": "a.txt"})])
    store = DocumentStore(docs, pt.indexing.BruteForceKnnFactory(
        dimensions=4, embedder=lambda text: np.ones(4)))
    server = DocumentStoreServer("127.0.0.1", 0, store)  # never started: run() raises first
    try:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            server.run()
    finally:
        terminate_all()
        pt.G.clear()


_IMPORT = re.compile(r"^\s*(?:import|from)\s+(jax|jaxlib|pathway_tpu)(?:[.\s]|$)", re.M)


def test_static_scan_finds_no_jax_or_pathway_tpu_import():
    files = sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    scanned = {str(f.relative_to(PACKAGE)) for f in files if PACKAGE in f.parents}
    assert {"parallel/frames.py", "io/columnar.py", "io/fs.py", "io/delivery.py", "io/null.py",
            "io/_object_scanner.py", "io/s3.py", "examples/rag_server/serve.py",
            "persistence/__init__.py", "persistence/backends.py", "persistence/layout.py",
            "persistence/snapshots.py", "persistence/manager.py", "rescale/__init__.py",
            "rescale/resharder.py", "engine/spill.py", "engine/frontier.py",
            "observability/critpath.py", "parallel/asyncplane.py", "engine/iterate.py",
            "internals/iterate.py", "io/_gated.py", "io/airbyte.py", "io/bigquery.py",
            "io/debezium.py", "io/deltalake.py", "io/elasticsearch.py", "io/gdrive.py",
            "io/http/__init__.py", "io/kafka.py", "io/logstash.py", "io/minio.py",
            "io/mongodb.py", "io/nats.py", "io/postgres.py", "io/pubsub.py",
            "io/pyfilesystem.py", "io/redpanda.py", "io/slack.py", "io/sqlite.py",
            "xpacks/connectors/__init__.py", "xpacks/connectors/sharepoint.py",
            "demo/__init__.py", "analysis/__init__.py", "analysis/graph.py", "analysis/lint.py",
            "analysis/passes.py", "analysis/report.py", "internals/lintmode.py",
            "internals/yaml_loader.py", "internals/error_log_table.py",
            "internals/interactive.py", "stdlib/viz/__init__.py", "xpacks/llm/llms.py",
            "xpacks/llm/prompts.py", "xpacks/llm/rerankers.py", "xpacks/llm/vector_store.py",
            "xpacks/llm/question_answering.py"} <= scanned
    # the YAML loader imports the modules its tags name; it maps the reference's package to the
    # port's and refuses JAX (held below), so it is the one module allowed to import by name
    loader = PACKAGE / "internals" / "yaml_loader.py"
    for path in files:
        src = path.read_text()
        assert not _IMPORT.findall(src), path
        if path.parent.name != "tests" and path.name != "chip_smoke.py" and path != loader:
            assert "import_module(" not in src and "__import__(" not in src, path
    from pathway_tpu_torch.internals.yaml_loader import _resolve_dotted

    for name in ("jax.numpy.zeros", "jaxlib.version"):
        with pytest.raises(ImportError, match="imports no JAX"):
            _resolve_dotted(name)
    assert _resolve_dotted("pathway_tpu.xpacks.llm.splitters.NullSplitter").__module__ == \
        "pathway_tpu_torch.xpacks.llm.splitters"


_BLOCKED_RUN = textwrap.dedent("""
    import importlib.abc
    import sys

    sys.modules["jax"] = None
    sys.modules["tiktoken"] = None  # its encodings come over the network; the splitter counts words

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name == "pathway_tpu" or name.startswith("pathway_tpu."):
                raise ImportError("blocked: " + name)
            return None

    sys.meta_path.insert(0, Block())

    import numpy as np
    import torch
    import pathway_tpu_torch as pt

    cfg = pt.EmbedderConfig(vocab_size=64, dim=32, n_layers=2, n_heads=4, max_len=48,
                            dtype=torch.float32)
    emb = pt.Embedder(cfg, device="cpu")
    chunks = [c for c, _ in pt.TokenCountSplitter(min_tokens=4, max_tokens=12).__wrapped__(
        "stream engines keep state. vector indexes answer queries. " * 6)]
    engine = pt.BruteForceKnnEngine(32, embedder=emb, device="cpu")
    engine.add_batch(list(range(len(chunks))), chunks, [None] * len(chunks))
    rows = engine.search(["vector indexes"], [3], [None])
    assert len(rows[0]) == 3, rows
    index = pt.ShardedKnnIndex(32, capacity=64, device="cpu")
    index.add(emb.embed_texts(chunks))
    s, i = index.query(emb.embed_texts(["stream engines"]), 2)
    assert np.isfinite(s).all()
    vec = pt.TorchEmbedder(emb, device="cpu").__wrapped__("a text")
    assert vec.shape == (32,)

    # the engine core: a 2-worker wordcount whose exchange goes through MeshComm on the CPU
    import threading
    from pathway_tpu_torch.engine import keys as K, operators as ops
    from pathway_tpu_torch.engine.delta import Delta
    from pathway_tpu_torch.engine.executor import Executor
    from pathway_tpu_torch.engine.reducers import make_reducer
    from pathway_tpu_torch.parallel.comm import LocalComm, WorkerContext
    from pathway_tpu_torch.parallel.meshcomm import MeshComm

    words = np.array(["a", "b", "c", "a", "b", "a"] * 20, dtype=object)
    comm = MeshComm(LocalComm(2), device="cpu")
    caps, runs = [], []
    for w in range(2):
        src = ops.ScheduledSource(["word"], [
            (2 * t + 2, Delta(keys=K.mix_columns([np.arange(s, s + 40)], 40, register=False),
                              data={"word": words[s:s + 40]}))
            for t, s in enumerate(range(0, 120, 40))])
        gb = ops.GroupByReduce(src, ["word"], [("c", make_reducer("count"), [])])
        caps.append(ops.Capture(gb))
        runs.append(Executor([src, gb, caps[-1]], ctx=WorkerContext(w, 2, comm)))
    threads = [threading.Thread(target=e.run) for e in runs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    counts = {row[0]: row[1] for _, row in caps[0].state.iter_items()}
    assert counts == {"a": 60, "b": 40, "c": 20}, counts
    assert comm.comm_stats()["mesh_rows_moved"] > 0

    # the Table API through pw.run on the CPU, past the expression tier's gates, at 2 workers
    import os
    from pathway_tpu_torch.internals import expression_compiler as ec
    from pathway_tpu_torch.ops.expression_kernel import HostLauncher

    ec.JIT_THRESHOLD, ec.JIT_WARMUP_BATCHES = 8, 1
    os.environ.update(PATHWAY_THREADS="2", PATHWAY_MESH_EXCHANGE="1")

    class Feed(pt.io.python.ConnectorSubject):
        def run(self):
            for s in range(0, 600, 100):
                self.next_batch({"a": list(range(s, s + 100)), "g": [i % 7 for i in range(100)]})
                self.commit()

    src = pt.io.python.read(Feed(), schema=pt.schema_from_types(a=int, g=int),
                            autocommit_duration_ms=None)
    res = (src.select(g=pt.this.g, y=pt.apply_with_type(lambda a: a * 3 + 7, int, pt.this.a))
           .filter(pt.this.y > 100)
           .groupby(pt.this.g).reduce(pt.this.g, s=pt.reducers.sum(pt.this.y)))
    sums = {}

    def on_change(key, row, time, is_addition):
        if is_addition:
            sums[row["g"]] = row["s"]

    pt.io.subscribe(res, on_change=on_change)
    pt.run(device="cpu")
    want = {}
    for a in range(600):
        if a * 3 + 7 > 100:
            want[(a % 100) % 7] = want.get((a % 100) % 7, 0) + a * 3 + 7
    assert sums == want, (sums, want)
    assert HostLauncher.runs > 0

    # the native keyspace module and pw.indexing: BM25 and a sort through pw.run on the CPU,
    # still at 2 workers
    import pathway_tpu_torch.native as native
    import pathway_tpu_torch.stdlib.indexing as indexing

    assert native.load().__name__ == "_pathway_torch_native"
    pt.G.clear()
    docs = pt.debug.table_from_rows(pt.schema_from_types(name=str, text=str), [
        ("a", "alpha beta"), ("b", "gamma delta"), ("c", "alpha")])
    qs = pt.debug.table_from_rows(pt.schema_from_types(q=str), [("alpha",)])
    answer = indexing.default_full_text_document_index(docs.text, docs).query_as_of_now(
        qs.q, number_of_matches=2).select(m=pt.right.name)
    order = docs + docs.sort(key=docs.name)
    found, chained = [], {}
    pt.io.subscribe(answer, on_change=lambda key, row, time, is_addition: found.append(row["m"]))
    pt.io.subscribe(order, on_change=lambda key, row, time, is_addition: chained.update(
        {row["name"]: row["next"]}))
    pt.run(device="cpu")
    assert sorted(found[-1]) == ["a", "c"], found
    assert chained["c"] is None and len(chained) == 3, chained

    # the RAG serve path's modules: xpacks.llm, io.http (on aiohttp) and serve; a DocumentStore
    # with the local parser, the splitter and the encoder through pw.run, still at 2 workers
    import pathway_tpu_torch.io.http
    import pathway_tpu_torch.serve
    from pathway_tpu_torch.xpacks.llm import DocumentStore, DocumentStoreServer, parsers, splitters

    pt.G.clear()
    docs = pt.debug.table_from_rows(pt.schema_from_types(data=bytes, _metadata=dict), [
        (b"<html><title>t</title><body><p>vector indexes answer queries.</p></body></html>",
         {"path": "a.html"}),
        (b"stream engines keep state.", {"path": "b.txt"})])
    store = DocumentStore(docs, pt.indexing.BruteForceKnnFactory(dimensions=32, embedder=emb),
                          parser=parsers.ParseLocal(),
                          splitter=splitters.TokenCountSplitter(min_tokens=2, max_tokens=12))
    q = pt.debug.table_from_rows(DocumentStore.RetrieveQuerySchema,
                                 [("vector indexes", 2, None, None)])
    [row] = pt.debug.table_to_pandas(store.retrieve_query(q), device="cpu")["result"].tolist()
    assert sorted(d["metadata"]["path"] for d in row) == ["a.html", "b.txt"], row
    # the file connectors, the connector frame and the delivery-managed writers: a csv read,
    # a groupby and a csv write through pw.run on the CPU, still at 2 workers; a tail stream;
    # then the example's server over a directory, built but not started
    import tempfile
    import pathway_tpu_torch.io.columnar
    import pathway_tpu_torch.io.s3
    from pathway_tpu_torch.parallel import frames
    from pathway_tpu_torch.examples.rag_server import serve

    work = tempfile.mkdtemp()
    with open(f"{work}/words.csv", "w") as f:
        f.write("word\\n" + "".join(w + "\\n" for w in ["a", "b", "a", "c", "a"]))
    pt.G.clear()
    words = pt.io.csv.read(f"{work}/words.csv", schema=pt.schema_from_types(word=str),
                           mode="static")
    pt.io.csv.write(words.groupby(pt.this.word).reduce(pt.this.word, n=pt.reducers.count()),
                    f"{work}/out.csv")
    pt.run(device="cpu")
    with open(f"{work}/out.csv") as f:
        assert sorted(f.read().splitlines()) == ["a,3,0,1", "b,1,0,1", "c,1,0,1",
                                                 "word,n,time,diff"]
    with open(f"{work}/lines.txt", "w") as f:
        f.write("x\\ny\\n")
    src = pt.io.fs.FsStreamSource(f"{work}/lines.txt", "plaintext",
                                  pt.schema_from_types(data=str), ["data"], autocommit_ms=None)
    [delta] = src.poll()
    chunks, _ = frames.encode_frame(0, 1, 0, {0: delta})
    back = frames.open_connector_frame(b"".join(bytes(c) for c in chunks))
    assert list(back.data["data"]) == ["x", "y"] and (back.keys == delta.keys).all()
    pt.G.clear()
    docs = f"{work}/docs"
    os.makedirs(docs)
    with open(f"{docs}/a.txt", "w") as f:
        f.write("vector indexes answer queries.")
    server = serve.build_server(docs, "127.0.0.1", 0, 64, "cpu",
                                embedder=pt.TorchEmbedder(emb, device="cpu"))
    q = pt.debug.table_from_rows(DocumentStore.RetrieveQuerySchema,
                                 [("vector indexes", 1, None, None)])
    [row] = pt.debug.table_to_pandas(server.document_store.retrieve_query(q),
                                     device="cpu")["result"].tolist()
    assert row[0]["text"] == "vector indexes answer queries.", row
    from pathway_tpu_torch.io.http._server import terminate_all
    terminate_all()

    # persistence: the csv wordcount persisted on the filesystem, still at 2 workers, run twice;
    # the second run restores its state, re-counts nothing and writes no row again
    import pathway_tpu_torch.persistence as persistence

    cfg = persistence.Config.simple_config(persistence.Backend.filesystem(f"{work}/pstate"))
    for _ in range(2):
        pt.G.clear()
        words = pt.io.python.read(Feed(), schema=pt.schema_from_types(a=int, g=int),
                                  autocommit_duration_ms=None, name="feed")
        pt.io.csv.write(words.groupby(pt.this.g).reduce(pt.this.g, n=pt.reducers.count()),
                        f"{work}/persisted.csv")
        pt.run(device="cpu", persistence_config=cfg)
    with open(f"{work}/persisted.csv") as f:
        rows = [line.split(",") for line in f.read().splitlines()[1:]]
    net = {}
    for g, n, _t, d in rows:
        net[(g, n)] = net.get((g, n), 0) + int(d)
    want = {(str(g), str(sum(1 for i in range(100) if i % 7 == g) * 6)) for g in range(7)}
    assert {k for k, v in net.items() if v} == want, net

    # elastic rescale and the spill tier: the store resharded 2 -> 1 offline, then the program
    # once more at 1 worker under a state budget of about 1 KiB: the store holds every count,
    # so nothing is re-counted and the csv nets to the same counts
    from pathway_tpu_torch.engine import spill
    from pathway_tpu_torch.persistence.backends import FilesystemBackend
    from pathway_tpu_torch.rescale import rescale

    report = rescale(FilesystemBackend(f"{work}/pstate"), 1, log=lambda msg: None)
    assert (report["from"], report["to"], report["ranks"]) == (2, 1, 1), report
    os.environ.update(PATHWAY_THREADS="1", PATHWAY_STATE_MEMORY_BUDGET_MB="0.001",
                      PATHWAY_STATE_SPILL_DIR=f"{work}/spill")
    spill._reset_for_tests()
    pt.G.clear()
    words = pt.io.python.read(Feed(), schema=pt.schema_from_types(a=int, g=int),
                              autocommit_duration_ms=None, name="feed")
    pt.io.csv.write(words.groupby(pt.this.g).reduce(pt.this.g, n=pt.reducers.count()),
                    f"{work}/persisted.csv")
    pt.run(device="cpu", persistence_config=cfg)
    with open(f"{work}/persisted.csv") as f:
        rows = [line.split(",") for line in f.read().splitlines()[1:]]
    net = {}
    for g, n, _t, d in rows:
        net[(g, n)] = net.get((g, n), 0) + int(d)
    assert {k for k, v in net.items() if v} == want, net
    pt.G.clear()
    big = pt.debug.table_from_rows(pt.schema_from_types(a=int), [(i,) for i in range(3000)])
    [n] = pt.debug.table_to_pandas(big.groupby(pt.this.a).reduce(n=pt.reducers.count())
                                   .reduce(n=pt.reducers.count()), device="cpu")["n"].tolist()
    assert n == 3000, n
    assert spill.get_budget().budget_bytes == 1048, spill.get_budget()

    # the async plane and pw.iterate: the csv wordcount persisted at 2 workers over LocalComm
    # takes the frontier-driven loop by default and commits in waves; then a fixpoint
    import pathway_tpu_torch.engine.frontier
    import pathway_tpu_torch.observability.critpath
    import pathway_tpu_torch.parallel.asyncplane
    from pathway_tpu_torch.engine import executor as E

    waves = []
    orig_wave = E.Executor._async_commit_wave

    def counting(self, *a, **k):
        waves.append(self.ctx.worker_id)
        return orig_wave(self, *a, **k)

    E.Executor._async_commit_wave = counting
    for var in ("PATHWAY_STATE_MEMORY_BUDGET_MB", "PATHWAY_STATE_SPILL_DIR",
                "PATHWAY_MESH_EXCHANGE"):
        os.environ.pop(var, None)
    os.environ["PATHWAY_THREADS"] = "2"
    spill._reset_for_tests()
    cfg = persistence.Config.simple_config(persistence.Backend.filesystem(f"{work}/pstate2"),
                                           snapshot_interval_ms=10)
    pt.G.clear()
    words = pt.io.python.read(Feed(), schema=pt.schema_from_types(a=int, g=int),
                              autocommit_duration_ms=None, name="feed")
    pt.io.csv.write(words.groupby(pt.this.g).reduce(pt.this.g, n=pt.reducers.count()),
                    f"{work}/async.csv")
    pt.run(device="cpu", persistence_config=cfg)
    assert sorted(set(waves)) == [0, 1], waves
    with open(f"{work}/async.csv") as f:
        rows = [line.split(",") for line in f.read().splitlines()[1:]]
    net = {}
    for g, n, _t, d in rows:
        net[(g, n)] = net.get((g, n), 0) + int(d)
    assert {k for k, v in net.items() if v} == want, net
    pt.G.clear()
    t = pt.debug.table_from_markdown("a\\n1\\n3\\n50")
    res = pt.iterate(lambda t: t.select(a=pt.if_else(t.a < 100, t.a * 2, t.a)), t=t)
    assert sorted(pt.debug.table_to_pandas(res, device="cpu")["a"]) == [100, 128, 192]
    pt.G.clear()
    from pathway_tpu_torch.xpacks.llm import question_answering as qa

    docs = pt.debug.table_from_rows(pt.schema_from_types(data=str, _metadata=dict),
                                    [("the answer is here", {"path": "a.txt"})])
    store = pt.xpacks.llm.DocumentStore(docs, pt.indexing.BruteForceKnnFactory(
        dimensions=4, embedder=lambda s: np.ones(4)))

    class Chat(pt.xpacks.llm.llms.BaseChat):
        def _call_model(self, messages, **kwargs):
            return "replied"

    rag = qa.BaseRAGQuestionAnswerer(Chat(), store, search_topk=1)
    q = pt.debug.table_from_rows(rag.AnswerQuerySchema, [("where?", None, None, False)])
    answer = rag.answer_query(q)
    pt.io.subscribe(answer, on_change=lambda **kw: None)
    report = pt.analyze(device="cpu")
    assert report.stats["operators"] > 5, report.stats
    assert pt.debug.table_to_pandas(answer, device="cpu")["result"].tolist() == ["replied"]
    pt.G.clear()
    objs = pt.load_yaml("s: !pw.xpacks.llm.splitters.NullSplitter\\n")
    assert type(objs["s"]).__name__ == "NullSplitter"
    loaded = sorted(
        m for m, mod in sys.modules.items() if mod is not None
        and (m.startswith("jax") or m == "pathway_tpu" or m.startswith("pathway_tpu."))
    )
    assert not loaded, loaded
    print("SLICE-OK", len(chunks))
""")


def test_slice_runs_with_jax_and_pathway_tpu_blocked():
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_RUN], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "SLICE-OK" in proc.stdout
