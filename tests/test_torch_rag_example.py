"""The ported example (``pathway_tpu_torch/examples/rag_server/serve.py``) against the reference's
``examples/rag_server/serve.py``, on the CPU, over the same small directory of documents (plain
text, HTML, Markdown) with the same encoder weights (an f32 encoder of the JAX package carried
across with ``params_from_jax``).

- The reference's script runs through its own ``main()`` (its encoder swapped for the small one,
  its server started on a thread); the port's through ``build_server(..., device="cpu")``.
- Both read the directory into a table of ``data`` alone (no ``_metadata``: the binary read has
  no streaming branch in either package, so the store's every ``_metadata`` is ``{}``).
- ``/v1/retrieve`` answers agree: each ``dist`` within one bf16 ulp of the reference's, texts
  equal where the dists are clear (ROADMAP Queue 3 item 3); ``/v1/statistics`` and
  ``/v1/inputs`` are equal.
- ``--device`` defaults to ``cuda`` and raises with no card; ``python -m
  pathway_tpu_torch.examples.rag_server.serve --device cpu`` serves with ``jax`` and
  ``pathway_tpu`` blocked.

Every server binds a free port, every client is ``urllib`` without a proxy, and each engine
thread and process is stopped within a bounded time.
"""

from __future__ import annotations

import importlib.util
import json
import os
import socket
import subprocess
import sys
import textwrap
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import jax.numpy as jnp
import pytest
import torch

import pathway_tpu as rpw
import pathway_tpu_torch as tpw
from pathway_tpu.io.http import _server as rserver
from pathway_tpu.models import embedder as jemb
from pathway_tpu.xpacks.llm.embedders import TpuEmbedder
from pathway_tpu_torch.examples.rag_server import serve as tserve
from pathway_tpu_torch.io.http import _server as tserver
from pathway_tpu_torch.models.embedder import Embedder, EmbedderConfig, params_from_jax
from pathway_tpu_torch.xpacks.llm.embedders import TorchEmbedder
from torch_topk_checks import assert_docs_close

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(vocab_size=256, dim=32, n_layers=2, n_heads=4, max_len=64)
_OPENER = urllib.request.build_opener(urllib.request.ProxyHandler({}))

DOCS = {
    "streams.txt": "Streaming dataflow keeps an index live as documents change. "
                   "Each commit is a tick of the engine.",
    "kafka.html": "<html><head><title>Brokers</title></head><body><p>Kafka is a distributed "
                  "message broker for event streams.</p><p>Topics hold partitions.</p></body>"
                  "</html>",
    "food.md": "# Baking\n\nCroissants are made with laminated butter dough.\n\n## Bread\n\n"
               "Sourdough rises slowly with a starter.",
    "tpu.txt": "Matrix units multiply tiles of bf16 values. A systolic array passes partial "
               "sums along its rows.",
}
QUERIES = ["event streams broker", "butter dough", "systolic array tiles", "engine tick"]


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    # tiktoken fetches its encodings over the network: both splitters count words instead
    monkeypatch.setitem(sys.modules, "tiktoken", None)
    rpw.G.clear()
    tpw.G.clear()
    yield
    rserver.terminate_all()
    tserver.terminate_all()
    rpw.G.clear()
    tpw.G.clear()


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def post(port: int, route: str, body: dict, deadline_s: float = 60.0):
    """One JSON POST once the server listens: (status, parsed body)."""
    deadline = time.monotonic() + deadline_s
    req = urllib.request.Request(f"http://127.0.0.1:{port}{route}", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    while True:
        try:
            with _OPENER.open(req, timeout=30) as resp:
                return resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read() or b"null")
        except OSError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.05)


def _docs_dir(tmp_path: Path) -> Path:
    d = tmp_path / "docs"
    d.mkdir()
    for name, text in DOCS.items():
        (d / name).write_text(text)
    return d


def _ask(port: int) -> list:
    out = [post(port, "/v1/retrieve", {"query": q, "k": 3}) for q in QUERIES]
    out.append(post(port, "/v1/statistics", {}))
    out.append(post(port, "/v1/inputs", {}))
    return out


def _stop(p, server_thread: threading.Thread, terminate) -> None:
    p.request_stop()
    terminate()
    server_thread.join(30)
    assert not server_thread.is_alive(), "the server's engine thread did not stop"


def _reference_answers(docs: Path, params) -> tuple[list, list]:
    """The reference's example through its own ``main()``: the small encoder for its default one,
    the server started on a thread."""
    spec = importlib.util.spec_from_file_location("reference_rag_serve",
                                                  ROOT / "examples" / "rag_server" / "serve.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    jcfg = jemb.EmbedderConfig(**SMALL, dtype=jnp.float32)
    started = []

    class ThreadedServer(mod.DocumentStoreServer):
        def run(self, **kwargs):
            started.append(self)
            super().run(threaded=True, **kwargs)

    mod.TpuEmbedder = lambda: TpuEmbedder(jemb.Embedder(jcfg, params=params))
    mod.DocumentStoreServer = ThreadedServer
    port = free_port()
    argv, sys.argv = sys.argv, ["serve.py", "--docs", str(docs), "--port", str(port)]
    try:
        mod.main()
    finally:
        sys.argv = argv
    [server] = started
    try:
        answers = _ask(port)
        columns = server.document_store.docs.column_names()
    finally:
        _stop(rpw, server._thread, rserver.terminate_all)
    return answers, columns


def _port_answers(docs: Path, params) -> tuple[list, list]:
    cfg = EmbedderConfig(**SMALL, dtype=torch.float32)
    embedder = TorchEmbedder(Embedder(cfg, params=params_from_jax(params, device="cpu"),
                                      device="cpu"), device="cpu")
    port = free_port()
    server = tserve.build_server(str(docs), "127.0.0.1", port, 256, "cpu", embedder=embedder)
    server.run(threaded=True, device="cpu")
    try:
        answers = _ask(port)
        columns = server.document_store.docs.column_names()
    finally:
        _stop(tpw, server._thread, tserver.terminate_all)
    return answers, columns


def test_ported_example_answers_as_the_reference(tmp_path):
    docs = _docs_dir(tmp_path)
    params = jemb.init_params(jemb.EmbedderConfig(**SMALL, dtype=jnp.float32), seed=5)
    want, want_cols = _reference_answers(docs, params)
    got, got_cols = _port_answers(docs, params)
    assert got_cols == want_cols == ["data"]
    for q, (g_status, g), (w_status, w) in zip(QUERIES, got, want):
        assert g_status == w_status == 200, (g, w)
        assert len(g) == 3, q
        assert_docs_close(g, w)
        assert all("path" not in d["metadata"] for d in g)  # only what the parser adds
    (g_status, g_stats), (w_status, w_stats) = got[-2], want[-2]
    assert g_status == w_status == 200 and g_stats == w_stats
    assert g_stats == {"file_count": len(DOCS), "last_modified": 0}
    (g_status, g_inputs), (w_status, w_inputs) = got[-1], want[-1]
    assert g_status == w_status == 200 and g_inputs == w_inputs
    assert g_inputs == [{"path": None}] * len(DOCS)


def test_device_defaults_to_cuda_and_raises_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.main(["--docs", str(tmp_path / "docs")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.build_server(str(tmp_path / "docs"))


_MODULE_RUN = textwrap.dedent("""
    import importlib.abc
    import runpy
    import sys

    sys.modules["jax"] = None
    sys.modules["tiktoken"] = None  # its encodings come over the network; the splitter counts words

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name == "pathway_tpu" or name.startswith("pathway_tpu."):
                raise ImportError("blocked: " + name)
            return None

    sys.meta_path.insert(0, Block())
    sys.argv = ["serve"] + sys.argv[1:]
    runpy.run_module("pathway_tpu_torch.examples.rag_server.serve", run_name="__main__")
""")


def test_module_entry_point_serves_on_the_cpu(tmp_path):
    """``python -m pathway_tpu_torch.examples.rag_server.serve --device cpu`` with the default
    encoder, ``jax`` and ``pathway_tpu`` blocked: it serves every document."""
    docs = _docs_dir(tmp_path)
    port = free_port()
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.Popen(
        [sys.executable, "-c", _MODULE_RUN, "--docs", str(docs), "--port", str(port),
         "--device", "cpu"], cwd=tmp_path, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        status, stats = post(port, "/v1/statistics", {}, deadline_s=120)
        assert (status, stats["file_count"]) == (200, len(DOCS))
        status, answer = post(port, "/v1/retrieve", {"query": "butter dough", "k": 2})
        assert status == 200 and len(answer) == 2
        assert all(d["text"] and "path" not in d["metadata"] for d in answer), answer
    finally:
        proc.terminate()
        try:
            out, err = proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate(timeout=30)
    assert "serving on http://127.0.0.1" in out, err[-4000:]
