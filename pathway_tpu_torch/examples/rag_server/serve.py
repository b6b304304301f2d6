"""Live RAG document store served over REST — the Adaptive-RAG template's
serving path (reference ``templates/rag``), on the card end to end.

Reads a directory of documents (txt/pdf/docx/pptx/html/markdown — the local
parser auto-dispatches by content), embeds them on the card (MiniLM-class
encoder, bf16, ``TorchEmbedder``), maintains a brute-force KNN index as one
device-resident block (exact search = one matmul + top-k kernel), and serves:

    POST /v1/retrieve   {"query": "...", "k": 3}
    POST /v1/statistics {}
    POST /v1/inputs     {}

Run:

    python -m pathway_tpu_torch.examples.rag_server.serve --docs ./docs --port 8666

``--device`` (default ``cuda``) is where the encoder, the index and the
engine's kernels run; with no card it raises unless ``--device cpu`` is
passed.

Copy of ``examples/rag_server/serve.py`` on ``pathway_tpu_torch``, with
``TorchEmbedder`` for ``TpuEmbedder``, the ``--device`` argument and
``build_server`` for callers that run the server in process. As in the
reference, ``pw.io.fs.read`` has no streaming branch for ``format="binary"``:
the directory is read once, when the graph is built, and documents dropped
into it later are not seen.
"""

from __future__ import annotations

import argparse
import os
from typing import Any

import torch

# Static-analysis suppressions (`python -m pathway_tpu_torch.cli lint`):
# - a document store's index/state is SUPPOSED to grow with the corpus —
#   there is no temporal cutoff to add;
# - the parse/split/embed UDFs run arbitrary document-processing Python
#   per row by design (they are io-heavy, not expression-shaped).
# pathway: ignore[unbounded-state, perrow-udf]

import pathway_tpu_torch as pw
from pathway_tpu_torch._device import resolve_device
from pathway_tpu_torch.internals import lintmode
from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import BruteForceKnnFactory
from pathway_tpu_torch.xpacks.llm.document_store import DocumentStore
from pathway_tpu_torch.xpacks.llm.embedders import TorchEmbedder
from pathway_tpu_torch.xpacks.llm.parsers import ParseLocal
from pathway_tpu_torch.xpacks.llm.servers import DocumentStoreServer
from pathway_tpu_torch.xpacks.llm.splitters import TokenCountSplitter


def build_server(docs: str, host: str = "127.0.0.1", port: int = 8666, max_tokens: int = 256,
                 device: str | torch.device = "cuda", *,
                 embedder: Any = None) -> DocumentStoreServer:
    """The example's ``DocumentStoreServer`` over the directory ``docs``, not yet running: start
    it with ``server.run(device=...)`` (``threaded=True`` to keep the caller's thread).
    ``embedder`` (a ``TorchEmbedder``) defaults to the seeded-init encoder on ``device``."""
    device = resolve_device(device)
    # a watch directory that does not exist yet is an empty corpus, not an
    # error — create it so the example works out of the box
    os.makedirs(docs, exist_ok=True)
    table = pw.io.fs.read(docs, format="binary", mode="streaming", with_metadata=True)
    if embedder is None:
        embedder = TorchEmbedder(device=device)
    store = DocumentStore(
        table,
        BruteForceKnnFactory(
            dimensions=embedder.embedder.cfg.dim,
            embedder=embedder.embedder,
        ),
        parser=ParseLocal(),
        splitter=TokenCountSplitter(max_tokens=max_tokens),
    )
    return DocumentStoreServer(host, port, store)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--docs", default="docs", help="directory of documents")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8666)
    ap.add_argument("--max-tokens", type=int, default=256)
    # under `lint --device`, the lint's device
    ap.add_argument("--device", default=lintmode.device(),
                    help="where the encoder, the index and the kernels run (cuda or cpu)")
    args = ap.parse_args(argv)

    server = build_server(args.docs, args.host, args.port, args.max_tokens, args.device)
    print(f"serving on http://{args.host}:{args.port}/v1/retrieve")
    server.run(device=args.device)


if __name__ == "__main__":
    main()
