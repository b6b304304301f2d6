"""PyTorch/CUDA port of ``pathway_tpu``'s RAG ingest and retrieval path and its training step,
for an NVIDIA H100.

The slices ported so far: the MiniLM-class encoder (``models.embedder``), the brute-force KNN
scorer (``ops.knn``), the mutable index engine (``ops.index_engines``), the token-count splitter
and the embedder front (``xpacks.llm``); and the one-device training step (``models.pipeline``).
Hand-written CUDA kernels carry their device work: masked attention and its gradient
(``ops.attention``), fused scoring with top-k (``ops.knn``) and the InfoNCE loss with its gradient
(``ops.infonce``). They build from ``csrc/`` at first use (``_kernels``).

Every entry point takes ``device=`` and defaults to ``"cuda"``; with no card it raises unless
the caller passes ``device="cpu"``, where each kernel's plain PyTorch version runs instead. The
package imports neither ``jax`` nor anything of ``pathway_tpu``.
"""

from .models.embedder import (
    Embedder,
    EmbedderConfig,
    embed_tokens,
    init_params,
    load_hf_state_dict,
    params_from_jax,
    tokenize_batch,
)
from .models.pipeline import make_step, run_one_step
from .models.wordpiece import WordPieceTokenizer
from .ops.attention import masked_attention, masked_attention_plain
from .ops.infonce import infonce, infonce_plain
from .ops.index_engines import BruteForceKnnEngine
from .ops.knn import (
    ShardedKnnIndex,
    knn_search,
    merge_shard_topk,
    topk_scores,
    topk_scores_plain,
)
from .utils.filters import compile_metadata_filter
from .xpacks.llm.embedders import TorchEmbedder
from .xpacks.llm.splitters import TokenCountSplitter

__all__ = [
    "BruteForceKnnEngine",
    "Embedder",
    "EmbedderConfig",
    "ShardedKnnIndex",
    "TokenCountSplitter",
    "TorchEmbedder",
    "WordPieceTokenizer",
    "compile_metadata_filter",
    "embed_tokens",
    "infonce",
    "infonce_plain",
    "init_params",
    "knn_search",
    "load_hf_state_dict",
    "make_step",
    "masked_attention",
    "masked_attention_plain",
    "merge_shard_topk",
    "params_from_jax",
    "run_one_step",
    "tokenize_batch",
    "topk_scores",
    "topk_scores_plain",
]
