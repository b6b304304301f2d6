"""PyTorch/CUDA port of ``pathway_tpu``'s RAG ingest and retrieval path, its training step, its
sequence- and index-parallel paths and its dataflow engine's core, for an NVIDIA H100.

The slices ported so far: the MiniLM-class encoder (``models.embedder``), the brute-force KNN
scorer (``ops.knn``), the mutable index engine (``ops.index_engines``), the token-count splitter
and the embedder front (``xpacks.llm``); the one-device training step (``models.pipeline``); the
meshes over ``torch.distributed`` (``parallel``), long-context embedding with ring attention
(``models.ring_attention``) and the sharded KNN search (``ops.knn``); the dataflow engine's core
(``engine``: executor, operators, keys, external index) sharded over worker threads, with its
record exchange on the card (``parallel.meshcomm``, ``parallel.exchange``). Hand-written CUDA
kernels carry their device work: masked attention and its gradient (``ops.attention``), fused
scoring with top-k and the sharded search's merge (``ops.knn``), the InfoNCE loss with its
gradient (``ops.infonce``), the ring's block step (``ops.ring``) and the exchange's bucketing
(``parallel.exchange``). They build from ``csrc/`` at first use (``_kernels``).

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
from .models.ring_attention import (
    embed_tokens_long,
    full_attention,
    ring_attention,
    ring_encoder_block,
)
from .models.wordpiece import WordPieceTokenizer
from .ops.attention import masked_attention, masked_attention_plain
from .ops.infonce import infonce, infonce_plain
from .ops.index_engines import BruteForceKnnEngine
from .ops.knn import (
    ShardedKnnIndex,
    knn_search,
    merge_shard_topk,
    sharded_knn_search,
    topk_merge,
    topk_merge_plain,
    topk_scores,
    topk_scores_plain,
)
from .ops.ring import ring_block_attention, ring_block_attention_plain
from .parallel.distributed import global_mesh, init_from_env
from .parallel.exchange import bucket_exchange, bucket_exchange_plain, bucketed_all_to_all
from .parallel.mesh import data_model_mesh, make_mesh
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
    "bucket_exchange",
    "bucket_exchange_plain",
    "bucketed_all_to_all",
    "compile_metadata_filter",
    "data_model_mesh",
    "embed_tokens",
    "embed_tokens_long",
    "full_attention",
    "global_mesh",
    "infonce",
    "infonce_plain",
    "init_from_env",
    "init_params",
    "knn_search",
    "load_hf_state_dict",
    "make_mesh",
    "make_step",
    "masked_attention",
    "masked_attention_plain",
    "merge_shard_topk",
    "params_from_jax",
    "ring_attention",
    "ring_block_attention",
    "ring_block_attention_plain",
    "ring_encoder_block",
    "run_one_step",
    "sharded_knn_search",
    "tokenize_batch",
    "topk_merge",
    "topk_merge_plain",
    "topk_scores",
    "topk_scores_plain",
]
