"""PyTorch/CUDA port of ``pathway_tpu``'s RAG ingest, retrieval and serving path, its training
step, its sequence- and index-parallel paths and its dataflow engine, for an NVIDIA H100.

The slices ported so far: the MiniLM-class encoder (``models.embedder``), the brute-force KNN
scorer (``ops.knn``), the mutable index engine (``ops.index_engines``); the one-device training
step (``models.pipeline``); the meshes over ``torch.distributed`` (``parallel``), long-context
embedding with ring attention (``models.ring_attention``) and the sharded KNN search
(``ops.knn``); the dataflow engine's core (``engine``: executor, operators, keys, external index)
sharded over worker threads, with its record exchange on the card (``parallel.meshcomm``,
``parallel.exchange``), its streaming runs frontier-driven by default (``parallel.asyncplane``,
``engine.frontier``: commit waves and boundary-only acks; ``PATHWAY_ASYNC_EXEC=0`` selects the
lock-step loop); the Table API down to ``run()`` (``internals``: tables, expressions,
schemas, the parse graph, the graph runner and the expression compiler; ``io.python``,
``io.subscribe``, ``debug``, ``reducers``, ``udfs``), so that ``import pathway_tpu_torch as pw``
reads like the reference; ``persistence`` (checkpoints of input and operator state, recovery,
exactly-once delivery-managed output); ``pw.iterate``; ``pw.temporal`` (windows, the
interval, window and as-of joins, their behaviours), ``pw.ordered``, ``pw.statistical``,
``pw.stateful`` and ``pw.universes``; ``pw.utils``, ``pw.graphs``, ``pw.ml``, ``pw.sql`` and the
row transformers (``pw.transformer``, ``pw.AsyncTransformer``); the native keyspace module under the
engine (``native``, built with the host C compiler at first use); ``pw.indexing`` (KNN, BM25,
hybrid and sorted indexes) and ``Table.sort``; the RAG serving path (``xpacks.llm``: the local parsers, the splitters and
embedders as UDFs, the live ``DocumentStore`` and ``DocumentStoreServer``; ``io.http``'s
``rest_connector``; the ``serve`` plane's admission control and merge); every connector of
``pw.io`` (those without their client package raise when called), ``xpacks.connectors`` and
``pw.demo``; the rest of ``xpacks.llm`` (chats, prompts, rerankers, the vector store and the RAG
question answerers with their REST servers); ``pw.analyze`` and lint mode (``analysis``),
``pw.load_yaml``, the error-log tables, ``LiveTable`` with interactive mode, and ``pw.viz``.
Hand-written CUDA
kernels carry their device work: masked attention and its gradient (``ops.attention``), fused
scoring with top-k and the sharded search's merge (``ops.knn``), the InfoNCE loss with its
gradient (``ops.infonce``), the ring's block step (``ops.ring``), the exchange's bucketing
(``parallel.exchange``) and the expression register machine that runs the compiled numeric
expressions and fused chains (``ops.expression_kernel``). They build from ``csrc/`` at first use
(``_kernels``).

Every entry point takes ``device=`` and defaults to ``"cuda"``; with no card it raises unless
the caller passes ``device="cpu"``, where each kernel's plain PyTorch version runs instead. The
package imports neither ``jax`` nor anything of ``pathway_tpu``.
"""

from . import reducers, udfs
from .internals import dtype as _dt
from .internals.config import PathwayConfig, get_pathway_config
from .internals.custom_reducers import BaseCustomAccumulator
from .internals.expression import (
    ColumnExpression,
    ColumnReference,
    apply,
    apply_async,
    apply_with_type,
    cast,
    coalesce,
    declare_type,
    fill_error,
    if_else,
    make_tuple,
    require,
    unwrap,
)
from .internals.groupbys import GroupedTable
from .internals.joins import Joinable, JoinMode, JoinResult
from .internals.json import Json
from .internals.error_log_table import global_error_log, local_error_log
from .internals.parse_graph import G, Universe
from .internals.iterate import iterate, iterate_universe
from .internals.monitoring import MonitoringLevel
from .internals.py_object_wrapper import PyObjectWrapper
from .internals.run import request_stop, run, run_all
from .internals.sql import sql
from .internals.yaml_loader import load_yaml
from .internals.schema import (
    Schema,
    SchemaProperties,
    assert_table_has_schema,
    column_definition,
    schema_builder,
    schema_from_dict,
    schema_from_types,
)
from .internals.table import (
    Table,
    TableLike,
    groupby,
    join,
    join_inner,
    join_left,
    join_outer,
    join_right,
)
from .internals.thisclass import left, right, this
from .udfs import UDF, udf, udf_async
from . import debug, demo, io, persistence, stdlib, universes  # noqa: E402
from .stdlib import graphs, indexing, ml, ordered, stateful, statistical, temporal, viz  # noqa: E402
from .internals.interactive import (  # noqa: E402
    LiveTable,
    enable_interactive_mode,
    is_interactive_mode_enabled,
)
from .stdlib.utils.async_transformer import AsyncTransformer  # noqa: E402
from .internals.row_transformer import (  # noqa: E402
    ClassArg,
    attribute,
    input_attribute,
    input_method,
    method,
    output_attribute,
    transformer,
)
from .analysis import analyze  # noqa: E402

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
    topk_merge_shards,
    topk_merge_shards_plain,
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
from .ops.expression_kernel import expression_vm, run_program, run_program_plain


class Type:
    """Engine-level type tags (reference ``PathwayType``)."""

    ANY = _dt.ANY
    STRING = _dt.STR
    INT = _dt.INT
    BOOL = _dt.BOOL
    FLOAT = _dt.FLOAT
    POINTER = _dt.POINTER
    DATE_TIME_NAIVE = _dt.DATE_TIME_NAIVE
    DATE_TIME_UTC = _dt.DATE_TIME_UTC
    DURATION = _dt.DURATION
    JSON = _dt.JSON
    BYTES = _dt.BYTES


Pointer = _dt.Pointer  # pointer typehint (engine keys are 64-bit ints)
DateTimeNaive = _dt.DATE_TIME_NAIVE
DateTimeUtc = _dt.DATE_TIME_UTC
Duration = _dt.DURATION

# ``pw.utils`` is the stdlib's utils (col, filtering, the async and pandas transformers), as in the
# reference. The package ``utils/`` (the metadata filter compiler) was imported above, so the
# import system keeps it under its own name, where ``from .utils.filters import ...`` finds it.
from .stdlib import utils  # noqa: E402

__all__ = [
    "AsyncTransformer",
    "BaseCustomAccumulator",
    "ClassArg",
    "ColumnExpression",
    "ColumnReference",
    "DateTimeNaive",
    "DateTimeUtc",
    "Duration",
    "G",
    "GroupedTable",
    "JoinMode",
    "JoinResult",
    "Joinable",
    "Json",
    "LiveTable",
    "MonitoringLevel",
    "PathwayConfig",
    "Pointer",
    "PyObjectWrapper",
    "Schema",
    "SchemaProperties",
    "Table",
    "TableLike",
    "Type",
    "UDF",
    "Universe",
    "analyze",
    "apply",
    "apply_async",
    "apply_with_type",
    "assert_table_has_schema",
    "attribute",
    "cast",
    "coalesce",
    "column_definition",
    "debug",
    "demo",
    "declare_type",
    "enable_interactive_mode",
    "expression_vm",
    "fill_error",
    "get_pathway_config",
    "global_error_log",
    "graphs",
    "groupby",
    "if_else",
    "indexing",
    "input_attribute",
    "input_method",
    "io",
    "is_interactive_mode_enabled",
    "iterate",
    "iterate_universe",
    "join",
    "join_inner",
    "join_left",
    "join_outer",
    "join_right",
    "left",
    "load_yaml",
    "local_error_log",
    "make_tuple",
    "method",
    "ml",
    "ordered",
    "output_attribute",
    "persistence",
    "reducers",
    "request_stop",
    "require",
    "right",
    "run",
    "run_all",
    "run_program",
    "run_program_plain",
    "schema_builder",
    "schema_from_dict",
    "schema_from_types",
    "sql",
    "stateful",
    "statistical",
    "stdlib",
    "temporal",
    "this",
    "transformer",
    "udf",
    "udf_async",
    "udfs",
    "universes",
    "unwrap",
    "utils",
    "viz",
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
    "topk_merge_shards",
    "topk_merge_shards_plain",
    "topk_scores",
    "topk_scores_plain",
]
