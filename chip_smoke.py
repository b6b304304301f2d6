"""Drive the PyTorch port's RAG ingest and retrieval path, its training step, its parallel paths, its
dataflow engine, its Table API, its indexing stdlib, its RAG serve path over HTTP, its file
connectors with the RAG example served from a directory, its persistence and recovery, its
elastic rescale and spill tier, its frontier-driven async plane with ``pw.iterate``, its
temporal stdlib on Nexmark's event model, its ML, SQL and graph stdlib, its SQLite, Delta
Lake and Debezium connectors, its RAG question answering with the last root names
(``pw.analyze``, ``pw.load_yaml``, the error log, ``LiveTable``), its observability plane
(the monitoring HTTP server, signals and SLO alerts, the profiler, key-load accounting, the flight
recorder, OTLP telemetry), its command line (record and replay, supervised recovery, ``top``,
``critpath``, ``profile``, ``lint``, ``trace merge``, ``rescale``), its training step on a (data,
model) mesh with the dry run of ``graft_entry``, and its multi-process cluster (``spawn -n 2``
over ``ClusterComm`` and ``MultiHostMeshComm``), on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order (phase 23 runs right after phase 8, on its world-1 group); any failure ends the
run with a non-zero exit code:

1. The card's name and power limit (``nvidia-smi``), then the build of every kernel of the path
   from ``pathway_tpu_torch/csrc`` (one ``nvcc`` per source, all started together), with ptxas's
   registers, shared memory and spills for each kernel by name (the attention's two routes, the
   backward's fused kernel and its two-kernel route, and the ring's two routes among them), and
   the build of the engine's native keyspace module (``pathway_tpu_torch/native``, the host C
   compiler), each with its time.
2. Each kernel against its plain PyTorch version on the card, at the shapes the main path gives
   it, with the tolerance stated beside each check; then its time (CUDA events) beside its bound,
   the plain version's time and one PyTorch library call's time. The attention on contiguous
   inputs and on the encoder's fused-qkv views, at S = 16 and 128 (the persistent route) and 512
   (the per-head route); timed at B=1024 S=128 on both layouts and with every key real, beside
   SDPA on the same inputs, with the persistent grid's CTAs per SM. The scorer at q=64, n=2^20,
   d=384 for k = 1, 10 (its stream route) and 100 (its tile route), each route logged; its plan
   held to one wave against the occupancy API at k=10 and at ``MAX_K``; and its device time
   (profiler) by pass beside the CUDA-event time a call.
3. The main path at full width: the default encoder (6 layers, 384 wide, 12 heads of 32, bf16,
   seeded init) embeds 16,384 chunks of a seeded corpus into ``BruteForceKnnEngine`` in ticks
   of 1024, seeded unit vectors fill the index to 1,048,576 rows, and 8 searches of 64 text
   queries (k=10) are answered, then one with a metadata filter, then one after removals. The
   kernels' launch counts are zeroed just before and read just after. The encoder's forward at
   an ingest tick's shape is timed, and its time outside attention set beside its bound.
4. The bert architecture at full width through ``load_hf_state_dict`` of a seeded HF-shaped
   state dict.
5. The training step (``models/pipeline.py::make_step``) at full width: the default encoder on
   B=256 pairs at S=128 (tokens of the seeded corpus; the second view as the reference augments
   it), an index of 1,048,576 x 384 f32 rows, 64 queries at S=32, k=10. First the attention
   backward against autograd of the plain attention at head widths 16, 32 and 64, the InfoNCE
   kernel against its plain version (B=256 on its cluster route, B=1000 on its one-block route),
   InfoNCE's device time (profiler) beside an empty kernel on the same cluster launch, and both
   kernels' times (the backward at B=256, H=12, S=128,
   D=32, its fused route, on inputs held against the plain version first, beside SDPA's backward
   and with its blocks a SM); then the gradient and one whole
   step on the kernel route against the plain route from the same parameters; then 2 warm-up and
   8 timed steps with the launch counts zeroed just before and read just after, one more step
   under the profiler, and the step on the plain route timed beside its bound.
6. Ring attention's block step (``ops/ring.py``) against its plain version: one call over
   B=1, S=4096, H=12, D=32 in bf16 (the tensor-core route), the same sequence folded as 4 blocks
   of 1024 in the order rank 0 of a 4-rank ring meets them, D=8 in f32 (the CUDA-core route) and
   in bf16, D=16 with blocks of 1000 keys (a partial key tile), D=64, and a fully masked first
   block; the
   top-k merge (``ops/knn.py::topk_merge`` on the concatenated rows and ``topk_merge_shards`` on
   the stacked lists) after the scorer over 4 slices of the 1,048,576-row index, against the
   scorer over the whole index (exact); then both kernels at the new paths' shapes (the block step
   at one layer of the long forward, B=4 x 8192 x 8192; the merge as the sharded search launches
   it at world size 1, m=10, and from synthetic buffers of 8 shards, m=80 and m=8192 at k=1024),
   each against its plain version on the same inputs and timed (the block step's error logged
   beside its time, its bound that of the tensor cores and the exponentials, the f32 route's
   bound beside it), the merge also by the profiler (the kernel's device time beside the time a
   call takes).
7. The long-context path (``models/ring_attention.py::embed_tokens_long``) on a
   ``torch.distributed`` group of world size 1 (NCCL): the default encoder on B=4 seeded
   documents of S=8192 tokens (16x the position table, so positions wrap) with padded tails of
   different lengths and one document all padding; 2 warm-up and 5 timed forwards with the launch
   counts zeroed just before and read just after, one more under the profiler; then B=1, S=2048
   against the plain route on the card.
8. The sharded index (``ShardedKnnIndex(mesh=...)``) on that group over 1,048,576 seeded unit
   rows of 384, added from the host 65,536 rows at a time (each add timed), then 8 searches of 64 queries
   at k=10 with the counts zeroed just before, against the unsharded index (exact). A search is
   4 launches: the scorer, two all-gathers, the merge reading their output.
9. The dataflow engine (``pathway_tpu_torch/engine``) on worker threads, as the JAX package's
   graph runner runs executors, over ``LocalComm`` and over ``MeshComm`` on the card (the record
   exchange's dense columns through the ``bucket_exchange`` kernel): the reference's streaming
   wordcount (500,000 rows, 997 words, commits of 10,000) at 1, 2 and 8 workers; a dense
   groupby-and-join (1,048,576 rows over 65,536 groups in 16 commits of 65,536, joined to a
   65,536-row dimension table) at 1 worker and at 8 with each comm; every multi-worker table equal
   to the 1-worker table exactly. The kernel (buckets, validity and per-bucket counts) against
   its plain version bitwise (n = 2, 4, 8, cap_in 8 to 65,536, w 4 to 16, rows without a
   destination, overflowing buckets, words with the high bit set, and the dense path's largest
   launch), timed there by CUDA events and the profiler; the driver's exchange ticks under the
   profiler, with each worker's readback of the rows that arrived and the device-to-host copies by
   destination (pageable or pinned). Then RAG through the engine: 16,384 corpus chunks in commits
   of 1024 embedded by a ``Rowwise`` into ``ExternalIndexNode`` over a 1,048,576-row
   ``BruteForceKnnEngine``, 64 text queries at k=10, 2 workers with mesh exchange, the replies
   against a direct search. Each path zeroes the launch counts just before and reads them after,
   and runs under the profiler, which sums the kernel's device time over the path.
10. The Table API down to ``pw.run()`` (``import pathway_tpu_torch as pw``): first the expression
   machine's kernel (``csrc/expression_vm.cu``) against its plain version on the card, bitwise
   (float ``**`` within 2 ulp), over 138 programs at 65,536 rows (every opcode at every operand
   type it takes, INT64_MIN/MAX with overflow, NaN, +-inf, -0.0, 1e300, a subnormal, shift
   counts from -3 to 70, negative exponents, casts) and a 3-member chain with two filters; then
   the phase's fused chain as one program at one commit's shape, timed (CUDA events, and the
   profiler for the kernel alone) beside its bound, an empty kernel on the same grid (the
   launch's own cost), its plain version, the upload and readback of its bytes and the numpy
   tier's host time. Then a
   streaming pipeline through ``pw.run(device="cuda")``: ``pw.io.python.read`` of a
   ``ConnectorSubject`` that ``next_batch``es 4,194,304 seeded rows in 64 commits of 65,536
   (``a`` int64, ``g`` int64 over 65,536 groups, ``x`` float64 multiples of 1/16 in [-64, 64)),
   ``select`` (a lifted ``pw.apply_with_type(lambda a: a * 3 + 7, ...)``, ``x * 2.0 - 1.0``),
   ``filter``, ``select`` with ``if_else`` and ``cast``, ``groupby(g).reduce(sum, count)``,
   ``pw.io.subscribe(on_batch=...)``; at 1 worker and at 2 with ``PATHWAY_MESH_EXCHANGE=1``,
   and again with the lambda written out, which makes the chain one program. Every final table
   equals a plain numpy computation exactly, and every launch count equals what the reference's
   gates give for the graph (``gated_launches``); every run is profiled for the kernel's summed
   device time, the 1-worker run also for its idle share.
11. The indexing stdlib through ``pw.run()``: ``pw.indexing.DataIndex`` over
   ``BruteForceKnnFactory(dimensions=384, reserved_space=2^20)`` with the default encoder as its
   embedder; its data table from a ``ConnectorSubject``: the RAG cell's 16,384 chunk texts in
   commits of 1024, then 1,032,192 seeded unit vectors in commits of 65,536 (1,048,576 rows);
   then 64 text queries at k=10 in a commit of their own through ``query_as_of_now`` with
   collapsed answers (each commit is its own tick); at 1 worker, and at 2 with
   ``PATHWAY_MESH_EXCHANGE=1`` over the first 262,144 of those rows. Every answer is held against
   ``BruteForceKnnEngine.search`` called directly on an engine filled with the same rows (scores
   within one bf16 ulp, ids equal where the scores are clear). The fill rate (until the run's
   engine holds every row), the query tick's host time (commit to the last answer's callback)
   and its idle share (a trace of the run's device activity, between two marker kernels launched
   at the commit and at the last answer) are logged. Then a ``HybridIndex`` of BM25 with the
   brute-force index (reciprocal-rank fusion) over the first 1,024 chunks (its fill embeds one
   chunk at a time, so it is the phase's longest run), the same queries, held
   against ``HybridEngine.search`` called directly on the run's engine (untraced). The launch
   counts are zeroed just before each run and read just after.
12. The RAG serve path over HTTP (``xpacks/llm``: ``DocumentStore``, ``DocumentStoreServer``;
   ``io/http``: ``rest_connector`` on ``aiohttp``), ``pw.run(device="cuda")`` on a thread of its
   own and the client on ``urllib``. (a) Seeded documents of the RAG cell's sentences,
   as plain text, HTML and Markdown in turn, from a ``ConnectorSubject`` in commits of 256,
   through ``ParseLocal``, ``TokenCountSplitter(max_tokens=256)`` (exactly 4,096 chunks) and
   the default encoder into ``BruteForceKnnFactory(dimensions=384)``: documents/s and chunks/s
   until ``/v1/statistics`` reads every document; 16 ``/v1/retrieve`` answers (k=10) held
   against the run's engine searched directly (scores within one bf16 ulp, texts equal where
   the scores are clear); ``/v1/inputs`` listing every path; a ``filepath_globpattern`` request
   whose answers all match it. (b) The north star, as the JAX package's bench measures its
   serve p50 (``bench.py``, ``_doc_server`` and ``_rest_rag_point``): 1,048,576 seeded unit
   vectors in commits of 100,000 into the store's pre-embedded mode
   (``BruteForceKnnFactory(reserved_space=2^20)``, ``TorchEmbedder(max_len=32)``), then 104
   requests of ``{"query": "dataflow shard topic {i % 13}", "k": 3}``, the first 4 untimed:
   p50, p95 and p99 (host clock), ``framework_ms`` (the p50 of 14 ``/v1/statistics``),
   ``embed_ms`` (one query's embed) and ``index_ms`` (the remainder); 8 answers held against the
   plain scorer over the fed vectors; the kernels' launches per request; one request traced
   between two marker kernels (its idle share and largest device events); the peak device
   memory; a filtered request timed apart. The launch counts are zeroed just before each leg
   and read just after.
13. The files (``io/fs.py``, ``io/columnar.py``, ``io/delivery.py``, the example). (a) The JAX
   package bench's ingest lanes (``bench.py``, ``_INGEST_CONNECTOR_PROG``): csv, jsonlines and
   plaintext files of 200,000 rows (``word = w{i % 997}``, ``x = i``) read by
   ``pw.io.fs.read(mode="streaming", autocommit_duration_ms=25)`` through
   ``pw.run(device="cuda")`` and counted by ``on_batch`` (held to 200,000), each with
   ``PATHWAY_INGEST_COLUMNAR`` 1 and 0: rows/s and the parse/hash/delta split of
   ``INGEST_CONNECTOR_STATS``; every arm's net table equal to the per-row one (ids, diffs,
   values). (b) Its file
   wordcount (``_WORDCOUNT_FILE_PROG``): 300,000 plaintext rows, ``groupby(data).reduce(count)``
   at 1 worker and at 2 with ``PATHWAY_MESH_EXCHANGE=1`` (``bucket_exchange`` on the card),
   every count held against ``collections.Counter``, and so is the last row per word of the
   counts written by ``pw.io.csv.write`` and read back. (c) The north star's example: phase 12's
   kind of documents, 16,384 chunks of them, written as files into a directory and served by the
   ported
   ``examples/rag_server/serve.py``'s ``build_server(..., device="cuda")``: documents/s and
   chunks/s until ``/v1/statistics`` reads every document, 104 requests of ``/v1/retrieve``
   (k=3, 4 untimed): p50, p95, p99 (host clock) and the launches per request (held to 6
   ``masked_attention`` and 1 ``knn_topk``); 8 answers against the run's engine searched
   directly; ``/v1/inputs`` as the reference answers for such a directory (every
   ``_metadata`` is ``{}``). The launch counts are zeroed just before each run and read just
   after.
14. Persistence and recovery (``pw.persistence``, ``pw.run(persistence_config=...)``). (a) Phase
   11's index as a persisted program: its 1,048,576 rows through a python source named ``rows``
   (each commit sent once the index holds the rows before it) into ``DataIndex`` over
   ``BruteForceKnnFactory(dimensions=384, reserved_space=2^20)``, at 1 worker, on the filesystem
   backend with a snapshot interval of a fifth of phase 11's fill time. The first leg runs in a
   child interpreter (``subprocess``, this script with ``--persist-leg``), SIGKILLed once its
   newest metadata covers 786,432 rows; each of its commits is logged with its barrier, snapshot
   and release ms and its bytes, and the store's bytes at the kill. The second leg restarts the
   same program in this process with the whole feed (the source's seek skips what the snapshot
   holds), then sends phase 11's 64 text queries through ``query_as_of_now`` (k=10); the
   answers are held against phase 11's direct search. Logged: ``restore_operators``'s seconds,
   the rows replayed from the input tail, the seconds from the second ``pw.run`` to the tick
   holding every row beside phase 11's fill time, and the first query tick (host, and on the
   device between two marker kernels, its copies apart). (b) Phase 13's 300,000 plaintext rows
   as 10 files in a directory, ``pw.io.fs.read(mode="streaming")``, ``groupby(data).reduce(count)``
   at 2 workers with ``PATHWAY_MESH_EXCHANGE=1``, persisted on the filesystem and written by
   ``pw.io.csv.write`` (transactional): a first leg over 5 files stopped by ``request_stop`` once
   it counted them, 5 more files, a second leg until every row is counted. The finals are held
   against ``collections.Counter``, and the csv rows of both legs, net of their diffs, against the
   clean counts, with no row written twice. The launch counts are zeroed just before (a) and (b)
   and read just after ((a)'s first leg launches in another process, so (a)'s counts are those
   after the restore); they must show ``knn_topk`` and ``masked_attention`` in (a) and
   ``bucket_exchange`` in (b). The stores are deleted at the end.
15. Elastic rescale and the spill tier (``pathway_tpu_torch.rescale``, ``PATHWAY_ELASTIC``,
   ``engine/spill.py``, the key registry's cold tier). (a) Phase 14's index store, handed over
   after its second leg (262,144 rows, 1 worker), mounted at 2 workers with
   ``PATHWAY_MESH_EXCHANGE=1`` and ``PATHWAY_ELASTIC=1``: worker 0's boot reshards it (the
   resharder's seconds by phase, the bytes it read and wrote, the store's bytes after its
   cleanup), the restore (its seconds, the rows replayed), then the 64 text queries (k=10) under
   a new source name, each answer held against phase 11's direct search; ``knn_topk`` and
   ``masked_attention`` must launch. (b) Phase 14 (b)'s 10 files and transactional
   ``pw.io.csv.write``: files 1-4 at 2 workers, 5-7 at 4 with the mesh exchange through the
   elastic boot, an offline ``rescale(backend, 1)``, 8-10 at 1; the csv holds every count once
   and nets to ``collections.Counter``; ``bucket_exchange`` must launch with 4 destinations. (c)
   ``dense_graph`` (columns unchanged) over 524,288 rows and 2^20 groups in commits of 65,536,
   in a child interpreter with ``PATHWAY_STATE_MEMORY_BUDGET_MB=32``,
   ``PATHWAY_KEY_REGISTRY_CAP=262144`` and a spill directory: at 1 worker, then at 4 with the
   mesh exchange over the first 262,144 rows at a sixteenth of the budget (each budget halved
   until the run's peak state a worker is 4x it); each table held against numpy, the spill
   counters must show bytes spilled and loads; beside it the same graph at 1 worker with no
   budget in this process: rows/s, the bytes spilled and loaded and shed by store, the child's
   peak RSS (sampled). The store and the spill directory are deleted at the end.
16. The frontier-driven async plane and ``pw.iterate``. Phases 1-15 run no sharded streaming
   graph over ``LocalComm`` (each sharded streaming run there uses the mesh exchange, which keeps
   the BSP loop unless ``PATHWAY_ASYNC_EXEC=1``, or is a batch run), so none of them changes
   loop; this phase runs the async loop and one ``PATHWAY_ASYNC_EXEC=0`` run beside each. (a)
   The reference's skew lane (``bench.py:1261-1470``): 150,000 fast rows in batches of 5,000 over
   64 words of worker 0's shard, 40 slow rows over 8 words of worker 1's, each through a blocking
   25 ms UDF, at 2 workers over ``LocalComm`` through ``pw.run(device="cuda")``, in a fresh
   process async and one with ``PATHWAY_ASYNC_EXEC=0`` (``--async-leg``): the fast shard's rows/s
   until its last output update, its drain and total seconds, worker 0's busy fraction from
   ``Executor._idle_park_ns`` and ``EngineStats``' Exchange node times, the async/BSP ratio;
   both arms' counts held against numpy's. (b) The reference's uniform A/B
   (``bench.py:2030-2085``): its wordcount, 500,000 rows in commits of 10,000 after a warm-up of
   100,000, the best of 2, at 1 worker, 2 async and 2 BSP, a fresh process each: rows/s and both
   efficiencies. (c) At 2 workers over ``LocalComm``, async: phase 9's RAG through
   ``ExternalIndexNode`` over realtime sources (16,384 chunks in commits of 1,024, embedded on both
   workers and gathered to the index on worker 0; 64 text queries, k=10, once the index holds
   every chunk), every answer held against a direct search; and phase 10's Table API chain over
   4,194,304 rows, its table against numpy's; each beside a BSP run of the same graph. The launch
   counts must show ``masked_attention`` and ``knn_topk``, and ``expression_vm``. (d) Phase 14
   (b)'s persisted file wordcount (300,000 rows in 10 files, transactional ``pw.io.csv.write``)
   at 2 workers async: 5 files, a stop, all 10 after a restart; then on a new store a child
   interpreter over 5 files, SIGKILLed once both workers finished a commit wave, 5 more files
   and a restart. Each time the csv holds each count once. Logged per leg: ``waves_total``, the
   wave duration's p50, ``WaveRecorder``'s stage split (sweep, inbox_dwell, frontier_wait,
   settle, snapshot, release) and the holders and critical stages of the merged wave documents.
   (e) ``pw.iterate``'s min-label propagation (connected components) over a seeded graph of
   16,384 nodes and 32,768 undirected edges at 1 worker, the labels held
   against ``scipy.sparse.csgraph.connected_components``; its rounds, seconds (within 120) and
   ``expression_vm`` launches.
17. Nexmark windows through ``pw.temporal`` (windows, the window, interval and as-of joins), each
   query a ``pw.run(device="cuda")`` over ``pw.io.python`` sources fed by a seeded numpy
   generator of the Nexmark benchmark's event model (``nexmark_events``: persons, auctions and
   bids as 1:3:46, 10,000 events per event-second in time order, hot auctions, bidders and
   sellers as the generator's ratios say; 1,000,000 events, 920,000 bids, in commits of 10,000
   events). (a) Q1 (``price * 0.908`` on the dense ``price`` column, an ``expression_vm``
   program once past the gate) and Q7 (the highest bid per 10 s ``tumbling`` window under
   ``exactly_once_behavior()``) at 1 worker, then at 2 (async, the default); ``expression_vm``
   must launch in both. (b) Q5: bids per auction over ``sliding(hop=2 s, duration=10 s)``, each
   window's maximum and its hot items. (c) Q8: persons who opened an auction in the same 10 s
   window (``window_join_inner``). (d) ``interval_join_inner`` of each auction with the bids
   within [0, 10 s] after it, and ``asof_join`` of each bid with its bidder's person record
   (backward). Every output is held against a plain numpy and Python computation on the same
   events; each leg's rows/s (its input rows over the wall of ``pw.run``, host clock), its
   window or match count, and the launch counts (zeroed just before each run, read just after)
   are logged. ``NEXMARK_LEG_EVENTS`` holds each leg's cut: (a) and (b) over the first
   500,000 events, (d) over the first 125,000.
18. The stdlib and SQL (``pw.ml``, ``pw.sql``, ``pw.graphs``), each leg a
   ``pw.run(device="cuda")`` checked against numpy on the same data. (a) kNN classification at
   MNIST's shape: 60,000 seeded training vectors of 784 around ten class centres and 10,000
   queries through ``pw.io.python`` (commits of 10,000, then of 1,000),
   ``knn_lsh_classifier_train(L=20, type="euclidean", d=784)``, ``knn_lsh_classify(k=3)`` and
   ``classifier_accuracy``; each label against the majority of the plain scorer's top 3 (a
   difference allowed only where the scorer's tolerance leaves the vote open), and the accuracy
   table against numpy's count; ``knn_topk`` must launch. Then ``knn_topk`` on the run's own
   index mirror (the tile route, l2sq) with the first commit of 1,000 queries, held against the
   plain scorer score by score (``check_topk_against_plain``). (b) Nexmark's Q0-Q3 and a grouped
   count and maximum per auction through ``pw.sql`` over the first ``SQL_EVENTS`` of phase
   17's events, at 1 worker and at 2 (async); ``expression_vm`` must launch. (c) Graph500's
   Kronecker graphs (A=0.57, B=C=0.19, edge factor 16, duplicates and self-loops kept):
   ``pagerank(steps=5)`` at scale 12 exactly equal to numpy's integer recurrence,
   ``bellman_ford`` at scale 10 (integer weights 1-255 as floats) equal to a numpy relaxation to
   the fixpoint, and one Louvain level at scale 12 whose ``exact_modularity`` equals numpy's
   modularity of the clustering it returned (within 1e-12 a cluster: the sums run in another
   order). Each leg logs its rows/s, seconds and the launch counts (zeroed just before each run,
   read just after).
19. The connectors over Nexmark, each leg a ``pw.run(device="cuda")`` at 1 worker over the bids of
   phase 17's first events (``CONNECTOR_LEG_EVENTS``: 250,000 for (a) and (b), 50,000 for (c)),
   into Nexmark Q1's conversion (``price * 0.908``) and a count and largest converted price per
   auction, each table held against numpy's over the same rows. (a) SQLite CDC: a writer thread
   fills a SQLite file (WAL) in transactions of 10,000 events' bids, then 10 that give 10% of the
   bids a new price and delete 5%, each after the tick that reflects the one before;
   ``pw.io.sqlite.read(mode="streaming")``; the database's final rows, the bids key by key and
   the aggregate against numpy's. (b) Delta Lake: its bids through ``pw.io.python`` into
   ``pw.io.deltalake.write`` (a version a transaction), then ``read(mode="streaming")`` while a
   writer appends 9 versions of (a)'s changes (retractions in the ``diff`` column) and a tenth
   that removes version 1's file. (c) Debezium: (a)'s change stream of its first bids as
   envelopes (``c``, ``u``, ``d``) in a jsonlines file through ``pw.io.debezium.read``. Each leg's
   rows/s (rows written, or read, over the wall from ``pw.run`` to the tick that reflects the last
   write; (c) over its run) and its ``expression_vm`` launches are logged; the kernel is held
   against its plain version bitwise on (a)'s own lowered program and batch, and must launch.
   One line names, for each gated connector, whether its client package is importable here.
20. RAG question answering over HTTP (``xpacks/llm``: ``question_answering``, ``rerankers``,
   ``vector_store``) and the last root names, at 1 worker, each run a ``pw.run(device="cuda")``.
   Phase 12's documents (4,096 chunks; one document in 512 planted so that its parse raises)
   into a ``DocumentStore`` (``TorchEmbedder``'s default encoder, ``BruteForceKnnFactory``),
   served in one run by ``QASummaryRestServer`` over ``BaseRAGQuestionAnswerer(search_topk=6)``
   and ``QARestServer`` over ``AdaptiveRAGQuestionAnswerer(n_starting_documents=2, factor=2,
   max_iterations=4)``, each chat a deterministic ``BaseChat`` of this script. (a) 64 questions
   through ``RAGClient.answer`` after 4 untimed: the chat answers with its context's paths in
   prompt order; each context against a direct ``knn_topk`` search of the store's engine (scores
   within one bf16 ulp, texts equal where the scores are clear); p50, p95, p99 and the launches
   per request; ``/v1/retrieve``, ``/v1/statistics``, ``/v2/list_documents`` and
   ``/v1/pw_ai_summary`` once each against the store's own answers. (b) The same 64 questions to
   the adaptive answerer, each with a sentinel chunk at a known rank (1 to 16) of its direct
   search: the answer and the chat-call count against the geometric rule; p50. (c)
   ``EncoderReranker`` and ``rerank_topk_filter(k=3)`` over the (question, context) pairs of
   (a)'s first 32 answers (192) through ``pw.run``: each score against the cosine from one batched ``embed_texts_device``
   call (``RERANK_ATOL``), pairs/s and launches per pair. (d) ``VectorStoreServer`` over the
   first 256 chunks, 16 ``VectorStoreClient.query`` (k=6) against its engine searched
   directly. (e) ``pw.analyze`` on (a)'s graph before its run, on the card and on the host (the
   same diagnostics; no launch); ``pw.global_error_log()`` in (a)'s run (a parse error and a
   flatten skip for each planted document); ``pw.load_yaml`` of (a)'s store and answerer, 8
   answers against (a)'s; a ``LiveTable`` of the store's statistics to ``/v1/statistics``'s
   count. ``masked_attention`` at B=1 and ``knn_topk`` at a question's shape, each on inputs the
   phase gave it, against their plain versions. The launch counts are zeroed just before each
   counted block (a run, or (a)'s fill with its warm-up and other routes, (a)'s timed answers,
   (b)'s) and read just after; the direct searches and the batched embed that the answers are
   held against run outside every block.
21. The observability plane (``observability/``, ``engine/http_server.py``, the tracer, OTLP
   telemetry). (a) Phase 10's chain (one program a chain) at 2 workers over ``LocalComm`` (the
   async loop) in three arms, alternated twice: bare (``PATHWAY_PROFILE=0``,
   ``PATHWAY_KEYLOAD=0``), default (nothing set), and observed (``pw.run(with_http_server=True,
   monitoring_level=MonitoringLevel.ALL)`` on a free port, a trace file, a flight ring, two SLO
   rules of which one must fire, and OTLP export to a collector on loopback, flushed each
   second). Each table equals numpy's and each arm's programs run equal its ``expression_vm``
   launches; each arm's rows/s and the default and observed overheads against bare. During an
   observed run a thread reads every endpoint every 0.5 s: every ``/metrics`` parses, every
   histogram is cumulative with its ``+Inf`` bucket equal to its count, both workers are named,
   and ``/healthz`` and ``/readyz`` answer 200 once every worker has swept a tick. At its end,
   before the server stops: the input rows on ``/metrics``, ``/snapshot``'s fusion and UDF
   sections against the run (the bare run's counters, the chains its executors lowered), the
   trace file's tick and node spans of both workers, the collector's trace and metrics posts,
   the flight ring's run and tick records of both workers, ``/alerts`` (the one rule fired),
   and ``/profile``'s operator tags against ``/attribution``'s ranking. ``expression_vm``
   against its plain version on the observed run's own program, bitwise. (b)
   ``DocumentStoreServer`` over phase 12's 4,096 chunks with the monitoring server on: 64 timed
   ``/v1/retrieve`` (k=3) after 4 untimed, their p50, p95 and p99 beside phase 12's p50; the
   serve plane's families on ``/metrics``, its admitted count moved by the requests sent; 6
   ``masked_attention`` and 1 ``knn_topk`` launches a request, both kernels against their plain
   versions on one request's own inputs.
22. The command line (``python -m pathway_tpu_torch.cli``), each program a fresh interpreter
   under it, each command that needs no program in this process through ``main([...])``; any
   nonzero exit code fails the run. (a) Phase 10's chain (one program a chain, written out) over a
   python subject of 32 commits of 16,384 rows, written to a temporary script: under ``spawn
   --record``, then under ``replay --mode speedrun``; both tables equal numpy's, the replay sees
   the 32 recorded timestamps, ``expression_vm`` launches in both and its program is held bitwise
   against the plain version on one of the run's batches; an unrecorded run of the same pipeline
   in this process beside them (rows/s of each ``pw.run``). (b) Phase 14's persisted index (the
   default encoder, seeded init, 1 worker) over 65,536 rows (4,096 chunks) under ``spawn
   --supervise`` with a flight directory and the monitoring server on: generation 0 SIGKILLs
   itself at the first commit that covers 3/4 of the rows; the supervisor harvests
   ``crash-0-0.json`` and relaunches generation 1 (``PATHWAY_RESTART_COUNT=1``, the reason naming
   the bundle), which restores, refills and answers 64 queries, held against the direct search in
   that child, with ``masked_attention`` and ``knn_topk`` held on one query's inputs; while it
   serves, ``top --frames 3 --no-clear``, ``critpath --json`` and ``profile --top 10`` read its
   monitoring server; the supervisor exits 0 after exactly one restart. The seconds from the kill
   to generation 1's answers, by part. (c) ``lint --device cuda`` of the port's RAG example exits
   0; ``trace merge`` of (a)'s record run's trace file parses; ``rescale --dry-run --to 2`` of
   (b)'s store reports. Each child's launch counts (from 0 in a fresh process) are read just
   after its ``pw.run``, before the comparisons.
23. The training step on a (data, model) mesh and the dry run, on phase 6-8's world-1 NCCL
   group. (a) ``make_step(..., mesh=data_model_mesh(1))`` at phase 5's inputs and weights (made
   anew from their seeds): one step against phase 5's one-device step from the same weights and
   index, the loss, every updated weight, the inserted rows and the search held to
   ``tests/test_torch_pipeline.py``'s tolerances with each max |diff| logged; the first launch of
   ``masked_attention``, its backward, InfoNCE, ``knn_topk`` and ``topk_merge`` in that step each
   held against its plain version on its own inputs; then 10 steps with the launches counted,
   the last 8 timed (CUDA events) beside phase 5's. (b) ``graft_entry.entry()``'s forward (unit
   rows) and ``dryrun_multichip(1)`` (the mesh step, ring attention over a ``seq`` mesh, the
   dataflow over ``LocalComm`` and ``MeshComm`` against one worker, and its recovery), its first
   attention, ring step and largest bucketing held against their plain versions, every kernel of
   its path launched.
24. The cluster: phase 10's chain, written out, over 1,048,576 rows in 64 commits of 16,384,
   under ``python -m pathway_tpu_torch.cli spawn -n 2 -t 2`` with both processes on the card, in
   two arms run at once on disjoint ports: (a) ``ClusterComm``'s host frames (the async loop);
   (b) ``PATHWAY_MESH_EXCHANGE=1``, ``MultiHostMeshComm`` (each process's leader buckets its
   workers' dense rows on the card for all four workers, the leaders swap them over gloo, as
   processes that share a card must). Each arm's table equal to numpy's; each process's
   ``expression_vm`` launches (and in (b) ``bucket_exchange``'s) with one launch of each held
   against the plain version on its inputs; logged: rows/s, each process's seconds from the
   launch to its ``pw.run``, bytes and frames sent.
25. Each engine-path kernel's launches and summed device time per path, one JSON line with each
   kernel's numbers, then the closing JSON line.

It needs one CUDA card and exits non-zero, printing no result, without one. It imports nothing
of JAX and nothing of the ``pathway_tpu`` package.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import json
import math
import os
import re
import signal
import statistics
import subprocess
import sys
import time

sys.modules["jax"] = None  # a JAX import anywhere below fails loudly
# tiktoken fetches its encodings over the network at first use; the run needs none, so the
# splitter counts whitespace tokens, as it does wherever the encoding cannot load
sys.modules["tiktoken"] = None

import numpy as np  # noqa: E402
import torch  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense, at the full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
F32_OPS_PER_S = 67e12  # outside the tensor cores
# exponentials (MUFU.EX2, one an expf): 16 a clock an SM (CUDA C++ Programming Guide, arithmetic
# instruction throughput, compute capability 9.0), 132 SMs at the 1,980 MHz boost clock
SFU_OPS_PER_S = 132 * 16 * 1.98e9

ATTN_ATOL, ATTN_RTOL = 1e-2, 2.0 ** -7  # bf16 output: 1e-2 plus one bf16 ulp of the value
EMB_ATOL, EMB_MIN_COS = 3e-2, 0.999  # unit vectors: card (kernel) against host (plain), bf16
# the training step, kernel route against plain route on the card: bf16 rounds at other places
# inside attention, so the loss within 1e-2 of max(1, |loss|), each parameter's gradient with a
# cosine of at least 0.999 and a difference of at most 5% of its norm, the inserted rows (unit
# vectors) within 1e-2
STEP_LOSS_RTOL, GRAD_MIN_COS, GRAD_MAX_REL, ROW_ATOL = 1e-2, 0.999, 0.05, 1e-2
INFONCE_RTOL = 1e-5  # f32 loss and gradient, the sums in another order
RING_TOL = 2e-5  # the ring step in f32: within 2e-5 + 2e-5 |value|, the sums in another order


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of one call, from CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profiled(label: str, fn) -> None:
    """Run ``fn`` once under the profiler; print its wall time, the device's busy time (the sum of
    kernel times: one stream, so they do not overlap) and the kernels that took most of it."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    log(f"{label} under the profiler: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
        f"(idle share {1 - busy_ms / wall_ms:.3f})")
    for e in top:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")


def bound(n_bytes: float, n_ops: float, ops_per_s: float = BF16_OPS_PER_S) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


# -- phase 2: kernels against their plain versions ---------------------------------------------


def attention_inputs(B: int, S: int, gen: torch.Generator, device, H: int = 12, D: int = 32,
                     fused: bool = False):
    """q, k, v [B, H, S, D] in bf16, contiguous or (``fused``) as the encoder passes them: views
    of one [B, S, 3 H D] product (``models/embedder.py::_block``), a row stride of 3 H D values;
    and a key mask of random lengths with one all-pad row."""
    if fused:
        qkv = torch.randn((B, S, 3 * H * D), generator=gen, device=device).to(torch.bfloat16)
        q, k, v = (t.view(B, S, H, D).transpose(1, 2) for t in qkv.split(H * D, dim=-1))
    else:
        q, k, v = (torch.randn((B, H, S, D), generator=gen, device=device).to(torch.bfloat16)
                   for _ in range(3))
    lengths = torch.randint(1, S + 1, (B,), generator=gen, device=device)
    lengths[0] = 0  # one all-pad row: uniform attention, never NaN
    mask = torch.arange(S, device=device)[None, :] < lengths[:, None]
    return q, k, v, mask


def check_attention(B: int, seqs: tuple[int, ...], device) -> float:
    """The kernel against its plain version at B x S, H=12, D=32, on contiguous inputs and on
    the encoder's fused-qkv views: S <= 128 takes the persistent route, a longer S the per-head
    one."""
    gen = torch.Generator(device=device).manual_seed(11)
    worst = 0.0
    for S, fused in ((S, fused) for S in seqs for fused in (False, True)):
        q, k, v, mask = attention_inputs(B, S, gen, device, fused=fused)
        label = f"B={B} S={S} {'fused-qkv views' if fused else 'contiguous'}"
        worst = max(worst, attention_error(label, q, k, v, mask))
    return worst


def attention_error(label: str, q, k, v, mask) -> float:
    """The kernel's output against its plain version's on the same inputs: max |kernel - plain|;
    it raises on a non-finite value or a miss of ATTN_ATOL + ATTN_RTOL |plain|."""
    from pathway_tpu_torch.ops.attention import masked_attention, masked_attention_plain

    got = masked_attention(q, k, v, mask).float()
    want = masked_attention_plain(q, k, v, mask).float()
    if q.device.type == "cuda":
        torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError(f"masked_attention {label}: non-finite output")
    err = (got - want).abs()
    if (err > ATTN_ATOL + ATTN_RTOL * want.abs()).any():
        raise AssertionError(f"masked_attention {label}: max |err| {err.max().item()} over atol "
                             f"{ATTN_ATOL} + rtol {ATTN_RTOL}")
    log(f"masked_attention {label}: max |kernel - plain| = {err.max().item():.3e} (atol "
        f"{ATTN_ATOL} + rtol {ATTN_RTOL})")
    return err.max().item()


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at the magnitude of x (8 significant bits)."""
    x = x.abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(x)) - 7)


def check_topk_against_plain(s_k, i_k, s_p, i_p, tol) -> int:
    """The kernel's (s_k, i_k) [q, k] against the plain version's (s_p, i_p) [q, k + 1]:
    scores agree within ``tol``, ids agree wherever a score is more than ``tol`` from its
    neighbours, and equal scores come lower id first. Returns the number of ties seen."""
    k = s_k.shape[1]
    if ((s_k - s_p[:, :k]).abs() > tol[:, :k]).any():
        raise AssertionError("knn_topk: scores differ from the plain version by more than the tolerance")
    gap_prev = torch.full_like(s_p[:, :k], math.inf)
    gap_prev[:, 1:] = s_p[:, : k - 1] - s_p[:, 1:k]
    gap_next = s_p[:, :k] - s_p[:, 1 : k + 1]
    clear = (gap_prev > tol[:, :k]) & (gap_next > tol[:, :k])
    if (clear & (i_k != i_p[:, :k])).any():
        raise AssertionError("knn_topk: ids differ from the plain version where scores are clear")
    ties = s_k[:, 1:] == s_k[:, :-1]
    if (ties & (i_k[:, 1:] <= i_k[:, :-1])).any():
        raise AssertionError("knn_topk: equal scores not in lower-id-first order")
    return int(ties.sum().item())


def topk_tolerance(s: torch.Tensor, queries, index, metric: str) -> torch.Tensor:
    """One bf16 ulp of the rounded dot product: of the score itself for cos/ip; for l2, whose
    score carries 2 * dot, two ulps of the largest possible dot, |q| * max |row|."""
    if metric in ("cos", "ip"):
        return bf16_ulp(s)
    dot_max = queries.float().norm(dim=1, keepdim=True) * index.float().norm(dim=1).max()
    return (2 * bf16_ulp(dot_max) + 1e-6 * s.abs()).expand_as(s)


def knn_inputs(Q: int, N: int, d: int, gen: torch.Generator, device):
    index = torch.randn((N, d), generator=gen, device=device)
    index /= index.norm(dim=1, keepdim=True)
    dup = torch.arange(0, min(N // 2, 4096), device=device)
    index[N // 2 + dup] = index[dup]  # duplicated rows force exact ties
    valid = torch.rand((N,), generator=gen, device=device) > 0.1
    valid[dup] = True
    valid[N // 2 + dup] = True
    pick = dup[torch.randint(0, len(dup), (Q,), generator=gen, device=device)]
    queries = index[pick] + 0.05 * torch.randn((Q, d), generator=gen, device=device)
    return queries.contiguous(), index, valid


def check_knn(Q: int, N: int, d: int, ks: tuple[int, ...], device) -> tuple[float, int]:
    from pathway_tpu_torch.ops.knn import topk_scores, topk_scores_plain

    from pathway_tpu_torch.ops.knn import plan

    gen = torch.Generator(device=device).manual_seed(12)
    queries, index, valid = knn_inputs(Q, N, d, gen, device)
    worst, ties = 0.0, 0
    sms = torch.cuda.get_device_properties(device).multi_processor_count \
        if device.type == "cuda" else 132
    for metric in ("cos", "ip", "l2"):
        for k in ks:
            s_k, i_k = topk_scores(queries, index, k, metric, valid=valid)
            s_p, i_p = topk_scores_plain(queries, index, k + 1, metric, valid=valid)
            if device.type == "cuda":
                torch.cuda.synchronize()
            tol = topk_tolerance(s_p, queries, index, metric)
            n_ties = check_topk_against_plain(s_k, i_k, s_p, i_p, tol)
            err = (s_k - s_p[:, :k]).abs().max().item()
            worst, ties = max(worst, err), ties + n_ties
            log(f"knn_topk q={Q} n={N} d={d} {metric} k={k} ({plan(Q, N, d, k, sms).route} route): "
                f"max |score err| = {err:.3e}, {n_ties} exact ties in order (tolerance one bf16 "
                f"ulp of the dot)")
    if ties == 0:
        raise AssertionError("knn_topk: the duplicated rows produced no tie to check")
    return worst, ties


def time_attention(device, B: int = 1024, H: int = 12, S: int = 128, D: int = 32) -> dict:
    """The forward kernel at an ingest tick's shape, on the encoder's fused-qkv views (``ms``) and
    on contiguous [B, H, S, D] inputs, with keys of random lengths (the timing mask) and with every
    key real (``ms_full_mask``: the forward timed below, and 94% of the ingest corpus's keys); SDPA
    on the same inputs each time. Every key tile is computed under either mask: the timing mask
    differs from the full one only in the masked keys' -1e30 and the pad's -inf. Each of the three
    input sets is first held against the plain version (``err``: each CTA walks about 46 tiles
    here, so the ring of stages is refilled). The bound is the same for all: the bytes of q, k, v,
    o and the mask."""
    import torch.nn.functional as F

    from pathway_tpu_torch.ops.attention import (
        masked_attention, masked_attention_plain, persistent_ctas_per_sm, shared_memory_bytes,
    )

    gen = torch.Generator(device=device).manual_seed(13)
    q, k, v, mask = attention_inputs(B, S, gen, device, fused=True)
    full = torch.ones_like(mask)
    qc, kc, vc = (t.contiguous() for t in (q, k, v))
    times = {"err": 0.0}
    for key, args in (("", (q, k, v, mask)), ("_contiguous", (qc, kc, vc, mask)),
                      ("_full_mask", (q, k, v, full))):
        label = f"B={B} H={H} S={S} D={D} " + {"": "fused-qkv views", "_contiguous": "contiguous",
                                                "_full_mask": "fused-qkv views, every key real"}[key]
        times["err"] = max(times["err"], attention_error(label, *args))
        sdpa_mask = args[3][:, None, None, :]
        times["ms" + key] = cuda_ms(lambda: masked_attention(*args), 20)
        times["library_ms" + key] = cuda_ms(
            lambda: F.scaled_dot_product_attention(*args[:3], attn_mask=sdpa_mask), 20)
    times["plain_ms"] = cuda_ms(lambda: masked_attention_plain(q, k, v, mask), 5)
    n_bytes = 4 * B * H * S * D * 2 + B * S
    times["bound_ms"], times["bound_by"] = bound(n_bytes, 4 * B * H * S * S * D)
    times["tb_per_s"] = n_bytes / (times["ms"] * 1e-3) / 1e12
    times["ctas_per_sm"] = persistent_ctas_per_sm(D, S)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    times["grid"] = min(B * H, times["ctas_per_sm"] * sms)
    times["shape"] = f"B={B} H={H} S={S} D={D}, fused-qkv views"
    real = mask.float().mean().item()
    log(f"masked_attention at B={B} H={H} S={S} D={D}: persistent grid of {times['grid']} CTAs "
        f"({times['ctas_per_sm']} a SM on {sms} SMs) over {B * H} (b, h) tiles; the timing mask "
        f"holds {real:.3f} real keys")
    log("  shared memory a block (dynamic), by route: " + ", ".join(
        f"D={d} persistent {shared_memory_bytes(d, S)} B, per-head at S=512 "
        f"{shared_memory_bytes(d, 512)} B" for d in (16, 32, 64)))
    for key, label in (("", "fused-qkv views"), ("_contiguous", "contiguous"),
                       ("_full_mask", "fused-qkv views, every key real")):
        ms = times["ms" + key]
        log(f"  {label}: {ms:.4f} ms ({n_bytes / (ms * 1e-3) / 1e12:.3f} TB/s, "
            f"{times['bound_ms'] / ms:.3f} of the bound), SDPA {times['library_ms' + key]:.4f} ms")
    del q, k, v, qc, kc, vc
    return times


def time_kernels(device) -> dict:
    """Times at the main path's shapes: attention at an ingest tick (B=1024, S=128), scoring at
    a search (q=64 against 2^20 rows of 384, k=10)."""
    from pathway_tpu_torch.ops.knn import topk_scores, topk_scores_plain

    gen = torch.Generator(device=device).manual_seed(13)
    attn = time_attention(device)

    Q, N, d, kk = 64, 1 << 20, 384, 10
    queries, index, valid = knn_inputs(Q, N, d, gen, device)
    knn = {
        "ms": cuda_ms(lambda: topk_scores(queries, index, kk, "cos", valid=valid), 10),
        "plain_ms": cuda_ms(lambda: topk_scores_plain(queries, index, kk, "cos", valid=valid), 3),
        "library_ms": cuda_ms(
            lambda: torch.topk(queries.to(torch.bfloat16) @ index.to(torch.bfloat16).T, kk), 3
        ),
    }
    knn["bound_ms"], knn["bound_by"] = bound(
        Q * d * 4 + N * d * 4 + N + Q * kk * (4 + 8), 2 * Q * N * d
    )
    knn["shape"] = f"q={Q} n={N} d={d} k={kk} cos"
    knn.update(knn_route_times(lambda: topk_scores(queries, index, kk, "cos", valid=valid),
                               Q, N, d, kk, device))
    # the bulk of the timing inputs is freed before the main path
    del queries, index, valid
    torch.cuda.empty_cache()
    return {"masked_attention": attn, "knn_topk": knn}


def knn_one_wave(Q: int, N: int, d: int, k: int, device) -> dict:
    """The plan of the scorer at this shape against the card: its layout is the source's
    (``knn_topk_smem_bytes``), and its blocks a SM are no more than the occupancy API gives with
    registers counted, so every block of a launch is resident at once. Raises otherwise."""
    import ctypes

    from pathway_tpu_torch import _kernels
    from pathway_tpu_torch.ops.knn import plan, shared_memory_bytes

    lib = _kernels.load("knn_topk")
    for name in ("knn_topk_smem_bytes", "knn_topk_blocks_per_sm"):
        getattr(lib, name).argtypes = [ctypes.c_int] * 4
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    p = plan(Q, N, d, k, sms)
    route = 1 if p.route == "stream" else 0
    smem = shared_memory_bytes(p.route, p.qc, d, k)
    resident = lib.knn_topk_blocks_per_sm(route, p.qc, d, k)
    chunks = -(-Q // p.qc)
    if lib.knn_topk_smem_bytes(route, p.qc, d, k) != smem or not (
            1 <= p.blocks_per_sm <= resident) or p.grid * chunks > resident * sms:
        raise AssertionError(f"knn_topk plan {p} at q={Q} n={N} d={d} k={k}: {smem} bytes of "
                             f"shared memory, {resident} blocks a SM resident: not one wave")
    log(f"knn_topk plan at q={Q} n={N} d={d} k={k}: {p.route} route, {p.grid * chunks} blocks "
        f"of {smem} bytes of shared memory, {p.blocks_per_sm} a SM by the plan and {resident} by "
        f"the occupancy API on {sms} SMs: one wave")
    return {"route": p.route, "blocks": p.grid * chunks, "blocks_per_sm": p.blocks_per_sm,
            "smem_bytes": smem}


def knn_route_times(call, Q: int, N: int, d: int, k: int, device) -> dict:
    """The scorer's route at this shape (one wave, checked) and the device time of each of its
    passes by the profiler, beside the CUDA-event time a call that ``time_kernels`` takes."""
    wave = knn_one_wave(Q, N, d, k, device)
    first = "knn_stream_kernel" if wave["route"] == "stream" else "knn_score_topk_kernel"
    second = "knn_stream_merge_kernel" if wave["route"] == "stream" else "knn_merge_kernel"
    passes = {"pass 1": device_ms(call, f"::{first}", iters=10),
              "pass 2": device_ms(call, f"::{second}", iters=10)}
    total = None if None in passes.values() else sum(passes.values())
    log(f"knn_topk {wave['route']} route on the device (profiler): pass 1 "
        f"{fmt_ms(passes['pass 1'])} ({first}), pass 2 {fmt_ms(passes['pass 2'])} ({second})")
    return {**wave, "device_ms": total, "device_ms_by_pass": passes}


# -- phase 3: the main path ---------------------------------------------------------------------


@functools.cache
def make_corpus(n_chunks: int, max_tokens: int, seed: int):
    """Seeded documents of sentences over a synthetic vocabulary, split until ``n_chunks``
    chunks exist. Returns [(chunk text, topic)]."""
    from pathway_tpu_torch.xpacks.llm.splitters import TokenCountSplitter

    rng = np.random.default_rng(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    vocab = ["".join(rng.choice(letters, size=int(n))) for n in rng.integers(3, 10, 4000)]
    zipf = 1.0 / np.arange(1, len(vocab) + 1)
    zipf /= zipf.sum()
    splitter = TokenCountSplitter(max_tokens=max_tokens)
    chunks: list[tuple[str, str]] = []
    doc = 0
    while len(chunks) < n_chunks:
        sentences = []
        for _ in range(int(rng.integers(20, 80))):
            words = rng.choice(len(vocab), size=int(rng.integers(6, 30)), p=zipf)
            sentences.append(" ".join(vocab[w] for w in words) + ".")
        topic = f"t{doc % 8}"
        chunks.extend((text, topic) for text, _ in splitter.__wrapped__(" ".join(sentences)))
        doc += 1
    return chunks[:n_chunks]


def run_main_path(device, *, n_chunks: int, n_rows: int, tick: int, n_queries: int,
                  n_searches: int, k: int, cfg=None, sample: int = 64) -> dict:
    from pathway_tpu_torch.models.embedder import Embedder
    from pathway_tpu_torch.ops.attention import masked_attention
    from pathway_tpu_torch.ops.index_engines import BruteForceKnnEngine
    from pathway_tpu_torch.ops.knn import topk_scores, topk_scores_plain

    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    emb = Embedder(cfg, seed=0, device=device)
    engine = BruteForceKnnEngine(
        emb.cfg.dim, reserved_space=n_rows, embedder=emb, device=device
    )
    t0 = time.perf_counter()
    corpus = make_corpus(n_chunks, 256, seed=1)
    log(f"corpus: {len(corpus)} chunks in {time.perf_counter() - t0:.1f} s")
    texts = [c for c, _ in corpus]
    emb.embed_texts(texts[:8])  # first use: kernel libraries load, cuBLAS warms up
    sync()

    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0

    t0 = time.perf_counter()
    for start in range(0, n_chunks, tick):
        part = corpus[start : start + tick]
        engine.add_batch(
            list(range(start, start + len(part))), [c for c, _ in part],
            [{"topic": topic} for _, topic in part],
        )
    sync()
    ingest_s = time.perf_counter() - t0
    ingest_attention = masked_attention.launches
    if device.type == "cuda":  # the first tick again (same keys and texts: no growth)
        first = corpus[:tick]
        profiled("ingest tick", lambda: engine.add_batch(
            list(range(len(first))), [c for c, _ in first], [{"topic": t} for _, t in first]))

    rng = np.random.default_rng(2)
    for start in range(n_chunks, n_rows, 65536):
        n = min(65536, n_rows - start)
        vecs = rng.standard_normal((n, emb.cfg.dim), dtype=np.float32)
        engine.add_batch(list(range(start, start + n)), vecs, [None] * n)

    query_sets = [
        [texts[i].split(".")[0] for i in rng.integers(0, n_chunks, n_queries)]
        for _ in range(n_searches + 1)
    ]
    engine.search(query_sets[0], [k] * n_queries, [None] * n_queries)  # syncs the mirror
    sync()
    search_ms = []
    answers = None
    for qs in query_sets[1:]:
        t0 = time.perf_counter()
        answers = engine.search(qs, [k] * n_queries, [None] * n_queries)
        search_ms.append((time.perf_counter() - t0) * 1e3)
    search_topk = topk_scores.launches
    if device.type == "cuda":
        profiled("search", lambda: engine.search(query_sets[1], [k] * n_queries,
                                                 [None] * n_queries))

    flt = "topic == 't3'"
    filtered = engine.search(query_sets[1][:2], [k, k], [flt, flt])
    for row in filtered:
        if not row or any(engine._slots.meta.get(engine._slots.key_to_slot[key]) != {"topic": "t3"}
                          for key, _ in row):
            raise AssertionError("filtered search returned a row outside the filter")

    gone = [key for key, _ in answers[0][:5]]
    for key in gone:
        engine.remove(key)
    after = engine.search(query_sets[-1], [k] * n_queries, [None] * n_queries)
    if any(key in gone for row in after for key, _ in row):
        raise AssertionError("a removed key came back from search")
    counts = {name: fn.launches for name, fn in counters.items()}
    log(f"launches on the main path: {counts} (attention {ingest_attention} during ingest, "
        f"knn_topk {search_topk} over the first {n_searches + 1} unfiltered searches)")
    for name in ("masked_attention", "knn_topk"):
        if counts[name] == 0 and device.type == "cuda":
            raise AssertionError(f"{name} was not launched on the main path")

    # answers against the plain scorer on the same device tensors
    q = emb.embed_texts_device(query_sets[-1])
    s_k, i_k = topk_scores(q, engine._mirror, k, engine.metric, valid=engine._mirror_valid)
    s_p, i_p = topk_scores_plain(q, engine._mirror, k + 1, engine.metric,
                                 valid=engine._mirror_valid)
    check_topk_against_plain(s_k, i_k, s_p, i_p, topk_tolerance(s_p, q, engine._mirror, "cos"))
    for row, ids in zip(after, i_k.cpu().numpy()):
        keys = [engine._slots.slot_to_key.get(int(i)) for i in ids]
        if [key for key, _ in row] != keys[: len(row)]:
            raise AssertionError("engine.search disagrees with the kernel on the same tensors")

    # embeddings on the card against the plain path on the host, same params
    sample_texts = texts[:sample]
    got = torch.from_numpy(emb.embed_texts(sample_texts))
    host = Embedder(emb.cfg, params=emb.params, device="cpu")
    want = torch.from_numpy(host.embed_texts(sample_texts))
    err = (got - want).abs().max().item()
    cos = (got * want).sum(1).min().item()
    log(f"embeddings card vs host: max |err| {err:.3e} (atol {EMB_ATOL}), min cosine {cos:.6f} "
        f"(at least {EMB_MIN_COS})")
    if not (err <= EMB_ATOL and cos >= EMB_MIN_COS):
        raise AssertionError("embeddings on the card disagree with the host's")

    # forward-only embed rate at an ingest tick's shape
    toks = np.zeros((tick, 128), np.int32)
    toks[:] = rng.integers(2, emb.cfg.vocab_size, size=(tick, 128))
    fwd_ms = cuda_ms(lambda: emb._forward(toks), 5) if device.type == "cuda" else float("nan")
    return {
        "ingest_docs_per_s": n_chunks / ingest_s,
        "fwd_ms": fwd_ms,
        "embed_tokens_per_s": tick * 128 / (fwd_ms / 1e3),
        "search_p50_ms": statistics.median(search_ms),
        "search_ms": search_ms,
        "launches": counts,
        "index_rows": engine._slots.high,
    }


def encoder_outside_attention(fwd_ms: float, attn_ms: float, B: int = 1024, S: int = 128,
                              dim: int = 384, layers: int = 6, vocab: int = 30528) -> dict:
    """The default encoder's forward at B x S less its attention launches, beside the bound of
    what it does there: the bf16 matmuls (qkv, proj and the MLP, 12 dim^2 weights a layer), and
    the token gather, the activations each layer reads and writes (about 20 bf16 passes of
    [B, S, dim], the MLP's four times wider) and the weights."""
    tokens = B * S
    ops = 2 * tokens * 12 * dim * dim * layers
    n_bytes = tokens * (8 + dim * 2) + layers * (20 * tokens * dim * 2 + 12 * dim * dim * 4) \
        + vocab * dim * 4
    bound_ms, bound_by = bound(n_bytes, ops)
    return {"ms": fwd_ms - layers * attn_ms, "bound_ms": bound_ms, "bound_by": bound_by}


# -- phase 4: bert arch -------------------------------------------------------------------------


def hf_state_dict(vocab: int, dim: int, layers: int, inter: int, max_pos: int, seed: int) -> dict:
    """A BertModel-shaped state dict of seeded numbers (BERT's N(0, 0.02) init)."""
    gen = torch.Generator().manual_seed(seed)

    def w(*shape):
        return torch.randn(shape, generator=gen) * 0.02

    def ln(prefix, sd):
        sd[prefix + ".weight"] = 1 + 0.1 * torch.randn((dim,), generator=gen)
        sd[prefix + ".bias"] = 0.1 * torch.randn((dim,), generator=gen)

    sd = {
        "embeddings.word_embeddings.weight": w(vocab, dim),
        "embeddings.position_embeddings.weight": w(max_pos, dim),
        "embeddings.token_type_embeddings.weight": w(2, dim),
    }
    ln("embeddings.LayerNorm", sd)
    for i in range(layers):
        p = f"encoder.layer.{i}."
        for name, (o, n) in {
            "attention.self.query": (dim, dim), "attention.self.key": (dim, dim),
            "attention.self.value": (dim, dim), "attention.output.dense": (dim, dim),
            "intermediate.dense": (inter, dim), "output.dense": (dim, inter),
        }.items():
            sd[p + name + ".weight"] = w(o, n)
            sd[p + name + ".bias"] = w(o)
        ln(p + "attention.output.LayerNorm", sd)
        ln(p + "output.LayerNorm", sd)
    return sd


def run_bert(device, *, vocab: int, dim: int, layers: int, heads: int, inter: int,
             max_pos: int, batch: int, seq: int) -> float:
    from pathway_tpu_torch.models.embedder import Embedder
    from pathway_tpu_torch.ops.attention import masked_attention

    sd = hf_state_dict(vocab, dim, layers, inter, max_pos, seed=5)
    emb = Embedder.from_pretrained(sd, n_heads=heads, device=device)
    host = Embedder.from_pretrained(sd, n_heads=heads, device="cpu")
    rng = np.random.default_rng(6)
    ids = rng.integers(1, vocab, size=(batch, seq)).astype(np.int32)
    lengths = rng.integers(1, seq + 1, size=batch)
    ids[np.arange(seq)[None, :] >= lengths[:, None]] = 0
    before = masked_attention.launches
    got = torch.from_numpy(emb(ids))
    if device.type == "cuda" and masked_attention.launches == before:
        raise AssertionError("bert arch: masked_attention was not launched")
    want = torch.from_numpy(host(ids))
    err = (got - want).abs().max().item()
    cos = (got * want).sum(1).min().item()
    log(f"bert arch {layers}L x {dim} x {heads} heads, B={batch} S={seq}: card vs host max |err| "
        f"{err:.3e} (atol {EMB_ATOL}), min cosine {cos:.6f} (at least {EMB_MIN_COS})")
    if not torch.isfinite(got).all() or got.shape != (batch, dim):
        raise AssertionError("bert arch: output not finite or of the wrong shape")
    if not (err <= EMB_ATOL and cos >= EMB_MIN_COS):
        raise AssertionError("bert arch: card disagrees with host")
    return err


# -- phase 5: the training step ----------------------------------------------------------------


def check_attention_backward(shapes, device) -> float:
    """The gradient through ``masked_attention`` (the forward kernel with its statistic, then the
    backward kernel) against autograd of the plain version, at each (B, H, S, D) of ``shapes``,
    with an all-pad row and ragged masks. The gradients of rows with real keys must not be zero:
    the kernel route stays in the autograd graph."""
    from pathway_tpu_torch.ops.attention import masked_attention, masked_attention_bwd_plain

    gen = torch.Generator(device=device).manual_seed(14)
    worst = 0.0
    for B, H, S, D in shapes:
        q, k, v, mask = attention_inputs(B, S, gen, device, H=H, D=D)
        dout = torch.randn(q.shape, generator=gen, device=device).to(torch.bfloat16)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = masked_attention(*leaves, mask)
        got = torch.autograd.grad(out, leaves, dout)
        want = masked_attention_bwd_plain(q, k, v, dout, mask)
        if device.type == "cuda":
            torch.cuda.synchronize()
        for name, g, w in zip("qkv", got, want):
            g, w = g.float(), w.float()
            if not torch.isfinite(g).all():
                raise AssertionError(f"attention backward d{name} D={D}: non-finite")
            if g[1:].abs().max().item() == 0:
                raise AssertionError(f"attention backward d{name} D={D}: zero gradient")
            err = (g - w).abs()
            if (err > ATTN_ATOL + ATTN_RTOL * w.abs()).any():
                raise AssertionError(
                    f"attention backward d{name} B={B} H={H} S={S} D={D}: max |err| "
                    f"{err.max().item()} over atol {ATTN_ATOL} + rtol {ATTN_RTOL}"
                )
            worst = max(worst, err.max().item())
        log(f"masked_attention_bwd B={B} H={H} S={S} D={D}: max |kernel - plain| over dq, dk, "
            f"dv = {max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want)):.3e}"
            f" (atol {ATTN_ATOL} + rtol {ATTN_RTOL}), all non-zero")
    return worst


def infonce_inputs(B: int, gen: torch.Generator, device) -> torch.Tensor:
    """Logits of the step's shape and scale: two noisy views of B unit vectors, over 0.07."""
    ea = torch.nn.functional.normalize(torch.randn((B, 384), generator=gen, device=device), dim=1)
    eb = torch.nn.functional.normalize(
        ea + 0.5 * torch.randn((B, 384), generator=gen, device=device), dim=1)
    return (ea @ eb.T) / 0.07


def check_infonce(sizes, device) -> float:
    from pathway_tpu_torch.ops.infonce import infonce, infonce_plain

    gen = torch.Generator(device=device).manual_seed(15)
    worst = 0.0
    for B in sizes:
        logits = infonce_inputs(B, gen, device).requires_grad_()
        loss = infonce(logits)
        (grad,) = torch.autograd.grad(loss, logits)
        want = infonce_plain(logits)
        (want_grad,) = torch.autograd.grad(want, logits)
        l_err = abs(loss.item() - want.item())
        g_err = (grad - want_grad).abs()
        if l_err > INFONCE_RTOL * max(1.0, abs(want.item())) or (
                g_err > INFONCE_RTOL * (1.0 / B + want_grad.abs())).any():
            raise AssertionError(f"infonce B={B}: loss err {l_err}, grad err {g_err.max().item()}")
        worst = max(worst, l_err, g_err.max().item())
        log(f"infonce B={B}: loss {loss.item():.6f}, |kernel - plain| loss {l_err:.3e}, gradient "
            f"{g_err.max().item():.3e} (rtol {INFONCE_RTOL})")
    return worst


def time_training_kernels(device) -> dict:
    """Times at the training step's shapes: the attention backward at B=256, H=12, S=128, D=32
    (one layer of one view), first held against its plain version on the same inputs within
    ``ATTN_ATOL``/``ATTN_RTOL``; InfoNCE at B=256."""
    import torch.nn.functional as F

    from pathway_tpu_torch.ops import attention
    from pathway_tpu_torch.ops.infonce import CLUSTER_MAX_B, infonce, infonce_empty, infonce_plain

    gen = torch.Generator(device=device).manual_seed(16)
    B, H, S, D = 256, 12, 128, 32
    q, k, v, mask = attention_inputs(B, S, gen, device, H=H, D=D)
    dout = torch.randn(q.shape, generator=gen, device=device).to(torch.bfloat16)
    _, stat = attention._forward(q, k, v, mask, with_stat=True)
    # the timed inputs, held against the plain version first (the fused route, S = 128)
    got = attention.masked_attention_bwd(q, k, v, dout, mask, stat)
    want = attention.masked_attention_bwd_plain(q, k, v, dout, mask)
    torch.cuda.synchronize()
    bwd_err = 0.0
    for name, g, w in zip("qkv", got, want):
        err = (g.float() - w.float()).abs()
        if not torch.isfinite(g.float()).all() or (
                err > ATTN_ATOL + ATTN_RTOL * w.float().abs()).any():
            raise AssertionError(f"masked_attention_bwd d{name} at the timed inputs: max |err| "
                                 f"{err.max().item()} over atol {ATTN_ATOL} + rtol {ATTN_RTOL}")
        bwd_err = max(bwd_err, err.max().item())
    del got, want
    log(f"masked_attention_bwd B={B} H={H} S={S} D={D}, the timed inputs: max |kernel - plain| "
        f"over dq, dk, dv = {bwd_err:.3e} (atol {ATTN_ATOL} + rtol {ATTN_RTOL}); "
        f"{attention.backward_blocks_per_sm(D, S)} blocks a SM of "
        f"{attention.backward_shared_memory_bytes(D, S)} bytes of shared memory")
    sdpa = [t.clone().requires_grad_() for t in (q, k, v)]
    sdpa_out = F.scaled_dot_product_attention(*sdpa, attn_mask=mask[:, None, None, :])
    bwd = {
        "ms": cuda_ms(lambda: attention.masked_attention_bwd(q, k, v, dout, mask, stat), 20),
        "plain_ms": cuda_ms(
            lambda: attention.masked_attention_bwd_plain(q, k, v, dout, mask), 5),
        "library_ms": cuda_ms(
            lambda: torch.autograd.grad(sdpa_out, sdpa, dout, retain_graph=True), 20),
    }
    bwd["bound_ms"], bwd["bound_by"] = bound(
        7 * B * H * S * D * 2 + B * H * S * 8 + B * S, 10 * B * H * S * S * D)
    bwd["shape"] = f"B={B} H={H} S={S} D={D}"
    bwd["err"] = bwd_err
    bwd["ctas_per_sm"] = attention.backward_blocks_per_sm(D, S)

    n = 256
    logits = infonce_inputs(n, gen, device)
    live = logits.clone().requires_grad_()
    labels = torch.arange(n, device=device)
    route = "cluster" if n <= CLUSTER_MAX_B else "block"
    kernel = "::infonce_cluster_kernel" if route == "cluster" else "::infonce_kernel"
    nce = {
        "route": route,
        "device_ms": device_ms(lambda: infonce(logits), kernel),
        "empty_ms": cuda_ms(lambda: infonce_empty(n, device), 50),
        "empty_device_ms": device_ms(lambda: infonce_empty(n, device), "infonce_empty_kernel"),
        "ms": cuda_ms(lambda: infonce(logits), 50),
        "plain_ms": cuda_ms(lambda: torch.autograd.grad(infonce_plain(live), live), 20),
        "library_ms": cuda_ms(lambda: torch.autograd.grad(
            F.cross_entropy(live, labels) + F.cross_entropy(live.T, labels), live), 20),
    }
    # per logit: max, subtract, exp, add for the row and again for the column; subtract, exp,
    # subtract twice, add and multiply for the gradient
    nce["bound_ms"], nce["bound_by"] = bound(2 * n * n * 4 + 4, 15 * n * n, F32_OPS_PER_S)
    nce["shape"] = f"B={n}"
    return {"masked_attention_bwd": bwd, "infonce": nce}


@contextlib.contextmanager
def plain_route():
    """The training step with every kernel swapped for its plain version where the step's modules
    call it: the route this script holds the kernels' route against (the package has no switch
    for it)."""
    from pathway_tpu_torch.models import embedder, pipeline
    from pathway_tpu_torch.ops.attention import masked_attention_plain
    from pathway_tpu_torch.ops.infonce import infonce_plain
    from pathway_tpu_torch.ops.knn import topk_scores_plain

    saved = embedder.masked_attention, pipeline.infonce, pipeline.topk_scores
    embedder.masked_attention = masked_attention_plain
    pipeline.infonce = infonce_plain
    pipeline.topk_scores = topk_scores_plain
    try:
        yield
    finally:
        embedder.masked_attention, pipeline.infonce, pipeline.topk_scores = saved


def compare_grads(label: str, got: dict, want: dict) -> tuple[float, float]:
    """Each gradient leaf of ``got`` against ``want``: non-zero, cosine and relative error within
    the stated bounds. Returns the worst cosine and relative error."""
    from pathway_tpu_torch.models.pipeline import _leaves

    worst_cos, worst_rel = 1.0, 0.0
    for i, (g, w) in enumerate(zip(_leaves(got), _leaves(want))):
        g, w = g.float(), w.float()
        nw = w.norm().item()
        if g.abs().max().item() == 0 or nw == 0:
            raise AssertionError(f"{label}: gradient leaf {i} {tuple(g.shape)} is zero")
        cos = ((g * w).sum() / (g.norm() * w.norm())).item()
        rel = ((g - w).norm() / nw).item()
        if cos < GRAD_MIN_COS or rel > GRAD_MAX_REL:
            raise AssertionError(f"{label}: gradient leaf {i} {tuple(g.shape)} cosine {cos}, "
                                 f"relative error {rel}")
        worst_cos, worst_rel = min(worst_cos, cos), max(worst_rel, rel)
    return worst_cos, worst_rel


def training_inputs(device, *, cfg=None, batch: int = 256, seq: int = 128, n_rows: int = 1 << 20,
                    n_queries: int = 64, q_seq: int = 32):
    """The training phase's inputs, made from their seeds: (cfg, tokens, tokens_aug, queries,
    params, index)."""
    from pathway_tpu_torch.models.embedder import EmbedderConfig, init_params, tokenize_batch

    cfg = cfg or EmbedderConfig()
    texts = [c for c, _ in make_corpus(batch + n_queries, 256, seed=3)]
    tokens = torch.from_numpy(tokenize_batch(texts[:batch], cfg.vocab_size, seq)).to(device)
    # pipeline.py:110's augmentation, as it is: every id divisible by 7 becomes 1, pad ids too
    tokens_aug = torch.where(tokens % 7 == 0, 1, tokens)
    queries = torch.from_numpy(tokenize_batch(
        [t.split(".")[0] for t in texts[batch:]], cfg.vocab_size, q_seq)).to(device)
    params = init_params(cfg, 0, device=device)
    gen = torch.Generator(device=device).manual_seed(17)
    index = torch.randn((n_rows, cfg.dim), generator=gen, device=device)
    index /= index.norm(dim=1, keepdim=True)
    return cfg, tokens, tokens_aug, queries, params, index


def run_training(device, *, cfg=None, batch: int = 256, seq: int = 128, n_rows: int = 1 << 20,
                 n_queries: int = 64, q_seq: int = 32, k: int = 10, warmup: int = 2,
                 steps: int = 8) -> dict:
    from pathway_tpu_torch.models import pipeline
    from pathway_tpu_torch.models.embedder import embed_tokens
    from pathway_tpu_torch.ops.knn import topk_scores, topk_scores_plain

    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cfg, tokens, tokens_aug, queries, params, index = training_inputs(
        device, cfg=cfg, batch=batch, seq=seq, n_rows=n_rows, n_queries=n_queries, q_seq=q_seq)
    real = int((tokens > 0).sum().item())
    log(f"training inputs: {batch} pairs at S={seq} ({real} real tokens in the first view), "
        f"{n_queries} queries at S={q_seq}, index {n_rows} x {cfg.dim} f32, k={k}")

    # the gradient, kernel route against plain route, from the same parameters
    loss_k, ea_k, grads_k = pipeline.value_and_grad(params, tokens, tokens_aug, cfg)
    with plain_route():
        loss_p, ea_p, grads_p = pipeline.value_and_grad(params, tokens, tokens_aug, cfg)
    sync()
    loss_err = abs(loss_k.item() - loss_p.item())
    if not math.isfinite(loss_k.item()) or loss_err > STEP_LOSS_RTOL * max(1.0, abs(loss_p.item())):
        raise AssertionError(f"training loss: kernel {loss_k.item()} against plain {loss_p.item()}")
    cos, rel = compare_grads("value_and_grad", grads_k, grads_p)
    qkv = [layer["qkv"].abs().max().item() for layer in grads_k["layers"]]
    log(f"value_and_grad: loss kernel {loss_k.item():.6f}, plain {loss_p.item():.6f}; "
        f"{len(list(pipeline._leaves(grads_k)))} gradients, worst cosine {cos:.6f}, worst relative "
        f"error {rel:.3e}; max |d qkv| per layer {[f'{x:.2e}' for x in qkv]} (non-zero)")

    # one whole step on each route, from the same parameters and index; the plain route's search
    # keeps k + 1, so that the gap below the k-th score is known
    step = pipeline.make_step(cfg, k=k, device=device)
    insert_at = n_rows - batch // 2  # clamped to n_rows - batch, as dynamic_update_slice does
    idx_k, idx_p = index.clone(), index.clone()
    new_k, _, sl_k, s_k, i_k = step(params, tokens, tokens_aug, idx_k, insert_at, queries)
    with plain_route():
        _, _, sl_p, s_p, i_p = pipeline.make_step(cfg, k=k + 1, device=device)(
            params, tokens, tokens_aug, idx_p, insert_at, queries)
    sync()
    if abs(sl_k.item() - sl_p.item()) > STEP_LOSS_RTOL * max(1.0, abs(sl_p.item())):
        raise AssertionError(f"step loss: kernel {sl_k.item()} against plain {sl_p.item()}")
    rows_k, rows_p = idx_k[n_rows - batch:], idx_p[n_rows - batch:]
    row_err = (rows_k - rows_p).abs().max().item()
    if row_err > ROW_ATOL or not torch.equal(idx_k[: n_rows - batch], index[: n_rows - batch]):
        raise AssertionError(f"step: inserted rows differ by {row_err} or landed elsewhere")
    if (rows_k - ea_k).abs().max().item() > 1e-5:  # the same forward again
        raise AssertionError("step: the inserted rows are not the loss pass's embeddings")
    for new, old in zip(pipeline._leaves(new_k), pipeline._leaves(params)):
        if not torch.isfinite(new).all() or torch.equal(new, old):
            raise AssertionError(f"step: a parameter {tuple(old.shape)} is not finite or not moved")
    # the routes' queries differ by the attention's rounding in the updated weights
    check_topk_against_plain(s_k, i_k, s_p, i_p, bf16_ulp(s_p) + ROW_ATOL)
    with torch.no_grad():  # the kernel's search against the plain scorer on the same tensors
        qe = embed_tokens(new_k, queries, cfg)
        s_kk, i_kk = topk_scores(qe, idx_k, k)
        s_pp, i_pp = topk_scores_plain(qe, idx_k, k + 1)
    check_topk_against_plain(s_kk, i_kk, s_pp, i_pp, topk_tolerance(s_pp, qe, idx_k, "cos"))
    if not (torch.equal(s_kk, s_k) and torch.equal(i_kk, i_k)):
        raise AssertionError("step: its search is not the scorer's on the same tensors")
    hits = int((i_k >= n_rows - batch).sum().item())
    log(f"step: loss kernel {sl_k.item():.6f} plain {sl_p.item():.6f}; {batch} rows written at "
        f"{n_rows - batch} (insert_at {insert_at}, clamped), max |kernel - plain| {row_err:.3e}; "
        f"search scores within one bf16 ulp + {ROW_ATOL}; {hits} of {n_queries * k} hits are new "
        f"rows")
    del idx_k, idx_p, new_k, grads_k, grads_p
    if cuda:
        torch.cuda.empty_cache()

    # the main path of this phase: a short training run, counts zeroed just before
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    p = params
    losses = []

    def one(i):
        nonlocal p
        p, _, loss, _, _ = step(p, tokens, tokens_aug, index, i * batch, queries)
        losses.append(loss)

    for i in range(warmup):
        one(i)
    sync()
    t0 = time.perf_counter()
    if cuda:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
    for i in range(warmup, warmup + steps):
        one(i)
    if cuda:
        end.record()
    sync()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    step_ms = start.elapsed_time(end) / steps if cuda else float("nan")
    counts = {name: fn.launches for name, fn in counters.items()}
    n_steps = warmup + steps
    log(f"launches over {n_steps} training steps: {counts} "
        f"(per step {({n: c / n_steps for n, c in counts.items()})})")
    for name in ("masked_attention", "masked_attention_bwd", "infonce", "knn_topk"):
        if counts[name] == 0 and cuda:
            raise AssertionError(f"{name} was not launched on the training path")
    trend = [round(x.item(), 6) for x in losses]
    if not all(math.isfinite(x) for x in trend):
        raise AssertionError(f"training loss not finite: {trend}")
    log(f"training losses over {n_steps} steps: {trend}")
    if cuda:
        profiled("training step", lambda: one(warmup + steps))
        with plain_route():  # the same step with every kernel's plain version, timed the same way
            plain_step = pipeline.make_step(cfg, k=k, device=device)
            plain_ms = cuda_ms(lambda: plain_step(p, tokens, tokens_aug, index, 0, queries), 3,
                               warmup=1)
    else:
        plain_ms = float("nan")
    # the bound: the forward's matmuls and attention products over both views and the queries,
    # twice that again for the backward of the two views, and the search's dots
    per_token = 2 * (12 * cfg.dim * cfg.dim + 2 * seq * cfg.dim) * cfg.n_layers
    step_ops = 3 * 2 * batch * seq * per_token + n_queries * q_seq * per_token \
        + 2 * n_queries * n_rows * cfg.dim
    step_bound = bound(n_rows * cfg.dim * 4 + batch * cfg.dim * 4, step_ops)
    return {
        "step_ms": step_ms, "wall_ms": wall_ms, "plain_ms": plain_ms,
        "bound_ms": step_bound[0], "bound_by": step_bound[1],
        "tokens_per_s": 2 * batch * seq / (step_ms / 1e3) if cuda else float("nan"),
        "launches": counts, "loss_err": loss_err, "row_err": row_err,
    }


# -- phases 6-8: ring attention and the sharded search --------------------------------------


def ring_inputs(B: int, H: int, S: int, D: int, dtype, gen: torch.Generator, device,
                masked_first: bool = False):
    """q, k, v ``[B, H, S, D]`` and a key mask with ragged padded tails; with ``masked_first``,
    row 0 has no real key and row 1 none in the first quarter."""
    q, k, v = (torch.randn((B, H, S, D), generator=gen, device=device).to(dtype)
               for _ in range(3))
    lengths = torch.randint(S // 2, S + 1, (B,), generator=gen, device=device)
    mask = torch.arange(S, device=device)[None, :] < lengths[:, None]
    if masked_first:
        mask[0] = False
        mask[1, : S // 4] = False
    return q, k, v, mask


def ring_fold(step_fn, q, k, v, mask, order):
    """The block step folded over the key blocks in ``order``; the normalised f32 output."""
    from pathway_tpu_torch.ops.ring import init_state

    o, m, l = init_state(q)
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    blk = q.shape[2] // len(order)
    for step, j in enumerate(order):
        part = slice(j * blk, (j + 1) * blk)
        step_fn(q, k[:, :, part], v[:, :, part], mask[:, part], o, m, l, q.shape[-1] ** -0.5,
                out=out if step == len(order) - 1 else None)
    return out


def ring_close(label: str, got: torch.Tensor, want: torch.Tensor) -> float:
    err = (got - want).abs()
    if not torch.isfinite(got).all() or (err > RING_TOL + RING_TOL * want.abs()).any():
        raise AssertionError(f"{label}: max |err| {err.max().item()} over {RING_TOL} + "
                             f"{RING_TOL} |value|")
    log(f"{label}: max |err| = {err.max().item():.3e} (within {RING_TOL} + {RING_TOL} |value|)")
    return err.max().item()


RING_CASES = (  # (B, H, S, D, dtype, a fully masked first block)
    (1, 12, 4096, 32, torch.bfloat16, False),
    (2, 4, 1024, 8, torch.float32, True),
    (2, 6, 1024, 64, torch.bfloat16, True),
    (2, 4, 4000, 16, torch.bfloat16, True),  # blocks of 1000 keys: a partial tile of 64
    (2, 4, 1024, 8, torch.bfloat16, False),
)


def check_ring_block(device, cases=RING_CASES) -> float:
    """The ring's block step against its plain version; the same sequence as one block and as
    four, in the order rank 0 of a 4-rank ring meets them (blocks 0, 3, 2, 1)."""
    from pathway_tpu_torch.ops.ring import ring_block_attention, ring_block_attention_plain

    gen = torch.Generator(device=device).manual_seed(18)
    worst = 0.0
    rank0 = (0, 3, 2, 1)
    for B, H, S, D, dtype, masked_first in cases:
        q, k, v, mask = ring_inputs(B, H, S, D, dtype, gen, device, masked_first)
        name = f"ring_block_attention B={B} H={H} S={S} D={D} {str(dtype)[6:]}"
        one = ring_fold(ring_block_attention, q, k, v, mask, (0,))
        four = ring_fold(ring_block_attention, q, k, v, mask, rank0)
        for label, got, order in ((f"{name}, one block", one, (0,)),
                                  (f"{name}, 4 blocks in rank 0's order", four, rank0)):
            want = ring_fold(ring_block_attention_plain, q, k, v, mask, order)
            worst = max(worst, ring_close(label + ", kernel vs plain", got, want))
        ring_close(f"{name}, 4 blocks vs one call (kernel)", four, one)
        if masked_first:
            log(f"  (row 0 all padding, row 1's first block fully masked)")
        del q, k, v, mask, one, four
    return worst


def check_sharded_merge(device, Q: int = 64, N: int = 1 << 20, d: int = 384,
                        ks: tuple[int, ...] = (1, 10, 100), shards: int = 4) -> float:
    """The scorer over ``shards`` slices of the index, ids shifted to global rows, candidates
    gathered shard-major and merged, against the scorer over the whole index: equal exactly.
    Returns the largest score difference seen (0)."""
    from pathway_tpu_torch.ops.knn import topk_merge, topk_merge_shards, topk_scores

    gen = torch.Generator(device=device).manual_seed(12)
    queries, index, valid = knn_inputs(Q, N, d, gen, device)
    rows = N // shards
    worst = 0.0
    for metric in ("cos", "l2"):
        for k in ks:
            parts = [topk_scores(queries, index[r * rows : (r + 1) * rows], k, metric,
                                 valid=valid[r * rows : (r + 1) * rows]) for r in range(shards)]
            all_s = torch.cat([s for s, _ in parts], dim=1)
            all_i = torch.cat([i + r * rows for r, (_, i) in enumerate(parts)], dim=1)
            s_m, i_m = topk_merge(all_s, all_i, k)
            # the shard-major entry on the lists as an all-gather stacks them, local ids
            s_g, i_g = topk_merge_shards(torch.stack([s for s, _ in parts]),
                                         torch.stack([i for _, i in parts]), k, rows)
            s_w, i_w = topk_scores(queries, index, k, metric, valid=valid)
            for entry, (s_x, i_x) in (("topk_merge", (s_m, i_m)),
                                      ("topk_merge_shards", (s_g, i_g))):
                if not (torch.equal(s_x, s_w) and torch.equal(i_x, i_w)):
                    bad = (i_x != i_w).sum().item()
                    raise AssertionError(f"{entry} over {shards} slices, {metric} k={k}: {bad} "
                                         f"ids differ from the unsharded scorer")
            n_ties = int((s_w[:, 1:] == s_w[:, :-1]).sum().item())
            worst = max(worst, (s_m - s_w).abs().max().item())
            log(f"topk_merge and topk_merge_shards of {shards} slices of {N} x {d}, q={Q} {metric} "
                f"k={k}: equal to the unsharded scorer exactly ({n_ties} exact ties in order)")
    del queries, index, valid
    return worst


def time_parallel_kernels(device, B: int = 4, S: int = 8192, H: int = 12, D: int = 32,
                          Q: int = 64, k: int = 10) -> dict:
    """Both kernels at the new paths' shapes: the block step at the long-context forward's (one
    layer: B=4, 8192 queries against 8192 keys at world size 1, q/k/v laid out as the layer gives
    them, ragged key lengths), the merge at a sharded search's (``time_merge``: 64 queries at
    world size 1 and at 8 shards). Each is first held against its plain version on the same
    inputs (the block step from a fresh state, within ``RING_TOL``; the merge exactly), then
    timed."""
    import torch.nn.functional as F

    from pathway_tpu_torch.ops.ring import (
        init_state, ring_block_attention, ring_block_attention_plain,
    )

    gen = torch.Generator(device=device).manual_seed(20)
    qkv = torch.randn((B, S, 3 * H * D), generator=gen, device=device).to(torch.bfloat16)
    q, k_, v = (t.view(B, S, H, D) for t in qkv.split(H * D, dim=-1))
    qh, kh, vh = q.transpose(1, 2), k_.contiguous().transpose(1, 2), v.contiguous().transpose(1, 2)
    lengths = torch.tensor([S, S - 1000, S // 2 + 123, 1], device=device)[:B]
    mask = (torch.arange(S, device=device)[None, :] < lengths[:, None]).to(torch.uint8)
    scale = D ** -0.5
    shape = f"B={B} H={H} s=s_blk={S} D={D} bf16"
    outs = []  # the kernel and its plain version on exactly these inputs, each from a fresh state
    for fn in (ring_block_attention, ring_block_attention_plain):
        o, m, l = init_state(qh)
        out = torch.empty((B, H, S, D), dtype=torch.float32, device=device)
        fn(qh, kh, vh, mask, o, m, l, scale, out=out)
        outs.append(out)
    torch.cuda.synchronize()
    ring = {"err": ring_close(f"ring_block_attention at {shape}, lengths {lengths.tolist()}, "
                              f"kernel vs plain", *outs), "shape": shape}
    del outs
    ring["ms"] = cuda_ms(lambda: ring_block_attention(qh, kh, vh, mask, o, m, l, scale, out=out), 5)
    ring["plain_ms"] = cuda_ms(
        lambda: ring_block_attention_plain(qh, kh, vh, mask, o, m, l, scale, out=out), 2, warmup=1)
    qf, kf, vf = (t.float().contiguous() for t in (qh, kh, vh))
    bool_mask = mask.bool()[:, None, None, :]
    ring["library_ms"] = cuda_ms(
        lambda: F.scaled_dot_product_attention(qf, kf, vf, attn_mask=bool_mask), 5)
    # the bf16 route: 1 + 3 bf16 products on the tensor cores, one exponential a score; the
    # bound is the larger of those two times and the bytes. Beside it, the f32 route's bound:
    # its 4 B H s s_blk D f32 operations on the CUDA cores
    n_bytes = 3 * B * H * S * D * 2 + B * S + 2 * B * H * S * (D + 2) * 4 + B * H * S * D * 4
    ring["bound_ms"], ring["bound_by"] = bound(n_bytes, 8 * B * H * S * S * D)
    exp_ms = B * H * S * S / SFU_OPS_PER_S * 1e3
    if exp_ms > ring["bound_ms"]:
        ring["bound_ms"], ring["bound_by"] = exp_ms, "operations"
    ring["bound_ms_exponentials"] = exp_ms
    ring["bound_ms_f32_cores"], _ = bound(n_bytes, 4 * B * H * S * S * D, F32_OPS_PER_S)
    del qkv, q, k_, v, qh, kh, vh, o, m, l, out, qf, kf, vf
    torch.cuda.empty_cache()

    merge = time_merge(device, gen, Q, k)
    return {"ring_attention": ring, "topk_merge": merge}


def merge_case(P: int, Q: int, kk: int, gen: torch.Generator, device):
    """Candidates as the sharded search's all-gather lands them: [P, q, kk] scores, each shard's
    list best-first, from a few values (ties in every row, -0 beside +0) with -inf tails, and
    each shard's local ids."""
    values = torch.tensor([0.5, 0.25, 0.0, -0.0, -0.25], device=device)
    scores = values[torch.randint(0, len(values), (P, Q, kk), generator=gen, device=device)]
    scores[torch.rand((P, Q, kk), generator=gen, device=device) < 0.1] = -math.inf
    scores = scores.sort(dim=2, descending=True).values
    ids = torch.randint(0, 1 << 17, (P, Q, kk), generator=gen, device=device)
    return scores, ids


def fmt_ms(ms: float | None) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def profile_step(fn):
    """The profiler's record of one call of ``fn`` (synchronised), after a warm-up call in the same
    session: the tracer misses the first launches of a session, so the warm-up takes them."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    warm_then_record = torch.profiler.schedule(wait=0, warmup=1, active=1)
    with torch.profiler.profile(activities=acts, schedule=warm_then_record) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()  # the warm-up ends; the next call is recorded until the session closes
        fn()
        torch.cuda.synchronize()
    return prof


def device_ms(fn, name: str, iters: int = 50, sessions: int = 3,
              per_call: int = 1) -> float | None:
    """The device time of one call of ``fn`` in the kernels whose names hold ``name`` (``per_call``
    of them a call), from the profiler over ``iters`` calls: the kernels alone, without the host's
    wrapper and launch. The tracer sometimes records nothing of a session; after ``sessions`` such
    sessions the time is not measured (None). It is a measurement, not a check: the run goes
    on."""
    def calls():
        for _ in range(iters):
            fn()

    for _ in range(sessions):
        events = [e for e in profile_step(calls).key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA and name in e.key]
        count = sum(e.count for e in events)
        if count:
            if count != iters * per_call:
                log(f"  (the profiler recorded {count} of {iters * per_call} launches of {name}; "
                    f"the mean is theirs)")
            return sum(e.self_device_time_total for e in events) / (count / per_call) / 1e3
    log(f"  (the profiler recorded no launch of {name} in {sessions} sessions: not measured)")
    return None


MERGE_CASES = (  # (P, kk, k): the sharded search at world size 1, at 8 shards, at the limit
    (1, 10, 10), (8, 10, 10), (8, 1024, 1024))


def time_merge(device, gen: torch.Generator, Q: int = 64, k: int = 10) -> dict:
    """The merge as the sharded search launches it (``topk_merge_shards`` on the all-gather's
    [P, q, kk] buffers) at world size 1 (m=10), and from synthetic buffers of 8 shards on the one
    card (m=80, and m=8192 at k=1024): each exactly against its plain version (``topk_merge_plain``
    on the reshaped buffers), then timed by CUDA events over 50 back-to-back calls (what a caller
    waits, the host's wrapper and launch included) and by the profiler (the kernel alone), beside
    the plain version, ``torch.topk`` on the reshaped scores, and the bound (the bytes)."""
    from pathway_tpu_torch.ops.knn import topk_merge_shards, topk_merge_shards_plain

    cases = []
    for P, kk, kq in MERGE_CASES:
        scores, ids = merge_case(P, Q, kk, gen, device)
        got = topk_merge_shards(scores, ids, kq, 1 << 17)
        want = topk_merge_shards_plain(scores, ids, kq, 1 << 17)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"topk_merge_shards at P={P} q={Q} kk={kk} k={kq}: differs from "
                                 "its plain version")
        flat = scores.transpose(0, 1).reshape(Q, P * kk)
        case = {
            "shape": f"P={P} q={Q} m={P * kk} k={kq}", "err": 0.0,  # equal, -inf included
            "ms": cuda_ms(lambda: topk_merge_shards(scores, ids, kq, 1 << 17), 50),
            "device_ms": device_ms(lambda: topk_merge_shards(scores, ids, kq, 1 << 17),
                                   "topk_merge"),
            "plain_ms": cuda_ms(lambda: topk_merge_shards_plain(scores, ids, kq, 1 << 17), 50),
            "library_ms": cuda_ms(lambda: torch.topk(flat, kq, dim=1), 50),
        }
        case["bound_ms"], case["bound_by"] = bound(P * Q * kk * (4 + 8) + Q * kq * (4 + 8),
                                                   Q * P * kk)
        log(f"topk_merge_shards at {case['shape']} (ties, -0 and -inf in every row): equal to its "
            f"plain version; {case['ms']:.4f} ms a call (CUDA events), {fmt_ms(case['device_ms'])} "
            f"on the device (profiler), plain {case['plain_ms']:.4f} ms, torch.topk "
            f"{case['library_ms']:.4f} ms, bound {case['bound_ms']:.7f} ms ({case['bound_by']})")
        cases.append(case)
    return {**cases[0], "err": max(c["err"] for c in cases), "cases": cases}


@contextlib.contextmanager
def plain_ring():
    """The long-context forward with the block step swapped for its plain version."""
    from pathway_tpu_torch.models import ring_attention
    from pathway_tpu_torch.ops.ring import ring_block_attention_plain

    saved = ring_attention.ring_block_attention
    ring_attention.ring_block_attention = ring_block_attention_plain
    try:
        yield
    finally:
        ring_attention.ring_block_attention = saved


def long_documents(B: int, S: int, vocab: int, seed: int) -> np.ndarray:
    """Seeded token ids ``[B, S]``: padded tails of different lengths, the last document all
    padding."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(2, vocab, size=(B, S)).astype(np.int64)
    lengths = [S, S - S // 8, S // 2 + S // 64, 0][:B] if B <= 4 else rng.integers(0, S + 1, B)
    for b, n in enumerate(lengths):
        tokens[b, int(n):] = 0
    return tokens


def run_long_context(device, *, cfg=None, batch: int = 4, seq: int = 8192, warmup: int = 2,
                     iters: int = 5, check_seq: int = 2048) -> dict:
    from pathway_tpu_torch.models.embedder import EmbedderConfig, init_params
    from pathway_tpu_torch.models.ring_attention import embed_tokens_long
    from pathway_tpu_torch.parallel.distributed import global_mesh

    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cfg = cfg or EmbedderConfig()
    mesh = global_mesh({"data": 1}, device=device.type)
    params = init_params(cfg, 0, device=device)
    tokens = torch.from_numpy(long_documents(batch, seq, cfg.vocab_size, seed=21)).to(device)
    real = int((tokens > 0).sum().item())
    log(f"long context: {batch} documents of S={seq} ({seq / cfg.max_len:g}x max_len, "
        f"{real} real tokens, the last all padding) on a {mesh.size()}-rank "
        f"{torch.distributed.get_backend()} group")

    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    with torch.no_grad():
        for _ in range(warmup):
            emb = embed_tokens_long(params, tokens, cfg, mesh)
        sync()
        t0 = time.perf_counter()
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        for _ in range(iters):
            emb = embed_tokens_long(params, tokens, cfg, mesh)
        if cuda:
            end.record()
        sync()
    wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    fwd_ms = start.elapsed_time(end) / iters if cuda else float("nan")
    counts = {name: fn.launches for name, fn in counters.items()}
    n_fwd = warmup + iters
    log(f"launches over {n_fwd} long-context forwards: {counts} "
        f"(per forward {counts['ring_attention'] / n_fwd:g}, {cfg.n_layers} layers)")
    if cuda and counts["ring_attention"] != n_fwd * cfg.n_layers:
        raise AssertionError("ring_block_attention was not launched once per layer")
    norms = emb.norm(dim=1)
    if emb.shape != (batch, cfg.dim) or not torch.isfinite(emb).all() or \
            (norms[:-1] - 1).abs().max().item() > 1e-4 or norms[-1].item() != 0:
        raise AssertionError(f"long context: embeddings of shape {tuple(emb.shape)}, norms "
                             f"{norms.tolist()} (unit, and 0 for the all-pad document)")
    if cuda:
        with torch.no_grad():
            profiled("long-context forward", lambda: embed_tokens_long(params, tokens, cfg, mesh))

    # the kernel route against the plain route on the same device, B=1
    one = tokens[:1, :check_seq].clone()
    one[0, check_seq - check_seq // 8 :] = 0
    with torch.no_grad():
        got = embed_tokens_long(params, one, cfg, mesh)
        with plain_ring():
            want = embed_tokens_long(params, one, cfg, mesh)
    err = (got - want).abs().max().item()
    cos = (got * want).sum(1).min().item()
    log(f"long context B=1 S={check_seq}: kernel route vs plain route max |err| {err:.3e} "
        f"(atol {EMB_ATOL}), cosine {cos:.6f} (at least {EMB_MIN_COS})")
    if not (err <= EMB_ATOL and cos >= EMB_MIN_COS):
        raise AssertionError("long context: the kernel route disagrees with the plain route")
    return {"fwd_ms": fwd_ms, "wall_ms": wall_ms, "launches": counts,
            "tokens_per_s": batch * seq / (fwd_ms / 1e3) if cuda else float("nan"),
            "real_tokens": real, "err": err}


def run_sharded_search(device, *, n_rows: int = 1 << 20, dim: int = 384, n_queries: int = 64,
                       k: int = 10, searches: int = 8) -> dict:
    from pathway_tpu_torch.ops.knn import ShardedKnnIndex
    from pathway_tpu_torch.parallel.distributed import global_mesh

    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    mesh = global_mesh({"data": 1}, device=device.type)
    sharded = ShardedKnnIndex(dim, capacity=n_rows, mesh=mesh, device=device)
    single = ShardedKnnIndex(dim, capacity=n_rows, device=device)
    rng = np.random.default_rng(22)
    add_ms = []
    for start in range(0, n_rows, 65536):
        rows = rng.standard_normal((min(65536, n_rows - start), dim), dtype=np.float32)
        rows /= np.linalg.norm(rows, axis=1, keepdims=True)
        sync()
        t0 = time.perf_counter()
        sharded.add(rows)
        sync()
        add_ms.append((time.perf_counter() - t0) * 1e3)
        single.add(rows)
    picks = rng.integers(0, n_rows, n_queries)
    queries = single._data[torch.from_numpy(picks).to(device)].cpu().numpy()
    queries = queries + 0.05 * rng.standard_normal(queries.shape, dtype=np.float32)
    sharded.query(queries, k)  # first use

    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    search_ms = []
    for _ in range(searches):
        t0 = time.perf_counter()
        s, i = sharded.query(queries, k)
        search_ms.append((time.perf_counter() - t0) * 1e3)
    counts = {name: fn.launches for name, fn in counters.items()}
    log(f"launches over {searches} sharded searches: {counts}")
    if device.type == "cuda" and min(counts["knn_topk"], counts["topk_merge"]) == 0:
        raise AssertionError(f"a kernel was not launched on the sharded path: {counts}")
    if device.type == "cuda":  # what one search runs on the card, copies apart
        prof = profile_step(lambda: sharded.query(queries, k))
        names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                 and not e.name.lower().startswith(("memcpy", "memset", "profilerstep"))]
        log(f"one sharded search launches {len(names)} kernels: {[n[:60] for n in names]}")
    s1, i1 = single.query(queries, k)
    if not (np.array_equal(s, s1) and np.array_equal(i, i1)):
        raise AssertionError("the sharded index disagrees with the unsharded one")
    hits = int((i[:, 0] == picks).sum())
    log(f"sharded search over {n_rows} x {dim}, {n_queries} queries, k={k}, {mesh.size()} shard: "
        f"equal to the unsharded index; {hits} of {n_queries} queries find their source row first")
    # an add of the mesh index on the host API: 65536 rows of f32 from host memory into this
    # rank's rows and valid column; its bound is the bytes it writes at the device memory's rate
    # (the copy crosses PCIe)
    add_bound = bound(65536 * dim * 4 + 65536, 0)
    return {"search_p50_ms": statistics.median(search_ms), "search_ms": search_ms,
            "launches": counts, "add_ms": statistics.median(add_ms), "add_bound_ms": add_bound[0]}


# -- phase 9: the dataflow engine with its record exchange on the card --------------------------

#: the kernel wrappers whose launch counts each engine path reads
def launch_counters() -> dict:
    from pathway_tpu_torch.ops.attention import masked_attention, masked_attention_bwd
    from pathway_tpu_torch.ops.infonce import infonce
    from pathway_tpu_torch.ops.knn import topk_merge, topk_scores
    from pathway_tpu_torch.ops.ring import ring_block_attention
    from pathway_tpu_torch.ops.expression_kernel import expression_vm
    from pathway_tpu_torch.parallel.exchange import bucket_exchange

    return {"masked_attention": masked_attention, "masked_attention_bwd": masked_attention_bwd,
            "knn_topk": topk_scores, "infonce": infonce, "ring_attention": ring_block_attention,
            "topk_merge": topk_merge, "bucket_exchange": bucket_exchange,
            "expression_vm": expression_vm}


@contextlib.contextmanager
def counted(path: str, into: dict):
    """Zero every wrapper's launch count, run the block, read the counts into ``into[path]``."""
    wrappers = launch_counters()
    for fn in wrappers.values():
        fn.launches = 0
    yield
    into[path] = {name: fn.launches for name, fn in wrappers.items()}


def run_workers(build, n_workers: int, mesh: bool, device) -> tuple[object, float, dict]:
    """Build ``build(worker)``'s graph once per worker and run the executors on ``n_workers``
    threads, as the JAX package's graph runner runs them: over ``LocalComm``, or with
    ``mesh=True`` over ``MeshComm`` on ``device``; one executor without a comm at 1 worker.
    Returns (worker 0's Capture, seconds from the threads' start to the last join, the comm's
    counters)."""
    import threading

    from pathway_tpu_torch.engine.executor import Executor
    from pathway_tpu_torch.parallel.comm import LocalComm, WorkerContext
    from pathway_tpu_torch.parallel.meshcomm import MeshComm

    comm = None
    if n_workers > 1:
        comm = LocalComm(n_workers)
        if mesh:
            comm = MeshComm(comm, device=device)
    graphs = [build(w) for w in range(n_workers)]
    executors = [Executor(nodes, ctx=None if comm is None else WorkerContext(w, n_workers, comm))
                 for w, (nodes, _) in enumerate(graphs)]
    errors: list[BaseException] = []

    def work(ex):
        try:
            ex.run()
        except BaseException as e:  # noqa: BLE001 — raised below, after every worker stopped
            errors.append(e)
            if comm is not None:
                comm.abort()

    threads = [threading.Thread(target=work, args=(ex,), daemon=True) for ex in executors]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    seconds = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        raise AssertionError("an engine worker did not finish within 600 s")
    if errors:
        raise errors[0]
    stats = comm.comm_stats() if comm is not None else {}
    if comm is not None:
        comm.close()
    return graphs[0][1], seconds, stats


def table(cap) -> collections.Counter:
    """A Capture's consolidated table as a multiset of (row key, row)."""
    return collections.Counter((int(k), tuple(v.item() if isinstance(v, np.generic) else v
                                              for v in row))
                               for k, row in cap.state.iter_items())


def row_keys(n: int, salt: int) -> np.ndarray:
    from pathway_tpu_torch.engine import keys as K

    return K.mix_columns([np.arange(n, dtype=np.int64)], n, salt=salt, register=False)


def wordcount_graph(n_rows: int, commit: int):
    """The reference's in-repo streaming wordcount (``bench.py:2089``): words ``w{i % 997}``,
    one commit per ``commit`` rows, grouped and counted into a Capture."""
    from pathway_tpu_torch.engine import operators as ops
    from pathway_tpu_torch.engine.delta import Delta
    from pathway_tpu_torch.engine.reducers import make_reducer

    words = np.array([f"w{i % 997}" for i in range(n_rows)], dtype=object)
    keys = row_keys(n_rows, 1)
    batches = [(2 * t + 2, keys[s:s + commit], words[s:s + commit])
               for t, s in enumerate(range(0, n_rows, commit))]

    def build(worker):
        src = ops.ScheduledSource(["word"], [(t, Delta(keys=k, data={"word": w}))
                                             for t, k, w in batches])
        counts = ops.GroupByReduce(src, ["word"], [("count", make_reducer("count"), [])])
        cap = ops.Capture(counts)
        return [src, counts, cap], cap

    return build


def dense_columns(n_rows: int, n_groups: int, seed: int = 30) -> tuple:
    """``dense_graph``'s input columns: group int64 over ``n_groups``, value int64, weight
    float64 in 1/16ths."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, n_groups, n_rows).astype(np.int64)
    v = rng.integers(-2**31, 2**31, n_rows).astype(np.int64)
    w = rng.integers(-2**20, 2**20, n_rows) / 16.0
    return g, v, w


def dense_graph(n_rows: int, n_groups: int, commit: int, seed: int = 30):
    """Every column numeric: (group int64 over ``n_groups``, value int64, weight float64) in
    commits of ``commit`` rows, a sum/sum/count groupby joined to a ``n_groups``-row dimension
    table on the group. Weights are multiples of 1/16 below 2^16, so their sums are exact in any
    order and every sharding gives the same table bit for bit."""
    from pathway_tpu_torch.engine import keys as K, operators as ops
    from pathway_tpu_torch.engine.delta import Delta
    from pathway_tpu_torch.engine.reducers import make_reducer

    g, v, w = dense_columns(n_rows, n_groups, seed)
    keys = row_keys(n_rows, 2)
    batches = [(2 * t + 2, slice(s, s + commit)) for t, s in enumerate(range(0, n_rows, commit))]
    dim_g = np.arange(n_groups, dtype=np.int64)
    dim_keys, labels = row_keys(n_groups, 3), dim_g * 7919 + 13

    def jk(cols, k):
        return K.mix_columns([cols["g"]], len(k), register=False)

    def build(worker):
        src = ops.ScheduledSource(["g", "v", "w"], [
            (t, Delta(keys=keys[sl], data={"g": g[sl], "v": v[sl], "w": w[sl]}))
            for t, sl in batches])
        sums = ops.GroupByReduce(src, ["g"], [("sv", make_reducer("sum"), ["v"]),
                                              ("sw", make_reducer("sum"), ["w"]),
                                              ("n", make_reducer("count"), [])])
        left = ops.Rowwise(sums, {"jk": jk, **{c: (lambda c_: lambda cols, k: cols[c_])(c)
                                               for c in ("g", "sv", "sw", "n")}})
        dim = ops.StaticSource(dim_keys, {"g": dim_g, "label": labels})
        right = ops.Rowwise(dim, {"jk": jk, "label": lambda cols, k: cols["label"]})
        joined = ops.Join(left, right, "jk", "jk", ["g", "sv", "sw", "n"], ["label"],
                          ["g", "sv", "sw", "n", "label"])
        cap = ops.Capture(joined)
        return [src, sums, left, dim, right, joined, cap], cap

    return build


def exchange_case(n: int, cap_in: int, w: int, seed: int, device):
    """Words of 64-bit values with the high bit set, a fifth of the rows without a destination
    (-1), the rest skewed to destination 0 so that small buckets overflow."""
    gen = torch.Generator().manual_seed(seed)
    words = torch.randint(-2**31, 2**31 - 1, (n, cap_in, w), generator=gen,
                          dtype=torch.int64).to(torch.int32)
    words[..., 1::2] |= torch.tensor(-2**31, dtype=torch.int32)
    dest = torch.randint(0, n, (n, cap_in), generator=gen, dtype=torch.int32)
    dest[torch.rand((n, cap_in), generator=gen) < 0.3] = 0
    dest[torch.rand((n, cap_in), generator=gen) < 0.2] = -1
    return words.to(device), dest.to(device)


EXCHANGE_CASES = (  # (n, cap_in, w, cap_bucket): buckets that hold every row, and overflow
    (2, 8, 4, 8), (2, 1024, 4, 64), (2, 65536, 16, 65536), (4, 4096, 6, 4096),
    (4, 16384, 8, 256), (8, 8, 4, 2), (8, 16384, 10, 16384), (8, 65536, 16, 1024),
    (8, 65536, 4, 65536),
)


def check_bucket_exchange(device, recorded) -> int:
    """The kernel (buckets, validity and counts) against its plain version on the card, bitwise,
    on ``EXCHANGE_CASES`` and on the inputs the dense path gave it. Returns the largest word
    difference seen (0)."""
    from pathway_tpu_torch.parallel.exchange import bucket_exchange, bucket_exchange_plain

    cases = [(f"n={n} cap_in={c} w={w} cap_bucket={b}", *exchange_case(n, c, w, n * c + w, device),
              n, b) for n, c, w, b in EXCHANGE_CASES]
    cases.append((f"the dense path's largest input {tuple(recorded[0].shape)}, cap_bucket="
                  f"{recorded[3]}", *recorded))
    worst = 0
    for label, words, dest, n, cap_bucket in cases:
        out, valid, counts = bucket_exchange(words, dest, n, cap_bucket, return_counts=True)
        want, want_valid, want_counts = bucket_exchange_plain(words, dest, n, cap_bucket,
                                                              return_counts=True)
        torch.cuda.synchronize()
        kept, rows = int(want_valid.sum()), int((dest >= 0).sum())
        if not (torch.equal(out, want) and torch.equal(valid, want_valid)
                and torch.equal(counts, want_counts)):
            raise AssertionError(f"bucket_exchange at {label}: differs from its plain version")
        worst = max(worst, int((out.long() - want.long()).abs().max()))
        log(f"bucket_exchange at {label}: equal to its plain version bitwise ({kept} of {rows} "
            f"rows kept, {rows - kept} dropped for overflow)")
    return worst


def time_bucket_exchange(recorded) -> dict:
    """The kernel at the dense path's shape, on the inputs of that path's largest launch."""
    from pathway_tpu_torch.parallel.exchange import bucket_exchange, bucket_exchange_plain

    words, dest, n_dst, cap_bucket = recorded
    n_src, cap_in, w = words.shape
    out_rows = n_dst * n_src * cap_bucket
    t = {
        "shape": f"n_src={n_src} cap_in={cap_in} w={w} n_dst={n_dst} cap_bucket={cap_bucket}",
        "ms": cuda_ms(lambda: bucket_exchange(words, dest, n_dst, cap_bucket), 50),
        # the count pass and the scatter, on the device alone
        "device_ms": device_ms(lambda: bucket_exchange(words, dest, n_dst, cap_bucket),
                               "bucket_", per_call=2),
        "plain_ms": cuda_ms(lambda: bucket_exchange_plain(words, dest, n_dst, cap_bucket), 10),
        "library_ms": None,  # no PyTorch call buckets rows in source order
    }
    # each input word read once, each output word, validity byte and count written once
    t["bound_ms"], t["bound_by"] = bound(words.numel() * 4 + dest.numel() * 4
                                         + out_rows * w * 4 + out_rows + n_dst * n_src * 4, 0)
    return t


@contextlib.contextmanager
def record_largest_exchange(into: list):
    """Keep a copy of the bucketing inputs of the exchange made in the block that moves the most
    words (read plus written). The engine's runner reaches ``bucket_exchange`` through
    ``parallel.exchange``'s module attribute, which the block wraps; the wrapper counts its
    launches on that attribute, so the recording function carries the count and hands it back."""
    from pathway_tpu_torch.parallel import exchange

    original = exchange.bucket_exchange
    most = [0]

    def recording(values, dest, n_dst, cap_bucket, **kw):
        n_src, _, w = values.shape
        words = values.numel() + n_dst * n_src * cap_bucket * w
        if words > most[0]:
            most[0] = words
            into[:] = [values.clone(), dest.clone(), n_dst, cap_bucket]
        return original(values, dest, n_dst, cap_bucket, **kw)

    recording.launches = original.launches
    exchange.bucket_exchange = recording
    try:
        yield
    finally:
        exchange.bucket_exchange = original
        original.launches = recording.launches


#: the profiler's names of the kernels that each engine-path wrapper launches
PATH_KERNELS = {"bucket_exchange": ("bucket_count_kernel", "bucket_scatter_kernel"),
                "expression_vm": ("expression_vm_kernel",)}


def kernel_sums(prof) -> dict:
    """Each engine-path wrapper's device time summed over one profiled run (ms), beside the
    kernels the profiler recorded (two a ``bucket_exchange`` launch, one an ``expression_vm``)."""
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    out = {}
    for name, parts in PATH_KERNELS.items():
        mine = [e for e in events if any(part in e.key for part in parts)]
        out[name] = {"device_ms": sum(e.self_device_time_total for e in mine) / 1e3,
                     "kernels_recorded": sum(e.count for e in mine)}
    return out


@contextlib.contextmanager
def device_profile(on: bool):
    """The profiler over the block when ``on`` (the card), else nothing."""
    if not on:
        yield None
        return
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        torch.cuda.synchronize()


def exchange_split(prof, stats: dict, seconds: float, label: str) -> None:
    """The driver's exchange ticks of one engine run: the host time of its steps (the runner's
    counters: pack, the upload's enqueue, the kernel's enqueue with the wait for it, and the
    readback of the rows that arrived with its wait), the device time by kernel and copy (the
    profiler, which records the card's work of every thread), the device-to-host copies by
    destination (pageable or pinned memory), and the idle share of the run."""
    device_ev = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in device_ev) / 1e3
    wall_ms = seconds * 1e3
    n = int(stats["mesh_collectives"])
    split = {k: stats[f"mesh_{k}_ms"] for k in ("pack", "upload", "kernel", "readback")}
    card = card_line()
    log(f"{label} under the profiler: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms (idle "
        f"share {1 - busy_ms / wall_ms:.4f}); {n} collectives, "
        f"{int(stats['mesh_rows_moved'])} rows [{card}]")
    log("  host, summed over the run: " + ", ".join(
        f"{k} {v:.3f} ms ({v / n:.4f} a collective)" for k, v in split.items()) + f" [{card}]")
    log(f"  mesh_readback_ms {stats['mesh_readback_ms']:.3f} (host, the driver's readback of the "
        f"rows that arrived, with its wait); device-to-host copies on the device: " + ", ".join(
            f"{kind} {sum(e.self_device_time_total for e in device_ev if kind in e.key) / 1e3:.3f}"
            f" ms x{sum(e.count for e in device_ev if kind in e.key)}"
            for kind in ("Device -> Pageable", "Device -> Pinned")) + f" [{card}]")
    for e in sorted(device_ev, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"  device {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:80]} "
            f"[{card}]")


def run_engine(device, *, wc_rows: int = 500_000, wc_commit: int = 10_000,
               dense_rows: int = 1 << 20, groups: int = 1 << 16, dense_commit: int = 1 << 16,
               workers: int = 8, rag_chunks: int = 16384, rag_rows: int = 1 << 20,
               rag_commit: int = 1024, rag_queries: int = 64, k: int = 10, cfg=None) -> dict:
    """The engine phase; sizes as the defaults say on the card (a CPU rehearsal passes small
    ones). Returns the rows/s of each run, the launch counts of each path and the bucket
    exchange's check and times."""
    from pathway_tpu_torch.engine import operators as ops
    from pathway_tpu_torch.engine.delta import Delta
    from pathway_tpu_torch.engine.external_index import ExternalIndexNode
    from pathway_tpu_torch.models.embedder import Embedder
    from pathway_tpu_torch.ops.index_engines import BruteForceKnnEngine

    cuda = device.type == "cuda"
    launches: dict = {}
    rates: dict = {}

    build = wordcount_graph(wc_rows, wc_commit)
    base, sec, _ = run_workers(build, 1, False, device)
    rates["wordcount 1 worker"] = wc_rows / sec
    want = table(base)
    if sum(r[1] for _, r in want) != wc_rows or len(want) != min(997, wc_rows):
        raise AssertionError("wordcount: the counts do not add up to the rows")
    sums: dict = {}
    for n in (2, workers):
        with counted(f"engine_wordcount_{n}", launches), device_profile(cuda) as prof:
            cap, sec, stats = run_workers(build, n, True, device)
        if cuda:
            sums[f"engine_wordcount_{n}"] = kernel_sums(prof)
        if table(cap) != want:
            raise AssertionError(f"wordcount at {n} workers with mesh exchange differs from 1")
        rates[f"wordcount {n} workers, mesh exchange"] = wc_rows / sec
        log(f"wordcount {wc_rows} rows at {n} workers, mesh exchange: equal to 1 worker; "
            f"{int(stats['mesh_rows_moved'])} rows in {int(stats['mesh_collectives'])} "
            f"collectives; launches {launches[f'engine_wordcount_{n}']['bucket_exchange']}")

    build = dense_graph(dense_rows, groups, dense_commit)
    base, sec, _ = run_workers(build, 1, False, device)
    rates["dense 1 worker"] = dense_rows / sec
    want = table(base)
    if len(want) != groups or sum(r[3] for _, r in want) != dense_rows:
        raise AssertionError("dense groupby-join: the table does not cover every group and row")
    recorded: list = []
    with counted("engine_dense", launches), record_largest_exchange(recorded), \
            device_profile(cuda) as prof:
        cap, sec, stats = run_workers(build, workers, True, device)
    if cuda:
        exchange_split(prof, stats, sec, f"dense groupby-join at {workers} workers, mesh exchange,")
        sums["engine_dense"] = kernel_sums(prof)
    if table(cap) != want:
        raise AssertionError(f"dense groupby-join at {workers} workers with mesh exchange "
                             f"differs from 1 worker")
    rates[f"dense {workers} workers, mesh exchange"] = dense_rows / sec
    log(f"dense groupby-join {dense_rows} rows at {workers} workers, mesh exchange: equal to 1 "
        f"worker; {int(stats['mesh_rows_moved'])} rows in {int(stats['mesh_collectives'])} "
        f"collectives")
    cap, sec, _ = run_workers(build, workers, False, device)
    if table(cap) != want:
        raise AssertionError(f"dense groupby-join at {workers} workers over LocalComm differs")
    rates[f"dense {workers} workers, LocalComm"] = dense_rows / sec
    del base, cap, want

    result = {"rates": rates, "launches": launches, "device_ms_by_path": sums}
    if cuda:
        result["exchange_err"] = check_bucket_exchange(device, recorded)
        result["exchange"] = time_bucket_exchange(recorded)
    del recorded

    # RAG through the engine: chunks embedded by a Rowwise (kernel 1) into ExternalIndexNode
    # over the brute-force index on worker 0, filled first to rag_rows with seeded unit rows
    emb = Embedder(cfg, seed=0, device=device)
    corpus = make_corpus(rag_chunks, 256, seed=1)
    texts = np.array([c for c, _ in corpus], dtype=object)
    index = BruteForceKnnEngine(emb.cfg.dim, reserved_space=rag_rows, embedder=emb,
                                device=device)
    rng = np.random.default_rng(31)
    for start in range(0, rag_rows - rag_chunks, 65536):
        n = min(65536, rag_rows - rag_chunks - start)
        vecs = rng.standard_normal((n, emb.cfg.dim), dtype=np.float32)
        index.add_batch(list(range((1 << 62) + start, (1 << 62) + start + n)), vecs, [None] * n)
    doc_keys = row_keys(rag_chunks, 4)
    queries = np.array([texts[i].split(".")[0] for i in rng.integers(0, rag_chunks, rag_queries)],
                       dtype=object)
    n_commits = -(-rag_chunks // rag_commit)

    def build_rag(worker):
        docs = ops.ScheduledSource(["text"], [
            (2 * t + 2, Delta(keys=doc_keys[s:s + rag_commit], data={"text": texts[s:s + rag_commit]}))
            for t, s in enumerate(range(0, rag_chunks, rag_commit))])
        embedded = ops.Rowwise(docs, {"__data__": lambda c, k: emb.embed_texts(list(c["text"]))})
        qs = ops.ScheduledSource(["__query__", "__limit__"], [(2 * n_commits + 2, Delta(
            keys=row_keys(rag_queries, 5),
            data={"__query__": queries, "__limit__": np.full(rag_queries, k, np.int64)}))])
        # the index lives on worker 0, where both inputs gather; the other workers' nodes never
        # receive a row, so they get an empty index
        engine = index if worker == 0 else BruteForceKnnEngine(emb.cfg.dim, reserved_space=1,
                                                                device=device)
        node = ExternalIndexNode(embedded, qs, engine, asof_now=True)
        cap = ops.Capture(node)
        return [docs, embedded, qs, node, cap], cap

    emb.embed_texts(list(texts[:8]))  # first use: kernel libraries load, cuBLAS warms up
    with counted("engine_rag", launches), device_profile(cuda) as prof:
        cap, sec, stats = run_workers(build_rag, 2, True, device)
    if cuda:
        sums["engine_rag"] = kernel_sums(prof)
    rates["rag 2 workers, mesh exchange (chunks/s)"] = rag_chunks / sec
    replies = {int(k_): row[0] for k_, row in cap.state.iter_items()}
    q_keys = row_keys(rag_queries, 5)
    direct = index.search(list(queries), [k] * rag_queries, [None] * rag_queries)
    for qk, want_row in zip(q_keys, direct):
        got_row = replies.get(int(qk))
        if got_row != tuple((int(a), float(b)) for a, b in want_row):
            raise AssertionError("a reply of the engine differs from a direct search")
    corpus_keys = set(doc_keys.tolist())
    found = sum(1 for qk in q_keys if replies[int(qk)][0][0] in corpus_keys)
    log(f"RAG through the engine at 2 workers, mesh exchange: {rag_chunks} chunks in "
        f"{n_commits} commits into {index._slots.high} rows; {rag_queries} replies equal a direct "
        f"search; {found} of {rag_queries} top hits are corpus chunks; launches "
        f"{launches['engine_rag']}")
    if cuda:
        for path, need in (("engine_wordcount_2", ("bucket_exchange",)),
                           (f"engine_wordcount_{workers}", ("bucket_exchange",)),
                           ("engine_dense", ("bucket_exchange",)),
                           ("engine_rag", ("bucket_exchange", "masked_attention", "knn_topk"))):
            missing = [name for name in need if launches[path][name] == 0]
            if missing:
                raise AssertionError(f"{missing} not launched on the {path} path")
    return result


# -- phase 10: the Table API down to pw.run(), with the expression machine ---------------------

POW_ULP = 2  # float ** against its plain version: within 2 units in the last place
VM_SCHEMA = dict(a=int, b=int, s=int, e=int, x=float, y=float, px=float, p=bool, q=bool)


def vm_columns(n: int, seed: int = 40) -> dict:
    """Seeded columns with the edge values at their heads: INT64_MIN and INT64_MAX, shift counts
    from -3 to 70, negative exponents, NaN, +-inf, -0.0, 1e300 and a subnormal."""
    rng = np.random.default_rng(seed)
    ints = np.array([-2**63, 2**63 - 1, 0, -1, 1, 2, 3, 63, 64, 70, -3, 1 << 62, -(1 << 62)],
                    np.int64)
    floats = np.array([np.nan, np.inf, -np.inf, -0.0, 0.0, 1e300, -1e300, 2.0 ** 63,
                       -(2.0 ** 63) - 4096, 9.3e18, 0.5, -0.7, 1.5, -2.0, 1e-310])
    a = rng.integers(-2**62, 2**62, n)
    a[:len(ints)] = ints
    b = rng.integers(-1000, 1000, n)
    b[len(ints):2 * len(ints)] = ints
    x = rng.standard_normal(n) * 10
    x[:len(floats)] = floats
    y = rng.integers(-1024, 1024, n) / 16.0
    y[len(floats):2 * len(floats)] = floats
    return {"a": a.astype(np.int64), "b": b.astype(np.int64),
            "s": rng.integers(-3, 71, n).astype(np.int64),
            "e": rng.integers(-3, 12, n).astype(np.int64), "x": x, "y": y,
            "px": np.abs(x) + 0.25, "p": rng.random(n) < 0.5, "q": rng.random(n) < 0.3}


def vm_sweep(pw, t) -> list:
    """(label, expression): every opcode at every operand type it takes, weak constants, the
    casts among int, float and bool, and the trees udf_lift makes of lambdas."""
    import operator as o

    fns = {"+": o.add, "-": o.sub, "*": o.mul, "**": o.pow, "==": o.eq, "!=": o.ne, "<": o.lt,
           "<=": o.le, ">": o.gt, ">=": o.ge, "&": o.and_, "|": o.or_, "^": o.xor,
           "<<": o.lshift, ">>": o.rshift}

    def v(name):
        return getattr(t, name) if isinstance(name, str) else name

    pairs = {
        ("+", "-", "*"): (("a", "b"), ("a", "x"), ("x", "y"), ("x", "p"), ("a", "p"), ("a", 3),
                          ("x", 2.5), ("a", 2.5), ("p", 1), (3, "a"), (1.5, "x"), ("x", 0.0),
                          (0.0, "x"), ("x", -0.0), ("p", "q")),
        ("**",): (("a", "e"), ("b", "e"), ("a", 3), ("a", 0), ("x", 2), ("x", -2), ("px", 0.5),
                  ("px", "y"), ("px", "e"), ("b", "px"), (2, "s"), (2.0, "e"), ("p", "q")),
        ("==", "!=", "<", "<=", ">", ">="): (("a", "b"), ("a", "x"), ("x", "y"), ("p", "q"),
                                             ("a", 2.5), ("x", 1)),
        ("&", "|", "^"): (("a", "b"), ("p", "q"), ("a", 255)),
        ("<<", ">>"): (("a", "s"), ("b", "s"), ("a", 3), (1, "s"), ("p", "q")),
    }
    out = []
    for ops_, operands in pairs.items():
        for op in ops_:
            for l, r in operands:
                if op == "-" and (l, r) == ("p", "q"):
                    continue  # XLA refuses bool subtraction; so does the lowering
                out.append((f"{l}{op}{r}", fns[op](v(l), v(r))))
    out += [("-a", -t.a), ("-x", -t.x), ("~a", ~t.a), ("~p", ~t.p), ("abs a", abs(t.a)),
            ("abs x", abs(t.x)), ("if p a x", pw.if_else(t.p, t.a, t.x)),
            ("if p 2 a", pw.if_else(t.p, 2, t.a)), ("if a>0 x -x", pw.if_else(t.a > 0, t.x, -t.x)),
            ("declare float a", pw.declare_type(float, t.a)), ("keys", t.id),
            ("x*2.0-1.0", t.x * 2.0 - 1.0),
            ("min", pw.apply_with_type(lambda x, y: min(x, y), float, t.x, t.y)),
            ("apply a*3+7", pw.apply_with_type(lambda a: a * 3 + 7, int, t.a))]
    for src in ("a", "x", "y", "p"):
        for target in (int, float, bool):
            out.append((f"cast {target.__name__} {src}", pw.cast(target, v(src))))
    return out


def vm_agree(label: str, got: torch.Tensor, want: torch.Tensor, pow_case: bool) -> float:
    """Kernel against plain: bits equal (every NaN equal to every NaN), or for a float ``**``
    within ``POW_ULP`` units in the last place. Returns the largest absolute difference."""
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"expression_vm {label}: {got.dtype}{tuple(got.shape)} against "
                             f"{want.dtype}{tuple(want.shape)}")
    if got.dtype != torch.float64:
        if not torch.equal(got, want):
            raise AssertionError(f"expression_vm {label}: differs from its plain version")
        return 0.0
    nan = torch.isnan(want)
    if not torch.equal(torch.isnan(got), nan):
        raise AssertionError(f"expression_vm {label}: NaN rows differ from the plain version")
    gi, wi = got.view(torch.int64)[~nan], want.view(torch.int64)[~nan]
    if not pow_case:
        if not torch.equal(gi, wi):
            raise AssertionError(f"expression_vm {label}: bits differ from the plain version")
        return 0.0
    lo = torch.tensor(-2**63, dtype=torch.int64, device=gi.device)
    ulp = float((torch.where(gi < 0, lo - gi, gi).double()
                 - torch.where(wi < 0, lo - wi, wi).double()).abs().max()) if gi.numel() else 0.0
    if ulp > POW_ULP:
        raise AssertionError(f"expression_vm {label}: {ulp} ulp from the plain version's pow")
    fin = torch.isfinite(want)
    return float((got[fin] - want[fin]).abs().max()) if fin.any() else 0.0


def chain_variant(pw, t, lifted: bool):
    """The phase's pipeline up to the groupby: ``y`` through a lifted lambda (the main path), or
    written out (``lifted=False``), which gives the chain a structural signature."""
    y = (pw.apply_with_type(lambda a: a * 3 + 7, int, pw.this.a) if lifted
         else pw.this.a * 3 + 7)
    return (t.select(g=pw.this.g, y=y, z=pw.this.x * 2.0 - 1.0)
            .filter(pw.this.z > -32.0)
            .select(g=pw.this.g,
                    w=pw.if_else(pw.this.y > 1000, pw.cast(float, pw.this.y & 1023) * pw.this.z,
                                 -pw.this.z)))


def fused_chain_of(out_table, device):
    """The ``FusedChain`` that the port's runner makes of ``out_table``'s graph on ``device``."""
    from pathway_tpu_torch.engine import fusion
    from pathway_tpu_torch.internals.graph_runner import GraphRunner

    runner = GraphRunner(device)
    runner.capture(out_table)
    chains = [n for n in fusion.fuse_graph(runner._nodes) if isinstance(n, fusion.FusedChain)]
    if len(chains) != 1:
        raise AssertionError(f"expected one fused chain, found {len(chains)}")
    return chains[0]


def check_expression_vm(device, n: int = 65536) -> tuple[float, int]:
    """The kernel against its plain version on the card over the sweep at ``n`` rows and over a
    3-member chain with two filters; bitwise, float ``**`` within ``POW_ULP``. Returns the
    largest absolute difference (from ``**``) and the number of programs held."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.internals import expression_compiler as ec
    from pathway_tpu_torch.ops.expression_kernel import run_program, run_program_plain

    pw.G.clear()
    cols = vm_columns(n)
    keys = np.random.default_rng(41).integers(0, 2**63, n, dtype=np.uint64)
    keys[:3] = [0, 2**64 - 1, 2**63]
    t = pw.debug.table_from_rows(pw.schema_from_types(**VM_SCHEMA), [(0,) * 7 + (False,) * 2])
    env = ec.ColumnEnv(device=device)
    env.add_table(t)

    def column(arr):
        arr = np.ascontiguousarray(arr)
        return torch.from_numpy(arr.view(np.int64) if arr.dtype == np.uint64 else arr).to(device)

    def held(label, prog, src, pow_case=False):
        inputs = [column(keys if name is None else src[name]) for name, _ in prog.inputs]
        got, want = run_program(prog, inputs), run_program_plain(prog, inputs)
        torch.cuda.synchronize()
        return max((vm_agree(f"{label} [{name}]", g, w, pow_case)
                    for (name, _), g, w in zip(prog.outputs, got, want)), default=0.0)

    worst, count = 0.0, 0
    kinds = ec._input_kinds(list(cols), cols)
    for label, expr in vm_sweep(pw, t):
        prog = ec.expression_program(expr, env, kinds, {})
        worst = max(worst, held(label, prog, cols, "**" in label))
        count += 1
    # a 3-member chain with two filters, lowered as the runner lowers it
    rng = np.random.default_rng(42)
    rows = [(int(i) * 7 - 300, int(i) % 13, i / 16.0 - 20.0, i % 3 == 0) for i in range(600)]
    ct = pw.debug.table_from_rows(pw.schema_from_types(a=int, b=int, x=float, p=bool), rows)
    chain_t = (ct.select(a=pw.this.a, b=pw.this.b * 3 + 1, x=pw.this.x * 2.0 - 1.0, p=pw.this.p)
               .filter(pw.this.b > 10)
               .select(c=pw.this.a + pw.this.b, w=pw.if_else(pw.this.p, pw.this.x, -pw.this.x),
                       p=pw.this.p)
               .filter(pw.this.w < 8.0))
    plan = fused_chain_of(chain_t, device)._kernel_plan
    src = {"a": rng.integers(-2**62, 2**62, n), "b": rng.integers(-10, 30, n),
           "x": rng.standard_normal(n) * 8, "p": rng.random(n) < 0.5}
    src["x"][:4] = [np.nan, -0.0, np.inf, -np.inf]
    prog = ec.chain_program(plan, ec._input_kinds(plan["src_cols"], src))
    held("3-member chain with two filters", prog, src)
    pw.G.clear()
    log(f"expression_vm: {count + 1} programs at {n} rows (every opcode at its operand types, "
        f"edge values, a 3-member chain with two filters) equal to the plain version bitwise; "
        f"float ** within {POW_ULP} ulp, largest difference {worst:.3g}")
    return worst, count + 1


def pipeline_columns(n: int, n_groups: int, seed: int = 43) -> dict:
    """The phase's input: ``a`` int64, ``g`` int64 over ``n_groups`` groups, ``x`` float64 in
    multiples of 1/16 in [-64, 64), so every product and sum of the pipeline is exact."""
    rng = np.random.default_rng(seed)
    return {"a": rng.integers(-2**31, 2**31, n).astype(np.int64),
            "g": rng.integers(0, n_groups, n).astype(np.int64),
            "x": rng.integers(-1024, 1024, n) / 16.0}


def pipeline_reference(cols: dict) -> dict:
    """The same pipeline in plain numpy: group -> (sum of w, count)."""
    z = cols["x"] * 2.0 - 1.0
    keep = z > -32.0
    y = cols["a"] * 3 + 7
    w = np.where(y > 1000, (y & 1023).astype(np.float64) * z, -z)[keep]
    g = cols["g"][keep]
    uniq, inv = np.unique(g, return_inverse=True)
    sums = np.zeros(len(uniq))
    np.add.at(sums, inv, w)
    counts = np.bincount(inv, minlength=len(uniq))
    return {int(k): (float(s_), int(c)) for k, s_, c in zip(uniq, sums, counts)}


def time_expression_vm(device, cols: dict, commit: int) -> dict:
    """The phase's chain as one program at its launch shape (one commit), timed with CUDA events
    (a call) and the profiler (the kernel alone) beside its bound, its plain version and an empty
    kernel on the same grid (the launch's own cost); the upload and readback of the same bytes
    through pinned buffers; and the numpy tier's host time on the same batch."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.engine.delta import Delta
    from pathway_tpu_torch.internals import expression_compiler as ec
    from pathway_tpu_torch.ops.expression_kernel import (
        expression_vm, expression_vm_empty, expression_vm_plain, layout,
    )

    pw.G.clear()
    t = pw.debug.table_from_rows(pw.schema_from_types(a=int, g=int, x=float), [(0, 0, 0.0)])
    out = chain_variant(pw, t, lifted=False)
    res = out.groupby(pw.this.g).reduce(pw.this.g, s=pw.reducers.sum(pw.this.w),
                                        c=pw.reducers.count())
    chain = fused_chain_of(res, device)
    plan = chain._kernel_plan
    batch = {c: np.ascontiguousarray(cols[c][:commit]) for c in plan["src_cols"]}
    prog = ec.chain_program(plan, ec._input_kinds(plan["src_cols"], batch))
    in_offs, in_bytes, out_offs, out_bytes = layout(prog, commit)
    host_in = torch.empty(in_bytes, dtype=torch.uint8, pin_memory=True)
    for (name, _), off in zip(prog.inputs, in_offs):
        host_in.numpy()[off:off + commit * 8] = batch[name].view(np.uint8)
    dev_in = host_in.to(device)
    dev_out = torch.empty(out_bytes, dtype=torch.uint8, device=device)
    host_out = torch.empty(out_bytes, dtype=torch.uint8, pin_memory=True)
    plain_out = torch.empty_like(dev_out)
    expression_vm(prog, dev_in, dev_out, commit)
    expression_vm_plain(prog, dev_in, plain_out, commit)
    torch.cuda.synchronize()
    if not torch.equal(dev_out, plain_out):
        raise AssertionError("expression_vm: the phase's chain differs from its plain version")
    t_ = {
        "shape": f"{commit} rows, {len(prog.inputs)} columns in, {len(prog.outputs) - 1} columns "
                 f"and a mask out, {prog.code.shape[0]} instructions, {prog.n_regs} registers",
        "ms": cuda_ms(lambda: expression_vm(prog, dev_in, dev_out, commit), 100),
        "device_ms": device_ms(lambda: expression_vm(prog, dev_in, dev_out, commit),
                               "expression_vm_kernel"),
        # the floor: an empty kernel on the same grid, timed the same two ways
        "empty_ms": cuda_ms(lambda: expression_vm_empty(prog, device, commit), 100),
        "empty_device_ms": device_ms(lambda: expression_vm_empty(prog, device, commit),
                                     "expression_vm_empty_kernel"),
        "plain_ms": cuda_ms(lambda: expression_vm_plain(prog, dev_in, plain_out, commit), 20),
        "upload_ms": cuda_ms(lambda: dev_in.copy_(host_in, non_blocking=True), 50),
        "readback_ms": cuda_ms(lambda: host_out.copy_(dev_out, non_blocking=True), 50),
        "library_ms": None,  # no single PyTorch call evaluates an expression program
    }
    t_["bound_ms"], t_["bound_by"] = bound(in_bytes + out_bytes, 0)
    # the numpy tier on the same batch: the fused chain's composed member kernels, gates shut
    saved = ec.JIT_THRESHOLD
    ec.JIT_THRESHOLD = 1 << 62
    try:
        d = Delta(keys=np.arange(commit, dtype=np.uint64), data=batch)
        times = []
        for _ in range(7):
            t0 = time.perf_counter()
            chain.process(0, [d])
            times.append((time.perf_counter() - t0) * 1e3)
        t_["numpy_tier_ms"] = statistics.median(times)
    finally:
        ec.JIT_THRESHOLD = saved
    pw.G.clear()
    return t_


@contextlib.contextmanager
def scoped_env(env: dict):
    """The environment variables ``env`` set for the block (a None value unsets one), the old
    values back after it."""
    saved = {k: os.environ.get(k) for k in env}
    for k, v in env.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def scoped_async(value: str | None):
    """``PATHWAY_ASYNC_EXEC`` set to ``value`` for the block, or unset (the default loop) when
    ``value`` is None; the old value back after it."""
    saved = os.environ.pop("PATHWAY_ASYNC_EXEC", None)
    if value is not None:
        os.environ["PATHWAY_ASYNC_EXEC"] = value
    try:
        yield
    finally:
        os.environ.pop("PATHWAY_ASYNC_EXEC", None)
        if saved is not None:
            os.environ["PATHWAY_ASYNC_EXEC"] = saved


def run_pipeline(device, cols: dict, commit: int, n_groups: int, workers: int, lifted: bool,
                 mesh: bool | None = None, async_exec: str | None = None, **run_kw):
    """``pw.run(device=...)`` of the phase's streaming pipeline: a ``ConnectorSubject`` that
    ``next_batch``es the columns in commits of ``commit`` rows, the chain, the groupby, and
    ``pw.io.subscribe(on_batch=...)``. Returns (final table group -> (sum, count), seconds of
    the run). Each commit is its own tick (``PATHWAY_INGEST_COALESCE_WINDOWS=0``), so every
    gate sees the same batches in every run. Past 1 worker with the mesh exchange unless
    ``mesh`` is False; ``async_exec`` sets ``PATHWAY_ASYNC_EXEC`` (unset: the default loop, async
    over ``LocalComm`` and BSP over the mesh exchange). ``run_kw`` goes to ``pw.run``
    (``with_http_server``, ``monitoring_level``)."""
    import pathway_tpu_torch as pw

    n = len(cols["a"])

    class Subject(pw.io.python.ConnectorSubject):
        def run(self):
            for s in range(0, n, commit):
                self.next_batch({c: v[s:s + commit] for c, v in cols.items()})
                self.commit()

    pw.G.clear()
    t = pw.io.python.read(Subject(), schema=pw.schema_from_types(a=int, g=int, x=float),
                          autocommit_duration_ms=None)
    res = chain_variant(pw, t, lifted).groupby(pw.this.g).reduce(
        pw.this.g, s=pw.reducers.sum(pw.this.w), c=pw.reducers.count())
    seen: list = []
    pw.io.subscribe(res, on_batch=lambda tm, b: seen.append(
        (b.keys.copy(), b.data["g"].copy(), b.data["s"].copy(), b.data["c"].copy(),
         b.diffs.copy())))
    if mesh is None:
        mesh = workers > 1
    env = {"PATHWAY_THREADS": str(workers), "PATHWAY_MESH_EXCHANGE": "1" if mesh else "0",
           "PATHWAY_INGEST_COALESCE_WINDOWS": "0", "PATHWAY_FUSION": "1"}
    with scoped_env(env), scoped_async(async_exec):
        try:
            t0 = time.perf_counter()
            pw.run(device=device, **run_kw)
            seconds = time.perf_counter() - t0
        finally:
            pw.G.clear()
    keys, g, s_, c, diffs = (np.concatenate(x) for x in zip(*seen))
    order = np.lexsort((np.arange(len(keys)), keys))  # by row key, then arrival
    keys, g, s_, c, diffs = keys[order], g[order], s_[order], c[order], diffs[order]
    starts = np.flatnonzero(np.r_[True, keys[1:] != keys[:-1]])
    net = np.add.reduceat(diffs, starts)
    if ((net != 0) & (net != 1)).any():
        raise AssertionError("the subscribed stream does not consolidate to one row a group")
    alive = set(keys[starts][net == 1].tolist())
    pos = np.flatnonzero(diffs > 0)
    last = pos[np.flatnonzero(np.r_[keys[pos][1:] != keys[pos][:-1], True])]  # newest insert
    table = {int(g[i]): (float(s_[i]), int(c[i])) for i in last if int(keys[i]) in alive}
    return table, seconds


def gated_launches(n_commits: int, workers: int, lifted: bool, warmup: int = 16) -> int:
    """What the reference's gates give for the phase's graph when every batch holds at least
    ``JIT_THRESHOLD`` rows. Compiled expressions are shared by the workers (the compile cache
    sits on the expression), so each counts the batches of every worker; a fused chain is a node
    of one worker and counts its own. With the lifted lambda the chain has no structural
    signature, so its 8 member expressions (select: g, y, z; the filter; select: g, w; the
    groupby's preamble: its key and the sum's argument) run one program each on every batch.
    Written out, the chain is one program past its own warm-up; during that warm-up its numpy
    tier calls the member expressions, whose shared gates open once the workers together have
    sent more than ``warmup`` batches. The reduce's projection adds 3 expressions (g, s, c)."""
    shared = n_commits * workers - warmup
    if lifted:
        return (8 + 3) * shared
    return (workers * (n_commits - warmup) + 8 * max(0, workers * min(n_commits, warmup) - warmup)
            + 3 * shared)


def run_table_api(device, *, rows: int = 1 << 22, commit: int = 1 << 16, groups: int = 1 << 16,
                  threshold: int | None = None) -> dict:
    """The phase: the kernel against its plain version (on the card), then the pipeline through
    ``pw.run`` at 1 worker and at 2 with mesh exchange, with the lifted lambda (per-expression
    programs) and with it written out (one program for the chain); each table equal to the numpy
    computation and each launch count equal to the gates'. A CPU rehearsal passes small sizes
    and a lower ``threshold``."""
    from pathway_tpu_torch.internals import expression_compiler as ec
    from pathway_tpu_torch.ops.expression_kernel import HostLauncher, expression_vm

    cuda = device.type == "cuda"
    result: dict = {"launches": {}, "rates": {}, "device_ms_by_path": {}}
    if cuda:
        result["max_abs_err"], result["programs"] = check_expression_vm(device)
    saved_threshold = ec.JIT_THRESHOLD
    ec.JIT_THRESHOLD = threshold or saved_threshold
    cols = pipeline_columns(rows, groups)
    want = pipeline_reference(cols)
    if cuda:
        result["time"] = time_expression_vm(device, cols, commit)
    n_commits = -(-rows // commit)
    for path, workers, lifted in (("table_api_1", 1, True), ("table_api_2", 2, True),
                                  ("table_api_chain_1", 1, False),
                                  ("table_api_chain_2", 2, False)):
        HostLauncher.runs = 0
        with counted(path, result["launches"]), device_profile(cuda) as prof:
            got, sec = run_pipeline(device, cols, commit, groups, workers, lifted)
        if prof is not None:
            result["device_ms_by_path"][path] = kernel_sums(prof)
        if got != want:
            raise AssertionError(f"{path}: the table differs from the numpy computation")
        expected = gated_launches(n_commits, workers, lifted)
        ran = HostLauncher.runs
        launched = result["launches"][path]["expression_vm"]
        if ran != expected or (cuda and launched != expected):
            raise AssertionError(f"{path}: {ran} programs run, {launched} launched; the gates "
                                 f"give {expected}")
        rate = rows / sec
        result["rates"][path] = rate
        log(f"Table API {path}: {rows} rows in {n_commits} commits of {commit}, "
            f"{workers} worker(s){', mesh exchange' if workers > 1 else ''}, "
            f"{'lifted lambda' if lifted else 'one program for the chain'}: {len(got)} groups "
            f"equal to numpy; {ran} programs run, {launched} launches (gates: {expected}); "
            f"{rate:.1f} rows/s")
        if prof is not None and path == "table_api_1":
            device_ev = [e for e in prof.key_averages()
                         if e.device_type == torch.autograd.DeviceType.CUDA]
            busy_ms = sum(e.self_device_time_total for e in device_ev) / 1e3
            result["idle_share"] = 1 - busy_ms / (sec * 1e3)
            log(f"  under the profiler: wall {sec * 1e3:.3f} ms, device busy {busy_ms:.3f} ms "
                f"(idle share {result['idle_share']:.4f})")
            for e in sorted(device_ev, key=lambda e: -e.self_device_time_total)[:4]:
                log(f"  device {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
                    f"{e.key[:80]}")
    ec.JIT_THRESHOLD = saved_threshold
    return result


# -- phase 11: the indexing stdlib through pw.run() --------------------------------------------


_wall = time.perf_counter  # for the subscribe callbacks, whose ``time`` argument hides the module


def index_data(n_chunks: int, n_rows: int, dim: int, n_queries: int, seed: int = 31):
    """The RAG cell's rows: its chunk texts, then seeded unit vectors up to ``n_rows``; and its
    text queries (the first sentence of seeded chunks)."""
    texts = [c for c, _ in make_corpus(n_chunks, 256, seed=1)]
    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((n_rows - n_chunks, dim), dtype=np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    queries = [texts[i].split(".")[0] for i in rng.integers(0, n_chunks, n_queries)]
    return texts, vecs, queries


def rows_held(engine) -> int:
    """The rows an index engine holds (a hybrid: the fewest of its sub-engines')."""
    subs = getattr(engine, "engines", None)
    if subs is not None:
        return min(rows_held(e) for e in subs)
    return engine._slots.high if hasattr(engine, "_slots") else len(engine._doc_len)


def keep_engines(index) -> list:
    """The index engines a ``DataIndex``'s run builds (one a worker), for the direct searches."""
    inner = index.inner_index
    make_engine, engines = inner._make_engine, []

    def keep(dev):
        engines.append(make_engine(dev))
        return engines[-1]

    inner._make_engine = keep
    return engines


def run_index_pipeline(device, *, factory, texts, vecs, queries, k: int, chunk_commit: int,
                       vec_commit: int, workers: int, trace: bool = True) -> dict:
    """``pw.run(device=...)`` of an index over a ``ConnectorSubject``'s rows (``rid``, ``data``:
    the chunk texts in commits of ``chunk_commit``, then the vectors in commits of
    ``vec_commit``), then the queries (``qid``, ``q``) in one commit of their own once every row
    is in: a second subject polls the run's engines until one holds every row. Each commit is its
    own tick. On the card with ``trace`` the run is traced (device activity only), and the query
    tick is marked on the device by an empty spin kernel at the queries' commit and another at
    the last answer's callback. Returns the answers by query id (a list of (rid, score)), the
    matched row keys by query id, the engines the run built, and its times."""
    import threading

    import pathway_tpu_torch as pw

    cuda = device.type == "cuda"
    n_rows = len(texts) + len(vecs)
    answered = threading.Event()
    marks: dict = {}

    class Rows(pw.io.python.ConnectorSubject):
        def run(self):
            for s in range(0, len(texts), chunk_commit):
                part = texts[s:s + chunk_commit]
                self.next_batch({"rid": list(range(s, s + len(part))), "data": part})
                self.commit()
            for s in range(0, len(vecs), vec_commit):
                part = vecs[s:s + vec_commit]
                start = len(texts) + s
                self.next_batch({"rid": list(range(start, start + len(part))),
                                 "data": list(part)})
                self.commit()

    class Queries(pw.io.python.ConnectorSubject):
        def run(self):
            deadline = _wall() + 1200
            while not engines or max(rows_held(e) for e in engines) < n_rows:
                if _wall() > deadline:
                    raise AssertionError("the index did not take every row within 1200 s")
                time.sleep(0.005)
            marks["filled"] = _wall()
            if cuda and trace:
                torch.cuda._sleep(1000)  # the query tick's start on the device's timeline
            marks["query"] = _wall()
            self.next_batch({"qid": list(range(len(queries))), "q": list(queries)})
            self.commit()

    pw.G.clear()
    data = pw.io.python.read(Rows(), schema=pw.schema_from_types(rid=int, data=object),
                             autocommit_duration_ms=None)
    qt = pw.io.python.read(Queries(), schema=pw.schema_from_types(qid=int, q=str),
                           autocommit_duration_ms=None)
    index = factory.build_index(data.data, data)
    engines = keep_engines(index)
    res = index.query_as_of_now(qt.q, number_of_matches=k).select(
        qid=pw.left.qid, rid=pw.right.rid, score=pw.right._pw_index_reply_score,
        ids=pw.right._pw_index_reply_id)
    answers: dict = {}
    matched: dict = {}

    def on_answer(key, row, time, is_addition):
        if is_addition:
            answers[row["qid"]] = list(zip((int(r) for r in row["rid"]),
                                           (float(s) for s in row["score"])))
            matched[row["qid"]] = [int(i) for i in row["ids"]]
            if len(answers) == len(queries):
                marks["answered"] = _wall()
                if cuda and trace:
                    torch.cuda._sleep(1000)  # the query tick's end
                answered.set()

    pw.io.subscribe(res, on_change=on_answer)
    env = {"PATHWAY_THREADS": str(workers), "PATHWAY_MESH_EXCHANGE": "1" if workers > 1 else "0",
           "PATHWAY_INGEST_COALESCE_WINDOWS": "0"}
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with scoped_env(env), (torch.profiler.profile(activities=acts) if cuda and trace
                           else contextlib.nullcontext()) as prof:
        try:
            t0 = time.perf_counter()
            pw.run(device=device)
            seconds = time.perf_counter() - t0
        finally:
            pw.G.clear()
        if prof is not None:
            torch.cuda.synchronize()
    if not answered.is_set():
        raise AssertionError("the run ended before every query was answered")
    out = {"answers": answers, "matched": matched, "engines": engines, "seconds": seconds,
           "query_ms": (marks["answered"] - marks["query"]) * 1e3,
           "fill_rows_per_s": n_rows / (marks["filled"] - t0), "idle_share": None}
    if prof is not None:
        out.update(query_tick_device(prof))
    return out


def query_tick_device(prof) -> dict:
    """The query tick on the device's timeline, between the two spin kernels that mark it: its
    span, the device's busy time inside it (kernels and copies), its idle share, and the largest
    device events in it."""
    ev = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                key=lambda e: e.time_range.start)
    spins = [e for e in ev if "spin_kernel" in e.name]
    if len(spins) < 2:
        log(f"  the query tick's markers: {len(spins)} of 2 recorded; its idle share is not "
            f"measured")
        return {}
    lo, hi = spins[-2].time_range.end, spins[-1].time_range.start
    inside = [e for e in ev if lo <= e.time_range.start and e.time_range.end <= hi]
    span_ms = (hi - lo) / 1e3
    busy_ms = sum(e.time_range.elapsed_us() for e in inside) / 1e3
    copy_ms = sum(e.time_range.elapsed_us() for e in inside if "Memcpy" in e.name) / 1e3
    by_name = collections.Counter()
    counts = collections.Counter()
    for e in inside:
        by_name[e.name[:80]] += e.time_range.elapsed_us() / 1e3
        counts[e.name[:80]] += 1
    return {"idle_share": 1 - busy_ms / span_ms, "busy_ms": busy_ms, "span_ms": span_ms,
            "copy_ms": copy_ms,
            "top": [(ms, counts[name], name) for name, ms in by_name.most_common(4)]}


def check_answers(label: str, got: dict, want: dict, *, extra: int = 0) -> int:
    """Each query's answer through ``pw.run`` against the direct search's on the same rows, by
    query id: the direct search exactly ``extra`` matches longer (a caller that searches one
    further passes 1, so that a near tie across the answer's last place may swap), scores within
    one bf16 ulp, ids equal wherever the direct score is more than one ulp from its neighbours'.
    Returns the number of ids that differ inside such near ties."""
    if got.keys() != want.keys():
        raise AssertionError(f"{label}: answers for {len(got)} queries, direct {len(want)}")
    swapped = 0
    for q, w in want.items():
        g = got[q]
        if len(w) != len(g) + extra:
            raise AssertionError(f"{label}: {len(g)} matches, the direct search {len(w)} "
                                 f"({extra} beyond the answer's expected)")
        ws = torch.tensor([s for _, s in w], dtype=torch.float64)
        tol = bf16_ulp(ws)
        if (torch.tensor([s for _, s in g], dtype=torch.float64) - ws[:len(g)]).abs().gt(
                tol[:len(g)]).any():
            raise AssertionError(f"{label}: a score differs from the direct search's by more "
                                 f"than one bf16 ulp")
        for i, ((gi, _), (wi, _)) in enumerate(zip(g, w)):
            near = any(abs(ws[i] - ws[j]) <= tol[i] for j in (i - 1, i + 1) if 0 <= j < len(w))
            if gi != wi:
                if not near:
                    raise AssertionError(f"{label}: id {gi} where the direct search has {wi}, "
                                         f"with clear scores")
                swapped += 1
    return swapped


def run_indexing(device, *, n_chunks: int = 16384, n_rows: int = 1 << 20, n_rows_2: int = 1 << 18,
                 chunk_commit: int = 1024, vec_commit: int = 1 << 16, n_queries: int = 64,
                 k: int = 10, hybrid_chunks: int = 1024, cfg=None) -> dict:
    """The phase; sizes as the defaults say on the card (a CPU rehearsal passes small ones):
    ``n_rows`` at 1 worker, ``n_rows_2`` (at most ``n_rows``) at 2, the hybrid over the first
    ``hybrid_chunks`` of the ``n_chunks`` chunks (it embeds a chunk at a time: cut from 16,384 to
    8,192 when phase 16 came, to 4,096 when phase 18 did, to 2,048 when phase 19 did and to
    1,024 when phase 21 did, PERF.md section 4). Returns each
    run's launch counts, rates and times."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.models.embedder import Embedder
    from pathway_tpu_torch.ops.index_engines import BruteForceKnnEngine

    cuda = device.type == "cuda"
    emb = Embedder(cfg, seed=0, device=device)
    dim = emb.cfg.dim
    texts, vecs, queries = index_data(n_chunks, n_rows, dim, n_queries)
    emb.embed_texts(texts[:8])  # first use: kernel libraries load, cuBLAS warms up

    def direct_answers(rows: int) -> dict:
        t0 = time.perf_counter()
        direct = BruteForceKnnEngine(dim, reserved_space=rows, embedder=emb, device=device)
        for s in range(0, n_chunks, chunk_commit):
            part = texts[s:s + chunk_commit]
            direct.add_batch(list(range(s, s + len(part))), part, [None] * len(part))
        for s in range(0, rows - n_chunks, vec_commit):
            part = vecs[s:min(s + vec_commit, rows - n_chunks)]
            direct.add_batch(list(range(n_chunks + s, n_chunks + s + len(part))), list(part),
                             [None] * len(part))
        want = dict(enumerate(direct.search(queries, [k] * n_queries, [None] * n_queries)))
        log(f"the direct engine: {direct._slots.high} rows and {n_queries} searches in "
            f"{time.perf_counter() - t0:.1f} s")
        return want

    result: dict = {"launches": {}, "rates": {}, "data": (texts, vecs, queries), "want": {}}
    card = card_line() if cuda else "cpu"
    for path, workers, rows in (("indexing", 1, n_rows), ("indexing_2", 2, min(n_rows_2, n_rows))):
        want = direct_answers(rows)
        result["want"][rows] = want  # phase 14 answers the same queries over the first rows
        factory = pw.indexing.BruteForceKnnFactory(dimensions=dim, reserved_space=rows,
                                                   embedder=emb)
        with counted(path, result["launches"]):
            run = run_index_pipeline(device, factory=factory, texts=texts,
                                     vecs=vecs[:rows - n_chunks], queries=queries, k=k,
                                     chunk_commit=chunk_commit, vec_commit=vec_commit,
                                     workers=workers)
        swapped = check_answers(path, run["answers"], want)
        held = max(e._slots.high for e in run["engines"])
        if held != rows:
            raise AssertionError(f"{path}: the index holds {held} rows, not {rows}")
        result["rates"][path] = {k_: run[k_] for k_ in ("fill_rows_per_s", "query_ms",
                                                        "idle_share", "seconds")}
        log(f"pw.indexing {path}: {rows} rows ({n_chunks} chunks in commits of "
            f"{chunk_commit}, then vectors in commits of {vec_commit}) at {workers} worker(s)"
            f"{', mesh exchange' if workers > 1 else ''}: {run['fill_rows_per_s']:.1f} rows/s "
            f"filled; {n_queries} answers equal to the direct search ({swapped} ids swapped "
            f"inside near ties); the query tick {run['query_ms']:.3f} ms (host, commit to the "
            f"last answer), idle share {fmt_share(run['idle_share'])}; the run "
            f"{run['seconds']:.1f} s; launches {result['launches'][path]} [{card}]")
        log_query_tick(run, card)
        del run

    # the hybrid: BM25 fused with the brute-force index over the chunks, held against the run's
    # own engine searched directly
    factory = pw.indexing.HybridIndexFactory([
        pw.indexing.TantivyBM25Factory(),
        pw.indexing.BruteForceKnnFactory(dimensions=dim, embedder=emb)])
    with counted("indexing_hybrid", result["launches"]):
        # untraced: the per-chunk embeds (about 100 kernels each) would make a trace of some
        # 1.6 million device events, minutes to read
        run = run_index_pipeline(device, factory=factory, texts=texts[:hybrid_chunks],
                                 vecs=vecs[:0], queries=queries, k=k, chunk_commit=chunk_commit,
                                 vec_commit=vec_commit, workers=1, trace=False)
    direct = run["engines"][0].search(queries, [k] * n_queries, [None] * n_queries)
    for q, rows in enumerate(direct):
        got = list(zip(run["matched"][q], (s for _, s in run["answers"][q])))
        # equal fused scores may come in another order: each score's set of keys must agree
        if sorted(got) != sorted(rows) or [s for _, s in got] != [s for _, s in rows]:
            raise AssertionError("the hybrid's answer differs from HybridEngine.search")
    result["rates"]["indexing_hybrid"] = {k_: run[k_] for k_ in ("fill_rows_per_s", "query_ms",
                                                                 "idle_share", "seconds")}
    log(f"pw.indexing hybrid (BM25 + brute force, RRF k=60): {len(texts[:hybrid_chunks])} "
        f"chunks at 1 worker, "
        f"{run['fill_rows_per_s']:.1f} rows/s filled; {n_queries} answers equal to "
        f"HybridEngine.search; the query tick {run['query_ms']:.3f} ms, idle share "
        f"{fmt_share(run['idle_share'])}; launches {result['launches']['indexing_hybrid']} "
        f"[{card}]")
    log_query_tick(run, card)
    if cuda:
        for path in ("indexing", "indexing_2", "indexing_hybrid"):
            missing = [n for n in ("masked_attention", "knn_topk")
                       if result["launches"][path][n] == 0]
            if missing:
                raise AssertionError(f"{missing} not launched on the {path} path")
    return result


def log_query_tick(run: dict, card: str) -> None:
    if "span_ms" in run:
        log(f"  query tick on the device: {run['span_ms']:.3f} ms between its markers, busy "
            f"{run['busy_ms']:.3f} ms [{card}]")
    for dev_ms, count, name in run.get("top", []):
        log(f"  query tick, device {dev_ms:9.3f} ms  x{count:<5d} {name} [{card}]")


def fmt_share(x: float | None) -> str:
    return "not measured" if x is None else f"{x:.4f}"


# -- phase 12: the RAG serve path over HTTP ------------------------------------------------------


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@functools.cache
def local_opener():
    """A ``urllib`` opener that never goes through a proxy, built once (building one loads the
    TLS certificates, about 25 ms)."""
    import urllib.request

    return urllib.request.build_opener(urllib.request.ProxyHandler({}))


def post_json(port: int, route: str, body: dict, timeout: float = 120.0):
    """One JSON POST to the local server: (status, parsed body)."""
    import urllib.error
    import urllib.request

    opener = local_opener()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{route}",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with opener.open(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"null")


def serve_documents(n_chunks: int, seed: int = 7):
    """Seeded documents of ``make_corpus``'s sentences (the RAG cell's, in order, again from the
    start if they run out), 20 to 79 a document, as bytes in the three formats ``ParseLocal``
    sniffs in turn (plain text, HTML with a title and paragraphs, Markdown with headings), each
    with ``_metadata`` {path, modified_at}, until they split into exactly ``n_chunks`` chunks
    under ``TokenCountSplitter(max_tokens=256)`` (the last document is plain text cut to the
    count). Returns [(bytes, metadata)] and the chunk texts in order."""
    import itertools

    from pathway_tpu_torch.xpacks.llm.parsers import ParseLocal
    from pathway_tpu_torch.xpacks.llm.splitters import TokenCountSplitter

    parser, splitter = ParseLocal(), TokenCountSplitter(max_tokens=256)
    rng = np.random.default_rng(seed)
    stream = itertools.cycle([sent for chunk, _ in make_corpus(16384, 256, seed=1)
                              for sent in re.split(r"(?<=\.)\s+", chunk)])

    def chunks_of(data: bytes) -> list[str]:
        return [c for text, _ in parser.__wrapped__(data) for c, _ in splitter.__wrapped__(text)]

    docs: list = []
    chunks: list[str] = []
    while len(chunks) < n_chunks:
        i = len(docs)
        sentences = list(itertools.islice(stream, int(rng.integers(20, 80))))
        paras = [" ".join(sentences[j:j + 8]) for j in range(0, len(sentences), 8)]
        kind = ("txt", "html", "md")[i % 3]
        if kind == "txt":
            data = " ".join(sentences).encode()
        elif kind == "html":
            data = (f"<!DOCTYPE html><html><head><title>Document {i}</title></head><body>"
                    + "".join(f"<p>{p}</p>" for p in paras) + "</body></html>").encode()
        else:
            data = (f"# Document {i}\n\n" + "\n\n".join(
                (f"## Part {j}\n\n" if j % 2 else "") + p for j, p in enumerate(paras))).encode()
        got = chunks_of(data)
        if len(chunks) + len(got) > n_chunks:  # the last document: plain text, cut to the count
            kind, kept = "txt", []
            for sent in sentences:
                if len(chunks_of(" ".join(kept + [sent]).encode())) > n_chunks - len(chunks):
                    break
                kept.append(sent)
            data = " ".join(kept).encode()
            got = chunks_of(data)
        docs.append((data, {"path": f"docs/{i:05d}.{kind}", "modified_at": i + 1}))
        chunks.extend(got)
    if len(chunks) != n_chunks:
        raise AssertionError(f"the documents split into {len(chunks)} chunks, not {n_chunks}")
    return docs, chunks


def start_server(store, device) -> tuple[object, int]:
    """A ``DocumentStoreServer`` over ``store`` on a free local port, its engine (``pw.run``) on
    a thread of its own."""
    from pathway_tpu_torch.xpacks.llm.servers import DocumentStoreServer

    port = free_port()
    server = DocumentStoreServer("127.0.0.1", port, store)
    server.run(threaded=True, device=device)
    return server, port


def wait_for_count(server, port: int, count: int, deadline_s: float) -> float:
    """Poll ``/v1/statistics`` until it reads ``count`` documents; the host clock at that
    answer."""
    deadline = time.perf_counter() + deadline_s
    while True:
        if server.run_error is not None:
            raise server.run_error
        try:
            status, body = post_json(port, "/v1/statistics", {}, timeout=60)
            if status == 200 and body and body.get("file_count") == count:
                return time.perf_counter()
        except OSError:  # the server is not listening yet
            pass
        if time.perf_counter() > deadline:
            raise AssertionError(f"/v1/statistics did not read {count} documents in {deadline_s} s")
        time.sleep(0.05)


def stop_server(server) -> None:
    """``request_stop()`` and ``terminate_all()``, then the engine thread's join, bounded."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.io.http._server import terminate_all

    pw.request_stop()
    terminate_all()
    server._thread.join(60)
    pw.G.clear()
    if server._thread.is_alive():
        raise AssertionError("the server's engine thread did not stop within 60 s")
    if server.run_error is not None:
        raise server.run_error


def answer_pairs(body: list, ident) -> list:
    """A ``/v1/retrieve`` answer as [(id, score)]: the reply's ``dist`` is the negated score."""
    return [(ident(d), -float(d["dist"])) for d in body]


def run_serve_text(device, embedder, *, n_chunks: int, docs_commit: int, n_queries: int,
                   k: int) -> dict:
    """Leg (a): documents in three formats through ``ParseLocal``, ``TokenCountSplitter`` and the
    embedder into a ``DocumentStore`` served over HTTP; the fill rates, the answers against the
    run's engine searched directly, ``/v1/inputs`` and a glob request."""
    import fnmatch

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.xpacks.llm.document_store import DocumentStore
    from pathway_tpu_torch.xpacks.llm.parsers import ParseLocal
    from pathway_tpu_torch.xpacks.llm.splitters import TokenCountSplitter

    t0 = time.perf_counter()
    docs_in, chunk_texts = serve_documents(n_chunks)
    log(f"serve documents: {len(docs_in)} documents (text, HTML, Markdown) of {n_chunks} chunks "
        f"made in {time.perf_counter() - t0:.1f} s")

    class Docs(pw.io.python.ConnectorSubject):
        def run(self):
            for s in range(0, len(docs_in), docs_commit):
                part = docs_in[s:s + docs_commit]
                self.next_batch({"data": [d for d, _ in part], "_metadata": [m for _, m in part]})
                self.commit()

    pw.G.clear()
    docs = pw.io.python.read(Docs(), schema=pw.schema_from_types(data=bytes, _metadata=dict),
                             autocommit_duration_ms=None)
    store = DocumentStore(docs, pw.indexing.BruteForceKnnFactory(
        dimensions=embedder.embedder.cfg.dim, embedder=embedder.embedder),
        parser=ParseLocal(), splitter=TokenCountSplitter(max_tokens=256))
    engines = keep_engines(store.index)
    texts: dict = {}
    pw.io.subscribe(store.chunked_documents,
                    on_change=lambda key, row, time, is_addition: texts.__setitem__(
                        int(key), row["text"]) if is_addition else None)
    t0 = time.perf_counter()
    server, port = start_server(store, device)
    try:
        filled = wait_for_count(server, port, len(docs_in), 900) - t0
        held = rows_held(engines[0])
        if held != n_chunks or len(texts) != n_chunks:
            raise AssertionError(f"the index holds {held} chunks ({len(texts)} seen), "
                                 f"not {n_chunks}")
        rng = np.random.default_rng(8)
        queries = [chunk_texts[i].split(".")[0] for i in rng.integers(0, n_chunks, n_queries)]
        got = {}
        for q, query in enumerate(queries):
            status, body = post_json(port, "/v1/retrieve", {"query": query, "k": k})
            if status != 200:
                raise AssertionError(f"/v1/retrieve answered {status}: {body}")
            got[q] = answer_pairs(body, lambda d: d["text"])
        direct = engines[0].search(queries, [k] * n_queries, [None] * n_queries)
        want = {q: [(texts[key], score) for key, score in row] for q, row in enumerate(direct)}
        swapped = check_answers("serve text", got, want)
        status, files = post_json(port, "/v1/inputs", {})
        paths = sorted(f["path"] for f in files)
        if status != 200 or paths != sorted(m["path"] for _, m in docs_in):
            raise AssertionError(f"/v1/inputs listed {len(paths)} paths, not the "
                                 f"{len(docs_in)} documents")
        glob = "docs/*.html"
        status, body = post_json(port, "/v1/retrieve", {"query": queries[0], "k": k,
                                                        "filepath_globpattern": glob})
        if status != 200 or not body or not all(
                fnmatch.fnmatch(d["metadata"]["path"], glob) for d in body):
            raise AssertionError(f"the glob request's answer is outside {glob!r}: {body}")
    finally:
        stop_server(server)
    return {"docs_per_s": len(docs_in) / filled, "chunks_per_s": n_chunks / filled,
            "n_docs": len(docs_in), "swapped": swapped, "glob_answers": len(body)}


def run_serve_rows(device, embedder, *, n_rows: int, feed_commit: int, requests: int,
                   warmup: int, k: int) -> dict:
    """Leg (b), as the reference's bench measures its serve p50 (``bench.py``, ``_doc_server``
    and ``_rest_rag_point``): seeded unit vectors in the store's pre-embedded mode, then
    ``requests`` retrievals of which the first ``warmup`` are not timed, the framework's share
    (``/v1/statistics``), one query's embed, a traced request, a filtered one timed apart."""
    import fnmatch

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.models.embedder import Embedder
    from pathway_tpu_torch.ops.knn import topk_scores_plain
    from pathway_tpu_torch.xpacks.llm.document_store import DocumentStore

    cuda = device.type == "cuda"
    emb = embedder.embedder
    dim = emb.cfg.dim
    rng = np.random.default_rng(3)
    vecs = rng.standard_normal((n_rows, dim), dtype=np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)

    class DocFeed(pw.io.python.ConnectorSubject):
        def run(self):
            for start in range(0, n_rows, feed_commit):
                stop = min(start + feed_commit, n_rows)
                self.next_batch({
                    "data": [f"doc {i} on topic {i % 29} covering dataflow shard {i % 7}"
                             for i in range(start, stop)],
                    "_metadata": [{"path": f"d{i}.txt"} for i in range(start, stop)],
                    "vec": list(vecs[start:stop]),
                })
                self.commit()

    pw.G.clear()
    docs = pw.io.python.read(DocFeed(), schema=pw.schema_from_types(
        data=str, _metadata=dict, vec=np.ndarray), autocommit_duration_ms=None)
    store = DocumentStore(docs, pw.indexing.BruteForceKnnFactory(
        dimensions=dim, reserved_space=n_rows, embedder=emb), vector_column="vec")
    wrappers = launch_counters()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    server, port = start_server(store, device)
    out: dict = {}
    try:
        out["fill_rows_per_s"] = n_rows / (wait_for_count(server, port, n_rows, 1200) - t0)

        def retrieve(i: int, **extra):
            t = time.perf_counter()
            status, body = post_json(port, "/v1/retrieve",
                                     {"query": f"dataflow shard topic {i % 13}", "k": k, **extra})
            ms = (time.perf_counter() - t) * 1e3
            if status != 200 or len(body) != k:
                raise AssertionError(f"/v1/retrieve answered {status} with {body}")
            return ms, body

        lat, bodies = [], {}
        for i in range(warmup):  # the first copies the index to the device
            ms, _ = retrieve(i)
            if i == 0:
                out["first_ms"] = ms
        before = {name: fn.launches for name, fn in wrappers.items()}
        for i in range(warmup, requests):
            ms, body = retrieve(i)
            lat.append(ms)
            if len(bodies) < 8:
                bodies[i] = body
        out["per_request"] = {name: (fn.launches - before[name]) / len(lat)
                              for name, fn in wrappers.items()}
        fw = []
        for i in range(16):
            t = time.perf_counter()
            status, _ = post_json(port, "/v1/statistics", {})
            if i >= 2:
                fw.append((time.perf_counter() - t) * 1e3)
        embedder.embed_batch(["warm the query bucket"])
        embeds = []
        for i in range(7):
            t = time.perf_counter()
            embedder.embed_batch([f"dataflow shard topic {i}"])  # returns numpy: synchronised
            embeds.append((time.perf_counter() - t) * 1e3)
        out.update(p50=float(np.percentile(lat, 50)), p95=float(np.percentile(lat, 95)),
                   p99=float(np.percentile(lat, 99)), framework_ms=float(np.percentile(fw, 50)),
                   embed_ms=float(np.median(embeds)), lat=lat)
        out["index_ms"] = max(out["p50"] - out["framework_ms"] - out["embed_ms"], 0.0)

        # 8 answers against a direct search over the fed vectors, normalised as the cos metric
        # normalises them, with the plain scorer; each query's embedding, one a forward as the
        # server embeds it, held against the host encoder's (the plain attention) on the same
        # params
        fed = vecs.copy()
        fed /= np.linalg.norm(fed, axis=1, keepdims=True)
        index = torch.from_numpy(fed).to(device)
        del fed
        host = Embedder(emb.cfg, params=emb.params, device="cpu")
        got, want, emb_err, emb_cos = {}, {}, 0.0, 1.0
        for i, body in bodies.items():
            text = f"dataflow shard topic {i % 13}"
            q = emb.embed_texts_device([text], max_len=embedder.max_len).float()
            on_host = torch.from_numpy(host.embed_texts([text], max_len=embedder.max_len))
            emb_err = max(emb_err, (q.cpu() - on_host).abs().max().item())
            emb_cos = min(emb_cos, (q.cpu() * on_host).sum().item())
            s, ids = topk_scores_plain(q, index, k)
            want[i] = list(zip(ids[0].tolist(), s[0].tolist()))
            got[i] = answer_pairs(body, lambda d: int(d["metadata"]["path"][1:-4]))
        del index, host
        out.update(emb_err=emb_err, emb_cos=emb_cos)
        if not (emb_err <= EMB_ATOL and emb_cos >= EMB_MIN_COS):
            raise AssertionError(f"the served queries' embeddings disagree with the host's: max "
                                 f"|err| {emb_err:.3e}, min cosine {emb_cos:.6f}")
        out["swapped"] = check_answers("serve", got, want)

        if cuda:  # one request on the device's timeline, between two marker kernels
            acts = [torch.profiler.ProfilerActivity.CUDA]
            for _ in range(3):  # the tracer sometimes loses a session's events: up to 3
                with torch.profiler.profile(activities=acts) as prof:
                    torch.cuda._sleep(1000)
                    retrieve(requests)
                    torch.cuda._sleep(1000)
                    torch.cuda.synchronize()
                traced = query_tick_device(prof)
                if traced:
                    out.update(traced)
                    break
            out["peak_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
        glob = "d7*.txt"
        out["filtered_ms"], body = retrieve(0, filepath_globpattern=glob)
        if not all(fnmatch.fnmatch(d["metadata"]["path"], glob) for d in body):
            raise AssertionError(f"the filtered request's answer is outside {glob!r}: {body}")
    finally:
        stop_server(server)
    return out


def run_serve(device, *, n_chunks: int = 4096, docs_commit: int = 256, n_rows: int = 1 << 20,
              feed_commit: int = 100_000, n_queries: int = 16, requests: int = 104,
              warmup: int = 4, cfg=None) -> dict:
    """The phase; sizes as the defaults say on the card (a CPU rehearsal passes small ones and a
    small encoder). Returns each leg's launch counts, rates and times."""
    from pathway_tpu_torch.models.embedder import Embedder
    from pathway_tpu_torch.xpacks.llm.embedders import TorchEmbedder

    cuda = device.type == "cuda"
    card = card_line() if cuda else "cpu"
    launches: dict = {}

    def embedder(**kw):
        return TorchEmbedder(None if cfg is None else Embedder(cfg, seed=0, device=device),
                             device=device, **kw)

    with scoped_env({"PATHWAY_THREADS": "1", "PATHWAY_MESH_EXCHANGE": "0"}):
        with counted("serve_text", launches):
            text = run_serve_text(device, embedder(), n_chunks=n_chunks,
                                  docs_commit=docs_commit, n_queries=n_queries, k=10)
        log(f"serve, text leg: {text['n_docs']} documents of {n_chunks} chunks through "
            f"ParseLocal, TokenCountSplitter(max_tokens=256) and the encoder into DocumentStore: "
            f"{text['docs_per_s']:.1f} documents/s, {text['chunks_per_s']:.1f} chunks/s (run "
            f"start to /v1/statistics reading every document); {n_queries} /v1/retrieve answers "
            f"(k=10) equal to the run's engine searched directly ({text['swapped']} texts "
            f"swapped inside near ties); /v1/inputs lists every path; a glob request's "
            f"{text['glob_answers']} answers all match; launches {launches['serve_text']} "
            f"[{card}]")
        if cuda:
            torch.cuda.empty_cache()
        with counted("serve", launches):
            rows = run_serve_rows(device, embedder(max_len=32), n_rows=n_rows,
                                  feed_commit=feed_commit, requests=requests, warmup=warmup,
                                  k=3)
    per = {name: n for name, n in rows["per_request"].items() if n}
    log(f"serve, {n_rows} pre-embedded rows in commits of {feed_commit}: filled at "
        f"{rows['fill_rows_per_s']:.1f} rows/s; the first request {rows['first_ms']:.3f} ms "
        f"(it copies the index to the device) [{card}]")
    log(f"serve: /v1/retrieve p50 {rows['p50']:.3f} ms, p95 {rows['p95']:.3f} ms, p99 "
        f"{rows['p99']:.3f} ms over {requests - warmup} requests (host clock, k=3; the north "
        f"star: p50 < 50 ms); framework_ms {rows['framework_ms']:.3f} (p50 of /v1/statistics), "
        f"embed_ms {rows['embed_ms']:.3f} (one query, synchronised), index_ms "
        f"{rows['index_ms']:.3f} (the remainder) [{card}]")
    log(f"serve: 8 answers equal to the plain scorer over the fed vectors ({rows['swapped']} ids "
        f"swapped inside near ties); their queries embedded one a forward against the host "
        f"encoder: max |err| {rows['emb_err']:.3e} (atol {EMB_ATOL}), min cosine "
        f"{rows['emb_cos']:.6f} (at least {EMB_MIN_COS}); launches per request {per}; a filtered request "
        f"(filepath_globpattern) {rows['filtered_ms']:.3f} ms, untimed in the 100 [{card}]")
    if cuda:
        log(f"serve: one request on the device: idle share {fmt_share(rows.get('idle_share'))}; "
            f"peak device memory {rows['peak_gb']:.3f} GiB [{card}]")
        log_query_tick(rows, card)
        for path in ("serve_text", "serve"):
            missing = [n for n in ("masked_attention", "knn_topk") if launches[path][n] == 0]
            if missing:
                raise AssertionError(f"{missing} not launched on the {path} path")
        if not (rows["per_request"]["masked_attention"] and rows["per_request"]["knn_topk"]):
            raise AssertionError(f"a kernel of the serve path was not launched per request: "
                                 f"{rows['per_request']}")
    return {"launches": launches, "text": text, "rows": rows}


# -- phase 13: the file connectors, the delivery-managed writers and the example -----------------


LANE_KINDS = ("csv", "jsonlines", "plaintext")


def write_lane_file(kind: str, n_rows: int, d: str) -> str:
    """The reference bench's ingest lane file (``bench.py``, ``_INGEST_CONNECTOR_PROG``): rows
    ``word = w{i % 997}``, ``x = i``, as csv with a header, jsonlines or plaintext (words only)."""
    path = os.path.join(d, f"{kind}.in")
    words = [f"w{i % 997}" for i in range(n_rows)]
    with open(path, "w") as f:
        if kind == "csv":
            f.write("word,x\n")
            f.writelines(f"{w},{i}\n" for i, w in enumerate(words))
        elif kind == "jsonlines":
            f.writelines('{"word": "%s", "x": %d}\n' % (w, i) for i, w in enumerate(words))
        else:
            f.writelines(w + "\n" for w in words)
    return path


def net_table(seen: list, names: list) -> tuple:
    """A subscribed stream of (keys, diffs, columns) batches as its net table: each row key once,
    in key order, with its summed diff and its columns."""
    keys = np.concatenate([k for k, _, _ in seen])
    diffs = np.concatenate([d for _, d, _ in seen])
    order = np.argsort(keys, kind="stable")
    keys, diffs = keys[order], diffs[order]
    starts = np.flatnonzero(np.r_[True, keys[1:] != keys[:-1]])
    cols = {c: np.concatenate([b[c] for _, _, b in seen])[order][starts] for c in names}
    return keys[starts], np.add.reduceat(diffs, starts), cols


def read_lane(device, kind: str, path: str, n_rows: int, columnar: bool) -> tuple[dict, tuple]:
    """``pw.io.fs.read(mode="streaming", autocommit_duration_ms=25)`` of a lane file through
    ``pw.run(device=...)``, counted by ``on_batch`` until every row arrived (duplicate content
    keys consolidate, so rows are the positive-diff sum); ``columnar`` sets
    ``PATHWAY_INGEST_COLUMNAR``. Returns its rows/s and the
    parse/hash/delta split of ``INGEST_CONNECTOR_STATS``, and its net table."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.io.python import INGEST_CONNECTOR_STATS

    names = ["data"] if kind == "plaintext" else ["word", "x"]
    schema = pw.schema_from_types(**({"data": str} if kind == "plaintext" else
                                     {"word": str, "x": int}))
    INGEST_CONNECTOR_STATS.clear()
    pw.G.clear()
    t = pw.io.fs.read(path, format=kind, schema=schema, mode="streaming",
                      autocommit_duration_ms=25)
    total, seen = {"n": 0}, []

    def on_batch(time_, b):
        seen.append((b.keys, b.diffs, {c: b.data[c] for c in names}))
        total["n"] += int(b.diffs[b.diffs > 0].sum())
        if total["n"] >= n_rows:
            pw.request_stop()

    pw.io.subscribe(t, on_batch=on_batch)
    env = {"PATHWAY_INGEST_COLUMNAR": "1" if columnar else "0", "PATHWAY_PROFILE": "1",
           "PATHWAY_THREADS": "1", "PATHWAY_MESH_EXCHANGE": "0"}
    with scoped_env(env):
        try:
            t0 = time.perf_counter()
            pw.run(device=device)
            sec = time.perf_counter() - t0
        finally:
            pw.G.clear()
    if total["n"] != n_rows:
        raise AssertionError(f"lane {kind}: {total['n']} rows counted, not {n_rows}")
    s = INGEST_CONNECTOR_STATS[f"fs-{kind}"]
    split = {f"{st}_s": s[f"{st}_ns"] / 1e9 for st in ("parse", "hash", "delta")}
    return {"rows_per_s": n_rows / sec, "seconds": sec, "rows": s["rows"], **split}, \
        net_table(seen, names)


def run_file_wordcount(device, path: str, n_rows: int, workers: int, out_csv: str) -> tuple:
    """The reference bench's ``_WORDCOUNT_FILE_PROG`` (``bench.py``): a plaintext file read in
    streaming, ``groupby(data).reduce(count)``, counted until every row arrived; the counts also
    written with ``pw.io.csv.write``. At ``workers`` > 1 with ``PATHWAY_MESH_EXCHANGE=1``.
    Returns (word -> its last count in the subscribed stream, seconds of the run)."""
    import pathway_tpu_torch as pw

    pw.G.clear()
    t = pw.io.fs.read(path, format="plaintext", schema=pw.schema_from_types(data=str),
                      mode="streaming", autocommit_duration_ms=25)
    counts = t.groupby(pw.this.data).reduce(pw.this.data, c=pw.reducers.count())
    total, seen = {"n": 0}, []

    def on_raw(time_, b):
        total["n"] += int(b.diffs[b.diffs > 0].sum())
        if total["n"] >= n_rows:
            pw.request_stop()

    pw.io.subscribe(t, on_batch=on_raw)
    pw.io.subscribe(counts, on_batch=lambda tm, b: seen.append(
        (b.keys, b.diffs, {"data": b.data["data"], "c": b.data["c"]})))
    pw.io.csv.write(counts, out_csv)
    env = {"PATHWAY_THREADS": str(workers), "PATHWAY_MESH_EXCHANGE": "1" if workers > 1 else "0",
           "PATHWAY_INGEST_COLUMNAR": "1"}
    with scoped_env(env):
        try:
            t0 = time.perf_counter()
            pw.run(device=device)
            sec = time.perf_counter() - t0
        finally:
            pw.G.clear()
    if total["n"] != n_rows:
        raise AssertionError(f"file wordcount: {total['n']} rows counted, not {n_rows}")
    final: dict = {}
    for _keys, diffs, cols in seen:  # batches arrive in time order
        for w, c in zip(cols["data"][diffs > 0].tolist(), cols["c"][diffs > 0].tolist()):
            final[w] = c
    _keys, net, cols = net_table(seen, ["data"])
    if (net != 1).any() or sorted(cols["data"].tolist()) != sorted(final):
        raise AssertionError("file wordcount: the subscribed stream does not net one row a word")
    return final, sec


def read_written_counts(path: str) -> dict:
    """The last inserted count per word of a ``pw.io.csv.write`` output (``data,c,time,diff``)."""
    import csv

    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    if rows[0] != ["data", "c", "time", "diff"]:
        raise AssertionError(f"the written csv's header is {rows[0]}")
    last: dict = {}
    for w, c, t, d in sorted(rows[1:], key=lambda r: int(r[2])):  # stable: by time
        if int(d) > 0:
            last[w] = int(c)
    return last


def running_executor0():
    """Worker 0's executor of the running ``pw.run`` (its only one at 1 worker), or None while
    a sharded run builds its executors."""
    from pathway_tpu_torch.internals import run

    runner = run._current["runner"]
    peers = getattr(runner, "_peer_executors", None)
    return peers[0] if peers else getattr(runner, "executor", None)


def running_engines() -> list:
    """The index engines of the running ``pw.run``: each ``ExternalIndexNode``'s on worker 0,
    which holds the index under any worker count."""
    from pathway_tpu_torch.engine.external_index import ExternalIndexNode

    ex = running_executor0()
    nodes = ex.nodes if ex is not None else []
    return [n.engine for n in nodes if isinstance(n, ExternalIndexNode)]


def run_files_example(device, embedder, *, n_chunks: int, requests: int, warmup: int,
                      k: int, n_checked: int = 8) -> dict:
    """The north star's example as a user runs it: ``serve_documents``' documents written as files
    into a directory, served by ``examples/rag_server/serve.py``'s ``build_server``; the fill
    rate until ``/v1/statistics`` reads every document, ``requests`` retrievals of which the first
    ``warmup`` are untimed, the launches per request, ``n_checked`` answers against the store's
    engine searched directly, and ``/v1/inputs`` (every ``_metadata`` is ``{}``: the binary read
    is static in both packages)."""
    import tempfile

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.examples.rag_server import serve

    docs_in, chunk_texts = serve_documents(n_chunks)
    out: dict = {"n_docs": len(docs_in)}
    with tempfile.TemporaryDirectory(prefix="rag_docs_") as d:
        for data, meta in docs_in:
            with open(os.path.join(d, os.path.basename(meta["path"])), "wb") as f:
                f.write(data)
        pw.G.clear()
        port = free_port()
        t0 = time.perf_counter()
        server = serve.build_server(d, "127.0.0.1", port, 256, device, embedder=embedder)
        store = server.document_store
        if store.docs.column_names() != ["data"]:
            raise AssertionError(f"the example's table has {store.docs.column_names()}")
        texts: dict = {}
        pw.io.subscribe(store.chunked_documents,
                        on_change=lambda key, row, time, is_addition: texts.__setitem__(
                            int(key), row["text"]) if is_addition else None)
        server.run(threaded=True, device=device)
        try:
            filled = wait_for_count(server, port, len(docs_in), 900) - t0
            engines = running_engines()
            if len(engines) != 1:
                raise AssertionError(f"the run holds {len(engines)} index engines, not 1")
            held = rows_held(engines[0])
            if held != n_chunks or len(texts) != n_chunks:
                raise AssertionError(f"the index holds {held} chunks ({len(texts)} seen), "
                                     f"not {n_chunks}")
            out.update(docs_per_s=len(docs_in) / filled, chunks_per_s=n_chunks / filled,
                       fill_s=filled)
            rng = np.random.default_rng(9)
            queries = [chunk_texts[i].split(".")[0] for i in rng.integers(0, n_chunks, requests)]
            wrappers = launch_counters()
            lat, bodies = [], {}
            for i, query in enumerate(queries):
                if i == warmup:
                    before = {name: fn.launches for name, fn in wrappers.items()}
                t = time.perf_counter()
                status, body = post_json(port, "/v1/retrieve", {"query": query, "k": k})
                ms = (time.perf_counter() - t) * 1e3
                if status != 200 or len(body) != k:
                    raise AssertionError(f"/v1/retrieve answered {status} with {body}")
                if i >= warmup:
                    lat.append(ms)
                    if len(bodies) < n_checked:
                        bodies[i] = body
            out["per_request"] = {name: (fn.launches - before[name]) / len(lat)
                                  for name, fn in wrappers.items()}
            out.update(p50=float(np.percentile(lat, 50)), p95=float(np.percentile(lat, 95)),
                       p99=float(np.percentile(lat, 99)), n_timed=len(lat))
            got = {i: answer_pairs(body, lambda x: x["text"]) for i, body in bodies.items()}
            direct = engines[0].search([queries[i] for i in bodies], [k] * len(bodies),
                                       [None] * len(bodies))
            want = {i: [(texts[key], score) for key, score in row]
                    for i, row in zip(bodies, direct)}
            out["swapped"] = check_answers("files example", got, want)
            status, files = post_json(port, "/v1/inputs", {})
            if status != 200 or files != [{"path": None}] * len(docs_in):
                raise AssertionError(f"/v1/inputs answered {status} with {len(files)} entries, "
                                     f"not the reference's {len(docs_in)} of {{'path': None}}")
        finally:
            stop_server(server)
    return out


def run_files(device, *, lane_rows: int = 200_000, wc_rows: int = 300_000, n_chunks: int = 16384,
              requests: int = 104, warmup: int = 4, cfg=None) -> dict:
    """The phase; sizes as the defaults say on the card (a CPU rehearsal passes small ones and a
    small encoder). Returns each path's launch counts, rates and times."""
    import tempfile

    from pathway_tpu_torch.models.embedder import Embedder
    from pathway_tpu_torch.xpacks.llm.embedders import TorchEmbedder

    cuda = device.type == "cuda"
    card = card_line() if cuda else "cpu"
    result: dict = {"launches": {}, "lanes": {}, "wordcount": {}}
    with tempfile.TemporaryDirectory(prefix="files_phase_") as d:
        for kind in LANE_KINDS:
            path = write_lane_file(kind, lane_rows, d)
            tables = {}
            for arm, columnar in (("columnar", True), ("rows", False)):
                with counted(f"files_{kind}_{arm}", result["launches"]):
                    lane, tables[arm] = read_lane(device, kind, path, lane_rows, columnar)
                result["lanes"][(kind, arm)] = lane
                rates = {st: (lane["rows"] / lane[f"{st}_s"] if lane[f"{st}_s"] else None)
                         for st in ("parse", "hash", "delta")}
                log(f"files, lane {kind} ({arm} parse, PATHWAY_INGEST_COLUMNAR={int(columnar)}): "
                    f"{lane_rows} rows "
                    f"counted, {lane['rows_per_s']:.1f} rows/s; parse {lane['parse_s']:.4f} s, "
                    f"hash {lane['hash_s']:.4f} s, delta {lane['delta_s']:.4f} s (rows/s alone: "
                    + ", ".join(f"{st} {r:.1f}" if r else f"{st} -" for st, r in rates.items())
                    + f") [{card}]")
            k0, n0, c0 = tables["rows"]
            for arm, (k1, n1, c1) in tables.items():
                if not (np.array_equal(k1, k0) and np.array_equal(n1, n0)
                        and all(np.array_equal(c1[c], c0[c]) for c in c1)):
                    raise AssertionError(f"lane {kind}: the {arm} and per-row tables differ")
            log(f"files, lane {kind}: the {', '.join(tables)} tables equal ({len(k0)} row ids, "
                f"ids, diffs and values)")

        words = [f"w{i % 997}" for i in range(wc_rows)]
        want = dict(collections.Counter(words))
        path = os.path.join(d, "words.txt")
        with open(path, "w") as f:
            f.writelines(w + "\n" for w in words)
        for workers in (1, 2):
            label = f"files_wordcount_{workers}"
            out_csv = os.path.join(d, f"counts_{workers}.csv")
            with counted(label, result["launches"]):
                got, sec = run_file_wordcount(device, path, wc_rows, workers, out_csv)
            if got != want:
                raise AssertionError(f"{label}: the counts differ from collections.Counter")
            if read_written_counts(out_csv) != want:
                raise AssertionError(f"{label}: the csv.write output differs from the Counter")
            result["wordcount"][workers] = wc_rows / sec
            log(f"files, wordcount from a file at {workers} worker(s)"
                f"{' with PATHWAY_MESH_EXCHANGE=1' if workers > 1 else ''}: {wc_rows} rows, "
                f"{len(want)} words equal to collections.Counter, and so is pw.io.csv.write's "
                f"output read back; {wc_rows / sec:.1f} rows/s; launches "
                f"{ {n: c for n, c in result['launches'][label].items() if c} } [{card}]")

    def embedder():
        return TorchEmbedder(None if cfg is None else Embedder(cfg, seed=0, device=device),
                             device=device)

    with scoped_env({"PATHWAY_THREADS": "1", "PATHWAY_MESH_EXCHANGE": "0"}):
        with counted("files_example", result["launches"]):
            ex = run_files_example(device, embedder(), n_chunks=n_chunks, requests=requests,
                                   warmup=warmup, k=3)
    result["example"] = ex
    per = {name: n for name, n in ex["per_request"].items() if n}
    log(f"files, the example (examples/rag_server/serve.py on the port) over {ex['n_docs']} "
        f"document files of {n_chunks} chunks: {ex['docs_per_s']:.1f} documents/s, "
        f"{ex['chunks_per_s']:.1f} chunks/s ({ex['fill_s']:.1f} s from build_server to "
        f"/v1/statistics reading every document) [{card}]")
    log(f"files, the example: /v1/retrieve p50 {ex['p50']:.3f} ms, p95 {ex['p95']:.3f} ms, p99 "
        f"{ex['p99']:.3f} ms over {ex['n_timed']} requests (host clock, k=3, {warmup} untimed); "
        f"launches per request {per}; 8 answers equal to the store's engine searched directly "
        f"({ex['swapped']} texts swapped inside near ties); /v1/inputs as the reference's "
        f"[{card}]")
    if cuda:
        if ex["per_request"]["masked_attention"] != 6 or ex["per_request"]["knn_topk"] != 1:
            raise AssertionError(f"the example's requests launched {per}, not 6 masked_attention "
                                 f"and 1 knn_topk each")
        if not result["launches"]["files_wordcount_2"]["bucket_exchange"]:
            raise AssertionError("bucket_exchange was not launched on the 2-worker file wordcount")
        missing = [n for n in ("masked_attention", "knn_topk")
                   if not result["launches"]["files_example"][n]]
        if missing:
            raise AssertionError(f"{missing} not launched on the example's path")
    return result



# -- phase 14: persistence and recovery ----------------------------------------------------------


#: phase 14 (a)'s rows: the first 262,144 of phase 11's (its 2-worker run's rows, whose direct
#: answers phase 11 computed). At all 1,048,576, (a)'s two legs took 146 s on an H100 machine,
#: past the 120 s it may take, most of it its commits' pickling (PERF.md section 4;
#: ``scripts/torch_persistence_phase.py`` runs it at any size)
PERSIST_ROWS = 1 << 18


def dir_bytes(path: str) -> int:
    """The bytes of every file under ``path``."""
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def newest_meta(store: str) -> dict | None:
    """The newest committed metadata of a one-worker filesystem store (``meta/meta-*``)."""
    d = os.path.join(store, "meta")
    names = sorted(n for n in os.listdir(d) if n.startswith("meta-") and ".tmp" not in n) \
        if os.path.isdir(d) else []
    for name in reversed(names):
        try:
            with open(os.path.join(d, name)) as f:
                return json.load(f)
        except (OSError, ValueError):
            continue
    return None


def persisted_index_graph(pw, emb, *, texts, vecs, queries, k: int, chunk_commit: int,
                          vec_commit: int, ask: bool, device, marks: dict,
                          fed_path: str | None = None, queries_name: str = "queries",
                          qid_base: int = 0, after_ask=None) -> dict:
    """Phase 11's index as a persisted program: the chunk texts then the vectors, each commit
    sent once the index holds the ones before it, through a python source named ``rows`` into
    ``DataIndex`` over ``BruteForceKnnFactory(dimensions,
    reserved_space=rows)``; a second source named ``queries`` that, with ``ask``, sends the text
    queries in one commit once the running index holds every row (marking the query tick on the
    device with a spin kernel, as phase 11 does), and without ``ask`` sends nothing and never
    finishes (the first leg runs until it is killed; it creates ``fed_path`` once its feed is
    sent); ``queries_name`` names that source and ``qid_base`` offsets its query ids (a later
    program over the same store asks its queries anew under another name, past the offset the
    first one persisted, and with other ids, so other row keys); ``after_ask``, when given, runs
    in the queries' source after it sends them (the source, and so the run, ends when it
    returns). Returns the
    answers by query id, filled as they arrive; ``marks`` gets the host times and worker 0's
    running persistence manager."""
    cuda = device.type == "cuda"
    n_rows = len(texts) + len(vecs)

    def paced(upto: int) -> None:
        # each commit is sent once the running index holds the rows before it: a poll cycle
        # then brings one commit, so a snapshot can land between any two
        deadline = _wall() + 600
        while not running_engines() or rows_held(running_engines()[0]) < upto:
            if _wall() > deadline:
                raise AssertionError(f"the index did not take {upto} rows within 600 s")
            time.sleep(0.002)

    class Rows(pw.io.python.ConnectorSubject):
        def run(self):
            for s in range(0, len(texts), chunk_commit):
                part = texts[s:s + chunk_commit]
                paced(s)
                self.next_batch({"rid": list(range(s, s + len(part))), "data": part})
                self.commit()
            for s in range(0, len(vecs), vec_commit):
                part = vecs[s:s + vec_commit]
                start = len(texts) + s
                paced(start)
                self.next_batch({"rid": list(range(start, start + len(part))),
                                 "data": list(part)})
                self.commit()
            if fed_path is not None:
                open(fed_path, "w").close()

    class Queries(pw.io.python.ConnectorSubject):
        def run(self):
            marks["manager"] = running_executor0().persistence
            if not ask:
                time.sleep(900)  # killed long before; a leg left running fails its parent
                raise AssertionError("the first leg was not killed within 900 s")
            deadline = _wall() + 1200
            while not running_engines() or rows_held(running_engines()[0]) < n_rows:
                if _wall() > deadline:
                    raise AssertionError("the index did not take every row within 1200 s")
                time.sleep(0.005)
            marks["filled"] = _wall()
            if cuda:
                torch.cuda._sleep(1000)  # the query tick's start on the device's timeline
            marks["query"] = _wall()
            self.next_batch({"qid": list(range(qid_base, qid_base + len(queries))),
                             "q": list(queries)})
            self.commit()
            if after_ask is not None:
                after_ask()

    answers: dict = {}

    def on_answer(key, row, time, is_addition):
        if is_addition:
            answers[row["qid"] - qid_base] = list(zip((int(r) for r in row["rid"]),
                                           (float(s) for s in row["score"])))
            if len(answers) == len(queries):
                marks["answered"] = _wall()
                if cuda:
                    torch.cuda._sleep(1000)  # the query tick's end

    pw.G.clear()
    data = pw.io.python.read(Rows(), schema=pw.schema_from_types(rid=int, data=object),
                             autocommit_duration_ms=None, name="rows")
    qt = pw.io.python.read(Queries(), schema=pw.schema_from_types(qid=int, q=str),
                           autocommit_duration_ms=None, name=queries_name)
    factory = pw.indexing.BruteForceKnnFactory(dimensions=emb.cfg.dim, reserved_space=n_rows,
                                               embedder=emb)
    index = factory.build_index(data.data, data)
    res = index.query_as_of_now(qt.q, number_of_matches=k).select(
        qid=pw.left.qid, rid=pw.right.rid, score=pw.right._pw_index_reply_score)
    pw.io.subscribe(res, on_change=on_answer)
    return answers


def persist_leg(args: dict) -> int:
    """The first leg of phase 14 (a), in a child interpreter: the persisted index program run
    until its parent SIGKILLs it. Each commit's time, phase split, bytes and source offsets go
    to ``args["commit_log"]`` as it lands."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.models.embedder import Embedder, EmbedderConfig
    from pathway_tpu_torch.persistence import Backend, Config, PersistenceManager

    device = torch.device(args["device"])
    cfg = None
    if args["cfg"] is not None:
        cfg = EmbedderConfig(**{**args["cfg"], "dtype": getattr(torch, args["cfg"]["dtype"])})
    emb = Embedder(cfg, seed=0, device=device)
    with open(args["texts"]) as f:
        texts = json.load(f)
    vecs = np.load(args["vecs"])
    commit = PersistenceManager.commit

    def logged(self, time_, **kw):
        commit(self, time_, **kw)
        with open(args["commit_log"], "a") as f:
            f.write(json.dumps({**self.commit_log[-1], "offsets": self.offsets}) + "\n")

    PersistenceManager.commit = logged
    log(f"persistence leg 1 (pid {os.getpid()}): {len(texts)} chunks and {len(vecs)} vectors, "
        f"snapshot_interval_ms={args['interval_ms']}")
    persisted_index_graph(pw, emb, texts=texts, vecs=vecs, queries=[], k=1,
                          chunk_commit=args["chunk_commit"], vec_commit=args["vec_commit"],
                          ask=False, device=device, marks={}, fed_path=args["fed"])
    pw.run(device=device, persistence_config=Config.simple_config(
        Backend.filesystem(args["store"]), snapshot_interval_ms=args["interval_ms"]))
    return 3  # the leg ran to an end instead of being killed


def read_commit_log(path: str) -> list:
    """The first leg's commits as its child logged them (a line torn by the kill is dropped)."""
    out = []
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                try:
                    out.append(json.loads(line))
                except ValueError:
                    pass
    return out


def commit_lines(entries: list) -> list:
    """One line a commit: its bytes and phase split, the rows it covers, and its largest parts
    (the input flush, an operator's snapshot) with their ms and MiB."""
    return [f"t={e['time']} {e['bytes'] / 2**20:.1f} MiB, barrier "
            f"{e['ns']['barrier'] / 1e6:.1f} ms, snapshot {e['ns']['snapshot'] / 1e6:.1f} ms, "
            f"release {e['ns']['release'] / 1e6:.1f} ms"
            + (f", {e['offsets']['rows']['rows']} rows covered" if 'offsets' in e else "")
            + "; " + ", ".join(f"{p['what']} {p['ns'] / 1e6:.1f} ms {p['bytes'] / 2**20:.1f} MiB"
                               for p in sorted(e["parts"], key=lambda p: -p["ns"])[:4])
            for e in entries]


def run_persisted_index(device, emb, cfg, *, texts, vecs, queries, want, k: int,
                        chunk_commit: int, vec_commit: int, kill_rows: int, interval_ms: int,
                        work: str) -> dict:
    """Phase 14 (a): the persisted index killed by SIGKILL in a child once its metadata covers
    ``kill_rows`` rows, then restored in this process with the whole feed and queried."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.persistence import Backend, Config

    cuda = device.type == "cuda"
    n_rows = len(texts) + len(vecs)
    store = os.path.join(work, "store")
    args = {"device": str(device), "store": store, "texts": os.path.join(work, "texts.json"),
            "vecs": os.path.join(work, "vecs.npy"), "commit_log": os.path.join(work, "log.jsonl"),
            "fed": os.path.join(work, "fed"),
            "interval_ms": interval_ms, "chunk_commit": chunk_commit, "vec_commit": vec_commit,
            "cfg": None if cfg is None else {**cfg.__dict__, "dtype": str(cfg.dtype).split(".")[-1]}}
    with open(args["texts"], "w") as f:
        json.dump(texts, f)
    np.save(args["vecs"], vecs)
    if cuda:
        torch.cuda.empty_cache()
    out: dict = {}
    t0 = time.perf_counter()
    # exec, never fork, once CUDA is up: the child is a fresh interpreter
    child = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--persist-leg",
                              json.dumps(args)])
    try:
        covered, fed_at = 0, None
        while covered < kill_rows:
            if child.poll() is not None:
                raise AssertionError(f"leg 1 exited with {child.returncode} before a commit "
                                     f"covered {kill_rows} rows")
            if fed_at is None and os.path.exists(args["fed"]):
                fed_at = time.perf_counter()
            # once the feed is sent, ticks (and so commits) stop when the engine catches up
            if fed_at is not None and time.perf_counter() - fed_at > 60 + 3 * interval_ms / 1e3:
                raise AssertionError(f"the feed ended and no commit covered {kill_rows} rows: "
                                     f"snapshot_interval_ms={interval_ms} is too long for it")
            meta = newest_meta(store)
            # kill once the covering commit has returned (its log entry written), so the log
            # holds every commit the store does
            if meta and meta["offsets"].get("rows", {}).get("rows", 0) >= kill_rows:
                covered = max([e["offsets"].get("rows", {}).get("rows", 0)
                               for e in read_commit_log(args["commit_log"])] or [0])
            time.sleep(0.05)
        child.send_signal(signal.SIGKILL)
        child.wait(60)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(60)
    out["leg1_s"] = time.perf_counter() - t0
    out["killed_covered"] = covered
    out["store_bytes"] = dir_bytes(store)
    out["leg1_commits"] = read_commit_log(args["commit_log"])
    for name in ("texts", "vecs"):
        os.remove(args[name])
    if len(out["leg1_commits"]) < 2:
        raise AssertionError(f"leg 1 committed {len(out['leg1_commits'])} times, not at least 2")

    marks: dict = {}
    answers = persisted_index_graph(pw, emb, texts=texts, vecs=vecs, queries=queries, k=k,
                                    chunk_commit=chunk_commit, vec_commit=vec_commit, ask=True,
                                    device=device, marks=marks)
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with scoped_env({"PATHWAY_THREADS": "1", "PATHWAY_MESH_EXCHANGE": "0"}), \
            (torch.profiler.profile(activities=acts) if cuda else contextlib.nullcontext()) as prof:
        try:
            t0 = _wall()
            pw.run(device=device, persistence_config=Config.simple_config(
                Backend.filesystem(store), snapshot_interval_ms=interval_ms))
            out["leg2_s"] = _wall() - t0
        finally:
            pw.G.clear()
        if prof is not None:
            torch.cuda.synchronize()
    if len(answers) != len(queries):
        raise AssertionError(f"leg 2 answered {len(answers)} of {len(queries)} queries")
    manager = marks["manager"]
    out.update(recovery=dict(manager.recovery_stats), leg2_commits=list(manager.commit_log),
               refill_s=marks["filled"] - t0, query_ms=(marks["answered"] - marks["query"]) * 1e3,
               swapped=check_answers("persistence", answers, want))
    if prof is not None:
        out.update(query_tick_device(prof))
    return out


def write_word_files(d: str, words: list, n_files: int, first: int, last: int) -> int:
    """Files ``first`` to ``last - 1`` of ``n_files`` equal slices of ``words``, one word a line;
    returns the rows written."""
    per = len(words) // n_files
    for i in range(first, last):
        with open(os.path.join(d, f"part-{i:02d}.txt"), "w") as f:
            f.writelines(w + "\n" for w in words[i * per:(i + 1) * per])
    return per * (last - first)


def run_persisted_wordcount(device, *, words: list, n_files: int, work: str,
                            legs: tuple = ((5, 2, False), (10, 2, False))) -> dict:
    """Phase 14 (b): phase 13's file wordcount, persisted on the filesystem and written with
    ``pw.io.csv.write`` (transactional), in ``legs`` of (files written so far, workers, an
    offline ``rescale`` to that count before the leg): each leg runs over the directory until it
    counted every row of its files, then stops with ``request_stop``. Past 1 worker with the
    mesh exchange and ``PATHWAY_ELASTIC=1``, so a leg at another count than the store's
    reshards it at boot. Phase 14 runs two legs at 2 workers (half the files, then all);
    phase 15 runs 4 files at 2 workers, 7 at 4 through the elastic boot, then an offline
    rescale to 1 and all 10 at 1. Each leg's seconds, workers and the rescales' reports come
    back beside the csv's rows."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.persistence import Backend, Config
    from pathway_tpu_torch.persistence.backends import FilesystemBackend
    from pathway_tpu_torch.rescale import rescale, stats

    data, out_csv = os.path.join(work, "words"), os.path.join(work, "counts.csv")
    store = os.path.join(work, "store")
    os.makedirs(data)
    cfg = Config.simple_config(Backend.filesystem(store))
    last: dict = {}
    result: dict = {"legs": []}

    def leg(target: int, workers: int) -> float:
        pw.G.clear()
        t = pw.io.fs.read(data, format="plaintext", schema=pw.schema_from_types(data=str),
                          mode="streaming", autocommit_duration_ms=25, name="words")
        counts = t.groupby(pw.this.data).reduce(pw.this.data, c=pw.reducers.count())

        def on_change(key, row, time, is_addition):
            if is_addition:
                last[row["data"]] = row["c"]
                if sum(last.values()) >= target:
                    pw.request_stop()

        pw.io.subscribe(counts, on_change=on_change)
        pw.io.csv.write(counts, out_csv, name="counts")
        with scoped_env({"PATHWAY_THREADS": str(workers),
                         "PATHWAY_MESH_EXCHANGE": "1" if workers > 1 else "0",
                         "PATHWAY_INGEST_COLUMNAR": "1", "PATHWAY_ELASTIC": "1"}):
            try:
                t0 = time.perf_counter()
                pw.run(device=device, persistence_config=cfg)
                return time.perf_counter() - t0
            finally:
                pw.G.clear()

    written, files_written = 0, 0
    for files, workers, offline in legs:
        entry: dict = {"files": files, "workers": workers}
        if offline:
            entry["rescale"] = rescale(FilesystemBackend(store), workers, log=lambda m: None)
        before = stats()["total"]
        written += write_word_files(data, words, n_files, files_written, files)
        files_written = files
        entry["s"] = leg(written, workers)
        entry["counted"] = sum(last.values())
        if stats()["total"] > before:
            entry["elastic"] = stats()["last"]
        result["legs"].append(entry)
    want = dict(collections.Counter(words))
    if last != want:
        raise AssertionError("persisted wordcount: the finals differ from collections.Counter")
    import csv

    with open(out_csv, newline="") as f:
        rows = [(r["data"], int(r["c"]), int(r["time"]), int(r["diff"]))
                for r in csv.DictReader(f)]
    if len(rows) != len(set(rows)):
        raise AssertionError("persisted wordcount: a batch was written to the csv twice")
    net: dict = {}
    for w, c, _t, d_ in rows:
        net[(w, c)] = net.get((w, c), 0) + d_
    if {key for key, v in net.items() if v} != set(want.items()) or \
            any(v not in (0, 1) for v in net.values()):
        raise AssertionError("persisted wordcount: the csv rows net of their diffs differ from "
                             "the clean counts")
    result["csv_rows"] = len(rows)
    return result


def run_persistence(device, *, data=None, want=None, phase11_fill_rows_per_s=None,
                    n_chunks: int = 16384, n_rows: int = 1 << 20, chunk_commit: int = 1024,
                    vec_commit: int = 1 << 16, n_queries: int = 64, k: int = 10,
                    kill_rows: int = 786_432, wc_rows: int = 300_000, wc_files: int = 10,
                    cfg=None, hand_over: bool = False) -> dict:
    """The phase; sizes as the defaults say on the card (a CPU rehearsal passes small ones and a
    small encoder). ``data`` and ``want`` are phase 11's rows, queries and direct answers at one
    worker (computed here when absent), ``phase11_fill_rows_per_s`` its fill rate, which sets the
    snapshot interval so the first leg commits about three times before the kill. With
    ``hand_over`` the index's store (after its second leg) outlives the phase under
    ``result["store"]`` (with its snapshot interval, ``result["interval_ms"]``) for phase 15,
    which deletes it; every other file of the phase is deleted here."""
    import tempfile

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.models.embedder import Embedder
    from pathway_tpu_torch.ops.index_engines import BruteForceKnnEngine

    cuda = device.type == "cuda"
    card = card_line() if cuda else "cpu"
    emb = Embedder(cfg, seed=0, device=device)
    if data is None:
        data = index_data(n_chunks, n_rows, emb.cfg.dim, n_queries)
    texts, vecs, queries = data
    if want is None:
        direct = BruteForceKnnEngine(emb.cfg.dim, reserved_space=n_rows, embedder=emb,
                                     device=device)
        direct.add_batch(list(range(len(texts))), list(texts), [None] * len(texts))
        direct.add_batch(list(range(len(texts), n_rows)), list(vecs), [None] * len(vecs))
        want = dict(enumerate(direct.search(queries, [k] * n_queries, [None] * n_queries)))
        del direct
    fill_s = None if phase11_fill_rows_per_s is None else n_rows / phase11_fill_rows_per_s
    # five commits over phase 11's fill time (the interval runs from each commit's end, as the
    # fill's own time does): the fourth covers kill_rows = 3/4 of the rows with a margin of a
    # fifth of the fill either way
    interval_ms = max(100, int(1e3 * (fill_s or 5.0) / 5))
    result: dict = {"launches": {}}
    work = tempfile.mkdtemp(prefix="persistence_phase_")
    try:
        os.makedirs(os.path.join(work, "a"))
        with counted("persistence_index", result["launches"]):
            a = run_persisted_index(device, emb, cfg, texts=texts, vecs=vecs, queries=queries,
                                    want=want, k=k, chunk_commit=chunk_commit,
                                    vec_commit=vec_commit, kill_rows=kill_rows,
                                    interval_ms=interval_ms, work=os.path.join(work, "a"))
        result["index"] = a
        rec = a["recovery"]
        log(f"persistence, the index: snapshot_interval_ms={interval_ms}; leg 1 (a child "
            f"interpreter) committed {len(a['leg1_commits'])} times and was SIGKILLed "
            f"{a['leg1_s']:.1f} s after its start, its newest metadata covering "
            f"{a['killed_covered']} of {n_rows} rows; {a['store_bytes'] / 2**30:.3f} GiB under "
            f"the store at the kill [{card}]")
        for line in commit_lines(a["leg1_commits"]):
            log(f"  leg 1 commit: {line} [{card}]")
        log(f"persistence, the index: restore_operators {rec.get('restore_s', 0.0):.3f} s "
            f"(snapshot at t={rec.get('op_time')}), {rec.get('replayed_rows')} rows replayed "
            f"from the input tail in {rec.get('replayed_ticks')} ticks ({rec.get('replay_s', 0):.3f}"
            f" s); {a['refill_s']:.1f} s from the second pw.run to the tick holding all "
            f"{n_rows} rows, against "
            + (f"{fill_s:.1f} s for as many rows at phase 11's one-worker fill rate"
               if fill_s is not None else "no fill rate of phase 11 (not run)")
            + f"; leg 2 {a['leg2_s']:.1f} s in all [{card}]")
        for line in commit_lines(a["leg2_commits"]):
            log(f"  leg 2 commit: {line} [{card}]")
        log(f"persistence, the index: {n_queries} answers equal to the direct search "
            f"({a['swapped']} ids swapped inside near ties); the first query tick "
            f"{a['query_ms']:.3f} ms (host, commit to the last answer)"
            + (f", on the device {a['span_ms']:.3f} ms between its markers, busy "
               f"{a['busy_ms']:.3f} ms, of it copies {a['copy_ms']:.3f} ms" if "span_ms" in a
               else "")
            + f"; launches after the restore {result['launches']['persistence_index']} [{card}]")
        for dev_ms, count, name in a.get("top", []):
            log(f"  first query tick, device {dev_ms:9.3f} ms  x{count:<5d} {name} [{card}]")
        words = [f"w{i % 997}" for i in range(wc_rows)]
        os.makedirs(os.path.join(work, "b"))
        with counted("persistence_files", result["launches"]):
            b = run_persisted_wordcount(device, words=words, n_files=wc_files,
                                        work=os.path.join(work, "b"))
        result["files"] = b
        leg1, leg2 = b["legs"]
        log(f"persistence, the file wordcount at 2 workers with PATHWAY_MESH_EXCHANGE=1: leg 1 "
            f"counted {leg1['counted']} rows of {leg1['files']} files in {leg1['s']:.1f} s "
            f"and stopped; leg 2 over {leg2['files']} files {leg2['s']:.1f} s; the finals equal "
            f"collections.Counter, the {b['csv_rows']} csv rows of both legs net of their diffs "
            f"equal the clean counts, none written twice; launches "
            f"{ {n: c for n, c in result['launches']['persistence_files'].items() if c} } "
            f"[{card}]")
    finally:
        import shutil

        store = os.path.join(work, "a", "store")
        if hand_over and os.path.isdir(store):
            result["store"] = os.path.join(tempfile.mkdtemp(prefix="rescale_phase_"), "store")
            result["interval_ms"] = interval_ms
            os.replace(store, result["store"])
        shutil.rmtree(work, ignore_errors=True)
    if cuda:
        missing = [n for n in ("masked_attention", "knn_topk")
                   if not result["launches"]["persistence_index"][n]]
        if missing:
            raise AssertionError(f"{missing} not launched after the restore")
        if not result["launches"]["persistence_files"]["bucket_exchange"]:
            raise AssertionError("bucket_exchange was not launched on the persisted wordcount")
    return result


# -- phase 15: elastic rescale and the spill tier ---------------------------------------------------


#: phase 15 (c)'s spilled groupby-join: ``dense_graph`` over SPILL_ROWS rows and SPILL_GROUPS
#: groups in commits of SPILL_COMMIT, at 1 worker, then over the first SPILL_ROWS_4 rows at 4
#: workers with the mesh exchange, in a child interpreter under SPILL_BUDGET_MB a worker and a
#: key registry cut to SPILL_REGISTRY_CAP, with a spill directory. The 4-worker run is cut from
#: 524,288 rows to 262,144: the phase took 161.6 s of the 120 it may; the 1-worker runs from
#: 1,048,576 rows to 524,288 when phase 19 came, to keep the script's time (PERF.md section 4)
SPILL_ROWS, SPILL_GROUPS, SPILL_COMMIT, SPILL_ROWS_4 = 1 << 19, 1 << 20, 1 << 16, 1 << 18
SPILL_BUDGET_MB, SPILL_REGISTRY_CAP = 32.0, 1 << 18


def run_rescaled_index(device, emb, *, store: str, texts, vecs, queries, want, k: int,
                       chunk_commit: int, vec_commit: int, interval_ms: int) -> dict:
    """Phase 15 (a): phase 14's index store (one worker, after its second leg) mounted at 2
    workers with the mesh exchange and ``PATHWAY_ELASTIC=1``. Worker 0's boot reshards it
    (``rescale.stats()["last"]``: seconds by phase, bytes read and written, the store's bytes
    after the cleanup), the restore replays the input tail after the snapshot, and the 64 text
    queries, sent anew under another source name, are answered (k=10) and held against phase
    11's direct search."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.persistence import Backend, Config
    from pathway_tpu_torch.rescale import stats

    before = stats()["total"]
    marks: dict = {}
    answers = persisted_index_graph(pw, emb, texts=texts, vecs=vecs, queries=queries, k=k,
                                    chunk_commit=chunk_commit, vec_commit=vec_commit, ask=True,
                                    device=device, marks=marks, queries_name="queries_rescaled",
                                    qid_base=1 << 20)
    t0 = _wall()
    with scoped_env({"PATHWAY_THREADS": "2", "PATHWAY_MESH_EXCHANGE": "1",
                     "PATHWAY_ELASTIC": "1"}):
        try:
            pw.run(device=device, persistence_config=Config.simple_config(
                Backend.filesystem(store), snapshot_interval_ms=interval_ms))
        finally:
            pw.G.clear()
    out: dict = {"run_s": _wall() - t0}
    if stats()["total"] != before + 1:
        raise AssertionError("the elastic boot at 2 workers did not rescale the store")
    if len(answers) != len(queries):
        raise AssertionError(f"the rescaled index answered {len(answers)} of {len(queries)} "
                             "queries")
    out.update(rescale=stats()["last"], recovery=dict(marks["manager"].recovery_stats),
               query_ms=(marks["answered"] - marks["query"]) * 1e3,
               swapped=check_answers("rescaled index", answers, want),
               store_bytes_end=dir_bytes(store))
    return out


@contextlib.contextmanager
def exchange_widths(into: collections.Counter):
    """Count the block's ``bucket_exchange`` launches by their number of destinations, through
    the module attribute the engine's runner calls (see ``record_largest_exchange``)."""
    from pathway_tpu_torch.parallel import exchange

    original = exchange.bucket_exchange

    def recording(values, dest, n_dst, cap_bucket, **kw):
        into[n_dst] += 1
        return original(values, dest, n_dst, cap_bucket, **kw)

    recording.launches = original.launches
    exchange.bucket_exchange = recording
    try:
        yield
    finally:
        exchange.bucket_exchange = original
        original.launches = recording.launches


def spill_leg(args: dict) -> int:
    """Phase 15 (c) in a child interpreter, whose environment carries the state budget, the key
    registry's cap and the spill directory (or none of them): ``dense_graph`` over
    ``args["groups"]`` groups for each of ``args["runs"]``, (workers, rows, budget MiB a worker
    or None), with the mesh exchange past 1 worker; a run whose peak state a worker stays under
    4x its budget runs again at half the budget. Each table is held against numpy. Writes to
    ``args["out"]`` each run's budget, rows/s, its peak state a worker (resident spillable plus
    spilled, read at each enforcement), the process's peak RSS during it (the resident size
    of ``/proc/self/statm`` sampled every 20 ms: the ``ru_maxrss`` of a child forked from a
    large parent keeps the parent's mark across ``exec``, and the card machine's
    ``/proc/self/status`` has no ``VmHWM``), its spill counters and launch counts, and the
    registry's tiers. With no budget in the environment it runs in the caller's process too
    (``run_spilled_join``'s unbudgeted run)."""
    import threading

    from pathway_tpu_torch.engine import keys as K, spill

    device = torch.device(args["device"])
    budget = spill.get_budget()
    peak = [0]
    shed: collections.Counter = collections.Counter()  # bytes the budget moved out, by store
    if budget is not None:
        enforce = budget.maybe_spill

        def watched(stores=None):
            stores = budget.stores() if stores is None else stores
            out_before = [s.spilled_bytes() for s in stores]
            state = sum(s.spillable_bytes() for s in stores) + sum(out_before)
            peak[0] = max(peak[0], state)
            freed = enforce(stores)
            for s, b in zip(stores, out_before):
                if s.spilled_bytes() > b:
                    shed[type(s).__name__] += s.spilled_bytes() - b
            return freed

        budget.maybe_spill = watched
    rss = [0]
    sampling = threading.Event()

    def sample() -> None:
        while not sampling.wait(0.02):
            rss[0] = max(rss[0], spill._rss_bytes())

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    out: dict = {"runs": []}
    for workers, rows, budget_mb in args["runs"]:
        halved = 0
        rss[0] = 0
        shed.clear()
        while True:
            if budget is not None:
                budget.budget_bytes = int(budget_mb * (1 << 20))
            peak[0] = 0
            before = spill.spill_counters()
            build = dense_graph(rows, args["groups"], args["commit"])
            launches: dict = {}
            with counted("run", launches):
                cap, seconds, _ = run_workers(build, workers, workers > 1, device)
            if budget is None or peak[0] >= 4 * budget.budget_bytes or budget_mb < 1 / 64:
                break
            budget_mb /= 2
            halved += 1
        got = [np.array(col) for col in zip(*(row for _, row in cap.state.iter_items()))]
        order = np.argsort(got[0], kind="stable")
        got = [col[order] for col in got]
        g, v, w = dense_columns(rows, args["groups"])
        n = np.bincount(g, minlength=args["groups"])
        sv = np.zeros(args["groups"], np.int64)
        np.add.at(sv, g, v)
        sw = np.bincount(g, weights=w, minlength=args["groups"])
        live = np.flatnonzero(n)
        if len(got) != 5 or len(got[0]) != len(live) or not (
                np.array_equal(got[0], live) and np.array_equal(got[1], sv[live])
                and np.array_equal(got[2], sw[live]) and np.array_equal(got[3], n[live])
                and np.array_equal(got[4], live * 7919 + 13)):
            raise AssertionError(f"the groupby-join at {workers} worker(s): the table differs "
                                 "from numpy's sums, counts and labels")
        after = spill.spill_counters()
        out["runs"].append({
            "workers": workers, "rows": rows, "budget_mb": budget_mb, "halved": halved,
            "s": seconds, "rows_per_s": rows / seconds, "groups": int(len(live)),
            "peak_state_bytes": peak[0], "peak_rss_bytes": rss[0], "shed_bytes": dict(shed),
            "counters": {k_: after[k_] - before.get(k_, 0) for k_ in after},
            "launches": launches["run"]})
    sampling.set()
    sampler.join()
    out["registry"] = K.registry_stats()
    with open(args["out"], "w") as f:
        json.dump(out, f)
    return 0


def spill_child(args: dict, env: dict, timeout_s: float = 600) -> tuple[dict, int]:
    """``spill_leg`` in a child interpreter with ``env``; returns its JSON and the child's
    ``ru_maxrss`` in bytes (``os.wait4``'s usage of that child alone, which carries the
    parent's mark at the fork)."""
    child = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--spill-leg",
                              json.dumps(args)], env=env)
    deadline = time.perf_counter() + timeout_s
    try:
        while True:
            pid, status, usage = os.wait4(child.pid, os.WNOHANG)
            if pid:
                child.returncode = os.waitstatus_to_exitcode(status)
                break
            if time.perf_counter() > deadline:
                raise AssertionError(f"the spill leg did not end within {timeout_s} s")
            time.sleep(0.05)
    finally:
        if child.returncode is None:
            child.kill()
            child.wait(60)
    if child.returncode != 0:
        raise AssertionError(f"the spill leg exited with {child.returncode}")
    with open(args["out"]) as f:
        return json.load(f), usage.ru_maxrss * 1024


def run_spilled_join(device, *, rows: int, groups: int, commit: int, rows_4: int,
                     budget_mb: float, registry_cap: int, work: str) -> dict:
    """Phase 15 (c): in a child, the groupby-join at 1 worker under ``budget_mb`` a worker,
    then over ``rows_4`` rows at 4 workers under a sixteenth of it (a worker holds about a
    tenth of the state there), each budget halved until the run's peak state a worker is at
    least 4x it; then the same graph at 1 worker with no budget in this process (a child's
    start would cost the phase about 10 s more)."""
    base = {k_: v_ for k_, v_ in os.environ.items()
            if k_ not in ("PATHWAY_STATE_MEMORY_BUDGET_MB", "PATHWAY_STATE_SPILL_DIR",
                          "PATHWAY_KEY_REGISTRY_SPILL_DIR", "PATHWAY_KEY_REGISTRY_OVERFLOW")}
    args = {"device": str(device), "groups": groups, "commit": commit,
            "out": os.path.join(work, "spill.json"),
            "runs": [[1, rows, budget_mb]] + ([[4, rows_4, budget_mb / 16]] if rows_4 else [])}
    env = {**base, "PATHWAY_STATE_MEMORY_BUDGET_MB": repr(budget_mb),
           "PATHWAY_STATE_SPILL_DIR": os.path.join(work, "spill"),
           "PATHWAY_KEY_REGISTRY_CAP": str(registry_cap)}
    t0 = time.perf_counter()
    spilled, rss = spill_child(args, env)
    spilled_s = time.perf_counter() - t0
    from pathway_tpu_torch.engine import spill

    if spill.get_budget() is not None:
        raise AssertionError("this process has a state budget; the unbudgeted run needs none")
    t0 = time.perf_counter()
    spill_leg({**args, "runs": [[1, rows, None]], "out": os.path.join(work, "plain.json")})
    with open(os.path.join(work, "plain.json")) as f:
        plain = json.load(f)
    return {"spilled": spilled, "maxrss_bytes": rss, "spilled_child_s": spilled_s,
            "plain": plain, "plain_s": time.perf_counter() - t0}


def run_rescale_spill(device, *, store: str | None, interval_ms: int = 1000, data=None,
                      want=None, k: int = 10, chunk_commit: int = 1024,
                      vec_commit: int = 1 << 16, wc_rows: int = 300_000, wc_files: int = 10,
                      spill_rows: int = SPILL_ROWS, spill_groups: int = SPILL_GROUPS,
                      spill_commit: int = SPILL_COMMIT, spill_rows_4: int = SPILL_ROWS_4,
                      budget_mb: float = SPILL_BUDGET_MB, registry_cap: int = SPILL_REGISTRY_CAP,
                      cfg=None) -> dict:
    """Phase 15; sizes as the defaults say on the card (a CPU rehearsal passes small ones).
    ``store`` is phase 14's index store, handed over (``run_persistence(hand_over=True)``) and
    deleted here; ``data`` and ``want`` are its rows, queries and direct answers. Without a store
    (a rehearsal of (b) and (c) alone) leg (a) is skipped."""
    import shutil
    import tempfile

    from pathway_tpu_torch.models.embedder import Embedder

    cuda = device.type == "cuda"
    card = card_line() if cuda else "cpu"
    result: dict = {"launches": {}, "leg_s": {}}
    work = tempfile.mkdtemp(prefix="rescale_spill_phase_")
    try:
        t0 = time.perf_counter()
        if store is not None:
            emb = Embedder(cfg, seed=0, device=device)
            texts, vecs, queries = data
            with counted("rescale_index", result["launches"]):
                a = run_rescaled_index(device, emb, store=store, texts=texts, vecs=vecs,
                                       queries=queries, want=want, k=k, chunk_commit=chunk_commit,
                                       vec_commit=vec_commit, interval_ms=interval_ms)
            result["index"] = a
            r, rec = a["rescale"], a["recovery"]
            phases = ", ".join(f"{n} {t:.3f} s" for n, t in r["phase_s"].items())
            log(f"rescale, the index: phase 14's store (1 worker) at 2 workers with "
                f"PATHWAY_ELASTIC=1 and PATHWAY_MESH_EXCHANGE=1: the resharder {r['duration_s']:.3f}"
                f" s ({phases}; stage holds operators and chunks), {r['ranks']} stateful "
                f"operators, {r['tail_entries']} tail entries, read "
                f"{r['bytes_read'] / 2**30:.3f} GiB, wrote {r['bytes_written'] / 2**30:.3f} GiB, "
                f"the store {r['store_bytes'] / 2**30:.3f} GiB after its cleanup; "
                f"restore_operators {rec.get('restore_s', 0.0):.3f} s, "
                f"{rec.get('replayed_rows')} rows replayed; the run {a['run_s']:.1f} s; "
                f"{len(queries)} answers equal to the direct search ({a['swapped']} ids swapped "
                f"inside near ties), the query tick {a['query_ms']:.3f} ms; launches "
                f"{ {n: c for n, c in result['launches']['rescale_index'].items() if c} } "
                f"[{card}]")
        result["leg_s"]["a"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        words = [f"w{i % 997}" for i in range(wc_rows)]
        os.makedirs(os.path.join(work, "b"))
        widths: collections.Counter = collections.Counter()
        with counted("rescale_files", result["launches"]), exchange_widths(widths):
            b = run_persisted_wordcount(device, words=words, n_files=wc_files,
                                        work=os.path.join(work, "b"),
                                        legs=((4, 2, False), (7, 4, False), (10, 1, True)))
        result["files"] = b
        result["exchange_widths"] = dict(widths)
        legs = "; ".join(
            f"{e['files']} files at {e['workers']} worker(s) {e['s']:.1f} s"
            + (f" after an offline rescale of {e['rescale']['duration_s']:.3f} s"
               if "rescale" in e else "")
            + (f" through the elastic boot ({e['elastic']['from']} -> {e['elastic']['to']}, "
               f"{e['elastic']['duration_s']:.3f} s)" if "elastic" in e else "")
            for e in b["legs"])
        log(f"rescale, the file wordcount: {legs}; the {b['csv_rows']} csv rows net of their "
            f"diffs equal collections.Counter, none written twice; bucket_exchange launches by "
            f"destinations {dict(sorted(widths.items()))} [{card}]")
        if cuda and not widths.get(4):
            raise AssertionError("bucket_exchange was not launched with 4 destinations")
        result["leg_s"]["b"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        c = run_spilled_join(device, rows=spill_rows, groups=spill_groups, commit=spill_commit,
                             rows_4=spill_rows_4, budget_mb=budget_mb,
                             registry_cap=registry_cap, work=work)
        result["spill"] = c
        for run in c["spilled"]["runs"]:
            result["launches"][f"spill_{run['workers']}"] = run["launches"]
        plain = c["plain"]["runs"][0]
        for run in c["spilled"]["runs"]:
            cnt = run["counters"]
            log(f"spill, the groupby-join at {run['workers']} worker(s): {run['rows']} rows over "
                f"{run['groups']} live groups in {run['s']:.1f} s, {run['rows_per_s']:.1f} rows/s "
                f"under a budget of {run['budget_mb']!r} MiB a worker (halved {run['halved']} "
                f"times), the peak state a worker {run['peak_state_bytes'] / 2**20:.1f} MiB; "
                f"spilled {cnt['spill_bytes_total'] / 2**20:.1f} MiB in "
                f"{cnt['spill_events_total']} writes, loaded {cnt['load_bytes_total'] / 2**20:.1f}"
                f" MiB in {cnt['load_events_total']} reads, {cnt['spill_errors_total']} errors; "
                f"shed by store {run['shed_bytes']}; the child's peak RSS "
                f"{run['peak_rss_bytes'] / 2**30:.3f} GiB (sampled); launches "
                f"{ {n: k_ for n, k_ in run['launches'].items() if k_} } [{card}]")
        reg = c["spilled"]["registry"]
        log(f"spill, the same graph at 1 worker without a budget (in this process): "
            f"{plain['rows_per_s']:.1f} rows/s ({plain['s']:.1f} s), this process's RSS "
            f"{plain['peak_rss_bytes'] / 2**30:.3f} GiB at its peak (sampled); the "
            f"budgeted child's ru_maxrss {c['maxrss_bytes'] / 2**30:.3f} GiB (this process's "
            f"mark at the fork); "
            f"the key registry at cap {reg['cap']}: {reg['hot_entries']} hot, "
            f"{reg['cold_entries']} cold; every table equal to numpy's; the child "
            f"{c['spilled_child_s']:.1f} s, the unbudgeted run with its check "
            f"{c['plain_s']:.1f} s [{card}]")
        for run in c["spilled"]["runs"]:
            cnt = run["counters"]
            if run["peak_state_bytes"] < 4 * run["budget_mb"] * (1 << 20):
                raise AssertionError(f"the run at {run['workers']} worker(s) stayed under 4x "
                                     "its budget at 1/64 MiB")
            if not (cnt["spill_bytes_total"] > 0 and cnt["load_events_total"] > 0):
                raise AssertionError(f"the run at {run['workers']} worker(s) spilled "
                                     f"{cnt['spill_bytes_total']} bytes and loaded "
                                     f"{cnt['load_events_total']} times")
        if not reg["cold_entries"]:
            raise AssertionError("no key reached the registry's cold tier")
        result["leg_s"]["c"] = time.perf_counter() - t0
        log(f"rescale and spill: " + ", ".join(f"({k_}) {v_:.1f} s"
                                                for k_, v_ in result["leg_s"].items())
            + f" [{card}]")
    finally:
        shutil.rmtree(work, ignore_errors=True)
        if store is not None:
            shutil.rmtree(os.path.dirname(store), ignore_errors=True)
    if cuda:
        if store is not None:
            missing = [n for n in ("masked_attention", "knn_topk")
                       if not result["launches"]["rescale_index"][n]]
            if missing:
                raise AssertionError(f"{missing} not launched on the rescaled index")
        if spill_rows_4 and not result["launches"]["spill_4"]["bucket_exchange"]:
            raise AssertionError("bucket_exchange was not launched on the 4-worker spilled run")
    return result


# -- phase 16: the frontier-driven async plane and pw.iterate -------------------------------------


#: (a) the reference's skew lane (``bench.py:1261-1470``): fast rows in batches over 64 words of
#: worker 0's shard, slow rows over 8 words of worker 1's, each through a blocking 25 ms UDF
#: SKEW_REPS was 3 until phase 18 came: the script took 1,152.8 s of the contract's 1,200 on a
#: slow host; 2 until phase 19 came, which took it past 900 s to ``done`` on such a host (PERF.md
#: section 4)
SKEW_FAST, SKEW_BATCH, SKEW_SLOW, SKEW_PAUSE_MS, SKEW_REPS = 150_000, 5_000, 40, 25, 1
#: (b) the reference's uniform A/B (``bench.py:2030-2085``): its wordcount, a warm-up of 100,000
#: rows, then the best of 2 runs of 500,000 in commits of 10,000, each arm in a fresh process
UNIFORM_ROWS, UNIFORM_WARMUP, UNIFORM_BATCH = 500_000, 100_000, 10_000
#: (e) min-label propagation over a seeded graph, at 1 worker, within ITERATE_BUDGET_S; cut by
#: half (from 65,536 nodes and 262,144 edges) with SKEW_REPS, for the same reason, and by half
#: again when phase 19 came and when phase 21 did (PERF.md section 4)
CC_NODES, CC_EDGES, ITERATE_BUDGET_S = 1 << 14, 1 << 15, 120.0


def skew_words(workers: int = 2) -> tuple[list, list]:
    """The skew lane's words, picked by shard as the reference's are: a word's row keys and its
    groupby key both derive from the word at salt 0, so one ``shard_of`` probe pins its whole path
    to one worker. 64 words of worker 0's shard, 8 of worker 1's."""
    from pathway_tpu_torch.engine import keys as K

    fast, slow, i = [], [], 0
    while len(fast) < 64 or len(slow) < 8:
        w = f"w{i}"
        key = K.mix_columns([np.array([w], dtype=object)], 1, register=False)
        if int(K.shard_of(key, workers)[0]) == 0:
            if len(fast) < 64:
                fast.append(w)
        elif len(slow) < 8:
            slow.append(w)
        i += 1
    return fast, slow


def keep_counts(into: dict, b) -> None:
    """A count table's newest count per word from one subscribed batch (counts only grow)."""
    for w, c, d in zip(b.data["word"].tolist(), b.data["c"].tolist(), b.diffs.tolist()):
        if d > 0:
            into[w] = max(into.get(w, 0), int(c))


def numpy_counts(words: list) -> dict:
    u, c = np.unique(np.array(words, dtype=object).astype(str), return_counts=True)
    return dict(zip(u.tolist(), c.tolist()))


def skew_run(device, *, n_fast: int, batch: int, n_slow: int, pause_ms: float) -> dict:
    """One run of the skew lane at 2 workers over ``LocalComm`` (the loop as the environment
    selects it): the fast shard's rows/s until its last output update, its drain and the whole
    run's seconds, and worker 0's busy fraction over the drain (1 - waiting / drain, waiting its
    idle parks from ``Executor._idle_park_ns``, plus under BSP its time inside Exchange nodes,
    which ``EngineStats`` times per node). Both count tables are held against numpy's."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.engine import executor as E

    stats_init = E.EngineStats.__init__

    def detailed(self):  # per-node times for the busy fraction; this process runs one lane
        stats_init(self)
        self.detailed = True

    E.EngineStats.__init__ = detailed
    fast_words, slow_words = skew_words()
    fast_feed = [fast_words[j % len(fast_words)] for j in range(n_fast)]
    slow_feed = [slow_words[j % len(slow_words)] for j in range(n_slow)]

    class FastFeed(pw.io.python.ConnectorSubject):
        def run(self):
            for s in range(0, n_fast, batch):
                self.next_batch({"word": fast_feed[s:s + batch]})
                self.commit()

    class SlowFeed(pw.io.python.ConnectorSubject):
        def run(self):
            for w in slow_feed:
                self.next(word=w)
                self.commit()

    pw.G.clear()
    fast = pw.io.python.read(FastFeed(), schema=pw.schema_from_types(word=str),
                             autocommit_duration_ms=None)
    slow = pw.io.python.read(SlowFeed(), schema=pw.schema_from_types(word=str),
                             autocommit_duration_ms=None)
    pause = pause_ms / 1000.0

    def crawl(w):
        # the straggler: a blocking external call a row (sleep releases the interpreter's lock:
        # slowness bound by I/O). It reads a closure cell, so it stays on the per-row path
        time.sleep(pause)
        return w

    slowed = slow.select(word=pw.apply_with_type(crawl, str, pw.this.word))
    fc = fast.groupby(pw.this.word).reduce(pw.this.word, c=pw.reducers.count())
    sc = slowed.groupby(pw.this.word).reduce(pw.this.word, c=pw.reducers.count())
    finals: dict = {"fast": {}, "slow": {}}
    prog = {"fast_last": 0.0, "park_ns": 0, "exch_ns": 0}

    def on_fast(time_, b):
        keep_counts(finals["fast"], b)
        prog["fast_last"] = time.perf_counter()
        ex0 = running_executor0()
        if ex0 is not None:  # this callback runs on worker 0's thread: its counters now
            prog["park_ns"] = ex0._idle_park_ns
            prog["exch_ns"] = sum(ns for label, ns in ex0.stats.time_by_node.items()
                                  if label.startswith("Exchange#"))

    pw.io.subscribe(fc, on_batch=on_fast)
    pw.io.subscribe(sc, on_batch=lambda time_, b: keep_counts(finals["slow"], b))
    t0 = time.perf_counter()
    try:
        pw.run(device=device)
    finally:
        pw.G.clear()
        E.EngineStats.__init__ = stats_init
    total_s = time.perf_counter() - t0
    if finals["fast"] != numpy_counts(fast_feed) or finals["slow"] != numpy_counts(slow_feed):
        raise AssertionError("skew lane: the counts differ from numpy's")
    drain_s = max(prog["fast_last"] - t0, 1e-9)
    waiting_s = prog["park_ns"] / 1e9
    if os.environ.get("PATHWAY_ASYNC_EXEC") == "0":
        waiting_s += prog["exch_ns"] / 1e9
    return {"rows_per_s": n_fast / drain_s, "fast_drain_s": drain_s, "total_s": total_s,
            "fast_busy_frac": max(0.0, min(1.0, 1.0 - waiting_s / drain_s)),
            "park_s": prog["park_ns"] / 1e9, "exchange_s": prog["exch_ns"] / 1e9}


def uniform_wordcount(device, n_rows: int, batch: int) -> float:
    """The reference's ``_wordcount_throughput`` (``bench.py:2089``): words ``w{i % 997}`` from a
    ``ConnectorSubject`` in commits of ``batch``, grouped and counted, ``on_batch``; rows/s."""
    import pathway_tpu_torch as pw

    words = [f"w{i % 997}" for i in range(n_rows)]

    class Feed(pw.io.python.ConnectorSubject):
        def run(self):
            for s in range(0, n_rows, batch):
                self.next_batch({"word": words[s:s + batch]})
                self.commit()

    pw.G.clear()
    t = pw.io.python.read(Feed(), schema=pw.schema_from_types(word=str),
                          autocommit_duration_ms=None)
    counts = t.groupby(pw.this.word).reduce(pw.this.word, c=pw.reducers.count())
    final: dict = {}
    pw.io.subscribe(counts, on_batch=lambda time_, b: keep_counts(final, b))
    t0 = time.perf_counter()
    try:
        pw.run(device=device)
    finally:
        pw.G.clear()
    sec = time.perf_counter() - t0
    if final != numpy_counts(words):
        raise AssertionError("uniform wordcount: the counts differ from numpy's")
    return n_rows / sec


def async_leg(args: dict) -> int:
    """One of phase 16's runs in a fresh interpreter (the reference runs each arm so: the key
    registry and the hash memos grow across runs in one process); prints its JSON as the last
    line. ``kind``: ``skew`` (one skew-lane run), ``uniform`` (the warm-up and the best of 2), or
    ``wordcount`` ((d)'s persisted program, tailing its directory until its parent kills it)."""
    device = torch.device(args["device"])
    if args["kind"] == "skew":
        out = skew_run(device, n_fast=args["n_fast"], batch=args["batch"],
                       n_slow=args["n_slow"], pause_ms=args["pause_ms"])
    elif args["kind"] == "uniform":
        uniform_wordcount(device, args["warmup"], args["batch"])
        runs = [uniform_wordcount(device, args["rows"], args["batch"]) for _ in range(2)]
        out = {"rows_per_s": max(runs), "runs": runs}
    else:
        waves = []
        from pathway_tpu_torch.engine import executor as E

        wave = E.Executor._async_commit_wave

        def logged(self, plane, clock, epoch, fin=False):
            result = wave(self, plane, clock, epoch, fin)
            waves.append((self.ctx.worker_id, epoch))
            with open(args["waves"] + ".tmp", "w") as f:
                json.dump(waves, f)
            os.replace(args["waves"] + ".tmp", args["waves"])
            return result

        E.Executor._async_commit_wave = logged
        async_wordcount_leg(device, data=args["data"], store=args["store"],
                            out_csv=args["out_csv"], target=None)
        return 3  # the leg ran to an end instead of being killed
    print(json.dumps(out), flush=True)
    return 0


def async_child(args: dict, env: dict, timeout_s: float = 300) -> dict:
    """``async_leg`` in a fresh interpreter with ``env`` over this process's environment; its
    last line's JSON."""
    r = subprocess.run([sys.executable, os.path.abspath(__file__), "--async-leg",
                        json.dumps(args)], env={**os.environ, **env}, capture_output=True,
                       text=True, timeout=timeout_s)
    if r.returncode != 0:
        raise AssertionError(f"the {args['kind']} leg exited with {r.returncode}: "
                             f"{r.stderr[-3000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def run_skew_lane(device, reps: int = SKEW_REPS) -> dict:
    """(a): ``reps`` fresh processes a loop, async (the default) then BSP; the best of each."""
    arms: dict = {}
    for name, value in (("async", None), ("bsp", "0")):
        env = {"PATHWAY_THREADS": "2", "PATHWAY_MESH_EXCHANGE": "0"}
        if value is not None:
            env["PATHWAY_ASYNC_EXEC"] = value
        args = {"kind": "skew", "device": str(device), "n_fast": SKEW_FAST,
                "batch": SKEW_BATCH, "n_slow": SKEW_SLOW, "pause_ms": SKEW_PAUSE_MS}
        with scoped_async(None):
            arms[name] = [async_child(args, env) for _ in range(reps)]
    best = {name: max(runs, key=lambda d: d["rows_per_s"]) for name, runs in arms.items()}
    return {"arms": arms, "best": best,
            "ratio": best["async"]["rows_per_s"] / best["bsp"]["rows_per_s"]}


def run_uniform(device) -> dict:
    """(b): the wordcount at 1 worker, at 2 async and at 2 BSP over ``LocalComm``, a fresh
    process each; rows/s and the two efficiencies (2 workers' rate over 1 worker's)."""
    out: dict = {}
    for name, threads, value in (("1 worker", 1, None), ("2 async", 2, None),
                                 ("2 bsp", 2, "0")):
        env = {"PATHWAY_THREADS": str(threads), "PATHWAY_MESH_EXCHANGE": "0"}
        if value is not None:
            env["PATHWAY_ASYNC_EXEC"] = value
        with scoped_async(None):
            out[name] = async_child({"kind": "uniform", "device": str(device),
                                     "rows": UNIFORM_ROWS, "warmup": UNIFORM_WARMUP,
                                     "batch": UNIFORM_BATCH}, env)["rows_per_s"]
    out["efficiency_async"] = out["2 async"] / out["1 worker"]
    out["efficiency_bsp"] = out["2 bsp"] / out["1 worker"]
    return out


def feed_source(columns: list, batches: list, ready=None):
    """An engine-level realtime source: one of ``batches`` (Deltas) a poll, once ``ready()``
    holds; finished when every batch went out."""
    from pathway_tpu_torch.engine.executor import RealtimeSource

    class Feed(RealtimeSource):
        def __init__(self):
            super().__init__(columns)
            self._left = list(batches)

        def poll(self):
            if not self._left or (ready is not None and not ready()):
                return []
            return [self._left.pop(0)]

        def is_finished(self):
            return not self._left

    return Feed()


def run_async_rag(device, emb, *, n_chunks: int, commit: int, n_queries: int, k: int,
                  async_exec: str | None) -> dict:
    """(c)'s RAG through the engine: phase 9's ``ExternalIndexNode`` graph over realtime sources
    (the chunks in commits of ``commit``; the queries in one commit once worker 0's index holds
    every chunk), at 2 workers over ``LocalComm`` with ``PATHWAY_ASYNC_EXEC=async_exec`` (unset:
    async). The chunks are embedded on both workers and gathered to the index on worker 0; every
    answer is held against a direct search of the same index."""
    from pathway_tpu_torch.engine import operators as ops
    from pathway_tpu_torch.engine.delta import Delta
    from pathway_tpu_torch.engine.external_index import ExternalIndexNode
    from pathway_tpu_torch.ops.index_engines import BruteForceKnnEngine

    corpus = make_corpus(n_chunks, 256, seed=1)
    texts = np.array([c for c, _ in corpus], dtype=object)
    index = BruteForceKnnEngine(emb.cfg.dim, reserved_space=n_chunks, embedder=emb,
                                device=device)
    rng = np.random.default_rng(31)
    doc_keys = row_keys(n_chunks, 4)
    queries = np.array([texts[i].split(".")[0] for i in rng.integers(0, n_chunks, n_queries)],
                       dtype=object)
    q_keys = row_keys(n_queries, 5)

    def build(worker):
        docs = feed_source(["text"], [
            Delta(keys=doc_keys[s:s + commit], data={"text": texts[s:s + commit]})
            for s in range(0, n_chunks, commit)])
        embedded = ops.Rowwise(docs, {"__data__": lambda c, k_: emb.embed_texts(list(c["text"]))})
        qs = feed_source(["__query__", "__limit__"], [Delta(
            keys=q_keys, data={"__query__": queries,
                               "__limit__": np.full(n_queries, k, np.int64)})],
            ready=lambda: rows_held(index) >= n_chunks)
        engine = index if worker == 0 else BruteForceKnnEngine(emb.cfg.dim, reserved_space=1,
                                                                device=device)
        node = ExternalIndexNode(embedded, qs, engine, asof_now=True)
        cap = ops.Capture(node)
        return [docs, embedded, qs, node, cap], cap

    with scoped_async(async_exec):
        cap, sec, stats = run_workers(build, 2, False, device)
    replies = {int(k_): row[0] for k_, row in cap.state.iter_items()}
    direct = index.search(list(queries), [k] * n_queries, [None] * n_queries)
    for qk, want_row in zip(q_keys, direct):
        if replies.get(int(qk)) != tuple((int(a), float(b)) for a, b in want_row):
            raise AssertionError("a reply of the engine under async differs from a direct search")
    return {"chunks_per_s": n_chunks / sec, "s": sec, "stats": stats}


def run_async_kernels(device, *, n_chunks: int = 16384, commit: int = 1024,
                      n_queries: int = 64, k: int = 10, api_rows: int = 1 << 22,
                      api_commit: int = 1 << 16, api_groups: int = 1 << 16, cfg=None) -> dict:
    """(c): the kernels of the engine's paths under async at 2 workers over ``LocalComm``: the
    RAG through ``ExternalIndexNode`` (``masked_attention``, ``knn_topk``) and the Table API
    chain (``expression_vm``), each beside one ``PATHWAY_ASYNC_EXEC=0`` run of the same graph.
    The launch counts are zeroed just before each async run and read just after."""
    from pathway_tpu_torch.models.embedder import Embedder

    launches: dict = {}
    rates: dict = {}
    emb = Embedder(cfg, seed=0, device=device)
    emb.embed_texts(["first use: the kernel libraries load"])
    with counted("async_rag", launches):
        rag = run_async_rag(device, emb, n_chunks=n_chunks, commit=commit, n_queries=n_queries,
                            k=k, async_exec=None)
    rates["rag 2 workers async (chunks/s)"] = rag["chunks_per_s"]
    if "async_inbox_depth" not in rag["stats"]:
        raise AssertionError("the RAG run at 2 workers did not use the async plane")
    bsp = run_async_rag(device, emb, n_chunks=n_chunks, commit=commit, n_queries=n_queries, k=k,
                        async_exec="0")
    rates["rag 2 workers BSP (chunks/s)"] = bsp["chunks_per_s"]
    cols = pipeline_columns(api_rows, api_groups)
    want = pipeline_reference(cols)
    for name, value in (("async", None), ("BSP", "0")):
        with counted("async_table_api", launches) if value is None else contextlib.nullcontext():
            got, sec = run_pipeline(device, cols, api_commit, api_groups, 2, lifted=False,
                                    mesh=False, async_exec=value)
        if got != want:
            raise AssertionError(f"the Table API chain at 2 workers {name} differs from numpy's")
        rates[f"table api 2 workers {name}"] = api_rows / sec
    return {"launches": launches, "rates": rates}


@contextlib.contextmanager
def kept_executors(into: list):
    """Every ``Executor`` built in the block, appended to ``into``."""
    from pathway_tpu_torch.engine.executor import Executor

    init = Executor.__init__

    def keep(self, *a, **kw):
        init(self, *a, **kw)
        into.append(self)

    Executor.__init__ = keep
    try:
        yield
    finally:
        Executor.__init__ = init


def wave_summary(executors: list) -> dict:
    """The commit waves of one run's workers: the count, the duration's p50 (worker 0's
    ``WaveRecorder`` documents), the stage split summed over the waves (worker 0's
    ``EngineStats.wave_stage_ns``), and over the workers' documents merged a wave
    (``merge_worker_waves``): each wave's holder and critical stage tallied, and the waves whose
    holder every worker elected."""
    from pathway_tpu_torch.observability.critpath import PHASES, merge_worker_waves

    ex0 = executors[0]
    if ex0.stats._waves is None:
        raise AssertionError("the run recorded no commit wave: it did not take the async loop")
    docs = list(ex0.stats._waves.recent)
    merged = merge_worker_waves({str(ex.ctx.worker_id): ex.stats._waves.snapshot()
                                 for ex in executors if ex.stats._waves is not None})
    total = sum(ex0.stats.wave_stage_ns.get(p, 0) for p in PHASES) or 1
    return {"waves_total": ex0.stats.waves_total,
            "p50_ms": statistics.median(d["duration_ms"] for d in docs),
            "stage_ms": {p: ex0.stats.wave_stage_ns.get(p, 0) / 1e6 for p in PHASES},
            "stage_share": {p: ex0.stats.wave_stage_ns.get(p, 0) / total for p in PHASES},
            "held": dict(collections.Counter(d["holder"] for d in merged["recent"])),
            "agreed": sum(1 for d in merged["recent"] if d["agreed"]),
            "critical": dict(collections.Counter(d["critical_stage"] for d in merged["recent"]))}


def async_wordcount_leg(device, *, data: str, store: str, out_csv: str, target) -> float:
    """(d)'s program: phase 14 (b)'s file wordcount over ``data`` (``pw.io.fs.read`` streaming,
    name ``words``), persisted on the filesystem at ``store``, written with ``pw.io.csv.write``
    (transactional), at 2 workers over ``LocalComm`` (async by default); stops once it counted
    ``target`` rows (None: runs until it is killed). Returns its seconds."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.persistence import Backend, Config

    pw.G.clear()
    t = pw.io.fs.read(data, format="plaintext", schema=pw.schema_from_types(data=str),
                      mode="streaming", autocommit_duration_ms=25, name="words")
    counts = t.groupby(pw.this.data).reduce(pw.this.data, c=pw.reducers.count())
    last: dict = {}

    def on_change(key, row, time, is_addition):
        if is_addition:
            last[row["data"]] = row["c"]
            if target is not None and sum(last.values()) >= target:
                pw.request_stop()

    pw.io.subscribe(counts, on_change=on_change)
    pw.io.csv.write(counts, out_csv, name="counts")
    with scoped_env({"PATHWAY_THREADS": "2", "PATHWAY_MESH_EXCHANGE": "0",
                     "PATHWAY_INGEST_COLUMNAR": "1"}), scoped_async(None):
        try:
            t0 = time.perf_counter()
            pw.run(device=device, persistence_config=Config.simple_config(
                Backend.filesystem(store)))
            return time.perf_counter() - t0
        finally:
            pw.G.clear()


def csv_exactly_once(out_csv: str, want: dict) -> int:
    """The transactional csv's rows, net of their diffs, equal ``want`` with no row written
    twice; returns the rows."""
    import csv

    with open(out_csv, newline="") as f:
        rows = [(r["data"], int(r["c"]), int(r["time"]), int(r["diff"]))
                for r in csv.DictReader(f)]
    if len(rows) != len(set(rows)):
        raise AssertionError("async wordcount: a batch was written to the csv twice")
    net: dict = {}
    for w, c, _t, d_ in rows:
        net[(w, c)] = net.get((w, c), 0) + d_
    if {key for key, v in net.items() if v} != set(want.items()) or \
            any(v not in (0, 1) for v in net.values()):
        raise AssertionError("async wordcount: the csv rows net of their diffs differ from the "
                             "clean counts")
    return len(rows)


def run_async_wordcount(device, *, words: list, n_files: int, work: str) -> dict:
    """(d): the persisted file wordcount at 2 workers async with transactional csv: a leg over
    half the files stopped once it counted them, a restart over all of them; then on a new store,
    a child interpreter tailing half the files, SIGKILLed once both workers finished a commit
    wave, and a restart over all of them. Each time the csv holds each count once. The waves of the in-process
    legs are summarized from their executors."""
    want = numpy_counts(words)
    out: dict = {"legs": []}
    data = os.path.join(work, "words")
    os.makedirs(data)
    store, out_csv = os.path.join(work, "store"), os.path.join(work, "counts.csv")
    written = first = 0
    for files in (n_files // 2, n_files):
        written += write_word_files(data, words, n_files, first, files)
        first = files
        executors: list = []
        with kept_executors(executors):
            sec = async_wordcount_leg(device, data=data, store=store, out_csv=out_csv,
                                      target=written)
        out["legs"].append({"files": files, "rows": written, "s": sec,
                            "waves": wave_summary(executors)})
    out["csv_rows"] = csv_exactly_once(out_csv, want)
    # the SIGKILL: a new store and csv over half the files, a child that never stops by itself;
    # the other half written after the kill, so the restart updates every word's count
    data = os.path.join(work, "words_k")
    os.makedirs(data)
    write_word_files(data, words, n_files, 0, n_files // 2)
    store, out_csv = os.path.join(work, "store_k"), os.path.join(work, "counts_k.csv")
    waves = os.path.join(work, "waves.json")
    args = {"kind": "wordcount", "device": str(device), "data": data, "store": store,
            "out_csv": out_csv, "waves": waves}
    child = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--async-leg",
                              json.dumps(args)])
    t0 = time.perf_counter()
    try:
        while True:
            if child.poll() is not None:
                raise AssertionError(f"the killed leg ended by itself ({child.returncode})")
            if os.path.exists(waves):
                with open(waves) as f:
                    done = json.load(f)
                if {w for w, _ in done} == {0, 1}:
                    break
            if time.perf_counter() - t0 > 180:
                raise AssertionError("the killed leg finished no commit wave within 180 s")
            time.sleep(0.01)
        os.kill(child.pid, signal.SIGKILL)
        child.wait(60)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(60)
    out["killed_after_s"] = time.perf_counter() - t0
    out["killed_waves"] = len(done)
    out["csv_rows_at_kill"] = (sum(1 for _ in open(out_csv)) - 1) if os.path.exists(out_csv) else 0
    write_word_files(data, words, n_files, n_files // 2, n_files)
    executors = []
    with kept_executors(executors):
        out["restart_s"] = async_wordcount_leg(device, data=data, store=store, out_csv=out_csv,
                                               target=len(words))
    out["restart_waves"] = wave_summary(executors)
    out["csv_rows_killed"] = csv_exactly_once(out_csv, want)
    return out


def cc_edges(n: int, m: int, seed: int = 16) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    return rng.integers(0, n, m), rng.integers(0, n, m)


def run_iterate_cc(device, *, n: int, m: int) -> dict:
    """(e): min-label propagation (connected components) with ``pw.iterate`` over ``n`` nodes and
    ``m`` seeded undirected edges (both directions in the edge table), at 1 worker; the labels
    held against ``scipy.sparse.csgraph.connected_components`` (each node's label is its
    component's smallest node); the rounds the driver ran and the seconds."""
    import pandas as pd
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.internals import iterate as it

    u, v = cc_edges(n, m)
    pw.G.clear()
    nodes = pw.debug.table_from_pandas(pd.DataFrame({"node": np.arange(n), "label": np.arange(n)}))
    nodes = nodes.with_id_from(nodes.node)
    # both directions of every edge, and a loop at every node: a node's next label is the least
    # of its own and its neighbours'
    loop = np.arange(n)
    edges = pw.debug.table_from_pandas(pd.DataFrame({"a": np.concatenate([u, v, loop]),
                                                     "b": np.concatenate([v, u, loop])}))

    def step(labels, edges):
        cand = edges.join(labels, edges.a == labels.node).select(node=edges.b,
                                                                 label=labels.label)
        best = cand.groupby(pw.this.node).reduce(pw.this.node,
                                                 label=pw.reducers.min(pw.this.label))
        return dict(labels=best.with_id_from(best.node))

    res = pw.iterate(step, labels=nodes, edges=edges)["labels"]
    rounds = [0]
    run_once = it._IterateDescriptor._run_once

    def counting(self, cur, device_):
        rounds[0] += 1
        return run_once(self, cur, device_)

    it._IterateDescriptor._run_once = counting
    try:
        with scoped_env({"PATHWAY_THREADS": "1"}):
            t0 = time.perf_counter()
            got = pw.debug.table_to_pandas(res, device=device)
            sec = time.perf_counter() - t0
    finally:
        it._IterateDescriptor._run_once = run_once
        pw.G.clear()
    _, comp = connected_components(coo_matrix((np.ones(m), (u, v)), shape=(n, n)),
                                   directed=False)
    smallest = np.full(comp.max() + 1, n)
    np.minimum.at(smallest, comp, np.arange(n))
    label = dict(zip(got["node"].tolist(), got["label"].tolist()))
    if len(label) != n or any(label[i] != smallest[comp[i]] for i in range(n)):
        raise AssertionError("pw.iterate's labels differ from scipy's components")
    return {"rounds": rounds[0], "s": sec, "components": int(comp.max() + 1)}


def run_async_iterate(device, *, wc_rows: int = 300_000, wc_files: int = 10,
                      cc_nodes: int = CC_NODES, cc_edges_n: int = CC_EDGES,
                      kernels: dict | None = None, skew_reps: int = SKEW_REPS) -> dict:
    """Phase 16; sizes as the defaults say on the card (a CPU rehearsal passes small ones and
    ``kernels``, ``run_async_kernels``' sizes). Logs (a)-(e) with the card's name and power
    limit; returns the rates, the waves and the launch counts."""
    import shutil
    import tempfile

    cuda = device.type == "cuda"
    card = card_line() if cuda else "cpu"
    result: dict = {"launches": {}, "s": {}}
    t0 = time.perf_counter()
    skew = run_skew_lane(device, reps=skew_reps)
    result["skew"] = skew
    for name, runs in skew["arms"].items():
        for r in runs:
            log(f"async, (a) the skew lane {name}: the fast shard {r['rows_per_s']:.1f} rows/s, "
                f"drained in {r['fast_drain_s']:.3f} s, the run {r['total_s']:.3f} s, worker 0 "
                f"busy {r['fast_busy_frac']:.3f} of the drain (parked {r['park_s']:.3f} s, in "
                f"Exchange nodes {r['exchange_s']:.3f} s) [{card}]")
    b = skew["best"]
    log(f"async, (a) the skew lane, best of {skew_reps} fresh processes a loop: the fast shard "
        f"{b['async']['rows_per_s']:.1f} rows/s async against {b['bsp']['rows_per_s']:.1f} BSP, "
        f"ratio {skew['ratio']:.3f}; drain {b['async']['fast_drain_s']:.3f} s against "
        f"{b['bsp']['fast_drain_s']:.3f} s, the run {b['async']['total_s']:.3f} s against "
        f"{b['bsp']['total_s']:.3f} s; both arms' counts equal numpy's [{card}]")
    result["s"]["a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    uni = run_uniform(device)
    result["uniform"] = uni
    log(f"async, (b) the uniform wordcount ({UNIFORM_ROWS} rows, best of 2 after a warm-up, a "
        f"fresh process each): 1 worker {uni['1 worker']:.1f} rows/s, 2 workers async "
        f"{uni['2 async']:.1f} (efficiency {uni['efficiency_async']:.3f}), 2 workers BSP "
        f"{uni['2 bsp']:.1f} (efficiency {uni['efficiency_bsp']:.3f}) [{card}]")
    result["s"]["b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    kern = run_async_kernels(device, **(kernels or {}))
    result["launches"].update(kern["launches"])
    result["rates"] = kern["rates"]
    for name, rate in kern["rates"].items():
        log(f"async, (c) {name}: {rate:.1f}{'' if 'chunks' in name else ' rows/s'} [{card}]")
    for path_ in ("async_rag", "async_table_api"):
        log(f"async, (c) launches on the {path_} path: "
            f"{ {n: c for n, c in result['launches'][path_].items() if c} }; every answer "
            f"equal to the direct search, the table equal to numpy's [{card}]")
    result["s"]["c"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="async_phase_")
    try:
        words = [f"w{i % 997}" for i in range(wc_rows)]
        with counted("async_files", result["launches"]):
            d = run_async_wordcount(device, words=words, n_files=wc_files, work=work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    result["wordcount"] = d
    for i, leg in enumerate(d["legs"]):
        w = leg["waves"]
        log(f"async, (d) the persisted file wordcount at 2 workers, leg {i + 1}: {leg['rows']} "
            f"rows of {leg['files']} files in {leg['s']:.1f} s; waves_total {w['waves_total']}, "
            f"wave p50 {w['p50_ms']:.3f} ms; stage split "
            + ", ".join(f"{p} {ms:.1f} ms ({w['stage_share'][p]:.3f})"
                        for p, ms in w["stage_ms"].items())
            + f"; holders {w['held']} ({w['agreed']} agreed), critical stages {w['critical']} "
            f"[{card}]")
    w = d["restart_waves"]
    log(f"async, (d) the csv holds each count once across the stop ({d['csv_rows']} rows); the "
        f"SIGKILL leg killed {d['killed_after_s']:.1f} s after its start, after "
        f"{d['killed_waves']} waves of its workers, {d['csv_rows_at_kill']} csv rows written; the "
        f"restart {d['restart_s']:.1f} s, waves_total {w['waves_total']}, wave p50 "
        f"{w['p50_ms']:.3f} ms, holders {w['held']}; the csv holds each count once "
        f"({d['csv_rows_killed']} rows) [{card}]")
    result["s"]["d"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with counted("iterate", result["launches"]):
        cc = run_iterate_cc(device, n=cc_nodes, m=cc_edges_n)
    result["iterate"] = cc
    log(f"async, (e) pw.iterate's connected components over {cc_nodes} nodes and {cc_edges_n} "
        f"undirected edges at 1 worker: {cc['rounds']} rounds in {cc['s']:.1f} s, "
        f"{cc['components']} components, the labels equal scipy's; expression_vm launches "
        f"{result['launches']['iterate']['expression_vm']} [{card}]")
    result["s"]["e"] = time.perf_counter() - t0
    log("async and iterate: " + ", ".join(f"({k_}) {v_:.1f} s" for k_, v_ in result["s"].items())
        + f" [{card}]")
    if cuda:
        for path_, need in (("async_rag", ("masked_attention", "knn_topk")),
                            ("async_table_api", ("expression_vm",))):
            missing = [n for n in need if not result["launches"][path_][n]]
            if missing:
                raise AssertionError(f"{missing} not launched on the {path_} path under async")
        if cc["s"] > ITERATE_BUDGET_S:
            raise AssertionError(f"(e) took {cc['s']:.1f} s of its {ITERATE_BUDGET_S}")
    return result


NEXMARK_EVENTS = 1_000_000  # the generator's events: persons, auctions and bids as 1:3:46
NEXMARK_COMMIT = 10_000  # events a commit, each table's share of them through pw.io.python
NEXMARK_WINDOW_MS = 10_000
#: the first events of the generator's that each leg takes: Q5 ((b), five windows a bid), then
#: the joins (d) were cut by halves from NEXMARK_EVENTS after the phase's legs took 125.3 s of
#: its 120 at full size on the card; (a) by half and (d) by half again when phase 19 came, to
#: keep the script's time (PERF.md section 4), (d) by half again when phase 21 came; (a) never
#: below 262,144
NEXMARK_LEG_EVENTS = {"q1q7": 500_000, "q5": 500_000, "q8": NEXMARK_EVENTS, "joins": 125_000}
NEXMARK_BUDGET_S = 120.0
# the Beam generator's word lists (PersonGenerator)
NEXMARK_STATES = ("AZ", "CA", "ID", "OR", "WA", "WY")
NEXMARK_FIRST = ("Peter", "Paul", "Luke", "John", "Saul", "Vicky", "Kate", "Julie", "Sarah",
                 "Deiter", "Walter")
NEXMARK_LAST = ("Shultz", "Abrams", "Spencer", "White", "Bartels", "Walton", "Smith", "Jones",
                "Noris")


def nexmark_events(n_events: int, seed: int = 17) -> dict:
    """The Nexmark benchmark's event model (github.com/nexmark/nexmark, after Apache Beam's
    ``NexmarkConfiguration`` defaults and ``GeneratorConfig``), seeded, in numpy: event ``n`` is
    a person at offset 0 of each run of 50 events, an auction at offsets 1-3 and a bid at 4-49;
    its time is ``n // 10`` ms (the first-event rate of 10,000 events per event-second, 100 us
    apart, in order). Ids start at 1000. A bid's auction is, with odds 1 in ``hotAuctionRatio``
    = 2 against, the first of the newest pair of auctions, else one of the 100 in flight (up to
    10 ahead); its bidder, 3 in 4, the hot bidder of the newest four persons, else one of the
    1000 active (up to 10 ahead); an auction's seller likewise, with ``hotSellersRatio`` = 4.
    Prices are ``round(10 ** (6 u) * 100)`` cents. Returns {"person"|"auction"|"bid": columns},
    each with ``i`` (its row's index) and ``n`` (its event number)."""
    rng = np.random.default_rng(seed)
    n = np.arange(n_events, dtype=np.int64)
    epoch, off = n // 50, n % 50
    t = n // 10
    last_person = epoch  # the person of each run of 50 comes first
    last_auction = epoch * 3 + np.clip(off - 1, -1, 2)

    def next_person(lp):
        num = lp + 1
        active = np.minimum(num, 1000)
        return num - active + rng.integers(0, active + 10)

    out = {}
    m = off == 0
    k = int(m.sum())
    first = rng.integers(0, len(NEXMARK_FIRST), k)
    last = rng.integers(0, len(NEXMARK_LAST), k)
    out["person"] = {
        "i": np.arange(k, dtype=np.int64), "n": n[m], "pid": epoch[m] + 1000,
        "name": [f"{NEXMARK_FIRST[a]} {NEXMARK_LAST[b]}" for a, b in zip(first, last)],
        "state": [NEXMARK_STATES[s] for s in rng.integers(0, len(NEXMARK_STATES), k)],
        "t": t[m]}
    m = (off >= 1) & (off <= 3)
    k = int(m.sum())
    lp = last_person[m]
    hot = rng.integers(0, 4, k) > 0
    seller = np.where(hot, (lp // 4) * 4, next_person(lp))
    out["auction"] = {
        "i": np.arange(k, dtype=np.int64), "n": n[m], "aid": epoch[m] * 3 + off[m] - 1 + 1000,
        "seller": seller + 1000, "category": 10 + rng.integers(0, 5, k), "t": t[m]}
    m = off >= 4
    k = int(m.sum())
    la, lp = last_auction[m], last_person[m]
    lo = np.maximum(la - 100, 0)
    auction = np.where(rng.integers(0, 2, k) > 0, (la // 2) * 2,
                       lo + rng.integers(0, la - lo + 1 + 10))
    bidder = np.where(rng.integers(0, 4, k) > 0, (lp // 4) * 4 + 1, next_person(lp))
    price = np.rint(10.0 ** (rng.random(k) * 6.0) * 100.0).astype(np.int64)
    out["bid"] = {"i": np.arange(k, dtype=np.int64), "n": n[m], "auction": auction + 1000,
                  "bidder": bidder + 1000, "price": price, "t": t[m]}
    return out


NEXMARK_SCHEMAS = {"person": dict(i=int, pid=int, name=str, state=str, t=int),
                   "auction": dict(i=int, aid=int, seller=int, category=int, t=int),
                   "bid": dict(i=int, auction=int, bidder=int, price=int, t=int)}


def nexmark_source(pw, ev: dict, kind: str, n_events: int):
    """``pw.io.python.read`` of one table of the events: its rows of each ``NEXMARK_COMMIT``
    events in one ``next_batch`` and a commit."""
    cols = ev[kind]
    names = list(NEXMARK_SCHEMAS[kind])
    cuts = np.searchsorted(cols["n"], np.arange(0, n_events + NEXMARK_COMMIT, NEXMARK_COMMIT))

    class Feed(pw.io.python.ConnectorSubject):
        def run(self):
            for lo, hi in zip(cuts[:-1], cuts[1:]):
                self.next_batch({c: cols[c][lo:hi] for c in names})
                self.commit()

    return pw.io.python.read(Feed(), schema=pw.schema_from_types(**NEXMARK_SCHEMAS[kind]),
                             autocommit_duration_ms=None)


def subscribed(pw, table) -> list:
    """Subscribe ``on_batch`` to ``table``; the list its batches go into."""
    seen: list = []
    names = table.column_names()
    pw.io.subscribe(table, on_batch=lambda tm, b: seen.append(
        (b.keys.copy(), b.diffs.copy(), {c: np.asarray(b.data[c]).copy() for c in names})))
    return seen


def live_rows(seen: list, names: list, with_keys: bool = False) -> dict:
    """A subscribed stream's final table {column: array}: per row key the newest insert, for
    keys whose diffs net to 1; fails unless every key nets to 0 or 1. ``with_keys`` adds the
    row keys as column ``__key__``."""
    if not seen:
        return {c: np.zeros(0) for c in names + ["__key__"] * with_keys}
    keys = np.concatenate([k for k, _, _ in seen])
    diffs = np.concatenate([d for _, d, _ in seen])
    order = np.lexsort((np.arange(len(keys)), keys))  # by key, then arrival
    keys, diffs = keys[order], diffs[order]
    starts = np.flatnonzero(np.r_[True, keys[1:] != keys[:-1]])
    net = np.add.reduceat(diffs, starts)
    if ((net != 0) & (net != 1)).any():
        raise AssertionError("a subscribed stream does not consolidate to one row a key")
    alive = set(keys[starts][net == 1].tolist())
    pos = np.flatnonzero(diffs > 0)
    newest = pos[np.flatnonzero(np.r_[keys[pos][1:] != keys[pos][:-1], True])]
    keep = np.array([i for i in newest if int(keys[i]) in alive], dtype=np.int64)
    out = {c: np.concatenate([b[c] for _, _, b in seen])[order][keep] for c in names}
    if with_keys:
        out["__key__"] = keys[keep]
    return out


def rows_of(cols: dict, names: list) -> collections.Counter:
    return collections.Counter(zip(*(np.asarray(cols[c]).tolist() for c in names)))


def nexmark_run(device, build, workers: int, tag: str, launches: dict) -> tuple[dict, float]:
    """``build(pw)`` -> {name: table}, each subscribed; ``pw.run(device=)`` at ``workers`` over
    ``LocalComm`` (the default loop: async past 1 worker), its launch counts zeroed just before
    and read just after into ``launches[tag]``. Returns ({name: final columns}, seconds)."""
    import pathway_tpu_torch as pw

    pw.G.clear()
    tables = build(pw)
    seen = {name: (subscribed(pw, t), t.column_names()) for name, t in tables.items()}
    env = {"PATHWAY_THREADS": str(workers), "PATHWAY_MESH_EXCHANGE": "0",
           "PATHWAY_INGEST_COALESCE_WINDOWS": "0"}
    with scoped_env(env), scoped_async(None), counted(tag, launches):
        try:
            t0 = time.perf_counter()
            pw.run(device=device)
            seconds = time.perf_counter() - t0
        finally:
            pw.G.clear()
    return {name: live_rows(s, names) for name, (s, names) in seen.items()}, seconds


def plain_windows(t: np.ndarray, hop: int, duration: int) -> tuple[np.ndarray, np.ndarray]:
    """(row index, window start) of every window of ``sliding(hop, duration)`` (``tumbling``
    when hop == duration) that holds each time: starts s = k * hop with s <= t < s + duration."""
    rows, starts = [], []
    top = (t // hop) * hop
    for j in range(duration // hop):
        rows.append(np.arange(len(t)))
        starts.append(top - j * hop)
    return np.concatenate(rows), np.concatenate(starts)


def group_max_count(keys: np.ndarray, vals: np.ndarray) -> dict:
    """{key: (max of vals, count)} over rows grouped by ``keys``."""
    order = np.lexsort((vals, keys))
    keys, vals = keys[order], vals[order]
    ends = np.flatnonzero(np.r_[keys[1:] != keys[:-1], True])
    counts = np.diff(np.r_[-1, ends])
    return {int(k): (int(v), int(c)) for k, v, c in zip(keys[ends], vals[ends], counts)}


def nexmark_q1q7(pw, ev, n_events):
    bids = nexmark_source(pw, ev, "bid", n_events)
    q1 = bids.select(pw.this.i, pw.this.auction, pw.this.bidder, pw.this.t,
                     price_eur=pw.this.price * 0.908)
    q7 = bids.windowby(pw.this.t, window=pw.temporal.tumbling(duration=NEXMARK_WINDOW_MS),
                       behavior=pw.temporal.exactly_once_behavior()).reduce(
        start=pw.this._pw_window_start, top=pw.reducers.max(pw.this.price),
        n=pw.reducers.count())
    return {"q1": q1, "q7": q7}


def check_q1q7(out: dict, bid: dict) -> int:
    q1 = out["q1"]
    order = np.argsort(q1["i"])
    if len(order) != len(bid["i"]) or not (q1["i"][order] == bid["i"]).all():
        raise AssertionError("Q1 did not return every bid once")
    for c in ("auction", "bidder", "t"):
        if not (q1[c][order] == bid[c]).all():
            raise AssertionError(f"Q1's {c} differs from the bids'")
    want = bid["price"].astype(np.float64) * 0.908
    if not (q1["price_eur"][order].astype(np.float64) == want).all():
        raise AssertionError("Q1's price * 0.908 differs from numpy's")
    want7 = group_max_count((bid["t"] // NEXMARK_WINDOW_MS) * NEXMARK_WINDOW_MS, bid["price"])
    got7 = {int(s): (int(m), int(c)) for s, m, c in zip(out["q7"]["start"], out["q7"]["top"],
                                                          out["q7"]["n"])}
    if got7 != want7:
        raise AssertionError("Q7's highest bid per window differs from numpy's")
    return len(got7)


def nexmark_q5(pw, ev, n_events):
    bids = nexmark_source(pw, ev, "bid", n_events)
    counts = bids.windowby(
        pw.this.t, window=pw.temporal.sliding(hop=2_000, duration=NEXMARK_WINDOW_MS),
        instance=pw.this.auction).reduce(auction=pw.this._pw_instance,
                                         start=pw.this._pw_window_start, n=pw.reducers.count())
    top = counts.groupby(pw.this.start).reduce(pw.this.start, top=pw.reducers.max(pw.this.n))
    hot = counts.join(top, counts.start == top.start).select(
        counts.start, counts.auction, counts.n, top=top.top).filter(pw.this.n == pw.this.top)
    return {"counts": counts, "hot": hot}


def check_q5(out: dict, bid: dict) -> int:
    rows, starts = plain_windows(bid["t"], 2_000, NEXMARK_WINDOW_MS)
    auc = bid["auction"][rows]
    pair = np.stack([starts, auc], 1)
    uniq, counts = np.unique(pair, axis=0, return_counts=True)
    want = collections.Counter(zip(uniq[:, 1].tolist(), uniq[:, 0].tolist(), counts.tolist()))
    if rows_of(out["counts"], ["auction", "start", "n"]) != want:
        raise AssertionError("Q5's bids per auction and window differ from numpy's")
    top = group_max_count(uniq[:, 0], counts)
    hot = collections.Counter((int(s), int(a), int(c)) for (s, a), c in zip(uniq, counts)
                              if c == top[int(s)][0])
    if rows_of(out["hot"], ["start", "auction", "n"]) != hot:
        raise AssertionError("Q5's hot items differ from numpy's")
    return len(top)


def nexmark_q8(pw, ev, n_events):
    persons = nexmark_source(pw, ev, "person", n_events)
    auctions = nexmark_source(pw, ev, "auction", n_events)
    q8 = persons.window_join_inner(
        auctions, persons.t, auctions.t, pw.temporal.tumbling(duration=NEXMARK_WINDOW_MS),
        persons.pid == auctions.seller).select(persons.pid, persons.name, auctions.aid)
    return {"q8": q8}


def check_q8(out: dict, person: dict, auction: dict) -> int:
    w_p = {int(p): int(t) // NEXMARK_WINDOW_MS for p, t in zip(person["pid"], person["t"])}
    names = dict(zip(person["pid"].tolist(), person["name"]))
    want = collections.Counter(
        (s, names[s], a) for a, s, t in zip(auction["aid"].tolist(), auction["seller"].tolist(),
                                            auction["t"].tolist())
        if s in w_p and w_p[s] == t // NEXMARK_WINDOW_MS)
    if rows_of(out["q8"], ["pid", "name", "aid"]) != want:
        raise AssertionError("Q8's new sellers differ from numpy's")
    return len({p for p, _, _ in want})


def nexmark_joins(pw, ev, n_events):
    persons = nexmark_source(pw, ev, "person", n_events)
    auctions = nexmark_source(pw, ev, "auction", n_events)
    bids = nexmark_source(pw, ev, "bid", n_events)
    fresh = auctions.interval_join_inner(
        bids, auctions.t, bids.t, pw.temporal.interval(0, NEXMARK_WINDOW_MS),
        pw.left.aid == pw.right.auction).select(pw.left.aid, bi=pw.right.i)
    who = bids.asof_join(persons, bids.t, persons.t, bids.bidder == persons.pid).select(
        bi=pw.left.i, state=pw.right.state)
    return {"interval": fresh, "asof": who}


def check_joins(out: dict, person: dict, auction: dict, bid: dict) -> tuple[int, int]:
    created = dict(zip(auction["aid"].tolist(), auction["t"].tolist()))
    want = collections.Counter(
        (a, i) for i, a, t in zip(bid["i"].tolist(), bid["auction"].tolist(), bid["t"].tolist())
        if a in created and 0 <= t - created[a] <= NEXMARK_WINDOW_MS)
    if rows_of(out["interval"], ["aid", "bi"]) != want:
        raise AssertionError("the interval join differs from numpy's")
    joined = dict(zip(person["pid"].tolist(), zip(person["t"].tolist(), person["state"])))
    want_asof = collections.Counter(
        (i, joined[b][1] if b in joined and joined[b][0] <= t else None)
        for i, b, t in zip(bid["i"].tolist(), bid["bidder"].tolist(), bid["t"].tolist()))
    if rows_of(out["asof"], ["bi", "state"]) != want_asof:
        raise AssertionError("the as-of join differs from numpy's")
    return sum(want.values()), sum(1 for (_, s) in want_asof if s is not None)


def run_nexmark(device, *, n_events: int = NEXMARK_EVENTS, leg_events: dict | None = None
                ) -> dict:
    """Phase 17: the Nexmark generator's ``n_events`` events through ``pw.temporal`` with
    ``pw.run(device=...)``, each leg over the first ``leg_events[leg]`` of them (by default
    ``NEXMARK_LEG_EVENTS``), every output held against numpy and Python on the same events; each
    leg's rows/s (its input rows over the wall of ``pw.run``, host clock) and window or match
    count logged with the card's name and power limit."""
    cuda = device.type == "cuda"
    card = card_line() if cuda else "cpu"
    leg_events = {k: min(n, n_events)
                  for k, n in {**NEXMARK_LEG_EVENTS, **(leg_events or {})}.items()}
    t0 = time.perf_counter()
    ev = nexmark_events(n_events)
    log(f"nexmark: {n_events} events ({len(ev['person']['i'])} persons, "
        f"{len(ev['auction']['i'])} auctions, {len(ev['bid']['i'])} bids) generated in "
        f"{time.perf_counter() - t0:.1f} s")
    result: dict = {"launches": {}, "rates": {}, "windows": {}, "s": {}}

    def events_of(n: int) -> dict:
        return {kind: {c: v[:int(np.searchsorted(cols["n"], n))] for c, v in cols.items()}
                for kind, cols in ev.items()}

    n = leg_events["q1q7"]
    sub = events_of(n)
    n_bids = len(sub["bid"]["i"])
    for workers in (1, 2):
        tag = f"nexmark_q1q7_{workers}w"
        out, s = nexmark_run(device, lambda pw: nexmark_q1q7(pw, sub, n), workers, tag,
                             result["launches"])
        windows = check_q1q7(out, sub["bid"])
        result["rates"][tag] = n_bids / s
        result["windows"][tag] = windows
        result["s"][tag] = s
        log(f"nexmark (a) Q1 and Q7 at {workers} worker{'s' * (workers > 1)}: {n_bids} bids of "
            f"{n} events in {s:.2f} s, {n_bids / s:.1f} rows/s; {len(out['q1']['i'])} Q1 "
            f"rows, {windows} Q7 windows, each equal to numpy's; expression_vm launches "
            f"{result['launches'][tag]['expression_vm']} [{card}]")
    legs = (("b", "q5", nexmark_q5, ("bid",), "windows",
             lambda out, e: check_q5(out, e["bid"])),
            ("c", "q8", nexmark_q8, ("person", "auction"), "persons matched",
             lambda out, e: check_q8(out, e["person"], e["auction"])),
            ("d", "joins", nexmark_joins, ("person", "auction", "bid"),
             "(interval pairs, bids with their bidder)",
             lambda out, e: check_joins(out, e["person"], e["auction"], e["bid"])))
    for letter, name, build, kinds, what, check in legs:
        n = leg_events[name]
        sub = events_of(n)
        fed = sum(len(sub[k]["i"]) for k in kinds)
        tag = f"nexmark_{name}"
        out, s = nexmark_run(device, lambda pw, b=build: b(pw, sub, n), 1, tag,
                             result["launches"])
        got = check(out, sub)
        result["rates"][tag] = fed / s
        result["windows"][tag] = got
        result["s"][tag] = s
        log(f"nexmark ({letter}) {name} at 1 worker: {fed} rows ({'+'.join(kinds)}) of {n} "
            f"events in {s:.2f} s, {fed / s:.1f} rows/s; {what} {got}, every output equal to "
            f"numpy's [{card}]")
    total = sum(result["s"].values())
    log(f"nexmark: the runs took {total:.1f} s of the phase's {NEXMARK_BUDGET_S:.0f} "
        f"({', '.join(f'{k} {v:.1f} s' for k, v in result['s'].items())}) [{card}]")
    if cuda:
        for workers in (1, 2):
            if not result["launches"][f"nexmark_q1q7_{workers}w"]["expression_vm"]:
                raise AssertionError(f"expression_vm not launched by Q1 at {workers} workers")
    result["events"] = ev  # phase 18's SQL leg reads the same events
    return result


# -- phase 18: the stdlib and SQL ------------------------------------------------------------------

MNIST_TRAIN, MNIST_TEST, MNIST_DIM, MNIST_CLASSES = 60_000, 10_000, 784, 10
MNIST_TRAIN_COMMIT, MNIST_QUERY_COMMIT = 10_000, 1_000
SQL_EVENTS = 500_000  # the first of phase 17's events that leg (b) takes
#: PageRank cut from scale 14 and Bellman-Ford from 12 when phase 19 came, to 12 and 10 when
#: phase 21 did (PERF.md section 4)
GRAPH_SCALES = {"pagerank": 12, "bellman_ford": 10, "louvain": 12}
STDLIB_BUDGET_S = 120.0
SQL_QUERIES = {
    "q0": ("SELECT auction, bidder, price, t FROM bid", ("bid",)),
    "q1": ("SELECT auction, bidder, price * 0.908 AS price, t FROM bid", ("bid",)),
    "q2": ("SELECT auction, price FROM bid WHERE auction % 123 = 0", ("bid",)),
    "q3": ("SELECT P.name, P.state, A.aid FROM auction AS A JOIN person AS P ON A.seller = P.pid "
           "WHERE A.category = 10 AND (P.state = 'OR' OR P.state = 'ID' OR P.state = 'CA')",
           ("auction", "person")),
    # not a Nexmark query: a grouped count and maximum
    "per_auction": ("SELECT auction, COUNT(*) AS n, MAX(price) AS top FROM bid GROUP BY auction",
                    ("bid",)),
}


def mnist_shaped(seed: int = 19) -> dict:
    """MNIST's shape (LeCun et al.: 60,000 training and 10,000 test images of 28 x 28 = 784
    features, ten classes), seeded: each vector a class centre (standard normal) plus normal
    noise of 1.25, its label the class."""
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((MNIST_CLASSES, MNIST_DIM)).astype(np.float32)
    out = {}
    for part, n in (("train", MNIST_TRAIN), ("test", MNIST_TEST)):
        label = rng.integers(0, MNIST_CLASSES, n)
        noise = rng.standard_normal((n, MNIST_DIM)).astype(np.float32) * np.float32(1.25)
        out[part] = (centres[label] + noise, label)
    return out


def vote_options(labels: list, scores: list, tol: float, k: int) -> set:
    """Every label the majority of a top ``k`` can take where scores within ``tol`` of each other
    may come in either order: the rows clear above the k-th score stay, any of those within
    ``tol`` of it may fill the rest, and a tie of counts goes to the nearest of the tied labels'
    rows, which may be any of them within ``tol`` of the best."""
    kth = scores[k - 1]
    certain = [j for j in range(k) if scores[j] - kth > tol]
    band = [j for j in range(len(scores)) if j not in certain and abs(scores[j] - kth) <= tol]
    out = set()
    for combo in itertools.combinations(band, k - len(certain)):
        chosen = certain + list(combo)
        count = collections.Counter(labels[j] for j in chosen)
        top = max(count.values())
        tied = [j for j in chosen if count[labels[j]] == top]
        best = max(scores[j] for j in tied)
        out |= {labels[j] for j in tied if best - scores[j] <= tol}
    return out


def plain_votes(device, train: np.ndarray, train_label: np.ndarray, test: np.ndarray,
                k: int = 3, extra: int = 32, chunk: int = 1000) -> list:
    """Per query, the labels the majority of the plain scorer's top ``k`` (l2sq) can take within
    ``topk_tolerance`` (``vote_options`` over its top ``k + extra``; one label where no two
    scores that matter lie within it)."""
    from pathway_tpu_torch.ops.knn import topk_scores_plain

    index = torch.from_numpy(train).to(device)
    options = []
    for s in range(0, len(test), chunk):
        q = torch.from_numpy(test[s:s + chunk]).to(device)
        sc, ids = topk_scores_plain(q, index, k + extra, "l2sq")
        tol = topk_tolerance(sc, q, index, "l2sq")[:, k - 1].tolist()
        labels = train_label[ids.cpu().numpy()].tolist()
        for row, scores, t in zip(labels, sc.tolist(), tol):
            if abs(scores[-1] - scores[k - 1]) <= t:
                raise AssertionError("more scores within the tolerance than the check fetched")
            options.append(vote_options(row, scores, t, k))
    return options


def run_knn_classify(device, launches: dict, k: int = 3) -> dict:
    """(a): MNIST-shaped vectors through ``pw.io.python`` into ``pw.ml``'s kNN classifier, then
    ``knn_topk`` on the run's own index mirror and one commit of queries held against the plain
    scorer, score by score (``check_topk_against_plain``)."""
    from pathway_tpu_torch.ops.knn import plan, topk_scores, topk_scores_plain

    data = mnist_shaped()
    (train, train_label), (test, test_label) = data["train"], data["test"]
    n_train, n_test = len(train), len(test)
    held: list = []

    def build(pw):
        class Train(pw.io.python.ConnectorSubject):
            def run(self):
                for s in range(0, n_train, MNIST_TRAIN_COMMIT):
                    e = min(s + MNIST_TRAIN_COMMIT, n_train)
                    self.next_batch({"i": list(range(s, e)), "data": list(train[s:e]),
                                     "label": train_label[s:e]})
                    self.commit()

        class Queries(pw.io.python.ConnectorSubject):
            def run(self):  # once the index holds every training row
                deadline = _wall() + 600
                while not engines or max(rows_held(e) for e in engines) < n_train:
                    if _wall() > deadline:
                        raise AssertionError("the index did not take the training rows in 600 s")
                    time.sleep(0.005)
                for s in range(0, n_test, MNIST_QUERY_COMMIT):
                    e = min(s + MNIST_QUERY_COMMIT, n_test)
                    self.next_batch({"i": list(range(s, e)), "data": list(test[s:e]),
                                     "label": test_label[s:e]})
                    self.commit()

        # keyed by ``i``: without a primary key each row's key would hash its 784 floats
        schema = pw.schema_builder({"i": pw.column_definition(primary_key=True, dtype=int),
                                    "data": pw.column_definition(dtype=object),
                                    "label": pw.column_definition(dtype=int)})
        tr = pw.io.python.read(Train(), schema=schema, autocommit_duration_ms=None)
        qs = pw.io.python.read(Queries(), schema=schema, autocommit_duration_ms=None)
        model = pw.ml.knn_lsh_classifier_train(tr.select(data=pw.this.data), L=20,
                                               type="euclidean", d=MNIST_DIM)
        engines = keep_engines(model._index)
        held.append(engines)
        predicted = pw.ml.knn_lsh_classify(model, tr.select(label=pw.this.label),
                                           qs.select(data=pw.this.data), k=k)
        accuracy = pw.ml.classifier_accuracy(predicted.predicted_label, qs.label)
        return {"predicted": predicted.select(qi=qs.i, pred=predicted.predicted_label),
                "accuracy": accuracy}

    out, s = nexmark_run(device, build, 1, "stdlib_knn", launches)
    pred = out["predicted"]
    if len(pred["qi"]) != n_test:
        raise AssertionError(f"{len(pred['qi'])} of {n_test} queries classified")
    got = np.empty(n_test, dtype=np.int64)
    got[pred["qi"].astype(np.int64)] = pred["pred"].astype(np.int64)
    options = plain_votes(device, train, train_label, test, k)
    outside = sum(int(g) not in o for g, o in zip(got.tolist(), options))
    if outside:
        raise AssertionError(f"{outside} labels are none the plain scorer's top {k} can vote "
                             f"for within its tolerance")
    open_ = sum(len(o) > 1 for o in options)
    right = int((got == test_label).sum())
    acc = {bool(v): int(c) for v, c in zip(out["accuracy"]["value"], out["accuracy"]["cnt"])}
    if acc != {b: c for b, c in ((True, right), (False, n_test - right)) if c}:
        raise AssertionError(f"classifier_accuracy {acc} differs from numpy's count {right}")

    # the kernel at the leg's shape: one commit of queries against the run's index mirror
    engine = max(held[0], key=rows_held)
    if rows_held(engine) != n_train or engine._mirror is None:
        raise AssertionError("the classifier's index does not hold every training row")
    q = torch.from_numpy(test[:MNIST_QUERY_COMMIT]).to(device)
    mirror, valid = engine._mirror, engine._mirror_valid
    s_k, i_k = topk_scores(q, mirror, k, engine.metric, valid=valid)
    s_p, i_p = topk_scores_plain(q, mirror, k + 1, engine.metric, valid=valid)
    check_topk_against_plain(s_k, i_k, s_p, i_p, topk_tolerance(s_p, q, mirror, engine.metric))
    err = (s_k - s_p[:, :k]).abs().max().item()
    sms = torch.cuda.get_device_properties(device).multi_processor_count \
        if device.type == "cuda" else 132
    route = plan(len(q), mirror.shape[0], MNIST_DIM, k, sms).route
    return {"s": s, "rows": n_train + n_test, "accuracy": right / n_test, "open": open_,
            "score_err": err, "metric": engine.metric, "index_rows": int(mirror.shape[0]),
            "route": route}


def plain_sql(sub: dict) -> dict:
    """Each of ``SQL_QUERIES``' answers as a Counter of rows, from numpy and Python."""
    bid, auction, person = sub["bid"], sub["auction"], sub["person"]
    keep = bid["auction"] % 123 == 0
    state = dict(zip(person["pid"].tolist(), zip(person["name"], person["state"])))
    q3 = collections.Counter(
        (state[s][0], state[s][1], a) for a, s, c in zip(
            auction["aid"].tolist(), auction["seller"].tolist(), auction["category"].tolist())
        if c == 10 and s in state and state[s][1] in ("OR", "ID", "CA"))
    per = group_max_count(bid["auction"], bid["price"])
    return {
        "q0": rows_of(bid, ["auction", "bidder", "price", "t"]),
        "q1": rows_of({**bid, "price": bid["price"].astype(np.float64) * 0.908},
                      ["auction", "bidder", "price", "t"]),
        "q2": rows_of({c: bid[c][keep] for c in ("auction", "price")}, ["auction", "price"]),
        "q3": q3,
        "per_auction": collections.Counter((a, c, m) for a, (m, c) in per.items()),
    }


SQL_COLUMNS = {"q0": ["auction", "bidder", "price", "t"], "q1": ["auction", "bidder", "price", "t"],
               "q2": ["auction", "price"], "q3": ["name", "state", "aid"],
               "per_auction": ["auction", "n", "top"]}


def run_sql(device, ev: dict, n_events: int, launches: dict) -> dict:
    """(b): ``SQL_QUERIES`` through ``pw.sql`` over the first ``n_events`` events, at 1 and 2
    workers, each output against numpy's."""
    sub = {kind: {c: v[:int(np.searchsorted(cols["n"], n_events))] for c, v in cols.items()}
           for kind, cols in ev.items()}
    want = plain_sql(sub)
    fed = sum(len(sub[k]["i"]) for k in ("bid", "auction", "person"))

    def build(pw):
        src = {kind: nexmark_source(pw, sub, kind, n_events) for kind in sub}
        return {name: pw.sql(q, **{k: src[k] for k in kinds})
                for name, (q, kinds) in SQL_QUERIES.items()}

    result = {}
    for workers in (1, 2):
        tag = f"stdlib_sql_{workers}w"
        out, s = nexmark_run(device, build, workers, tag, launches)
        for name, cols in SQL_COLUMNS.items():
            if rows_of(out[name], cols) != want[name]:
                raise AssertionError(f"pw.sql's {name} at {workers} workers differs from numpy's")
        result[tag] = {"s": s, "rows": fed, "out_rows": {n: sum(w.values())
                                                          for n, w in want.items()}}
    return result


def kronecker_edges(scale: int, edge_factor: int = 16, seed: int = 18):
    """Graph500's Kronecker generator (graph500.org, the specification's ``kronecker_generator``:
    initiator A=0.57, B=0.19, C=0.19, ``edge_factor`` x 2^scale edges, the vertex labels and
    then the edges permuted), seeded numpy; duplicate edges and self-loops kept."""
    rng = np.random.default_rng(seed + scale)
    n, m = 1 << scale, edge_factor << scale
    a, b, c = 0.57, 0.19, 0.19
    ab, c_norm, a_norm = a + b, c / (1 - (a + b)), a / (a + b)
    u = np.zeros(m, np.int64)
    v = np.zeros(m, np.int64)
    for bit in range(scale):
        ii = rng.random(m) > ab
        jj = rng.random(m) > np.where(ii, c_norm, a_norm)
        u += ii.astype(np.int64) << bit
        v += jj.astype(np.int64) << bit
    perm = rng.permutation(n)
    order = rng.permutation(m)
    return perm[u][order], perm[v][order]


def plain_pagerank(u: np.ndarray, v: np.ndarray, steps: int) -> dict:
    """``pw.graphs.pagerank``'s integer recurrence in numpy: {vertex: rank}."""
    verts = np.unique(np.r_[u, v])
    iu, iv = np.searchsorted(verts, u), np.searchsorted(verts, v)
    deg = np.bincount(iu, minlength=len(verts))
    rank = np.full(len(verts), 6_000, np.int64)
    for _ in range(steps):
        flow = np.where(deg == 0, 0, (rank * 5) // np.maximum(deg * 6, 1))
        recv = np.zeros(len(verts), np.int64)
        np.add.at(recv, iv, flow[iu])
        new = recv + 1_000
        if (new == rank).all():
            break
        rank = new
    return dict(zip(verts.tolist(), rank.tolist()))


def plain_bellman_ford(n: int, u, v, w, source: int) -> np.ndarray:
    """Distances from ``source`` by relaxing every edge until nothing changes (np.minimum.at
    keeps the least of duplicate edges)."""
    dist = np.full(n, np.inf)
    dist[source] = 0.0
    while True:
        new = dist.copy()
        np.minimum.at(new, v, dist[u] + w)
        if np.array_equal(new, dist):
            return dist
        dist = new


def plain_modularity(u, v, w, cluster: dict) -> tuple[float, int]:
    """``exact_modularity``'s sum over clusters of internal weight / m - (degree / 2m)^2."""
    cu = np.array([cluster[x] for x in u.tolist()])
    cv = np.array([cluster[x] for x in v.tolist()])
    m = float(w.sum())
    labels, inv = np.unique(np.r_[cu, cv], return_inverse=True)
    deg = np.zeros(len(labels))
    np.add.at(deg, inv, np.r_[w, w])
    internal = np.zeros(len(labels))
    same = cu == cv
    np.add.at(internal, inv[:len(u)][same], w[same])
    return math.fsum(internal / m - (deg / (2.0 * m)) ** 2), len(labels)


def edge_source(pw, u: np.ndarray, v: np.ndarray, w: np.ndarray | None = None):
    """``pw.io.python.read`` of the whole graph in one commit: each edge's index ``i`` (so that
    duplicates stay rows of their own), ``a``, ``b`` and, given, ``w``. One commit, because
    ``pw.iterate`` reruns its fixpoint from the inputs' whole state at each commit."""

    class Edges(pw.io.python.ConnectorSubject):
        def run(self):
            cols = {"i": np.arange(len(u)), "a": u, "b": v}
            if w is not None:
                cols["w"] = w
            self.next_batch(cols)
            self.commit()

    types = dict(i=int, a=int, b=int, **({"w": float} if w is not None else {}))
    return pw.io.python.read(Edges(), schema=pw.schema_from_types(**types),
                             autocommit_duration_ms=None)


def vertex_table(pw, n: int):
    """Vertices 0..n-1 keyed by ``pointer_from(node)``."""
    t = pw.debug.table_from_rows(pw.schema_from_types(node=int), [(i,) for i in range(n)])
    return t.with_id_from(t.node)


def run_graphs(device, launches: dict, scales: dict | None = None) -> dict:
    """(c): PageRank, Bellman-Ford and a Louvain level over Kronecker graphs, each against
    numpy."""
    scales = {**GRAPH_SCALES, **(scales or {})}
    result = {}

    sc = scales["pagerank"]
    u, v = kronecker_edges(sc)

    def build_pagerank(pw):
        verts = vertex_table(pw, 1 << sc)
        raw = edge_source(pw, u, v)
        ranks = pw.graphs.pagerank.pagerank(
            raw.select(u=verts.pointer_from(raw.a), v=verts.pointer_from(raw.b)), steps=5)
        return {"ranks": ranks.select(node=verts.ix(ranks.id).node, rank=ranks.rank)}

    out, s = nexmark_run(device, build_pagerank, 1, "stdlib_pagerank", launches)
    got = dict(zip(out["ranks"]["node"].tolist(), out["ranks"]["rank"].tolist()))
    if got != plain_pagerank(u, v, 5):
        raise AssertionError("pagerank differs from numpy's integer recurrence")
    result["pagerank"] = {"s": s, "rows": len(u), "scale": sc, "vertices": len(got)}

    sc = scales["bellman_ford"]
    n = 1 << sc
    u, v = kronecker_edges(sc)
    w = np.random.default_rng(sc).integers(1, 256, len(u)).astype(np.float64)
    source = int(np.bincount(u, minlength=n).argmax())

    def build_bellman_ford(pw):
        verts = vertex_table(pw, n)
        raw = edge_source(pw, u, v, w)
        dist = pw.graphs.bellman_ford.bellman_ford(
            verts.select(is_source=verts.node == source),
            raw.select(u=verts.pointer_from(raw.a), v=verts.pointer_from(raw.b), dist=raw.w))
        return {"dist": dist.select(node=verts.ix(dist.id).node, d=dist.dist_from_source)}

    out, s = nexmark_run(device, build_bellman_ford, 1, "stdlib_bellman_ford", launches)
    got = np.full(n, np.nan)
    got[out["dist"]["node"].astype(np.int64)] = out["dist"]["d"].astype(np.float64)
    want = plain_bellman_ford(n, u, v, w, source)
    if not np.array_equal(got, want):
        raise AssertionError("bellman_ford differs from numpy's relaxation")
    result["bellman_ford"] = {"s": s, "rows": len(u), "scale": sc,
                              "reached": int(np.isfinite(want).sum())}

    sc = scales["louvain"]
    n = 1 << sc
    u, v = kronecker_edges(sc)
    w = np.ones(len(u))

    def build_louvain(pw):
        from pathway_tpu_torch.stdlib.graphs.louvain_communities import (
            exact_modularity, louvain_communities)

        verts = vertex_table(pw, n)
        raw = edge_source(pw, u, v, w)
        g = pw.graphs.WeightedGraph.from_vertices_and_weighted_edges(
            verts, raw.select(u=verts.pointer_from(raw.a), v=verts.pointer_from(raw.b),
                              weight=raw.w))
        clusters = louvain_communities(g)
        return {"clusters": clusters.select(node=verts.ix(clusters.id).node,
                                            c=verts.ix(clusters.c).node),
                "q": exact_modularity(g, clusters)}

    out, s = nexmark_run(device, build_louvain, 1, "stdlib_louvain", launches)
    cluster = dict(zip(out["clusters"]["node"].tolist(), out["clusters"]["c"].tolist()))
    want_q, n_clusters = plain_modularity(u, v, w, cluster)
    (got_q,) = out["q"]["modularity"].tolist()
    if abs(got_q - want_q) > 1e-12 * n_clusters:
        raise AssertionError(f"exact_modularity {got_q!r} differs from numpy's {want_q!r}")
    result["louvain"] = {"s": s, "rows": len(u), "scale": sc, "clusters": n_clusters,
                         "modularity": got_q}
    return result


def run_stdlib(device, *, ev: dict | None = None, sql_events: int = SQL_EVENTS,
               graph_scales: dict | None = None) -> dict:
    """Phase 18: (a) the kNN classifier at MNIST's shape, (b) ``pw.sql`` over Nexmark (``ev``,
    phase 17's events, or the generator's anew), (c) the graph algorithms, each leg's output
    held against numpy, its rows/s (its input rows over the wall of ``pw.run``, host clock),
    seconds and launch counts logged with the card's name and power limit."""
    cuda = device.type == "cuda"
    card = card_line() if cuda else "cpu"
    result: dict = {"launches": {}, "legs": {}}
    watched = ("knn_topk", "expression_vm", "bucket_exchange")

    def counts(tag: str) -> str:
        return ", ".join(f"{k} {result['launches'][tag][k]}" for k in watched)

    knn = run_knn_classify(device, result["launches"])
    result["legs"]["stdlib_knn"] = knn
    log(f"stdlib (a) kNN classification, {MNIST_TRAIN} x {MNIST_DIM} training vectors and "
        f"{MNIST_TEST} queries, k=3, 1 worker: {knn['s']:.2f} s, {knn['rows'] / knn['s']:.1f} "
        f"rows/s; accuracy {knn['accuracy']:.4f}, equal to numpy's count; every label one the "
        f"plain scorer's top 3 votes for within its tolerance ({knn['open']} queries where the "
        f"tolerance leaves two labels open); knn_topk on the run's index ({knn['index_rows']} "
        f"x {MNIST_DIM}, {knn['metric']}, the {knn['route']} route) and {MNIST_QUERY_COMMIT} "
        f"queries against the plain "
        f"scorer: max |score err| {knn['score_err']:.3e}, ids equal where scores are clear of "
        f"the tolerance; launches: {counts('stdlib_knn')} [{card}]")
    if ev is None:
        ev = nexmark_events(max(NEXMARK_EVENTS, sql_events))
    sql = run_sql(device, ev, sql_events, result["launches"])
    result["legs"].update(sql)
    for tag, leg in sql.items():
        log(f"stdlib (b) pw.sql over {sql_events} Nexmark events at {tag[-2]} worker(s): "
            f"{leg['rows']} rows in {leg['s']:.2f} s, {leg['rows'] / leg['s']:.1f} rows/s; "
            f"output rows {leg['out_rows']}, each query equal to numpy's; launches: "
            f"{counts(tag)} [{card}]")
    graphs = run_graphs(device, result["launches"], graph_scales)
    for name, leg in graphs.items():
        tag = f"stdlib_{name}"
        result["legs"][tag] = leg
        extra = {k: v for k, v in leg.items() if k not in ("s", "rows", "scale")}
        log(f"stdlib (c) {name} at scale {leg['scale']} ({leg['rows']} edges), 1 worker: "
            f"{leg['s']:.2f} s, {leg['rows'] / leg['s']:.1f} rows/s; {extra}, equal to numpy's; "
            f"launches: {counts(tag)} [{card}]")
    total = sum(leg["s"] for leg in result["legs"].values())
    log(f"stdlib: the runs took {total:.1f} s of the phase's {STDLIB_BUDGET_S:.0f} "
        f"({', '.join(f'{k} {v['s']:.1f} s' for k, v in result['legs'].items())}) [{card}]")
    if cuda:
        if not result["launches"]["stdlib_knn"]["knn_topk"]:
            raise AssertionError("knn_topk not launched by the kNN classifier")
        if not any(result["launches"][f"stdlib_sql_{w}w"]["expression_vm"] for w in (1, 2)):
            raise AssertionError("expression_vm not launched by pw.sql")
    return result


# -- phase 19: the connectors over Nexmark --------------------------------------------------------

#: the first of phase 17's events whose bids each leg takes: (a) SQLite, (b) Delta Lake, and (c)
#: Debezium, which replays (a)'s change stream of the bids among its own first events. (a) was
#: halved from 500,000 (it re-reads the whole table each transaction, as the reference does), (b)
#: with it, and (c) cut to 50,000 (a commit an envelope, as the reference commits) to keep the
#: legs inside the phase's 60 s and the script inside its time (PERF.md section 4). (a) stays
#: at 250,000: its 25 insert transactions take the expression machine past its 16 warm-up
#: batches, and the phase holds the machine on (a)'s own program
CONNECTOR_LEG_EVENTS = {"sqlite": 250_000, "delta": 250_000, "debezium": 50_000}
CONNECTOR_TXN_EVENTS = 10_000  # events whose bids one transaction (one Delta version) inserts
CONNECTOR_CHANGE_TXNS = 10  # then transactions that change 10% of the prices and delete 5%
CONNECTOR_BUDGET_S = 60.0
CONNECTOR_WAIT_S = 120.0  # longest wait for the tick that reflects a write
BID_COLUMNS = ("i", "auction", "bidder", "price", "t")
#: each gated connector's client package, as the connector imports it
GATED_CLIENTS = {
    "kafka": "confluent_kafka", "redpanda": "confluent_kafka", "debezium (Kafka)": "confluent_kafka",
    "postgres": "psycopg", "postgres (psycopg2)": "psycopg2", "mongodb": "pymongo",
    "elasticsearch": "elasticsearch", "nats": "nats", "airbyte (docker)": "airbyte_serverless",
    "bigquery": "google.cloud.bigquery", "gdrive": "googleapiclient", "s3": "boto3",
    "minio": "boto3", "http": "requests", "logstash": "requests",
    "sharepoint": "office365", "pyfilesystem (fs)": "fs", "deltalake": "pyarrow",
}


def client_importable(module: str) -> bool:
    import importlib.util

    try:
        return importlib.util.find_spec(module) is not None
    except ModuleNotFoundError:  # a parent package is missing
        return False


def bid_plan(bid: dict, n_events: int, seed: int = 23) -> dict:
    """The bids of the first ``n_events`` events, their insert transactions (one a
    ``CONNECTOR_TXN_EVENTS`` events), and ``CONNECTOR_CHANGE_TXNS`` change transactions that give
    10% of the bids a new price and delete 5% others, none of them a bid of the first insert
    transaction (leg (b) removes that transaction's file), each bid changed at most once."""
    n_bids = int(np.searchsorted(bid["n"], n_events))
    cols = {c: np.ascontiguousarray(bid[c][:n_bids]) for c in BID_COLUMNS}
    cuts = np.searchsorted(bid["n"][:n_bids],
                           np.arange(0, n_events + CONNECTOR_TXN_EVENTS, CONNECTOR_TXN_EVENTS))
    inserts = [(int(lo), int(hi)) for lo, hi in zip(cuts[:-1], cuts[1:]) if hi > lo]
    rng = np.random.default_rng(seed)
    pool = rng.permutation(np.arange(inserts[0][1], n_bids))
    n_up, n_del = n_bids // 10, n_bids // 20
    up, gone = pool[:n_up], pool[n_up:n_up + n_del]
    new_price = np.rint(10.0 ** (rng.random(n_up) * 6.0) * 100.0).astype(np.int64)
    new_price += new_price == cols["price"][up]  # every update changes its row
    changes = [{"update": u, "price": p, "delete": d} for u, p, d in zip(
        np.array_split(up, CONNECTOR_CHANGE_TXNS), np.array_split(new_price, CONNECTOR_CHANGE_TXNS),
        np.array_split(gone, CONNECTOR_CHANGE_TXNS))]
    return {"cols": cols, "inserts": inserts, "changes": changes, "n_bids": n_bids}


def restrict_plan(plan: dict, bid: dict, n_events: int) -> dict:
    """``plan`` restricted to the bids of the first ``n_events`` events: its inserts and changes
    of those bids, in the same transactions."""
    n = int(np.searchsorted(bid["n"][:plan["n_bids"]], n_events))
    changes = [{"update": ch["update"][ch["update"] < n], "price": ch["price"][ch["update"] < n],
                "delete": ch["delete"][ch["delete"] < n]} for ch in plan["changes"]]
    return {"cols": {c: v[:n] for c, v in plan["cols"].items()}, "changes": changes,
            "inserts": [(lo, min(hi, n)) for lo, hi in plan["inserts"] if lo < n], "n_bids": n}


def plan_final(plan: dict, n_changes: int, dropped: tuple = ()) -> dict:
    """The bids' columns after the inserts and the first ``n_changes`` change transactions, less
    the rows of the insert transactions at the indices ``dropped``."""
    price = plan["cols"]["price"].copy()
    alive = np.ones(plan["n_bids"], dtype=bool)
    for ch in plan["changes"][:n_changes]:
        price[ch["update"]] = ch["price"]
        alive[ch["delete"]] = False
    for j in dropped:
        lo, hi = plan["inserts"][j]
        alive[lo:hi] = False
    return {c: (price if c == "price" else plan["cols"][c])[alive] for c in BID_COLUMNS}


def q1_per_auction(pw, bids):
    """Nexmark Q1's currency conversion, then the count and the largest converted price per
    auction."""
    q1 = bids.select(pw.this.auction, price_eur=pw.this.price * 0.908)
    return q1.groupby(pw.this.auction).reduce(pw.this.auction, n=pw.reducers.count(),
                                              top=pw.reducers.max(pw.this.price_eur))


def plain_q1_per_auction(final: dict) -> dict:
    """``q1_per_auction`` in numpy: {auction: (count, largest price * 0.908)}."""
    eur = final["price"].astype(np.float64) * 0.908
    order = np.lexsort((eur, final["auction"]))
    keys, vals = final["auction"][order], eur[order]
    ends = np.flatnonzero(np.r_[keys[1:] != keys[:-1], True])
    counts = np.diff(np.r_[-1, ends])
    return {int(k): (int(c), float(v)) for k, c, v in zip(keys[ends], counts, vals[ends])}


def check_bids(label: str, got: dict, want: dict, keys) -> None:
    """The leg's final table of bids (``live_rows(..., with_keys=True)``) against numpy's final
    rows: row by row by ``i``, and key by key against ``keys(want)``."""
    order = np.argsort(got["i"], kind="stable")
    if len(order) != len(want["i"]):
        raise AssertionError(f"{label}: {len(order)} bids, numpy has {len(want['i'])}")
    for c in BID_COLUMNS:
        if not (np.asarray(got[c])[order] == want[c]).all():
            raise AssertionError(f"{label}: column {c} differs from numpy's")
    if not (got["__key__"][order] == keys(want)).all():
        raise AssertionError(f"{label}: the row keys differ from the keys of numpy's rows")


def check_per_auction(label: str, got: dict, want: dict) -> int:
    table = {int(a): (int(n), float(t)) for a, n, t in zip(got["auction"], got["n"], got["top"])}
    if table != want:
        raise AssertionError(f"{label}: the count and largest price per auction differ from "
                             f"numpy's")
    return len(table)


def pk_keys(final: dict) -> np.ndarray:
    """The port's row keys of rows whose primary key is ``i`` (sqlite's ``hash_values`` of the
    key tuple; the python connector's ``mix_columns`` of the key column is the same key)."""
    from pathway_tpu_torch.engine import keys as K

    return K.hash_values([(int(i),) for i in final["i"]], register=False)


def content_keys(final: dict) -> np.ndarray:
    """The port's row keys of Delta rows: the hash of each row's data tuple."""
    from pathway_tpu_torch.engine import keys as K

    cols = [final[c].tolist() for c in BID_COLUMNS]
    return K.hash_values(list(zip(*cols)), register=False)


def bid_schema(pw):
    return pw.schema_builder({c: pw.column_definition(dtype=int, primary_key=c == "i")
                              for c in BID_COLUMNS})


class ReflectedRows:
    """``on_batch`` of a source table: counts the rows of its ticks so that a writer can wait for
    the tick that reflects what it wrote, and keeps the batches for ``live_rows``."""

    def __init__(self, pw, table):
        self.seen = subscribed(pw, table)
        import threading

        self.count = 0
        self.cond = threading.Condition()
        pw.io.subscribe(table, on_batch=self._on_batch)

    def _on_batch(self, time_, batch) -> None:
        with self.cond:
            self.count += len(batch.keys)
            self.cond.notify_all()

    def wait_for(self, n: int) -> None:
        with self.cond:
            if not self.cond.wait_for(lambda: self.count >= n, timeout=CONNECTOR_WAIT_S):
                raise AssertionError(f"no tick reflected {n} rows within {CONNECTOR_WAIT_S} s "
                                     f"(saw {self.count})")


def run_while_writing(device, write, tag: str, launches: dict) -> tuple[float, float]:
    """``pw.run(device=)`` at 1 worker while ``write()`` runs on a thread; ``write`` returns once
    the tick that reflects its last write has come, and the run is stopped then. Returns (seconds
    from ``pw.run`` to that tick, seconds of the run)."""
    import threading

    import pathway_tpu_torch as pw

    errors: list = []
    marks: dict = {}

    def writer() -> None:
        try:
            write()
            marks["end"] = time.perf_counter()
        except BaseException as e:  # raised below, after the run
            errors.append(e)
        finally:
            pw.request_stop()

    env = {"PATHWAY_THREADS": "1", "PATHWAY_INGEST_COALESCE_WINDOWS": "0"}
    th = threading.Thread(target=writer, daemon=True)
    with scoped_env(env), counted(tag, launches):
        try:
            t0 = time.perf_counter()
            th.start()
            pw.run(device=device)
            run_s = time.perf_counter() - t0
        finally:
            th.join(CONNECTOR_WAIT_S)
            pw.G.clear()
    if errors:
        raise errors[0]
    return marks["end"] - t0, run_s


def sqlite_leg(device, plan: dict, work: str, launches: dict) -> dict:
    """(a): a writer fills a SQLite file (WAL) with the plan's insert transactions, then its
    change transactions, each after the tick that reflects the one before;
    ``pw.io.sqlite.read(mode="streaming")`` feeds ``q1_per_auction``."""
    import sqlite3

    import pathway_tpu_torch as pw

    db = os.path.join(work, "bids.db")
    con = sqlite3.connect(db, check_same_thread=False)
    con.execute("PRAGMA journal_mode=WAL")
    con.execute("CREATE TABLE bids (i INTEGER PRIMARY KEY, auction INTEGER, bidder INTEGER, "
                "price INTEGER, t INTEGER)")
    con.commit()
    cols = plan["cols"]
    rows = list(zip(*(cols[c].tolist() for c in BID_COLUMNS)))
    pw.G.clear()
    t = pw.io.sqlite.read(db, "bids", bid_schema(pw), mode="streaming")
    raw = ReflectedRows(pw, t)
    per_auction = subscribed(pw, q1_per_auction(pw, t))
    written = {"inserts": 0, "updates": 0, "deletes": 0}

    def write() -> None:
        want = 0
        for lo, hi in plan["inserts"]:
            con.executemany("INSERT INTO bids VALUES (?, ?, ?, ?, ?)", rows[lo:hi])
            con.commit()
            written["inserts"] += hi - lo
            want += hi - lo
            raw.wait_for(want)
        for ch in plan["changes"]:
            con.executemany("UPDATE bids SET price = ? WHERE i = ?",
                            zip(ch["price"].tolist(), cols["i"][ch["update"]].tolist()))
            con.executemany("DELETE FROM bids WHERE i = ?",
                            [(i,) for i in cols["i"][ch["delete"]].tolist()])
            con.commit()
            written["updates"] += len(ch["update"])
            written["deletes"] += len(ch["delete"])
            want += 2 * len(ch["update"]) + len(ch["delete"])
            raw.wait_for(want)

    try:
        to_last, run_s = run_while_writing(device, write, "connectors_sqlite", launches)
        db_rows = con.execute("SELECT i, auction, bidder, price, t FROM bids ORDER BY i").fetchall()
    finally:
        con.close()
    final = plan_final(plan, len(plan["changes"]))
    if db_rows != list(zip(*(final[c].tolist() for c in BID_COLUMNS))):
        raise AssertionError("sqlite: the database's final rows differ from numpy's")
    check_bids("sqlite", live_rows(raw.seen, list(BID_COLUMNS), with_keys=True), final, pk_keys)
    groups = check_per_auction("sqlite", live_rows(per_auction, ["auction", "n", "top"]),
                               plain_q1_per_auction(final))
    n_written = sum(written.values())
    return {"s": to_last, "run_s": run_s, "rows": n_written, "written": written,
            "rows_per_s": n_written / to_last, "groups": groups, "final_rows": len(final["i"]),
            "db": db}


def delta_leg(device, plan: dict, work: str, launches: dict) -> dict:
    """(b): the plan's insert transactions through ``pw.io.python`` into
    ``pw.io.deltalake.write`` (a Delta version a transaction), then
    ``pw.io.deltalake.read(mode="streaming")`` while a writer appends all but the last of the
    change transactions as versions and a last version that removes the first transaction's
    file."""
    from types import SimpleNamespace

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.io.deltalake import (DeltaTableWriter, _list_versions,
                                                _read_file_rows, _version_actions)

    uri = os.path.join(work, "bids_delta")
    cols = plan["cols"]
    names = list(BID_COLUMNS)
    pw.G.clear()

    class Feed(pw.io.python.ConnectorSubject):
        def run(self):
            for lo, hi in plan["inserts"]:
                self.next_batch({c: cols[c][lo:hi] for c in names})
                self.commit()

    src = pw.io.python.read(Feed(), schema=pw.schema_from_types(**{c: int for c in names}),
                            autocommit_duration_ms=None)
    pw.io.deltalake.write(src, uri, min_commit_frequency=None)
    with scoped_env({"PATHWAY_THREADS": "1", "PATHWAY_INGEST_COALESCE_WINDOWS": "0"}), \
            counted("connectors_delta_write", launches):
        try:
            t0 = time.perf_counter()
            pw.run(device=device)
            write_s = time.perf_counter() - t0
        finally:
            pw.G.clear()
    versions = _list_versions(uri)
    (first_file,), _ = _version_actions(uri, versions[1])
    lo, hi = plan["inserts"][0]
    first_i = sorted(r[0] for r in _read_file_rows(uri, first_file, names))
    if first_i != cols["i"][lo:hi].tolist():
        raise AssertionError("deltalake: version 1 does not hold the first transaction's bids")
    changes = plan["changes"][:-1]
    n_inserted = plan["n_bids"]

    t = pw.io.deltalake.read(uri, schema=pw.schema_from_types(**{c: int for c in names}),
                             mode="streaming", autocommit_duration_ms=100)
    raw = ReflectedRows(pw, t)
    per_auction = subscribed(pw, q1_per_auction(pw, t))

    def write() -> None:
        writer = DeltaTableWriter(uri, names, None, min_commit_frequency_ms=None)
        want = n_inserted
        for k, ch in enumerate(changes):
            before = {c: cols[c][np.r_[ch["update"], ch["delete"]]] for c in names}
            after = {c: cols[c][ch["update"]] for c in names}
            after["price"] = ch["price"]
            data = {c: np.r_[before[c], after[c]].tolist() for c in names}
            diffs = [-1] * len(before["i"]) + [1] * len(after["i"])
            writer.add_batch(len(versions) + k, SimpleNamespace(data=data, diffs=diffs))
            writer.flush()
            want += len(diffs)
        writer._commit_actions([{"remove": {"path": first_file, "dataChange": True}}])
        raw.wait_for(want + hi - lo)

    to_last, run_s = run_while_writing(device, write, "connectors_delta_read", launches)
    final = plan_final(plan, len(changes), dropped=(0,))
    check_bids("deltalake", live_rows(raw.seen, names, with_keys=True), final, content_keys)
    groups = check_per_auction("deltalake", live_rows(per_auction, ["auction", "n", "top"]),
                               plain_q1_per_auction(final))
    read_rows = raw.count
    return {"write_s": write_s, "write_rows_per_s": n_inserted / write_s,
            "versions_written": len(versions) - 1, "s": to_last, "run_s": run_s,
            "read_rows": read_rows, "rows_per_s": read_rows / to_last, "groups": groups,
            "final_rows": len(final["i"]), "versions_appended": len(changes) + 1}


def debezium_envelopes(plan: dict, path: str) -> int:
    """The plan's change stream as Debezium envelopes in a jsonlines file: an insert ``c``, an
    update ``u`` (before and after), a delete ``d`` (before), in transaction order."""
    cols = plan["cols"]
    rows = list(zip(*(cols[c].tolist() for c in BID_COLUMNS)))
    n = 0
    with open(path, "w") as f:
        def emit(op, before, after):
            payload = {"op": op}
            if before is not None:
                payload["before"] = dict(zip(BID_COLUMNS, before))
            if after is not None:
                payload["after"] = dict(zip(BID_COLUMNS, after))
            f.write(json.dumps({"payload": payload}) + "\n")

        for lo, hi in plan["inserts"]:
            for r in rows[lo:hi]:
                emit("c", None, r)
            n += hi - lo
        for ch in plan["changes"]:
            for j, p in zip(ch["update"].tolist(), ch["price"].tolist()):
                emit("u", rows[j], rows[j][:3] + (p,) + rows[j][4:])
            for j in ch["delete"].tolist():
                emit("d", rows[j], None)
            n += len(ch["update"]) + len(ch["delete"])
    return n


def debezium_leg(device, plan: dict, work: str, launches: dict) -> dict:
    """(c): (a)'s change stream as Debezium envelopes through ``pw.io.debezium.read`` over the
    file transport into ``q1_per_auction``."""
    import pathway_tpu_torch as pw

    path = os.path.join(work, "bids_cdc.jsonl")
    n_envelopes = debezium_envelopes(plan, path)
    pw.G.clear()
    t = pw.io.debezium.read(input_file=path, schema=bid_schema(pw), autocommit_duration_ms=None)
    raw = subscribed(pw, t)
    per_auction = subscribed(pw, q1_per_auction(pw, t))
    with scoped_env({"PATHWAY_THREADS": "1"}), counted("connectors_debezium", launches):
        try:
            t0 = time.perf_counter()
            pw.run(device=device)
            s = time.perf_counter() - t0
        finally:
            pw.G.clear()
    final = plan_final(plan, len(plan["changes"]))
    check_bids("debezium", live_rows(raw, list(BID_COLUMNS), with_keys=True), final, pk_keys)
    groups = check_per_auction("debezium", live_rows(per_auction, ["auction", "n", "top"]),
                               plain_q1_per_auction(final))
    return {"s": s, "rows": n_envelopes, "rows_per_s": n_envelopes / s, "groups": groups,
            "final_rows": len(final["i"])}


@contextlib.contextmanager
def first_program(into: dict):
    """Keep the first program that the expression machine's host launcher runs in the block, with
    its input columns (the phase's own lowered program and one of its batches)."""
    from pathway_tpu_torch.ops import expression_kernel as vm

    real = vm.HostLauncher.run

    def run(self, program, cols, n):
        if "program" not in into:
            into.update(program=program, cols=[np.array(c) for c in cols], n=n)
        return real(self, program, cols, n)

    vm.HostLauncher.run = run
    try:
        yield
    finally:
        vm.HostLauncher.run = real


def check_first_program(device, captured: dict) -> dict:
    """``expression_vm`` against its plain version on the captured program and batch: every
    output column bitwise."""
    from pathway_tpu_torch.ops.expression_kernel import run_program, run_program_plain

    prog, n = captured["program"], captured["n"]
    inputs = [torch.from_numpy(np.ascontiguousarray(
        c.view(np.int64) if c.dtype == np.uint64 else c)).to(device) for c in captured["cols"]]
    got, want = run_program(prog, inputs), run_program_plain(prog, inputs)
    torch.cuda.synchronize()
    err = 0.0
    for (name, _), g, w in zip(prog.outputs, got, want):
        if not torch.equal(g, w):
            raise AssertionError(f"expression_vm: output {name} of the phase's program differs "
                                 f"from its plain version")
        if g.dtype.is_floating_point:
            err = max(err, float((g - w).abs().max()) if g.numel() else 0.0)
    return {"rows": n, "instructions": int(prog.code.shape[0]), "max_abs_err": err}


def run_connectors(device, *, ev: dict | None = None, leg_events: dict | None = None) -> dict:
    """Phase 19: the bids of phase 17's events (``ev``, or the generator's anew) through (a)
    SQLite CDC, (b) Delta Lake and (c) Debezium, each leg's tables held against numpy's on the
    same rows; ``expression_vm`` held against its plain version on (a)'s program and batch; each
    leg's rows/s (host clock) and launch counts logged with the card's name and power limit; and
    which gated connectors' client packages this machine has."""
    import shutil
    import tempfile

    cuda = device.type == "cuda"
    card = card_line() if cuda else "cpu"
    leg_events = {**CONNECTOR_LEG_EVENTS, **(leg_events or {})}
    if ev is None:
        ev = nexmark_events(max(leg_events.values()))
    result: dict = {"launches": {}, "legs": {}}
    log("connectors: client packages importable here: " + ", ".join(
        f"{name} ({mod}) {'yes' if client_importable(mod) else 'no'}"
        for name, mod in GATED_CLIENTS.items()))
    work = tempfile.mkdtemp(prefix="connectors_phase_")
    captured: dict = {}
    try:
        plan = bid_plan(ev["bid"], leg_events["sqlite"])
        with first_program(captured):
            a = sqlite_leg(device, plan, work, result["launches"])
        result["legs"]["sqlite"] = a
        log(f"connectors (a) SQLite CDC over the bids of {leg_events['sqlite']} events: "
            f"{a['rows']} rows written ({a['written']['inserts']} inserts, "
            f"{a['written']['updates']} updates, {a['written']['deletes']} deletes in "
            f"{len(plan['inserts']) + len(plan['changes'])} transactions) in {a['s']:.2f} s to "
            f"the tick of the last, {a['rows_per_s']:.1f} rows/s; {a['final_rows']} bids and "
            f"{a['groups']} auctions, equal to numpy's; expression_vm launches "
            f"{result['launches']['connectors_sqlite']['expression_vm']} [{card}]")
        if captured:
            held = check_first_program(device, captured) if cuda else None
            if held is not None:
                result["held"] = held
                log(f"connectors: expression_vm against its plain version on (a)'s program "
                    f"({held['instructions']} instructions) and batch of {held['rows']} rows: "
                    f"every output equal bitwise [{card}]")
        plan_b = plan if leg_events["delta"] == leg_events["sqlite"] else bid_plan(
            ev["bid"], leg_events["delta"])
        b = delta_leg(device, plan_b, work, result["launches"])
        result["legs"]["delta"] = b
        log(f"connectors (b) Delta Lake over the bids of {leg_events['delta']} events: written "
            f"through pw.io.python in {b['write_s']:.2f} s ({b['versions_written']} versions), "
            f"{b['write_rows_per_s']:.1f} rows/s; read streaming while {b['versions_appended']} "
            f"versions were appended (the last removes version 1's file): {b['read_rows']} rows "
            f"in {b['s']:.2f} s to the tick of the last, {b['rows_per_s']:.1f} rows/s; "
            f"{b['final_rows']} bids and {b['groups']} auctions, equal to numpy's; expression_vm "
            f"launches {result['launches']['connectors_delta_write']['expression_vm']} (write), "
            f"{result['launches']['connectors_delta_read']['expression_vm']} (read) [{card}]")
        plan_c = restrict_plan(plan, ev["bid"], min(leg_events["debezium"],
                                                    leg_events["sqlite"]))
        c = debezium_leg(device, plan_c, work, result["launches"])
        result["legs"]["debezium"] = c
        log(f"connectors (c) Debezium over the change stream of the bids of "
            f"{leg_events['debezium']} events: {c['rows']} envelopes in {c['s']:.2f} s, "
            f"{c['rows_per_s']:.1f} rows/s; {c['final_rows']} bids key by key and {c['groups']} "
            f"auctions, equal to numpy's; expression_vm launches "
            f"{result['launches']['connectors_debezium']['expression_vm']} [{card}]")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    a.pop("db", None)
    total = a["s"] + b["write_s"] + b["s"] + c["s"]
    result["s"] = total
    log(f"connectors: the runs took {total:.1f} s of the phase's {CONNECTOR_BUDGET_S:.0f} "
        f"(sqlite {a['s']:.1f} s, delta write {b['write_s']:.1f} s, delta read {b['s']:.1f} s, "
        f"debezium {c['s']:.1f} s) [{card}]")
    if cuda:
        if not any(v["expression_vm"] for v in result["launches"].values()):
            raise AssertionError("expression_vm not launched by the connectors phase")
        if "held" not in result:
            raise AssertionError("expression_vm: no program of the phase was captured")
    return result


# -- phase 20: RAG question answering over HTTP, and the last root names -------------------------

QA_TOPK = 6  # the standard answerer's search_topk
QA_ADAPTIVE = {"n_starting_documents": 2, "factor": 2, "max_iterations": 4}
QA_PLANT_EVERY = 512  # one document in 512 is planted so that its parse raises
QA_PLANTED = b"%planted: this document fails its parse\n"
RERANK_K = 3
# the reranker's cosine against the one from a batched ``embed_texts_device``: each text runs at
# its own length bucket (16-128 tokens) in both, its pad columns masked out, so its embedding is
# the same whatever else the batch holds; the two cosines differ only in how their 384 products
# are summed (the reranker's in float64 over the f32 embeddings, here an f32 dot on the card, at
# most 384 f32 epsilons of the sum of |products|, 2.3e-5 for unit vectors) and in the reranker's
# normalisation of its vectors
RERANK_ATOL = 1e-4
QA_BUDGET_S = 60.0

#: what the phase's chats, parser and documents read (filled by ``run_qa`` before each run)
QA_STATE: dict = {}


def qa_prompt(query: str, texts) -> str:
    """The standard answerer's prompt: the question and its context texts as JSON, in order."""
    return json.dumps({"query": query, "texts": list(texts)})


def qa_prompt_template():
    return qa_prompt


@functools.cache
def qa_classes() -> dict:
    """The phase's parser and its two deterministic chats (``BaseChat`` subclasses)."""
    import threading

    from pathway_tpu_torch.xpacks.llm import prompts
    from pathway_tpu_torch.xpacks.llm.llms import BaseChat
    from pathway_tpu_torch.xpacks.llm.parsers import ParseLocal

    lock = threading.Lock()

    class PlantedParser(ParseLocal):
        """``ParseLocal``, raising on a planted document."""

        def __wrapped__(self, contents, **kwargs):
            if bytes(contents).startswith(QA_PLANTED):
                raise ValueError("a planted document fails its parse")
            return super().__wrapped__(contents, **kwargs)

    class PathChat(BaseChat):
        """Answers with the path of each context text, in prompt order (``qa_prompt``); a
        summary request with the number of texts it got."""

        def _call_model(self, messages, **kwargs):
            content = messages[-1]["content"]
            if content.startswith("Summarize"):
                body = content.split("\n\n", 1)[1].rsplit("\n\nSummary:", 1)[0]
                return f"a summary of {len(body.splitlines())} texts"
            return "\n".join(QA_STATE["path_of"][t] for t in json.loads(content)["texts"])

    class SentinelChat(BaseChat):
        """Answers only when its question's sentinel text is among the prompt's articles, and
        otherwise with ``NO_INFO_ANSWER``; counts its calls by question and number of
        articles."""

        def _call_model(self, messages, **kwargs):
            content = messages[-1]["content"]
            articles, question = content.split("Articles:\n", 1)[1].rsplit("\n\nQ: ", 1)
            question = question.removesuffix("\nA:")
            with lock:
                QA_STATE["calls"][(question, len(articles))] += 1
            if QA_STATE["sentinel"][question] in articles:
                return f"the sentinel of {question}"
            return prompts.NO_INFO_ANSWER

    return {"parser": PlantedParser, "paths": PathChat, "sentinel": SentinelChat}


def qa_parser():
    return qa_classes()["parser"]()


def qa_chat(kind: str):
    return qa_classes()[kind]()


def qa_encoder():
    return QA_STATE["encoder"]


def qa_docs_table():
    """The phase's documents through a ``ConnectorSubject`` in commits of ``docs_commit``."""
    import pathway_tpu_torch as pw

    docs, commit = QA_STATE["docs"], QA_STATE["docs_commit"]

    class Docs(pw.io.python.ConnectorSubject):
        def run(self):
            for s in range(0, len(docs), commit):
                part = docs[s:s + commit]
                self.next_batch({"data": [d for d, _ in part],
                                 "_metadata": [m for _, m in part]})
                self.commit()

    return pw.io.python.read(Docs(), schema=pw.schema_from_types(data=bytes, _metadata=dict),
                             autocommit_duration_ms=None)


#: leg (e): (a)'s store and standard answerer as one YAML description
QA_YAML = """
$encoder: !{mod}.qa_encoder {{}}
$docs: !{mod}.qa_docs_table {{}}
store: !pw.xpacks.llm.document_store.DocumentStore
  docs: $docs
  retriever_factory: !pw.indexing.BruteForceKnnFactory
    dimensions: {dim}
    embedder: $encoder
  parser: !{mod}.qa_parser {{}}
  splitter: !pw.xpacks.llm.splitters.TokenCountSplitter
    max_tokens: 256
answerer: !pw.xpacks.llm.question_answering.BaseRAGQuestionAnswerer
  llm: !{mod}.qa_chat
    kind: paths
  indexer: $store
  search_topk: {k}
  prompt_template: !{mod}.qa_prompt_template {{}}
"""


def geometric_calls(rank: int, n: int, factor: int, max_iterations: int) -> int:
    """The chat calls the geometric strategy makes before a document at ``rank`` (1-based) is in
    its context: n, n * factor, ... documents, at most ``max_iterations`` asks."""
    calls = 1
    while n < rank and calls < max_iterations:
        n, calls = n * factor, calls + 1
    return calls


@contextlib.contextmanager
def kernel_inputs(into: dict, when=None):
    """Keep the inputs of the block's first ``masked_attention`` launch at B=1 and of its first
    ``knn_topk`` launch (the embedder's and the index engine's own calls); with ``when``, those
    of the last launches made while ``when()`` holds (a query tick's), cut to their first
    query."""
    from pathway_tpu_torch.models import embedder as emb_mod
    from pathway_tpu_torch.ops import index_engines

    attn, topk = emb_mod.masked_attention, index_engines.topk_scores

    def attention(q, k, v, mask, *a, **kw):
        if when is not None and when():
            into["attention"] = tuple(t[:1].detach().clone() for t in (q, k, v, mask))
        elif when is None and q.shape[0] == 1 and "attention" not in into:
            into["attention"] = tuple(t.detach().clone() for t in (q, k, v, mask))
        return attn(q, k, v, mask, *a, **kw)

    def scores(queries, index, k, metric, *a, **kw):
        if (when() if when is not None else "knn" not in into):
            into["knn"] = (queries[:1].detach().clone() if when is not None
                           else queries.detach().clone(), index.detach().clone(), k, metric,
                           {n: (t.detach().clone() if torch.is_tensor(t) else t)
                            for n, t in kw.items()})
        return topk(queries, index, k, metric, *a, **kw)

    emb_mod.masked_attention, index_engines.topk_scores = attention, scores
    try:
        yield
    finally:
        emb_mod.masked_attention, index_engines.topk_scores = attn, topk


def check_phase_kernels(captured: dict, label: str = "phase 20") -> dict:
    """``masked_attention`` at B=1 and ``knn_topk`` at the question's shape, each on the inputs
    the phase gave it, against the plain version (the attention within ATTN_ATOL + ATTN_RTOL, the
    scores within one bf16 ulp, ids equal where the scores are clear)."""
    from pathway_tpu_torch.ops.knn import topk_scores, topk_scores_plain

    q, k, v, mask = captured["attention"]
    attn_err = attention_error(f"{label} B=1 S={q.shape[2]}", q, k, v, mask)
    queries, index, kk, metric, kw = captured["knn"]
    s_k, i_k = topk_scores(queries, index, kk, metric, **kw)
    s_p, i_p = topk_scores_plain(queries, index, kk + 1, metric, **kw)
    torch.cuda.synchronize()
    check_topk_against_plain(s_k, i_k, s_p, i_p, topk_tolerance(s_p, queries, index, metric))
    knn_err = (s_k - s_p[:, :kk]).abs().max().item()
    return {"attention_shape": tuple(q.shape), "attention_err": attn_err,
            "knn_shape": (queries.shape[0], index.shape[0], queries.shape[1], kk),
            "knn_err": knn_err}


def ask_all(client, questions: list, **kw) -> tuple[list, list]:
    """Each question through ``client.answer``: the answers and each request's ms (host
    clock)."""
    answers, ms = [], []
    for q in questions:
        t = time.perf_counter()
        answers.append(client.answer(q, **kw))
        ms.append((time.perf_counter() - t) * 1e3)
    return answers, ms


def context_pairs(answer: dict) -> list:
    """An answer's context documents as [(text, score)]: ``dist`` is the negated score."""
    return [(d["text"], -float(d["dist"])) for d in answer["context_docs"]]


def run_qa_servers(device, encoder, *, warm: list, questions: list, k: int, launches: dict,
                   captured: dict) -> dict:
    """Legs (a) and (b) in one ``pw.run`` (two servers over one store), with (e)'s analysis
    before it and its error log in it. The launch counts, each zeroed before its block and read
    after it: the fill, the warm-up answers and the other routes in ``launches["qa"]``, (a)'s
    timed requests in ``["qa_answer"]`` and (b)'s in ``["qa_adaptive"]``; the direct search
    between them counts in none."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.xpacks.llm import prompts
    from pathway_tpu_torch.xpacks.llm.document_store import DocumentStore
    from pathway_tpu_torch.xpacks.llm.question_answering import (
        AdaptiveRAGQuestionAnswerer, BaseRAGQuestionAnswerer, RAGClient)
    from pathway_tpu_torch.xpacks.llm.servers import QARestServer, QASummaryRestServer
    from pathway_tpu_torch.xpacks.llm.splitters import TokenCountSplitter

    docs_in = QA_STATE["docs"]
    pw.G.clear()
    store = DocumentStore(qa_docs_table(), pw.indexing.BruteForceKnnFactory(
        dimensions=encoder.cfg.dim, embedder=encoder),
        parser=qa_parser(), splitter=TokenCountSplitter(max_tokens=256))
    engines = keep_engines(store.index)
    chunks: dict = {}
    pw.io.subscribe(store.chunked_documents, on_change=lambda key, row, time, is_addition: (
        chunks.__setitem__(int(key), (row["text"], row["_metadata"]["path"]))
        if is_addition else None))
    errors = collections.Counter()
    pw.io.subscribe(pw.global_error_log(), on_change=lambda key, row, time, is_addition: (
        errors.update({(row["context"], row["message"]): 1 if is_addition else -1})))
    rag = BaseRAGQuestionAnswerer(qa_chat("paths"), store, search_topk=k,
                                  prompt_template=qa_prompt)
    adaptive = AdaptiveRAGQuestionAnswerer(qa_chat("sentinel"), store, **QA_ADAPTIVE)
    port, port_b = free_port(), free_port()
    server = QASummaryRestServer("127.0.0.1", port, rag)
    QARestServer("127.0.0.1", port_b, adaptive)  # registers its routes; the one run serves both

    out: dict = {}
    with counted("qa_analysis", launches):
        t0 = time.perf_counter()
        report = pw.analyze(device=device)
        out["analyze_s"] = time.perf_counter() - t0
        report_cpu = pw.analyze(device="cpu")
    if any(launches["qa_analysis"].values()):
        raise AssertionError(f"pw.analyze launched kernels: {launches['qa_analysis']}")
    out["analysis"] = {"operators": report.stats["operators"],
                       "ids": collections.Counter(d.id for d in report.diagnostics),
                       "cpu_ids": collections.Counter(d.id for d in report_cpu.diagnostics)}
    if [d.id for d in report.diagnostics] != [d.id for d in report_cpu.diagnostics]:
        raise AssertionError("pw.analyze: the card's diagnostics differ from the host's")
    del engines[:]  # the analyses' engines; the run builds its own

    n_planted = sum(d.startswith(QA_PLANTED) for d, _ in docs_in)
    client, client_b = (RAGClient(url=f"http://127.0.0.1:{p}", timeout=120)
                        for p in (port, port_b))
    t0 = time.perf_counter()
    server.run(threaded=True, device=device)
    try:
        # the fill, the warm-up answers and one call of each other route; then, outside every
        # counted window (the engine idle: an answer's launches are made before it returns), the
        # direct search that the answers are held against
        with counted("qa", launches):
            out["fill_s"] = wait_for_count(server, port, len(docs_in), 900) - t0
            n_chunks = len(chunks)
            held = {rows_held(e) for e in engines}
            if held != {n_chunks}:
                raise AssertionError(f"the engines hold {held} chunks, the store {n_chunks}")
            QA_STATE["path_of"] = {text: path for text, path in chunks.values()}
            text_of = {key: text for key, (text, _) in chunks.items()}
            warm_answers, _ = ask_all(client, warm, return_context_docs=True)
            status, retrieved = post_json(port, "/v1/retrieve", {"query": questions[0], "k": k})
            if status != 200:
                raise AssertionError(f"/v1/retrieve answered {status}")
            want_stats = {"file_count": len(docs_in),
                          "last_modified": max(m["modified_at"] for _, m in docs_in)}
            status, stats = post_json(port, "/v1/statistics", {})
            if status != 200 or stats != want_stats:
                raise AssertionError(f"/v1/statistics answered {stats}, the documents "
                                     f"{want_stats}")
            status, body = post_json(port, "/v2/list_documents", {})
            if status != 200 or sorted(d["path"] for d in body) != sorted(
                    m["path"] for _, m in docs_in):
                raise AssertionError("/v2/list_documents does not list every document")
            texts = [t for t, _ in context_pairs(warm_answers[0])]
            status, body = post_json(port, "/v1/pw_ai_summary", {"text_list": texts})
            expect = qa_chat("paths").__wrapped__(prompts.prompt_summarize(texts))
            if status != 200 or body != expect:
                raise AssertionError(f"/v1/pw_ai_summary answered {body!r}, not {expect!r}")
            out["stats"] = stats
        direct = engines[0].search(questions, [17] * len(questions), [None] * len(questions))
        # one beyond the answer's k, so that a near tie across its last place may swap
        want = {i: [(text_of[key], s) for key, s in row[:k + 1]]
                for i, row in enumerate(direct)}
        check_answers("qa /v1/retrieve", {0: answer_pairs(retrieved, lambda d: d["text"])},
                      {0: want[0]}, extra=1)

        # (a) the standard answerer: each answer's paths against its context, the context
        # against the direct search
        with counted("qa_answer", launches), kernel_inputs(captured):
            answers, ms = ask_all(client, questions, return_context_docs=True)
        got = {i: context_pairs(a) for i, a in enumerate(answers)}
        for i, a in enumerate(answers):
            paths = [QA_STATE["path_of"][t] for t, _ in got[i]]
            if a["response"].split("\n") != paths:
                raise AssertionError(f"(a) answer {i}: the chat's paths {a['response']!r} "
                                     f"are not its context's {paths}")
        swapped = check_answers("qa answers", got, want, extra=1)
        out["a"] = {"p50": float(np.percentile(ms, 50)),
                    "p95": float(np.percentile(ms, 95)),
                    "p99": float(np.percentile(ms, 99)), "swapped": swapped,
                    "answers": answers, "slowest": (int(np.argmax(ms)), float(max(ms))),
                    "per_request": {n: launches["qa_answer"][n] / len(questions)
                                    for n in ("masked_attention", "knn_topk")}}

        # (b) the adaptive answerer: a sentinel at a known rank (1 to 16) of each question's
        # direct search; its rank in the run's own context (the same, but inside a near tie)
        # sets the geometric rule's answer and chat calls
        planted, QA_STATE["sentinel"] = {}, {}
        QA_STATE["calls"] = collections.Counter()
        for i, q in enumerate(questions):
            planted[q] = i % 16 + 1
            QA_STATE["sentinel"][q] = text_of[direct[i][i % 16][0]]
        with counted("qa_adaptive", launches):
            answers_b, ms_b = ask_all(client_b, questions, return_context_docs=True)
        full = {i: [(text_of[key], s) for key, s in row] for i, row in enumerate(direct)}
        swapped_b = check_answers("qa adaptive contexts",
                                  {i: context_pairs(a) for i, a in enumerate(answers_b)},
                                  full, extra=1)
        # each question's answer runs twice, once for its row and once more for the row's
        # retraction once it is answered (``delete_completed_queries``), as in the reference:
        # so each prompt of the geometric rule reaches the chat twice
        asked = collections.defaultdict(list)
        for (q, _), n in QA_STATE["calls"].items():
            asked[q].append(n)
        ranks, moved = collections.Counter(), 0
        for q, a in zip(questions, answers_b):
            context = [t for t, _ in context_pairs(a)]
            sentinel = QA_STATE["sentinel"][q]
            rank = context.index(sentinel) + 1 if sentinel in context else len(context) + 1
            ranks[rank] += 1
            moved += rank != planted[q]
            calls = geometric_calls(rank, QA_ADAPTIVE["n_starting_documents"],
                                    QA_ADAPTIVE["factor"], QA_ADAPTIVE["max_iterations"])
            answer = (f"the sentinel of {q}" if rank <= len(context)
                      else prompts.NO_INFO_ANSWER)
            if a["response"] != answer or sorted(asked[q]) != [2] * calls:
                raise AssertionError(f"(b) {q!r}: sentinel at rank {rank}, answer "
                                     f"{a['response']!r} after prompts asked "
                                     f"{sorted(asked[q])} times, not {calls} prompts twice")
        out["b"] = {"p50": float(np.percentile(ms_b, 50)),
                    "calls": sum(QA_STATE["calls"].values()),
                    "prompts": len(QA_STATE["calls"]), "ranks": ranks, "moved": moved,
                    "swapped": swapped_b}
        out["want"] = want
    finally:
        stop_server(server)
    parse_errors = sum(n for (ctx, msg), n in errors.items() if "planted" in msg)
    other = {key: n for key, n in errors.items() if "planted" not in key[1] and n}
    if parse_errors != n_planted or any(n != n_planted for n in other.values()):
        raise AssertionError(f"the error log holds {dict(errors)} for {n_planted} planted "
                             f"documents")
    out.update(n_docs=len(docs_in), n_chunks=n_chunks, n_planted=n_planted,
               errors={f"{ctx}: {msg}": n for (ctx, msg), n in errors.items() if n})
    return out


def run_rerank(device, encoder, answers: list, questions: list, launches: dict) -> dict:
    """Leg (c): ``EncoderReranker`` over each question's context documents through ``pw.run``
    (its launches in ``launches["qa_rerank"]``), each score against the cosine of the two texts'
    embeddings from one batched ``embed_texts_device`` call after it, and ``rerank_topk_filter``
    against the run's own scores."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.xpacks.llm.embedders import TorchEmbedder
    from pathway_tpu_torch.xpacks.llm.rerankers import EncoderReranker, rerank_topk_filter_expr

    rows = [(qi, q, d["text"]) for qi, (q, a) in enumerate(zip(questions, answers))
            for d in a["context_docs"]]
    pw.G.clear()
    pairs = pw.debug.table_from_rows(pw.schema_from_types(qid=int, query=str, doc=str), rows)
    reranker = EncoderReranker(TorchEmbedder(encoder, device=device))
    scored = pairs.select(pw.this.qid, pw.this.doc,
                          score=reranker(pw.this.doc, pw.this.query))
    top = scored.groupby(pw.this.qid).reduce(
        pw.this.qid, docs=pw.reducers.tuple(pw.this.doc),
        scores=pw.reducers.tuple(pw.this.score)).select(
        pw.this.qid, top=rerank_topk_filter_expr(pw.this.docs, pw.this.scores, k=RERANK_K))
    got, tops = {}, {}
    pw.io.subscribe(scored, on_change=lambda key, row, time, is_addition: got.__setitem__(
        (row["qid"], row["doc"]), row["score"]) if is_addition else None)
    pw.io.subscribe(top, on_change=lambda key, row, time, is_addition: tops.__setitem__(
        row["qid"], row["top"]) if is_addition else None)
    with counted("qa_rerank", launches):
        t0 = time.perf_counter()
        pw.run(device=device)
        seconds = time.perf_counter() - t0
    pw.G.clear()
    texts = sorted({t for _, q, d in rows for t in (q, d)})
    with torch.no_grad():
        vecs = encoder.embed_texts_device(texts).float()
    at = {t: i for i, t in enumerate(texts)}
    want = {(qi, d): float(vecs[at[d]] @ vecs[at[q]]) for qi, q, d in rows}
    if got.keys() != want.keys():
        raise AssertionError(f"(c) {len(got)} scores for {len(want)} pairs")
    err = max(abs(got[key] - want[key]) for key in want)
    if err > RERANK_ATOL:
        raise AssertionError(f"(c) a reranker score is {err:.3e} from the batched cosine "
                             f"(atol {RERANK_ATOL})")
    for qi in range(len(questions)):
        mine = sorted(((s, d) for (i, d), s in got.items() if i == qi), key=lambda p: -p[0])
        docs, scores = tops[qi]
        if list(scores) != [s for s, _ in mine[:RERANK_K]] or set(docs) != {
                d for s, d in mine[:RERANK_K]}:
            raise AssertionError(f"(c) question {qi}: top {RERANK_K} {tops[qi]} is not the "
                                 f"highest of the run's scores")
    return {"pairs": len(rows), "s": seconds, "pairs_per_s": len(rows) / seconds,
            "max_err": err,
            "per_pair": {name: launches["qa_rerank"][name] / len(rows)
                         for name in ("masked_attention", "knn_topk")}}


def run_vector_store(device, encoder, chunk_texts: list, *, queries: list, k: int,
                     launches: dict) -> dict:
    """Leg (d): ``VectorStoreServer`` over chunk texts (the run's launches in
    ``launches["qa_vector_store"]``), ``VectorStoreClient.query`` against the run's engine
    searched directly after the run."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.io.http._server import terminate_all
    from pathway_tpu_torch.xpacks.llm.embedders import TorchEmbedder
    from pathway_tpu_torch.xpacks.llm.vector_store import VectorStoreClient, VectorStoreServer

    pw.G.clear()
    docs = pw.debug.table_from_rows(pw.schema_from_types(data=str, _metadata=dict), [
        (t, {"path": f"chunks/{i:05d}"}) for i, t in enumerate(chunk_texts)])
    server = VectorStoreServer(docs, embedder=TorchEmbedder(encoder, device=device))
    engines = keep_engines(server.index)
    text_of: dict = {}
    pw.io.subscribe(server.store.chunked_documents, on_change=lambda key, row, time, is_addition: (
        text_of.__setitem__(int(key), row["text"]) if is_addition else None))
    port = free_port()
    client = VectorStoreClient(url=f"http://127.0.0.1:{port}", timeout=120)
    with counted("qa_vector_store", launches):
        t0 = time.perf_counter()
        server.run_server("127.0.0.1", port, threaded=True, device=device)
        try:
            wait_for_count(server, port, len(chunk_texts), 900)
            fill = time.perf_counter() - t0
            got = {i: answer_pairs(client.query(q, k=k), lambda d: d["text"])
                   for i, q in enumerate(queries)}
        finally:
            pw.request_stop()
            terminate_all()
            for t in server._threads:
                t.join(60)
            pw.G.clear()
    if any(t.is_alive() for t in server._threads):
        raise AssertionError("(d) the vector store's engine thread did not stop within 60 s")
    if server.run_error is not None:
        raise server.run_error
    if rows_held(engines[0]) != len(chunk_texts):
        raise AssertionError(f"(d) the engine holds {rows_held(engines[0])} of "
                             f"{len(chunk_texts)} chunks")
    # one beyond k, so that a near tie across the answer's last place may swap
    direct = engines[0].search(queries, [k + 1] * len(queries), [None] * len(queries))
    want = {i: [(text_of[key], s) for key, s in row] for i, row in enumerate(direct)}
    swapped = check_answers("vector store", got, want, extra=1)
    return {"fill_s": fill, "s": time.perf_counter() - t0, "swapped": swapped}


def run_qa_yaml(device, questions: list, answers: list, want: dict, k: int) -> dict:
    """Leg (e)'s YAML: (a)'s store and standard answerer from ``QA_YAML`` through
    ``pw.load_yaml``, served by ``QARestServer``; its answers to ``questions`` against (a)'s."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.xpacks.llm.question_answering import RAGClient
    from pathway_tpu_torch.xpacks.llm.servers import QARestServer

    pw.G.clear()
    built = pw.load_yaml(QA_YAML.format(mod=__name__, dim=QA_STATE["encoder"].cfg.dim, k=k))
    port = free_port()
    server = QARestServer("127.0.0.1", port, built["answerer"])
    client = RAGClient(url=f"http://127.0.0.1:{port}", timeout=120)
    t0 = time.perf_counter()
    server.run(threaded=True, device=device)
    try:
        wait_for_count(server, port, len(QA_STATE["docs"]), 900)
        got_answers, _ = ask_all(client, questions, return_context_docs=True)
    finally:
        stop_server(server)
    got = {i: context_pairs(a) for i, a in enumerate(got_answers)}
    swapped = check_answers("qa from YAML", got, {i: want[i] for i in got}, extra=1)
    for i, (g, w) in enumerate(zip(got_answers, answers)):
        if [t for t, _ in context_pairs(g)] == [t for t, _ in context_pairs(w)] and \
                g["response"] != w["response"]:
            raise AssertionError(f"(e) YAML answer {i} differs from (a)'s on the same context")
    return {"s": time.perf_counter() - t0, "swapped": swapped,
            "store": type(built["store"]).__name__, "answerer": type(built["answerer"]).__name__}


def run_qa_live_stats(device, want: dict) -> dict:
    """Leg (e)'s ``LiveTable``: the store's statistics over the phase's documents on a
    background run, to the count that ``/v1/statistics`` reported."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.xpacks.llm.document_store import DocumentStore

    pw.G.clear()
    store = DocumentStore(qa_docs_table(), pw.indexing.BruteForceKnnFactory(
        dimensions=QA_STATE["encoder"].cfg.dim, embedder=QA_STATE["encoder"]),
        parser=qa_parser())
    q = pw.debug.table_from_rows(DocumentStore.StatisticsQuerySchema, [()])
    t0 = time.perf_counter()
    live = store.statistics_query(q).live(device=device)
    if not live._stopped.wait(300) or live.failed():
        raise AssertionError(f"the live statistics table did not finish: {live._error!r}")
    (row,) = live.snapshot().rows.values()
    pw.G.clear()
    if row[0] != want:
        raise AssertionError(f"the live statistics ended at {row[0]}, /v1/statistics at {want}")
    return {"s": time.perf_counter() - t0, "result": row[0], "frontier": live.frontier()}


def run_qa(device, *, n_chunks: int = 4096, docs_commit: int = 256, n_questions: int = 64,
           warmup: int = 4, vs_chunks: int = 256, vs_queries: int = 16, yaml_questions: int = 8,
           rerank_questions: int = 32,
           cfg=None) -> dict:
    """Phase 20; sizes as the defaults say on the card (a CPU rehearsal passes small ones and a
    small encoder). Returns each leg's launch counts, rates and times."""
    from pathway_tpu_torch.models.embedder import Embedder

    cuda = device.type == "cuda"
    card = card_line() if cuda else "cpu"
    launches: dict = {}
    captured: dict = {}
    start = time.perf_counter()
    import urllib.request

    # RAGClient and VectorStoreClient post through urllib's global opener: make it the local one
    # (no proxy, the certificates loaded once)
    urllib.request.install_opener(local_opener())
    log("qa: importable here: " + ", ".join(
        f"{mod} {'yes' if client_importable(mod) else 'no'}" for mod in ("yaml", "bokeh", "panel")))
    docs_in, chunk_texts = serve_documents(n_chunks)
    QA_STATE.clear()
    QA_STATE.update(
        docs=[(QA_PLANTED + d if i % QA_PLANT_EVERY == 0 else d, m)
              for i, (d, m) in enumerate(docs_in)],
        docs_commit=docs_commit, encoder=Embedder(cfg, seed=0, device=device))
    rng = np.random.default_rng(20)
    questions = [chunk_texts[i].split(".")[0]
                 for i in rng.choice(n_chunks, n_questions + warmup, replace=False)]
    warm, questions = questions[:warmup], questions[warmup:]
    encoder = QA_STATE["encoder"]
    with scoped_env({"PATHWAY_THREADS": "1", "PATHWAY_MESH_EXCHANGE": "0"}):
        qa = run_qa_servers(device, encoder, warm=warm, questions=questions, k=QA_TOPK,
                            launches=launches, captured=captured)
        a, b = qa["a"], qa["b"]
        log(f"qa (a): {qa['n_docs']} documents ({qa['n_planted']} planted to fail their parse) "
            f"of {qa['n_chunks']} chunks into DocumentStore under QASummaryRestServer and "
            f"QARestServer, filled in {qa['fill_s']:.2f} s; {len(questions)} answers "
            f"(BaseRAGQuestionAnswerer, search_topk={QA_TOPK}) after {warmup} untimed: p50 "
            f"{a['p50']:.3f} ms, p95 {a['p95']:.3f} ms, p99 {a['p99']:.3f} ms (host clock; the "
            f"slowest, request {a['slowest'][0]}, {a['slowest'][1]:.3f} ms); each "
            f"chat's paths its context's, each context the direct knn_topk search's "
            f"({a['swapped']} swapped inside near ties); launches per request {a['per_request']}; "
            f"/v1/retrieve, /v1/statistics {qa['stats']}, /v2/list_documents and "
            f"/v1/pw_ai_summary as the store answers them [{card}]")
        log(f"qa (b): AdaptiveRAGQuestionAnswerer({QA_ADAPTIVE}) on the same store, "
            f"{len(questions)} questions with a sentinel planted at ranks 1-16 of their direct "
            f"search, at ranks {dict(sorted(b['ranks'].items()))} of the run's context "
            f"({b['moved']} moved inside near ties; each context the direct search's, "
            f"{b['swapped']} swapped inside near ties): each answer and its prompts the "
            f"geometric rule's "
            f"({b['prompts']} prompts, each asked twice: the answer runs again for the query's "
            f"retraction); p50 {b['p50']:.3f} ms [{card}]")
        an = qa["analysis"]
        log(f"qa (e): pw.analyze(device={device.type!r}) before the run: {an['operators']} "
            f"operators, diagnostics {dict(an['ids'])} in {qa['analyze_s']:.3f} s; with "
            f"device='cpu' {dict(an['cpu_ids'])} [{card}]")
        log(f"qa (e): pw.global_error_log() in the run: {qa['errors']} for {qa['n_planted']} "
            f"planted documents [{card}]")
        if cuda:
            torch.cuda.empty_cache()
        rerank = run_rerank(device, encoder, a["answers"][:rerank_questions],
                            questions[:rerank_questions], launches)
        log(f"qa (c): EncoderReranker and rerank_topk_filter(k={RERANK_K}) over (a)'s context "
            f"documents, {rerank['pairs']} pairs in {rerank['s']:.2f} s, "
            f"{rerank['pairs_per_s']:.1f} pairs/s; each score within {rerank['max_err']:.3e} of "
            f"the batched cosine (atol {RERANK_ATOL}); launches per pair {rerank['per_pair']} "
            f"[{card}]")
        vs = run_vector_store(device, encoder, chunk_texts[:vs_chunks],
                              queries=questions[:vs_queries], k=QA_TOPK, launches=launches)
        log(f"qa (d): VectorStoreServer over {vs_chunks} chunks (one forward a chunk: "
            f"TorchEmbedder as its embedder) filled in {vs['fill_s']:.2f} s; {vs_queries} "
            f"VectorStoreClient.query (k={QA_TOPK}) equal to its engine searched directly "
            f"({vs['swapped']} swapped inside near ties); launches "
            f"{launches['qa_vector_store']} [{card}]")
        with counted("qa_yaml", launches):
            yml = run_qa_yaml(device, questions[:yaml_questions], a["answers"][:yaml_questions],
                              qa["want"], QA_TOPK)
        log(f"qa (e): pw.load_yaml built {yml['store']} and {yml['answerer']}; its "
            f"{yaml_questions} answers equal (a)'s ({yml['swapped']} swapped inside near ties) "
            f"in {yml['s']:.2f} s [{card}]")
        with counted("qa_live", launches):
            live = run_qa_live_stats(device, qa["stats"])
        log(f"qa (e): LiveTable of the store's statistics ended at {live['result']} (frontier "
            f"{live['frontier']}) in {live['s']:.2f} s, as /v1/statistics [{card}]")
    held = check_phase_kernels(captured) if cuda else None
    if held is not None:
        log(f"qa: masked_attention at {held['attention_shape']} and knn_topk at (q, n, d, k) = "
            f"{held['knn_shape']}, each on the phase's own inputs, against their plain versions: "
            f"max |err| {held['attention_err']:.3e} and {held['knn_err']:.3e} [{card}]")
    seconds = time.perf_counter() - start
    log(f"qa: the phase took {seconds:.1f} s of its {QA_BUDGET_S:.0f} [{card}]")
    if cuda:
        for path, names in (("qa", ("masked_attention", "knn_topk")),
                            ("qa_answer", ("masked_attention", "knn_topk")),
                            ("qa_adaptive", ("masked_attention", "knn_topk")),
                            ("qa_rerank", ("masked_attention",)),
                            ("qa_vector_store", ("masked_attention", "knn_topk")),
                            ("qa_yaml", ("masked_attention", "knn_topk"))):
            missing = [n for n in names if launches[path][n] == 0]
            if missing:
                raise AssertionError(f"{missing} not launched on the {path} path")
    return {"launches": launches,
            "a": {k: v for k, v in a.items() if k != "answers"},
            "b": b, "rerank": rerank, "vector_store": vs, "yaml": yml, "live": live,
            "analyze_s": qa["analyze_s"], "held": held, "s": seconds}


# -- phase 21: the observability plane --------------------------------------------------------


OBS_BUDGET_S = 60.0
OBS_REPS = 2  # each arm runs twice, alternated: bare, default, observed, bare, default, observed
OBS_SCRAPE_S = 0.5
OBS_ENDPOINTS = ("/metrics", "/snapshot", "/query", "/attribution", "/alerts", "/profile",
                 "/healthz", "/readyz")
#: one rule that must fire (any tick takes time) and one that must not
OBS_SLO_RULES = [
    {"name": "tick_p95", "expr": "p95(tick_duration_ms)", "op": ">", "threshold": 0.0,
     "for_s": 0.0},
    {"name": "tick_p95_hour", "expr": "p95(tick_duration_ms)", "op": ">",
     "threshold": 3_600_000.0, "for_s": 0.0},
]
#: the arms' environments (None: unset); the observed arm adds its server, trace file, flight
#: ring, rules and collector
OBS_ARMS = {"bare": {"PATHWAY_PROFILE": "0", "PATHWAY_KEYLOAD": "0"},
            "default": {"PATHWAY_PROFILE": None, "PATHWAY_KEYLOAD": None},
            "observed": {"PATHWAY_PROFILE": None, "PATHWAY_KEYLOAD": None}}
#: one default-on hook at a time (``scripts/torch_obs_phase.py --split``): which of the two the
#: default arm's cost is
OBS_SPLIT_ARMS = {"keyload_only": {"PATHWAY_PROFILE": "0", "PATHWAY_KEYLOAD": None},
                  "profile_only": {"PATHWAY_PROFILE": None, "PATHWAY_KEYLOAD": "0"}}


class OtlpCollector:
    """A loopback OTLP/HTTP collector on a thread of its own: each POST's path and body."""

    def __init__(self) -> None:
        import http.server
        import threading

        received = self.received = []

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):  # noqa: N802 - http.server API
                n = int(self.headers.get("Content-Length", 0))
                received.append((self.path, json.loads(self.rfile.read(n) or b"null")))
                self.send_response(200)
                self.send_header("Content-Length", "2")
                self.end_headers()
                self.wfile.write(b"{}")

            def log_message(self, *a):
                pass

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(10)


def http_get(port: int, path: str, timeout: float = 30.0) -> tuple[int, str]:
    """One GET to the local server: (status, body)."""
    import urllib.error

    try:
        with local_opener().open(f"http://127.0.0.1:{port}{path}", timeout=timeout) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def check_histograms(series: dict) -> int:
    """Each histogram of a parsed exposition cumulative and monotone in ``le``, its ``+Inf``
    bucket equal to its ``_count``; returns the histograms checked."""
    buckets: dict = {}
    for (name, labels), v in series.items():
        if name.endswith("_bucket"):
            lab = dict(labels)
            le = lab.pop("le")
            buckets.setdefault((name[:-len("_bucket")], tuple(sorted(lab.items()))), []).append(
                (float("inf") if le == "+Inf" else float(le), v))
    for (fam, lab), pts in buckets.items():
        pts.sort()
        counts = [v for _, v in pts]
        if any(b < a for a, b in zip(counts, counts[1:])):
            raise AssertionError(f"{fam}{dict(lab)}: bucket counts fall with le: {counts}")
        if pts[-1][0] != float("inf") or pts[-1][1] != series.get((fam + "_count", lab)):
            raise AssertionError(f"{fam}{dict(lab)}: the +Inf bucket {pts[-1]} is not the "
                                 f"count {series.get((fam + '_count', lab))}")
    return len(buckets)


class Scraper:
    """Reads every endpoint of a monitoring server every ``period`` s on a thread: each request's
    host ms; each ``/metrics`` body parsed and its histograms checked; the workers its labels
    name; ``/healthz`` and ``/readyz`` held to 200 in every scrape after one whose ``/snapshot``
    showed every worker past its first tick. A refused connection (the server not up yet, or
    gone) counts as no scrape; any other fault is kept and raised by ``check``."""

    def __init__(self, port: int, n_workers: int, period: float = OBS_SCRAPE_S) -> None:
        import threading

        from pathway_tpu_torch.observability import parse_exposition

        self.port, self.n_workers, self.period = port, n_workers, period
        self.parse = parse_exposition
        self.ms: dict = {p: [] for p in OBS_ENDPOINTS}
        self.rounds = self.histograms = self.refused = 0
        self.workers: set = set()
        self.swept = False
        self.probes_after_sweep = 0
        self.faults: list = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.period):
            try:
                self.scrape_once()
            except ConnectionError:
                self.refused += 1
            except OSError as e:  # urllib wraps a refused connection
                if isinstance(getattr(e, "reason", None), ConnectionError):
                    self.refused += 1
                else:
                    self.faults.append(repr(e))
            except Exception as e:  # kept, raised by check() on the phase's thread
                self.faults.append(repr(e))

    def scrape_once(self) -> None:
        bodies = {}
        for path in OBS_ENDPOINTS:
            t0 = time.perf_counter()
            bodies[path] = http_get(self.port, path)
            self.ms[path].append((time.perf_counter() - t0) * 1e3)
        self.rounds += 1
        code, text = bodies["/metrics"]
        if code != 200:
            raise AssertionError(f"/metrics answered {code}")
        series = self.parse(text)
        self.histograms += check_histograms(series)
        self.workers |= {dict(lab)["worker"] for _, lab in series if "worker" in dict(lab)}
        for path in ("/snapshot", "/query", "/attribution", "/alerts", "/profile"):
            if bodies[path][0] != 200:
                raise AssertionError(f"{path} answered {bodies[path][0]}")
            json.loads(bodies[path][1])
        if self.swept:
            self.probes_after_sweep += 1
            for path in ("/healthz", "/readyz"):
                if bodies[path][0] != 200:
                    raise AssertionError(f"{path} answered {bodies[path][0]} after the first "
                                         f"tick swept: {bodies[path][1]}")
        snap = json.loads(bodies["/snapshot"][1])
        ticked = [w for w in snap["workers"] if w["ticks"] >= 1]
        self.swept = self.swept or len(ticked) == self.n_workers

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(60)

    def check(self) -> None:
        if self.faults:
            raise AssertionError(f"the scraper saw {len(self.faults)} fault(s): {self.faults[:3]}")
        if not self.rounds or not self.probes_after_sweep:
            raise AssertionError(f"{self.rounds} scrapes, {self.probes_after_sweep} after the "
                                 f"first tick swept: the observed run ended too soon to be read")
        want = {str(w) for w in range(self.n_workers)}
        if not want <= self.workers:
            raise AssertionError(f"/metrics named workers {sorted(self.workers)}, not {want}")


@contextlib.contextmanager
def final_reads(into: dict, port: int, before_stop=None):
    """Every endpoint read over HTTP at the end of the block's run: after every worker has joined
    and before the runner stops its server (``GraphRunner._stop_observability``), each body into
    ``into``; ``before_stop`` runs first (the scraper's stop)."""
    from pathway_tpu_torch.internals.graph_runner import GraphRunner

    stop = GraphRunner._stop_observability

    def read_then_stop(http_server, flusher, hub=None):
        if before_stop is not None:
            before_stop()
        for path in OBS_ENDPOINTS:
            into[path] = http_get(port, path)
        stop(http_server, flusher, hub)

    GraphRunner._stop_observability = staticmethod(read_then_stop)
    try:
        yield
    finally:
        GraphRunner._stop_observability = staticmethod(stop)


#: the fusion counters a run moves by what it builds (chains, their members, the preambles) and
#: its fallbacks (none); the rest count batches, which the async loop groups by arrival, so a
#: worker's chain may or may not pass its warm-up (``jit_chains_total`` is held to the chains
#: that hold a launcher at the run's end instead)
OBS_BUILD_COUNTERS = ("chains_total", "fused_ops_total", "preambles_total", "fallbacks_total")


def module_counters() -> dict:
    """The process-wide fusion and UDF counters, as the hub's ``/snapshot`` sections read them."""
    from pathway_tpu_torch.engine.fusion import fusion_stats_snapshot
    from pathway_tpu_torch.internals.expression_compiler import udf_stats_snapshot

    return {"fusion": fusion_stats_snapshot(), "udf": udf_stats_snapshot()}


def counter_delta(after: dict, before: dict, keys=None) -> dict:
    return {k: after[k] - before.get(k, 0.0) for k in (keys or after)}


def check_observed_run(reads: dict, *, rows: int, n_workers: int, before: dict, bare: dict,
                       executors: list, trace_file: str, flight_dir: str,
                       collector: OtlpCollector) -> dict:
    """What the observed arm's endpoints, trace file, flight ring and collector hold, each held
    to what the run did; returns what it counted."""
    from pathway_tpu_torch.observability import harvest, parse_exposition
    from pathway_tpu_torch.observability.flightrecorder import ring_path
    from pathway_tpu_torch.observability.profile_merge import operator_shares

    for path, (code, body) in reads.items():
        if code != 200:
            raise AssertionError(f"{path} answered {code} at the run's end: {body[:300]}")
    series = parse_exposition(reads["/metrics"][1])
    check_histograms(series)
    inputs = {dict(lab)["worker"]: v for (name, lab), v in series.items()
              if name == "pathway_input_rows"}
    if set(inputs) != {str(w) for w in range(n_workers)} or sum(inputs.values()) != rows:
        raise AssertionError(f"pathway_input_rows {inputs}: not {rows} rows over "
                             f"{n_workers} workers")
    snap = json.loads(reads["/snapshot"][1])
    # the sections /snapshot serves, moved over the arm, against what the bare arm's run of the
    # same graph moved the module's counters by: the same chains built and lowered, the same UDF
    # lanes
    for section, keys in (("fusion", OBS_BUILD_COUNTERS), ("udf", None)):
        if not snap.get(section):
            raise AssertionError(f"/snapshot's {section} section is empty")
        served = counter_delta(snap[section], before[section], keys)
        if served != counter_delta(bare[section], {}, keys):
            raise AssertionError(f"/snapshot's {section} section moved by {served} over the "
                                 f"arm; the bare arm's run moved it by {bare[section]}")
    from pathway_tpu_torch.engine.fusion import FusedChain

    fusion = counter_delta(snap["fusion"], before["fusion"])
    lowered = sum(1 for ex in executors for n in ex.nodes
                  if isinstance(n, FusedChain) and n._launcher is not None)
    if not lowered or fusion["jit_chains_total"] != lowered:
        raise AssertionError(f"/snapshot's fusion section counts {fusion['jit_chains_total']} "
                             f"chains lowered to one program; the run's executors hold "
                             f"{lowered}")
    keyload = [w.get("keyload") for w in snap["workers"]]
    if not all(k and k["rows_total"] for k in keyload):
        raise AssertionError(f"a worker's key-load section is empty: {keyload}")
    with open(trace_file) as f:
        events = json.load(f)["traceEvents"]
    tid_worker = {e["tid"]: e["args"]["worker"] for e in events
                  if e.get("name") == "engine.run" and e.get("ph") == "X"}
    spans: dict = {}
    for e in events:
        if e.get("ph") == "X" and e.get("tid") in tid_worker:
            kind = "tick" if e["name"] == "tick" else "node" if "#" in e["name"] else None
            if kind:
                spans.setdefault(tid_worker[e["tid"]], {}).setdefault(kind, 0)
                spans[tid_worker[e["tid"]]][kind] += 1
    if sorted(spans) != list(range(n_workers)) or not all(
            v.get("tick") and v.get("node") for v in spans.values()):
        raise AssertionError(f"the trace file's tick and node spans by worker: {spans}")
    posts = {path for path, _ in collector.received}
    if not {"/v1/traces", "/v1/metrics"} <= posts:
        raise AssertionError(f"the collector received {sorted(posts)}")
    ring = harvest(ring_path(flight_dir, 0))
    kinds = {(r["kind"], r.get("worker")) for r in ring["records"]}
    for w in range(n_workers):
        for kind in ("run.start", "run.end", "tick"):
            if (kind, w) not in kinds:
                raise AssertionError(f"the flight ring holds no {kind} record of worker {w}")
    alerts = json.loads(reads["/alerts"][1])
    fired = {e["rule"] for e in alerts["history"] if e["state"] == "firing"}
    active = {e["rule"] for e in alerts["active"]}
    if fired != {"tick_p95"} or active != {"tick_p95"}:
        raise AssertionError(f"/alerts: fired {fired}, active {active}; only tick_p95 fires")
    ranked = [r["operator"] for r in json.loads(reads["/attribution"][1])["ranked"]]
    tagged = operator_shares(json.loads(reads["/profile"][1]))
    if not set(tagged) & set(ranked):
        raise AssertionError(f"/profile's operator tags {sorted(tagged)} name none of "
                             f"/attribution's ranked operators {ranked}")
    return {"input_rows": inputs, "fusion": fusion, "trace_spans": spans,
            "posts": len(collector.received), "flight_records": len(ring["records"]),
            "fired": sorted(fired), "profiled_ops": len(set(tagged) & set(ranked)),
            "ranked_ops": len(ranked), "top_op": ranked[0] if ranked else None,
            "keyload_rows": [k["rows_total"] for k in keyload]}


def run_observed_table_api(device, *, rows: int, commit: int, groups: int, reps: int,
                           launches: dict, captured: dict, work: str,
                           arms: dict = OBS_ARMS) -> dict:
    """Leg (a): phase 10's chain (one program a chain) at 2 workers over ``LocalComm`` (the
    async loop) in the ``arms``, alternated ``reps`` times; each table equal to numpy's, each
    arm's programs run equal to its launches. The observed arm is scraped while it runs and read
    at its end."""
    from pathway_tpu_torch.internals.monitoring import MonitoringLevel
    from pathway_tpu_torch.ops.expression_kernel import HostLauncher

    cuda = device.type == "cuda"
    workers = 2
    cols = pipeline_columns(rows, groups)
    want = pipeline_reference(cols)
    rates: dict = {arm: [] for arm in arms}
    out: dict = {"rates": rates}
    bare: dict = {}
    for rep in range(reps):
        for arm, env in arms.items():
            path = f"obs_{arm}_{rep + 1}"
            env = dict(env)
            run_kw: dict = {}
            observed = arm == "observed"
            reads: dict = {}
            collector = scraper = None
            if observed:
                port = free_port()
                collector = OtlpCollector()
                trace_file = os.path.join(work, f"trace-{rep}.json")
                flight_dir = os.path.join(work, f"flight-{rep}")
                env.update(PATHWAY_MONITORING_HTTP_PORT=str(port),
                           PATHWAY_TRACE_FILE=trace_file, PATHWAY_FLIGHT_DIR=flight_dir,
                           PATHWAY_FLIGHT_RING_KB="4096",
                           PATHWAY_SLO_RULES=json.dumps(OBS_SLO_RULES),
                           PATHWAY_MONITORING_SERVER=f"http://127.0.0.1:{collector.port}",
                           PATHWAY_TELEMETRY_FLUSH_S="1")
                run_kw = {"with_http_server": True, "monitoring_level": MonitoringLevel.ALL}
                scraper = Scraper(port, workers)
            before = module_counters()
            HostLauncher.runs = 0
            executors: list = []
            with scoped_env(env), counted(path, launches), kept_executors(executors), \
                    (final_reads(reads, port, scraper.stop) if observed
                     else contextlib.nullcontext()), \
                    (first_program(captured) if observed else contextlib.nullcontext()):
                got, sec = run_pipeline(device, cols, commit, groups, workers, lifted=False,
                                        mesh=False, **run_kw)
            if got != want:
                raise AssertionError(f"{path}: the table differs from the numpy computation")
            ran, launched = HostLauncher.runs, launches[path]["expression_vm"]
            if not ran or (cuda and launched != ran):
                raise AssertionError(f"{path}: {ran} programs run, {launched} launched")
            rates[arm].append(rows / sec)
            if arm == "bare":
                after = module_counters()
                bare = {k: counter_delta(after[k], before[k]) for k in after}
            line = f"obs (a) {path}: {rows} rows, {len(got)} groups equal to numpy; " \
                   f"{ran} programs run, {launched} launches; {rows / sec:.1f} rows/s"
            if observed:
                collector.close()
                scraper.check()
                checked = check_observed_run(reads, rows=rows, n_workers=workers,
                                             before=before, bare=bare, executors=executors,
                                             trace_file=trace_file, flight_dir=flight_dir,
                                             collector=collector)
                metrics_ms = scraper.ms["/metrics"]
                all_ms = [m for v in scraper.ms.values() for m in v]
                out.setdefault("scrapes", []).append({
                    "rounds": scraper.rounds, "refused": scraper.refused,
                    "histograms": scraper.histograms,
                    "metrics_p50_ms": float(np.percentile(metrics_ms, 50)),
                    "all_p50_ms": float(np.percentile(all_ms, 50)),
                    "round_p50_ms": float(np.median([np.median(r) for r in
                                                     zip(*scraper.ms.values())])),
                    **checked})
                sc = out["scrapes"][-1]
                line += (f"; {sc['rounds']} scrapes of {len(OBS_ENDPOINTS)} endpoints, every "
                         f"/metrics parsed ({sc['histograms']} histograms cumulative, +Inf = "
                         f"_count), workers 0 and 1 named, /healthz and /readyz 200 after the "
                         f"first sweep; /metrics p50 {sc['metrics_p50_ms']:.3f} ms, all "
                         f"endpoints p50 {sc['all_p50_ms']:.3f} ms; at the end: input rows "
                         f"{sc['input_rows']}, fusion {sc['fusion']['jit_chains_total']:.0f} "
                         f"chains lowered, trace spans {sc['trace_spans']}, {sc['posts']} OTLP "
                         f"posts, {sc['flight_records']} flight records, fired {sc['fired']}, "
                         f"{sc['profiled_ops']} of {sc['ranked_ops']} ranked operators in the "
                         f"profile (top {sc['top_op']}), key-load rows {sc['keyload_rows']}")
            log(line)
    mean = {arm: float(np.mean(v)) for arm, v in rates.items()}
    out["mean"] = mean
    out["overhead"] = {arm: 1.0 - mean[arm] / mean["bare"] for arm in arms if arm != "bare"}
    return out


def run_observed_serve(device, *, n_chunks: int, docs_commit: int, requests: int, warmup: int,
                       k: int, launches: dict, captured: dict, cfg=None) -> dict:
    """Leg (b): ``DocumentStoreServer`` over phase 12's documents with the monitoring server on:
    ``warmup`` untimed ``/v1/retrieve`` requests, then ``requests`` timed ones (host clock); the
    serve plane's families on ``/metrics`` and its admitted count moved by the requests sent;
    the kernels' launches in the timed block; one request's kernel inputs kept."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.models.embedder import Embedder
    from pathway_tpu_torch.observability import parse_exposition
    from pathway_tpu_torch.xpacks.llm.document_store import DocumentStore
    from pathway_tpu_torch.xpacks.llm.embedders import TorchEmbedder
    from pathway_tpu_torch.xpacks.llm.parsers import ParseLocal
    from pathway_tpu_torch.xpacks.llm.splitters import TokenCountSplitter

    cuda = device.type == "cuda"
    embedder = TorchEmbedder(None if cfg is None else Embedder(cfg, seed=0, device=device),
                             device=device)
    docs_in, chunk_texts = serve_documents(n_chunks)

    class Docs(pw.io.python.ConnectorSubject):
        def run(self):
            for s in range(0, len(docs_in), docs_commit):
                part = docs_in[s:s + docs_commit]
                self.next_batch({"data": [d for d, _ in part], "_metadata": [m for _, m in part]})
                self.commit()

    def admitted() -> float:
        code, text = http_get(mport, "/metrics")
        series = parse_exposition(text)
        fams = sorted({name for name, _ in series if name.startswith("pathway_serve_")})
        if code != 200 or "pathway_serve_queries_total" not in fams:
            raise AssertionError(f"/metrics ({code}) carries no serve-plane families: {fams}")
        return sum(v for (name, _), v in series.items() if name == "pathway_serve_queries_total")

    pw.G.clear()
    docs = pw.io.python.read(Docs(), schema=pw.schema_from_types(data=bytes, _metadata=dict),
                             autocommit_duration_ms=None)
    store = DocumentStore(docs, pw.indexing.BruteForceKnnFactory(
        dimensions=embedder.embedder.cfg.dim, embedder=embedder.embedder),
        parser=ParseLocal(), splitter=TokenCountSplitter(max_tokens=256))
    rng = np.random.default_rng(21)
    queries = [chunk_texts[i].split(".")[0] for i in rng.integers(0, n_chunks, warmup + requests)]
    mport = free_port()
    with scoped_env({"PATHWAY_MONITORING_HTTP_PORT": str(mport)}):
        from pathway_tpu_torch.xpacks.llm.servers import DocumentStoreServer

        port = free_port()
        server = DocumentStoreServer("127.0.0.1", port, store)
        server.run(threaded=True, device=device, with_http_server=True)
        wait_for_count(server, port, len(docs_in), 900)
        a0 = admitted()
        for q in queries[:warmup]:
            status, body = post_json(port, "/v1/retrieve", {"query": q, "k": k})
            if status != 200 or len(body) != k:
                raise AssertionError(f"/v1/retrieve answered {status}: {body}")
        ms = []
        with counted("obs_serve", launches), kernel_inputs(captured):
            for q in queries[warmup:]:
                t0 = time.perf_counter()
                status, body = post_json(port, "/v1/retrieve", {"query": q, "k": k})
                ms.append((time.perf_counter() - t0) * 1e3)
                if status != 200 or len(body) != k:
                    raise AssertionError(f"/v1/retrieve answered {status}: {body}")
        moved = admitted() - a0
        stop_server(server)
    if moved != warmup + requests:
        raise AssertionError(f"pathway_serve_queries_total moved by {moved}, not the "
                             f"{warmup + requests} requests sent")
    per = launches["obs_serve"]
    if cuda and (per["masked_attention"] != 6 * requests or per["knn_topk"] != requests):
        raise AssertionError(f"the timed requests launched {per}; each request launches 6 "
                             f"masked_attention and 1 knn_topk")
    return {"p50": float(np.percentile(ms, 50)), "p95": float(np.percentile(ms, 95)),
            "p99": float(np.percentile(ms, 99)), "admitted": moved, "n_docs": len(docs_in)}


def run_observability(device, *, rows: int = 1 << 22, commit: int = 1 << 16,
                      groups: int = 1 << 16, reps: int = OBS_REPS, n_chunks: int = 4096,
                      docs_commit: int = 256, requests: int = 64, warmup: int = 4, k: int = 3,
                      serve_p50: float | None = None, threshold: int | None = None,
                      split: bool = False, cfg=None) -> dict:
    """Phase 21; sizes as the defaults say on the card (a CPU rehearsal passes small ones, a
    lower expression ``threshold`` and a small encoder; ``split`` adds an arm for each default
    hook alone). Returns the arms' rates and overheads,
    the scrapes, the observed serve's latencies, the kernels held against their plain versions
    and the launch counts by path."""
    import tempfile

    from pathway_tpu_torch.internals import expression_compiler as ec

    cuda = device.type == "cuda"
    card = card_line() if cuda else "cpu"
    start = time.perf_counter()
    launches: dict = {}
    vm_captured: dict = {}
    serve_captured: dict = {}
    saved_threshold = ec.JIT_THRESHOLD
    ec.JIT_THRESHOLD = threshold or saved_threshold
    with tempfile.TemporaryDirectory(prefix="obs-") as work, scoped_env({
            "PATHWAY_INGEST_COALESCE_WINDOWS": "0", "PATHWAY_MESH_EXCHANGE": "0",
            "PATHWAY_ASYNC_EXEC": None, "PATHWAY_SIGNALS_SAMPLE_S": "0.25"}):
        api = run_observed_table_api(device, rows=rows, commit=commit, groups=groups, reps=reps,
                                     launches=launches, captured=vm_captured, work=work,
                                     arms={**OBS_ARMS, **(OBS_SPLIT_ARMS if split else {})})
    ec.JIT_THRESHOLD = saved_threshold
    rates = ", ".join(f"{arm} {' and '.join(f'{r:.1f}' for r in v)}"
                      for arm, v in api["rates"].items())
    overheads = ", ".join(f"{arm} {v * 100:.2f}%" for arm, v in api["overhead"].items())
    log(f"obs (a): rows/s by arm ({reps} runs each, alternated): {rates}; overhead against bare: "
        f"{overheads} (the reference's budget: 3% a hook) [{card}]")
    scrapes = api["scrapes"]
    metrics_p50 = ", ".join(f"{sc['metrics_p50_ms']:.3f}" for sc in scrapes)
    all_p50 = ", ".join(f"{sc['all_p50_ms']:.3f}" for sc in scrapes)
    log(f"obs (a): scrape p50: /metrics {metrics_p50} ms, every endpoint {all_p50} ms (host "
        f"clock, every {OBS_SCRAPE_S} s during the observed runs) [{card}]")
    with scoped_env({"PATHWAY_THREADS": "1", "PATHWAY_MESH_EXCHANGE": "0"}):
        serve = run_observed_serve(device, n_chunks=n_chunks, docs_commit=docs_commit,
                                   requests=requests, warmup=warmup, k=k, launches=launches,
                                   captured=serve_captured, cfg=cfg)
    beside = f"; phase 12's p50 {serve_p50:.3f} ms" if serve_p50 is not None else ""
    log(f"obs (b): DocumentStoreServer over {serve['n_docs']} documents of {n_chunks} chunks "
        f"with the monitoring server on: /v1/retrieve (k={k}) p50 {serve['p50']:.3f} ms, p95 "
        f"{serve['p95']:.3f} ms, p99 {serve['p99']:.3f} ms over {requests} after {warmup} "
        f"untimed{beside}; pathway_serve_queries_total moved by {serve['admitted']:.0f}; "
        f"launches {launches['obs_serve']} [{card}]")
    held = None
    if cuda:
        vm = check_first_program(device, vm_captured)
        kernels = check_phase_kernels(serve_captured, label="phase 21")
        held = {"vm_err": vm["max_abs_err"], **kernels}
        log(f"obs: expression_vm on the observed arm's own program ({vm['instructions']} "
            f"instructions, {vm['rows']} rows) bitwise equal to its plain version; "
            f"masked_attention at {kernels['attention_shape']} and knn_topk at (q, n, d, k) = "
            f"{kernels['knn_shape']} on a request's own inputs: max |err| "
            f"{kernels['attention_err']:.3e} and {kernels['knn_err']:.3e} [{card}]")
        for path in launches:
            name = "expression_vm" if path.startswith("obs_") and path != "obs_serve" \
                else "masked_attention"
            if not launches[path][name]:
                raise AssertionError(f"{name} not launched on the {path} path")
    seconds = time.perf_counter() - start
    log(f"obs: the phase took {seconds:.1f} s of its {OBS_BUDGET_S:.0f} [{card}]")
    return {"launches": launches, "rates": api["rates"], "mean": api["mean"],
            "overhead": api["overhead"], "scrapes": scrapes, "serve": serve, "held": held,
            "s": seconds}


# -- phase 22: the command line ---------------------------------------------------------------


CLI_BUDGET_S = 75.0
#: (a): phase 10's chain over CLI_CHAIN_COMMITS commits of CLI_CHAIN_COMMIT rows, past the
#: expression machine's gate (4,096 rows a batch) and its warm-up (16 batches)
CLI_CHAIN_COMMIT, CLI_CHAIN_COMMITS, CLI_CHAIN_GROUPS = 16384, 32, 4096
#: (b): phase 14's persisted index cut from 262,144 rows (16,384 chunks) to 65,536 rows (4,096
#: chunks), so both generations' fresh processes fit in the phase's time (PERF.md section 4)
CLI_CHUNKS, CLI_ROWS, CLI_QUERIES, CLI_K = 4096, 1 << 16, 64, 10
CLI_CHUNK_COMMIT, CLI_VEC_COMMIT = 256, 4096

#: (a)'s program, written to a temporary file and run by ``spawn --record`` and ``replay``: the
#: chain over a python subject, its final table, timestamps and launch counts to a JSON file,
#: and its own program held against the plain version on one of its batches
CLI_CHAIN_SCRIPT = '''
import json
import sys
import time

args = json.loads(sys.argv[1])
sys.path.insert(0, args["repo"])
import chip_smoke as cs
import numpy as np
import pathway_tpu_torch as pw
import torch
from pathway_tpu_torch.internals import expression_compiler as ec

device = torch.device(args["device"])
if args["threshold"]:
    ec.JIT_THRESHOLD = args["threshold"]
cols = cs.pipeline_columns(args["rows"], args["groups"])
commit = args["commit"]


class Subject(pw.io.python.ConnectorSubject):
    def run(self):
        for s in range(0, args["send"], commit):
            self.next_batch({c: v[s:s + commit] for c, v in cols.items()})
            self.commit()


t = pw.io.python.read(Subject(), schema=pw.schema_from_types(a=int, g=int, x=float),
                      autocommit_duration_ms=None, name="chain")
res = cs.chain_variant(pw, t, lifted=False).groupby(pw.this.g).reduce(
    pw.this.g, s=pw.reducers.sum(pw.this.w), c=pw.reducers.count())
times, final = set(), {}


def on_batch(tm, b):
    times.add(tm)
    for g, s, c, d in zip(b.data["g"].tolist(), b.data["s"].tolist(), b.data["c"].tolist(),
                          b.diffs.tolist()):
        if d > 0:
            final[g] = (s, c)
        elif final.get(g) == (s, c):
            del final[g]


pw.io.subscribe(res, on_batch=on_batch)
captured = {}
with cs.first_program(captured):
    t0 = time.perf_counter()
    pw.run(device=device)
    seconds = time.perf_counter() - t0
launches = {name: fn.launches for name, fn in cs.launch_counters().items()}
held = cs.check_first_program(device, captured) if device.type == "cuda" else None
with open(args["out"], "w") as f:
    json.dump({"table": sorted([g, s, c] for g, (s, c) in final.items()), "times": len(times),
               "seconds": seconds, "launches": launches, "held": held,
               "recorded_rows": args["send"]}, f)
'''


def cli_supervised_leg(args: dict) -> int:
    """Phase 22 (b)'s program under ``spawn --supervise``: phase 14's persisted index. In
    generation 0 (``PATHWAY_RESTART_COUNT=0``) it SIGKILLs itself once a commit covers
    ``kill_rows`` rows; in generation 1 it restores, refills and answers the queries, writes
    ``answered`` and waits for the parent's ``release`` file while the parent reads its
    monitoring server, then holds its answers against the direct search, and its kernels on one
    query's inputs against their plain versions, and writes its numbers to ``result``."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.models.embedder import Embedder, EmbedderConfig
    from pathway_tpu_torch.ops.index_engines import BruteForceKnnEngine
    from pathway_tpu_torch.persistence import Backend, Config, PersistenceManager

    started = time.time()
    gen = int(os.environ.get("PATHWAY_RESTART_COUNT", "0"))
    device = torch.device(args["device"])
    cfg = None
    if args["cfg"] is not None:
        cfg = EmbedderConfig(**{**args["cfg"], "dtype": getattr(torch, args["cfg"]["dtype"])})
    emb = Embedder(cfg, seed=0, device=device)
    with open(args["texts"]) as f:
        texts = json.load(f)
    with open(args["queries"]) as f:
        queries = json.load(f)
    vecs = np.load(args["vecs"])
    n_rows = len(texts) + len(vecs)
    config = Config.simple_config(Backend.filesystem(args["store"]),
                                  snapshot_interval_ms=args["interval_ms"])
    if gen == 0:
        commit = PersistenceManager.commit

        def killing(self, time_, **kw):
            commit(self, time_, **kw)
            covered = self.offsets.get("rows", {}).get("rows", 0)
            if covered >= args["kill_rows"]:
                with open(args["killed"], "w") as f:
                    json.dump({"t": time.time(), "covered": covered}, f)
                os.kill(os.getpid(), signal.SIGKILL)

        PersistenceManager.commit = killing

        def stop_when_fed():
            # the feed ended before a commit covered kill_rows: the final commit of a stopped
            # run covers every row and so kills
            while not os.path.exists(args["fed"]):
                time.sleep(0.01)
            time.sleep(3 * args["interval_ms"] / 1e3)
            pw.request_stop()

        import threading

        threading.Thread(target=stop_when_fed, daemon=True).start()
        persisted_index_graph(pw, emb, texts=texts, vecs=vecs, queries=[], k=1,
                              chunk_commit=args["chunk_commit"], vec_commit=args["vec_commit"],
                              ask=False, device=device, marks={}, fed_path=args["fed"])
        pw.run(device=device, persistence_config=config)
        return 3  # the generation ran to an end instead of killing itself

    marks: dict = {}

    def hold():
        deadline = time.time() + 600
        while len(answers) < len(queries) and time.time() < deadline:
            time.sleep(0.002)
        marks["answered_unix"] = time.time()
        with open(args["answered"], "w") as f:
            json.dump({"t": marks["answered_unix"]}, f)
        while not os.path.exists(args["release"]) and time.time() < deadline:
            time.sleep(0.01)

    captured: dict = {}
    answers = persisted_index_graph(pw, emb, texts=texts, vecs=vecs, queries=queries,
                                    k=args["k"], chunk_commit=args["chunk_commit"],
                                    vec_commit=args["vec_commit"], ask=True, device=device,
                                    marks=marks, after_ask=hold)
    try:
        with kernel_inputs(captured, when=lambda: "query" in marks):
            t_run, run_t0 = time.time(), _wall()
            pw.run(device=device, persistence_config=config)
    finally:
        pw.G.clear()
    launches = {name: fn.launches for name, fn in launch_counters().items()}
    if len(answers) != len(queries):
        raise AssertionError(f"generation 1 answered {len(answers)} of {len(queries)} queries")
    direct = BruteForceKnnEngine(emb.cfg.dim, reserved_space=n_rows, embedder=emb, device=device)
    direct.add_batch(list(range(len(texts))), list(texts), [None] * len(texts))
    direct.add_batch(list(range(len(texts), n_rows)), list(vecs), [None] * len(vecs))
    want = dict(enumerate(direct.search(queries, [args["k"]] * len(queries),
                                        [None] * len(queries))))
    swapped = check_answers("phase 22 (b)", answers, want)
    held = check_phase_kernels(captured, label="phase 22 (b)") if device.type == "cuda" else None
    manager = marks["manager"]
    with open(args["result"], "w") as f:
        json.dump({"restart_count": gen, "reason": os.environ.get("PATHWAY_LAST_RESTART_REASON"),
                   "started": started, "run_started": t_run,
                   "filled": t_run + (marks["filled"] - run_t0),
                   "answered": marks["answered_unix"], "recovery": manager.recovery_stats,
                   "launches": launches, "held": held, "swapped": swapped}, f)
    return 0


def cli(*argv) -> tuple[int, str]:
    """``main(argv)`` of the port's command line in this process: its exit code and its
    standard output."""
    import io

    from pathway_tpu_torch.cli import main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = main([str(a) for a in argv])
    return code, out.getvalue()


def cli_child(argv: list, env: dict, log_path: str, timeout_s: float = 600) -> int:
    """``python -m pathway_tpu_torch.cli <argv>`` in a fresh interpreter from the repository's
    root, its output to ``log_path``; fails on a nonzero exit code."""
    root = os.path.dirname(os.path.abspath(__file__))
    with open(log_path, "w") as f:
        code = subprocess.call([sys.executable, "-m", "pathway_tpu_torch.cli", *argv],
                               env={**os.environ, "PYTHONPATH": root, **env}, cwd=root,
                               stdout=f, stderr=subprocess.STDOUT, timeout=timeout_s)
    if code != 0:
        with open(log_path) as f:
            tail = f.read()[-4000:]
        raise AssertionError(f"`{' '.join(map(str, argv[:3]))} ...` exited with {code}:\n{tail}")
    return code


def run_cli_record_replay(device, work: str, *, commit: int, commits: int, groups: int,
                          threshold: int | None) -> dict:
    """(a): the chain program under ``spawn --record``, then under ``replay --mode speedrun``,
    each a fresh process; an unrecorded run of the same pipeline in this process beside them."""
    cuda = device.type == "cuda"
    rows = commit * commits
    script = os.path.join(work, "chain.py")
    with open(script, "w") as f:
        f.write(CLI_CHAIN_SCRIPT)
    rec, trace = os.path.join(work, "record"), os.path.join(work, "trace.json")
    base = {"repo": os.path.dirname(os.path.abspath(__file__)), "device": str(device),
            "rows": rows, "commit": commit, "groups": groups, "threshold": threshold}
    env = {"PATHWAY_INGEST_COALESCE_WINDOWS": "0", "PATHWAY_FUSION": "1", "PATHWAY_THREADS": "1",
           "PATHWAY_MESH_EXCHANGE": "0"}
    runs = {}
    for label, argv, send, extra in (
            ("record", ["spawn", "--record", "--record-path", rec], rows,
             {"PATHWAY_TRACE_FILE": trace}),
            ("replay", ["replay", "--record-path", rec, "--mode", "speedrun"], 0, {})):
        out = os.path.join(work, f"{label}.json")
        t0 = time.perf_counter()
        cli_child([*argv, sys.executable, script,
                   json.dumps({**base, "send": send, "out": out})], {**env, **extra},
                  os.path.join(work, f"{label}.log"))
        with open(out) as f:
            runs[label] = {**json.load(f), "process_s": time.perf_counter() - t0}
    cols = pipeline_columns(rows, groups)
    want = pipeline_reference(cols)
    from pathway_tpu_torch.internals import expression_compiler as ec

    saved = ec.JIT_THRESHOLD
    ec.JIT_THRESHOLD = threshold or saved
    try:
        direct, runs["unrecorded_s"] = run_pipeline(device, cols, commit, groups, 1,
                                                    lifted=False)
    finally:
        ec.JIT_THRESHOLD = saved
    for label in ("record", "replay"):
        got = {g: (s_, c) for g, s_, c in runs[label]["table"]}
        if got != want:
            raise AssertionError(f"phase 22 (a): the {label} run's table differs from numpy's")
    if direct != want:
        raise AssertionError("phase 22 (a): the unrecorded run's table differs from numpy's")
    if runs["replay"]["times"] != runs["record"]["times"] or runs["record"]["times"] != commits:
        raise AssertionError(f"phase 22 (a): {runs['record']['times']} recorded timestamps, "
                             f"{runs['replay']['times']} replayed, {commits} commits")
    if cuda:
        for label in ("record", "replay"):
            if not runs[label]["launches"]["expression_vm"]:
                raise AssertionError(f"phase 22 (a): expression_vm not launched in the {label} "
                                     f"run")
    runs["rows"], runs["trace"], runs["store"] = rows, trace, rec
    return runs


def start_cli_supervised(device, work: str, *, data, k: int, kill_rows: int, interval_ms: int,
                         cfg) -> dict:
    """(b), started: phase 14's persisted index under ``spawn --supervise`` with a flight
    directory and the monitoring server on, in the background; ``finish_cli_supervised`` reads
    it."""
    texts, vecs, queries = data
    args = {"device": str(device), "store": os.path.join(work, "store"), "k": k,
            "kill_rows": kill_rows, "interval_ms": interval_ms, "chunk_commit": CLI_CHUNK_COMMIT,
            "vec_commit": CLI_VEC_COMMIT,
            "cfg": None if cfg is None else {**cfg.__dict__,
                                             "dtype": str(cfg.dtype).split(".")[-1]}}
    for name in ("texts", "vecs", "queries", "fed", "killed", "answered", "release", "result"):
        args[name] = os.path.join(work, name + (".npy" if name == "vecs" else ".json"))
    with open(args["texts"], "w") as f:
        json.dump(texts, f)
    with open(args["queries"], "w") as f:
        json.dump(queries, f)
    np.save(args["vecs"], vecs)
    port = free_port()
    root = os.path.dirname(os.path.abspath(__file__))
    env = {"PATHWAY_FLIGHT_DIR": os.path.join(work, "flight"),
           "PATHWAY_MONITORING_HTTP_SERVER": "1", "PATHWAY_MONITORING_HTTP_PORT": str(port),
           "PATHWAY_THREADS": "1", "PATHWAY_MESH_EXCHANGE": "0",
           "PATHWAY_SUPERVISE_BACKOFF_S": "0.05", "PATHWAY_SUPERVISE_BACKOFF_MAX_S": "0.2",
           "PYTHONPATH": root}
    log_path = os.path.join(work, "supervise.log")
    t0 = time.perf_counter()
    with open(log_path, "w") as f:
        sup = subprocess.Popen(
            [sys.executable, "-m", "pathway_tpu_torch.cli", "spawn", "--supervise",
             sys.executable, os.path.abspath(__file__), "--cli-leg", json.dumps(args)],
            env={**os.environ, **env}, cwd=root, stdout=f, stderr=subprocess.STDOUT)
    return {"sup": sup, "args": args, "port": port, "log_path": log_path, "t0": t0,
            "flight": env["PATHWAY_FLIGHT_DIR"]}


def finish_cli_supervised(b: dict) -> dict:
    """(b), finished: once generation 1 has answered, ``top``, ``critpath --json`` and
    ``profile --top 10`` read its monitoring server in this process; then generation 1 is
    released and the supervisor must exit 0 after exactly one restart with one crash bundle."""
    sup, args, port, flight = b["sup"], b["args"], b["port"], b["flight"]
    out: dict = {"port": port}
    try:
        deadline = time.perf_counter() + 600
        while not os.path.exists(args["answered"]):
            if sup.poll() is not None or time.perf_counter() > deadline:
                raise AssertionError("phase 22 (b): generation 1 did not answer")
            time.sleep(0.02)
        code, text = cli("top", "--frames", 3, "--no-clear", "--port", port, "-i", 0.2)
        if code != 0 or text.count("pathway-tpu top") != 3:
            raise AssertionError(f"phase 22 (b): top exited with {code}:\n{text[-2000:]}")
        out["top"] = text
        code, text = cli("critpath", "--json", "--port", port)
        json.loads(text)
        out["critpath"] = (code, text)
        code_p, text_p = cli("profile", "--top", 10, "--port", port)
        out["profile"] = (code_p, text_p)
        if code or code_p:
            raise AssertionError(f"phase 22 (b): critpath exited with {code}, profile with "
                                 f"{code_p}")
    finally:
        open(args["release"], "w").close()
        try:
            out["exit_code"] = sup.wait(300)
        except subprocess.TimeoutExpired:
            sup.kill()
            sup.wait(60)
            raise
    out["s"] = time.perf_counter() - b["t0"]
    with open(b["log_path"]) as f:
        out["log"] = f.read()
    if out["exit_code"] != 0:
        raise AssertionError(f"phase 22 (b): the supervisor exited with {out['exit_code']}:\n"
                             f"{out['log'][-4000:]}")
    restarts = re.findall(r"restart #(\d+)", out["log"])
    if restarts != ["1"]:
        raise AssertionError(f"phase 22 (b): restarts {restarts}, not exactly one")
    bundles = sorted(n for n in os.listdir(flight) if n.startswith("crash-"))
    if bundles != ["crash-0-0.json"]:
        raise AssertionError(f"phase 22 (b): crash bundles {bundles}")
    with open(os.path.join(flight, bundles[0])) as f:
        out["bundle"] = json.load(f)
    with open(args["killed"]) as f:
        out["killed"] = json.load(f)
    with open(args["result"]) as f:
        out["result"] = json.load(f)
    if out["result"]["restart_count"] != 1 or "crash-0-0.json" not in out["result"]["reason"]:
        raise AssertionError(f"phase 22 (b): generation {out['result']['restart_count']}, "
                             f"reason {out['result']['reason']!r}")
    out["store"] = args["store"]
    return out


def run_cli(device, *, chain_commit: int = CLI_CHAIN_COMMIT,
            chain_commits: int = CLI_CHAIN_COMMITS, chain_groups: int = CLI_CHAIN_GROUPS,
            n_chunks: int = CLI_CHUNKS, n_rows: int = CLI_ROWS, n_queries: int = CLI_QUERIES,
            k: int = CLI_K, fill_rows_per_s: float | None = None, threshold: int | None = None,
            cfg=None) -> dict:
    """Phase 22; sizes as the defaults say on the card (a CPU rehearsal passes small ones, a
    lower expression ``threshold`` and a small encoder). Returns each leg's numbers, the kernels
    held against their plain versions and the launch counts by path."""
    import shutil
    import tempfile

    from pathway_tpu_torch.models.embedder import Embedder

    cuda = device.type == "cuda"
    card = card_line() if cuda else "cpu"
    start = time.perf_counter()
    work = tempfile.mkdtemp(prefix="cli-phase-")
    b_started = None
    try:
        # (b) runs in the background from the start (its two generations' fresh processes take
        # most of its time), (a) in the meantime
        emb = Embedder(cfg, seed=0, device=device)
        data = index_data(n_chunks, n_rows, emb.cfg.dim, n_queries)
        del emb
        fill_s = n_rows / fill_rows_per_s if fill_rows_per_s else 5.0
        interval_ms = max(100, int(1e3 * fill_s / 5))
        os.makedirs(os.path.join(work, "b"))
        b_started = start_cli_supervised(device, os.path.join(work, "b"), data=data, k=k,
                                         kill_rows=n_rows * 3 // 4, interval_ms=interval_ms,
                                         cfg=cfg)
        del data
        t0 = time.perf_counter()
        os.makedirs(os.path.join(work, "a"))
        a = run_cli_record_replay(device, os.path.join(work, "a"), commit=chain_commit,
                                  commits=chain_commits, groups=chain_groups,
                                  threshold=threshold)
        a_s = time.perf_counter() - t0
        rec, rep = a["record"], a["replay"]
        log(f"cli (a): spawn --record then replay --mode speedrun of phase 10's chain over "
            f"{a['rows']} rows in {chain_commits} commits: tables equal numpy's, "
            f"{rec['times']} timestamps recorded and {rep['times']} replayed; rows/s "
            f"{a['rows'] / rec['seconds']:.1f} recorded, {a['rows'] / rep['seconds']:.1f} "
            f"replayed, {a['rows'] / a['unrecorded_s']:.1f} unrecorded in this process (each "
            f"pw.run's own time, (b) running beside); each fresh process {rec['process_s']:.1f} "
            f"and {rep['process_s']:.1f} s; expression_vm launches "
            f"{rec['launches']['expression_vm']} and {rep['launches']['expression_vm']}" + (
                f", its program ({rec['held']['instructions']} instructions, "
                f"{rec['held']['rows']} rows) bitwise equal to its plain version in both"
                if cuda else "") + f"; (a) {a_s:.1f} s [{card}]")
        b = finish_cli_supervised(b_started)
        res = b["result"]
        rec_b = res["recovery"]
        first_answer = res["answered"] - b["killed"]["t"]
        log(f"cli (b): spawn --supervise of phase 14's index over {n_rows} rows "
            f"(snapshot_interval_ms={interval_ms}): generation 0 SIGKILLed itself at a commit "
            f"covering {b['killed']['covered']} rows; the crash bundle crash-0-0.json holds "
            f"{len(b['bundle']['records'])} records ({len(b['bundle']['last_ticks'])} ticks); "
            f"generation 1 (PATHWAY_RESTART_COUNT={res['restart_count']}) answered "
            f"{n_queries} queries equal to the direct search ({res['swapped']} ids swapped "
            f"inside near ties); the supervisor exited with {b['exit_code']} after one restart "
            f"[{card}]")
        log(f"cli (b): {first_answer:.2f} s from the kill to generation 1's first answer: "
            f"{res['run_started'] - b['killed']['t']:.2f} s to its pw.run (supervisor, backoff, "
            f"process start, the encoder), restore_operators {rec_b.get('restore_s', 0):.3f} s "
            f"and the tail ({rec_b.get('replayed_rows')} rows) {rec_b.get('replay_s', 0):.3f} s, "
            f"refill to every row {res['filled'] - res['run_started']:.2f} s, then the queries "
            f"{res['answered'] - res['filled']:.2f} s; generation 1's launches masked_attention "
            f"{res['launches']['masked_attention']}, knn_topk {res['launches']['knn_topk']}"
            + (f"; on one query's inputs max |err| {res['held']['attention_err']:.3e} and "
               f"{res['held']['knn_err']:.3e}" if res["held"] else "") + f" [{card}]")
        frame = b["top"].split("pathway-tpu top")[-1].splitlines()
        log(f"cli (b): top rendered 3 frames from generation 1's /query (the last: "
            f"{' | '.join(x.strip() for x in frame[:4] if x.strip())}); critpath --json "
            f"{len(b['critpath'][1])} bytes; profile --top 10 {len(b['profile'][1].splitlines())}"
            f" lines; (b) {b['s']:.1f} s [{card}]")

        t0 = time.perf_counter()
        code, text = cli("lint", "--device", str(device),
                          os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                       "pathway_tpu_torch", "examples", "rag_server"))
        if code != 0:
            raise AssertionError(f"phase 22 (c): lint exited with {code}:\n{text[-2000:]}")
        merged = os.path.join(work, "merged.json")
        code_t, text_t = cli("trace", "merge", a["trace"], "-o", merged)
        with open(merged) as f:
            n_events = len(json.load(f)["traceEvents"])
        code_r, text_r = cli("rescale", "--dry-run", "--to", 2, b["store"])
        report = json.loads(text_r.splitlines()[-1])
        if code_t or code_r or not report.get("dry_run"):
            raise AssertionError(f"phase 22 (c): trace merge exited with {code_t}, rescale "
                                 f"--dry-run with {code_r}")
        log(f"cli (c): lint --device {device} of the example exited 0; trace merge of (a)'s "
            f"record run: {text_t.strip()} ({n_events} events parsed); rescale --dry-run --to 2 "
            f"of (b)'s store: {len(report['operators'])} operators, "
            f"{report['state_bytes_total'] / 2**20:.1f} MiB to redistribute; (c) "
            f"{time.perf_counter() - t0:.1f} s [{card}]")
    finally:
        if b_started is not None and b_started["sup"].poll() is None:
            b_started["sup"].kill()
            b_started["sup"].wait(60)
        shutil.rmtree(work, ignore_errors=True)
    launches = {"cli_record": a["record"]["launches"], "cli_replay": a["replay"]["launches"],
                "cli_supervised": res["launches"]}
    held = None
    if cuda:
        for path, name in (("cli_supervised", "masked_attention"),
                           ("cli_supervised", "knn_topk")):
            if not launches[path][name]:
                raise AssertionError(f"{name} not launched on the {path} path")
        held = {"vm_err": max(a["record"]["held"]["max_abs_err"],
                              a["replay"]["held"]["max_abs_err"]),
                "attention_err": res["held"]["attention_err"], "knn_err": res["held"]["knn_err"]}
    seconds = time.perf_counter() - start
    log(f"cli: the phase took {seconds:.1f} s of its {CLI_BUDGET_S:.0f} [{card}]")
    return {"launches": launches, "held": held, "a": a, "b": b, "s": seconds,
            "first_answer_s": first_answer}


# -- phase 23: the training step on a (data, model) mesh, and the dry run ----------------------


MESH_BUDGET_S = 15.0
#: the mesh step against the one-device step: tests/test_torch_pipeline.py's tolerances (the
#: loss absolute; each parameter's update by cosine and relative norm; rows and scores absolute)
MESH_LOSS_ATOL, MESH_UPDATE_MIN_COS, MESH_UPDATE_MAX_REL, MESH_EMB_ATOL = 1e-2, 0.999, 0.05, 1e-2


@contextlib.contextmanager
def first_call(module, name: str, into: dict, key: str, clone: bool = True):
    """Keep the arguments of the block's first call of ``module.name`` under ``into[key]`` (its
    tensors cloned unless ``clone`` is False). A wrapper wrapped in its own module counts its
    launches on the module attribute, so the recording function carries the count and hands it
    back, as ``record_largest_exchange`` does."""
    original = getattr(module, name)

    def recording(*args, **kw):
        if key not in into:
            into[key] = tuple(a.detach().clone() if clone and torch.is_tensor(a) else a
                              for a in args)
        return original(*args, **kw)

    counted = original.__module__ == module.__name__ and hasattr(original, "launches")
    if counted:
        recording.launches = original.launches
    setattr(module, name, recording)
    try:
        yield
    finally:
        setattr(module, name, original)
        if counted:
            original.launches = recording.launches


def hold_training_kernels(captured: dict, label: str) -> dict:
    """Rows 1, 8a, 8b, 3 and 5 against their plain versions on one launch's inputs each, as the
    step gave them: the attention forward and backward within ATTN_ATOL + ATTN_RTOL, InfoNCE's
    loss and gradient within INFONCE_RTOL, the scorer within one bf16 ulp (ids where the scores
    are clear), the merge exactly. Returns each max |kernel - plain|."""
    from pathway_tpu_torch.ops import attention
    from pathway_tpu_torch.ops.infonce import infonce, infonce_plain
    from pathway_tpu_torch.ops.knn import (
        topk_merge_shards, topk_merge_shards_plain, topk_scores, topk_scores_plain,
    )

    errs = {"masked_attention": attention_error(label, *captured["attention"])}
    q, k, v, dout, mask, stat = captured["bwd"]
    got = attention.masked_attention_bwd(q, k, v, dout, mask, stat)
    want = attention.masked_attention_bwd_plain(q, k, v, dout, mask)
    torch.cuda.synchronize()
    errs["masked_attention_bwd"] = 0.0
    for name, g, w in zip("qkv", got, want):
        err = (g.float() - w.float()).abs()
        if not torch.isfinite(g.float()).all() or (
                err > ATTN_ATOL + ATTN_RTOL * w.float().abs()).any():
            raise AssertionError(f"{label}: masked_attention_bwd d{name} max |err| "
                                 f"{err.max().item()}")
        errs["masked_attention_bwd"] = max(errs["masked_attention_bwd"], err.max().item())
    (logits,) = captured["infonce"]
    live = logits.clone().requires_grad_()
    loss = infonce(live)
    (grad,) = torch.autograd.grad(loss, live)
    want_loss = infonce_plain(live)
    (want_grad,) = torch.autograd.grad(want_loss, live)
    l_err, g_err = abs(loss.item() - want_loss.item()), (grad - want_grad).abs()
    B = logits.shape[0]
    if l_err > INFONCE_RTOL * max(1.0, abs(want_loss.item())) or (
            g_err > INFONCE_RTOL * (1.0 / B + want_grad.abs())).any():
        raise AssertionError(f"{label}: infonce B={B} loss err {l_err}, grad err {g_err.max()}")
    errs["infonce"] = max(l_err, g_err.max().item())
    queries, index, kk, metric = captured["knn"][:4]
    s_k, i_k = topk_scores(queries, index, kk, metric)
    s_p, i_p = topk_scores_plain(queries, index, kk + 1, metric)
    torch.cuda.synchronize()
    check_topk_against_plain(s_k, i_k, s_p, i_p, topk_tolerance(s_p, queries, index, metric))
    errs["knn_topk"] = (s_k - s_p[:, :kk]).abs().max().item()
    scores, ids, km, rows = captured["merge"]
    m_s, m_i = topk_merge_shards(scores, ids, km, rows)
    w_s, w_i = topk_merge_shards_plain(scores, ids, km, rows)
    if not (torch.equal(m_s, w_s) and torch.equal(m_i, w_i)):
        raise AssertionError(f"{label}: topk_merge differs from its plain version")
    errs["topk_merge"] = 0.0
    log(f"{label}: on one launch's inputs each, masked_attention {tuple(q.shape)} and its "
        f"backward, infonce B={B}, knn_topk (q={queries.shape[0]}, n={index.shape[0]}, "
        f"d={queries.shape[1]}, k={kk}) and topk_merge (P={scores.shape[0]}, kk={scores.shape[2]})"
        f" held against their plain versions: max |err| "
        f"{ {n: float(f'{e:.3e}') for n, e in errs.items()} }")
    return errs


def run_mesh_step(device, *, cfg=None, batch: int = 256, seq: int = 128, n_rows: int = 1 << 20,
                  n_queries: int = 64, q_seq: int = 32, k: int = 10, warmup: int = 2,
                  steps: int = 8) -> dict:
    """Phase 23 (a): ``make_step(..., mesh=data_model_mesh(1))`` on the world-1 group at phase
    5's inputs (made anew from their seeds). One step against phase 5's one-device step from the
    same weights and index; the kernels of rows 1, 8a, 8b, 3 and 5 held on that step's launches;
    then the launches counted over ``warmup + steps`` steps, the last ``steps`` timed."""
    from pathway_tpu_torch.models import embedder, pipeline
    from pathway_tpu_torch.ops import attention, knn
    from pathway_tpu_torch.parallel.mesh import data_model_mesh

    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cfg, tokens, tokens_aug, queries, params, index = training_inputs(
        device, cfg=cfg, batch=batch, seq=seq, n_rows=n_rows, n_queries=n_queries, q_seq=q_seq)
    mesh = data_model_mesh(1, device=device.type)
    shard = pipeline.param_shardings(mesh, params, cfg)
    insert_at = n_rows - batch // 2  # clamped to n_rows - batch
    idx_one = index.clone()
    new_o, _, loss_o, s_o, i_o = pipeline.make_step(cfg, k=k + 1, device=device)(
        params, tokens, tokens_aug, idx_one, insert_at, queries)
    step = pipeline.make_step(cfg, k=k, mesh=mesh, device=device)
    captured: dict = {}
    with contextlib.ExitStack() as stack:
        for mod, name, key, clone in ((embedder, "masked_attention", "attention", True),
                                      (attention, "masked_attention_bwd", "bwd", True),
                                      (pipeline, "infonce", "infonce", True),
                                      (knn, "topk_scores", "knn", False),
                                      (knn, "topk_merge_shards", "merge", True)):
            stack.enter_context(first_call(mod, name, captured, key, clone))
        new_m, _, loss_m, s_m, i_m = step(shard, tokens, tokens_aug, index, insert_at, queries)
    sync()
    loss_diff = abs(loss_m.item() - loss_o.item())
    if not math.isfinite(loss_m.item()) or loss_diff > MESH_LOSS_ATOL:
        raise AssertionError(f"mesh step loss {loss_m.item()} against one device {loss_o.item()}")
    worst_cos, worst_rel, weight_diff = 1.0, 0.0, 0.0
    for new, one, old in zip(pipeline._leaves(pipeline.gather_params(mesh, new_m)),
                             pipeline._leaves(new_o), pipeline._leaves(params)):
        dm, do = new - old, one - old
        cos = ((dm * do).sum() / (dm.norm() * do.norm())).item()
        rel = ((dm - do).norm() / do.norm()).item()
        if not cos >= MESH_UPDATE_MIN_COS or not rel <= MESH_UPDATE_MAX_REL:
            raise AssertionError(f"mesh step: a parameter {tuple(old.shape)}'s update has cosine "
                                 f"{cos}, relative error {rel} against one device")
        worst_cos, worst_rel = min(worst_cos, cos), max(worst_rel, rel)
        weight_diff = max(weight_diff, (new - one).abs().max().item())
    rows = slice(n_rows - batch, n_rows)
    row_diff = (index[rows] - idx_one[rows]).abs().max().item()
    if row_diff > MESH_EMB_ATOL or not torch.equal(index[: n_rows - batch],
                                                   idx_one[: n_rows - batch]):
        raise AssertionError(f"mesh step: inserted rows differ by {row_diff} or landed elsewhere")
    check_topk_against_plain(s_m, i_m, s_o, i_o, bf16_ulp(s_o) + MESH_EMB_ATOL)
    score_diff = (s_m - s_o[:, :k]).abs().max().item()
    log(f"mesh step (data_model_mesh(1)) against phase 5's one-device step: |loss| diff "
        f"{loss_diff:.3e} ({loss_m.item():.6f}), updates' worst cosine {worst_cos:.6f} and "
        f"relative error {worst_rel:.3e}, max |weight diff| {weight_diff:.3e}, rows "
        f"{row_diff:.3e}, scores {score_diff:.3e}, ids equal where the scores are clear")
    errs = hold_training_kernels(captured, "phase 23 (a)") if cuda else {}
    del captured, new_o, new_m
    if cuda:
        torch.cuda.empty_cache()

    def timed(step_fn, p, idx) -> tuple[float, float]:
        """``warmup + steps`` steps, the last ``steps`` timed: (CUDA events ms, host ms) a step."""
        losses = []
        for i in range(warmup + steps):
            if i == warmup:
                sync()
                t0 = time.perf_counter()
                if cuda:
                    start = torch.cuda.Event(enable_timing=True)
                    start.record()
            p, _, loss, _, _ = step_fn(p, tokens, tokens_aug, idx, i * batch, queries)
            losses.append(loss)
        if cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
        sync()
        if not all(math.isfinite(x.item()) for x in losses):
            raise AssertionError("mesh step: loss not finite")
        return (start.elapsed_time(end) / steps if cuda else float("nan"),
                (time.perf_counter() - t0) * 1e3 / steps)

    # the one-device step timed the same way in this call, then the mesh step's path
    one_ms, one_wall_ms = timed(pipeline.make_step(cfg, k=k, device=device), params, idx_one)
    del idx_one
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    step_ms, wall_ms = timed(step, shard, index)
    counts = {name: fn.launches for name, fn in counters.items()}
    log(f"launches over {warmup + steps} mesh steps: {counts}")
    for name in ("masked_attention", "masked_attention_bwd", "infonce", "knn_topk", "topk_merge"):
        if counts[name] == 0 and cuda:
            raise AssertionError(f"{name} was not launched on the mesh step's path")
    return {"step_ms": step_ms, "wall_ms": wall_ms, "one_device_ms": one_ms,
            "one_device_wall_ms": one_wall_ms, "launches": counts, "errs": errs,
            "diffs": {"loss": loss_diff, "weights": weight_diff, "rows": row_diff,
                      "scores": score_diff}}


def run_dryrun(device) -> dict:
    """Phase 23 (b): ``graft_entry.entry()``'s forward and ``dryrun_multichip(1)`` on the
    world-1 group; the dry run's first attention, ring step and bucketing held against their
    plain versions on their inputs, and its launches counted."""
    from pathway_tpu_torch import graft_entry
    from pathway_tpu_torch.models import embedder, ring_attention
    from pathway_tpu_torch.ops.ring import ring_block_attention, ring_block_attention_plain

    cuda = device.type == "cuda"
    fn, args = graft_entry.entry(device)
    with torch.no_grad():
        out = fn(*args)
    norms = out.norm(dim=1)
    if out.shape != (8, 128) or not torch.isfinite(out).all() or (norms - 1).abs().max() > 1e-3:
        raise AssertionError(f"graft_entry.entry(): forward {tuple(out.shape)} not unit rows")
    counters = launch_counters()
    for c in counters.values():
        c.launches = 0
    captured: dict = {}
    recorded: list = []
    with first_call(embedder, "masked_attention", captured, "attention"), \
            first_call(ring_attention, "ring_block_attention", captured, "ring"), \
            record_largest_exchange(recorded):
        dry = graft_entry.dryrun_multichip(1, device=device)
    launches = {name: c.launches for name, c in counters.items()}
    errs = {}
    if cuda:
        errs["masked_attention"] = attention_error("phase 23 (b) dry run",
                                                   *captured["attention"])
        # the state as the launch found it, folded by each version with the normalised output
        q, k, v, mask, o, m, l, scale = captured["ring"]
        states = [tuple(t.clone() for t in (o, m, l)) + (torch.empty_like(o),) for _ in range(2)]
        ring_block_attention(q, k, v, mask, *states[0][:3], scale, out=states[0][3])
        ring_block_attention_plain(q, k, v, mask, *states[1][:3], scale, out=states[1][3])
        torch.cuda.synchronize()
        errs["ring_attention"] = ring_close(f"phase 23 (b) ring_block_attention {tuple(q.shape)} "
                                            f"{str(q.dtype)[6:]}", states[0][3], states[1][3])
        errs["bucket_exchange"] = check_recorded_exchange(recorded, "phase 23 (b)")
        for name in ("masked_attention", "knn_topk", "infonce", "masked_attention_bwd",
                     "topk_merge", "ring_attention", "bucket_exchange"):
            if not launches[name]:
                raise AssertionError(f"{name} was not launched in the dry run")
    log(f"graft_entry: entry()'s forward (8, 128) unit rows; dryrun_multichip(1): mesh "
        f"{dry['mesh']}, loss {dry['loss']:.6f}, ids {dry['topk_ids']}, ring over "
        f"{dry['seq']} tokens, dataflow parity {dry['dataflow']}, recovery parity "
        f"{dry['recovery']}; launches {launches}")
    return {"launches": launches, "errs": errs, "dry": dry}


def check_recorded_exchange(recorded: list, label: str) -> int:
    """``bucket_exchange`` against its plain version, bitwise, on the inputs
    ``record_largest_exchange`` kept. Returns the largest word difference (0)."""
    from pathway_tpu_torch.parallel.exchange import bucket_exchange, bucket_exchange_plain

    words, dest, n_dst, cap_bucket = recorded
    out, valid, counts = bucket_exchange(words, dest, n_dst, cap_bucket, return_counts=True)
    want, want_valid, want_counts = bucket_exchange_plain(words, dest, n_dst, cap_bucket,
                                                          return_counts=True)
    torch.cuda.synchronize()
    if not (torch.equal(out, want) and torch.equal(valid, want_valid)
            and torch.equal(counts, want_counts)):
        raise AssertionError(f"{label}: bucket_exchange differs from its plain version")
    log(f"{label}: bucket_exchange at n_src={words.shape[0]} cap_in={words.shape[1]} "
        f"w={words.shape[2]} n_dst={n_dst} cap_bucket={cap_bucket}, the largest launch's inputs, "
        f"equal to its plain version bitwise")
    return 0


# -- phase 24: the cluster ----------------------------------------------------------------------


CLUSTER_BUDGET_S = 60.0
#: phase 10's chain over CLUSTER_COMMITS commits of CLUSTER_COMMIT rows (1,048,576) and its
#: 65,536 groups, under ``spawn -n 2 -t 2``
CLUSTER_COMMIT, CLUSTER_COMMITS, CLUSTER_GROUPS = 16384, 64, 1 << 16

#: the program each process of an arm runs: the chain over a python subject; its table (process
#: 0 holds the subscription), timestamps, launch counts, comm counters and held kernels to a JSON
#: file a process
CLUSTER_CHAIN_SCRIPT = """
import json
import os
import sys
import time

args = json.loads(sys.argv[1])
sys.path.insert(0, args["repo"])
import chip_smoke as cs
import pathway_tpu_torch as pw
import torch
from pathway_tpu_torch.internals import expression_compiler as ec
from pathway_tpu_torch.parallel import cluster, meshcomm

pid = int(os.environ["PATHWAY_PROCESS_ID"])
comms = {}


def keep(cls, key):
    real = cls.__init__

    def init(self, *a, **kw):
        real(self, *a, **kw)
        comms[key] = self

    cls.__init__ = init


keep(cluster.ClusterComm, "cluster")
keep(meshcomm.MultiHostMeshComm, "mesh")
device = torch.device(args["device"])
if args["threshold"]:
    ec.JIT_THRESHOLD = args["threshold"]
cols = cs.pipeline_columns(args["rows"], args["groups"])
commit = args["commit"]


class Subject(pw.io.python.ConnectorSubject):
    def run(self):
        for s in range(0, args["rows"], commit):
            self.next_batch({c: v[s:s + commit] for c, v in cols.items()})
            self.commit()


t = pw.io.python.read(Subject(), schema=pw.schema_from_types(a=int, g=int, x=float),
                      autocommit_duration_ms=None, name="chain")
res = cs.chain_variant(pw, t, lifted=False).groupby(pw.this.g).reduce(
    pw.this.g, s=pw.reducers.sum(pw.this.w), c=pw.reducers.count())
final = {}


def on_batch(tm, b):
    for g, s, c, d in zip(b.data["g"].tolist(), b.data["s"].tolist(), b.data["c"].tolist(),
                          b.diffs.tolist()):
        if d > 0:
            final[g] = (s, c)
        elif final.get(g) == (s, c):
            del final[g]


pw.io.subscribe(res, on_batch=on_batch)
captured, recorded = {}, []
with cs.first_program(captured), cs.record_largest_exchange(recorded):
    run_at = time.time()
    t0 = time.perf_counter()
    pw.run(device=device)
    seconds = time.perf_counter() - t0
launches = {name: fn.launches for name, fn in cs.launch_counters().items()}
held = {}
if device.type == "cuda":
    if captured:
        held["vm"] = cs.check_first_program(device, captured)
    if recorded:
        held["exchange"] = cs.check_recorded_exchange(recorded, f"phase 24 process {pid}")
stats = comms["cluster"].comm_stats()
mesh = comms.get("mesh")
with open(f"{args['out']}.p{pid}", "w") as f:
    json.dump({"process": pid, "table": sorted([g, s, c] for g, (s, c) in final.items()),
               "seconds": seconds, "run_at": run_at, "launches": launches, "held": held,
               "bytes_sent": stats["cluster_bytes_sent"],
               "frames_sent": stats["cluster_frames_sent"],
               "transport": None if mesh is None else mesh.transport,
               "mesh": None if mesh is None else {k: v for k, v in mesh.comm_stats().items()
                                                  if k.startswith("mesh_")}}, f)
"""


def cluster_ports(start: int) -> int:
    """A first port at or above ``start`` whose two cluster ports and the rendezvous above them
    (``first_port + 1000``) are free."""
    import socket

    for first in range(start, start + 400, 4):
        ok = True
        for port in (first, first + 1, first + 1000):
            with socket.socket() as sock:
                sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                try:
                    sock.bind(("127.0.0.1", port))
                except OSError:
                    ok = False
        if ok:
            return first
    raise RuntimeError(f"no free cluster ports above {start}")


def run_cluster(device, *, commit: int = CLUSTER_COMMIT, commits: int = CLUSTER_COMMITS,
                groups: int = CLUSTER_GROUPS, threshold: int | None = None) -> dict:
    """Phase 24: the chain program under ``python -m pathway_tpu_torch.cli spawn -n 2 -t 2``, two
    arms at once on disjoint ports: (a) ``ClusterComm``'s host frames, (b)
    ``PATHWAY_MESH_EXCHANGE=1`` (``MultiHostMeshComm``, the swap over gloo: both processes share
    the card). Each arm's table against numpy's, each process's launches and held kernels; logged:
    rows/s, each process's seconds from the launch to its ``pw.run``, bytes and frames sent."""
    import shutil
    import tempfile

    cuda = device.type == "cuda"
    card = card_line() if cuda else "cpu"
    start = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    rows = commit * commits
    work = tempfile.mkdtemp(prefix="cluster-phase-")
    procs = {}
    try:
        script = os.path.join(work, "chain.py")
        with open(script, "w") as f:
            f.write(CLUSTER_CHAIN_SCRIPT)
        first = 24000
        for arm, extra in (("a", {"PATHWAY_MESH_EXCHANGE": "0"}),
                           ("b", {"PATHWAY_MESH_EXCHANGE": "1"})):
            first = cluster_ports(first)
            out = os.path.join(work, f"{arm}.json")
            cfg = {"repo": root, "device": str(device), "rows": rows, "commit": commit,
                   "groups": groups, "threshold": threshold, "out": out}
            env = {**os.environ, "PYTHONPATH": root, "PATHWAY_INGEST_COALESCE_WINDOWS": "0",
                   "PATHWAY_FUSION": "1", **extra}
            log_path = os.path.join(work, f"{arm}.log")
            launched = time.time()
            with open(log_path, "w") as log_f:
                proc = subprocess.Popen(
                    [sys.executable, "-m", "pathway_tpu_torch.cli", "spawn", "-n", "2", "-t",
                     "2", "--first-port", str(first), sys.executable, script, json.dumps(cfg)],
                    env=env, cwd=root, stdout=log_f, stderr=subprocess.STDOUT)
            procs[arm] = (proc, launched, out, log_path, first)
            first += 8
        want = pipeline_reference(pipeline_columns(rows, groups))
        arms = {}
        for arm, (proc, launched, out, log_path, first) in procs.items():
            try:
                code = proc.wait(timeout=600)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(60)
                code = "timeout"
            if code != 0:
                with open(log_path) as f:
                    raise AssertionError(f"phase 24 ({arm}): spawn exited with {code}:\n"
                                         f"{f.read()[-4000:]}")
            parts = []
            for pid in (0, 1):
                with open(f"{out}.p{pid}") as f:
                    parts.append(json.load(f))
            got = {g: (s_, c) for g, s_, c in parts[0]["table"]}
            if got != want:
                raise AssertionError(f"phase 24 ({arm}): the table differs from numpy's")
            if parts[1]["table"]:
                raise AssertionError(f"phase 24 ({arm}): process 1 holds a subscription's rows")
            if cuda:
                if not sum(p["launches"]["expression_vm"] for p in parts):
                    raise AssertionError(f"phase 24 ({arm}): expression_vm not launched")
                for p in parts:
                    if p["launches"]["expression_vm"] and "vm" not in p["held"]:
                        raise AssertionError(f"phase 24 ({arm}): process {p['process']}'s "
                                             f"program not held")
                    if arm == "b" and not (p["launches"]["bucket_exchange"]
                                           and "exchange" in p["held"]):
                        raise AssertionError(f"phase 24 (b): bucket_exchange not launched or "
                                             f"not held in process {p['process']}")
            if arm == "b" and {p["transport"] for p in parts} != {"gloo"}:
                raise AssertionError(f"phase 24 (b): the swap's transport "
                                     f"{[p['transport'] for p in parts]}, not gloo")
            arms[arm] = {"rows_per_s": rows / parts[0]["seconds"],
                         "to_run_s": [p["run_at"] - launched for p in parts],
                         "bytes_sent": [p["bytes_sent"] for p in parts],
                         "frames_sent": [p["frames_sent"] for p in parts],
                         "launches": [p["launches"] for p in parts],
                         "held": [p["held"] for p in parts],
                         "transport": parts[0]["transport"], "mesh": [p["mesh"] for p in parts],
                         "ports": first}
            a = arms[arm]
            log(f"cluster ({arm}{', MultiHostMeshComm over ' + a['transport'] if a['transport'] else ', ClusterComm host frames'}): "
                f"phase 10's chain over {rows} rows in {commits} commits under spawn -n 2 -t 2 "
                f"(ports {first}, {first + 1}): table equal to numpy's; "
                f"{a['rows_per_s']:.1f} rows/s (process 0's pw.run); each process "
                f"{[round(x, 2) for x in a['to_run_s']]} s from the launch to its pw.run; "
                f"bytes sent {a['bytes_sent']}, frames {a['frames_sent']}; launches "
                f"expression_vm {[x['expression_vm'] for x in a['launches']]}, bucket_exchange "
                f"{[x['bucket_exchange'] for x in a['launches']]}"
                + (f"; mesh {a['mesh']}" if a["transport"] else "") + "".join(
                    f"; process {pid} held bitwise against the plain versions: " + " and ".join(
                        f"expression_vm's program ({h['vm']['instructions']} instructions, "
                        f"{h['vm']['rows']} rows)" if k == "vm"
                        else "bucket_exchange's largest launch" for k in h)
                    for pid, h in enumerate(a["held"]) if h) + f" [{card}]")
    finally:
        for proc, *_ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(60)
        shutil.rmtree(work, ignore_errors=True)
    launches = {f"cluster_{arm}_p{pid}": arms[arm]["launches"][pid]
                for arm in arms for pid in (0, 1)}
    held = {"vm_err": max([h["vm"]["max_abs_err"] for a in arms.values() for h in a["held"]
                           if "vm" in h], default=0.0)}
    seconds = time.perf_counter() - start
    log(f"cluster: the phase took {seconds:.1f} s of its {CLUSTER_BUDGET_S:.0f} [{card}]")
    return {"arms": arms, "launches": launches, "held": held, "s": seconds}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 2
    from pathway_tpu_torch import _kernels, native

    device = torch.device("cuda")
    # the engine keeps one 128-bit conflation registry a process: the engine phase's and the
    # Table API phase's distinct keys together (about 9 million) pass its default cap of 4,194,304
    os.environ.setdefault("PATHWAY_KEY_REGISTRY_CAP", str(1 << 25))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    start = time.perf_counter()

    def phase(name: str) -> None:
        log(f"-- {name}, {time.perf_counter() - start:.1f} s into the run")

    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    cc_out = native.build()
    name = os.path.basename(native.load().__file__)
    log(f"native keyspace module {name}: " + ("built before" if cc_out is None else
        f"built with the host C compiler in {time.perf_counter() - t0:.1f} s") +
        (f"; the compiler said: {cc_out.strip()}" if cc_out and cc_out.strip() else ""))
    t0 = time.perf_counter()
    build_logs = _kernels.build_all()
    log(f"built {list(build_logs) or 'nothing (cached)'} in {time.perf_counter() - t0:.1f} s")
    for name, text in build_logs.items():
        for line in text.splitlines():
            entry = re.search(r"entry function '[^']*?(\d+)([a-z_]+kernel)(ILi(\d+)E)?", line)
            if entry:  # the kernel of the lines below: its name, and its template argument
                arg = f"<{entry.group(4)}>" if entry.group(4) else ""
                log(f"  {name}: {entry.group(2)}{arg}")
            elif "registers" in line or "spill" in line or "smem" in line:
                log(f"  {name}:   {line.strip()}")

    phase("kernels of the RAG path")
    attn_err = check_attention(64, (16, 128, 512), device)
    # one query a request on the serve path: B=1 at each length bucket an encoder pass can take
    attn_err = max(attn_err, check_attention(1, (16, 32, 64, 128), device))
    knn_err, _ = check_knn(64, 1 << 20, 384, (1, 10, 100), device)
    from pathway_tpu_torch.ops.knn import MAX_K

    knn_one_wave(64, 1 << 20, 384, MAX_K, device)  # the tile route at its largest k
    times = time_kernels(device)
    for name, t in times.items():
        log(f"{name} at {t['shape']}: {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, library "
            f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}) [{card}]")
    t = times["knn_topk"]
    log(f"knn_topk at {t['shape']}: {t['route']} route, {fmt_ms(t['device_ms'])} on the device "
        f"(profiler, both passes), {t['ms']:.4f} ms a call (CUDA events) [{card}]")

    phase("the RAG path")
    path = run_main_path(device, n_chunks=16384, n_rows=1 << 20, tick=1024, n_queries=64,
                         n_searches=8, k=10)
    log(f"ingest: {path['ingest_docs_per_s']:.1f} docs/s over 16384 chunks [{card}]")
    log(f"embed forward: {path['embed_tokens_per_s']:.1f} tokens/s at B=1024 S=128 [{card}]")
    # the forward's tokens are all real, so its six launches take the full-mask time
    outside = encoder_outside_attention(path["fwd_ms"], times["masked_attention"]["ms_full_mask"])
    log(f"embed_tokens outside attention at B=1024 S=128: {outside['ms']:.4f} ms (the forward's "
        f"{path['fwd_ms']:.4f} ms less 6 x masked_attention with every key real), bound "
        f"{outside['bound_ms']:.4f} ms "
        f"({outside['bound_by']}) [{card}]")
    log(f"search: p50 {path['search_p50_ms']:.3f} ms for 64 text queries, k=10, over "
        f"{path['index_rows']} rows (each: {[round(x, 3) for x in path['search_ms']]}) [{card}]")
    run_bert(device, vocab=30522, dim=384, layers=6, heads=12, inter=1536, max_pos=512,
             batch=64, seq=128)

    phase("the training step")
    bwd_err = check_attention_backward(
        ((64, 24, 128, 16), (256, 12, 128, 32), (64, 6, 128, 64), (4, 6, 512, 64)), device)
    nce_err = check_infonce((256, 1000), device)
    times.update(time_training_kernels(device))
    for name in ("masked_attention_bwd", "infonce"):
        t = times[name]
        log(f"{name} at {t['shape']}: {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, library "
            f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}) [{card}]")
    t = times["infonce"]
    log(f"infonce at {t['shape']}: {t['route']} route, {fmt_ms(t['device_ms'])} on the device "
        f"(profiler); an empty kernel on the same launch {fmt_ms(t['empty_device_ms'])} on the "
        f"device, {t['empty_ms']:.4f} ms a call [{card}]")
    torch.cuda.empty_cache()
    train = run_training(device)
    log(f"training step: {train['step_ms']:.3f} ms (CUDA events; host clock {train['wall_ms']:.3f}"
        f" ms), {train['tokens_per_s']:.1f} trained tokens/s (2 x 256 x 128 per step) [{card}]")
    log(f"training step: plain route {train['plain_ms']:.3f} ms, bound {train['bound_ms']:.3f} ms "
        f"({train['bound_by']}) [{card}]")
    torch.cuda.empty_cache()

    phase("the parallel paths")
    ring_err = check_ring_block(device)
    merge_err = check_sharded_merge(device)
    times.update(time_parallel_kernels(device))
    for name in ("ring_attention", "topk_merge"):
        t = times[name]
        log(f"{name} at {t['shape']}: {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, library "
            f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}), max "
            f"|kernel - plain| {t['err']:.3e} [{card}]")
    t = times["ring_attention"]
    log(f"ring_attention bounds: tensor cores or exponentials {t['bound_ms']:.4f} ms "
        f"(exponentials alone {t['bound_ms_exponentials']:.4f} ms); the f32 route's on the CUDA "
        f"cores {t['bound_ms_f32_cores']:.4f} ms [{card}]")
    for c in times["topk_merge"]["cases"]:
        log(f"topk_merge at {c['shape']}: {c['ms']:.4f} ms a call (CUDA events), "
            f"{fmt_ms(c['device_ms'])} on the device (profiler) [{card}]")
    torch.cuda.empty_cache()
    long = run_long_context(device)
    log(f"long context: {long['fwd_ms']:.3f} ms a forward of 4 x 8192 tokens (CUDA events; host "
        f"clock {long['wall_ms']:.3f} ms), {long['tokens_per_s']:.1f} tokens/s "
        f"({long['real_tokens']} of them real) [{card}]")
    sharded = run_sharded_search(device)
    log(f"sharded search: p50 {sharded['search_p50_ms']:.3f} ms for 64 queries, k=10, over "
        f"1048576 rows on 1 shard (each: {[round(x, 3) for x in sharded['search_ms']]}) [{card}]")
    log(f"ShardedKnnIndex(mesh=...).add of 65536 x 384 f32 rows from the host, 1 rank: median "
        f"{sharded['add_ms']:.4f} ms (host clock, synchronised), bound "
        f"{sharded['add_bound_ms']:.4f} ms (bytes) [{card}]")
    torch.cuda.empty_cache()

    phase("the mesh step and the dry run")
    t0 = time.perf_counter()
    mesh_step = run_mesh_step(device)
    log(f"mesh step (data_model_mesh(1), world-1 NCCL group): {mesh_step['step_ms']:.3f} ms "
        f"(CUDA events, mean of 8 after 2; host clock {mesh_step['wall_ms']:.3f} ms) beside "
        f"the one-device step's {mesh_step['one_device_ms']:.3f} ms in this phase and phase 5's "
        f"{train['step_ms']:.3f} ms [{card}]")
    torch.cuda.empty_cache()
    dryrun = run_dryrun(device)
    log(f"the mesh step and the dry run took {time.perf_counter() - t0:.1f} s of its "
        f"{MESH_BUDGET_S:.0f} [{card}]")
    torch.distributed.destroy_process_group()
    torch.cuda.empty_cache()

    phase("the engine")
    engine = run_engine(device)
    for name, rate in engine["rates"].items():
        log(f"engine {name}: {rate:.1f} rows/s [{card}]")
    t = engine["exchange"]
    times["bucket_exchange"] = {**t, "err": engine["exchange_err"]}
    log(f"bucket_exchange at {t['shape']}: {t['ms']:.4f} ms ({fmt_ms(t['device_ms'])} on the "
        f"device), plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}) "
        f"[{card}]")

    phase("the Table API")
    torch.cuda.empty_cache()
    api = run_table_api(device)
    t = api["time"]
    times["expression_vm"] = {**t, "err": api["max_abs_err"]}
    log(f"expression_vm at {t['shape']}: {t['ms']:.4f} ms ({fmt_ms(t['device_ms'])} on the "
        f"device), an empty kernel on its grid {t['empty_ms']:.4f} ms "
        f"({fmt_ms(t['empty_device_ms'])} on the device), plain {t['plain_ms']:.4f} ms, "
        f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}); upload {t['upload_ms']:.4f} ms, "
        f"readback {t['readback_ms']:.4f} ms; numpy tier {t['numpy_tier_ms']:.4f} ms (host "
        f"clock) [{card}]")
    for name, rate in api["rates"].items():
        log(f"{name}: {rate:.1f} rows/s [{card}]")
    log(f"Table API idle share (1 worker, under the profiler): {api['idle_share']:.4f} [{card}]")

    phase("the indexing stdlib")
    torch.cuda.empty_cache()
    indexing = run_indexing(device)

    phase("the RAG serve path over HTTP")
    torch.cuda.empty_cache()
    serve = run_serve(device)

    phase("the files")
    torch.cuda.empty_cache()
    files = run_files(device)

    phase("persistence")
    torch.cuda.empty_cache()
    texts, vecs, queries = indexing.pop("data")
    rows = PERSIST_ROWS
    want = indexing.pop("want")[rows]
    persistence = run_persistence(
        device, data=(texts, vecs[:rows - len(texts)], queries), want=want,
        n_rows=rows, kill_rows=rows * 3 // 4,
        phase11_fill_rows_per_s=indexing["rates"]["indexing"]["fill_rows_per_s"],
        hand_over=True)

    phase("rescale and spill")
    torch.cuda.empty_cache()
    rescaled = run_rescale_spill(device, store=persistence.pop("store"),
                                 interval_ms=persistence["interval_ms"],
                                 data=(texts, vecs[:rows - len(texts)], queries), want=want)
    del texts, vecs

    phase("async and iterate")
    torch.cuda.empty_cache()
    asynced = run_async_iterate(device)

    phase("Nexmark windows")
    nexmark = run_nexmark(device)

    phase("stdlib and SQL")
    torch.cuda.empty_cache()
    stdlib = run_stdlib(device, ev=nexmark["events"])

    phase("the connectors over Nexmark")
    connectors = run_connectors(device, ev=nexmark.pop("events"))

    phase("RAG question answering and the last root names")
    torch.cuda.empty_cache()
    qa = run_qa(device)

    phase("the observability plane")
    torch.cuda.empty_cache()
    obs = run_observability(device, serve_p50=serve["rows"]["p50"])

    phase("the command line")
    torch.cuda.empty_cache()
    cli_phase = run_cli(device, fill_rows_per_s=indexing["rates"]["indexing"]["fill_rows_per_s"])

    phase("the cluster")
    torch.cuda.empty_cache()
    cluster_phase = run_cluster(device)

    by_path = {**engine["device_ms_by_path"], **api["device_ms_by_path"]}
    all_launches = {**engine["launches"], **api["launches"]}
    for name in PATH_KERNELS:
        for p_, sums in by_path.items():
            if all_launches[p_][name]:
                log(f"{name} on the {p_} path: {all_launches[p_][name]} launches, "
                    f"{sums[name]['device_ms']:.3f} ms on the device summed (profiler, "
                    f"{sums[name]['kernels_recorded']} kernels recorded) [{card}]")
        times[name]["device_ms_by_path"] = {p_: sums[name]["device_ms"]
                                            for p_, sums in by_path.items()
                                            if all_launches[p_][name]}

    phase("done")
    sources = {
        "masked_attention": ("pathway_tpu_torch/csrc/masked_attention.cu",
                             "pathway_tpu/models/embedder.py:90",
                             max(attn_err, times["masked_attention"]["err"],
                                 qa["held"]["attention_err"], obs["held"]["attention_err"],
                                 cli_phase["held"]["attention_err"],
                                 mesh_step["errs"]["masked_attention"],
                                 dryrun["errs"]["masked_attention"])),
        "masked_attention_bwd": ("pathway_tpu_torch/csrc/masked_attention_bwd.cu",
                                 "pathway_tpu/models/pipeline.py:72",
                                 max(bwd_err, times["masked_attention_bwd"]["err"],
                                     mesh_step["errs"]["masked_attention_bwd"])),
        "knn_topk": ("pathway_tpu_torch/csrc/knn_topk.cu", "pathway_tpu/ops/knn.py:46",
                     max(knn_err, qa["held"]["knn_err"], obs["held"]["knn_err"],
                         cli_phase["held"]["knn_err"], mesh_step["errs"]["knn_topk"])),
        "infonce": ("pathway_tpu_torch/csrc/infonce.cu", "pathway_tpu/models/pipeline.py:61",
                    max(nce_err, mesh_step["errs"]["infonce"])),
        "ring_attention": ("pathway_tpu_torch/csrc/ring_attention.cu",
                           "pathway_tpu/models/ring_attention.py:80",
                           max(ring_err, times["ring_attention"]["err"],
                               dryrun["errs"]["ring_attention"])),
        "topk_merge": ("pathway_tpu_torch/csrc/topk_merge.cu", "pathway_tpu/ops/knn.py:125",
                       max(merge_err, times["topk_merge"]["err"],
                           mesh_step["errs"]["topk_merge"])),
        "bucket_exchange": ("pathway_tpu_torch/csrc/bucket_exchange.cu",
                            "pathway_tpu/parallel/exchange.py:51",
                            max(engine["exchange_err"], dryrun["errs"]["bucket_exchange"])),
        "expression_vm": ("pathway_tpu_torch/csrc/expression_vm.cu",
                          "pathway_tpu/internals/expression_compiler.py:272",
                          max(api["max_abs_err"], connectors["held"]["max_abs_err"],
                              obs["held"]["vm_err"], cli_phase["held"]["vm_err"],
                              cluster_phase["held"]["vm_err"])),
    }
    kernels = []
    for name, (source, replaces, err) in sources.items():
        t = times[name]
        by_path = {"rag": path["launches"][name], "train": train["launches"][name],
                   "long": long["launches"][name], "sharded": sharded["launches"][name],
                   **{p: c[name] for p, c in engine["launches"].items()},
                   **{p: c[name] for p, c in api["launches"].items()},
                   **{p: c[name] for p, c in indexing["launches"].items()},
                   **{p: c[name] for p, c in serve["launches"].items()},
                   **{p: c[name] for p, c in files["launches"].items()},
                   **{p: c[name] for p, c in persistence["launches"].items()},
                   **{p: c[name] for p, c in rescaled["launches"].items()},
                   **{p: c[name] for p, c in asynced["launches"].items()},
                   **{p: c[name] for p, c in nexmark["launches"].items()},
                   **{p: c[name] for p, c in stdlib["launches"].items()},
                   **{p: c[name] for p, c in connectors["launches"].items()},
                   **{p: c[name] for p, c in qa["launches"].items()},
                   **{p: c[name] for p, c in obs["launches"].items()},
                   **{p: c[name] for p, c in cli_phase["launches"].items()},
                   "mesh_step": mesh_step["launches"][name],
                   "dryrun": dryrun["launches"][name],
                   **{p: c[name] for p, c in cluster_phase["launches"].items()}}
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            **({"kernel_route": t["route"]} if "route" in t else {}),
            **{k: t[k] for k in ("device_ms_by_pass", "blocks", "blocks_per_sm",
                                 "smem_bytes", "upload_ms", "readback_ms", "numpy_tier_ms",
                                 "device_ms", "cases",
                                 "empty_ms", "empty_device_ms", "device_ms_by_path",
                                 "ms_contiguous", "library_ms_contiguous", "ms_full_mask",
                                 "library_ms_full_mask", "ctas_per_sm", "grid",
                                 "bound_ms_exponentials", "bound_ms_f32_cores") if k in t},
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--persist-leg"]:  # phase 14's first leg, in a child interpreter
        sys.exit(persist_leg(json.loads(sys.argv[2])))
    if sys.argv[1:2] == ["--spill-leg"]:  # phase 15 (c), in a child interpreter
        sys.exit(spill_leg(json.loads(sys.argv[2])))
    if sys.argv[1:2] == ["--async-leg"]:  # phase 16's fresh processes
        sys.exit(async_leg(json.loads(sys.argv[2])))
    if sys.argv[1:2] == ["--cli-leg"]:  # phase 22 (b)'s program under spawn --supervise
        sys.exit(cli_supervised_leg(json.loads(sys.argv[2])))
    sys.exit(main())
