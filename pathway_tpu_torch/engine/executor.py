"""Single-worker dataflow executor: logical-time ticks over an operator DAG.

Re-design of the reference's per-worker event loop
(``src/engine/dataflow.rs:5596-5650`` — ``step_or_park`` over timely
operators): here the DAG is explicit, acyclic (iteration is a composite node
running an inner fixpoint), and each logical timestamp is processed by one
topological sweep that moves columnar ``Delta`` batches between operators.
Progress tracking degenerates to "times are processed in nondecreasing
order", which is exactly the reference's total-order ``Timestamp``
(``src/engine/timestamp.rs:20``) semantics.

Multi-worker sharding (reference: timely exchange channels) is layered above
by partitioning deltas on ``keys.shard_of`` — see ``parallel/``. Sharded
STREAMING runs over ``LocalComm`` default to frontier-driven asynchronous
execution (each worker advances on data availability, consistency via
frontier broadcasts and commit waves — the timely progress model proper;
see the block comment above ``_use_async``); ``PATHWAY_ASYNC_EXEC=0``
restores the lock-step global tick, and a run over ``MeshComm`` keeps it
unless ``PATHWAY_ASYNC_EXEC=1``.

Copy of ``pathway_tpu/engine/executor.py``: the bulk-synchronous tick loop,
the frontier-driven async loop with its commit waves
(``_stream_loop_sharded_async``, ``_async_commit_wave``, ``_async_settle``;
each wave's document goes to ``EngineStats``' ``WaveRecorder``), and the
persistence: the node snapshot protocol, the sources' offset protocol, the
commit points (each tick in one worker; an agreed tick in BSP sharded runs, a
frontier-agreed wave time under async) and recovery (``_recover``: restore
the newest operator snapshot every worker holds, replay the input tail after
it, seek the sources). The observability hooks are the reference's: the
profiler's operator slot (``PATHWAY_PROFILE``, default on), key-load
accounting on the Exchange buckets (``PATHWAY_KEYLOAD``, default on), the
flight recorder's run, tick and async records (``PATHWAY_FLIGHT_DIR``) and
the tracer's tick, node and commit-wave spans (``PATHWAY_TRACE_FILE``).
Left out: the CLI's replay modes, chaos injection and the upgrade
fingerprints. The rescale protocol (``RESHARD``,
``split_state``/``merge_states``) and the spill budget's hook after each tick
are the reference's.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable

import numpy as np

from .delta import Delta, concat_deltas

__all__ = [
    "Node", "SourceNode", "Executor", "EngineStats", "END_TIME", "E2E_STAGES",
]

END_TIME = 1 << 62

#: staged decomposition of the ingest→emit histogram, pipeline order:
#: connector ingest → exchange post (route), post → operator delivery
#: (inbox dwell), delivery → emitting sweep (settle/commit wait), sweep
#: start → emit. The four stage observations sum EXACTLY to the
#: ``e2e_latency_hist`` observation they decompose (the third stage is
#: the remainder by construction) — see EngineStats.note_e2e.
E2E_STAGES = ("ingest_route", "inbox_dwell", "settle_commit", "commit_deliver")


class EngineStats:
    """Live counters read by the monitoring dashboard and the /metrics
    endpoint (the reference's ProberStats role, graph.rs:521-563)."""

    def __init__(self) -> None:
        import time as _time

        from ..observability.histogram import LogHistogram

        self.started_at = _time.time()
        self.ticks = 0
        self.rows_total = 0
        self.input_rows = 0
        self.output_rows = 0
        self.latency_ms: float | None = None
        #: wall-clock of the last latency_ms update — the gauge freezes at
        #: the last commit's value, so its age is what separates "fast"
        #: from "stalled" (pathway_output_latency_age_seconds)
        self.latency_updated_at: float | None = None
        self.last_time: int = 0
        self.rows_by_node: dict[str, int] = {}
        #: cumulative processing nanoseconds per node (the dashboard's
        #: per-operator latency column, reference monitoring.py:56-190);
        #: populated when detailed monitoring or tracing is on
        self.time_by_node: dict[str, int] = {}
        #: set by the dashboard at level >= ALL to turn on per-node timing
        self.detailed = False
        self.finished = False
        # -- distribution-level metrics (observability/histogram.py) --
        #: wall time of each tick sweep, ns
        self.tick_duration = LogHistogram()
        #: commit-to-output latency, ns (histogram companion of latency_ms)
        self.latency_hist = LogHistogram()
        #: end-to-end ingest→emit latency, ns: connector ingest stamp
        #: (ConnectorSubject._emit wall time) to the tick that delivered
        #: rows to a terminal output node — the signals plane's
        #: user-visible latency distribution
        self.e2e_latency_hist = LogHistogram()
        #: last observed ingest→emit latency (gauge companion)
        self.e2e_ms: float | None = None
        #: per-operator processing time, ns (fed with time_by_node)
        self.node_time_hist: dict[str, Any] = {}
        self._hist_factory = LogHistogram
        # -- liveness / readiness (observability/health.py) --
        #: updated every tick AND every idle park cycle; a stale heartbeat
        #: on an unfinished run means the executor thread is wedged
        self.last_heartbeat = self.started_at
        #: all sources collected/started — first half of /readyz
        self.sources_connected = False
        # -- exchange backpressure (Exchange nodes / comm backends) --
        self.exchange_rows_out = 0
        self.exchange_rows_in = 0
        self.exchange_batches = 0
        #: staged ingest→emit histograms (E2E_STAGES order); each e2e
        #: observation lands once in every stage, so per-stage p99s name
        #: the stage behind an e2e p99 move
        self.stage_hists: dict[str, Any] = {
            s: LogHistogram() for s in E2E_STAGES
        }
        # -- commit-wave critical path (observability/critpath.py) --
        self.waves_total = 0
        #: wall duration of each commit wave (entry → release), ns
        self.wave_duration = LogHistogram()
        #: cumulative per-phase ns across waves (critpath.PHASES keys)
        self.wave_stage_ns: dict[str, int] = {}
        #: waves held per worker id (str keys — prometheus label values)
        self.wave_held_total: dict[str, int] = {}
        #: per-worker WaveRecorder ring, attached by the async loop
        self._waves: Any = None
        # -- key-group load accounting (observability/keyload.py) --
        #: bounded SpaceSaving sketch over routed exchange buckets;
        #: None when PATHWAY_KEYLOAD=0
        from ..observability.keyload import maybe_account

        self.keyload = maybe_account()
        # -- continuous profiling (observability/profiler.py) --
        #: the worker thread's operator-context slot: the executor (and
        #: fused chains, which see stats via node._engine_stats) publish
        #: the executing operator's label here so the sampling profiler
        #: tags stacks with /attribution's labels; None when
        #: PATHWAY_PROFILE=0 — one None check per node on the hot path
        self._op_slot: Any = None

    def heartbeat(self) -> None:
        import time as _time

        self.last_heartbeat = _time.time()

    def note_node(self, node: "Node", n_rows: int, is_source: bool) -> None:
        self.rows_total += n_rows
        if is_source:
            self.input_rows += n_rows
        # fused chains (engine/fusion.py) attribute under their MEMBER
        # labels so the rows and time series share keys; the chain's
        # emitted count is credited to each member (a best-effort rate,
        # exact for filterless chains)
        labels = getattr(node, "attribution_labels", None) or (
            f"{type(node).__name__}#{node.node_id}",
        )
        for label in labels:
            self.rows_by_node[label] = self.rows_by_node.get(label, 0) + n_rows

    def note_node_time(self, node: "Node", ns: int) -> None:
        self.note_op_time(f"{type(node).__name__}#{node.node_id}", ns)

    def note_op_time(self, label: str, ns: int) -> None:
        """Per-operator time under an explicit label — fused chains
        (engine/fusion.py) self-report their MEMBER operators' cost
        splits here so /attribution still names the bottleneck operator
        inside a fused chain."""
        self.time_by_node[label] = self.time_by_node.get(label, 0) + ns
        hist = self.node_time_hist.get(label)
        if hist is None:
            hist = self.node_time_hist[label] = self._hist_factory()
        hist.observe(ns)

    def note_e2e(
        self,
        ingest_ns: int,
        route_ns: int = 0,
        dwell_ns: int = 0,
        sweep_t0_wall_ns: "int | None" = None,
    ) -> None:
        """Record one ingest→emit observation: rows stamped at connector
        ingest time ``ingest_ns`` just reached a terminal output node —
        and decompose it into the E2E_STAGES. ``route_ns`` is the
        sender-side ingest→exchange-post latency, ``dwell_ns`` the
        exchange inbox dwell (both ride the frame meta through the async
        plane), ``sweep_t0_wall_ns`` the wall clock at the start of the
        sweep that emitted. Stages are clamped in order against the
        total, the settle/commit stage is the remainder — the four
        observations sum exactly to the e2e one."""
        import time as _time

        now = _time.time_ns()
        lat_ns = now - int(ingest_ns)
        if lat_ns < 0:  # clock skew guard (stamps come from this host)
            lat_ns = 0
        self.e2e_latency_hist.observe(lat_ns)
        self.e2e_ms = lat_ns / 1e6
        s1 = min(max(0, int(route_ns)), lat_ns)
        s2 = min(max(0, int(dwell_ns)), lat_ns - s1)
        s4 = 0
        if sweep_t0_wall_ns is not None:
            s4 = min(max(0, now - int(sweep_t0_wall_ns)), lat_ns - s1 - s2)
        h = self.stage_hists
        h["ingest_route"].observe(s1)
        h["inbox_dwell"].observe(s2)
        h["settle_commit"].observe(lat_ns - s1 - s2 - s4)
        h["commit_deliver"].observe(s4)

    def note_wave(self, doc: dict, duration_ns: int) -> None:
        """Fold one commit-wave document (critpath.WaveRecorder) into
        the scalar counters."""
        self.waves_total += 1
        self.wave_duration.observe(max(0, int(duration_ns)))
        for p, ms in (doc.get("phases_ms") or {}).items():
            self.wave_stage_ns[p] = (
                self.wave_stage_ns.get(p, 0) + int(ms * 1e6)
            )
        holder = doc.get("holder")
        if holder is not None:
            k = str(holder)
            self.wave_held_total[k] = self.wave_held_total.get(k, 0) + 1

    def note_exchange(self, rows_out: int, rows_in: int) -> None:
        self.exchange_batches += 1
        self.exchange_rows_out += rows_out
        self.exchange_rows_in += rows_in

    def note_tick(self, time: int) -> None:
        import time as _time

        self.ticks += 1
        self.last_time = time
        now = _time.time()
        self.last_heartbeat = now
        now_ms = now * 1000.0
        # only wall-clock commit timestamps are latency-comparable; small
        # logical times (scheduled test streams) would read as ~epoch ms
        if time > 1_000_000_000_000:
            # a logical clock nudged past wall-clock means we're keeping up
            self.latency_ms = max(0.0, now_ms - time)
            self.latency_updated_at = now
            self.latency_hist.observe(int(self.latency_ms * 1e6))


class Node:
    """An engine operator: consumes per-tick input deltas, emits one delta."""

    _ids = itertools.count()

    #: run process() every tick even with no local input (Exchange nodes
    #: must join every collective; sharded peers may be sending rows)
    always_run = False

    #: instance attributes that together form this operator's state
    #: (reference: the arrangement each operator keeps). Empty = stateless;
    #: a run whose nodes are all stateless skips key registration.
    STATE_FIELDS: tuple[str, ...] = ()

    #: how this operator's persisted state repartitions when the cluster is
    #: resharded from N to M workers (rescale/resharder.py):
    #:
    #: - ``"keyed"``  — state containers are keyed by the same uint64
    #:   routing keys the operator's exchange spec uses; ``split_state``
    #:   filters by destination key-shard, ``merge_states`` unions disjoint
    #:   pieces.
    #: - ``"pinned"`` — the whole state lives on worker 0 (gather-routed
    #:   operators: Capture, GradualBroadcast, external index).
    #:   ``split_state`` hands every destination the piece unchanged and
    #:   ``merge_states`` keeps source worker 0's piece — gather semantics
    #:   guarantee the other source workers' copies are pristine, and a
    #:   replicated copy on destination workers > 0 is inert (they never
    #:   receive gathered rows).
    #: - ``"replicate"`` — per-source scanner state (RealtimeSource): only
    #:   the owner worker ever advanced it; every destination receives the
    #:   field-wise union so the post-rescale owner (source index mod M)
    #:   finds it wherever it lands.
    RESHARD: str = "keyed"

    @classmethod
    def split_state(cls, state: dict, key_mask) -> dict:
        """The sub-state of one persisted ``snapshot_state()`` dict owned by
        a destination worker. ``key_mask(uint64[n]) -> bool[n]`` answers
        "does this routing key belong to the destination's shard". The
        generic implementation splits int-keyed dicts, ``RowState`` tables
        and lists/tuples of those by their top-level keys — operators whose
        state is shaped differently override (GroupByReduce arenas, Join
        arrangements, temporal buffers)."""
        if cls.RESHARD != "keyed":
            return state
        return {
            f: _split_keyed_value(cls, f, v, key_mask)
            for f, v in state.items()
        }

    @classmethod
    def merge_states(cls, states: list[dict]) -> dict:
        """Combine split pieces (one per SOURCE worker, in worker order)
        into one destination state. Keyed pieces are key-disjoint by the
        routing invariant and union; pinned state keeps source worker 0's
        piece; replicated source state unions field-wise."""
        if not states:
            raise ValueError(f"{cls.__name__}.merge_states: no pieces")
        if cls.RESHARD == "pinned":
            return states[0]
        if cls.RESHARD == "replicate":
            fields = states[0].keys()
            return {
                f: _merge_replicated_value(cls, f, [s[f] for s in states])
                for f in fields
            }
        fields = states[0].keys()
        return {
            f: _merge_keyed_value(cls, f, [s[f] for s in states])
            for f in fields
        }

    #: fingerprint-transparent nodes (Exchange) take their input's
    #: structural fingerprint verbatim: sharding inserts them between
    #: stateful operators, and an analysis of a sharded graph must agree
    #: with an unsharded lowering of the same script
    FINGERPRINT_TRANSPARENT = False

    #: static-analysis verdict on this operator's state growth
    #: (``analysis/passes.py``'s unbounded-state pass): None = stateless or no
    #: verdict; False = state grows with the number of distinct keys/rows
    #: seen (groupby arenas, join arrangements — unbounded over a
    #: never-ending source unless something upstream forgets); True = state
    #: is bounded by construction (temporal buffers drain on watermark
    #: progress).
    ANALYSIS_STATE_BOUNDED: "bool | None" = None

    def analysis_forgets(self) -> bool:
        """Does this operator RETRACT rows once the watermark passes them
        (bounding every stateful consumer downstream)? ForgetAfter with
        ``forget_state`` answers True; the analyzer treats such a node as
        a state-growth firewall on the source→stateful-operator path."""
        return False

    def analysis_signature(self) -> tuple:
        """Operator-specific structural parameters folded into the stable
        operator fingerprint (``analysis/graph.py``). Must be identity-free:
        derived from construction parameters only, never node ids or
        object identities, so two compiles of the same script agree."""
        return ()

    def __init__(self, inputs: list["Node"], column_names: list[str]):
        self.node_id = next(Node._ids)
        self.inputs = list(inputs)
        self.column_names = list(column_names)
        #: pw.local_error_log() scope of the table this node was lowered
        #: from (set by graph_runner.lower; None = no local scope)
        self.error_scope: int | None = None

    def has_state(self) -> bool:
        return bool(self.STATE_FIELDS)

    def snapshot_state(self) -> dict:
        """Picklable snapshot of the operator's durable state. Called at a
        consistency point (after a tick sweep, before the next); the result
        plus replay of later input must reproduce the operator exactly
        (reference operator_snapshot.rs:18-293)."""
        return {
            f: getattr(self, f) for f in self.STATE_FIELDS if hasattr(self, f)
        }

    def snapshot_state_parts(self):
        """Streaming snapshot protocol: yield picklable parts that
        together reproduce ``snapshot_state()``'s result via
        ``state_from_parts``. The default is a single part: the monolithic
        state."""
        yield self.snapshot_state()

    @classmethod
    def state_from_parts(cls, parts) -> dict:
        """Reassemble the materialized state dict from a parts stream
        (inverse of ``snapshot_state_parts``; fed to ``restore_state``)."""
        return next(parts)

    def restore_state(self, state: dict) -> None:
        for f, v in state.items():
            setattr(self, f, v)

    def exchange_specs(self) -> list[tuple | None]:
        """Routing requirement per input port for sharded execution: None
        (stateless — rows may stay wherever they are) or a route spec the
        sharding pass turns into an Exchange node (see operators.Exchange).
        Stateful operators MUST route so each worker owns a disjoint
        key-shard of their state (reference ShardPolicy, value.rs:93)."""
        return [None] * len(self.inputs)

    def on_shard(self, ctx) -> None:
        """Hook called by the sharding pass on every node; sink nodes mute
        user callbacks on workers that never receive gathered rows."""

    def process(self, time: int, in_deltas: list[Delta | None]) -> Delta | None:
        raise NotImplementedError

    def advance_to(self, time: int) -> Delta | None:
        """Called when logical time advances to `time`, before any deltas at
        `time` are delivered. Temporal buffers release their due rows here."""
        return None

    def on_end(self) -> Delta | None:
        """Input frontier closed — flush anything still buffered."""
        return None

    def __repr__(self) -> str:
        return f"<{type(self).__name__} #{self.node_id} cols={self.column_names}>"


def _min_stamp(a: "int | None", b: "int | None") -> "int | None":
    """Oldest of two optional ingest stamps (ns)."""
    if a is None:
        return b
    if b is None:
        return a
    return min(a, b)


def _mask_keys(key_mask, keys) -> np.ndarray:
    """Apply a shard mask to an iterable of python-int keys."""
    arr = np.fromiter((int(k) & 0xFFFFFFFFFFFFFFFF for k in keys),
                      dtype=np.uint64, count=len(keys))
    return key_mask(arr)


def _split_keyed_value(cls, field: str, value, key_mask):
    from .state import RowState

    if value is None:
        return None
    if isinstance(value, RowState):
        out = RowState(value.columns)
        items = list(value.iter_items())
        if items:
            keep = _mask_keys(key_mask, [k for k, _ in items])
            for (k, row), m in zip(items, keep.tolist()):
                if m:
                    out._rows[k] = row
                    out._counts[k] = 1
        return out
    if isinstance(value, dict):
        if not value:
            return {}
        if all(isinstance(k, (int, np.integer)) for k in value):
            ks = list(value)
            keep = _mask_keys(key_mask, ks)
            return {k: value[k] for k, m in zip(ks, keep.tolist()) if m}
    if isinstance(value, (list, tuple)):
        parts = [_split_keyed_value(cls, field, v, key_mask) for v in value]
        return type(value)(parts)
    raise TypeError(
        f"{cls.__name__}.{field} holds a {type(value).__name__} that the "
        "generic keyed resharder cannot split — the operator must override "
        "split_state/merge_states"
    )


def _merge_keyed_value(cls, field: str, values: list):
    from .state import RowState

    if all(v is None for v in values):
        return None
    if isinstance(values[0], RowState):
        out = RowState(values[0].columns)
        for piece in values:
            for k, row in piece.iter_items():
                if k in out._rows:
                    raise ValueError(
                        f"{cls.__name__}.{field}: key {k:#x} present in two "
                        "source workers' state — routing invariant violated"
                    )
                out._rows[k] = row
                out._counts[k] = 1
        return out
    if isinstance(values[0], dict):
        out: dict = {}
        for piece in values:
            for k, v in piece.items():
                if k in out and out[k] != v:
                    raise ValueError(
                        f"{cls.__name__}.{field}: key {k!r} present in two "
                        "source workers' state — routing invariant violated"
                    )
                out[k] = v
        return out
    if isinstance(values[0], (list, tuple)):
        merged = [
            _merge_keyed_value(cls, field, [v[i] for v in values])
            for i in range(len(values[0]))
        ]
        return type(values[0])(merged)
    raise TypeError(
        f"{cls.__name__}.{field}: cannot merge {type(values[0]).__name__} "
        "generically — the operator must override merge_states"
    )


def _merge_replicated_value(cls, field: str, values: list):
    """Union of per-source scanner state: only the owner worker ever
    advanced it, the peers hold the initial value, so sets/dicts union,
    numbers take their max and None loses to anything."""
    present = [v for v in values if v is not None]
    if not present:
        return None
    first = present[0]
    try:
        if all(v == first for v in present[1:]):
            return first
    except Exception:
        pass  # unorderable / ambiguous equality — fall through to merging
    if isinstance(first, set):
        out_set: set = set()
        for v in present:
            out_set |= v
        return out_set
    if isinstance(first, dict):
        # key-union with RECURSIVE conflict resolution: progress markers
        # (e.g. per-file row counts) must merge numerically (max), never
        # by repr ordering — '999' > '1500' as strings
        out: dict = dict(first)
        for v in present[1:]:
            for k, val in v.items():
                if k not in out:
                    out[k] = val
                elif out[k] != val:
                    out[k] = _merge_replicated_value(
                        cls, f"{field}[{k!r}]", [out[k], val]
                    )
        return out
    if isinstance(first, (int, float)) and not isinstance(first, bool):
        return max(present)
    raise TypeError(
        f"{cls.__name__}.{field}: conflicting source-state values of type "
        f"{type(first).__name__} cannot be merged — override merge_states"
    )


class SourceNode(Node):
    """A source: provides a schedule of (time, delta) batches.

    Batch inputs yield everything at a single time; streaming test sources
    (stream generators, demo streams, the python ConnectorSubject machinery)
    yield a finite timestamped schedule. Long-running realtime sources
    implement ``poll`` instead (see io/).
    """

    def __init__(self, column_names: list[str]):
        super().__init__([], column_names)

    def schedule(self) -> list[tuple[int, Delta]]:
        raise NotImplementedError

    def process(self, time: int, in_deltas: list[Delta | None]) -> Delta | None:
        return None


class RealtimeSource(SourceNode):
    """A live long-running source, polled by the streaming event loop.

    ``attach_waker`` hands the source the loop's wake event: setting it on
    new data ends the idle park immediately (the reference's unpark on
    channel activity) instead of waiting out the poll interval — this is
    what keeps serve-path latency at data-arrival time, not park cadence.

    The reference runs each connector on its own thread feeding a channel
    drained by the worker loop's pollers (``src/connectors/mod.rs:427``,
    ``dataflow.rs:5596-5650``); subclasses here do the same — a producer
    thread fills an internal queue and ``poll()`` drains it.
    """

    #: stable id used by persistence to snapshot/replay this source's input
    #: (reference `persistent_id` / unique_name, src/connectors/mod.rs)
    persistent_id: str | None = None

    #: scanner state (seen-file sets, CDC cursors) is per-source, not
    #: keyed by row shard: a rescale replicates the owner's state to every
    #: destination so the new owner (source index mod M) finds it
    RESHARD = "replicate"

    def schedule(self) -> list[tuple[int, Delta]]:
        return []

    def start(self) -> None:
        """Begin producing (spawn the reader thread)."""

    def attach_waker(self, event) -> None:
        """Receive the streaming loop's wake event; implementations may set
        it when new data arrives to end the idle park immediately."""
        self.waker = event

    def poll(self) -> list[Delta]:
        """Drain everything produced since the last poll. Each returned
        delta is committed at its own fresh timestamp (a commit tick)."""
        return []

    def take_ingest_stamps(self) -> list["int | None"]:
        """Ingest wall-time stamps (ns) aligned 1:1 with the deltas the
        last ``poll()`` returned — when the connector actually received
        each batch's oldest row. Feeds the ingest→emit latency histogram
        (EngineStats.e2e_latency_hist); sources without stamping return
        ``[]`` and their ticks simply don't observe."""
        return []

    def is_finished(self) -> bool:
        return False

    def stop(self) -> None:
        """Request shutdown (engine teardown)."""

    # -- persistence protocol (reference OffsetAntichain, connectors/offset.rs)

    def offset_state(self):
        """JSON-serializable resume position covering everything emitted by
        `poll` so far. None = non-replayable (snapshot replay only)."""
        return None

    def seek(self, state) -> None:
        """Skip input already covered by `state` (recovery restart)."""

    def observe_replay(self, delta: Delta) -> None:
        """Recovery: one of this source's persisted batches is being replayed
        through the dataflow. Diff-based sources (full-state scanners)
        rebuild their internal last-seen state here so the first live poll
        only emits genuinely new changes."""


def owned_sources(realtime: list["RealtimeSource"], ctx) -> list["RealtimeSource"]:
    """The realtime sources THIS worker polls (round-robin by source
    index). The single owner per source is also the correctness anchor of
    persisted offsets: only the owner's offset ever advances, so only the
    owner records it — which is what lets a rescale union per-pid offsets
    across workers exactly (rescale/resharder.py). Polling and recording
    MUST use this same assignment."""
    if not ctx.is_sharded:
        return list(realtime)
    return [
        s for i, s in enumerate(realtime)
        if i % ctx.n_workers == ctx.worker_id
    ]


def _topological(nodes: list[Node]) -> list[Node]:
    """Deterministic topo order (DFS post-order, children by construction
    id): the sharding pass inserts Exchange nodes after their consumers were
    constructed, so plain id order is no longer topological."""
    seen: dict[int, bool] = {}
    out: list[Node] = []

    def visit(n: Node) -> None:
        if seen.get(n.node_id):
            return
        seen[n.node_id] = True
        for inp in n.inputs:
            visit(inp)
        out.append(n)

    for n in sorted(nodes, key=lambda n: n.node_id):
        visit(n)
    return out


def shard_graph(nodes: list[Node], ctx: Any) -> list[Node]:
    """Insert Exchange nodes on every stateful-operator input (SURVEY §7
    step 6: record exchange at groupby/join boundaries). Channel ids derive
    from each consumer's position in the deterministic build order so the
    same program built on every worker agrees on them."""
    from .operators import Exchange

    ordered = sorted(nodes, key=lambda n: n.node_id)
    out = list(ordered)
    # monotone counter, not pos*16+port: nodes with >16 routed inputs
    # (Iterate gathers one port per pinned input) must not collide
    next_channel = 0
    # K stateless consumers of one realtime source share ONE Exchange (one
    # all-to-all per tick, not K identical ones)
    source_exchanges: dict[int, Node] = {}
    for node in ordered:
        node.on_shard(ctx)
        for port, spec in enumerate(node.exchange_specs()):
            inp = node.inputs[port]
            if spec is None:
                # realtime sources are polled by one owner worker only;
                # spread their rows to owner shards immediately so all
                # downstream *stateless* work (expressions, UDFs, filters)
                # parallelizes too (reference: connector input exchanged to
                # owner shards right after the reader, SURVEY §3.2 step 5)
                if not isinstance(inp, RealtimeSource):
                    continue
                if inp.node_id in source_exchanges:
                    node.inputs[port] = source_exchanges[inp.node_id]
                    continue
                spec = ("key",)
            ex = Exchange(inp, spec, ctx)
            ex.channel = next_channel
            next_channel += 1
            node.inputs[port] = ex
            out.append(ex)
            if isinstance(inp, RealtimeSource) and spec == ("key",):
                source_exchanges[inp.node_id] = ex
    return out


class Executor:
    """Runs a DAG of Nodes over logical times.

    Batch mode (finite source schedules) processes all scheduled times and
    finishes; streaming mode (any RealtimeSource present) is the analog of
    the reference per-worker event loop (``step_or_park`` + pollers +
    flushers, dataflow.rs:5596-5650): poll sources, mint an even wall-clock
    commit timestamp (timestamp.rs:22-28), run one topological sweep, park
    briefly when idle.
    """

    def __init__(self, nodes: list[Node], persistence: Any = None, ctx: Any = None):
        if ctx is None:
            from ..parallel.comm import single_worker_context

            ctx = single_worker_context()
        self.ctx = ctx
        if ctx.is_sharded:
            nodes = shard_graph(nodes, ctx)
        # whole-graph kernel fusion (engine/fusion.py): maximal pure
        # Rowwise/Filter chains collapse into single FusedChain nodes and
        # groupby/join preambles are absorbed — AFTER sharding, so
        # Exchange boundaries are fusion barriers by construction.
        # PATHWAY_FUSION=0 is the escape hatch (fuse_graph no-ops).
        from .fusion import fuse_graph

        nodes = fuse_graph(nodes)
        self.nodes = _topological(nodes)
        self._consumers: dict[int, list[tuple[Node, int]]] = {}
        for node in self.nodes:
            for port, inp in enumerate(node.inputs):
                self._consumers.setdefault(inp.node_id, []).append((node, port))
        self._on_time_end: list[Callable[[int], None]] = []
        self._stop_requested = False
        self.persistence = persistence
        self._last_clock = 0
        self._defer_commit = False
        self.stats = EngineStats()
        #: cumulative ns spent inside _tick sweeps — the busy half of the
        #: wave critical path (sweep phase = busy delta between waves)
        self._busy_ns_total = 0
        #: (busy_ns, dwell_ns, perf_ns) snapshot at the end of the last
        #: commit wave; the next wave's sweep/inbox_dwell phases and its
        #: inter-wave interval are deltas against this mark
        self._wave_mark: "tuple[int, int, int] | None" = None
        #: cumulative ns this worker spent PARKED waiting for work in its
        #: sharded streaming loop (async or BSP) — the "waiting" half of a
        #: worker's busy fraction; blocked-in-collective time is NOT parked
        #: time (it hides in Exchange node time under detailed timing)
        self._idle_park_ns = 0
        #: ingest wall-time (ns) of the oldest row feeding the NEXT tick
        #: (set by the streaming loops from connector stamps); consumed
        #: and cleared by _tick to observe ingest→emit latency
        self._next_tick_ingest_ns: int | None = None
        self._tick_seq = 0
        #: perf_counter_ns of the last flight-recorded tick (throttle)
        self._flight_tick_ns = 0
        for node in self.nodes:
            # Exchange nodes report per-tick sent/received row counts into
            # the worker's stats (backpressure signals on /metrics)
            node._engine_stats = self.stats
            # the /attribution label the profiler's op slot publishes
            # while this node executes (fused chains refine to members)
            node._op_label = f"{type(node).__name__}#{node.node_id}"
        from ..internals.tracing import get_tracer

        self.tracer = get_tracer()
        # black box (observability/flightrecorder.py): None unless a flight
        # dir is configured — one None check per tick when disarmed
        from ..observability.flightrecorder import get_recorder

        self.flight = get_recorder()
        # spill-to-disk state budget (engine/spill.py): None unless
        # PATHWAY_STATE_MEMORY_BUDGET_MB is set — one None check per tick
        from . import spill as _spill

        self._state_budget = _spill.get_budget()
        if persistence is not None:
            # sharded mode: commits are coordinated by the sharded loops (an
            # agreed tick under BSP, a commit wave under async), never a
            # per-worker wall-clock whim — all workers must snapshot
            # operator state at the SAME time, or
            # replaying one worker's input tail would re-exchange rows into
            # peers whose state already includes them
            persistence.auto_commit = not ctx.is_sharded
            persistence.attach_nodes(self.nodes)

    def request_stop(self) -> None:
        self._stop_requested = True

    def _partition_source(self, delta: Delta) -> Delta:
        """Each worker reads its key-shard of every static schedule (no
        exchange needed at sources: downstream stateful boundaries re-route
        anyway). Times stay aligned across workers — empty partitions still
        tick."""
        if not self.ctx.is_sharded:
            return delta
        from . import keys as K

        shards = K.shard_of(delta.keys, self.ctx.n_workers)
        return delta.take(np.flatnonzero(shards == self.ctx.worker_id))

    def run(self) -> None:
        from ..observability import profiler as _profiler
        from . import keys as K

        # register this worker thread with the sampling profiler: _tick
        # (and fused chains) publish the executing operator's label into
        # the slot; None when PATHWAY_PROFILE=0
        self.stats._op_slot = _profiler.current_op_slot()
        # stateless dataflows (no keyed operator state anywhere) suspend
        # 128-bit key registration for the duration of the run: conflation
        # can only corrupt coexisting keyed STATE, and the registry probe
        # costs real throughput on unique-key streams (see keys.py)
        stateless = not any(n.has_state() for n in self.nodes)
        if stateless:
            K._suspend_registration(+1)  # thread-local: this executor only
        for node in self.nodes:
            if isinstance(node, RealtimeSource):
                node._keys_register = not stateless
        if self.flight is not None:
            self.flight.record(
                "run.start",
                worker=self.ctx.worker_id,
                n_workers=self.ctx.n_workers,
                n_nodes=len(self.nodes),
            )
        try:
            if self.tracer is not None:
                try:
                    with self.tracer.span(
                        "engine.run",
                        n_nodes=len(self.nodes),
                        worker=self.ctx.worker_id,
                        n_workers=self.ctx.n_workers,
                    ):
                        self._run_inner()
                finally:
                    if not self.ctx.is_sharded:
                        # sharded runs flush once after every worker
                        # joined — a per-worker flush here would freeze
                        # the file at the first worker's finish
                        self.tracer.flush()
            else:
                self._run_inner()
            if self.flight is not None:
                self.flight.record(
                    "run.end",
                    worker=self.ctx.worker_id,
                    ticks=self.stats.ticks,
                    rows=self.stats.rows_total,
                )
        except BaseException as e:
            if self.flight is not None:
                # the ring is the only record a crashed worker leaves —
                # name the failure before it propagates
                self.flight.record(
                    "run.error", worker=self.ctx.worker_id, error=repr(e)
                )
            raise
        finally:
            if stateless:
                K._suspend_registration(-1)
            # a parked pool thread must not keep counting as an engine
            # thread in the profiler's op-tagged accounting
            self.stats._op_slot = None
            _profiler.release_op_slot()

    def _run_inner(self) -> None:
        realtime = [n for n in self.nodes if isinstance(n, RealtimeSource)]
        if realtime:
            self._run_streaming(realtime)
            return
        # Collect source schedules, merged by time (monotone processing order).
        pending: dict[int, list[tuple[SourceNode, Delta]]] = {}
        for node in self.nodes:
            if isinstance(node, SourceNode):
                for time, delta in node.schedule():
                    pending.setdefault(int(time), []).append(
                        (node, self._partition_source(delta))
                    )
        # batch mode: every input is a finite schedule already in hand
        self.stats.sources_connected = True

        for time in sorted(pending):
            self._tick(time, pending[time])
        self._finish()

    def _run_streaming(self, realtime: list[RealtimeSource]) -> None:
        import time as _time

        # finite schedules (static tables) land on the first ticks
        pending: dict[int, list[tuple[SourceNode, Delta]]] = {}
        for node in self.nodes:
            if isinstance(node, SourceNode) and not isinstance(node, RealtimeSource):
                for t, delta in node.schedule():
                    pending.setdefault(int(t), []).append(
                        (node, self._partition_source(delta))
                    )
        clock = 0
        for t in sorted(pending):
            clock = max(clock + 2, int(t))
            self._tick(clock, pending[t])

        if self.persistence is not None:
            clock = max(clock, self._recover(realtime))
            # exactly-once replay determinism: a recovered run must
            # re-derive the same tick boundaries as the original run, so
            # the backpressure coalescing of backlogged windows
            # (PATHWAY_INGEST_COALESCE_WINDOWS, io/python.py) is disabled
            for src in realtime:
                if hasattr(src, "_coalesce_windows"):
                    src._coalesce_windows = 0

        if self.ctx.is_sharded:
            # frontier-driven asynchronous execution is the default for
            # sharded streaming (PATHWAY_ASYNC_EXEC=0 restores the BSP
            # lock-step tick loop); recovery replay above ran lock-step
            # either way — only the LIVE loop changes shape
            if self._use_async():
                self._stream_loop_sharded_async(realtime, clock)
            else:
                self._stream_loop_sharded(realtime, clock)
            self._finish()
            return

        import threading

        wake = threading.Event()
        for src in realtime:
            src.attach_waker(wake)
            src.start()
        self.stats.sources_connected = True
        try:
            while not self._stop_requested:
                self.stats.heartbeat()
                # each commit batch of a source gets its own timestamp;
                # batch j of every source shares round j's tick
                rounds: list[list[tuple[SourceNode, Delta]]] = []
                ingest: list[int | None] = []
                for src in realtime:
                    deltas = src.poll()
                    stamps = src.take_ingest_stamps()
                    for j, delta in enumerate(deltas):
                        if delta is None or not len(delta):
                            continue
                        while len(rounds) <= j:
                            rounds.append([])
                            ingest.append(None)
                        rounds[j].append((src, delta))
                        ingest[j] = _min_stamp(
                            ingest[j],
                            stamps[j] if j < len(stamps) else None,
                        )
                if rounds:
                    for j, emissions in enumerate(rounds):
                        # even wall-clock ms, strictly increasing (timestamp.rs)
                        wall = int(_time.time() * 1000) & ~1
                        clock = max(clock + 2, wall)
                        # a checkpoint between rounds of one poll cycle would
                        # persist offsets covering rounds not yet recorded —
                        # only the cycle's last tick may commit
                        self._defer_commit = j < len(rounds) - 1
                        self._next_tick_ingest_ns = ingest[j]
                        self._tick(clock, emissions)
                    self._defer_commit = False
                    if self.persistence is not None:
                        # every drained round has now ticked: live source
                        # offsets exactly cover the recorded input again
                        self.persistence.note_delivery_boundary()
                elif all(src.is_finished() for src in realtime):
                    break
                else:
                    # park until data arrives (waker) or the poll interval
                    # lapses (step_or_park's timed wait)
                    wake.wait(0.005)
                    wake.clear()
        finally:
            for src in realtime:
                src.stop()
        self._finish()

    def _stream_loop_sharded(self, realtime: list[RealtimeSource], clock: int) -> None:
        """Multi-worker streaming event loop: each realtime source is polled
        by exactly one owner worker (reference ``parallel_readers`` — other
        workers idle on that source, worker-architecture doc :40-42); every
        poll cycle the workers allgather (rounds, finished, stop, wall) so
        all agree on the tick times to sweep — the host-side progress
        protocol of SURVEY §7 hard part (c) under a total order."""
        import time as _time

        import threading

        ctx = self.ctx
        owned = owned_sources(realtime, ctx)
        wake = threading.Event()
        for src in owned:
            src.attach_waker(wake)
            src.start()
        self.stats.sources_connected = True
        cycle = 0
        try:
            while True:
                self.stats.heartbeat()
                rounds: list[list[tuple[SourceNode, Delta]]] = []
                cycle_ingest: int | None = None
                for src in owned:
                    deltas = src.poll()
                    stamps = src.take_ingest_stamps()
                    for j, delta in enumerate(deltas):
                        if delta is None or not len(delta):
                            continue
                        while len(rounds) <= j:
                            rounds.append([])
                        rounds[j].append((src, delta))
                        cycle_ingest = _min_stamp(
                            cycle_ingest,
                            stamps[j] if j < len(stamps) else None,
                        )
                finished = all(src.is_finished() for src in owned)
                wall = int(_time.time() * 1000) & ~1
                want_commit = (
                    self.persistence is not None
                    and self.persistence.should_commit()
                )
                gathered = ctx.comm.allgather(
                    ("cycle", cycle), ctx.worker_id,
                    (len(rounds), finished, self._stop_requested, wall,
                     want_commit, cycle_ingest),
                )
                cycle += 1
                n_rounds = max(p[0] for p in gathered)
                agreed_wall = max(p[3] for p in gathered)
                # oldest ingest stamp anywhere in the cluster this cycle:
                # gathered rows cross workers inside the tick (BSP), so
                # the sink worker needs the ORIGIN's stamp, not its own
                agreed_ingest: int | None = None
                for p in gathered:
                    agreed_ingest = _min_stamp(agreed_ingest, p[5])
                for j in range(n_rounds):
                    # identical on every worker: deterministic fn of the
                    # gathered payload and the shared tick history
                    clock = max(clock + 2, agreed_wall + 2 * j)
                    self._next_tick_ingest_ns = agreed_ingest
                    self._tick(clock, rounds[j] if j < len(rounds) else [])
                if n_rounds and self.persistence is not None:
                    # every drained round has now ticked: live source
                    # offsets exactly cover the recorded input again
                    self.persistence.note_delivery_boundary()
                # coordinated checkpoint: every worker snapshots operator
                # state at the SAME agreed tick (reference: workers agree on
                # the last complete snapshot, worker-architecture doc :57-61).
                # The decision is a function of the gathered payload, so a
                # worker that wants no commit still joins its peers' one —
                # no worker waits at a barrier the others skip
                if self.persistence is not None and any(p[4] for p in gathered):
                    self.persistence.commit(clock)
                # honour stop only after flushing this cycle's rounds —
                # breaking first would drop rows already drained from the
                # connector queues (the single-worker loop always flushes)
                if any(p[2] for p in gathered):
                    break
                if n_rounds == 0:
                    if all(p[1] for p in gathered):
                        break
                    # park until owned-source data arrives or the poll
                    # interval lapses; peers' data surfaces via the next
                    # cycle's allgather either way
                    park_t0 = _time.perf_counter_ns()
                    wake.wait(0.005)
                    wake.clear()
                    self._idle_park_ns += _time.perf_counter_ns() - park_t0
        finally:
            for src in owned:
                src.stop()

    # -- frontier-driven asynchronous execution ---------------------------
    #
    # The BSP loop above advances the whole cluster in lock-step: a
    # per-cycle allgather plus a blocking all-to-all per Exchange per tick
    # means one slow or skewed worker stalls everyone. The async loop
    # below is the timely/differential model (SURVEY §0/§2.5) under this
    # engine's total-order timestamps:
    #
    # - each worker mints its OWN tick times and sweeps on data
    #   availability (its sources' polls + whatever peers posted);
    # - Exchange nodes post buckets fire-and-forget and merge arrivals
    #   eagerly — data moves asynchronously, accumulation commutes;
    # - consistency comes from frontiers (engine/frontier.py): each
    #   worker broadcasts "all my future sends are at times > f", and
    #   commits/termination settle on a frontier-agreed boundary via the
    #   QuiesceVotes protocol before any worker snapshots state;
    # - exactly-once carries over because the delivery layer and the
    #   persistence snapshots key on logical time: commit waves pick a
    #   global time T > every worker's clock, settle all data <= T
    #   everywhere (two clean vote rounds), then every worker snapshots
    #   at the SAME T — the frontier-derived commit boundary replacing
    #   the BSP "agreed tick".
    #
    # PATHWAY_ASYNC_EXEC=0 restores the BSP loop bit-for-bit; recovery
    # replay and the END_TIME flush sweep stay lock-step in both modes.

    def _use_async(self) -> bool:
        if not self.ctx.is_sharded or self.ctx.comm is None:
            return False
        import os

        raw = os.environ.get("PATHWAY_ASYNC_EXEC")
        if raw is not None:
            enabled = raw.strip().lower() not in ("0", "false", "no", "off")
        else:
            # the device mesh-exchange collective is bulk-synchronous by
            # construction — keep it the owner of record exchange unless
            # async is explicitly requested
            enabled = not hasattr(self.ctx.comm, "exchange_deltas")
        return enabled and self.ctx.comm.supports_async()

    def _mint(self, clock: int) -> int:
        """Next local tick time: even wall-clock ms, strictly increasing
        (timestamp.rs:22-28) — per worker now, not cluster-agreed."""
        import time as _time

        return max(clock + 2, int(_time.time() * 1000) & ~1)

    def _stream_loop_sharded_async(
        self, realtime: list[RealtimeSource], clock: int
    ) -> None:
        import time as _time

        from ..internals.config import _env_float
        from ..parallel.asyncplane import AsyncPlane
        from .frontier import QuiesceVotes

        ctx = self.ctx
        plane = AsyncPlane(ctx.comm, ctx.worker_id, ctx.n_workers)
        ctx.async_plane = plane
        if self.stats._waves is None:
            from ..observability.critpath import WaveRecorder

            self.stats._waves = WaveRecorder(ctx.worker_id)
        self._wave_mark = None
        self._async_timeout_s = _env_float(
            "PATHWAY_COLLECTIVE_TIMEOUT_S", 600.0
        )
        bcast_s = _env_float("PATHWAY_FRONTIER_MS", 5.0) / 1000.0
        delivery = (
            getattr(self.persistence, "delivery", None)
            if self.persistence is not None
            else None
        )
        if delivery is not None:
            delivery.use_boundary_acks()
        owned = owned_sources(realtime, ctx)
        for src in owned:
            src.attach_waker(plane.waker)
            src.start()
        self.stats.sources_connected = True
        epoch = 0
        stop_seen = False
        term_votes: QuiesceVotes | None = None
        stall_logged = False
        participated_final = False
        if self.flight is not None:
            self.flight.record(
                "async.start", worker=ctx.worker_id, n_workers=ctx.n_workers
            )
        try:
            plane.broadcast_status({"ep": 0})
            while True:
                self.stats.heartbeat()
                plane.drain()
                worked = False
                # 1. poll OWNED sources; each commit batch gets its own
                #    locally-minted tick (round alignment across sources
                #    as in the BSP loop; no cross-worker agreement needed)
                rounds: list[list[tuple[SourceNode, Delta]]] = []
                ingest: list[int | None] = []
                # backpressure: a peer inbox (or outbound pipeline) at its
                # bound pauses ingestion — queued work drains, new data
                # waits at the connectors (bounded per-operator queues;
                # remote workers' depths ride their status broadcasts)
                if not stop_seen and not plane.congested():
                    for src in owned:
                        deltas = src.poll()
                        stamps = src.take_ingest_stamps()
                        for j, delta in enumerate(deltas):
                            if delta is None or not len(delta):
                                continue
                            while len(rounds) <= j:
                                rounds.append([])
                                ingest.append(None)
                            rounds[j].append((src, delta))
                            ingest[j] = _min_stamp(
                                ingest[j],
                                stamps[j] if j < len(stamps) else None,
                            )
                for j, emissions in enumerate(rounds):
                    clock = self._mint(clock)
                    self._next_tick_ingest_ns = _min_stamp(
                        ingest[j], plane.pending_ingest_ns()
                    )
                    self._tick(clock, emissions)
                    worked = True
                # 2. peer arrivals with no local round to ride (Exchange
                #    is always_run, so round sweeps above already took
                #    them) get a sweep of their own
                if not rounds and plane.releasable():
                    clock = self._mint(clock)
                    self._next_tick_ingest_ns = plane.pending_ingest_ns()
                    self._tick(clock, [])
                    worked = True
                # NOTE: unlike the BSP loop, no note_delivery_boundary()
                # here — a locally-ticked round only proves the rows were
                # POSTED, not that peers processed them or that their
                # output came back. Advancing the close-path boundary on
                # local progress would let a surviving worker's close()
                # commit input whose output died in a peer, and the
                # replay's skip_until would then suppress it forever (one
                # lost row per in-flight exchange). The boundary advances
                # only inside commit waves, where the settle quiesce
                # proves global <=T processing; input recorded after the
                # last wave is truncated by close() and re-read live on
                # resume (at-least-once callbacks, exactly-once state).
                # 3. frontier: everything this worker will ever send now
                #    carries a time > its clock; an idle worker promises
                #    up to the wall clock so peers' commit waves and stall
                #    detection never wait on a parked worker
                now = _time.monotonic()
                if not worked:
                    # idle promise up to the wall clock — and raise the
                    # local clock floor WITH it, so a later backwards
                    # wall step (NTP) can never mint a tick at or below
                    # the already-broadcast frontier (mints are
                    # max(clock+2, wall), monotone in clock)
                    clock = max(clock, (int(_time.time() * 1000) & ~1) - 2)
                plane.tracker.advance_local(
                    max(clock, plane.tracker.local()), now=now
                )
                plane.broadcast_status({}, min_interval_s=bcast_s)
                if not stop_seen and (
                    self._stop_requested
                    or any(
                        st.get("stop")
                        for st in plane.peer_status.values()
                    )
                ):
                    # sticky + broadcast: every worker flushes its drained
                    # rounds, stops polling, and converges on termination
                    stop_seen = True
                    plane.broadcast_status({"stop": True})
                # 4. commit wave: any worker's snapshot-interval lapse (or
                #    sink release pressure) pulls the whole cluster into a
                #    wave at a frontier-agreed time
                if self.persistence is not None:
                    want = self.persistence.should_commit() or any(
                        st.get("wc") == epoch
                        or (
                            st.get("cr") is not None
                            and st["cr"][0] == epoch
                        )
                        for st in plane.peer_status.values()
                    )
                    if want:
                        clock, was_final = self._async_commit_wave(
                            plane, clock, epoch
                        )
                        epoch += 1
                        if was_final:
                            # a terminated peer marked this wave final:
                            # global quiescence is proven (its vote round
                            # needed everyone), so skip straight out
                            participated_final = True
                            break
                        continue
                # 5. termination: when locally drained + finished (or
                #    stopping), vote; two clean rounds across the cluster
                #    = the dataflow is quiescent everywhere
                finished = all(src.is_finished() for src in owned)
                if not worked and (finished or stop_seen) \
                        and not plane.releasable():
                    if term_votes is None:
                        term_votes = QuiesceVotes(
                            ctx.n_workers, ctx.worker_id, "term"
                        )
                    if term_votes.needs_cast():
                        payload = term_votes.cast(
                            plane.sent_events, plane.recv_events,
                            plane.take_activity(),
                        )
                        plane.broadcast_status({"vote": payload})
                    for w, v in plane.take_votes("term"):
                        term_votes.observe(w, v)
                    if term_votes.step():
                        break
                if not worked:
                    # stall observability: name a peer that stopped
                    # advancing while others make progress (once)
                    if not stall_logged:
                        stalled = plane.tracker.stalled(now, 30.0)
                        if stalled and self.flight is not None:
                            self.flight.record(
                                "async.stall",
                                worker=ctx.worker_id,
                                stalled=stalled,
                            )
                            stall_logged = True
                    park_t0 = _time.perf_counter_ns()
                    plane.waker.wait(0.005)
                    plane.waker.clear()
                    self._idle_park_ns += _time.perf_counter_ns() - park_t0
            # final consistency point: one last wave so every worker's
            # newest snapshot shares ONE frontier-derived time (the
            # _finish path then commits at the same _last_clock cluster-
            # wide, exactly like the BSP loop's agreed ticks). It is a
            # REGULAR epoch wave carrying a ``fin`` marker: workers still
            # inside their main loop join it by epoch number exactly like
            # any other wave (a sentinel epoch would deadlock against a
            # concurrently-triggered regular wave), and the marker tells
            # them it was the last one.
            if self.persistence is not None and not participated_final:
                clock, _ = self._async_commit_wave(
                    plane, clock, epoch, fin=True
                )
                epoch += 1
            if self.flight is not None:
                self.flight.record(
                    "async.end", worker=ctx.worker_id,
                    frontier=plane.tracker.local(), epochs=epoch,
                )
        finally:
            for src in owned:
                src.stop()
            # the END_TIME flush sweep (and any recovery that follows a
            # crash) runs over the blocking collectives again
            ctx.async_plane = None

    def _async_commit_wave(
        self, plane, clock: int, epoch: int, fin: bool = False
    ) -> tuple[int, bool]:
        """One frontier-coordinated commit: agree on a target time T
        greater than every worker's clock, settle all data <= T
        everywhere (quiesce votes — settle sweeps are labeled exactly T,
        so multi-hop forwarding of <=T input stays inside the boundary),
        then snapshot at T on every worker. Replaces the BSP loop's
        agreed-tick collective commit; SIGKILL at ANY point recovers to
        the newest snapshot common to all workers, exactly as before.
        Returns (clock, was_final): final when any participant entered
        post-termination (its ``fin`` marker rides the ready payload)."""
        import time as _time

        from .frontier import QuiesceVotes

        ctx = self.ctx
        deadline = _time.monotonic() + self._async_timeout_s
        # -- phase stamps: the wave's accounting window opened when the
        # LAST wave released (self._wave_mark); sweep busy time and inbox
        # dwell accumulated since then are this wave's pipeline phases
        t_entry = _time.perf_counter_ns()
        mark = self._wave_mark
        if self.flight is not None:
            self.flight.record(
                "wave.phase", worker=ctx.worker_id, epoch=epoch,
                phase="frontier_wait",
            )
        ready_clock = max(clock, plane.tracker.local())
        # the ready broadcast carries this worker's wave-entry wall time
        # and its pre-wave busy time so every worker elects the holding
        # worker from IDENTICAL data (critpath.attribute_holder): last
        # entry when the spread is real, busiest pipeline when everyone
        # joined within scheduler jitter
        entry_wall = _time.time()
        busy_pre_ms = (
            self._busy_ns_total - (mark[0] if mark else 0)
        ) / 1e6
        plane.broadcast_status(
            {
                "wc": epoch,
                "cr": [
                    epoch, ready_clock, bool(fin),
                    entry_wall, round(busy_pre_ms, 3),
                ],
            }
        )
        readys = {ctx.worker_id: ready_clock}
        ready_order = [(ctx.worker_id, ready_clock, entry_wall)]
        busy_by = {ctx.worker_id: busy_pre_ms}
        was_final = bool(fin)
        while len(readys) < ctx.n_workers:
            plane.drain()  # keeps inbox bounds free; nothing is processed
            for w, st in plane.peer_status.items():
                cr = st.get("cr")
                if cr is not None and cr[0] == epoch:
                    if w not in readys:
                        ready_order.append(
                            (w, cr[1], cr[3] if len(cr) > 3 else 0.0)
                        )
                        busy_by[w] = cr[4] if len(cr) > 4 else 0.0
                    readys[w] = cr[1]
                    if len(cr) > 2 and cr[2]:
                        was_final = True
            if len(readys) >= ctx.n_workers:
                break
            now_mono = _time.monotonic()
            if now_mono > deadline:
                ages = plane.tracker.ages(now_mono)
                missing = ", ".join(
                    f"w{w}"
                    + (
                        f" (quiet {ages[w]:.1f}s)"
                        if ages.get(w) is not None
                        else " (never heard)"
                    )
                    for w in range(ctx.n_workers)
                    if w not in readys
                )
                raise RuntimeError(
                    f"worker {ctx.worker_id}: commit wave {epoch} timed "
                    f"out collecting ready clocks ({len(readys)}/"
                    f"{ctx.n_workers}; waiting on {missing}; "
                    "PATHWAY_COLLECTIVE_TIMEOUT_S)"
                )
            plane.waker.wait(0.002)
            plane.waker.clear()
        # T is strictly greater than every worker's promise: settle
        # sweeps at T can lawfully post data derived from <=T arrivals
        T = (max(readys.values()) + 2) & ~1
        clock = max(clock, T)
        plane.hold_above = T
        t_ready = _time.perf_counter_ns()
        tracer = self.tracer
        if tracer is not None:
            tracer.complete("wave.frontier_wait", t_entry, {"epoch": epoch})
        if self.flight is not None:
            self.flight.record(
                "wave.phase", worker=ctx.worker_id, epoch=epoch,
                phase="settle", time=T,
            )
        votes = QuiesceVotes(ctx.n_workers, ctx.worker_id, f"cw{epoch}")
        busy_before_settle = self._busy_ns_total
        self._async_settle(plane, votes, deadline, label=T)
        t_settled = _time.perf_counter_ns()
        settle_rounds = votes.round
        if tracer is not None:
            tracer.complete(
                "wave.settle", t_ready,
                {"epoch": epoch, "rounds": settle_rounds},
            )
        if plane.tracker.local() < T:
            plane.tracker.advance_local(T, now=_time.monotonic())
        if self.flight is not None:
            self.flight.record(
                "wave.phase", worker=ctx.worker_id, epoch=epoch,
                phase="snapshot", time=T,
            )
        self.persistence.commit(T)
        if tracer is not None:
            tracer.complete("wave.snapshot", t_settled, {"epoch": epoch})
        self._last_clock = max(self._last_clock, T)
        plane.hold_above = None
        plane.broadcast_status({"wc": -1, "cr": None, "ep": epoch + 1})
        t_end = _time.perf_counter_ns()
        # -- build the wave document and fold it into the counters
        commit_ns = t_end - t_settled
        snapshot_ns, release_ns = commit_ns, 0
        ph = getattr(self.persistence, "last_commit_phase_ns", None)
        if ph:
            # the manager's own split: snapshotting proper vs delivery
            # barrier + post-commit release (io/delivery.py boundary)
            release_ns = min(
                commit_ns, int(ph.get("barrier", 0)) + int(ph.get("release", 0))
            )
            snapshot_ns = commit_ns - release_ns
        phases_ms = {
            # busy sweep time since the last wave — includes this wave's
            # settle sweeps, which is why settle subtracts them below
            "sweep": (
                self._busy_ns_total - (mark[0] if mark else 0)
            ) / 1e6,
            "inbox_dwell": (
                plane.dwell_total_ns - (mark[1] if mark else 0)
            ) / 1e6,
            "frontier_wait": (t_ready - t_entry) / 1e6,
            "settle": max(
                0.0,
                (t_settled - t_ready)
                - (self._busy_ns_total - busy_before_settle),
            ) / 1e6,
            "snapshot": snapshot_ns / 1e6,
            "release": release_ns / 1e6,
        }
        duration_ns = t_end - t_entry
        doc = self.stats._waves.record_wave(
            epoch=epoch,
            T=T,
            t=_time.time(),
            duration_ms=duration_ns / 1e6,
            interval_ms=(t_entry - mark[2]) / 1e6 if mark else 0.0,
            phases_ms=phases_ms,
            settle_rounds=settle_rounds,
            ready_order=ready_order,
            busy_ms=busy_by,
            fin=was_final,
        )
        self.stats.note_wave(doc, duration_ns)
        self._wave_mark = (self._busy_ns_total, plane.dwell_total_ns, t_end)
        if self.flight is not None:
            self.flight.record(
                "async.commit", worker=ctx.worker_id, epoch=epoch, time=T,
                holder=doc["holder"], critical=doc["critical_stage"],
                dur_ms=round(duration_ns / 1e6, 3), rounds=settle_rounds,
            )
        if tracer is not None:
            # the wave.commit parent is emitted LAST but began at
            # t_entry: complete events nest by time-range enclosure on
            # the worker's track, so the merged Perfetto timeline shows
            # the wave span wrapping its phase children above
            tracer.complete(
                "wave.commit", t_entry,
                {
                    "epoch": epoch, "T": T, "holder": doc["holder"],
                    "critical": doc["critical_stage"],
                },
            )
        return clock, was_final

    def _async_settle(self, plane, votes, deadline: float,
                      label: int) -> None:
        """Drive the quiesce protocol for one commit wave: deliver every
        queued arrival <= label (sweeps run at exactly ``label``), vote,
        repeat until two consecutive clean rounds prove nothing at or
        below the boundary is in flight anywhere."""
        import time as _time

        while True:
            plane.drain()
            while plane.releasable():
                self._next_tick_ingest_ns = plane.pending_ingest_ns()
                self._tick(label, [])
            if votes.needs_cast():
                payload = votes.cast(
                    plane.sent_events, plane.recv_events,
                    plane.take_activity(),
                )
                plane.broadcast_status({"vote": payload})
            for w, v in plane.take_votes(votes.phase):
                votes.observe(w, v)
            if votes.step():
                return
            if _time.monotonic() > deadline:
                raise RuntimeError(
                    f"worker {self.ctx.worker_id}: commit-wave settle "
                    f"({votes.phase}) timed out at round {votes.round} "
                    "(PATHWAY_COLLECTIVE_TIMEOUT_S)"
                )
            plane.waker.wait(0.002)
            plane.waker.clear()

    def _recover(self, realtime: list[RealtimeSource]) -> int:
        """Restore operator state from the newest usable snapshot, replay
        only the input tail recorded after it (restart cost O(state) +
        O(tail), not O(history) — reference operator_snapshot.rs), seek
        sources past persisted offsets, then start recording live input.
        Returns the clock floor."""
        import time as _wall

        unnamed_schemas: dict[tuple, int] = {}
        for src in realtime:
            if src.persistent_id is None:
                unnamed_schemas[tuple(src.column_names)] = (
                    unnamed_schemas.get(tuple(src.column_names), 0) + 1
                )
        dupes = [cols for cols, n in unnamed_schemas.items() if n > 1]
        if dupes:
            # positional fallback ids would silently swap snapshots if the
            # sources were ever reordered and the column-name check can't
            # tell them apart — refuse instead
            raise RuntimeError(
                f"{sum(unnamed_schemas[c] for c in dupes)} unnamed sources share "
                f"identical column sets {[list(c) for c in dupes]}; persistence "
                "cannot distinguish their snapshots across restarts — give each "
                "source a stable name= id"
            )
        for i, src in enumerate(realtime):
            if src.persistent_id is None:
                src.persistent_id = f"src-{i}"
        by_pid = {src.persistent_id: src for src in realtime}

        # pick the newest operator snapshot present on EVERY worker — a crash
        # mid-commit-wave may have left some workers one version ahead; the
        # manager retains two versions so a common one always exists.
        # Delivery-managed sinks add a FLOOR (io/delivery.py): restore must
        # not climb above the minimum ack cursor, or output between the
        # cursor and the snapshot would never be regenerated (replay only
        # covers times after the restored snapshot) — a kill between a
        # metadata commit and its post-commit sink drain lands exactly here
        local_times = self.persistence.available_op_times()
        delivery_mgr = getattr(self.persistence, "delivery", None)
        floor = (
            delivery_mgr.recovery_floor() if delivery_mgr is not None else None
        )
        first_chunk = getattr(self.persistence, "_first_chunk", 0)
        if self.ctx.is_sharded:
            gathered = self.ctx.comm.allgather(
                ("recover-op",), self.ctx.worker_id,
                (tuple(local_times), floor, first_chunk),
            )
            common = set(gathered[0][0])
            for avail, _f, _c in gathered[1:]:
                common &= set(avail)
            floors = [f for _, f, _ in gathered if f is not None]
            floor = min(floors) if floors else None
            first_chunk = max(c for _, _, c in gathered)
        else:
            common = set(local_times)
        eligible = {
            t for t in common if floor is None or t <= floor
        }
        if common and not eligible:
            # reachable exactly once: a kill between the FIRST metadata
            # commit (snapshot written) and its post-commit sink drain —
            # the cursor still reads -1. Nothing was truncated yet
            # (truncation needs a full retention window), so restore
            # NOTHING and replay the retained input log from scratch: the
            # pending (never-released) output regenerates and the cursor
            # dedupes. Restoring a snapshot instead would suppress replay
            # below it and silently LOSE the undelivered output.
            import logging

            if first_chunk == 0:
                logging.getLogger("pathway_tpu_torch.persistence").warning(
                    "sink ack floor %s sits below every operator snapshot "
                    "%s; replaying the input log from scratch so the "
                    "undelivered output regenerates", floor, sorted(common),
                )
            else:
                # input below the oldest snapshot is gone — full replay
                # would rebuild garbage state. Restore the oldest
                # snapshot (loses the least output) and say so. Should be
                # unreachable: truncation requires commits whose drains
                # advanced the floor past the oldest retained snapshot.
                logging.getLogger("pathway_tpu_torch.persistence").warning(
                    "sink ack floor %s sits below every operator snapshot "
                    "%s but the input log was truncated (first chunk %d); "
                    "restoring the oldest snapshot — output between the "
                    "floor and it is LOST", floor, sorted(common),
                    first_chunk,
                )
                eligible = {min(common)}
        op_time = max(eligible) if eligible else -1
        if op_time >= 0:
            self.persistence.restore_operators(op_time)
        clock = max(0, op_time)

        # replay the recorded input tail (times after the operator snapshot)
        replay_t0 = _wall.perf_counter()
        replayed_rows = 0
        by_time: dict[int, list[tuple[SourceNode, Delta]]] = {}
        for t, pid, delta in self.persistence.replay_batches(after_time=op_time):
            src = by_pid.get(pid)
            if src is None:
                raise RuntimeError(
                    f"persisted state references source {pid!r} which is not "
                    "present in this program — the dataflow changed since the "
                    "snapshot was taken (give sources stable name= ids, or "
                    "clear the persistence backend)"
                )
            if list(delta.columns) != list(src.column_names):
                raise RuntimeError(
                    f"persisted snapshot for source {pid!r} has columns "
                    f"{list(delta.columns)} but the source now produces "
                    f"{list(src.column_names)} — refusing to replay "
                    "mismatched state (did unnamed sources get reordered?)"
                )
            by_time.setdefault(int(t), []).append((src, delta))
            src.observe_replay(delta)
            replayed_rows += len(delta)
        # sharded replay runs in lock-step over the union of all workers'
        # recorded times (Exchange nodes join a collective every tick)
        times = sorted(by_time)
        if self.ctx.is_sharded:
            gathered = self.ctx.comm.allgather(
                ("recover-times",), self.ctx.worker_id, tuple(times)
            )
            times = sorted({t for tup in gathered for t in tup})
        for t in times:
            self._tick(t, by_time.get(t, []))
            clock = max(clock, t)
        self.persistence.recovery_stats.update(
            op_time=op_time, replayed_rows=replayed_rows,
            replayed_ticks=len(times),
            replay_s=_wall.perf_counter() - replay_t0,
        )
        clock = max(clock, self.persistence.last_time)
        for src in realtime:
            state = self.persistence.offset_for(src.persistent_id)
            if state is not None:
                src.seek(state)
        # record offsets for OWNED sources only (the owner is the one
        # worker whose offset ever advances): each pid then appears in
        # exactly one worker's metadata, so a rescale can union per-pid
        # offsets across workers without conflicts
        self.persistence.begin_recording(owned_sources(realtime, self.ctx))
        return clock

    def _tick(self, time: int, source_emissions: list[tuple[SourceNode, Delta]]) -> None:
        import time as _wall

        self._tick_seq += 1
        tracer = self.tracer
        timed = tracer is not None or self.stats.detailed
        # tick duration is always histogrammed — two clock reads per tick
        # against a full topological sweep is noise, and it is the one
        # distribution that catches hot-path regressions unconditionally
        tick_t0 = _wall.perf_counter_ns()
        tick_wall_t0 = _wall.time_ns()
        ingest_ns = self._next_tick_ingest_ns
        self._next_tick_ingest_ns = None
        plane = getattr(self.ctx, "async_plane", None)
        if plane is not None:
            # async mode: Exchange posts forward the ORIGIN's ingest stamp
            # with the data, so the sink worker's ingest→emit observation
            # measures the true cross-worker path (the BSP loop shipped
            # this through the cycle allgather instead)
            plane.cur_ingest_ns = ingest_ns
            # fresh per-sweep slot: take() fills it with the oldest
            # arrival's route/dwell stamps for the staged e2e split
            plane.sweep_oldest = None
        out_rows_before = self.stats.output_rows
        inbox: dict[int, dict[int, list[Delta]]] = {}
        seeded: dict[int, list[Delta]] = {}
        for src, delta in source_emissions:
            seeded.setdefault(src.node_id, []).append(delta)
            if self.persistence is not None and isinstance(src, RealtimeSource):
                if src.persistent_id is not None:
                    self.persistence.record(time, src.persistent_id, delta)
        self._last_clock = max(self._last_clock, time) if time != END_TIME else self._last_clock
        op_slot = self.stats._op_slot
        for node in self.nodes:
            if op_slot is not None:
                # publish the executing operator to the sampling profiler
                # (one GIL-atomic attribute store per node; fused chains
                # refine this to member labels as they sweep)
                op_slot.label = node._op_label
            if timed:
                node_t0 = _wall.perf_counter_ns()
            out_parts: list[Delta] = []
            released = node.advance_to(time)
            if released is not None and len(released):
                out_parts.append(released)
            ports = inbox.get(node.node_id, {})
            if node.node_id in seeded:
                out_parts.extend(d for d in seeded[node.node_id] if len(d))
            elif ports or not node.inputs or node.always_run:
                ins: list[Delta | None] = [
                    concat_deltas(ports.get(p, []), node.inputs[p].column_names)
                    if p in ports
                    else None
                    for p in range(len(node.inputs))
                ]
                if any(x is not None for x in ins) or node.always_run:
                    if node.inputs and not self._consumers.get(node.node_id):
                        # terminal node (Subscribe/Capture/output writer):
                        # rows reaching it ARE the pipeline's output
                        self.stats.output_rows += sum(
                            len(d) for d in ins if d is not None
                        )
                    if node.error_scope is not None:
                        # errors raised during this node's processing carry
                        # its table's local_error_log scope (thread-local:
                        # one worker per thread under sharding)
                        from .error import set_current_scope

                        set_current_scope(node.error_scope)
                        try:
                            out = node.process(time, ins)
                        finally:
                            set_current_scope(None)
                    else:
                        out = node.process(time, ins)
                    if out is not None and len(out):
                        out_parts.append(out)
            if self.persistence is not None and node.has_state() and (
                ports or node.node_id in seeded or out_parts
            ):
                self.persistence.mark_dirty(node)
            emitted_rows = 0
            if out_parts:
                emitted = concat_deltas(out_parts, out_parts[0].columns)
                emitted_rows = len(emitted)
                self.stats.note_node(
                    node, emitted_rows,
                    is_source=isinstance(node, SourceNode),
                )
                self._route(node, emitted, inbox)
            if timed and (
                out_parts or ports or node.node_id in seeded or node.always_run
            ):
                # record nodes that did work even when they emitted nothing
                # (an expensive filter/join producing an empty delta is the
                # exact hot spot a trace exists to show)
                if tracer is not None:
                    tracer.complete(
                        f"{type(node).__name__}#{node.node_id}",
                        node_t0,
                        {"rows": emitted_rows},
                    )
                if self.stats.detailed and not getattr(
                    node, "ATTRIBUTES_MEMBERS", False
                ):
                    # fused chains self-report per-MEMBER cost splits
                    # (fusion.py) — recording the chain's own label too
                    # would double-count it above every member
                    self.stats.note_node_time(
                        node, _wall.perf_counter_ns() - node_t0
                    )
        if op_slot is not None:
            # between sweeps nothing is executing — a parked worker's
            # samples must not carry the last node's label
            op_slot.label = None
        sweep_ns = _wall.perf_counter_ns() - tick_t0
        self.stats.tick_duration.observe(sweep_ns)
        self._busy_ns_total += sweep_ns
        if ingest_ns is not None and self.stats.output_rows > out_rows_before:
            # rows stamped at connector ingest reached a terminal output
            # node within this sweep — one ingest→emit observation,
            # staged: when the oldest arrival this sweep delivered IS the
            # stamped row, its frame meta supplies route/dwell; a locally
            # sourced row spent its pre-sweep time in the route stage
            route_ns = dwell_ns = 0
            oldest = plane.sweep_oldest if plane is not None else None
            if oldest is not None and oldest[0] == ingest_ns:
                route_ns, dwell_ns = oldest[1], oldest[2]
            else:
                route_ns = max(0, tick_wall_t0 - ingest_ns)
            self.stats.note_e2e(
                ingest_ns, route_ns, dwell_ns, tick_wall_t0
            )
        self.stats.note_tick(time)
        for cb in self._on_time_end:
            cb(time)
        if (
            self.persistence is not None
            and time != END_TIME
            and not self._defer_commit
        ):
            self.persistence.on_time_end(time)
        if tracer is not None:
            # after the callbacks and the persistence commit, which can
            # dominate a tick and must show inside its span. Span + counter go in ONE append (worker id in
            # the counter name: counter tracks merge by (pid, name)).
            tracer.complete(
                "tick",
                tick_t0,
                {"time": time},
                counter=(
                    f"engine_rows.w{self.ctx.worker_id}",
                    {
                        "input": self.stats.input_rows,
                        "output": self.stats.output_rows,
                    },
                ),
            )
        if self.flight is not None:
            # throttled to one record per 10ms: the ring's job is the
            # FINAL ticks before a crash, and async execution sweeps more
            # often than the BSP loop ticked (arrival sweeps) — recording
            # every sweep would rotate rarer forensic records (slo.alert,
            # comm.broken) out of the ring faster
            now_ns = _wall.perf_counter_ns()
            if now_ns - self._flight_tick_ns >= 10_000_000:
                self._flight_tick_ns = now_ns
                self.flight.record(
                    "tick",
                    worker=self.ctx.worker_id,
                    time=time if time != END_TIME else -1,
                    seq=self._tick_seq - 1,
                    dur_ms=round((now_ns - tick_t0) / 1e6, 3),
                    rows=self.stats.rows_total,
                    out=self.stats.output_rows,
                )
        if self._state_budget is not None:
            # after the persistence commit: spilled segments materialize
            # into snapshots, so shedding right after one avoids paying an
            # immediate reload for state the commit just serialized. Only
            # THIS executor's stores: workers must never spill (and race)
            # a sibling thread's live arrangement — the budget is
            # per-worker
            from .spill import collect_spillable

            self._state_budget.maybe_spill(collect_spillable(self.nodes))

    def _route(
        self, node: Node, delta: Delta, inbox: dict[int, dict[int, list[Delta]]]
    ) -> None:
        for consumer, port in self._consumers.get(node.node_id, []):
            inbox.setdefault(consumer.node_id, {}).setdefault(port, []).append(delta)

    def _finish(self) -> None:
        delivery = (
            getattr(self.persistence, "delivery", None)
            if self.persistence is not None
            else None
        )
        if delivery is not None and not delivery.has_sinks():
            delivery = None
        if delivery is not None:
            # final consistency point FIRST, snapshotting PRE-end-of-stream
            # state: the END_TIME flush output generated below is a pure
            # function of this state, so a crash mid-final-delivery
            # restores here, re-runs _finish, regenerates the same END
            # batches, and the ack cursor dedupes — commit-after-sweep
            # would snapshot post-flush state that can never regenerate
            # the END batches a partial drain left undelivered
            self.persistence.commit(self._last_clock)
        inbox: dict[int, dict[int, list[Delta]]] = {}
        for node in self.nodes:
            out_parts: list[Delta] = []
            ports = inbox.get(node.node_id, {})
            if ports or (node.always_run and node.inputs):
                ins = [
                    concat_deltas(ports.get(p, []), node.inputs[p].column_names)
                    if p in ports
                    else None
                    for p in range(len(node.inputs))
                ]
                out = node.process(END_TIME, ins)
                if out is not None and len(out):
                    out_parts.append(out)
            flushed = node.on_end()
            if flushed is not None and len(flushed):
                out_parts.append(flushed)
            if out_parts:
                emitted = concat_deltas(out_parts, out_parts[0].columns)
                self._route(node, emitted, inbox)
        for cb in self._on_time_end:
            cb(END_TIME)
        if self.persistence is not None and delivery is None:
            self.persistence.commit(self._last_clock)
        if delivery is not None:
            # after the pre-sweep commit: release everything still pending
            # (END_TIME flush batches included), drain to acked, close
            delivery.finish()
        self.stats.finished = True
