"""Engine operator implementations over columnar deltas.

Copy of ``pathway_tpu/engine/operators.py`` with its operator snapshots (``GroupByReduce`` and
``Join`` in the reference's parts layout, the rest through ``STATE_FIELDS``), the rescale protocol
(``split_state``/``merge_states`` of the arena, the join's arrangements with the rk→jk map and its
cache, the temporal buffers, the pinned composites) and the spill tier (``GroupByReduce``'s dense
cold blocks and general cold buckets, ``_SortedSide``'s spilled runs; snapshots materialize both).
``Exchange`` has both of the reference's branches: the blocking all-to-all of the BSP loop and the
async plane's posts. Left out: the analyzer's hooks, the key-load sketch and the JAX array case of
``_as_column``.

Each class re-designs one family of the reference engine's ~60 ``Graph``
trait operations (``src/engine/graph.rs:664-1011``, implemented at
``src/engine/dataflow.rs``): rowwise expression tables, filter, reindex,
incremental groupby/reduce with retraction-correct reducers, incremental
join (inner/left/right/outer — differential ``join_core`` semantics,
``dataflow.rs:2270``), concat, update_rows/update_cells, flatten, and
output/subscribe sinks. Rowwise and filter nodes take plain callables over
the batch's numpy columns.
"""

from __future__ import annotations

from typing import Any, Callable

import operator

import numpy as np

from . import keys as K
from .delta import Delta, column_of_values, concat_deltas, rows_to_columns
from .error import ERROR_LOG, Error as EngineError, errors_seen, is_error
from .executor import END_TIME, Node, SourceNode
from .reducers import ReducerImpl
from .state import MultiIndex, RowState

CompiledExpr = Callable[[dict[str, np.ndarray], np.ndarray], np.ndarray]

_PAD_SALT = 0x00AD_0000_0000_0001


def _rows_equal(a: tuple | None, b: tuple | None) -> bool:
    """Tuple equality that tolerates ndarray-valued cells."""
    if a is None or b is None:
        return a is b
    if len(a) != len(b):
        return False
    if all(map(operator.is_, a, b)):
        # the same cells, as in a recomputed group's unchanged rows: equal (ndarray and Error
        # cells too), unless a cell is a NaN, which the loop below finds unequal to itself
        return float not in map(type, a) or not any(
            type(x) is float and x != x for x in a)
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            if not (
                isinstance(x, np.ndarray)
                and isinstance(y, np.ndarray)
                and x.shape == y.shape
                and bool(np.all(x == y))
            ):
                return False
        elif x != y and not (x is None and y is None):
            # Error compares equal to nothing, but for EMISSION stability
            # two Error cells are the same output (no retract/re-insert
            # churn for a group stuck in error)
            if not (type(x) is EngineError and type(y) is EngineError):
                return False
    return True


class StaticSource(SourceNode):
    """A static table: all rows at time 0 (batch mode = stream that ends)."""

    def __init__(self, keys: np.ndarray, data: dict[str, np.ndarray]):
        super().__init__(list(data.keys()))
        self._delta = Delta(keys=keys, data=data)

    def schedule(self) -> list[tuple[int, Delta]]:
        return [(0, self._delta)]


class ScheduledSource(SourceNode):
    """A finite timestamped schedule of deltas (stream generators, demo
    streams, markdown tables with __time__/__diff__ columns)."""

    def __init__(self, column_names: list[str], batches: list[tuple[int, Delta]]):
        super().__init__(column_names)
        self._batches = batches

    def schedule(self) -> list[tuple[int, Delta]]:
        return self._batches


class Rowwise(Node):
    """expression_table (graph.rs:708): one compiled function per output
    column, evaluated over the whole batch."""

    def analysis_exprs(self) -> dict:
        """Compiled per-column kernels for the analyzer (each may carry
        ``_pw_expr``/``_pw_dtype`` breadcrumbs from compile_expr)."""
        return self._exprs

    def __init__(self, inp: Node, exprs: dict[str, CompiledExpr]):
        super().__init__([inp], list(exprs.keys()))
        self._exprs = exprs

    def process(self, time: int, ins: list[Delta | None]) -> Delta | None:
        d = ins[0]
        if d is None or not len(d):
            return None
        data = {name: _as_column(fn(d.data, d.keys), len(d)) for name, fn in self._exprs.items()}
        return d.replace_data(data)


class Filter(Node):
    def analysis_exprs(self) -> dict:
        return {"__pred__": self._predicate}

    def __init__(self, inp: Node, predicate: CompiledExpr):
        super().__init__([inp], inp.column_names)
        self._predicate = predicate

    def process(self, time: int, ins: list[Delta | None]) -> Delta | None:
        d = ins[0]
        if d is None or not len(d):
            return None
        mask = np.asarray(self._predicate(d.data, d.keys))
        if mask.dtype == object:
            # an Error condition drops the row with a log entry instead of
            # crashing the batch (reference: filter skips error rows)
            out = np.empty(len(mask), dtype=bool)
            for i, x in enumerate(mask):
                if type(x) is EngineError:
                    out[i] = False
                    if d.diffs[i] > 0:  # retraction of an error row: cleanup
                        ERROR_LOG.record(
                            "Error value encountered in filter condition, "
                            "skipping the row",
                            "filter",
                        )
                else:
                    out[i] = bool(x)
            mask = out
        return d.take(np.flatnonzero(mask))


class RemoveErrors(Node):
    """Drop rows in which any column holds an Error value (reference
    ``remove_errors`` / filter_out_results_of_failed_computations)."""

    def __init__(self, inp: Node):
        super().__init__([inp], inp.column_names)

    def process(self, time: int, ins: list[Delta | None]) -> Delta | None:
        d = ins[0]
        if d is None or not len(d):
            return None
        if not errors_seen():
            return d
        mask = None
        for c in self.column_names:
            col = np.asarray(d.data[c])
            if col.dtype == object:
                m = np.fromiter(
                    (type(v) is EngineError for v in col), bool, len(col)
                )
                mask = m if mask is None else (mask | m)
        if mask is None or not mask.any():
            return d
        return d.take(np.flatnonzero(~mask))


class Reindex(Node):
    """Replace row keys with a precomputed key column (with_id_from /
    groupby key routing / restrict)."""

    def analysis_signature(self) -> tuple:
        return (self._key_column, tuple(self._keep))

    def __init__(self, inp: Node, key_column: str, keep: list[str] | None = None):
        keep = keep if keep is not None else [c for c in inp.column_names if c != key_column]
        super().__init__([inp], keep)
        self._key_column = key_column
        self._keep = keep

    def process(self, time: int, ins: list[Delta | None]) -> Delta | None:
        d = ins[0]
        if d is None or not len(d):
            return None
        new_keys = np.asarray(d.data[self._key_column], dtype=np.uint64)
        return Delta(keys=new_keys, data={c: d.data[c] for c in self._keep}, diffs=d.diffs)


class Concat(Node):
    """concat of same-schema tables with disjoint key sets.

    Disjointness is *promised* at build time (the universe solver refuses
    otherwise); the engine still verifies it: a key live on two inputs at
    once means the promise was false, and silently merged rows would be
    wrong — raise instead (reference: engine-side key-uniqueness check
    behind `promise_are_pairwise_disjoint`).
    """

    # per-input live-key multiplicities backing the disjointness check
    # (only kept when verifying a promise, not a structural proof)
    STATE_FIELDS = ("_live",)

    def __init__(self, inputs: list[Node], verify: bool = True):
        super().__init__(inputs, inputs[0].column_names)
        #: False when the universe solver PROVED disjointness from table
        #: structure alone — no state, no exchanges, pure passthrough
        self._verify = verify
        self._live: list[dict[int, int]] = [{} for _ in inputs] if verify else []

    def has_state(self) -> bool:
        return self._verify

    def exchange_specs(self):
        if not self._verify:
            return [None] * len(self.inputs)
        # all inputs route by row key so each worker owns a consistent
        # slice of the liveness state
        return [("key",)] * len(self.inputs)

    def process(self, time: int, ins: list[Delta | None]) -> Delta | None:
        parts = []
        affected: set[int] = set()
        for port, d in enumerate(ins):
            if d is None or not len(d):
                continue
            if self._verify:
                mine = self._live[port]
                for i in range(len(d)):
                    k = int(d.keys[i])
                    c = mine.get(k, 0) + int(d.diffs[i])
                    if c:
                        mine[k] = c
                    else:
                        mine.pop(k, None)
                    affected.add(k)
            parts.append(d.select_columns(self.column_names))
        # verify only after ALL ports' deltas applied: a key migrating
        # between inputs within one tick (retract on one port, insert on
        # another) is disjoint at every tick boundary and must not trip
        for k in affected:
            if sum(1 for m in self._live if m.get(k, 0) > 0) > 1:
                raise ValueError(
                    f"concat: key {k:#x} is live in more than one input — "
                    "the universes promised disjoint "
                    "(promise_are_pairwise_disjoint) actually collide"
                )
        if not parts:
            return None
        return concat_deltas(parts, self.column_names)


class Exchange(Node):
    """Cross-worker record routing (the timely Exchange pact analog).

    Inserted automatically before every stateful operator input when the
    engine runs sharded (``shard_graph``): buckets local delta rows by the
    owner shard of their routing key (low key bits — reference SHARD_MASK,
    value.rs:38) and swaps buckets with all peers through the comm backend.
    Runs EVERY tick (``always_run``) — a worker with no local rows must
    still participate in the all-to-all to receive rows others route to it.

    route_spec: ("key",) row key | ("column", name) uint64 column |
    ("mix", cols, salt) group-value mix | ("gather",) everything→worker 0.
    """

    always_run = True

    # sharding inserts Exchanges the offline (unsharded) lowering never
    # sees; transparent fingerprints keep both compiles' manifests equal
    FINGERPRINT_TRANSPARENT = True

    def __init__(self, inp: Node, route_spec: tuple, ctx):
        super().__init__([inp], inp.column_names)
        self._spec = route_spec
        self._ctx = ctx
        #: stable cross-worker channel id; assigned by shard_graph (node ids
        #: are process-global counters and may differ between workers)
        self.channel: int = -1

    def _route_keys(self, d: Delta) -> np.ndarray:
        kind = self._spec[0]
        if kind == "key":
            return d.keys
        if kind == "column":
            col = np.asarray(d.data[self._spec[1]])
            if col.dtype == object:
                # optional pointer columns (ix optional / sort prev-next)
                # may hold None: route them by a fixed sentinel — the
                # downstream Join maps None to a never-matching key, so
                # WHERE the row lands only needs to be deterministic
                return np.array(
                    [
                        0xE707_0E0E_DEAD_0001 if v is None else int(v)
                        for v in col
                    ],
                    dtype=np.uint64,
                )
            return col.astype(np.uint64, copy=False)
        if kind == "mix":
            cols = [np.asarray(d.data[c]) for c in self._spec[1]]
            return K.mix_columns(cols, len(d), salt=self._spec[2])
        raise AssertionError(self._spec)

    def process(self, time: int, ins: list[Delta | None]) -> Delta | None:
        ctx = self._ctx
        n_w = ctx.n_workers
        d = ins[0]
        buckets: list[Delta | None] = [None] * n_w
        if d is not None and len(d):
            if self._spec[0] == "gather":
                buckets[0] = d
            else:
                shards = K.shard_of(self._route_keys(d), n_w)
                for w in range(n_w):
                    ix = np.flatnonzero(shards == w)
                    if len(ix):
                        buckets[w] = d.take(ix)
        plane = getattr(ctx, "async_plane", None)
        if plane is not None:
            # frontier-driven mode: post peer buckets fire-and-forget and
            # merge whatever peers already delivered for this channel —
            # no rendezvous, no waiting on the slowest worker. Delivery is
            # eager (timely's model: data moves asynchronously, only
            # notifications/commits follow the frontier); accumulation
            # commutes, so out-of-order cross-worker merge is lawful.
            own = buckets[ctx.worker_id]
            sent_rows = sum(
                len(b) for i, b in enumerate(buckets)
                if b is not None and i != ctx.worker_id
            )
            plane.post(self.channel, time, buckets)
            received, _ingest = plane.take(self.channel)
            if own is not None and len(own):
                received.append(own)
            stats = getattr(self, "_engine_stats", None)
            if stats is not None:
                stats.note_exchange(
                    sent_rows + (len(own) if own is not None else 0),
                    sum(len(r) for r in received),
                )
            if not received:
                return None
            return concat_deltas(received, self.column_names)
        if hasattr(ctx.comm, "exchange_deltas"):
            # device path (MeshComm): dense columns ride the card via
            # bucketed_all_to_all; object columns take the host path
            received = ctx.comm.exchange_deltas(
                self.channel, time, ctx.worker_id, buckets, self.column_names
            )
        else:
            received = ctx.comm.exchange(
                self.channel, time, ctx.worker_id, buckets
            )
        received = [r for r in received if r is not None and len(r)]
        stats = getattr(self, "_engine_stats", None)
        if stats is not None:
            stats.note_exchange(
                sum(len(b) for b in buckets if b is not None),
                sum(len(r) for r in received),
            )
        if not received:
            return None
        return concat_deltas(received, self.column_names)


class DanglingPointerError(KeyError):
    """A pointer to a row that is not there: a strict ``ix`` probe still unmatched when its
    frontier closed, or a row transformer's lookup of a row of another class (a ``KeyError``,
    as the reference raises). Under the async plane a row can arrive ahead of the row it points
    to, so the nodes that recompute from whole inputs (``GroupedRecompute``, ``Iterate``) hold
    such a result there until more input comes and raise it at the latest when their frontier
    closes, as ``IxStrictCheck`` does; elsewhere (one worker, the BSP loop, recovery replay and
    the end-of-stream sweep) every input of a tick has arrived, and they raise at once."""


def holds_dangling(ctx) -> bool:
    """Whether a node may hold a ``DanglingPointerError`` for later input: only while the
    frontier-driven async loop is live (``ctx.async_plane``)."""
    return getattr(ctx, "async_plane", None) is not None


class IxStrictCheck(Node):
    """End-of-stream guard behind non-optional ``ix`` (reference ix
    missing-key KeyError, test_common.py:2480): tracks probe rows (input 0,
    keyed by probe row key) against matched join output (input 1, same
    keys). A probe may lawfully arrive ticks before its indexed row —
    incremental join semantics withhold it — but a probe still unmatched
    when the frontier CLOSES is a permanent dangling pointer and raises.
    Infinite streams never close, so they only ever withhold.

    Sharded, both inputs route by row key: the join's output keeps its
    probe's key (``key_mode="left"``) but leaves the join on the worker of
    ``__ptr__``, so without its own exchange a probe and its match reached
    different workers' checks and each counted the other's probes as
    missing (the reference's check has no exchange and raises so)."""

    STATE_FIELDS = ("_probes", "_matched")

    def __init__(self, probes: Node, joined: Node):
        super().__init__([probes, joined], [])
        self._probes: dict[int, int] = {}
        self._matched: dict[int, int] = {}

    def exchange_specs(self):
        return [("key",), ("key",)]

    def process(self, time: int, ins: list[Delta | None]) -> Delta | None:
        p, j = ins
        if p is not None and len(p):
            for k, d in zip(p.keys.tolist(), p.diffs.tolist()):
                self._probes[k] = self._probes.get(k, 0) + d
        if j is not None and len(j):
            for k, d in zip(j.keys.tolist(), j.diffs.tolist()):
                self._matched[k] = self._matched.get(k, 0) + d
        return None

    def on_end(self) -> Delta | None:
        missing = sum(
            1 for k, c in self._probes.items()
            if c > 0 and self._matched.get(k, 0) <= 0
        )
        if missing:
            raise DanglingPointerError(
                f"ix: {missing} row(s) reference key(s) missing from the "
                "indexed table (use optional=True for left-join semantics)"
            )
        return None


class GroupByReduce(Node):
    """group_by_table + reducers (graph.rs:885, reduce.rs).

    State: per group — total row multiplicity, grouping values, one
    accumulator per reducer. Emits retraction of the previous result row and
    insertion of the new one for every affected group.
    Result key = hash of grouping values (consistent across tables, like the
    reference's ``Key::for_values`` result ids).

    Two execution paths (SURVEY §7 step 3 — "semigroup reducers as
    segment-reduce kernels"):

    - **dense arena** (all reducers count/sum over numeric columns): group
      state lives in columnar numpy arrays indexed by a dense slot id per
      group key (``SlotMap``, native C hash). A batch is one argsort +
      ``np.add.reduceat`` segment reduction + masked array updates — no
      per-row Python. This is the analog of the reference's
      ``SemigroupReducerImpl`` O(1)-state path (reduce.rs:40-61) at
      numpy batch speed.
    - **general** (min/max/tuple/custom/object dtypes): per-row multiset
      accumulators, retraction-correct for non-semigroup reducers. A dense
      arena demotes to this path permanently if a later batch brings a
      non-numeric argument column.
    """

    #: group state grows with the number of distinct keys — unbounded over
    #: a never-ending source unless something upstream forgets
    ANALYSIS_STATE_BOUNDED = False

    def analysis_signature(self) -> tuple:
        return (
            tuple(self._group_cols),
            tuple(
                (name, type(r).__name__, tuple(args))
                for name, r, args in self._reducers
            ),
            self._key_from_column,
            self._skip_errors,
        )

    def __init__(
        self,
        inp: Node,
        group_cols: list[str],
        reducers: list[tuple[str, ReducerImpl, list[str]]],
        key_salt: int = 0,
        key_from_column: str | None = None,
        skip_errors: bool = True,
    ):
        out_cols = list(group_cols) + [name for name, _, _ in reducers]
        super().__init__([inp], out_cols)
        self._group_cols = group_cols
        self._reducers = reducers
        self._key_salt = key_salt
        self._key_from_column = key_from_column
        #: reference groupby(_skip_errors=True) default: an Error arg cell
        #: is EXCLUDED from its reducer (count still counts the row);
        #: False keeps the error-multiplicity path (aggregate reads Error)
        self._skip_errors = skip_errors
        # group_key -> [count, group_values, [accs...], last_emitted_row|None]
        self._state: dict[int, list] = {}
        # group_key -> per-reducer Error multiplicity (reference
        # reduce.rs:162-173 error_count: any Error in a reduced column makes
        # that group's aggregate Error until the error rows retract)
        self._gerrs: dict[int, list[int]] = {}
        from .reducers import CountReducer, SumReducer
        from .slotmap import SlotMap
        from . import spill as _spill

        # spill tier (PATHWAY_STATE_MEMORY_BUDGET_MB, engine/spill.py):
        # dense arenas shed a cold PREFIX block of slots (old groups get
        # low slot ids; any touch below the boundary faults the whole
        # block back in); the general path sheds cold groups into hashed
        # buckets faulted back per-batch. Both materialize into snapshots.
        self._budget = _spill.get_budget()
        if self._budget is not None:
            self._budget.register(self)
        self._arena_base = 0  # slots [0, base) live in the cold blocks
        #: spill-store handles, oldest first — each holds one contiguous
        #: slot range; spills APPEND a block (never rewrite the whole
        #: cold prefix: that would be quadratic I/O and a 2x RAM spike
        #: at exactly the over-budget moment)
        self._arena_cold: list[dict] = []
        from collections import deque

        self._hot_slot_mins: Any = deque(maxlen=4)
        self._recent_hist: Any = deque(maxlen=2)
        self._recent_gks: set[int] = set()
        self._cold_set: set[int] = set()  # general groups now on disk
        self._cold_buckets: dict[int, dict] = {}  # bucket id -> handle
        self._entry_bytes_est = 512  # refined from real pickles at spill

        # reducer-preamble fusion (engine/fusion.py): the adjacent Rowwise
        # the lowering materializes group keys / reducer args in can be
        # absorbed so its kernels run inside this node, and — when the
        # group keys are plain references to exactly the columns the
        # source derived row keys from — the row keys are reused as group
        # keys bit-for-bit instead of re-hashing the columns
        self._preamble: dict[str, Any] | None = None
        self._preamble_label: str | None = None
        self._gkey_reuse_cols: tuple | None = None

        self._dense = all(
            type(r) in (CountReducer, SumReducer) for _, r, _ in reducers
        )
        self._is_count = [type(r) is CountReducer for _, r, _ in reducers]
        if self._dense:
            self._slots = SlotMap()
            self._counts = np.empty(0, dtype=np.int64)
            self._gkey_by_slot = np.empty(0, dtype=np.uint64)
            self._gvals: list[np.ndarray | None] = [None] * len(group_cols)
            # sum accumulators (None for count — multiplicity IS the value);
            # _prev holds the last *emitted* value per reducer, incl. counts
            self._accs: list[np.ndarray | None] = [
                None if c else np.empty(0, dtype=np.int64)
                for c in self._is_count
            ]
            self._emitted = np.empty(0, dtype=bool)
            self._prev: list[np.ndarray] = [
                np.empty(0, dtype=np.int64) for _ in reducers
            ]

    _DENSE_DTYPES = ("i", "u", "f", "b")

    def exchange_specs(self):
        if self._key_from_column is not None:
            return [("column", self._key_from_column)]
        return [("mix", self._group_cols, self._key_salt)]

    # -- operator snapshots (persist.rs analog) ---------------------------

    def has_state(self) -> bool:
        return True

    def snapshot_state(self) -> dict:
        # snapshots are the truth: spilled state (cold arena block, cold
        # general groups) MATERIALIZES into the snapshot, so recovery and
        # the resharder never depend on the scratch spill dir
        st: dict = {
            "_state": self._general_materialized(),
            "dense": self._dense,
            "gerrs": self._gerrs,
        }
        if self._dense:
            # trim arenas to allocated slots; the SlotMap is reconstructed
            # from _gkey_by_slot on restore (SlotMap.rebuild)
            st["arena"] = self._arena_full_trimmed()
        return st

    def snapshot_state_parts(self):
        """Streaming snapshot (persistence/snapshots.py write_parts): the
        resident head first, then each cold arena delta block and each
        cold general bucket loaded ONE AT A TIME — the writer flushes
        chunks between parts, so commit-time peak RSS is bounded by the
        largest single spilled segment plus a chunk, never the
        operator's total state (ROADMAP PR-8 corner)."""
        head: dict = {
            "dense": self._dense,
            "gerrs": self._gerrs,
            "state_resident": self._state,
            "n_cold_buckets": (
                len(self._cold_buckets) if self._cold_set else 0
            ),
        }
        if self._dense:
            n = len(self._slots)
            base = self._arena_base
            r = n - base
            head["arena_tail"] = {
                "_counts": self._counts[:r].copy(),
                "_gkey_by_slot": self._gkey_by_slot[:r].copy(),
                "_emitted": self._emitted[:r].copy(),
                "_accs": [
                    None if a is None else a[:r].copy() for a in self._accs
                ],
                "_prev": [p[:r].copy() for p in self._prev],
                "_gvals": [
                    None if g is None else g[:r].copy() for g in self._gvals
                ],
            }
            head["n_arena_blocks"] = len(self._arena_cold)
        yield head
        if self._dense and self._arena_cold:
            store = self._budget.spill_store()
            for h in self._arena_cold:
                yield store.get_blob(h)  # one cold block resident at a time
        if self._cold_set:
            store = self._budget.spill_store()
            for b in sorted(self._cold_buckets):
                blob = store.get_blob(self._cold_buckets[b])
                yield {
                    gk: entry
                    for gk, entry in blob.items()
                    if gk in self._cold_set
                }

    @classmethod
    def state_from_parts(cls, parts) -> dict:
        head = next(parts)
        st: dict = {
            "_state": dict(head["state_resident"]),
            "dense": head["dense"],
            "gerrs": head["gerrs"],
        }
        if head["dense"]:
            blocks = [next(parts) for _ in range(head["n_arena_blocks"])]
            st["arena"] = cls._cat_arena_parts(
                blocks + [head["arena_tail"]]
            )
        for _ in range(head.get("n_cold_buckets", 0)):
            st["_state"].update(next(parts))
        return st

    @staticmethod
    def _cat_arena_parts(blocks: list[dict]) -> dict:
        """Concatenate arena dicts in slot order (cold delta blocks, then
        the resident tail). Column None-ness is decided before the first
        slot exists, so a column is None in every block or in none; an
        empty tail array concatenates away."""
        if len(blocks) == 1:
            return blocks[0]

        def cat(cols):
            present = [c for c in cols if c is not None and len(c)]
            if not present:
                return None if all(c is None for c in cols) else cols[-1]
            if len(present) == 1:
                return present[0]
            return _concat_arena(present)

        first = blocks[0]
        return {
            "_counts": cat([b["_counts"] for b in blocks]),
            "_gkey_by_slot": cat([b["_gkey_by_slot"] for b in blocks]),
            "_emitted": cat([b["_emitted"] for b in blocks]),
            "_accs": [
                cat([b["_accs"][j] for b in blocks])
                for j in range(len(first["_accs"]))
            ],
            "_prev": [
                cat([b["_prev"][j] for b in blocks])
                for j in range(len(first["_prev"]))
            ],
            "_gvals": [
                cat([b["_gvals"][j] for b in blocks])
                for j in range(len(first["_gvals"]))
            ],
        }

    def _general_materialized(self) -> dict:
        """The general-path state with every cold group faulted into a
        COPY (the live dict and the cold tier stay as they are)."""
        if not self._cold_set:
            return self._state
        merged = dict(self._state)
        store = self._budget.spill_store()
        for b, handle in self._cold_buckets.items():
            for gk, entry in store.get_blob(handle).items():
                if gk in self._cold_set:
                    merged[gk] = entry
        return merged

    def _arena_full_trimmed(self) -> dict:
        """Snapshot-format arena covering slots [0, n): the cold block
        (if spilled) concatenated with the resident tail, copies only."""
        n = len(self._slots)
        base = self._arena_base
        r = n - base  # resident slot count
        if not base:
            return {
                "_counts": self._counts[:n].copy(),
                "_gkey_by_slot": self._gkey_by_slot[:n].copy(),
                "_emitted": self._emitted[:n].copy(),
                "_accs": [None if a is None else a[:n].copy() for a in self._accs],
                "_prev": [p[:n].copy() for p in self._prev],
                "_gvals": [None if g is None else g[:n].copy() for g in self._gvals],
            }
        cold = self._load_cold_blocks()

        def cat(c, res):
            if c is None and res is None:
                return None
            if c is None:
                return res.copy()
            if res is None or not len(res):
                return c.copy()
            return _concat_arena([c, res])

        return {
            "_counts": cat(cold["_counts"], self._counts[:r]),
            "_gkey_by_slot": cat(cold["_gkey_by_slot"], self._gkey_by_slot[:r]),
            "_emitted": cat(cold["_emitted"], self._emitted[:r]),
            "_accs": [
                cat(c, None if a is None else a[:r])
                for c, a in zip(cold["_accs"], self._accs)
            ],
            "_prev": [
                cat(c, p[:r]) for c, p in zip(cold["_prev"], self._prev)
            ],
            "_gvals": [
                cat(c, None if g is None else g[:r])
                for c, g in zip(cold["_gvals"], self._gvals)
            ],
        }

    def restore_state(self, state: dict) -> None:
        from .slotmap import SlotMap

        self._state = state["_state"]
        self._gerrs = state.get("gerrs", {})
        # restored state is fully resident; any previous spill handles
        # belong to a dead generation of this operator
        self._arena_base = 0
        self._arena_cold = []
        self._cold_set = set()
        self._cold_buckets = {}
        if not state["dense"]:
            if self._dense:
                # snapshot was taken after a demotion — mirror it
                self._dense = False
                del self._slots, self._counts, self._gkey_by_slot
                del self._gvals, self._accs, self._emitted, self._prev
            return
        a = state["arena"]
        self._counts = a["_counts"]
        self._gkey_by_slot = a["_gkey_by_slot"]
        self._emitted = a["_emitted"]
        self._accs = a["_accs"]
        self._prev = a["_prev"]
        self._gvals = a["_gvals"]
        self._slots = SlotMap.rebuild(self._gkey_by_slot)

    # -- spill tier (engine/spill.py spillable protocol) -------------------

    _ARENA_KEYS = ("_counts", "_gkey_by_slot", "_emitted")

    def spillable_bytes(self) -> int:
        if self._dense:
            total = self._counts.nbytes + self._gkey_by_slot.nbytes
            total += self._emitted.nbytes
            for group in (self._accs, self._prev, self._gvals):
                for a in group:
                    if a is not None:
                        total += (
                            len(a) * 64 if a.dtype == object else a.nbytes
                        )
            return total
        return len(self._state) * self._entry_bytes_est

    def spilled_bytes(self) -> int:
        total = sum(h["bytes"] for h in self._cold_buckets.values())
        total += sum(h["bytes"] for h in self._arena_cold)
        return total

    def spill(self, want_bytes: int) -> int:
        if self._budget is None:
            return 0
        if self._dense:
            return self._spill_dense(want_bytes)
        return self._spill_general(want_bytes)

    @staticmethod
    def _bucket_of(gk: int) -> int:
        return (gk >> 56) & 0xFF

    def _spill_dense(self, want_bytes: int) -> int:
        """Extend the cold prefix: every slot below the recent hot-slot
        watermark moves to ONE new delta block appended after the
        existing cold blocks (spills never reload or rewrite earlier
        blocks). Resident arrays re-slice only after the write lands."""
        n = len(self._slots)
        base = self._arena_base
        if n - base == 0:
            return 0
        hot_min = min(self._hot_slot_mins) if self._hot_slot_mins else n
        boundary = min(hot_min, n)
        k = boundary - base  # newly-cold resident slots
        if k <= 0:
            return 0
        store = self._budget.spill_store()
        payload = {
            "_counts": self._counts[:k].copy(),
            "_gkey_by_slot": self._gkey_by_slot[:k].copy(),
            "_emitted": self._emitted[:k].copy(),
            "_accs": [
                None if a is None else a[:k].copy() for a in self._accs
            ],
            "_prev": [p[:k].copy() for p in self._prev],
            "_gvals": [
                None if g is None else g[:k].copy() for g in self._gvals
            ],
        }
        freed = 0
        for group in ((self._counts, self._gkey_by_slot, self._emitted),
                      self._accs, self._prev, self._gvals):
            for a in group:
                if a is not None:
                    freed += (
                        k * 64 if a.dtype == object else k * a.itemsize
                    )
        handle = store.put_blob("gb/arena", payload)
        self._arena_cold.append(handle)
        self._arena_base = boundary
        self._counts = self._counts[k:].copy()
        self._gkey_by_slot = self._gkey_by_slot[k:].copy()
        self._emitted = self._emitted[k:].copy()
        self._accs = [None if a is None else a[k:].copy() for a in self._accs]
        self._prev = [p[k:].copy() for p in self._prev]
        self._gvals = [
            None if g is None else g[k:].copy() for g in self._gvals
        ]
        return freed

    def _unspill_arena(self) -> None:
        """Fault the cold blocks back in front of the resident arrays."""
        store = self._budget.spill_store()
        cold = self._load_cold_blocks()

        def cat(c, res):
            if c is None:
                return res
            if res is None or not len(res):
                return c
            return _concat_arena([c, res])

        self._counts = cat(cold["_counts"], self._counts)
        self._gkey_by_slot = cat(cold["_gkey_by_slot"], self._gkey_by_slot)
        self._emitted = cat(cold["_emitted"], self._emitted)
        self._accs = [
            cat(c, a) for c, a in zip(cold["_accs"], self._accs)
        ]
        self._prev = [cat(c, p) for c, p in zip(cold["_prev"], self._prev)]
        self._gvals = [
            cat(c, g) for c, g in zip(cold["_gvals"], self._gvals)
        ]
        for h in self._arena_cold:
            store.drop_blob(h)
        self._arena_cold = []
        self._arena_base = 0

    def _load_cold_blocks(self) -> dict:
        """The full cold prefix as one arena dict: every delta block
        loaded and concatenated in spill (= slot) order. Columns absent
        (None) in a block are absent in all of them — ``_gvals``/``_accs``
        None-ness is decided before the first slot exists."""
        store = self._budget.spill_store()
        blocks = [store.get_blob(h) for h in self._arena_cold]
        if len(blocks) == 1:
            return blocks[0]

        def cat(cols):
            present = [c for c in cols if c is not None]
            if not present:
                return None
            return _concat_arena(present)

        return {
            "_counts": cat([b["_counts"] for b in blocks]),
            "_gkey_by_slot": cat([b["_gkey_by_slot"] for b in blocks]),
            "_emitted": cat([b["_emitted"] for b in blocks]),
            "_accs": [
                cat([b["_accs"][j] for b in blocks])
                for j in range(len(self._accs))
            ],
            "_prev": [
                cat([b["_prev"][j] for b in blocks])
                for j in range(len(self._prev))
            ],
            "_gvals": [
                cat([b["_gvals"][ci] for b in blocks])
                for ci in range(len(self._gvals))
            ],
        }

    def _spill_general(self, want_bytes: int) -> int:
        """Move cold groups (untouched in the recent batches) into hashed
        disk buckets. A bucket whose write fails keeps its groups resident
        — nothing is dropped before its bytes are durable."""
        if not self._state:
            return 0
        store = self._budget.spill_store()
        if self._state and self._entry_bytes_est == 512:
            import itertools, pickle as _pickle

            sample = list(itertools.islice(self._state.items(), 8))
            self._entry_bytes_est = max(
                64, len(_pickle.dumps(sample)) // len(sample)
            )
        moved: dict[int, dict[int, list]] = {}
        budgeted = 0
        for gk, entry in self._state.items():
            if gk in self._recent_gks:
                continue
            moved.setdefault(self._bucket_of(gk), {})[gk] = entry
            budgeted += self._entry_bytes_est
            if budgeted >= want_bytes:
                break
        freed = 0
        for b, entries in moved.items():
            prev = self._cold_buckets.get(b)
            existing = store.get_blob(prev) if prev is not None else {}
            # prune entries faulted back in since the last write — the
            # cold set is the single source of which keys disk owns
            merged = {
                k: v for k, v in existing.items() if k in self._cold_set
            }
            merged.update(entries)
            handle = store.put_blob(f"gb/bucket/{b:02x}", merged, prev=prev)
            self._cold_buckets[b] = handle
            for gk in entries:
                del self._state[gk]
                self._cold_set.add(gk)
            freed += len(entries) * self._entry_bytes_est
        return freed

    def _fault_in_groups(self, gkeys: np.ndarray) -> None:
        """Move any of this batch's groups that live in cold buckets back
        into the resident dict (called before the per-row loop)."""
        need: dict[int, list[int]] = {}
        for gk in set(gkeys.tolist()):
            gk = int(gk)
            if gk in self._cold_set:
                need.setdefault(self._bucket_of(gk), []).append(gk)
        if not need:
            return
        store = self._budget.spill_store()
        for b, gks in need.items():
            data = store.get_blob(self._cold_buckets[b])
            for gk in gks:
                entry = data.get(gk)
                if entry is not None:
                    self._state[gk] = entry
                self._cold_set.discard(gk)

    # -- elastic rescale (rescale/resharder.py) ---------------------------

    @classmethod
    def split_state(cls, state: dict, key_mask) -> dict:
        from .executor import _split_keyed_value

        out = {
            "_state": _split_keyed_value(cls, "_state", state["_state"], key_mask),
            "dense": state["dense"],
            "gerrs": _split_keyed_value(
                cls, "gerrs", state.get("gerrs", {}), key_mask
            ),
        }
        if state["dense"]:
            a = state["arena"]
            gk = np.asarray(a["_gkey_by_slot"], dtype=np.uint64)
            keep = key_mask(gk) if len(gk) else np.zeros(0, dtype=bool)
            out["arena"] = {
                "_counts": a["_counts"][keep],
                "_gkey_by_slot": gk[keep],
                "_emitted": a["_emitted"][keep],
                "_accs": [None if x is None else x[keep] for x in a["_accs"]],
                "_prev": [p[keep] for p in a["_prev"]],
                "_gvals": [None if g is None else g[keep] for g in a["_gvals"]],
            }
        return out

    @classmethod
    def merge_states(cls, states: list[dict]) -> dict:
        from .executor import _merge_keyed_value

        if all(s["dense"] for s in states):
            arenas = [s["arena"] for s in states]
            slots = [len(a["_counts"]) for a in arenas]
            return {
                "_state": _merge_keyed_value(
                    cls, "_state", [s["_state"] for s in states]
                ),
                "dense": True,
                "gerrs": _merge_keyed_value(
                    cls, "gerrs", [s.get("gerrs", {}) for s in states]
                ),
                "arena": {
                    "_counts": _concat_arena([a["_counts"] for a in arenas]),
                    "_gkey_by_slot": _concat_arena(
                        [a["_gkey_by_slot"] for a in arenas]
                    ),
                    "_emitted": _concat_arena([a["_emitted"] for a in arenas]),
                    "_accs": _merge_arena_columns(
                        [a["_accs"] for a in arenas], slots
                    ),
                    "_prev": _merge_arena_columns(
                        [a["_prev"] for a in arenas], slots
                    ),
                    "_gvals": _merge_arena_columns(
                        [a["_gvals"] for a in arenas], slots
                    ),
                },
            }
        # mixed dense/general across source workers (one worker saw the
        # demoting column, another saw no rows at all): demote every dense
        # piece offline and merge in the general representation
        general: dict = {}
        for s in states:
            piece = _arena_to_general(s["arena"]) if s["dense"] else s["_state"]
            for gk, entry in piece.items():
                if gk in general:
                    raise ValueError(
                        f"GroupByReduce: group {gk:#x} present in two source "
                        "workers' state — routing invariant violated"
                    )
                general[gk] = entry
        return {
            "_state": general,
            "dense": False,
            "gerrs": _merge_keyed_value(
                cls, "gerrs", [s.get("gerrs", {}) for s in states]
            ),
        }

    def absorb_preamble(self, port: int, rowwise: "Rowwise") -> bool:
        """Fuse the adjacent Rowwise preamble into this node (called by
        engine/fusion.fuse_graph; the caller rewires inputs)."""
        if port != 0 or self._preamble is not None:
            return False
        self._preamble = dict(rowwise._exprs)
        self._preamble_label = f"Rowwise#{rowwise.node_id}"
        # content-key reuse precondition: every group key is a plain
        # column reference, in order — matched per batch against the
        # delta's key-provenance columns (Delta.keys_content_cols)
        self._gkey_reuse_cols = None
        if self._key_from_column is None and self._key_salt == 0:
            cols = []
            for c in self._group_cols:
                ref = getattr(self._preamble.get(c), "_pw_colref", None)
                if ref is None:
                    break
                cols.append(ref)
            else:
                self._gkey_reuse_cols = tuple(cols)
        return True

    def _apply_preamble(self, d: Delta) -> Delta:
        import time as _wall

        stats = getattr(self, "_engine_stats", None)
        timed = stats is not None and stats.detailed
        t0 = _wall.perf_counter_ns() if timed else 0
        n = len(d)
        data = {
            name: _as_column(fn(d.data, d.keys), n)
            for name, fn in self._preamble.items()
        }
        if timed:
            # the absorbed Rowwise keeps its own attribution label, so
            # /attribution still names it when IT is the bottleneck
            stats.note_op_time(
                self._preamble_label, _wall.perf_counter_ns() - t0
            )
        return d.replace_data(data)

    def process(self, time: int, ins: list[Delta | None]) -> Delta | None:
        d = ins[0]
        if d is None or not len(d):
            return None
        reuse_keys = None
        if self._preamble is not None:
            if (
                self._gkey_reuse_cols is not None
                and d.keys_content_cols == self._gkey_reuse_cols
                and not errors_seen()
            ):
                # the group keys would fold exactly the column hashes the
                # ingest row keys folded, same salt — the values are
                # bit-identical, and conflation detection already covers
                # them (the 128-bit pair was registered at ingest)
                reuse_keys = d.keys
            d = self._apply_preamble(d)
        d = self._skip_error_keys(d)
        if not len(d):
            return None
        n = len(d)
        gcols = [np.asarray(d.data[c]) for c in self._group_cols]
        if self._key_from_column is not None:
            gkeys = np.asarray(d.data[self._key_from_column], dtype=np.uint64)
        elif reuse_keys is not None and len(reuse_keys) == n:
            from .fusion import FUSION_STATS

            FUSION_STATS["key_reuse_total"] += 1
            gkeys = reuse_keys
        else:
            gkeys = K.mix_columns(gcols, n, salt=self._key_salt)
        if self._dense:
            arg_arrays = [
                None if is_count else np.asarray(d.data[args[0]])
                for is_count, (_, _, args) in zip(self._is_count, self._reducers)
            ]
            if all(
                a is None
                or (
                    a.dtype.kind in self._DENSE_DTYPES
                    # uint64 args don't fit the int64 accumulator exactly
                    # (astype wraps); the general path sums exact Python ints
                    and not (a.dtype.kind == "u" and a.dtype.itemsize == 8)
                )
                for a in arg_arrays
            ):
                return self._process_dense(d, n, gcols, gkeys, arg_arrays)
            self._demote()
        return self._process_general(d, n, gcols, gkeys, time)

    def _skip_error_keys(self, d: Delta) -> Delta:
        """Drop rows whose grouping values contain an Error (reference
        ErrorInGroupby, dataflow.rs:3026: log + skip, never poison the
        group). Free when no Error was ever created in this process."""
        if not errors_seen():
            return d
        key_cols = (
            [self._key_from_column]
            if self._key_from_column is not None
            else self._group_cols
        )
        mask = None
        for c in key_cols:
            col = np.asarray(d.data[c])
            if col.dtype == object:
                m = np.fromiter(
                    (type(v) is EngineError for v in col), bool, len(col)
                )
                mask = m if mask is None else (mask | m)
        if mask is None or not mask.any():
            return d
        # one log entry per skipped row with ADDITIONS only (a retraction
        # of an error row is cleanup, not a new incident) — reference
        # wording, test_errors.py:741
        for _ in range(int(mask[d.diffs > 0].sum())):
            ERROR_LOG.record(
                "Error value encountered in grouping columns, skipping "
                "the row",
                "groupby",
            )
        return d.take(np.flatnonzero(~mask))

    # -- dense arena path ------------------------------------------------

    def _grow(self, total: int) -> None:
        if total <= len(self._counts):
            return
        cap = max(64, len(self._counts))
        while cap < total:
            cap *= 2
        self._counts = np.concatenate(
            [self._counts, np.zeros(cap - len(self._counts), np.int64)]
        )
        grown = len(self._counts)
        self._gkey_by_slot = _resize(self._gkey_by_slot, grown)
        self._emitted = _resize(self._emitted, grown)
        for j in range(len(self._accs)):
            if self._accs[j] is not None:
                self._accs[j] = _resize(self._accs[j], grown)
            self._prev[j] = _resize(self._prev[j], grown)
        for ci in range(len(self._gvals)):
            if self._gvals[ci] is not None:
                self._gvals[ci] = _resize(self._gvals[ci], grown)

    def _reclaim_arena(self) -> None:
        """Drop slots of vanished groups (count 0, nothing emitted) so
        high-churn keyspaces don't grow the arena forever — the arena analog
        of the general path's ``del self._state[gk]``."""
        from .slotmap import SlotMap

        if self._arena_base:
            # cold slots are on disk and SlotMap.rebuild would renumber
            # resident slots over the cold block's ids — reclaim resumes
            # after the next fault-in
            return
        n_alloc = len(self._slots)
        live = np.flatnonzero(
            (self._counts[:n_alloc] != 0) | self._emitted[:n_alloc]
        )
        if n_alloc - len(live) < max(1024, len(live)):
            return
        self._slots = SlotMap.rebuild(self._gkey_by_slot[live])
        self._counts = self._counts[live].copy()
        self._gkey_by_slot = self._gkey_by_slot[live].copy()
        self._emitted = self._emitted[live].copy()
        for j in range(len(self._accs)):
            if self._accs[j] is not None:
                self._accs[j] = self._accs[j][live].copy()
            self._prev[j] = self._prev[j][live].copy()
        for ci in range(len(self._gvals)):
            if self._gvals[ci] is not None:
                self._gvals[ci] = self._gvals[ci][live].copy()

    def _store_fresh_groups(
        self, fresh_slots, fresh_first_ix, gcols, gkeys
    ) -> None:
        """Record a batch's NEW groups into the arena: group key per
        slot + the grouping values from each group's first occurrence.
        Shared by the sort and bincount segment-reduce paths — the
        dtype rules must never diverge between them: can_cast(int64,
        float64) is "safe" to numpy but rounds values > 2^53, so
        cross-kind mixes go to object instead."""
        self._gkey_by_slot[fresh_slots] = gkeys[fresh_first_ix]
        for ci, col in enumerate(gcols):
            stored = self._gvals[ci]
            if stored is None:
                stored = np.empty(len(self._counts), dtype=col.dtype)
                self._gvals[ci] = stored
            elif stored.dtype != object and not _lossless_cast(
                col.dtype, stored.dtype
            ):
                self._gvals[ci] = stored = stored.astype(object)
            stored[fresh_slots] = col[fresh_first_ix]

    def _process_dense(self, d, n, gcols, gkeys, arg_arrays) -> Delta | None:
        self._reclaim_arena()
        slots, n_new = self._slots.lookup_or_insert(gkeys)
        if self._arena_base and int(slots.min()) < self._arena_base:
            # the batch touches a group inside the spilled cold block —
            # fault the whole block back in (O(cold) once, then the
            # resident fast path below runs unchanged)
            self._unspill_arena()
        base = self._arena_base
        self._hot_slot_mins.append(int(slots.min()))
        old_n = len(self._slots) - n_new
        total = len(self._slots)
        self._grow(total - base)
        from .fusion import fusion_enabled as _fusion_on

        if (
            _fusion_on()
            and all(a is None for a in arg_arrays)
            # bincount scans O(arena) per batch — only when the arena is
            # not much larger than the batch (or small outright); a huge
            # arena fed tiny batches keeps the O(n log n) sort path
            and (total <= 4 * n or total <= 65536)
        ):
            # fused segmented reduce for pure-count groupbys (wordcount
            # shape): two O(n + arena) bincounts replace the stable
            # argsort + reduceat — touched slots come out ascending,
            # exactly the order the sort path produced. Float64 bincount
            # sums of per-batch diffs are exact (|sum| <= n < 2^53).
            occ = np.bincount(slots, minlength=total)
            u_slots_abs = np.flatnonzero(occ)
            u_slots = u_slots_abs - base
            if n_new:
                # SlotMap assigns fresh ids in first-occurrence order;
                # reversed fancy-store leaves each slot's FIRST index
                first_ix = np.empty(total, dtype=np.int64)
                first_ix[slots[::-1]] = np.arange(n - 1, -1, -1)
                fresh = u_slots_abs >= old_n
                self._store_fresh_groups(
                    u_slots[fresh], first_ix[u_slots_abs[fresh]],
                    gcols, gkeys,
                )
            if (d.diffs == 1).all():
                self._counts[u_slots] += occ[u_slots_abs]
            else:
                sums = np.bincount(slots, weights=d.diffs, minlength=total)
                self._counts[u_slots] += sums[u_slots_abs].astype(np.int64)
        else:
            order = np.argsort(slots, kind="stable")
            ss = slots[order]
            boundaries = np.flatnonzero(np.diff(ss) != 0) + 1
            starts = np.concatenate([[0], boundaries])
            u_slots_abs = ss[starts]
            # arena arrays cover slots [base, n) — index them relative
            u_slots = u_slots_abs - base
            if n_new:
                first_ix = order[starts]  # first occurrence of each u_slot
                fresh = u_slots_abs >= old_n
                self._store_fresh_groups(
                    u_slots[fresh], first_ix[fresh], gcols, gkeys
                )

            diffs_sorted = d.diffs[order]
            self._counts[u_slots] += np.add.reduceat(diffs_sorted, starts)
            for j, arr in enumerate(arg_arrays):
                if arr is None:
                    continue
                acc = self._accs[j]
                if arr.dtype.kind == "f" and acc.dtype.kind != "f":
                    self._accs[j] = acc = acc.astype(np.float64)
                    self._prev[j] = self._prev[j].astype(np.float64)
                contrib = arr.astype(acc.dtype) * d.diffs
                acc[u_slots] += np.add.reduceat(contrib[order], starts)

        new_counts = self._counts[u_slots]
        if (new_counts < 0).any():
            raise ValueError("negative multiplicity in groupby input")
        alive = new_counts > 0
        was = self._emitted[u_slots]
        changed = np.zeros(len(u_slots), dtype=bool)
        for j in range(len(self._reducers)):
            new_v = new_counts if self._is_count[j] else self._accs[j][u_slots]
            changed |= self._prev[j][u_slots] != new_v
        retract = was & (~alive | changed)
        insert = alive & (~was | changed)
        rs = u_slots[retract]
        is_ = u_slots[insert]

        out = None
        if len(rs) or len(is_):
            data: dict[str, np.ndarray] = {}
            for ci, cname in enumerate(self._group_cols):
                col = self._gvals[ci]
                data[cname] = np.concatenate([col[rs], col[is_]])
            for j, (rname, _, _) in enumerate(self._reducers):
                if self._is_count[j]:
                    old_v = self._prev[j][rs]
                    new_v = self._counts[is_]
                else:
                    old_v = self._prev[j][rs]
                    new_v = self._accs[j][is_]
                data[rname] = np.concatenate([old_v, new_v])
            out = Delta(
                keys=np.concatenate(
                    [self._gkey_by_slot[rs], self._gkey_by_slot[is_]]
                ),
                data=data,
                diffs=np.concatenate(
                    [np.full(len(rs), -1, np.int64), np.ones(len(is_), np.int64)]
                ),
            )
        # commit emission bookkeeping + reset emptied groups (the general
        # path deletes them; here the slot stays but state zeroes so a
        # revived group starts clean)
        self._emitted[u_slots] = alive
        for j in range(len(self._reducers)):
            if not self._is_count[j]:
                self._prev[j][is_] = self._accs[j][is_]
                self._accs[j][u_slots[~alive]] = 0
                self._prev[j][u_slots[~alive]] = 0
            else:
                self._prev[j][is_] = self._counts[is_]
                self._prev[j][u_slots[~alive]] = 0
        return out

    def _demote(self) -> None:
        """Migrate arena state into the general dict state (a non-numeric
        argument column arrived); one-way, per-operator."""
        if self._arena_base:
            self._unspill_arena()
        self._dense = False
        live = np.flatnonzero(self._counts != 0)
        for slot in live:
            gk = int(self._gkey_by_slot[slot])
            gvals = tuple(self._gvals[ci][slot] for ci in range(len(self._group_cols)))
            accs = []
            for j, (_, red, _) in enumerate(self._reducers):
                if self._is_count[j]:
                    accs.append(int(self._counts[slot]))
                else:
                    acc = self._accs[j][slot]
                    accs.append(acc.item() if isinstance(acc, np.generic) else acc)
            last = None
            if self._emitted[slot]:
                last = gvals + tuple(
                    self._prev[j][slot].item() for j in range(len(self._reducers))
                )
            self._state[gk] = [int(self._counts[slot]), gvals, accs, last]
        del self._slots, self._counts, self._gkey_by_slot
        del self._gvals, self._accs, self._emitted, self._prev

    # -- general path ----------------------------------------------------

    def _process_general(self, d, n, gcols, gkeys, time) -> Delta | None:
        if self._cold_set:
            self._fault_in_groups(gkeys)
        if self._budget is not None:
            batch = set(map(int, gkeys.tolist()))
            self._recent_hist.append(batch)
            self._recent_gks = set().union(*self._recent_hist)
        arg_cols = [[d.data[a] for a in args] for _, _, args in self._reducers]
        # Error-aware only when errors exist at all (the errors_seen latch
        # trips on every Error construction/unpickle — zero-cost guard on
        # clean pipelines, immune to ERROR_LOG.clear() and state restores)
        watch_errors = errors_seen()
        affected: dict[int, None] = {}
        for i in range(n):
            gk = int(gkeys[i])
            diff = int(d.diffs[i])
            st = self._state.get(gk)
            if st is None:
                st = [0, tuple(col[i] for col in gcols), [r.make() for _, r, _ in self._reducers], None]
                self._state[gk] = st
            st[0] += diff
            row_key = int(d.keys[i])
            for j, (_, red, _) in enumerate(self._reducers):
                vals = tuple(col[i] for col in arg_cols[j])
                if watch_errors and any(
                    type(v) is EngineError for v in vals
                ):
                    if self._skip_errors:
                        # reference groupby default: the Error cell is
                        # simply not reduced (count has no args and still
                        # counts the row)
                        continue
                    # _skip_errors=False (reference reduce.rs error_count):
                    # the Error row joins the group's error multiplicity,
                    # not the accumulator — the aggregate reads Error
                    # until it retracts
                    errs = self._gerrs.setdefault(
                        gk, [0] * len(self._reducers)
                    )
                    errs[j] += diff
                    continue
                st[2][j] = red.update(st[2][j], vals, diff, row_key, time)
            affected[gk] = None

        out_keys: list[int] = []
        out_rows: list[tuple] = []
        out_diffs: list[int] = []
        for gk in affected:
            st = self._state[gk]
            old_row = st[3]
            if st[0] < 0:
                raise ValueError("negative multiplicity in groupby input")
            errs = self._gerrs.get(gk)
            if errs is not None and not any(errs):
                self._gerrs.pop(gk)
                errs = None
            if st[0] == 0:
                new_row = None
            else:
                new_row = st[1] + tuple(
                    EngineError.silent("error value in reduced column")
                    if errs is not None and errs[j] > 0
                    else red.extract(st[2][j])
                    for j, (_, red, _) in enumerate(self._reducers)
                )
            if _rows_equal(old_row, new_row):
                if new_row is None:
                    del self._state[gk]
                    self._gerrs.pop(gk, None)
                continue
            if old_row is not None:
                out_keys.append(gk)
                out_rows.append(old_row)
                out_diffs.append(-1)
            if new_row is not None:
                out_keys.append(gk)
                out_rows.append(new_row)
                out_diffs.append(1)
                st[3] = new_row
            else:
                del self._state[gk]
                self._gerrs.pop(gk, None)
        if not out_keys:
            return None
        return Delta(
            keys=np.array(out_keys, dtype=np.uint64),
            data=rows_to_columns(out_rows, self.column_names),
            diffs=np.array(out_diffs, dtype=np.int64),
        )


def _concat_arena(pieces: list[np.ndarray]) -> np.ndarray:
    """Concatenate per-worker arena columns, promoting dtypes the same way
    the live operator does (int accumulators promote to float64 when any
    worker's did; any-object gvals make the merged column object)."""
    nonempty = [p for p in pieces if len(p)]
    if not nonempty:
        return pieces[0]
    if any(p.dtype == object for p in nonempty):
        return np.concatenate([p.astype(object) for p in nonempty])
    target = np.result_type(*[p.dtype for p in nonempty])
    return np.concatenate([p.astype(target, copy=False) for p in nonempty])


def _merge_arena_columns(per_piece: list[list], slots: list[int]) -> list:
    """Merge parallel lists of arena columns (one list per source worker,
    ``slots[i]`` = that worker's allocated slot count): column j of the
    result is the concatenation of every worker's column j. A ``None``
    column (count reducer's acc, or gvals never materialized) may sit
    next to arrays only when its piece holds ZERO slots — otherwise the
    concatenated column would silently fall out of alignment with the
    slot order at restore."""
    n_cols = len(per_piece[0])
    out: list = []
    for j in range(n_cols):
        cols = [p[j] for p in per_piece]
        if all(c is None for c in cols):
            out.append(None)
            continue
        for c, n_slots in zip(cols, slots):
            if c is None and n_slots:
                raise ValueError(
                    "GroupByReduce arena merge: a worker's snapshot holds "
                    f"{n_slots} slot(s) but no array for column {j} — "
                    "inconsistent snapshots (reducer config mismatch?)"
                )
        out.append(_concat_arena([c for c in cols if c is not None]))
    return out


def _arena_to_general(arena: dict) -> dict:
    """Offline analog of ``GroupByReduce._demote``: convert a snapshotted
    dense arena into general-path ``_state`` entries. A ``None`` slot in
    ``_accs`` marks a count reducer (its value IS the multiplicity)."""
    out: dict = {}
    counts = arena["_counts"]
    for slot in np.flatnonzero(counts != 0):
        gk = int(arena["_gkey_by_slot"][slot])
        gvals = tuple(g[slot] for g in arena["_gvals"])
        accs: list = []
        for acc in arena["_accs"]:
            if acc is None:
                accs.append(int(counts[slot]))
            else:
                v = acc[slot]
                accs.append(v.item() if isinstance(v, np.generic) else v)
        last = None
        if arena["_emitted"][slot]:
            last = gvals + tuple(
                p[slot].item() if isinstance(p[slot], np.generic) else p[slot]
                for p in arena["_prev"]
            )
        out[gk] = [int(counts[slot]), gvals, accs, last]
    return out


def _resize(arr: np.ndarray, total: int) -> np.ndarray:
    out = np.zeros(total, dtype=arr.dtype)
    out[: len(arr)] = arr
    return out


def _lossless_cast(src: np.dtype, dst: np.dtype) -> bool:
    """True when every value of ``src`` round-trips exactly through ``dst``
    — stricter than numpy 'safe' casting, which allows int64→float64."""
    if src == dst:
        return True
    if src.kind == "b":
        # bool→numeric is exact; bool→str would stringify ('True')
        return dst.kind in "biuf"
    if src.kind == dst.kind:
        return np.can_cast(src, dst)
    if src.kind in "iu" and dst.kind == "f":
        # float64 mantissa holds 53 bits: only ≤32-bit ints are exact
        return src.itemsize <= 4 and dst.itemsize >= 8
    return False


class _SortedSide:
    """One join side as a log-structured arrangement of jk-sorted columnar
    runs — the differential *arrangement* analog (sort-merge join on key
    shards, SURVEY §7 step 3). Probes are vectorized ``searchsorted`` range
    expansions; retractions ride as negative counts in newer runs and cancel
    at compaction, so ``d ⋈ state`` stays a linear operator over runs.

    Two maintenance optimizations keep per-tick cost amortized-log
    (BENCH ``join_stream_rows_per_sec``):

    - **size-tiered run merging**: ``apply`` merge-sorts tail runs whose
      sizes are within 2×, so a long stream holds O(log n) runs instead
      of hitting the periodic full-sort compaction wall every MAX_RUNS
      ticks;
    - **probe range memo**: the ``searchsorted`` (lo, hi) pair for a
      (run, query) array pair is cached by identity — ``totals`` and
      ``probe`` over the same affected-jk set in one tick (the pre/post
      pad snapshots of an unchanged arrangement) pay the binary search
      once. Runs are immutable after construction, which is what makes
      identity a sound cache key.

    Under ``PATHWAY_STATE_MEMORY_BUDGET_MB`` (engine/spill.py) the
    arrangement participates in the spill tier: cold runs (oldest first —
    size-tiering makes them the largest and the last to merge) shed their
    payload (row keys, value columns, counts) to the spill store, keeping
    only the sorted jk array and the count prefix-sum resident. ``totals``
    stays a pure in-memory operation; ``probe`` loads a spilled payload
    transiently ONLY when its jk range actually matches — the hot-key
    working set never touches disk. Snapshots are the truth: pickling
    (``__getstate__``) materializes every spilled run back into the
    resident representation, so recovery, ``split_state``/``merge_states``
    and the resharder never see a spill handle.
    """

    MAX_RUNS = 8
    _RANGE_CACHE_MAX = 16

    def __init__(self, n_cols: int):
        self._n_cols = n_cols
        self._runs: list[list] = []  # [jks_sorted, row_keys, cols, counts]
        #: (id(run_jks), id(qjks)) -> (run_jks, qjks, lo, hi); strong refs
        #: make ids valid, the size bound makes the pinning harmless
        self._range_cache: dict = {}
        #: id(run_jks) -> [run_jks, probe_count, (SlotMap, lo, hi) | None]
        #: — fusion fast path: a run probed repeatedly (the static
        #: dimension side of a stream⋈dim join is probed EVERY tick)
        #: gets a jk→(lo,hi) hash index replacing the per-probe binary
        #: search; runs are immutable so the index never invalidates
        self._jk_hash_idx: dict = {}
        #: fusion lane: raw (jks, keys, cols, diffs) batches whose sort +
        #: tiered merge is deferred until the arrangement is read
        self._pending: list[tuple] = []
        self._pending_rows = 0
        #: spilled cold runs, oldest first: [jks_sorted, csum, handle] —
        #: payload (row_keys, cols, counts) lives in the spill store
        self._spilled: list[list] = []
        from . import spill as _spill

        self._budget = _spill.get_budget()
        if self._budget is not None:
            self._budget.register(self)

    def __getstate__(self) -> dict:
        # the memo must not ride into operator snapshots (it pins query
        # arrays and is identity-keyed — meaningless after unpickling);
        # spilled runs MATERIALIZE into the snapshot — the scratch spill
        # dir is a cache, never part of durable or resharded state
        self._flush_pending()  # snapshots see the arranged representation
        d = dict(self.__dict__)
        d.pop("_range_cache", None)
        d.pop("_jk_hash_idx", None)
        d.pop("_pending", None)
        d.pop("_pending_rows", None)
        d.pop("_budget", None)
        spilled = d.pop("_spilled", None)
        if spilled:
            d["_runs"] = [self._load_spilled(rec) for rec in spilled] + list(
                d["_runs"]
            )
        return d

    def __setstate__(self, d: dict) -> None:
        self.__dict__.update(d)
        self._range_cache = {}
        self._jk_hash_idx = {}
        self._pending = []
        self._pending_rows = 0
        self._spilled = []
        from . import spill as _spill

        self._budget = _spill.get_budget()
        if self._budget is not None:
            self._budget.register(self)

    def _snapshot_skeleton(self) -> dict:
        """The resident-only pickle dict (spilled payloads EXCLUDED) —
        the streaming-snapshot head Join.snapshot_state_parts yields
        before streaming each spilled run's payload individually."""
        self._flush_pending()
        d = dict(self.__dict__)
        d.pop("_range_cache", None)
        d.pop("_jk_hash_idx", None)
        d.pop("_pending", None)
        d.pop("_pending_rows", None)
        d.pop("_budget", None)
        d.pop("_spilled", None)
        d["_runs"] = list(self._runs)
        return d

    def __len__(self) -> int:
        return (
            sum(len(r[0]) for r in self._runs)
            + sum(len(rec[0]) for rec in self._spilled)
            + getattr(self, "_pending_rows", 0)
        )

    # -- spill tier (engine/spill.py spillable protocol) -----------------

    @staticmethod
    def _col_bytes(col) -> int:
        arr = np.asarray(col)
        if arr.dtype == object:
            # pointer + a modest boxed-object estimate per cell
            return len(arr) * 64
        return arr.nbytes

    def _payload_bytes(self, run: list) -> int:
        # run[0] (jks) and run[4] (csum) stay resident after a spill, so
        # only keys + value columns + counts count as spillable
        return (
            run[1].nbytes
            + run[3].nbytes
            + sum(self._col_bytes(c) for c in run[2])
        )

    def spillable_bytes(self) -> int:
        self._flush_pending()  # spill decisions see arranged runs
        return sum(self._payload_bytes(r) for r in self._runs)

    def spilled_bytes(self) -> int:
        return sum(rec[2]["bytes"] for rec in self._spilled)

    def spill(self, want_bytes: int) -> int:
        """Shed the oldest resident runs' payloads to the spill store
        until ~want_bytes moved. A failed blob write propagates with the
        run still resident (the budget logs and keeps going)."""
        if self._budget is None:
            return 0
        self._flush_pending()  # only arranged runs spill
        store = self._budget.spill_store()
        freed = 0
        while self._runs and freed < want_bytes:
            run = self._runs[0]
            nbytes = self._payload_bytes(run)
            handle = store.put_blob("join/run", (run[1], run[2], run[3]))
            self._runs.pop(0)
            self._spilled.append([run[0], run[4], handle])
            self._range_cache.clear()
            freed += nbytes
        return freed

    def _load_spilled(self, rec: list) -> list:
        keys, cols, counts = self._budget.spill_store().get_blob(rec[2])
        return [rec[0], keys, cols, counts, rec[1]]

    def _unspill_all(self) -> None:
        """Materialize every spilled run back in front of the resident
        list (compaction needs the whole arrangement)."""
        if not self._spilled:
            return
        store = self._budget.spill_store()
        loaded = [self._load_spilled(rec) for rec in self._spilled]
        for rec in self._spilled:
            store.drop_blob(rec[2])
        self._spilled = []
        self._runs[:0] = loaded

    @staticmethod
    def _make_run(jks, keys, cols, counts) -> list:
        """Runs are immutable after construction: [jks, keys, cols, counts,
        count-prefix-sum] — the prefix sum backs O(log N) totals()."""
        return [jks, keys, cols, counts,
                np.concatenate([[0], np.cumsum(counts)])]

    def _ranges(self, run: list, qjks: np.ndarray) -> tuple:
        """Memoized ``(searchsorted left, right)`` of ``qjks`` in a run.

        A run probed repeatedly (fusion lane: the static dimension side
        of a stream⋈dim join takes a probe EVERY tick) upgrades to a
        jk→(lo, hi) hash index — native KeyTable lookups replace the
        two binary searches. Misses land on a (0, 0) sentinel: lo == hi,
        i.e. an empty range, exactly what searchsorted yields for an
        absent key."""
        jks_s = run[0]
        cache = self._range_cache
        key = (id(jks_s), id(qjks))
        hit = cache.get(key)
        if hit is not None and hit[0] is jks_s and hit[1] is qjks:
            return hit[2], hit[3]
        lo = hi = None
        from .fusion import fusion_enabled

        if fusion_enabled() and len(jks_s) >= 4096:
            ent = self._jk_hash_idx.get(id(jks_s))
            if ent is not None and ent[0] is not jks_s:
                ent = None  # recycled id
            if ent is None:
                if len(self._jk_hash_idx) >= 8:
                    self._jk_hash_idx.clear()
                ent = self._jk_hash_idx[id(jks_s)] = [jks_s, 0, None]
            ent[1] += 1
            if ent[2] is None and (
                ent[1] >= 2 or len(qjks) * 4 >= len(jks_s)
            ):
                # build on the second probe — or immediately when one
                # query batch alone amortizes the O(run) build (a large
                # coalesced probe pays ~150ns/query in binary-search
                # cache misses vs ~10ns hashed)
                from .slotmap import SlotMap

                starts = np.concatenate(
                    [[0], np.flatnonzero(np.diff(jks_s) != 0) + 1]
                )
                ends = np.concatenate([starts[1:], [len(jks_s)]])
                sm = SlotMap()
                slots, _ = sm.lookup_or_insert(jks_s[starts])
                # first-occurrence slot order over sorted uniques makes
                # slot i == position i; trailing sentinel serves slot -1
                ent[2] = (
                    sm,
                    np.concatenate([starts, [0]]),
                    np.concatenate([ends, [0]]),
                )
            if ent[2] is not None:
                sm, lo_by_slot, hi_by_slot = ent[2]
                slots = sm.lookup(qjks)
                lo = lo_by_slot[slots]
                hi = hi_by_slot[slots]
        if lo is None:
            lo = np.searchsorted(jks_s, qjks, "left")
            hi = np.searchsorted(jks_s, qjks, "right")
        if len(cache) >= self._RANGE_CACHE_MAX:
            cache.clear()
        cache[key] = (jks_s, qjks, lo, hi)
        return lo, hi

    def apply(self, jks, keys, cols, diffs) -> None:
        if not len(jks):
            return
        from .fusion import fusion_enabled

        if (
            fusion_enabled()
            and self._budget is None
            # only batches big enough that the deferred sort pays (tiny
            # batches keep the original eager layout, which unit tests
            # of the physical run structure observe) — but once a
            # pending list exists, EVERYTHING defers behind it: runs
            # must arrange in arrival order or retractions would
            # consolidate against the wrong prefix
            and (len(jks) >= 256 or self._pending)
        ):
            # fusion lane: defer sort + tiered merging until something
            # actually reads the arrangement (probe/totals/snapshot). A
            # side that is never probed again — the FACT side of a
            # stream⋈static-dimension join — never pays the maintenance
            # at all; an always-probed side flushes one batch per tick,
            # exactly the eager schedule. Bounded so a never-read side
            # cannot defer an unbounded compaction to snapshot time.
            # Eager under a state memory budget: pending raw batches
            # would dodge the spill tier's accounting.
            self._pending.append((
                jks, keys,
                [np.asarray(c) for c in cols],
                diffs.astype(np.int64),
            ))
            self._pending_rows += len(jks)
            if self._pending_rows >= 262_144:
                self._flush_pending()
            return
        self._apply_now(jks, keys, cols, diffs)

    def _flush_pending(self) -> None:
        if not getattr(self, "_pending", None):
            return
        pend, self._pending = self._pending, []
        self._pending_rows = 0
        for jks, keys, cols, diffs in pend:
            self._apply_now(jks, keys, cols, diffs)

    def _apply_now(self, jks, keys, cols, diffs) -> None:
        order = np.argsort(jks, kind="stable")
        self._runs.append(self._make_run(
            jks[order],
            keys[order],
            [np.asarray(c)[order] for c in cols],
            diffs[order].astype(np.int64),
        ))
        # size-tiered maintenance: merge the tail while neighbors are
        # within 2x, keeping the run count logarithmic in total rows with
        # amortized O(n log n) total merge work — no periodic full-sort
        # spike, and probes touch far fewer runs
        runs = self._runs
        while len(runs) > 1 and 2 * len(runs[-1][0]) >= len(runs[-2][0]):
            b = runs.pop()
            a = runs.pop()
            merged = self._merge_runs(a, b)
            if merged is not None:
                runs.append(merged)
        if len(runs) > self.MAX_RUNS:
            self._compact()

    def _merge_runs(self, a: list, b: list) -> list | None:
        """Merge two sorted runs into one (stable: a's rows precede b's
        within equal jks — b is the newer run). Pure-insert merges (the
        common streaming case) skip consolidation entirely; once a
        retraction is present the merge consolidates, so cancelled pairs
        are reclaimed incrementally rather than at a compaction wall.
        Returns None when everything cancelled."""
        from .delta import _concat_cols

        jks = np.concatenate([a[0], b[0]])
        keys = np.concatenate([a[1], b[1]])
        cols = [
            _concat_cols([a[2][i], b[2][i]]) for i in range(self._n_cols)
        ]
        counts = np.concatenate([a[3], b[3]])
        if len(counts) and counts.min() < 0:
            jks, keys, cols, counts = self._consolidate(jks, keys, cols, counts)
            if not len(jks):
                return None
        order = np.argsort(jks, kind="stable")
        return self._make_run(
            jks[order], keys[order], [c[order] for c in cols], counts[order]
        )

    @staticmethod
    def _consolidate(jks, keys, cols, counts):
        """Sum multiplicities of identical (jk, row_key, values) rows and
        drop the zeros — differential consolidation over a row batch."""
        sig = K.derive_pair(
            K.derive_pair(jks, keys),
            K.mix_columns(cols, len(jks), register=False),
        )
        order = np.argsort(sig, kind="stable")
        ss = sig[order]
        starts = np.concatenate([[0], np.flatnonzero(np.diff(ss) != 0) + 1])
        sums = np.add.reduceat(counts[order], starts)
        keep = sums != 0
        reps = order[starts[keep]]
        return jks[reps], keys[reps], [c[reps] for c in cols], sums[keep]

    def _compact(self) -> None:
        from .delta import _concat_cols

        self._flush_pending()
        self._unspill_all()
        if not self._runs:
            return
        jks = np.concatenate([r[0] for r in self._runs])
        keys = np.concatenate([r[1] for r in self._runs])
        cols = [
            _concat_cols([r[2][i] for r in self._runs])
            for i in range(self._n_cols)
        ]
        counts = np.concatenate([r[3] for r in self._runs])
        # row identity = (jk, row_key, values); multiplicities sum, zeros drop
        jks, keys, cols, counts = self._consolidate(jks, keys, cols, counts)
        order2 = np.argsort(jks, kind="stable")
        self._runs = (
            [self._make_run(
                jks[order2],
                keys[order2],
                [c[order2] for c in cols],
                counts[order2],
            )]
            if len(jks)
            else []
        )

    def probe(self, qjks: np.ndarray):
        """Yield (q_idx, row_keys, col_arrays, counts) for every state row
        matching each query jk, per run — the vectorized pair enumeration.
        Spilled runs (oldest, probed first to keep run order) decide the
        match from their RESIDENT jk array and load the payload from disk
        only on an actual hit — the working set stays in memory."""
        self._flush_pending()
        for rec in self._spilled:
            lo, hi = self._ranges(rec, qjks)
            m = hi - lo
            total = int(m.sum())
            if not total:
                continue
            _jks_s, keys, cols, counts, _csum = self._load_spilled(rec)
            q_idx = np.repeat(np.arange(len(qjks)), m)
            side_idx = np.repeat(lo, m) + (
                np.arange(total) - np.repeat(np.cumsum(m) - m, m)
            )
            yield q_idx, keys[side_idx], [c[side_idx] for c in cols], counts[side_idx]
        for run in self._runs:
            _jks_s, keys, cols, counts, _csum = run
            lo, hi = self._ranges(run, qjks)
            m = hi - lo
            total = int(m.sum())
            if not total:
                continue
            q_idx = np.repeat(np.arange(len(qjks)), m)
            side_idx = np.repeat(lo, m) + (
                np.arange(total) - np.repeat(np.cumsum(m) - m, m)
            )
            yield q_idx, keys[side_idx], [c[side_idx] for c in cols], counts[side_idx]

    def totals(self, qjks: np.ndarray) -> np.ndarray:
        """Total row multiplicity per query jk (the match-count vector the
        pad bookkeeping needs) — memoized searchsorted over a per-run
        prefix sum (shared with ``probe`` on the same query array). Pure
        in-memory even for spilled runs: their jks + prefix sums never
        leave RAM."""
        self._flush_pending()
        out = np.zeros(len(qjks), dtype=np.int64)
        for rec in self._spilled:
            lo, hi = self._ranges(rec, qjks)
            csum = rec[1]
            out += csum[hi] - csum[lo]
        for run in self._runs:
            lo, hi = self._ranges(run, qjks)
            csum = run[4]
            out += csum[hi] - csum[lo]
        return out


class Join(Node):
    """Incremental two-sided join (dataflow.rs:2270 / differential join_core).

    Inputs must carry a precomputed uint64 join-key column (``jk``) each.
    Algebra per tick:  out = L_old ⋈ dR  +  dL ⋈ (R_old + dR)
    which equals d(L ⋈ R). Outer modes additionally maintain match counts per
    row and emit/retract null-padded rows on 0↔nonzero transitions.

    All reactive modes run fully columnar over ``_SortedSide`` arrangements
    (no per-row Python); outer pads are recomputed from arrangement probes
    before/after the tick's deltas apply, with consolidation netting the
    unchanged ones. Only asof_now (react_to_right=False) outer modes keep
    the row-at-a-time path — their pads intentionally ignore later
    right-side changes.

    key_mode: 'pair' (result id from both row ids — default joins),
    'left' (keep left row id — backs ``.ix`` / ``id_from=left``), 'right'.
    """

    #: both sides' arrangements retain every row seen — unbounded over a
    #: never-ending source unless something upstream forgets
    ANALYSIS_STATE_BOUNDED = False

    def analysis_signature(self) -> tuple:
        return (
            self._ljk, self._rjk,
            tuple(self._lcols), tuple(self._rcols),
            self._mode, self._key_mode,
            self._emit_matched, self._react_to_right,
        )

    def __init__(
        self,
        left: Node,
        right: Node,
        left_jk: str,
        right_jk: str,
        left_cols: list[str],
        right_cols: list[str],
        out_names: list[str],
        mode: str = "inner",  # inner | left | right | outer
        key_mode: str = "pair",
        emit_matched: bool = True,
        react_to_right: bool = True,  # False = asof_now: left deltas join the
        # right state as-of-now; later right changes never retract past output
        # (reference asof_now_join, _asof_now_join.py:176)
    ):
        super().__init__([left, right], out_names)
        assert len(out_names) == len(left_cols) + len(right_cols)
        self._ljk, self._rjk = left_jk, right_jk
        self._lcols, self._rcols = left_cols, right_cols
        self._mode = mode
        self._key_mode = key_mode
        self._emit_matched = emit_matched
        self._react_to_right = react_to_right
        # asof_now (react_to_right=False) OUTER modes keep the row-at-a-time
        # path: their pads deliberately do NOT react to later right changes,
        # which the columnar pad bookkeeping is built to do. Inner joins are
        # always columnar (the react_to_right guard in the matched algebra
        # covers asof_now, and inner has no pads).
        self._columnar = react_to_right or mode == "inner"
        if self._columnar:
            self._cleft = _SortedSide(len(left_cols))
            self._cright = _SortedSide(len(right_cols))
        else:
            self._left = MultiIndex(left_cols)
            self._right = MultiIndex(right_cols)
        # row_key -> current pad multiplicity (row path only)
        self._lpad: dict[int, int] = {}
        self._rpad: dict[int, int] = {}
        # id-keyed joins (key_mode left/right) promise one output row per
        # id-side row ("result.id == left.id"). A second match would
        # silently duplicate a row key inside a table labeled with the id
        # side's universe (ADVICE r4), so the output is projected per id:
        # multiplicity 1 passes through; >1 becomes ONE row with Error in
        # the other side's columns plus a "duplicate key" log entry — the
        # reference's behavior (test_errors.py:483 left_join_preserving_id).
        # out_key -> {row_sig: [row_tuple, count]} of emitted rows.
        self._idstate: dict[int, dict[int, list]] = {}
        # pre-join projection/filter fusion (engine/fusion.py): the
        # adjacent per-side Rowwise (renames + row id + join-key mixing)
        # absorbed into this node, with the join keys reused from the
        # row keys bit-for-bit when they mix exactly the columns the
        # source derived its keys from
        self._preambles: list[dict[str, Any] | None] = [None, None]
        self._preamble_labels: list[str | None] = [None, None]
        self._jk_reuse_cols: list[tuple | None] = [None, None]

    def absorb_preamble(self, port: int, rowwise: "Rowwise") -> bool:
        """Fuse a side's Rowwise preamble into the join (called by
        engine/fusion.fuse_graph; the caller rewires inputs)."""
        if self._preambles[port] is not None:
            return False
        self._preambles[port] = dict(rowwise._exprs)
        self._preamble_labels[port] = f"Rowwise#{rowwise.node_id}"
        jk_col = self._ljk if port == 0 else self._rjk
        jk_fn = self._preambles[port].get(jk_col)
        key_fns = getattr(jk_fn, "_pw_key_fns", None)
        if key_fns:
            cols = []
            for f in key_fns:
                ref = getattr(f, "_pw_colref", None)
                if ref is None:
                    break
                cols.append(ref)
            else:
                self._jk_reuse_cols[port] = tuple(cols)
        return True

    def _apply_preamble(self, side: int, d: "Delta | None") -> "Delta | None":
        if d is None or not len(d):
            return d
        import time as _wall

        stats = getattr(self, "_engine_stats", None)
        timed = stats is not None and stats.detailed
        t0 = _wall.perf_counter_ns() if timed else 0
        preamble = self._preambles[side]
        jk_col = self._ljk if side == 0 else self._rjk
        reuse = (
            self._jk_reuse_cols[side] is not None
            and d.keys_content_cols == self._jk_reuse_cols[side]
            and not errors_seen()
        )
        n = len(d)
        data = {
            name: (d.keys if reuse and name == jk_col
                   else _as_column(fn(d.data, d.keys), n))
            for name, fn in preamble.items()
        }
        if reuse:
            from .fusion import FUSION_STATS

            FUSION_STATS["key_reuse_total"] += 1
        out = d.replace_data(data)
        if timed:
            stats.note_op_time(
                self._preamble_labels[side], _wall.perf_counter_ns() - t0
            )
        return out

    STATE_FIELDS = (
        "_cleft", "_cright", "_left", "_right", "_lpad", "_rpad", "_idstate"
    )

    def snapshot_state(self) -> dict:
        # deferred (fusion-lane) arrangement batches must be arranged
        # before any state consumer walks _runs directly — pickling
        # flushes via __getstate__, but split_state/unit tests may read
        # the live object
        for side in (getattr(self, "_cleft", None), getattr(self, "_cright", None)):
            if side is not None:
                side._flush_pending()
        return super().snapshot_state()

    # -- streaming snapshots (persistence/snapshots.py write_parts) -------
    #
    # A sorted-merge arrangement under the memory budget holds most of
    # its payload in spilled runs; pickling it (``__getstate__``)
    # materializes every run resident. The parts protocol instead streams
    # the resident skeleton first and each spilled run's payload one at a
    # time — commit-time peak RSS stays bounded by one run + one chunk.

    def snapshot_state_parts(self):
        base: dict = {}
        sides: dict[str, _SortedSide] = {}
        for f in self.STATE_FIELDS:
            if not hasattr(self, f):
                continue
            v = getattr(self, f)
            if (
                f in ("_cleft", "_cright")
                and isinstance(v, _SortedSide)
                and v._spilled
            ):
                sides[f] = v
            else:
                base[f] = v
        yield {
            "base": base,
            "sides": {f: len(s._spilled) for f, s in sides.items()},
        }
        for f in sorted(sides):
            side = sides[f]
            yield side._snapshot_skeleton()
            store = side._budget.spill_store()
            for rec in side._spilled:
                # (sorted jks, count prefix-sum, payload) — ONE spilled
                # run resident at a time
                yield (rec[0], rec[1], store.get_blob(rec[2]))

    @classmethod
    def state_from_parts(cls, parts) -> dict:
        head = next(parts)
        state = dict(head["base"])
        for f in sorted(head["sides"]):
            skel = next(parts)
            runs = []
            for _ in range(head["sides"][f]):
                jks, csum, payload = next(parts)
                keys, cols, counts = payload
                runs.append([jks, keys, cols, counts, csum])
            side = _SortedSide.__new__(_SortedSide)
            skel["_runs"] = runs + list(skel["_runs"])
            side.__setstate__(skel)
            state[f] = side
        return state

    # -- elastic rescale (rescale/resharder.py) ---------------------------
    #
    # Join state routes by JOIN key: arrangements split directly on their
    # jk arrays; pads and the id-uniqueness ledger are keyed by ROW key, so
    # their destination is the shard of the jk their row lives under — a
    # rk→jk map rebuilt from the arrangements decides, falling back to the
    # row key's own shard for entries whose row is no longer arranged.

    @classmethod
    def _row_jk_map(cls, state: dict) -> dict[int, int]:
        out: dict[int, int] = {}
        for f in ("_cleft", "_cright"):
            side = state.get(f)
            if side is not None:
                for run in side._runs:
                    for jk, rk in zip(run[0].tolist(), run[1].tolist()):
                        out.setdefault(int(rk), int(jk))
        for f in ("_left", "_right"):
            idx = state.get(f)
            if idx is not None:
                for jk, grp in idx._index.items():
                    for rk in grp:
                        out.setdefault(int(rk), int(jk))
        return out

    @staticmethod
    def _split_rk_dict(d: dict, rk2jk: dict[int, int], key_mask) -> dict:
        if not d:
            return {}
        route = np.fromiter(
            (rk2jk.get(int(k), int(k)) & 0xFFFFFFFFFFFFFFFF for k in d),
            dtype=np.uint64, count=len(d),
        )
        keep = key_mask(route)
        # the reference's comprehension reads an unbound ``v`` here (a NameError on any
        # non-empty pad ledger); the port keeps each entry's own value
        return {k: d[k] for k, m in zip(d, keep.tolist()) if m}

    #: memoization slot for the rk→jk map: the resharder calls split_state
    #: once per destination on the SAME piece, and the map depends only on
    #: the piece — rebuilding the O(rows) scan per destination would make
    #: a rescale O(M × rows) per source worker
    _RK2JK_CACHE = "__rescale_rk2jk__"

    @classmethod
    def split_state(cls, state: dict, key_mask) -> dict:
        out: dict = {}
        rk2jk = state.get(cls._RK2JK_CACHE)
        if rk2jk is None:
            rk2jk = cls._row_jk_map(state)
            state[cls._RK2JK_CACHE] = rk2jk
        for f, v in state.items():
            if f == cls._RK2JK_CACHE:
                continue
            if f in ("_cleft", "_cright"):
                side = _SortedSide(v._n_cols)
                for run in v._runs:
                    keep = key_mask(run[0])
                    if keep.any():
                        side._runs.append(_SortedSide._make_run(
                            run[0][keep], run[1][keep],
                            [np.asarray(c)[keep] for c in run[2]],
                            run[3][keep],
                        ))
                out[f] = side
            elif f in ("_left", "_right"):
                idx = MultiIndex(v.columns)
                jks = list(v._index)
                if jks:
                    arr = np.fromiter(
                        (int(j) & 0xFFFFFFFFFFFFFFFF for j in jks),
                        dtype=np.uint64, count=len(jks),
                    )
                    keep = key_mask(arr)
                    idx._index = {
                        j: v._index[j] for j, m in zip(jks, keep.tolist()) if m
                    }
                out[f] = idx
            else:  # _lpad / _rpad / _idstate — row-keyed ledgers
                out[f] = cls._split_rk_dict(v, rk2jk, key_mask)
        return out

    @classmethod
    def merge_states(cls, states: list[dict]) -> dict:
        out: dict = {}
        for f in states[0]:
            vals = [s[f] for s in states]
            if f in ("_cleft", "_cright"):
                side = _SortedSide(vals[0]._n_cols)
                for v in vals:
                    side._runs.extend(v._runs)
                if len(side._runs) > _SortedSide.MAX_RUNS:
                    side._compact()
                out[f] = side
            elif f in ("_left", "_right"):
                idx = MultiIndex(vals[0].columns)
                for v in vals:
                    for jk, grp in v._index.items():
                        if jk in idx._index:
                            raise ValueError(
                                f"Join.{f}: join key {jk:#x} present in two "
                                "source workers' state"
                            )
                        idx._index[jk] = grp
                out[f] = idx
            else:
                merged: dict = {}
                for v in vals:
                    merged.update(v)
                out[f] = merged
        return out

    def exchange_specs(self):
        # both sides route by join key -> matching rows co-locate
        # (ShardPolicy::LastKeyColumn analog)
        return [
            ("key",) if self._ljk is None else ("column", self._ljk),
            ("key",) if self._rjk is None else ("column", self._rjk),
        ]

    def _out_key(self, lk: int, rk: int) -> int:
        if self._key_mode == "left":
            return lk
        if self._key_mode == "right":
            return rk
        return K.derive_pair_scalar(lk, rk)

    def _emit(self, out, lk, rk, lrow, rrow, diff):
        out[0].append(self._out_key(lk, rk))
        out[1].append(tuple(lrow) + tuple(rrow))
        out[2].append(diff)

    def _pad_left(self, out, lk, lrow, diff):
        key = K.derive_scalar(lk, _PAD_SALT) if self._key_mode == "pair" else lk
        out[0].append(key)
        out[1].append(tuple(lrow) + (None,) * len(self._rcols))
        out[2].append(diff)

    def _pad_right(self, out, rk, rrow, diff):
        key = K.derive_scalar(rk, _PAD_SALT ^ 0xF) if self._key_mode == "pair" else rk
        out[0].append(key)
        out[1].append((None,) * len(self._lcols) + tuple(rrow))
        out[2].append(diff)

    @staticmethod
    def _drop_error_keys(delta: Delta | None, jk_col: str | None):
        """Rows whose join key evaluated to an Error carry the reserved
        ``K.ERROR_KEY`` sentinel (graph_runner jk_fn) — drop them with a
        log entry before they reach join state, so Error keys match
        nothing (Error compares equal to nothing, value.rs:226).

        The uint64 sentinel compare runs UNCONDITIONALLY: the Error
        objects that produced the sentinel were transient (freed when
        jk_fn returned), so the live-error gate may already be off by the
        time the Join node runs — only the sentinel remains. The
        object-column scan stays gated on ``errors_seen()``, which is safe
        there because any Error it could find is alive inside this very
        delta and therefore counted."""
        if delta is None or jk_col is None or not len(delta):
            return delta, None
        col = np.asarray(delta.data[jk_col])
        if col.dtype == object:
            # raw pointer key columns (optional ix / having) may hold
            # None or Error objects — drop only the Errors here; None
            # keeps its pre-existing downstream handling
            if not errors_seen():
                return delta, None
            m = np.fromiter(
                (type(v) is EngineError for v in col), bool, len(col)
            )
        else:
            m = col.astype(np.uint64, copy=False) == K.ERROR_KEY
        if not m.any():
            return delta, None
        # reference wording, one entry per skipped ADDITION
        # (test_errors.py:203)
        for _ in range(int(m[delta.diffs > 0].sum())):
            ERROR_LOG.record(
                "Error value encountered in join condition, skipping the row",
                "join",
            )
        return delta.take(np.flatnonzero(~m)), delta.take(np.flatnonzero(m))

    def _error_key_pads(self, side: int, err: Delta) -> Delta:
        """Pad rows for error-keyed inputs on a padded side: the row keeps
        its own values, the other side is all-None (reference left join:
        the error row still shows, unmatched — test_errors.py:216). These
        pads are permanent (an Error key matches nothing, ever), so their
        multiplicity simply follows the row's diffs — no transition
        bookkeeping."""
        if side == 0:
            keys = (
                K.derive(err.keys, _PAD_SALT)
                if self._key_mode == "pair" else err.keys
            )
            cols = [np.asarray(err.data[c]) for c in self._lcols]
            none_col = np.empty(len(err), dtype=object)
            none_col[:] = None
            ordered = cols + [none_col] * len(self._rcols)
        else:
            keys = (
                K.derive(err.keys, _PAD_SALT ^ 0xF)
                if self._key_mode == "pair" else err.keys
            )
            cols = [np.asarray(err.data[c]) for c in self._rcols]
            none_col = np.empty(len(err), dtype=object)
            none_col[:] = None
            ordered = [none_col] * len(self._lcols) + cols
        return Delta(
            keys=keys,
            data=dict(zip(self.column_names, ordered)),
            diffs=err.diffs,
        )

    #: per-side sentinels for a None join key: a None key matches NOTHING
    #: (SQL/reference semantics) — distinct sentinels per side prevent two
    #: None keys from spuriously matching each other, while left/outer pad
    #: emission still fires (the sentinel simply never finds a partner)
    _NONE_JK = (
        np.uint64(0xE707_0E0E_DEAD_0002),
        np.uint64(0xE707_0E0E_DEAD_0003),
    )

    @classmethod
    def _normalize_none_keys(
        cls, delta: Delta | None, jk_col: str | None, side: int
    ):
        """Object-dtype join-key columns (optional pointers from
        ``ix(optional=True)`` / sort prev-next chains) may hold None —
        replace with the side sentinel and densify to uint64 so the join
        paths never cast None."""
        if delta is None or jk_col is None or not len(delta):
            return delta
        col = np.asarray(delta.data[jk_col])
        if col.dtype != object:
            return delta
        out = np.empty(len(col), dtype=np.uint64)
        sent = cls._NONE_JK[side]
        for i, v in enumerate(col):
            out[i] = sent if v is None else np.uint64(v)
        return delta.replace_data({**delta.data, jk_col: out})

    @staticmethod
    def _rows_of(delta: Delta | None, jk_col: str | None, cols: list[str]):
        """Yield (jk, row_key, row_values, diff) for a delta. jk_col=None
        means join on the row key itself (restrict/ix/zip-by-universe)."""
        if delta is None or not len(delta):
            return []
        jks = delta.keys if jk_col is None else np.asarray(delta.data[jk_col], dtype=np.uint64)
        arrs = [delta.data[c] for c in cols]
        return [
            (int(jks[i]), int(delta.keys[i]), tuple(a[i] for a in arrs), int(delta.diffs[i]))
            for i in range(len(delta))
        ]

    def _unpack(self, delta: Delta | None, jk_col: str | None, cols: list[str]):
        if delta is None or not len(delta):
            return None
        jks = (
            delta.keys
            if jk_col is None
            else np.asarray(delta.data[jk_col], dtype=np.uint64)
        )
        return jks, delta.keys, [delta.data[c] for c in cols], delta.diffs

    def _out_keys_vec(self, lk: np.ndarray, rk: np.ndarray) -> np.ndarray:
        if self._key_mode == "left":
            return lk
        if self._key_mode == "right":
            return rk
        return K.derive_pair(lk, rk)

    def _process_columnar(self, ins: list[Delta | None]) -> Delta | None:
        left = self._unpack(ins[0], self._ljk, self._lcols)
        right = self._unpack(ins[1], self._rjk, self._rcols)
        parts: list[Delta] = []
        # pad bookkeeping is fully recomputable from the arrangements:
        # snapshot each padded side's current pads at the affected jks
        # BEFORE the deltas apply; after applying, emit (new pads) −
        # (old pads) — the final consolidation nets every unchanged pad
        # away, so only genuine 0↔nonzero match transitions surface
        affected_l = affected_r = None
        if self._mode in ("left", "outer"):
            affected_l = self._affected_jks(left, right)
            if affected_l is not None:
                self._emit_pads(
                    parts, affected_l, self._cleft, self._cright, "left", -1
                )
        if self._mode in ("right", "outer"):
            affected_r = self._affected_jks(right, left)
            if affected_r is not None:
                self._emit_pads(
                    parts, affected_r, self._cright, self._cleft, "right", -1
                )

        def emit(lk, rk, lcols, rcols, diffs):
            data = {}
            for name, arr in zip(self.column_names, list(lcols) + list(rcols)):
                data[name] = np.asarray(arr)
            parts.append(
                Delta(keys=self._out_keys_vec(lk, rk), data=data, diffs=diffs)
            )

        # L_old ⋈ dR
        if self._emit_matched and self._react_to_right and right is not None:
            r_jks, r_keys, r_cols, r_diffs = right
            for qi, lkeys, lcols, lcounts in self._cleft.probe(r_jks):
                emit(
                    lkeys, r_keys[qi], lcols,
                    [np.asarray(c)[qi] for c in r_cols],
                    lcounts * r_diffs[qi],
                )
        # apply dR
        if right is not None:
            self._cright.apply(*right)
        # dL ⋈ R_new
        if self._emit_matched and left is not None:
            l_jks, l_keys, l_cols, l_diffs = left
            for qi, rkeys, rcols, rcounts in self._cright.probe(l_jks):
                emit(
                    l_keys[qi], rkeys,
                    [np.asarray(c)[qi] for c in l_cols], rcols,
                    l_diffs[qi] * rcounts,
                )
        # apply dL
        if left is not None:
            self._cleft.apply(*left)
        # post-apply pad snapshots: (new pads) + the pre-apply (− old pads)
        # already in `parts` net to exactly the pad transitions
        if affected_l is not None:
            self._emit_pads(
                parts, affected_l, self._cleft, self._cright, "left", 1
            )
        if affected_r is not None:
            self._emit_pads(
                parts, affected_r, self._cright, self._cleft, "right", 1
            )
        if not parts:
            return None
        # engine-internal edge: duplicate all-insert (key,row) entries are
        # the same multiset as merged ones — downstream operators fold
        # diffs, so an all-positive batch skips the signature sort
        return concat_deltas(parts, self.column_names).consolidated(
            multiset_ok=True
        )

    @staticmethod
    def _affected_jks(this, other) -> np.ndarray | None:
        """jks whose pads may change this tick: any jk touched by either
        side's delta."""
        pieces = [t[0] for t in (this, other) if t is not None]
        if not pieces:
            return None
        jks = np.unique(np.concatenate(pieces))
        return jks if len(jks) else None

    def _emit_pads(self, parts, jks: np.ndarray, this_arr: _SortedSide,
                   other_arr: _SortedSide, side: str, sign: int) -> None:
        """Append ``sign`` × (current pads of ``this`` side at ``jks``):
        rows at jks with zero other-side multiplicity, null-padded.
        Everything is arrangement probes — no per-row python, no pad
        ledger state (the pre/post pair plus consolidation replaces it)."""
        tot = other_arr.totals(jks)
        zjks = jks[tot == 0]
        if not len(zjks):
            return
        n_other = len(self._rcols) if side == "left" else len(self._lcols)
        for _qi, rks, cols, counts in this_arr.probe(zjks):
            src = np.asarray(rks, dtype=np.uint64)
            if self._key_mode == "pair":
                salt = _PAD_SALT if side == "left" else (_PAD_SALT ^ 0xF)
                keys = K.derive(src, salt)
            else:
                keys = src
            none_col = np.empty(len(src), dtype=object)
            none_col[:] = None
            this_cols = [np.asarray(c) for c in cols]
            pad_cols = [none_col] * n_other
            ordered = (
                this_cols + pad_cols if side == "left" else pad_cols + this_cols
            )
            parts.append(Delta(
                keys=keys,
                data=dict(zip(self.column_names, ordered)),
                diffs=np.asarray(counts, dtype=np.int64) * sign,
            ))

    def process(self, time: int, ins: list[Delta | None]) -> Delta | None:
        if self._preambles[0] is not None or self._preambles[1] is not None:
            ins = [
                self._apply_preamble(side, d) if self._preambles[side] else d
                for side, d in enumerate(ins)
            ]
        clean: list[Delta | None] = []
        pad_parts: list[Delta] = []
        padded_sides = {
            "left": (0,), "right": (1,), "outer": (0, 1), "inner": (),
        }[self._mode]
        for side, (d, jk) in enumerate(zip(ins, (self._ljk, self._rjk))):
            kept, err = self._drop_error_keys(d, jk)
            clean.append(self._normalize_none_keys(kept, jk, side))
            if err is not None and len(err) and side in padded_sides:
                pad_parts.append(self._error_key_pads(side, err))
        ins = clean
        if self._columnar:
            out = self._process_columnar(ins)
            if pad_parts:
                parts = ([out] if out is not None and len(out) else []) + pad_parts
                out = concat_deltas(parts, self.column_names).consolidated(
                    multiset_ok=True
                )
            return self._check_unique_ids(out)
        dl = self._rows_of(ins[0], self._ljk, self._lcols)
        dr = self._rows_of(ins[1], self._rjk, self._rcols)
        out: tuple[list, list, list] = ([], [], [])

        # L_old ⋈ dR
        if self._emit_matched and self._react_to_right:
            for jk, rk, rrow, diff in dr:
                for lrk, lrow, lcount in self._left.iter_group_rows(jk):
                    self._emit(out, lrk, rk, lrow, rrow, lcount * diff)
        # apply dR
        for jk, rk, rrow, diff in dr:
            self._right.apply_one(jk, rk, rrow, diff)
        # dL ⋈ R_new
        if self._emit_matched:
            for jk, lk, lrow, diff in dl:
                for rrk, rrow, rcount in self._right.iter_group_rows(jk):
                    self._emit(out, lk, rrk, lrow, rrow, diff * rcount)
        # apply dL
        for jk, lk, lrow, diff in dl:
            self._left.apply_one(jk, lk, lrow, diff)

        # outer padding: recompute pad multiplicity for affected rows
        if self._mode in ("left", "outer"):
            self._repad(
                out, dl, dr, self._left, self._right, self._lpad, self._pad_left
            )
        if self._mode in ("right", "outer"):
            self._repad(
                out, dr, dl, self._right, self._left, self._rpad, self._pad_right
            )
        if not out[0] and not pad_parts:
            return None
        parts = (
            [Delta(
                keys=np.array(out[0], dtype=np.uint64),
                data=rows_to_columns(out[1], self.column_names),
                diffs=np.array(out[2], dtype=np.int64),
            )] if out[0] else []
        ) + pad_parts
        return self._check_unique_ids(
            concat_deltas(parts, self.column_names).consolidated()
        )

    #: sentinel sig for the Error-degraded duplicate row projection
    _DUP_SIG = object()

    def _project_id_key(self, k: int) -> list[tuple[Any, tuple, int]]:
        """Current OUTPUT rows for id key ``k`` as ``(sig, row, count)``:
        one real row at multiplicity 1, or one Error-degraded row
        (sig = _DUP_SIG) when several matches share the id (pads count
        too — pad and match are exclusive). Comparisons between old/new
        projections go through sigs only, so array-valued cells never hit
        ambiguous ``==``."""
        ent = self._idstate.get(k)
        if not ent:
            return []
        total = sum(e[1] for e in ent.values())
        if total <= 0:
            return []
        if total == 1 and len(ent) == 1:
            sig, (row, cnt) = next(iter(ent.items()))
            return [(sig, tuple(row), cnt)]
        base = next(iter(ent.values()))[0]
        n_l = len(self._lcols)
        if self._key_mode == "left":
            err_row = tuple(base[:n_l]) + tuple(
                EngineError.silent("duplicate key") for _ in self._rcols
            )
        else:
            err_row = tuple(
                EngineError.silent("duplicate key") for _ in self._lcols
            ) + tuple(base[n_l:])
        return [(self._DUP_SIG, err_row, 1)]

    def _check_unique_ids(self, delta: Delta | None) -> Delta | None:
        """key_mode left/right: every output key is an id-side row id.
        Multiplicity ≤ 1 passes through untouched; an id matched by
        several rows degrades to ONE row with Error values in the other
        side's columns and a "duplicate key" log entry, recovering when
        matches drop back to one (reference id-preserving join contract,
        test_errors.py:483)."""
        if self._key_mode == "pair" or delta is None or not len(delta):
            return delta
        n = len(delta)
        sigs = K.mix_columns(
            list(delta.data.values()), n, register=False
        ).tolist()
        keys_l = delta.keys.tolist()
        diffs_l = delta.diffs.tolist()
        cols = [np.asarray(delta.data[c]) for c in self.column_names]
        state = self._idstate
        if (
            (delta.diffs == 1).all()
            and len(set(keys_l)) == n
            and state.keys().isdisjoint(keys_l)
        ):
            # inserts of ids new to the join, each once (a fresh run's or an
            # ``iterate`` round's whole input): every id's projection is its
            # one row, so the delta passes through and each row is recorded
            # as the loop below would record it
            state.update(zip(keys_l, (
                {sg: [row, 1]} for sg, row in zip(sigs, zip(*cols))
            )))
            return delta
        old_proj = {k: self._project_id_key(k) for k in set(keys_l)}
        for i, (k, sg, df) in enumerate(zip(keys_l, sigs, diffs_l)):
            ent = state.setdefault(k, {})
            cur = ent.get(sg)
            if cur is None:
                ent[sg] = [tuple(c[i] for c in cols), df]
            else:
                cur[1] += df
                if cur[1] == 0:
                    del ent[sg]
            if not ent:
                state.pop(k, None)
        out_keys: list[int] = []
        out_rows: list[tuple] = []
        out_diffs: list[int] = []
        for k, old in old_proj.items():
            new = self._project_id_key(k)
            if [(s, c) for s, _, c in new] == [(s, c) for s, _, c in old]:
                continue
            old_dup = any(s is self._DUP_SIG for s, _, _ in old)
            new_dup = any(s is self._DUP_SIG for s, _, _ in new)
            if new_dup and not old_dup:
                ERROR_LOG.record(f"duplicate key: {K.fmt_key(k)}", "join")
            for _, row, cnt in old:
                out_keys.append(k)
                out_rows.append(row)
                out_diffs.append(-cnt)
            for _, row, cnt in new:
                out_keys.append(k)
                out_rows.append(row)
                out_diffs.append(cnt)
        if not out_keys:
            return None
        return Delta(
            keys=np.array(out_keys, dtype=np.uint64),
            data=rows_to_columns(out_rows, self.column_names),
            diffs=np.array(out_diffs, dtype=np.int64),
        ).consolidated()

    def _repad(self, out, d_this, d_other, this_idx: MultiIndex, other_idx: MultiIndex, pad_state: dict[int, int], pad_fn) -> None:
        affected_jks = {jk for jk, _, _, _ in d_this} | {jk for jk, _, _, _ in d_other}
        for jk in affected_jks:
            other_count = other_idx.total_count(jk)
            for rk, row, count in this_idx.iter_group_rows(jk):
                want = count if other_count == 0 else 0
                have = pad_state.get(rk, 0)
                if want != have:
                    pad_fn(out, rk, row, want - have)
                    if want == 0:
                        pad_state.pop(rk, None)
                    else:
                        pad_state[rk] = want
        # rows fully retracted from this side: drop any pad they had
        for jk, rk, row, _ in d_this:
            if rk not in this_idx.group(jk) and pad_state.get(rk, 0) != 0:
                pad_fn(out, rk, row, -pad_state.pop(rk))


class GroupedRecompute(Node):
    """Generic stateful operator: group rows of 1–2 inputs by a key column,
    recompute affected groups with a host function on every change, emit the
    diff against the group's previous output.

    Backs the order-sensitive operators the reference implements as custom
    timely operators (``prev_next.rs`` sort/prev-next pointers, asof joins
    ``_asof_join.py:479``, session windows ``_window.py``): not maximally
    incremental within a group, but retraction-correct and batched per group.

    compute_fn(group_key, rows_a, rows_b, time) -> list[(out_key, row_tuple)]
    where rows_x = {row_key: row_tuple}.
    """

    def __init__(
        self,
        inputs: list[Node],
        group_cols: list[str | None],  # per input; None = whole-input group
        out_columns: list[str],
        compute_fn,
    ):
        super().__init__(inputs, out_columns)
        self._group_cols = group_cols
        self._fn = compute_fn
        self._state: list[dict[int, dict[int, list[list]]]] = [
            {} for _ in inputs
        ]  # per input: group_key -> {row_key: [[row, count], ...]}
        self._prev_out: dict[int, dict[int, tuple]] = {}
        self._dangling: dict[int, DanglingPointerError] = {}

    STATE_FIELDS = ("_state", "_prev_out")
    _ctx = None  # the sharded run's context (``on_shard``); None on one worker

    def on_shard(self, ctx) -> None:
        self._ctx = ctx

    def exchange_specs(self):
        return [
            ("gather",) if col is None else ("column", col)
            for col in self._group_cols
        ]

    def _gkeys(self, port: int, d: Delta) -> np.ndarray:
        col = self._group_cols[port]
        if col is None:
            return np.zeros(len(d), dtype=np.uint64)
        return np.asarray(d.data[col], dtype=np.uint64)

    def process(self, time: int, ins: list[Delta | None]) -> Delta | None:
        affected: dict[int, None] = {}
        for port, d in enumerate(ins):
            if d is None or not len(d):
                continue
            gkeys = self._gkeys(port, d)
            state = self._state[port]
            for gk, (rk, row, diff) in zip(gkeys.tolist(), d.iter_rows()):
                grp = state.setdefault(gk, {})
                entries = grp.get(rk)
                if entries is None:
                    grp[rk] = [[row, diff]]
                else:
                    # net by row VALUE — a tick may carry the retract of the
                    # old row and the insert of the new one in any order
                    for e in entries:
                        if _rows_equal(e[0], row):
                            e[1] += diff
                            if e[1] == 0:
                                entries.remove(e)
                            break
                    else:
                        entries.append([row, diff])
                    if not entries:
                        del grp[rk]
                if not grp:
                    state.pop(gk, None)
                affected[gk] = None
        if not affected:
            return None
        out_keys: list[int] = []
        out_rows: list[tuple] = []
        out_diffs: list[int] = []
        for gk in affected:
            rows_per_input = []
            for p in range(len(self.inputs)):
                rows = {}
                for rk, entries in self._state[p].get(gk, {}).items():
                    positive = [e for e in entries if e[1] > 0]
                    if len(positive) > 1:
                        raise ValueError(
                            f"row key {rk} holds {len(positive)} live rows in a group"
                        )
                    if positive:
                        rows[rk] = positive[0][0]
                rows_per_input.append(rows)
            if any(rows_per_input):
                try:
                    new_out = dict(self._fn(gk, *rows_per_input, time))
                except DanglingPointerError as e:
                    if not holds_dangling(self._ctx):
                        raise
                    self._dangling[gk] = e  # the group keeps its output until more input
                    continue
            else:
                new_out = {}
            self._dangling.pop(gk, None)
            old_out = self._prev_out.get(gk, {})
            for ok, row in old_out.items():
                if not _rows_equal(row, new_out.get(ok)):
                    out_keys.append(ok)
                    out_rows.append(row)
                    out_diffs.append(-1)
            for ok, row in new_out.items():
                if not _rows_equal(row, old_out.get(ok)):
                    out_keys.append(ok)
                    out_rows.append(row)
                    out_diffs.append(1)
            if new_out:
                self._prev_out[gk] = new_out
            else:
                self._prev_out.pop(gk, None)
        if not out_keys:
            return None
        return Delta(
            keys=np.array(out_keys, dtype=np.uint64),
            data=rows_to_columns(out_rows, self.column_names),
            diffs=np.array(out_diffs, dtype=np.int64),
        )

    def on_end(self) -> Delta | None:
        for e in self._dangling.values():
            raise e
        return None


class UpdateRows(Node):
    """update_rows (table.py:1524): other's rows override self's by key."""

    STATE_FIELDS = ("_self_state", "_other_state")

    def __init__(self, left: Node, right: Node):
        super().__init__([left, right], left.column_names)
        self._self_state = RowState(left.column_names)
        self._other_state = RowState(left.column_names)

    def exchange_specs(self):
        return [("key",), ("key",)]

    def process(self, time: int, ins: list[Delta | None]) -> Delta | None:
        d_self = ins[0].select_columns(self.column_names) if ins[0] is not None else None
        d_other = ins[1].select_columns(self.column_names) if ins[1] is not None else None
        affected: dict[int, None] = {}
        for d in (d_self, d_other):
            if d is not None:
                for k in d.keys:
                    affected[int(k)] = None
        if not affected:
            return None
        old = {k: self._resolve(k) for k in affected}
        if d_self is not None:
            self._self_state.apply(d_self)
        if d_other is not None:
            self._other_state.apply(d_other)
        return _emit_resolved_diffs(self, affected, old)

    def _resolve(self, key: int) -> tuple | None:
        row = self._other_state.get(key)
        if row is not None:
            return row
        return self._self_state.get(key)


class UpdateCells(Node):
    """update_cells (table.py:1439): override a subset of columns for keys
    present in `other`; both tables share the key universe."""

    STATE_FIELDS = ("_self_state", "_other_state")

    def __init__(self, left: Node, right: Node, override_cols: list[str]):
        super().__init__([left, right], left.column_names)
        self._override = override_cols
        self._self_state = RowState(left.column_names)
        self._other_state = RowState(override_cols)

    def exchange_specs(self):
        return [("key",), ("key",)]

    def process(self, time: int, ins: list[Delta | None]) -> Delta | None:
        d_self = ins[0]
        d_other = ins[1].select_columns(self._override) if ins[1] is not None else None
        affected: dict[int, None] = {}
        for d in (d_self, d_other):
            if d is not None:
                for k in d.keys:
                    affected[int(k)] = None
        if not affected:
            return None
        old = {k: self._resolve(k) for k in affected}
        if d_self is not None:
            self._self_state.apply(d_self)
        if d_other is not None:
            self._other_state.apply(d_other)
        return _emit_resolved_diffs(self, affected, old)

    def _resolve(self, key: int) -> tuple | None:
        base = self._self_state.get(key)
        if base is None:
            return None
        over = self._other_state.get(key)
        if over is None:
            return base
        row = list(base)
        for j, c in enumerate(self._override):
            row[self.column_names.index(c)] = over[j]
        return tuple(row)


def _emit_resolved_diffs(node: Node, affected: dict[int, None], old: dict[int, tuple | None]) -> Delta | None:
    keys_out: list[int] = []
    rows_out: list[tuple] = []
    diffs_out: list[int] = []
    for k in affected:
        new = node._resolve(k)
        if _rows_equal(old[k], new):
            continue
        if old[k] is not None:
            keys_out.append(k)
            rows_out.append(old[k])
            diffs_out.append(-1)
        if new is not None:
            keys_out.append(k)
            rows_out.append(new)
            diffs_out.append(1)
    if not keys_out:
        return None
    return Delta(
        keys=np.array(keys_out, dtype=np.uint64),
        data=rows_to_columns(rows_out, node.column_names),
        diffs=np.array(diffs_out, dtype=np.int64),
    )


class Flatten(Node):
    """flatten (table.py:2089): explode an iterable column into rows with
    derived keys mix(parent_key, position). Stateless — diffs propagate."""

    def __init__(self, inp: Node, flatten_col: str):
        super().__init__([inp], inp.column_names)
        self._col = flatten_col

    def process(self, time: int, ins: list[Delta | None]) -> Delta | None:
        d = ins[0]
        if d is None or not len(d):
            return None
        src: list[int] = []  # the input row of each output row
        positions: list[int] = []
        items_out: list = []
        names = self.column_names
        flat = d.data[self._col]
        for i in range(len(d)):
            value = flat[i]
            items = None
            if value is not None and not isinstance(value, EngineError):
                try:
                    # listifying (not hasattr __iter__) also catches
                    # wrappers whose __iter__ fails at runtime, e.g. a
                    # scalar pw.Json — Json.__iter__ exists but iter(42)
                    # inside it raises
                    items = list(value)
                except TypeError:
                    items = None
            if items is None:
                # a row whose flatten column holds Error/None/any
                # non-iterable cannot explode; log and skip instead of
                # crashing the run (reference flatten error-row semantics)
                ERROR_LOG.record(
                    "non-iterable value in flatten column; row skipped",
                    "flatten",
                )
                continue
            src.extend([i] * len(items))
            positions.extend(range(len(items)))
            items_out.extend(items)
        if not src:
            return None
        idx = np.array(src, dtype=np.int64)
        data = {}
        for c in names:
            if c == self._col:
                data[c] = column_of_values(items_out)
                continue
            arr = d.data[c]
            if isinstance(arr, np.ndarray) and arr.dtype in _DENSE_KEEP:
                data[c] = arr[idx]  # what column_of_values makes of these cells
            else:
                data[c] = column_of_values([arr[i] for i in src])
        # each child key is derive(parent, pos * 2 + 7), the whole batch in one call
        salts = np.array(positions, dtype=np.uint64) * np.uint64(2) + np.uint64(0x7)
        return Delta(keys=K.derive_each(d.keys[idx], salts), data=data, diffs=d.diffs[idx])


#: column dtypes whose cells ``column_of_values`` turns back into the same dtype
_DENSE_KEEP = (np.dtype(np.int64), np.dtype(np.float64), np.dtype(np.bool_))


def _split_temporal_state(cls, state: dict, key_mask) -> dict:
    """BufferUntil/ForgetAfter rescale split: their stores are keyed by
    THRESHOLD (an event-time value, not a routing key) with row entries
    inside — split the entry lists by each entry's row key, keep the
    per-worker watermark as-is (it replicates; merge takes the max)."""
    out: dict = {}
    for f, store in state.items():
        if f == "_watermark":
            out[f] = store
            continue
        nb: dict = {}
        for thr, entries in store.items():
            if not entries:
                continue
            keys = np.fromiter(
                (int(e[0]) & 0xFFFFFFFFFFFFFFFF for e in entries),
                dtype=np.uint64, count=len(entries),
            )
            keep = key_mask(keys)
            kept = [e for e, m in zip(entries, keep.tolist()) if m]
            if kept:
                nb[thr] = kept
        out[f] = nb
    return out


def _merge_temporal_states(cls, states: list[dict]) -> dict:
    out: dict = {}
    for f in states[0]:
        vals = [s[f] for s in states]
        if f == "_watermark":
            # the MIN of the per-worker watermarks (None = least knowledge
            # wins): every buffered entry satisfies thr > its own worker's
            # watermark, so min preserves the invariant — a max would
            # strand entries below it, which only release on a FURTHER
            # advance (never, on a plateaued stream). Understating the
            # watermark merely delays releases/retractions until the next
            # data-driven advance, which is within the per-shard-view
            # semantics the live operator already has.
            out[f] = None if any(v is None for v in vals) else min(vals)
            continue
        merged: dict = {}
        for v in vals:
            for thr, entries in v.items():
                merged.setdefault(thr, []).extend(entries)
        out[f] = merged
    return out


def _pop_due(store: dict, watermark, strict: bool = False) -> list:
    """Pop all (key, row, diff) entries whose threshold <= watermark
    (``strict``: < watermark). Thresholds may be ints, floats or
    datetimes — any consistently ordered time domain."""
    if strict:
        due = [t for t in store if t < watermark]
    else:
        due = [t for t in store if t <= watermark]
    entries = []
    for t in sorted(due):
        entries.extend(store.pop(t))
    return entries


def _time_column(col) -> np.ndarray:
    """A threshold/event-time column in its natural ordered domain:
    int64 / float64 arrays, or objects (datetimes, Durations) as-is —
    NEVER an int cast that would truncate float event times."""
    a = np.asarray(col)
    if a.dtype.kind in "iu":
        return a.astype(np.int64, copy=False)
    if a.dtype.kind == "f":
        return a.astype(np.float64, copy=False)
    return a


def _watermark_max(col, context: str):
    """Max of an event-time watermark column, skipping values that cannot
    advance a frontier (None / Error) with an error-log entry instead of a
    TypeError that would kill the run. None = nothing comparable."""
    raw = _time_column(col).tolist()
    comparable = [v for v in raw if v is not None and not is_error(v)]
    if len(comparable) != len(raw):
        ERROR_LOG.record(
            f"{len(raw) - len(comparable)} non-comparable watermark "
            "value(s) skipped",
            context,
        )
    return max(comparable) if comparable else None


def _entries_delta(
    entries: list, names: list[str], negate: bool = False
) -> Delta | None:
    if not entries:
        return None
    keys = np.array([e[0] for e in entries], dtype=np.uint64)
    rows = [e[1] for e in entries]
    sign = -1 if negate else 1
    diffs = np.array([sign * e[2] for e in entries], dtype=np.int64)
    return Delta(
        keys=keys, data=rows_to_columns(rows, names), diffs=diffs
    ).consolidated()


class BufferUntil(Node):
    """Temporal buffer (reference ``time_column.rs`` postpone_core/
    TimeColumnBuffer :255,380): hold each row until the EVENT-TIME
    watermark (max value of ``watermark_col`` seen so far — the reference's
    time-column frontier) reaches its threshold column value; release on
    watermark progress / end of stream. Without a ``watermark_col`` the
    engine's logical time drives releases instead. Buffered insert+retract
    pairs cancel before ever being emitted — the mechanism behind
    exactly-once window outputs."""

    STATE_FIELDS = ("_buffer", "_watermark")

    split_state = classmethod(_split_temporal_state)
    merge_states = classmethod(_merge_temporal_states)

    #: the buffer drains as the watermark advances — bounded by lateness,
    #: not by stream length
    ANALYSIS_STATE_BOUNDED = True

    def analysis_signature(self) -> tuple:
        return (self._col, self._wm_col)

    def __init__(self, inp: Node, threshold_col: str, watermark_col: str | None = None):
        super().__init__([inp], inp.column_names)
        self._col = threshold_col
        self._wm_col = watermark_col
        # threshold -> list[(key, row, diff)]
        self._buffer: dict = {}
        self._watermark = None  # None = nothing seen yet

    def process(self, time: int, ins: list[Delta | None]) -> Delta | None:
        d = ins[0]
        if d is None or not len(d):
            return None
        thr = _time_column(d.data[self._col])
        wm_moved = False
        if self._wm_col is not None:
            batch_max = _watermark_max(
                d.data[self._wm_col], "BufferUntil(watermark)"
            )
            if batch_max is not None and (
                self._watermark is None or batch_max > self._watermark
            ):
                self._watermark = batch_max
                wm_moved = True
        if self._watermark is None:
            pass_now = np.zeros(len(d), dtype=bool)
        else:
            wm = self._watermark
            pass_now = np.array([t <= wm for t in thr.tolist()], dtype=bool) \
                if thr.dtype == object else (thr <= wm)
        out_parts = [d.take(np.flatnonzero(pass_now))]
        hold_ix = np.flatnonzero(~pass_now)
        cols = list(d.data.values())
        thr_list = thr.tolist()
        for i in hold_ix:
            self._buffer.setdefault(thr_list[i], []).append(
                (int(d.keys[i]), tuple(c[i] for c in cols), int(d.diffs[i]))
            )
        if self._wm_col is not None and wm_moved:
            # only when the watermark advanced can anything come due
            # (logical-time mode releases in advance_to instead)
            released = _entries_delta(
                _pop_due(self._buffer, self._watermark), self.column_names
            )
            if released is not None:
                out_parts.append(released)
        out_parts = [p for p in out_parts if p is not None and len(p)]
        if not out_parts:
            return None
        return concat_deltas(out_parts, self.column_names)

    def advance_to(self, time: int) -> Delta | None:
        if self._wm_col is not None:
            # event-time mode: logical time does not move the watermark
            # (data does); END flushes via on_end
            return None
        self._watermark = time
        return _entries_delta(
            _pop_due(self._buffer, self._watermark), self.column_names
        )

    def on_end(self) -> Delta | None:
        entries = []
        for t in sorted(self._buffer):
            entries.extend(self._buffer.pop(t))
        return _entries_delta(entries, self.column_names)


class ForgetAfter(Node):
    """Temporal forget/cutoff (reference ``time_column.rs`` TimeColumnForget
    :556 / ignore_late :631): drop rows arriving after their threshold has
    passed; if ``forget_state``, also retract previously-passed rows once the
    watermark crosses their threshold (bounding downstream state — the
    keep_results=False behavior). With a ``watermark_col`` the watermark is
    the max EVENT-TIME value seen (the reference's time-column frontier);
    otherwise the engine's logical time. Lateness is judged against the
    watermark BEFORE the arriving batch — a row never makes itself late."""

    STATE_FIELDS = ("_live", "_watermark")

    split_state = classmethod(_split_temporal_state)
    merge_states = classmethod(_merge_temporal_states)

    #: live-set is bounded by the watermark horizon, not stream length
    ANALYSIS_STATE_BOUNDED = True

    def analysis_forgets(self) -> bool:
        # with forget_state, rows are RETRACTED once the watermark passes
        # them — every stateful consumer downstream sees bounded state
        return self._forget

    def analysis_signature(self) -> tuple:
        return (self._col, self._forget, self._wm_col)

    def __init__(
        self,
        inp: Node,
        threshold_col: str,
        forget_state: bool = False,
        watermark_col: str | None = None,
    ):
        super().__init__([inp], inp.column_names)
        self._col = threshold_col
        self._forget = forget_state
        self._wm_col = watermark_col
        self._watermark = None  # None = nothing seen yet
        # threshold -> list[(key, row, diff)] of rows passed through
        self._live: dict = {}

    def _retract_due(self) -> Delta | None:
        # a row at EXACTLY the watermark is still valid (keep is thr >= wm)
        return _entries_delta(
            _pop_due(self._live, self._watermark, strict=True),
            self.column_names, negate=True,
        )

    def process(self, time: int, ins: list[Delta | None]) -> Delta | None:
        d = ins[0]
        if d is None or not len(d):
            return None
        thr = _time_column(d.data[self._col])
        if self._watermark is None:
            keep = np.ones(len(d), dtype=bool)
        else:
            wm = self._watermark
            keep = np.array([t >= wm for t in thr.tolist()], dtype=bool) \
                if thr.dtype == object else (thr >= wm)
        out = d.take(np.flatnonzero(keep))
        wm_moved = False
        if self._wm_col is not None:
            batch_max = _watermark_max(
                d.data[self._wm_col], "ForgetLate(watermark)"
            )
            if batch_max is not None and (
                self._watermark is None or batch_max > self._watermark
            ):
                self._watermark = batch_max
                wm_moved = True
        if self._forget and len(out):
            cols = list(out.data.values())
            thr_kept = _time_column(out.data[self._col]).tolist()
            for i in range(len(out)):
                self._live.setdefault(thr_kept[i], []).append(
                    (int(out.keys[i]), tuple(c[i] for c in cols), int(out.diffs[i]))
                )
        parts = [out] if len(out) else []
        if self._forget and self._wm_col is not None and wm_moved:
            retracted = self._retract_due()
            if retracted is not None and len(retracted):
                parts.append(retracted)
        if not parts:
            return None
        return concat_deltas(parts, self.column_names)

    def advance_to(self, time: int) -> Delta | None:
        if self._wm_col is not None:
            # event-time mode: watermark moves with data only; windows past
            # their cutoff at stream END stay emitted (keep_results
            # retraction happens only when data pushed the watermark past)
            return None
        self._watermark = time
        if not self._forget:
            return None
        return self._retract_due()


class Deduplicate(Node):
    """deduplicate (stateful/deduplicate.py:9 + StatefulReduce): per instance,
    keep the latest row whose value the acceptor accepts against the
    previously accepted value. Processes insertions in delta order (time
    order across ticks); retractions of non-accepted rows are ignored, and
    retracting the accepted row retracts the output (reference keeps accepted
    state the same way)."""

    STATE_FIELDS = ("_state",)

    #: one accepted-row entry per distinct instance key, kept forever —
    #: unbounded over a never-ending source of fresh instances
    ANALYSIS_STATE_BOUNDED = False

    def analysis_signature(self) -> tuple:
        return (self._value_col, self._instance_col)

    def __init__(self, inp: Node, value_col: str, instance_col: str | None, acceptor):
        super().__init__([inp], inp.column_names)
        self._value_col = value_col
        self._instance_col = instance_col
        self._acceptor = acceptor
        # instance_key -> [accepted_value, row, out_key]
        self._state: dict[int, list] = {}

    def exchange_specs(self):
        if self._instance_col is None:
            return [("gather",)]  # one global instance -> one owner
        return [("mix", [self._instance_col], 0)]

    def process(self, time: int, ins: list[Delta | None]) -> Delta | None:
        d = ins[0]
        if d is None or not len(d):
            return None
        n = len(d)
        vals = d.data[self._value_col]
        if self._instance_col is not None:
            ikeys = K.mix_columns([np.asarray(d.data[self._instance_col])], n)
        else:
            ikeys = np.zeros(n, dtype=np.uint64)
        names = self.column_names
        arrs = [d.data[c] for c in names]
        inst_col = (
            np.asarray(d.data[self._instance_col])
            if self._instance_col is not None else None
        )
        watch_errors = errors_seen()
        out: tuple[list, list, list] = ([], [], [])
        for i in range(n):
            if watch_errors:
                # reference error contract (test_errors.py:756/:979): an
                # Error in the instance or value column skips the row
                if (
                    inst_col is not None
                    and inst_col.dtype == object
                    and type(inst_col[i]) is EngineError
                ):
                    if d.diffs[i] > 0:
                        ERROR_LOG.record(
                            "Error value encountered in deduplicate "
                            "instance, skipping the row",
                            "deduplicate",
                        )
                    continue
                if type(vals[i]) is EngineError:
                    continue
            ik = int(ikeys[i])
            st = self._state.get(ik)
            new_val = vals[i]
            if d.diffs[i] <= 0:
                # retraction of the currently-accepted row retracts the output
                if st is not None:
                    row = tuple(a[i] for a in arrs)
                    if _rows_equal(st[1], row):
                        out[0].append(st[2])
                        out[1].append(st[1])
                        out[2].append(-1)
                        del self._state[ik]
                continue
            if st is None:
                accept = True  # first value per instance is always accepted
            elif self._acceptor is None:
                accept = True
            else:
                try:
                    accept = self._acceptor(new_val, st[0])
                except Exception as e:
                    # a raising acceptor skips the row with a log entry
                    # (reference test_errors.py:1004)
                    ERROR_LOG.record(
                        f"{type(e).__name__}: {e}", "deduplicate"
                    )
                    continue
            if not accept:
                continue
            row = tuple(a[i] for a in arrs)
            out_key = ik
            if st is not None:
                if _rows_equal(st[1], row):
                    st[0] = new_val
                    continue
                out[0].append(st[2])
                out[1].append(st[1])
                out[2].append(-1)
            out[0].append(out_key)
            out[1].append(row)
            out[2].append(1)
            self._state[ik] = [new_val, row, out_key]
        if not out[0]:
            return None
        return Delta(
            keys=np.array(out[0], dtype=np.uint64),
            data=rows_to_columns(out[1], names),
            diffs=np.array(out[2], dtype=np.int64),
        )


class GradualBroadcast(Node):
    """apx_value column from a moving threshold (gradual_broadcast.rs:65).

    Every key gets a deterministic hash fraction in [0, 1); with threshold
    (lower, value, upper) the key's apx_value is ``upper`` when
    frac < (value-lower)/(upper-lower) else ``lower``. As ``value`` sweeps,
    only keys whose fraction lies in the crossed band flip — the
    incremental-broadcast property the reference built this operator for
    (a naive join against the threshold row would retract EVERY key on
    every threshold change).
    """

    _SALT = 0x6BCA_57A1_0000_0001

    STATE_FIELDS = ("_keys", "_fracs", "_thr")

    RESHARD = "pinned"  # single-owner composite (gathered to worker 0)

    def __init__(self, main: Node, thr: Node, cols: tuple[str, str, str]):
        super().__init__([main, thr], ["apx_value"])
        self._cols = cols  # (lower, value, upper) column names on thr input
        self._keys = np.empty(0, dtype=np.uint64)
        self._fracs = np.empty(0, dtype=np.float64)
        self._thr: tuple | None = None  # (lower, value, upper)

    def exchange_specs(self):
        # single-owner composite (like Iterate): the threshold is one global
        # row and the apx output re-shards downstream anyway
        return [("gather",), ("gather",)]

    @staticmethod
    def _frac_of(keys: np.ndarray) -> np.ndarray:
        return K.derive(keys, GradualBroadcast._SALT).astype(np.float64) / 2.0**64

    @staticmethod
    def _fraction(thr: tuple) -> float:
        lower, value, upper = thr
        if upper <= lower:
            return 1.0
        return min(max((value - lower) / (upper - lower), 0.0), 1.0)

    def _apx(self, fracs: np.ndarray, thr: tuple) -> np.ndarray:
        lower, _, upper = thr
        return np.where(fracs < self._fraction(thr), upper, lower)

    def process(self, time: int, ins: list[Delta | None]) -> Delta | None:
        parts: list[Delta] = []
        new_thr = self._thr
        if ins[1] is not None and len(ins[1]):
            d = ins[1].consolidated()
            for i in range(len(d)):
                row = tuple(
                    float(d.data[c][i]) for c in self._cols
                )
                if d.diffs[i] > 0:
                    new_thr = row
                elif new_thr == row:
                    new_thr = None

        if new_thr != self._thr:
            old, new = self._thr, new_thr
            if len(self._keys):
                if old is not None and new is not None:
                    old_apx = self._apx(self._fracs, old)
                    new_apx = self._apx(self._fracs, new)
                    changed = np.flatnonzero(old_apx != new_apx)
                    if len(changed):
                        parts.append(Delta(
                            keys=np.concatenate([self._keys[changed]] * 2),
                            data={"apx_value": np.concatenate(
                                [old_apx[changed], new_apx[changed]]
                            )},
                            diffs=np.concatenate([
                                np.full(len(changed), -1, np.int64),
                                np.full(len(changed), 1, np.int64),
                            ]),
                        ))
                elif old is None and new is not None:
                    parts.append(Delta(
                        keys=self._keys,
                        data={"apx_value": self._apx(self._fracs, new)},
                    ))
                elif old is not None and new is None:
                    parts.append(Delta(
                        keys=self._keys,
                        data={"apx_value": self._apx(self._fracs, old)},
                        diffs=np.full(len(self._keys), -1, np.int64),
                    ))
            self._thr = new_thr

        if ins[0] is not None and len(ins[0]):
            d = ins[0].consolidated()
            ins_ix = np.flatnonzero(d.diffs > 0)
            del_ix = np.flatnonzero(d.diffs < 0)
            # net out same-tick updates of one key: a (retract old row,
            # insert new row) pair must leave the key tracked with net-zero
            # apx output — deletions only count keys NOT re-inserted this
            # tick, and re-inserted keys are not appended twice
            add_keys = d.keys[ins_ix]
            gone = d.keys[del_ix]
            if len(gone):
                gone = gone[~np.isin(gone, add_keys)]
            if len(add_keys):
                fresh = ~np.isin(add_keys, self._keys)
                add_keys = add_keys[fresh]
            if len(gone):
                mask = np.isin(self._keys, gone)
                if self._thr is not None and mask.any():
                    parts.append(Delta(
                        keys=self._keys[mask],
                        data={"apx_value": self._apx(self._fracs[mask], self._thr)},
                        diffs=np.full(int(mask.sum()), -1, np.int64),
                    ))
                self._keys = self._keys[~mask]
                self._fracs = self._fracs[~mask]
            if len(add_keys):
                add_fracs = self._frac_of(add_keys)
                self._keys = np.concatenate([self._keys, add_keys])
                self._fracs = np.concatenate([self._fracs, add_fracs])
                if self._thr is not None:
                    parts.append(Delta(
                        keys=add_keys,
                        data={"apx_value": self._apx(add_fracs, self._thr)},
                    ))
        if not parts:
            return None
        return concat_deltas(parts, ["apx_value"]).consolidated()


class Capture(Node):
    """Output sink: maintains the consolidated table and the full update
    stream (ConsolidateForOutput, output.rs:27 + capture for debug)."""

    # only the consolidated table is durable: `stream` is the unbounded
    # debug update log — snapshotting it would make every checkpoint
    # O(history), exactly what operator snapshots exist to avoid
    STATE_FIELDS = ("state",)

    RESHARD = "pinned"  # gathered to worker 0; the full table lives there

    def exchange_specs(self):
        return [("gather",)]

    def __init__(self, inp: Node):
        super().__init__([inp], inp.column_names)
        self.state = RowState(inp.column_names)
        self.stream: list[tuple[int, int, tuple, int]] = []  # (time, key, row, diff)

    def process(self, time: int, ins: list[Delta | None]) -> Delta | None:
        d = ins[0]
        if d is None or not len(d):
            return None
        d = d.consolidated()
        self.state.apply(d)
        t = time if time != END_TIME else self.stream[-1][0] + 2 if self.stream else 0
        for key, row, diff in d.iter_rows():
            self.stream.append((t, key, row, diff))
        return None


class Subscribe(Node):
    """io.subscribe: per-row callbacks + per-time and end-of-stream hooks."""

    def __init__(
        self,
        inp: Node,
        on_change: Callable[..., None] | None = None,
        on_time_end: Callable[[int], None] | None = None,
        on_end: Callable[[], None] | None = None,
        on_batch: Callable[[int, Delta], None] | None = None,
        skip_until: int = -1,
    ):
        super().__init__([inp], inp.column_names)
        self._on_change = on_change
        self._on_time_end = on_time_end
        self._had_data_at: int | None = None
        self._on_end_cb = on_end
        #: columnar fast lane: one call per consolidated tick delta (no
        #: per-row dict building) — the batched counterpart of on_change
        self._on_batch = on_batch
        # suppress re-emission of already-persisted times on recovery
        # (reference io.subscribe skip_persisted_batch)
        self._skip_until = skip_until

    def exchange_specs(self):
        # user callbacks fire on one worker only (single-writer sinks give
        # exactly-once output under spawn -n M)
        return [("gather",)]

    def on_shard(self, ctx):
        if ctx.worker_id != 0:
            # gathered rows only ever reach worker 0; without muting, every
            # worker's copy would still fire on_end/on_time_end
            self._on_change = None
            self._on_time_end = None
            self._on_end_cb = None
            self._on_batch = None

    def process(self, time: int, ins: list[Delta | None]) -> Delta | None:
        d = ins[0]
        if d is None or not len(d):
            return None
        if time <= self._skip_until:
            return None
        d = d.consolidated()
        if self._on_batch is not None and len(d):
            self._on_batch(time, d)
        if self._on_change is not None:
            # one pass per tick: bulk tolist + C-speed zip transposition,
            # vectorized diff>0, and dict-display row building for the
            # common narrow schemas — the per-row work is exactly the
            # dict the callback signature requires plus the call itself
            cb = self._on_change
            names = tuple(self.column_names)
            cols = [np.asarray(d.data[c]).tolist() for c in names]
            keys_l = d.keys.tolist()
            adds = (d.diffs > 0).tolist()
            if len(names) == 1:
                n0 = names[0]
                for key, add, v0 in zip(keys_l, adds, cols[0]):
                    cb(key=key, row={n0: v0}, time=time, is_addition=add)
            elif len(names) == 2:
                n0, n1 = names
                for key, add, v0, v1 in zip(keys_l, adds, cols[0], cols[1]):
                    cb(
                        key=key, row={n0: v0, n1: v1},
                        time=time, is_addition=add,
                    )
            else:
                rows = zip(*cols) if cols else iter([()] * len(d))
                for key, add, row in zip(keys_l, adds, rows):
                    cb(
                        key=key,
                        row=dict(zip(names, row)),
                        time=time,
                        is_addition=add,
                    )
        if self._on_time_end is not None and time != END_TIME:
            self._on_time_end(time)
        return None

    def on_end(self) -> Delta | None:
        if self._on_end_cb is not None:
            self._on_end_cb()
        return None


def _as_column(arr: Any, n: int) -> np.ndarray:
    """Normalize an expression result to a length-n column array."""
    if (
        isinstance(arr, np.ndarray)
        and arr.ndim == 1
        and len(arr) == n
        and arr.dtype.kind not in ("U", "S")
    ):
        return arr
    if not isinstance(arr, (np.ndarray, list)):
        # anything else — scalars, None, tuples, dicts, Json, arbitrary
        # objects — is a row *value* (constant per row), never a column
        # vector; np.asarray on an iterable value (pw.Json wraps one)
        # would silently spread its elements across rows
        return column_of_values([arr] * n)
    a = np.asarray(arr)
    if a.ndim == 1 and len(a) == n:
        if a.dtype.kind in ("U", "S"):
            return a.astype(object)
        return a
    # row-valued (e.g. ndarray per row) — wrap as objects
    return column_of_values(list(arr))
