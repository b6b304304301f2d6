"""Whole-graph kernel fusion: compile operator chains into single callables.

The compiler vectorizes per operator — every node in a pipeline
materializes its full intermediate columns (a fresh ``Delta`` per node)
and re-enters Python dispatch before the next node runs, and every
``Filter`` compacts all columns with a ``take``. The reference engine
instead compiles whole expression DAGs into single evaluation units
(``src/engine/expression.rs``). This pass closes that gap at the
compiler/executor boundary:

- after graph lowering (and sharding — Exchange nodes are fusion
  barriers by construction), maximal pure linear chains of
  ``Rowwise``/``Filter`` nodes collapse into ONE :class:`FusedChain`
  node whose inputs are the chain's source columns and whose output is
  the final node's columns — no intermediate ``Delta``, no Python
  dispatch between fused members;
- filters inside a chain propagate a boolean mask instead of
  compacting, with one compaction at the chain exit, whenever every
  later member kernel is total on masked-out rows (the same
  ``jax_ok`` property the per-expression jit gates on); otherwise the
  chain compacts in place at the filter boundary (still fused — index
  arrays applied to live columns, no Delta round-trip);
- reducer preambles feeding groupby/join (the adjacent ``Rowwise``
  the lowering always materializes group keys / join keys in) are
  absorbed into the stateful node itself (``operators.GroupByReduce``
  / ``operators.Join`` ``_preamble``), which also unlocks the
  content-key reuse fast path (group/join keys equal to the ingest
  row keys bit-for-bit — see ``operators.py``).

Error-row semantics are preserved by construction: any batch that
raises inside a fused kernel (or routes an Error-carrying predicate
through a deferred mask) re-runs through the exact per-node path —
the same contract the lifted-UDF ladder established.

Fusion is observable: per-chain ``fusion.exec`` trace spans carry the
member operator names, and per-operator time is measured member by
member when detailed stats are on.

``PATHWAY_FUSION=0`` is the escape hatch (default on): the graph then
runs the per-node path unchanged.

Copy of ``pathway_tpu/engine/fusion.py``. In place of its whole-chain XLA
tier (``FusedChain._try_jit``), chains whose every kernel is a ``jax_ok``
expression tree with a structural signature lower to ONE program of the
expression register machine (``ops/expression_kernel.py``, the CUDA kernel
``csrc/expression_vm.cu``): the members' columns, then the filters' masks
ANDed, in one launch per batch past the reference's gates (threshold,
warm-up, no object columns), on the device the runner lowered the chain's
expressions for. A failure to build or launch the program raises; it does
not fall back to the numpy tier. A program's run is attributed to the
members by the reference's EWMA cost split of the numpy tier
(``_attribute_by_weight``), and the profiler's operator slot names the
executing member as the reference's does.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable

import numpy as np

from .delta import Delta
from .executor import Node

__all__ = [
    "FusedChain",
    "FusionPlan",
    "fusion_enabled",
    "fuse_graph",
    "plan_chains",
    "fusion_stats_snapshot",
    "FUSION_STATS",
]

# ---------------------------------------------------------------------------
# knob + process-wide counters
# ---------------------------------------------------------------------------


def fusion_enabled() -> bool:
    """The PATHWAY_FUSION escape hatch: default on, ``0`` disables the
    whole subsystem (chain fusion, preamble absorption, key reuse and
    the consolidation identity fast path) so a same-host A/B attributes
    the speedup. Read per call — tests and the bench toggle it between
    runs within one process."""
    return os.environ.get("PATHWAY_FUSION", "1") != "0"


#: process-wide fusion counters — snapshotted onto /metrics as
#: pathway_fusion_* and into the signals plane (observability.hub),
#: mirroring UDF_STATS in internals/expression_compiler.py
FUSION_STATS: dict[str, int] = {
    "chains_total": 0,        # FusedChain nodes built (per executor build)
    "fused_ops_total": 0,     # member operators those chains absorbed
    "fallbacks_total": 0,     # batches replayed through the per-node path
    "preambles_total": 0,     # Rowwise preambles absorbed into groupby/join
    "key_reuse_total": 0,     # batches whose group/join keys reused row keys
    "consolidation_skips_total": 0,  # provably-identity consolidations skipped
    "jit_chains_total": 0,    # chains that lowered to one machine program
}


def fusion_stats_snapshot() -> dict[str, float]:
    return {k: float(v) for k, v in FUSION_STATS.items()}


# ---------------------------------------------------------------------------
# decline reasons (module-level constants: the fusion-chain lint
# diagnostic surfaces them verbatim, and the check_all `fusion_reasons`
# gate asserts every one of them is exercised by a parity test)
# ---------------------------------------------------------------------------

REASON_DISABLED = "fusion disabled (PATHWAY_FUSION=0)"
REASON_MIXED_ERROR_SCOPES = "members span different local error-log scopes"


@dataclass
class FusionPlan:
    """One chain decision: the members (in dataflow order), whether the
    compiler fuses it, and the verbatim decline reason otherwise."""

    members: list[Node]
    fused: bool
    reason: str | None = None
    #: set when the plan is a preamble absorption rather than a chain
    preamble_into: Node | None = None

    def labels(self) -> list[str]:
        return [f"{type(m).__name__}#{m.node_id}" for m in self.members]


# ---------------------------------------------------------------------------
# chain detection (the same maximal-pure-linear-chain walk the
# fusion-chain lint diagnostic performs — analysis/passes.py imports
# plan_chains so analyzer and compiler can never disagree on shape)
# ---------------------------------------------------------------------------


def _chainable(node: Node) -> bool:
    from . import operators as ops

    return (
        isinstance(node, (ops.Rowwise, ops.Filter))
        and len(node.inputs) == 1
        and not node.always_run
        and not node.has_state()
    )


def plan_chains(nodes: list[Node], enabled: bool | None = None) -> list[FusionPlan]:
    """Maximal linear chains of chainable nodes with single-consumer
    internal edges, each with the compiler's fuse/decline verdict.
    Pure planning — no node is rewired; the executor applies plans via
    :func:`fuse_graph`, the lint pass reads them for the cross-check."""
    if enabled is None:
        enabled = fusion_enabled()
    consumers: dict[int, int] = {}
    for n in nodes:
        for inp in n.inputs:
            consumers[id(inp)] = consumers.get(id(inp), 0) + 1
    by_id = {id(n): n for n in nodes}
    eligible = {id(n) for n in nodes if _chainable(n)}
    consumer_of: dict[int, Node] = {}
    for n in nodes:
        for inp in n.inputs:
            consumer_of[id(inp)] = n  # only used where count == 1

    plans: list[FusionPlan] = []
    seen: set[int] = set()
    for n in nodes:
        if id(n) not in eligible or id(n) in seen:
            continue
        head = n
        while True:
            prev = head.inputs[0]
            if id(prev) in eligible and consumers.get(id(prev), 0) == 1:
                head = prev
            else:
                break
        chain = [head]
        while consumers.get(id(chain[-1]), 0) == 1:
            nxt = consumer_of.get(id(chain[-1]))
            if nxt is None or id(nxt) not in eligible:
                break
            chain.append(nxt)
        for m in chain:
            seen.add(id(m))
        if len(chain) < 2:
            continue
        if not enabled:
            plans.append(FusionPlan(chain, False, REASON_DISABLED))
            continue
        scopes = {getattr(m, "error_scope", None) for m in chain}
        if len(scopes) > 1:
            plans.append(FusionPlan(chain, False, REASON_MIXED_ERROR_SCOPES))
            continue
        plans.append(FusionPlan(chain, True))
    return plans


def plan_preambles(
    nodes: list[Node], enabled: bool | None = None,
    fused_members: set[int] | None = None,
) -> list[FusionPlan]:
    """Adjacent single-consumer Rowwise nodes feeding a stateful
    groupby/join port — absorbed into the stateful node so the key
    columns materialize inside it (and the content-key reuse fast path
    can see the source delta's provenance)."""
    from . import operators as ops

    if enabled is None:
        enabled = fusion_enabled()
    if not enabled:
        return []
    fused_members = fused_members or set()
    consumers: dict[int, int] = {}
    for n in nodes:
        for inp in n.inputs:
            consumers[id(inp)] = consumers.get(id(inp), 0) + 1
    plans: list[FusionPlan] = []
    for n in nodes:
        if isinstance(n, ops.GroupByReduce):
            ports = [0]
        elif isinstance(n, ops.Join):
            ports = [0, 1]
        else:
            continue
        for port in ports:
            if port >= len(n.inputs):
                continue
            inp = n.inputs[port]
            if (
                isinstance(inp, ops.Rowwise)
                and len(inp.inputs) == 1
                and consumers.get(id(inp), 0) == 1
                and id(inp) not in fused_members
                # scope must match: the preamble's errors keep firing
                # under the stateful node's process()
                and getattr(inp, "error_scope", None)
                == getattr(n, "error_scope", None)
            ):
                plans.append(FusionPlan([inp], True, preamble_into=n))
    return plans


def fuse_graph(nodes: list[Node]) -> list[Node]:
    """Apply the fusion pass to a lowered (and sharded) node list.
    Returns the new node list; the per-node graph is returned unchanged
    when the escape hatch is closed."""
    if not fusion_enabled():
        return nodes
    plans = [p for p in plan_chains(nodes, enabled=True) if p.fused]
    dropped: set[int] = set()
    replacement: dict[int, Node] = {}
    fused_members: set[int] = set()
    for p in plans:
        fused = FusedChain(p.members)
        FUSION_STATS["chains_total"] += 1
        FUSION_STATS["fused_ops_total"] += len(p.members)
        for m in p.members:
            dropped.add(id(m))
            fused_members.add(id(m))
        replacement[id(p.members[-1])] = fused
        # breadcrumb for the lint cross-check + /query introspection
        fused._pw_fusion_plan = p

    out: list[Node] = []
    for n in nodes:
        if id(n) in replacement:
            out.append(replacement[id(n)])
        elif id(n) not in dropped:
            out.append(n)
    # rewire consumers of each chain's last member onto the FusedChain
    tail_to_fused = {
        id(p.members[-1]): replacement[id(p.members[-1])] for p in plans
    }
    for n in out:
        n.inputs = [
            tail_to_fused.get(id(inp), inp) for inp in n.inputs
        ]

    # preamble absorption AFTER chains: only plain un-fused Rowwise
    # nodes directly feeding a groupby/join port qualify
    for p in plan_preambles(out, enabled=True, fused_members=fused_members):
        target = p.preamble_into
        member = p.members[0]
        port = target.inputs.index(member)
        if target.absorb_preamble(port, member):
            target.inputs[port] = member.inputs[0]
            out.remove(member)
            FUSION_STATS["preambles_total"] += 1
            plans.append(p)
    return out


# ---------------------------------------------------------------------------
# the fused node
# ---------------------------------------------------------------------------


class _FuseFallback(Exception):
    """Internal: this batch must run the exact per-node path."""


class FusedChain(Node):
    """One engine node executing a whole Rowwise/Filter chain.

    Three execution tiers per batch, fastest first:

    1. one expression-machine program for the whole chain (pure numeric
       expression chains, large dense batches — the per-expression
       gates: threshold, warm-up, dense columns);
    2. composed member kernels over a live column dict — no
       intermediate Delta, masks deferred across total members, one
       compaction at exit;
    3. the exact per-node path (``member.process`` in sequence) for any
       batch that raises or routes Errors through a deferred mask —
       row-error semantics are identical to the unfused graph.
    """

    #: executor: per-operator time is self-reported per member (the
    #: attribution contract — never double-count the chain's own label)
    ATTRIBUTES_MEMBERS = True

    def __init__(self, members: list[Node]):
        from . import operators as ops

        super().__init__([members[0].inputs[0]], members[-1].column_names)
        self.members = members
        self.error_scope = getattr(members[0], "error_scope", None)
        self._labels = [f"{type(m).__name__}#{m.node_id}" for m in members]
        #: EngineStats.note_node keys emitted-row counts by these, so
        #: the rows and time series share labels inside a fused chain
        self.attribution_labels = tuple(self._labels)
        #: EWMA per-member cost weights (ns) — the program tier reports
        #: one launch's time; attribution splits it by these
        self._weights = np.ones(len(members), dtype=np.float64)
        self._member_kind = [
            "filter" if isinstance(m, ops.Filter) else "rowwise"
            for m in members
        ]
        # mask deferral: after member i produced a mask, it may stay
        # deferred only while every LATER kernel is total on masked-out
        # rows (jax_ok expression kernels: dense numeric, no division,
        # no error carriers) — otherwise compact right at the filter
        total_after = [True] * (len(members) + 1)
        for i in range(len(members) - 1, -1, -1):
            total_after[i] = total_after[i + 1] and self._member_total(members[i])
        self._defer_after = total_after[1:]
        self._tracer_box: list = []  # lazily resolved process tracer
        self._kernel_hot = 0  # large dense batches seen by the program tier
        self._kernel_plan = self._build_kernel_plan()
        self._launcher = None  # lazily built HostLauncher of the plan's device

    # -- planning helpers ------------------------------------------------

    @staticmethod
    def _member_kernels(m: Node) -> dict[str, Callable]:
        from . import operators as ops

        if isinstance(m, ops.Filter):
            return {"__pred__": m._predicate}
        return m._exprs

    @staticmethod
    def _member_total(m: Node) -> bool:
        """Every kernel of ``m`` is a jax-compilable expression — total
        on any row, so evaluating masked-out rows cannot raise, produce
        Error carriers, or touch the error log."""
        for fn in FusedChain._member_kernels(m).values():
            if not getattr(fn, "_pw_jax_ok", False):
                return False
        return True

    def _build_kernel_plan(self):
        """(member spec, source cols, composite signature, device) when
        the whole chain can run as one machine program, else None."""
        from ..internals import expression_compiler as ec

        spec: list[tuple[str, dict]] = []
        sigs: list = []
        src_cols: set[str] = set()
        devices: set = set()
        produced: set[str] | None = None  # None until a rowwise ran
        for m, kind in zip(self.members, self._member_kind):
            kernels = self._member_kernels(m)
            entry: dict[str, tuple] = {}
            for name, fn in kernels.items():
                expr = getattr(fn, "_pw_expr", None)
                env = getattr(fn, "_pw_env", None)
                if (
                    expr is None or env is None
                    or not getattr(fn, "_pw_jax_ok", False)
                ):
                    return None
                sig = ec._structural_sig(expr, env)
                if sig is None:
                    return None
                entry[name] = (expr, env)
                devices.add(env.device)
                sigs.append((kind, name, sig))
                _, _, _, refs = ec._build(expr, env)
                src_cols.update(
                    c
                    for c in refs
                    if c is not None
                    and (produced is None or c not in produced)
                )
            if kind == "rowwise":
                produced = set(kernels.keys())
            spec.append((kind, entry))
        # output producibility: after the LAST rowwise the live dict holds
        # exactly its outputs; a filter-only chain passes the input dict
        # through, so its output columns must ride in as source columns
        if produced is None:
            src_cols.update(self.column_names)
        elif not set(self.column_names) <= produced:
            return None
        if len(devices) != 1 or None in devices:
            return None  # expressions lowered for type inference only
        return {
            "spec": spec,
            "src_cols": sorted(src_cols),
            "out_cols": list(self.column_names),
            "sig": ("chain", *sigs),
            "member_sigs": [s[2] for s in sigs],
            "device": devices.pop(),
        }

    def _try_kernel(self, d: Delta):
        """Run the whole chain as one machine program when the plan and the
        gates allow: (columns, mask or None); None → the composed numpy
        tier. The gates are the per-expression ones of
        internals/expression_compiler (threshold, warm-up, columns the
        machine loads). Past them the launch raises on failure."""
        from ..internals import expression_compiler as ec
        from ..ops import expression_kernel as vm

        plan = self._kernel_plan
        if plan is None:
            return None
        n = len(d)
        if n < ec.JIT_THRESHOLD:
            return None
        for c in plan["src_cols"]:
            a = d.data.get(c)
            if a is None or vm.column_kind(getattr(a, "dtype", object)) is None:
                return None
        self._kernel_hot += 1
        if self._kernel_hot <= ec.JIT_WARMUP_BATCHES:
            return None
        if self._launcher is None:
            self._launcher = vm.HostLauncher(plan["device"])
            FUSION_STATS["jit_chains_total"] += 1
        kinds = ec._input_kinds(plan["src_cols"], d.data)
        prog = ec.chain_program(plan, kinds)
        outs = self._launcher.run(prog, ec._program_inputs(prog, d.data, d.keys), n)
        cols = dict(zip(self.column_names, outs))
        mask = outs[len(self.column_names)] if len(outs) > len(self.column_names) else None
        return cols, mask

    # -- execution -------------------------------------------------------

    def process(self, time: int, ins: list[Delta | None]) -> Delta | None:
        import time as _wall

        d = ins[0]
        if d is None or not len(d):
            return None
        stats = getattr(self, "_engine_stats", None)
        detailed = stats is not None and stats.detailed
        tracer = self._tracer()
        t0 = _wall.perf_counter_ns() if tracer is not None or detailed else 0
        fell_back = False
        # progress record for the fallback: [next member index, cols,
        # keys, diffs, pending mask]. Completed members are NOT re-run
        # on fallback — their kernels already fired (and row-error
        # creation logs once, exactly like the per-node path).
        state: list = [0, d.data, d.keys, d.diffs, None]
        try:
            # the program tier runs outside the fallback's try: past its
            # gates a failure raises, it never falls back to the numpy tier
            kernel_out = self._try_kernel(d)
            if kernel_out is not None:
                cols, mask = kernel_out
                if detailed:
                    self._attribute_by_weight(
                        stats, _wall.perf_counter_ns() - t0
                    )
                return self._exit(d.keys, cols, d.diffs, mask)
            try:
                return self._process_fused(d, stats if detailed else None, state)
            except Exception:
                FUSION_STATS["fallbacks_total"] += 1
                fell_back = True
                return self._resume_per_node(
                    time, state, stats if detailed else None
                )
        finally:
            if tracer is not None:
                tracer.complete(
                    "fusion.exec",
                    t0,
                    {
                        "members": ",".join(self._labels),
                        "rows": len(d),
                        "fallback": fell_back,
                    },
                )

    def _resume_per_node(self, time, state, stats) -> Delta | None:
        """The exact unfused path from the point the fused tier stopped:
        members the fused tier already COMPLETED are not re-run (their
        kernels fired once, error-log entries included — identical to
        the per-node schedule), the failing member and everything after
        it run their own ``process``. A pending deferred mask compacts
        first: the completed filters' kernels are row-local, so the
        compacted state is bit-identical to what the eager per-node
        path would hold here."""
        import time as _wall

        start, cols, keys, diffs, mask = state
        if mask is not None:
            idx = np.flatnonzero(mask)
            if len(idx) == 0:
                return None
            keys = keys[idx]
            diffs = diffs[idx]
            cols = {c: np.asarray(a)[idx] for c, a in cols.items()}
        d = Delta(keys=keys, data=dict(cols), diffs=diffs)
        es = getattr(self, "_engine_stats", None)
        op_slot = es._op_slot if es is not None else None
        for m in self.members[start:]:
            if d is None or not len(d):
                return None
            if op_slot is not None:
                op_slot.label = f"{type(m).__name__}#{m.node_id}"
            if stats is not None:
                t0 = _wall.perf_counter_ns()
            d = m.process(time, [d])
            if stats is not None:
                stats.note_op_time(
                    f"{type(m).__name__}#{m.node_id}",
                    _wall.perf_counter_ns() - t0,
                )
        if d is None or not len(d):
            return None
        return d

    def _process_fused(self, d: Delta, stats, state: list) -> Delta | None:
        import time as _wall

        from .error import ERROR_LOG, Error as EngineError
        from .operators import _as_column

        cols: dict[str, np.ndarray] = d.data
        keys, diffs = d.keys, d.diffs
        mask: np.ndarray | None = None
        member_ns = None if stats is None else np.zeros(len(self.members))
        es = getattr(self, "_engine_stats", None)
        op_slot = es._op_slot if es is not None else None
        for i, (m, kind) in enumerate(zip(self.members, self._member_kind)):
            if op_slot is not None:
                # refine the executor's chain label to the executing
                # MEMBER — /attribution ranks member labels, and profiler
                # samples must join against that ranking
                op_slot.label = self._labels[i]
            t0 = _wall.perf_counter_ns() if stats is not None else 0
            n = len(keys)
            if kind == "rowwise":
                cols = {
                    name: _as_column(fn(cols, keys), n)
                    for name, fn in m._exprs.items()
                }
            else:
                mv = np.asarray(m._predicate(cols, keys))
                if mv.dtype == object:
                    # Error-carrying predicate: exact Filter.process
                    # semantics INLINE (drop the row, log additions) —
                    # never re-evaluate, a second evaluation would
                    # re-create (and re-log) the per-row errors. A
                    # pending deferred mask cannot coexist with an
                    # object mask (deferral requires every later kernel
                    # jax_ok-total over dense columns), asserted below.
                    if mask is not None:
                        raise _FuseFallback
                    out = np.empty(len(mv), dtype=bool)
                    for j, x in enumerate(mv):
                        if type(x) is EngineError:
                            out[j] = False
                            if diffs[j] > 0:
                                ERROR_LOG.record(
                                    "Error value encountered in filter "
                                    "condition, skipping the row",
                                    "filter",
                                )
                        else:
                            out[j] = bool(x)
                    mv = out
                if mv.dtype != np.bool_:
                    mv = mv.astype(bool)
                if mask is not None:
                    mv = mask & mv
                # defer the mask only while every later kernel is total
                # AND the live columns are dense — evaluating _objsafe
                # per-row lanes on masked-out object rows could create
                # (and log) row errors the per-node path never sees
                if self._defer_after[i] and all(
                    getattr(a, "dtype", None) != object
                    for a in cols.values()
                ):
                    mask = mv
                else:
                    idx = np.flatnonzero(mv)
                    mask = None
                    if len(idx) == 0:
                        if stats is not None:
                            member_ns[i] += _wall.perf_counter_ns() - t0
                            self._note_members(stats, member_ns)
                        return None
                    if len(idx) < n:
                        keys = keys[idx]
                        diffs = diffs[idx]
                        cols = {c: a[idx] for c, a in cols.items()}
            if stats is not None:
                member_ns[i] += _wall.perf_counter_ns() - t0
            # member i complete: the fallback resumes AFTER it
            state[0] = i + 1
            state[1], state[2], state[3], state[4] = cols, keys, diffs, mask
        if stats is not None:
            self._note_members(stats, member_ns)
        return self._exit(keys, cols, diffs, mask)

    def _exit(self, keys, cols, diffs, mask) -> Delta | None:
        """One compaction at the chain exit."""
        if mask is not None:
            idx = np.flatnonzero(mask)
            if len(idx) == 0:
                return None
            if len(idx) < len(keys):
                keys = keys[idx]
                diffs = diffs[idx]
                cols = {c: np.asarray(a)[idx] for c, a in cols.items()}
        out = Delta(keys=keys, data=dict(cols), diffs=diffs)
        return out if len(out) else None

    # -- attribution + tracing ------------------------------------------

    def _note_members(self, stats, member_ns) -> None:
        total = float(member_ns.sum())
        if total > 0:
            # EWMA cost split: the program tier re-uses it
            self._weights = 0.8 * self._weights + 0.2 * member_ns
        for label, ns in zip(self._labels, member_ns):
            if ns > 0:
                stats.note_op_time(label, int(ns))

    def _attribute_by_weight(self, stats, total_ns: int) -> None:
        w = self._weights
        tot = float(w.sum()) or 1.0
        for label, wi in zip(self._labels, w):
            share = int(total_ns * (wi / tot))
            if share > 0:
                stats.note_op_time(label, share)

    def _tracer(self):
        if not self._tracer_box:
            from ..internals.tracing import get_tracer

            self._tracer_box.append(get_tracer())
        return self._tracer_box[0]

    def __repr__(self) -> str:
        inner = "→".join(self._labels)
        return f"<FusedChain #{self.node_id} [{inner}]>"
