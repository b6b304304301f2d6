"""Analyzer passes over the compiled dataflow graph.

Copy of ``pathway_tpu/analysis/passes.py``; the unbounded-state pass's mitigation names the
memory budget without the reference's change number.

Each pass is a function ``(ctx: AnalysisContext) -> list[Diagnostic]``;
:func:`run_passes` runs them all. Passes reason about the ENGINE nodes
(post expression compilation), using the introspection hooks the
operators expose (``ANALYSIS_STATE_BOUNDED``, ``analysis_forgets``,
``analysis_exprs``) plus the compile-time breadcrumbs the expression
compiler leaves on its kernels (``_pw_expr``/``_pw_dtype``/
``_pw_lift_outcome``).
"""

from __future__ import annotations

import dis
import os
from typing import Any, Callable, Iterator

from ..engine import operators as ops
from ..engine.executor import Node, RealtimeSource
from ..internals import dtype as dt
from ..internals import lintmode
from ..internals.expression import (
    ApplyExpression,
    AsyncApplyExpression,
    ColumnConstExpression,
)
from .graph import AnalysisGraphRunner, node_labels
from .report import Diagnostic

__all__ = ["AnalysisContext", "run_passes", "PASSES"]

#: the spill budget knob (``engine/spill.py``) — its presence downgrades unbounded-state
#: growth from a future OOM to graceful disk degradation
_SPILL_BUDGET_ENV = "PATHWAY_STATE_MEMORY_BUDGET_MB"


class AnalysisContext:
    def __init__(
        self,
        runner: AnalysisGraphRunner,
        persistence_config: Any = None,
        n_workers: int | None = None,
    ) -> None:
        self.runner = runner
        self.nodes: list[Node] = list(runner._nodes)
        self.labels = node_labels(self.nodes)
        if persistence_config is None and lintmode.ACTIVE:
            persistence_config = lintmode.CAPTURE.get("persistence_config")
        self.persistence_config = persistence_config
        if n_workers is None:
            env = os.environ.get("PATHWAY_LINT_WORKERS")
            if env:
                try:
                    n_workers = int(env)
                except ValueError:
                    n_workers = None
        if n_workers is None:
            from ..internals.config import get_pathway_config

            try:
                n_workers = get_pathway_config().total_workers
            except Exception:
                n_workers = 1
        self.n_workers = max(1, int(n_workers))
        #: consumer fan-out per node (id -> count)
        self.consumers: dict[int, int] = {}
        for n in self.nodes:
            for inp in n.inputs:
                self.consumers[id(inp)] = self.consumers.get(id(inp), 0) + 1

    # -- provenance helpers -------------------------------------------------

    def location_of(self, node: Node) -> tuple[str, int] | None:
        table = self.runner.node_tables.get(id(node))
        seq = getattr(table, "_table_seq", None)
        if seq is None:
            return None
        return lintmode.LOCATIONS.get(seq)

    def label(self, node: Node) -> str:
        return self.labels.get(id(node), f"?:{type(node).__name__}")

    @property
    def persisted(self) -> bool:
        return self.persistence_config is not None

    @property
    def transactional_sinks(self) -> list[dict]:
        return self.runner.sink_specs


# ---------------------------------------------------------------------------
# shared walkers
# ---------------------------------------------------------------------------


def _node_exprs(node: Node) -> Iterator[tuple[str, Any]]:
    """(column name, tagged source expression) for every compiled kernel
    of an expression-bearing node that carries a compile breadcrumb."""
    hook = getattr(node, "analysis_exprs", None)
    if hook is None:
        return
    for name, fn in hook().items():
        expr = getattr(fn, "_pw_expr", None)
        if expr is not None:
            yield name, expr


def _walk_expr(expr: Any) -> Iterator[Any]:
    yield expr
    for dep in getattr(expr, "_deps", ()):
        yield from _walk_expr(dep)


def _iter_applies(ctx: AnalysisContext) -> Iterator[tuple[Node, Any]]:
    """Every (node, ApplyExpression) in the graph, deduplicated by the
    UDF's code object (one diagnostic per UDF, not per re-use)."""
    seen: set[Any] = set()
    for node in ctx.nodes:
        for _name, expr in _node_exprs(node):
            for e in _walk_expr(expr):
                if isinstance(e, ApplyExpression):
                    code = getattr(e._fn, "__code__", None)
                    key = code if code is not None else id(e)
                    if key in seen:
                        continue
                    seen.add(key)
                    yield node, e


def _udf_location(fn: Callable) -> tuple[str, int] | None:
    code = getattr(fn, "__code__", None)
    if code is None:
        return None
    return (code.co_filename, code.co_firstlineno)


def _udf_name(fn: Callable) -> str:
    return getattr(fn, "__name__", None) or repr(fn)


# ---------------------------------------------------------------------------
# pass: unbounded-state growth
# ---------------------------------------------------------------------------


def _reaches_live_source(node: Node) -> bool:
    """True when an input path from a never-ending source reaches ``node``
    without crossing a forgetting operator (ForgetAfter with
    forget_state) — the condition under which keyed state grows for as
    long as the stream runs."""
    stack = list(node.inputs)
    seen: set[int] = set()
    while stack:
        n = stack.pop()
        if id(n) in seen:
            continue
        seen.add(id(n))
        if n.analysis_forgets():
            continue  # rows are retracted past the watermark: bounded below
        if isinstance(n, RealtimeSource):
            return True
        stack.extend(n.inputs)
    return False


def pass_unbounded_state(ctx: AnalysisContext) -> list[Diagnostic]:
    out: list[Diagnostic] = []
    budget = os.environ.get(_SPILL_BUDGET_ENV)
    for node in ctx.nodes:
        if node.ANALYSIS_STATE_BOUNDED is not False:
            continue
        if not _reaches_live_source(node):
            continue
        kind = type(node).__name__
        if budget:
            out.append(Diagnostic(
                "unbounded-state",
                f"{kind} accumulates state for every distinct key of a "
                f"never-ending source; the {_SPILL_BUDGET_ENV}={budget} "
                "spill budget degrades it to disk instead of OOM, but "
                "state (and recovery time) still grows forever",
                severity="info",
                operator=ctx.label(node),
                location=ctx.location_of(node),
                mitigation=(
                    "add a temporal cutoff upstream (windowby(...) with a "
                    "cutoff behavior / ForgetAfter) so old keys retract"
                ),
            ))
        else:
            out.append(Diagnostic(
                "unbounded-state",
                f"{kind} accumulates state for every distinct key of a "
                "never-ending source with no temporal cutoff upstream — "
                "memory grows for as long as the stream runs",
                operator=ctx.label(node),
                location=ctx.location_of(node),
                mitigation=(
                    "add a temporal cutoff upstream (windowby(...) with a "
                    "cutoff behavior / ForgetAfter), or set "
                    f"{_SPILL_BUDGET_ENV} so cold state spills to disk "
                    "(the memory budget) instead of OOMing"
                ),
            ))
    return out


# ---------------------------------------------------------------------------
# pass: replay determinism
# ---------------------------------------------------------------------------

#: module globals whose mere use inside a UDF makes replay diverge
_NONDET_GLOBALS = {"random", "secrets", "time"}
#: builtins that reach outside the row (io / entropy)
_NONDET_BUILTINS = {"open", "input"}
#: module -> attributes that are nondeterministic (the module itself is
#: fine: ``datetime.datetime(2024, 1, 1)`` replays exactly and
#: ``uuid.UUID(s)``/``uuid5`` are pure parsing/hashing; ``.now()`` and
#: ``uuid4()`` are not)
_NONDET_ATTRS = {
    "datetime": {"now", "today", "utcnow"},
    # `datetime.datetime.now()` pairs through the dotted chain
    "datetime.datetime": {"now", "today", "utcnow"},
    "datetime.date": {"today"},
    "os": {"urandom", "getpid"},
    "uuid": {"uuid1", "uuid4", "getnode"},
    "np": {"random"},
    "numpy": {"random"},
}


def nondeterminism_evidence(fn: Callable) -> list[str]:
    """RNG/time/io reads visible in ``fn``'s bytecode — the same
    dis-level inspection the udf_lift gates use, pointed at replay
    hazards instead of liftability."""
    code = getattr(fn, "__code__", None)
    if code is None:
        return []
    try:
        instructions = list(dis.get_instructions(fn))
    except TypeError:
        return []
    hits: list[str] = []
    pending: str | None = None
    #: local variable -> module it was import-bound to (a function-local
    #: `import uuid` reaches `uuid.uuid4` via STORE_FAST/LOAD_FAST, never
    #: LOAD_GLOBAL)
    local_mods: dict[str, str] = {}
    for ins in instructions:
        name = ins.opname
        if name.startswith("IMPORT_NAME"):
            mod = (ins.argval or "").split(".")[0]
            if mod in _NONDET_GLOBALS:
                hits.append(mod)
            pending = mod
        elif name.startswith("STORE_FAST"):
            if pending is not None and pending in _NONDET_ATTRS:
                local_mods[ins.argval] = pending
            pending = None
        elif name.startswith("LOAD_FAST"):
            pending = local_mods.get(ins.argval)
        elif name.startswith("LOAD_GLOBAL"):
            g = ins.argval
            if g in _NONDET_GLOBALS:
                hits.append(g)
            elif g in _NONDET_BUILTINS:
                hits.append(f"{g}()")
            pending = g
        elif name.startswith(("LOAD_ATTR", "LOAD_METHOD")):
            if pending is not None:
                allowed = _NONDET_ATTRS.get(pending)
                if allowed and ins.argval in allowed:
                    hits.append(f"{pending}.{ins.argval}")
                pending = f"{pending}.{ins.argval}"
        else:
            pending = None
    # stable order, deduplicated
    return sorted(set(hits))


def pass_replay_determinism(ctx: AnalysisContext) -> list[Diagnostic]:
    if not ctx.persisted and not ctx.transactional_sinks:
        # nothing replays and nothing is exactly-once: a wall-clock UDF
        # is a choice, not a correctness hazard
        return []
    surface = (
        "persisted (state replays after recovery)"
        if ctx.persisted
        else "feeding exactly-once sinks"
    )
    out: list[Diagnostic] = []
    for _node, expr in _iter_applies(ctx):
        evidence = nondeterminism_evidence(expr._fn)
        if not evidence:
            continue
        out.append(Diagnostic(
            "nondeterministic-udf",
            f"UDF {_udf_name(expr._fn)!r} calls {', '.join(evidence)} in a "
            f"pipeline that is {surface}: a recovery replay re-executes it "
            "and produces different values than the original run",
            location=_udf_location(expr._fn),
            mitigation=(
                "move the nondeterminism into the input (stamp rows at "
                "ingest), or make the UDF a pure function of its arguments"
            ),
        ))
    return out


# ---------------------------------------------------------------------------
# pass: per-row dispatch tax
# ---------------------------------------------------------------------------


def pass_dispatch_tax(ctx: AnalysisContext) -> list[Diagnostic]:
    out: list[Diagnostic] = []
    for _node, expr in _iter_applies(ctx):
        outcome = getattr(expr, "_pw_lift_outcome", None)
        if outcome is None or outcome.get("status") != "dynamic":
            continue
        if outcome.get("traceable"):
            continue  # the probe-row trace will compile it at runtime
        refusal = outcome.get("refusal") or "outside the liftable subset"
        out.append(Diagnostic(
            "perrow-udf",
            f"UDF {_udf_name(expr._fn)!r} runs per-row Python on every "
            f"batch (static lift refused: {refusal}; probe-trace gate "
            "refused too)",
            location=_udf_location(expr._fn),
            mitigation=(
                "rewrite within the liftable subset (pure expressions, "
                "method chains, conditionals — see README 'Writing fast "
                "UDFs'), or hoist the blocking construct out of the UDF"
            ),
        ))
    return out


# ---------------------------------------------------------------------------
# pass: fusion readiness
# ---------------------------------------------------------------------------


def pass_fusion_readiness(ctx: AnalysisContext) -> list[Diagnostic]:
    """Cross-check of the compiler's ACTUAL fusion decisions: the same
    chain walk the executor's fusion pass performs (engine/fusion.py
    ``plan_chains`` — one implementation, so analyzer and compiler can
    never disagree on chain shape), with each chain's fuse/decline
    verdict surfaced. A fused chain is an info note; a chain the
    compiler detected but DECLINED carries the verbatim decline reason
    at warning severity — the same reason-plumbing contract the
    ``_LIFT_REFUSED`` per-row diagnostics established."""
    from ..engine.fusion import plan_chains

    out: list[Diagnostic] = []
    for plan in plan_chains(ctx.nodes):
        chain = plan.members
        # every internal boundary re-enters Python dispatch and
        # materializes the upstream node's full column set
        cost = sum(len(m.column_names) for m in chain[:-1])
        shape = "→".join(type(m).__name__ for m in chain)
        if plan.fused:
            out.append(Diagnostic(
                "fusion-chain",
                f"pure linear chain {shape} ({len(chain)} operators) "
                f"fuses into one compiled kernel — ~{cost} intermediate "
                "column(s) per batch stop materializing between nodes",
                severity="info",
                operator=ctx.label(chain[0]),
                location=ctx.location_of(chain[0]),
                mitigation=None,
            ))
        else:
            out.append(Diagnostic(
                "fusion-chain",
                f"linear chain {shape} ({len(chain)} operators) "
                f"materializes ~{cost} intermediate column(s) per batch "
                f"but the compiler declined to fuse it: {plan.reason}",
                severity="warning",
                operator=ctx.label(chain[0]),
                location=ctx.location_of(chain[0]),
                mitigation=(
                    "resolve the decline reason (or unset PATHWAY_FUSION=0) "
                    "so the chain compiles into one kernel"
                ),
            ))
    return out


# ---------------------------------------------------------------------------
# pass: shard skew
# ---------------------------------------------------------------------------


def _key_cardinality(fn: Any) -> int | None:
    """Static upper bound on a key kernel's distinct values, when the
    dtype proves one (BOOL -> 2, constant -> 1); None = unknown."""
    expr = getattr(fn, "_pw_expr", None)
    if isinstance(expr, ColumnConstExpression):
        return 1
    dtype = getattr(fn, "_pw_dtype", None)
    if dtype is not None and dt.unoptionalize(dtype) == dt.BOOL:
        return 2
    return None


def _key_fns_of(node: Node) -> list[Any] | None:
    """The key kernels a keyed-state operator routes by, read off its
    input Rowwise node (the lowering always materializes keys there)."""
    if isinstance(node, ops.GroupByReduce):
        inp = node.inputs[0]
        hook = getattr(inp, "analysis_exprs", None)
        if hook is None:
            return None
        exprs = hook()
        fns = [exprs.get(c) for c in node._group_cols]
        return [f for f in fns if f is not None] or None
    if isinstance(node, ops.Join):
        fns = []
        for side in node.inputs:
            hook = getattr(side, "analysis_exprs", None)
            if hook is None:
                continue
            jk = hook().get("__jk__")
            key_fns = getattr(jk, "_pw_key_fns", None)
            if key_fns:
                fns.append(list(key_fns))
        return fns[0] if fns else None
    return None


def pass_shard_skew(ctx: AnalysisContext) -> list[Diagnostic]:
    if ctx.n_workers <= 1:
        return []
    out: list[Diagnostic] = []
    for node in ctx.nodes:
        fns = _key_fns_of(node)
        if not fns:
            continue
        cards = [_key_cardinality(f) for f in fns]
        if any(c is None for c in cards):
            continue
        total = 1
        for c in cards:
            total *= c  # type: ignore[operator]
        if total >= ctx.n_workers:
            continue
        kind = type(node).__name__
        out.append(Diagnostic(
            "shard-skew",
            f"{kind} keys take at most {total} distinct value(s) but the "
            f"pipeline targets {ctx.n_workers} workers — "
            f"{ctx.n_workers - total} worker(s) will hold no state and "
            "the rest become hot shards",
            operator=ctx.label(node),
            location=ctx.location_of(node),
            mitigation=(
                "group/join on a higher-cardinality key (or a composite "
                "key), or run fewer workers for this stage; at runtime, "
                "the keyload.* signals series and pathway_key_group_share "
                "on /metrics (observability/keyload.py) measure the "
                "realized per-key-group row distribution this pass can "
                "only predict statically"
            ),
        ))
    return out


# ---------------------------------------------------------------------------
# pass: sink / persistence misconfiguration
# ---------------------------------------------------------------------------


def _sink_location(spec: dict) -> tuple[str, int] | None:
    return spec.get("_lint_loc")


def pass_sink_misconfig(ctx: AnalysisContext) -> list[Diagnostic]:
    out: list[Diagnostic] = []
    specs = ctx.runner.sink_specs
    if specs and not ctx.persisted:
        names = ", ".join(s["name"] for s in specs[:4])
        more = f" (+{len(specs) - 4} more)" if len(specs) > 4 else ""
        out.append(Diagnostic(
            "sink-no-persistence",
            f"{len(specs)} transactional sink(s) [{names}{more}] but the "
            "pipeline runs without persistence: no commit boundary gates "
            "delivery, so a crash re-sends whatever was in flight "
            "(at-least-once, not exactly-once)",
            location=_sink_location(specs[0]),
            mitigation=(
                "pass persistence_config to pw.run (pw.persistence."
                "Config.simple_config) — the delivery layer then acks "
                "against committed input and recovery dedupes replays"
            ),
        ))
    for spec in specs:
        if spec.get("decollided"):
            out.append(Diagnostic(
                "sink-name-collision",
                f"sink {spec['name']!r} got its name from a registration-"
                "order de-collision suffix (another sink derived the same "
                "default): reordering outputs in the program would swap "
                "their ack cursors and DLQ files",
                location=_sink_location(spec),
                mitigation="pass a distinct name= to each output connector",
            ))
    # DLQ directory overlapping a path some other component owns
    dlq_root = os.path.abspath(
        os.environ.get("PATHWAY_SINK_DLQ_DIR", "./pathway-dlq")
    )
    owned: list[tuple[str, str]] = []
    for spec in specs:
        path = (spec.get("meta") or {}).get("path")
        if path:
            owned.append((f"sink {spec['name']!r} output", os.path.abspath(path)))
    pcfg = ctx.persistence_config
    backend = getattr(pcfg, "backend", None)
    proot = (getattr(backend, "options", None) or {}).get("path")
    if proot:
        owned.append(("the persistence root", os.path.abspath(proot)))
    for what, path in owned:
        if path == dlq_root or _nested(path, dlq_root) or _nested(dlq_root, path):
            out.append(Diagnostic(
                "dlq-collision",
                f"the dead-letter directory ({dlq_root}) overlaps {what} "
                f"({path}): dead-lettered rows would interleave with "
                "data another component owns",
                mitigation=(
                    "point PATHWAY_SINK_DLQ_DIR at a directory of its own"
                ),
            ))
    return out


def _nested(inner: str, outer: str) -> bool:
    return inner.startswith(outer.rstrip(os.sep) + os.sep)


PASSES: list[Callable[[AnalysisContext], list[Diagnostic]]] = [
    pass_unbounded_state,
    pass_replay_determinism,
    pass_dispatch_tax,
    pass_fusion_readiness,
    pass_shard_skew,
    pass_sink_misconfig,
]


def run_passes(ctx: AnalysisContext) -> list[Diagnostic]:
    out: list[Diagnostic] = []
    for p in PASSES:
        out.extend(p(ctx))
    # deterministic report order: errors first, then by id, then location
    from .report import SEVERITIES

    out.sort(key=lambda d: (
        -SEVERITIES.index(d.severity),
        d.id,
        d.location or ("", 0),
        d.operator or "",
    ))
    return out
