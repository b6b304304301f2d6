"""Side-effect-free lowering + structural operator fingerprints.

Copy of ``pathway_tpu/analysis/graph.py``. ``AnalysisGraphRunner`` takes the
port's ``GraphRunner``'s ``device=`` and lowers there; it builds no executor,
so no source thread starts and no kernel launches. Fingerprints of user
expressions (``_pw_expr``) are the reference's; a node whose fingerprint
folds in an engine-internal closure (a projection, a join-key mixer, a
reducer's helper) hashes the port's bytecode, which is not the reference's.

The analyzer walks the COMPILED dataflow graph — the same engine-operator
nodes ``pw.run`` would execute — not the declarative parse graph: every
diagnostic then reasons about what actually runs (post expression
compilation, post groupby/join decomposition), exactly the stage the
reference engine checks whole expression DAGs at (``src/engine/
expression.rs``). :class:`AnalysisGraphRunner` reuses the real
``GraphRunner`` lowering but stubs the delivery layer (no files opened,
no connections dialed) and records sink metadata + node→table provenance
for diagnostics.

Fingerprints: every operator gets a structural hash derived from its
class, construction parameters (``Node.analysis_signature``), compiled
expression trees and its inputs' fingerprints — identity-free, so two
compiles of the same script agree bit-for-bit while any graph change
propagates downstream. This is the stable operator identity primitive
zero-downtime graph-version migration needs.
"""

from __future__ import annotations

import hashlib
from typing import Any

import torch

from ..engine.executor import Node, SourceNode, _topological
from ..internals.graph_runner import GraphRunner
from ..internals.parse_graph import G

__all__ = [
    "AnalysisGraphRunner",
    "expr_fingerprint",
    "fingerprint_nodes",
    "lower_current_graph",
    "node_labels",
]


class _NullDeliverySink:
    """Stands in for a DeliverySink during analysis: the Subscribe node
    gets real callables, nothing external is ever opened."""

    @staticmethod
    def on_batch(*a: Any, **k: Any) -> None:  # pragma: no cover
        return None

    @staticmethod
    def on_end(*a: Any, **k: Any) -> None:  # pragma: no cover
        return None


class AnalysisGraphRunner(GraphRunner):
    """GraphRunner that lowers WITHOUT execution side effects and records
    provenance the passes need."""

    def __init__(self, device: str | torch.device = "cuda") -> None:
        super().__init__(device)
        #: delivery sink specs in registration order (io/delivery.deliver)
        self.sink_specs: list[dict] = []
        #: plain (non-delivery) subscribe sinks seen
        self.plain_sinks: int = 0
        #: id(node) -> Table that lowered to it (diagnostic locations)
        self.node_tables: dict[int, Any] = {}

    def lower(self, table: Any) -> Node:
        before = len(self._nodes)
        node = super().lower(table)
        # every node minted while lowering THIS table inherits its
        # provenance; nested lower() calls already claimed their own
        # spans (setdefault keeps the innermost, most precise owner)
        for minted in self._nodes[before:]:
            self.node_tables.setdefault(id(minted), table)
        self.node_tables.setdefault(id(node), table)
        return node

    def lower_sink(self, sink: Any) -> None:
        if sink.get("kind") == "subscribe" and not sink.get("delivery"):
            self.plain_sinks += 1
        super().lower_sink(sink)

    def _build_delivery_sink(self, spec: dict) -> Any:
        # record, never instantiate: adapter factories open files/dial
        # connections — analysis must observe the graph, not touch the world
        self.sink_specs.append(spec)
        return _NullDeliverySink


def lower_current_graph(device: str | torch.device = "cuda") -> AnalysisGraphRunner:
    """Lower every sink registered on the global parse graph (what
    ``pw.run`` would execute) through the analysis runner on ``device``."""
    runner = AnalysisGraphRunner(device)
    for sink in G.sinks:
        runner.lower_sink(sink)
    return runner


# ---------------------------------------------------------------------------
# structural fingerprints
# ---------------------------------------------------------------------------


def _const_repr(c: Any) -> str:
    """Canonical, process-independent repr of a code/default constant.
    Plain ``repr`` is NOT stable across processes for everything the
    bytecode compiler can intern: frozenset literals (``x in {"a","b"}``)
    iterate in hash-randomized order, and arbitrary objects embed memory
    addresses. Sets sort by element repr; containers recurse; anything
    without a value-based repr degrades to its type name."""
    if isinstance(c, (frozenset, set)):
        return "{" + ",".join(sorted(_const_repr(e) for e in c)) + "}"
    if isinstance(c, tuple):
        return "(" + ",".join(_const_repr(e) for e in c) + ")"
    if c is None or isinstance(c, (bool, int, float, complex, str, bytes)):
        return repr(c)
    r = repr(c)
    # value-based reprs (dtypes, enums) are stable and informative; a
    # default object repr embeds a memory address — degrade to the type
    return r if " at 0x" not in r else type(c).__name__


def _code_fp(code: Any, h: "hashlib._Hash") -> None:
    """Fold a code object into the hash, identity-free: raw bytecode +
    global/attribute names + canonicalized non-code constants (nested
    code objects recurse — their repr embeds a memory address and must
    never be hashed). Local variable names (``co_varnames``) are
    deliberately NOT hashed: bytecode addresses locals by slot, so a
    pure rename is semantically invisible — and graph-version migration
    relies on renames not moving fingerprints."""
    h.update(code.co_code)
    h.update(repr(code.co_names).encode())
    for const in code.co_consts:
        if hasattr(const, "co_code"):
            _code_fp(const, h)
        else:
            h.update(_const_repr(const).encode())


def _fn_fp(fn: Any, h: "hashlib._Hash") -> None:
    code = getattr(fn, "__code__", None)
    if code is not None:
        _code_fp(code, h)
        h.update(_const_repr(getattr(fn, "__defaults__", None) or ()).encode())
    else:
        h.update(type(fn).__name__.encode())


#: expression attributes that carry structural identity, in hash order
_SALIENT_ATTRS = (
    "_op", "_method", "_method_kwargs", "_value", "name", "_name",
    "_reducer", "_return_type", "_engine_name", "_dtype",
    "_propagate_none", "_deterministic",
)


def expr_fingerprint(expr: Any, h: "hashlib._Hash") -> None:
    """Fold one ColumnExpression tree into the hash: node type, salient
    parameters (operator symbol, method name, constant value, referenced
    column NAME — never table identity), UDF bytecode, and children via
    ``_deps``."""
    h.update(type(expr).__name__.encode())
    for attr in _SALIENT_ATTRS:
        v = getattr(expr, attr, None)
        if v is not None and not hasattr(v, "_deps"):
            h.update(attr.encode())
            if isinstance(v, dict):
                h.update(repr(sorted(
                    (k, _const_repr(x)) for k, x in v.items()
                )).encode())
            else:
                h.update(_const_repr(v).encode())
    fn = getattr(expr, "_fn", None)
    if fn is not None:
        _fn_fp(fn, h)
    for dep in getattr(expr, "_deps", ()):
        expr_fingerprint(dep, h)


def _compiled_fn_fp(fn: Any, h: "hashlib._Hash") -> None:
    """Fingerprint one compiled per-column kernel: prefer the tagged
    source expression (identity-free, survives recompiles); engine-
    internal closures (projections, join-key mixers) hash by bytecode."""
    expr = getattr(fn, "_pw_expr", None)
    if expr is not None:
        expr_fingerprint(expr, h)
        return
    key_fns = getattr(fn, "_pw_key_fns", None)
    if key_fns is not None:
        h.update(b"jk")
        for kf in key_fns:
            _compiled_fn_fp(kf, h)
        return
    _fn_fp(fn, h)


def fingerprint_nodes(nodes: list[Node]) -> dict[int, str]:
    """id(node) -> structural fingerprint hex for every node, computed in
    topological order so each fingerprint folds in its inputs'."""
    order = _topological(nodes)
    fps: dict[int, str] = {}
    for node in order:
        if getattr(node, "FINGERPRINT_TRANSPARENT", False) and node.inputs:
            # Exchange: sharding inserts it, offline lowering doesn't —
            # pass the input's fingerprint through so the manifests a
            # live sharded run and an unsharded `upgrade --plan` compile
            # write agree bit-for-bit
            fps[id(node)] = fps[id(node.inputs[0])]
            continue
        h = hashlib.sha256()
        h.update(type(node).__name__.encode())
        h.update(repr(tuple(node.column_names)).encode())
        try:
            h.update(repr(node.analysis_signature()).encode())
        except Exception:
            pass
        exprs = getattr(node, "analysis_exprs", None)
        if exprs is not None:
            for name, fn in exprs().items():
                h.update(name.encode())
                _compiled_fn_fp(fn, h)
        if isinstance(node, SourceNode):
            pid = getattr(node, "persistent_id", None)
            if pid:
                h.update(str(pid).encode())
        for inp in node.inputs:
            h.update(fps[id(inp)].encode())
        fps[id(node)] = h.hexdigest()[:16]
    return fps


def node_labels(nodes: list[Node]) -> dict[int, str]:
    """id(node) -> stable display label ("<topo index>:<class>") — NOT the
    process-global node_id, which differs between two compiles."""
    order = _topological(nodes)
    return {
        id(n): f"{i}:{type(n).__name__}" for i, n in enumerate(order)
    }
