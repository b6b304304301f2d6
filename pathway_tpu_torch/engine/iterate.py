"""Fixpoint iteration operator (``pw.iterate``).

Re-design of the reference's nested-scope iteration (``dataflow.rs:3737`` —
a differential ``Variable`` with ``Product<Timestamp, u32>`` timestamps
iterated until no diffs; Python side ``internals/operator.py:316``
IterateOperator). The TPU engine runs iteration as a *host-driven fixpoint
loop* over a composite node: on any input change the node re-runs the inner
subgraph — rebuilt each round from static snapshots of the iterated state —
until the fed-back tables stop changing, then emits output diffs vs. what it
previously emitted. Inner subgraph compute runs on the engine's columnar
operators (and the expression machine past its gates), so the per-round cost
is batched column work, not Python row loops.

The node is gather-routed (``exchange_specs``: every input to worker 0), so
its state is ``RESHARD = "pinned"``: under a rescale the base class's
``split_state`` hands every destination the piece unchanged and
``merge_states`` keeps source worker 0's piece.

Under the async plane the gathered inputs of one commit reach worker 0 at
different sweeps (an input derived through an exchange lags the raw one), so
an inner run can see a probe of the body's strict ``ix`` ahead of its indexed
row. As ``IxStrictCheck`` withholds such a probe until its frontier closes,
the node withholds that round's output there and retries on the next input; a
round still dangling when the outer stream ends raises
(``operators.DanglingPointerError``). Outside the async loop every input of a
tick has arrived, and such a round raises at once. (The reference raises on the
first such round under the async plane too: ``ROADMAP.md`` Queue 3, "Not port
faults".)

Copy of ``pathway_tpu/engine/iterate.py``.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np

from .delta import Delta, rows_equal, rows_to_columns
from .executor import Node
from .operators import DanglingPointerError, holds_dangling
from .state import RowState

__all__ = ["Iterate", "IterateOutput", "states_equal"]


def states_equal(a: dict[int, tuple], b: dict[int, tuple]) -> bool:
    if len(a) != len(b):
        return False
    for k, row in a.items():
        other = b.get(k)
        if other is None and k not in b:
            return False
        if not rows_equal(row, other):
            return False
    return True


def state_to_delta(
    state: dict[int, tuple], columns: list[str], diff: int = 1
) -> Delta:
    keys = np.fromiter(state.keys(), dtype=np.uint64, count=len(state))
    data = rows_to_columns(list(state.values()), columns)
    diffs = np.full(len(state), diff, dtype=np.int64)
    return Delta(keys=keys, data=data, diffs=diffs)


class Iterate(Node):
    """Composite fixpoint node.

    ``driver`` receives ``{name: {key: row}}`` snapshots of every input table
    and returns ``{name: {key: row}}`` for every output table (it owns the
    inner fixpoint loop — see ``internals/iterate.py``).
    """

    def __init__(
        self,
        inputs: list[Node],
        input_names: list[str],
        driver: Callable[[dict[str, dict[int, tuple]]], dict[str, dict[int, tuple]]],
        out_specs: dict[str, list[str]],
    ):
        super().__init__(inputs, ["__tick__"])
        self._input_names = input_names
        self._driver = driver
        self._in_state = {
            name: RowState(node.column_names)
            for name, node in zip(input_names, inputs)
        }
        self._out_last: dict[str, dict[int, tuple]] = {n: {} for n in out_specs}
        self.pending: dict[str, Delta] = {}
        self.out_specs = out_specs
        self._dangling: DanglingPointerError | None = None

    # pending is transient (drained by IterateOutput within the same tick);
    # only the input mirror and last-emitted outputs are durable
    STATE_FIELDS = ("_in_state", "_out_last")

    RESHARD = "pinned"  # gather-routed composite: state lives on worker 0
    _ctx = None  # the sharded run's context (``on_shard``); None on one worker

    def on_shard(self, ctx) -> None:
        self._ctx = ctx

    def exchange_specs(self):
        # the inner fixpoint is a single-worker composite: gather inputs to
        # worker 0 (downstream stateful ops re-shard its outputs)
        return [("gather",) for _ in self.inputs]

    def process(self, time: int, ins: list[Delta | None]) -> Delta | None:
        changed = False
        for port, d in enumerate(ins):
            if d is not None and len(d):
                self._in_state[self._input_names[port]].apply(d.consolidated())
                changed = True
        if not changed:
            return None
        snapshots = {
            name: {k: st._rows[k] for k in st._rows if k in st}
            for name, st in self._in_state.items()
        }
        try:
            results = self._driver(snapshots)
        except DanglingPointerError as e:
            if not holds_dangling(self._ctx):
                raise
            self._dangling = e  # held until more input arrives, or raised at the end
            return None
        self._dangling = None
        emitted_any = False
        for name, cols in self.out_specs.items():
            new = results[name]
            old = self._out_last[name]
            out_keys: list[int] = []
            out_rows: list[tuple] = []
            out_diffs: list[int] = []
            for k, row in old.items():
                nrow = new.get(k)
                if (nrow is None and k not in new) or not rows_equal(row, nrow):
                    out_keys.append(k)
                    out_rows.append(row)
                    out_diffs.append(-1)
            for k, row in new.items():
                orow = old.get(k)
                if (orow is None and k not in old) or not rows_equal(row, orow):
                    out_keys.append(k)
                    out_rows.append(row)
                    out_diffs.append(1)
            if out_keys:
                self.pending[name] = Delta(
                    keys=np.asarray(out_keys, dtype=np.uint64),
                    data=rows_to_columns(out_rows, cols),
                    diffs=np.asarray(out_diffs, dtype=np.int64),
                )
                emitted_any = True
            self._out_last[name] = new
        if not emitted_any:
            return None
        # marker delta: wakes downstream IterateOutput nodes this tick
        return Delta(
            keys=np.asarray([0], dtype=np.uint64),
            data={"__tick__": np.asarray([int(time)], dtype=object)},
            diffs=np.asarray([1], dtype=np.int64),
        )

    def on_end(self) -> Delta | None:
        if self._dangling is not None:
            raise self._dangling
        return None


class IterateOutput(Node):
    """Reads one named output of an Iterate node."""

    def __init__(self, parent: Iterate, name: str):
        super().__init__([parent], parent.out_specs[name])
        self._parent = parent
        self._name = name

    def process(self, time: int, ins: list[Delta | None]) -> Delta | None:
        return self._parent.pending.pop(self._name, None)
