"""``pw.iterate`` — declarative fixpoint iteration.

Re-design of the reference's ``pw.iterate`` (``internals/operator.py:316``
IterateOperator; engine side ``dataflow.rs:3737-4222`` — nested differential
scope with ``Product<Timestamp, u32>`` timestamps and a feedback Variable).

The user passes a graph-building function and the tables it iterates over;
the function is traced **once** at parse time against placeholder tables to
capture the inner subgraph. Execution is a host-driven loop (engine
``Iterate`` node): each round lowers the captured subgraph with the current
iterated state as static sources, runs it on the outer run's device (every
dense numeric expression past its gate on the expression machine), and feeds
outputs whose names match inputs back in, until nothing changes or
``iteration_limit`` rounds have run.

Copy of ``pathway_tpu/internals/iterate.py``; the inner runs take the device
of the runner that lowered the ``Iterate`` node.
"""

from __future__ import annotations

import functools
from typing import Any, Callable

import numpy as np

from ..engine import operators as ops
from ..engine.delta import rows_to_columns
from ..engine.iterate import Iterate, IterateOutput, states_equal
from .parse_graph import Universe
from .table import Table

__all__ = ["iterate", "iterate_universe"]


def iterate_universe(table: "Table") -> "Table":
    """Marker for iterated tables whose key set changes between rounds
    (reference ``pw.iterate_universe``). The TPU engine rebuilds iterated
    state from snapshots every round, so changing universes need no special
    handling — this is an identity passthrough kept for API parity."""
    return table


class _IterateDescriptor:
    def __init__(
        self,
        inputs: dict[str, Table],
        placeholders: dict[str, Table],
        outputs: dict[str, Table],
        feedback: list[str],
        iteration_limit: int | None,
    ):
        self.inputs = inputs
        self.placeholders = placeholders
        self.outputs = outputs
        self.feedback = feedback
        self.limit = iteration_limit
        # column permutation for feeding an output back into its input slot
        self._fb_perm: dict[str, list[int]] = {}
        for name in feedback:
            in_cols = inputs[name].column_names()
            out_cols = outputs[name].column_names()
            if set(in_cols) != set(out_cols):
                raise ValueError(
                    f"pw.iterate: output {name!r} columns {out_cols} do not "
                    f"match the iterated input's columns {in_cols}"
                )
            self._fb_perm[name] = [out_cols.index(c) for c in in_cols]

    # -- execution-time driver --------------------------------------------

    def driver(
        self, snapshots: dict[str, dict[int, tuple]], device: Any = "cuda"
    ) -> dict[str, dict[int, tuple]]:
        cur = {name: snapshots[name] for name in self.inputs}
        rounds = 0
        while True:
            rounds += 1
            out_states = self._run_once(cur, device)
            changed = False
            for name in self.feedback:
                perm = self._fb_perm[name]
                fb = {
                    k: tuple(row[j] for j in perm)
                    for k, row in out_states[name].items()
                }
                if not states_equal(fb, cur[name]):
                    cur[name] = fb
                    changed = True
            if not changed:
                break
            if self.limit is not None and rounds >= self.limit:
                break
        return out_states

    def _run_once(
        self, cur: dict[str, dict[int, tuple]], device: Any
    ) -> dict[str, dict[int, tuple]]:
        from .graph_runner import GraphRunner

        runner = GraphRunner(device)
        for name, ph in self.placeholders.items():
            state = cur[name]
            keys = np.fromiter(state.keys(), dtype=np.uint64, count=len(state))
            data = rows_to_columns(
                list(state.values()), self.inputs[name].column_names()
            )
            runner._cache[id(ph)] = runner._add(ops.StaticSource(keys, data))
        caps = runner.run_tables(*self.outputs.values())
        return {
            name: dict(cap.state._rows)
            for name, cap in zip(self.outputs, caps)
        }

    # -- lowering ----------------------------------------------------------

    def lower_output(self, runner: Any, name: str):
        registry = getattr(runner, "_iterate_nodes", None)
        if registry is None:
            registry = {}
            runner._iterate_nodes = registry
        node = registry.get(id(self))
        if node is None:
            in_nodes = [
                runner._project(runner.lower(t), t, t.column_names())
                for t in self.inputs.values()
            ]
            node = runner._add(
                Iterate(
                    in_nodes,
                    list(self.inputs),
                    functools.partial(self.driver, device=runner.device),
                    {n: t.column_names() for n, t in self.outputs.items()},
                )
            )
            registry[id(self)] = node
        return runner._add(IterateOutput(node, name))


def iterate(
    func: Callable[..., Any],
    iteration_limit: int | None = None,
    **kwargs: Any,
):
    """Iterate ``func`` to fixpoint over the given tables.

    ``func`` is called once with placeholder tables to build the inner
    subgraph; outputs whose names match input keyword names are fed back each
    round. Returns table(s) of the same shape as ``func``'s return value
    (single Table, dict, or namedtuple of tables).
    """
    if iteration_limit is not None and iteration_limit < 1:
        raise ValueError("wrong value of iteration_limit")
    table_inputs = {
        name: v for name, v in kwargs.items() if isinstance(v, Table)
    }
    if not table_inputs:
        raise ValueError("pw.iterate needs at least one Table argument")
    placeholders = {
        name: Table("iter_pin", [], {"name": name}, t.schema, Universe())
        for name, t in table_inputs.items()
    }
    call_kwargs = dict(kwargs)
    call_kwargs.update(placeholders)
    result = func(**call_kwargs)

    single = isinstance(result, Table)
    if single:
        # a lone returned table iterates with the first table argument
        out_map = {next(iter(table_inputs)): result}
    elif isinstance(result, dict):
        out_map = dict(result)
    elif hasattr(result, "_asdict"):
        out_map = dict(result._asdict())
    else:
        raise TypeError(
            "pw.iterate function must return a Table, a dict of tables, or a "
            f"namedtuple of tables; got {type(result)!r}"
        )
    for name, t in out_map.items():
        if not isinstance(t, Table):
            raise TypeError(f"pw.iterate output {name!r} is not a Table")

    feedback = [n for n in out_map if n in table_inputs]
    desc = _IterateDescriptor(
        table_inputs, placeholders, out_map, feedback, iteration_limit
    )

    def make_output(name: str, t: Table) -> Table:
        return Table(
            "custom",
            list(table_inputs.values()),
            {"lower": (lambda runner, _table, n=name: desc.lower_output(runner, n))},
            t.schema,
            Universe(),
        )

    outer = {name: make_output(name, t) for name, t in out_map.items()}
    if single:
        return next(iter(outer.values()))
    if isinstance(result, dict):
        return outer
    return type(result)(**outer)
