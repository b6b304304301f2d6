"""``pw.sql`` and the row transformers (``pw.transformer``, ``pw.ClassArg`` and the attribute
markers) of the port against the JAX package's, on the CPU.

- The cases of ``tests/test_ported_sql.py``, ``test_sql.py`` and ``test_transformers.py``, and
  ``test_ported_common_3.py``'s ``collatz_transformer`` case, each run through both packages
  (``tests/torch_case_runs.py``). Each case's own assertions hold in both, and every table it
  computes is equal, row key by row key. The cases that only check a parse or build error compute
  no table.
- Streaming programs over python subjects of seeded numpy rows, a commit a batch, with
  retractions: a ``pw.sql`` join with ``GROUP BY`` and ``HAVING``, numeric ``WHERE`` and
  ``SELECT`` expressions, and a pointer-chasing row transformer over static nodes and over
  streamed ones. At 1 worker the port's table equals the reference's; at 2 and 4 workers (async,
  the default) and at 2 under BSP (``PATHWAY_ASYNC_EXEC=0``) it equals the reference's 1-worker
  table (for streamed nodes, the static nodes' table).

Tolerance: none. Floats are multiples of a power of two, so sums are exact in any order.
"""

from __future__ import annotations

import numpy as np
import pytest

from torch_case_runs import Side, cases, run_case
from torch_state_runs import (PACKAGES, final_table, held_open_feed, keyed_feed as _feed,
                              raises_before_the_stream_ends)

CASES = cases(["test_ported_sql", "test_sql", "test_transformers"])
CASES.append(("test_ported_common_3", "test_column_fixpoint"))

# cases that only check a parse or build error
_NO_TABLE = {"test_having_without_group_errors", "test_duplicate_clause_errors",
             "test_qualified_star_after_join_expands_one_side", "test_method_markers_refused",
             "test_call_signature_validation", "test_input_only_class_error_is_helpful",
             "test_output_attribute_rename_non_decorator"}


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in ("PATHWAY_ASYNC_EXEC", "PATHWAY_MESH_EXCHANGE", "PATHWAY_FUSION"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("PATHWAY_THREADS", "1")


@pytest.mark.parametrize("module,name", CASES, ids=[f"{m}::{n}" for m, n in CASES])
def test_reference_case_through_both_packages(module, name):
    want = run_case(module, name, Side("pathway_tpu"))
    got = run_case(module, name, Side("pathway_tpu_torch"))
    assert got == want
    assert bool(want) != (name in _NO_TABLE)


# -- streaming programs ------------------------------------------------------------------------


def _batches(n: int, seed: int, n_keys: int) -> list:
    """``n`` rows (``i``, ``k`` in [0, n_keys), ``v`` a multiple of 0.25) in 5 commits, then a
    commit retracting every 9th."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, n_keys, n)
    v = rng.integers(-40, 400, n) / 4.0

    def cols(idx):
        return {"i": idx.tolist(), "k": k[idx].tolist(), "v": v[idx].tolist()}

    idx = np.arange(n)
    return [(cols(part), 1) for part in np.array_split(idx, 5)] + [(cols(idx[::9]), -1)]


ORDERS = _batches(200, 11, 12)
ITEMS = _batches(90, 12, 15)


def _sql_join_group_having(pw):
    orders = _feed(pw, ORDERS, i=int, k=int, v=float)
    items = _feed(pw, ITEMS, i=int, k=int, v=float)
    return pw.sql(
        "SELECT O.k, COUNT(*) AS n, SUM(O.v + I.v) AS s, MAX(I.v) AS top "
        "FROM orders AS O JOIN items AS I ON O.k = I.k "
        "WHERE O.v > 0 GROUP BY O.k HAVING COUNT(*) > 3",
        orders=orders, items=items)


def _sql_numeric(pw):
    orders = _feed(pw, ORDERS, i=int, k=int, v=float)
    return pw.sql("SELECT i, k * 3 + 7 AS a, v * 0.5 - 1.0 AS b FROM orders "
                  "WHERE k % 4 = 1 AND v < 80.0", orders=orders)


NODES = {"i": list(range(24)), "nxt": [(3 * j + 5) % 24 for j in range(24)],
         "val": [j * j for j in range(24)]}


def _pointer_chasing(pw, streamed_nodes: bool = False):
    @pw.transformer
    class list_traversal:
        class nodes(pw.ClassArg):
            next = pw.input_attribute()
            val = pw.input_attribute()

        class requests(pw.ClassArg):
            node = pw.input_attribute()
            steps = pw.input_attribute()

            @pw.output_attribute
            def reached_value(self) -> int:
                node = self.transformer.nodes[self.node]
                for _ in range(self.steps):
                    node = self.transformer.nodes[node.next]
                return node.val

    if streamed_nodes:  # they may come after the requests that point at them
        raw = _feed(pw, [(NODES, 1)], i=int, nxt=int, val=int)
    else:  # static: in before the first request
        raw = pw.debug.table_from_rows(pw.schema_from_types(i=int, nxt=int, val=int),
                                       list(zip(*NODES.values())))
        raw = raw.with_id_from(raw.i)
    nodes = raw.select(next=raw.pointer_from(raw.nxt), val=raw.val)
    req_rows = [({"i": list(range(s, s + 10)), "node": [(7 * j) % 24 for j in range(s, s + 10)],
                  "steps": [j % 6 for j in range(s, s + 10)]}, 1) for s in range(0, 40, 10)]
    req_rows.append(({"i": [4, 17], "node": [4 * 7 % 24, 17 * 7 % 24], "steps": [4, 5]}, -1))
    req = _feed(pw, req_rows, i=int, node=int, steps=int)
    requests = req.select(node=raw.pointer_from(req.node), steps=req.steps)
    return list_traversal(nodes, requests).requests


PROGRAMS = {"sql_join_group_having": _sql_join_group_having, "sql_numeric": _sql_numeric,
            "pointer_chasing": _pointer_chasing,
            "pointer_chasing_streamed_nodes": lambda pw: _pointer_chasing(pw, True)}
# A request can arrive ahead of the nodes it points at: the reference raises then ("no row ...
# in transformer table", ROADMAP.md Queue 3, "Not port faults"), where the port holds the class
# until the nodes come. The streamed-nodes program is held to the static one's reference table.
_REFERENCE_PROGRAM = {"pointer_chasing_streamed_nodes": "pointer_chasing"}

_REFERENCE: dict[str, dict] = {}


def _reference_one_worker(prog: str, monkeypatch) -> dict:
    prog = _REFERENCE_PROGRAM.get(prog, prog)
    if prog not in _REFERENCE:
        _REFERENCE[prog] = final_table("pathway_tpu", PROGRAMS[prog], monkeypatch)
    return _REFERENCE[prog]


@pytest.mark.parametrize("prog", list(PROGRAMS))
def test_streaming_one_worker(monkeypatch, prog):
    want = _reference_one_worker(prog, monkeypatch)
    assert want
    assert final_table("pathway_tpu_torch", PROGRAMS[prog], monkeypatch) == want


@pytest.mark.parametrize("workers,async_exec", [(2, None), (4, None), (2, "0")],
                         ids=["2-async", "4-async", "2-bsp"])
@pytest.mark.parametrize("prog", list(PROGRAMS))
def test_streaming_sharded_equals_the_reference_one_worker(monkeypatch, prog, workers,
                                                           async_exec):
    want = _reference_one_worker(prog, monkeypatch)
    got = final_table("pathway_tpu_torch", PROGRAMS[prog], monkeypatch, workers, async_exec)
    assert got == want


def test_sql_join_group_having_equals_numpy(monkeypatch):
    """The streamed join's groups against a plain count over the rows that stay."""
    got = final_table("pathway_tpu_torch", _sql_join_group_having, monkeypatch)

    def live(batches):
        rows = {}
        for cols, diff in batches:
            for i, k, v in zip(cols["i"], cols["k"], cols["v"]):
                if diff > 0:
                    rows[i] = (k, v)
                else:
                    del rows[i]
        return list(rows.values())

    want = {}
    for ok, ov in live(ORDERS):
        if ov <= 0:
            continue
        for ik, iv in live(ITEMS):
            if ik == ok:
                n, s, top = want.get(ok, (0, 0.0, -np.inf))
                want[ok] = (n + 1, s + ov + iv, max(top, iv))
    want = sorted((k, n, s, top) for k, (n, s, top) in want.items() if n > 3)
    assert sorted(got.values()) == want
    assert want


def test_a_dangling_transformer_pointer_still_raises():
    """The port's ``GroupedRecompute`` holds a class whose lookup misses a row, for the rows that
    the async plane brings late; a pointer still dangling when the stream ends raises as in the
    reference."""
    for pkg in ("pathway_tpu", "pathway_tpu_torch"):
        side = Side(pkg)
        pw = side.pw
        pw.G.clear()

        @pw.transformer
        class follow:
            class nodes(pw.ClassArg):
                val = pw.input_attribute()

            class requests(pw.ClassArg):
                node = pw.input_attribute()

                @pw.output_attribute
                def reached(self) -> int:
                    return self.transformer.nodes[self.node].val

        raw = pw.debug.table_from_rows(pw.schema_from_types(k=int, val=int), [(1, 10), (2, 20)])
        nodes = raw.with_id_from(raw.k).select(val=pw.this.val)
        req = pw.debug.table_from_rows(pw.schema_from_types(node=int), [(2,), (7,)])
        out = follow(nodes, req.select(node=raw.pointer_from(req.node))).requests
        try:
            with pytest.raises(KeyError, match="no row"):
                side.run_table(out)
        finally:
            pw.G.clear()


def _follow(pw, requests):
    @pw.transformer
    class follow:
        class nodes(pw.ClassArg):
            val = pw.input_attribute()

        class requests(pw.ClassArg):
            node = pw.input_attribute()

            @pw.output_attribute
            def reached(self) -> int:
                return self.transformer.nodes[self.node].val

    raw = pw.debug.table_from_rows(pw.schema_from_types(k=int, val=int), [(1, 10), (2, 20)])
    nodes = raw.with_id_from(raw.k).select(val=pw.this.val)
    return follow(nodes, requests.select(node=raw.pointer_from(requests.node))).requests


@pytest.mark.parametrize("pkg", PACKAGES)
def test_a_dangling_transformer_pointer_raises_at_once_on_one_worker(pkg):
    """Outside the async plane every input of a tick has arrived, so the port's
    ``GroupedRecompute`` raises a dangling lookup in the tick that made it, as the reference
    does, and does not wait for the stream to end."""
    raises_before_the_stream_ends(
        pkg, lambda pw: _follow(pw, held_open_feed(pw, {"i": [0, 1], "node": [2, 7]},
                                                   i=int, node=int)), "no row")
