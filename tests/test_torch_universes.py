"""``pw.universes`` and the root names ``BaseCustomAccumulator``, ``PyObjectWrapper``,
``PathwayConfig``, ``get_pathway_config`` and ``MonitoringLevel`` of the port against the JAX
package's, on the CPU.

- The cases of ``tests/test_universes_slice.py`` and the reference's tests that reach these names
  through ``pw.`` (``test_joins.py::test_concat_and_update_rows``, ``test_ported_reducers.py``,
  ``test_groupby.py::test_custom_accumulator``, ``test_ported_py_object_wrapper.py`` and
  ``test_ops_surface.py::test_universes_promises``), each run through both packages
  (``tests/torch_case_runs.py``). Each case's own assertions hold in both, and every table it
  computes is equal, row key by row key.
- A ``concat`` that the port refused, naming ``pw.universes.promise_are_pairwise_disjoint``, runs
  once that promise is made, and gives the reference's table.

Tolerance: none.
"""

from __future__ import annotations

import pytest

import pathway_tpu as rpw
import pathway_tpu_torch as tpw
from torch_case_runs import Side, cases, run_case

CASES = cases(["test_universes_slice", "test_ported_reducers",
               "test_ported_py_object_wrapper"]) + [
    ("test_joins", "test_concat_and_update_rows"),
    ("test_groupby", "test_custom_accumulator"),
    ("test_ops_surface", "test_universes_promises"),
]

# cases that check only build-time behaviour, a raise, dtypes or values outside a table
_NO_TABLE = {"test_solver_subset_transitivity_and_equality",
             "test_solver_disjointness_propagates_to_subsets",
             "test_solver_intersection_difference", "test_proven_concat_is_stateless_passthrough",
             "test_concat_runtime_collision_detection",
             "test_concat_key_migration_within_tick_not_flagged",
             "test_table_slice_rename_dict_and_getitem_list",
             "test_dtypes", "test_serialization_pickle", "test_copy_deepcopy"}


@pytest.fixture(autouse=True)
def _clean_graphs():
    rpw.G.clear()
    tpw.G.clear()
    yield
    rpw.G.clear()
    tpw.G.clear()


@pytest.mark.parametrize("module,name", CASES, ids=[f"{m}::{n}" for m, n in CASES])
def test_reference_case_through_both_packages(module, name):
    want = run_case(module, name, Side("pathway_tpu"))
    got = run_case(module, name, Side("pathway_tpu_torch"))
    assert got == want
    assert want or name in _NO_TABLE, "the case computed no table"


def _pair(pw):
    t1 = pw.debug.table_from_markdown("id | a\n1 | 1\n2 | 2")
    t2 = pw.debug.table_from_markdown("id | a\n3 | 3\n4 | 4")
    return t1, t2


def test_concat_refused_until_promised():
    t1, t2 = _pair(tpw)
    with pytest.raises(ValueError, match="pw.universes.promise_are_pairwise_disjoint"):
        t1.concat(t2)
    tpw.universes.promise_are_pairwise_disjoint(t1, t2)
    got = Side("pathway_tpu_torch")
    got._table_to_dicts(t1.concat(t2))

    r1, r2 = _pair(rpw)
    rpw.universes.promise_are_pairwise_disjoint(r1, r2)
    want = Side("pathway_tpu")
    want._table_to_dicts(r1.concat(r2))
    assert got.tables == want.tables
    assert sorted(r for r, in got.tables[0].values()) == [1, 2, 3, 4]


def test_root_names_match_the_reference():
    for name in ("NONE", "IN_OUT", "ALL", "AUTO", "AUTO_ALL"):
        assert getattr(tpw.MonitoringLevel, name) == getattr(rpw.MonitoringLevel, name)
    assert sorted(tpw.universes.__all__) == sorted(rpw.universes.__all__)
    cfg, ref = tpw.get_pathway_config(), rpw.get_pathway_config()
    assert isinstance(cfg, tpw.PathwayConfig)
    assert (cfg.threads, cfg.processes, cfg.total_workers) == (
        ref.threads, ref.processes, ref.total_workers)
    from pathway_tpu_torch.internals.custom_reducers import BaseCustomAccumulator

    assert tpw.BaseCustomAccumulator is BaseCustomAccumulator
    assert tpw.PyObjectWrapper(3).value == rpw.PyObjectWrapper(3).value
