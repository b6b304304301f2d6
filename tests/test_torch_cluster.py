"""The port's multi-process cluster (``pathway_tpu_torch/parallel/cluster.py``, the runner's
``PATHWAY_PROCESSES`` > 1 branch, the command line's ``spawn -n``, the config's address book)
through the JAX package's own cluster cases, on the CPU.

The cases run on the port as written (``tests/torch_case_runs.py``), each ``import pathway_tpu``
bound to ``pathway_tpu_torch``:

- ``tests/test_sharded.py``'s cluster cases: the barrier of four workers in two processes, the
  groupby + join program under ``spawn -n 2 -t 2`` against its one-worker run, the address
  book, its parsing and the config's validation, the cluster formed from an address book, and
  ``spawn``'s rejections;
- ``tests/test_wire_frames.py``'s ``ClusterComm`` cases without a fault plan: a Delta exchange
  over the sockets with the comm's counters, torn wire bytes named by their origin, and the
  writer queue's bound;
- ``tests/test_failure_propagation.py``'s cases without a fault plan: a dead peer fails every
  blocked collective within a second and names itself, the collective and connect timeouts.

On the port's side each program a case writes or spawns names the port (``pw.run(device="cpu")``,
``-m pathway_tpu_torch.cli``), ``click.testing.CliRunner`` is the shim over the port's
``main(argv)``, and each case's ``_free_port`` takes a block below the ephemeral range
(``tests/torch_ports.py``), where the reference's smokes never bind. ``LEFT_OUT`` gives each
case of those modules left out, with its reason. Each spawned run has the case's own timeout.

Tolerance: none. Tables and messages are compared as the cases compare them.
"""

from __future__ import annotations

import os

import pytest

from torch_case_runs import TESTS, Side, case_args, cases, run_case
from torch_ports import free_port

PORT = "pathway_tpu_torch"

MODULES = ["test_sharded", "test_wire_frames", "test_failure_propagation"]

#: the cases of MODULES not run here, with the reason
_CHAOS = "arms a fault plan (chaos/ is not ported)"
LEFT_OUT = {
    **{name: "no cluster: tests/test_torch_engine.py holds the threaded runs"
       for _, name in cases(["test_sharded"])
       if name.startswith(("test_sharded_thread_parity", "test_mesh_exchange",
                            "test_sharded_results"))},
    "test_multihost_mesh_exchange_parity":
        "jax.distributed's device collective, which the reference skips on this host; "
        "tests/test_torch_cluster_runs.py holds the port's MultiHostMeshComm",
    "test_chaos_corrupt_action_fires_on_pipelined_path": _CHAOS,
    "test_sever_fault_partitions_the_mesh": _CHAOS,
    **{name: "no cluster: the frame codec (tests/test_torch_frames.py holds it)"
       for _, name in cases(["test_wire_frames"])
       if name.startswith(("test_roundtrip", "test_dense_columns", "test_truncated",
                           "test_header_corruption", "test_localcomm"))},
}

_PROGRAM = {
    "import pathway_tpu as pw\nfrom pathway_tpu.testing import T, _norm":
        "import pathway_tpu_torch as pw\nfrom pathway_tpu_torch.testing import T, _norm",
    "pw.run()\nrows = ": 'pw.run(device="cpu")\nrows = ',
    '"-m", "pathway_tpu.cli"': '"-m", "pathway_tpu_torch.cli"',
    "from click.testing import CliRunner": "from torch_case_runs import PortCliRunner as CliRunner",
}
REWRITES = {"test_sharded": _PROGRAM, "test_wire_frames": {}, "test_failure_propagation": {}}
CASES = [c for c in cases(MODULES) if c[1] not in LEFT_OUT]


def test_no_reference_case_is_left_out_without_a_reason():
    names = {n for _, n in cases(MODULES)}
    assert set(LEFT_OUT) <= names
    assert len(CASES) == len(names) - len(LEFT_OUT) == 15


@pytest.mark.parametrize("module,name", CASES, ids=[n for _, n in CASES])
def test_reference_case(module, name, tmp_path, monkeypatch):
    args = case_args(module, name)
    side = Side(PORT)

    def prepare(env):
        env["_free_port"] = free_port
        return {}

    with open(os.path.join(TESTS, f"{module}.py")) as f:
        source = f.read()
    fixtures = {"tmp_path": tmp_path, "monkeypatch": monkeypatch}
    run_case(module, name, side, prepare=prepare,
             rewrite={k: v for k, v in REWRITES[module].items() if k in source},
             **{k: v for k, v in fixtures.items() if k in args})
