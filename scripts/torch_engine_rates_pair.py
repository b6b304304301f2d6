"""Time the engine's and the Table API's host-bound runs of checkouts on one card, in turns.

    python scripts/torch_engine_rates_pair.py TREE [TREE ...]

Each TREE is the root of a checkout that holds ``chip_smoke.py`` and ``pathway_tpu_torch`` (``.``
for this one). Every TREE runs in a process of its own, in the order given, so that ``A B B A``
pairs two versions within one call on one card, where the host's speed moves less than between
calls. A process imports that tree's ``chip_smoke.py`` and runs, at the sizes its phases use:

- the Table API pipeline through ``pw.run(device="cuda")`` at 1 worker, with the lifted lambda
  and written out (``run_pipeline``: 4,194,304 rows in 64 commits of 65,536 over 65,536 groups);
- the dense groupby-join at 8 workers over ``MeshComm`` (``dense_graph``, ``run_workers``:
  4,194,304 rows in commits of 65,536), with the mesh exchange's host counters (pack, upload,
  kernel, readback).

Each pipeline's table is held against ``pipeline_reference`` (numpy), the join's against its
group and row totals. Prints one JSON line a process (rows/s of each run and the mesh counters);
the card's name and power limit come first.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

ROWS, COMMIT, GROUPS, WORKERS = 1 << 22, 1 << 16, 1 << 16, 8


def child(tree: str) -> None:
    root = Path(tree).resolve()
    sys.path.insert(0, str(root))
    # the two phases' distinct keys pass the key registry's default cap, as in chip_smoke.py
    os.environ.setdefault("PATHWAY_KEY_REGISTRY_CAP", str(1 << 25))
    import importlib.util

    import torch

    spec = importlib.util.spec_from_file_location("chip_smoke", root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    device = torch.device("cuda")
    out: dict = {"tree": tree}
    cols = cs.pipeline_columns(ROWS, GROUPS)
    want = cs.pipeline_reference(cols)
    for label, lifted in (("table_api_1", True), ("table_api_chain_1", False)):
        got, sec = cs.run_pipeline(device, cols, COMMIT, GROUPS, 1, lifted)
        if got != want:
            raise AssertionError(f"{label}: the table differs from the numpy computation")
        out[label] = ROWS / sec
    cap, sec, stats = cs.run_workers(cs.dense_graph(ROWS, GROUPS, COMMIT), WORKERS, True, device)
    table = cs.table(cap)
    if len(table) != GROUPS or sum(r[3] for _, r in table) != ROWS:
        raise AssertionError("dense groupby-join: the table does not cover every group and row")
    out[f"dense_{WORKERS}_mesh"] = ROWS / sec
    out["mesh"] = {k: v for k, v in stats.items() if k.startswith("mesh_")}
    print(json.dumps(out), flush=True)


def main(trees: list[str]) -> int:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    for tree in trees:
        subprocess.run([sys.executable, __file__, "--child", tree], check=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        child(sys.argv[2])
        sys.exit(0)
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1:]))
