"""Phases 23 and 24 of ``chip_smoke.py`` (the mesh step with the dry run, and the cluster) alone
on one card.

    python scripts/torch_cluster_phase.py [--commits N]

The script builds the kernels and the native module, initialises the world-1 NCCL group, runs
``chip_smoke.py::run_mesh_step`` (the mesh step at phase 5's full width against the one-device
step, its kernels held, its launches counted and its step timed beside the one-device step's)
and ``run_dryrun`` (``graft_entry``'s forward and ``dryrun_multichip(1)``), then
``run_cluster`` (the chain under ``spawn -n 2 -t 2``, over ``ClusterComm`` and over
``MultiHostMeshComm``, at once). It logs what the phases log and prints the card's name and power
limit, then one JSON line: the phases' numbers and launch counts.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--commits", type=int, default=64)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    os.environ.setdefault("PATHWAY_KEY_REGISTRY_CAP", str(1 << 25))
    import torch

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs
    spec.loader.exec_module(cs)
    if not torch.cuda.is_available():
        print("torch_cluster_phase: no CUDA device", file=sys.stderr)
        return 2
    from pathway_tpu_torch import _kernels, native
    from pathway_tpu_torch.parallel.distributed import init_from_env

    native.build()
    _kernels.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    device = torch.device("cuda")
    card = cs.card_line()
    cs.log(card)
    init_from_env(device="cuda")
    t0 = time.perf_counter()
    mesh = cs.run_mesh_step(device)
    torch.cuda.empty_cache()
    dry = cs.run_dryrun(device)
    mesh_s = time.perf_counter() - t0
    torch.distributed.destroy_process_group()
    torch.cuda.empty_cache()
    cluster = cs.run_cluster(device, commits=args.commits)
    print(card, flush=True)
    print(json.dumps({
        "mesh_s": mesh_s, "step_ms": mesh["step_ms"], "one_device_ms": mesh["one_device_ms"],
        "diffs": mesh["diffs"], "errs": {**mesh["errs"], **{f"dryrun_{k}": v
                                                             for k, v in dry["errs"].items()}},
        "launches": {"mesh_step": mesh["launches"], "dryrun": dry["launches"],
                     **cluster["launches"]},
        "cluster_s": cluster["s"],
        "arms": {a: {k: v for k, v in x.items() if k not in ("launches", "held")}
                 for a, x in cluster["arms"].items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
