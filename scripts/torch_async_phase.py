"""Phase 16 of ``chip_smoke.py`` (the frontier-driven async plane and ``pw.iterate``) alone on one
card, with ``pw.iterate``'s connected components at one or more graph sizes.

    python scripts/torch_async_phase.py [--cc-scales 1,2] [--skew-reps 3]

The script builds the kernels and the native module, then runs
``chip_smoke.py::run_async_iterate`` at the phase's sizes, and after it (e) again at each further
scale in ``--cc-scales`` (scale s: ``CC_NODES / s`` nodes and ``CC_EDGES / s`` edges), so one call
shows which size fits the phase's 120 s. It logs what the phase logs and prints the card's name
and power limit, then one JSON line: the skew lane's runs, the uniform rates, (c)'s rates and
launches, (d)'s legs with their waves, and (e)'s rounds and seconds at each scale. A run of (e)
past 120 s is logged, not raised, here.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cc-scales", default="1")
    ap.add_argument("--skew-reps", type=int, default=3)
    args = ap.parse_args()
    scales = [int(s) for s in args.cc_scales.split(",")]
    sys.path.insert(0, str(ROOT))
    os.environ.setdefault("PATHWAY_KEY_REGISTRY_CAP", str(1 << 25))
    import torch

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    if not torch.cuda.is_available():
        print("torch_async_phase: no CUDA device", file=sys.stderr)
        return 2
    from pathway_tpu_torch import _kernels, native

    native.build()
    _kernels.build_all()
    device = torch.device("cuda")
    card = cs.card_line()
    cs.log(card)
    cs.ITERATE_BUDGET_S = float("inf")  # sized here: the times are logged, not held
    n, m = cs.CC_NODES // scales[0], cs.CC_EDGES // scales[0]
    out = cs.run_async_iterate(device, cc_nodes=n, cc_edges_n=m, skew_reps=args.skew_reps)
    cc = [{"nodes": n, "edges": m, **out["iterate"]}]
    for scale in scales[1:]:
        n, m = cs.CC_NODES // scale, cs.CC_EDGES // scale
        r = cs.run_iterate_cc(device, n=n, m=m)
        cs.log(f"pw.iterate's connected components over {n} nodes and {m} edges: "
               f"{r['rounds']} rounds in {r['s']:.1f} s [{card}]")
        cc.append({"nodes": n, "edges": m, **r})
    print(card, flush=True)
    print(json.dumps({"skew": out["skew"], "uniform": out["uniform"], "rates": out["rates"],
                      "launches": out["launches"], "wordcount": out["wordcount"],
                      "iterate": cc, "s": out["s"]}, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
