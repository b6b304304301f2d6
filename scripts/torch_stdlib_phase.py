"""Phase 18 of ``chip_smoke.py`` (the stdlib and SQL: ``pw.ml``'s kNN classifier, ``pw.sql``
over Nexmark, ``pw.graphs``) alone on one card.

    python scripts/torch_stdlib_phase.py [--sql-events 500000] [--scales pagerank=14,...]

The script builds the kernels and the native module, generates phase 17's Nexmark events, then
runs ``chip_smoke.py::run_stdlib`` with leg (b) over the first ``--sql-events`` of them and
leg (c) at the scales given (the others at ``chip_smoke.GRAPH_SCALES``). It logs what the phase
logs and prints the card's name and power limit, then one JSON line: each leg's seconds, rows
and counts, and the launch counts.
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
    ap.add_argument("--sql-events", type=int, default=None)
    ap.add_argument("--scales", default="")
    args = ap.parse_args()
    scales = {k: int(v) for k, v in (p.split("=") for p in args.scales.split(",") if p)}
    sys.path.insert(0, str(ROOT))
    os.environ.setdefault("PATHWAY_KEY_REGISTRY_CAP", str(1 << 25))
    import torch

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    if not torch.cuda.is_available():
        print("torch_stdlib_phase: no CUDA device", file=sys.stderr)
        return 2
    from pathway_tpu_torch import _kernels, native

    native.build()
    _kernels.build_all()
    device = torch.device("cuda")
    card = cs.card_line()
    cs.log(card)
    sql_events = args.sql_events or cs.SQL_EVENTS
    ev = cs.nexmark_events(max(cs.NEXMARK_EVENTS, sql_events))
    out = cs.run_stdlib(device, ev=ev, sql_events=sql_events, graph_scales=scales)
    print(card, flush=True)
    print(json.dumps({"legs": out["legs"], "launches": out["launches"]}, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
