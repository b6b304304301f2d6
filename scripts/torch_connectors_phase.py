"""Phase 19 of ``chip_smoke.py`` (the connectors over Nexmark: SQLite CDC, Delta Lake and
Debezium) alone on one card.

    python scripts/torch_connectors_phase.py [--legs sqlite=N,delta=N,debezium=N]

The script builds the kernels and the native module, generates phase 17's Nexmark events, then
runs ``chip_smoke.py::run_connectors`` with each leg over the bids of the first N events given
(the others at ``chip_smoke.CONNECTOR_LEG_EVENTS``). It logs what the phase logs and prints the
card's name and power limit, then one JSON line: each leg's seconds, rows and rows/s, and the
launch counts.
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
    ap.add_argument("--legs", default="")
    args = ap.parse_args()
    legs = {k: int(v) for k, v in (p.split("=") for p in args.legs.split(",") if p)}
    sys.path.insert(0, str(ROOT))
    os.environ.setdefault("PATHWAY_KEY_REGISTRY_CAP", str(1 << 25))
    import torch

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    if not torch.cuda.is_available():
        print("torch_connectors_phase: no CUDA device", file=sys.stderr)
        return 2
    from pathway_tpu_torch import _kernels, native

    native.build()
    _kernels.build_all()
    device = torch.device("cuda")
    card = cs.card_line()
    cs.log(card)
    sizes = {**cs.CONNECTOR_LEG_EVENTS, **legs}
    ev = cs.nexmark_events(max(cs.NEXMARK_EVENTS, *sizes.values()))
    out = cs.run_connectors(device, ev=ev, leg_events=sizes)
    print(card, flush=True)
    print(json.dumps({"legs": out["legs"], "launches": out["launches"],
                      "held": out.get("held")}, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
