"""Phase 17 of ``chip_smoke.py`` (Nexmark windows through ``pw.temporal``) alone on one card.

    python scripts/torch_nexmark_phase.py [--events 1000000] [--legs q1q7=N,q5=N,q8=N,joins=N]

The script builds the kernels and the native module, then runs ``chip_smoke.py::run_nexmark``
over ``--events`` generated events, each leg named in ``--legs`` over the first N of them (the
others over all ``--events``; with no ``--legs``, the phase's own cuts,
``chip_smoke.NEXMARK_LEG_EVENTS``). It logs what the phase logs and prints the card's name and
power limit, then one JSON line: each leg's rows/s, seconds and window or match counts, and the
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
    ap.add_argument("--events", type=int, default=None)
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
        print("torch_nexmark_phase: no CUDA device", file=sys.stderr)
        return 2
    from pathway_tpu_torch import _kernels, native

    native.build()
    _kernels.build_all()
    device = torch.device("cuda")
    card = cs.card_line()
    cs.log(card)
    events = args.events or cs.NEXMARK_EVENTS
    leg_events = {k: legs.get(k, events) for k in cs.NEXMARK_LEG_EVENTS} if legs else None
    out = cs.run_nexmark(device, n_events=events, leg_events=leg_events)
    print(card, flush=True)
    print(json.dumps({"rates": out["rates"], "s": out["s"], "windows": out["windows"],
                      "launches": out["launches"]}, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
