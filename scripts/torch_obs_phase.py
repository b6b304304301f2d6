"""Phase 21 of ``chip_smoke.py`` (the observability plane) alone on one card.

    python scripts/torch_obs_phase.py [--rows N] [--reps N] [--chunks N] [--requests N] [--split]

The script builds the kernels and the native module, then runs
``chip_smoke.py::run_observability`` at the phase's sizes (or those given): (a) phase 10's chain
at 2 workers in the bare, default and observed arms, alternated ``--reps`` times, the observed
runs scraped and read at their end (``--split`` adds an arm for each default-on hook alone:
the key-load sketch with the profiler off, the profiler's operator slot with the sketch off);
(b) ``DocumentStoreServer`` with the monitoring server on.
Phase 12's serve p50, which the full script prints beside (b)'s, is not measured here. It logs
what the phase logs and prints the card's name and power limit, then one JSON line: each arm's
rows/s and overhead, the scrapes, the observed serve's latencies, the kernels held against their
plain versions and the launch counts by path.
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
    ap.add_argument("--rows", type=int, default=1 << 22)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--chunks", type=int, default=4096)
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--split", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    os.environ.setdefault("PATHWAY_KEY_REGISTRY_CAP", str(1 << 25))
    import torch

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs
    spec.loader.exec_module(cs)
    if not torch.cuda.is_available():
        print("torch_obs_phase: no CUDA device", file=sys.stderr)
        return 2
    from pathway_tpu_torch import _kernels, native

    native.build()
    _kernels.build_all()
    device = torch.device("cuda")
    card = cs.card_line()
    cs.log(card)
    out = cs.run_observability(device, rows=args.rows, reps=args.reps, n_chunks=args.chunks,
                               requests=args.requests, split=args.split)
    print(card, flush=True)
    print(json.dumps(out, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
