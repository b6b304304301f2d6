"""Phase 22 of ``chip_smoke.py`` (the command line) alone on one card.

    python scripts/torch_cli_phase.py [--commits N] [--rows N] [--chunks N] [--fill-rows-per-s R]

The script builds the kernels and the native module, then runs ``chip_smoke.py::run_cli`` at the
phase's sizes (or those given): (a) phase 10's chain under ``spawn --record`` and ``replay --mode
speedrun``; (b) phase 14's persisted index under ``spawn --supervise``, killed in generation 0
and recovered in generation 1, with ``top``, ``critpath`` and ``profile`` against its monitoring
server; (c) ``lint``, ``trace merge`` and ``rescale --dry-run``. Phase 11's fill rate, which the
full script hands (b) to set its snapshot interval, is ``--fill-rows-per-s`` here (unset: an
interval of one second). It logs what the phase logs and prints the card's name and power limit,
then one JSON line: the phase's seconds, the kernels held against their plain versions and the
launch counts by path.
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
    ap.add_argument("--commits", type=int, default=32)
    ap.add_argument("--rows", type=int, default=1 << 16)
    ap.add_argument("--chunks", type=int, default=4096)
    ap.add_argument("--fill-rows-per-s", type=float, default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    os.environ.setdefault("PATHWAY_KEY_REGISTRY_CAP", str(1 << 25))
    import torch

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs
    spec.loader.exec_module(cs)
    if not torch.cuda.is_available():
        print("torch_cli_phase: no CUDA device", file=sys.stderr)
        return 2
    from pathway_tpu_torch import _kernels, native

    native.build()
    _kernels.build_all()
    device = torch.device("cuda")
    card = cs.card_line()
    cs.log(card)
    out = cs.run_cli(device, chain_commits=args.commits, n_rows=args.rows, n_chunks=args.chunks,
                     fill_rows_per_s=args.fill_rows_per_s)
    print(card, flush=True)
    print(json.dumps({"s": out["s"], "first_answer_s": out["first_answer_s"],
                      "held": out["held"], "launches": out["launches"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
