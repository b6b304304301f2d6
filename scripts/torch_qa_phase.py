"""Phase 20 of ``chip_smoke.py`` (RAG question answering over HTTP and the last root names) alone
on one card.

    python scripts/torch_qa_phase.py [--chunks N] [--questions N] [--vs-chunks N]

The script builds the kernels and the native module, then runs ``chip_smoke.py::run_qa`` at the
phase's sizes (or those given). It logs what the phase logs and prints the card's name and power
limit, then one JSON line: each leg's numbers, the kernels held against their plain versions and
the launch counts by path.
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
    ap.add_argument("--chunks", type=int, default=4096)
    ap.add_argument("--questions", type=int, default=64)
    ap.add_argument("--vs-chunks", type=int, default=1024)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    os.environ.setdefault("PATHWAY_KEY_REGISTRY_CAP", str(1 << 25))
    import torch

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs  # the phase's YAML names its documents and chats by module
    spec.loader.exec_module(cs)
    if not torch.cuda.is_available():
        print("torch_qa_phase: no CUDA device", file=sys.stderr)
        return 2
    from pathway_tpu_torch import _kernels, native

    native.build()
    _kernels.build_all()
    device = torch.device("cuda")
    card = cs.card_line()
    cs.log(card)
    out = cs.run_qa(device, n_chunks=args.chunks, n_questions=args.questions,
                    vs_chunks=args.vs_chunks)
    print(card, flush=True)
    print(json.dumps(out, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
