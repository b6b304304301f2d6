"""Phase 14 of ``chip_smoke.py`` (persistence and recovery) alone on one card, at a chosen number
of index rows, beside a clean fill of the same index in the same process; with ``--rescale``,
phase 15 (elastic rescale and the spill tier) after it, over phase 14's store.

    python scripts/torch_persistence_phase.py [--rows N] [--rescale] [--spill-rows N]

``--rows`` (default 1,048,576, phase 11's full index) sets how many of phase 11's rows (its
16,384 chunk texts, then seeded unit vectors) the index takes. The script builds the kernels and
the native module, fills ``pw.indexing.DataIndex`` over the rows through ``pw.run(device="cuda")``
without persistence (``chip_smoke.py::run_index_pipeline``, 1 worker, untraced) and holds its 64
answers (k=10) against a direct ``BruteForceKnnEngine.search``; then runs
``chip_smoke.py::run_persistence`` at that size, with the clean fill's rate setting the snapshot
interval and standing beside the restored run's refill, and the first leg killed once a commit
covers three quarters of the rows. It logs what the phase logs and prints the card's name and
power limit, then one JSON line: the clean fill's seconds and rate, each commit's time, bytes and
phase split, the store's bytes at the kill, the restore's seconds, the rows replayed, the
refill's seconds, the first query tick and the launches. ``--rescale`` hands phase 14's index
store to ``chip_smoke.py::run_rescale_spill`` (its spilled groupby-join over ``--spill-rows``
rows and as many groups, default 1,048,576, the 4-worker run over half of them), which logs what
phase 15 logs; the JSON line then carries phase 15's rescale report, restore, spill runs and
launches under ``"rescale"``.
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
    ap.add_argument("--rows", type=int, default=1 << 20)
    ap.add_argument("--rescale", action="store_true")
    ap.add_argument("--spill-rows", type=int, default=1 << 20)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    os.environ.setdefault("PATHWAY_KEY_REGISTRY_CAP", str(1 << 25))
    import torch

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    if not torch.cuda.is_available():
        print("torch_persistence_phase: no CUDA device", file=sys.stderr)
        return 2
    import pathway_tpu_torch as pw
    from pathway_tpu_torch import _kernels, native
    from pathway_tpu_torch.models.embedder import Embedder
    from pathway_tpu_torch.ops.index_engines import BruteForceKnnEngine

    native.build()
    _kernels.build_all()
    device = torch.device("cuda")
    card = cs.card_line()
    cs.log(card)
    emb = Embedder(None, seed=0, device=device)
    n_chunks, k, n_queries = 16384, 10, 64
    texts, vecs, queries = cs.index_data(n_chunks, args.rows, emb.cfg.dim, n_queries)
    direct = BruteForceKnnEngine(emb.cfg.dim, reserved_space=args.rows, embedder=emb,
                                 device=device)
    for s in range(0, n_chunks, 1024):
        direct.add_batch(list(range(s, s + 1024)), texts[s:s + 1024], [None] * 1024)
    direct.add_batch(list(range(n_chunks, args.rows)), list(vecs), [None] * len(vecs))
    want = dict(enumerate(direct.search(queries, [k] * n_queries, [None] * n_queries)))
    del direct
    torch.cuda.empty_cache()

    factory = pw.indexing.BruteForceKnnFactory(dimensions=emb.cfg.dim, reserved_space=args.rows,
                                               embedder=emb)
    clean = cs.run_index_pipeline(device, factory=factory, texts=texts, vecs=vecs,
                                  queries=queries, k=k, chunk_commit=1024, vec_commit=1 << 16,
                                  workers=1, trace=False)
    swapped = cs.check_answers("clean fill", clean["answers"], want)
    fill_s = args.rows / clean["fill_rows_per_s"]
    cs.log(f"clean fill of {args.rows} rows at 1 worker: {fill_s:.1f} s "
           f"({clean['fill_rows_per_s']:.1f} rows/s), the query tick {clean['query_ms']:.3f} ms, "
           f"{n_queries} answers equal to the direct search ({swapped} swapped in near ties) "
           f"[{card}]")
    del clean
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = cs.run_persistence(device, data=(texts, vecs, queries), want=want,
                             phase11_fill_rows_per_s=args.rows / fill_s, n_rows=args.rows,
                             kill_rows=args.rows * 3 // 4, hand_over=args.rescale)
    phase14_s = time.perf_counter() - t0
    rescaled = None
    if args.rescale:
        t1 = time.perf_counter()
        r = cs.run_rescale_spill(device, store=res.pop("store"), interval_ms=res["interval_ms"],
                                 data=(texts, vecs, queries), want=want,
                                 spill_rows=args.spill_rows, spill_groups=args.spill_rows,
                                 spill_rows_4=args.spill_rows // 2)
        rescaled = {"phase_s": time.perf_counter() - t1, "index": r.get("index"),
                    "files": r["files"], "exchange_widths": r["exchange_widths"],
                    "spill": r["spill"], "launches": r["launches"]}
    a = res["index"]
    print(json.dumps({
        "rows": args.rows, "clean_fill_s": fill_s, "phase_s": phase14_s, "rescale": rescaled,
        "leg1_commits": a["leg1_commits"], "leg1_s": a["leg1_s"],
        "store_bytes_at_kill": a["store_bytes"], "recovery": a["recovery"],
        "leg2_commits": a["leg2_commits"], "refill_s": a["refill_s"], "leg2_s": a["leg2_s"],
        "query_ms": a["query_ms"], "query_copy_ms": a.get("copy_ms"),
        "files": res["files"], "launches": res["launches"],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
