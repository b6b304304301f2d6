"""Which late rows a sharded windowed run drops, run after run, on the CPU.

    JAX_PLATFORMS=cpu python scripts/temporal_watermark_probe.py [--package pathway_tpu_torch]

The program: a python subject of 2,000 seeded rows in 20 commits, a tumbling window of 50 with
``instance=``, sum and count; then the same with 100 rows made 60 time units late. For each
behaviour (``exactly_once_behavior()``, ``common_behavior(cutoff=20)``, none) it runs 1 worker,
then 2 and 4 workers (4 runs each where rows are late and a behaviour is set), and prints the
first 8 hex digits of the SHA-256 of each final table, starred where it equals the 1-worker
table. ``BufferUntil`` and ``ForgetAfter`` judge lateness against the largest event time their
own worker has seen, so with late rows the sharded tables spread (``ROADMAP.md`` Queue 3, "Not
port faults"). ``--package`` picks the package (the JAX package by default).
"""

from __future__ import annotations

import argparse
import hashlib
import importlib
import os
import threading
from collections import Counter

import numpy as np


def program(pw, behavior: str, late: bool):
    rng = np.random.default_rng(5)
    t = np.sort(rng.integers(0, 2000, 2000))
    k, v = rng.integers(0, 4, 2000), rng.integers(0, 100, 2000)
    rows = [dict(t=int(a), k=int(b), v=int(c)) for a, b, c in zip(t, k, v)]
    batches = [rows[i * 100:(i + 1) * 100] for i in range(20)]
    if late:
        for j in range(100):
            b = 5 + j % 15
            batches[b].append(dict(t=max(0, batches[b][-1]["t"] - 60), k=j % 4, v=j))

    class Feed(pw.io.python.ConnectorSubject):
        def run(self):
            for b in batches:
                self.next_batch({c: [r[c] for r in b] for c in ("t", "k", "v")})
                self.commit()

    src = pw.io.python.read(Feed(), schema=pw.schema_from_types(t=int, k=int, v=int),
                            autocommit_duration_ms=None)
    beh = {"exactly_once": pw.temporal.exactly_once_behavior(),
           "cutoff": pw.temporal.common_behavior(cutoff=20), "none": None}[behavior]
    return src.windowby(pw.this.t, window=pw.temporal.tumbling(duration=50), instance=pw.this.k,
                        behavior=beh).reduce(k=pw.this._pw_instance,
                                             start=pw.this._pw_window_start,
                                             s=pw.reducers.sum(pw.this.v), n=pw.reducers.count())


def table_hash(pw, run_kw: dict, behavior: str, late: bool, workers: int) -> str:
    pw.G.clear()
    os.environ["PATHWAY_THREADS"] = str(workers)
    acc: Counter = Counter()
    lock = threading.Lock()

    def on_change(key, row, time, is_addition):
        with lock:
            acc[tuple(row.values())] += 1 if is_addition else -1

    pw.io.subscribe(program(pw, behavior, late), on_change=on_change)
    pw.run(**run_kw)
    return hashlib.sha256(repr(sorted((+acc).items())).encode()).hexdigest()[:8]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", default="pathway_tpu")
    args = ap.parse_args()
    pw = importlib.import_module(args.package)
    run_kw = {"device": "cpu"} if args.package == "pathway_tpu_torch" else {}
    for behavior in ("exactly_once", "cutoff", "none"):
        for late in (False, True):
            one = table_hash(pw, run_kw, behavior, late, 1)
            reps = 4 if late and behavior != "none" else 1
            multi = {w: [table_hash(pw, run_kw, behavior, late, w) for _ in range(reps)]
                     for w in (2, 4)}
            shown = {w: [h + ("*" if h == one else "") for h in hs] for w, hs in multi.items()}
            print(behavior, "late" if late else "in order", "1 worker", one, shown, flush=True)


if __name__ == "__main__":
    main()
