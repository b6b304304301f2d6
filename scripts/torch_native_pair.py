"""Time the engine's and the Table API's host-bound runs of checkouts on one card, in turns; and
the JAX package's streaming wordcount beside the port's in one process.

    python scripts/torch_native_pair.py TREE [TREE ...] [--reference]

Each TREE is the root of a checkout that holds ``chip_smoke.py`` and ``pathway_tpu_torch`` (``.``
for this one). Every TREE runs in a process of its own, in the order given, so that ``A B B A``
pairs two versions within one call on one card, where the host's speed moves less than between
calls. A process imports that tree's ``chip_smoke.py`` and runs, at the sizes its phases use:

- the engine's wordcount (``wordcount_graph``: 500,000 rows of 997 words in commits of 10,000) at
  1 worker, and at 2 and 8 over ``MeshComm``, each table held against the 1-worker table;
- the dense groupby-join at 8 workers over ``MeshComm`` (``dense_graph``: 4,194,304 rows in
  commits of 65,536), held against its group and row totals;
- the Table API pipeline through ``pw.run(device="cuda")`` at 1 worker with the lifted lambda
  (``run_pipeline``: 4,194,304 rows in 64 commits of 65,536), held against ``pipeline_reference``.

``--reference`` adds a process that runs the JAX package's streaming wordcount
(``bench.py::_wordcount_throughput``: ``pw.run()`` over a ``ConnectorSubject`` of 500,000 rows in
commits of 10,000, ``next_batch`` and ``on_batch``) and the same program written for the port
(``pw.run(device="cuda")``), at 1 and 2 workers, in turns (reference, port, port, reference). The
JAX package imports no JAX on this path: its import is blocked, and its native module is built
with the host C compiler as its loader does.

Prints the card's name and power limit first, then one JSON line a process (rows/s of each run).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

WC_ROWS, WC_COMMIT = 500_000, 10_000
ROWS, COMMIT, GROUPS, WORKERS = 1 << 22, 1 << 16, 1 << 16, 8


def child(tree: str) -> None:
    root = Path(tree).resolve()
    sys.path.insert(0, str(root))
    # the runs' distinct keys pass the key registry's default cap, as in chip_smoke.py
    os.environ.setdefault("PATHWAY_KEY_REGISTRY_CAP", str(1 << 25))
    import importlib.util

    import torch

    spec = importlib.util.spec_from_file_location("chip_smoke", root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    device = torch.device("cuda")
    out: dict = {"tree": tree}
    build = cs.wordcount_graph(WC_ROWS, WC_COMMIT)
    base, sec, _ = cs.run_workers(build, 1, False, device)
    out["wordcount_1"] = WC_ROWS / sec
    want = cs.table(base)
    for n in (2, 8):
        cap, sec, _ = cs.run_workers(build, n, True, device)
        if cs.table(cap) != want:
            raise AssertionError(f"wordcount at {n} workers differs from 1 worker")
        out[f"wordcount_{n}_mesh"] = WC_ROWS / sec
    cap, sec, _ = cs.run_workers(cs.dense_graph(ROWS, GROUPS, COMMIT), WORKERS, True, device)
    table = cs.table(cap)
    if len(table) != GROUPS or sum(r[3] for _, r in table) != ROWS:
        raise AssertionError("dense groupby-join: the table does not cover every group and row")
    out[f"dense_{WORKERS}_mesh"] = ROWS / sec
    cols = cs.pipeline_columns(ROWS, GROUPS)
    got, sec = cs.run_pipeline(device, cols, COMMIT, GROUPS, 1, True)
    if got != cs.pipeline_reference(cols):
        raise AssertionError("table_api_1: the table differs from the numpy computation")
    out["table_api_1"] = ROWS / sec
    print(json.dumps(out), flush=True)


def port_wordcount(threads: int) -> float:
    """``bench.py::_wordcount_throughput``'s columnar program, written for the port."""
    import pathway_tpu_torch as pw

    pw.G.clear()
    words = [f"w{i % 997}" for i in range(WC_ROWS)]

    class Feed(pw.io.python.ConnectorSubject):
        def run(self) -> None:
            for start in range(0, WC_ROWS, WC_COMMIT):
                self.next_batch({"word": words[start:start + WC_COMMIT]})
                self.commit()

    t = pw.io.python.read(Feed(), schema=pw.schema_from_types(word=str),
                          autocommit_duration_ms=None)
    counts = t.groupby(pw.this.word).reduce(pw.this.word, c=pw.reducers.count())
    total = {"n": 0}

    def on_batch(time, b):
        total["n"] = max(total["n"], int(b.data["c"].max()))

    pw.io.subscribe(counts, on_batch=on_batch)
    prev = os.environ.get("PATHWAY_THREADS")
    os.environ["PATHWAY_THREADS"] = str(threads)
    t0 = time.perf_counter()
    try:
        pw.run(device="cuda")
    finally:
        elapsed = time.perf_counter() - t0
        if prev is None:
            os.environ.pop("PATHWAY_THREADS", None)
        else:
            os.environ["PATHWAY_THREADS"] = prev
        pw.G.clear()
    if total["n"] != (WC_ROWS + 996) // 997:
        raise AssertionError(f"port wordcount: counted {total['n']}")
    return WC_ROWS / elapsed


def reference_child() -> None:
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    sys.modules["jax"] = None  # the JAX package's engine path imports no JAX
    sys.modules["jaxlib"] = None
    os.environ.setdefault("PATHWAY_KEY_REGISTRY_CAP", str(1 << 25))
    import bench
    from pathway_tpu.native import get_native

    if get_native() is None:
        raise RuntimeError("the JAX package's native module did not build on this host")
    out: dict = {"tree": "reference and port, one process"}
    for threads in (1, 2):
        runs = {"reference": [], "port": []}
        for who in ("reference", "port", "port", "reference"):
            rate = (bench._wordcount_throughput(WC_ROWS, WC_COMMIT, threads=threads)
                    if who == "reference" else port_wordcount(threads))
            runs[who].append(rate)
        out[f"wordcount_api_{threads}"] = runs
    out["jax_loaded"] = sorted(m for m, mod in sys.modules.items()
                               if mod is not None and m.split(".")[0] in ("jax", "jaxlib"))
    print(json.dumps(out), flush=True)


def main(args: list[str]) -> int:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    trees = [a for a in args if a != "--reference"]
    for tree in trees:
        subprocess.run([sys.executable, __file__, "--child", tree], check=True)
    if "--reference" in args:
        subprocess.run([sys.executable, __file__, "--reference-child"], check=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        child(sys.argv[2])
        sys.exit(0)
    if sys.argv[1:] == ["--reference-child"]:
        reference_child()
        sys.exit(0)
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1:]))
