"""How the streaming programs of the stdlib and SQL tests fare at 2 and 4 workers, run after run,
on the CPU.

    JAX_PLATFORMS=cpu python scripts/stdlib_async_probe.py [--package pathway_tpu_torch]
        [--runs 6] [--programs pandas_transformer,pagerank,pointer_chasing_streamed_nodes]

Each program is one of ``tests/test_torch_stdlib.py``'s or ``tests/test_torch_sql.py``'s
(python subjects of seeded rows, a commit a batch, retractions). The script runs it once at
1 worker, then ``--runs`` times each at 2 and 4 workers (async, the default loop) and at 2 under
BSP (``PATHWAY_ASYNC_EXEC=0``), and prints for each how many runs gave the 1-worker table, how
many another table, and how many raised (with the first error). ``--package`` picks the package
(the JAX package by default). The JAX package's ``pandas_transformer`` routes no input, so its
sharded tables differ; its ``pw.iterate`` and row transformers raise when the async plane brings
a row after a row that points at it (``ROADMAP.md`` Queue 3, "Not port faults").
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", default="pathway_tpu")
    ap.add_argument("--runs", type=int, default=6)
    ap.add_argument("--programs", default="pandas_transformer,pagerank,"
                                          "pointer_chasing_streamed_nodes")
    args = ap.parse_args()
    sys.path[:0] = [os.path.join(ROOT, "tests"), ROOT]
    import pandas  # noqa: F401  (first imported on this thread: see pandas_transformer)
    import pytest
    import test_torch_sql
    import test_torch_stdlib
    from torch_state_runs import final_table

    programs = {**test_torch_stdlib.PROGRAMS, **test_torch_sql.PROGRAMS}
    mp = pytest.MonkeyPatch()
    for name in args.programs.split(","):
        prog = programs[name]
        one = final_table(args.package, prog, mp)
        for workers, async_exec in ((2, None), (4, None), (2, "0")):
            same = other = raised = 0
            first_error = ""
            for _ in range(args.runs):
                try:
                    got = final_table(args.package, prog, mp, workers, async_exec)
                except Exception as e:  # the run's own error, counted and shown
                    raised += 1
                    first_error = first_error or repr(e)[:120]
                    continue
                if got == one:
                    same += 1
                else:
                    other += 1
            mode = "BSP" if async_exec == "0" else "async"
            print(f"{args.package} {name} {workers} workers {mode}: {same} the 1-worker table, "
                  f"{other} another, {raised} raised {first_error}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
