"""Streaming wordcount with persistence — the canonical end-to-end workload
(reference ``integration_tests/wordcount/pw_wordcount.py``).

Copy of ``examples/wordcount/pw_wordcount.py`` on ``pathway_tpu_torch``, with
the ``--device`` argument (default ``cuda``; ``--device cpu`` on a host with
no card).

Watches a directory of CSV files (column ``word``), maintains live counts,
writes the update stream to an output file, and checkpoints input so a
killed run resumes exactly where it stopped:

    python -m pathway_tpu_torch.cli spawn -t 2 \\
        python -m pathway_tpu_torch.examples.wordcount.pw_wordcount \\
        --input ./data --output ./counts.csv --pstorage ./pstate

Feed it by appending lines to any csv in --input while it runs; stop with
Ctrl-C and restart to see recovery (no duplicated counts).
"""

from __future__ import annotations

import argparse

import pathway_tpu_torch as pw
from pathway_tpu_torch.internals import lintmode


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", default="data", help="directory of csv files")
    ap.add_argument("--output", default="counts.csv")
    ap.add_argument("--pstorage", default=None, help="persistence directory")
    ap.add_argument("--mode", default="streaming", choices=["streaming", "static"])
    # under `lint --device`, the lint's device
    ap.add_argument("--device", default=lintmode.device(),
                    help="where the engine's kernels run")
    args = ap.parse_args()

    words = pw.io.csv.read(
        args.input,
        schema=pw.schema_from_types(word=str),
        mode=args.mode,
        name="words",
    )
    # the live count per distinct word IS the product here, so the state
    # is meant to grow with the vocabulary; persistence is optional by
    # design (--pstorage) — both lint findings are deliberate choices
    counts = words.groupby(pw.this.word).reduce(  # pathway: ignore[unbounded-state]
        pw.this.word, count=pw.reducers.count()
    )
    pw.io.csv.write(counts, args.output)  # pathway: ignore[sink-no-persistence]

    persistence_config = None
    if args.pstorage is not None:
        persistence_config = pw.persistence.Config.simple_config(
            pw.persistence.Backend.filesystem(args.pstorage),
            snapshot_interval_ms=1000,
        )
    pw.run(
        device=args.device,
        persistence_config=persistence_config,
        monitoring_level=pw.MonitoringLevel.AUTO,
    )


if __name__ == "__main__":
    main()
