"""Static analysis of compiled dataflow graphs (``pw.analyze`` and lint mode).

Copy of ``pathway_tpu/analysis/__init__.py``. ``analyze`` takes ``device=``
(default ``"cuda"``): the analysis runner lowers on that device as ``pw.run``
would (expression environments, index engines) and starts nothing. Left out:
``astgate.py`` (a gate over the JAX package's own source tree) and the
``pathway-tpu lint`` command of ``cli.py``; ``analysis.lint.lint_targets``
is what that command runs.

The reference engine compiles whole expression DAGs and rejects bad
plans before a single row flows (SURVEY §1.3); this package gives the
reproduction the same ahead-of-time discipline: :func:`analyze` lowers
the currently-registered parse graph to engine operators WITHOUT
executing anything and runs a battery of passes over it —

- ``unbounded-state``: groupby/join state growing forever over a
  never-ending source (names the ForgetAfter / spill-budget mitigation);
- ``nondeterministic-udf``: RNG/time/io inside UDFs of persisted /
  exactly-once pipelines (replay divergence);
- ``perrow-udf``: UDFs that fail both the static lift and the
  probe-trace gate, with the exact refusal reason;
- ``fusion-chain``: maximal pure linear operator chains + their
  intermediate materialization cost;
- ``shard-skew``: provably low-cardinality keys vs the worker count;
- ``sink-no-persistence`` / ``sink-name-collision`` / ``dlq-collision``:
  output-plane misconfiguration.

The report also carries a stable structural fingerprint per operator —
the identity primitive graph-version migration needs.

Surfaces: ``pw.analyze()`` (this function) and ``analysis/lint.py``'s
``lint_script``/``lint_targets`` (machine-readable JSON, severity exit
codes, ``# pathway: ignore[<id>]`` suppressions).
"""

from __future__ import annotations

from typing import Any

import torch

from .report import CATALOG, Diagnostic, Report

__all__ = ["CATALOG", "Diagnostic", "Report", "analyze"]


def analyze(
    *,
    persistence_config: Any = None,
    n_workers: int | None = None,
    device: str | torch.device = "cuda",
) -> Report:
    """Statically analyze the dataflow registered so far (everything
    ``pw.run()`` would execute). Lowering runs for real — expression
    compilation included — but nothing executes: no sources start, no
    sinks open, no rows flow.

    ``persistence_config``: the config the eventual ``pw.run`` will use
    (enables the replay-determinism and exactly-once checks); under
    lint mode (``analysis/lint.py``) it is captured from the script's own stubbed
    ``pw.run`` call. ``n_workers``: the deployment's worker count for the
    shard-skew pass (default: PATHWAY_LINT_WORKERS, then the current
    config's total_workers). ``device``: where the lowering would run (with
    no card it raises unless the caller passes ``device="cpu"``)."""
    from .graph import fingerprint_nodes, lower_current_graph, node_labels
    from .passes import AnalysisContext, run_passes

    runner = lower_current_graph(device)
    ctx = AnalysisContext(
        runner,
        persistence_config=persistence_config,
        n_workers=n_workers,
    )
    report = Report()
    report.diagnostics = run_passes(ctx)
    fps = fingerprint_nodes(ctx.nodes)
    labels = node_labels(ctx.nodes)
    report.fingerprints = {
        labels[nid]: fps[nid]
        for nid in sorted(
            labels, key=lambda i: int(labels[i].split(":", 1)[0])
        )
        if nid in fps
    }
    report.stats = {
        "operators": len(ctx.nodes),
        "delivery_sinks": len(runner.sink_specs),
        "plain_sinks": runner.plain_sinks,
        "workers_modeled": ctx.n_workers,
        "persisted": ctx.persisted,
    }
    return report
