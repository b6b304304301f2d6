"""Lint driver: run a pipeline script in build-only mode and statically
analyze the graph it registers.

Copy of ``pathway_tpu/analysis/lint.py`` (what the reference's ``pathway-tpu
lint`` command runs; the port has no CLI). ``lint_script`` and
``lint_targets`` take ``device=`` (default ``"cuda"``) for the analysis
runner's lowering.

The script executes for real — imports, argument parsing, table
building — but ``pw.run()`` is stubbed to capture its
``persistence_config`` and return (``internals/lintmode.py``), so no
sources start and no sinks open. Diagnostics anchor to script lines
(table/sink creation sites recorded while lint mode is armed) and can be
suppressed inline:

    counts = words.groupby(pw.this.word)  # pathway: ignore[unbounded-state]

A suppression comment on a line of its own suppresses those ids for the
whole file; a trailing comment suppresses only diagnostics anchored to
that line.
"""

from __future__ import annotations

import os
import re
import runpy
import sys
from typing import Any

import torch

from .._device import resolve_device
from ..internals import lintmode
from ..internals.parse_graph import G
from .report import CATALOG, Report

__all__ = ["collect_suppressions", "lint_script", "lint_targets"]

_SUPPRESS_RE = re.compile(r"#\s*pathway:\s*ignore\[([a-zA-Z0-9_,\s\-]+)\]")


def collect_suppressions(
    source: str,
) -> tuple[set[str], dict[int, set[str]]]:
    """(file-wide ids, line -> ids) from ``# pathway: ignore[...]``
    comments. Unknown ids are kept (forward compatibility: a script may
    carry suppressions for diagnostics a newer version ships)."""
    filewide: set[str] = set()
    by_line: dict[int, set[str]] = {}
    for lineno, line in enumerate(source.splitlines(), start=1):
        m = _SUPPRESS_RE.search(line)
        if not m:
            continue
        ids = {s.strip() for s in m.group(1).split(",") if s.strip()}
        if line.strip().startswith("#"):
            filewide |= ids
        else:
            by_line.setdefault(lineno, set()).update(ids)
    return filewide, by_line


def _apply_suppressions(report: Report, script: str, source: str) -> None:
    filewide, by_line = collect_suppressions(source)
    if not filewide and not by_line:
        return
    kept, suppressed = [], []
    for d in report.diagnostics:
        ids_here = set(filewide)
        if (
            d.location is not None
            and os.path.abspath(d.location[0]) == os.path.abspath(script)
        ):
            ids_here |= by_line.get(d.location[1], set())
        (suppressed if d.id in ids_here else kept).append(d)
    report.diagnostics = kept
    report.suppressed.extend(suppressed)


def lint_script(
    path: str, *, n_workers: int | None = None,
    device: str | torch.device = "cuda",
) -> tuple[Report, BaseException | None]:
    """Execute ``path`` in build-only mode and analyze its graph.
    Returns (report, crash) — ``crash`` is the exception the script
    itself raised (the report is then empty; exit code 3)."""
    from . import analyze

    device = resolve_device(device)
    script = os.path.abspath(path)
    saved_graph = dict(G.__dict__)
    saved_argv = list(sys.argv)
    G.clear()
    lintmode.arm(script, device)
    crash: BaseException | None = None
    report = Report(script=path)
    try:
        sys.argv = [script]
        try:
            runpy.run_path(script, run_name="__main__")
        except SystemExit as e:
            # argparse --help / explicit sys.exit(0) in a script is not a
            # crash; a nonzero exit is
            if e.code not in (None, 0):
                crash = e
        except BaseException as e:
            crash = e
        if crash is None:
            analyzed = analyze(
                persistence_config=lintmode.CAPTURE.get("persistence_config"),
                n_workers=n_workers,
                device=device,
            )
            analyzed.script = path
            report = analyzed
            try:
                with open(script, encoding="utf-8") as f:
                    source = f.read()
            except OSError:
                source = ""
            _apply_suppressions(report, script, source)
    finally:
        lintmode.disarm()
        sys.argv = saved_argv
        G.__dict__.clear()
        G.__dict__.update(saved_graph)
    return report, crash


def expand_targets(targets: list[str]) -> list[str]:
    """Scripts to lint: files stay; directories expand to every ``*.py``
    beneath them (sorted, __pycache__ excluded)."""
    out: list[str] = []
    for t in targets:
        if os.path.isdir(t):
            for dirpath, dirnames, filenames in os.walk(t):
                dirnames[:] = [d for d in dirnames if d != "__pycache__"]
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        out.append(os.path.join(dirpath, fn))
        else:
            out.append(t)
    return sorted(dict.fromkeys(out))


def lint_targets(
    targets: list[str],
    *,
    n_workers: int | None = None,
    fail_on: str = "warning",
    device: str | torch.device = "cuda",
) -> tuple[list[dict[str, Any]], int]:
    """Lint every expanded target. Returns (per-script result docs,
    overall exit code): 0 clean, 1 warnings, 2 errors, 3 a script
    crashed while building — thresholded by ``fail_on``."""
    device = resolve_device(device)
    results: list[dict[str, Any]] = []
    worst = 0
    for script in expand_targets(targets):
        report, crash = lint_script(script, n_workers=n_workers, device=device)
        doc = report.to_dict()
        if crash is not None:
            doc["crash"] = f"{type(crash).__name__}: {crash}"
            # the same threshold contract as findings: "never" collects
            # reports non-fatally even when a script fails to build
            if fail_on != "never":
                worst = max(worst, 3)
        else:
            worst = max(worst, report.exit_code(fail_on))
        results.append({"report": report, "doc": doc, "crash": crash})
    return results, worst


def known_ids() -> list[str]:
    return sorted(CATALOG)
