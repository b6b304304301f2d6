"""Diagnostic + report model of the static analyzer.

Copy of ``pathway_tpu/analysis/report.py``.

Every analyzer pass emits :class:`Diagnostic` records with a stable id
from :data:`CATALOG`; a :class:`Report` bundles them with the per-operator
structural fingerprints and renders to machine-readable JSON (CI) or a
human summary (terminal). Severity ordering drives the CLI exit code:
``error`` > ``warning`` > ``info``; suppressed and info-only reports are
clean (exit 0).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any

__all__ = ["CATALOG", "Diagnostic", "Report", "SEVERITIES"]

#: severity rank (exit codes: error -> 2, warning -> 1, info/clean -> 0)
SEVERITIES = ("info", "warning", "error")

#: diagnostic catalog: id -> (default severity, one-line description).
#: Ids are the suppression vocabulary (`# pathway: ignore[<id>]`) and the
#: stable key CI pipelines match on — never rename, only add.
CATALOG: dict[str, tuple[str, str]] = {
    "unbounded-state": (
        "warning",
        "groupby/join state grows without bound over a never-ending "
        "source (no temporal cutoff upstream, no spill budget set)",
    ),
    "nondeterministic-udf": (
        "error",
        "a UDF reaching a persisted/exactly-once pipeline calls RNG/"
        "time/io — replay after recovery diverges from the original run",
    ),
    "perrow-udf": (
        "warning",
        "a UDF failed the static lift AND the probe-trace gate: every "
        "row pays the Python dispatch tax",
    ),
    "fusion-chain": (
        "info",
        "a linear operator chain the compiler fuses into one kernel — "
        "or, at warning severity, one it detected but DECLINED to fuse "
        "(the message carries the compiler's verbatim decline reason)",
    ),
    "shard-skew": (
        "warning",
        "groupby/join keys have fewer distinct values than workers — "
        "some workers would sit idle while one holds the whole key space",
    ),
    "sink-no-persistence": (
        "warning",
        "transactional sinks registered but the pipeline runs without "
        "persistence — delivery degrades to at-least-once",
    ),
    "sink-name-collision": (
        "warning",
        "two sinks derived the same default name (de-collided only by "
        "registration order — ack cursors/DLQ files silently swap if the "
        "registration order changes)",
    ),
    "dlq-collision": (
        "warning",
        "the sink dead-letter directory overlaps a sink output path or "
        "the persistence root",
    ),
}


@dataclass
class Diagnostic:
    id: str
    message: str
    severity: str = ""
    #: (filename, lineno) in the linted script, when known
    location: tuple[str, int] | None = None
    #: stable operator label ("3:GroupByReduce") when node-anchored
    operator: str | None = None
    #: what to do about it — rendered under the finding
    mitigation: str | None = None

    def __post_init__(self) -> None:
        if self.id not in CATALOG:
            raise ValueError(f"unknown diagnostic id {self.id!r}")
        if not self.severity:
            self.severity = CATALOG[self.id][0]
        if self.severity not in SEVERITIES:
            raise ValueError(f"unknown severity {self.severity!r}")

    def to_dict(self) -> dict[str, Any]:
        d: dict[str, Any] = {
            "id": self.id,
            "severity": self.severity,
            "message": self.message,
        }
        if self.location is not None:
            d["location"] = {"file": self.location[0], "line": self.location[1]}
        if self.operator is not None:
            d["operator"] = self.operator
        if self.mitigation is not None:
            d["mitigation"] = self.mitigation
        return d

    def render(self) -> str:
        loc = (
            f"{self.location[0]}:{self.location[1]}: "
            if self.location is not None
            else ""
        )
        op = f" [{self.operator}]" if self.operator else ""
        out = f"{loc}{self.severity}[{self.id}]{op}: {self.message}"
        if self.mitigation:
            out += f"\n    fix: {self.mitigation}"
        return out


@dataclass
class Report:
    diagnostics: list[Diagnostic] = field(default_factory=list)
    suppressed: list[Diagnostic] = field(default_factory=list)
    #: stable operator label -> structural fingerprint (hex)
    fingerprints: dict[str, str] = field(default_factory=dict)
    #: analyzed graph shape (operator/sink/source counts)
    stats: dict[str, Any] = field(default_factory=dict)
    script: str | None = None

    def worst_severity(self) -> str | None:
        worst = None
        for d in self.diagnostics:
            if worst is None or SEVERITIES.index(d.severity) > SEVERITIES.index(worst):
                worst = d.severity
        return worst

    def exit_code(self, fail_on: str = "warning") -> int:
        """0 clean/info, 1 warnings, 2 errors — thresholded by
        ``fail_on`` ('error' ignores warnings, 'never' always exits 0)."""
        worst = self.worst_severity()
        code = {None: 0, "info": 0, "warning": 1, "error": 2}[worst]
        if fail_on == "never":
            return 0
        if fail_on == "error" and code == 1:
            return 0
        return code

    def by_id(self, diag_id: str) -> list[Diagnostic]:
        return [d for d in self.diagnostics if d.id == diag_id]

    def to_dict(self) -> dict[str, Any]:
        return {
            "script": self.script,
            "diagnostics": [d.to_dict() for d in self.diagnostics],
            "suppressed": [d.to_dict() for d in self.suppressed],
            "fingerprints": dict(self.fingerprints),
            "stats": dict(self.stats),
            "summary": {
                s: sum(1 for d in self.diagnostics if d.severity == s)
                for s in SEVERITIES
            },
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=False)

    def render(self, fingerprints: bool = True) -> str:
        lines: list[str] = []
        head = self.script or "<current graph>"
        lines.append(f"== pathway-tpu lint: {head} ==")
        for d in self.diagnostics:
            lines.append(d.render())
        if self.suppressed:
            lines.append(
                f"({len(self.suppressed)} finding(s) suppressed by "
                "`# pathway: ignore[...]`)"
            )
        if fingerprints and self.fingerprints:
            lines.append("operator fingerprints:")
            for label, fp in self.fingerprints.items():
                lines.append(f"  {label:<28} {fp}")
        counts = {
            s: sum(1 for d in self.diagnostics if d.severity == s)
            for s in SEVERITIES
        }
        lines.append(
            f"{counts['error']} error(s), {counts['warning']} warning(s), "
            f"{counts['info']} info — "
            f"{len(self.fingerprints)} operator(s) analyzed"
        )
        return "\n".join(lines)
