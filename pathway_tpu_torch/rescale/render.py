"""Human-readable rendering of ``rescale --dry-run``'s report.

Copy of ``render_dry_run`` and ``op_label`` of ``pathway_tpu/upgrade/render.py``
(``upgrade/`` is not ported; its plan renderer stays with it). The port's
manager writes no fingerprint manifest, so a row names its operator by rank
and class alone.
"""

from __future__ import annotations

from typing import Any

__all__ = ["render_dry_run", "op_label"]


def op_label(op: dict[str, Any]) -> str:
    """``rank <r> <Cls>`` plus the identity a human can match across
    reports: the pinned name when one exists, else the fingerprint."""
    ident = []
    if op.get("name"):
        ident.append(f"name={op['name']!r}")
    if op.get("fingerprint"):
        ident.append(f"fp={op['fingerprint']}")
    tail = f" ({', '.join(ident)})" if ident else ""
    return f"rank {op['rank']} {op['cls']}{tail}"


def render_dry_run(report: dict[str, Any]) -> list[str]:
    """The rescale dry-run preview: one line an operator, then the totals."""
    lines = [
        f"dry run: would rescale {report['from']} -> {report['to']} "
        f"worker(s) at snapshot time {report['snapshot_time']} "
        f"(epoch {report['epoch']} -> {report['epoch'] + 1}):"
    ]
    for op in report.get("operators", []):
        mb = op.get("state_bytes", 0) / 1e6
        lines.append(
            f"  {op_label(op)} [{op['mode']}]: {op['action']} "
            f"(source snapshot chunks: {op['chunks_per_source']}, "
            f"state {mb:.2f} MB = {op.get('state_bytes_per_source')} B "
            "per source, incl. spilled)"
        )
    if not report.get("operators"):
        lines.append("  (no stateful operator snapshots at that time)")
    total_mb = report.get("state_bytes_total", 0) / 1e6
    lines.append(
        f"  total stateful-operator bytes to redistribute: "
        f"{total_mb:.2f} MB across {report['to']} target worker(s) "
        f"(~{total_mb / max(1, report['to']):.2f} MB/worker)"
    )
    lines.append(
        "  input tail chunks to re-route per source worker: "
        f"{report.get('tail_chunks_per_source')}"
    )
    return lines
