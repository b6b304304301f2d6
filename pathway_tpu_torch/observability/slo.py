"""Declarative SLO rules evaluated against the in-cluster signal store.

``PATHWAY_SLO_RULES`` holds inline JSON or a path to a JSON file (the
same convention as ``PATHWAY_FAULT_PLAN``):

.. code-block:: json

    {"rules": [
        {"name": "tick-p95", "expr": "p95(tick_duration_ms)",
         "op": ">", "threshold": 50, "for_s": 5,
         "severity": "critical"},
        {"name": "starved", "expr": "rate(output_rows)",
         "op": "<", "threshold": 1, "for_s": 30}
    ]}

``expr`` is a :class:`~pathway_tpu_torch.observability.timeseries.Signals`
expression — ``op(metric)`` with op in rate/delta/avg/min/max/last/
p50/p95/p99, or a bare metric name (= last). Histogram percentiles read
in milliseconds; the special spellings ``p*(tick_duration_ms)`` /
``p*(e2e_latency_ms)`` alias the underlying ns histogram series. Each
evaluation pass (one per sampler tick) computes the worst value across
workers; a rule whose predicate holds CONTINUOUSLY for ``for_s`` fires
exactly once — it stays ``firing`` (no re-fire storms) until the
predicate clears, which emits a ``resolved`` event.

Every fired alert lands in three places, so it survives every failure
mode the observability arc covers:

- the in-memory :class:`AlertLog` served at ``/alerts`` (live ops);
- the trace stream as an ``slo.alert`` instant event (post-hoc
  timelines: the alert shows *on* the merged Perfetto track);
- the flight-recorder ring (``slo.alert`` record), so a crash bundle
  carries the alerts that preceded death.

Copy of ``pathway_tpu/observability/slo.py``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any

__all__ = ["AlertLog", "Rule", "SloEngine", "load_rules"]

#: /alerts history bound — an alert storm must not grow memory
_HISTORY_MAX = 256

_SEVERITIES = ("info", "warning", "critical")

#: percentile exprs read in ms; these alias the ns histogram series
_METRIC_ALIASES = {
    "tick_duration_ms": "tick_duration",
    "e2e_latency_ms": "e2e_latency",
    "ingest_to_emit_ms": "e2e_latency",
}


@dataclass
class Rule:
    name: str
    expr: str
    threshold: float
    op: str = ">"
    for_s: float = 5.0
    severity: str = "warning"
    window_s: float | None = None  # None = the plane's default window
    # -- evaluation state ---------------------------------------------
    breach_since: float | None = field(default=None, repr=False)
    active: bool = field(default=False, repr=False)

    def __post_init__(self) -> None:
        if self.op not in (">", "<", ">=", "<="):
            raise ValueError(
                f"SLO rule {self.name!r}: op must be one of > < >= <=, "
                f"got {self.op!r}"
            )
        if self.severity not in _SEVERITIES:
            raise ValueError(
                f"SLO rule {self.name!r}: severity must be one of "
                f"{_SEVERITIES}, got {self.severity!r}"
            )
        self.threshold = float(self.threshold)
        self.for_s = float(self.for_s)
        # alias ms-spelled histogram metrics to their ns series
        for alias, real in _METRIC_ALIASES.items():
            self.expr = self.expr.replace(f"({alias})", f"({real})")

    @property
    def higher_is_worse(self) -> bool:
        return self.op in (">", ">=")

    def breaches(self, value: float) -> bool:
        if self.op == ">":
            return value > self.threshold
        if self.op == ">=":
            return value >= self.threshold
        if self.op == "<":
            return value < self.threshold
        return value <= self.threshold


def load_rules(spec: str | None) -> list[Rule]:
    """Parse ``PATHWAY_SLO_RULES`` (inline JSON, or a path to a JSON
    file). Accepts ``{"rules": [...]}`` or a bare list. Raises
    ``ValueError`` on a malformed spec — a typo'd rules file must fail
    loudly at boot, not silently monitor nothing."""
    if not spec or not spec.strip():
        return []
    text = spec
    if not spec.lstrip().startswith(("{", "[")):
        try:
            with open(spec, encoding="utf-8") as f:
                text = f.read()
        except OSError as e:
            raise ValueError(
                f"PATHWAY_SLO_RULES names file {spec!r} which cannot be "
                f"read: {e}"
            ) from e
    try:
        doc = json.loads(text)
    except json.JSONDecodeError as e:
        raise ValueError(f"PATHWAY_SLO_RULES is not valid JSON: {e}") from e
    entries = doc.get("rules", []) if isinstance(doc, dict) else doc
    if not isinstance(entries, list):
        raise ValueError("PATHWAY_SLO_RULES: expected a list of rules")
    rules: list[Rule] = []
    seen: set[str] = set()
    for i, entry in enumerate(entries):
        if not isinstance(entry, dict):
            raise ValueError(f"PATHWAY_SLO_RULES rule #{i} is not an object")
        unknown = set(entry) - {
            "name", "expr", "threshold", "op", "for_s", "severity",
            "window_s",
        }
        if unknown:
            raise ValueError(
                f"PATHWAY_SLO_RULES rule #{i}: unknown keys {sorted(unknown)}"
            )
        try:
            rule = Rule(**entry)
        except TypeError as e:
            raise ValueError(f"PATHWAY_SLO_RULES rule #{i}: {e}") from e
        if rule.name in seen:
            raise ValueError(
                f"PATHWAY_SLO_RULES: duplicate rule name {rule.name!r}"
            )
        seen.add(rule.name)
        rules.append(rule)
    return rules


def load_rules_from_env() -> list[Rule]:
    return load_rules(os.environ.get("PATHWAY_SLO_RULES"))


class AlertLog:
    """Bounded in-memory alert record — the ``/alerts`` payload."""

    def __init__(self, history_max: int = _HISTORY_MAX):
        self._history: deque = deque(maxlen=history_max)
        self._active: dict[str, dict] = {}
        self._lock = threading.Lock()
        self.fired_total: dict[str, int] = {}

    def fire(self, event: dict) -> None:
        with self._lock:
            self._history.append(event)
            self._active[event["rule"]] = event
            sev = event.get("severity", "warning")
            self.fired_total[sev] = self.fired_total.get(sev, 0) + 1

    def resolve(self, event: dict) -> None:
        with self._lock:
            self._history.append(event)
            self._active.pop(event["rule"], None)

    def document(self) -> dict:
        with self._lock:
            return {
                "active": sorted(
                    self._active.values(), key=lambda e: e["t"]
                ),
                "history": list(self._history),
                "fired_total": dict(self.fired_total),
            }


class SloEngine:
    """Evaluates the rule set against a Signals view once per sampler
    tick; owns the alert log and fans fired alerts out to the trace
    stream and the flight recorder. Never raises into the sampler."""

    def __init__(
        self,
        rules: list[Rule],
        default_window_s: float,
        process_id: int = 0,
    ):
        self.rules = rules
        self.default_window_s = default_window_s
        self.process_id = process_id
        self.alerts = AlertLog()

    def evaluate(self, signals: Any, now: float | None = None) -> None:
        if not self.rules:
            return
        if now is None:
            now = time.time()
        for rule in self.rules:
            try:
                self._evaluate_rule(rule, signals, now)
            except Exception:
                # a rule over a not-yet-sampled metric must not take the
                # evaluator down with it
                continue

    def _evaluate_rule(self, rule: Rule, signals: Any, now: float) -> None:
        window = rule.window_s or self.default_window_s
        # staleness guard: a worker whose series froze (dead worker,
        # cached peer scrape) must not win the worst-worker comparison
        # and hold a rule breaching (or block its resolve) forever —
        # generous bound so scheduler jitter never drops a live worker
        sample_s = getattr(signals, "sample_s", None)
        value, worker = signals.eval_worst(
            rule.expr, window, higher_is_worse=rule.higher_is_worse,
            max_age_s=sample_s * 8 if sample_s else None, now=now,
        )
        if value is None or not rule.breaches(value):
            rule.breach_since = None
            if rule.active:
                rule.active = False
                self._emit(rule, value, worker, now, state="resolved")
            return
        if rule.breach_since is None:
            rule.breach_since = now
        if rule.active:
            return  # fires exactly once while the breach persists
        if now - rule.breach_since + 1e-9 >= rule.for_s:
            rule.active = True
            self._emit(rule, value, worker, now, state="firing")

    def _emit(
        self, rule: Rule, value: float | None, worker: int | None,
        now: float, state: str,
    ) -> None:
        event = {
            "t": round(now, 3),
            "rule": rule.name,
            "state": state,
            "severity": rule.severity,
            "expr": rule.expr,
            "op": rule.op,
            "threshold": rule.threshold,
            "for_s": rule.for_s,
            "value": None if value is None else round(float(value), 4),
            "worker": worker,
            "process": self.process_id,
        }
        if state == "firing":
            self.alerts.fire(event)
        else:
            self.alerts.resolve(event)
        # trace stream: the alert shows ON the merged cluster timeline
        from ..internals.tracing import get_tracer

        tracer = get_tracer()
        if tracer is not None:
            tracer.instant("slo.alert", **event)
        # flight recorder: crash bundles carry the alerts that preceded
        # death (the ring survives SIGKILL)
        from .flightrecorder import get_recorder

        flight = get_recorder()
        if flight is not None:
            flight.record("slo.alert", **event)
