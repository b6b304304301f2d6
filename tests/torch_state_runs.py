"""Helpers of the port's rescale and spill tests (``tests/test_torch_rescale.py``,
``tests/test_torch_spill.py``): both packages' modules by name, a reset of the process-wide state
tiers (the spill budget, its counters and the key registry) that a test's knobs armed, and bounded
streaming runs of a python subject through ``pw.run`` that return the final table and the update
multiset.

Every knob a test sets goes through ``monkeypatch``; ``reset_state_tiers`` puts each package's
registry back to the one it had before the test (``monkeypatch.setattr``) and resets the budget
before and after, so a later test file in the same worker process (``--dist loadfile``) sees
neither the budget nor a lowered cap.
"""

from __future__ import annotations

import importlib
import os
import threading
import time
from collections import Counter
from types import SimpleNamespace

from torch_io_runs import run_bounded

PACKAGES = ("pathway_tpu", "pathway_tpu_torch")

KNOBS = ("PATHWAY_STATE_MEMORY_BUDGET_MB", "PATHWAY_STATE_SPILL_DIR",
         "PATHWAY_KEY_REGISTRY_SPILL_DIR", "PATHWAY_KEY_REGISTRY_CAP",
         "PATHWAY_KEY_REGISTRY_OVERFLOW", "PATHWAY_ELASTIC", "PATHWAY_RESCALE_WAIT_S",
         "PATHWAY_MESH_EXCHANGE")


def ns(pkg: str) -> SimpleNamespace:
    """The modules of one package that the tests drive."""
    mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    return SimpleNamespace(
        name=pkg, torch=pkg == "pathway_tpu_torch",
        pw=importlib.import_module(pkg), spill=mod("engine.spill"), K=mod("engine.keys"),
        ops=mod("engine.operators"), ex=mod("engine.executor"), delta=mod("engine.delta"),
        reducers=mod("engine.reducers"), backends=mod("persistence.backends"),
        persistence=mod("persistence"), layout=mod("persistence.layout"),
        snapshots=mod("persistence.snapshots"), rescale=mod("rescale"),
        resharder=mod("rescale.resharder"),
        run={"device": "cpu"} if pkg == "pathway_tpu_torch" else {},
    )


def reset_state_tiers(monkeypatch) -> None:
    """Clear the knobs, reset both packages' budgets and counters, and give each a fresh key
    registry for the test (the previous one comes back at teardown)."""
    for var in KNOBS:
        monkeypatch.delenv(var, raising=False)
    for pkg in PACKAGES:
        p = ns(pkg)
        p.spill._reset_for_tests()
        monkeypatch.setattr(p.K, "_REGISTRY", None)


def arm_budget(monkeypatch, tmp_path, mb: str = "0.01", *, registry_cap: int | None = None,
               pkgs: tuple = PACKAGES) -> None:
    """Set a state budget of ``mb`` MiB with a spill directory under ``tmp_path`` (and a key
    registry cap) for the packages ``pkgs``, and reset their budgets and registries: both
    resolve from the knobs at first use. Arm one package just before its run when both run in a
    test: the two would otherwise share one per-process scratch directory."""
    monkeypatch.setenv("PATHWAY_STATE_MEMORY_BUDGET_MB", mb)
    monkeypatch.setenv("PATHWAY_STATE_SPILL_DIR", str(tmp_path / "-".join(pkgs) / "spill"))
    if registry_cap is not None:
        monkeypatch.setenv("PATHWAY_KEY_REGISTRY_CAP", str(registry_cap))
    for pkg in pkgs:
        p = ns(pkg)
        p.spill._reset_for_tests()
        monkeypatch.setattr(p.K, "_REGISTRY", None)


def stream_run(p, build, batches: list, threads: int, cfg=None, *, mesh: bool = False,
               name: str = "rows", schema: dict | None = None, timeout_s: float = 120.0):
    """One ``pw.run`` over a python subject that sends ``batches`` (dicts of column lists), a
    commit each; ``build(p.pw, table)`` makes the output table. Returns (final table as
    {row key: row tuple}, the updates as a Counter {row tuple: net diff}, negative entries
    kept)."""
    pw = p.pw
    pw.G.clear()
    final: dict = {}
    updates: Counter = Counter()
    lock = threading.Lock()

    class Subject(pw.io.python.ConnectorSubject):
        def run(self):
            for batch in batches:
                self.next_batch(batch)
                self.commit()
                time.sleep(0.02)  # one commit a tick, also on a loaded host

    t = pw.io.python.read(Subject(), schema=pw.schema_from_types(**(schema or {})), name=name,
                          autocommit_duration_ms=None)
    out = build(pw, t)
    names = out.column_names()

    def on_change(key, row, time, is_addition):
        tup = tuple(row[c] for c in names)
        with lock:
            updates[tup] += 1 if is_addition else -1
            if is_addition:
                final[int(key)] = tup
            elif final.get(int(key)) == tup:
                del final[int(key)]

    pw.io.subscribe(out, on_change=on_change)
    saved = {k: os.environ.get(k) for k in ("PATHWAY_THREADS", "PATHWAY_MESH_EXCHANGE")}
    os.environ["PATHWAY_THREADS"] = str(threads)
    os.environ["PATHWAY_MESH_EXCHANGE"] = "1" if mesh else "0"
    try:
        kw = dict(p.run)
        if cfg is not None:
            kw["persistence_config"] = cfg
        run_bounded(pw, timeout_s, **kw)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        pw.G.clear()
    return final, updates


def final_table(pkg: str, prog, monkeypatch, workers: int = 1, async_exec: str | None = None):
    """The run's final table {row key: row} from its subscription; fails on a negative
    multiplicity or two live rows under one key."""
    p = ns(pkg)
    pw = p.pw
    pw.G.clear()
    acc: Counter = Counter()
    lock = threading.Lock()
    table = prog(pw)
    names = table.column_names()

    def on_change(key, row, time, is_addition):
        with lock:
            acc[(int(key), tuple(row[c] for c in names))] += 1 if is_addition else -1

    pw.io.subscribe(table, on_change=on_change)
    monkeypatch.setenv("PATHWAY_THREADS", str(workers))
    if async_exec is not None:
        monkeypatch.setenv("PATHWAY_ASYNC_EXEC", async_exec)
    try:
        run_bounded(pw, 120, **p.run)
    finally:
        monkeypatch.setenv("PATHWAY_THREADS", "1")
        monkeypatch.delenv("PATHWAY_ASYNC_EXEC", raising=False)
        pw.G.clear()
    assert all(n >= 0 for n in acc.values()), f"negative multiplicity: {-acc}"
    live = +acc
    assert all(n == 1 for n in live.values())
    out = {k: r for k, r in live}
    assert len(out) == len(live), "two live rows under one key"
    return out


def keyed_feed(pw, batches: list[tuple[dict, int]], **types):
    """``pw.io.python.read`` of ``batches`` over the schema ``types`` (column ``i`` the primary
    key): each (columns, diff) one ``next_batch`` and a commit, a diff of -1 retracting rows sent
    before under the same key."""
    schema = pw.schema_builder({c: pw.column_definition(primary_key=c == "i", dtype=t)
                                for c, t in types.items()})

    class Feed(pw.io.python.ConnectorSubject):
        def run(self):
            for cols, diff in batches:
                self.next_batch(cols, diffs=[diff] * len(cols["i"]))
                self.commit()
                time.sleep(0.01)

    return pw.io.python.read(Feed(), schema=schema, autocommit_duration_ms=None)


HELD_OPEN_S = 60.0


def held_open_feed(pw, cols: dict, **types):
    """``pw.io.python.read`` of one commit of ``cols`` (column ``i`` the primary key) whose stream
    then stays open until the engine stops the subject, or ``HELD_OPEN_S`` seconds have passed:
    a run over it that raises in less time raised before its stream ended."""
    schema = pw.schema_builder({c: pw.column_definition(primary_key=c == "i", dtype=t)
                                for c, t in types.items()})

    class Feed(pw.io.python.ConnectorSubject):
        def run(self):
            self.next_batch(cols)
            self.commit()
            deadline = time.monotonic() + HELD_OPEN_S
            while not self.stopped and time.monotonic() < deadline:
                time.sleep(0.01)

    return pw.io.python.read(Feed(), schema=schema, autocommit_duration_ms=None)


def raises_before_the_stream_ends(pkg: str, build, match: str) -> None:
    """``pw.run`` at 1 worker over ``build(pw)`` raises ``KeyError`` matching ``match`` well
    before a ``held_open_feed`` stream ends."""
    p = ns(pkg)
    pw = p.pw
    pw.G.clear()
    try:
        pw.io.subscribe(build(pw), on_change=lambda key, row, time, is_addition: None)
        t0 = time.monotonic()
        import pytest

        with pytest.raises(KeyError, match=match):
            pw.run(**p.run)
        assert time.monotonic() - t0 < HELD_OPEN_S / 2, "raised only when the stream ended"
    finally:
        pw.G.clear()
