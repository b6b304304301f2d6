"""The port's command line (``pathway_tpu_torch/cli.py``), its supervisor, ``top`` and
``trace_merge``, and the record and replay branches behind ``spawn --record`` and ``replay``,
against the JAX package's, on the CPU.

- The reference's own cases run through both packages (``tests/torch_case_runs.py``):
  ``tests/test_ported_cli.py`` (record and replay through the command line),
  ``tests/test_ops_surface.py``'s two command-line cases, the 14 cases of
  ``tests/test_lint_cli.py`` and the cases of ``tests/test_supervise.py`` that need neither a
  fault plan nor two processes (``LEFT_OUT`` gives each case left out its reason). On the port's
  side each program the case writes or spawns names the port (``pw.run(device="cpu")``, ``-m
  pathway_tpu_torch.cli``), ``lint`` runs with ``--device cpu`` over the port's own examples,
  and ``click.testing.CliRunner`` is a shim over the port's ``main(argv)`` that catches its exit
  code and captures stdout and stderr as one output, as ``CliRunner`` does.
- Replay parity: one recorded program through both packages' command lines, each on its own
  store, in batch and speedrun modes. At 1 worker the two packages give the same tables and
  timestamp counts. At 2 workers (``-t 2``) the reference's replay does not finish: only the
  source's owner recorded, and it ticks its recorded batches through the Exchange alone (its
  peer is already in the streaming loop under async; under BSP the loop's collective gets a
  ``None`` vote). The port ticks the union of the workers' recorded times in lock step, as its
  recovery does, so the port's 2-worker replay is held to the reference's 1-worker one.
- A supervised recovery under the port's ``spawn --supervise``: a persisted program SIGKILLs
  itself in generation 0 once a commit covers part of its input; generation 1
  (``PATHWAY_RESTART_COUNT=1``) restores and finishes; one crash bundle is harvested; the final
  table equals the reference's uninterrupted run of the same program.
- ``trace merge``: both packages' ``merge_trace`` give the same document over a part a port run
  wrote and over two crafted parts of one run, and both refuse parts of two runs.
- The command line, the supervisor, ``top`` and ``trace_merge`` load neither JAX, nor the JAX
  package, nor ``click``; the options that need a module the port lacks refuse, naming their
  ``ROADMAP.md`` item.

Tolerance: none. Tables, exit codes and rendered text are compared exactly; only wall-clock
fields are left out.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import textwrap

import pytest

from torch_case_runs import TESTS, Side, case_args, cases, run_case

ROOT = os.path.dirname(TESTS)
PACKAGES = ("pathway_tpu", "pathway_tpu_torch")
PORT = "pathway_tpu_torch"

#: the reference's cases of these modules that are not run through the port, with the reason
LEFT_OUT = {
    "test_sharded_sigkill_supervised_recovery":
        "two processes and a fault plan (parallel/cluster.py and chaos/ are not ported)",
    "test_chaos_injections_metric": "arms a fault plan (chaos/ is not ported)",
    "test_planned_stop_chaos_crash_propagates":
        "raises chaos.injector.ChaosInjected (chaos/ is not ported)",
    "test_poll_hook_chaos_crash_propagates":
        "raises chaos.injector.ChaosInjected (chaos/ is not ported)",
}

#: source rewrites that point the programs a case writes or spawns at the port
REWRITES = {
    "test_ported_cli": {
        '"-m", "pathway_tpu.cli"': '"-m", "pathway_tpu_torch.cli"',
        "import pathway_tpu as pw\n\nrows_to_generate":
            "import pathway_tpu_torch as pw\n\nrows_to_generate",
        "pw.run()\ntimestamp_file": 'pw.run(device="cpu")\ntimestamp_file',
    },
    "test_ops_surface": {'"-m", "pathway_tpu.cli"': '"-m", "pathway_tpu_torch.cli"'},
    "test_lint_cli": {
        "p.write_text(textwrap.dedent(body))":
            'p.write_text(textwrap.dedent(body).replace("pathway_tpu", "pathway_tpu_torch"))',
        'os.path.join(REPO, "examples"': 'os.path.join(REPO, "pathway_tpu_torch", "examples"',
    },
    "test_supervise": {},
}

_OPS_CLI = ["test_cli_spawn_sets_environment", "test_cli_replay_sets_replay_env"]
CASES = ([c for c in cases(["test_ported_cli", "test_lint_cli", "test_supervise"])
          if c[1] not in LEFT_OUT]
         + [c for c in cases(["test_ops_surface"]) if c[1] in _OPS_CLI])


class _Result:
    def __init__(self, exit_code: int, output: str) -> None:
        self.exit_code = exit_code
        self.output = output


class PortCliRunner:
    """``click.testing.CliRunner`` over the port's ``main(argv)``: its exit code, and stdout and
    stderr captured as one output. ``lint`` runs on the CPU."""

    def invoke(self, main, args) -> _Result:
        args = list(args)
        if args[:1] == ["lint"]:
            args = ["lint", "--device", "cpu", *args[1:]]
        out = io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(out):
            try:
                code = main(args)
            except SystemExit as e:
                code = e.code
        return _Result(code if isinstance(code, int) else 1, out.getvalue())


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in ("PATHWAY_STATE_MEMORY_BUDGET_MB", "PATHWAY_LINT_WORKERS", "PATHWAY_THREADS",
                "PATHWAY_FLIGHT_DIR", "PATHWAY_TRACE_FILE", "PATHWAY_SUPERVISED",
                "PATHWAY_RESTART_COUNT", "PATHWAY_LAST_RESTART_REASON",
                "PATHWAY_SUPERVISE_WINDOW_FAILURES", "PATHWAY_REPLAY_STORAGE",
                "PATHWAY_SNAPSHOT_ACCESS", "PATHWAY_PERSISTENCE_MODE",
                "PATHWAY_CONTINUE_AFTER_REPLAY", "PATHWAY_MONITORING_HTTP_SERVER"):
        monkeypatch.delenv(var, raising=False)


def test_no_reference_case_is_left_out_without_a_reason():
    names = {n for _, n in cases(["test_ported_cli", "test_lint_cli", "test_supervise"])}
    assert set(LEFT_OUT) <= names
    assert len(CASES) == len(names) - len(LEFT_OUT) + len(_OPS_CLI)
    assert len([c for c in CASES if c[0] == "test_lint_cli"]) == 14
    assert len([c for c in CASES if c[0] == "test_supervise"]) == 12


@pytest.mark.parametrize("module,name", CASES, ids=[n for _, n in CASES])
def test_reference_case(module, name, tmp_path, monkeypatch):
    runs = {}
    args = case_args(module, name)
    for pkg in PACKAGES:
        side = Side(pkg, reference_modules=("chaos",))
        tmp = tmp_path / pkg
        tmp.mkdir()
        port = pkg == PORT
        prepare = (lambda env: env.update(CliRunner=PortCliRunner) or {}) if port else None
        with pytest.MonkeyPatch.context() as mp:
            fixtures = {"tmp_path": tmp, "monkeypatch": mp}
            run_case(module, name, side, prepare=prepare,
                     rewrite=REWRITES[module] if port else None,
                     **{k: v for k, v in fixtures.items() if k in args})
        runs[pkg] = side.tables
    assert runs[PORT] == runs["pathway_tpu"]


def test_port_cli_runner_is_used_for_lint(tmp_path):
    """The shim runs the port's ``lint`` (the port's exit codes and report), not the
    reference's."""
    import pathway_tpu_torch.cli as cli

    p = tmp_path / "clean.py"
    p.write_text("import pathway_tpu_torch as pw\nt = pw.debug.table_from_markdown('a\\n1')\n"
                 "pw.io.subscribe(t, on_change=lambda **kw: None)\npw.run()\n")
    r = PortCliRunner().invoke(cli.main, ["lint", str(p)])
    assert r.exit_code == 0, r.output
    assert "0 error(s), 0 warning(s)" in r.output


# -- replay parity ---------------------------------------------------------------------------

PARITY_PROGRAM = '''
import collections
import json
import pathlib
import sys
import threading

import {pkg} as pw

rows = int(sys.argv[1])
out = pathlib.Path(sys.argv[2])


class Subject(pw.io.python.ConnectorSubject):
    def run(self):
        for i in range(rows):
            self.next(k=i % 3, v=2 * i + 1)
            if i % 2 == 1:
                self.commit()
        self.commit()


t = pw.io.python.read(Subject(), schema=pw.schema_from_types(k=int, v=int),
                      autocommit_duration_ms=None, name="gen")
res = t.groupby(pw.this.k).reduce(pw.this.k, s=pw.reducers.sum(pw.this.v),
                                  c=pw.reducers.count())
times, rows_seen = set(), collections.Counter()
lock = threading.Lock()


def on_change(key, row, time, is_addition):
    with lock:
        times.add(time)
        rows_seen[(row["k"], row["s"], row["c"])] += 1 if is_addition else -1


pw.io.subscribe(res, on_change=on_change)
pw.run({run_kw})
out.write_text(json.dumps({{"times": len(times),
                            "table": sorted(list(r) for r, n in rows_seen.items() if n > 0)}}))
'''


def _cli(pkg: str, argv: list, cwd, timeout: float = 120) -> subprocess.CompletedProcess:
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": ROOT,
           "PATHWAY_INGEST_COALESCE_WINDOWS": "0"}
    r = subprocess.run([sys.executable, "-m", f"{pkg}.cli", *argv], env=env, cwd=cwd,
                       capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, (pkg, argv, r.stderr[-3000:])
    return r


def _recorded_runs(pkg: str, d, workers: int, labels=None) -> dict:
    """Record 8 rows (4 commits and a last empty one), replay in batch and speedrun modes, and
    replay with ``--continue`` while 5 more rows come (not recorded), then replay again (the
    runs in ``labels`` only, when given)."""
    d.mkdir()
    prog = d / "prog.py"
    prog.write_text(PARITY_PROGRAM.format(
        pkg=pkg, run_kw='device="cpu"' if pkg == PORT else ""))
    rec = str(d / "rec")
    t = ["-t", str(workers)]
    runs = {}
    for label, argv, rows in (
            ("record", ["spawn", *t, "--record", "--record-path", rec], 8),
            ("batch", ["replay", *t, "--record-path", rec, "--mode", "batch"], 0),
            ("speedrun", ["replay", *t, "--record-path", rec, "--mode", "speedrun"], 0),
            ("continue", ["replay", *t, "--record-path", rec, "--mode", "speedrun",
                          "--continue"], 5),
            ("again", ["replay", *t, "--record-path", rec, "--mode", "speedrun"], 0)):
        if labels is not None and label not in labels:
            continue
        out = d / f"{label}.json"
        _cli(pkg, [*argv, sys.executable, str(prog), str(rows), str(out)], d)
        runs[label] = json.loads(out.read_text())
    return runs


def _hold_replays(runs: dict, recorded_times: int) -> None:
    """Batch replays in one timestamp, speedrun in the recorded ones; every replay without
    ``--continue`` gives the recorded table, and ``--continue`` adds the fresh rows."""
    assert runs["batch"]["times"] == 1
    assert runs["speedrun"]["times"] == recorded_times
    for label in ("batch", "speedrun", "again"):
        if label in runs:
            assert runs[label]["table"] == runs["record"]["table"], label
    if "again" in runs:
        assert runs["again"]["times"] == recorded_times
        assert runs["continue"]["table"] != runs["record"]["table"]


@pytest.fixture(scope="module")
def one_worker_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("replay")
    return {pkg: _recorded_runs(pkg, d / pkg, 1) for pkg in PACKAGES}


def test_replay_parity_at_one_worker(one_worker_runs):
    for pkg in PACKAGES:
        _hold_replays(one_worker_runs[pkg], one_worker_runs[pkg]["record"]["times"])
    assert one_worker_runs[PORT] == one_worker_runs["pathway_tpu"]
    # every commit its own tick: 4 commits of 2 rows (the last, empty commit adds none)
    assert one_worker_runs[PORT]["record"]["times"] == 4


@pytest.mark.parametrize("async_exec", ["1", "0"], ids=["async", "bsp"])
def test_replay_at_two_workers_against_the_reference_at_one(tmp_path, monkeypatch, async_exec,
                                                          one_worker_runs):
    """The recorded input times are the commits' (4); the recording run's own output times may
    be fewer under the async loop, which lets a commit wave carry several."""
    monkeypatch.setenv("PATHWAY_ASYNC_EXEC", async_exec)
    port = _recorded_runs(PORT, tmp_path / "port", 2, labels=("record", "batch", "speedrun"))
    ref = one_worker_runs["pathway_tpu"]
    _hold_replays(port, ref["speedrun"]["times"])
    for label in ("record", "batch", "speedrun"):
        assert port[label]["table"] == ref[label]["table"], label


def test_record_keeps_the_whole_input_log(tmp_path):
    """Under ``spawn --record`` a commit writes no operator snapshot and truncates no input
    chunk: the tape a replay reads stays whole however often the run commits."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.internals.config import get_pathway_config
    from pathway_tpu_torch.persistence import (
        Backend, Config, PersistenceManager, apply_replay_env,
    )

    os.environ.update(PATHWAY_REPLAY_STORAGE=str(tmp_path / "rec"),
                      PATHWAY_SNAPSHOT_ACCESS="record")
    manager = PersistenceManager(Config.simple_config(Backend.filesystem(str(tmp_path / "rec"))))
    apply_replay_env(manager, get_pathway_config())
    assert manager.record_replay and manager.replay_mode is None
    os.environ.update(PATHWAY_SNAPSHOT_ACCESS="replay", PATHWAY_PERSISTENCE_MODE="speedrun",
                      PATHWAY_CONTINUE_AFTER_REPLAY="1")
    replaying = PersistenceManager(Config.simple_config(Backend.memory()))
    apply_replay_env(replaying, get_pathway_config())
    assert replaying.replay_mode == "speedrun" and replaying.continue_after_replay
    assert not replaying.record_replay
    pw.G.clear()
    for k in ("PATHWAY_REPLAY_STORAGE", "PATHWAY_SNAPSHOT_ACCESS", "PATHWAY_PERSISTENCE_MODE",
              "PATHWAY_CONTINUE_AFTER_REPLAY"):
        os.environ.pop(k, None)

    d = tmp_path / "prog"
    d.mkdir()
    prog = d / "prog.py"
    prog.write_text(PARITY_PROGRAM.format(pkg=PORT, run_kw='device="cpu"'))
    rec = d / "rec"
    _cli(PORT, ["spawn", "--record", "--record-path", str(rec), sys.executable, str(prog),
                "40", str(d / "out.json")], d)
    files = [os.path.relpath(os.path.join(p, f), rec) for p, _, fs in os.walk(rec) for f in fs]
    assert files and not [f for f in files if f.startswith("ops/")], files
    meta = json.loads((rec / "meta" / sorted(os.listdir(rec / "meta"))[-1]).read_text())
    assert meta["first_chunk"] == 0
    assert meta["offsets"]["gen"]["rows"] == 40


# -- supervised recovery ---------------------------------------------------------------------

SUPERVISED_PROGRAM = '''
import json
import os
import signal
import sys
import time

import {pkg} as pw
from {pkg}.persistence import Backend, Config

out_path, pstate, n_words, kill_at = sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
gen = os.environ.get("PATHWAY_RESTART_COUNT")
with open(out_path, "a") as f:
    f.write(json.dumps(["gen", gen, os.environ.get("PATHWAY_LAST_RESTART_REASON")]) + "\\n")
WORDS = [["foo", "bar", "foo", "baz"][i % 4] + str(i % 7) for i in range(n_words)]
killing = os.environ.get("PATHWAY_SUPERVISED") == "1" and gen == "0"


def covered() -> int:
    d = os.path.join(pstate, "meta")
    names = sorted(n for n in os.listdir(d) if ".tmp" not in n) if os.path.isdir(d) else []
    for name in reversed(names):
        try:
            with open(os.path.join(d, name)) as f:
                return json.load(f)["offsets"].get("words", {{}}).get("rows", 0)
        except (OSError, ValueError):
            continue
    return 0


class S(pw.io.python.ConnectorSubject):
    def run(self):
        for i, w in enumerate(WORDS):
            self.next(word=w)
            self.commit()
            time.sleep(0.01)
            if killing and i + 1 == kill_at:
                # the newest rows' commit waits for a tick after them: half of them will do
                deadline = time.monotonic() + 60
                while covered() < kill_at // 2 and time.monotonic() < deadline:
                    time.sleep(0.01)
                os.kill(os.getpid(), signal.SIGKILL)


t = pw.io.python.read(S(), schema=pw.schema_from_types(word=str), name="words",
                      autocommit_duration_ms=None)
counts = t.groupby(pw.this.word).reduce(pw.this.word, c=pw.reducers.count())
f = open(out_path, "a")


def on_change(key, row, time, is_addition):
    f.write(json.dumps([row["word"], int(row["c"]), bool(is_addition)]) + "\\n")
    f.flush()


pw.io.subscribe(counts, on_change=on_change)
pw.run({run_kw}persistence_config=Config.simple_config(Backend.filesystem(pstate),
                                                       snapshot_interval_ms=10))
'''


def _events(path) -> list:
    out = []
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                try:  # a SIGKILL may tear the last line
                    out.append(json.loads(line))
                except ValueError:
                    pass
    return out


def _final(events: list) -> dict:
    final: dict = {}
    for e in events:
        if e[0] == "gen":
            continue
        word, c, add = e
        if add:
            final[word] = c
        elif final.get(word) == c:
            del final[word]
    return final


def test_supervised_recovery_through_the_port_cli(tmp_path):
    n_words, kill_at = 60, 24
    runs = {}
    for pkg in PACKAGES:
        d = tmp_path / pkg
        d.mkdir()
        prog = d / "prog.py"
        prog.write_text(SUPERVISED_PROGRAM.format(
            pkg=pkg, run_kw='device="cpu", ' if pkg == PORT else ""))
        out = d / "events.jsonl"
        argv = [sys.executable, str(prog), str(out), str(d / "pstate"), str(n_words),
                str(kill_at)]
        if pkg == PORT:
            env = {**os.environ, "PYTHONPATH": ROOT, "PATHWAY_FLIGHT_DIR": str(d / "flight"),
                   "PATHWAY_SUPERVISE_BACKOFF_S": "0.05",
                   "PATHWAY_SUPERVISE_BACKOFF_MAX_S": "0.2"}
            r = subprocess.run([sys.executable, "-m", "pathway_tpu_torch.cli", "spawn",
                                "--supervise", *argv], env=env, cwd=d, capture_output=True,
                               text=True, timeout=300)
            assert r.returncode == 0, r.stderr[-4000:]
            runs["stderr"] = r.stderr
            runs["flight"] = sorted(os.listdir(d / "flight"))
        else:  # the reference, uninterrupted and unsupervised
            env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": ROOT}
            r = subprocess.run(argv, env=env, cwd=d, capture_output=True, text=True,
                               timeout=300)
            assert r.returncode == 0, r.stderr[-4000:]
        runs[pkg] = _events(out)
    port = runs[PORT]
    gens = [e for e in port if e[0] == "gen"]
    assert [g[1] for g in gens] == ["0", "1"], runs["stderr"][-2000:]
    assert gens[0][2] is None
    assert "process 0" in gens[1][2] and "exited with -9" in gens[1][2]
    assert "crash-0-0.json" in gens[1][2]
    crashes = [n for n in runs["flight"] if n.startswith("crash-")]
    assert crashes == ["crash-0-0.json"], runs["flight"]
    bundle = json.loads((tmp_path / PORT / "flight" / "crash-0-0.json").read_text())
    assert bundle["generation"] == 0 and bundle["process"] == 0
    assert bundle["last_ticks"], bundle["records"][-5:]
    # the kill landed mid-stream: generation 0 had not counted every word
    upto = port.index(gens[1])
    assert _final(port[:upto]) != _final(runs["pathway_tpu"])
    assert _final(port) == _final(runs["pathway_tpu"])
    assert sum(_final(port).values()) == n_words


# -- trace merge -------------------------------------------------------------------------------


def _crafted_parts(base, run_ids=("r1", "r1")) -> None:
    for proc, run_id in enumerate(run_ids):
        events = [
            {"name": "trace.clock_sync", "ph": "M", "pid": 100 + proc, "args": {
                "process_id": proc, "origin_unix_ns": 1_700_000_000_000_000_000 + proc * 5_000,
                "run_id": run_id,
                "clock_offsets": {"0": [1500.0, 20.0]} if proc else {}}},
            {"name": "process_name", "ph": "M", "pid": 100 + proc, "args": {"name": "x"}},
            {"name": "tick", "ph": "X", "pid": 100 + proc, "tid": 0, "ts": 10.0 + proc,
             "dur": 4.0},
            {"name": "wave.commit", "ph": "X", "pid": 100 + proc, "tid": 1, "ts": 20.0,
             "dur": 900.0 + proc, "args": {"epoch": 3, "T": 7, "holder": proc,
                                           "critical": "drain"}},
            {"name": "send", "ph": "s" if proc == 0 else "f", "id": 42, "pid": 100 + proc,
             "tid": 0, "ts": 12.0},
        ]
        with open(f"{base}.p{proc}", "w") as f:
            json.dump({"traceEvents": events}, f)


def _merged(pkg: str, base: str, out: str, **kw) -> tuple[dict, dict]:
    import importlib

    tm = importlib.import_module(f"{pkg}.observability.trace_merge")
    path, report = tm.merge_trace(base, output=out, **kw)
    with open(path) as f:
        doc = json.load(f)
    return doc, {**report, "waves": tm.wave_spans(doc)}


def test_trace_merge_of_crafted_parts_in_both_packages(tmp_path):
    base = str(tmp_path / "run.json")
    _crafted_parts(base)
    ref = _merged("pathway_tpu", base, str(tmp_path / "ref.json"))
    got = _merged(PORT, base, str(tmp_path / "port.json"))
    assert got == ref
    assert got[1]["n_parts"] == 2 and got[1]["n_flows"] == 2 and got[1]["run_id"] == "r1"
    assert [w["pid"] for w in got[1]["waves"]] == [1, 0]


def test_trace_merge_refuses_mixed_runs_in_both_packages(tmp_path):
    import importlib

    base = str(tmp_path / "run.json")
    _crafted_parts(base, run_ids=("r1", "r2"))
    messages = []
    for pkg in PACKAGES:
        tm = importlib.import_module(f"{pkg}.observability.trace_merge")
        with pytest.raises(ValueError) as e:
            tm.merge_trace(base)
        messages.append(str(e.value))
        doc, report = _merged(pkg, base, str(tmp_path / f"{pkg}.json"), allow_mixed_runs=True)
        assert report["n_parts"] == 2
    assert messages[0] == messages[1] and "different run ids" in messages[0]
    import pathway_tpu_torch.cli as cli

    r = PortCliRunner().invoke(cli.main, ["trace", "merge", base])
    assert r.exit_code == 1 and r.output.startswith("Error: trace parts carry different run ids")


def test_trace_merge_of_a_port_run(tmp_path, monkeypatch):
    import pathway_tpu_torch as pw
    import pathway_tpu_torch.cli as cli
    from pathway_tpu_torch.internals import tracing

    base = str(tmp_path / "trace.json")
    monkeypatch.setenv("PATHWAY_TRACE_FILE", base)
    monkeypatch.setenv("PATHWAY_RUN_ID", "feedc0de")
    pw.G.clear()
    try:
        t = pw.debug.table_from_markdown("a | b\n1 | 2\n3 | 4\n5 | 6")
        res = t.groupby(pw.this.a % 2).reduce(s=pw.reducers.sum(pw.this.b))
        pw.io.subscribe(res, on_change=lambda **kw: None)
        pw.run(device="cpu")
    finally:
        pw.G.clear()
        tracing.deactivate()
    ref = _merged("pathway_tpu", base, str(tmp_path / "ref.json"))
    got = _merged(PORT, base, str(tmp_path / "port.json"))
    assert got == ref
    assert got[1]["n_parts"] == 1 and got[1]["run_id"] == "feedc0de" and got[1]["n_events"] > 3
    r = PortCliRunner().invoke(cli.main, ["trace", "merge", base, "-o",
                                          str(tmp_path / "cli.json")])
    assert r.exit_code == 0, r.output
    assert r.output == (f"merged 1 part(s), {got[1]['n_events']} events (0 flow events) -> "
                        f"{tmp_path / 'cli.json'}\n")
    with open(tmp_path / "cli.json") as f:
        assert json.load(f) == got[0]


# -- the command line itself -------------------------------------------------------------------


def test_help_lists_every_command():
    r = subprocess.run([sys.executable, "-m", "pathway_tpu_torch.cli", "--help"],
                       env={**os.environ, "PYTHONPATH": ROOT}, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    for name in ("spawn", "replay", "rescale", "top", "critpath", "profile", "dlq", "lint",
                 "trace"):
        assert f"\n    {name} " in r.stdout, (name, r.stdout)


_NO_JAX = textwrap.dedent("""
    import importlib.abc
    import sys

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "pathway_tpu", "click"):
                raise ImportError("blocked: " + name)
            return None

    sys.meta_path.insert(0, Block())
    import pathway_tpu_torch.cli as cli
    import pathway_tpu_torch.observability.top
    import pathway_tpu_torch.observability.trace_merge
    import pathway_tpu_torch.parallel.supervisor
    import pathway_tpu_torch.rescale.render
    assert cli.main(["dlq", "/nonexistent"]) == 1
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "pathway_tpu", "click"))
    assert not loaded, loaded
    print("NO-JAX-OK")
""")


def test_cli_supervisor_top_and_trace_merge_load_no_jax_and_no_click():
    r = subprocess.run([sys.executable, "-c", _NO_JAX], env={**os.environ, "PYTHONPATH": ROOT},
                       capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip() == "NO-JAX-OK"


@pytest.mark.parametrize("argv,item", [
    (["spawn", "-n", "2", "python", "x.py"], "ROADMAP.md Queue 1 item 9"),
    (["spawn", "--addresses", "a:1", "python", "x.py"], "ROADMAP.md Queue 1 item 9"),
    (["spawn", "-p", "0", "python", "x.py"], "ROADMAP.md Queue 1 item 9"),
    (["replay", "-n", "2", "python", "x.py"], "ROADMAP.md Queue 1 item 9"),
    (["spawn", "--autoscale", "1..4", "--store", "s", "python", "x.py"],
     "ROADMAP.md Queue 1 item 13, its last part"),
    (["spawn", "--upgrade-to", "new.py", "--store", "s", "python", "x.py"],
     "ROADMAP.md Queue 1 item 13, its last part"),
    (["upgrade", "store", "new.py"], "ROADMAP.md Queue 1 item 13, its last part"),
], ids=["processes", "addresses", "process-ids", "replay-processes", "autoscale", "upgrade-to",
        "upgrade"])
def test_refusals_name_their_roadmap_item(argv, item):
    import pathway_tpu_torch.cli as cli

    r = PortCliRunner().invoke(cli.main, argv)
    assert r.exit_code == 1
    assert r.output.startswith("Error: ") and item in r.output, r.output


@pytest.mark.parametrize("argv", [["spawn", "--bogus-option"], ["replay", "--mode", "fast"],
                                  ["rescale", "store"], ["lint", "/no/such/script.py"],
                                  ["trace"], []],
                         ids=["unknown-option", "bad-choice", "missing-option", "missing-path",
                              "missing-subcommand", "no-command"])
def test_usage_errors_exit_two(argv):
    import pathway_tpu_torch.cli as cli

    assert PortCliRunner().invoke(cli.main, argv).exit_code == 2


@pytest.mark.parametrize("pkg", PACKAGES)
def test_refused_commands_print_the_same_errors(pkg, tmp_path):
    """The refusals both packages share, through each package's command line: the same
    ``Error:`` line on stderr and exit code 1."""
    r = subprocess.run([sys.executable, "-m", f"{pkg}.cli", "dlq", str(tmp_path / "none")],
                       env={**os.environ, "PYTHONPATH": ROOT, "JAX_PLATFORMS": "cpu"},
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 1
    assert r.stderr == f"Error: no dead-letter directory at {tmp_path / 'none'}\n"


def test_dlq_rescale_and_top_against_the_reference(tmp_path, monkeypatch):
    """``dlq`` over the same dead letters, ``rescale --dry-run`` over each package's own store of
    the same program, and ``top`` over the same ``/query`` document print the same text in both
    packages (the rescale report's timings left out)."""
    import pathway_tpu.cli as ref_cli
    import pathway_tpu_torch.cli as cli
    from click.testing import CliRunner

    d = tmp_path / "dlq"
    d.mkdir()
    (d / "out.jsonl").write_text(
        "".join(json.dumps({"time": t, "stamp": t * 2, "error": "boom", "row": [t, "x"]}) + "\n"
                for t in range(7)) + "not json\n")
    (d / "other.jsonl").write_text(json.dumps({"time": 1, "error": "e", "row": None}) + "\n")
    for argv in (["dlq", str(d)], ["dlq", str(d), "--sink", "out", "--tail", "2"],
                 ["dlq", str(d), "--tail", "0"], ["dlq", str(d), "--sink", "none"]):
        want = CliRunner().invoke(ref_cli.main, argv)
        got = PortCliRunner().invoke(cli.main, argv)
        assert (got.exit_code, got.output) == (want.exit_code, want.output), argv

    reports = {}
    for pkg in PACKAGES:
        store = tmp_path / f"store-{pkg}"
        prog = tmp_path / f"prog-{pkg}.py"
        prog.write_text(SUPERVISED_PROGRAM.format(
            pkg=pkg, run_kw='device="cpu", ' if pkg == PORT else ""))
        env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": ROOT}
        r = subprocess.run([sys.executable, str(prog), str(tmp_path / f"{pkg}.jsonl"),
                            str(store), "12", "0"], env=env, capture_output=True, text=True,
                           timeout=300)
        assert r.returncode == 0, r.stderr[-3000:]
        runner, main = (PortCliRunner(), cli.main) if pkg == PORT else (CliRunner(),
                                                                        ref_cli.main)
        res = runner.invoke(main, ["rescale", "--dry-run", "--to", "2", str(store)])
        assert res.exit_code == 0, res.output
        lines = res.output.splitlines()
        report = json.loads(lines[-1])
        # the reference names each operator's fingerprint from its manifest; the port's store
        # carries none (ROADMAP.md Queue 3 item 9)
        reports[pkg] = ([re.sub(r"snapshot time \d+", "snapshot time <t>",
                                ln.split(" (fp=")[0].split(" [")[0])
                         for ln in lines[:-1] if "->" in ln or ln.startswith("  rank")],
                        {k: v for k, v in report.items()
                         if k not in ("phase_s", "operators", "snapshot_time")},
                        [{k: v for k, v in op.items() if k not in ("fingerprint", "name")}
                         for op in report["operators"]])
    assert reports[PORT][0] == reports["pathway_tpu"][0]
    assert reports[PORT][2] == reports["pathway_tpu"][2]
    assert reports[PORT][1]["from"] == 1 and reports[PORT][1]["to"] == 2
    assert reports[PORT][1]["dry_run"] is True

    from pathway_tpu.observability.top import render_frame as ref_frame
    from pathway_tpu_torch.observability.top import render_frame

    doc = {"workers": {"0": {"tick_rate": 3.5, "row_rate": 10.0, "stale_s": 2.0}},
           "processes": [0], "window_s": 30.0, "sample_s": 0.5,
           "keyload": {"top": [{"group": 3, "share": 0.625, "dest_rows": {"1": 50, "0": 2}}],
                       "rows_total": 80, "skew": 2.5, "error_bound": 3.0},
           "memory": {"rss_bytes": 2e8, "key_registry_entries": 12.0},
           "alerts": {"active": [{"t": 100.0, "rule": "r", "severity": "warning", "expr": "e",
                                  "op": ">", "threshold": 1, "value": 2.0}]}}
    assert render_frame(doc, now=110.0) == ref_frame(doc, now=110.0)
