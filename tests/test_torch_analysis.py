"""``pw.analyze`` and lint mode (``analysis/``, ``internals/lintmode.py``) of the port against the
JAX package's, on the CPU.

- The reference's own cases of ``tests/test_analysis.py`` run through both packages
  (``tests/torch_case_runs.py``), ``pw.analyze`` on the port with ``device="cpu"``. Each case's
  own assertions hold in both, and every report the case makes is held to the reference's: the
  diagnostics in order by id, severity, operator label, message and location (a message that
  names the case's temporary directory compared with the directory taken out), the
  operator count and the stats, and every fingerprint by operator label. A fingerprint hashes
  user expressions (``_pw_expr``) structurally and any other compiled closure by its bytecode
  (``_compiled_fn_fp``); on these cases every closure the lowering makes carries its source
  expression or the reference's bytecode, so every fingerprint is the reference's. The
  reference's cross-process case is marked slow; its port counterpart here runs two
  interpreters of the port under different hash seeds.
- The cases of ``tests/test_lint_cli.py`` that need no ``cli.py`` go through
  ``analysis.lint.lint_targets`` in both packages: the same scripts (the port's with its
  package's name), the same exit codes and the same diagnostic ids; the shipped wordcount
  example lints clean in both.
- The analysis runner lowers on its device and starts nothing: no source thread, no executor.

Tolerance: none; reports are compared exactly.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
import threading

import pytest

from torch_case_runs import TESTS, Side, case_args, cases, run_case

ROOT = os.path.dirname(TESTS)
PACKAGES = ("pathway_tpu", "pathway_tpu_torch")

#: the reference's slow case (two interpreters of the reference) is not run through the port
CASES = [c for c in cases(["test_analysis"]) if c[1] != "test_fingerprints_stable_across_processes"]

@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in ("PATHWAY_STATE_MEMORY_BUDGET_MB", "PATHWAY_SINK_DLQ_DIR", "PATHWAY_LINT_WORKERS",
                "PATHWAY_FUSION", "PATHWAY_THREADS"):
        monkeypatch.delenv(var, raising=False)


def _recording_side(pkg: str) -> Side:
    """A side whose ``pw.analyze`` keeps every report it makes (``side.reports``)."""
    import importlib

    pw = importlib.import_module(pkg)
    reports: list = []
    kw = {"device": "cpu"} if pkg == "pathway_tpu_torch" else {}

    def analyze(**k):
        reports.append(pw.analyze(**k, **kw))
        return reports[-1]

    side = Side(pkg, analyze=analyze)
    side.reports = reports
    return side


def _untmp(text, tmp: str):
    return text.replace(tmp, "<tmp>") if isinstance(text, str) else text


def _diagnostics(report, tmp: str) -> list:
    return [(d.id, d.severity, d.operator, _untmp(d.message, tmp), d.location)
            for d in report.diagnostics]


def _stats(report) -> dict:
    return dict(report.stats)


@pytest.mark.parametrize("module,name", CASES, ids=[n for _, n in CASES])
def test_reference_case(module, name, tmp_path, monkeypatch):
    runs = {}
    for pkg in PACKAGES:
        side = _recording_side(pkg)
        tmp = tmp_path / pkg
        tmp.mkdir()
        with pytest.MonkeyPatch.context() as mp:
            fixtures = {"tmp_path": tmp, "monkeypatch": mp}
            run_case(module, name, side,
                     **{k: v for k, v in fixtures.items() if k in case_args(module, name)})
        runs[pkg] = (side.reports, str(tmp))
    (want, wtmp), (got, gtmp) = runs["pathway_tpu"], runs["pathway_tpu_torch"]
    assert len(got) == len(want) and want
    for w, g in zip(want, got):
        assert _diagnostics(g, gtmp) == _diagnostics(w, wtmp)
        assert _stats(g) == _stats(w)
        assert list(g.fingerprints.items()) == list(w.fingerprints.items())


def _user_expression_graph(pw):
    t = pw.debug.table_from_markdown("a | b\n1 | 2\n3 | 4")
    res = t.select(c=pw.this.a * 3 + pw.this.b, d=pw.this.a > 1)
    pw.io.subscribe(res, on_change=lambda **kw: None)
    return res


def test_user_expression_fingerprints_equal_the_reference():
    """A select over a static table: the source's and the select's fingerprints (a user
    expression each) are the reference's; the subscribe's folds in its input's."""
    fps = {}
    for pkg in PACKAGES:
        pw = __import__(pkg)
        pw.G.clear()
        _user_expression_graph(pw)
        kw = {"device": "cpu"} if pkg == "pathway_tpu_torch" else {}
        fps[pkg] = pw.analyze(**kw).fingerprints
        pw.G.clear()
    assert fps["pathway_tpu_torch"] == fps["pathway_tpu"]
    assert len(fps["pathway_tpu"]) == 3


def test_fingerprints_stable_across_processes_on_the_port():
    """The port's counterpart of the reference's slow case: one script fingerprints identically
    in two interpreters under different hash seeds."""
    script = (
        "import json, sys\n"
        "sys.modules['jax'] = None\n"
        "import pathway_tpu_torch as pw\n"
        "t = pw.debug.table_from_markdown('a\\nalpha\\nbeta')\n"
        "res = t.select(c=pw.apply_with_type(\n"
        "    lambda s: s in {'alpha', 'beta', 'gamma', 'delta'}, bool, pw.this.a))\n"
        "pw.io.subscribe(res, on_change=lambda **kw: None)\n"
        "print(json.dumps(pw.analyze(device='cpu').fingerprints))\n"
    )

    def run(seed):
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["PYTHONHASHSEED"] = seed
        out = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        return json.loads(out.stdout.strip().splitlines()[-1])

    first = run("1")
    assert first and first == run("42")


def test_analysis_starts_nothing():
    """The analysis runner lowers a streaming graph without building an executor: the subject's
    thread never starts."""
    import pathway_tpu_torch as pw

    started = threading.Event()

    class Subject(pw.io.python.ConnectorSubject):
        def run(self):
            started.set()

    pw.G.clear()
    t = pw.io.python.read(Subject(), schema=pw.schema_from_types(word=str))
    counts = t.groupby(pw.this.word).reduce(pw.this.word, c=pw.reducers.count())
    pw.io.subscribe(counts, on_change=lambda **kw: None)
    report = pw.analyze(device="cpu")
    pw.G.clear()
    assert not started.wait(0.2)
    assert [d.id for d in report.diagnostics] == ["unbounded-state"]


def test_analyze_defaults_to_the_card():
    import torch

    import pathway_tpu_torch as pw

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    pw.G.clear()
    _user_expression_graph(pw)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pw.analyze()
    pw.G.clear()


# -- the lint driver ---------------------------------------------------------------------------


def _lint_scripts() -> dict:
    """The scripts of ``tests/test_lint_cli.py``, read from its source."""
    import ast

    with open(os.path.join(TESTS, "test_lint_cli.py")) as f:
        tree = ast.parse(f.read())
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Constant) \
                and isinstance(node.value.value, str) and node.targets[0].id.isupper():
            out[node.targets[0].id] = node.value.value
    return out


SCRIPTS = _lint_scripts()

SKEW = """
import pathway_tpu as pw
from pathway_tpu.testing import T

t = T("a\\n1\\n2")
flagged = t.select(flag=pw.this.a > 1)
res = flagged.groupby(pw.this.flag).reduce(
    pw.this.flag, c=pw.reducers.count())
pw.io.subscribe(res, on_change=lambda **kw: None)
pw.run()
"""

#: (case of ``tests/test_lint_cli.py``, files to write, lint_targets keywords, its exit code)
LINT_CASES = [
    ("test_clean_script_exits_zero", {"clean.py": "CLEAN"}, {}, 0),
    ("test_warning_script_exits_one", {"warn.py": "WARNING"}, {}, 1),
    ("test_fail_on_error_ignores_warnings", {"warn.py": "WARNING"}, {"fail_on": "error"}, 0),
    ("test_error_script_exits_two", {"err.py": "ERROR"}, {}, 2),
    ("test_crashing_script_exits_three", {"crash.py": "CRASH"}, {}, 3),
    ("test_fail_on_never_covers_crashes_too", {"crash.py": "CRASH"}, {"fail_on": "never"}, 0),
    ("test_filewide_suppression_cleans_exit", {"sup.py": "SUPPRESSED"}, {}, 0),
    ("test_line_suppression_is_line_scoped", {"wrongline.py": "WRONGLINE"}, {}, 1),
    ("test_directory_target_expands", {"one.py": "CLEAN", "two.py": "CLEAN"}, {"dir": True}, 0),
    ("test_workers_flag_drives_shard_skew", {"skew.py": "SKEW"}, {"n_workers": 4}, 1),
    ("test_workers_flag_drives_shard_skew_at_one", {"skew.py": "SKEW"}, {"n_workers": 1}, 0),
]


def _script(key: str, pkg: str) -> str:
    if key == "SUPPRESSED":
        body = "# pathway: ignore[unbounded-state]\n" + SCRIPTS["WARNING"]
    elif key == "WRONGLINE":
        body = SCRIPTS["WARNING"].replace(
            'name="w")', 'name="w")  # pathway: ignore[unbounded-state]')
    elif key == "SKEW":
        body = SKEW
    else:
        body = SCRIPTS[key]
    return textwrap.dedent(body).replace("pathway_tpu", pkg)


def _lint(pkg: str, d, files: dict, kw: dict):
    import importlib

    lint = importlib.import_module(f"{pkg}.analysis.lint")
    G = importlib.import_module(f"{pkg}.internals.parse_graph").G
    d.mkdir()
    paths = []
    for name, key in files.items():
        p = d / name
        p.write_text(_script(key, pkg))
        paths.append(str(p))
    kw = dict(kw)
    targets = [str(d)] if kw.pop("dir", False) else paths
    if pkg == "pathway_tpu_torch":
        kw["device"] = "cpu"
    G.clear()
    try:
        results, code = lint.lint_targets(targets, **kw)
    finally:
        G.clear()
    docs = [r["doc"] for r in results]
    return code, [(os.path.basename(doc["script"]) if doc["script"] else None,
                   [(x["id"], x["severity"], x.get("operator"), x["message"]) for x in
                    doc["diagnostics"]], len(doc["suppressed"]), sorted(doc["fingerprints"]),
                   "crash" in doc) for doc in docs]


@pytest.mark.parametrize("case,files,kw,code", LINT_CASES, ids=[c[0] for c in LINT_CASES])
def test_lint_targets_as_the_reference_cli(case, files, kw, code, tmp_path):
    want = _lint("pathway_tpu", tmp_path / "ref", files, kw)
    got = _lint("pathway_tpu_torch", tmp_path / "port", files, kw)
    assert want[0] == code
    assert got == want


def test_wordcount_example_lints_clean(tmp_path):
    """``examples/wordcount`` through each package's lint driver: the port's copy of the script
    names the port's package."""
    src = os.path.join(ROOT, "examples", "wordcount")
    for pkg in PACKAGES:
        d = tmp_path / pkg
        d.mkdir()
        for name in os.listdir(src):
            if name.endswith(".py"):
                with open(os.path.join(src, name)) as f:
                    (d / name).write_text(f.read().replace("pathway_tpu", pkg))
        import importlib

        lint = importlib.import_module(f"{pkg}.analysis.lint")
        kw = {"device": "cpu"} if pkg == "pathway_tpu_torch" else {}
        results, code = lint.lint_targets([str(d)], **kw)
        assert code == 0, [r["doc"] for r in results]
        assert results


def test_lint_mode_breadcrumbs_on_the_port(tmp_path):
    """Under lint mode ``pw.run`` records and returns, and tables and sinks carry the script
    lines that built them, as in the reference."""
    import pathway_tpu_torch.analysis.lint as lint

    p = tmp_path / "warn.py"
    p.write_text(_script("WARNING", "pathway_tpu_torch"))
    report, crash = lint.lint_script(str(p), device="cpu")
    assert crash is None
    (d,) = report.by_id("unbounded-state")
    assert d.location is not None and d.location[0] == str(p)
    assert "reduce" in p.read_text().splitlines()[d.location[1] - 1]
