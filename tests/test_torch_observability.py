"""The observability plane of the port (``observability/``, ``engine/http_server.py``,
``internals/tracing.py``, ``telemetry.py``, ``monitoring.py``) against the JAX package's, on the
CPU: the reference's own cases through both packages.

The reference's cases of ``tests/test_observability.py``, ``test_profiler.py``,
``test_signals.py``, ``test_keyload.py``, ``test_flightrecorder.py``, ``test_monitoring.py``, the
single-process cases of ``test_tracing.py`` and the cases of ``test_critpath.py`` that call
``render_report`` run through both packages (``tests/torch_case_runs.py``), every engine run of the
port on the CPU; each case's own assertions hold in both, and every table it computes is held to
the reference's. Two cases of ``test_signals.py`` end by feeding the merged ``/query`` document
to the autoscaler's decider, which the port does not have: on the port's side they feed the
port's document to the reference's decider. The cases of ``top`` (``observability/top.py``)
and of the supervisor's crash bundles (``parallel/supervisor.py``) run through both packages.
Left out, with its reason in ``LEFT_OUT``: the one case that spawns several processes through
the command line.

``tests/test_torch_observability_outputs.py`` holds the documents themselves: the same seeded
inputs give the same bytes in both packages, and live runs of both give the same metrics.

Tolerance: none; every recorded table is compared exactly.
"""

from __future__ import annotations

import ast
import importlib
import os

import pytest

from torch_case_runs import TESTS, Side, case_args, cases, run_case

PACKAGES = ("pathway_tpu", "pathway_tpu_torch")

#: the reference's cases that are not run through the port, with the reason
LEFT_OUT = {
    # two processes spawned through `spawn -n 2`: the cluster is not ported (ROADMAP.md Queue 1
    # item 9)
    "test_multiprocess_trace_files_cross_link": "several processes (parallel/cluster.py)",
}

_MODULES = ["test_observability", "test_profiler", "test_signals", "test_keyload",
            "test_flightrecorder", "test_monitoring", "test_tracing"]


def _params(module: str, name: str) -> list[dict]:
    """The argument sets of a case's ``pytest.mark.parametrize`` (literal lists only), or one
    empty set."""
    with open(os.path.join(TESTS, module + ".py")) as f:
        (fn,) = [n for n in ast.parse(f.read()).body
                 if isinstance(n, ast.FunctionDef) and n.name == name]
    for dec in fn.decorator_list:
        if isinstance(dec, ast.Call) and getattr(dec.func, "attr", "") == "parametrize":
            names = [a.strip() for a in ast.literal_eval(dec.args[0]).split(",")]
            return [dict(zip(names, v if len(names) > 1 else (v,)))
                    for v in ast.literal_eval(dec.args[1])]
    return [{}]


_NAMED = [c for c in cases(_MODULES) if c[1] not in LEFT_OUT] + [
    c for c in cases(["test_critpath"]) if "render_report" in c[1]]
CASES = [(m, n, p) for m, n in _NAMED for p in _params(m, n)]
IDS = [n + (f"[{i}]" if p else "") for i, (m, n, p) in enumerate(CASES)]


def _reset(pkg: str) -> None:
    """The reference modules' autouse fixtures' teardown, for ``pkg``: no flight ring and no
    tracer outlive a case."""
    fr = importlib.import_module(f"{pkg}.observability.flightrecorder")
    if fr._active is not None:
        fr._active.close()
    fr._active = None
    fr._env_sig = None
    importlib.import_module(f"{pkg}.internals.tracing").deactivate()


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in ("PATHWAY_THREADS", "PATHWAY_FLIGHT_DIR", "PATHWAY_TRACE_FILE",
                "PATHWAY_MONITORING_SERVER", "PATHWAY_TELEMETRY_SERVER", "PATHWAY_SLO_RULES",
                "PATHWAY_PROFILE", "PATHWAY_KEYLOAD", "PATHWAY_MONITORING_HTTP_SERVER"):
        monkeypatch.delenv(var, raising=False)
    yield
    for pkg in PACKAGES:
        _reset(pkg)


def test_no_reference_case_is_left_out_without_a_reason():
    names = {n for _, n in cases(_MODULES)}
    assert set(LEFT_OUT) <= names
    assert len(_NAMED) == len(names) - len(LEFT_OUT) + 2


@pytest.mark.parametrize("module,name,params", CASES, ids=IDS)
def test_reference_case(module, name, params, tmp_path, monkeypatch):
    runs = {}
    args = case_args(module, name)
    for pkg in PACKAGES:
        side = Side(pkg, reference_modules=("autoscale",))
        tmp = tmp_path / pkg
        tmp.mkdir()
        with pytest.MonkeyPatch.context() as mp:
            mp.delenv("PATHWAY_FLIGHT_DIR", raising=False)
            fixtures = {"tmp_path": tmp, "monkeypatch": mp}
            try:
                run_case(module, name, side, **params,
                         **{k: v for k, v in fixtures.items() if k in args})
            finally:
                _reset(pkg)
        runs[pkg] = side.tables
    assert runs["pathway_tpu_torch"] == runs["pathway_tpu"]
