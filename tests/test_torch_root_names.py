"""The last root names of the port against the JAX package's, on the CPU: ``pw.load_yaml``, the
error-log tables (``pw.global_error_log``, ``pw.local_error_log``), ``LiveTable`` with
interactive mode, and ``pw.viz``.

- The reference's own cases run through both packages (``tests/torch_case_runs.py``):
  ``tests/test_interactive.py``, ``test_viz.py``, ``test_ported_yaml.py``,
  ``test_error_log_ring.py``, ``test_ported_errors.py`` (each error read through
  ``pw.global_error_log()`` or ``pw.local_error_log()``) and the YAML cases of
  ``test_ops_surface.py``. Each case's own assertions hold in both; every table a case computes
  and every ``LiveTable`` snapshot it takes is equal row key by row key. On the port,
  ``Table.live``, the runners and the notebook display run with ``device="cpu"``.
- The error-log tables over a streaming program at 1, 2 and 4 workers, async (the default) and
  BSP (``PATHWAY_ASYNC_EXEC=0``): each error is logged once, in the global log and in the local
  log of the scope that built its expression, and the logs and the output equal the
  reference's at 1 worker.
- ``LiveTable`` under ``PATHWAY_THREADS`` 1, 2 and 4: it runs one executor whatever the worker
  count, as the reference's does, and its snapshot equals the reference's.
- A YAML that names ``TpuEmbedder`` builds the same pipeline in both packages (the port's loader
  maps ``pw.`` to ``pathway_tpu_torch`` and the name to ``TorchEmbedder``); with shared weights
  (``params_from_jax``, f32) the embeddings agree within 2e-5.

Tolerances: 2e-5 for f32 embeddings; none elsewhere: every table is compared exactly.
"""

from __future__ import annotations

import importlib
import os
import sys
import threading
import time
from collections import Counter

import numpy as np
import pytest

from torch_case_runs import Side, case_args, cases, norm, run_case

PACKAGES = ("pathway_tpu", "pathway_tpu_torch")
EMB_ATOL = 2e-5

CASES = cases(["test_interactive", "test_viz", "test_ported_yaml", "test_error_log_ring",
               "test_ported_errors"]) + [
    ("test_ops_surface", n) for n in ("test_yaml_loader", "test_yaml_pw_alias",
                                      "test_yaml_schema_type_names_coerce")]


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in ("PATHWAY_ASYNC_EXEC", "PATHWAY_MESH_EXCHANGE", "PATHWAY_FUSION"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("PATHWAY_THREADS", "1")
    for pkg in PACKAGES:
        importlib.import_module(f"{pkg}.engine.error").ERROR_LOG.clear()
    yield
    for pkg in PACKAGES:
        importlib.import_module(f"{pkg}.engine.error").ERROR_LOG.clear()


def _snapshot_rows(snap) -> dict:
    return {int(k): norm(tuple(r)) for k, r in snap.rows.items()}


def _side(pkg: str, mp: pytest.MonkeyPatch) -> Side:
    """A side whose ``LiveTable`` snapshots are recorded with its tables; on the port the entry
    points that the cases call without arguments run on the CPU."""
    side = Side(pkg)
    interactive = importlib.import_module(f"{pkg}.internals.interactive")
    snapshot = interactive.LiveTable.snapshot

    def recorded(self):
        snap = snapshot(self)
        side.tables.append(_snapshot_rows(snap))
        return snap

    mp.setattr(interactive.LiveTable, "snapshot", recorded)
    if side.port:
        table = importlib.import_module("pathway_tpu_torch.internals.table").Table
        debug = importlib.import_module("pathway_tpu_torch.debug")
        live, to_pandas = table.live, debug.table_to_pandas
        mp.setattr(table, "live", lambda self, device="cpu": live(self, device=device))
        mp.setattr(debug, "table_to_pandas",
                   lambda t, device="cpu", **k: to_pandas(t, device=device, **k))
    return side


@pytest.mark.parametrize("module,name", CASES, ids=[f"{m}::{n}" for m, n in CASES])
def test_reference_case(module, name, tmp_path, capsys):
    runs = {}
    for pkg in PACKAGES:
        importlib.import_module(f"{pkg}.engine.error").ERROR_LOG.clear()
        with pytest.MonkeyPatch.context() as mp:
            side = _side(pkg, mp)
            d = tmp_path / pkg
            d.mkdir()
            fixtures = {"tmp_path": d, "capsys": capsys, "monkeypatch": mp}
            runs[pkg] = run_case(module, name, side, **{
                k: v for k, v in fixtures.items() if k in case_args(module, name)})
    assert runs["pathway_tpu_torch"] == runs["pathway_tpu"]


# -- the error-log tables at 1, 2 and 4 workers ------------------------------------------------


ROWS = [(a, a % 5, a % 7) for a in range(1, 61)]  # b == 0 on 12 rows, c == 0 on 8


def _error_program(pkg: str, commit: int = 10):
    pw = importlib.import_module(pkg)
    pw.G.clear()

    class Feed(pw.io.python.ConnectorSubject):
        def run(self):
            for s in range(0, len(ROWS), commit):
                for a, b, c in ROWS[s:s + commit]:
                    self.next(a=a, b=b, c=c)
                self.commit()

    t = pw.io.python.read(Feed(), schema=pw.schema_from_types(a=int, b=int, c=int),
                          autocommit_duration_ms=None)
    with pw.local_error_log() as log_b:
        xb = t.select(x=pw.this.a // pw.this.b)
    with pw.local_error_log() as log_c:
        xc = t.select(y=pw.this.a // pw.this.c)
    out = t.select(pw.this.a, x=pw.fill_error(xb.x, -1), y=pw.fill_error(xc.y, -1))
    logs = {"global": pw.global_error_log(), "b": log_b, "c": log_c}
    got: dict = {"out": Counter(), **{k: Counter() for k in logs}}
    lock = threading.Lock()

    def keep(into):
        def on_change(key, row, time, is_addition):
            with lock:
                into[tuple(row.values())] += 1 if is_addition else -1
        return on_change

    pw.io.subscribe(out, on_change=keep(got["out"]))
    for name, log in logs.items():
        pw.io.subscribe(log.select(pw.this.message), on_change=keep(got[name]))
    return pw, got


def _run_errors(pkg: str) -> dict:
    pw, got = _error_program(pkg)
    kw = {"device": "cpu"} if pkg == "pathway_tpu_torch" else {}
    pw.run(**kw)
    pw.G.clear()
    return {k: +v for k, v in got.items()}


@pytest.fixture(scope="module")
def reference_errors():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PATHWAY_THREADS", "1")
        importlib.import_module("pathway_tpu.engine.error").ERROR_LOG.clear()
        return _run_errors("pathway_tpu")


@pytest.mark.parametrize("workers,asynced", [(1, True), (2, True), (4, True), (2, False),
                                             (4, False)])
def test_error_logs_by_worker_count(workers, asynced, monkeypatch, reference_errors):
    monkeypatch.setenv("PATHWAY_THREADS", str(workers))
    if not asynced:
        monkeypatch.setenv("PATHWAY_ASYNC_EXEC", "0")
    got = _run_errors("pathway_tpu_torch")
    assert got == reference_errors
    assert got["global"] == Counter({("division by zero",): 20})
    assert got["b"] == Counter({("division by zero",): 12})
    assert got["c"] == Counter({("division by zero",): 8})


@pytest.mark.parametrize("workers", [1, 2, 4])
def test_live_table_by_worker_count(workers, monkeypatch):
    monkeypatch.setenv("PATHWAY_THREADS", str(workers))
    snaps = {}
    for pkg in PACKAGES:
        pw = importlib.import_module(pkg)
        pw.G.clear()
        t = pw.debug.table_from_markdown("k | v\n1 | 2\n1 | 5\n2 | 4\n3 | 1")
        total = t.groupby(pw.this.k).reduce(pw.this.k, s=pw.reducers.sum(pw.this.v))
        live = total.live(**({"device": "cpu"} if pkg == "pathway_tpu_torch" else {}))
        assert live._stopped.wait(20)
        assert not live.failed(), live._error
        snaps[pkg] = _snapshot_rows(live.snapshot())
        pw.G.clear()
    assert snaps["pathway_tpu_torch"] == snaps["pathway_tpu"]
    assert sorted(snaps["pathway_tpu"].values()) == [(1, 7), (2, 4), (3, 1)]


def test_live_table_defaults_to_the_card():
    import torch

    import pathway_tpu_torch as pw

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    pw.G.clear()
    t = pw.debug.table_from_markdown("a\n1")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t.live()
    pw.G.clear()


# -- YAML: one description, both packages -------------------------------------------------------

SMALL = dict(vocab_size=30522, dim=32, n_layers=2, n_heads=2, max_len=64)


def shared_encoder(package: str):
    """The encoder of ``SMALL`` with one set of seeded weights: the JAX package's, and the
    port's from them (``params_from_jax``, f32)."""
    import jax.numpy as jnp

    from pathway_tpu.models import embedder as jemb

    params = jemb.init_params(jemb.EmbedderConfig(**SMALL, dtype=jnp.float32), 11)
    if package == "pathway_tpu":
        return jemb.Embedder(jemb.EmbedderConfig(**SMALL, dtype=jnp.float32), params=params)
    import torch

    from pathway_tpu_torch.models.embedder import Embedder, EmbedderConfig, params_from_jax

    return Embedder(EmbedderConfig(**SMALL, dtype=torch.float32),
                    params=params_from_jax(params, device="cpu"), device="cpu")


YAML = """
$encoder: !test_torch_root_names.shared_encoder
  package: {package}
embedder: !pw.xpacks.llm.embedders.TpuEmbedder
  embedder: $encoder
  max_len: 48
  device: cpu
splitter: !pw.xpacks.llm.splitters.TokenCountSplitter
  max_tokens: 12
"""

TEXTS = ["Dataflow engines keep every result up to date as the input changes.",
         "A brute-force index scores each query against every row.",
         "short"]


def test_yaml_names_the_reference_embedder(monkeypatch):
    monkeypatch.setitem(sys.modules, "tiktoken", None)  # fetched over the network: count words
    built = {}
    for pkg in PACKAGES:
        load_yaml = importlib.import_module(pkg).load_yaml
        built[pkg] = load_yaml(YAML.format(package=pkg))
    ref, port = built["pathway_tpu"], built["pathway_tpu_torch"]
    from pathway_tpu_torch.xpacks.llm.embedders import TorchEmbedder

    assert isinstance(port["embedder"], TorchEmbedder)
    assert type(ref["embedder"]).__name__ == "TpuEmbedder"
    assert list(port) == list(ref) == ["embedder", "splitter"]
    want = np.stack([ref["embedder"].__wrapped__(t) for t in TEXTS])
    got = np.stack([port["embedder"].__wrapped__(t) for t in TEXTS])
    np.testing.assert_allclose(got, want, rtol=0, atol=EMB_ATOL)
    for text in TEXTS:
        assert port["splitter"].__wrapped__(text * 3) == ref["splitter"].__wrapped__(text * 3)


def test_yaml_never_imports_the_reference():
    """``!pathway_tpu.`` and ``!pw.`` tags resolve inside the port."""
    from pathway_tpu_torch.internals.yaml_loader import _resolve_dotted
    from pathway_tpu_torch.xpacks.llm import splitters

    assert _resolve_dotted("pathway_tpu.xpacks.llm.splitters.NullSplitter") is \
        splitters.NullSplitter
    assert _resolve_dotted("pw.xpacks.llm.splitters.NullSplitter") is splitters.NullSplitter
    assert _resolve_dotted("pw").__name__ == "pathway_tpu_torch"
    assert _resolve_dotted("pw.xpacks.llm.embedders.TpuEmbedder").__name__ == "TorchEmbedder"
