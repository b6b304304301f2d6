"""Run a test function of the JAX package's suite through either package, recording every table
it computes.

The port's parity tests (``tests/test_torch_temporal.py``, ``tests/test_torch_universes.py``) take
the reference's own test functions (``tests/test_temporal.py`` and the others) and call each twice:
once over ``pathway_tpu``, and once with the test module's source executed afresh so that each of
its ``import pathway_tpu...`` statements (at module level and in function bodies) gets
``pathway_tpu_torch``'s module instead, every entry point on the CPU. Module-level objects (custom
accumulators, reducers made from them) are so built by the package under test. Each function's
own assertions hold in both runs. Every table that a run
computes (an assert's left-hand table, ``run_table``, ``GraphRunner.run_tables``,
``debug.table_to_dicts`` / ``table_to_pandas`` and the final table of each ``io.subscribe``) is
recorded as {row key: row}, in order, so the caller can hold the two runs' records equal.
"""

from __future__ import annotations

import ast
import builtins
import importlib
import os
import sys
import threading
import types
from collections import Counter
from typing import Any

import numpy as np
import pytest

TESTS = os.path.dirname(os.path.abspath(__file__))

def norm(v: Any) -> Any:
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, np.ndarray):
        return ("ndarray", v.shape, tuple(v.reshape(-1).tolist()))
    if isinstance(v, tuple):
        return tuple(norm(x) for x in v)
    if isinstance(v, float) and v != v:
        return "nan"
    return v


def norm_table(d: dict) -> dict:
    return {int(k): norm(tuple(r)) for k, r in d.items()}


class _Proxy:
    """Attribute access falls through to ``target`` unless an override is set."""

    def __init__(self, target: Any, **overrides: Any) -> None:
        self._target = target
        self.__dict__.update(overrides)

    def __getattr__(self, name: str) -> Any:
        return getattr(self._target, name)


class Side:
    """One package's bindings for a reference test function, and the tables it recorded."""

    def __init__(self, pkg: str, reference_modules: tuple[str, ...] = (),
                 **pw_overrides: Any) -> None:
        """``pw_overrides``: more of the package's root names to bind in the cases' ``pw`` (an
        entry point with the port's ``device="cpu"``, a recording wrapper).
        ``reference_modules``: subpackages the port does not have (``"autoscale"``) that the
        cases' imports take from the JAX package on the port's side too, so that a case can hand
        the port's output to a reference consumer."""
        self.pkg = pkg
        self.reference_modules = reference_modules
        self.pw_overrides = pw_overrides
        self.port = pkg == "pathway_tpu_torch"
        self.pw = importlib.import_module(pkg)
        self.testing = importlib.import_module(f"{pkg}.testing")
        self.gr = importlib.import_module(f"{pkg}.internals.graph_runner")
        self.tables: list[dict] = []
        self._subs: list[Counter] = []
        self._lock = threading.Lock()
        self.runner = self._runner_class()

    # -- recording entry points ----------------------------------------------------------------

    def _kw(self) -> dict:
        return {"device": "cpu"} if self.port else {}

    def _runner_class(self):
        side = self

        class RecordingRunner(self.gr.GraphRunner):
            def __init__(self, *a: Any, **k: Any) -> None:
                if side.port and not a:
                    k.setdefault("device", "cpu")
                super().__init__(*a, **k)

            def run_tables(self, *tables: Any, **k: Any):
                caps = super().run_tables(*tables, **k)
                for c in caps:
                    side.tables.append(norm_table(dict(c.state.iter_items())))
                return caps

        return RecordingRunner

    def run_table(self, table: Any):
        (cap,) = self.runner().run_tables(table)
        return dict(cap.state.iter_items()), cap.column_names

    def _assert(self, name: str):
        real = getattr(self.testing, name)

        def check(t1: Any, t2: Any, *a: Any, **k: Any) -> None:
            self.runner().run_tables(t1)
            real(t1, t2, *a, **k, **self._kw())

        return check

    def _table_to_dicts(self, table: Any, **k: Any):
        keys, cols = self.pw.debug.table_to_dicts(table, **k, **self._kw())
        self.tables.append(norm_table({key: tuple(cols[c][key] for c in cols) for key in keys}))
        return keys, cols

    def _table_to_pandas(self, table: Any, **k: Any):
        self._table_to_dicts(table)
        return self.pw.debug.table_to_pandas(table, **k, **self._kw())

    def _compute_and_print(self, table: Any, *a: Any, **k: Any):
        self._table_to_dicts(table)
        return self.pw.debug.compute_and_print(table, *a, **k, **self._kw())

    def _subscribe(self, table: Any, on_change: Any = None, *a: Any, **k: Any):
        mult: Counter = Counter()
        self._subs.append(mult)

        def record(key, row, time, is_addition):
            with self._lock:
                kr = (int(key), norm(tuple(row.values())))
                mult[kr] += 1 if is_addition else -1
            if on_change is not None:
                on_change(key=key, row=row, time=time, is_addition=is_addition)

        return self.pw.io.subscribe(table, on_change=record, *a, **k)

    def _run(self, **k: Any) -> None:
        self.pw.run(**k, **self._kw())
        for mult in self._subs:
            self.tables.append({key: row for (key, row), n in mult.items() if n > 0})
        self._subs.clear()

    # -- the bindings -------------------------------------------------------------------------

    def bindings(self) -> dict:
        pw = self.pw
        gr = _Proxy(self.gr, GraphRunner=self.runner)
        proxied = _Proxy(
            pw,
            run=self._run,
            debug=_Proxy(pw.debug, table_to_dicts=self._table_to_dicts,
                         table_to_pandas=self._table_to_pandas,
                         compute_and_print=self._compute_and_print),
            internals=_Proxy(pw.internals, graph_runner=gr),
            io=_Proxy(pw.io, subscribe=self._subscribe),
            **self.pw_overrides,
        )
        out = {
            "pw": proxied,
            "T": self.testing.T,
            "run_table": self.run_table,
            "GraphRunner": self.runner,
        }
        for name in ("assert_table_equality", "assert_table_equality_wo_index",
                     "assert_table_equality_wo_types", "assert_table_equality_wo_index_types"):
            out[name] = self._assert(name)
        return out


def _redirect(env: dict, side: Side, pw: Any):
    """``__import__`` for code whose globals are ``env``: ``pathway_tpu`` and its modules resolve
    to ``side``'s package (``pw`` for the package itself, the recording ``graph_runner``)."""
    real_import = builtins.__import__

    def redirect(name, globals=None, locals=None, fromlist=(), level=0):
        if globals is env and level == 0 and name.split(".")[0] == "pathway_tpu":
            sub = name[len("pathway_tpu"):].lstrip(".")
            pkg = side.pkg
            if sub.split(".")[0] in side.reference_modules or (
                    not sub and fromlist and set(fromlist) <= set(side.reference_modules)):
                pkg = "pathway_tpu"
            mod = importlib.import_module(pkg + ("." + sub if sub else ""))
            if not fromlist:
                return pw
            if sub == "internals.graph_runner":
                return pw.internals.graph_runner
            for attr in fromlist:
                # ``from package import submodule``, as the import statement itself does
                if not hasattr(mod, attr) and hasattr(mod, "__path__"):
                    try:
                        importlib.import_module(f"{mod.__name__}.{attr}")
                    except ModuleNotFoundError:
                        pass
            return mod
        return real_import(name, globals, locals, fromlist, level)

    return redirect


def run_case(module_name: str, name: str, side: Side, prepare=None,
             rewrite: dict[str, str] | None = None, **fixtures: Any) -> list[dict]:
    """Execute the source of test module ``module_name`` afresh over ``side``'s package and call
    its function ``name`` with ``fixtures`` as arguments, and with those that
    ``prepare(module globals)`` returns (fixtures built from the module's own classes); return the
    tables it computed. The fresh module sits in ``sys.modules`` for the call, so its classes
    pickle. ``rewrite`` maps source text to its replacement before the source is compiled (a
    program the case writes to a file or a command it spawns names the package in a string, which
    no import binding reaches); each key must occur in the source."""
    path = os.path.join(TESTS, module_name + ".py")
    mod = types.ModuleType(f"{module_name}__{side.pkg}")
    mod.__file__ = path
    env = mod.__dict__
    binds = side.bindings()
    with open(path) as f:
        source = f.read()
    for old, new in (rewrite or {}).items():
        if old not in source:
            raise AssertionError(f"{module_name}: {old!r} is not in the source to rewrite")
        source = source.replace(old, new)
    code = compile(source, path, "exec")
    side.pw.G.clear()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(builtins, "__import__", _redirect(env, side, binds["pw"]))
        mp.setitem(sys.modules, mod.__name__, mod)
        try:
            exec(code, env)
            env.update({k: v for k, v in binds.items() if k in env})
            if prepare is not None:
                fixtures.update(prepare(env))
            env[name](**fixtures)
        finally:
            side.pw.G.clear()
    return side.tables


def cases(module_names: list[str]) -> list[tuple[str, str]]:
    """(module name, test name) of every test function of the modules, in file order, read from
    their source (nothing is imported at collection)."""
    out = []
    for m in module_names:
        with open(os.path.join(TESTS, m + ".py")) as f:
            tree = ast.parse(f.read())
        out += [(m, n.name) for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name.startswith("test_")]
    return out


def case_args(module_name: str, name: str) -> list[str]:
    """The argument names (fixtures) of test function ``name`` of module ``module_name``."""
    with open(os.path.join(TESTS, module_name + ".py")) as f:
        tree = ast.parse(f.read())
    (fn,) = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == name]
    return [a.arg for a in fn.args.args]
