"""``pw.temporal``, ``pw.ordered`` and ``pw.statistical`` of the port against the JAX package's, on
the CPU.

- The cases of ``tests/test_temporal.py``, ``test_ported_windows.py``,
  ``test_ported_interval_joins.py``, ``test_ported_asof_window_joins.py`` and ``test_ordered.py``,
  each run through both packages (``tests/torch_case_runs.py``: the reference's ``pw.run()`` and
  the port's ``pw.run(device="cpu")``). Each case's own assertions hold in both, and every table it
  computes is equal, row key by row key.
- Streaming programs over python subjects of seeded numpy rows, a commit a batch, event times in
  order: windows (tumbling with ``instance``, sliding, session, float times, behaviours), the
  interval, window and as-of joins, ``diff`` and ``interpolate``. At 1 worker the port's table
  equals the reference's; at 2 and 4 workers (async, the default) and at 2 under BSP
  (``PATHWAY_ASYNC_EXEC=0``) it equals the reference's 1-worker table.
- Naive datetime event times with timedelta durations: tumbling (under a behaviour), sliding and
  session windows and an as-of join, static, at 1 worker.
- Late rows under a behaviour. At 1 worker the two packages give the same table. At 2 and 4
  workers neither package is deterministic: the watermark of ``BufferUntil`` and ``ForgetAfter``
  is the largest event time that the node's own worker has seen, so which late rows a worker
  drops depends on how arrivals interleave across workers (``ROADMAP.md`` Queue 3, "Not port
  faults"). There each package is held only to what holds whatever the order: the set of windows
  equals the 1-worker one, every on-time row is counted in its window, and each window's count,
  sum and maximum are those of the rows it kept, each of which lies in the window.
- Importing the new modules loads neither ``jax`` nor ``pathway_tpu``.

Tolerance: none. Floats are multiples of a power of two, so sums are exact in any order.
"""

from __future__ import annotations

import datetime
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from torch_case_runs import Side, cases, run_case
from torch_state_runs import final_table as _final_table

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CASE_MODULES = ["test_temporal", "test_ported_windows", "test_ported_interval_joins",
                "test_ported_asof_window_joins", "test_ordered"]
CASES = cases(CASE_MODULES)


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in ("PATHWAY_ASYNC_EXEC", "PATHWAY_MESH_EXCHANGE", "PATHWAY_FUSION"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("PATHWAY_THREADS", "1")


@pytest.mark.parametrize("module,name", CASES, ids=[f"{m}::{n}" for m, n in CASES])
def test_reference_case_through_both_packages(module, name):
    want = run_case(module, name, Side("pathway_tpu"))
    got = run_case(module, name, Side("pathway_tpu_torch"))
    assert got == want
    assert want or name in _NO_TABLE, "the case computed no table"


# cases that only check a build-time error or a dtype
_NO_TABLE = {"test_session_window_creation", "test_interval_join_negative_time_errors"}


# -- streaming programs ------------------------------------------------------------------------


def _stream(n: int, seed: int, *, step: int = 3, k: int = 4, nulls: bool = False,
            late: int = 0) -> list[dict]:
    """``n`` rows in 8 commits: ``t`` ascending (gaps 0..step-1; 1..step-1 with ``nulls``,
    since interpolation divides by the gap), ``k`` in [0, k), ``v`` a
    multiple of 0.25, ``i`` unique. With ``late``, that many extra rows go out 60 time units
    behind the newest, spread over the last 5 commits. With ``nulls``, a fifth of ``v`` is None."""
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.integers(int(nulls), step, n)).astype(int)
    ks = rng.integers(0, k, n)
    v = rng.integers(-40, 400, n) / 4.0
    rows = [{"i": i, "t": int(t[i]), "k": int(ks[i]),
             "v": None if nulls and i % 5 == 2 else float(v[i])} for i in range(n)]
    batches = [rows[i * n // 8:(i + 1) * n // 8] for i in range(8)]
    for j in range(late):
        b = 3 + j % 5
        newest = batches[b][-1]["t"]
        batches[b].append({"i": n + j, "t": max(0, newest - 60), "k": int(ks[j]),
                           "v": float(v[j])})
    return [{c: [r[c] for r in b] for c in ("i", "t", "k", "v")} for b in batches]


def _source(pw, batches: list[dict], *, float_t: bool = False, nulls: bool = False):
    class Feed(pw.io.python.ConnectorSubject):
        def run(self):
            for b in batches:
                if float_t:
                    b = {**b, "t": [x / 2.0 for x in b["t"]]}
                self.next_batch(b)
                self.commit()
                time.sleep(0.01)

    vt = float | None if nulls else float
    schema = pw.schema_from_types(i=int, t=float if float_t else int, k=int, v=vt)
    return pw.io.python.read(Feed(), schema=schema, autocommit_duration_ms=None)


L = _stream(240, 1)
R = _stream(160, 2, step=5)
NULLS = _stream(200, 3, nulls=True)
LATE = _stream(320, 4, late=40)


def _agg(pw, w):
    return w.reduce(start=pw.this._pw_window_start, end=pw.this._pw_window_end,
                    n=pw.reducers.count(), s=pw.reducers.sum(pw.this.v),
                    top=pw.reducers.max(pw.this.v))


def _tumbling_instance(pw):
    t = _source(pw, L)
    w = t.windowby(pw.this.t, window=pw.temporal.tumbling(duration=50), instance=pw.this.k)
    return w.reduce(k=pw.this._pw_instance, start=pw.this._pw_window_start,
                    n=pw.reducers.count(), s=pw.reducers.sum(pw.this.v))


def _sliding(pw):
    t = _source(pw, L)
    return _agg(pw, t.windowby(pw.this.t, window=pw.temporal.sliding(hop=20, duration=60)))


def _session(pw):
    t = _source(pw, R)
    w = t.windowby(pw.this.t, window=pw.temporal.session(max_gap=3), instance=pw.this.k)
    return w.reduce(k=pw.this._pw_instance, start=pw.this._pw_window_start,
                    end=pw.this._pw_window_end, n=pw.reducers.count(),
                    s=pw.reducers.sum(pw.this.v))


def _float_tumbling(pw):
    t = _source(pw, L, float_t=True)
    return _agg(pw, t.windowby(pw.this.t, window=pw.temporal.tumbling(duration=12.5)))


def _exactly_once(pw):
    t = _source(pw, L)
    return _agg(pw, t.windowby(pw.this.t, window=pw.temporal.tumbling(duration=50),
                               behavior=pw.temporal.exactly_once_behavior()))


def _common_behavior(pw):
    t = _source(pw, L)
    return _agg(pw, t.windowby(pw.this.t, window=pw.temporal.tumbling(duration=40),
                               behavior=pw.temporal.common_behavior(delay=10, cutoff=20)))


def _interval_inner(pw):
    a, b = _source(pw, L), _source(pw, R)
    return a.interval_join_inner(b, a.t, b.t, pw.temporal.interval(-4, 4),
                                 pw.left.k == pw.right.k).select(
        li=pw.left.i, ri=pw.right.i, s=pw.left.v + pw.right.v)


def _interval_outer(pw):
    a, b = _source(pw, L), _source(pw, R)
    return a.interval_join_outer(b, a.t, b.t, pw.temporal.interval(0, 2),
                                 pw.left.k == pw.right.k).select(li=pw.left.i, ri=pw.right.i)


def _window_join(pw):
    a, b = _source(pw, L), _source(pw, R)
    return a.window_join_left(b, a.t, b.t, pw.temporal.tumbling(duration=40),
                              a.k == b.k).select(li=pw.left.i, ri=pw.right.i)


def _asof(pw):
    a, b = _source(pw, L), _source(pw, R)
    return a.asof_join(b, a.t, b.t, a.k == b.k).select(li=pw.left.i, ri=pw.right.i,
                                                       bv=pw.right.v)


def _asof_nearest(pw):
    a, b = _source(pw, L), _source(pw, R)
    return a.asof_join(b, a.t, b.t, direction=pw.temporal.Direction.NEAREST).select(
        li=pw.left.i, ri=pw.right.i)


def _diff(pw):
    t = _source(pw, L)
    return t.diff(pw.this.t * 1000 + pw.this.i, pw.this.v, instance=pw.this.k)


def _interpolate(pw):
    t = _source(pw, NULLS, nulls=True)
    return t.interpolate(pw.this.t, pw.this.v)


PROGRAMS = {
    "tumbling_instance": _tumbling_instance, "sliding": _sliding, "session": _session,
    "float_tumbling": _float_tumbling, "exactly_once": _exactly_once,
    "common_behavior": _common_behavior, "interval_inner": _interval_inner,
    "interval_outer": _interval_outer, "window_join_left": _window_join, "asof": _asof,
    "asof_nearest": _asof_nearest, "diff": _diff, "interpolate": _interpolate,
}


_REFERENCE: dict[str, dict] = {}


def _reference_one_worker(prog: str, monkeypatch) -> dict:
    if prog not in _REFERENCE:
        _REFERENCE[prog] = _final_table("pathway_tpu", PROGRAMS[prog], monkeypatch)
    return _REFERENCE[prog]


@pytest.mark.parametrize("prog", list(PROGRAMS))
def test_streaming_one_worker(monkeypatch, prog):
    want = _reference_one_worker(prog, monkeypatch)
    assert want
    assert _final_table("pathway_tpu_torch", PROGRAMS[prog], monkeypatch) == want


@pytest.mark.parametrize("workers,async_exec", [(2, None), (4, None), (2, "0")],
                         ids=["2-async", "4-async", "2-bsp"])
@pytest.mark.parametrize("prog", list(PROGRAMS))
def test_streaming_sharded_equals_the_reference_one_worker(monkeypatch, prog, workers,
                                                           async_exec):
    want = _reference_one_worker(prog, monkeypatch)
    got = _final_table("pathway_tpu_torch", PROGRAMS[prog], monkeypatch, workers, async_exec)
    assert got == want


def _datetime_program(pw) -> list:
    """Naive datetime event times with timedelta durations (the window functions' datetime
    branch): a tumbling window with ``instance`` under ``exactly_once_behavior(shift=)``, a
    sliding window, a session window and an as-of join. The interval join is left out: its
    bucket width is a float of seconds, which a datetime cannot be divided by, so both packages
    log a row error for each row."""
    base = datetime.datetime(2024, 1, 1, 12, 0, 0)
    sec = datetime.timedelta(seconds=1)
    rows = [(base + (7 * i + i % 3) * sec, i % 3, i / 4.0) for i in range(60)]
    t = pw.debug.table_from_rows(pw.schema_from_types(t=datetime.datetime, k=int, v=float), rows)
    r = pw.debug.table_from_rows(pw.schema_from_types(t=datetime.datetime, k=int),
                                 [(base + 11 * i * sec, i % 3) for i in range(30)])
    tumbling = t.windowby(pw.this.t, window=pw.temporal.tumbling(duration=60 * sec),
                          instance=pw.this.k,
                          behavior=pw.temporal.exactly_once_behavior(shift=5 * sec))
    sliding = t.windowby(pw.this.t, window=pw.temporal.sliding(hop=30 * sec, duration=60 * sec))
    session = t.windowby(pw.this.t, window=pw.temporal.session(max_gap=8 * sec),
                         instance=pw.this.k)
    return [
        tumbling.reduce(k=pw.this._pw_instance, start=pw.this._pw_window_start,
                        end=pw.this._pw_window_end, s=pw.reducers.sum(pw.this.v),
                        n=pw.reducers.count()),
        sliding.reduce(start=pw.this._pw_window_start, n=pw.reducers.count()),
        session.reduce(start=pw.this._pw_window_start, end=pw.this._pw_window_end,
                       n=pw.reducers.count()),
        t.asof_join(r, t.t, r.t, t.k == r.k).select(v=pw.left.v, rt=pw.right.t),
    ]


def test_datetime_event_times():
    tables = []
    for pkg in ("pathway_tpu", "pathway_tpu_torch"):
        side = Side(pkg)
        side.pw.G.clear()
        try:
            for t in _datetime_program(side.pw):
                side._table_to_dicts(t)
        finally:
            side.pw.G.clear()
        tables.append(side.tables)
    assert tables[1] == tables[0]
    assert all(tables[0]) and len(tables[0]) == 4


# -- late rows under a behaviour ---------------------------------------------------------------

_LATE_ROWS = {i: (t, v) for b in LATE for i, t, v in zip(b["i"], b["t"], b["v"])}
_ON_TIME = set(range(320))


def _late_program(behavior: str):
    def prog(pw):
        beh = (pw.temporal.exactly_once_behavior() if behavior == "exactly_once"
               else pw.temporal.common_behavior(cutoff=20))
        t = _source(pw, LATE)
        w = t.windowby(pw.this.t, window=pw.temporal.tumbling(duration=50), behavior=beh)
        return w.reduce(start=pw.this._pw_window_start, n=pw.reducers.count(),
                        s=pw.reducers.sum(pw.this.v), top=pw.reducers.max(pw.this.v),
                        ids=pw.reducers.sorted_tuple(pw.this.i))

    return prog


@pytest.mark.parametrize("behavior", ["exactly_once", "cutoff"])
def test_late_rows_one_worker(monkeypatch, behavior):
    want = _final_table("pathway_tpu", _late_program(behavior), monkeypatch)
    got = _final_table("pathway_tpu_torch", _late_program(behavior), monkeypatch)
    assert got == want
    dropped = set(_LATE_ROWS) - {i for _, _, _, _, ids in want.values() for i in ids}
    assert dropped, "no late row was dropped: the case does not reach the behaviour"


@pytest.mark.parametrize("workers", [2, 4])
@pytest.mark.parametrize("behavior", ["exactly_once", "cutoff"])
@pytest.mark.parametrize("pkg", ["pathway_tpu", "pathway_tpu_torch"])
def test_late_rows_sharded_hold_what_any_order_gives(monkeypatch, pkg, behavior, workers):
    one = _final_table("pathway_tpu", _late_program(behavior), monkeypatch)
    got = _final_table(pkg, _late_program(behavior), monkeypatch, workers)
    assert sorted(r[0] for r in got.values()) == sorted(r[0] for r in one.values())
    kept: set = set()
    for start, n, s, top, ids in got.values():
        ts = [_LATE_ROWS[i][0] for i in ids]
        vs = [_LATE_ROWS[i][1] for i in ids]
        assert all(start <= x < start + 50 for x in ts)
        assert (n, s, top) == (len(ids), sum(vs), max(vs))
        kept |= set(ids)
    assert _ON_TIME <= kept


def test_imports_load_neither_jax_nor_the_reference():
    code = (
        "import sys\n"
        "import pathway_tpu_torch.stdlib.temporal, pathway_tpu_torch.stdlib.ordered\n"
        "import pathway_tpu_torch.stdlib.statistical, pathway_tpu_torch.stdlib.stateful\n"
        "import pathway_tpu_torch.universes\n"
        "import pathway_tpu_torch as pw\n"
        "assert len(pw.temporal.__all__) == 25\n"
        "for n in ('BaseCustomAccumulator', 'PyObjectWrapper', 'PathwayConfig',\n"
        "          'get_pathway_config', 'MonitoringLevel', 'universes'):\n"
        "    getattr(pw, n)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'pathway_tpu' or m.startswith('pathway_tpu.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
