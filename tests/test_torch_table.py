"""The Table API down to ``pw.run()``: the port against the JAX package on the CPU.

The same Table API programs are built in both packages from the same seeded rows and run through
the JAX package's ``pw.run()`` and the port's ``pw.run(device="cpu")``, with ``PATHWAY_FUSION``
on and off. In both, ``JIT_THRESHOLD`` and ``JIT_WARMUP_BATCHES`` are set low (as
``tests/test_fusion.py:642-643`` does), so the reference reaches its ``jax.jit`` tier and the
port its expression programs (their plain version on the CPU). The programs: select, filter,
lifted ``apply``, ``if_else``; groupby-reduce and join; the chains of
``tests/test_fusion.py:638-695``; and cases of ``tests/test_table_basics.py``,
``tests/test_expressions_sweep.py`` and ``tests/test_udf_lift_parity.py`` that the slice covers.

Tolerance: none. The subscribed tables (row key -> row) are equal exactly. Float ``**`` with a
float exponent, which is held to its ulp bound (``tests/test_torch_expression_kernel.py``), is
not in these programs; ``**`` with an integer exponent is.

Casts are not in the parity programs: past its gate, the JAX package's jit tier raises on a cast
(ROADMAP Queue 3 item 13); ``test_cast_past_the_gate`` shows that and holds the port's result
against the numpy tier's on values where the two conversions agree.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import pathway_tpu as rpw
import pathway_tpu_torch as tpw
from pathway_tpu.internals import expression_compiler as rec
from pathway_tpu.internals.parse_graph import G as RG
from pathway_tpu_torch.internals import expression_compiler as tec
from pathway_tpu_torch.internals.parse_graph import G as TG
from pathway_tpu_torch.ops.expression_kernel import HostLauncher


@pytest.fixture(autouse=True)
def _clear_graphs():
    RG.clear()
    TG.clear()
    yield
    RG.clear()
    TG.clear()


@pytest.fixture
def low_gates(monkeypatch):
    for mod in (rec, tec):
        monkeypatch.setattr(mod, "JIT_THRESHOLD", 8)
        monkeypatch.setattr(mod, "JIT_WARMUP_BATCHES", 1)


def _stream(pw, batches, schema):
    """A python connector replaying the given per-commit column dicts."""

    class Feed(pw.io.python.ConnectorSubject):
        def run(self) -> None:
            for batch in batches:
                self.next_batch({k: list(v) for k, v in batch.items()})
                self.commit()

    return pw.io.python.read(Feed(), schema=schema, autocommit_duration_ms=None)


def _batches(seed: int, n: int = 400, commits: int = 5) -> list[dict]:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(commits):
        out.append({
            "a": rng.integers(-2**40, 2**40, n).tolist(),
            "b": rng.integers(-50, 50, n).tolist(),
            "g": rng.integers(0, 17, n).tolist(),
            "s": rng.integers(0, 66, n).tolist(),
            "x": (rng.integers(-1024, 1024, n) / 16.0).tolist(),
            "p": (rng.random(n) < 0.5).tolist(),
        })
    return out


def _source(pw, seed: int):
    schema = pw.schema_from_types(a=int, b=int, g=int, s=int, x=float, p=bool)
    return _stream(pw, _batches(seed), schema)


def _norm(v):
    if isinstance(v, np.generic):
        v = v.item()
    if isinstance(v, float) and v != v:
        return "nan"
    return v


def _capture(pw, program, **run_kw) -> dict:
    """Run ``program(pw)``'s table through ``pw.run`` with a subscriber; its final table."""
    table: dict = {}

    def on_change(key, row, time, is_addition):
        vals = tuple(_norm(row[c]) for c in sorted(row))
        if is_addition:
            table[int(key)] = vals
        elif table.get(int(key)) == vals:
            del table[int(key)]

    pw.io.subscribe(program(pw), on_change=on_change)
    pw.run(**run_kw)
    return table


def _pipeline(pw):
    t = _source(pw, 1)
    out = (t.select(g=pw.this.g, y=pw.apply_with_type(lambda a: a * 3 + 7, int, pw.this.a),
                    z=pw.this.x * 2.0 - 1.0)
           .filter(pw.this.z > -32.0)
           .select(g=pw.this.g,
                   w=pw.if_else(pw.this.y > 1000, (pw.this.y & 1023) * pw.this.z, -pw.this.z)))
    return out.groupby(pw.this.g).reduce(pw.this.g, s=pw.reducers.sum(pw.this.w),
                                         c=pw.reducers.count())


def _fusion_chain(pw):  # tests/test_fusion.py:638
    t = _source(pw, 2)
    return t.select(b=pw.this.a * 3 + 1, a=pw.this.a).filter(pw.this.b > 16).select(
        c=pw.this.b - pw.this.a)


def _filter_only(pw):  # tests/test_fusion.py:669
    t = _source(pw, 3)
    return t.filter(pw.this.b > 1).filter(pw.this.s > 2)


def _groupby(pw):
    t = _source(pw, 4)
    return t.groupby(pw.this.g).reduce(
        pw.this.g, s=pw.reducers.sum(pw.this.b * 2 + 1), mn=pw.reducers.min(pw.this.x),
        mx=pw.reducers.max(pw.this.x * -1.0), c=pw.reducers.count())


def _join(pw):
    left = _source(pw, 5).select(k=pw.this.g, v=pw.this.b, x=pw.this.x)
    right = _source(pw, 6).groupby(pw.this.g).reduce(k=pw.this.g, w=pw.reducers.sum(pw.this.b))
    return left.join(right, left.k == right.k).select(
        k=left.k, v=left.v * 2 + right.w, f=pw.if_else(left.v > right.w, left.x, -left.x))


def _unary_bool(pw):
    t = _source(pw, 7)
    return t.select(n=-pw.this.a, m=~pw.this.p, q=abs(pw.this.x), r=(pw.this.a > 0) & pw.this.p,
                    u=pw.this.p | (pw.this.b > 3), v=pw.this.p ^ (pw.this.b < 0), w=~pw.this.b)


def _shifts_pow(pw):
    t = _source(pw, 8)
    return t.select(l=pw.this.a << pw.this.s, r=pw.this.a >> pw.this.s,
                    e=pw.this.b ** 3, f=pw.this.x ** 2, k=2 ** pw.this.s)


def _keys_and_consts(pw):
    t = _source(pw, 9)
    return t.select(i=pw.this.id, a=pw.this.a, c=pw.this.a * 0 + 5, d=pw.this.x + 0.0,
                    e=pw.this.x * pw.this.p)


def _lifted_builtins(pw):  # tests/test_udf_lift_parity.py:237,259,288
    t = _source(pw, 10)
    return t.select(
        mm=pw.apply_with_type(lambda a, b: min(a, b) * 100 + max(a, b), int, pw.this.b, pw.this.g),
        tern=pw.apply_with_type(lambda a: a if a > 0 else -a, int, pw.this.b),
        both=pw.apply_with_type(lambda a, b: a > 0 and b > 0, bool, pw.this.b, pw.this.g),
        ab=pw.apply_with_type(lambda a: abs(a) + 1, int, pw.this.b))


PROGRAMS = {
    "pipeline": _pipeline, "fusion_chain": _fusion_chain, "filter_only": _filter_only,
    "groupby": _groupby, "join": _join, "unary_bool": _unary_bool, "shifts_pow": _shifts_pow,
    "keys_and_consts": _keys_and_consts, "lifted_builtins": _lifted_builtins,
}


@pytest.mark.parametrize("fusion", ["1", "0"], ids=["fusion", "no_fusion"])
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_table_programs_match_the_reference(name, fusion, monkeypatch, low_gates):
    monkeypatch.setenv("PATHWAY_FUSION", fusion)
    program = PROGRAMS[name]
    want = _capture(rpw, program)
    before = HostLauncher.runs
    got = _capture(tpw, program, device="cpu")
    assert got == want
    assert want, "the program produced no rows"
    assert HostLauncher.runs > before, "no expression program ran past the gates"


# cases of tests/test_table_basics.py and tests/test_expressions_sweep.py, through run_table
BASICS = {
    "select_arithmetic": lambda pw, T: T("a | b\n1 | 2\n3 | 4").select(c=pw.this.a + pw.this.b),
    "select_keeps_ids": lambda pw, T: T("id | a\n1 | 10\n2 | 20").select(b=pw.this.a * 2),
    "filter": lambda pw, T: T("id | a\n1 | 10\n2 | 25\n3 | 30").filter(pw.this.a > 15),
    "comparison_and_bool_ops": lambda pw, T: T("a | b\n1 | 2\n5 | 2\n3 | 3").select(
        lt=pw.this.a < pw.this.b, both=(pw.this.a > 0) & (pw.this.b > 2)),
    "if_else": lambda pw, T: T("a\n1\n5\n3").select(
        x=pw.if_else(pw.this.a > 2, pw.this.a * 10, pw.this.a)),
    "with_columns": lambda pw, T: T("id | a | b\n1 | 1 | 2\n2 | 3 | 4").with_columns(
        c=pw.this.a + pw.this.b),
    "if_else_nested_numeric": lambda pw, T: T("a\n1\n5\n10").select(
        c=pw.if_else(pw.this.a < 3, 0, pw.if_else(pw.this.a < 7, 1, 2))),
    "int64_wraparound": lambda pw, T: T(f"a\n{2**62}\n{-2**62}").select(
        b=pw.this.a * 4 + pw.this.a),
    "unary_ops": lambda pw, T: T("a | b\n3 | 1.5\n-4 | -2.0").select(
        n=-pw.this.a, m=abs(pw.this.b), k=~pw.this.a),
}


@pytest.mark.parametrize("fusion", ["1", "0"], ids=["fusion", "no_fusion"])
@pytest.mark.parametrize("name", sorted(BASICS))
def test_basic_programs_match_the_reference(name, fusion, monkeypatch):
    monkeypatch.setenv("PATHWAY_FUSION", fusion)
    for mod in (rec, tec):
        monkeypatch.setattr(mod, "JIT_THRESHOLD", 1)
        monkeypatch.setattr(mod, "JIT_WARMUP_BATCHES", 0)
    from pathway_tpu.testing import T as RT, run_table as rrun
    from pathway_tpu_torch.testing import T as TT, run_table as trun

    want, wnames = rrun(BASICS[name](rpw, RT))
    before = HostLauncher.runs
    got, gnames = trun(BASICS[name](tpw, TT), device="cpu")
    assert gnames == wnames
    norm = lambda d: {int(k): tuple(_norm(v) for v in row) for k, row in d.items()}  # noqa: E731
    assert norm(got) == norm(want)
    assert HostLauncher.runs > before


def test_cast_past_the_gate(monkeypatch, low_gates):
    """A cast past the gate: the JAX package's jit tier raises out of ``pw.run`` (its
    ``_cast_fn`` materializes the tracer), the port runs it as XLA would convert. On these values
    (exact ints, finite floats in range) XLA's conversion and numpy's agree, and the port's
    table equals the numpy tier's (the reference with its gate shut)."""
    monkeypatch.setenv("PATHWAY_FUSION", "0")

    def program(pw):
        t = _source(pw, 11)
        return t.select(f=pw.cast(float, pw.this.b & 1023) * pw.this.x,
                        i=pw.cast(int, pw.this.x * 16.0), t=pw.cast(bool, pw.this.b))

    with pytest.raises(Exception):
        _capture(rpw, program)
    RG.clear()
    monkeypatch.setattr(rec, "JIT_THRESHOLD", 1 << 40)
    want = _capture(rpw, program)
    got = _capture(tpw, program, device="cpu")
    assert got == want and want


def test_run_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    t = tpw.debug.table_from_rows(tpw.schema_from_types(a=int), [(1,)])
    tpw.io.subscribe(t, on_change=lambda **kw: None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpw.run()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpw.debug.compute_and_print(t)


def test_stdlib_methods_name_the_queue_item():
    """``plot``, ``show`` and ``live``, the last of Queue 3 item 12's methods, do what the
    reference's do: without bokeh and panel ``plot`` and ``show`` return the live mirror, whose
    columns after ``pw.run`` are the reference's, and ``live`` (on the port with ``device=``)
    runs the table on a background thread to the reference's snapshot."""
    out = {}
    for pw, kw in ((rpw, {}), (tpw, {"device": "cpu"})):
        pw.G.clear()
        t = pw.debug.table_from_rows(pw.schema_from_types(a=int, b=str),
                                     [(2, "x"), (1, "y"), (3, "z")])
        plotted = t.plot(lambda source: None, sorting_col="a")
        shown = t.show()
        live = t.live(**kw)
        assert live._stopped.wait(20) and not live.failed(), live._error
        pw.run(**kw)
        out[pw.__name__] = (type(plotted).__name__, plotted.columns(), type(shown).__name__,
                            sorted(zip(*shown.columns().values())),
                            sorted(live.snapshot().rows.values()))
        pw.G.clear()
    assert out["pathway_tpu_torch"] == out["pathway_tpu"]
    assert out["pathway_tpu"][1] == {"a": [1, 2, 3], "b": ["y", "x", "z"]}
