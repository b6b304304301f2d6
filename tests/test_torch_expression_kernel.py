"""The expression register machine's programs against the JAX package's jitted expressions.

The same seeded numpy columns go through the JAX package's ``_make_jitted(expr, env)``
(``jax.jit`` on the CPU with x64) and through the port's program for the same expression tree
(``expression_program`` lowered from the port's own tables, run by the plain version on the
CPU). The sweep covers every opcode at the operand types it takes, weak Python constants, and
the edge values: INT64_MIN and INT64_MAX with overflow, NaN, +-inf, -0.0, shift counts from -3
to 70, negative integer exponents, casts of NaN, +-inf and 1e300.

Tolerance: integer, bool and comparison results equal exactly; float ``+ - * /``, casts and
``where`` bit for bit (every NaN equal to every NaN: payloads are not compared); float ``**``
within ``POW_ULP`` units in the last place of XLA's ``pow``. Dtypes differ where the values
agree in one place: an integer result of two bools (a shift, a power) is int32 under XLA and
int64 in the port (``INT32_UNDER_XLA``, ROADMAP Queue 3 item 13).

Casts run in the JAX package's jit tier only as far as tracing: its ``_cast_fn`` materializes the
tracer into an object array and raises (ROADMAP Queue 3 item 13), so a cast case is held against
``jax.jit`` of the operand's jitted expression followed by ``astype``, the conversion XLA would
run. The whole-chain program is held against the JAX package's traced chain
(``FusedChain._make_traceable``) under ``jax.jit``; the capacity check and the chain-with-members
eviction of the program cache are checked too.
"""

from __future__ import annotations

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pathway_tpu as rpw
import pathway_tpu_torch as tpw
from pathway_tpu.engine import fusion as rfusion
from pathway_tpu.internals import expression_compiler as rec
from pathway_tpu.internals.graph_runner import GraphRunner as RRunner
from pathway_tpu_torch.engine import fusion as tfusion
from pathway_tpu_torch.internals import expression_compiler as tec
from pathway_tpu_torch.internals.graph_runner import GraphRunner as TRunner
from pathway_tpu_torch.internals.parse_graph import G as TG
from pathway_tpu_torch.ops import expression_kernel as vm

POW_ULP = 2
#: integer results of two bools: int32 under XLA, int64 in the port, the same values
INT32_UNDER_XLA = ("p<<q", "p>>q", "p**q", "p**2")
N = 4096
I64_MIN, I64_MAX = -(1 << 63), (1 << 63) - 1
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _clear_port_graph():
    TG.clear()
    yield
    TG.clear()


def _columns(seed: int = 5) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    ints = np.array([I64_MIN, I64_MAX, 0, -1, 1, 2, 3, 63, 64, 70, -3, 1 << 62, -(1 << 62)],
                    np.int64)
    floats = np.array([np.nan, np.inf, -np.inf, -0.0, 0.0, 1e300, -1e300, 2.0 ** 63,
                       -(2.0 ** 63) - 4096, 9.3e18, 0.5, -0.7, 1.5, -2.0, 1e-310])
    a = rng.integers(-2 ** 62, 2 ** 62, N)
    a[:len(ints)] = ints
    b = rng.integers(-1000, 1000, N)
    b[len(ints):2 * len(ints)] = ints
    x = rng.standard_normal(N) * 10
    x[:len(floats)] = floats
    y = rng.integers(-1024, 1024, N) / 16.0
    y[len(floats):2 * len(floats)] = floats
    return {
        "a": a.astype(np.int64),
        "b": b.astype(np.int64),
        "s": rng.integers(-3, 71, N).astype(np.int64),  # shift counts and exponents
        "e": rng.integers(-3, 12, N).astype(np.int64),  # small integer exponents
        "x": x,
        "y": y,
        "px": np.abs(x) + 0.25,  # positive bases for pow with a float exponent
        "p": rng.random(N) < 0.5,
        "q": rng.random(N) < 0.3,
    }


SCHEMA = dict(a=int, b=int, s=int, e=int, x=float, y=float, px=float, p=bool, q=bool)

# (case id, builder taking (pw, table) -> expression). The same builder runs in both packages.
CASES = []


def case(name, fn):
    CASES.append(pytest.param(fn, id=name))


for op in ("+", "-", "*"):
    for l, r in (("a", "b"), ("a", "x"), ("x", "y"), ("x", "p"), ("a", "p"),
                 ("a", 3), ("x", 2.5), ("a", 2.5), ("p", 1), (3, "a"), (1.5, "x"),
                 ("x", 0.0), (0.0, "x"), ("x", -0.0), ("p", 2.5)):
        case(f"{l}{op}{r}", lambda pw, t, op=op, l=l, r=r: _bin(t, op, l, r))
for op in ("+", "*"):
    case(f"p{op}q", lambda pw, t, op=op: _bin(t, op, "p", "q"))
for l, r in (("a", "e"), ("b", "e"), ("a", 3), ("a", 0), ("a", 1), ("x", 2), ("x", 3),
             ("x", -2), ("x", 0), ("px", 0.5), ("px", "y"), ("x", 2.0), ("px", "e"),
             ("b", "px"), (2, "s"), (2.0, "e"), ("p", "q"), ("a", "p"), ("p", 2),
             ("x", "p")):
    case(f"{l}**{r}", lambda pw, t, l=l, r=r: _bin(t, "**", l, r))
for op in ("==", "!=", "<", "<=", ">", ">="):
    for l, r in (("a", "b"), ("a", "x"), ("x", "y"), ("p", "q"), ("a", 2.5), ("x", 1),
                 ("p", True), (0, "b")):
        case(f"{l}{op}{r}", lambda pw, t, op=op, l=l, r=r: _bin(t, op, l, r))
for op in ("&", "|", "^"):
    for l, r in (("a", "b"), ("p", "q"), ("a", 255)):
        case(f"{l}{op}{r}", lambda pw, t, op=op, l=l, r=r: _bin(t, op, l, r))
for op in ("<<", ">>"):
    for l, r in (("a", "s"), ("b", "s"), ("a", 3), (1, "s"), ("p", "q"), ("a", "p"),
                 ("p", "s")):
        case(f"{l}{op}{r}", lambda pw, t, op=op, l=l, r=r: _bin(t, op, l, r))
case("-a", lambda pw, t: -t.a)
case("-x", lambda pw, t: -t.x)
case("~a", lambda pw, t: ~t.a)
case("~p", lambda pw, t: ~t.p)
case("abs a", lambda pw, t: abs(t.a))
case("abs x", lambda pw, t: abs(t.x))
case("abs p", lambda pw, t: abs(t.p))
case("--x", lambda pw, t: -(-t.x))
case("if p a b", lambda pw, t: pw.if_else(t.p, t.a, t.b))
case("if p a x", lambda pw, t: pw.if_else(t.p, t.a, t.x))
case("if p a 2.5", lambda pw, t: pw.if_else(t.p, t.a, 2.5))
case("if p 2 a", lambda pw, t: pw.if_else(t.p, 2, t.a))
case("if a>0 x -x", lambda pw, t: pw.if_else(t.a > 0, t.x, -t.x))
case("if p p q", lambda pw, t: pw.if_else(t.p, t.p, t.q))
case("if p 1 2.5", lambda pw, t: pw.if_else(t.p, 1, 2.5))
case("declare float a", lambda pw, t: pw.declare_type(float, t.a))
case("keys", lambda pw, t: t.id)
case("x*2.0-1.0", lambda pw, t: t.x * 2.0 - 1.0)
case("a*3+7", lambda pw, t: t.a * 3 + 7)
case("nested", lambda pw, t: pw.if_else((t.a * 3 + 7) > 1000, (t.b & 1023) * t.x, -t.x)
     + (t.s << 2) * 0.5)
case("const only", lambda pw, t: t.a * 0 + (2 + 3))
case("apply a*3+7", lambda pw, t: pw.apply_with_type(lambda a: a * 3 + 7, int, t.a))
case("apply to float", lambda pw, t: pw.apply_with_type(lambda a: a * 2, float, t.b))
case("apply max", lambda pw, t: pw.apply_with_type(lambda a, b: max(a, b), int, t.a, t.b))
case("apply min float", lambda pw, t: pw.apply_with_type(lambda x, y: min(x, y), float,
                                                         t.x, t.y))

# casts: held against jax.jit of the operand followed by astype (see the module docstring)
CASTS = []
for src in ("a", "x", "y", "p", "b"):
    for target in (int, float, bool):
        CASTS.append(pytest.param(src, target, id=f"cast {target.__name__} {src}"))


def _operand(t, v):
    return getattr(t, v) if isinstance(v, str) else v


def _bin(t, op, l, r):
    import operator as o

    fn = {"+": o.add, "-": o.sub, "*": o.mul, "**": o.pow, "==": o.eq, "!=": o.ne, "<": o.lt,
          "<=": o.le, ">": o.gt, ">=": o.ge, "&": o.and_, "|": o.or_, "^": o.xor,
          "<<": o.lshift, ">>": o.rshift}[op]
    return fn(_operand(t, l), _operand(t, r))


def _tables():
    cols = _columns()
    rt = rpw.debug.table_from_rows(rpw.schema_from_types(**SCHEMA), [(0,) * 7 + (False,) * 2])
    tt = tpw.debug.table_from_rows(tpw.schema_from_types(**SCHEMA), [(0,) * 7 + (False,) * 2])
    keys = np.random.default_rng(9).integers(0, 2 ** 63, N, dtype=np.uint64)
    keys[:3] = [0, (1 << 64) - 1, 1 << 63]
    return cols, keys, rt, tt


def _port_program_output(expr, env, cols, keys):
    kinds = tec._input_kinds([c for c in cols], cols)
    prog = tec.expression_program(expr, env, kinds, {})
    launcher = vm.HostLauncher(CPU)
    (out,) = launcher.run(prog, tec._program_inputs(prog, cols, keys), len(keys))
    return out


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    ia, ib = a.view(np.int64), b.view(np.int64)
    ia = np.where(ia < 0, np.int64(I64_MIN) - ia, ia)
    ib = np.where(ib < 0, np.int64(I64_MIN) - ib, ib)
    return np.abs(ia.astype(np.float64) - ib.astype(np.float64))


def _check(got: np.ndarray, want: np.ndarray, label: str, pow_case: bool = False) -> None:
    want = np.asarray(want)
    if want.ndim == 0:
        want = np.full(got.shape, want)
    assert got.shape == want.shape, label
    if want.dtype.kind == "f":
        assert got.dtype == np.float64, f"{label}: {got.dtype}"
        nan = np.isnan(want)
        assert np.array_equal(np.isnan(got), nan), f"{label}: NaN rows differ"
        if pow_case:
            inf = ~np.isfinite(want) & ~nan
            assert np.array_equal(got[inf], want[inf]), f"{label}: inf rows differ"
            fin = np.isfinite(want)
            worst = _ulps(got[fin], want[fin]).max(initial=0)
            assert worst <= POW_ULP, f"{label}: {worst} ulp from XLA's pow"
        else:
            same = got[~nan].view(np.int64) == want[~nan].view(np.int64)
            assert same.all(), f"{label}: {int((~same).sum())} rows differ in bits"
        return
    if want.dtype.kind == "b":
        assert got.dtype == np.bool_, f"{label}: {got.dtype}"
    elif want.dtype.kind in "iu":
        assert got.dtype.kind == want.dtype.kind, f"{label}: {got.dtype} vs {want.dtype}"
        if want.dtype != got.dtype:  # int32 under XLA for shifts and powers of two bools
            assert want.dtype == np.int32 and label in INT32_UNDER_XLA, label
    assert np.array_equal(got.astype(np.int64) if got.dtype.kind != "u" else got,
                          want.astype(np.int64) if want.dtype.kind != "u" else want), label


@pytest.mark.parametrize("build", CASES)
def test_program_matches_jax_jit(build, request):
    cols, keys, rt, tt = _tables()
    renv, tenv = rec.ColumnEnv(), tec.ColumnEnv(device=CPU)
    renv.add_table(rt)
    tenv.add_table(tt)
    rexpr, texpr = build(rpw, rt), build(tpw, tt)
    label = request.node.callspec.id
    try:
        want = np.asarray(rec._make_jitted(rexpr, renv)(cols, keys))
    except TypeError as e:
        # XLA refuses the expression while tracing (bool subtraction and negation, a negative
        # constant exponent of an integer): the port refuses it while lowering
        with pytest.raises(TypeError):
            _port_program_output(texpr, tenv, cols, keys)
        assert "bool" in str(e) or "negative" in str(e), e
        return
    got = _port_program_output(texpr, tenv, cols, keys)
    _check(got, want, label, pow_case="**" in label)


@pytest.mark.parametrize("src,target", CASTS)
def test_cast_program_matches_xla_convert(src, target):
    cols, keys, rt, tt = _tables()
    renv, tenv = rec.ColumnEnv(), tec.ColumnEnv(device=CPU)
    renv.add_table(rt)
    tenv.add_table(tt)
    inner = rec._build(getattr(rt, src), renv, xp_name="jax")[0]
    jnp_target = {int: jnp.int64, float: jnp.float64, bool: jnp.bool_}[target]
    want = np.asarray(jax.jit(lambda c, k: jnp.asarray(inner(c, k)).astype(jnp_target))(
        cols, keys))
    got = _port_program_output(tpw.cast(target, getattr(tt, src)), tenv, cols, keys)
    _check(got, want, f"cast {target.__name__} {src}")
    # the JAX package's own jit tier raises on the cast (ROADMAP Queue 3 item 13)
    with pytest.raises((TypeError, ValueError)):
        rec._make_jitted(rpw.cast(target, getattr(rt, src)), renv)(cols, keys)


def test_lifted_cast_program_matches_xla_convert():
    """``float()`` inside a lifted lambda is a cast (udf_lift), so the JAX package's jit tier
    raises on it as on any cast; XLA's conversion of the jitted operand decides."""
    cols, keys, rt, tt = _tables()
    renv, tenv = rec.ColumnEnv(), tec.ColumnEnv(device=CPU)
    renv.add_table(rt)
    tenv.add_table(tt)
    half = lambda b: float(b) * 0.5  # noqa: E731 (the AST lift reads a one-line source)
    want = np.asarray(jax.jit(lambda c: c["b"].astype(jnp.float64) * 0.5)(cols))
    texpr = tpw.apply_with_type(half, float, tt.b)
    assert tec._build(texpr, tenv)[2]  # lifted, and in the kernel tier's subset
    got = _port_program_output(texpr, tenv, cols, keys)
    _check(got, want, "apply float()")
    rexpr = rpw.apply_with_type(half, float, rt.b)
    assert rec._build(rexpr, renv)[2]
    with pytest.raises(TypeError):
        rec._make_jitted(rexpr, renv)(cols, keys)


def _chain_nodes(pw, runner_cls, ns_fusion, device=None):
    schema = pw.schema_from_types(a=int, b=int, x=float, p=bool)
    rows = [(i * 7 - 300, i % 13, i / 16.0 - 20.0, i % 3 == 0) for i in range(600)]
    t = pw.debug.table_from_rows(schema, rows)
    out = (t.select(a=pw.this.a, b=pw.this.b * 3 + 1, x=pw.this.x * 2.0 - 1.0, p=pw.this.p)
           .filter(pw.this.b > 10)
           .select(c=pw.this.a + pw.this.b, w=pw.if_else(pw.this.p, pw.this.x, -pw.this.x),
                   p=pw.this.p)
           .filter(pw.this.w < 8.0))
    runner = runner_cls() if device is None else runner_cls(device)
    runner.capture(out)
    chains = [n for n in ns_fusion.fuse_graph(runner._nodes) if isinstance(n, ns_fusion.FusedChain)]
    assert len(chains) == 1
    return chains[0]


def test_chain_program_matches_fused_chain_kernel(monkeypatch):
    monkeypatch.setenv("PATHWAY_FUSION", "1")
    rchain = _chain_nodes(rpw, RRunner, rfusion)
    tchain = _chain_nodes(tpw, TRunner, tfusion, "cpu")
    rplan, tplan = rchain._jit_plan, tchain._kernel_plan
    assert rplan is not None and tplan is not None
    assert rplan["src_cols"] == tplan["src_cols"]
    rng = np.random.default_rng(3)
    n = 5000
    src = {"a": rng.integers(-2 ** 62, 2 ** 62, n), "b": rng.integers(-10, 30, n),
           "x": rng.standard_normal(n) * 8, "p": rng.random(n) < 0.5}
    src["x"][:4] = [np.nan, -0.0, np.inf, -np.inf]
    src = {c: src[c] for c in rplan["src_cols"]}
    keys = rng.integers(0, 2 ** 63, n, dtype=np.uint64)
    *want_cols, want_mask = jax.jit(rchain._make_traceable(rplan)())(src, keys)
    kinds = tec._input_kinds(tplan["src_cols"], src)
    prog = tec.chain_program(tplan, kinds)
    outs = vm.HostLauncher(CPU).run(prog, tec._program_inputs(prog, src, keys), n)
    assert len(outs) == len(want_cols) + 1
    for name, got, want in zip(tchain.column_names, outs, want_cols):
        _check(got, np.asarray(want), f"chain column {name}")
    _check(outs[-1], np.asarray(want_mask).astype(bool), "chain mask")
    # the same chain through FusedChain.process past the gates: one program, same rows
    monkeypatch.setattr(tec, "JIT_THRESHOLD", 8)
    monkeypatch.setattr(tec, "JIT_WARMUP_BATCHES", 0)
    from pathway_tpu_torch.engine.delta import Delta

    d = Delta(keys=keys, data=dict(src))
    before = tfusion.FUSION_STATS["jit_chains_total"]
    out = tchain.process(0, [d])
    assert tfusion.FUSION_STATS["jit_chains_total"] == before + 1
    mask = np.asarray(want_mask).astype(bool)
    assert np.array_equal(out.keys, keys[mask])
    for name, want in zip(tchain.column_names, want_cols):
        _check(out.data[name], np.asarray(want)[mask], f"processed column {name}")


def test_program_over_capacity_raises():
    cols, keys, _, tt = _tables()
    env = tec.ColumnEnv(device=CPU)
    env.add_table(tt)
    terms = [tt.a * (i + 2) for i in range(vm.MAX_INSNS)]  # a fresh constant each
    while len(terms) > 1:  # a balanced sum: shallow enough to lower
        terms = [l + r for l, r in zip(terms[::2], terms[1::2])] + terms[len(terms) & ~1:]
    expr = terms[0]
    with pytest.raises(ValueError, match=r"at most (256|64)"):
        _port_program_output(expr, env, cols, keys)
    b = vm.ProgramBuilder({"a": "I"})
    v = b.load("a")
    vals = [b.binop("+", v, b.const(i)) for i in range(vm.MAX_REGS + 1)]
    acc = vals[0]
    for w in vals[1:]:
        acc = b.binop("*", acc, w)
    b.store("out", acc)
    with pytest.raises(ValueError, match="registers"):
        b.finish()


def test_program_cache_entries_evict_with_members():
    """A chain's program must not outlive any member signature the oldest-half sweep evicts (the
    JAX package's tests/test_fusion.py:697, on the port's program cache)."""
    cache, deps = tec._PROGRAM_CACHE, tec._PROGRAM_CHAIN_DEPS
    saved_cache, saved_deps = dict(cache), dict(deps)
    cache.clear()
    deps.clear()
    try:
        old = [("m", i) for i in range(4)]
        young = [("m", i) for i in range(4, 8)]
        for s in old + young:
            cache[s] = object()
        chain_old = ("chain", old[0])
        chain_young = ("chain", young[-1])
        cache[chain_old] = object()
        deps[chain_old] = frozenset([old[0]])
        cache[chain_young] = object()
        deps[chain_young] = frozenset([young[-1]])
        tec._evict_program_cache()
        assert old[0] not in cache
        assert chain_old not in cache
        assert chain_young in cache
        assert chain_old not in deps
    finally:
        cache.clear()
        cache.update(saved_cache)
        deps.clear()
        deps.update(saved_deps)


def test_kernel_source_agrees_with_the_opcode_table():
    """The CUDA source's opcode enum and capacity are the Python table's."""
    src = (Path(vm.__file__).resolve().parent.parent / "csrc" / "expression_vm.cu").read_text()
    body = re.search(r"enum Op \{(.*?)\};", src, re.S).group(1)
    names = [w for w in re.findall(r"[A-Z0-9_]+", body)]
    assert names == list(vm.OPS)
    for cap in ("MAX_INSNS", "MAX_REGS", "MAX_CONSTS", "MAX_COLS"):
        assert re.search(rf"constexpr int {cap} = (\d+);", src).group(1) == str(getattr(vm, cap))


def test_every_program_keeps_to_its_register_count():
    """The kernel sizes its register file by ``Program.n_regs``: every program of the sweep reads
    and writes registers below it (the check the wrapper makes before a program's first launch),
    and a program that reaches past it, names an unknown opcode or is not laid out as the launch
    parameters take it, is refused."""
    cols, keys, _, tt = _tables()
    env = tec.ColumnEnv(device=CPU)
    env.add_table(tt)
    kinds = tec._input_kinds(list(cols), cols)
    checked = 0
    for param in CASES:
        (build,) = param.values
        try:
            prog = tec.expression_program(build(tpw, tt), env, kinds, {})
        except TypeError:  # refused while lowering, as XLA refuses it
            continue
        vm._check_registers(prog)
        checked += 1
    assert checked > len(CASES) // 2
    bad = vm.Program(code=prog.code.copy(), consts=prog.consts, inputs=prog.inputs,
                     outputs=prog.outputs, n_regs=prog.n_regs)
    bad.code[0, 1] = prog.n_regs  # the first instruction writes one register too far
    with pytest.raises(ValueError, match="outside"):
        vm._check_registers(bad)
    bad.code[0, 0] = len(vm.OPS)
    with pytest.raises(ValueError, match="unknown opcode"):
        vm._check_registers(bad)
    bad.code = prog.code.astype(np.int64)
    with pytest.raises(ValueError, match="int32"):
        vm._check_registers(bad)


def test_plain_version_on_packed_buffers_matches_columns():
    """``expression_vm`` on CPU buffers (the plain version) equals ``run_program_plain`` over the
    columns, and counts no launch."""
    cols, keys, _, tt = _tables()
    env = tec.ColumnEnv(device=CPU)
    env.add_table(tt)
    expr = tpw.if_else(tt.p, tt.a * 3 + 7, tt.b) + (tt.x > 0.5)
    kinds = tec._input_kinds(list(cols), cols)
    prog = tec.expression_program(expr, env, kinds, {})
    inputs = [torch.from_numpy(np.ascontiguousarray(c).view(np.int64) if c.dtype == np.uint64
                               else c) for c in tec._program_inputs(prog, cols, keys)]
    before = vm.expression_vm.launches
    (got,) = vm.run_program(prog, inputs)
    (want,) = vm.run_program_plain(prog, inputs)
    assert vm.expression_vm.launches == before
    assert torch.equal(got, want)


def test_shared_gate_counts_every_batch_under_threads(monkeypatch):
    """Worker threads share a compiled expression (the compile cache sits on the expression), so
    its warm-up gate and the launch counters are read-modify-writes from many threads: with more
    threads than cores and a short switch interval, no update is lost and every result holds."""
    import sys
    import threading

    cols, keys, _, tt = _tables()
    env = tec.ColumnEnv(device=CPU)
    env.add_table(tt)
    monkeypatch.setattr(tec, "JIT_THRESHOLD", 16)
    monkeypatch.setattr(tec, "JIT_WARMUP_BATCHES", 5)
    fn = tec.compile_expr(tt.a * 3 + tt.b, env).fn
    want = cols["a"] * 3 + cols["b"]
    n_threads, calls = 16, 40
    before = vm.HostLauncher.runs
    bad: list = []

    def work():
        for _ in range(calls):
            if not np.array_equal(fn(cols, keys), want):
                bad.append(1)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert not bad
    assert vm.HostLauncher.runs - before == n_threads * calls - 5
