"""Widened UDF lifting: AST lifter + probe-row value tracer.

Two escalating ways to turn a per-row Python UDF into a columnar plan,
both emitting ordinary :class:`ColumnExpression` trees that
``expression_compiler`` compiles to whole-batch kernels (the reference
never executes per-row Python — ``src/engine/expression.rs``):

- :func:`ast_lift` — *static* lifting from the function's source AST.
  Handles what the bytecode-execution trace in ``expression_compiler``
  cannot: method-call chains (``s.lower() + "!"`` via the
  ``MethodCallExpression`` namespaces), dict/tuple-style access
  (``r["x"]``), value conditionals (ternaries, ``if``/``return``
  statements, ``and``/``or``/``not`` — all rewritten to ``if_else``,
  whose per-row truthiness selection matches Python's), ``is None``
  tests, f-strings, and a whitelisted builtin subset (``len``/``abs``/
  ``round``/``str``/``int``/``float``/``bool``/``min``/``max``). Runs
  NO user code — it is side-effect-free by construction. Refuses
  anything it cannot prove equivalent (closure/global reads stay
  late-binding, loops stay per-row).

- :class:`ValueTracer` — *runtime* probe tracing for callables whose
  source is unavailable (``eval``/REPL lambdas) or whose method usage
  only types at runtime. The UDF runs ONCE on a real probe row with
  each argument wrapped in a tracer that computes the genuine scalar
  result while recording the symbolic expression. Control flow on a
  traced value (``bool``/``len``/``iter``/``str``) raises
  :class:`TraceRefused` — a plan traced down one branch of a value
  branch would be wrong for other rows. :func:`traceable` is the
  widened bytecode gate deciding which callables may be probed at all
  (no stores, no imports, no closures, no iteration, globals limited
  to a safe builtin subset) so the single probe run cannot execute
  side effects the per-row path would have run per row.

Both paths share one method/attribute table so a form lifts
identically whichever path catches it.
"""

from __future__ import annotations

import ast
import builtins
import datetime
from typing import Any, Callable

from . import dtype as dt
from .expression import (
    CastExpression,
    ColumnBinaryOpExpression,
    ColumnConstExpression,
    ColumnExpression,
    ColumnUnaryOpExpression,
    GetExpression,
    IfElseExpression,
    IsNoneExpression,
    IsNotNoneExpression,
    MakeTupleExpression,
    MethodCallExpression,
    smart_coerce,
)

__all__ = [
    "LiftRefused",
    "TraceRefused",
    "ValueTracer",
    "ast_lift",
    "trace_probe",
    "traceable",
]


class LiftRefused(Exception):
    """A construct outside the provably-equivalent liftable subset."""


class TraceRefused(BaseException):
    """Raised by tracer dunders the probe run must not fold (bool/len/
    str/iter). BaseException on purpose: a UDF's own ``except
    Exception`` must not swallow it and corrupt the trace."""


# ---------------------------------------------------------------------------
# shared method / attribute tables
# ---------------------------------------------------------------------------

# Python method name -> expression builder. Every builder constructs a
# MethodCallExpression whose engine impl (expressions_namespaces._METHODS)
# is the EXACT Python method it replaces, so lifted and per-row semantics
# agree cell for cell. The two long-refused corners are now aligned
# instead of absent: the engine's ``str.split`` returns a plain Python
# list (it used to wrap in tuple), and ``timestamp`` maps to
# ``py.timestamp`` — the genuine ``datetime.timestamp()``, tz-aware
# exactly like Python (naive datetimes use the local timezone, unlike
# the namespace's epoch-anchored ``dt.timestamp(unit=...)``).
_METHOD_LIFTS: dict[str, Callable[..., ColumnExpression]] = {
    "lower": lambda r: MethodCallExpression("str.lower", [r]),
    "upper": lambda r: MethodCallExpression("str.upper", [r]),
    "strip": lambda r, c=None: MethodCallExpression("str.strip", [r, c]),
    "title": lambda r: MethodCallExpression("str.title", [r]),
    "swapcase": lambda r: MethodCallExpression("str.swapcase", [r]),
    "startswith": lambda r, p: MethodCallExpression("str.startswith", [r, p]),
    "endswith": lambda r, s: MethodCallExpression("str.endswith", [r, s]),
    "removeprefix": lambda r, p: MethodCallExpression(
        "str.removeprefix", [r, p]
    ),
    "removesuffix": lambda r, s: MethodCallExpression(
        "str.removesuffix", [r, s]
    ),
    "count": lambda r, s: MethodCallExpression("str.count", [r, s]),
    "find": lambda r, s: MethodCallExpression("str.find", [r, s]),
    "rfind": lambda r, s: MethodCallExpression("str.rfind", [r, s]),
    "replace": lambda r, o, n, c=-1: MethodCallExpression(
        "str.replace", [r, o, n, c]
    ),
    "split": lambda r, sep=None, m=-1: MethodCallExpression(
        "str.split", [r, sep, m]
    ),
    "strftime": lambda r, f: MethodCallExpression("dt.strftime", [r, f]),
    "weekday": lambda r: MethodCallExpression("dt.weekday", [r]),
    "timestamp": lambda r: MethodCallExpression("py.timestamp", [r]),
}

#: methods only the VALUE TRACER may lift: their compiled expression
#: assumes a receiver type the AST lifter cannot see. ``.get`` compiles
#: to a dict-typed GetExpression — on a non-dict receiver the per-row
#: path raises AttributeError while the kernel would silently index, so
#: lifting is sound only after the probe row proves the receiver IS a
#: dict (the tracer checks the real type before intercepting).
_TRACER_ONLY_LIFTS: dict[str, Callable[..., ColumnExpression]] = {
    "get": lambda r, k, d=None: GetExpression(
        r, k, default=d, check_if_exists=False
    ),
}

#: datetime attribute -> engine method whose impl is exactly that
#: attribute read. timedelta's ``.days``/``.seconds`` are deliberately
#: absent: Python floors them while the engine's ``dt.days`` truncates
#: toward zero — negative durations would diverge.
_ATTR_LIFTS: dict[str, str] = {
    "year": "dt.year",
    "month": "dt.month",
    "day": "dt.day",
    "hour": "dt.hour",
    "minute": "dt.minute",
    "second": "dt.second",
    "microsecond": "dt.microsecond",
}

#: constants a lifted tree may embed (late-binding / aliasing hazards
#: rule out everything mutable)
_CONST_TYPES = (
    type(None), bool, int, float, str, bytes,
    datetime.datetime, datetime.date, datetime.timedelta,
)


def _builtin_ok(fn: Callable, name: str) -> bool:
    """True when ``name`` resolves to the genuine builtin in ``fn``'s
    globals — a module-level shadow must keep its late-binding per-row
    semantics."""
    b = getattr(builtins, name, None)
    if b is None:
        return False
    g = getattr(fn, "__globals__", None)
    return g is None or g.get(name, b) is b


def _not_expr(x: ColumnExpression) -> ColumnExpression:
    # Python `not x` is truthiness-exact for ANY operand type via the
    # if_else kernel (bool(cell) per object cell) — `~x` would be int
    # complement on non-bools
    return IfElseExpression(x, False, True)


def _min_expr(a, b) -> ColumnExpression:
    # Python's exact rule: `b if b < a else a` — returns the FIRST
    # minimal argument on ties AND keeps Python's NaN behavior
    # (min(nan, x) is nan, min(x, nan) is x: NaN comparisons are False)
    return IfElseExpression(
        ColumnBinaryOpExpression(b, a, "<"), b, a
    )


def _max_expr(a, b) -> ColumnExpression:
    return IfElseExpression(
        ColumnBinaryOpExpression(b, a, ">"), b, a
    )


def _round_expr(x, nd=None) -> ColumnExpression:
    if nd is None:
        # 1-arg round returns int in Python; num.round keeps the dtype
        return CastExpression(dt.INT, MethodCallExpression("num.round", [x, 0]))
    return MethodCallExpression("num.round", [x, nd])


#: builtin name -> (expression builder, min positional args, max)
_BUILTIN_LIFTS: dict[str, tuple[Callable[..., Any], int, int]] = {
    "len": (lambda x: MethodCallExpression("str.len", [x]), 1, 1),
    "abs": (lambda x: ColumnUnaryOpExpression(x, "abs"), 1, 1),
    "round": (_round_expr, 1, 2),
    "str": (lambda x: MethodCallExpression("to_string", [x]), 1, 1),
    # per-element int(): the dense CastExpression astype would turn
    # NaN/inf into INT64_MIN silently instead of a per-row Error
    "int": (lambda x: MethodCallExpression("py.int", [x]), 1, 1),
    "float": (lambda x: CastExpression(dt.FLOAT, x), 1, 1),
    "bool": (lambda x: CastExpression(dt.BOOL, x), 1, 1),
    "min": (_min_expr, 2, 2),
    "max": (_max_expr, 2, 2),
}


# ---------------------------------------------------------------------------
# AST lifting
# ---------------------------------------------------------------------------

_BIN_OPS = {
    ast.Add: "+", ast.Sub: "-", ast.Mult: "*", ast.Div: "/",
    ast.FloorDiv: "//", ast.Mod: "%", ast.Pow: "**", ast.MatMult: "@",
    ast.LShift: "<<", ast.RShift: ">>", ast.BitAnd: "&",
    ast.BitOr: "|", ast.BitXor: "^",
}

_CMP_OPS = {
    ast.Eq: "==", ast.NotEq: "!=", ast.Lt: "<", ast.LtE: "<=",
    ast.Gt: ">", ast.GtE: ">=",
}

#: statement-lifting bound: sequential `if` statements duplicate their
#: tail into both branches, so cap the lifted-node budget rather than
#: risk exponential trees on pathological inputs
_NODE_BUDGET = 400


def ast_lift(
    fn: Callable,
    args: tuple,
    kwargs: dict[str, Any],
    reason_out: list | None = None,
) -> ColumnExpression | None:
    """Build the ColumnExpression equivalent of ``fn(*args, **kwargs)``
    from ``fn``'s source AST, or None when any construct falls outside
    the liftable subset (source unavailable, closures/globals, loops,
    unknown methods...). ``args``/``kwargs`` are the already-coerced
    argument ColumnExpressions of the apply node. ``reason_out``, when
    given, receives the refusing construct as a string — the static
    analyzer's dispatch-tax diagnostic reports it verbatim."""
    try:
        node = _fn_ast(fn)
        if node is None:
            if reason_out is not None:
                reason_out.append("source unavailable or ambiguous")
            return None
        scope = _bind_params(fn, node, args, kwargs)
        lifter = _AstLifter(fn)
        if isinstance(node, ast.Lambda):
            return lifter.lift(node.body, scope)
        return lifter.lift_body(list(node.body), scope)
    except RecursionError:
        if reason_out is not None:
            reason_out.append("recursion limit during lift")
        return None
    except LiftRefused as e:
        if reason_out is not None:
            reason_out.append(str(e) or "refused construct")
        return None


def _fn_ast(fn: Callable) -> ast.Lambda | ast.FunctionDef | None:
    import inspect
    import textwrap

    if getattr(fn, "__wrapped__", None) is not None:
        # functools.wraps-style decoration: getsource unwraps to the
        # ORIGINAL body while the callable runs the wrapper — compiling
        # the original would silently drop the wrapper's behavior
        return None
    try:
        src = textwrap.dedent(inspect.getsource(fn))
    except (OSError, TypeError):
        return None
    try:
        tree = ast.parse(src)
    except SyntaxError:
        # a lambda extracted mid-expression (continuation lines, trailing
        # operators) may not parse standalone
        return None
    code = getattr(fn, "__code__", None)
    if code is None:
        return None
    # the matched node must be THIS callable's code, not a same-named
    # sibling: arg names come from fn.__code__, so a wrapper whose
    # signature differs from the wrapped def never matches it
    want = code.co_varnames[: code.co_argcount + code.co_kwonlyargcount]
    matches: list[ast.Lambda | ast.FunctionDef] = []
    for n in ast.walk(tree):
        if isinstance(n, ast.Lambda):
            names = tuple(a.arg for a in n.args.args + n.args.kwonlyargs)
            if names == want:
                matches.append(n)
        elif isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names = tuple(
                a.arg for a in n.args.args + n.args.kwonlyargs
            ) + tuple(a.arg for a in n.args.posonlyargs)
            if n.name == getattr(fn, "__name__", None) and names == want:
                matches.append(n)
    if len(matches) != 1 or isinstance(matches[0], ast.AsyncFunctionDef):
        # zero: not found; several: ambiguous (two lambdas on one line)
        return None
    node = matches[0]
    a = node.args
    if a.vararg or a.kwarg or a.posonlyargs:
        return None
    # fn must take the same parameter shape the node declares (a *args
    # wrapper around a plain def has different code flags)
    if code.co_flags & (inspect.CO_VARARGS | inspect.CO_VARKEYWORDS):
        return None
    return node


def _bind_params(
    fn: Callable,
    node: ast.Lambda | ast.FunctionDef,
    args: tuple,
    kwargs: dict[str, Any],
) -> dict[str, ColumnExpression]:
    names = [a.arg for a in node.args.args]
    kw_names = [a.arg for a in node.args.kwonlyargs]
    scope: dict[str, ColumnExpression] = {}
    if len(args) > len(names):
        raise LiftRefused("too many positional args")
    for name, e in zip(names, args):
        scope[name] = e
    for k, e in kwargs.items():
        if k not in names + kw_names or k in scope:
            raise LiftRefused(f"bad kwarg {k}")
        scope[k] = e
    # defaults for unbound params — immutable constants only
    defaults = node.args.defaults
    for name, dnode in zip(names[len(names) - len(defaults):], defaults):
        if name not in scope:
            v = _const_of(dnode)
            scope[name] = smart_coerce(v)
    for a, dnode in zip(node.args.kwonlyargs, node.args.kw_defaults):
        if a.arg not in scope:
            if dnode is None:
                raise LiftRefused(f"missing kwonly {a.arg}")
            scope[a.arg] = smart_coerce(_const_of(dnode))
    missing = [n for n in names + kw_names if n not in scope]
    if missing:
        raise LiftRefused(f"unbound params {missing}")
    return scope


def _const_of(node: ast.AST) -> Any:
    if isinstance(node, ast.Constant) and isinstance(
        node.value, _CONST_TYPES
    ):
        return node.value
    if isinstance(node, ast.Tuple):
        return tuple(_const_of(e) for e in node.elts)
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        v = _const_of(node.operand)
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            return -v
    raise LiftRefused("non-constant default")


class _AstLifter:
    def __init__(self, fn: Callable):
        self.fn = fn
        self.budget = _NODE_BUDGET

    def _spend(self) -> None:
        self.budget -= 1
        if self.budget <= 0:
            raise LiftRefused("lift budget exhausted")

    # -- statements -----------------------------------------------------

    def lift_body(
        self, stmts: list[ast.stmt], scope: dict[str, ColumnExpression]
    ) -> ColumnExpression:
        """Lift a straight-line function body: docstring + simple
        assignments + ``if``/``return`` trees. An ``if`` duplicates the
        statement tail into both branches (each with its own scope copy),
        so assignments under a branch stay branch-local — exactly
        Python's dataflow for side-effect-free bodies."""
        for i, st in enumerate(stmts):
            self._spend()
            if isinstance(st, ast.Expr) and isinstance(st.value, ast.Constant):
                continue  # docstring / bare literal
            if isinstance(st, ast.Pass):
                continue
            if isinstance(st, ast.Assign):
                if len(st.targets) != 1 or not isinstance(
                    st.targets[0], ast.Name
                ):
                    raise LiftRefused("complex assignment")
                scope[st.targets[0].id] = self.lift(st.value, scope)
                continue
            if isinstance(st, ast.AnnAssign):
                if st.value is None or not isinstance(st.target, ast.Name):
                    raise LiftRefused("annotation-only assignment")
                scope[st.target.id] = self.lift(st.value, scope)
                continue
            if isinstance(st, ast.Return):
                if st.value is None:
                    raise LiftRefused("bare return")
                return self.lift(st.value, scope)
            if isinstance(st, ast.If):
                cond = self.lift(st.test, scope)
                tail = stmts[i + 1:]
                then_v = self.lift_body(list(st.body) + tail, dict(scope))
                else_v = self.lift_body(list(st.orelse) + tail, dict(scope))
                return IfElseExpression(cond, then_v, else_v)
            raise LiftRefused(f"statement {type(st).__name__}")
        raise LiftRefused("fell off the end (implicit return None)")

    # -- expressions ----------------------------------------------------

    def lift(
        self, node: ast.expr, scope: dict[str, ColumnExpression]
    ) -> ColumnExpression | Any:
        self._spend()
        if isinstance(node, ast.Constant):
            if not isinstance(node.value, _CONST_TYPES):
                raise LiftRefused(f"constant {type(node.value).__name__}")
            return smart_coerce(node.value)
        if isinstance(node, ast.Name):
            if node.id in scope:
                return scope[node.id]
            # bare builtin names (uncalled) and module globals keep their
            # late-binding per-row semantics
            raise LiftRefused(f"free name {node.id}")
        if isinstance(node, ast.BinOp):
            op = _BIN_OPS.get(type(node.op))
            if op is None:
                raise LiftRefused(f"binop {type(node.op).__name__}")
            return ColumnBinaryOpExpression(
                self.lift(node.left, scope), self.lift(node.right, scope), op
            )
        if isinstance(node, ast.UnaryOp):
            v = self.lift(node.operand, scope)
            if isinstance(node.op, ast.USub):
                return ColumnUnaryOpExpression(v, "-")
            if isinstance(node.op, ast.UAdd):
                return v
            if isinstance(node.op, ast.Invert):
                return ColumnUnaryOpExpression(v, "~")
            if isinstance(node.op, ast.Not):
                return _not_expr(v)
            raise LiftRefused("unary op")
        if isinstance(node, ast.Compare):
            return self._lift_compare(node, scope)
        if isinstance(node, ast.BoolOp):
            # `a and b` == b if truthy(a) else a; `a or b` == a if
            # truthy(a) else b — if_else selects per row by Python
            # truthiness, so this is exact for any operand types.
            # (Operands are evaluated eagerly; errors become per-row
            # Error values, which where-selection then discards for rows
            # whose branch was not taken.)
            vals = [self.lift(v, scope) for v in node.values]
            out = vals[0]
            for v in vals[1:]:
                if isinstance(node.op, ast.And):
                    out = IfElseExpression(out, v, out)
                else:
                    out = IfElseExpression(out, out, v)
            return out
        if isinstance(node, ast.IfExp):
            return IfElseExpression(
                self.lift(node.test, scope),
                self.lift(node.body, scope),
                self.lift(node.orelse, scope),
            )
        if isinstance(node, ast.Subscript):
            if isinstance(node.slice, ast.Slice):
                raise LiftRefused("slice subscript")
            return GetExpression(
                self.lift(node.value, scope),
                self.lift(node.slice, scope),
                check_if_exists=True,
            )
        if isinstance(node, ast.Attribute):
            engine = _ATTR_LIFTS.get(node.attr)
            if engine is None:
                raise LiftRefused(f"attribute {node.attr}")
            return MethodCallExpression(engine, [self.lift(node.value, scope)])
        if isinstance(node, ast.Call):
            return self._lift_call(node, scope)
        if isinstance(node, ast.Tuple):
            return MakeTupleExpression(
                *[self.lift(e, scope) for e in node.elts]
            )
        if isinstance(node, ast.JoinedStr):
            return self._lift_fstring(node, scope)
        raise LiftRefused(f"expression {type(node).__name__}")

    def _lift_compare(self, node: ast.Compare, scope) -> ColumnExpression:
        if any(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
            # only the sole-comparator `x is [not] None` form lifts
            if len(node.ops) != 1 or not (
                isinstance(node.comparators[0], ast.Constant)
                and node.comparators[0].value is None
            ):
                raise LiftRefused("`is` outside `x is [not] None`")
            cls = (
                IsNoneExpression
                if isinstance(node.ops[0], ast.Is)
                else IsNotNoneExpression
            )
            return cls(self.lift(node.left, scope))
        parts: list[ColumnExpression] = []
        left = self.lift(node.left, scope)
        for op, comparator in zip(node.ops, node.comparators):
            sym = _CMP_OPS.get(type(op))
            if sym is None:
                raise LiftRefused(f"compare {type(op).__name__}")
            right = self.lift(comparator, scope)
            parts.append(ColumnBinaryOpExpression(left, right, sym))
            left = right
        out = parts[0]
        for p in parts[1:]:
            out = ColumnBinaryOpExpression(out, p, "&")
        return out

    def _lift_call(self, node: ast.Call, scope) -> ColumnExpression:
        if node.keywords:
            raise LiftRefused("call with keywords")
        args = [self.lift(a, scope) for a in node.args]
        f = node.func
        if isinstance(f, ast.Attribute):
            builder = _METHOD_LIFTS.get(f.attr)
            if builder is None:
                raise LiftRefused(f"method {f.attr}")
            recv = self.lift(f.value, scope)
            try:
                return builder(recv, *args)
            except TypeError:
                raise LiftRefused(f"arity of {f.attr}") from None
        if isinstance(f, ast.Name):
            entry = _BUILTIN_LIFTS.get(f.id)
            if entry is None or not _builtin_ok(self.fn, f.id):
                raise LiftRefused(f"call to {getattr(f, 'id', '?')}")
            builder, lo, hi = entry
            if not lo <= len(args) <= hi:
                raise LiftRefused(f"arity of {f.id}")
            return builder(*args)
        raise LiftRefused("computed call")

    def _lift_fstring(self, node: ast.JoinedStr, scope) -> ColumnExpression:
        out: ColumnExpression | None = None
        for part in node.values:
            if isinstance(part, ast.Constant):
                piece: Any = smart_coerce(part.value)
            elif isinstance(part, ast.FormattedValue):
                if part.format_spec is not None or part.conversion not in (
                    -1, 115,  # default / !s — both str()
                ):
                    raise LiftRefused("f-string format spec")
                piece = MethodCallExpression(
                    "to_string", [self.lift(part.value, scope)]
                )
            else:
                raise LiftRefused("f-string part")
            out = piece if out is None else ColumnBinaryOpExpression(
                out, piece, "+"
            )
        if out is None:
            return smart_coerce("")
        return out


# ---------------------------------------------------------------------------
# probe-row value tracing
# ---------------------------------------------------------------------------


def _unwrap_operand(x: Any) -> tuple[Any, Any]:
    """(real value, expression operand) of a tracer or plain constant."""
    if isinstance(x, ValueTracer):
        return x.v, x.e
    if isinstance(x, ColumnExpression):
        raise TraceRefused
    return x, x  # constant — smart_coerce'd by the expression ctor


def _trace_binop(sym: str):
    import operator as _op

    py = {
        "+": _op.add, "-": _op.sub, "*": _op.mul, "/": _op.truediv,
        "//": _op.floordiv, "%": _op.mod, "**": _op.pow,
        "==": _op.eq, "!=": _op.ne, "<": _op.lt, "<=": _op.le,
        ">": _op.gt, ">=": _op.ge, "&": _op.and_, "|": _op.or_,
        "^": _op.xor, "<<": _op.lshift, ">>": _op.rshift, "@": _op.matmul,
    }[sym]

    def fwd(self: "ValueTracer", other: Any) -> "ValueTracer":
        ov, oe = _unwrap_operand(other)
        return ValueTracer(
            py(self.v, ov), ColumnBinaryOpExpression(self.e, oe, sym)
        )

    def rev(self: "ValueTracer", other: Any) -> "ValueTracer":
        ov, oe = _unwrap_operand(other)
        return ValueTracer(
            py(ov, self.v), ColumnBinaryOpExpression(oe, self.e, sym)
        )

    return fwd, rev


class _TracedMethod:
    __slots__ = ("_recv", "_name")

    def __init__(self, recv: "ValueTracer", name: str):
        self._recv = recv
        self._name = name

    def __call__(self, *args: Any, **kwargs: Any) -> "ValueTracer":
        if kwargs:
            raise TraceRefused
        real_args, expr_args = [], []
        for a in args:
            rv, re_ = _unwrap_operand(a)
            real_args.append(rv)
            expr_args.append(re_)
        real = getattr(self._recv.v, self._name)(*real_args)
        builder = (
            _METHOD_LIFTS.get(self._name) or _TRACER_ONLY_LIFTS[self._name]
        )
        try:
            expr = builder(self._recv.e, *expr_args)
        except TypeError:
            raise TraceRefused from None
        return ValueTracer(real, expr)


class ValueTracer:
    """A probe-row scalar carrying (real value, symbolic expression).
    Every supported operation computes the genuine Python result AND
    records the columnar expression; anything that would fold a value
    into control flow or a foreign type raises :class:`TraceRefused`."""

    __slots__ = ("v", "e")

    def __init__(self, v: Any, e: Any):
        self.v = v
        self.e = smart_coerce(e) if not isinstance(e, ColumnExpression) else e

    # control flow / coercions a trace cannot represent
    def __bool__(self) -> bool:
        raise TraceRefused

    def __len__(self) -> int:
        raise TraceRefused

    def __iter__(self):
        raise TraceRefused

    def __contains__(self, item):
        raise TraceRefused

    def __int__(self):
        raise TraceRefused

    def __float__(self):
        raise TraceRefused

    def __index__(self):
        raise TraceRefused

    def __str__(self):
        raise TraceRefused

    def __format__(self, spec):
        raise TraceRefused

    def __hash__(self):
        return object.__hash__(self)

    # value access
    def __getitem__(self, k):
        kv, ke = _unwrap_operand(k)
        return ValueTracer(
            self.v[kv], GetExpression(self.e, ke, check_if_exists=True)
        )

    def __getattr__(self, name: str):
        engine = _ATTR_LIFTS.get(name)
        if engine is not None and isinstance(
            self.v, (datetime.date, datetime.datetime)
        ):
            return ValueTracer(
                getattr(self.v, name), MethodCallExpression(engine, [self.e])
            )
        if (name in _METHOD_LIFTS or name in _TRACER_ONLY_LIFTS) and callable(
            getattr(type(self.v), name, None)
        ):
            if name in _TRACER_ONLY_LIFTS and not isinstance(self.v, dict):
                raise TraceRefused  # .get's kernel is dict-typed
            return _TracedMethod(self, name)
        raise TraceRefused

    # unary
    def __neg__(self):
        return ValueTracer(-self.v, ColumnUnaryOpExpression(self.e, "-"))

    def __pos__(self):
        return ValueTracer(+self.v, self.e)

    def __invert__(self):
        return ValueTracer(~self.v, ColumnUnaryOpExpression(self.e, "~"))

    def __abs__(self):
        return ValueTracer(abs(self.v), ColumnUnaryOpExpression(self.e, "abs"))

    def __round__(self, nd=None):
        if nd is None:
            return ValueTracer(round(self.v), _round_expr(self.e))
        nv, ne = _unwrap_operand(nd)
        return ValueTracer(round(self.v, nv), _round_expr(self.e, ne))


for _sym in (
    "+", "-", "*", "/", "//", "%", "**", "&", "|", "^", "<<", ">>", "@",
):
    _f, _r = _trace_binop(_sym)
    _n = {
        "+": "add", "-": "sub", "*": "mul", "/": "truediv",
        "//": "floordiv", "%": "mod", "**": "pow", "&": "and",
        "|": "or", "^": "xor", "<<": "lshift", ">>": "rshift",
        "@": "matmul",
    }[_sym]
    setattr(ValueTracer, f"__{_n}__", _f)
    setattr(ValueTracer, f"__r{_n}__", _r)
for _sym, _n in (
    ("==", "eq"), ("!=", "ne"), ("<", "lt"),
    ("<=", "le"), (">", "gt"), (">=", "ge"),
):
    _f, _r = _trace_binop(_sym)
    setattr(ValueTracer, f"__{_n}__", _f)
del _sym, _n, _f, _r


def trace_probe(
    fn: Callable,
    probe_args: list,
    arg_exprs: list,
    probe_kwargs: dict[str, Any],
    kwarg_exprs: dict[str, Any],
) -> tuple[ColumnExpression, Any]:
    """Run ``fn`` once on the probe row with tracer-wrapped arguments.
    Returns (traced expression, the genuine scalar result for the probe
    row — the caller's consistency check). Raises TraceRefused (or any
    error the probe row itself would raise per-row) on failure."""
    tracers = [ValueTracer(v, e) for v, e in zip(probe_args, arg_exprs)]
    kts = {
        k: ValueTracer(probe_kwargs[k], kwarg_exprs[k]) for k in probe_kwargs
    }
    out = fn(*tracers, **kts)
    if isinstance(out, ValueTracer):
        return out.e, out.v
    if isinstance(out, _CONST_TYPES):
        # a constant-valued UDF still lifts (rare but valid)
        return smart_coerce(out), out
    raise TraceRefused


# ---------------------------------------------------------------------------
# widened bytecode gate for probe tracing
# ---------------------------------------------------------------------------

#: globals a traced callable may read — they resolve to tracer dunders
#: (``abs``/``round``) so the probe stays symbolic
_TRACE_GLOBAL_WHITELIST = frozenset({"abs", "round"})

_BLOCKED_TRACE_OPS = (
    # side effects / late binding
    "IMPORT", "MAKE_FUNCTION", "MAKE_CELL",
    "STORE_GLOBAL", "STORE_DEREF", "STORE_ATTR", "STORE_SUBSCR",
    "DELETE_GLOBAL", "DELETE_DEREF", "DELETE_ATTR", "DELETE_SUBSCR",
    "LOAD_DEREF", "LOAD_CLASSDEREF", "LOAD_NAME", "LOAD_BUILD_CLASS",
    # iteration / generators (tracer iteration would spin or fold)
    "GET_ITER", "FOR_ITER", "GET_AITER", "GET_ANEXT", "GET_AWAITABLE",
    "YIELD", "RETURN_GENERATOR", "UNPACK",
    # identity tests fold silently on a tracer (no dunder fires)
    "IS_OP", "POP_JUMP_IF_NONE", "POP_JUMP_IF_NOT_NONE",
    "CONTAINS_OP",
    # exception machinery: a UDF-level `except` could mask TraceRefused
    # ordering subtleties; stay per-row
    "SETUP_FINALLY", "SETUP_WITH", "BEFORE_WITH", "RAISE_VARARGS",
    "RERAISE", "PUSH_EXC_INFO", "CHECK_EXC_MATCH", "JUMP_IF_NOT_EXC",
    "WITH_EXCEPT", "END_ASYNC",
)

#: verdicts per code object; capped with oldest-half eviction (the
#: verdict is a pure bytecode property, so the code object is the key)
_TRACEABLE_CACHE: dict[Any, bool] = {}
_TRACEABLE_CACHE_MAX = 1024


def evict_oldest_half(d: dict) -> None:
    """Drop the least-recently-inserted half of a dict-backed cache —
    the cliff-free replacement for wholesale ``clear()`` (a long-lived
    multi-pipeline process must not re-derive every cached verdict at
    once)."""
    import itertools

    for k in list(itertools.islice(iter(d), max(1, len(d) // 2))):
        del d[k]


def traceable(fn: Callable) -> bool:
    """May ``fn`` be probe-traced? A single probe run must be unable to
    execute side effects the per-row path would have run per row: no
    stores outside locals, no imports, no closure/global reads (beyond
    the safe builtin subset), no iteration, no exception handling.
    CALLs are allowed — with globals restricted, the only reachable
    callables are tracer methods (intercepted) and whitelisted
    builtins."""
    code = getattr(fn, "__code__", None)
    if code is None:
        return False
    hit = _TRACEABLE_CACHE.get(code)
    if hit is not None:
        return hit
    import dis

    try:
        instructions = list(dis.get_instructions(fn))
    except TypeError:
        return False
    verdict = True
    for ins in instructions:
        name = ins.opname
        if name.startswith("LOAD_GLOBAL"):
            if (
                ins.argval not in _TRACE_GLOBAL_WHITELIST
                or not _builtin_ok(fn, ins.argval)
            ):
                verdict = False
                break
            continue
        if name.startswith(_BLOCKED_TRACE_OPS):
            verdict = False
            break
    if len(_TRACEABLE_CACHE) >= _TRACEABLE_CACHE_MAX:
        evict_oldest_half(_TRACEABLE_CACHE)
    _TRACEABLE_CACHE[code] = verdict
    return verdict
