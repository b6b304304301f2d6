"""``pw.sql(query, **tables)`` — SQL compiled to Table operations.

Re-design of ``python/pathway/internals/sql.py`` (726 LoC). The reference
parses with sqlglot and walks its AST into Table ops; sqlglot is not in
this environment, so this module carries its own tokenizer + recursive-
descent parser for the supported subset, then compiles to the same Table
operations (select/filter/join/groupby-reduce/union):

    SELECT [DISTINCT] expr [AS name], ...
    FROM t [AS a] [ [INNER|LEFT|RIGHT|OUTER] JOIN t2 ON cond ]*
    [WHERE cond] [GROUP BY e, ... [HAVING cond]]
    [UNION [ALL] <select>]

Expressions: literals, [table.]column, + - * / % arithmetic, comparisons,
AND/OR/NOT, IS [NOT] NULL, IN (v, ...), BETWEEN, CASE WHEN, COALESCE,
and the aggregates COUNT(*)/COUNT/SUM/AVG/MIN/MAX.

Copy of ``pathway_tpu/internals/sql.py``, over the port's Table API and engine nodes.
"""

from __future__ import annotations

import re
from typing import Any

from . import dtype as dt
from .expression import ColumnExpression, apply_with_type, if_else
from .table import Table

__all__ = ["sql"]

# ---------------------------------------------------------------------------
# tokenizer


_TOKEN_RE = re.compile(
    r"""\s*(?:
        (?P<num>\d+\.\d+|\d+)
      | (?P<str>'(?:[^']|'')*')
      | (?P<op><>|!=|<=|>=|=|<|>|\+|-|\*|/|%|\(|\)|,|\.)
      | (?P<name>[A-Za-z_][A-Za-z0-9_]*)
    )""",
    re.VERBOSE,
)

_KEYWORDS = {
    "select", "distinct", "from", "where", "group", "by", "having", "as",
    "join", "inner", "left", "right", "outer", "full", "on", "and", "or",
    "not", "is", "null", "in", "between", "like", "union", "all", "case",
    "when", "then", "else", "end", "true", "false", "with",
}


class SqlSyntaxError(ValueError):
    pass


def _tokenize(src: str) -> list[tuple[str, Any]]:
    out: list[tuple[str, Any]] = []
    pos = 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if m is None:
            rest = src[pos:].strip()
            if not rest:
                break
            raise SqlSyntaxError(f"cannot tokenize SQL at: {rest[:30]!r}")
        pos = m.end()
        if m.group("num") is not None:
            text = m.group("num")
            out.append(("num", float(text) if "." in text else int(text)))
        elif m.group("str") is not None:
            out.append(("str", m.group("str")[1:-1].replace("''", "'")))
        elif m.group("op") is not None:
            out.append(("op", m.group("op")))
        else:
            name = m.group("name")
            if name.lower() in _KEYWORDS:
                out.append(("kw", name.lower()))
            else:
                out.append(("name", name))
    return out


# ---------------------------------------------------------------------------
# AST


class _Node(dict):
    def __init__(self, kind: str, **kw: Any):
        super().__init__(kind=kind, **kw)

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e


class _Parser:
    def __init__(self, tokens: list[tuple[str, Any]]):
        self._anon = 0
        self.toks = tokens
        self.i = 0

    # -- token helpers --

    def peek(self, ahead: int = 0) -> tuple[str, Any]:
        j = self.i + ahead
        return self.toks[j] if j < len(self.toks) else ("eof", None)

    def next(self) -> tuple[str, Any]:
        t = self.peek()
        self.i += 1
        return t

    def accept(self, kind: str, value: Any = None) -> bool:
        k, v = self.peek()
        if k == kind and (value is None or v == value):
            self.i += 1
            return True
        return False

    def expect(self, kind: str, value: Any = None) -> Any:
        k, v = self.peek()
        if k != kind or (value is not None and v != value):
            raise SqlSyntaxError(
                f"expected {value or kind}, got {v!r} (token {self.i})"
            )
        self.i += 1
        return v

    # -- grammar --

    def parse(self) -> _Node:
        node = self.query()
        if self.peek()[0] != "eof":
            raise SqlSyntaxError(f"trailing tokens: {self.toks[self.i:]}")
        return node

    def query(self) -> _Node:
        """[WITH ctes] SELECT with optional UNION [ALL] chain (also the
        body of a parenthesized derived table)."""
        ctes: list[tuple[str, _Node]] = []
        if self.accept("kw", "with"):
            while True:
                name = self.expect("name")
                self.expect("kw", "as")
                self.expect("op", "(")
                body = self.query()
                self.expect("op", ")")
                ctes.append((name, body))
                if not self.accept("op", ","):
                    break
        node = self.select()
        while self.accept("kw", "union"):
            all_ = self.accept("kw", "all")
            rhs = self.select()
            node = _Node("union", left=node, right=rhs, all=all_)
        if ctes:
            node = _Node("with", ctes=ctes, body=node)
        return node

    def select(self) -> _Node:
        self.expect("kw", "select")
        distinct = self.accept("kw", "distinct")
        items = [self.select_item()]
        while self.accept("op", ","):
            items.append(self.select_item())
        self.expect("kw", "from")
        table = self.table_ref()
        joins = []
        while True:
            mode = None
            if self.accept("kw", "join") or (
                self.accept("kw", "inner") and self.expect("kw", "join")
            ):
                mode = "inner"
            elif self.accept("kw", "left"):
                self.accept("kw", "outer")
                self.expect("kw", "join")
                mode = "left"
            elif self.accept("kw", "right"):
                self.accept("kw", "outer")
                self.expect("kw", "join")
                mode = "right"
            elif self.accept("kw", "full") or self.accept("kw", "outer"):
                self.accept("kw", "outer")
                self.expect("kw", "join")
                mode = "outer"
            else:
                break
            jt = self.table_ref()
            self.expect("kw", "on")
            cond = self.expr()
            joins.append(_Node("join", table=jt, on=cond, mode=mode))
        where = self.expr() if self.accept("kw", "where") else None
        group = None
        having = None
        # the reference (via sqlglot) tolerates HAVING before GROUP BY —
        # accept the clauses in either order, each at most once
        while True:
            if self.accept("kw", "group"):
                if group is not None:
                    raise SqlSyntaxError("duplicate GROUP BY clause")
                self.expect("kw", "by")
                group = [self.expr()]
                while self.accept("op", ","):
                    group.append(self.expr())
            elif self.accept("kw", "having"):
                if having is not None:
                    raise SqlSyntaxError("duplicate HAVING clause")
                having = self.expr()
            else:
                break
        return _Node(
            "select", items=items, table=table, joins=joins,
            where=where, group=group, having=having, distinct=distinct,
        )

    def table_ref(self) -> _Node:
        if self.accept("op", "("):
            # derived table: FROM (SELECT ... [UNION ...]) [AS] alias
            inner = self.query()
            self.expect("op", ")")
            alias = None
            if self.accept("kw", "as"):
                alias = self.expect("name")
            elif self.peek()[0] == "name":
                alias = self.next()[1]
            if alias is None:
                # distinct fallback aliases: two anonymous derived tables
                # in one query must not evict each other from the env
                self._anon += 1
                alias = f"_subquery_{self._anon}"
            return _Node("subquery", select=inner, alias=alias)
        name = self.expect("name")
        alias = None
        if self.accept("kw", "as"):
            alias = self.expect("name")
        elif self.peek()[0] == "name":
            alias = self.next()[1]
        return _Node("table", name=name, alias=alias or name)

    def select_item(self) -> _Node:
        if self.accept("op", "*"):
            return _Node("star", table=None)
        if (
            self.peek()[0] == "name"
            and self.peek(1) == ("op", ".")
            and self.peek(2) == ("op", "*")
        ):
            tname = self.next()[1]
            self.next()
            self.next()
            return _Node("star", table=tname)
        e = self.expr()
        alias = None
        if self.accept("kw", "as"):
            alias = self.expect("name")
        elif self.peek()[0] == "name":
            alias = self.next()[1]
        return _Node("item", expr=e, alias=alias)

    # precedence: or < and < not < comparison < additive < multiplicative

    def expr(self) -> _Node:
        node = self.and_expr()
        while self.accept("kw", "or"):
            node = _Node("or", left=node, right=self.and_expr())
        return node

    def and_expr(self) -> _Node:
        node = self.not_expr()
        while self.accept("kw", "and"):
            node = _Node("and", left=node, right=self.not_expr())
        return node

    def not_expr(self) -> _Node:
        if self.accept("kw", "not"):
            return _Node("not", arg=self.not_expr())
        return self.comparison()

    def comparison(self) -> _Node:
        node = self.additive()
        k, v = self.peek()
        if k == "op" and v in ("=", "<>", "!=", "<", "<=", ">", ">="):
            self.next()
            return _Node("cmp", op=v, left=node, right=self.additive())
        if k == "kw" and v == "is":
            self.next()
            negate = self.accept("kw", "not")
            self.expect("kw", "null")
            return _Node("isnull", arg=node, negate=negate)
        if k == "kw" and v == "in":
            self.next()
            self.expect("op", "(")
            vals = [self.additive()]
            while self.accept("op", ","):
                vals.append(self.additive())
            self.expect("op", ")")
            return _Node("in", arg=node, values=vals)
        if k == "kw" and v == "between":
            self.next()
            lo = self.additive()
            self.expect("kw", "and")
            hi = self.additive()
            return _Node("between", arg=node, lo=lo, hi=hi)
        if k == "kw" and v == "like":
            self.next()
            pat = self.additive()
            return _Node("like", arg=node, pattern=pat)
        return node

    def additive(self) -> _Node:
        node = self.multiplicative()
        while True:
            if self.accept("op", "+"):
                node = _Node("bin", op="+", left=node, right=self.multiplicative())
            elif self.accept("op", "-"):
                node = _Node("bin", op="-", left=node, right=self.multiplicative())
            else:
                return node

    def multiplicative(self) -> _Node:
        node = self.unary()
        while True:
            if self.accept("op", "*"):
                node = _Node("bin", op="*", left=node, right=self.unary())
            elif self.accept("op", "/"):
                node = _Node("bin", op="/", left=node, right=self.unary())
            elif self.accept("op", "%"):
                node = _Node("bin", op="%", left=node, right=self.unary())
            else:
                return node

    def unary(self) -> _Node:
        if self.accept("op", "-"):
            return _Node("neg", arg=self.unary())
        return self.primary()

    def primary(self) -> _Node:
        k, v = self.peek()
        if k == "num" or k == "str":
            self.next()
            return _Node("lit", value=v)
        if k == "kw" and v in ("true", "false"):
            self.next()
            return _Node("lit", value=(v == "true"))
        if k == "kw" and v == "null":
            self.next()
            return _Node("lit", value=None)
        if k == "kw" and v == "case":
            return self.case_expr()
        if self.accept("op", "("):
            node = self.expr()
            self.expect("op", ")")
            return node
        if k == "name":
            self.next()
            # function call?
            if self.accept("op", "("):
                fname = v.lower()
                if fname == "count" and self.accept("op", "*"):
                    self.expect("op", ")")
                    return _Node("func", name="count", args=[])
                args = []
                if not self.accept("op", ")"):
                    args.append(self.expr())
                    while self.accept("op", ","):
                        args.append(self.expr())
                    self.expect("op", ")")
                return _Node("func", name=fname, args=args)
            # qualified column?
            if self.accept("op", "."):
                col = self.expect("name")
                return _Node("col", table=v, name=col)
            return _Node("col", table=None, name=v)
        raise SqlSyntaxError(f"unexpected token {v!r}")

    def case_expr(self) -> _Node:
        self.expect("kw", "case")
        whens = []
        while self.accept("kw", "when"):
            cond = self.expr()
            self.expect("kw", "then")
            whens.append((cond, self.expr()))
        default = self.expr() if self.accept("kw", "else") else _Node("lit", value=None)
        self.expect("kw", "end")
        return _Node("case", whens=whens, default=default)


# ---------------------------------------------------------------------------
# compiler

_AGGREGATES = {"count", "sum", "avg", "min", "max"}


def _walk(node: Any):
    if isinstance(node, dict):
        yield node
        for v in node.values():
            yield from _walk(v)
    elif isinstance(node, (list, tuple)):
        for x in node:
            yield from _walk(x)


def _has_aggregate(node: _Node) -> bool:
    return any(
        n.get("kind") == "func" and n.get("name") in _AGGREGATES
        for n in _walk(node)
    )


class _Compiler:
    def __init__(self, tables: dict[str, Table]):
        self.tables = tables

    def compile(self, node: _Node) -> Table:
        if node["kind"] == "with":
            # each CTE materializes into the table env for the WITH body
            # only — restore afterwards so a CTE inside a subquery cannot
            # shadow outer tables
            saved = self.tables
            try:
                for name, body in node.ctes:
                    self.tables = {**self.tables, name: self.compile(body)}
                return self.compile(node.body)
            finally:
                self.tables = saved
        if node["kind"] == "union":
            left = self.compile(node.left)
            right = self.compile(node.right)
            out = left.concat_reindex(right)
            if not node.all:
                out = _distinct(out)
            return out
        return self.compile_select(node)

    # -- FROM/JOIN resolution --

    def _resolve_source(self, sel: _Node) -> tuple[Table, dict[str, Table]]:
        """The working table + alias env. Joins compile to pw joins keeping
        both sides' columns (qualified names disambiguated). Also records
        ``self._alias_cols``: alias -> the names its columns carry in the
        working table (for qualified ``alias.*`` expansion)."""
        def lookup(tref: _Node) -> Table:
            if tref["kind"] == "subquery":
                return self.compile(tref["select"])  # handles UNION bodies
            name = tref["name"]
            if name not in self.tables:
                raise KeyError(f"unknown table {name!r} in SQL (pass it as kwarg)")
            return self.tables[name]

        base = lookup(sel.table)
        env: dict[str, Table] = {sel.table["alias"]: base}
        # built locally: lookup() of a derived table (subquery in JOIN
        # position) recursively compiles and would clobber self._alias_cols
        # mid-loop (ADVICE r4) — publish only once all joins resolve
        alias_cols = {sel.table["alias"]: list(base.column_names())}
        current = base
        for join in sel.joins:
            right = lookup(join.table)
            alias = join.table["alias"]
            env[alias] = right
            cond = join.on
            # only equi-joins compile to keyed joins
            if cond["kind"] != "cmp" or cond["op"] != "=":
                raise SqlSyntaxError("JOIN ON requires an equality condition")
            lexpr = self._expr(cond["left"], env)
            rexpr = self._expr(cond["right"], env)
            from .joins import JoinMode

            mode = join["mode"]
            joined = current.join(
                right, lexpr == rexpr,
                how={"inner": JoinMode.INNER, "left": JoinMode.LEFT,
                     "right": JoinMode.RIGHT, "outer": JoinMode.OUTER}[mode],
            )
            # materialize both sides' columns under unqualified names where
            # unambiguous; qualified refs re-resolve via env
            out_cols: dict[str, Any] = {}
            from .thisclass import left as l_, right as r_

            for c in current.column_names():
                out_cols[c] = getattr(l_, c)
            right_names = []
            for c in right.column_names():
                if c in out_cols:
                    out_cols[f"{alias}.{c}"] = getattr(r_, c)
                    right_names.append(f"{alias}.{c}")
                else:
                    out_cols[c] = getattr(r_, c)
                    right_names.append(c)
            alias_cols[alias] = right_names
            current = joined.select(**out_cols)
            env = {a: current for a in env}  # all aliases now view the join
        self._alias_cols = alias_cols
        return current, env

    # -- expressions --

    def _expr(self, node: _Node, env: dict[str, Table]) -> Any:
        kind = node["kind"]
        if kind == "lit":
            return node["value"]
        if kind == "col":
            tname, cname = node["table"], node["name"]
            if tname is not None:
                t = env.get(tname)
                if t is None:
                    raise KeyError(f"unknown table alias {tname!r}")
                qual = f"{tname}.{cname}"
                if qual in t.column_names():
                    return t[qual]
                return t[cname]
            for t in dict.fromkeys(env.values()):
                if cname in t.column_names():
                    return t[cname]
            raise KeyError(f"unknown column {cname!r}")
        if kind == "bin":
            lhs, rhs = self._expr(node["left"], env), self._expr(node["right"], env)
            op = node["op"]
            if op == "+":
                return lhs + rhs
            if op == "-":
                return lhs - rhs
            if op == "*":
                return lhs * rhs
            if op == "/":
                return lhs / rhs
            return lhs % rhs
        if kind == "neg":
            return -self._expr(node["arg"], env)
        if kind == "cmp":
            lhs, rhs = self._expr(node["left"], env), self._expr(node["right"], env)
            op = node["op"]
            if op == "=":
                return lhs == rhs
            if op in ("<>", "!="):
                return lhs != rhs
            if op == "<":
                return lhs < rhs
            if op == "<=":
                return lhs <= rhs
            if op == ">":
                return lhs > rhs
            return lhs >= rhs
        if kind == "and":
            return self._expr(node["left"], env) & self._expr(node["right"], env)
        if kind == "or":
            return self._expr(node["left"], env) | self._expr(node["right"], env)
        if kind == "not":
            return ~self._expr(node["arg"], env)
        if kind == "isnull":
            arg = self._expr(node["arg"], env)
            isnull = apply_with_type(lambda v: v is None, dt.BOOL, arg)
            return ~isnull if node["negate"] else isnull
        if kind == "in":
            arg = self._expr(node["arg"], env)
            vals = [self._expr(v, env) for v in node["values"]]
            if any(isinstance(v, ColumnExpression) for v in vals):
                raise SqlSyntaxError("IN list must be literal values")
            vs = tuple(vals)
            return apply_with_type(lambda x, vs=vs: x in vs, dt.BOOL, arg)
        if kind == "between":
            arg = self._expr(node["arg"], env)
            lo = self._expr(node["lo"], env)
            hi = self._expr(node["hi"], env)
            return (arg >= lo) & (arg <= hi)
        if kind == "like":
            arg = self._expr(node["arg"], env)
            pat = self._expr(node["pattern"], env)
            if isinstance(pat, ColumnExpression):
                raise SqlSyntaxError("LIKE pattern must be a literal")
            rx = re.compile(
                "^"
                + "".join(
                    ".*" if ch == "%" else "." if ch == "_" else re.escape(ch)
                    for ch in str(pat)
                )
                + "$"
            )
            return apply_with_type(
                lambda s, rx=rx: s is not None and rx.match(str(s)) is not None,
                dt.BOOL, arg,
            )
        if kind == "case":
            result: Any = self._expr(node["default"], env)
            for cond, then in reversed(node["whens"]):
                result = if_else(
                    self._expr(cond, env), self._expr(then, env), result
                )
            return result
        if kind == "func":
            return self._func(node, env)
        raise SqlSyntaxError(f"unsupported expression kind {kind!r}")

    def _func(self, node: _Node, env: dict[str, Table]) -> Any:
        name = node["name"]
        if name in _AGGREGATES:
            raise SqlSyntaxError(
                f"aggregate {name}() outside SELECT/HAVING of a GROUP BY"
            )
        args = [self._expr(a, env) for a in node["args"]]
        return self._scalar_func(name, args)

    def _scalar_func(self, name: str, args: list[Any]) -> Any:
        if name == "coalesce":
            from .expression import coalesce

            return coalesce(*args)
        if name == "abs":
            return apply_with_type(
                lambda v: None if v is None else abs(v), dt.ANY, args[0]
            )
        if name in ("upper", "lower"):
            fn = str.upper if name == "upper" else str.lower
            return apply_with_type(
                lambda v, fn=fn: None if v is None else fn(str(v)), dt.STR, args[0]
            )
        if name == "length":
            return apply_with_type(
                lambda v: None if v is None else len(v), dt.INT, args[0]
            )
        if name == "round":
            return apply_with_type(
                lambda v, *nd: None if v is None else round(v, *(int(n) for n in nd)),
                dt.ANY, *args,
            )
        raise SqlSyntaxError(f"unsupported SQL function {name!r}")

    def _aggregate(self, node: _Node, env: dict[str, Table]):
        """Aggregate call -> pw.reducers expression."""
        from .. import reducers

        name = node["name"]
        if name == "count":
            if not node["args"]:
                return reducers.count()
            # COUNT(expr) counts non-NULL values only (SQL semantics)
            (arg,) = [self._expr(a, env) for a in node["args"]]
            return reducers.sum(
                apply_with_type(lambda v: 0 if v is None else 1, dt.INT, arg)
            )
        (arg,) = [self._expr(a, env) for a in node["args"]]
        return {
            "sum": reducers.sum,
            "avg": reducers.avg,
            "min": reducers.min,
            "max": reducers.max,
        }[name](arg)

    def _agg_expr(self, node: _Node, env: dict[str, Table]) -> Any:
        """Expression that may contain aggregates (SELECT item / HAVING of a
        grouped query): aggregates lower to reducer expressions inline."""
        if node["kind"] == "func" and node["name"] in _AGGREGATES:
            return self._aggregate(node, env)
        if node["kind"] in ("bin", "cmp", "and", "or"):
            left = self._agg_expr(node["left"], env)
            right = self._agg_expr(node["right"], env)
            op = node.get("op")
            if node["kind"] == "bin":
                return {"+": lambda a, b: a + b, "-": lambda a, b: a - b,
                        "*": lambda a, b: a * b, "/": lambda a, b: a / b,
                        "%": lambda a, b: a % b}[op](left, right)
            if node["kind"] == "cmp":
                return {"=": lambda a, b: a == b, "<>": lambda a, b: a != b,
                        "!=": lambda a, b: a != b, "<": lambda a, b: a < b,
                        "<=": lambda a, b: a <= b, ">": lambda a, b: a > b,
                        ">=": lambda a, b: a >= b}[op](left, right)
            if node["kind"] == "and":
                return left & right
            return left | right
        if node["kind"] == "neg":
            return -self._agg_expr(node["arg"], env)
        if node["kind"] == "not":
            return ~self._agg_expr(node["arg"], env)
        if node["kind"] == "case":
            result: Any = self._agg_expr(node["default"], env)
            for cond, then in reversed(node["whens"]):
                result = if_else(
                    self._agg_expr(cond, env), self._agg_expr(then, env), result
                )
            return result
        if node["kind"] == "func" and node["name"] not in _AGGREGATES:
            return self._scalar_func(
                node["name"], [self._agg_expr(a, env) for a in node["args"]]
            )
        return self._expr(node, env)

    # -- SELECT --

    def compile_select(self, sel: _Node) -> Table:
        current, env = self._resolve_source(sel)

        if sel.where is not None:
            current = current.filter(self._expr(sel.where, env))
            env = {a: current for a in env}

        grouped = sel.group is not None or any(
            n["kind"] == "item" and _has_aggregate(n["expr"]) for n in sel["items"]
        )
        if sel.having is not None and not grouped:
            raise SqlSyntaxError(
                "HAVING requires GROUP BY or aggregate select items"
            )

        if not grouped:
            out_cols: dict[str, Any] = {}
            for i, item in enumerate(sel["items"]):
                if item["kind"] == "star":
                    # `tab.*` expands only the named alias's columns (a
                    # typo'd alias raises, like qualified column refs);
                    # bare `*` expands the whole working table
                    if item["table"] is not None:
                        if item["table"] not in self._alias_cols:
                            raise KeyError(
                                f"unknown table alias {item['table']!r}"
                            )
                        for c in self._alias_cols[item["table"]]:
                            out = (
                                c.split(".", 1)[1]
                                if c.startswith(item["table"] + ".")
                                else c
                            )
                            out_cols[out] = current[c]
                    else:
                        for c in current.column_names():
                            out_cols[c] = current[c]
                    continue
                name = item["alias"] or _default_name(item["expr"], i)
                out_cols[name] = self._expr(item["expr"], env)
            result = current.select(**out_cols)
            if sel.distinct:
                result = _distinct(result)
            return result

        # grouped query
        group_exprs = [self._expr(g, env) for g in (sel.group or [])]
        gb = current.groupby(*group_exprs)
        out_cols = {}
        for i, item in enumerate(sel["items"]):
            if item["kind"] == "star":
                raise SqlSyntaxError("SELECT * not allowed with GROUP BY")
            name = item["alias"] or _default_name(item["expr"], i)
            out_cols[name] = self._agg_expr(item["expr"], env)
        if sel.having is not None:
            out_cols["__having__"] = self._agg_expr(sel.having, env)
        result = gb.reduce(**out_cols)
        if sel.having is not None:
            from .thisclass import this

            result = result.filter(this["__having__"]).select(
                **{c: this[c] for c in out_cols if c != "__having__"}
            )
        if sel.distinct:
            result = _distinct(result)
        return result


def _default_name(node: _Node, i: int) -> str:
    if node["kind"] == "col":
        return node["name"]
    if node["kind"] == "func":
        return node["name"]
    return f"_col_{i}"


def _distinct(table: Table) -> Table:
    from .. import reducers
    from .thisclass import this

    cols = table.column_names()
    gb = table.groupby(*[table[c] for c in cols])
    return gb.reduce(**{c: this[c] for c in cols})


def sql(query: str, **tables: Table) -> Table:
    """Execute a SQL query against the given tables
    (reference internals/sql.py:10 ``pw.sql``)."""
    ast = _Parser(_tokenize(query)).parse()
    return _Compiler(tables).compile(ast)
