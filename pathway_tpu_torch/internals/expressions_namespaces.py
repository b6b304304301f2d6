"""``.str`` / ``.num`` / ``.dt`` expression method namespaces.

Re-design of ``python/pathway/internals/expressions/`` (date_time.py 1,613
LoC, string.py 931 LoC, numerical.py in the reference). Methods compile to
elementwise columnar kernels via ``compile_method``; numeric ones vectorize,
string ones run host-side (strings are irregular data and stay off the TPU —
same split the reference draws between Rust string ops and ndarray ops).
"""

from __future__ import annotations

import datetime
import math
from typing import Any, Callable

import numpy as np

from . import dtype as dt
from .expression import ColumnExpression, MethodCallExpression, smart_coerce


class _Namespace:
    def __init__(self, expression: ColumnExpression):
        self._expression = expression

    def _method(self, name: str, *args: Any, **kwargs: Any) -> MethodCallExpression:
        return MethodCallExpression(name, [self._expression, *args], **kwargs)


class StringNamespace(_Namespace):
    def lower(self):
        return self._method("str.lower")

    def upper(self):
        return self._method("str.upper")

    def strip(self, chars=None):
        return self._method("str.strip", chars)

    def len(self):
        return self._method("str.len")

    def reversed(self):
        return self._method("str.reversed")

    def swapcase(self):
        return self._method("str.swapcase")

    # pre-parity spelling kept as an alias (reference name is ``swapcase``,
    # string.py:358)
    swap_case = swapcase

    def removeprefix(self, prefix):
        return self._method("str.removeprefix", prefix)

    def removesuffix(self, suffix):
        return self._method("str.removesuffix", suffix)

    def title(self):
        return self._method("str.title")

    def count(self, sub):
        return self._method("str.count", sub)

    def find(self, sub):
        return self._method("str.find", sub)

    def rfind(self, sub):
        return self._method("str.rfind", sub)

    def startswith(self, prefix):
        return self._method("str.startswith", prefix)

    def endswith(self, suffix):
        return self._method("str.endswith", suffix)

    def replace(self, old, new, count=-1):
        return self._method("str.replace", old, new, count)

    def split(self, sep=None, maxsplit=-1):
        return self._method("str.split", sep, maxsplit)

    def slice(self, start, end):
        return self._method("str.slice", start, end)

    def parse_int(self, optional: bool = False):
        return self._method("str.parse_int", optional=optional)

    def parse_float(self, optional: bool = False):
        return self._method("str.parse_float", optional=optional)

    def parse_bool(self, true_values=("on", "true", "yes", "1"), false_values=("off", "false", "no", "0"), optional: bool = False):
        return self._method(
            "str.parse_bool",
            true_values=tuple(true_values),
            false_values=tuple(false_values),
            optional=optional,
        )


class NumericalNamespace(_Namespace):
    def abs(self):
        return self._method("num.abs")

    def round(self, decimals=0):
        return self._method("num.round", decimals)

    def fill_na(self, default_value):
        return self._method("num.fill_na", default_value)


class DateTimeNamespace(_Namespace):
    def nanosecond(self):
        return self._method("dt.nanosecond")

    def microsecond(self):
        return self._method("dt.microsecond")

    def millisecond(self):
        return self._method("dt.millisecond")

    def second(self):
        return self._method("dt.second")

    def minute(self):
        return self._method("dt.minute")

    def hour(self):
        return self._method("dt.hour")

    def day(self):
        return self._method("dt.day")

    def month(self):
        return self._method("dt.month")

    def year(self):
        return self._method("dt.year")

    def timestamp(self, unit: str | None = None):
        """Epoch timestamp. With a unit ('s'/'ms'/'us'/'ns'): float, like the
        reference (date_time.py:384). unit=None: int nanoseconds (the
        reference's deprecated default)."""
        return self._method("dt.timestamp", unit=unit)

    def weekday(self):
        return self._method("dt.weekday")

    def from_timestamp(self, unit: str):
        """INT/FLOAT epoch timestamp -> DateTimeNaive (date_time.py:1466)."""
        return self._method("dt.from_timestamp", unit=unit)

    def utc_from_timestamp(self, unit: str):
        """INT/FLOAT epoch timestamp -> DateTimeUtc (date_time.py:1525)."""
        return self._method("dt.from_timestamp", unit=unit).dt.to_utc("UTC")

    # -- Duration totals (date_time.py:1119-1465) -------------------------

    def nanoseconds(self):
        return self._method("dt.nanoseconds")

    def microseconds(self):
        return self._method("dt.microseconds")

    def milliseconds(self):
        return self._method("dt.milliseconds")

    def seconds(self):
        return self._method("dt.seconds")

    def minutes(self):
        return self._method("dt.minutes")

    def hours(self):
        return self._method("dt.hours")

    def days(self):
        return self._method("dt.days")

    def weeks(self):
        return self._method("dt.weeks")

    # -- timezone-aware arithmetic (date_time.py:840-975): compositions
    # over to_utc/to_naive_in_timezone, exactly as the reference builds them

    def add_duration_in_timezone(self, duration, timezone):
        return (self.to_utc(timezone) + duration).dt.to_naive_in_timezone(
            timezone
        )

    def subtract_duration_in_timezone(self, duration, timezone):
        return (self.to_utc(timezone) - duration).dt.to_naive_in_timezone(
            timezone
        )

    def subtract_date_time_in_timezone(self, date_time, timezone):
        return self.to_utc(timezone) - smart_coerce(date_time).dt.to_utc(
            timezone
        )

    def strftime(self, fmt):
        return self._method("dt.strftime", fmt)

    def strptime(self, fmt, contains_timezone: bool | None = None):
        if contains_timezone is None:
            # a literal fmt with %z parses zone-aware values -> UTC dtype
            # (reference infers DATE_TIME_UTC from the format string)
            contains_timezone = isinstance(fmt, str) and "%z" in fmt
        return self._method("dt.strptime", fmt, contains_timezone=contains_timezone)

    def to_naive_in_timezone(self, timezone: str):
        return self._method("dt.to_naive_in_timezone", timezone)

    def to_utc(self, from_timezone: str):
        return self._method("dt.to_utc", from_timezone)

    def round(self, duration):
        return self._method("dt.round", duration)

    def floor(self, duration):
        return self._method("dt.floor", duration)


# ---------------------------------------------------------------------------
# compilation
# ---------------------------------------------------------------------------

_UNIT_NS = {"ns": 1, "us": 1_000, "ms": 1_000_000, "s": 1_000_000_000}


def _td_ns(d: datetime.timedelta) -> int:
    """Exact total nanoseconds of a timedelta (int arithmetic throughout)."""
    return ((d.days * 86400 + d.seconds) * 1_000_000 + d.microseconds) * 1000


def _td_trunc(d: datetime.timedelta, unit_ns: int) -> int:
    """Total whole units, truncating toward zero — chrono ``num_*``
    semantics (reference Duration accessors), not floor division: -90s is
    -1 minute, not -2."""
    ns = _td_ns(d)
    q = abs(ns) // unit_ns
    return q if ns >= 0 else -q


def _dur_ns(d: Any) -> int:
    if isinstance(d, datetime.timedelta):
        return _td_ns(d)
    return int(d)


def _dt_epoch_ns(v: datetime.datetime) -> int:
    """Exact nanoseconds since the epoch (naive: 1970-01-01; aware: UTC)."""
    if v.tzinfo is None:
        epoch = datetime.datetime(1970, 1, 1)
    else:
        epoch = datetime.datetime(1970, 1, 1, tzinfo=datetime.timezone.utc)
    return _td_ns(v - epoch)


def _tz(name: str):
    from zoneinfo import ZoneInfo  # module-level cache inside zoneinfo

    return ZoneInfo(name)


_METHODS: dict[str, tuple[Callable, Callable]] = {
    # name -> (scalar impl, dtype fn over arg dtypes)
    "to_string": (lambda v: str(v), lambda ts: dt.STR),
    "str.lower": (lambda s: s.lower(), lambda ts: dt.STR),
    "str.upper": (lambda s: s.upper(), lambda ts: dt.STR),
    "str.strip": (lambda s, c: s.strip(c), lambda ts: dt.STR),
    "str.len": (lambda s: len(s), lambda ts: dt.INT),
    "str.reversed": (lambda s: s[::-1], lambda ts: dt.STR),
    "str.swapcase": (lambda s: s.swapcase(), lambda ts: dt.STR),
    "str.removeprefix": (lambda s, p: s.removeprefix(p), lambda ts: dt.STR),
    "str.removesuffix": (lambda s, p: s.removesuffix(p), lambda ts: dt.STR),
    "str.title": (lambda s: s.title(), lambda ts: dt.STR),
    "str.count": (lambda s, sub: s.count(sub), lambda ts: dt.INT),
    "str.find": (lambda s, sub: s.find(sub), lambda ts: dt.INT),
    "str.rfind": (lambda s, sub: s.rfind(sub), lambda ts: dt.INT),
    "str.startswith": (lambda s, p: s.startswith(p), lambda ts: dt.BOOL),
    "str.endswith": (lambda s, p: s.endswith(p), lambda ts: dt.BOOL),
    "str.replace": (lambda s, o, n, c: s.replace(o, n, c), lambda ts: dt.STR),
    # exact Python list semantics (a lifted `s.split(...)` must be
    # cell-for-cell identical to the per-row path; the engine used to
    # wrap in tuple, which diverged on == and isinstance checks)
    "str.split": (
        lambda s, sep, m: s.split(sep, m),
        lambda ts: dt.List(dt.STR),
    ),
    "str.slice": (lambda s, a, b: s[a:b], lambda ts: dt.STR),
    "num.abs": (lambda v: abs(v), lambda ts: ts[0]),
    "num.round": (lambda v, d: round(v, d), lambda ts: ts[0]),
    # exact Python int() for lifted UDFs (udf_lift): per element, so
    # int(nan)/int(inf) raise into per-row semantics instead of the
    # dense astype path's silent INT64_MIN
    "py.int": (lambda v: int(v), lambda ts: dt.INT),
    "dt.second": (lambda v: v.second, lambda ts: dt.INT),
    "dt.minute": (lambda v: v.minute, lambda ts: dt.INT),
    "dt.hour": (lambda v: v.hour, lambda ts: dt.INT),
    "dt.day": (lambda v: v.day, lambda ts: dt.INT),
    "dt.month": (lambda v: v.month, lambda ts: dt.INT),
    "dt.year": (lambda v: v.year, lambda ts: dt.INT),
    "dt.microsecond": (lambda v: v.microsecond, lambda ts: dt.INT),
    "dt.millisecond": (lambda v: v.microsecond // 1000, lambda ts: dt.INT),
    "dt.nanosecond": (lambda v: v.microsecond * 1000, lambda ts: dt.INT),
    "dt.strftime": (lambda v, fmt: v.strftime(fmt), lambda ts: dt.STR),
    "dt.weekday": (lambda v: v.weekday(), lambda ts: dt.INT),
    # exact Python datetime.timestamp() for lifted UDFs (udf_lift): tz-
    # aware datetimes convert exactly; naive ones use the LOCAL timezone,
    # like Python — deliberately distinct from dt.timestamp(unit=...),
    # whose naive anchor is the epoch (reference date_time.py:384)
    "py.timestamp": (lambda v: v.timestamp(), lambda ts: dt.FLOAT),
    # Duration totals (reference date_time.py:1119-1465: all are *total*
    # durations as ints, truncating toward zero like chrono's num_*)
    "dt.nanoseconds": (lambda d: _td_ns(d), lambda ts: dt.INT),
    "dt.microseconds": (lambda d: _td_trunc(d, 1_000), lambda ts: dt.INT),
    "dt.milliseconds": (lambda d: _td_trunc(d, 1_000_000), lambda ts: dt.INT),
    "dt.seconds": (lambda d: _td_trunc(d, 1_000_000_000), lambda ts: dt.INT),
    "dt.minutes": (lambda d: _td_trunc(d, 60_000_000_000), lambda ts: dt.INT),
    "dt.hours": (lambda d: _td_trunc(d, 3_600_000_000_000), lambda ts: dt.INT),
    "dt.days": (lambda d: _td_trunc(d, 86_400_000_000_000), lambda ts: dt.INT),
    "dt.weeks": (
        lambda d: _td_trunc(d, 604_800_000_000_000), lambda ts: dt.INT,
    ),
    # timezone conversions (reference date_time.py:660,750; zoneinfo is the
    # chrono-tz analog)
    "dt.to_utc": (
        lambda v, tz: v.replace(tzinfo=_tz(tz)).astimezone(
            datetime.timezone.utc
        ),
        lambda ts: dt.DATE_TIME_UTC,
    ),
    "dt.to_naive_in_timezone": (
        lambda v, tz: v.astimezone(_tz(tz)).replace(tzinfo=None),
        lambda ts: dt.DATE_TIME_NAIVE,
    ),
}


def compile_method(expr: MethodCallExpression, env, build, xp_name):
    name = expr._method
    kw = expr._method_kwargs
    parts = [build(a, env, xp_name) for a in expr._args]
    arg_dtypes = [p[1] for p in parts]
    refs = set().union(*[p[3] for p in parts]) if parts else set()

    if name in ("str.parse_int", "str.parse_float", "str.parse_bool"):
        optional = kw.get("optional", False)
        if name == "str.parse_int":
            conv, out_dt = int, dt.INT
        elif name == "str.parse_float":
            conv, out_dt = float, dt.FLOAT
        else:
            tv = {s.lower() for s in kw.get("true_values", ("true",))}
            fv = {s.lower() for s in kw.get("false_values", ("false",))}

            def conv(s: str) -> bool:
                ls = s.strip().lower()
                if ls in tv:
                    return True
                if ls in fv:
                    return False
                raise ValueError(f"cannot parse {s!r} as bool")

            out_dt = dt.BOOL

        def fn(cols, keys, f=parts[0][0]):
            from .expression_compiler import _materialize

            vals = _materialize(f(cols, keys), len(keys))
            out = np.empty(len(vals), dtype=object)
            for i, s in enumerate(vals):
                if s is None:
                    out[i] = None
                    continue
                try:
                    out[i] = conv(s)
                except ValueError:
                    if optional:
                        out[i] = None
                    else:
                        raise
            if not optional and out_dt != dt.BOOL:
                return out.astype(out_dt.numpy_dtype)
            return out

        return fn, (dt.Optional(out_dt) if optional else out_dt), False, refs

    if name == "dt.timestamp":
        unit = kw.get("unit")
        as_float = unit is not None  # reference: float with a unit, int ns
        # for the deprecated no-unit form (date_time.py:384)
        div = _UNIT_NS[unit or "ns"]

        def fn(cols, keys, f=parts[0][0]):
            from .expression_compiler import _materialize

            vals = _materialize(f(cols, keys), len(keys))
            out = np.empty(
                len(vals), dtype=np.float64 if as_float else np.int64
            )
            for i, v in enumerate(vals):
                ns = _dt_epoch_ns(v)
                out[i] = ns / div if as_float else ns // div
            return out

        return fn, dt.FLOAT if as_float else dt.INT, False, refs

    if name == "dt.from_timestamp":
        mul = _UNIT_NS[kw["unit"]]

        def fn(cols, keys, f=parts[0][0]):
            from .expression_compiler import _materialize

            vals = _materialize(f(cols, keys), len(keys))
            out = np.empty(len(vals), dtype=object)
            epoch = datetime.datetime(1970, 1, 1)
            for i, v in enumerate(vals):
                if isinstance(v, (int, np.integer)):
                    # exact int path: float64 can't hold current-era ns
                    us = (int(v) * mul) // 1000
                else:
                    us = (v * mul) / 1000
                out[i] = epoch + datetime.timedelta(microseconds=us)
            return out

        return fn, dt.DATE_TIME_NAIVE, False, refs

    if name == "dt.strptime":
        contains_tz = kw.get("contains_timezone", False)

        def fn(cols, keys, f=parts[0][0], fmtf=parts[1][0]):
            from .expression_compiler import _materialize

            vals = _materialize(f(cols, keys), len(keys))
            fmts = _materialize(fmtf(cols, keys), len(keys))
            out = np.empty(len(vals), dtype=object)
            for i in range(len(vals)):
                out[i] = datetime.datetime.strptime(vals[i], fmts[i])
            return out

        return fn, dt.DATE_TIME_UTC if contains_tz else dt.DATE_TIME_NAIVE, False, refs

    if name in ("dt.round", "dt.floor"):
        def fn(cols, keys, f=parts[0][0], df=parts[1][0]):
            from .expression_compiler import _materialize

            vals = _materialize(f(cols, keys), len(keys))
            durs = _materialize(df(cols, keys), len(keys))
            out = np.empty(len(vals), dtype=object)
            for i, v in enumerate(vals):
                step = _dur_ns(durs[i])
                epoch = datetime.datetime(1970, 1, 1, tzinfo=v.tzinfo)
                ns = int((v - epoch).total_seconds() * 1_000_000_000)
                if name == "dt.round":
                    ns = (ns + step // 2) // step * step
                else:
                    ns = ns // step * step
                out[i] = epoch + datetime.timedelta(microseconds=ns / 1000)
            return out

        return fn, arg_dtypes[0], False, refs

    if name == "num.fill_na":
        def fn(cols, keys, f=parts[0][0], dflt=parts[1][0]):
            from .expression_compiler import _materialize

            vals = _materialize(f(cols, keys), len(keys))
            dv = _materialize(dflt(cols, keys), len(keys))
            if vals.dtype != object:
                if vals.dtype == np.float64:
                    mask = np.isnan(vals)
                    if mask.any():
                        vals = vals.copy()
                        vals[mask] = dv[mask]
                return vals
            out = np.empty(len(vals), dtype=object)
            for i, v in enumerate(vals):
                bad = v is None or (isinstance(v, float) and math.isnan(v))
                out[i] = dv[i] if bad else v
            from .expression_compiler import _densify

            return _densify(out, dt.unoptionalize(arg_dtypes[0]))

        return fn, dt.unoptionalize(arg_dtypes[0]), False, refs

    if name not in _METHODS:
        # internal invariant: every namespace method constructs a name listed
        # above (the reference's .dt/.str/.num inventory is fully mapped) —
        # reaching here means a namespace/compiler mismatch, not a user error
        raise AssertionError(f"unmapped expression method {name!r}")

    impl, dtype_fn = _METHODS[name]
    out_dt = dtype_fn(arg_dtypes)
    any_opt = any(t.is_optional for t in arg_dtypes)

    def fn(cols, keys):
        from .expression_compiler import _densify, _materialize, _unnp

        n = len(keys)
        arrs = [_materialize(p[0](cols, keys), n) for p in parts]
        out = np.empty(n, dtype=object)
        for i in range(n):
            args_i = [_unnp(a[i]) for a in arrs]
            if args_i and args_i[0] is None:
                out[i] = None
            else:
                out[i] = impl(*args_i)
        return _densify(out, out_dt)

    return fn, (dt.Optional(out_dt) if any_opt else out_dt), False, refs
