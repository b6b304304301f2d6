"""The expression register machine: programs, their plain PyTorch interpreter and the kernel.

Replaces the JAX package's fused expression kernels (``internals/expression_compiler.py:272``
``_make_jitted`` with its cache ``:383`` ``_jitted_kernel``, ``:398`` ``fused_chain_kernel``, and
``engine/fusion.py:607`` ``FusedChain._try_jit``): there one expression DAG, or one fused
Rowwise/Filter chain, is traced into ``jax.jit`` and XLA compiles it. Here the expression compiler
lowers the same tree (``internals/expression_compiler.py::lower_exprs``) through
:class:`ProgramBuilder` into a typed :class:`Program` for one CUDA kernel that is built once,
``csrc/expression_vm.cu``: the program travels in the launch's parameters, with its constants and
loads folded into the operands, and each thread runs it over two rows at a time, its 64-bit
registers and input columns in shared memory sized to the program.

The builder applies ``jax.numpy``'s promotion with x64 (Python constants are weak types; a bool
constant is not), and XLA's semantics where C++ leaves them open: integer arithmetic wraps, a
shift by a count outside ``[0, 64)`` gives 0 (``<<``) or the sign (``>>``), float to int
saturates with NaN to 0, integer ``**`` of two columns is ``jnp.power``'s six-step binary
exponentiation, ``**`` with a constant integer exponent is ``lax.integer_pow``, and ``A + 0.0``
folds to ``A`` as XLA's simplifier folds it. Float ``+ - * /`` round each operation on its own
(no FMA contraction), and a subnormal operand or result of float arithmetic or a comparison
flushes to a zero of its sign, as on XLA's CPU backend, where the JAX package pins its expression
kernels; float ``**`` is the C library's ``pow`` on both routes.

The work is elementwise over columns, so the kernel is bound by the bytes it reads and writes;
on the engine's path the host's upload and readback of those columns are larger still. A
program past the machine's capacity (``MAX_INSNS``, ``MAX_REGS``, ``MAX_CONSTS``, ``MAX_COLS``)
raises ``ValueError`` when it is built.
"""

from __future__ import annotations

import ctypes
import functools
import operator
import threading
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import _kernels

__all__ = [
    "OPS", "MAX_INSNS", "MAX_REGS", "MAX_CONSTS", "MAX_COLS", "KEYS",
    "Program", "ProgramBuilder", "Val", "layout", "expression_vm", "expression_vm_plain",
    "run_program", "run_program_plain", "HostLauncher", "expression_vm_empty",
]

#: the machine's capacity (the same numbers stand in csrc/expression_vm.cu)
MAX_INSNS = 256
MAX_REGS = 64
MAX_CONSTS = 64
MAX_COLS = 32

#: opcodes, in the order of ``enum Op`` in csrc/expression_vm.cu. Operands: ``dst`` the
#: register written; ``a``, ``b``, ``c`` source registers, except where noted.
OPS = {name: i for i, name in enumerate((
    "LD8",     # dst <- input column a, 64-bit row
    "LDB",     # dst <- input column a, bool byte (0 or 1)
    "CONST",   # dst <- constant a
    "ST8",     # output column b, 64-bit row <- a
    "STB",     # output column b, bool byte <- a != 0
    "ADD_I", "SUB_I", "MUL_I",            # int64, wrapping
    "ADD_F", "SUB_F", "MUL_F", "DIV_F",   # float64, each rounded on its own
    "POW_I",   # jnp.power of two int64 columns: six steps of binary exponentiation
    "POW_F",   # pow(a, b) in float64
    "IPOW_I",  # lax.integer_pow(a, constant b >= 0), int64
    "IPOW_F",  # lax.integer_pow(a, constant b), float64 (1 / x^|b| when b < 0)
    "EQ_I", "NE_I", "LT_I", "LE_I",       # int64 (and bool, and uint64 equality)
    "EQ_F", "NE_F", "LT_F", "LE_F",       # float64, false on NaN but for NE
    "LT_U", "LE_U",                       # uint64
    "AND", "OR", "XOR",                   # bitwise on 64 bits (logical on 0/1)
    "SHL", "SHR",                         # int64 shifts, XLA's out-of-range counts
    "NEG_I", "NEG_F", "NOT_I", "NOT_B", "ABS_I", "ABS_F",
    "SEL",     # dst <- a != 0 ? b : c
    "I2F",     # int64 -> float64, to nearest
    "F2I",     # float64 -> int64, toward zero, saturating, NaN -> 0
    "I2B",     # int64 -> bool, a != 0
    "F2B",     # float64 -> bool, a != 0.0 (NaN -> true)
    "B2F",     # bool -> float64
))}

#: the input name that stands for the batch's row keys
KEYS = None

#: value types of the machine: int64, float64, bool (0/1 in a register), uint64
_NP = {"I": np.dtype(np.int64), "F": np.dtype(np.float64), "B": np.dtype(np.bool_),
       "U": np.dtype(np.uint64)}
_KIND = {np.dtype(np.int64): "I", np.dtype(np.float64): "F", np.dtype(np.bool_): "B",
         np.dtype(np.uint64): "U"}
_I64_MIN, _I64_MAX = -(1 << 63), (1 << 63) - 1


def column_kind(dtype) -> str | None:
    """The machine's type of a numpy column dtype, or None for one it does not load."""
    return _KIND.get(np.dtype(dtype))


@dataclass(frozen=True)
class Val:
    """A value under construction: a register of type ``t`` (``reg`` set), or a Python constant
    (``py`` set, ``t`` its weak type, or ``"B"`` for a bool, which is not weak)."""

    t: str
    reg: int | None = None
    py: object = None

    @property
    def is_const(self) -> bool:
        return self.reg is None


@dataclass
class Program:
    """One program of the machine: ``code`` int32 ``[k, 5]`` rows of (op, dst, a, b, c),
    ``consts`` int64 bits, the input columns (name, machine type) it loads, the output columns
    (name, numpy dtype) it stores, and its register count."""

    code: np.ndarray
    consts: np.ndarray
    inputs: list[tuple[object, str]]
    outputs: list[tuple[str, np.dtype]]
    n_regs: int
    _layouts: dict = field(default_factory=dict, repr=False, compare=False)  # n -> layout
    _checked: bool = field(default=False, repr=False, compare=False)


def _bits(v: float | int, t: str) -> int:
    if t == "F":
        return int(np.array(float(v), np.float64).view(np.int64))
    if t == "B":
        return int(bool(v))
    return int(np.array(int(v) & ((1 << 64) - 1), np.uint64).view(np.int64))


class ProgramBuilder:
    """Emits one program. ``load`` a column, ``const`` a Python value, combine values with
    ``binop``/``unary``/``where``/``convert``, ``store`` outputs, ``finish()``.

    Values carry the type ``jax.numpy`` would give them; a binary operation on two Python
    constants is computed in Python, as the JAX package's expression kernels compute it. Dead
    instructions are dropped and registers are reused after a value's last use."""

    def __init__(self, in_kinds: dict):
        self._in_kinds = in_kinds  # input name -> machine type of its column this batch
        self._inputs: dict[object, Val] = {}
        self._consts: dict[tuple[str, int], Val] = {}
        self._const_bits: list[int] = []
        self._code: list[list[int]] = []
        self._vregs = 0
        self._outputs: list[tuple[str, np.dtype]] = []
        self._float_cmps: dict[int, tuple[int, int]] = {}  # LT_F/LE_F result -> operands

    # -- emission -------------------------------------------------------------------------

    def _emit(self, op: str, a: int = -1, b: int = -1, c: int = -1, dst: bool = True) -> int:
        d = -1
        if dst:
            d = self._vregs
            self._vregs += 1
        self._code.append([OPS[op], d, a, b, c])
        return d

    def load(self, name) -> Val:
        hit = self._inputs.get(name)
        if hit is None:
            t = self._in_kinds[name]
            idx = len(self._inputs)
            hit = Val(t, self._emit("LDB" if t == "B" else "LD8", idx))
            self._inputs[name] = hit
        return hit

    def const(self, value) -> Val:
        if isinstance(value, (bool, np.bool_)):
            return Val("B", py=bool(value))
        if isinstance(value, (int, np.integer)):
            return Val("I", py=int(value))
        if isinstance(value, (float, np.floating)):
            return Val("F", py=float(value))
        raise TypeError(f"constant {value!r} is not a number")

    def _const_index(self, bits: int) -> int:
        self._const_bits.append(bits)
        return len(self._const_bits) - 1

    def reg(self, v: Val, t: str | None = None) -> int:
        """The register holding ``v`` as type ``t`` (a constant is materialized once)."""
        t = t or v.t
        if not v.is_const:
            return self.convert(v, t).reg
        value = v.py
        if t == "I" and isinstance(value, float):
            raise TypeError("a float constant cannot be an int64 operand")
        bits = _bits(value, t)
        key = (t, bits)
        hit = self._consts.get(key)
        if hit is None:
            hit = Val(t, self._emit("CONST", self._const_index(bits)))
            self._consts[key] = hit
        return hit.reg

    # -- types --------------------------------------------------------------------------

    @staticmethod
    def _join(l: Val, r: Val) -> str:
        """``jax.numpy``'s result type of two values (x64, weak Python constants)."""
        order = {"B": 0, "I": 1, "F": 2}
        if "U" in (l.t, r.t):
            if l.t == r.t or (l.is_const and l.t == "I") or (r.is_const and r.t == "I"):
                return "U"
            raise TypeError("uint64 columns combine only with uint64 columns here")
        if l.is_const and r.is_const:
            return max(l.t, r.t, key=order.get)
        if l.is_const or r.is_const:
            weak, strong = (l, r) if l.is_const else (r, l)
            if weak.t == "B":  # a Python bool is not weak
                return max(l.t, r.t, key=order.get)
            if weak.t == "F":
                return "F"
            return "I" if strong.t == "B" else strong.t
        return max(l.t, r.t, key=order.get)

    def convert(self, v: Val, t: str) -> Val:
        """``astype`` with XLA's conversions."""
        if v.is_const:
            value = v.py
            if t == "F":
                return Val("F", py=float(value))
            if t == "B":
                return Val("B", py=bool(value))
            if t in ("I", "U"):
                if isinstance(value, float):
                    return Val(t, self._emit("F2I", self.reg(v, "F")))
                return Val(t, py=int(value))
            raise TypeError(f"no conversion to {t}")
        if v.t == t or {v.t, t} <= {"I", "U"} or (v.t == "B" and t in ("I", "U")):
            return Val(t, v.reg)  # the same bits
        name = {("I", "F"): "I2F", ("F", "I"): "F2I", ("I", "B"): "I2B", ("U", "B"): "I2B",
                ("F", "B"): "F2B", ("B", "F"): "B2F"}.get((v.t, t))
        if name is None:
            raise TypeError(f"no conversion from {v.t} to {t}")
        return Val(t, self._emit(name, v.reg))

    # -- operations -----------------------------------------------------------------------

    def binop(self, op: str, l: Val, r: Val) -> Val:
        if l.is_const and r.is_const:
            return self._fold(op, l, r)
        if op == "**":
            return self._pow(l, r)
        t = self._join(l, r)
        if op in ("+", "*") and l.t == "B" and r.t == "B":
            return Val("B", self._emit("OR" if op == "+" else "AND", self.reg(l), self.reg(r)))
        if op in ("+", "-", "*"):
            if t == "B":
                raise TypeError(f"{op!r} does not accept dtype bool")
            if t == "U":
                raise TypeError("uint64 arithmetic is not lowered")
            if t == "F" and op == "*":
                # XLA's algebraic simplifier: A * convert(pred) -> select(pred, A, 0)
                for pred, other in ((l, r), (r, l)):
                    if not pred.is_const and pred.t == "B" and other.t != "B":
                        return self.where(pred, self.convert(other, "F"), self.const(0.0))
            if t == "F" and op in ("+", "-"):
                # XLA's algebraic simplifier: A + 0 -> A, 0 + A -> A, A - 0 -> A
                for keep, zero in ((l, r), (r, l)) if op == "+" else ((l, r),):
                    if zero.is_const and float(zero.py) == 0.0:
                        return self.convert(keep, "F")
            name = {"+": "ADD", "-": "SUB", "*": "MUL"}[op] + "_" + t
            return Val(t, self._emit(name, self.reg(l, t), self.reg(r, t)))
        if op in ("==", "!=", "<", "<=", ">", ">="):
            if op in (">", ">="):
                l, r, op = r, l, {">": "<", ">=": "<="}[op]
            suffix = {"B": "I", "I": "I", "F": "F", "U": "U"}[t]
            if suffix == "U" and op in ("==", "!="):
                suffix = "I"
            name = {"==": "EQ", "!=": "NE", "<": "LT", "<=": "LE"}[op] + "_" + suffix
            lr, rr = self.reg(l, t), self.reg(r, t)
            out = Val("B", self._emit(name, lr, rr))
            if name in ("LT_F", "LE_F"):
                self._float_cmps[out.reg] = (lr, rr)
            return out
        if op in ("&", "|", "^"):
            if t not in ("B", "I"):
                raise TypeError(f"{op!r} takes ints or bools")
            name = {"&": "AND", "|": "OR", "^": "XOR"}[op]
            return Val(t, self._emit(name, self.reg(l, t), self.reg(r, t)))
        if op in ("<<", ">>"):
            if t not in ("B", "I"):
                raise TypeError(f"{op!r} takes ints or bools")
            return Val("I", self._emit("SHL" if op == "<<" else "SHR",
                                       self.reg(l, "I"), self.reg(r, "I")))
        raise TypeError(f"operator {op!r} is not lowered")

    def _fold(self, op: str, l: Val, r: Val) -> Val:
        fns = {"+": operator.add, "-": operator.sub, "*": operator.mul, "**": operator.pow,
               "==": operator.eq, "!=": operator.ne, "<": operator.lt, "<=": operator.le,
               ">": operator.gt, ">=": operator.ge, "&": operator.and_, "|": operator.or_,
               "^": operator.xor, "<<": operator.lshift, ">>": operator.rshift}
        return self.const(fns[op](l.py, r.py))

    def _pow(self, l: Val, r: Val) -> Val:
        """``jnp.power``: a Python int exponent goes through ``lax.integer_pow``; an int base
        with an int exponent through its binary exponentiation; an inexact base with an int
        exponent through ``pow`` of the exponent converted; anything else promotes first."""
        if r.is_const and r.t in ("I", "B"):
            e = int(r.py)
            if l.t in ("B", "I"):
                if e < 0:
                    raise TypeError(f"Integers cannot be raised to negative powers, got {e}")
                return Val("I", self._emit("IPOW_I", self.reg(l, "I"),
                                           self._const_index(_bits(e, "I"))))
            return Val("F", self._emit("IPOW_F", self.reg(l, "F"),
                                       self._const_index(_bits(e, "I"))))
        t = self._join(l, r)
        if t in ("B", "I"):
            return Val("I", self._emit("POW_I", self.reg(l, "I"), self.reg(r, "I")))
        if t == "U":
            raise TypeError("uint64 arithmetic is not lowered")
        return Val("F", self._emit("POW_F", self.reg(l, "F"), self.reg(r, "F")))

    def unary(self, op: str, v: Val, logical: bool = False) -> Val:
        """``-``, ``abs`` and ``~`` (logical ``not`` when ``logical``, as the JAX package picks
        by the operand's static type)."""
        if v.is_const:
            if op == "-":
                return self.const(-v.py)
            if op == "abs":
                return self.const(abs(v.py))
            return self.const((not v.py) if logical else ~v.py)
        if op == "-":
            if v.t == "B":
                raise TypeError("negative does not accept dtype bool")
            return Val(v.t, self._emit("NEG_I" if v.t in ("I", "U") else "NEG_F", v.reg))
        if op == "abs":
            if v.t in ("B", "U"):
                return v
            return Val(v.t, self._emit("ABS_I" if v.t == "I" else "ABS_F", v.reg))
        if logical:
            return Val("B", self._emit("NOT_B", self.reg(v, "B")))
        if v.t == "F":
            raise TypeError("bitwise not does not accept dtype float")
        if v.t == "B":
            return Val("B", self._emit("NOT_B", v.reg))
        return Val(v.t, self._emit("NOT_I", v.reg))

    def where(self, cond: Val, then: Val, other: Val) -> Val:
        """``jnp.where``: the condition as bool, the branches promoted together."""
        if then.is_const and other.is_const:
            t = self._join(then, other)
            then, other = Val(t, self.reg(then, t)), Val(t, self.reg(other, t))
        t = self._join(then, other)
        tr, er = self.reg(then, t), self.reg(other, t)
        out = Val(t, self._emit("SEL", self.reg(cond, "B"), tr, er))
        if t == "F" and not cond.is_const and {tr, er} == set(self._float_cmps.get(cond.reg, ())):
            # XLA turns a select between the two operands of their own comparison into a
            # minimum or maximum, which flushes a subnormal result: x + -0.0 flushes the same
            out = Val("F", self._emit("ADD_F", out.reg, self.reg(Val("F", py=-0.0))))
        return out

    def store(self, name: str, v: Val) -> None:
        """Write ``v`` as output column ``name`` (a constant in its default dtype)."""
        if v.is_const:
            v = Val(v.t, self.reg(v))
        idx = len(self._outputs)
        self._outputs.append((name, _NP[v.t]))
        self._emit("STB" if v.t == "B" else "ST8", v.reg, idx, dst=False)

    # -- finish -----------------------------------------------------------------------------

    def finish(self) -> Program:
        """Drop dead instructions, map values onto reused registers, check capacity."""
        code = self._code
        srcs = [_sources(_OP_NAMES[op], a, b, c) for op, d, a, b, c in code]
        live: set[int] = set()
        keep = [False] * len(code)
        for i in range(len(code) - 1, -1, -1):
            d = code[i][1]
            if d == -1 or d in live:
                keep[i] = True
                live.discard(d)
                live.update(srcs[i])
        last_use: dict[int, int] = {}
        kept = [i for i in range(len(code)) if keep[i]]
        for pos, i in enumerate(kept):
            for s in srcs[i]:
                last_use[s] = pos
        phys: dict[int, int] = {}
        free: list[int] = []
        n_regs = 0
        out_code = []
        used_inputs: dict[int, int] = {}
        for pos, i in enumerate(kept):
            op, d, a, b, c = code[i]
            name = _OP_NAMES[op]
            row = [op, -1, a, b, c]
            mapped = [phys[s] for s in srcs[i]]
            if name in ("LD8", "LDB"):
                row[2] = used_inputs.setdefault(a, len(used_inputs))
            elif name in ("ST8", "STB"):
                row[2] = mapped[0]
            elif name in ("IPOW_I", "IPOW_F"):
                row[2] = mapped[0]
            elif name != "CONST":
                for slot, p in zip((2, 3, 4), mapped):
                    row[slot] = p
            for s in srcs[i]:
                if last_use[s] == pos and phys[s] not in free:
                    free.append(phys[s])
            if d != -1:
                if free:
                    p = free.pop()
                else:
                    p = n_regs
                    n_regs += 1
                phys[d] = p
                row[1] = p
            out_code.append(row)
        names = list(self._inputs)
        inputs = [None] * len(used_inputs)
        for old, new in used_inputs.items():
            inputs[new] = (names[old], self._inputs[names[old]].t)
        for what, n, cap in (("instructions", len(out_code), MAX_INSNS),
                             ("registers", n_regs, MAX_REGS),
                             ("constants", len(self._const_bits), MAX_CONSTS),
                             ("input columns", len(inputs), MAX_COLS),
                             ("output columns", len(self._outputs), MAX_COLS)):
            if n > cap:
                raise ValueError(
                    f"expression program needs {n} {what}; the expression machine holds at "
                    f"most {cap} (csrc/expression_vm.cu)"
                )
        return Program(
            code=np.asarray(out_code, dtype=np.int32).reshape(-1, 5),
            consts=np.asarray(self._const_bits or [0], dtype=np.int64),
            inputs=inputs, outputs=list(self._outputs), n_regs=max(n_regs, 1),
        )


_OP_NAMES = {v: k for k, v in OPS.items()}
_UNARY = {"NEG_I", "NEG_F", "NOT_I", "NOT_B", "ABS_I", "ABS_F", "I2F", "F2I", "I2B", "F2B",
          "B2F"}


def _sources(name: str, a: int, b: int, c: int) -> tuple[int, ...]:
    """The registers an instruction reads."""
    if name in ("LD8", "LDB", "CONST"):
        return ()
    if name in ("ST8", "STB", "IPOW_I", "IPOW_F") or name in _UNARY:
        return (a,)
    if name == "SEL":
        return (a, b, c)
    return (a, b)


def _check_registers(program: Program) -> None:
    """Raise unless the program is what the kernel reads from its launch parameters (int32 code
    rows, int64 constants, both C-contiguous) and every register it reads or writes is below its
    ``n_regs``: the kernel sizes its register file by that count."""
    if (program.code.dtype != np.int32 or program.consts.dtype != np.int64
            or not program.code.flags.c_contiguous or not program.consts.flags.c_contiguous):
        raise ValueError("expression program: code must be C-contiguous int32 and constants "
                         "C-contiguous int64")
    for op, d, a, b, c in program.code.tolist():
        name = _OP_NAMES.get(op)
        if name is None:
            raise ValueError(f"expression program: unknown opcode {op}")
        used = _sources(name, a, b, c) + (() if name in ("ST8", "STB") else (d,))
        if not 1 <= program.n_regs <= MAX_REGS or any(
                not 0 <= r < program.n_regs for r in used):
            raise ValueError(f"expression program: {name} uses a register outside "
                             f"[0, {program.n_regs}) (at most {MAX_REGS})")


# -- the plain version ------------------------------------------------------------------------

def run_program_plain(program: Program, inputs: list[torch.Tensor]) -> list[torch.Tensor]:
    """The program over whole columns with PyTorch ops, one instruction at a time: ``inputs``
    in the program's input order (int64, float64, bool or uint64-as-int64 tensors of one length,
    on one device); returns its output columns (int64, float64 or bool; a uint64 output as its
    int64 bits). Registers hold int64 bits; float operations view them as float64."""
    n = inputs[0].shape[0] if inputs else 0
    dev = inputs[0].device if inputs else torch.device("cpu")
    consts = torch.from_numpy(program.consts).to(dev)
    regs: list = [None] * program.n_regs
    outs: list = [None] * len(program.outputs)
    i64 = torch.int64

    def f(x):
        return _flush(x).view(torch.float64)

    def bits(x):
        return _flush(x.view(i64))

    for op, d, a, b, c in program.code.tolist():
        name = _OP_NAMES[op]
        if name == "LD8":
            x = inputs[a]
            regs[d] = x.view(i64) if x.dtype != torch.bool else x.to(i64)
            continue
        if name == "LDB":
            regs[d] = inputs[a].to(i64)
            continue
        if name == "CONST":
            regs[d] = consts[a].expand(n)
            continue
        if name == "ST8":
            want = program.outputs[b][1]
            outs[b] = regs[a].view(torch.float64).clone() if want == np.float64 else regs[a].clone()
            continue
        if name == "STB":
            outs[b] = regs[a] != 0
            continue
        x = regs[a]
        y = regs[b] if b >= 0 and name not in ("IPOW_I", "IPOW_F") else None
        if name == "ADD_I":
            r = x + y
        elif name == "SUB_I":
            r = x - y
        elif name == "MUL_I":
            r = x * y
        elif name == "ADD_F":
            r = bits(f(x) + f(y))
        elif name == "SUB_F":
            r = bits(f(x) - f(y))
        elif name == "MUL_F":
            r = bits(f(x) * f(y))
        elif name == "DIV_F":
            r = bits(f(x) / f(y))
        elif name == "POW_I":
            r = _pow_int_plain(x, y)
        elif name == "POW_F":
            r = bits(torch.pow(f(x), f(y)))
        elif name in ("IPOW_I", "IPOW_F"):
            r = _integer_pow_plain(x, int(program.consts[b]), name == "IPOW_F")
        elif name in ("EQ_I", "EQ_F"):
            r = (x == y if name == "EQ_I" else f(x) == f(y)).to(i64)
        elif name in ("NE_I", "NE_F"):
            r = (x != y if name == "NE_I" else f(x) != f(y)).to(i64)
        elif name in ("LT_I", "LT_F", "LT_U"):
            r = (f(x) < f(y) if name == "LT_F" else _unsigned(x, name) < _unsigned(y, name)).to(i64)
        elif name in ("LE_I", "LE_F", "LE_U"):
            r = (f(x) <= f(y) if name == "LE_F" else _unsigned(x, name) <= _unsigned(y, name)).to(i64)
        elif name == "AND":
            r = x & y
        elif name == "OR":
            r = x | y
        elif name == "XOR":
            r = x ^ y
        elif name == "SHL":
            ok = (y >= 0) & (y < 64)
            r = torch.where(ok, x << y.clamp(0, 63), torch.zeros_like(x))
        elif name == "SHR":
            ok = (y >= 0) & (y < 64)
            r = torch.where(ok, x >> y.clamp(0, 63), torch.where(x < 0, -1, 0).to(i64))
        elif name == "NEG_I":
            r = -x
        elif name == "NEG_F":
            r = x ^ _I64_MIN  # flip the sign bit, as negation does
        elif name == "NOT_I":
            r = ~x
        elif name == "NOT_B":
            r = x ^ 1
        elif name == "ABS_I":
            r = torch.abs(x)
        elif name == "ABS_F":
            r = x & _I64_MAX  # clear the sign bit
        elif name == "SEL":
            r = torch.where(x != 0, regs[b], regs[c])
        elif name == "I2F":
            r = x.to(torch.float64).view(i64)
        elif name == "F2I":
            r = _f2i_plain(f(x))
        elif name == "I2B":
            r = (x != 0).to(i64)
        elif name == "F2B":
            r = (f(x) != 0.0).to(i64)
        elif name == "B2F":
            r = x.to(torch.float64).view(i64)
        else:  # pragma: no cover - every opcode is handled above
            raise AssertionError(name)
        regs[d] = r.expand(n) if r.dim() == 0 else r
    return outs


def _flush(x: torch.Tensor) -> torch.Tensor:
    """Subnormal float64 bits to a zero of their sign (XLA's CPU backend runs with FTZ/DAZ)."""
    return torch.where((x & 0x7FF0000000000000) == 0, x & _I64_MIN, x)


def _unsigned(x: torch.Tensor, name: str) -> torch.Tensor:
    """Order-preserving map of uint64 bits onto int64 for the unsigned comparisons."""
    return x ^ torch.tensor(_I64_MIN, dtype=torch.int64, device=x.device) if name.endswith("_U") else x


def _pow_int_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``jnp.power`` of two int64 columns: six steps of binary exponentiation."""
    acc = torch.where((x == 0) & (y != 0), 0, 1).to(torch.int64)
    for _ in range(6):
        acc = torch.where((y & 1) != 0, acc * x, acc)
        x = x * x
        y = torch.where(y < 0, (y >> 1) & ((1 << 63) - 1), y >> 1)  # logical shift right
    return acc


def _integer_pow_plain(x: torch.Tensor, e: int, is_float: bool) -> torch.Tensor:
    """``lax.integer_pow(x, e)``: binary exponentiation, ``1 / x^|e|`` for e < 0; in float64
    every product is flushed as the kernel flushes it."""
    if is_float:
        def mul(p, q):
            return _flush((p.view(torch.float64) * q.view(torch.float64)).view(torch.int64))
        x = _flush(x)
    else:
        def mul(p, q):
            return p * q
    if e == 0:
        return torch.ones_like(x.view(torch.float64)).view(torch.int64) if is_float else \
            torch.ones_like(x)
    recip, e = e < 0, abs(e)
    acc = None
    while e > 0:
        if e & 1:
            acc = x if acc is None else mul(acc, x)
        e >>= 1
        if e > 0:
            x = mul(x, x)
    if recip:
        acc = _flush((1.0 / acc.view(torch.float64)).view(torch.int64))
    return acc


def _f2i_plain(x: torch.Tensor) -> torch.Tensor:
    """float64 -> int64 as XLA converts: toward zero, saturating, NaN to 0."""
    inside = torch.where(torch.isnan(x), 0.0, x).clamp(-(2.0 ** 63), 2.0 ** 63 - 1024)
    r = inside.to(torch.int64)
    r = torch.where(x >= 2.0 ** 63, _I64_MAX, r)
    return r


# -- layout of a launch ----------------------------------------------------------------------

_ALIGN = 16


def layout(program: Program, n: int) -> tuple[list[int], int, list[int], int]:
    """Byte offsets of each input and output column in one packed buffer of ``n`` rows, and the
    two buffers' sizes. Each column starts on a 16-byte boundary. Kept on the program for the
    last few row counts: a launch's host cost is part of what the engine waits for."""
    hit = program._layouts.get(n)
    if hit is None:
        if len(program._layouts) >= 16:
            program._layouts.clear()
        hit = program._layouts[n] = _layout(program, n)
    return hit


def _layout(program: Program, n: int) -> tuple[list[int], int, list[int], int]:
    def offsets(itemsizes):
        offs, at = [], 0
        for size in itemsizes:
            offs.append(at)
            at += -(-(n * size) // _ALIGN) * _ALIGN
        return offs, max(at, _ALIGN)

    in_offs, in_bytes = offsets([1 if t == "B" else 8 for _, t in program.inputs])
    out_offs, out_bytes = offsets([np.dtype(d).itemsize for _, d in program.outputs])
    return in_offs, in_bytes, out_offs, out_bytes


def _typed(buf: torch.Tensor, off: int, n: int, dtype: torch.dtype) -> torch.Tensor:
    size = torch.empty((), dtype=dtype).element_size()
    return buf[off:off + n * size].view(dtype)


def expression_vm_plain(program: Program, in_buf: torch.Tensor, out_buf: torch.Tensor,
                        n: int) -> None:
    """The plain version of :func:`expression_vm` on packed byte buffers."""
    in_offs, _, out_offs, _ = layout(program, n)
    cols = [_typed(in_buf, off, n, torch.bool if t == "B" else torch.int64)
            for (_, t), off in zip(program.inputs, in_offs)]
    outs = run_program_plain(program, cols)
    for (_, dtype), off, col in zip(program.outputs, out_offs, outs):
        want = {np.dtype(np.bool_): torch.bool, np.dtype(np.float64): torch.float64}.get(
            np.dtype(dtype), torch.int64)
        _typed(out_buf, off, n, want).copy_(col.to(want) if col.dtype != want else col)


@functools.cache
def _launcher():
    fn = _kernels.load("expression_vm").expression_vm
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def expression_vm(program: Program, in_buf: torch.Tensor, out_buf: torch.Tensor, n: int) -> None:
    """Run ``program`` over ``n`` rows: the input columns packed in the uint8 buffer ``in_buf``
    and the output columns written into ``out_buf``, at the offsets of :func:`layout`.

    On CUDA buffers one launch of the kernel of ``csrc/expression_vm.cu`` on the current stream,
    the program among its parameters (checked once first: :func:`_check_registers`); on CPU
    buffers the plain version runs."""
    if in_buf.device.type == "cpu":
        expression_vm_plain(program, in_buf, out_buf, n)
        return
    if in_buf.device.type != "cuda":
        raise ValueError(f"expression_vm: no kernel for device {in_buf.device}")
    in_offs, in_bytes, out_offs, out_bytes = layout(program, n)
    if (in_buf.dtype != torch.uint8 or out_buf.dtype != torch.uint8
            or out_buf.device != in_buf.device or not in_buf.is_contiguous()
            or not out_buf.is_contiguous() or in_buf.numel() < in_bytes
            or out_buf.numel() < out_bytes):
        raise ValueError("expression_vm: the kernel takes contiguous uint8 buffers on one device "
                         f"of at least {in_bytes} and {out_bytes} bytes")
    if in_buf.data_ptr() % _ALIGN or out_buf.data_ptr() % _ALIGN:
        raise ValueError("expression_vm: buffers must start on a 16-byte boundary")
    if not program._checked:
        _check_registers(program)
        program._checked = True
    in_off = (ctypes.c_longlong * max(len(in_offs), 1))(*in_offs)
    out_off = (ctypes.c_longlong * max(len(out_offs), 1))(*out_offs)
    # the code and constants are read from host memory into the launch's parameters
    err = _launcher()(
        program.code.ctypes.data, program.code.shape[0], program.consts.ctypes.data,
        program.consts.size, program.n_regs, in_buf.data_ptr(), ctypes.addressof(in_off),
        len(in_offs), out_buf.data_ptr(), ctypes.addressof(out_off), len(out_offs), n,
        _kernels.stream(in_buf.device),
    )
    _kernels.check(err, "expression_vm")
    with _count_lock:  # worker threads launch concurrently
        expression_vm.launches += 1


expression_vm.launches = 0
_count_lock = threading.Lock()


def expression_vm_empty(program: Program, device: torch.device, n: int) -> None:
    """Launch an empty kernel on the grid :func:`expression_vm` takes for ``program`` over ``n``
    rows, on the current stream: the launch's own cost, the yardstick of the machine's floor.
    Not a launch of the machine: nothing counts it."""
    fn = _kernels.load("expression_vm").expression_vm_empty
    fn.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(n, program.n_regs + len(program.inputs), _kernels.stream(device))
    _kernels.check(err, "expression_vm_empty")


def _pack(program: Program, inputs: list[torch.Tensor], n: int, device) -> tuple:
    in_offs, in_bytes, _, out_bytes = layout(program, n)
    in_buf = torch.empty(in_bytes, dtype=torch.uint8, device=device)
    for (_, t), off, col in zip(program.inputs, in_offs, inputs):
        want = torch.bool if t == "B" else torch.int64
        src = col if col.dtype == want else (col.view(torch.int64) if col.element_size() == 8
                                             else col.to(want))
        _typed(in_buf, off, n, want).copy_(src)
    out_buf = torch.empty(out_bytes, dtype=torch.uint8, device=device)
    return in_buf, out_buf


def _unpack(program: Program, out_buf: torch.Tensor, n: int) -> list[torch.Tensor]:
    _, _, out_offs, _ = layout(program, n)
    outs = []
    for (_, dtype), off in zip(program.outputs, out_offs):
        want = {np.dtype(np.bool_): torch.bool, np.dtype(np.float64): torch.float64}.get(
            np.dtype(dtype), torch.int64)
        outs.append(_typed(out_buf, off, n, want))
    return outs


def run_program(program: Program, inputs: list[torch.Tensor]) -> list[torch.Tensor]:
    """The program over columns that lie on one device, through :func:`expression_vm`: packed
    into one buffer there, one launch on CUDA (the plain version on the CPU). Returns the output
    columns as :func:`run_program_plain` does."""
    n = inputs[0].shape[0]
    device = inputs[0].device
    in_buf, out_buf = _pack(program, inputs, n, device)
    expression_vm(program, in_buf, out_buf, n)
    return _unpack(program, out_buf, n)


# -- the engine's host columns ------------------------------------------------------------------

class _Staging:
    """One worker's pinned host buffers and device buffers, grown as needed."""

    def __init__(self, device: torch.device):
        self.device = device
        self.host_in = self.host_out = self.dev_in = self.dev_out = None
        self.uploaded: torch.cuda.Event | None = None

    def ensure(self, in_bytes: int, out_bytes: int) -> None:
        if self.host_in is None or self.host_in.numel() < in_bytes:
            if self.uploaded is not None:
                self.uploaded.synchronize()
                self.uploaded = None
            size = max(in_bytes, 2 * (0 if self.host_in is None else self.host_in.numel()))
            self.host_in = torch.empty(size, dtype=torch.uint8, pin_memory=True)
            self.dev_in = torch.empty(size, dtype=torch.uint8, device=self.device)
        if self.host_out is None or self.host_out.numel() < out_bytes:
            size = max(out_bytes, 2 * (0 if self.host_out is None else self.host_out.numel()))
            self.host_out = torch.empty(size, dtype=torch.uint8, pin_memory=True)
            self.dev_out = torch.empty(size, dtype=torch.uint8, device=self.device)


class HostLauncher:
    """Runs programs over the engine's numpy columns on one device, with one staging pair per
    worker thread: the columns are packed into a pinned buffer, uploaded in one copy, the kernel
    runs, and one copy reads the outputs back. The next pack into the same buffer waits on an
    event recorded after the upload. On the CPU the plain version runs over the columns."""

    #: programs run through any launcher, on either device (a card's launches are also
    #: counted by ``expression_vm.launches``)
    runs = 0

    def __init__(self, device: torch.device):
        self.device = device
        self._local = threading.local()

    def run(self, program: Program, cols: list[np.ndarray], n: int) -> list[np.ndarray]:
        """``cols`` in the program's input order; returns its output columns as numpy arrays."""
        with _count_lock:
            HostLauncher.runs += 1
        if self.device.type == "cpu":
            tensors = [torch.from_numpy(_as_int64_bits(c)) for c in cols]
            outs = run_program_plain(program, tensors)
            return [_to_numpy(o, dtype) for o, (_, dtype) in zip(outs, program.outputs)]
        st = getattr(self._local, "staging", None)
        if st is None:
            st = self._local.staging = _Staging(self.device)
        in_offs, in_bytes, out_offs, out_bytes = layout(program, n)
        st.ensure(in_bytes, out_bytes)
        if st.uploaded is not None:
            st.uploaded.synchronize()  # the last upload from this buffer has left it
        host = st.host_in.numpy()
        for (_, t), off, col in zip(program.inputs, in_offs, cols):
            size = 1 if t == "B" else 8
            host[off:off + n * size] = np.ascontiguousarray(col).view(np.uint8)
        stream = torch.cuda.current_stream(self.device)
        st.dev_in[:in_bytes].copy_(st.host_in[:in_bytes], non_blocking=True)
        st.uploaded = torch.cuda.Event()
        st.uploaded.record(stream)
        expression_vm(program, st.dev_in, st.dev_out, n)
        st.host_out[:out_bytes].copy_(st.dev_out[:out_bytes], non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
        done.synchronize()
        out = st.host_out.numpy()
        return [out[off:off + n * np.dtype(dtype).itemsize].view(dtype).copy()
                for (_, dtype), off in zip(program.outputs, out_offs)]


def _as_int64_bits(col: np.ndarray) -> np.ndarray:
    col = np.ascontiguousarray(col)
    return col.view(np.int64) if col.dtype.itemsize == 8 and col.dtype != np.int64 else col


def _to_numpy(t: torch.Tensor, dtype) -> np.ndarray:
    arr = t.numpy()
    dtype = np.dtype(dtype)
    return arr.view(dtype) if arr.dtype != dtype and arr.dtype.itemsize == dtype.itemsize else arr
