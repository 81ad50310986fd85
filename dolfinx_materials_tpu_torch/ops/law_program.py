"""Hardening laws as short programs that the J2 kernels interpret.

The JAX package's J2 kernel runs any traceable hardening law: it takes one
``jax.jvp`` of the callable for sigma_Y and its slope at each Newton iteration
(dolfinx_materials_tpu/ops/pallas_j2.py:71-99). A compiled CUDA kernel cannot
call a Python callable, so a law without a closed form in the kernel is
recorded once as a program: :func:`trace_law` calls it on a recording scalar
and keeps every operation as one instruction ``(op, a, b, c)`` of an SSA list
(slot 0 holds p, instruction k writes slot k + 1, ``a`` and ``b`` name earlier
slots, ``c`` is a float64 constant). The kernel (``csrc/j2_radial_return.cu``,
law id :data:`LAW_PROGRAM`) walks the list once per evaluation, carrying value
and slope as a dual pair in its working type, with the constants rounded to
it; :func:`evaluate` is its plain PyTorch twin, the same arithmetic on tensors.

What a law may use: ``+ - * /`` between values and constants, ``**`` with a
constant on either side, unary minus, ``exp``, ``log``, ``log1p``, ``expm1``,
``sqrt``, ``tanh``, ``abs`` (as torch functions or tensor methods),
``clamp``/``clamp_min``/``clamp_max``/``clip`` against constants, and
``maximum``/``minimum`` against a constant. Anything else, a Python branch on
the value, or more than :data:`MAX_INSTRUCTIONS` instructions raises
``TypeError`` naming the operation, as an untraceable law fails under
``jax.jvp`` in the reference.

Slopes where a law is not differentiable follow ``torch.func.jvp``, which the
plain return map uses on the callable: ``clamp`` passes the slope at a tie
(``x == bound``), ``maximum``/``minimum`` against a constant pass half of it,
``abs`` has slope 0 at 0 (the JAX package's ``jnp.maximum`` and ``jnp.clip``
also split a tie in half, so the two packages differ there by design).
"""

from __future__ import annotations

import operator
from dataclasses import dataclass

import numpy as np
import torch

#: the kernels' law id of a program (the closed forms are 0-3,
#: models/hardening.py)
LAW_PROGRAM = 4
#: capacity of the program struct the kernels take by value
MAX_INSTRUCTIONS = 64

#: opcodes, in the order of ``enum Op`` in csrc/j2_radial_return.cu
OPS = (
    "const", "add", "sub", "mul", "div", "add_c", "mul_c", "div_c", "rsub_c",
    "rdiv_c", "pow_c", "c_pow", "neg", "exp", "log", "log1p", "expm1", "sqrt",
    "tanh", "abs", "clamp_lo", "clamp_hi", "max_c", "min_c",
)
OP = {name: k for k, name in enumerate(OPS)}


@dataclass(frozen=True)
class LawProgram:
    """A traced hardening law: ``code`` is a tuple of ``(op, a, b, c)``
    instructions, ``out`` the slot holding sigma_Y."""

    code: tuple
    out: int

    def pack(self) -> np.ndarray:
        """The program as float64 values for the kernels' parameter block:
        ``n, out``, then ``op, a, b, c`` per instruction (the integers are
        exact in float64)."""
        flat = [float(len(self.code)), float(self.out)]
        for op, a, b, c in self.code:
            flat += [float(op), float(a), float(b), float(c)]
        return np.asarray(flat, dtype=np.float64)


class _Recorder:
    def __init__(self):
        self.code = []

    def emit(self, op, a=0, b=0, c=0.0):
        if len(self.code) == MAX_INSTRUCTIONS:
            raise TypeError(
                f"trace_law: the law needs more than {MAX_INSTRUCTIONS} instructions"
            )
        self.code.append((OP[op], int(a), int(b), float(c)))
        return _Tracer(self, len(self.code))


def _constant(x, what):
    """A constant operand as a Python float; a value that is neither a number
    nor a 0-d tensor has no place in a program."""
    if isinstance(x, (bool, int, float, np.number)):
        return float(x)
    if isinstance(x, torch.Tensor) and x.numel() == 1 and not x.requires_grad:
        return float(x)
    raise TypeError(f"trace_law: unsupported operand of {what}: {type(x).__name__}")


def _refuse(what):
    def method(self, *args, **kwargs):
        raise TypeError(
            f"trace_law: unsupported operation {what} on the hardening variable "
            "(a program has no branches)"
        )

    return method


class _Tracer:
    """The recording scalar: each operation on it appends one instruction."""

    __array_ufunc__ = None  # numpy scalars hand their operators back to us

    def __init__(self, rec, slot):
        self.rec = rec
        self.slot = slot

    def _binary(self, other, op, op_c, what):
        if isinstance(other, _Tracer):
            return self.rec.emit(op, self.slot, other.slot)
        c = _constant(other, what)
        if op_c == "sub_c":  # x - c is x + (-c), exactly
            return self.rec.emit("add_c", self.slot, 0, -c)
        return self.rec.emit(op_c, self.slot, 0, c)

    def __add__(self, o):
        return self._binary(o, "add", "add_c", "+")

    __radd__ = __add__  # c + x == x + c exactly

    def __sub__(self, o):
        return self._binary(o, "sub", "sub_c", "-")

    def __rsub__(self, o):
        return self.rec.emit("rsub_c", self.slot, 0, _constant(o, "-"))

    def __mul__(self, o):
        return self._binary(o, "mul", "mul_c", "*")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binary(o, "div", "div_c", "/")

    def __rtruediv__(self, o):
        return self.rec.emit("rdiv_c", self.slot, 0, _constant(o, "/"))

    def __pow__(self, o):
        if isinstance(o, _Tracer):
            raise TypeError("trace_law: unsupported operation ** between two variables")
        return self.rec.emit("pow_c", self.slot, 0, _constant(o, "**"))

    def __rpow__(self, o):
        return self.rec.emit("c_pow", self.slot, 0, _constant(o, "**"))

    def __neg__(self):
        return self.rec.emit("neg", self.slot)

    def __pos__(self):
        return self

    def __abs__(self):
        return self.rec.emit("abs", self.slot)

    def _clamp(self, lo=None, hi=None):
        x = self
        if lo is not None:
            x = x.rec.emit("clamp_lo", x.slot, 0, _constant(lo, "clamp"))
        if hi is not None:
            x = x.rec.emit("clamp_hi", x.slot, 0, _constant(hi, "clamp"))
        return x

    # tensor methods a law may call on its argument
    def exp(self):
        return self.rec.emit("exp", self.slot)

    def log(self):
        return self.rec.emit("log", self.slot)

    def log1p(self):
        return self.rec.emit("log1p", self.slot)

    def expm1(self):
        return self.rec.emit("expm1", self.slot)

    def sqrt(self):
        return self.rec.emit("sqrt", self.slot)

    def tanh(self):
        return self.rec.emit("tanh", self.slot)

    def abs(self):
        return self.rec.emit("abs", self.slot)

    def clamp(self, min=None, max=None):
        return self._clamp(min, max)

    clip = clamp

    def clamp_min(self, min):
        return self._clamp(min, None)

    def clamp_max(self, max):
        return self._clamp(None, max)

    __bool__ = _refuse("bool() (a branch on the value)")
    __float__ = _refuse("float()")
    __int__ = _refuse("int()")
    __index__ = _refuse("index()")
    __lt__ = _refuse("<")
    __le__ = _refuse("<=")
    __gt__ = _refuse(">")
    __ge__ = _refuse(">=")

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        name = getattr(func, "__name__", str(func))
        if name in _UNARY and len(args) == 1 and not kwargs:
            return getattr(args[0], _UNARY[name])()
        if name in _BINARY and len(args) == 2 and not kwargs:
            a, b = (x if isinstance(x, _Tracer) else _constant(x, name) for x in args)
            return _BINARY[name](a, b)
        if name in ("clamp", "clip", "clamp_min", "clamp_max"):
            x, *rest = args
            bounds = dict(zip(("min", "max") if name in ("clamp", "clip") else
                              ("min",) if name == "clamp_min" else ("max",), rest))
            bounds.update(kwargs)
            if not isinstance(x, _Tracer) or set(bounds) - {"min", "max"}:
                raise TypeError(f"trace_law: unsupported call of {name}")
            return x._clamp(bounds.get("min"), bounds.get("max"))
        if name in ("maximum", "minimum") and len(args) == 2 and not kwargs:
            x, c = args if isinstance(args[0], _Tracer) else args[::-1]
            if isinstance(c, _Tracer):
                raise TypeError(f"trace_law: unsupported operation {name} between two variables")
            op = "max_c" if name == "maximum" else "min_c"
            return x.rec.emit(op, x.slot, 0, _constant(c, name))
        raise TypeError(f"trace_law: unsupported operation {name}")


_UNARY = {n: n for n in ("exp", "log", "log1p", "expm1", "sqrt", "tanh", "abs")}
_UNARY.update(neg="__neg__", negative="__neg__", __neg__="__neg__", __abs__="abs")
_BINARY = {
    "add": operator.add, "__add__": operator.add, "__radd__": lambda a, b: b + a,
    "sub": operator.sub, "subtract": operator.sub, "__sub__": operator.sub,
    "__rsub__": lambda a, b: b - a,
    "mul": operator.mul, "multiply": operator.mul, "__mul__": operator.mul,
    "__rmul__": lambda a, b: b * a,
    "div": operator.truediv, "divide": operator.truediv, "true_divide": operator.truediv,
    "__truediv__": operator.truediv, "__rtruediv__": lambda a, b: b / a,
    "pow": operator.pow, "__pow__": operator.pow, "__rpow__": lambda a, b: b ** a,
}


def trace_law(fn) -> LawProgram:
    """Record ``fn(p)`` once as a :class:`LawProgram`; raises ``TypeError``
    naming the operation for a law that is not a program."""
    rec = _Recorder()
    out = fn(_Tracer(rec, 0))
    if isinstance(out, _Tracer):
        return LawProgram(tuple(rec.code), out.slot)
    c = _constant(out, "the law's result")  # a law that ignores p
    rec.emit("const", 0, 0, c)
    return LawProgram(tuple(rec.code), len(rec.code))


def evaluate(program: LawProgram, p):
    """``(sigma_Y(p), sigma_Y'(p))`` of a program on a tensor ``p``: forward
    dual arithmetic in the order the kernel evaluates it."""
    zero = torch.zeros_like(p)
    v, d = [p], [torch.ones_like(p)]
    for op, a, b, c in program.code:
        name = OPS[op]
        va, da, vb, db = v[a], d[a], v[b], d[b]
        if name == "const":
            r, dr = torch.full_like(p, c), zero
        elif name == "add":
            r, dr = va + vb, da + db
        elif name == "sub":
            r, dr = va - vb, da - db
        elif name == "mul":
            r, dr = va * vb, da * vb + va * db
        elif name == "div":
            r = va / vb
            dr = (da - r * db) / vb
        elif name == "add_c":
            r, dr = va + c, da
        elif name == "mul_c":
            r, dr = va * c, da * c
        elif name == "div_c":
            r, dr = va / c, da / c
        elif name == "rsub_c":
            r, dr = c - va, -da
        elif name == "rdiv_c":
            r = c / va
            dr = -(r / va) * da
        elif name == "pow_c":
            r = va**c
            dr = zero if c == 0.0 else c * va ** (c - 1.0) * da
        elif name == "c_pow":
            r = torch.pow(torch.full_like(va, c), va)
            dr = zero if c == 0.0 else r * float(np.log(c)) * da
        elif name == "neg":
            r, dr = -va, -da
        elif name == "exp":
            r = torch.exp(va)
            dr = r * da
        elif name == "log":
            r, dr = torch.log(va), da / va
        elif name == "log1p":
            r, dr = torch.log1p(va), da / (1.0 + va)
        elif name == "expm1":
            r = torch.expm1(va)
            dr = (r + 1.0) * da
        elif name == "sqrt":
            r = torch.sqrt(va)
            dr = da / (2.0 * r)
        elif name == "tanh":
            r = torch.tanh(va)
            dr = (1.0 - r * r) * da
        elif name == "abs":
            r, dr = torch.abs(va), torch.sign(va) * da
        elif name == "clamp_lo":
            r, dr = torch.clamp(va, min=c), torch.where(va >= c, da, zero)
        elif name == "clamp_hi":
            r, dr = torch.clamp(va, max=c), torch.where(va <= c, da, zero)
        else:  # max_c, min_c: half the slope at a tie
            side = va > c if name == "max_c" else va < c
            r = torch.clamp(va, min=c) if name == "max_c" else torch.clamp(va, max=c)
            dr = torch.where(side, da, torch.where(va == c, 0.5 * da, zero))
        v.append(r)
        d.append(dr)
    return v[program.out], d[program.out]
