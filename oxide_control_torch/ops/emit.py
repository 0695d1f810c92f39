"""Emitting backend of the scalar graph: symbolic values that write C.

``Emitter`` is the second backend of ``ops.scalar_graph`` (the first is
the torch ``TorchBackend``).  A :class:`Sym` is a named C value; Python
operators and the backend methods on it append one SSA statement each
(``const float t12 = t3 * 1.5e+00f;``) to the current block, so running
``scalar_graph.build_step`` on symbols writes the per-model step body of
the CUDA rollout kernel (``ops/csrc/rollout.cu``) as an ``OXC_HD`` inline
function -- ``__host__ __device__`` under nvcc, plain ``inline`` under a
host compiler, which is how the tests check the same source with g++.

Constants stay python doubles until they are printed: each is rounded to
the target type once and written as a literal of that type (``1.25f`` in
float), so no bare double literal promotes a float expression.  Every
statement rounds once, in the order the torch backend evaluates it, and
the kernel is built without FMA contraction (``ops.build``), so kernel and
plain version on the card agree bit for bit; in float (the kernel) a
division by a constant is written as the multiply by its reciprocal that
torch performs on CUDA, in double (host checks against torch on the CPU)
as the true division torch performs there.
``fori`` loops become real C ``for`` loops with explicit carry variables.

The emitter also counts the dynamic work of what it emits: every
statement is one lane-op, weighted by the trip counts of the loops around
it; square roots, logarithms, trigonometric and hyperbolic functions and
divisions are also counted apart as special-function ops.  These counts
give the kernel's compute bound.
"""

from __future__ import annotations

import math

import numpy as np

from .scalar_graph import _is_const

# C spellings of the unary math functions, per value type
_FUNCS = {
    "float": dict(sqrt="sqrtf", rsqrt="oxc_rsqrt", sin="sinf", cos="cosf",
                  log="logf", tanh="tanhf", abs="fabsf", pow="powf"),
    "double": dict(sqrt="sqrt", rsqrt="oxc_rsqrt", sin="sin", cos="cos",
                   log="log", tanh="tanh", abs="fabs", pow="pow"),
}
_SFU = frozenset({"sqrt", "rsqrt", "sin", "cos", "log", "tanh", "pow"})

PRELUDE = r"""
#ifndef OXC_HD
#ifdef __CUDACC__
#define OXC_HD __host__ __device__ __forceinline__
#else
#define OXC_HD inline
#endif
#endif
#ifndef OXC_MATH_HELPERS
#define OXC_MATH_HELPERS
#include <math.h>
/* NaN-propagating max/min: jnp.maximum / torch.maximum semantics */
OXC_HD float oxc_max(float a, float b) { return (a > b || a != a) ? a : b; }
OXC_HD float oxc_min(float a, float b) { return (a < b || a != a) ? a : b; }
OXC_HD double oxc_max(double a, double b) { return (a > b || a != a) ? a : b; }
OXC_HD double oxc_min(double a, double b) { return (a < b || a != a) ? a : b; }
OXC_HD bool oxc_isfinite(float a) { return a - a == 0.0f; }
OXC_HD bool oxc_isfinite(double a) { return a - a == 0.0; }
#ifdef __CUDA_ARCH__
OXC_HD float oxc_rsqrt(float a) { return rsqrtf(a); }
OXC_HD double oxc_rsqrt(double a) { return rsqrt(a); }
#else
OXC_HD float oxc_rsqrt(float a) { return 1.0f / sqrtf(a); }
OXC_HD double oxc_rsqrt(double a) { return 1.0 / sqrt(a); }
#endif
#endif
"""


class Sym:
    """A named C value of the emitter: float-typed (kind ``"f"``) or a
    ``bool`` mask (kind ``"b"``)."""

    __slots__ = ("em", "name", "kind")

    def __init__(self, em: "Emitter", name: str, kind: str):
        self.em = em
        self.name = name
        self.kind = kind

    def __add__(self, o):
        return self.em._bin("+", self, o)

    def __radd__(self, o):
        return self.em._bin("+", o, self)

    def __sub__(self, o):
        return self.em._bin("-", self, o)

    def __rsub__(self, o):
        return self.em._bin("-", o, self)

    def __mul__(self, o):
        return self.em._bin("*", self, o)

    def __rmul__(self, o):
        return self.em._bin("*", o, self)

    def __truediv__(self, o):
        if _is_const(o) and self.em.ctype == "float":
            # torch on CUDA divides by a python scalar as a multiply by
            # the scalar's reciprocal, taken in double and rounded once
            return self.em._bin("*", self, 1.0 / o)
        return self.em._bin("/", self, o, sfu=True)

    def __rtruediv__(self, o):
        # torch's Tensor.__rtruediv__: reciprocal(self) * o
        return self.em._bin("*", self.em._bin("/", 1.0, self, sfu=True), o)

    def __neg__(self):
        return self.em._new(f"-{self.name}", "f")

    def __lt__(self, o):
        return self.em._bin("<", self, o, kind="b")

    def __le__(self, o):
        return self.em._bin("<=", self, o, kind="b")

    def __gt__(self, o):
        return self.em._bin(">", self, o, kind="b")

    def __ge__(self, o):
        return self.em._bin(">=", self, o, kind="b")

    def __and__(self, o):
        return self.em._logic("&&", self, o)

    __rand__ = __and__

    def __or__(self, o):
        return self.em._logic("||", self, o)

    __ror__ = __or__

    def __bool__(self):
        raise TypeError("a symbolic value has no truth value at build time")


class Emitter:
    """Backend whose values are :class:`Sym`; collects the C statements of
    one function body.  ``ctype`` is ``"float"`` (the kernel) or
    ``"double"`` (host checks)."""

    def __init__(self, ctype: str = "float"):
        if ctype not in _FUNCS:
            raise ValueError(f"ctype must be float or double, not {ctype!r}")
        self.ctype = ctype
        self._f = _FUNCS[ctype]
        self._lines: list[str] = []
        self._depth = 1
        self._n = 0
        self._mult = 1
        self.ops = 0        # dynamic lane-ops per call of the function
        self.sfu_ops = 0    # of which special-function ops

    # ----- printing -----
    def lit(self, x) -> str:
        if isinstance(x, (bool, np.bool_)):
            return "true" if x else "false"
        v = np.float32(x) if self.ctype == "float" else np.float64(x)
        if np.isnan(v):
            return "(0.0f/0.0f)" if self.ctype == "float" else "(0.0/0.0)"
        if np.isinf(v):
            inf = "(1.0f/0.0f)" if self.ctype == "float" else "(1.0/0.0)"
            return inf if v > 0 else f"(-{inf})"
        s = np.format_float_scientific(v, unique=True)
        if self.ctype == "float":
            s += "f"
        return f"({s})" if s.startswith("-") else s

    def arg(self, x) -> str:
        if isinstance(x, Sym):
            return x.name
        return self.lit(x)

    def _ty(self, kind: str) -> str:
        return "bool" if kind == "b" else self.ctype

    def _line(self, text: str):
        self._lines.append("  " * self._depth + text)

    def _new(self, expr: str, kind: str, sfu: bool = False) -> Sym:
        name = f"t{self._n}"
        self._n += 1
        self._line(f"const {self._ty(kind)} {name} = {expr};")
        self.ops += self._mult
        if sfu:
            self.sfu_ops += self._mult
        return Sym(self, name, kind)

    def _bin(self, op, a, b, kind="f", sfu=False) -> Sym:
        return self._new(f"{self.arg(a)} {op} {self.arg(b)}", kind, sfu)

    def _logic(self, op, a, b):
        for x, y in ((a, b), (b, a)):
            if _is_const(x):
                if op == "&&":
                    return y if x else False
                return True if x else y
        return self._new(f"{a.name} {op} {b.name}", "b")

    def _call(self, fn: str, *xs) -> Sym:
        args = ", ".join(self.arg(x) for x in xs)
        return self._new(f"{self._f[fn]}({args})", "f", sfu=fn in _SFU)

    # ----- the backend interface (constant folding as TorchBackend) -----
    def full(self, x):
        if isinstance(x, Sym):
            return x
        kind = "b" if isinstance(x, bool) else "f"
        return self._new(self.lit(x), kind)

    def where(self, c, a, b):
        if _is_const(c):
            return a if c else b
        kind = "b" if any(isinstance(x, Sym) and x.kind == "b"
                          or isinstance(x, bool) for x in (a, b)) else "f"
        return self._new(f"{c.name} ? {self.arg(a)} : {self.arg(b)}", kind)

    def maximum(self, a, b):
        if _is_const(a) and _is_const(b):
            return max(a, b)
        return self._new(f"oxc_max({self.arg(a)}, {self.arg(b)})", "f")

    def minimum(self, a, b):
        if _is_const(a) and _is_const(b):
            return min(a, b)
        return self._new(f"oxc_min({self.arg(a)}, {self.arg(b)})", "f")

    def clip(self, x, lo, hi):
        if _is_const(x):
            return min(max(x, lo), hi)
        return self.minimum(self.maximum(x, lo), hi)

    def abs(self, x):
        return math.fabs(x) if _is_const(x) else self._call("abs", x)

    def sqrt(self, x):
        return math.sqrt(x) if _is_const(x) else self._call("sqrt", x)

    def rsqrt(self, x):
        return 1.0 / math.sqrt(x) if _is_const(x) else self._call("rsqrt", x)

    def sin(self, x):
        return math.sin(x) if _is_const(x) else self._call("sin", x)

    def cos(self, x):
        return math.cos(x) if _is_const(x) else self._call("cos", x)

    def log(self, x):
        return math.log(x) if _is_const(x) else self._call("log", x)

    def tanh(self, x):
        return math.tanh(x) if _is_const(x) else self._call("tanh", x)

    def pow(self, x, p: float):
        return x ** p if _is_const(x) else self._call("pow", x, float(p))

    def isfinite(self, x):
        if _is_const(x):
            return math.isfinite(x)
        return self._new(f"oxc_isfinite({x.name})", "b")

    def not_(self, x):
        return (not x) if _is_const(x) else self._new(f"!{x.name}", "b")

    def fori(self, n: int, carry, body):
        """A C ``for`` loop of ``n`` trips with mutable carry variables;
        returns symbols naming the carries' final values."""
        vars_ = []
        for c in carry:
            kind = ("b" if isinstance(c, bool)
                    or (isinstance(c, Sym) and c.kind == "b") else "f")
            name = f"c{self._n}"
            self._n += 1
            self._line(f"{self._ty(kind)} {name} = {self.arg(c)};")
            vars_.append(Sym(self, name, kind))
        i = f"i{self._n}"
        self._n += 1
        self._line(f"for (int {i} = 0; {i} < {int(n)}; ++{i}) {{")
        self._depth += 1
        outer = self._mult
        self._mult *= int(n)
        new = list(body(list(vars_)))
        if len(new) != len(vars_):
            raise ValueError("fori body changed the carry length")
        # two phases: a carry may be assigned another carry's old value
        staged = []
        for v, x in zip(vars_, new):
            name = f"n{self._n}"
            self._n += 1
            self._line(f"const {self._ty(v.kind)} {name} = {self.arg(x)};")
            staged.append(name)
        for v, name in zip(vars_, staged):
            self._line(f"{v.name} = {name};")
        self._mult = outer
        self._depth -= 1
        self._line("}")
        return vars_

    # ----- function assembly -----
    def load(self, array: str, n: int) -> list:
        """Symbols naming ``array[0..n-1]`` (an input the function only
        reads)."""
        return [Sym(self, f"{array}[{i}]", "f") for i in range(n)]

    def store(self, array: str, values) -> None:
        for i, x in enumerate(values):
            self._line(f"{array}[{i}] = {self.arg(x)};")

    def ret(self, x) -> None:
        self._line(f"return {self.arg(x)};")

    def function(self, signature: str) -> str:
        """The collected statements as ``OXC_HD <signature> { ... }``."""
        return "OXC_HD " + signature + " {\n" + "\n".join(self._lines) \
            + "\n}\n"
