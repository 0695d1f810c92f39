"""Scalar-graph physics step, written once against a small backend.

The port of ``oxide_control_tpu/ops/scalar_graph.py`` for the control
suite's class widened by stateful and muscle actuators, fixed and spatial
tendons (sphere and cylinder wraps), friction loss, equality constraints,
every narrowphase pair of the reference, ball joints, elliptic cones
and condim 4/6, fluid forces, mocap bodies and applied forces (see
:func:`supports`), with the in-kernel sensors the observation hooks read
(:func:`build_sensors`).  The whole ``mj_step`` of
one env is built as a graph of elementwise operations on per-env scalars; the
model's structure (tree topology, joint axes, geom pairs, constraint
rows) is compiled away at build time:

* every per-env scalar is either a **python float constant** (folded at
  build time in double precision -- structural zeros vanish, so the
  sparsity of the Jacobian and mass matrix is exploited automatically) or a
  backend value;
* every operation on backend values goes through Python operators or the
  backend object ``bk`` (``where``, ``maximum``, ``minimum``, ``clip``,
  ``abs``, ``sqrt``, ``rsqrt``, ``sin``, ``cos``, ``exp``, ``log``,
  ``tanh``, ``isfinite``, ``pow``, ``not_``, ``fori``), so one graph
  drives two backends:

  - :class:`TorchBackend`: values are ``(B,)`` tensors -- the plain
    PyTorch version, on the CPU (tests) or the GPU (comparison);
  - ``ops.emit.Emitter``: values are symbols that write SSA-style C into
    the per-model step body of the CUDA rollout kernel.

The Newton iterations, the line search's grow/bisect loops and the
inside-sidesite wrap search (built only where the model lets the sidesite
lie inside its geom) run through ``bk.fori`` with explicit carries:
Python loops on the torch backend, real C ``for`` loops in the emitted body
(same arithmetic, a small kernel source).  Loop carries are always backend
values, never folded constants, so both backends fold exactly the same
constants.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch

from ..model import (
    BiasType,
    ConeType,
    DynType,
    EqType,
    GainType,
    GeomType,
    Integrator,
    JointType,
    Model,
    ObjType,
    SensorType,
    SolverType,
    TrnType,
)
from ..physics import muscle, smooth
from ..physics.collision import max_contacts_per_pair

# ---------------------------------------------------------------------------
# backends
# ---------------------------------------------------------------------------


def _is_const(x) -> bool:
    return isinstance(x, (int, float))


# team sizes of the line search: G lanes of one warp share one env's
# dphi sums (see _linesearch_scalar)
TEAM_SIZES = (1, 2, 4, 8)


class TorchBackend:
    """Plain-version backend: every non-constant value is a ``(B,)``
    tensor of one float dtype on one device (bool tensors for masks)."""

    def __init__(self, batch: int, dtype: torch.dtype,
                 device: torch.device | str):
        self.batch = batch
        self.dtype = dtype
        self.device = torch.device(device)

    def full(self, x):
        """Materialize a python constant as a ``(B,)`` value."""
        if isinstance(x, torch.Tensor):
            return x
        if isinstance(x, bool):
            return torch.full((self.batch,), x, dtype=torch.bool,
                              device=self.device)
        return torch.full((self.batch,), float(x), dtype=self.dtype,
                          device=self.device)

    def where(self, c, a, b):
        if _is_const(c):
            return a if c else b
        if _is_const(a) and _is_const(b):
            return torch.where(c, self.full(a), self.full(b))
        if _is_const(a):
            a = self.full(a)
        if _is_const(b):
            b = self.full(b)
        return torch.where(c, a, b)

    def maximum(self, a, b):
        if _is_const(a) and _is_const(b):
            return max(a, b)
        if _is_const(a):
            return torch.clamp_min(b, a)
        if _is_const(b):
            return torch.clamp_min(a, b)
        return torch.maximum(a, b)

    def minimum(self, a, b):
        if _is_const(a) and _is_const(b):
            return min(a, b)
        if _is_const(a):
            return torch.clamp_max(b, a)
        if _is_const(b):
            return torch.clamp_max(a, b)
        return torch.minimum(a, b)

    def clip(self, x, lo, hi):
        """jnp.clip with constant bounds: minimum(maximum(x, lo), hi)."""
        if _is_const(x):
            return min(max(x, lo), hi)
        return torch.clamp(x, lo, hi)

    def abs(self, x):
        return math.fabs(x) if _is_const(x) else torch.abs(x)

    def sqrt(self, x):
        return math.sqrt(x) if _is_const(x) else torch.sqrt(x)

    def rsqrt(self, x):
        return 1.0 / math.sqrt(x) if _is_const(x) else torch.rsqrt(x)

    def sin(self, x):
        return math.sin(x) if _is_const(x) else torch.sin(x)

    def cos(self, x):
        return math.cos(x) if _is_const(x) else torch.cos(x)

    def exp(self, x):
        return math.exp(x) if _is_const(x) else torch.exp(x)

    def log(self, x):
        return math.log(x) if _is_const(x) else torch.log(x)

    def tanh(self, x):
        return math.tanh(x) if _is_const(x) else torch.tanh(x)

    def pow(self, x, p: float):
        return x ** p if _is_const(x) else torch.pow(x, p)

    def isfinite(self, x):
        return math.isfinite(x) if _is_const(x) else torch.isfinite(x)

    def not_(self, x):
        return (not x) if _is_const(x) else torch.logical_not(x)

    def sign(self, x):
        """torch.sign: -1, 0 or 1; sign(-0) = +0 and sign(NaN) = 0
        (jnp.sign keeps the NaN: the two differ only on a NaN input)."""
        if _is_const(x):
            return float((x > 0) - (x < 0))
        return torch.sign(x)

    def eq(self, a, b):
        return a == b

    def fori(self, n: int, carry, body):
        """``carry = body(carry)`` n times; the carry is materialized so
        nothing inside the loop folds against a loop-carried constant."""
        carry = [self.full(c) for c in carry]
        for _ in range(n):
            carry = [self.full(c) for c in body(list(carry))]
        return carry

    def team_lanes(self, columns):
        """Each column's G values, one per lane of the team, as one
        ``(G, B)`` value: every lane's slot at once."""
        return [torch.stack([self.full(x) for x in col]) for col in columns]

    def team_sum(self, part):
        """The sum of a ``(G, B)`` value over its lanes as the kernel's
        butterfly forms it: pairwise, ((p0+p1)+(p2+p3))+..., which IEEE
        addition's commutativity makes every lane's result."""
        while part.shape[0] > 1:
            part = part[0::2] + part[1::2]
        return part[0]


# ---------------------------------------------------------------------------
# forward-mode tangents (the port of the reference's jax.jvp)
# ---------------------------------------------------------------------------


class Dual:
    """A value of the tangent pass: the primal ``v``, computed when the
    Dual is made by the very op the plain path applies (so it is bit for
    bit the plain path's value), and its tangent ``t``, computed on demand
    by :func:`tangents` from ``rule`` and the tangents of ``args``.  Only
    the tangents that an output needs are ever built."""

    __slots__ = ("v", "t", "rule", "args", "n")
    _serial = itertools.count()

    def __init__(self, v, rule=None, args=(), t=None):
        self.v, self.t, self.rule, self.args = v, t, rule, args
        self.n = next(Dual._serial)  # creation order: a topological order

    def __add__(self, o):
        return Dual(self.v + _dv(o), add, (self, o))

    def __radd__(self, o):
        return Dual(o + self.v, add, (o, self))

    def __sub__(self, o):
        return Dual(self.v - _dv(o), sub, (self, o))

    def __rsub__(self, o):
        return Dual(o - self.v, sub, (o, self))

    def __mul__(self, o):
        a, b = self.v, _dv(o)
        return Dual(a * b, lambda ta, tb: add(mul(ta, b), mul(a, tb)),
                    (self, o))

    def __rmul__(self, o):
        a, b = o, self.v
        return Dual(a * b, lambda ta, tb: add(mul(ta, b), mul(a, tb)),
                    (o, self))

    def __truediv__(self, o):
        return _dual_div(self, o, self.v / _dv(o))

    def __rtruediv__(self, o):
        return _dual_div(o, self, o / self.v)

    def __neg__(self):
        return Dual(-self.v, neg, (self,))

    def __lt__(self, o):
        return self.v < _dv(o)

    def __le__(self, o):
        return self.v <= _dv(o)

    def __gt__(self, o):
        return self.v > _dv(o)

    def __ge__(self, o):
        return self.v >= _dv(o)

    def __bool__(self):
        raise TypeError("a traced value has no truth value at build time")


def _dv(x):
    return x.v if isinstance(x, Dual) else x


def _div(a, b):
    """a / b, folding a numerator that is identically 0."""
    if _is_const(a) and a == 0.0:
        return 0.0
    return a / b


def _dual_div(a, b, q):
    # d(a / b) = da / b - q db / b
    bv = _dv(b)
    return Dual(q, lambda ta, tb: sub(_div(ta, bv), mul(q, _div(tb, bv))),
                (a, b))


def _primal(x):
    """``x`` with every Dual replaced by its primal, through tuples, lists
    and dicts."""
    if isinstance(x, Dual):
        return x.v
    if isinstance(x, tuple):
        return tuple(_primal(y) for y in x)
    if isinstance(x, list):
        return [_primal(y) for y in x]
    if isinstance(x, dict):
        return {k: _primal(y) for k, y in x.items()}
    return x


def tangents(outs):
    """The tangents of ``outs`` (Duals, or plain values whose tangent is
    0): every Dual they depend on gets its tangent once, in creation
    order."""
    todo, stack = {}, [o for o in outs if isinstance(o, Dual)]
    while stack:
        d = stack.pop()
        if d.t is not None or d.n in todo:
            continue
        todo[d.n] = d
        stack.extend(a for a in d.args if isinstance(a, Dual))
    for n in sorted(todo):
        d = todo[n]
        d.t = d.rule(*(a.t if isinstance(a, Dual) else 0.0 for a in d.args))
    return [o.t if isinstance(o, Dual) else 0.0 for o in outs]


class DualBackend:
    """The backend of the tangent pass, over the step's backend ``bk``.

    Each op computes its primal with ``bk``'s own op and records the
    derivative rule of JAX's ``jvp`` (named per op), so one tangent layer
    serves the torch backend and the emitter alike.  Values are Duals, or
    ``bk``'s values and constants, whose tangent is 0."""

    def __init__(self, bk):
        self.bk = bk
        self._memo = {}  # (op, id(primal)) -> (primal, result)

    def _unary(self, name, x):
        key = (name, id(x))
        if key not in self._memo:
            self._memo[key] = (x, getattr(self.bk, name)(x))
        return self._memo[key][1]

    @staticmethod
    def _wrap(v, rule, args):
        if not any(isinstance(a, Dual) for a in args):
            return v
        return Dual(v, rule, args)

    def full(self, x):
        return x if isinstance(x, Dual) else self.bk.full(x)

    def where(self, c, a, b):
        # select: the selected operand's tangent
        if _is_const(c):
            return a if c else b
        bk = self.bk

        def rule(ta, tb):
            if _is_const(ta) and _is_const(tb) and ta == tb:
                return ta
            return bk.where(c, ta, tb)

        return self._wrap(bk.where(c, _dv(a), _dv(b)), rule, (a, b))

    def _minmax(self, a, b, v, picks):
        """max/min: the tangent weights of JAX's _balanced_eq, 1 for the
        operand the op picks, 0 for the other, 0.5 each at a tie;
        ``picks(x, y)`` is whether the op may pick x over y."""
        av, bv, bk = _dv(a), _dv(b), self.bk

        def rule(ta, tb):
            a_in, b_in = picks(av, bv), picks(bv, av)
            out = 0.0
            if not (_is_const(ta) and ta == 0.0):
                out = mul(ta, bk.where(a_in, bk.where(b_in, 0.5, 1.0), 0.0))
            if not (_is_const(tb) and tb == 0.0):
                out = add(out, mul(tb, bk.where(
                    b_in, bk.where(a_in, 0.5, 1.0), 0.0)))
            return out

        return self._wrap(v, rule, (a, b))

    def maximum(self, a, b):
        return self._minmax(a, b, self.bk.maximum(_dv(a), _dv(b)),
                            lambda x, y: x >= y)

    def minimum(self, a, b):
        return self._minmax(a, b, self.bk.minimum(_dv(a), _dv(b)),
                            lambda x, y: x <= y)

    def clip(self, x, lo, hi):
        # jnp.clip is minimum(maximum(x, lo), hi): its tangent composes
        # the two rules (the primal equals bk.clip's)
        if not isinstance(x, Dual):
            return self.bk.clip(x, lo, hi)
        return self.minimum(self.maximum(x, lo), hi)

    def abs(self, x):
        # select(x >= 0, t, -t)
        xv, bk = _dv(x), self.bk
        return self._wrap(bk.abs(xv),
                          lambda t: bk.where(xv >= 0.0, t, neg(t)), (x,))

    def sqrt(self, x):
        # t * (0.5 / ans)
        v = self.bk.sqrt(_dv(x))
        return self._wrap(v, lambda t: mul(t, 0.5 / v), (x,))

    def rsqrt(self, x):
        # t * (-0.5 * (ans / x))
        xv = _dv(x)
        v = self.bk.rsqrt(xv)
        return self._wrap(v, lambda t: mul(t, mul(-0.5, v / xv)), (x,))

    def sin(self, x):
        # t * cos(x)
        xv = _dv(x)
        return self._wrap(self._unary("sin", xv),
                          lambda t: mul(t, self._unary("cos", xv)), (x,))

    def cos(self, x):
        # t * -sin(x)
        xv = _dv(x)
        return self._wrap(self._unary("cos", xv),
                          lambda t: mul(t, neg(self._unary("sin", xv))),
                          (x,))

    def sign(self, x):
        return self.bk.sign(_dv(x))  # piecewise constant: tangent 0

    def eq(self, a, b):
        return self.bk.eq(_dv(a), _dv(b))

    def isfinite(self, x):
        return self.bk.isfinite(_dv(x))

    def not_(self, x):
        return self.bk.not_(x)


# ---------------------------------------------------------------------------
# constant-aware scalar ops (fold python floats at build time)
# ---------------------------------------------------------------------------


def add(a, b):
    if _is_const(a) and _is_const(b):
        return a + b
    if _is_const(a) and a == 0.0:
        return b
    if _is_const(b) and b == 0.0:
        return a
    return a + b


def sub(a, b):
    if _is_const(a) and _is_const(b):
        return a - b
    if _is_const(b) and b == 0.0:
        return a
    if _is_const(a) and a == 0.0:
        return neg(b)
    return a - b


def neg(a):
    return -a


def mul(a, b):
    if _is_const(a) and _is_const(b):
        return a * b
    if _is_const(a):
        if a == 0.0:
            return 0.0
        if a == 1.0:
            return b
    if _is_const(b):
        if b == 0.0:
            return 0.0
        if b == 1.0:
            return a
    return a * b


def fma(acc, a, b):
    return add(acc, mul(a, b))


def sum_scalars(xs):
    out = 0.0
    for x in xs:
        out = add(out, x)
    return out


def dot3(a, b):
    return add(add(mul(a[0], b[0]), mul(a[1], b[1])), mul(a[2], b[2]))


def cross3(a, b):
    return (
        sub(mul(a[1], b[2]), mul(a[2], b[1])),
        sub(mul(a[2], b[0]), mul(a[0], b[2])),
        sub(mul(a[0], b[1]), mul(a[1], b[0])),
    )


def vadd3(a, b):
    return tuple(add(x, y) for x, y in zip(a, b))


def vsub3(a, b):
    return tuple(sub(x, y) for x, y in zip(a, b))


def vscale3(a, s):
    return tuple(mul(x, s) for x in a)


def qmul(u, v):
    w1, x1, y1, z1 = u
    w2, x2, y2, z2 = v
    return (
        sub(sub(sub(mul(w1, w2), mul(x1, x2)), mul(y1, y2)), mul(z1, z2)),
        sub(add(add(mul(w1, x2), mul(x1, w2)), mul(y1, z2)), mul(z1, y2)),
        add(sub(mul(w1, y2), mul(x1, z2)), add(mul(y1, w2), mul(z1, x2))),
        add(sub(add(mul(w1, z2), mul(x1, y2)), mul(y1, x2)), mul(z1, w2)),
    )


def qrot(q, v):
    """Rotate vec3 by quat: v + 2 w (qv x v) + 2 qv x (qv x v)."""
    qv = (q[1], q[2], q[3])
    t = vscale3(cross3(qv, v), 2.0)
    return vadd3(v, vadd3(vscale3(t, q[0]), cross3(qv, t)))


def quat_to_mat(q):
    w, x, y, z = q
    return (
        sub(1.0, mul(2.0, add(mul(y, y), mul(z, z)))),
        mul(2.0, sub(mul(x, y), mul(w, z))),
        mul(2.0, add(mul(x, z), mul(w, y))),
        mul(2.0, add(mul(x, y), mul(w, z))),
        sub(1.0, mul(2.0, add(mul(x, x), mul(z, z)))),
        mul(2.0, sub(mul(y, z), mul(w, x))),
        mul(2.0, sub(mul(x, z), mul(w, y))),
        mul(2.0, add(mul(y, z), mul(w, x))),
        sub(1.0, mul(2.0, add(mul(x, x), mul(y, y)))),
    )


def mat_col(m, i):
    return (m[i], m[3 + i], m[6 + i])


def mat_vec(m, v):
    return (
        dot3((m[0], m[1], m[2]), v),
        dot3((m[3], m[4], m[5]), v),
        dot3((m[6], m[7], m[8]), v),
    )


def mat_vec_t(m, v):
    """m^T v (world -> local)."""
    return (
        dot3((m[0], m[3], m[6]), v),
        dot3((m[1], m[4], m[7]), v),
        dot3((m[2], m[5], m[8]), v),
    )


def _mat_mul_const(a, b):
    """3x3 (row-major tuple) product a @ b with constant folding."""
    out = []
    for i in range(3):
        for j in range(3):
            s = 0.0
            for k in range(3):
                s = fma(s, a[3 * i + k], b[3 * k + j])
            out.append(s)
    return tuple(out)


def axis_angle_quat(bk, axis_const, angle):
    """Constant unit axis + traced angle -> quat components."""
    half = angle * 0.5
    c = bk.cos(half)
    s = bk.sin(half)
    return (c, mul(float(axis_const[0]), s), mul(float(axis_const[1]), s),
            mul(float(axis_const[2]), s))


def qnormalize(bk, q):
    """Unit-normalize a quat (mju_normalize4 analog, zero-guarded)."""
    n2 = add(add(mul(q[0], q[0]), mul(q[1], q[1])),
             add(mul(q[2], q[2]), mul(q[3], q[3])))
    if _is_const(n2):
        if n2 <= 0.0:
            return (1.0, 0.0, 0.0, 0.0)
        inv = 1.0 / math.sqrt(n2)
        return tuple(mul(x, inv) for x in q)
    inv = bk.rsqrt(bk.maximum(n2, 1e-30))
    return tuple(mul(x, inv) for x in q)


def quat_integrate_scalar(bk, q, w, dt):
    """mju_quatIntegrate in scalar form: q * exp(0.5 * w_local * dt)."""
    n2 = dot3(w, w)
    angle = bk.sqrt(n2)
    safe = bk.where(angle > 0, angle, 1.0)
    axis = tuple(wi / safe for wi in w)
    half = 0.5 * (angle * dt)
    c = bk.cos(half)
    s = bk.sin(half)
    nz = angle > 0
    dq = (
        bk.where(nz, c, 1.0),
        bk.where(nz, axis[0] * s, 0.0),
        bk.where(nz, axis[1] * s, 0.0),
        bk.where(nz, axis[2] * s, 0.0),
    )
    return qnormalize(bk, qmul(q, dq))


def atan2_sg(bk, y, x):
    """atan2 from arithmetic + sin/cos only: polynomial estimate polished
    with two Newton steps on f(th) = y cos(th) - x sin(th)."""
    ax = bk.abs(x)
    ay = bk.abs(y)
    hi = bk.maximum(ax, ay)
    lo = bk.minimum(ax, ay)
    t = lo / bk.maximum(hi, 1e-30)
    s = t * t
    p = t * (0.9998660 + s * (-0.3302995 + s * (0.1801410 + s * (
        -0.0851330 + s * 0.0208351))))
    r = bk.where(ay > ax, 0.5 * math.pi - p, p)
    r = bk.where(x < 0, math.pi - r, r)
    th = bk.where(y < 0, -r, r)
    inv = 1.0 / bk.maximum(bk.sqrt(x * x + y * y), 1e-30)
    for _ in range(2):
        th = th + (y * bk.cos(th) - x * bk.sin(th)) * inv
    return th


def quat_sub_scalar(bk, qa, qb):
    """mju_subQuat in scalar form: 3D v with qb * exp(v/2) = qa."""
    qdif = qmul((qb[0], neg(qb[1]), neg(qb[2]), neg(qb[3])), qa)
    sgn = bk.where(qdif[0] < 0, -1.0, 1.0)
    qdif = tuple(mul(x, sgn) if not _is_const(x) else x * sgn for x in qdif)
    sin_a_2 = bk.sqrt(
        bk.maximum(
            add(
                add(mul(qdif[1], qdif[1]), mul(qdif[2], qdif[2])),
                mul(qdif[3], qdif[3]),
            ),
            0.0,
        )
    )
    angle = 2.0 * atan2_sg(bk, sin_a_2, qdif[0])
    safe = bk.where(sin_a_2 > 0, sin_a_2, 1.0)
    return tuple(
        bk.where(sin_a_2 > 0, qdif[1 + k] / safe * angle, 0.0)
        for k in range(3)
    )


def motion_cross(v, c):
    """Spatial motion cross product on ((ang3), (lin3)) pairs."""
    va, vl = v
    ca, cl = c
    return (cross3(va, ca), vadd3(cross3(va, cl), cross3(vl, ca)))


# ---------------------------------------------------------------------------
# support predicate
# ---------------------------------------------------------------------------

# contact-pair types with a scalar narrowphase (see _np_contacts_sg): the
# reference's list
_SUPPORTED_PAIRS = (
    (GeomType.PLANE, GeomType.SPHERE),
    (GeomType.PLANE, GeomType.CAPSULE),
    (GeomType.PLANE, GeomType.BOX),
    (GeomType.PLANE, GeomType.ELLIPSOID),
    (GeomType.PLANE, GeomType.CYLINDER),
    (GeomType.SPHERE, GeomType.SPHERE),
    (GeomType.SPHERE, GeomType.CAPSULE),
    (GeomType.SPHERE, GeomType.BOX),
    (GeomType.CAPSULE, GeomType.CAPSULE),
    (GeomType.CAPSULE, GeomType.BOX),
    (GeomType.BOX, GeomType.BOX),
)


def unsupported_reason(model: Model) -> str | None:
    """Why the port's scalar graph cannot run ``model`` (None if it can).

    This is the exact class spec of the port, narrower than the
    reference's ``supports``; each reason names the ROADMAP row that
    widens it:

    * joints: hinge and slide (limits included), ball (limits and
      rotational springs included), and free joints alone on their body;
      a reset may leave a ball or free joint's quaternion off the unit
      sphere (the step reads it normalized)
    * integrator: Euler (implicit joint damping included) or RK4
    * solver: Newton with pyramidal or elliptic cones at condim 1, 3, 4
      or 6 (torsional and rolling friction)
    * contacts: plane-sphere/capsule/box/ellipsoid/cylinder,
      sphere-sphere, sphere-capsule, sphere-box, capsule-capsule,
      capsule-box and box-box (SAT and face clip)
    * actuators: every dynamics (none, integrator, filter, filterexact,
      muscle), gain and bias (fixed, affine, muscle), with a joint
      (hinge, slide, ball, free), tendon or site (no refsite)
      transmission
    * tendons: fixed, and spatial (site paths, pulleys, sphere and
      cylinder wraps with or without a sidesite): springs, dampers,
      limits, friction loss and transmission; dof friction loss
    * equality: connect, weld, joint and tendon, active or not at build
      time (every row is gated by its runtime eq_active lane)
    * fluid forces (the inertia-box model: density, viscosity, wind)
    * mocap bodies, posed by runtime lanes, and applied forces
      (Data.qfrc_applied and xfrc_applied) as runtime lanes

    The reference's ``supports`` also admits a site transmission with a
    refsite, which its kernel step computes as if there were none; the
    port refuses it (ROADMAP, known faults in the reference).
    """
    for j in range(model.njnt):
        jt = JointType(model.jnt_type[j])
        if jt == JointType.FREE and (
                model.jnt_limited[j]
                or model.body_jntnum[model.jnt_bodyid[j]] != 1):
            # MuJoCo's compiler clears `limited` on free joints and rejects
            # a free joint sharing its body, so MJCF never gets here
            return "a free joint must be unlimited and alone on its body"
    if model.opt.integrator not in (Integrator.EULER, Integrator.RK4):
        return ("integrator %s: only Euler and RK4 run in the kernel; the "
                "implicit integrators stay on the general path (ROADMAP "
                "Queue A item 11)" % Integrator(model.opt.integrator).name)
    if model.opt.solver != SolverType.NEWTON:
        return "solver is not Newton: CG/PGS stay on the general path " \
               "(ROADMAP Queue A item 11)"
    for (t1, t2, _) in model.pair_groups:
        if (GeomType(t1), GeomType(t2)) not in _SUPPORTED_PAIRS:
            return (f"contact pair {GeomType(t1).name}-{GeomType(t2).name}: "
                    "pairs without a closed-form narrowphase stay on the "
                    "general path (ROADMAP Queue A item 11)")
    for c in model.pair_condim:
        if c not in (1, 3, 4, 6):
            return (f"condim {c}: only condim 1, 3, 4 and 6 are in the "
                    "kernel class; it stays on the general path (ROADMAP "
                    "Queue A item 11)")
    refid = tuple(model.actuator_refid) or (-1,) * model.nu
    for u in range(model.nu):
        trn = TrnType(model.actuator_trntype[u])
        if trn not in (TrnType.JOINT, TrnType.TENDON, TrnType.SITE):
            return (f"actuator {u}: {trn.name} transmission is outside the "
                    "kernel class; it stays on the general path (ROADMAP "
                    "Queue A item 11)")
        if trn == TrnType.SITE and refid[u] >= 0:
            return (f"actuator {u}: a site transmission with a refsite is "
                    "outside the kernel class; it stays on the general path "
                    "(ROADMAP Queue A item 11)")
    for t in range(model.ntendon):
        if _tendon_kinds(model)[t] != 1:
            continue
        for entry in smooth._tendon_path(model, t):
            if entry[0] != 0 and GeomType(model.geom_type[entry[1]]) not in (
                    GeomType.SPHERE, GeomType.CYLINDER):
                return (f"tendon {t} wraps a "
                        f"{GeomType(model.geom_type[entry[1]]).name} geom: "
                        "only sphere and cylinder wraps are in the kernel "
                        "class; others stay on the general path (ROADMAP "
                        "Queue A item 11)")
    return None


def supports(model: Model) -> bool:
    """True if the port's scalar graph runs this model
    (see :func:`unsupported_reason` for the class)."""
    return unsupported_reason(model) is None


# ---------------------------------------------------------------------------
# step builder
# ---------------------------------------------------------------------------


def _np(model_arr):
    # nested python-float lists: constants fold in double precision and
    # enter a backend op as weakly typed scalars
    return np.asarray(model_arr, dtype=np.float64).tolist()


class _ModelConsts:
    """The model parameters the step reads, as (nested lists of) floats."""

    def __init__(self, model: Model):
        self.m = model
        for name in (
            "qpos0", "qpos_spring", "body_pos", "body_quat", "body_ipos",
            "body_iquat", "body_mass", "body_inertia", "jnt_pos", "jnt_axis",
            "jnt_range", "jnt_stiffness", "jnt_margin", "jnt_solref",
            "jnt_solimp", "dof_armature", "dof_damping", "dof_invweight0",
            "body_invweight0", "geom_pos", "geom_quat", "geom_size",
            "actuator_gear", "actuator_ctrlrange", "actuator_forcerange",
            "actuator_gainprm", "actuator_biasprm", "actuator_dynprm",
            "actuator_actrange", "actuator_lengthrange", "actuator_acc0",
            "pair_friction", "pair_solref", "pair_solimp", "pair_margin",
            "pair_gap", "site_pos", "site_quat", "dof_frictionloss",
            "dof_solref", "dof_solimp", "tendon_range", "tendon_stiffness",
            "tendon_damping", "tendon_frictionloss", "tendon_lengthspring",
            "tendon_margin", "tendon_solref_lim", "tendon_solimp_lim",
            "tendon_solref_fri", "tendon_solimp_fri", "tendon_invweight0",
            "tendon_wrap_coef", "eq_data", "eq_solref", "eq_solimp",
        ):
            setattr(self, name, _np(getattr(model, name)))
        self.tendon_length0 = (None if model.tendon_length0 is None
                               else _np(model.tendon_length0))


# ---------------------------------------------------------------------------
# tendons: fixed couplings and spatial paths with sphere/cylinder wraps
# ---------------------------------------------------------------------------


def _tendon_kinds(model):
    return list(model.tendon_kind) or [0] * model.ntendon


def _point_jac_sg(model, cdof, subtree_com, bd_mask, point, body):
    """Sparse dict dof -> vec3: translational Jacobian of world `point`
    rigidly attached to `body` (mj_jac jacp in scalar form)."""
    out = {}
    origin = subtree_com[model.body_rootid[body]]
    arm = vsub3(point, origin)
    for dof in range(model.nv):
        if not bd_mask[body, dof]:
            continue
        ang, lin = cdof[dof]
        out[dof] = vadd3(lin, cross3(ang, arm))
    return out


def _wrap_circle2d_sg(bk, d0, d1, sd, radius, sd_inside):
    """Scalar twin of smooth.wrap_circle2d: circle of ``radius`` at the
    origin, endpoints d0/d1 (2-tuples of lane scalars), side reference sd
    (2-tuple) or None.  Constants are materialized (``bk.full``) so the
    branch-free where/compare logic stays per-lane.  ``sd_inside`` is
    whether sd lies inside the circle: a lane value, or a Python bool where
    the model fixes it (then only the regime it selects is built, with the
    values the per-lane selection would give).  Returns (active, t0, t1,
    arc)."""
    tiny = 1e-14
    mat = bk.full
    not_ = bk.not_
    d0 = (mat(d0[0]), mat(d0[1]))
    d1 = (mat(d1[0]), mat(d1[1]))

    def dot2(a, b):
        return a[0] * b[0] + a[1] * b[1]

    sq0 = dot2(d0, d0)
    sq1 = dot2(d1, d1)
    r2 = radius * radius
    seg = (d1[0] - d0[0], d1[1] - d0[1])
    ss = bk.maximum(dot2(seg, seg), tiny)
    tpar = bk.clip(-dot2(d0, seg) / ss, 0.0, 1.0)
    pnt = (d0[0] + tpar * seg[0], d0[1] + tpar * seg[1])
    dist2 = dot2(pnt, pnt)
    crosses = dist2 < r2
    ends_out = (sq0 > r2) & (sq1 > r2)

    ccw_nat = (d0[0] * d1[1] - d0[1] * d1[0]) > 0
    sd_in = None
    if sd is None:
        active = crosses & ends_out
        use_ccw = ccw_nat
    else:
        sd = (mat(sd[0]), mat(sd[1]))
        sd_in = (dot2(sd, sd) < r2) if sd_inside is None else sd_inside
        if sd_in is True:
            active = not_(crosses) & ends_out
        elif sd_in is False:
            flip = dot2(pnt, sd) < 0
            active = (crosses | flip) & ends_out
            use_ccw = (ccw_nat & not_(flip)) | (not_(ccw_nat) & flip)
        else:
            flip = dot2(pnt, sd) < 0
            active = ((sd_in & not_(crosses))
                      | (not_(sd_in) & (crosses | flip))) & ends_out
            flip_o = flip & not_(sd_in)
            use_ccw = (ccw_nat & not_(flip_o)) | (not_(ccw_nat) & flip_o)

    def tangents(dv, sq):
        sq = bk.maximum(sq, r2 + tiny)
        root = bk.sqrt(bk.maximum(sq - r2, 0.0))
        base = ((r2 / sq) * dv[0], (r2 / sq) * dv[1])
        s = radius * root / sq
        off = (s * (-dv[1]), s * dv[0])
        return ((base[0] + off[0], base[1] + off[1]),
                (base[0] - off[0], base[1] - off[1]))

    if sd_in is not True:
        t0p, t0m = tangents(d0, sq0)
        t1p, t1m = tangents(d1, sq1)
        t0 = tuple(bk.where(use_ccw, t0p[i], t0m[i]) for i in range(2))
        t1 = tuple(bk.where(use_ccw, t1m[i], t1p[i]) for i in range(2))
        cosang = bk.clip(dot2(t0, t1) / r2, -1.0, 1.0)
        # arccos through atan2_sg (built from arithmetic, sqrt, sin and cos)
        arc = radius * atan2_sg(
            bk, bk.sqrt(bk.maximum(1.0 - cosang * cosang, 0.0)), cosang)

    if sd is not None and sd_in is not False:
        # inside-sidesite regime (smooth.wrap_circle2d's wrap_inside):
        # single touch point minimizing |d0-T| + |T-d1| -- a 32-angle
        # tournament and 60 golden-section steps, per lane, as loops
        def f_of(th):
            tx, ty = radius * bk.cos(th), radius * bk.sin(th)
            a0, a1 = tx - d0[0], ty - d0[1]
            b0, b1 = tx - d1[0], ty - d1[1]
            return bk.sqrt(a0 * a0 + a1 * a1) + bk.sqrt(b0 * b0 + b1 * b1)

        step = 2.0 * math.pi / 32.0

        def scan(c):
            best_f, best_th, kf = c
            thk = kf * step
            fk_ = f_of(thk)
            take = fk_ < best_f
            return [bk.where(take, fk_, best_f), bk.where(take, thk, best_th),
                    kf + 1.0]

        best_f, best_th, _ = bk.fori(31, [f_of(mat(0.0)), 0.0, 1.0], scan)
        lo = best_th - step
        hi = best_th + step
        gr = 0.6180339887498949
        a_, b_ = lo, hi
        c_ = b_ - gr * (b_ - a_)
        e_ = a_ + gr * (b_ - a_)

        def golden(c):
            a_, b_, c_, e_, fc, fe = c
            take_c = fc < fe
            b_ = bk.where(take_c, e_, b_)
            a_ = bk.where(take_c, a_, c_)
            c_, e_ = b_ - gr * (b_ - a_), a_ + gr * (b_ - a_)
            return [a_, b_, c_, e_, f_of(c_), f_of(e_)]

        a_, b_, _, _, _, _ = bk.fori(
            60, [a_, b_, c_, e_, f_of(c_), f_of(e_)], golden)
        th = 0.5 * (a_ + b_)
        T = (radius * bk.cos(th), radius * bk.sin(th))
        if sd_in is True:
            return active, T, T, mat(0.0)
        t0 = tuple(bk.where(sd_in, T[i], t0[i]) for i in range(2))
        t1 = tuple(bk.where(sd_in, T[i], t1[i]) for i in range(2))
        arc = bk.where(sd_in, 0.0, arc)
    return active, t0, t1, arc


def _wrap_segment_sg(bk, p1, p2, gpos, gmat, radius, is_cyl, side_w,
                     side_in=None):
    """Scalar twin of smooth.wrap_segment: world-frame path p1 -> p2
    possibly wrapping the sphere/cylinder (gpos, gmat 9-tuple, radius).
    ``side_in`` is whether the sidesite ``side_w`` lies inside the geom
    where the model fixes it (``_sidesite_inside``), else None.
    Returns (active, t0w, t1w, wlen)."""
    mat = bk.full
    l0 = mat_vec_t(gmat, vsub3(p1, gpos))
    l1 = mat_vec_t(gmat, vsub3(p2, gpos))
    ls = None if side_w is None else mat_vec_t(gmat, vsub3(side_w, gpos))
    r2 = radius * radius
    if is_cyl:
        d0, z0 = (l0[0], l0[1]), mat(l0[2])
        d1, z1 = (l1[0], l1[1]), mat(l1[2])
        sd = None if ls is None else (ls[0], ls[1])
        sd_inside = side_in
        if ls is not None and side_in is None:
            s0, s1 = mat(ls[0]), mat(ls[1])
            sd_inside = s0 * s0 + s1 * s1 < r2
        active, t0, t1, arc = _wrap_circle2d_sg(bk, d0, d1, sd, radius,
                                                sd_inside)
        d0c, d0s = mat(d0[0]) - t0[0], mat(d0[1]) - t0[1]
        d1c, d1s = mat(d1[0]) - t1[0], mat(d1[1]) - t1[1]
        len0 = bk.sqrt(d0c * d0c + d0s * d0s)
        len1 = bk.sqrt(d1c * d1c + d1s * d1s)
        tot = bk.maximum(len0 + arc + len1, 1e-12)
        zt0 = z0 + (z1 - z0) * len0 / tot
        zt1 = z0 + (z1 - z0) * (len0 + arc) / tot
        dz = zt1 - zt0
        wlen = bk.sqrt(arc * arc + dz * dz)
        t0w = vadd3(gpos, mat_vec(gmat, (t0[0], t0[1], zt0)))
        t1w = vadd3(gpos, mat_vec(gmat, (t1[0], t1[1], zt1)))
        return active, t0w, t1w, wlen
    # sphere: 2D problem in the plane through l0, l1 and the center
    l0 = tuple(mat(x) for x in l0)
    l1 = tuple(mat(x) for x in l1)
    n0 = bk.sqrt(bk.maximum(l0[0] * l0[0] + l0[1] * l0[1] + l0[2] * l0[2],
                            0.0))
    inv0 = 1.0 / bk.maximum(n0, 1e-12)
    e1 = (l0[0] * inv0, l0[1] * inv0, l0[2] * inv0)
    dot_e1 = e1[0] * l1[0] + e1[1] * l1[1] + e1[2] * l1[2]
    t_vec = tuple(l1[i] - e1[i] * dot_e1 for i in range(3))
    tn = bk.sqrt(t_vec[0] * t_vec[0] + t_vec[1] * t_vec[1]
                 + t_vec[2] * t_vec[2])
    alt = (e1[1] - e1[2], e1[2] - e1[0], e1[0] - e1[1])
    altn = bk.sqrt(alt[0] * alt[0] + alt[1] * alt[1] + alt[2] * alt[2])
    alt2 = (-e1[1], e1[0], mat(0.0))
    alt2n = bk.maximum(
        bk.sqrt(alt2[0] * alt2[0] + alt2[1] * alt2[1] + alt2[2] * alt2[2]),
        1e-12)
    alt = tuple(
        bk.where(altn > 1e-9, alt[i] / bk.maximum(altn, 1e-12),
                 alt2[i] / alt2n)
        for i in range(3)
    )
    invt = 1.0 / bk.maximum(tn, 1e-12)
    e2 = tuple(bk.where(tn > 1e-9, t_vec[i] * invt, alt[i])
               for i in range(3))
    d0 = (n0, mat(0.0))
    d1 = (dot_e1, e2[0] * l1[0] + e2[1] * l1[1] + e2[2] * l1[2])
    sd, sd_inside = None, side_in
    if ls is not None:
        ls = tuple(mat(x) for x in ls)
        sd = (e1[0] * ls[0] + e1[1] * ls[1] + e1[2] * ls[2],
              e2[0] * ls[0] + e2[1] * ls[1] + e2[2] * ls[2])
        if side_in is None:
            sd_inside = (ls[0] * ls[0] + ls[1] * ls[1] + ls[2] * ls[2]
                         < r2)
    active, t0, t1, arc = _wrap_circle2d_sg(bk, d0, d1, sd, radius,
                                            sd_inside)
    t0w = vadd3(gpos, mat_vec(gmat, tuple(
        e1[i] * t0[0] + e2[i] * t0[1] for i in range(3))))
    t1w = vadd3(gpos, mat_vec(gmat, tuple(
        e1[i] * t1[0] + e2[i] * t1[1] for i in range(3))))
    return active, t0w, t1w, arc


def _sidesite_inside(model, mc, side, g):
    """Whether sidesite ``side`` lies inside wrap geom ``g`` (the ball, or
    the cylinder's infinite extent) as a build-time bool, where the two
    share a body and the site is clear of the surface by 1% of r^2 (far
    beyond the rounding of the per-lane test); else None, decided per
    lane.  On one body the site's geom-frame position is a constant."""
    if model.site_bodyid[side] != model.geom_bodyid[g]:
        return None
    rel = (np.asarray(mc.site_pos[side], np.float64)
           - np.asarray(mc.geom_pos[g], np.float64))
    rot = np.asarray(quat_to_mat(tuple(float(x) for x in mc.geom_quat[g])),
                     np.float64).reshape(3, 3)
    loc = rot.T @ rel
    if GeomType(model.geom_type[g]) == GeomType.CYLINDER:
        loc = loc[:2]
    d2, r2 = float(loc @ loc), float(mc.geom_size[g][0]) ** 2
    if abs(d2 - r2) <= 1e-2 * r2:
        return None
    return d2 < r2


def _tendon_len_mom_sg(bk, model, mc, qpos, qvel, fk, bd_mask):
    """Per-tendon (length, moment {dof: coef}, velocity) for fixed and
    spatial tendons -- the scalar mj_tendon.  Fixed tendons keep python
    float moments (structural sparsity folds at build time); spatial
    tendons route through site positions and sphere/cylinder wraps from
    ``fk``.  The step computes this once per forward pass and hands it to
    the passive, actuation and constraint stages."""
    lens, moms, vels = [], [], []
    for t, kind in enumerate(_tendon_kinds(model)):
        if kind != 1:
            adr, num = model.tendon_adr[t], model.tendon_num[t]
            L = 0.0
            V = 0.0
            mom = {}
            for w in range(adr, adr + num):
                jid = model.tendon_wrap_jnt[w]
                coef = float(mc.tendon_wrap_coef[w])
                L = fma(L, coef, qpos[model.jnt_qposadr[jid]])
                vadr = model.jnt_dofadr[jid]
                V = fma(V, coef, qvel[vadr])
                mom[vadr] = mom.get(vadr, 0.0) + coef
            lens.append(L)
            moms.append(mom)
            vels.append(V)
            continue
        L, mom = _spatial_tendon_sg(bk, model, mc, fk, bd_mask, t)
        lens.append(L)
        moms.append(mom)
        vels.append(_jdotv(mom, qvel))
    return lens, moms, vels


def _spatial_tendon_sg(bk, model, mc, fk, bd_mask, t):
    """One spatial tendon's (length, moment dict): straight segments add
    |p2 - p1| / div and u . (J2 - J1) / div; a wrap adds both tangent
    segments and the on-surface arc, its tangent points rigidly attached
    to the wrap geom's body (mj_tendon's wrap-point chain)."""
    mat = bk.full
    xpos, xmat = fk["xpos"], fk["xmat"]
    subtree_com, cdof = fk["subtree_com"], fk["cdof"]

    def site_p(s):
        b = model.site_bodyid[s]
        return vadd3(xpos[b], mat_vec(xmat[b], tuple(mc.site_pos[s])))

    def site_jac(s):
        return _point_jac_sg(model, cdof, subtree_com, bd_mask,
                             site_p(s), model.site_bodyid[s])

    z3 = (0.0, 0.0, 0.0)

    def seg_term(p1, j1, p2, j2, div):
        dvec = vsub3(p2, p1)
        n = bk.sqrt(bk.maximum(mat(dot3(dvec, dvec)), 1e-24))
        u = vscale3(dvec, 1.0 / n)
        dr = {}
        for dof in set(j1) | set(j2):
            dr[dof] = dot3(vsub3(j2.get(dof, z3), j1.get(dof, z3)),
                           u) / div
        return n / div, dr

    def row_add(row, d):
        for k_, v_ in d.items():
            row[k_] = add(row.get(k_, 0.0), v_)

    path = smooth._tendon_path(model, t)
    L = 0.0
    row = {}
    k = 0
    while k < len(path) - 1:
        kind1, obj1, _side1, br1, div = path[k]
        assert kind1 == 0, "path segments start at sites"
        nxt = path[k + 1]
        if nxt[3] != br1:
            k += 1
            continue  # pulley between: no segment
        p1, j1 = site_p(obj1), site_jac(obj1)
        if nxt[0] == 0:  # plain site-site segment
            p2, j2 = site_p(nxt[1]), site_jac(nxt[1])
            dl, dr = seg_term(p1, j1, p2, j2, div)
            L = add(L, dl)
            row_add(row, dr)
            k += 1
            continue
        # wrap geom between this site and the next
        g = nxt[1]
        side = nxt[2]
        s2 = path[k + 2][1]
        assert path[k + 2][0] == 0, "wrap geom bracketed by sites"
        p2, j2 = site_p(s2), site_jac(s2)
        gb = model.geom_bodyid[g]
        gpos = vadd3(xpos[gb], mat_vec(xmat[gb], tuple(mc.geom_pos[g])))
        gmat = _mat_mul_const(xmat[gb], quat_to_mat(tuple(mc.geom_quat[g])))
        is_cyl = GeomType(model.geom_type[g]) == GeomType.CYLINDER
        radius = float(mc.geom_size[g][0])
        side_w = None if side < 0 else site_p(side)
        active, t0w, t1w, wlen = _wrap_segment_sg(
            bk, p1, p2, gpos, gmat, radius, is_cyl, side_w,
            None if side < 0 else _sidesite_inside(model, mc, side, g))
        jt0 = _point_jac_sg(model, cdof, subtree_com, bd_mask, t0w, gb)
        jt1 = _point_jac_sg(model, cdof, subtree_com, bd_mask, t1w, gb)
        dl0, dr0 = seg_term(p1, j1, t0w, jt0, div)
        _dla, dra = seg_term(t0w, jt0, t1w, jt1, div)
        dl1, dr1 = seg_term(t1w, jt1, p2, j2, div)
        dls, drs = seg_term(p1, j1, p2, j2, div)
        L = add(L, bk.where(active, dl0 + wlen / div + dl1, mat(dls)))
        row_w = {}
        row_add(row_w, dr0)
        row_add(row_w, dra)
        row_add(row_w, dr1)
        for dof in set(row_w) | set(drs):
            row[dof] = add(
                row.get(dof, 0.0),
                bk.where(active, mat(row_w.get(dof, 0.0)),
                         mat(drs.get(dof, 0.0))),
            )
        k += 2
    return L, row


def _transmission(bk, model, mc, u, fk, bd_mask, qpos, ten, need_length):
    """(moment {dof: coef}, length) of actuator ``u`` (mj_transmission):
    a hinge, slide, ball or free joint, a tendon (``ten`` is the step's
    (lengths, moments, velocities)) or a site without refsite, whose gear
    is a 6D wrench in the site frame.  The length is built only when
    ``need_length`` (affine or muscle gain and bias read it)."""
    trn = TrnType(model.actuator_trntype[u])
    if trn == TrnType.JOINT:
        j = model.actuator_trnid[u]
        vadr = model.jnt_dofadr[j]
        if model.jnt_type[j] == JointType.FREE:
            g6 = [float(x) for x in mc.actuator_gear[u]]
            return {vadr + k: g6[k] for k in range(6) if g6[k] != 0.0}, 0.0
        if model.jnt_type[j] == JointType.BALL:
            # torque gear[:3] on the 3 dofs; length expmap(q) . gear[:3]
            g3 = [float(x) for x in mc.actuator_gear[u][:3]]
            length = 0.0
            if need_length:
                qadr = model.jnt_qposadr[j]
                expmap = quat_sub_scalar(
                    bk, qnormalize(bk, tuple(qpos[qadr + k]
                                             for k in range(4))),
                    (1.0, 0.0, 0.0, 0.0))
                length = sum_scalars([mul(g3[k], expmap[k])
                                      for k in range(3)])
            return {vadr + k: g3[k] for k in range(3) if g3[k] != 0.0}, length
        gear = float(mc.actuator_gear[u][0])
        length = (mul(gear, qpos[model.jnt_qposadr[j]]) if need_length
                  else 0.0)
        return {vadr: gear}, length
    if trn == TrnType.TENDON:
        t = model.actuator_trnid[u]
        gear = float(mc.actuator_gear[u][0])
        ten_len, ten_mom, _ = ten
        return ({vadr: mul(gear, m) for vadr, m in ten_mom[t].items()},
                mul(gear, ten_len[t]) if need_length else 0.0)
    s = model.actuator_trnid[u]
    b = model.site_bodyid[s]
    xpos, xmat = fk["xpos"], fk["xmat"]
    spos = vadd3(xpos[b], mat_vec(xmat[b], tuple(mc.site_pos[s])))
    smat = _mat_mul_const(xmat[b], quat_to_mat(tuple(mc.site_quat[s])))
    g6 = [float(x) for x in mc.actuator_gear[u]]
    wf = mat_vec(smat, (g6[0], g6[1], g6[2]))
    wt = mat_vec(smat, (g6[3], g6[4], g6[5]))
    arm = vsub3(spos, fk["subtree_com"][model.body_rootid[b]])
    moment = {}
    for dof in range(model.nv):
        if not bd_mask[b, dof]:
            continue
        ang, lin = fk["cdof"][dof]
        jacp = vadd3(lin, cross3(ang, arm))
        moment[dof] = add(dot3(jacp, wf), dot3(ang, wt))
    return moment, 0.0


def _fk_chain(bk, model, mc, sub_mask, qpos, com: bool = True,
              mocap=None):
    """FK + com geometry for hinge/slide/ball/free trees: every
    position-dependent quantity the downstream stages and the env hooks
    read (xanchor/xaxis captured during the walk, before each joint's own
    transform, as mj_kinematics does).  ``com=False`` stops after the body
    frames: no subtree coms and no cdof.

    ``mocap``: 7 * nmocap values, (pos3, quat4) per mocap body in
    Data.mocap_pos/mocap_quat order, that replace the model's rest poses
    of the mocap bodies (the quaternion is normalized, as mj_kinematics
    does); without it a mocap body keeps its rest pose."""
    nbody, nv = model.nbody, model.nv
    xpos = [(0.0, 0.0, 0.0)] * nbody
    xquat = [(1.0, 0.0, 0.0, 0.0)] * nbody
    xanchor = [None] * model.njnt
    xaxis = [None] * model.njnt
    for b in range(1, nbody):
        p = model.body_parentid[b]
        mid = model.body_mocapid[b] if mocap is not None else -1
        if mid >= 0:
            xpos[b] = tuple(mocap[7 * mid + i] for i in range(3))
            xquat[b] = qnormalize(bk, tuple(mocap[7 * mid + 3 + i]
                                            for i in range(4)))
            continue
        pos = vadd3(xpos[p], qrot(xquat[p], tuple(mc.body_pos[b])))
        quat = qmul(xquat[p], tuple(mc.body_quat[b]))
        jids = smooth.body_joints(model, b)
        if len(jids) == 1 and model.jnt_type[jids[0]] == JointType.FREE:
            # the body frame is the joint's coordinates: world position and
            # the (normalized) quaternion
            j = jids[0]
            qadr = model.jnt_qposadr[j]
            pos = (qpos[qadr], qpos[qadr + 1], qpos[qadr + 2])
            quat = qnormalize(bk, tuple(qpos[qadr + 3 + i] for i in range(4)))
            xanchor[j] = pos
            # MuJoCo keeps the free joint's axis unrotated (global z)
            xaxis[j] = tuple(float(x) for x in mc.jnt_axis[j])
            jids = []
        for j in jids:
            jt = model.jnt_type[j]
            qadr = model.jnt_qposadr[j]
            axis_local = mc.jnt_axis[j]
            jpos_local = tuple(mc.jnt_pos[j])
            axis_w = qrot(quat, tuple(axis_local))
            anchor = vadd3(pos, qrot(quat, jpos_local))
            if jt == JointType.SLIDE:
                disp = sub(qpos[qadr], float(mc.qpos0[qadr]))
                pos = vadd3(pos, vscale3(axis_w, disp))
            elif jt == JointType.BALL:
                # the joint's (normalized) quaternion turns the body
                # about the anchor
                qloc = qnormalize(bk, tuple(qpos[qadr + i] for i in range(4)))
                quat = qmul(quat, qloc)
                pos = vsub3(anchor, qrot(quat, jpos_local))
            else:  # hinge
                angle = sub(qpos[qadr], float(mc.qpos0[qadr]))
                qloc = axis_angle_quat(bk, axis_local, angle)
                quat = qmul(quat, qloc)
                pos = vsub3(anchor, qrot(quat, jpos_local))
            xanchor[j] = anchor
            xaxis[j] = axis_w
        xpos[b] = pos
        xquat[b] = quat
    xmat = [quat_to_mat(q) for q in xquat]
    xipos = [
        vadd3(xpos[b], mat_vec(xmat[b], tuple(mc.body_ipos[b])))
        for b in range(nbody)
    ]
    if not com:
        return dict(xpos=xpos, xquat=xquat, xmat=xmat, xipos=xipos)

    # subtree_com of each root's tree (constant masses: python weights)
    subtree_com = [None] * nbody
    for b in range(nbody):
        members = [c for c in range(nbody) if sub_mask[b, c]]
        total = float(sum(mc.body_mass[c] for c in members))
        if total <= 0:
            subtree_com[b] = xpos[b]
            continue
        acc = (0.0, 0.0, 0.0)
        for c in members:
            w = float(mc.body_mass[c]) / total
            if w:
                acc = vadd3(acc, vscale3(xipos[c], w))
        subtree_com[b] = acc

    # cdof per dof: (ang3, lin3)
    cdof = [None] * nv
    for j in range(model.njnt):
        vadr = model.jnt_dofadr[j]
        b = model.jnt_bodyid[j]
        com = subtree_com[model.body_rootid[b]]
        if model.jnt_type[j] == JointType.FREE:
            # 3 world-aligned translations (constant cdof) + 3 rotations
            # about the body-frame axes, anchored at the body origin
            for i in range(3):
                e = [0.0, 0.0, 0.0]
                e[i] = 1.0
                cdof[vadr + i] = ((0.0, 0.0, 0.0), tuple(e))
            off = vsub3(com, xpos[b])
            for i in range(3):
                col = mat_col(xmat[b], i)
                cdof[vadr + 3 + i] = (col, cross3(col, off))
        elif model.jnt_type[j] == JointType.BALL:
            # 3 rotations about the body-frame axes, anchored at the joint
            off = vsub3(com, xanchor[j])
            for i in range(3):
                col = mat_col(xmat[b], i)
                cdof[vadr + i] = (col, cross3(col, off))
        elif model.jnt_type[j] == JointType.SLIDE:
            cdof[vadr] = ((0.0, 0.0, 0.0), xaxis[j])
        else:
            off = vsub3(com, xanchor[j])
            cdof[vadr] = (xaxis[j], cross3(xaxis[j], off))
    return dict(
        xpos=xpos, xquat=xquat, xmat=xmat, xipos=xipos, xanchor=xanchor,
        xaxis=xaxis, subtree_com=subtree_com, cdof=cdof,
    )


def build_step(model: Model, bk, want_qacc: bool = False, team: int = 1):
    """Build the scalar-graph step on backend ``bk``.

    Returns ``step(qpos, qvel, act, warmstart, ctrl, eq_act=None, *,
    mocap=None, qfrc_ext=None, xfrc_ext=None) -> (qpos', qvel', act',
    warmstart')`` over python lists of backend values (one per
    generalized coordinate / activation / actuator).  ``eq_act`` is one
    bool lane per equality (Data.eq_active); without it the equalities
    active at build time are always on (see :func:`_eq_rows`).  ``mocap``
    holds the 7 * nmocap pose lanes of the mocap bodies (see
    :func:`_fk_chain`); ``qfrc_ext`` (nv lanes) and ``xfrc_ext``
    (6 * nbody lanes: force, then torque, per body) are Data.qfrc_applied
    and Data.xfrc_applied.  RK4 feeds all of them to its four passes.
    ``want_qacc`` appends the step's stage-1 constrained qacc, the
    acceleration the sensors read (mj_step computes them before it
    integrates; under RK4 that is the first forward pass, not stage 4's).
    ``team`` is the line search's team size G (see
    :func:`_linesearch_scalar`): 1, or a power of two up to 8.
    """
    if team not in TEAM_SIZES:
        raise ValueError(f"team must be one of {TEAM_SIZES}, not {team}")
    reason = unsupported_reason(model)
    if reason is not None:
        raise ValueError(f"model not in the port's scalar-graph class: "
                         f"{reason}")
    mc = _ModelConsts(model)
    nq, nv, nu, nbody = model.nq, model.nv, model.nu, model.nbody
    na = model.na
    h = float(model.opt.timestep)
    gravity = tuple(float(g) for g in model.opt.gravity)
    if model.opt.disable_gravity:
        gravity = (0.0, 0.0, 0.0)

    anc = smooth.dof_ancestor_mask(model)          # (nv, nv)
    bd_mask = smooth.body_dof_mask(model)          # (nbody, nv)
    sub_mask = smooth.subtree_mask(model)          # (nbody, nbody)

    def chol_factor(mat, extra_diag=None):
        """mat: dict {(i,j): val, i>=j}; returns L dict {(i,j)}."""
        L = {}
        for jcol in range(nv):
            s = mat.get((jcol, jcol), 0.0)
            if extra_diag is not None:
                s = add(s, extra_diag[jcol])
            for k in range(jcol):
                if (jcol, k) in L:
                    s = sub(s, mul(L[(jcol, k)], L[(jcol, k)]))
            Ljj = bk.sqrt(s)
            L[(jcol, jcol)] = Ljj
            inv = 1.0 / Ljj
            for i in range(jcol + 1, nv):
                s = mat.get((i, jcol), 0.0)
                for k in range(jcol):
                    if (i, k) in L and (jcol, k) in L:
                        s = sub(s, mul(L[(i, k)], L[(jcol, k)]))
                if _is_const(s) and s == 0.0:
                    continue
                L[(i, jcol)] = mul(s, inv)
        return L

    def chol_solve(L, b_vec):
        y = [None] * nv
        for i in range(nv):
            s = b_vec[i]
            for k in range(i):
                if (i, k) in L:
                    s = sub(s, mul(L[(i, k)], y[k]))
            y[i] = (mul(s, 1.0 / L[(i, i)]) if _is_const(L[(i, i)])
                    else s / L[(i, i)])
        x = [None] * nv
        for i in range(nv - 1, -1, -1):
            s = y[i]
            for k in range(i + 1, nv):
                if (k, i) in L:
                    s = sub(s, mul(L[(k, i)], x[k]))
            x[i] = (mul(s, 1.0 / L[(i, i)]) if _is_const(L[(i, i)])
                    else s / L[(i, i)])
        return x

    cw_eqs = [e for e in range(model.neq)
              if EqType(model.eq_type[e]) in (EqType.CONNECT, EqType.WELD)]

    # fluid forces: (body, half-sizes of its equivalent inertia box) for
    # every body with mass and dofs; none without density or viscosity
    # (wind alone moves nothing), so such a model emits no op for them
    density = float(model.opt.density)
    viscosity = float(model.opt.viscosity)
    wind = tuple(float(x) for x in model.opt.wind)
    fluid_boxes = []
    for b in range(1, nbody):
        m_b = float(mc.body_mass[b])
        if (density == 0.0 and viscosity == 0.0) or m_b <= 0.0 \
                or not bd_mask[b].any():
            continue
        i3 = [float(x) for x in mc.body_inertia[b]]
        fluid_boxes.append((b, [
            math.sqrt(max(1.5 * (i3[(i + 1) % 3] + i3[(i + 2) % 3] - i3[i])
                          / m_b, 1e-12)) for i in range(3)]))

    def forward_pass(qpos, qvel, act, warmstart, ctrl, eq_act=None,
                     mocap=None, qfrc_ext=None, xfrc_ext=None):
        """Forward dynamics to qacc (no integration) and act_dot."""
        if any(eq_act is not None or model.eq_active0[e] for e in cw_eqs):
            # connect and weld rows need d/dt of their Jacobian along
            # qvel: the one FK of the pass runs on Duals, and its primal
            # (the very ops of the plain FK) is the step's FK; the mocap
            # lanes enter it as constants (tangent 0)
            fk_d = _fk_chain(DualBackend(bk), model, mc, sub_mask,
                             _qpos_duals(model, qpos, qvel), mocap=mocap)
            fk = _primal(fk_d)
        else:
            fk_d = None
            fk = _fk_chain(bk, model, mc, sub_mask, qpos, mocap=mocap)
        xpos, xquat, xmat, xipos = (fk["xpos"], fk["xquat"], fk["xmat"],
                                    fk["xipos"])
        subtree_com, cdof = fk["subtree_com"], fk["cdof"]

        # spatial inertia (I0 6 unique, h 3, mass const) about root com
        cin_i = [None] * nbody
        cin_h = [None] * nbody
        for b in range(nbody):
            mb = float(mc.body_mass[b])
            origin = subtree_com[model.body_rootid[b]]
            imat = quat_to_mat(qmul(xquat[b], tuple(mc.body_iquat[b])))
            d1, d2, d3 = (float(x) for x in mc.body_inertia[b])
            r = imat
            icc = {}
            for a_ in range(3):
                for c_ in range(a_, 3):
                    icc[(a_, c_)] = add(
                        add(
                            mul(mul(r[3 * a_ + 0], r[3 * c_ + 0]), d1),
                            mul(mul(r[3 * a_ + 1], r[3 * c_ + 1]), d2),
                        ),
                        mul(mul(r[3 * a_ + 2], r[3 * c_ + 2]), d3),
                    )
            c3 = vsub3(xipos[b], origin)
            cc = dot3(c3, c3)
            i0 = {}
            for a_ in range(3):
                for c_ in range(a_, 3):
                    paxis = mul(mb, sub(mul(1.0 if a_ == c_ else 0.0, cc),
                                        mul(c3[a_], c3[c_])))
                    i0[(a_, c_)] = add(icc[(a_, c_)], paxis)
            cin_i[b] = i0
            cin_h[b] = vscale3(c3, mb)

        # ----------------- CRB -> M -----------------
        crb_i = [dict(cin_i[b]) for b in range(nbody)]
        crb_h = [list(cin_h[b]) for b in range(nbody)]
        crb_m = [float(mc.body_mass[b]) for b in range(nbody)]
        for b in range(nbody - 1, 0, -1):
            p = model.body_parentid[b]
            for key in crb_i[b]:
                crb_i[p][key] = add(crb_i[p][key], crb_i[b][key])
            for k3 in range(3):
                crb_h[p][k3] = add(crb_h[p][k3], crb_h[b][k3])
            crb_m[p] += crb_m[b]

        def inert_mul(i0, h3, mm, ang, lin):
            """(I0, h, m) applied to motion (ang, lin) -> force (t, f)."""
            def sym(a_, c_):
                return i0[(a_, c_)] if a_ <= c_ else i0[(c_, a_)]

            t = tuple(
                add(
                    add(
                        add(mul(sym(r_, 0), ang[0]), mul(sym(r_, 1), ang[1])),
                        mul(sym(r_, 2), ang[2]),
                    ),
                    cross3(h3, lin)[r_],
                )
                for r_ in range(3)
            )
            f = tuple(
                sub(mul(mm, lin[r_]), cross3(h3, ang)[r_]) for r_ in range(3)
            )
            return t, f

        m_mat = {}
        for i in range(nv):
            bi = model.dof_bodyid[i]
            t, f = inert_mul(crb_i[bi], crb_h[bi], crb_m[bi], cdof[i][0],
                             cdof[i][1])
            for j in range(nv):
                if anc[i, j]:  # j ancestor-or-self of i
                    val = add(dot3(cdof[j][0], t), dot3(cdof[j][1], f))
                    m_mat[(max(i, j), min(i, j))] = val
        for i in range(nv):
            arm = float(mc.dof_armature[i])
            if arm:
                m_mat[(i, i)] = add(m_mat[(i, i)], arm)

        # ----------------- velocity stage -----------------
        cvel = [((0.0, 0.0, 0.0), (0.0, 0.0, 0.0))] * nbody
        cdof_dot = [((0.0, 0.0, 0.0), (0.0, 0.0, 0.0))] * nv

        def vel_add(v, i):
            ca, cl = cdof[i]
            return (
                vadd3(v[0], vscale3(ca, qvel[i])),
                vadd3(v[1], vscale3(cl, qvel[i])),
            )

        for b in range(1, nbody):
            p = model.body_parentid[b]
            v = cvel[p]
            for j in smooth.body_joints(model, b):
                adr = model.jnt_dofadr[j]
                if model.jnt_type[j] == JointType.FREE:
                    # translation dofs: constant cdof -> cdof_dot = 0
                    for i in range(adr, adr + 3):
                        v = vel_add(v, i)
                    # rotation dofs: cdof_dot = v_after_translation x cdof
                    for i in range(adr + 3, adr + 6):
                        cdof_dot[i] = motion_cross(v, cdof[i])
                    for i in range(adr + 3, adr + 6):
                        v = vel_add(v, i)
                elif model.jnt_type[j] == JointType.BALL:
                    for i in range(adr, adr + 3):
                        cdof_dot[i] = motion_cross(v, cdof[i])
                    for i in range(adr, adr + 3):
                        v = vel_add(v, i)
                else:
                    cdof_dot[adr] = motion_cross(v, cdof[adr])
                    v = vel_add(v, adr)
            cvel[b] = v

        # rne (bias forces)
        cacc = [((0.0, 0.0, 0.0), (neg(gravity[0]), neg(gravity[1]),
                                   neg(gravity[2])))] * nbody
        cacc[0] = ((0.0, 0.0, 0.0), (-gravity[0], -gravity[1], -gravity[2]))
        for b in range(1, nbody):
            p = model.body_parentid[b]
            aa, al = cacc[p]
            adr, num = model.body_dofadr[b], model.body_dofnum[b]
            for i in range(adr, adr + num) if adr >= 0 else ():
                da, dl = cdof_dot[i]
                aa = vadd3(aa, vscale3(da, qvel[i]))
                al = vadd3(al, vscale3(dl, qvel[i]))
            cacc[b] = (aa, al)

        cfrc = [None] * nbody
        for b in range(nbody):
            iv_t, iv_f = inert_mul(cin_i[b], cin_h[b], float(mc.body_mass[b]),
                                   cvel[b][0], cvel[b][1])
            ia_t, ia_f = inert_mul(cin_i[b], cin_h[b], float(mc.body_mass[b]),
                                   cacc[b][0], cacc[b][1])
            va, vl = cvel[b]
            # force cross: v x* f
            fc_t = vadd3(cross3(va, iv_t), cross3(vl, iv_f))
            fc_f = cross3(va, iv_f)
            cfrc[b] = (vadd3(ia_t, fc_t), vadd3(ia_f, fc_f))

        # backward accumulate + project
        cfrc_tot = [list(map(list, cfrc[b])) for b in range(nbody)]
        for b in range(nbody - 1, 0, -1):
            p = model.body_parentid[b]
            for part in range(2):
                for k3 in range(3):
                    cfrc_tot[p][part][k3] = add(
                        cfrc_tot[p][part][k3], cfrc_tot[b][part][k3]
                    )
        qfrc_bias = []
        for i in range(nv):
            bi = model.dof_bodyid[i]
            t = tuple(cfrc_tot[bi][0])
            f = tuple(cfrc_tot[bi][1])
            qfrc_bias.append(add(dot3(cdof[i][0], t), dot3(cdof[i][1], f)))

        # ----------------- passive + actuation -----------------
        qfrc_passive = []
        quat_springs = {}  # jnt id -> (3,) rotational spring displacement
        for i in range(nv):
            j = model.dof_jntid[i]
            jt = model.jnt_type[j]
            qadr = model.jnt_qposadr[j]
            stiff = float(mc.jnt_stiffness[j])
            spring = 0.0
            if stiff and jt in (JointType.HINGE, JointType.SLIDE):
                spring = mul(
                    -stiff, sub(qpos[qadr], float(mc.qpos_spring[qadr]))
                )
            elif stiff and jt == JointType.BALL:
                # -stiffness * mju_subQuat(q, qpos_spring) on the 3 dofs
                if j not in quat_springs:
                    quat_springs[j] = quat_sub_scalar(
                        bk, tuple(qpos[qadr + k] for k in range(4)),
                        tuple(float(mc.qpos_spring[qadr + k])
                              for k in range(4)))
                spring = mul(-stiff,
                             quat_springs[j][i - model.jnt_dofadr[j]])
            elif stiff:
                # translation dofs: linear spring to qpos_spring[:3];
                # rotation dofs: quaternion spring (mju_subQuat)
                k_ = i - model.jnt_dofadr[j]
                if k_ < 3:
                    spring = mul(
                        -stiff,
                        sub(qpos[qadr + k_], float(mc.qpos_spring[qadr + k_])),
                    )
                else:
                    if j not in quat_springs:
                        quat_springs[j] = quat_sub_scalar(
                            bk,
                            tuple(qpos[qadr + 3 + k] for k in range(4)),
                            tuple(float(mc.qpos_spring[qadr + 3 + k])
                                  for k in range(4)),
                        )
                    spring = mul(-stiff, quat_springs[j][k_ - 3])
            damp = mul(-float(mc.dof_damping[i]), qvel[i])
            qfrc_passive.append(add(spring, damp))

        # tendon springs (dead-band) and dampers, fixed and spatial: the
        # force maps through the tendon's moment row.  The tendon state is
        # computed once here and read again by the transmissions and the
        # constraint rows.
        ten = _tendon_len_mom_sg(bk, model, mc, qpos, qvel, fk, bd_mask)
        ten_len, ten_mom, ten_vel = ten
        for t in range(model.ntendon):
            stiff = float(mc.tendon_stiffness[t])
            damp = float(mc.tendon_damping[t])
            if stiff == 0.0 and damp == 0.0:
                continue
            lo, hi = (float(x) for x in mc.tendon_lengthspring[t])
            L = ten_len[t]
            disp = bk.where(L < lo, lo - L, bk.where(L > hi, hi - L, 0.0))
            frc = sub(mul(stiff, disp), mul(damp, ten_vel[t]))
            for vadr, coef in ten_mom[t].items():
                qfrc_passive[vadr] = fma(qfrc_passive[vadr], coef, frc)

        # fluid forces (mj_fluid's inertia-box model): each body with
        # mass and dofs drags as the box of its inertia through the
        # medium moving at the wind; the box and the coefficients are
        # build-time constants, the body velocities are traced
        for b, rbox in fluid_boxes:
            origin = subtree_com[model.body_rootid[b]]
            arm = vsub3(xipos[b], origin)
            w_w = cvel[b][0]
            v_w = vsub3(vadd3(cvel[b][1], cross3(w_w, arm)), wind)
            imat = quat_to_mat(qmul(xquat[b], tuple(mc.body_iquat[b])))
            w_l = mat_vec_t(imat, w_w)
            v_l = mat_vec_t(imat, v_w)
            f_l = [0.0, 0.0, 0.0]
            t_l = [0.0, 0.0, 0.0]
            rbar = (rbox[0] + rbox[1] + rbox[2]) / 3.0
            if viscosity != 0.0:
                # viscous (Stokes) force and torque of the box's sphere
                cf = -6.0 * math.pi * viscosity * rbar
                ct = -8.0 * math.pi * viscosity * rbar ** 3
                f_l = [mul(cf, v_l[i]) for i in range(3)]
                t_l = [mul(ct, w_l[i]) for i in range(3)]
            if density != 0.0:
                # quadratic drag on the box's faces
                for i in range(3):
                    rj, rk = rbox[(i + 1) % 3], rbox[(i + 2) % 3]
                    f_l[i] = add(f_l[i], mul(
                        -2.0 * density * rj * rk,
                        mul(bk.abs(v_l[i]), v_l[i])))
                    t_l[i] = add(t_l[i], mul(
                        -0.5 * density * rbox[i] * (rj ** 4 + rk ** 4),
                        mul(bk.abs(w_l[i]), w_l[i])))
            f_w = mat_vec(imat, tuple(f_l))
            t_w = mat_vec(imat, tuple(t_l))
            sp_ang = vadd3(t_w, cross3(arm, f_w))
            for dof in range(nv):
                if bd_mask[b, dof]:
                    ang, lin = cdof[dof]
                    qfrc_passive[dof] = add(
                        qfrc_passive[dof],
                        add(dot3(ang, sp_ang), dot3(lin, f_w)))

        qfrc_actuator = [0.0] * nv
        act_dot = [0.0] * na
        for u in range(nu):
            c = ctrl[u]
            if model.actuator_ctrllimited[u]:
                lo, hi = mc.actuator_ctrlrange[u]
                c = bk.clip(c, float(lo), float(hi))
            gtype = GainType(model.actuator_gaintype[u])
            btype = BiasType(model.actuator_biastype[u])
            need_lv = gtype != GainType.FIXED or btype != BiasType.NONE
            moment, length = _transmission(bk, model, mc, u, fk, bd_mask,
                                           qpos, ten, need_lv)
            velocity = _jdotv(moment, qvel) if need_lv else 0.0
            # activation dynamics (mj_fwdActuation): a stateful actuator's
            # force reads act; act_dot is integrated by the step
            aadr = model.actuator_actadr[u]
            if aadr >= 0:
                a_u = act[aadr]
                dyn = DynType(model.actuator_dyntype[u])
                if dyn == DynType.INTEGRATOR:
                    act_dot[aadr] = c
                elif dyn == DynType.MUSCLE:
                    act_dot[aadr] = muscle.muscle_dynamics(
                        bk, c, a_u, mc.actuator_dynprm[u])
                else:  # FILTER / FILTEREXACT
                    tau = max(float(mc.actuator_dynprm[u][0]), 1e-15)
                    act_dot[aadr] = mul(sub(c, a_u), 1.0 / tau)
                force_input = a_u
            else:
                force_input = c
            gp = [float(x) for x in mc.actuator_gainprm[u]]
            if gtype == GainType.MUSCLE:
                gain = muscle.muscle_gain(
                    bk, length, velocity, mc.actuator_lengthrange[u],
                    float(mc.actuator_acc0[u]), gp)
            elif gtype == GainType.FIXED:
                gain = gp[0]
            else:
                gain = add(add(gp[0], mul(gp[1], length)),
                           mul(gp[2], velocity))
            bp = [float(x) for x in mc.actuator_biasprm[u]]
            if btype == BiasType.MUSCLE:
                bias = muscle.muscle_bias(
                    bk, length, mc.actuator_lengthrange[u],
                    float(mc.actuator_acc0[u]), bp)
            elif btype == BiasType.NONE:
                bias = 0.0
            else:
                bias = add(add(bp[0], mul(bp[1], length)),
                           mul(bp[2], velocity))
            force = add(mul(gain, force_input), bias)
            if model.actuator_forcelimited[u]:
                lo, hi = mc.actuator_forcerange[u]
                force = bk.clip(force, float(lo), float(hi))
            for dof, mval in moment.items():
                qfrc_actuator[dof] = fma(qfrc_actuator[dof], mval, force)

        qfrc_smooth = [
            add(add(qfrc_passive[i], neg(qfrc_bias[i])), qfrc_actuator[i])
            for i in range(nv)
        ]
        # applied forces (Data.qfrc_applied, and xfrc_applied through
        # mj_xfrcAccumulate): the wrench of body b >= 1 acts at its com;
        # the world's six lanes are read by nothing
        if qfrc_ext is not None:
            qfrc_smooth = [add(qfrc_smooth[i], qfrc_ext[i])
                           for i in range(nv)]
        if xfrc_ext is not None:
            for b in range(1, nbody):
                f3 = tuple(xfrc_ext[6 * b + k] for k in range(3))
                t3 = tuple(xfrc_ext[6 * b + 3 + k] for k in range(3))
                arm = vsub3(xipos[b], subtree_com[model.body_rootid[b]])
                sp_ang = vadd3(t3, cross3(arm, f3))
                for dof in range(nv):
                    if bd_mask[b, dof]:
                        ang, lin = cdof[dof]
                        qfrc_smooth[dof] = add(
                            qfrc_smooth[dof],
                            add(dot3(ang, sp_ang), dot3(lin, f3)))

        l_m = chol_factor(m_mat)
        qacc_smooth = chol_solve(l_m, qfrc_smooth)

        # ----------------- collision + efc assembly -----------------
        rows, cones = _assemble_rows(bk, model, mc, qpos, qvel, xpos, xmat,
                                     subtree_com, cdof, bd_mask, h, ten,
                                     eq_act, fk_d)

        # ----------------- Newton solver -----------------
        qfrc_constraint = [0.0] * nv
        if rows or cones:
            qacc = _newton(bk, model, rows, cones, m_mat, chol_factor,
                           chol_solve, qacc_smooth, qfrc_smooth, warmstart,
                           nv, team)
            for r in rows:
                fr = r["force"]
                for dof, val in r["J"].items():
                    qfrc_constraint[dof] = fma(qfrc_constraint[dof], val, fr)
            for c in cones:
                for Ji, fi in zip(c["J"], c["force"]):
                    for dof, val in Ji.items():
                        qfrc_constraint[dof] = fma(qfrc_constraint[dof], val,
                                                   fi)
        else:
            qacc = qacc_smooth
        return dict(qacc=qacc, qfrc_smooth=qfrc_smooth,
                    qfrc_constraint=qfrc_constraint, m_mat=m_mat,
                    act_dot=act_dot)

    def integrate_pos_sg(qpos, qvel_new, dt):
        """mj_integratePos in scalar form (manifold update for quats)."""
        if nq == nv:  # scalar joints only: plain vector update
            return [add(qpos[i], mul(dt, qvel_new[i])) for i in range(nq)]
        qpos_new = list(qpos)
        for j in range(model.njnt):
            qadr = model.jnt_qposadr[j]
            vadr = model.jnt_dofadr[j]
            if model.jnt_type[j] in (JointType.HINGE, JointType.SLIDE):
                qpos_new[qadr] = add(qpos[qadr], mul(dt, qvel_new[vadr]))
                continue
            if model.jnt_type[j] == JointType.BALL:
                q = quat_integrate_scalar(
                    bk, tuple(qpos[qadr + i] for i in range(4)),
                    tuple(qvel_new[vadr + i] for i in range(3)), dt)
                for i in range(4):
                    qpos_new[qadr + i] = q[i]
                continue
            # free: world-frame translation + local angular velocity
            for i in range(3):
                qpos_new[qadr + i] = add(
                    qpos[qadr + i], mul(dt, qvel_new[vadr + i])
                )
            q = quat_integrate_scalar(
                bk, tuple(qpos[qadr + 3 + i] for i in range(4)),
                tuple(qvel_new[vadr + 3 + i] for i in range(3)), dt,
            )
            for i in range(4):
                qpos_new[qadr + 3 + i] = q[i]
        return qpos_new

    def advance_act_sg(act, act_dot, dt):
        """mj_advance's act update: Euler for integrator, filter and
        muscle, the exact exponential for filterexact, then the actrange
        clamp."""
        out = list(act)
        for u in range(nu):
            aadr = model.actuator_actadr[u]
            if aadr < 0:
                continue
            if DynType(model.actuator_dyntype[u]) == DynType.FILTEREXACT:
                tau = max(float(mc.actuator_dynprm[u][0]), 1e-15)
                eff_dt = tau * -math.expm1(-dt / tau)
            else:
                eff_dt = dt
            a = fma(act[aadr], eff_dt, act_dot[aadr])
            if model.actuator_actlimited[u]:
                lo, hi = mc.actuator_actrange[u]
                a = bk.clip(a, float(lo), float(hi))
            out[aadr] = a
        return out

    if model.opt.integrator == Integrator.EULER:

        def step(qpos, qvel, act, warmstart, ctrl, eq_act=None, *,
                 mocap=None, qfrc_ext=None, xfrc_ext=None):
            fw = forward_pass(list(qpos), list(qvel), list(act),
                              list(warmstart), list(ctrl), eq_act,
                              mocap, qfrc_ext, xfrc_ext)
            # semi-implicit Euler with implicit joint damping (mj_Euler)
            if model.any_damping and not model.opt.disable_eulerdamp:
                damp = [h * float(mc.dof_damping[i]) for i in range(nv)]
                l_mhb = chol_factor(fw["m_mat"], extra_diag=damp)
                qfrc_tot = [
                    add(fw["qfrc_smooth"][i], fw["qfrc_constraint"][i])
                    for i in range(nv)
                ]
                dv = chol_solve(l_mhb, qfrc_tot)
                qvel_new = [add(qvel[i], mul(h, dv[i])) for i in range(nv)]
            else:
                qvel_new = [add(qvel[i], mul(h, fw["qacc"][i]))
                            for i in range(nv)]
            qpos_new = integrate_pos_sg(qpos, qvel_new, h)
            act_new = advance_act_sg(act, fw["act_dot"], h)
            out = qpos_new, qvel_new, act_new, list(fw["qacc"])
            return out + (list(fw["qacc"]),) if want_qacc else out

    else:  # RK4 (mj_RungeKutta, N=4): 4 chained forward passes

        def step(qpos, qvel, act, warmstart, ctrl, eq_act=None, *,
                 mocap=None, qfrc_ext=None, xfrc_ext=None):
            qpos, qvel, act = list(qpos), list(qvel), list(act)
            ctrl = list(ctrl)
            ext = (mocap, qfrc_ext, xfrc_ext)
            fw = forward_pass(qpos, qvel, act, list(warmstart), ctrl, eq_act,
                              *ext)
            vels = [qvel]
            accs = [fw["qacc"]]
            adots = [fw["act_dot"]]
            A = ((0.5, 0.0, 0.0), (0.0, 0.5, 0.0), (0.0, 0.0, 1.0))
            B = (1.0 / 6.0, 1.0 / 3.0, 1.0 / 3.0, 1.0 / 6.0)
            for i in range(3):
                dq = [sum_scalars([mul(A[i][j], vels[j][k])
                                   for j in range(i + 1)])
                      for k in range(nv)]
                dv = [sum_scalars([mul(A[i][j], accs[j][k])
                                   for j in range(i + 1)])
                      for k in range(nv)]
                da = [sum_scalars([mul(A[i][j], adots[j][k])
                                   for j in range(i + 1)])
                      for k in range(na)]
                qpos_i = integrate_pos_sg(qpos, dq, h)
                qvel_i = [add(qvel[k], mul(h, dv[k])) for k in range(nv)]
                act_i = [add(act[k], mul(h, da[k])) for k in range(na)]
                # each stage warm-starts from the previous stage's qacc
                fw = forward_pass(qpos_i, qvel_i, act_i, list(fw["qacc"]),
                                  ctrl, eq_act, *ext)
                vels.append(qvel_i)
                accs.append(fw["qacc"])
                adots.append(fw["act_dot"])
            dq = [sum_scalars([mul(B[j], vels[j][k]) for j in range(4)])
                  for k in range(nv)]
            dv = [sum_scalars([mul(B[j], accs[j][k]) for j in range(4)])
                  for k in range(nv)]
            da = [sum_scalars([mul(B[j], adots[j][k]) for j in range(4)])
                  for k in range(na)]
            qpos_new = integrate_pos_sg(qpos, dq, h)
            qvel_new = [add(qvel[k], mul(h, dv[k])) for k in range(nv)]
            # the final act update goes through mj_advance (the exact
            # filter update with the RK-weighted derivative, the clamp)
            act_new = advance_act_sg(act, da, h)
            out = qpos_new, qvel_new, act_new, list(fw["qacc"])
            return out + (list(accs[0]),) if want_qacc else out

    return step


def build_fk(model: Model, bk):
    """Scalar-graph forward kinematics for the env hooks: the same
    ``_fk_chain`` the step computes, so frame-based rewards and
    observations read the step's own body frames.

    Returns ``fk(qpos, mocap=None) -> dict`` with ``xpos[b]``,
    ``xquat[b]``, ``xmat[b]`` (row-major 3x3), ``xipos[b]`` and
    ``site_xpos[s]`` as tuples of backend values; ``mocap`` poses the
    mocap bodies (see :func:`_fk_chain`).
    """
    mc = _ModelConsts(model)

    def fk(qpos, mocap=None):
        out = _fk_chain(bk, model, mc, None, list(qpos), com=False,
                        mocap=mocap)
        out["site_xpos"] = [
            vadd3(out["xpos"][b], mat_vec(out["xmat"][b],
                                          tuple(mc.site_pos[s])))
            for s, b in enumerate(model.site_bodyid)
        ]
        return out

    return fk


# ---------------------------------------------------------------------------
# in-kernel sensors (mj_sensorPos / mj_sensorVel / mj_sensorAcc)
# ---------------------------------------------------------------------------

# the sensor family the scalar graph evaluates from (qpos, qvel, qacc):
# kinematics, velocities, tendon and transmission state, and the
# accelerometer/frame-acceleration family from the cacc propagation.
# Touch, force, torque, rangefinder, subtree momenta, energies and the
# geometry-distance family stay on the general path.
_KERNEL_SENSORS = (
    SensorType.JOINTPOS, SensorType.JOINTVEL, SensorType.TENDONPOS,
    SensorType.TENDONVEL, SensorType.ACTUATORPOS, SensorType.ACTUATORVEL,
    SensorType.BALLQUAT, SensorType.BALLANGVEL,
    SensorType.FRAMEPOS, SensorType.FRAMEQUAT, SensorType.FRAMEXAXIS,
    SensorType.FRAMEYAXIS, SensorType.FRAMEZAXIS,
    SensorType.FRAMELINVEL, SensorType.FRAMEANGVEL,
    SensorType.FRAMELINACC, SensorType.FRAMEANGACC,
    SensorType.GYRO, SensorType.VELOCIMETER, SensorType.ACCELEROMETER,
    SensorType.MAGNETOMETER, SensorType.SUBTREECOM, SensorType.CLOCK,
)
# the sensors that read qacc: the previous step's stage-1 qacc, carried
_ACC_SENSORS = (
    SensorType.ACCELEROMETER, SensorType.FRAMELINACC,
    SensorType.FRAMEANGACC,
)
_FRAME_OBJ = (ObjType.SITE, ObjType.BODY, ObjType.XBODY, ObjType.GEOM)
_FRAME_SENSORS = (
    SensorType.FRAMEPOS, SensorType.FRAMEQUAT, SensorType.FRAMEXAXIS,
    SensorType.FRAMEYAXIS, SensorType.FRAMEZAXIS, SensorType.FRAMELINVEL,
    SensorType.FRAMEANGVEL, SensorType.FRAMELINACC, SensorType.FRAMEANGACC,
)
# sensors whose values are not clipped at their cutoff (unit quaternions
# and frame axes)
_NO_CUTOFF = (
    SensorType.BALLQUAT, SensorType.FRAMEQUAT, SensorType.FRAMEXAXIS,
    SensorType.FRAMEYAXIS, SensorType.FRAMEZAXIS,
)


def unsupported_sensor_reason(model: Model) -> str | None:
    """Why :func:`build_sensors` cannot evaluate the model's sensors
    (None if it can): every sensor in the kernel family, and frame
    sensors attached to (and referred to) sites, bodies or geoms."""
    for i in range(model.nsensor):
        st = SensorType(model.sensor_type[i])
        if st not in _KERNEL_SENSORS:
            return (f"sensor {i} ({st.name}) is outside the in-kernel "
                    "sensor family; it stays on the general path (ROADMAP "
                    "Queue A item 11)")
        if st not in _FRAME_SENSORS:
            continue
        frames = [("object", model.sensor_objtype[i])]
        if model.sensor_refid[i] >= 0:
            frames.append(("reference", model.sensor_reftype[i]))
        for kind, ot in frames:
            if ObjType(ot) not in _FRAME_OBJ:
                return (f"sensor {i} ({st.name}) has a {ObjType(ot).name} "
                        f"{kind} frame; frame sensors in the kernel read "
                        "sites, bodies and geoms, others stay on the "
                        "general path (ROADMAP Queue A item 11)")
    return None


def sensors_supported(model: Model) -> bool:
    """True if every sensor of the model is in the kernel family (see
    :func:`unsupported_sensor_reason`)."""
    return unsupported_sensor_reason(model) is None


def _sv_zero():
    return ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0))


def _sv_add(a, b):
    return (vadd3(a[0], b[0]), vadd3(a[1], b[1]))


def _sv_scale(a, s):
    return (vscale3(a[0], s), vscale3(a[1], s))


def _com_vel_sg(model, fk, qvel):
    """cvel per body and cdof_dot per dof (mj_comVel), in the general
    path's order."""
    cvel = [_sv_zero()] * model.nbody
    cdof_dot = [_sv_zero()] * model.nv
    cdof = fk["cdof"]
    for b in range(1, model.nbody):
        v = cvel[model.body_parentid[b]]
        for j in smooth.body_joints(model, b):
            jt = model.jnt_type[j]
            vadr = model.jnt_dofadr[j]
            if jt == JointType.FREE:
                for i in range(3):
                    v = _sv_add(v, _sv_scale(cdof[vadr + i], qvel[vadr + i]))
                for i in range(3):
                    cdof_dot[vadr + 3 + i] = motion_cross(
                        v, cdof[vadr + 3 + i])
                for i in range(3):
                    v = _sv_add(
                        v, _sv_scale(cdof[vadr + 3 + i], qvel[vadr + 3 + i]))
            elif jt == JointType.BALL:
                for i in range(3):
                    cdof_dot[vadr + i] = motion_cross(v, cdof[vadr + i])
                for i in range(3):
                    v = _sv_add(v, _sv_scale(cdof[vadr + i], qvel[vadr + i]))
            else:
                cdof_dot[vadr] = motion_cross(v, cdof[vadr])
                v = _sv_add(v, _sv_scale(cdof[vadr], qvel[vadr]))
        cvel[b] = v
    return cvel, cdof_dot


def _cacc_sg(model, fk, qvel, qacc, cdof_dot):
    """Body spatial accelerations with gravity (mj_rnePostConstraint's
    cacc) from ``qacc`` and the velocity stage's cdof_dot."""
    if model.opt.disable_gravity:
        a0 = _sv_zero()
    else:
        g = [float(x) for x in model.opt.gravity]
        a0 = ((0.0, 0.0, 0.0), (-g[0], -g[1], -g[2]))
    cdof = fk["cdof"]
    cacc = [a0] * model.nbody
    for b in range(1, model.nbody):
        a = cacc[model.body_parentid[b]]
        adr, num = model.body_dofadr[b], model.body_dofnum[b]
        for i in range(adr, adr + num):
            a = _sv_add(a, _sv_add(_sv_scale(cdof_dot[i], qvel[i]),
                                   _sv_scale(cdof[i], qacc[i])))
        cacc[b] = a
    return cacc


def _point_vel_sg(model, fk, cvel, b, p):
    """(omega, v): world velocity of point p on body b
    (mj_objectVelocity, flg_local = 0)."""
    o = fk["subtree_com"][model.body_rootid[b]]
    w, vl = cvel[b]
    return w, vadd3(vl, cross3(w, vsub3(p, o)))


def _point_acc_sg(model, fk, cvel, cacc, b, p):
    """(alpha, a): world acceleration of point p on body b
    (mj_objectAcceleration: the spatial transform plus omega x v)."""
    o = fk["subtree_com"][model.body_rootid[b]]
    alpha, al = cacc[b]
    a = vadd3(al, cross3(alpha, vsub3(p, o)))
    w, v = _point_vel_sg(model, fk, cvel, b, p)
    return alpha, vadd3(a, cross3(w, v))


def _obj_pose_sg(model, mc, fk, objtype, oid):
    """(pos, mat as a row-major 9-tuple, body id) of a frame sensor's
    site, geom, body (inertial frame) or xbody (body frame)."""
    ot = ObjType(objtype)
    if ot in (ObjType.SITE, ObjType.GEOM):
        b, lpos, lquat = ((model.site_bodyid[oid], mc.site_pos[oid],
                           mc.site_quat[oid]) if ot == ObjType.SITE else
                          (model.geom_bodyid[oid], mc.geom_pos[oid],
                           mc.geom_quat[oid]))
        pos = vadd3(fk["xpos"][b], mat_vec(fk["xmat"][b], tuple(lpos)))
        return pos, _mat_mul_const(fk["xmat"][b],
                                   quat_to_mat(tuple(lquat))), b
    if ot == ObjType.BODY:
        mat = _mat_mul_const(fk["xmat"][oid],
                             quat_to_mat(tuple(mc.body_iquat[oid])))
        return fk["xipos"][oid], mat, oid
    return fk["xpos"][oid], fk["xmat"][oid], oid


def _obj_quat_sg(model, mc, fk, objtype, oid):
    """World orientation of a frame sensor's object (not normalized)."""
    ot = ObjType(objtype)
    if ot == ObjType.SITE:
        return qmul(fk["xquat"][model.site_bodyid[oid]],
                    tuple(mc.site_quat[oid]))
    if ot == ObjType.GEOM:
        return qmul(fk["xquat"][model.geom_bodyid[oid]],
                    tuple(mc.geom_quat[oid]))
    if ot == ObjType.BODY:
        return qmul(fk["xquat"][oid], tuple(mc.body_iquat[oid]))
    return fk["xquat"][oid]


def _qconj(q):
    return (q[0], neg(q[1]), neg(q[2]), neg(q[3]))


def _act_len_vel(bk, model, mc, u, fk, bd_mask, qpos, qvel, ten):
    """(length, velocity) of actuator ``u`` (mj_transmission): the length
    from :func:`_transmission`, the velocity as its moment . qvel; a
    tendon transmission scales the tendon's own length and velocity."""
    if TrnType(model.actuator_trntype[u]) == TrnType.TENDON:
        t = model.actuator_trnid[u]
        gear = float(mc.actuator_gear[u][0])
        return mul(gear, ten[0][t]), mul(gear, ten[2][t])
    moment, length = _transmission(bk, model, mc, u, fk, bd_mask, qpos, ten,
                                   True)
    return length, _jdotv(moment, qvel)


def build_sensors(model: Model, bk):
    """Scalar-graph sensors on backend ``bk``.

    Returns ``sens(qpos, qvel, qacc=None, time=None, mocap=None) -> list``
    of ``model.nsensordata`` values, element for element with the reference's
    ``build_sensors`` (the general path's sensor_pos/vel/acc) for the
    kernel family (:func:`sensors_supported`), cutoffs included.  ``qacc``
    is the acceleration the accelerometer family reads (the step's
    stage-1 qacc: mj_step computes sensors before integrating, so the
    values after step k read step k's entry state); ``time`` feeds CLOCK;
    ``mocap`` poses the mocap bodies (see :func:`_fk_chain`).
    """
    reason = unsupported_sensor_reason(model)
    if reason is not None:
        raise ValueError(reason)
    mc = _ModelConsts(model)
    sub_mask = smooth.subtree_mask(model)
    bd_mask = smooth.body_dof_mask(model)
    types = [SensorType(t) for t in model.sensor_type]
    need_vel = any(
        t in (SensorType.VELOCIMETER, SensorType.GYRO,
              SensorType.FRAMELINVEL, SensorType.FRAMEANGVEL)
        or t in _ACC_SENSORS for t in types)
    need_acc = any(t in _ACC_SENSORS for t in types)
    need_ten = any(
        t in (SensorType.TENDONPOS, SensorType.TENDONVEL)
        or t in (SensorType.ACTUATORPOS, SensorType.ACTUATORVEL)
        and TrnType(model.actuator_trntype[model.sensor_objid[i]])
        == TrnType.TENDON for i, t in enumerate(types))
    cutoff = [float(x) for x in _np(model.sensor_cutoff)] if types else []

    def sens(qpos, qvel, qacc=None, time=None, mocap=None):
        qpos, qvel = list(qpos), list(qvel)
        fk = _fk_chain(bk, model, mc, sub_mask, qpos, mocap=mocap)
        cvel = cdof_dot = cacc = ten = None
        if need_vel:
            cvel, cdof_dot = _com_vel_sg(model, fk, qvel)
        if need_acc:
            if qacc is None:
                raise ValueError("acceleration sensors need qacc")
            cacc = _cacc_sg(model, fk, qvel, list(qacc), cdof_dot)
        if need_ten:
            ten = _tendon_len_mom_sg(bk, model, mc, qpos, qvel, fk, bd_mask)
        out = [0.0] * model.nsensordata
        for i, st in enumerate(types):
            oid, rid = model.sensor_objid[i], model.sensor_refid[i]
            ot, rt = model.sensor_objtype[i], model.sensor_reftype[i]
            if st == SensorType.JOINTPOS:
                val = [qpos[model.jnt_qposadr[oid]]]
            elif st == SensorType.JOINTVEL:
                val = [qvel[model.jnt_dofadr[oid]]]
            elif st == SensorType.TENDONPOS:
                val = [ten[0][oid]]
            elif st == SensorType.TENDONVEL:
                val = [ten[2][oid]]
            elif st in (SensorType.ACTUATORPOS, SensorType.ACTUATORVEL):
                length, vel = _act_len_vel(bk, model, mc, oid, fk, bd_mask,
                                           qpos, qvel, ten)
                val = [length if st == SensorType.ACTUATORPOS else vel]
            elif st == SensorType.BALLQUAT:
                q = model.jnt_qposadr[oid]
                val = list(qnormalize(bk, tuple(qpos[q:q + 4])))
            elif st == SensorType.BALLANGVEL:
                v = model.jnt_dofadr[oid]
                val = qvel[v:v + 3]
            elif st == SensorType.FRAMEPOS:
                pos, _, _ = _obj_pose_sg(model, mc, fk, ot, oid)
                if rid >= 0:
                    rpos, rmat, _ = _obj_pose_sg(model, mc, fk, rt, rid)
                    val = list(mat_vec_t(rmat, vsub3(pos, rpos)))
                else:
                    val = list(pos)
            elif st == SensorType.FRAMEQUAT:
                q = _obj_quat_sg(model, mc, fk, ot, oid)
                if rid >= 0:
                    q = qmul(_qconj(_obj_quat_sg(model, mc, fk, rt, rid)), q)
                val = list(qnormalize(bk, q))
            elif st in (SensorType.FRAMEXAXIS, SensorType.FRAMEYAXIS,
                        SensorType.FRAMEZAXIS):
                _, mat, _ = _obj_pose_sg(model, mc, fk, ot, oid)
                axis = mat_col(mat, int(st) - int(SensorType.FRAMEXAXIS))
                if rid >= 0:
                    _, rmat, _ = _obj_pose_sg(model, mc, fk, rt, rid)
                    axis = mat_vec_t(rmat, axis)
                val = list(axis)
            elif st == SensorType.SUBTREECOM:
                val = list(fk["subtree_com"][oid])
            elif st == SensorType.MAGNETOMETER:
                _, smat, _ = _obj_pose_sg(model, mc, fk, ObjType.SITE, oid)
                mag = tuple(float(x) for x in model.opt.magnetic)
                val = list(mat_vec_t(smat, mag))
            elif st in (SensorType.VELOCIMETER, SensorType.GYRO):
                spos, smat, b = _obj_pose_sg(model, mc, fk, ObjType.SITE,
                                             oid)
                if st == SensorType.VELOCIMETER:
                    vec = _point_vel_sg(model, fk, cvel, b, spos)[1]
                else:
                    vec = _point_vel_sg(model, fk, cvel, b,
                                        (0.0, 0.0, 0.0))[0]
                val = list(mat_vec_t(smat, vec))
            elif st in (SensorType.FRAMELINVEL, SensorType.FRAMEANGVEL):
                pos, _, b = _obj_pose_sg(model, mc, fk, ot, oid)
                w, v = _point_vel_sg(model, fk, cvel, b, pos)
                lin = st == SensorType.FRAMELINVEL
                if rid >= 0:
                    rpos, rmat, rb = _obj_pose_sg(model, mc, fk, rt, rid)
                    rw, rv = _point_vel_sg(model, fk, cvel, rb, rpos)
                    rel = (vsub3(vsub3(v, rv), cross3(rw, vsub3(pos, rpos)))
                           if lin else vsub3(w, rw))
                    val = list(mat_vec_t(rmat, rel))
                else:
                    val = list(v if lin else w)
            elif st == SensorType.ACCELEROMETER:
                spos, smat, b = _obj_pose_sg(model, mc, fk, ObjType.SITE,
                                             oid)
                _, a = _point_acc_sg(model, fk, cvel, cacc, b, spos)
                val = list(mat_vec_t(smat, a))
            elif st == SensorType.FRAMELINACC:
                pos, _, b = _obj_pose_sg(model, mc, fk, ot, oid)
                val = list(_point_acc_sg(model, fk, cvel, cacc, b, pos)[1])
            elif st == SensorType.FRAMEANGACC:
                _, _, b = _obj_pose_sg(model, mc, fk, ot, oid)
                val = list(cacc[b][0])
            else:  # CLOCK
                if time is None:
                    raise ValueError("the clock sensor needs time")
                val = [time]
            if cutoff[i] > 0 and st not in _NO_CUTOFF:
                val = [bk.clip(x, -cutoff[i], cutoff[i]) for x in val]
            adr = model.sensor_adr[i]
            out[adr:adr + len(val)] = val
        return out

    return sens


# ---------------------------------------------------------------------------
# equality rows
# ---------------------------------------------------------------------------


def _eq_cw_rows_sg(model, mc, fk, bd_mask, eqs):
    """Connect and weld rows of the equalities ``eqs`` from an fk dict:
    {eq_id: [(J dict, pos, dap), ...]}, the scalar form of the general
    path's constraint._eq_cw_rows.  Run on the Duals of the tangent pass,
    every J entry and pos carries its time derivative."""
    if not eqs:
        return {}
    xpos, xmat, xquat = fk["xpos"], fk["xmat"], fk["xquat"]
    subtree_com, cdof = fk["subtree_com"], fk["cdof"]

    def trans_rows(p1, b1, p2, b2):
        j1 = _point_jac_sg(model, cdof, subtree_com, bd_mask, p1, b1)
        j2 = _point_jac_sg(model, cdof, subtree_com, bd_mask, p2, b2)
        cpos = vsub3(p1, p2)
        dap = float(mc.body_invweight0[b1][0] + mc.body_invweight0[b2][0])
        out = []
        for i in range(3):
            J = {dof: v[i] for dof, v in j1.items()}
            for dof, v in j2.items():
                J[dof] = sub(J.get(dof, 0.0), v[i])
            out.append((J, cpos[i], dap))
        return out

    out = {}
    for e in eqs:
        b1 = model.eq_obj1id[e]
        b2 = max(model.eq_obj2id[e], 0)
        data = [float(x) for x in mc.eq_data[e]]
        if EqType(model.eq_type[e]) == EqType.CONNECT:
            out[e] = trans_rows(
                vadd3(xpos[b1], mat_vec(xmat[b1], tuple(data[:3]))), b1,
                vadd3(xpos[b2], mat_vec(xmat[b2], tuple(data[3:6]))), b2)
            continue
        # weld: 3 translation rows, then 3 rotation rows with
        # pos = -ts vec(conj(q1 relquat) q2) and
        # J = -ts/2 V (jacr2 - jacr1), V[:, k] = vec(conj(A) e_k q2)
        rq = np.asarray(data[6:10])
        nrm = float(np.linalg.norm(rq))
        relquat = tuple((rq / nrm if nrm > 0 else [1.0, 0, 0, 0]).tolist())
        ts = data[10]
        rows_e = trans_rows(
            vadd3(xpos[b1], mat_vec(xmat[b1], tuple(data[3:6]))), b1,
            vadd3(xpos[b2], mat_vec(xmat[b2], tuple(data[:3]))), b2)
        q1, q2 = xquat[b1], xquat[b2]
        conj_a = tuple(neg(x) if i else x
                       for i, x in enumerate(qmul(q1, relquat)))
        crot = vscale3(qmul(conj_a, q2)[1:4], -ts)
        v_cols = []
        for kk in range(3):
            e_k = tuple(1.0 if i == kk + 1 else 0.0 for i in range(4))
            v_cols.append(qmul(qmul(conj_a, e_k), q2)[1:4])
        # the angular cdof difference (b2 - b1)
        jr = {}
        for dof in range(model.nv):
            a2 = cdof[dof][0] if bd_mask[b2, dof] else None
            a1 = cdof[dof][0] if bd_mask[b1, dof] else None
            if a2 is None and a1 is None:
                continue
            if a2 is None:
                jr[dof] = tuple(neg(x) for x in a1)
            elif a1 is None:
                jr[dof] = a2
            else:
                jr[dof] = vsub3(a2, a1)
        dap_r = float(mc.body_invweight0[b1][1] + mc.body_invweight0[b2][1])
        for i in range(3):
            J = {}
            for dof, av in jr.items():
                s = 0.0
                for kk in range(3):
                    s = fma(s, v_cols[kk][i], av[kk])
                J[dof] = mul(-0.5 * ts, s)
            rows_e.append((J, crot[i], dap_r))
        out[e] = rows_e
    return out


def _qpos_tangent_sg(model, qpos, qvel):
    """d(qpos)/dt on the manifold, per coordinate: scalar joints copy
    qvel, a ball or free joint's quaternion moves as 0.5 q (0, w)."""
    out = list(qpos)
    for j in range(model.njnt):
        qadr = model.jnt_qposadr[j]
        vadr = model.jnt_dofadr[j]
        if model.jnt_type[j] in (JointType.HINGE, JointType.SLIDE):
            out[qadr] = qvel[vadr]
            continue
        if model.jnt_type[j] == JointType.BALL:
            q = tuple(qpos[qadr + i] for i in range(4))
            w = (0.0,) + tuple(qvel[vadr + i] for i in range(3))
            qd = qmul(q, w)
            for i in range(4):
                out[qadr + i] = mul(0.5, qd[i])
            continue
        for i in range(3):
            out[qadr + i] = qvel[vadr + i]
        q = tuple(qpos[qadr + 3 + i] for i in range(4))
        w = (0.0,) + tuple(qvel[vadr + 3 + i] for i in range(3))
        qd = qmul(q, w)
        for i in range(4):
            out[qadr + 3 + i] = mul(0.5, qd[i])
    return out


def _qpos_duals(model, qpos, qvel):
    """qpos as the leaves of the tangent pass: Duals whose tangent is
    :func:`_qpos_tangent_sg`'s, built on first demand."""
    memo = []

    def tan(i):
        if not memo:
            memo.append(_qpos_tangent_sg(model, qpos, qvel))
        return memo[0][i]

    return [Dual(q, lambda i=i: tan(i)) for i, q in enumerate(qpos)]


def _horner(poly, x):
    """(p(x), p'(x)) of the quartic ``poly`` (lowest order first)."""
    pval, dval = poly[4], 0.0
    for c in (poly[3], poly[2], poly[1], poly[0]):
        dval = fma(pval, dval, x)
        pval = fma(c, pval, x)
    return pval, dval


def _eq_rows(bk, model, mc, qpos, qvel, bd_mask, h, ten, eq_act, fk_d):
    """Equality rows (mjCNSTR_EQUALITY) in equality order, kind ``eq``.

    Without ``eq_act`` only the equalities active at build time
    (eq_active0) get rows, which always exist; with it (one bool lane per
    equality, Data.eq_active) every equality gets rows that exist where
    its lane is set.  Joint and tendon rows couple two coordinates through
    a quartic; connect and weld rows read ``fk_d``, the step's FK run on
    Duals, for the Gauss-Newton term Jdot qvel of their aref (the
    reference's jax.jvp), and take their impedance on the norm of the
    whole residual."""
    on = [e for e in range(model.neq)
          if eq_act is not None or model.eq_active0[e]]
    cw = _eq_cw_rows_sg(model, mc, fk_d, bd_mask, [
        e for e in on
        if EqType(model.eq_type[e]) in (EqType.CONNECT, EqType.WELD)])
    vel_d = {e: [_jdotv(J, qvel) for (J, _, _) in cw[e]] for e in cw}
    acc0 = iter(tangents([v for e in cw for v in vel_d[e]]))
    ten_len, ten_mom, _ = ten
    rows = []
    for e in on:
        et = EqType(model.eq_type[e])
        poly = [float(x) for x in mc.eq_data[e][:5]]
        o1, o2 = model.eq_obj1id[e], model.eq_obj2id[e]
        if et == EqType.JOINT:
            a1, v1 = model.jnt_qposadr[o1], model.jnt_dofadr[o1]
            dif1 = sub(qpos[a1], float(mc.qpos0[a1]))
            if o2 >= 0:
                a2, v2 = model.jnt_qposadr[o2], model.jnt_dofadr[o2]
                pval, dval = _horner(poly, sub(qpos[a2], float(mc.qpos0[a2])))
                parts = [({v1: 1.0, v2: neg(dval)}, sub(dif1, pval),
                          float(mc.dof_invweight0[v1]
                                + mc.dof_invweight0[v2]))]
            else:
                parts = [({v1: 1.0}, sub(dif1, poly[0]),
                          float(mc.dof_invweight0[v1]))]
        elif et == EqType.TENDON:
            dif1 = sub(ten_len[o1], float(mc.tendon_length0[o1]))
            J = dict(ten_mom[o1])
            if o2 >= 0:
                pval, dval = _horner(
                    poly, sub(ten_len[o2], float(mc.tendon_length0[o2])))
                for dof, v2 in ten_mom[o2].items():
                    J[dof] = sub(J.get(dof, 0.0), mul(dval, v2))
                parts = [(J, sub(dif1, pval),
                          float(mc.tendon_invweight0[o1]
                                + mc.tendon_invweight0[o2]))]
            else:
                parts = [(J, sub(dif1, poly[0]),
                          float(mc.tendon_invweight0[o1]))]
        else:
            parts = [(_primal(J), _primal(p), dap)
                     for (J, p, dap) in cw[e]]
        if et in (EqType.JOINT, EqType.TENDON):
            k, b, imp = _kbi_const(bk, mc.eq_solref[e], mc.eq_solimp[e],
                                   parts[0][1], h)
            vels = [_jdotv(parts[0][0], qvel)]
            accs = [0.0]
        else:
            res2 = 0.0
            for (_, p, _) in parts:
                res2 = fma(res2, p, p)
            k, b, imp = _kbi_const(bk, mc.eq_solref[e], mc.eq_solimp[e],
                                   bk.sqrt(bk.maximum(res2, 0.0)), h)
            vels = [v.v if isinstance(v, Dual) else v for v in vel_d[e]]
            accs = [next(acc0) for _ in parts]
        for (J, pos, dap), vel, a0 in zip(parts, vels, accs):
            aref = -b * vel - k * imp * pos
            if not (_is_const(a0) and a0 == 0.0):
                aref = aref - a0
            rows.append(dict(J=J, pos=pos, aref=aref,
                             D=imp / (1.0 - imp) / max(dap, 1e-12),
                             exists=True if eq_act is None else eq_act[e],
                             kind="eq"))
    return rows


# ---------------------------------------------------------------------------
# constraint rows + Newton (scalar-graph form)
# ---------------------------------------------------------------------------


def _kbi_zero_pos(solref, solimp, h):
    """(b, imp) python constants for rows whose pos is identically 0
    (friction rows, whose aref has no stiffness term): x = 0 puts the
    impedance at dmin."""
    dmin = min(max(float(solimp[0]), 0.0001), 0.9999)
    dmax = min(max(float(solimp[1]), 0.0001), 0.9999)
    tc = max(float(solref[0]), 2.0 * h)
    return 2.0 / (dmax * tc), dmin


def _kbi_const(bk, solref, solimp, pos, h):
    """Impedance/aref transform with constant solref/solimp and traced pos;
    dmin/dmax are clamped into [mjMINIMP, mjMAXIMP] as MuJoCo does."""
    dmin, dmax, width, mid, power = (float(x) for x in solimp)
    dmin = min(max(dmin, 0.0001), 0.9999)
    dmax = min(max(dmax, 0.0001), 0.9999)
    mid = min(max(mid, 0.0001), 0.9999)
    power = max(power, 1.0)
    timeconst, dampratio = (float(x) for x in solref)
    tc = max(timeconst, 2.0 * h)
    b_coef = 2.0 / (dmax * tc)
    k_coef = 1.0 / (dmax * dmax * tc * tc * dampratio * dampratio)

    x = bk.abs(pos) * (1.0 / width if width > 0 else 1.0)
    x = bk.clip(x, 0.0, 1.0)
    a_c = 1.0 / mid ** (power - 1.0)
    b_c = 1.0 / (1.0 - mid) ** (power - 1.0)
    if power == 2.0:
        y = bk.where(x < mid, a_c * x * x,
                     1.0 - b_c * (1.0 - x) * (1.0 - x))
    else:
        y = bk.where(
            x < mid,
            a_c * bk.pow(x, power),
            1.0 - b_c * bk.pow(1.0 - x, power),
        )
    imp = dmin + y * (dmax - dmin)
    return k_coef, b_coef, imp


def _assemble_rows(bk, model, mc, qpos, qvel, xpos, xmat, subtree_com, cdof,
                   bd_mask, h, ten, eq_act=None, fk_d=None):
    """Equality, friction-loss, limit and contact rows as dicts with a
    sparse J, in MuJoCo's row order: equality, dof friction, tendon
    friction, joint limits, ball limits, tendon limits, contacts.  ``ten``
    is the step's tendon (lengths, moments, velocities); ``eq_act`` and
    ``fk_d`` are :func:`_eq_rows`'.  Row kinds:

    * ``eq`` (equality): f = -D jar where the row exists;
    * ``uni`` (limits, pyramid facets): f = max(-D jar, 0) on existing rows;
    * ``fri`` (friction loss, box-bounded): f = clip(-D jar, -floss, floss).

    Returns ``(rows, cones)``: under elliptic cones each contact at condim
    > 1 is one cone group instead of pyramid facets (a dict with ``J``, a
    list of condim sparse rows, per-row ``D`` and ``aref``, ``exists`` and
    the mu constants), which the Newton solver handles through
    :func:`_cone_force_sg`, :func:`_cone_cost_sg` and
    :func:`_cone_hess_sg`.
    """
    elliptic = model.opt.cone == ConeType.ELLIPTIC
    rows, cones = [], []
    if model.neq:
        rows += _eq_rows(bk, model, mc, qpos, qvel, bd_mask, h, ten, eq_act,
                         fk_d)
    ten_len, ten_mom, ten_vel = ten

    # dof friction loss (mjCNSTR_FRICTION_DOF): pos = 0 is a build-time
    # constant, so the impedance folds to dmin
    if not model.opt.disable_frictionloss:
        for i in range(model.nv):
            floss = float(mc.dof_frictionloss[i])
            if floss <= 0:
                continue
            b, imp = _kbi_zero_pos(mc.dof_solref[i], mc.dof_solimp[i], h)
            aref = mul(-b, qvel[i])
            dcoef = imp / (1.0 - imp) / max(float(mc.dof_invweight0[i]),
                                            1e-12)
            rows.append(dict(J={i: 1.0}, pos=0.0, aref=aref, D=dcoef,
                             exists=True, kind="fri", floss=floss))
        # tendon friction loss (mjCNSTR_FRICTION_TENDON)
        for t in range(model.ntendon):
            floss = float(mc.tendon_frictionloss[t])
            if floss <= 0:
                continue
            b, imp = _kbi_zero_pos(mc.tendon_solref_fri[t],
                                   mc.tendon_solimp_fri[t], h)
            aref = mul(-b, ten_vel[t])
            dcoef = imp / (1.0 - imp) / max(
                float(mc.tendon_invweight0[t]), 1e-12)
            rows.append(dict(J=dict(ten_mom[t]), pos=0.0, aref=aref,
                             D=dcoef, exists=True, kind="fri", floss=floss))

    # scalar joint limits
    for j in range(model.njnt):
        if model.opt.disable_limit or not model.jnt_limited[j]:
            continue
        if model.jnt_type[j] not in (JointType.HINGE, JointType.SLIDE):
            continue  # free joints cannot be limited
        qadr = model.jnt_qposadr[j]
        vadr = model.jnt_dofadr[j]
        lo, hi = (float(x) for x in mc.jnt_range[j])
        margin = float(mc.jnt_margin[j])
        q = qpos[qadr]
        dist_lo = q - lo
        dist_hi = hi - q
        dist = bk.minimum(dist_lo, dist_hi)
        sign = bk.where(dist_lo < dist_hi, 1.0, -1.0)
        exists = dist < margin
        pos = bk.where(exists, dist - margin, 0.0)
        k, b, imp = _kbi_const(bk, mc.jnt_solref[j], mc.jnt_solimp[j], pos, h)
        vel = mul(sign, qvel[vadr])
        aref = -b * vel - k * imp * pos
        dcoef = imp / (1.0 - imp) / max(float(mc.dof_invweight0[vadr]),
                                        1e-12)
        rows.append(dict(J={vadr: sign}, pos=pos, aref=aref, D=dcoef,
                         exists=exists, kind="uni"))

    # ball joint limits: one row per limited ball joint on the rotation
    # angle, wrapped to (-pi, pi], against max(range); J = -axis
    for j in range(model.njnt):
        if (model.opt.disable_limit or not model.jnt_limited[j]
                or model.jnt_type[j] != JointType.BALL):
            continue
        qadr = model.jnt_qposadr[j]
        vadr = model.jnt_dofadr[j]
        q = qnormalize(bk, tuple(qpos[qadr + k] for k in range(4)))
        sin_half = bk.sqrt(bk.maximum(
            add(add(mul(q[1], q[1]), mul(q[2], q[2])), mul(q[3], q[3])),
            0.0))
        angle = 2.0 * atan2_sg(bk, sin_half, q[0])
        angle = bk.where(angle > math.pi, angle - 2.0 * math.pi, angle)
        has_axis = sin_half > 1e-12
        safe = bk.where(has_axis, sin_half, 1.0)
        sgn = bk.sign(bk.where(bk.eq(angle, 0.0), 1.0, angle))
        axis = [bk.where(has_axis, q[1 + k] / safe, 1.0 if k == 2 else 0.0)
                * sgn for k in range(3)]
        dist = float(max(mc.jnt_range[j])) - bk.abs(angle)
        margin = float(mc.jnt_margin[j])
        exists = dist < margin
        pos = bk.where(exists, dist - margin, 0.0)
        k, b, imp = _kbi_const(bk, mc.jnt_solref[j], mc.jnt_solimp[j], pos, h)
        J = {vadr + kk: neg(axis[kk]) for kk in range(3)}
        aref = -b * _jdotv(J, qvel) - k * imp * pos
        dcoef = imp / (1.0 - imp) / max(float(mc.dof_invweight0[vadr]),
                                        1e-12)
        rows.append(dict(J=J, pos=pos, aref=aref, D=dcoef, exists=exists,
                         kind="uni"))

    # tendon limits (mjCNSTR_LIMIT_TENDON): joint-limit rows on the tendon
    # length, J = +-moment row
    if not model.opt.disable_limit:
        for t in range(model.ntendon):
            if not model.tendon_limited[t]:
                continue
            lo, hi = (float(x) for x in mc.tendon_range[t])
            margin = float(mc.tendon_margin[t])
            L = ten_len[t]
            dist_lo = L - lo
            dist_hi = hi - L
            dist = bk.minimum(dist_lo, dist_hi)
            sign = bk.where(dist_lo < dist_hi, 1.0, -1.0)
            exists = dist < margin
            pos = bk.where(exists, dist - margin, 0.0)
            k, b, imp = _kbi_const(bk, mc.tendon_solref_lim[t],
                                   mc.tendon_solimp_lim[t], pos, h)
            vel = mul(sign, ten_vel[t])
            aref = -b * vel - k * imp * pos
            dcoef = imp / (1.0 - imp) / max(
                float(mc.tendon_invweight0[t]), 1e-12)
            J = {dof: mul(sign, m) for dof, m in ten_mom[t].items()}
            rows.append(dict(J=J, pos=pos, aref=aref, D=dcoef,
                             exists=exists, kind="uni"))

    # contacts: static pair table; per pair type a closed-form scalar
    # narrowphase yields a fixed number of (dist, pos, normal, t1|None)
    # candidate lanes
    lane = 0
    for (t1, t2, pairs) in model.pair_groups:
        ta, tb = GeomType(t1), GeomType(t2)
        kmax = max_contacts_per_pair(t1, t2)
        for (g1, g2) in pairs:
            pidx = _lane_to_pair(model, lane)
            b1 = model.geom_bodyid[g1]
            b2 = model.geom_bodyid[g2]
            condim = model.pair_condim[pidx]
            friction = mc.pair_friction[pidx]
            solref = mc.pair_solref[pidx]
            solimp = mc.pair_solimp[pidx]
            inclmargin = float(mc.pair_margin[pidx] - mc.pair_gap[pidx])
            iw = float(mc.body_invweight0[b1][0] + mc.body_invweight0[b2][0])

            cands = _np_contacts_sg(bk, model, mc, ta, tb, g1, g2, xpos, xmat)
            assert len(cands) == kmax, (ta, tb, len(cands), kmax)

            for (dist, cpos, n, t1u) in cands:
                exists = dist < inclmargin
                posr = bk.where(exists, sub(dist, inclmargin), 0.0)
                # tangent frame
                if t1u is None:
                    t1f, t2f = _make_frame_scalar(bk, n)
                else:
                    t1f = t1u
                    t2f = cross3(n, t1f)
                # relative jacobian (body2 - body1) at cpos
                jrows = _point_jac_rel(
                    model, cdof, subtree_com, bd_mask, cpos, b1, b2
                )  # dict dof -> vec3
                jn = {dof: dot3(n, v) for dof, v in jrows.items()}
                k, b_, imp = _kbi_const(bk, solref, solimp, posr, h)
                dapn = imp / (1.0 - imp)
                if condim == 1:
                    vel = _jdotv(jn, qvel)
                    aref = -b_ * vel - k * imp * posr
                    rows.append(dict(J=jn, pos=posr, aref=aref,
                                     D=dapn / max(iw, 1e-12),
                                     exists=exists, kind="uni"))
                    lane += 1
                    continue
                axes = _friction_axes(model, cdof, bd_mask, b1, b2, jrows,
                                      (n, t1f, t2f), friction, condim)
                mu0 = float(friction[0])
                if elliptic:
                    # one cone group [normal; axes] with plain (un-mu-scaled)
                    # Jacobians: D_i = D0 impratio (mu_i/mu0)^2, friction
                    # aref = -b vel
                    d0 = dapn / max(iw, 1e-12)
                    impr = float(model.opt.impratio)
                    cones.append(dict(
                        J=[jn] + [jt for (jt, _) in axes],
                        D=[d0] + [d0 * impr * (mu / mu0) ** 2
                                  for (_, mu) in axes],
                        aref=[-b_ * _jdotv(jn, qvel) - k * imp * posr]
                        + [mul(-b_, _jdotv(jt, qvel)) for (jt, _) in axes],
                        pos=posr, exists=exists,
                        mu=tuple(mu for (_, mu) in axes), mu0=mu0,
                        impratio=impr))
                else:
                    # pyramidal facets, two per axis; the diagApprox of
                    # every facet uses friction[0]
                    dap = iw * 2.0 * mu0 * mu0 * (1.0 + mu0 * mu0)
                    for (jt, mu) in axes:
                        for sgn in (1.0, -1.0):
                            J = dict(jn)
                            for dof, val in jt.items():
                                J[dof] = add(J.get(dof, 0.0),
                                             mul(sgn * mu, val))
                            vel = _jdotv(J, qvel)
                            aref = -b_ * vel - k * imp * posr
                            rows.append(dict(J=J, pos=posr, aref=aref,
                                             D=dapn / max(dap, 1e-12),
                                             exists=exists, kind="uni"))
                lane += 1
    return rows, cones


def _friction_axes(model, cdof, bd_mask, b1, b2, jrows, frame, friction,
                   condim):
    """[(J dict, mu)] of one contact's friction axes: the two tangents of
    ``frame`` = (n, t1, t2) on the point Jacobian ``jrows``, then the
    torsional spin about n (condim >= 4) and the two rolling axes (condim
    6) on the relative rotational Jacobian."""
    n, t1f, t2f = frame
    axes = [({dof: dot3(t1f, v) for dof, v in jrows.items()},
             float(friction[0])),
            ({dof: dot3(t2f, v) for dof, v in jrows.items()},
             float(friction[1]))]
    if condim >= 4:
        jrot = _rot_jac_rel(model, cdof, bd_mask, b1, b2)
        for (ax, mu) in ((n, friction[2]), (t1f, friction[3]),
                         (t2f, friction[4]))[:condim - 3]:
            axes.append(({dof: dot3(ax, av) for dof, av in jrot.items()},
                         float(mu)))
    return axes


def _np_contacts_sg(bk, model, mc, ta, tb, g1, g2, xpos, xmat):
    """Scalar narrowphase for one candidate pair: list of ``(dist, pos,
    normal, t1|None)`` lanes, len == max_contacts_per_pair.  Normals point
    geom1 -> geom2."""
    p1 = _geom_pos(model, mc, g1, xpos, xmat)
    m1 = _geom_mat(model, mc, g1, xmat)
    p2 = _geom_pos(model, mc, g2, xpos, xmat)
    m2 = _geom_mat(model, mc, g2, xmat)
    s1 = [float(x) for x in mc.geom_size[g1]]
    s2 = [float(x) for x in mc.geom_size[g2]]

    if ta == GeomType.PLANE and tb == GeomType.SPHERE:
        n = mat_col(m1, 2)
        r = s2[0]
        dist = sub(dot3(n, p2), add(dot3(n, p1), r))
        pos = vsub3(p2, vscale3(n, add(r, mul(0.5, dist))))
        return [(dist, pos, n, None)]

    if ta == GeomType.PLANE and tb == GeomType.CAPSULE:
        n = mat_col(m1, 2)
        r, hl = s2[0], s2[1]
        axis = mat_col(m2, 2)
        # frame tangent along the capsule axis projection (mjc_PlaneCapsule)
        t1v = vsub3(axis, vscale3(n, dot3(n, axis)))
        t1n = bk.sqrt(bk.maximum(dot3(t1v, t1v), 1e-20))
        altv = mat_col(m2, 0)
        alt = vsub3(altv, vscale3(n, dot3(n, altv)))
        altn = bk.sqrt(bk.maximum(dot3(alt, alt), 1e-20))
        use_alt = t1n < 1e-10
        t1u = tuple(
            bk.where(use_alt, a_ / altn, t_ / t1n)
            for t_, a_ in zip(t1v, alt)
        )
        out = []
        for sgn in (1.0, -1.0):
            point = vadd3(p2, vscale3(axis, sgn * hl))
            dist = sub(dot3(n, point), add(dot3(n, p1), r))
            pos = vsub3(point, vscale3(n, add(r, mul(0.5, dist))))
            out.append((dist, pos, n, t1u))
        return out

    if ta == GeomType.PLANE and tb == GeomType.BOX:
        # all 8 corners (collision._plane_box, lane for lane)
        n = mat_col(m1, 2)
        pn = dot3(n, p1)
        out = []
        for sx in (-1.0, 1.0):
            for sy in (-1.0, 1.0):
                for sz in (-1.0, 1.0):
                    local = (sx * s2[0], sy * s2[1], sz * s2[2])
                    corner = vadd3(p2, mat_vec(m2, local))
                    dist = sub(dot3(n, corner), pn)
                    pos = vsub3(corner, vscale3(n, mul(0.5, dist)))
                    out.append((dist, pos, n, None))
        return out

    if ta == GeomType.PLANE and tb == GeomType.ELLIPSOID:
        # the support point opposite the plane normal
        # (collision._plane_ellipsoid)
        n = mat_col(m1, 2)
        a = mat_vec_t(m2, n)
        w = tuple(mul(s2[i] * s2[i], a[i]) for i in range(3))
        denom = bk.sqrt(bk.maximum(dot3(a, w), 1e-20))
        x = vsub3(p2, mat_vec(m2, tuple(wi / denom for wi in w)))
        dist = sub(dot3(n, x), dot3(n, p1))
        pos = vsub3(x, vscale3(n, mul(0.5, dist)))
        return [(dist, pos, n, None)]

    if ta == GeomType.PLANE and tb == GeomType.CYLINDER:
        # rim points of the downhill cap (collision._plane_cylinder)
        n = mat_col(m1, 2)
        r, hl = s2[0], s2[1]
        axis = mat_col(m2, 2)
        c = dot3(n, axis)
        perp = vsub3(n, vscale3(axis, c))
        plen = bk.sqrt(bk.maximum(dot3(perp, perp), 0.0))
        altv = mat_col(m2, 0)
        alt = vsub3(altv, vscale3(n, dot3(n, altv)))
        altn = bk.sqrt(bk.maximum(dot3(alt, alt), 1e-24))
        altu = tuple(ai / altn for ai in alt)
        good = plen > 1e-10
        safe = bk.where(good, plen, 1.0)
        dir0 = tuple(bk.where(good, -pi_ / safe, au)
                     for pi_, au in zip(perp, altu))
        sgn = bk.where(c > 0, -1.0, 1.0)
        cap_a = vadd3(p2, vscale3(axis, sgn * hl))
        cap_b = vsub3(p2, vscale3(axis, sgn * hl))
        crossd = cross3(axis, dir0)
        root3_2 = math.sqrt(3.0) / 2.0
        dir120 = vadd3(vscale3(dir0, -0.5), vscale3(crossd, root3_2))
        dir240 = vsub3(vscale3(dir0, -0.5), vscale3(crossd, root3_2))
        pts = [
            vadd3(cap_a, vscale3(dir0, r)),
            vadd3(cap_a, vscale3(dir120, r)),
            vadd3(cap_a, vscale3(dir240, r)),
            vadd3(cap_b, vscale3(dir0, r)),
        ]
        pn = dot3(n, p1)
        out = []
        for point in pts:
            dist = sub(dot3(n, point), pn)
            pos = vsub3(point, vscale3(n, mul(0.5, dist)))
            out.append((dist, pos, n, None))
        return out

    if ta == GeomType.SPHERE and tb == GeomType.SPHERE:
        dist, pos, n = _np_sphere_sphere_sg(bk, p1, s1[0], p2, s2[0])
        return [(dist, pos, n, None)]

    if ta == GeomType.SPHERE and tb == GeomType.CAPSULE:
        r2c, hl = s2[0], s2[1]
        axis = mat_col(m2, 2)
        closest = _np_seg_closest_sg(
            bk, vsub3(p2, vscale3(axis, hl)), vadd3(p2, vscale3(axis, hl)),
            p1)
        dist, pos, n = _np_sphere_sphere_sg(bk, p1, s1[0], closest, r2c)
        return [(dist, pos, n, None)]

    if ta == GeomType.CAPSULE and tb == GeomType.CAPSULE:
        r1c, hl1 = s1[0], s1[1]
        r2c, hl2 = s2[0], s2[1]
        ax1 = mat_col(m1, 2)
        ax2 = mat_col(m2, 2)
        q1, q2 = _np_seg_seg_sg(
            bk, vsub3(p1, vscale3(ax1, hl1)), vadd3(p1, vscale3(ax1, hl1)),
            vsub3(p2, vscale3(ax2, hl2)), vadd3(p2, vscale3(ax2, hl2)))
        dist, pos, n = _np_sphere_sphere_sg(bk, q1, r1c, q2, r2c)
        return [(dist, pos, n, None)]

    if ta == GeomType.SPHERE and tb == GeomType.BOX:
        dist, pos, n = _np_sphere_box_sg(bk, p1, s1[0], p2, m2, s2)
        return [(dist, pos, n, None)]

    if ta == GeomType.CAPSULE and tb == GeomType.BOX:
        r, hl = s1[0], s1[1]
        axis = mat_col(m1, 2)
        a = vsub3(p1, vscale3(axis, hl))
        b = vadd3(p1, vscale3(axis, hl))
        # the segment point nearest the box: 8 fixed alternating-projection
        # iterations (collision._capsule_box)
        t = 0.5
        seg = vsub3(b, a)
        denom = bk.maximum(dot3(seg, seg), 1e-12)
        for _ in range(8):
            p = vadd3(a, vscale3(seg, t))
            q_local = tuple(
                bk.clip(mat_vec_t(m2, vsub3(p, p2))[i], -s2[i], s2[i])
                for i in range(3))
            q = vadd3(p2, mat_vec(m2, q_local))
            t = bk.clip(dot3(vsub3(q, a), seg) / denom, 0.0, 1.0)
        mid = vadd3(a, vscale3(seg, t))
        cands = [_np_sphere_box_sg(bk, point, r, p2, m2, s2)
                 for point in (a, b, mid)]
        # the mid lane fires only when strictly deeper than both end lanes
        # (the segment across an edge); else it would repeat an endpoint's
        # contact and double its force against MuJoCo's
        d_mid = cands[2][0]
        redundant = d_mid >= bk.minimum(cands[0][0], cands[1][0]) - 1e-10
        d_mid = bk.where(redundant, 1e10, d_mid)
        return [
            (cands[0][0], cands[0][1], cands[0][2], None),
            (cands[1][0], cands[1][1], cands[1][2], None),
            (d_mid, cands[2][1], cands[2][2], None),
        ]

    if ta == GeomType.BOX and tb == GeomType.BOX:
        return _np_box_box_sg(bk, p1, m1, s1, p2, m2, s2)

    raise ValueError(
        f"pair type {ta.name}-{tb.name} not in the port's scalar-graph class"
    )


def _np_sphere_sphere_sg(bk, p1, r1, p2, r2):
    """collision._sphere_sphere_raw in scalar form: (dist, pos, normal)."""
    delta = vsub3(p2, p1)
    d = bk.sqrt(bk.maximum(dot3(delta, delta), 0.0))
    good = d > 1e-12
    safe = bk.where(good, d, 1.0)
    fallback = (0.0, 0.0, 1.0)
    n = tuple(bk.where(good, delta[i] / safe, fallback[i]) for i in range(3))
    dist = sub(d, r1 + r2)
    pos = vadd3(p1, vscale3(n, add(r1, mul(0.5, dist))))
    return dist, pos, n


def _np_seg_closest_sg(bk, a, b, p):
    """collision._closest_on_segment in scalar form."""
    ab = vsub3(b, a)
    denom = dot3(ab, ab)
    good = denom > 1e-16
    safe = bk.where(good, denom, 1.0)
    t = bk.clip(bk.where(good, dot3(vsub3(p, a), ab) / safe, 0.0), 0.0, 1.0)
    return vadd3(a, vscale3(ab, t))


def _np_seg_seg_sg(bk, a1, b1, a2, b2):
    """collision._segment_segment in scalar form (same clamping order)."""
    d1 = vsub3(b1, a1)
    d2 = vsub3(b2, a2)
    r = vsub3(a1, a2)
    a = dot3(d1, d1)
    e = dot3(d2, d2)
    f = dot3(d2, r)
    c = dot3(d1, r)
    b = dot3(d1, d2)
    denom = sub(mul(a, e), mul(b, b))
    gd = denom > 1e-14
    sd = bk.where(gd, denom, 1.0)
    s = bk.where(gd, bk.clip(sub(mul(b, f), mul(c, e)) / sd, 0.0, 1.0), 0.0)
    ge = e > 1e-14
    se = bk.where(ge, e, 1.0)
    t = bk.where(ge, add(mul(b, s), f) / se, 0.0)
    t_cl = bk.clip(t, 0.0, 1.0)
    ga = a > 1e-14
    sa = bk.where(ga, a, 1.0)
    s = bk.where(
        bk.abs(t - t_cl) > 0,
        bk.clip(bk.where(ga, sub(mul(b, t_cl), c) / sa, 0.0), 0.0, 1.0),
        s,
    )
    return vadd3(a1, vscale3(d1, s)), vadd3(a2, vscale3(d2, t_cl))


def _np_sphere_box_sg(bk, spos, r, bpos, bmat, bsize):
    """collision._sphere_box in scalar form, with the inside branch's
    first-minimum axis tie-break of jnp.argmin."""
    local = mat_vec_t(bmat, vsub3(spos, bpos))
    clamped = tuple(bk.clip(local[i], -bsize[i], bsize[i]) for i in range(3))
    inside = ((bk.abs(local[0]) < bsize[0])
              & (bk.abs(local[1]) < bsize[1])
              & (bk.abs(local[2]) < bsize[2]))
    closest_out = vadd3(bpos, mat_vec(bmat, clamped))
    delta = vsub3(spos, closest_out)
    dn = bk.sqrt(bk.maximum(dot3(delta, delta), 0.0))
    gd = dn > 1e-12
    sdn = bk.where(gd, dn, 1.0)
    zcol = mat_col(bmat, 2)
    n_out = tuple(bk.where(gd, delta[i] / sdn, zcol[i]) for i in range(3))
    dist_out = sub(dn, r)
    depth = tuple(sub(bsize[i], bk.abs(local[i])) for i in range(3))
    is0 = (depth[0] <= depth[1]) & (depth[0] <= depth[2])
    is1 = bk.not_(is0) & (depth[1] <= depth[2])
    sgn = tuple(bk.sign(local[i]) for i in range(3))
    cols = [mat_col(bmat, i) for i in range(3)]
    n_in = tuple(
        bk.where(is0, sgn[0] * cols[0][kk],
                 bk.where(is1, sgn[1] * cols[1][kk], sgn[2] * cols[2][kk]))
        for kk in range(3)
    )
    depth_min = bk.where(is0, depth[0], bk.where(is1, depth[1], depth[2]))
    dist_in = -(depth_min + r)
    dist = bk.where(inside, dist_in, dist_out)
    n = tuple(bk.where(inside, -n_in[kk], neg(n_out[kk])) for kk in range(3))
    pos = vadd3(spos, vscale3(n, add(r, mul(0.5, dist))))
    return dist, pos, n


def _first_true(bk, masks):
    """Each mask and-ed with "no earlier mask holds": a one-hot pick of the
    first true mask (the tie-break of jnp.argmin/argmax)."""
    out, prior = [], None
    for m in masks:
        out.append(m if prior is None else (m & bk.not_(prior)))
        prior = m if prior is None else (prior | m)
    return out


def _np_box_box_sg(bk, p1, m1, s1, p2, m2, s2):
    """Scalar twin of collision._box_box: SAT over the 6 face axes, then
    the incident face clipped against the reference rectangle.  24
    candidate lanes (4 incident corners, 4 rectangle corners, 16 edge
    intersections, deduplicated) compact to the same 8 lanes as the
    general path's top_k (score = valid - idx 1e-6, so lane assignment
    matches exactly), plus the deepest-corner fallback on lane 0."""
    where, babs = bk.where, bk.abs
    d12 = vsub3(p2, p1)
    axes = ([mat_col(m1, a) for a in range(3)]
            + [mat_col(m2, a) for a in range(3)])
    overlaps = []
    for a in range(6):
        r1 = sum_scalars([babs(bk.full(dot3(axes[a], mat_col(m1, kk))))
                          * s1[kk] for kk in range(3)])
        r2 = sum_scalars([babs(bk.full(dot3(axes[a], mat_col(m2, kk))))
                          * s2[kk] for kk in range(3)])
        sep = babs(bk.full(dot3(axes[a], d12)))
        overlaps.append(r1 + r2 - sep)
    best = overlaps[0]
    for a in range(1, 6):
        best = bk.minimum(best, overlaps[a])
    wk = _first_true(bk, [bk.eq(o, best) for o in overlaps])

    def sel6(vals):
        out = vals[5]
        for a in range(4, -1, -1):
            out = where(wk[a], vals[a], out)
        return out

    ref_is_1 = wk[0] | wk[1] | wk[2]
    nref = tuple(sel6([axes[a][i] for a in range(6)]) for i in range(3))
    nd = bk.full(dot3(nref, d12))
    sgn = bk.sign(where(ref_is_1, nd, -nd))
    sgn = where(bk.eq(sgn, 0.0), 1.0, sgn)
    nref = vscale3(nref, sgn)

    def selb(x1, x2):
        return where(ref_is_1, x1, x2)

    pr = tuple(selb(p1[i], p2[i]) for i in range(3))
    mr = tuple(selb(m1[i], m2[i]) for i in range(9))
    sr = tuple(selb(s1[i], s2[i]) for i in range(3))
    pi_ = tuple(selb(p2[i], p1[i]) for i in range(3))
    mi = tuple(selb(m2[i], m1[i]) for i in range(9))
    si = tuple(selb(s2[i], s1[i]) for i in range(3))

    wkr = [wk[0] | wk[3], wk[1] | wk[4], wk[2] | wk[5]]

    def sel3(w3, vals):
        return where(w3[0], vals[0], where(w3[1], vals[1], vals[2]))

    # in-plane axes of the reference face: kr=0 -> (1,2), 1 -> (0,2),
    # 2 -> (0,1)
    u = tuple(where(wkr[0], mat_col(mr, 1)[i], mat_col(mr, 0)[i])
              for i in range(3))
    v = tuple(where(wkr[2], mat_col(mr, 1)[i], mat_col(mr, 2)[i])
              for i in range(3))
    su = where(wkr[0], sr[1], sr[0])
    sv = where(wkr[2], sr[1], sr[2])
    srk = sel3(wkr, list(sr))
    face_c = vadd3(pr, vscale3(nref, srk))

    # incident face: outward normal most anti-parallel to nref
    dots = [bk.full(dot3(mat_col(mi, jj), nref)) for jj in range(3)]
    absd = [babs(x) for x in dots]
    bestd = bk.maximum(bk.maximum(absd[0], absd[1]), absd[2])
    wji = _first_true(bk, [bk.eq(x, bestd) for x in absd])
    dji = sel3(wji, dots)
    jsgn = -bk.sign(dji)
    jsgn = where(bk.eq(jsgn, 0.0), 1.0, jsgn)
    inc_n = vscale3(
        tuple(sel3(wji, [mat_col(mi, jj)[i] for jj in range(3)])
              for i in range(3)),
        jsgn,
    )
    sji = sel3(wji, list(si))
    inc_c = vadd3(pi_, vscale3(inc_n, sji))
    e1ax = tuple(where(wji[0], mat_col(mi, 1)[i], mat_col(mi, 0)[i])
                 for i in range(3))
    e2ax = tuple(where(wji[2], mat_col(mi, 1)[i], mat_col(mi, 2)[i])
                 for i in range(3))
    e1s = where(wji[0], si[1], si[0])
    e2s = where(wji[2], si[1], si[2])
    e1 = vscale3(e1ax, e1s)
    e2 = vscale3(e2ax, e2s)
    signs = ((1.0, 1.0), (1.0, -1.0), (-1.0, -1.0), (-1.0, 1.0))
    corners = [vadd3(inc_c, vadd3(vscale3(e1, a_), vscale3(e2, b_)))
               for (a_, b_) in signs]
    rels = [vsub3(c, face_c) for c in corners]
    qu = [bk.full(dot3(r_, u)) for r_ in rels]
    qv = [bk.full(dot3(r_, v)) for r_ in rels]
    qh = [bk.full(dot3(r_, nref)) for r_ in rels]

    # affine h(u, v) from three corners
    du1 = (qu[1] - qu[0], qv[1] - qv[0])
    du2 = (qu[3] - qu[0], qv[3] - qv[0])
    dh1 = qh[1] - qh[0]
    dh2 = qh[3] - qh[0]
    det = du1[0] * du2[1] - du1[1] * du2[0]
    safe_det = where(babs(det) > 1e-12, det, 1.0)
    gu = (dh1 * du2[1] - dh2 * du1[1]) / safe_det
    gv = (dh2 * du1[0] - dh1 * du2[0]) / safe_det
    h0 = qh[0] - gu * qu[0] - gv * qv[0]

    cands = []  # (pu, pv, valid)
    for i in range(4):  # incident corners inside the rectangle
        ok = (babs(qu[i]) <= su + 1e-10) & (babs(qv[i]) <= sv + 1e-10)
        cands.append((qu[i], qv[i], ok))
    rect = [(su, sv), (su, -sv), (-su, -sv), (-su, sv)]
    for (px, py) in rect:  # rectangle corners inside the quad
        crosses = []
        for i in range(4):
            ax_, ay_ = qu[i], qv[i]
            bx_, by_ = qu[(i + 1) % 4], qv[(i + 1) % 4]
            crosses.append((bx_ - ax_) * (py - ay_)
                           - (by_ - ay_) * (px - ax_))
        all_pos = crosses[0] >= -1e-10
        all_neg = crosses[0] <= 1e-10
        for c_ in crosses[1:]:
            all_pos = all_pos & (c_ >= -1e-10)
            all_neg = all_neg & (c_ <= 1e-10)
        cands.append((px, py, all_pos | all_neg))
    for i in range(4):  # quad edges x rectangle edges
        ax_, ay_ = qu[i], qv[i]
        abx = qu[(i + 1) % 4] - ax_
        aby = qv[(i + 1) % 4] - ay_
        for rj in range(4):
            cx, cy = rect[rj]
            dx_, dy_ = rect[(rj + 1) % 4]
            cdx, cdy = dx_ - cx, dy_ - cy
            den = abx * cdy - aby * cdx
            safe = where(babs(den) > 1e-12, den, 1.0)
            t_ = ((cx - ax_) * cdy - (cy - ay_) * cdx) / safe
            sly = ((cx - ax_) * aby - (cy - ay_) * abx) / safe
            ok = ((babs(den) > 1e-12) & (t_ >= 0) & (t_ <= 1)
                  & (sly >= 0) & (sly <= 1))
            cands.append((ax_ + t_ * abx, ay_ + t_ * aby, ok))

    # dedup coincident candidates: keep the first valid representative
    valid = [c[2] for c in cands]
    for i in range(1, 24):
        dup = None
        for jj in range(i):
            du_ = cands[i][0] - cands[jj][0]
            dv_ = cands[i][1] - cands[jj][1]
            dd = (du_ * du_ + dv_ * dv_ < 1e-16) & valid[jj]
            dup = dd if dup is None else (dup | dd)
        valid[i] = valid[i] & bk.not_(dup)

    # compact to 8 lanes by repeated argmax of score = valid - idx 1e-6,
    # the general path's top_k lane assignment
    scores = [where(valid[i], 1.0, 0.0) - i * 1e-6 for i in range(24)]
    taken = [False] * 24
    out = []
    for _lane in range(8):
        eff = [where(taken[i], -1e9, scores[i]) for i in range(24)]
        best_s = eff[0]
        for i in range(1, 24):
            best_s = bk.maximum(best_s, eff[i])
        pick = _first_true(bk, [bk.eq(e_, best_s) for e_ in eff])
        pu, pv, pval = cands[23][0], cands[23][1], valid[23]
        for i in range(22, -1, -1):
            pu = where(pick[i], cands[i][0], pu)
            pv = where(pick[i], cands[i][1], pv)
            pval = (pick[i] & valid[i]) | (bk.not_(pick[i]) & pval)
        taken = [taken[i] | pick[i] for i in range(24)]
        out.append((pu, pv, pval))

    n_contact = vscale3(nref, where(ref_is_1, 1.0, -1.0))
    lanes = []
    any_valid = None
    for (pu, pv, pval) in out:
        hh = h0 + gu * pu + gv * pv
        world = vadd3(face_c, vadd3(vscale3(u, pu),
                                    vadd3(vscale3(v, pv),
                                          vscale3(nref, hh))))
        pos = vsub3(world, vscale3(nref, 0.5 * hh))
        lanes.append([where(pval, hh, 1e10), pos, n_contact])
        any_valid = pval if any_valid is None else (any_valid | pval)

    # edge-dominant fallback on lane 0: the deepest incident corner
    none_valid = bk.not_(any_valid)
    dh_best = qh[0]
    du_best, dv_best = qu[0], qv[0]
    for i in range(1, 4):
        deeper = qh[i] < dh_best
        du_best = where(deeper, qu[i], du_best)
        dv_best = where(deeper, qv[i], dv_best)
        dh_best = where(deeper, qh[i], dh_best)
    dpu = bk.clip(du_best, -su, su)
    dpv = bk.clip(dv_best, -sv, sv)
    deep_world = vadd3(face_c, vadd3(vscale3(u, dpu),
                                     vadd3(vscale3(v, dpv),
                                           vscale3(nref, dh_best))))
    deep_pos = vsub3(deep_world, vscale3(nref, 0.5 * dh_best))
    lanes[0][0] = where(none_valid, dh_best, lanes[0][0])
    lanes[0][1] = tuple(where(none_valid, deep_pos[i], lanes[0][1][i])
                        for i in range(3))
    return [(d_, p_, n_, None) for (d_, p_, n_) in lanes]


def _lane_to_pair(model, lane):
    idx = 0
    count = 0
    for (t1, t2, pairs) in model.pair_groups:
        k = max_contacts_per_pair(t1, t2)
        for _ in pairs:
            if lane < count + k:
                return idx
            count += k
            idx += 1
    raise IndexError(lane)


def _geom_pos(model, mc, g, xpos, xmat):
    b = model.geom_bodyid[g]
    return vadd3(xpos[b], mat_vec(xmat[b], tuple(mc.geom_pos[g])))


def _geom_mat(model, mc, g, xmat):
    gq = tuple(mc.geom_quat[g])
    gm = quat_to_mat(gq)
    # xmat[b] @ gm, with constant folding (identity quats vanish)
    out = []
    for i in range(3):
        for jcol in range(3):
            s = 0.0
            for k in range(3):
                s = fma(s, xmat[model.geom_bodyid[g]][3 * i + k],
                        gm[3 * k + jcol])
            out.append(s)
    return tuple(out)


def _make_frame_scalar(bk, n):
    """mju_makeFrame in scalar form."""
    use_y = bk.abs(n[1]) < 0.5
    seed = tuple(bk.where(use_y, s_y, s_z) for s_y, s_z in
                 ((0.0, 0.0), (1.0, 0.0), (0.0, 1.0)))
    d = dot3(n, seed)
    t1 = vsub3(seed, vscale3(n, d))
    t1n = bk.sqrt(bk.maximum(dot3(t1, t1), 1e-20))
    t1 = tuple(t / t1n for t in t1)
    return t1, cross3(n, t1)


def _point_jac_rel(model, cdof, subtree_com, bd_mask, point, b1, b2):
    """Sparse dict dof -> vec3: translational jacobian of `point` on b2
    relative to b1."""
    out = {}
    for body, s in ((b2, 1.0), (b1, -1.0)):
        origin = subtree_com[model.body_rootid[body]]
        arm = vsub3(point, origin)
        for dof in range(model.nv):
            if not bd_mask[body, dof]:
                continue
            ang, lin = cdof[dof]
            contrib = vadd3(lin, cross3(ang, arm))
            if s < 0:
                contrib = tuple(neg(c) for c in contrib)
            if dof in out:
                out[dof] = vadd3(out[dof], contrib)
            else:
                out[dof] = contrib
    return out


def _rot_jac_rel(model, cdof, bd_mask, b1, b2):
    """Sparse dict dof -> vec3: the rotational Jacobian of b2 relative to
    b1 (the angular cdof difference), for the torsional and rolling
    friction axes."""
    out = {}
    for body, s in ((b2, 1.0), (b1, -1.0)):
        for dof in range(model.nv):
            if not bd_mask[body, dof]:
                continue
            ang = cdof[dof][0]
            contrib = ang if s > 0 else tuple(neg(a) for a in ang)
            if dof in out:
                out[dof] = vadd3(out[dof], contrib)
            else:
                out[dof] = contrib
    return out


def _jdotv(jrow, qvel):
    s = 0.0
    for dof, val in jrow.items():
        s = fma(s, val, qvel[dof])
    return s


def _row_force_act(bk, r, jar_r):
    """(force, quadratic-zone mask) of one row at residual ``jar_r``.

    uni: f = max(-D jar, 0) on existing rows;
    fri: f = clip(-D jar, -floss, floss) -- the quadratic zone is
    |D jar| < floss, outside it the cost is linear (MuJoCo's friction-row
    Huber cost); eq: f = -D jar on existing rows (bilateral)."""
    if r.get("kind") == "fri":
        fl = r["floss"]
        g = r["D"] * jar_r
        return bk.clip(-g, -fl, fl), bk.abs(g) < fl
    if r.get("kind") == "eq":
        ex = r["exists"]
        if ex is True:
            return -r["D"] * jar_r, True
        return bk.where(ex, -r["D"] * jar_r, 0.0), ex
    act = r["exists"] & (jar_r < 0)
    return bk.where(act, -r["D"] * jar_r, 0.0), act


def _dphi_stacked(bk, rows, jar, jp, d0, sg, cones=(), cjar=(), cjp=()):
    """The line search's ``dphi`` on the torch backend, over ``(rows, B)``
    stacks: every element goes through the same ops in the same order as
    the per-row form (the sum over rows stays a sequential loop), so the
    result is bit-identical, from about a tenth of the torch calls.  Cone
    groups stack per shape and mu constants (a division by a Python mu
    rounds as the per-group form's does) and are summed after the rows in
    group order."""
    st = lambda xs: torch.stack([bk.full(x) for x in xs])
    if rows:
        jar_s, jp_s = st(jar), st(jp)
        neg_d = st([-r["D"] for r in rows])
        exists = st([r["exists"] for r in rows])
    fri = [r.get("kind") == "fri" for r in rows]
    # an eq row is active wherever it exists
    is_eq = [r.get("kind") == "eq" for r in rows]
    is_eq = st(is_eq) if any(is_eq) else None
    if any(fri):
        # a friction row's clip(-(D jar), -fl, fl): -(D jar) == (-D) jar
        # bit for bit, so both kinds share neg_d * jar_a
        # built on the device: the plain step may be under graph capture
        is_fri = st(fri)
        fl = st([r["floss"] if f else 0.0 for r, f in zip(rows, fri)])

    # cone groups of one shape and one set of mu constants stack as
    # (groups, condim, B); ``order`` is each group's (stack, index)
    stacks, order = {}, []
    for c, j3, p3 in zip(cones, cjar, cjp):
        key = (c["mu"], c["mu0"], c["impratio"])
        grp = stacks.setdefault(key, dict(c=c, members=[]))
        order.append((key, len(grp["members"])))
        grp["members"].append((c, j3, p3))
    for grp in stacks.values():
        mem = grp.pop("members")
        grp["jar"] = torch.stack([st(j3) for (_, j3, _) in mem])
        grp["jp"] = torch.stack([st(p3) for (_, _, p3) in mem])
        d = torch.stack([st(c["D"]) for (c, _, _) in mem])
        # the group's cone: D and exists stacked as (groups, B) rows
        grp["c"] = dict(grp["c"], D=list(d.unbind(1)),
                        exists=st([c["exists"] for (c, _, _) in mem]))

    def cone_df(grp, alpha):
        jar_a = grp["jar"] + alpha * grp["jp"]
        f, _ = _cone_force_sg(bk, grp["c"], list(jar_a.unbind(1)))
        return torch.stack(f, 1) * grp["jp"]

    def dphi(alpha):
        s = d0 + alpha * sg
        if rows:
            jar_a = jar_s + alpha * jp_s
            below = jar_a < 0
            act = exists & (below if is_eq is None else below | is_eq)
            g = neg_d * jar_a
            f_a = torch.where(act, g, torch.zeros_like(jar_a))
            if any(fri):
                f_a = torch.where(is_fri, torch.clamp(g, -fl, fl), f_a)
            df = f_a * jp_s
            for i in range(len(rows)):
                s = s - df[i]
        if cones:
            dfc = {key: cone_df(grp, alpha) for key, grp in stacks.items()}
            for key, k in order:
                for dfi in dfc[key][k]:
                    s = s - dfi
        return s

    return dphi


def _row_cost(bk, r, jar_r):
    if r.get("kind") == "eq":
        c = 0.5 * r["D"] * jar_r * jar_r
        return c if r["exists"] is True else bk.where(r["exists"], c, 0.0)
    if r.get("kind") == "fri":
        fl = r["floss"]
        g = r["D"] * jar_r
        quad = 0.5 * r["D"] * jar_r * jar_r
        lin = fl * bk.abs(jar_r) - 0.5 * fl * fl / r["D"]
        return bk.where(bk.abs(g) < fl, quad, lin)
    act = r["exists"] & (jar_r < 0)
    return bk.where(act, 0.5 * r["D"] * jar_r * jar_r, 0.0)


def _mat_vec_sym(m_mat, v, nv):
    out = [0.0] * nv
    for (i, j), val in m_mat.items():
        out[i] = fma(out[i], val, v[j])
        if i != j:
            out[j] = fma(out[j], val, v[i])
    return out


def _cone_g(c, jar3):
    """g = -D jar of one cone group's rows."""
    return [mul(-1.0, mul(c["D"][i], jar3[i])) for i in range(len(c["J"]))]


def _cone_force_sg(bk, c, jar3):
    """(force list, g list) of one elliptic cone group at residual
    ``jar3``: g = -D jar projected onto the friction cone in the D^-1
    metric (the reference's scalar form of the general path's cone
    force).  The group has condim rows: the normal, then condim - 1
    friction components (the tangents, then torsional and rolling at
    condim 4/6)."""
    m = len(c["J"]) - 1
    g = _cone_g(c, jar3)
    ghat = [g[i + 1] / c["mu"][i] for i in range(m)]
    gT = bk.sqrt(sum_scalars([gh * gh for gh in ghat]))
    mub2 = c["mu0"] * c["mu0"] / c["impratio"]
    wa = 1.0 / (1.0 + mub2)
    wb = mub2 / (1.0 + mub2)
    t = wa * g[0] + wb * gT
    bottom = g[0] >= gT
    zero = t <= 0.0
    safe = bk.where(gT > 1e-15, gT, 1.0)
    f = [bk.where(bottom, g[0], bk.where(zero, 0.0, t))] + [
        bk.where(bottom, g[i + 1],
                 bk.where(zero, 0.0, c["mu"][i] * t * ghat[i] / safe))
        for i in range(m)
    ]
    return [bk.where(c["exists"], fi, 0.0) for fi in f], g


def _cone_cost_sg(bk, c, jar3):
    """Moreau-envelope cost of one cone group (its gradient is -force)."""
    f, g = _cone_force_sg(bk, c, jar3)
    cost = 0.0
    for i in range(len(c["J"])):
        dinv = 1.0 / bk.maximum(c["D"][i], 1e-30)
        d = g[i] - f[i]
        cost = add(cost, 0.5 * dinv * (g[i] * g[i] - d * d))
    return bk.where(c["exists"], cost, 0.0)


def _cone_hess_sg(bk, c, jar3, g=None):
    """The (condim, condim) cost Hessian of one cone group with respect
    to its residuals (the general path's cone Hessian in scalar form);
    ``g`` is :func:`_cone_force_sg`'s, where the caller has it."""
    dim = len(c["J"])
    m = dim - 1
    if g is None:
        g = _cone_g(c, jar3)
    q = [g[i + 1] / c["mu"][i] for i in range(m)]
    Q = bk.sqrt(sum_scalars([qi * qi for qi in q]))
    safe_q = bk.where(Q > 1e-15, Q, 1.0)
    mub2 = c["mu0"] * c["mu0"] / c["impratio"]
    D0 = c["D"][0]
    a = 1.0 / bk.maximum(D0, 1e-30)
    # one rounding, as the reference's division: torch (and the emitter
    # after it) would take mub2 / x as reciprocal(x) * mub2
    b_ = bk.full(mub2) / bk.maximum(D0, 1e-30)
    wa = 1.0 / (1.0 + mub2)
    wb = mub2 / (1.0 + mub2)
    t = wa * g[0] + wb * Q
    hpp = a * a / (a + b_)
    s0 = mul(-1.0, D0)
    st = [mul(-1.0, c["D"][i + 1]) / c["mu"][i] for i in range(m)]
    H = [[None] * dim for _ in range(dim)]
    H[0][0] = s0 * s0 * hpp
    for i in range(m):
        hpq_i = (a * b_ / (a + b_)) * q[i] / safe_q
        H[0][i + 1] = s0 * st[i] * hpq_i
        H[i + 1][0] = H[0][i + 1]
    for i in range(m):
        for j in range(m):
            qq = q[i] * q[j] / (safe_q * safe_q)
            eye = 1.0 if i == j else 0.0
            hqq = (b_ * b_ / (a + b_)) * qq + (t * b_ / safe_q) * (eye - qq)
            H[i + 1][j + 1] = st[i] * st[j] * hqq
    bottom = g[0] >= Q
    zero = t <= 0.0
    out = [[None] * dim for _ in range(dim)]
    for i in range(dim):
        for j in range(dim):
            diag = c["D"][i] if i == j else 0.0
            v = bk.where(bottom, diag, bk.where(zero, 0.0, H[i][j]))
            out[i][j] = bk.where(c["exists"], v, 0.0)
    return out


def _newton(bk, model, rows, cones, m_mat, chol_factor, chol_solve,
            qacc_smooth, qfrc_smooth, warmstart, nv, team=1):
    """Scalar-graph Newton solver with the sort-free line search; the
    ``model.opt.iterations`` iterations run as one ``bk.fori`` carrying
    (x, jar, the cone groups' residuals).  Sets each row's and cone
    group's ``force`` and returns qacc."""
    ne = len(rows)
    dims = [len(c["J"]) for c in cones]

    def jar_of(x):
        return ([sub(_jdotv(r["J"], x), r["aref"]) for r in rows],
                [[sub(_jdotv(Ji, x), c["aref"][i])
                  for i, Ji in enumerate(c["J"])] for c in cones])

    def cost_parts(x, jar, cjar):
        # gauss: 0.5 (x - xs)^T M (x - xs)
        dx = [sub(x[i], qacc_smooth[i]) for i in range(nv)]
        mdx = _mat_vec_sym(m_mat, dx, nv)
        gauss = 0.0
        for i in range(nv):
            gauss = fma(gauss, dx[i], mdx[i])
        gauss = mul(0.5, gauss)
        cons = 0.0
        for r, jr in zip(rows, jar):
            cons = add(cons, _row_cost(bk, r, jr))
        for c, j3 in zip(cones, cjar):
            cons = add(cons, _cone_cost_sg(bk, c, j3))
        return add(gauss, cons)

    jar_ws, cjar_ws = jar_of(warmstart)
    jar_sm, cjar_sm = jar_of(qacc_smooth)
    c_ws = cost_parts(warmstart, jar_ws, cjar_ws)
    c_sm = cost_parts(qacc_smooth, jar_sm, cjar_sm)
    use_ws = c_ws < c_sm
    x = [bk.where(use_ws, warmstart[i], qacc_smooth[i]) for i in range(nv)]
    jar = [bk.where(use_ws, a, b) for a, b in zip(jar_ws, jar_sm)]
    cjar = [bk.where(use_ws, a, b)
            for ca, cb in zip(cjar_ws, cjar_sm) for a, b in zip(ca, cb)]

    def unflat(flat):
        out, k = [], 0
        for d in dims:
            out.append(flat[k:k + d])
            k += d
        return out

    def iteration(carry):
        x, jar = carry[:nv], carry[nv:nv + ne]
        cjar = unflat(carry[nv + ne:])
        fa = [_row_force_act(bk, r, jr) for r, jr in zip(rows, jar)]
        f = [x_[0] for x_ in fa]
        act = [x_[1] for x_ in fa]
        mx = _mat_vec_sym(m_mat, x, nv)
        grad = [sub(sub(mx[i], qfrc_smooth[i]), 0.0) for i in range(nv)]
        for r, fr in zip(rows, f):
            for dof, val in r["J"].items():
                grad[dof] = sub(grad[dof], mul(val, fr))
        cg = []
        for c, j3 in zip(cones, cjar):
            fc, g = _cone_force_sg(bk, c, j3)
            cg.append(g)
            for Ji, fi in zip(c["J"], fc):
                for dof, val in Ji.items():
                    grad[dof] = sub(grad[dof], mul(val, fi))
        # hessian = M + sum_act D J J^T + sum_cones J_c^T H_c J_c
        hess = dict(m_mat)
        for r, a in zip(rows, act):
            w = bk.where(a, r["D"], 0.0)
            items = sorted(r["J"].items())
            for ii, (d1, v1) in enumerate(items):
                wv1 = mul(w, v1)
                for (d2, v2) in items[: ii + 1]:
                    key = (max(d1, d2), min(d1, d2))
                    hess[key] = add(hess.get(key, 0.0), mul(wv1, v2))
        for c, j3, g in zip(cones, cjar, cg):
            H = _cone_hess_sg(bk, c, j3, g)
            dofs = sorted({d for Ji in c["J"] for d in Ji})
            for pi, dp in enumerate(dofs):
                for dq in dofs[: pi + 1]:
                    v = 0.0
                    for Ji, Hi in zip(c["J"], H):
                        jip = Ji.get(dp)
                        if jip is None:
                            continue
                        for Jj, hij in zip(c["J"], Hi):
                            jjq = Jj.get(dq)
                            if jjq is None:
                                continue
                            v = add(v, mul(mul(jip, hij), jjq))
                    key = (max(dp, dq), min(dp, dq))
                    hess[key] = add(hess.get(key, 0.0), v)
        l_h = chol_factor(hess)
        p = chol_solve(l_h, [neg(g) for g in grad])
        jp = [_jdotv(r["J"], p) for r in rows]
        cjp = [[_jdotv(Ji, p) for Ji in c["J"]] for c in cones]
        mp = _mat_vec_sym(m_mat, p, nv)
        d0 = 0.0
        sg = 0.0
        for i in range(nv):
            d0 = fma(d0, p[i], sub(mx[i], qfrc_smooth[i]))
            sg = fma(sg, p[i], mp[i])
        alpha = _linesearch_scalar(bk, rows, jar, jp, d0, sg, cones, cjar,
                                   cjp, team=team)
        x = [fma(x[i], alpha, p[i]) for i in range(nv)]
        jar = [fma(jr, alpha, jpr) for jr, jpr in zip(jar, jp)]
        cjar = [fma(jr, alpha, jpr) for ca, cpa in zip(cjar, cjp)
                for jr, jpr in zip(ca, cpa)]
        return x + jar + cjar

    carry = bk.fori(model.opt.iterations, x + jar + cjar, iteration)
    x, jar = carry[:nv], carry[nv:nv + ne]

    # final forces
    for r, jr in zip(rows, jar):
        r["force"], _ = _row_force_act(bk, r, jr)
    for c, j3 in zip(cones, unflat(carry[nv + ne:])):
        c["force"], _ = _cone_force_sg(bk, c, j3)
    return x


# the row kinds in the team deal's slot order; cone groups follow, by key
_TEAM_ROW_KINDS = ("uni", "fri", "eq")


def _row_kind(r) -> str:
    return r.get("kind") if r.get("kind") in ("fri", "eq") else "uni"


def team_deal(rows, cones, team: int):
    """The team line search's deal of rows and cone groups to lane slots.

    Rows go by kind (``uni``, ``fri``, ``eq``), cone groups by their
    stacking key (condim, mu, mu0, impratio); the ``n`` members of a kind
    fill ``R = ceil(n / G)`` slots, member ``s * G + l`` in lane l's slot
    s.  Returns ``[(kind, members)]`` in slot order, every lane with the
    same sequence of kinds: ``kind`` a row kind or a cone key, ``members``
    G indices into ``rows`` or ``cones``, None for a padding slot (a row
    that does not exist: it contributes exactly +0.0)."""
    blocks = {}
    for i, r in enumerate(rows):
        blocks.setdefault(_row_kind(r), []).append(i)
    keys = [k for k in _TEAM_ROW_KINDS if k in blocks]
    for j, c in enumerate(cones):
        key = (len(c["J"]), c["mu"], c["mu0"], c["impratio"])
        if key not in blocks:
            keys.append(key)
        blocks.setdefault(key, []).append(j)
    slots = []
    for key in keys:
        idx = blocks[key]
        for s in range(0, len(idx), team):
            members = idx[s:s + team]
            slots.append((key, members + [None] * (team - len(members))))
    return slots


def _team_fields(rows, cones, jar, jp, cjar, cjp, kind, members):
    """``{field: [G lane values]}`` of one slot: the values its dphi term
    reads, padding slots as a row that does not exist (jar 0, jp 0, D 0,
    exists false)."""
    pad = lambda get, z: [z if m is None else get(m) for m in members]
    if kind in _TEAM_ROW_KINDS:
        f = dict(jar=pad(lambda i: jar[i], 0.0), jp=pad(lambda i: jp[i], 0.0),
                 neg_d=pad(lambda i: -rows[i]["D"], 0.0),
                 exists=pad(lambda i: rows[i]["exists"], False))
        if kind == "fri":
            f["fl"] = pad(lambda i: rows[i]["floss"], 0.0)
        return f
    f = {"exists": pad(lambda j: cones[j]["exists"], False)}
    for i in range(kind[0]):
        f[f"jar{i}"] = pad(lambda j: cjar[j][i], 0.0)
        f[f"jp{i}"] = pad(lambda j: cjp[j][i], 0.0)
        f[f"d{i}"] = pad(lambda j: cones[j]["D"][i], 0.0)
    return f


def _team_terms(bk, kind, v, alpha):
    """The dphi terms ``f * jp`` of one slot (one per row: condim for a
    cone group) at step ``alpha``; ``v`` holds the slot's lane values."""
    if kind in _TEAM_ROW_KINDS:
        jar_a = v["jar"] + alpha * v["jp"]
        g = v["neg_d"] * jar_a
        if kind == "uni":
            f = bk.where(v["exists"] & (jar_a < 0), g, 0.0)
        elif kind == "eq":
            f = bk.where(v["exists"], g, 0.0)
        else:  # fri: clip(-(D jar), -fl, fl) == clip((-D) jar, -fl, fl)
            f = bk.where(v["exists"], bk.clip(g, -v["fl"], v["fl"]), 0.0)
        return [f * v["jp"]]
    dim, mu, mu0, impratio = kind
    c = dict(J=[None] * dim, D=[v[f"d{i}"] for i in range(dim)], mu=mu,
             mu0=mu0, impratio=impratio, exists=v["exists"])
    f, _ = _cone_force_sg(bk, c, [v[f"jar{i}"] + alpha * v[f"jp{i}"]
                                  for i in range(dim)])
    return [fi * v[f"jp{i}"] for i, fi in enumerate(f)]


def _dphi_team(bk, rows, jar, jp, d0, sg, cones, cjar, cjp, team):
    """The line search's ``dphi`` of a team of G lanes, per slot: each
    lane sums its slots' terms in slot order (its partial), the team
    sums the G partials pairwise (``bk.team_sum``) and
    ``dphi = (d0 + alpha sg) - total``.  The slot values are taken once
    per Newton iteration (``bk.team_lanes``).  On the emitter each value
    is this lane's; on the torch backend a ``(G, B)`` value holds every
    lane's, so the torch run computes the kernel's partials and tree."""
    deal = team_deal(rows, cones, team)
    fields = [_team_fields(rows, cones, jar, jp, cjar, cjp, k, m)
              for k, m in deal]
    flat = bk.team_lanes([col for f in fields for col in f.values()])
    slots, n = [], 0
    for (kind, _), f in zip(deal, fields):
        slots.append((kind, dict(zip(f, flat[n:n + len(f)]))))
        n += len(f)

    def dphi(alpha):
        part = None
        for kind, v in slots:
            for t in _team_terms(bk, kind, v, alpha):
                part = t if part is None else part + t
        return (d0 + alpha * sg) - bk.team_sum(part)

    return dphi


def _dphi_team_stacked(bk, rows, jar, jp, d0, sg, cones, cjar, cjp, team):
    """:func:`_dphi_team` on the torch backend from a tenth of the torch
    calls: the slots of one kind stack as ``(R, G, B)`` and their terms
    are folded into the partial in the same slot order, so every element
    goes through the same ops in the same order (bit-identical)."""
    deal = team_deal(rows, cones, team)
    blocks = []  # (kind, the members of each of its slots)
    for kind, members in deal:
        if not blocks or blocks[-1][0] != kind:
            blocks.append((kind, []))
        blocks[-1][1].append(members)
    stacked = []
    for kind, members in blocks:
        fs = [_team_fields(rows, cones, jar, jp, cjar, cjp, kind, m)
              for m in members]
        stacked.append((kind, {
            k: torch.stack(bk.team_lanes([f[k] for f in fs]))
            for k in fs[0]}))

    def dphi(alpha):
        part = None
        for kind, v in stacked:
            terms = _team_terms(bk, kind, v, alpha)
            for s in range(terms[0].shape[0]):
                for t in terms:
                    part = t[s] if part is None else part + t[s]
        return (d0 + alpha * sg) - bk.team_sum(part)

    return dphi


def _linesearch_scalar(bk, rows, jar, jp, d0, sg, cones=(), cjar=(), cjp=(),
                       n_grow=12, n_bisect=26, team=1):
    """Monotone derivative root find: doubling bracket then bisection
    (sort-free), both as ``bk.fori`` loops.  dphi is piecewise linear in
    alpha for the row kinds and curved in the cone groups' zones, which
    the bracket handles alike.

    With ``team`` G > 1 a team of G lanes evaluates each dphi: the rows
    and cone groups are dealt to lane slots (:func:`team_deal`) and the
    sum over them is taken as G partial sums and a pairwise tree
    (:func:`_dphi_team`); the grow and bisection decisions read the
    tree's total, which every lane holds bit for bit.  At G = 1 the sum
    is the sequential chain of the reference."""

    def dphi(alpha):
        # dcost/dalpha per row = -f(jar_a) * jp
        s = d0 + alpha * sg
        for r, jr, jpr in zip(rows, jar, jp):
            jar_a = jr + alpha * jpr
            f_a, _ = _row_force_act(bk, r, jar_a)
            s = s - f_a * jpr
        for c, j3, p3 in zip(cones, cjar, cjp):
            f_a, _ = _cone_force_sg(
                bk, c, [jr + alpha * jpr for jr, jpr in zip(j3, p3)])
            for fi, pi in zip(f_a, p3):
                s = s - fi * pi
        return s

    if hasattr(bk, "line_search_terms"):  # the emitter counts them
        bk.line_search_terms = max(bk.line_search_terms, len(rows) + sum(
            len(c["J"]) for c in cones))
    if team > 1 and (rows or cones):
        team_form = (_dphi_team_stacked if isinstance(bk, TorchBackend)
                     else _dphi_team)
        dphi = team_form(bk, rows, jar, jp, d0, sg, cones, cjar, cjp, team)
    elif isinstance(bk, TorchBackend) and (rows or cones):
        dphi = _dphi_stacked(bk, rows, jar, jp, d0, sg, cones, cjar, cjp)

    def grow(c):
        hi = c[0]
        return [bk.where(dphi(hi) < 0, hi * 4.0, hi)]

    def bisect(c):
        lo, hi = c
        mid = 0.5 * (lo + hi)
        neg_mid = dphi(mid) < 0
        return [bk.where(neg_mid, mid, lo), bk.where(neg_mid, hi, mid)]

    (hi,) = bk.fori(n_grow, [1.0], grow)
    lo, hi = bk.fori(n_bisect, [0.0, hi], bisect)
    alpha = 0.5 * (lo + hi)
    return bk.where(dphi(bk.full(0.0)) >= 0, 0.0, alpha)
