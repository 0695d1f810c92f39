"""Scalar-graph physics step, written once against a small backend.

The port of ``oxide_control_tpu/ops/scalar_graph.py`` for the cheetah
class (see :func:`supports`).  The whole ``mj_step`` of one env is built as
a graph of elementwise operations on per-env scalars; the model's structure
(tree topology, joint axes, geom pairs, constraint rows) is compiled away at
build time:

* every per-env scalar is either a **python float constant** (folded at
  build time in double precision -- structural zeros vanish, so the
  sparsity of the Jacobian and mass matrix is exploited automatically) or a
  backend value;
* every operation on backend values goes through Python operators or the
  backend object ``bk`` (``where``, ``maximum``, ``minimum``, ``clip``,
  ``abs``, ``sqrt``, ``rsqrt``, ``sin``, ``cos``, ``log``, ``tanh``,
  ``isfinite``, ``pow``, ``not_``, ``fori``), so one graph drives two
  backends:

  - :class:`TorchBackend`: values are ``(B,)`` tensors -- the plain
    PyTorch version, on the CPU (tests) or the GPU (comparison);
  - ``ops.emit.Emitter``: values are symbols that write SSA-style C into
    the per-model step body of the CUDA rollout kernel.

The Newton iterations and the line search's grow/bisect loops run through
``bk.fori`` with explicit carries: Python loops on the torch backend, real
C ``for`` loops in the emitted body (same arithmetic, a small kernel
source).  Loop carries are always backend values, never folded constants,
so both backends fold exactly the same constants.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..model import (
    BiasType,
    ConeType,
    DynType,
    GainType,
    GeomType,
    Integrator,
    JointType,
    Model,
    SolverType,
    TrnType,
)
from ..physics import smooth
from ..physics.collision import max_contacts_per_pair

# ---------------------------------------------------------------------------
# backends
# ---------------------------------------------------------------------------


def _is_const(x) -> bool:
    return isinstance(x, (int, float))


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

    def fori(self, n: int, carry, body):
        """``carry = body(carry)`` n times; the carry is materialized so
        nothing inside the loop folds against a loop-carried constant."""
        carry = [self.full(c) for c in carry]
        for _ in range(n):
            carry = [self.full(c) for c in body(list(carry))]
        return carry


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

# contact-pair types with a scalar narrowphase in this port (see
# _np_contacts_sg); the reference's other pairs are ROADMAP Queue A 10.3
_SUPPORTED_PAIRS = (
    (GeomType.PLANE, GeomType.SPHERE),
    (GeomType.PLANE, GeomType.CAPSULE),
)


def unsupported_reason(model: Model) -> str | None:
    """Why the port's scalar graph cannot run ``model`` (None if it can).

    This is the exact class spec of the port, narrower than the
    reference's ``supports``; each reason names the ROADMAP row that
    widens it:

    * joints: hinge and slide (limits included)
    * integrator: Euler (implicit joint damping included)
    * solver: Newton with pyramidal cones at condim 1 or 3
    * contacts: plane-sphere and plane-capsule
    * actuators: stateless motors (fixed gain, no bias) on joints
    * no tendons, equality, mocap bodies, friction loss or fluid forces
    """
    for j in range(model.njnt):
        jt = JointType(model.jnt_type[j])
        if jt not in (JointType.HINGE, JointType.SLIDE):
            return (f"{jt.name} joint: ball/free joints are ROADMAP Queue A "
                    "item 9 (humanoid-run) and the later integrate_pos_sg")
    if model.opt.integrator != Integrator.EULER:
        return ("integrator %s: RK4 is ROADMAP Queue A item 9 "
                "(cartpole-swingup)" % Integrator(model.opt.integrator).name)
    if model.opt.solver != SolverType.NEWTON:
        return "solver is not Newton: CG/PGS stay on the general path " \
               "(ROADMAP Queue A item 11)"
    if model.opt.cone != ConeType.PYRAMIDAL:
        return "elliptic cones are ROADMAP Queue A item 10.4"
    for (t1, t2, _) in model.pair_groups:
        if (GeomType(t1), GeomType(t2)) not in _SUPPORTED_PAIRS:
            return (f"contact pair {GeomType(t1).name}-{GeomType(t2).name}: "
                    "other narrowphase pairs are ROADMAP Queue A item 10.3")
    for c in model.pair_condim:
        if c not in (1, 3):
            return (f"condim {c}: condim 4/6 rows are ROADMAP Queue A "
                    "item 10.4")
    if model.na:
        return "stateful actuators are ROADMAP Queue A item 10.1"
    for u in range(model.nu):
        if (TrnType(model.actuator_trntype[u]) != TrnType.JOINT
                or DynType(model.actuator_dyntype[u]) != DynType.NONE
                or GainType(model.actuator_gaintype[u]) != GainType.FIXED
                or BiasType(model.actuator_biastype[u]) != BiasType.NONE):
            return (f"actuator {u} is not a motor on a joint: other "
                    "actuators are ROADMAP Queue A item 10.1")
    if model.ntendon:
        return "tendons are ROADMAP Queue A items 10.1 and 10.5"
    if model.neq:
        return "equality constraints are ROADMAP Queue A item 10.2"
    if model.nmocap:
        return "mocap bodies are ROADMAP Queue A item 10.8"
    if (not model.opt.disable_frictionloss
            and np.any(np.asarray(model.dof_frictionloss) > 0)):
        return "friction loss is ROADMAP Queue A item 10.1"
    if (model.opt.density != 0.0 or model.opt.viscosity != 0.0
            or any(float(w) != 0.0 for w in model.opt.wind)):
        return "fluid forces are ROADMAP Queue A item 10.6"
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
            "actuator_gainprm", "pair_friction", "pair_solref",
            "pair_solimp", "pair_margin", "pair_gap",
        ):
            setattr(self, name, _np(getattr(model, name)))


def _fk_chain(bk, model, mc, sub_mask, qpos):
    """FK + com geometry for hinge/slide trees: every position-dependent
    quantity the downstream stages read (xanchor/xaxis captured during the
    walk, before each joint's own transform, as mj_kinematics does)."""
    nbody, nv = model.nbody, model.nv
    xpos = [(0.0, 0.0, 0.0)] * nbody
    xquat = [(1.0, 0.0, 0.0, 0.0)] * nbody
    xanchor = [None] * model.njnt
    xaxis = [None] * model.njnt
    for b in range(1, nbody):
        p = model.body_parentid[b]
        pos = vadd3(xpos[p], qrot(xquat[p], tuple(mc.body_pos[b])))
        quat = qmul(xquat[p], tuple(mc.body_quat[b]))
        for j in smooth.body_joints(model, b):
            jt = model.jnt_type[j]
            qadr = model.jnt_qposadr[j]
            axis_local = mc.jnt_axis[j]
            jpos_local = tuple(mc.jnt_pos[j])
            axis_w = qrot(quat, tuple(axis_local))
            anchor = vadd3(pos, qrot(quat, jpos_local))
            if jt == JointType.SLIDE:
                disp = sub(qpos[qadr], float(mc.qpos0[qadr]))
                pos = vadd3(pos, vscale3(axis_w, disp))
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
        if model.jnt_type[j] == JointType.SLIDE:
            cdof[vadr] = ((0.0, 0.0, 0.0), xaxis[j])
        else:
            off = vsub3(com, xanchor[j])
            cdof[vadr] = (xaxis[j], cross3(xaxis[j], off))
    return dict(
        xpos=xpos, xquat=xquat, xmat=xmat, xipos=xipos, xanchor=xanchor,
        xaxis=xaxis, subtree_com=subtree_com, cdof=cdof,
    )


def build_step(model: Model, bk):
    """Build the scalar-graph step on backend ``bk``.

    Returns ``step(qpos, qvel, act, warmstart, ctrl) -> (qpos', qvel',
    act', warmstart')`` over python lists of backend values (one per
    generalized coordinate / activation / actuator).
    """
    reason = unsupported_reason(model)
    if reason is not None:
        raise ValueError(f"model not in the port's scalar-graph class: "
                         f"{reason}")
    mc = _ModelConsts(model)
    nq, nv, nu, nbody = model.nq, model.nv, model.nu, model.nbody
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

    def forward_pass(qpos, qvel, warmstart, ctrl):
        """Forward dynamics to qacc (no integration)."""
        fk = _fk_chain(bk, model, mc, sub_mask, qpos)
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
        for i in range(nv):
            j = model.dof_jntid[i]
            qadr = model.jnt_qposadr[j]
            stiff = float(mc.jnt_stiffness[j])
            spring = 0.0
            if stiff:
                spring = mul(
                    -stiff, sub(qpos[qadr], float(mc.qpos_spring[qadr]))
                )
            damp = mul(-float(mc.dof_damping[i]), qvel[i])
            qfrc_passive.append(add(spring, damp))

        qfrc_actuator = [0.0] * nv
        for u in range(nu):
            c = ctrl[u]
            if model.actuator_ctrllimited[u]:
                lo, hi = mc.actuator_ctrlrange[u]
                c = bk.clip(c, float(lo), float(hi))
            # joint transmission of a hinge/slide: moment = gear
            j = model.actuator_trnid[u]
            gear = float(mc.actuator_gear[u][0])
            moment = {model.jnt_dofadr[j]: gear}
            force = mul(float(mc.actuator_gainprm[u][0]), c)
            if model.actuator_forcelimited[u]:
                lo, hi = mc.actuator_forcerange[u]
                force = bk.clip(force, float(lo), float(hi))
            for dof, mval in moment.items():
                qfrc_actuator[dof] = fma(qfrc_actuator[dof], mval, force)

        qfrc_smooth = [
            add(add(qfrc_passive[i], neg(qfrc_bias[i])), qfrc_actuator[i])
            for i in range(nv)
        ]

        l_m = chol_factor(m_mat)
        qacc_smooth = chol_solve(l_m, qfrc_smooth)

        # ----------------- collision + efc assembly -----------------
        rows = _assemble_rows(bk, model, mc, qpos, qvel, xpos, xmat,
                              subtree_com, cdof, bd_mask, h)

        # ----------------- Newton solver -----------------
        qfrc_constraint = [0.0] * nv
        if rows:
            qacc, rows = _newton(bk, model, rows, m_mat, chol_factor,
                                 chol_solve, qacc_smooth, qfrc_smooth,
                                 warmstart, nv)
            for r in rows:
                fr = r["force"]
                for dof, val in r["J"].items():
                    qfrc_constraint[dof] = fma(qfrc_constraint[dof], val, fr)
        else:
            qacc = qacc_smooth
        return dict(qacc=qacc, qfrc_smooth=qfrc_smooth,
                    qfrc_constraint=qfrc_constraint, m_mat=m_mat)

    def step(qpos, qvel, act, warmstart, ctrl):
        fw = forward_pass(list(qpos), list(qvel), list(warmstart),
                          list(ctrl))
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
        # hinge/slide only: mj_integratePos is the plain vector update
        qpos_new = [add(qpos[i], mul(h, qvel_new[i])) for i in range(nq)]
        return qpos_new, qvel_new, list(act), list(fw["qacc"])

    return step


# ---------------------------------------------------------------------------
# constraint rows + Newton (scalar-graph form)
# ---------------------------------------------------------------------------


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
                   bd_mask, h):
    """Joint-limit and contact rows as dicts with a sparse J (MuJoCo row
    order: joint limits, then contacts).  All rows are unilateral: the
    force is max(-D jar, 0) on existing rows."""
    rows = []

    # scalar joint limits
    for j in range(model.njnt):
        if model.opt.disable_limit or not model.jnt_limited[j]:
            continue
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
                         exists=exists))

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
                                     exists=exists))
                else:
                    # pyramidal facets of the 2 tangent directions; the
                    # diagApprox of every facet uses friction[0]
                    jt1 = {dof: dot3(t1f, v) for dof, v in jrows.items()}
                    jt2 = {dof: dot3(t2f, v) for dof, v in jrows.items()}
                    axes = [(jt1, float(friction[0])),
                            (jt2, float(friction[1]))]
                    mu0 = float(friction[0])
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
                                             exists=exists))
                lane += 1
    return rows


def _np_contacts_sg(bk, model, mc, ta, tb, g1, g2, xpos, xmat):
    """Scalar narrowphase for one candidate pair: list of ``(dist, pos,
    normal, t1|None)`` lanes, len == max_contacts_per_pair.  Normals point
    geom1 -> geom2."""
    p1 = _geom_pos(model, mc, g1, xpos, xmat)
    m1 = _geom_mat(model, mc, g1, xmat)
    p2 = _geom_pos(model, mc, g2, xpos, xmat)
    m2 = _geom_mat(model, mc, g2, xmat)
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

    raise ValueError(
        f"pair type {ta.name}-{tb.name} not in the port's scalar-graph class"
    )


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


def _jdotv(jrow, qvel):
    s = 0.0
    for dof, val in jrow.items():
        s = fma(s, val, qvel[dof])
    return s


def _row_force_act(bk, r, jar_r):
    """(force, active mask) of one unilateral row at residual ``jar_r``:
    f = max(-D jar, 0) on existing rows."""
    act = r["exists"] & (jar_r < 0)
    return bk.where(act, -r["D"] * jar_r, 0.0), act


def _dphi_stacked(bk, rows, jar, jp, d0, sg):
    """The line search's ``dphi`` on the torch backend, over ``(rows, B)``
    stacks: every element goes through the same ops in the same order as
    the per-row form (the sum over rows stays a sequential loop), so the
    result is bit-identical, from about a tenth of the torch calls."""
    st = lambda xs: torch.stack([bk.full(x) for x in xs])
    jar_s, jp_s = st(jar), st(jp)
    neg_d = st([-r["D"] for r in rows])
    exists = st([r["exists"] for r in rows])

    def dphi(alpha):
        s = d0 + alpha * sg
        jar_a = jar_s + alpha * jp_s
        act = exists & (jar_a < 0)
        f_a = torch.where(act, neg_d * jar_a, torch.zeros_like(jar_a))
        df = f_a * jp_s
        for i in range(len(rows)):
            s = s - df[i]
        return s

    return dphi


def _row_cost(bk, r, jar_r):
    act = r["exists"] & (jar_r < 0)
    return bk.where(act, 0.5 * r["D"] * jar_r * jar_r, 0.0)


def _mat_vec_sym(m_mat, v, nv):
    out = [0.0] * nv
    for (i, j), val in m_mat.items():
        out[i] = fma(out[i], val, v[j])
        if i != j:
            out[j] = fma(out[j], val, v[i])
    return out


def _newton(bk, model, rows, m_mat, chol_factor, chol_solve, qacc_smooth,
            qfrc_smooth, warmstart, nv):
    """Scalar-graph Newton solver with the sort-free line search; the
    ``model.opt.iterations`` iterations run as one ``bk.fori`` carrying
    (x, jar)."""
    ne = len(rows)

    def jar_of(x):
        return [sub(_jdotv(r["J"], x), r["aref"]) for r in rows]

    def cost_parts(x, jar):
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
        return add(gauss, cons)

    jar_ws = jar_of(warmstart)
    jar_sm = jar_of(qacc_smooth)
    c_ws = cost_parts(warmstart, jar_ws)
    c_sm = cost_parts(qacc_smooth, jar_sm)
    use_ws = c_ws < c_sm
    x = [bk.where(use_ws, warmstart[i], qacc_smooth[i]) for i in range(nv)]
    jar = [bk.where(use_ws, a, b) for a, b in zip(jar_ws, jar_sm)]

    def iteration(carry):
        x, jar = carry[:nv], carry[nv:]
        fa = [_row_force_act(bk, r, jr) for r, jr in zip(rows, jar)]
        f = [x_[0] for x_ in fa]
        act = [x_[1] for x_ in fa]
        mx = _mat_vec_sym(m_mat, x, nv)
        grad = [sub(sub(mx[i], qfrc_smooth[i]), 0.0) for i in range(nv)]
        for r, fr in zip(rows, f):
            for dof, val in r["J"].items():
                grad[dof] = sub(grad[dof], mul(val, fr))
        # hessian = M + sum_act D J J^T
        hess = dict(m_mat)
        for r, a in zip(rows, act):
            w = bk.where(a, r["D"], 0.0)
            items = sorted(r["J"].items())
            for ii, (d1, v1) in enumerate(items):
                wv1 = mul(w, v1)
                for (d2, v2) in items[: ii + 1]:
                    key = (max(d1, d2), min(d1, d2))
                    hess[key] = add(hess.get(key, 0.0), mul(wv1, v2))
        l_h = chol_factor(hess)
        p = chol_solve(l_h, [neg(g) for g in grad])
        jp = [_jdotv(r["J"], p) for r in rows]
        mp = _mat_vec_sym(m_mat, p, nv)
        d0 = 0.0
        sg = 0.0
        for i in range(nv):
            d0 = fma(d0, p[i], sub(mx[i], qfrc_smooth[i]))
            sg = fma(sg, p[i], mp[i])
        alpha = _linesearch_scalar(bk, rows, jar, jp, d0, sg)
        x = [fma(x[i], alpha, p[i]) for i in range(nv)]
        jar = [fma(jr, alpha, jpr) for jr, jpr in zip(jar, jp)]
        return x + jar

    carry = bk.fori(model.opt.iterations, x + jar, iteration)
    x, jar = carry[:nv], carry[nv:nv + ne]

    # final forces
    for r, jr in zip(rows, jar):
        r["force"], _ = _row_force_act(bk, r, jr)
    return x, rows


def _linesearch_scalar(bk, rows, jar, jp, d0, sg, n_grow=12, n_bisect=26):
    """Monotone piecewise-linear derivative root find: doubling bracket then
    bisection (sort-free), both as ``bk.fori`` loops."""

    def dphi(alpha):
        # dcost/dalpha per row = -f(jar_a) * jp (piecewise linear in alpha)
        s = d0 + alpha * sg
        for r, jr, jpr in zip(rows, jar, jp):
            jar_a = jr + alpha * jpr
            f_a, _ = _row_force_act(bk, r, jar_a)
            s = s - f_a * jpr
        return s

    if isinstance(bk, TorchBackend) and rows:
        dphi = _dphi_stacked(bk, rows, jar, jp, d0, sg)

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
