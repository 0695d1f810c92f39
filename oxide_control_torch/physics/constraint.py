"""Constraint rows and the constraint solvers, batched.

The port of ``oxide_control_tpu/physics/constraint.py``: MuJoCo's soft
constraint model (impedance d(r), reference acceleration aref, regularizer
R = (1-d)/d * diagApprox), the efc rows of equality, friction loss,
limits and contacts (condim 1/3/4/6, pyramidal or elliptic cones), the
primal Newton and CG solvers with their exact line searches, the dual PGS
solver, and the per-contact force reconstruction.  Every row exists
statically with a runtime ``exists`` mask; every tensor has the env axis
first, where the reference ``vmap``s one env.  The solvers run
``opt.iterations`` iterations with no early exit, as the reference's
``fori_loop``s do, so nothing reads a value back to the host and the
step can be captured in a CUDA graph.
"""

from __future__ import annotations

import numpy as np
import torch

from ..model import ConeType, EqType, JointType, Model, SensorType, SolverType
from . import maths, smooth
from .collision import contact_condims, max_contacts_per_pair
from .consts import consts

_BIG = 1e12


# ---------------------------------------------------------------------------
# static row layout
# ---------------------------------------------------------------------------


def _limit_joints(model: Model) -> list[int]:
    if model.opt.disable_limit:
        return []
    out = []
    for j in range(model.njnt):
        if not model.jnt_limited[j]:
            continue
        if model.jnt_type[j] == JointType.FREE:
            raise NotImplementedError("free joints cannot be limited")
        if model.jnt_type[j] in (JointType.HINGE, JointType.SLIDE):
            out.append(j)
    return out


def _ball_limit_joints(model: Model) -> list[int]:
    if model.opt.disable_limit:
        return []
    return [j for j in range(model.njnt)
            if model.jnt_limited[j] and model.jnt_type[j] == JointType.BALL]


def _friction_dofs(model: Model) -> list[int]:
    if getattr(model.opt, "disable_frictionloss", False):
        return []
    fl = np.asarray(model.dof_frictionloss)
    return [int(i) for i in np.flatnonzero(fl > 0)]


def _friction_tendons(model: Model) -> list[int]:
    if getattr(model.opt, "disable_frictionloss", False) or not model.ntendon:
        return []
    fl = np.asarray(model.tendon_frictionloss)
    return [int(i) for i in np.flatnonzero(fl > 0)]


def _limit_tendons(model: Model) -> list[int]:
    if model.opt.disable_limit:
        return []
    return [t for t in range(model.ntendon) if model.tendon_limited[t]]


def _lane_bodies(model: Model) -> list[tuple[int, int]]:
    out = []
    for (t1, t2, pairs) in model.pair_groups:
        k = max_contacts_per_pair(t1, t2)
        for (g1, g2) in pairs:
            out.extend([(model.geom_bodyid[g1], model.geom_bodyid[g2])] * k)
    return out


_EQ_ROWS = {EqType.CONNECT: 3, EqType.WELD: 6, EqType.JOINT: 1,
            EqType.TENDON: 1}


def nefc(model: Model) -> int:
    """Static efc row count (rows may be inactive at runtime)."""
    n = sum(_EQ_ROWS[EqType(t)] for t in model.eq_type)
    n += len(_friction_dofs(model)) + len(_friction_tendons(model))
    n += len(_limit_joints(model)) + len(_ball_limit_joints(model))
    n += len(_limit_tendons(model))
    elliptic = model.opt.cone == ConeType.ELLIPTIC
    for condim in contact_condims(model):
        n += condim if elliptic else {1: 1, 3: 4, 4: 6, 6: 10}[condim]
    return n


def limit_row_map(model: Model) -> dict:
    """('joint'|'tendon', objid) -> efc row of its limit row, in the order
    of ``Data.efc_limit``."""
    n = sum(_EQ_ROWS[EqType(t)] for t in model.eq_type)
    n += len(_friction_dofs(model)) + len(_friction_tendons(model))
    out = {}
    for j in _limit_joints(model) + _ball_limit_joints(model):
        out[("joint", j)] = n
        n += 1
    for t in _limit_tendons(model):
        out[("tendon", t)] = n
        n += 1
    return out


def n_limit_rows(model: Model) -> int:
    return (len(_limit_joints(model)) + len(_ball_limit_joints(model))
            + len(_limit_tendons(model)))


def _needs_limit_sensor(model: Model) -> bool:
    lim = (SensorType.JOINTLIMITPOS, SensorType.JOINTLIMITVEL,
           SensorType.JOINTLIMITFRC, SensorType.TENDONLIMITPOS,
           SensorType.TENDONLIMITVEL, SensorType.TENDONLIMITFRC)
    return any(SensorType(t) in lim for t in model.sensor_type)


def _needs_contact_force(model: Model) -> bool:
    want = (SensorType.TOUCH, SensorType.FORCE, SensorType.TORQUE)
    return any(SensorType(t) in want for t in model.sensor_type)


# ---------------------------------------------------------------------------
# impedance and reference acceleration
# ---------------------------------------------------------------------------


def _impedance(solimp, pos):
    """d(r) from solimp = [dmin, dmax, width, midpoint, power]; dmin and
    dmax clamped into [1e-4, 0.9999] before the interpolation."""
    dmin = torch.clamp(solimp[..., 0], 0.0001, 0.9999)
    dmax = torch.clamp(solimp[..., 1], 0.0001, 0.9999)
    width = solimp[..., 2]
    mid = torch.clamp(solimp[..., 3], 0.0001, 0.9999)
    power = torch.clamp(solimp[..., 4], min=1.0)
    wpos = width > 0
    x = torch.abs(pos) / torch.where(wpos, width, torch.ones_like(width))
    x = torch.clamp(x, 0.0, 1.0)
    one = torch.ones_like(mid)
    a = one / torch.pow(mid, power - 1.0)
    b = one / torch.pow(1.0 - mid, power - 1.0)
    y = torch.where(x < mid, a * torch.pow(x, power),
                    1.0 - b * torch.pow(1.0 - x, power))
    imp = dmin + y * (dmax - dmin)
    return torch.where(wpos, imp, dmin)


def _kbi(model: Model, solref, solimp, pos):
    """(k, b, impedance) of MuJoCo's solver-parameter transformation."""
    dmax = torch.clamp(solimp[..., 1], 0.0001, 0.9999)
    imp = _impedance(solimp, pos)
    tc = torch.clamp(solref[..., 0], min=2.0 * model.opt.timestep)
    dr = solref[..., 1]
    one = torch.ones_like(dmax)
    b = 2.0 * one / (dmax * tc)
    k = one / (dmax * dmax * tc * tc * dr * dr)
    direct = (solref[..., 0] <= 0) & (solref[..., 1] <= 0)
    k = torch.where(direct, -solref[..., 0], k)
    b = torch.where(direct, -solref[..., 1], b)
    return k, b, imp


# ---------------------------------------------------------------------------
# efc assembly
# ---------------------------------------------------------------------------


def _point_jac(model: Model, d, K, point, body: int):
    """(B, 3, nv) translational jacobian of world ``point (B, 3)``."""
    return smooth._point_jac_b(model, d, K, point, body).transpose(-1, -2)


def _rot_jac(model: Model, d, K, body: int):
    """(B, 3, nv) rotational jacobian of ``body``."""
    mask = smooth._bdm(model, K)[body][:, None]
    return (d.cdof[..., :3] * mask).transpose(-1, -2)


def _rep(x, n: int):
    """Each entry of axis 1 repeated n times in place (repeat_interleave
    with a static count, as a view expansion)."""
    shape = x.shape
    return x.unsqueeze(2).expand(shape[:2] + (n,) + shape[2:]).reshape(
        (shape[0], shape[1] * n) + shape[2:])


class _Rows:
    """Accumulator of efc row blocks: J (B, n, nv), pos/aref/D (B, n),
    exists (B, n), floss (B, n); static per-row kinds."""

    def __init__(self):
        self.J, self.pos, self.aref, self.D = [], [], [], []
        self.exists, self.floss = [], []
        self.unilateral, self.is_friction, self.is_cone = [], [], []
        self.cone_groups = []   # static (start_row, condim) per contact
        self.cone_sets = []     # static (start_row, ncones, condim)
        self.cone_mu = []       # (B, ncones, 5) per set

    @property
    def n(self) -> int:
        return len(self.unilateral)

    def add_block(self, model, J, pos, solref, solimp, diag_approx, exists,
                  unilateral, vel, floss=None, acc0=None, imp_pos=None):
        k, b, imp = _kbi(model, solref, solimp,
                         pos if imp_pos is None else imp_pos)
        aref = -b * vel - k * imp * pos
        if acc0 is not None:
            aref = aref - acc0
        dd = imp / (1.0 - imp) / torch.clamp(diag_approx, min=1e-12)
        n = J.shape[1]
        self.J.append(J)
        self.pos.append(pos)
        self.aref.append(aref)
        self.D.append(dd)
        self.exists.append(exists.expand(pos.shape))
        self.unilateral.extend([bool(unilateral)] * n)
        self.is_friction.extend([floss is not None] * n)
        self.is_cone.extend([False] * n)
        self.floss.append(torch.zeros_like(pos) if floss is None
                          else floss.expand(pos.shape))

    def add_cone_set(self, J, pos, aref, D, exists, mu, condim):
        """Elliptic contacts of one condim: J (B, L*condim, nv), rows of
        contact l at l*condim..; exists (B, L); mu (B, L, 5)."""
        nl = exists.shape[1]
        start = self.n
        self.cone_sets.append((start, nl, condim))
        for li in range(nl):
            self.cone_groups.append((start + li * condim, condim))
        self.cone_mu.append(mu)
        self.J.append(J)
        self.pos.append(pos)
        self.aref.append(aref)
        self.D.append(D)
        self.exists.append(_rep(exists, condim))
        self.floss.append(torch.zeros_like(pos))
        self.unilateral.extend([True] * (nl * condim))
        self.is_friction.extend([False] * (nl * condim))
        self.is_cone.extend([True] * (nl * condim))


def _eq_cw_rows(model: Model, dd):
    """Connect/weld rows from kinematic state ``dd``: {e: [(J (B, nv),
    pos (B,), dap float), ...]} in equality order (see the reference)."""
    K = consts(model, dd.qpos)
    eq_data = np.asarray(model.eq_data, dtype=np.float64)
    iw = np.asarray(model.body_invweight0, dtype=np.float64)
    eqd = K.f("eq_data")
    out = {}
    for e in range(model.neq):
        et = EqType(model.eq_type[e])
        if et in (EqType.JOINT, EqType.TENDON):
            continue
        b1 = model.eq_obj1id[e]
        b2 = max(model.eq_obj2id[e], 0)
        rows_e = []
        if et == EqType.CONNECT:
            p1 = dd.xpos[:, b1] + maths.matvec(dd.xmat[:, b1], eqd[e, :3])
            p2 = dd.xpos[:, b2] + maths.matvec(dd.xmat[:, b2], eqd[e, 3:6])
            jdiff = (_point_jac(model, dd, K, p1, b1)
                     - _point_jac(model, dd, K, p2, b2))
            cpos = p1 - p2
            dap = float(iw[b1][0] + iw[b2][0])
            for i in range(3):
                rows_e.append((jdiff[:, i], cpos[:, i], dap))
        else:
            ts = float(eq_data[e][10])
            p1 = dd.xpos[:, b1] + maths.matvec(dd.xmat[:, b1], eqd[e, 3:6])
            p2 = dd.xpos[:, b2] + maths.matvec(dd.xmat[:, b2], eqd[e, :3])
            jdiff = (_point_jac(model, dd, K, p1, b1)
                     - _point_jac(model, dd, K, p2, b2))
            cpos = p1 - p2
            dap_t = float(iw[b1][0] + iw[b2][0])
            for i in range(3):
                rows_e.append((jdiff[:, i], cpos[:, i], dap_t))
            relquat = maths.quat_normalize(eqd[e, 6:10])
            q1 = dd.xquat[:, b1]
            q2 = dd.xquat[:, b2]
            conj_a = maths.quat_conj(maths.quat_mul(q1, relquat.expand_as(q1)))
            crot = -ts * maths.quat_mul(conj_a, q2)[:, 1:4]
            cols = []
            for kk in range(3):
                ek = torch.zeros_like(q1)
                ek[:, kk + 1] = 1.0
                cols.append(maths.quat_mul(maths.quat_mul(conj_a, ek),
                                           q2)[:, 1:4])
            v_mat = torch.stack(cols, -1)                      # (B, 3, 3)
            jr = _rot_jac(model, dd, K, b2) - _rot_jac(model, dd, K, b1)
            jrot = (-0.5 * ts) * (v_mat @ jr)
            dap_r = float(iw[b1][1] + iw[b2][1])
            for i in range(3):
                rows_e.append((jrot[:, i], crot[:, i], dap_r))
        out[e] = rows_e
    return out


def _qpos_tangent(model: Model, qpos, qvel):
    """d(qpos)/dt on the configuration manifold (quaternion joints:
    0.5 * q * (0, w))."""
    if model.nq == model.nv:
        return qvel
    cols = []
    for j in range(model.njnt):
        jt = model.jnt_type[j]
        qadr = model.jnt_qposadr[j]
        vadr = model.jnt_dofadr[j]
        if jt in (JointType.HINGE, JointType.SLIDE):
            cols.append(qvel[:, vadr:vadr + 1])
        elif jt == JointType.BALL:
            w = torch.cat([torch.zeros_like(qvel[:, :1]),
                           qvel[:, vadr:vadr + 3]], -1)
            cols.append(0.5 * maths.quat_mul(qpos[:, qadr:qadr + 4], w))
        else:
            cols.append(qvel[:, vadr:vadr + 3])
            w = torch.cat([torch.zeros_like(qvel[:, :1]),
                           qvel[:, vadr + 3:vadr + 6]], -1)
            cols.append(0.5 * maths.quat_mul(qpos[:, qadr + 3:qadr + 7], w))
    # joints are laid out in qpos order
    return torch.cat(cols, -1)


def _eq_cw_vel(model: Model, d):
    """(J qvel, Jdot qvel) of every connect/weld row: the forward-mode
    derivative of qpos -> J(qpos) qvel along the manifold tangent, as the
    reference's ``jax.jvp``."""
    def cw_vels(qp):
        dd = d.replace(qpos=qp)
        dd = smooth.kinematics(model, dd)
        dd = smooth.com_pos(model, dd)
        rr = _eq_cw_rows(model, dd)
        return torch.stack([(J * d.qvel).sum(-1) for e in sorted(rr)
                            for (J, _, _) in rr[e]], 1)

    qdot = _qpos_tangent(model, d.qpos, d.qvel)
    return torch.func.jvp(cw_vels, (d.qpos,), (qdot,))


def make_efc(model: Model, d):
    """Assemble every constraint row; None if the model has none."""
    K = consts(model, d.qpos)
    bsz = d.qpos.shape[0]
    nv = model.nv
    rows = _Rows()
    iw_dof = K.f("dof_invweight0")

    def full(x):
        return torch.full_like(d.time, float(x))

    # ----- equality -----
    cw = _eq_cw_rows(model, d)
    if cw:
        cw_vel, cw_jdotv = _eq_cw_vel(model, d)
    ri = 0
    ten_lm = None
    eq_data = np.asarray(model.eq_data, dtype=np.float64)
    qpos0 = np.asarray(model.qpos0, dtype=np.float64)
    eq_solref, eq_solimp = K.f("eq_solref"), K.f("eq_solimp")
    iwd_np = np.asarray(model.dof_invweight0, dtype=np.float64)
    for e in range(model.neq):
        et = EqType(model.eq_type[e])
        solref, solimp = eq_solref[e:e + 1], eq_solimp[e:e + 1]
        active = d.eq_active[:, e:e + 1]
        if et == EqType.JOINT:
            j1, j2 = model.eq_obj1id[e], model.eq_obj2id[e]
            a1, v1 = model.jnt_qposadr[j1], model.jnt_dofadr[j1]
            poly = [float(x) for x in eq_data[e][:5]]
            Jn = np.zeros(nv)
            Jn[v1] = 1.0
            if j2 >= 0:
                a2, v2 = model.jnt_qposadr[j2], model.jnt_dofadr[j2]
                dif = d.qpos[:, a2] - float(qpos0[a2])
                val = sum(poly[i] * dif ** i for i in range(5))
                pos = (d.qpos[:, a1] - float(qpos0[a1])) - val
                dpoly = sum(poly[i + 1] * ((i + 1.0) * dif ** i)
                            for i in range(4))
                J = K.t(f"eqj_{e}", lambda r=Jn: r).expand(bsz, nv).clone()
                J[:, v2] = J[:, v2] - dpoly
                dap = float(iwd_np[v1] + iwd_np[v2])
            else:
                pos = (d.qpos[:, a1] - float(qpos0[a1])) - poly[0]
                J = K.t(f"eqj_{e}", lambda r=Jn: r).expand(bsz, nv)
                dap = float(iwd_np[v1])
            rows.add_block(model, J[:, None], pos[:, None], solref, solimp,
                           full(dap)[:, None], active, False,
                           vel=(J * d.qvel).sum(-1)[:, None])
        elif et == EqType.TENDON:
            t1, t2 = model.eq_obj1id[e], model.eq_obj2id[e]
            if ten_lm is None:
                ten_lm = smooth.tendon_length_moment(model, d)
            tlen, tmom = ten_lm
            len0 = np.asarray(model.tendon_length0, dtype=np.float64)
            tiw = np.asarray(model.tendon_invweight0, dtype=np.float64)
            poly = [float(x) for x in eq_data[e][:5]]
            if t2 >= 0:
                dif = tlen[:, t2] - float(len0[t2])
                val = sum(poly[i] * dif ** i for i in range(5))
                pos = (tlen[:, t1] - float(len0[t1])) - val
                dpoly = sum(poly[i + 1] * ((i + 1.0) * dif ** i)
                            for i in range(4))
                J = tmom[:, t1] - dpoly[:, None] * tmom[:, t2]
                dap = float(tiw[t1] + tiw[t2])
            else:
                pos = (tlen[:, t1] - float(len0[t1])) - poly[0]
                J = tmom[:, t1]
                dap = float(tiw[t1])
            rows.add_block(model, J[:, None], pos[:, None], solref, solimp,
                           full(dap)[:, None], active, False,
                           vel=(J * d.qvel).sum(-1)[:, None])
        else:
            res = torch.stack([p for (_, p, _) in cw[e]], -1)
            res_norm = maths.norm(res)[:, None]
            for (J, pos, dap) in cw[e]:
                rows.add_block(model, J[:, None], pos[:, None], solref,
                               solimp, full(dap)[:, None], active, False,
                               vel=cw_vel[:, ri:ri + 1],
                               acc0=cw_jdotv[:, ri:ri + 1],
                               imp_pos=res_norm)
                ri += 1

    # ----- dof friction loss -----
    fr_dofs = _friction_dofs(model)
    if fr_dofs:
        idx = K.i("fr_dofs", lambda: fr_dofs)
        onehot = np.zeros((len(fr_dofs), nv))
        onehot[np.arange(len(fr_dofs)), fr_dofs] = 1.0
        J = K.t("fr_dofs_J", lambda: onehot).expand(bsz, -1, -1)
        zero = d.qpos.new_zeros((bsz, len(fr_dofs)))
        fl = K.f("dof_frictionloss")[idx]
        rows.add_block(model, J, zero, K.f("dof_solref")[idx],
                       K.f("dof_solimp")[idx], iw_dof[idx].expand_as(zero),
                       (fl > 0).expand_as(zero), False, vel=d.qvel[:, idx],
                       floss=fl)

    # ----- tendon friction loss -----
    fr_tens = _friction_tendons(model)
    if fr_tens:
        if ten_lm is None:
            ten_lm = smooth.tendon_length_moment(model, d)
        idx = K.i("fr_tens", lambda: fr_tens)
        J = ten_lm[1][:, idx]
        zero = d.qpos.new_zeros((bsz, len(fr_tens)))
        fl = K.f("tendon_frictionloss")[idx]
        rows.add_block(model, J, zero, K.f("tendon_solref_fri")[idx],
                       K.f("tendon_solimp_fri")[idx],
                       K.f("tendon_invweight0")[idx].expand_as(zero),
                       (fl > 0).expand_as(zero), False,
                       vel=(J * d.qvel[:, None]).sum(-1), floss=fl)

    # ----- joint limits -----
    lim = _limit_joints(model)
    if lim:
        jidx = K.i("lim_j", lambda: lim)
        qadr = K.i("lim_q", lambda: [model.jnt_qposadr[j] for j in lim])
        vadr_l = [model.jnt_dofadr[j] for j in lim]
        vadr = K.i("lim_v", lambda: vadr_l)
        rng = K.f("jnt_range")[jidx]
        q = d.qpos[:, qadr]
        dist_lo = q - rng[:, 0]
        dist_hi = rng[:, 1] - q
        dist = torch.minimum(dist_lo, dist_hi)
        sign = torch.where(dist_lo < dist_hi, torch.ones_like(q),
                           -torch.ones_like(q))
        margin = K.f("jnt_margin")[jidx]
        exists = dist < margin
        pos = torch.where(exists, dist - margin, torch.zeros_like(dist))
        onehot = np.zeros((len(lim), nv))
        onehot[np.arange(len(lim)), vadr_l] = 1.0
        J = K.t("lim_J", lambda: onehot) * sign[:, :, None]
        rows.add_block(model, J, pos, K.f("jnt_solref")[jidx],
                       K.f("jnt_solimp")[jidx], iw_dof[vadr].expand_as(pos),
                       exists, True, vel=sign * d.qvel[:, vadr])

    # ----- ball joint limits -----
    jrange = np.asarray(model.jnt_range, dtype=np.float64)
    for j in _ball_limit_joints(model):
        qadr = model.jnt_qposadr[j]
        vadr = model.jnt_dofadr[j]
        q = maths.quat_normalize(d.qpos[:, qadr:qadr + 4])
        sin_half = maths.norm(q[:, 1:4])
        angle = 2.0 * torch.atan2(sin_half, q[:, 0])
        angle = torch.where(angle > np.pi, angle - 2.0 * np.pi, angle)
        big = sin_half > 1e-12
        axis = torch.where(
            big[:, None],
            q[:, 1:4] / torch.where(big, sin_half,
                                    torch.ones_like(sin_half))[:, None],
            torch.zeros_like(q[:, 1:4]) + K.t("zaxis", lambda: [0, 0, 1.0]))
        axis = axis * torch.sign(torch.where(angle == 0,
                                             torch.ones_like(angle),
                                             angle))[:, None]
        dist = float(jrange[j].max()) - torch.abs(angle)
        margin = float(np.asarray(model.jnt_margin)[j])
        exists_b = dist < margin
        pos_b = torch.where(exists_b, dist - margin, torch.zeros_like(dist))
        J = torch.cat([d.qpos.new_zeros((bsz, vadr)), -axis,
                       d.qpos.new_zeros((bsz, nv - vadr - 3))], -1)
        rows.add_block(model, J[:, None], pos_b[:, None],
                       K.f("jnt_solref")[j:j + 1], K.f("jnt_solimp")[j:j + 1],
                       iw_dof[vadr:vadr + 1].expand(bsz, 1),
                       exists_b[:, None], True,
                       vel=(J * d.qvel).sum(-1)[:, None])

    # ----- tendon limits -----
    lim_tens = _limit_tendons(model)
    if lim_tens:
        if ten_lm is None:
            ten_lm = smooth.tendon_length_moment(model, d)
        idx = K.i("lim_t", lambda: lim_tens)
        length = ten_lm[0][:, idx]
        rng = K.f("tendon_range")[idx]
        dist_lo = length - rng[:, 0]
        dist_hi = rng[:, 1] - length
        dist = torch.minimum(dist_lo, dist_hi)
        sign = torch.where(dist_lo < dist_hi, torch.ones_like(dist),
                           -torch.ones_like(dist))
        margin = K.f("tendon_margin")[idx]
        exists_t = dist < margin
        pos_t = torch.where(exists_t, dist - margin, torch.zeros_like(dist))
        J = ten_lm[1][:, idx] * sign[:, :, None]
        rows.add_block(model, J, pos_t, K.f("tendon_solref_lim")[idx],
                       K.f("tendon_solimp_lim")[idx],
                       K.f("tendon_invweight0")[idx].expand_as(pos_t),
                       exists_t, True, vel=(J * d.qvel[:, None]).sum(-1))

    # ----- contacts -----
    condims = contact_condims(model)
    if model.opt.disable_contact:
        condims = []
    bad = [c for c in condims if c not in (1, 3, 4, 6)]
    if bad:
        raise NotImplementedError(f"condim {bad[0]} not supported")
    bodies = _lane_bodies(model)
    con = d.contact
    bdm = smooth._bdm(model, K)
    ang = d.cdof[..., :3]
    lin = d.cdof[..., 3:]
    elliptic = model.opt.cone == ConeType.ELLIPTIC
    impratio = float(model.opt.impratio)
    contact_layout = []
    iwb = K.f("body_invweight0")

    for condim in (1, 3, 4, 6):
        lanes = [i for i, c in enumerate(condims) if c == condim]
        if not lanes:
            continue
        L = len(lanes)
        idx = K.i(f"lanes_{condim}", lambda ls=lanes: ls)
        b1 = K.i(f"lanes_b1_{condim}", lambda ls=lanes: [bodies[i][0]
                                                          for i in ls])
        b2 = K.i(f"lanes_b2_{condim}", lambda ls=lanes: [bodies[i][1]
                                                          for i in ls])
        rootid = K.i("body_rootid", lambda: model.body_rootid)
        pos_l = con.pos[:, idx]

        def side_jac(bids):
            origin = d.subtree_com[:, rootid[bids]]
            arm = (pos_l - origin)[:, :, None, :]
            jacp = lin[:, None] + maths.cross(ang[:, None], arm)
            return (jacp * bdm[bids][None, :, :, None]).transpose(-1, -2)

        def side_jacr(bids):
            jr = ang[:, None] * bdm[bids][None, :, :, None]
            return jr.transpose(-1, -2)

        jdiff = side_jac(b2) - side_jac(b1)                  # (B, L, 3, nv)
        frame = con.frame[:, idx]
        dist = con.dist[:, idx]
        margin = con.includemargin[:, idx]
        exists = dist < margin
        pos = torch.where(exists, dist - margin, torch.zeros_like(dist))
        iw = iwb[b1, 0] + iwb[b2, 0]
        jn = torch.einsum("blk,blkv->blv", frame[:, :, 0], jdiff)
        solref, solimp = con.solref[:, idx], con.solimp[:, idx]
        mu_all = con.friction[:, idx]                        # (B, L, 5)
        if condim == 1:
            start = rows.n
            for li, lane in enumerate(lanes):
                contact_layout.append((lane, start + li, 1, 1, False))
            rows.add_block(model, jn, pos, solref, solimp,
                           iw.expand_as(pos), exists, True,
                           vel=(jn * d.qvel[:, None]).sum(-1))
            continue
        jrows = [jn,
                 torch.einsum("blk,blkv->blv", frame[:, :, 1], jdiff),
                 torch.einsum("blk,blkv->blv", frame[:, :, 2], jdiff)]
        if condim >= 4:
            jr = side_jacr(b2) - side_jacr(b1)
            jrows.append(torch.einsum("blk,blkv->blv", frame[:, :, 0], jr))
        if condim == 6:
            jrows.append(torch.einsum("blk,blkv->blv", frame[:, :, 1], jr))
            jrows.append(torch.einsum("blk,blkv->blv", frame[:, :, 2], jr))
        if elliptic:
            Jc = torch.stack(jrows, 2)                       # (B, L, c, nv)
            k, b, imp = _kbi(model, solref, solimp, pos)
            d0 = imp / (1.0 - imp) / torch.clamp(iw, min=1e-12)
            mu = mu_all[..., :condim - 1]
            s2 = (mu / mu_all[..., :1]) ** 2
            D_c = torch.cat([d0[..., None], d0[..., None] * impratio * s2],
                            -1)
            vel_c = (Jc * d.qvel[:, None, None]).sum(-1)
            aref_c = -b[..., None] * vel_c - torch.cat(
                [(k * imp * pos)[..., None],
                 torch.zeros_like(vel_c[..., 1:])], -1)
            pos_c = torch.cat([pos[..., None],
                               torch.zeros_like(vel_c[..., 1:])], -1)
            start = rows.n
            for li, lane in enumerate(lanes):
                contact_layout.append((lane, start + li * condim, condim,
                                       condim, True))
            rows.add_cone_set(Jc.reshape(bsz, L * condim, nv),
                              pos_c.reshape(bsz, -1), aref_c.reshape(bsz, -1),
                              D_c.reshape(bsz, -1), exists, mu_all, condim)
            continue
        ndir = condim - 1
        nrow = 2 * ndir
        ax = torch.stack(jrows[1:], 2)                       # (B, L, ndir, nv)
        mu = mu_all[..., :ndir]
        signs = K.t("pm_signs", lambda: [1.0, -1.0])
        jp = (jn[:, :, None, None, :] + signs[None, None, None, :, None]
              * mu[..., None, None] * ax[:, :, :, None, :])
        jp = jp.reshape(bsz, L * nrow, nv)
        mu02 = mu_all[..., 0] ** 2
        dap = _rep(iw * 2.0 * mu02 * (1.0 + mu02), nrow)

        def rep(x):
            return _rep(x, nrow)

        start = rows.n
        for li, lane in enumerate(lanes):
            contact_layout.append((lane, start + li * nrow, condim, nrow,
                                   False))
        rows.add_block(model, jp, rep(pos), rep(solref), rep(solimp), dap,
                       rep(exists), True, vel=(jp * d.qvel[:, None]).sum(-1))

    if not rows.J:
        return None
    key = lambda name, v: K.b(f"efc_{name}", lambda: np.asarray(v, bool))
    return dict(
        J=torch.cat(rows.J, 1),
        pos=torch.cat(rows.pos, 1),
        aref=torch.cat(rows.aref, 1),
        D=torch.cat(rows.D, 1),
        exists=torch.cat(rows.exists, 1),
        floss=torch.cat(rows.floss, 1),
        unilateral=key("uni", rows.unilateral),
        is_friction=key("fri", rows.is_friction),
        is_cone=key("cone", rows.is_cone),
        any_cone=bool(rows.cone_sets),
        cone_groups=tuple(rows.cone_groups),
        cone_sets=tuple(rows.cone_sets),
        cone_mu=rows.cone_mu,
        impratio=impratio,
        contact_layout=tuple(contact_layout),
    )


# ---------------------------------------------------------------------------
# forces and costs
# ---------------------------------------------------------------------------


def _force_bounds(efc):
    """Per-row force clamp (lo, hi): equality (-BIG, BIG), unilateral
    (0, BIG), friction loss (-floss, floss)."""
    fl = efc["floss"]
    big = torch.full_like(fl, _BIG)
    lo = torch.where(efc["is_friction"], -fl,
                     torch.where(efc["unilateral"], torch.zeros_like(fl),
                                 -big))
    hi = torch.where(efc["is_friction"], fl, big)
    return lo, hi


def _cone_force_cost(efc, jar):
    """Elliptic cones: (force (B, n) on the cone rows, cost (B,)) -- the
    D^-1-metric projection onto each friction cone and its Moreau
    envelope, vectorized over the contacts of each condim."""
    force = torch.zeros_like(jar)
    cost = torch.zeros_like(jar[:, 0])
    parts = []
    for (start, nc, dim), cmu in zip(efc["cone_sets"], efc["cone_mu"]):
        sl = slice(start, start + nc * dim)
        bsz = jar.shape[0]
        D_c = efc["D"][:, sl].reshape(bsz, nc, dim)
        g = -D_c * jar[:, sl].reshape(bsz, nc, dim)
        mu = cmu[..., :dim - 1]
        ghat = g[..., 1:] / mu
        gT = maths.norm(ghat)
        mu1 = cmu[..., 0]
        mub2 = mu1 * mu1 / efc["impratio"]
        one = torch.ones_like(mub2)
        wa = one / (1.0 + mub2)
        wb = mub2 / (1.0 + mub2)
        t = wa * g[..., 0] + wb * gT
        bottom = g[..., 0] >= gT
        zero = t <= 0.0
        safe_t = torch.where(gT > 1e-15, gT, torch.ones_like(gT))
        zf = torch.zeros_like(t)
        f0 = torch.where(bottom, g[..., 0], torch.where(zero, zf, t))
        ft = torch.where(bottom[..., None], g[..., 1:],
                         torch.where(zero[..., None], torch.zeros_like(ghat),
                                     mu * t[..., None] * ghat
                                     / safe_t[..., None]))
        f_c = torch.cat([f0[..., None], ft], -1)
        ex = efc["exists"][:, start:start + nc * dim:dim]      # (B, nc)
        f_c = torch.where(ex[..., None], f_c, torch.zeros_like(f_c))
        dinv = 1.0 / torch.clamp(D_c, min=1e-30)
        c = (0.5 * (g * g * dinv).sum(-1)
             - 0.5 * ((g - f_c) ** 2 * dinv).sum(-1))
        cost = cost + torch.where(ex, c, torch.zeros_like(c)).sum(-1)
        parts.append((sl, f_c.reshape(bsz, nc * dim)))
    if parts:
        pieces, at = [], 0
        for sl, fc in parts:
            pieces.append(force[:, at:sl.start])
            pieces.append(fc)
            at = sl.stop
        pieces.append(force[:, at:])
        force = torch.cat(pieces, 1)
    return force, cost


def _efc_force(efc, jar):
    lo, hi = _force_bounds(efc)
    f = torch.minimum(torch.maximum(-efc["D"] * jar, lo), hi)
    f = torch.where(efc["exists"], f, torch.zeros_like(f))
    if efc["any_cone"]:
        cone_f, _ = _cone_force_cost(efc, jar)
        f = torch.where(efc["is_cone"], cone_f, f)
    return f


def _cost(efc, x, qacc_smooth, jar, qM):
    """Gauss term plus the rows' piecewise cost (cones: their Moreau
    envelope)."""
    dx = x - qacc_smooth
    gauss = 0.5 * (dx * maths.matvec(qM, dx)).sum(-1)
    lo, hi = _force_bounds(efc)
    D = efc["D"]
    gc = torch.minimum(torch.maximum(D * jar, -hi), -lo)
    cons = gc * jar - 0.5 * gc * gc / torch.clamp(D, min=1e-30)
    keep = efc["exists"]
    if efc["any_cone"]:
        keep = keep & ~efc["is_cone"]
        _, cone_cost = _cone_force_cost(efc, jar)
        gauss = gauss + cone_cost
    return gauss + torch.where(keep, cons, torch.zeros_like(cons)).sum(-1)


def _linesearch_bisect(efc, jar, jp, d0_gauss, slope_gauss):
    """Doubling bracket + bisection on the nondecreasing phi'(alpha)
    (elliptic cones)."""

    def dphi(alpha):
        f = _efc_force(efc, jar + alpha[:, None] * jp)
        return d0_gauss + alpha * slope_gauss - (jp * f).sum(-1)

    hi = torch.ones_like(d0_gauss)
    for _ in range(16):
        hi = torch.where(dphi(hi) < 0, hi * 4.0, hi)
    lo = torch.zeros_like(hi)
    for _ in range(44):
        mid = 0.5 * (lo + hi)
        neg = dphi(mid) < 0
        lo = torch.where(neg, mid, lo)
        hi = torch.where(neg, hi, mid)
    alpha = 0.5 * (lo + hi)
    return torch.where(dphi(torch.zeros_like(alpha)) >= 0,
                       torch.zeros_like(alpha), alpha)


def _linesearch(efc, jar, jp, d0_gauss, slope_gauss):
    """Exact minimization of the piecewise-quadratic cost along p: the
    zero of phi'(alpha) located among its sorted clamp breakpoints.

    phi'(alpha) = d0 + alpha * slope + sum_i jp_i clip(D_i jar_i(alpha),
    glo_i, ghi_i) is continuous and piecewise linear; each row's term is
    affine between its (up to two) breakpoints.  The reference evaluates
    the sum afresh at every breakpoint (O(n^2) per env); here the rows'
    affine pieces at alpha = 0+ and the change of piece at each breakpoint
    are summed once and accumulated in breakpoint order (O(n log n)),
    which gives the same phi' at every breakpoint up to rounding.  The
    bracketing, interpolation and extrapolation are the reference's."""
    if efc["any_cone"]:
        return _linesearch_bisect(efc, jar, jp, d0_gauss, slope_gauss)
    exists = efc["exists"]
    D = efc["D"]
    lo, hi = _force_bounds(efc)
    glo, ghi = -hi, -lo
    zero = torch.zeros_like(jar)

    def dphi(alpha):
        """phi' at alpha (B,), summed over the rows."""
        gc = torch.minimum(torch.maximum(D * (jar + alpha[:, None] * jp),
                                         glo), ghi)
        return (d0_gauss + alpha * slope_gauss
                + torch.where(exists, jp * gc, zero).sum(-1))

    valid = exists & (torch.abs(jp) > 1e-15)
    safe_jp = torch.where(valid, jp, torch.ones_like(jp))
    safe_d = torch.clamp(D, min=1e-30)
    big = torch.full_like(jar, _BIG)
    b_lo = torch.where(valid & (glo > -_BIG), (glo / safe_d - jar) / safe_jp,
                       big)
    b_hi = torch.where(valid & (ghi < _BIG), (ghi / safe_d - jar) / safe_jp,
                       big)
    alpha_b = torch.cat([b_lo, b_hi], 1)
    alpha_b = torch.where(alpha_b > 0, alpha_b, torch.full_like(alpha_b,
                                                                _BIG))
    # each row's term jp * clip(g) as A + B * alpha: clamped low or high
    # (B = 0) or in band; at alpha = 0+ a row on a band edge takes the
    # side it moves to
    g0 = D * jar
    up = jp > 0
    band_a, band_b = jp * g0, D * jp * jp
    low = (g0 < glo) | ((g0 == glo) & ~up)
    high = (g0 > ghi) | ((g0 == ghi) & up)
    a0 = torch.where(low, jp * glo, torch.where(high, jp * ghi, band_a))
    b0 = torch.where(low | high, zero, band_b)
    a0 = torch.where(exists, a0, zero).sum(-1)
    b0 = torch.where(exists, b0, zero).sum(-1)
    # the change of piece at each breakpoint: crossing glo enters the band
    # moving up and leaves it moving down, crossing ghi the reverse
    da = torch.cat([torch.where(up, band_a - jp * glo, jp * glo - band_a),
                    torch.where(up, jp * ghi - band_a, band_a - jp * ghi)], 1)
    db = torch.cat([torch.where(up, band_b, -band_b),
                    torch.where(up, -band_b, band_b)], 1)
    # breakpoints past the evaluation clip (1e8) change nothing there
    happen = alpha_b < 1e8
    da = torch.where(happen, da, torch.zeros_like(da))
    db = torch.where(happen, db, torch.zeros_like(db))
    alpha_s, order = torch.sort(alpha_b, dim=1)
    # clip evaluation points to avoid inf in low precision; crossing at
    # _BIG is handled by the extrapolation branch
    alpha_eval = torch.clamp(alpha_s, max=1e8)
    ca = torch.cumsum(torch.gather(da, 1, order), 1)
    cb = torch.cumsum(torch.gather(db, 1, order), 1)
    d_at = (d0_gauss[:, None] + alpha_eval * slope_gauss[:, None]
            + (a0[:, None] + ca) + (b0[:, None] + cb) * alpha_eval)
    d_0 = dphi(torch.zeros_like(d0_gauss))
    crossed = d_at >= 0
    any_crossed = crossed.any(1)
    k = torch.argmax(crossed.to(torch.int8), dim=1)
    km1 = torch.clamp(k - 1, min=0)[:, None]
    kpos = k > 0
    prev_alpha = torch.where(kpos, torch.gather(alpha_eval, 1, km1)[:, 0],
                             torch.zeros_like(d_0))
    prev_d = torch.where(kpos, torch.gather(d_at, 1, km1)[:, 0], d_0)
    cur_alpha = torch.gather(alpha_eval, 1, k[:, None])[:, 0]
    cur_d = torch.gather(d_at, 1, k[:, None])[:, 0]
    denom = cur_d - prev_d
    okd = torch.abs(denom) > 1e-30
    frac = torch.where(okd, -prev_d / torch.where(okd, denom,
                                                  torch.ones_like(denom)),
                       torch.zeros_like(denom))
    alpha_seg = prev_alpha + frac * (cur_alpha - prev_alpha)
    act_inf = exists & (((jp > 0) & (ghi >= _BIG))
                        | ((jp < 0) & (glo <= -_BIG)))
    slope_inf = slope_gauss + torch.where(act_inf, D * jp * jp, zero).sum(1)
    last_alpha = torch.where(alpha_b < _BIG, alpha_eval,
                             torch.zeros_like(alpha_eval)).max(1).values
    d_last = dphi(last_alpha)
    alpha_ext = last_alpha - d_last / torch.clamp(slope_inf, min=1e-30)
    alpha = torch.where(any_crossed, alpha_seg, alpha_ext)
    alpha = torch.where(d_0 >= 0, torch.zeros_like(alpha), alpha)
    return torch.clamp(alpha, min=0.0)


# ---------------------------------------------------------------------------
# solvers
# ---------------------------------------------------------------------------


def _start(efc, d):
    """Warmstart: the better of qacc_warmstart and qacc_smooth."""
    J, aref, qM = efc["J"], efc["aref"], d.qM

    def cost_of(x):
        jar = maths.matvec(J, x) - aref
        return _cost(efc, x, d.qacc_smooth, jar, qM), jar

    c_ws, jar_ws = cost_of(d.qacc_warmstart)
    c_sm, jar_sm = cost_of(d.qacc_smooth)
    use_ws = c_ws < c_sm
    x0 = torch.where(use_ws[:, None], d.qacc_warmstart, d.qacc_smooth)
    jar0 = torch.where(use_ws[:, None], jar_ws, jar_sm)
    return x0, jar0, torch.minimum(c_ws, c_sm)


def _improved(model, cost, new_cost):
    return ((cost - new_cost) > model.opt.tolerance * torch.clamp(
        torch.abs(cost), min=1.0)).to(torch.int64)


def _result(d, efc, x, jar, cost, gradnorm, niter, qfrc=None):
    f = _efc_force(efc, jar)
    J = efc["J"]
    return d.replace(
        qacc=x,
        qfrc_constraint=(J * f[..., None]).sum(1) if qfrc is None else qfrc,
        qacc_warmstart=x,
        nefc_active=efc["exists"].sum(1),
        solver_cost=cost, solver_gradnorm=gradnorm, solver_niter=niter)


def _solve_cg(model: Model, d, efc):
    """Nonlinear CG with the exact line search and Polak-Ribiere
    restarts, preconditioned by M^-1."""
    qM = d.qM
    chol = maths.cholesky(qM)
    J, qfrc_smooth = efc["J"], d.qfrc_smooth

    def grad_of(x, jar):
        f = _efc_force(efc, jar)
        return maths.matvec(qM, x) - qfrc_smooth - (J * f[..., None]).sum(1)

    x, jar, cost = _start(efc, d)
    g = grad_of(x, jar)
    mg = maths.cho_solve(chol, g)
    p = -mg
    niter = torch.zeros_like(d.solver_niter)
    for _ in range(model.opt.iterations):
        jp = maths.matvec(J, p)
        mp = maths.matvec(qM, p)
        d0_gauss = (p * (maths.matvec(qM, x) - qfrc_smooth)).sum(-1)
        slope_gauss = (p * mp).sum(-1)
        alpha = _linesearch(efc, jar, jp, d0_gauss, slope_gauss)
        x = x + alpha[:, None] * p
        jar = jar + alpha[:, None] * jp
        g_new = grad_of(x, jar)
        mg_new = maths.cho_solve(chol, g_new)
        denom = (g * mg).sum(-1)
        beta = (g_new * (mg_new - mg)).sum(-1) / torch.where(
            denom > 1e-30, denom, torch.ones_like(denom))
        beta = torch.clamp(beta, min=0.0)
        p = -mg_new + beta[:, None] * p
        g, mg = g_new, mg_new
        new_cost = _cost(efc, x, d.qacc_smooth, jar, qM)
        niter = niter + _improved(model, cost, new_cost)
        cost = new_cost
    return _result(d, efc, x, jar, cost, maths.norm(grad_of(x, jar)), niter)


def _cone_hess(efc, jar):
    """Per-contact cost Hessian blocks of the elliptic cones wrt their
    jar slices: [(start, nc, dim, h (B, nc, dim, dim)), ...]."""
    out = []
    for (start, nc, dim), cmu in zip(efc["cone_sets"], efc["cone_mu"]):
        bsz = jar.shape[0]
        sl = slice(start, start + nc * dim)
        D_c = efc["D"][:, sl].reshape(bsz, nc, dim)
        g = -D_c * jar[:, sl].reshape(bsz, nc, dim)
        mu = cmu[..., :dim - 1]
        mu1 = cmu[..., 0]
        q = g[..., 1:] / mu
        Q = maths.norm(q)
        safe_q = torch.where(Q > 1e-15, Q, torch.ones_like(Q))
        mub2 = mu1 * mu1 / efc["impratio"]
        one = torch.ones_like(mub2)
        a = one / D_c[..., 0]
        b = mub2 / D_c[..., 0]
        wa = one / (1.0 + mub2)
        wb = mub2 / (1.0 + mub2)
        t = wa * g[..., 0] + wb * Q
        hpp = a * a / (a + b)
        hpq = (a * b / (a + b))[..., None] * q / safe_q[..., None]
        qq = q[..., :, None] * q[..., None, :] / (safe_q * safe_q)[
            ..., None, None]
        eye = torch.eye(dim - 1, dtype=jar.dtype, device=jar.device)
        hqq = ((b * b / (a + b))[..., None, None] * qq
               + (t * b / safe_q)[..., None, None] * (eye - qq))
        s0 = -D_c[..., 0]
        st = -D_c[..., 1:] / mu
        top = torch.cat([(s0 * s0 * hpp)[..., None], s0[..., None] * st * hpq],
                        -1)
        low = torch.cat([(s0[..., None] * st * hpq)[..., None],
                         st[..., :, None] * st[..., None, :] * hqq], -1)
        h = torch.cat([top[..., None, :], low], -2)
        bottom = g[..., 0] >= Q
        zero = t <= 0.0
        h = torch.where(bottom[..., None, None], torch.diag_embed(D_c),
                        torch.where(zero[..., None, None],
                                    torch.zeros_like(h), h))
        ex = efc["exists"][:, start:start + nc * dim:dim]
        h = torch.where(ex[..., None, None], h, torch.zeros_like(h))
        out.append((start, nc, dim, h))
    return out


def _solve_newton(model: Model, d, efc):
    """Newton on the convex cost: H = M + J^T diag(D active) J (plus the
    cone blocks), Cholesky for the direction, exact line search."""
    qM = d.qM
    J, qfrc_smooth = efc["J"], d.qfrc_smooth
    lo, hi = _force_bounds(efc)
    glo, ghi = -hi, -lo
    x, jar, cost = _start(efc, d)
    niter = torch.zeros_like(d.solver_niter)
    bsz = x.shape[0]
    for _ in range(model.opt.iterations):
        f = _efc_force(efc, jar)
        grad = maths.matvec(qM, x) - qfrc_smooth - (J * f[..., None]).sum(1)
        g = efc["D"] * jar
        in_band = (g > glo) & (g < ghi) & efc["exists"]
        w = torch.where(in_band, efc["D"], torch.zeros_like(g))
        if efc["any_cone"]:
            w = torch.where(efc["is_cone"], torch.zeros_like(w), w)
        hess = qM + torch.einsum("bnv,bn,bnw->bvw", J, w, J)
        if efc["any_cone"]:
            for (start, nc, dim, h) in _cone_hess(efc, jar):
                J_c = J[:, start:start + nc * dim].reshape(bsz, nc, dim, -1)
                hess = hess + torch.einsum("bcdv,bcde,bcew->bvw", J_c, h, J_c)
        p = -maths.solve_pd(hess, grad)
        jp = maths.matvec(J, p)
        d0_gauss = (p * (maths.matvec(qM, x) - qfrc_smooth)).sum(-1)
        slope_gauss = (p * maths.matvec(qM, p)).sum(-1)
        alpha = _linesearch(efc, jar, jp, d0_gauss, slope_gauss)
        x = x + alpha[:, None] * p
        jar = jar + alpha[:, None] * jp
        new_cost = _cost(efc, x, d.qacc_smooth, jar, qM)
        niter = niter + _improved(model, cost, new_cost)
        cost = new_cost
    f = _efc_force(efc, jar)
    grad = maths.matvec(qM, x) - qfrc_smooth - (J * f[..., None]).sum(1)
    return _result(d, efc, x, jar, cost, maths.norm(grad), niter)


def _solve_pgs(model: Model, d, efc):
    """Dual projected Gauss-Seidel (pyramidal cones): row by row over
    A = J M^-1 J^T + diag(R), b = J qacc_smooth - aref."""
    if efc["any_cone"]:
        raise NotImplementedError(
            "PGS with elliptic cones is not implemented (per-contact cone "
            "projection sweep); use the Newton or CG solver")
    qM = d.qM
    J, aref, exists = efc["J"], efc["aref"], efc["exists"]
    uni = efc["unilateral"] & exists
    ne = J.shape[1]
    r_diag = 1.0 / torch.clamp(efc["D"], min=1e-15)
    minv_jt = maths.cho_solve(maths.cholesky(qM), J.transpose(1, 2))
    a_mat = J @ minv_jt + torch.diag_embed(r_diag)
    both = exists[:, :, None] & exists[:, None, :]
    a_mat = torch.where(both, a_mat, torch.zeros_like(a_mat))
    diag = torch.where(exists, torch.diagonal(a_mat, dim1=1, dim2=2),
                       torch.ones_like(r_diag))
    b_vec = torch.where(exists, maths.matvec(J, d.qacc_smooth) - aref,
                        torch.zeros_like(aref))
    _, jar0, _ = _start(efc, d)
    f = _efc_force(efc, jar0)
    floss = efc["floss"]
    niter = torch.zeros_like(d.solver_niter)
    for _ in range(model.opt.iterations):
        f_old = f
        f = f.clone()
        for i in range(ne):
            resid = (a_mat[:, i] * f).sum(-1) + b_vec[:, i]
            fi = f[:, i] - resid / diag[:, i]
            fi = torch.where(efc["unilateral"][i], torch.clamp(fi, min=0.0),
                             fi)
            fi = torch.where(efc["is_friction"][i],
                             torch.minimum(torch.maximum(fi, -floss[:, i]),
                                           floss[:, i]), fi)
            f[:, i] = torch.where(exists[:, i], fi, torch.zeros_like(fi))
        moved = torch.abs(f - f_old).max(1).values > model.opt.tolerance
        niter = niter + moved.to(torch.int64)
    qfrc_constraint = (J * f[..., None]).sum(1)
    qacc = d.qacc_smooth + maths.matvec(minv_jt, f)
    resid = maths.matvec(a_mat, f) + b_vec
    zero = torch.zeros_like(resid)
    proj = torch.where(uni, torch.minimum(resid, torch.where(f > 0, resid,
                                                             zero)), resid)
    return d.replace(
        qacc=qacc, qfrc_constraint=qfrc_constraint, qacc_warmstart=qacc,
        nefc_active=exists.sum(1),
        solver_cost=_cost(efc, qacc, d.qacc_smooth,
                          maths.matvec(J, qacc) - aref, qM),
        solver_gradnorm=maths.norm(torch.where(exists, proj, zero)),
        solver_niter=niter)


def contact_forces(model: Model, d, efc, qacc):
    """(B, ncon, 6) world [torque; force] on geom2's body at each contact
    point, from the solved efc forces (mj_contactForce analog)."""
    out = torch.zeros_like(d.contact_force)
    if efc is None or not efc["contact_layout"]:
        return out
    jar = maths.matvec(efc["J"], qacc) - efc["aref"]
    f = _efc_force(efc, jar)
    lanes = list(out.unbind(1))
    z3 = torch.zeros_like(d.contact.pos[:, 0])
    for (lane, start, condim, nrow, is_cone) in efc["contact_layout"]:
        frame = d.contact.frame[:, lane]
        mu = d.contact.friction[:, lane]
        torque = z3
        if condim == 1:
            force = frame[:, 0] * f[:, start:start + 1]
        elif is_cone:
            fc = f[:, start:start + condim]
            force = maths.matTvec(frame, fc[:, :3])
            if condim >= 4:
                torque = frame[:, 0] * fc[:, 3:4]
            if condim == 6:
                torque = torque + frame[:, 1] * fc[:, 4:5] \
                    + frame[:, 2] * fc[:, 5:6]
        else:
            ndir = nrow // 2
            fr = f[:, start:start + nrow].reshape(-1, ndir, 2)
            fn = fr.sum((1, 2))[:, None]
            # mu_k * (f_k+ - f_k-) per friction direction
            td = mu[:, :ndir] * (fr[..., 0] - fr[..., 1])
            force = (frame[:, 0] * fn + frame[:, 1] * td[:, 0:1]
                     + frame[:, 2] * td[:, 1:2])
            if condim >= 4:
                torque = frame[:, 0] * td[:, 2:3]
            if condim == 6:
                torque = (torque + frame[:, 1] * td[:, 3:4]
                          + frame[:, 2] * td[:, 4:5])
        lanes[lane] = torch.cat([torque, force], -1)
    return torch.stack(lanes, 1)


def fwd_constraint(model: Model, d):
    """mj_fwdConstraint analog: assemble the rows, solve, store qacc, the
    constraint force and the solver statistics."""
    efc = make_efc(model, d)
    if efc is None:
        zero = torch.zeros_like(d.time)
        return d.replace(
            qacc=d.qacc_smooth, qfrc_constraint=torch.zeros_like(d.qvel),
            qacc_warmstart=d.qacc_smooth,
            nefc_active=torch.zeros_like(d.solver_niter),
            solver_cost=zero, solver_gradnorm=zero,
            solver_niter=torch.zeros_like(d.solver_niter))
    if model.opt.solver == SolverType.NEWTON:
        d = _solve_newton(model, d, efc)
    elif model.opt.solver == SolverType.PGS:
        d = _solve_pgs(model, d, efc)
    else:
        d = _solve_cg(model, d, efc)
    if _needs_contact_force(model):
        d = d.replace(contact_force=contact_forces(model, d, efc, d.qacc))
    if _needs_limit_sensor(model) and n_limit_rows(model):
        K = consts(model, d.qpos)
        ridx = K.i("limit_rows", lambda: list(limit_row_map(model).values()))
        jar = maths.matvec(efc["J"], d.qacc) - efc["aref"]
        f = _efc_force(efc, jar)
        vel = maths.matvec(efc["J"], d.qvel)
        trip = torch.stack([efc["pos"], vel, f], -1)
        trip = torch.where(efc["exists"][..., None], trip,
                           torch.zeros_like(trip))
        d = d.replace(efc_limit=trip[:, ridx])
    return d
