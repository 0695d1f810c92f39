"""The plain reference of one physics step, batched over envs, float64.

MuJoCo's documented pipeline (the "Computation" chapter of its
documentation), written for what the two assets need and nothing else:

* kinematics: each body's frame from its parent's, through its hinge,
  slide or free joints; each dof's motion axis in world coordinates
  (angular part, then the linear velocity of the point at the world
  origin);
* the joint-space inertia by composite rigid bodies, plus armature; the
  bias forces (Coriolis, centrifugal, gravity) by recursive Newton-Euler;
  joint springs and dampers; motors;
* contacts of spheres and capsules (a sphere at each end of the segment)
  with planes, each a pyramidal friction cone of four edges, and joint
  limits; each row's impedance, reference acceleration and regulariser
  from its ``solref``/``solimp`` as MuJoCo's soft-constraint model
  defines them;
* the constrained acceleration by the solver the model names: Newton
  steps on the convex cost of that model, each with an exact line search
  (the cost is piecewise quadratic), from the better of the warmstart
  and the unconstrained acceleration, for the model's ``iterations``
  (its tolerance 0 stops none early);
* the Euler integrator with the joints' damping taken implicitly, and the
  free joint's quaternion turned by its angular velocity.

Nothing here depends on the program: the inputs are a state, the ctrl
and the warmstart, and the constants come from
:mod:`benchmark.reference.mjcf`.
"""

from __future__ import annotations

import numpy as np
import torch

from . import mjcf

MINVAL = 1e-15          # MuJoCo's mjMINVAL
MINIMP, MAXIMP = 0.0001, 0.9999
F64 = torch.float64


# ---------------------------------------------------------------------------
# small batched geometry
# ---------------------------------------------------------------------------


def quat_mul(a, b):
    w1, x1, y1, z1 = a.unbind(-1)
    w2, x2, y2, z2 = b.unbind(-1)
    return torch.stack([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], -1)


def quat_mat(q):
    q = q / q.norm(dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    rows = [1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
            2 * (x * z + w * y), 2 * (x * y + w * z),
            1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x),
            1 - 2 * (x * x + y * y)]
    return torch.stack(rows, -1).reshape(q.shape[:-1] + (3, 3))


def cross(a, b):
    return torch.linalg.cross(*torch.broadcast_tensors(a, b), dim=-1)


def cross_motion(v, s):
    """Spatial motion cross product ``v x s`` ([angular, linear])."""
    w, u = v[..., :3], v[..., 3:]
    return torch.cat([cross(w, s[..., :3]),
                      cross(w, s[..., 3:]) + cross(u, s[..., :3])], -1)


def cross_force(v, f):
    """Spatial force cross product ``v x* f`` ([moment, force])."""
    w, u = v[..., :3], v[..., 3:]
    return torch.cat([cross(w, f[..., :3]) + cross(u, f[..., 3:]),
                      cross(w, f[..., 3:])], -1)


def skew(c):
    z = torch.zeros_like(c[..., 0])
    x, y, w = c.unbind(-1)
    return torch.stack([z, -w, y, w, z, -x, -y, x, z], -1).reshape(
        c.shape[:-1] + (3, 3))


def impedance(r, d0, dmax, width, mid, power):
    """MuJoCo's impedance d(r) of rows at violation ``r``, each with its
    own ``solimp`` (tensors broadcast against ``r``; d0 and dmax already
    clipped)."""
    x = (r.abs() / width).clamp(max=1.0)
    lo = x.pow(power) / mid.pow(power - 1.0)
    hi = 1.0 - (1.0 - x).pow(power) / (1.0 - mid).pow(power - 1.0)
    y = torch.where(power == 1.0, x, torch.where(x <= mid, lo, hi))
    return d0 + y * (dmax - d0)


def soft_params(rows):
    """Per row (solref, solimp, timestep) -> the arrays (b, k, d0, dmax,
    width, mid, power), for ``aref = -b v - k d(r) r``."""
    out = []
    for solref, solimp, h in rows:
        imp = list(solimp) + [0.5, 2.0][len(solimp) - 3:]
        d0 = min(max(float(imp[0]), MINIMP), MAXIMP)
        dmax = min(max(float(imp[1]), MINIMP), MAXIMP)
        tc = max(float(solref[0]), 2.0 * h)
        ratio = float(solref[1])
        out.append((2.0 / (dmax * tc),
                    1.0 / (dmax * dmax * tc * tc * ratio * ratio),
                    d0, dmax, float(imp[2]), float(imp[3]), float(imp[4])))
    return np.array(out, np.float64).reshape(-1, 7).T


# ---------------------------------------------------------------------------
# the model's constants as tensors
# ---------------------------------------------------------------------------


class Model:
    """The constants of :class:`mjcf.Spec` as float64 tensors on a
    device."""

    def __init__(self, spec: mjcf.Spec, device):
        self.spec, self.device = spec, torch.device(device)
        t = self.t
        self.nq, self.nv, self.nu = spec.nq, spec.nv, len(spec.motors)
        self.nbody = len(spec.bodies)
        self.h = spec.timestep
        if spec.tolerance != 0.0:
            raise ValueError("the reference runs a fixed count of solver "
                             "iterations: the model's tolerance must be 0")
        self.iterations = spec.iterations
        self.qpos0 = t(spec.qpos0)
        self.gravity = t(np.concatenate([np.zeros(3), -spec.gravity]))
        self.body_pos = [t(b.pos) for b in spec.bodies]
        self.body_rot = [t(mjcf.quat_mat(b.quat)) for b in spec.bodies]
        self.jnt_axis = [t(j.axis) for j in spec.joints]
        self.eye3 = t(np.eye(3))
        self.jnt_skew = []
        for j in spec.joints:
            K = np.cross(np.eye(3), j.axis)   # K @ x = axis x x
            self.jnt_skew.append((t(K), t(K @ K)))
        self.jnt_pos = [t(j.pos) for j in spec.joints]
        self.eye = [t(e) for e in np.eye(3)]
        # per dof: its body, its joint's damping and armature
        dof_body, damping, armature = [], [], []
        for j in spec.joints:
            n = 6 if j.type == mjcf.FREE else 1
            dof_body += [j.body] * n
            damping += [j.damping] * n
            armature += [j.armature] * n
        self.dof_body = dof_body
        self.damping, self.armature = t(damping), t(armature)
        # ancestors: anc[b, d] if dof d moves body b
        anc = np.zeros((self.nbody, self.nv), bool)
        for b in range(1, self.nbody):
            a = b
            while a > 0:
                anc[b, [d for d in range(self.nv) if dof_body[d] == a]] = True
                a = spec.bodies[a].parent
        self.anc = torch.as_tensor(anc, device=self.device)
        # dof j < i with j on the path of i (the lower triangle of M)
        lower = np.array([[j < i and anc[dof_body[i], j]
                           for j in range(self.nv)] for i in range(self.nv)])
        self.lower = torch.as_tensor(lower, device=self.device)
        self.mass = t([b.mass for b in spec.bodies[1:]])
        self.ipos = t(np.stack([b.ipos for b in spec.bodies[1:]]))
        self.inertia = t(np.stack([b.inertia for b in spec.bodies[1:]]))
        self.gear = t([mo.gear for mo in spec.motors])
        self.motor_dof = self.index(
            [spec.joints[mo.joint].dofadr for mo in spec.motors])
        lim = [(mo.ctrlrange if mo.ctrllimited else (-np.inf, np.inf))
               for mo in spec.motors]
        self.ctrl_lo = t([a for a, _ in lim])
        self.ctrl_hi = t([b for _, b in lim])
        # springs on scalar joints
        spring = [(j.dofadr, j.qposadr, j.stiffness, j.springref)
                  for j in spec.joints
                  if j.type != mjcf.FREE and j.stiffness != 0.0]
        self.spring_dof = self.index([s[0] for s in spring])
        self.spring_q = self.index([s[1] for s in spring])
        self.spring_k = t([s[2] for s in spring])
        self.spring_ref = t([s[3] for s in spring])
        self.body_invweight, self.dof_invweight = self._invweights()
        self._limits()
        self._contacts()

    def t(self, a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=F64,
                               device=self.device)

    def index(self, a):
        return torch.as_tensor(a, dtype=torch.int64, device=self.device)

    def _limits(self):
        """Two rows per limited scalar joint: the lower and upper side."""
        rows = []
        for j in self.spec.joints:
            if j.limited and j.type != mjcf.FREE:
                for side, bound in ((1.0, j.range[0]), (-1.0, j.range[1])):
                    rows.append((j.dofadr, j.qposadr, side, bound, j))
        t = self.t
        self.lim_dof = self.index([r[0] for r in rows])
        self.lim_q = self.index([r[1] for r in rows])
        self.lim_side = t([r[2] for r in rows])
        self.lim_bound = t([r[3] for r in rows])
        jac = np.zeros((len(rows), self.nv))
        for i, r in enumerate(rows):
            jac[i, r[0]] = r[2]
        self.lim_jac = t(jac)
        self.lim_soft = t(soft_params([(r[4].solref, r[4].solimp, self.h)
                                       for r in rows]))
        self.lim_weight = self.dof_invweight[self.lim_dof]

    def _contacts(self):
        """The candidate contacts: each sphere, and each end of each
        capsule, against each plane whose contype and conaffinity meet
        its own."""
        cand = []
        for gp in self.spec.geoms:
            if gp.type != mjcf.PLANE:
                continue
            if gp.body != 0:
                raise ValueError("the reference takes planes of the world")
            for g in self.spec.geoms:
                if g.type == mjcf.PLANE or g.body == 0:
                    continue
                if not (gp.contype & g.conaffinity
                        or g.contype & gp.conaffinity):
                    continue
                if max(gp.condim, g.condim) != 3:
                    raise ValueError("the reference takes condim 3 only")
                ends = (1.0, -1.0) if g.type == mjcf.CAPSULE else (0.0,)
                for e in ends:
                    cand.append((gp, g, e))
        t = self.t
        self.con_body = self.index([g.body for _, g, _ in cand])
        self.con_gpos = t([g.pos for _, g, _ in cand])
        self.con_gmat = t([g.mat for _, g, _ in cand])
        self.con_ppos = t([gp.pos for gp, _, _ in cand])
        self.con_normal = t([gp.mat[:, 2] for gp, _, _ in cand])
        self.con_end = t([e * (g.size[1] if e else 0.0) for _, g, e in cand])
        self.con_capsule = torch.as_tensor([e != 0.0 for _, _, e in cand],
                                           device=self.device)
        self.con_radius = t([g.size[0] for _, g, _ in cand])
        self.con_mu = t([max(gp.friction[0], g.friction[0])
                         for gp, g, _ in cand])
        # MuJoCo mixes two geoms' solref and solimp by their solmix (both 1)
        self.con_soft = t(soft_params([(0.5 * (gp.solref + g.solref),
                                        0.5 * (gp.solimp + g.solimp), self.h)
                                       for gp, g, _ in cand]))
        self.con_tran = t([self.body_invweight[g.body][0]
                           for _, g, _ in cand])
        self.con_anc = self.anc[self.con_body]            # (C, nv)

    def _invweights(self):
        """MuJoCo's inverse weights at qpos0, which scale each row's
        regulariser: per body, the mean diagonal of the translational and
        of the rotational block of J M^-1 J' at its centre of mass; per
        dof, the diagonal of M^-1 (a free joint's translational and
        rotational dofs averaged)."""
        kin = kinematics(self, self.qpos0[None])
        minv = torch.linalg.inv(mass_matrix(self, kin))[0]
        S = kin["S"][0]
        body = [(0.0, 0.0)]
        for b in range(1, self.nbody):
            mask = self.anc[b][:, None]
            jr = (S[:, :3] * mask).T
            jp = ((S[:, 3:] + cross(S[:, :3], kin["xipos"][0, b - 1]))
                  * mask).T
            body.append((float(torch.trace(jp @ minv @ jp.T)) / 3.0,
                         float(torch.trace(jr @ minv @ jr.T)) / 3.0))
        dof = torch.diagonal(minv).clone()
        for j in self.spec.joints:
            if j.type == mjcf.FREE:
                a = j.dofadr
                dof[a:a + 3] = dof[a:a + 3].mean()
                dof[a + 3:a + 6] = dof[a + 3:a + 6].mean()
        return body, dof


# ---------------------------------------------------------------------------
# kinematics and dynamics
# ---------------------------------------------------------------------------


def kinematics(m: Model, qpos):
    """Body frames, centres of mass and world inertias, and each dof's
    motion axis ``S (B, nv, 6)``.  A hinge turns its body by Rodrigues'
    formula about its local axis."""
    B = qpos.shape[0]
    spec = m.spec
    zero3 = torch.zeros((B, 3), dtype=F64, device=qpos.device)
    xpos, xmat = [zero3], [m.body_rot[0].expand(B, 3, 3)]
    S = [None] * m.nv
    for b in range(1, m.nbody):
        body = spec.bodies[b]
        p = body.parent
        pos = xpos[p] + xmat[p] @ m.body_pos[b]
        rot = xmat[p] @ m.body_rot[b]
        for ji in body.joints:
            j = spec.joints[ji]
            a, d = j.qposadr, j.dofadr
            if j.type == mjcf.FREE:
                pos = qpos[:, a:a + 3]
                rot = quat_mat(qpos[:, a + 3:a + 7])
                for k in range(3):
                    S[d + k] = torch.cat([zero3, zero3 + m.eye[k]], -1)
                    axis = rot[:, :, k]
                    S[d + 3 + k] = torch.cat([axis, cross(pos, axis)], -1)
                continue
            axis = rot @ m.jnt_axis[ji]
            anchor = pos + rot @ m.jnt_pos[ji]
            q = (qpos[:, a] - m.qpos0[a])[:, None, None]
            if j.type == mjcf.SLIDE:
                S[d] = torch.cat([zero3, axis], -1)
                pos = pos + axis * q[:, 0]
            else:
                S[d] = torch.cat([axis, cross(anchor, axis)], -1)
                K, K2 = m.jnt_skew[ji]
                rot = rot @ (m.eye3 + torch.sin(q) * K
                             + (1.0 - torch.cos(q)) * K2)
                pos = anchor - rot @ m.jnt_pos[ji]
        xpos.append(pos)
        xmat.append(rot)
    xpos, xmat = torch.stack(xpos, 1), torch.stack(xmat, 1)
    xipos = xpos[:, 1:] + (xmat[:, 1:] @ m.ipos[..., None])[..., 0]
    iworld = xmat[:, 1:] @ m.inertia @ xmat[:, 1:].transpose(-1, -2)
    return {"xpos": xpos, "xmat": xmat, "xipos": xipos, "iworld": iworld,
            "S": torch.stack(S, 1)}


def spatial_inertia(m: Model, kin):
    """(B, nbody - 1, 6, 6): each body's spatial inertia about the world
    origin, motion as [angular, linear]."""
    c = skew(kin["xipos"])
    mass = m.mass[None, :, None, None]
    top = torch.cat([kin["iworld"] - mass * (c @ c), mass * c], -1)
    eye = torch.eye(3, dtype=F64, device=c.device)
    bottom = torch.cat([-mass * c, mass * eye.expand_as(c)], -1)
    return torch.cat([top, bottom], -2)


def mass_matrix(m: Model, kin, inert=None):
    """M (B, nv, nv) by composite rigid bodies, plus armature."""
    inert = spatial_inertia(m, kin) if inert is None else inert
    comp = [None] + list(inert.unbind(1))
    for b in range(m.nbody - 1, 0, -1):
        p = m.spec.bodies[b].parent
        if p > 0:
            comp[p] = comp[p] + comp[b]
    S = kin["S"]
    comp_dof = torch.stack([comp[b] for b in m.dof_body], 1)  # B,nv,6,6
    f = (comp_dof @ S[..., None])[..., 0]                      # B,nv,6
    full = f @ S.transpose(1, 2)                               # [i, j]
    low = torch.where(m.lower, full, torch.zeros_like(full))
    diag = torch.diagonal(full, dim1=1, dim2=2)
    return low + low.transpose(1, 2) + torch.diag_embed(diag + m.armature)


def bias_force(m: Model, kin, qvel, inert=None):
    """C(q, v) + g(q) (B, nv) by recursive Newton-Euler, the base
    accelerating against gravity."""
    spec = m.spec
    S = kin["S"]
    inert = spatial_inertia(m, kin) if inert is None else inert
    zero = torch.zeros((qvel.shape[0], 6), dtype=F64, device=qvel.device)
    vel, acc = [zero], [zero + m.gravity]
    for b in range(1, m.nbody):
        body = spec.bodies[b]
        v, a = vel[body.parent], acc[body.parent]
        for ji in body.joints:
            j = spec.joints[ji]
            d = j.dofadr
            if j.type == mjcf.FREE:
                v = v + (S[:, d:d + 3] * qvel[:, d:d + 3, None]).sum(1)
                rot = S[:, d + 3:d + 6]
                a = a + (cross_motion(v[:, None], rot)
                         * qvel[:, d + 3:d + 6, None]).sum(1)
                v = v + (rot * qvel[:, d + 3:d + 6, None]).sum(1)
            else:
                a = a + cross_motion(v, S[:, d]) * qvel[:, d, None]
                v = v + S[:, d] * qvel[:, d, None]
        vel.append(v)
        acc.append(a)
    force = [None]
    for b in range(1, m.nbody):
        i6 = inert[:, b - 1]
        force.append((i6 @ acc[b][..., None])[..., 0] + cross_force(
            vel[b], (i6 @ vel[b][..., None])[..., 0]))
    for b in range(m.nbody - 1, 0, -1):
        p = spec.bodies[b].parent
        if p > 0:
            force[p] = force[p] + force[b]
    fdof = torch.stack([force[b] for b in m.dof_body], 1)
    return (S * fdof).sum(-1)


# ---------------------------------------------------------------------------
# constraints
# ---------------------------------------------------------------------------


def constraints(m: Model, kin, qpos, qvel):
    """Every candidate row, padded: ``J (B, R, nv)``, ``aref (B, R)``,
    ``D (B, R)`` (zero for a row that is not active): the joint limits,
    then four pyramid edges per candidate contact."""
    B = qpos.shape[0]
    # joint limits
    r = m.lim_side * (qpos[:, m.lim_q] - m.lim_bound)
    b, k, *imp_p = m.lim_soft
    imp = impedance(r, *imp_p)
    R = torch.clamp_min((1.0 - imp) / imp * m.lim_weight, MINVAL)
    aref_lim = -b * (m.lim_side * qvel[:, m.lim_dof]) - k * imp * r
    D_lim = torch.where(r < 0.0, 1.0 / R, torch.zeros_like(R))
    # contacts of a sphere (or a capsule's end) with a plane of the world
    xpos, xmat = kin["xpos"][:, m.con_body], kin["xmat"][:, m.con_body]
    axis = (xmat @ m.con_gmat)[..., 2]                       # B,C,3
    center = (xpos + (xmat @ m.con_gpos[..., None])[..., 0]
              + m.con_end[:, None] * axis)
    n = m.con_normal.expand_as(center)
    dist = ((center - m.con_ppos) * n).sum(-1) - m.con_radius
    point = center - n * (m.con_radius + 0.5 * dist)[..., None]
    # tangents: a capsule's axis made normal to n, else MuJoCo's default
    # frame (y, or z where the normal lies near y)
    near_y = n[..., 1:2].abs() < 0.5
    default = torch.where(near_y, m.eye[1], m.eye[2])
    hint = torch.where(m.con_capsule[:, None], axis, default)
    t1 = hint - n * (hint * n).sum(-1, keepdim=True)
    t1 = t1 / t1.norm(dim=-1, keepdim=True)
    t2 = cross(n, t1)
    S = kin["S"][:, None]                                    # B,1,nv,6
    jac = S[..., 3:] + cross(S[..., :3], point[:, :, None, :])
    jac = jac * m.con_anc[None, :, :, None]                  # B,C,nv,3
    jn = (jac * n[:, :, None]).sum(-1)
    mu = m.con_mu[:, None]
    jt1, jt2 = (jac * t1[:, :, None]).sum(-1), (jac * t2[:, :, None]).sum(-1)
    edges = torch.stack([jn + mu * jt1, jn - mu * jt1, jn + mu * jt2,
                         jn - mu * jt2], 2)                  # B,C,4,nv
    b, k, *imp_p = m.con_soft
    imp = impedance(dist, *imp_p)
    # each edge: (1 - d)/d times its diagonal approximation tran (1 +
    # mu^2); the pyramid's edges share 2 mu^2 times the normal's
    r_normal = (1.0 - imp) / imp * (m.con_tran * (1.0 + m.con_mu ** 2))
    R = torch.clamp_min(2.0 * m.con_mu ** 2 * r_normal, MINVAL)
    Dc = torch.where(dist < 0.0, 1.0 / R, torch.zeros_like(R))
    vel = (edges * qvel[:, None, None, :]).sum(-1)           # B,C,4
    aref_c = -b[:, None] * vel - (k * imp * dist)[..., None]
    return (torch.cat([m.lim_jac.expand(B, -1, -1),
                       edges.reshape(B, -1, m.nv)], 1),
            torch.cat([aref_lim, aref_c.reshape(B, -1)], 1),
            torch.cat([D_lim, Dc[..., None].expand(-1, -1, 4).reshape(B, -1)],
                      1))


def _chol_solve(L, b):
    y = torch.linalg.solve_triangular(L, b[..., None], upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), y,
                                         upper=True)[..., 0]


def _cholesky(A):
    return torch.linalg.cholesky_ex(A)[0]


def solve(M, qfrc, J, aref, D, warm, iterations: int):
    """The constrained acceleration of MuJoCo's Newton solver: the cost
    ``1/2 (a - a0)' M (a - a0) + 1/2 sum_i D_i min(0, (J a - aref)_i)^2``
    (``a0 = M^-1 qfrc``) lowered by ``iterations`` Newton steps, each
    with an exact line search along its direction, from ``warm`` or
    ``a0``, whichever costs less.  Returns ``(qacc, qfrc_constraint)``."""
    a0 = _chol_solve(_cholesky(M), qfrc)
    Mv = lambda x: (M @ x[..., None])[..., 0]  # noqa: E731
    Jv = lambda x: (J @ x[..., None])[..., 0]  # noqa: E731

    def cost(a):
        jar = Jv(a) - aref
        return 0.5 * ((a - a0) * Mv(a - a0)).sum(-1) + 0.5 * (
            D * torch.clamp_max(jar, 0.0) ** 2).sum(-1)

    a = torch.where((cost(warm) < cost(a0))[:, None], warm, a0)
    for _ in range(iterations):
        jar = Jv(a) - aref
        act = (jar < 0.0).to(a.dtype) * D
        grad = Mv(a - a0) + (J.transpose(1, 2) @ (act * jar)[..., None])[
            ..., 0]
        H = M + J.transpose(1, 2) @ (act[..., None] * J)
        p = -_chol_solve(_cholesky(H), grad)
        a = a + _line_search(Mv, a, a0, p, jar, Jv(p), D)[:, None] * p
    force = -D * torch.clamp_max(Jv(a) - aref, 0.0)
    return a, (J.transpose(1, 2) @ force[..., None])[..., 0]


def _line_search(Mv, a, a0, p, jar, q, D):
    """The exact minimiser ``alpha >= 0`` of the cost along ``p`` (``q =
    J p``).  Its derivative ``A + alpha C`` is piecewise linear and
    increasing: ``A`` and ``C`` change where a row's ``jar + alpha q``
    crosses zero.  The crossings, sorted, bound the pieces; the root lies
    in the first piece at whose right end the derivative is not
    negative."""
    w, c2 = D * q * jar, D * q * q
    on = (jar < 0.0) | ((jar == 0.0) & (q < 0.0))
    zero = torch.zeros_like(w)
    A0 = (p * Mv(a - a0)).sum(-1) + torch.where(on, w, zero).sum(-1)
    C0 = (p * Mv(p)).sum(-1) + torch.where(on, c2, zero).sum(-1)
    inf = torch.full_like(w, float("inf"))
    brk = torch.where((D > 0.0) & (q != 0.0), -jar / q, inf)
    brk = torch.where(brk > 0.0, brk, inf)
    brk, order = torch.sort(brk, dim=1)
    sign = torch.where(on, -1.0, 1.0).to(w.dtype)
    dA = torch.cumsum(torch.gather(sign * w, 1, order), 1)
    dC = torch.cumsum(torch.gather(sign * c2, 1, order), 1)
    A = torch.cat([A0[:, None], A0[:, None] + dA], 1)
    C = torch.cat([C0[:, None], C0[:, None] + dC], 1)
    right = torch.cat([brk, inf[:, :1]], 1)
    at_right = torch.where(torch.isinf(right), inf[:, :1].expand_as(A),
                           A + right * C)
    piece = torch.argmax((at_right >= 0.0).to(torch.int8), dim=1)[:, None]
    A, C = torch.gather(A, 1, piece)[:, 0], torch.gather(C, 1, piece)[:, 0]
    # a zero direction (converged) has no curvature: stay
    alpha = -A / torch.where(C > 0.0, C, torch.ones_like(C))
    return torch.where(C > 0.0, alpha.clamp_min(0.0), torch.zeros_like(C))


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------


def integrate_pos(m: Model, qpos, qvel, h: float):
    out = []
    for j in m.spec.joints:
        a, d = j.qposadr, j.dofadr
        if j.type == mjcf.FREE:
            out.append(qpos[:, a:a + 3] + h * qvel[:, d:d + 3])
            w = qvel[:, d + 3:d + 6]
            speed = w.norm(dim=-1, keepdim=True)
            axis = w / torch.where(speed > 0.0, speed,
                                   torch.ones_like(speed))
            half = 0.5 * h * speed
            turn = torch.cat([torch.cos(half), torch.sin(half) * axis], -1)
            quat = quat_mul(qpos[:, a + 3:a + 7], turn)
            out.append(quat / quat.norm(dim=-1, keepdim=True))
        else:
            out.append(qpos[:, a:a + 1] + h * qvel[:, d:d + 1])
    return torch.cat(out, 1)


def smooth_force(m: Model, kin, qpos, qvel, ctrl, inert=None):
    """Springs, dampers and motors, less the bias force."""
    f = -m.damping * qvel - bias_force(m, kin, qvel, inert)
    f = f.index_add(1, m.spring_dof,
                    -m.spring_k * (qpos[:, m.spring_q] - m.spring_ref))
    force = m.gear * torch.minimum(torch.maximum(ctrl, m.ctrl_lo), m.ctrl_hi)
    return f.index_add(1, m.motor_dof, force)


def step(m: Model, qpos, qvel, ctrl, warm):
    """One Euler step of every env from the warmstart ``warm``:
    ``(qpos, qvel, qacc)`` after it, ``qacc`` the solver's acceleration
    (the next step's warmstart)."""
    kin = kinematics(m, qpos)
    inert = spatial_inertia(m, kin)
    M = mass_matrix(m, kin, inert)
    qfrc = smooth_force(m, kin, qpos, qvel, ctrl, inert)
    J, aref, D = constraints(m, kin, qpos, qvel)
    qacc, qfrc_c = solve(M, qfrc, J, aref, D, warm, m.iterations)
    # Euler: the dampers implicit in the velocity update
    Mh = M + torch.diag_embed(m.h * m.damping.expand_as(qvel))
    qvel = qvel + m.h * _chol_solve(_cholesky(Mh), qfrc + qfrc_c)
    return integrate_pos(m, qpos, qvel, m.h), qvel, qacc

