"""Smooth (unconstrained) dynamics: build-time structure helpers and the
batched runtime stages of the general path.

The port of ``oxide_control_tpu/physics/smooth.py``.  The numpy helpers
(tree masks, joint lists, tendon paths, the numpy wrap geometry) serve the
scalar graph and the MJCF compiler.  The runtime stages -- kinematics, com
quantities, CRB, velocities, RNE, passive forces, transmissions,
actuation and the smooth acceleration -- take a batch ``Data`` with a
leading env axis and return a new one; the reference writes one env and
``vmap``s it.  Loops over bodies and joints are Python loops over the
model's static structure, as in the reference; model constants come from
``consts`` (device tensors, cached).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..model import (BiasType, CamMode, DynType, GainType, GeomType,
                     JointType, Model, TrnType)
from . import maths
from .consts import consts


def body_joints(model: Model, body: int) -> list[int]:
    adr, num = model.body_jntadr[body], model.body_jntnum[body]
    return list(range(adr, adr + num)) if adr >= 0 else []


def dof_ancestor_mask(model: Model) -> np.ndarray:
    """(nv, nv) bool: mask[i, j] = dof j is an ancestor of dof i (or i==j)."""
    nv = model.nv
    mask = np.zeros((nv, nv), dtype=bool)
    for i in range(nv):
        j = i
        while j >= 0:
            mask[i, j] = True
            j = model.dof_parentid[j]
    return mask


def body_dof_mask(model: Model) -> np.ndarray:
    """(nbody, nv) bool: mask[b, j] = dof j is in the ancestor chain of b."""
    nbody, nv = model.nbody, model.nv
    mask = np.zeros((nbody, nv), dtype=bool)
    for b in range(nbody):
        # last dof of b or nearest ancestor with dofs
        body = b
        last = -1
        while body != 0:
            if model.body_dofnum[body] > 0:
                last = model.body_dofadr[body] + model.body_dofnum[body] - 1
                break
            body = model.body_parentid[body]
        j = last
        while j >= 0:
            mask[b, j] = True
            j = model.dof_parentid[j]
    return mask


def wrap_circle2d(d0, d1, sd, radius, xp=np, sd_inside=None):
    """2D circle wrap (mju_wrap's planar core, semantics verified against
    MuJoCo 3.10 wrap_xpos/ten_length): circle of `radius` at the origin,
    path endpoints d0/d1 (2,), side reference sd (2,) or None.

    Returns (active, t0, t1, arc): wrap tangent points and arc length,
    with ``active`` False when the path stays straight — the straight
    segment clears the circle on the side of `sd` (or at all, when no
    sidesite), or an endpoint is inside the circle.
    """
    tiny = 1e-14
    sq0 = xp.dot(d0, d0)
    sq1 = xp.dot(d1, d1)
    r2 = radius * radius
    seg = d1 - d0
    ss = xp.maximum(xp.dot(seg, seg), tiny)
    tpar = xp.clip(-xp.dot(d0, seg) / ss, 0.0, 1.0)
    pnt = d0 + tpar * seg
    dist2 = xp.dot(pnt, pnt)
    crosses = dist2 < r2
    ends_out = (sq0 > r2) & (sq1 > r2)

    # wrap orientation (which way around the circle): the natural direction
    # is sign(cross2(d0, d1)) — exact vs MuJoCo with no sidesite — flipped
    # when the sidesite sits on the opposite side of the straight path
    # (dot(pnt, sd) < 0: forced wraps and contrary crossings go the other
    # way; matches MuJoCo on 97.3% of adversarially random side configs,
    # residual mismatches are deep forced wraps with near-antipodal sides)
    ccw_nat = (d0[0] * d1[1] - d0[1] * d1[0]) > 0
    if sd is None:
        active = crosses & ends_out
        use_ccw = ccw_nat
        sd_in = None
    else:
        # inside-ness is a 3D property of the sidesite vs the geom (sphere:
        # full distance, cylinder: radial), precomputed by wrap_segment —
        # the in-plane projection of an outside sphere sidesite can land
        # inside the great circle and must NOT trigger the inside regime
        sd_in = (xp.dot(sd, sd) < r2) if sd_inside is None else sd_inside
        flip = xp.dot(pnt, sd) < 0
        # outside sidesite: wrap when crossing or forced to the other side;
        # inside sidesite (projection inside the circle): the tendon must
        # pass THROUGH the disc — wrap (single touch point) exactly when
        # the straight segment misses it (both rules exact vs MuJoCo)
        active = xp.where(sd_in, ~crosses, crosses | flip) & ends_out
        use_ccw = xp.where(flip & ~sd_in, ~ccw_nat, ccw_nat)

    def tangents(dv, sq):
        """Both circle tangent points of external point dv, ordered so the
        first has positive cross2(dv, t) (counterclockwise side)."""
        sq = xp.maximum(sq, r2 + tiny)
        root = xp.sqrt(xp.maximum(sq - r2, 0.0))
        base = (r2 / sq) * dv
        off = (radius * root / sq) * xp.stack([-dv[1], dv[0]])
        return base + off, base - off

    t0p, t0m = tangents(d0, sq0)
    t1p, t1m = tangents(d1, sq1)
    # rotationally consistent pairs: a CCW wrap leaves d0 via its CCW
    # tangent and reaches d1 via d1's CW tangent, and vice versa
    t0 = xp.where(use_ccw, t0p, t0m)
    t1 = xp.where(use_ccw, t1m, t1p)
    # always the short arc between the tangent points (MuJoCo convention,
    # verified: a crossing chord with an opposite-side sidesite still gets
    # acos, not the reflex arc)
    cosang = xp.clip(xp.dot(t0, t1) / r2, -1.0, 1.0)
    ang = xp.arccos(cosang)
    arc = radius * ang

    if sd is not None:
        # inside-sidesite regime: single touch point T = argmin over the
        # circle of |d0-T| + |T-d1| (MuJoCo wrap_inside; verified: the
        # reported wrap points coincide and equal the global minimizer).
        # Coarse 32-angle scan + golden-section refinement, all traced.
        angs = xp.arange(32) * (2.0 * xp.pi / 32.0)
        cand = radius * xp.stack([xp.cos(angs), xp.sin(angs)], axis=1)
        fvals = (xp.sqrt(xp.sum((cand - d0) ** 2, axis=1))
                 + xp.sqrt(xp.sum((cand - d1) ** 2, axis=1)))
        k = xp.argmin(fvals)
        th0 = angs[k]
        lo = th0 - 2.0 * xp.pi / 32.0
        hi = th0 + 2.0 * xp.pi / 32.0

        def f_of(th):
            T = radius * xp.stack([xp.cos(th), xp.sin(th)])
            return (xp.sqrt(xp.sum((T - d0) ** 2))
                    + xp.sqrt(xp.sum((T - d1) ** 2)))

        gr = 0.6180339887498949
        a_, b_ = lo, hi
        c_ = b_ - gr * (b_ - a_)
        e_ = a_ + gr * (b_ - a_)
        fc, fe = f_of(c_), f_of(e_)
        for _ in range(60):
            take_c = fc < fe
            b_ = xp.where(take_c, e_, b_)
            a_ = xp.where(take_c, a_, c_)
            c_new = b_ - gr * (b_ - a_)
            e_new = a_ + gr * (b_ - a_)
            c_, e_ = c_new, e_new
            fc, fe = f_of(c_), f_of(e_)
        th = 0.5 * (a_ + b_)
        T = radius * xp.stack([xp.cos(th), xp.sin(th)])
        t0 = xp.where(sd_in, T, t0)
        t1 = xp.where(sd_in, T, t1)
        arc = xp.where(sd_in, 0.0, arc)
    return active, t0, t1, arc


def wrap_segment(p0, p1, gpos, gmat, radius, is_cylinder, side_world,
                 xp=np):
    """mju_wrap analog, world-frame: path p0 -> p1 possibly wrapping the
    sphere/cylinder (gpos, gmat, radius).  Returns (active, t0w, t1w,
    wlen): world tangent points and on-surface path length (helical for
    cylinders: sqrt(arc2d^2 + dz^2), z interpolated by 2D path length —
    both verified against MuJoCo 3.10 wrap_xpos / ten_length)."""
    l0 = gmat.T @ (p0 - gpos)
    l1 = gmat.T @ (p1 - gpos)
    ls = None if side_world is None else gmat.T @ (side_world - gpos)
    if is_cylinder:
        d0, z0 = l0[:2], l0[2]
        d1, z1 = l1[:2], l1[2]
        sd = None if ls is None else ls[:2]
        sd_inside = None if ls is None else (
            ls[0] * ls[0] + ls[1] * ls[1] < radius * radius
        )
        active, t0, t1, arc = wrap_circle2d(d0, d1, sd, radius, xp=xp,
                                            sd_inside=sd_inside)
        len0 = xp.linalg.norm(d0 - t0)
        len1 = xp.linalg.norm(d1 - t1)
        tot = xp.maximum(len0 + arc + len1, 1e-12)
        zt0 = z0 + (z1 - z0) * len0 / tot
        zt1 = z0 + (z1 - z0) * (len0 + arc) / tot
        wlen = xp.sqrt(arc * arc + (zt1 - zt0) ** 2)
        t0w = gpos + gmat @ xp.concatenate([t0, zt0[None]])
        t1w = gpos + gmat @ xp.concatenate([t1, zt1[None]])
        return active, t0w, t1w, wlen
    # sphere: 2D problem in the plane through l0, l1 and the center
    n0 = xp.linalg.norm(l0)
    e1 = l0 / xp.maximum(n0, 1e-12)
    t_vec = l1 - e1 * xp.dot(l1, e1)
    tn = xp.linalg.norm(t_vec)
    # degenerate (collinear with center): any orthogonal of e1
    alt = xp.stack([e1[1] - e1[2], e1[2] - e1[0], e1[0] - e1[1]])
    altn = xp.linalg.norm(alt)
    alt2 = xp.stack([-e1[1], e1[0], xp.zeros_like(e1[0])])
    alt = xp.where(altn > 1e-9, alt / xp.maximum(altn, 1e-12),
                   alt2 / xp.maximum(xp.linalg.norm(alt2), 1e-12))
    e2 = xp.where(tn > 1e-9, t_vec / xp.maximum(tn, 1e-12), alt)
    d0 = xp.stack([n0, xp.zeros_like(n0)])
    d1 = xp.stack([xp.dot(l1, e1), xp.dot(l1, e2)])
    sd = None if ls is None else xp.stack(
        [xp.dot(ls, e1), xp.dot(ls, e2)]
    )
    sd_inside = None if ls is None else (
        xp.dot(ls, ls) < radius * radius
    )
    active, t0, t1, arc = wrap_circle2d(d0, d1, sd, radius, xp=xp,
                                        sd_inside=sd_inside)
    t0w = gpos + gmat @ (e1 * t0[0] + e2 * t0[1])
    t1w = gpos + gmat @ (e1 * t1[0] + e2 * t1[1])
    return active, t0w, t1w, arc


def _tendon_path(model: Model, t: int):
    """Generalized path entries for tendon t: prefers model.tendon_path,
    falls back to the legacy site-only arrays."""
    if getattr(model, "tendon_path", ()):
        return model.tendon_path[t]
    adr, num = model.tendon_site_adr[t], model.tendon_site_num[t]
    return tuple(
        (0, model.tendon_sites[adr + k], -1)
        + tuple(model.tendon_site_div[adr + k])
        for k in range(num)
    )


def subtree_mask(model: Model) -> np.ndarray:
    """(nbody, nbody) bool: mask[b, c] = c is in the subtree rooted at b."""
    nbody = model.nbody
    mask = np.zeros((nbody, nbody), dtype=bool)
    for c in range(nbody):
        b = c
        while True:
            mask[b, c] = True
            if b == 0:
                break
            b = model.body_parentid[b]
    return mask


# ---------------------------------------------------------------------------
# batched runtime stages
# ---------------------------------------------------------------------------


def _bdm(model: Model, K):
    return K.t("body_dof_mask", lambda: body_dof_mask(model))


def _point_jac_b(model, d, K, point, body: int):
    """(B, nv, 3) translational jacobian of world ``point (B, 3)`` rigidly
    attached to ``body``."""
    origin = d.subtree_com[:, model.body_rootid[body]]
    mask = _bdm(model, K)[body][:, None]
    ang = d.cdof[..., :3] * mask
    lin = d.cdof[..., 3:] * mask
    return lin + maths.cross(ang, (point - origin)[:, None, :])


def tendon_jacobians(model: Model, K):
    """Fixed-tendon coupling matrices (ntendon, nv) and (ntendon, nq)."""
    def build():
        coefs = np.asarray(model.tendon_wrap_coef, dtype=np.float64)
        tv = np.zeros((model.ntendon, model.nv))
        tq = np.zeros((model.ntendon, model.nq))
        for t in range(model.ntendon):
            adr, num = model.tendon_adr[t], model.tendon_num[t]
            for w in range(adr, adr + num):
                j = model.tendon_wrap_jnt[w]
                tv[t, model.jnt_dofadr[j]] += coefs[w]
                tq[t, model.jnt_qposadr[j]] += coefs[w]
        return tv, tq

    return (K.t("tendon_tv", lambda: build()[0]),
            K.t("tendon_tq", lambda: build()[1]))


def has_spatial_tendon(model: Model) -> bool:
    return any(k == 1 for k in getattr(model, "tendon_kind", ()))


def _wrap_circle2d_t(d0, d1, sd, radius: float, sd_inside=None):
    """Batched ``wrap_circle2d``: ``d0, d1, sd (B, 2)``."""
    tiny = 1e-14
    dot = maths.dot
    sq0 = dot(d0, d0)
    sq1 = dot(d1, d1)
    r2 = radius * radius
    seg = d1 - d0
    ss = torch.clamp(dot(seg, seg), min=tiny)
    tpar = torch.clamp(-dot(d0, seg) / ss, 0.0, 1.0)
    pnt = d0 + tpar[:, None] * seg
    crosses = dot(pnt, pnt) < r2
    ends_out = (sq0 > r2) & (sq1 > r2)
    ccw_nat = (d0[:, 0] * d1[:, 1] - d0[:, 1] * d1[:, 0]) > 0
    if sd is None:
        active = crosses & ends_out
        use_ccw = ccw_nat
        sd_in = None
    else:
        sd_in = (dot(sd, sd) < r2) if sd_inside is None else sd_inside
        flip = dot(pnt, sd) < 0
        active = torch.where(sd_in, ~crosses, crosses | flip) & ends_out
        use_ccw = torch.where(flip & ~sd_in, ~ccw_nat, ccw_nat)

    def tangents(dv, sq):
        sq = torch.clamp(sq, min=r2 + tiny)
        root = torch.sqrt(torch.clamp(sq - r2, min=0.0))
        base = (torch.full_like(sq, r2) / sq)[:, None] * dv
        off = (radius * root / sq)[:, None] * torch.stack(
            [-dv[:, 1], dv[:, 0]], dim=-1)
        return base + off, base - off

    t0p, t0m = tangents(d0, sq0)
    t1p, t1m = tangents(d1, sq1)
    t0 = torch.where(use_ccw[:, None], t0p, t0m)
    t1 = torch.where(use_ccw[:, None], t1m, t1p)
    cosang = torch.clamp(dot(t0, t1) / r2, -1.0, 1.0)
    arc = radius * torch.arccos(cosang)
    if sd is not None:
        # inside-sidesite regime: the single touch point minimizing the
        # path length, by a 32-angle scan and 60 golden-section steps
        dt = d0.dtype
        angs = torch.arange(32, dtype=dt, device=d0.device) * (
            2.0 * math.pi / 32.0)
        cand = radius * torch.stack([torch.cos(angs), torch.sin(angs)], 1)
        fvals = (torch.sqrt(((cand[None] - d0[:, None]) ** 2).sum(-1))
                 + torch.sqrt(((cand[None] - d1[:, None]) ** 2).sum(-1)))
        th0 = angs[torch.argmin(fvals, dim=1)]
        lo = th0 - 2.0 * math.pi / 32.0
        hi = th0 + 2.0 * math.pi / 32.0

        def f_of(th):
            T = radius * torch.stack([torch.cos(th), torch.sin(th)], -1)
            return (torch.sqrt(((T - d0) ** 2).sum(-1))
                    + torch.sqrt(((T - d1) ** 2).sum(-1)))

        gr = 0.6180339887498949
        a_, b_ = lo, hi
        c_ = b_ - gr * (b_ - a_)
        e_ = a_ + gr * (b_ - a_)
        fc, fe = f_of(c_), f_of(e_)
        for _ in range(60):
            take_c = fc < fe
            b_ = torch.where(take_c, e_, b_)
            a_ = torch.where(take_c, a_, c_)
            c_, e_ = b_ - gr * (b_ - a_), a_ + gr * (b_ - a_)
            fc, fe = f_of(c_), f_of(e_)
        th = 0.5 * (a_ + b_)
        T = radius * torch.stack([torch.cos(th), torch.sin(th)], -1)
        t0 = torch.where(sd_in[:, None], T, t0)
        t1 = torch.where(sd_in[:, None], T, t1)
        arc = torch.where(sd_in, torch.zeros_like(arc), arc)
    return active, t0, t1, arc


def _wrap_segment_t(p0, p1, gpos, gmat, radius: float, is_cylinder: bool,
                    side_world):
    """Batched ``wrap_segment``: world points ``(B, 3)``, ``gmat (B,3,3)``."""
    dot, nrm = maths.dot, maths.norm
    l0 = maths.matTvec(gmat, p0 - gpos)
    l1 = maths.matTvec(gmat, p1 - gpos)
    ls = None if side_world is None else maths.matTvec(gmat,
                                                       side_world - gpos)
    if is_cylinder:
        d0, z0 = l0[:, :2], l0[:, 2]
        d1, z1 = l1[:, :2], l1[:, 2]
        sd = None if ls is None else ls[:, :2]
        sd_inside = None if ls is None else (
            ls[:, 0] * ls[:, 0] + ls[:, 1] * ls[:, 1] < radius * radius)
        active, t0, t1, arc = _wrap_circle2d_t(d0, d1, sd, radius,
                                               sd_inside)
        len0 = nrm(d0 - t0)
        len1 = nrm(d1 - t1)
        tot = torch.clamp(len0 + arc + len1, min=1e-12)
        zt0 = z0 + (z1 - z0) * len0 / tot
        zt1 = z0 + (z1 - z0) * (len0 + arc) / tot
        wlen = torch.sqrt(arc * arc + (zt1 - zt0) ** 2)
        t0w = gpos + maths.matvec(gmat, torch.cat([t0, zt0[:, None]], -1))
        t1w = gpos + maths.matvec(gmat, torch.cat([t1, zt1[:, None]], -1))
        return active, t0w, t1w, wlen
    n0 = nrm(l0)
    e1 = l0 / torch.clamp(n0, min=1e-12)[:, None]
    t_vec = l1 - e1 * dot(l1, e1)[:, None]
    tn = nrm(t_vec)
    alt = torch.stack([e1[:, 1] - e1[:, 2], e1[:, 2] - e1[:, 0],
                       e1[:, 0] - e1[:, 1]], -1)
    altn = nrm(alt)
    alt2 = torch.stack([-e1[:, 1], e1[:, 0], torch.zeros_like(e1[:, 0])],
                       -1)
    alt = torch.where((altn > 1e-9)[:, None],
                      alt / torch.clamp(altn, min=1e-12)[:, None],
                      alt2 / torch.clamp(nrm(alt2), min=1e-12)[:, None])
    e2 = torch.where((tn > 1e-9)[:, None],
                     t_vec / torch.clamp(tn, min=1e-12)[:, None], alt)
    d0 = torch.stack([n0, torch.zeros_like(n0)], -1)
    d1 = torch.stack([dot(l1, e1), dot(l1, e2)], -1)
    sd = None if ls is None else torch.stack([dot(ls, e1), dot(ls, e2)], -1)
    sd_inside = None if ls is None else dot(ls, ls) < radius * radius
    active, t0, t1, arc = _wrap_circle2d_t(d0, d1, sd, radius, sd_inside)
    t0w = gpos + maths.matvec(gmat, e1 * t0[:, :1] + e2 * t0[:, 1:])
    t1w = gpos + maths.matvec(gmat, e1 * t1[:, :1] + e2 * t1[:, 1:])
    return active, t0w, t1w, arc


def tendon_length_moment(model: Model, d):
    """(B, ntendon) lengths and (B, ntendon, nv) moments dL/dq of fixed
    and spatial tendons (mj_tendon analog; needs position-stage Data)."""
    K = consts(model, d.qpos)
    tv, tq = tendon_jacobians(model, K)
    length = d.qpos @ tq.T
    moment = tv.expand((d.qpos.shape[0],) + tv.shape)
    if not has_spatial_tendon(model):
        return length, moment
    lengths = list(length.unbind(1))
    rows = list(moment.unbind(1))

    def seg_term(p1, j1, p2, j2, div):
        dvec = p2 - p1
        n = maths.norm(dvec)
        u = dvec / torch.clamp(n, min=1e-12)[:, None]
        return n / div, ((j2 - j1) * u[:, None, :]).sum(-1) / div

    gsize = np.asarray(model.geom_size, dtype=np.float64)
    for t in range(model.ntendon):
        if model.tendon_kind[t] != 1:
            continue
        path = _tendon_path(model, t)
        L = torch.zeros_like(d.time)
        row = torch.zeros_like(d.qvel)
        k = 0
        while k < len(path) - 1:
            kind1, obj1, _, br1, div = path[k]
            div = float(div)
            nxt = path[k + 1]
            if nxt[3] != br1:
                k += 1
                continue
            s1 = obj1
            p1 = d.site_xpos[:, s1]
            j1 = _point_jac_b(model, d, K, p1, model.site_bodyid[s1])
            if nxt[0] == 0:
                s2 = nxt[1]
                p2 = d.site_xpos[:, s2]
                j2 = _point_jac_b(model, d, K, p2, model.site_bodyid[s2])
                dl, dr = seg_term(p1, j1, p2, j2, div)
                L = L + dl
                row = row + dr
                k += 1
                continue
            g, side = nxt[1], nxt[2]
            s2 = path[k + 2][1]
            p2 = d.site_xpos[:, s2]
            j2 = _point_jac_b(model, d, K, p2, model.site_bodyid[s2])
            gb = model.geom_bodyid[g]
            is_cyl = GeomType(model.geom_type[g]) == GeomType.CYLINDER
            side_w = None if side < 0 else d.site_xpos[:, side]
            active, t0w, t1w, wlen = _wrap_segment_t(
                p1, p2, d.geom_xpos[:, g], d.geom_xmat[:, g],
                float(gsize[g][0]), is_cyl, side_w)
            jt0 = _point_jac_b(model, d, K, t0w, gb)
            jt1 = _point_jac_b(model, d, K, t1w, gb)
            dl0, dr0 = seg_term(p1, j1, t0w, jt0, div)
            dla, dra = seg_term(t0w, jt0, t1w, jt1, div)
            dl1, dr1 = seg_term(t1w, jt1, p2, j2, div)
            dls, drs = seg_term(p1, j1, p2, j2, div)
            L = L + torch.where(active, dl0 + wlen / div + dl1, dls)
            row = row + torch.where(active[:, None], dr0 + dra + dr1, drs)
            k += 2
        lengths[t] = L
        rows[t] = row
    return torch.stack(lengths, 1), torch.stack(rows, 1)


def _ident_quat(like):
    q = torch.zeros(like.shape[:-1] + (4,), dtype=like.dtype,
                    device=like.device)
    q[..., 0] = 1.0
    return q


def kinematics(model: Model, d):
    """Forward kinematics: body/geom/site poses and joint anchors/axes
    (mj_kinematics analog)."""
    K = consts(model, d.qpos)
    bsz = d.qpos.shape[0]
    body_pos, body_quat = K.f("body_pos"), K.f("body_quat")
    jnt_pos, jnt_axis = K.f("jnt_pos"), K.f("jnt_axis")
    qpos0 = np.asarray(model.qpos0, dtype=np.float64)
    zero3 = torch.zeros((bsz, 3), dtype=d.qpos.dtype, device=d.qpos.device)
    xpos = [zero3]
    xquat = [_ident_quat(zero3)]
    xanchor = [None] * model.njnt
    xaxis = [None] * model.njnt
    for b in range(1, model.nbody):
        p = model.body_parentid[b]
        mid = model.body_mocapid[b]
        if mid >= 0:
            pos = d.mocap_pos[:, mid]
            quat = maths.quat_normalize(d.mocap_quat[:, mid])
        else:
            pos = xpos[p] + maths.quat_rotate(xquat[p], body_pos[b])
            quat = maths.quat_mul(xquat[p], body_quat[b].expand(bsz, 4))
        jids = body_joints(model, b)
        if len(jids) == 1 and model.jnt_type[jids[0]] == JointType.FREE:
            j = jids[0]
            qadr = model.jnt_qposadr[j]
            pos = d.qpos[:, qadr:qadr + 3]
            quat = maths.quat_normalize(d.qpos[:, qadr + 3:qadr + 7])
            xanchor[j] = pos
            xaxis[j] = jnt_axis[j].expand(bsz, 3)
        else:
            for j in jids:
                jt = model.jnt_type[j]
                qadr = model.jnt_qposadr[j]
                anchor = pos + maths.quat_rotate(quat, jnt_pos[j])
                axis = maths.quat_rotate(quat, jnt_axis[j])
                if jt == JointType.SLIDE:
                    pos = pos + axis * (d.qpos[:, qadr:qadr + 1]
                                        - float(qpos0[qadr]))
                elif jt == JointType.BALL:
                    qloc = maths.quat_normalize(d.qpos[:, qadr:qadr + 4])
                    quat = maths.quat_mul(quat, qloc)
                    pos = anchor - maths.quat_rotate(quat, jnt_pos[j])
                elif jt == JointType.HINGE:
                    angle = d.qpos[:, qadr] - float(qpos0[qadr])
                    qloc = maths.axis_angle_to_quat(jnt_axis[j], angle)
                    quat = maths.quat_mul(quat, qloc)
                    pos = anchor - maths.quat_rotate(quat, jnt_pos[j])
                else:
                    raise NotImplementedError(f"joint type {jt}")
                xanchor[j] = anchor
                xaxis[j] = axis
        xpos.append(pos)
        xquat.append(maths.quat_normalize(quat))
    xpos = torch.stack(xpos, 1)
    xquat = torch.stack(xquat, 1)
    xmat = maths.quat_to_mat(xquat)
    if model.njnt:
        xanchor = torch.stack(xanchor, 1)
        xaxis = torch.stack(xaxis, 1)
    else:
        xanchor = xaxis = d.qpos.new_zeros((bsz, 0, 3))
    xipos = xpos + maths.matvec(xmat, K.f("body_ipos"))
    ximat = xmat @ K.t("body_imat", lambda: _quat_to_mat_np(model.body_iquat))
    gb = K.i("geom_bodyid", lambda: model.geom_bodyid)
    geom_xpos = xpos[:, gb] + maths.matvec(xmat[:, gb], K.f("geom_pos"))
    geom_xmat = xmat[:, gb] @ K.t("geom_mat",
                                  lambda: _quat_to_mat_np(model.geom_quat))
    if model.nsite:
        sb = K.i("site_bodyid", lambda: model.site_bodyid)
        site_xpos = xpos[:, sb] + maths.matvec(xmat[:, sb],
                                               K.f("site_pos"))
        site_xmat = xmat[:, sb] @ K.t(
            "site_mat", lambda: _quat_to_mat_np(model.site_quat))
    else:
        site_xpos = d.qpos.new_zeros((bsz, 0, 3))
        site_xmat = d.qpos.new_zeros((bsz, 0, 3, 3))
    return d.replace(
        xpos=xpos, xquat=xquat, xmat=xmat, xipos=xipos, ximat=ximat,
        xanchor=xanchor, xaxis=xaxis, geom_xpos=geom_xpos,
        geom_xmat=geom_xmat, site_xpos=site_xpos, site_xmat=site_xmat)


def _quat_to_mat_np(q):
    q = np.asarray(q, dtype=np.float64).reshape(-1, 4)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    r = np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], axis=-1)
    return r.reshape(-1, 3, 3)


def com_pos(model: Model, d):
    """Subtree coms, spatial inertias about each tree's com, and cdof
    (mj_comPos analog)."""
    K = consts(model, d.qpos)
    sub = K.t("subtree_mask", lambda: subtree_mask(model))
    mass = K.f("body_mass")
    wsum = torch.einsum("bc,c,nci->nbi", sub, mass, d.xipos)
    total = sub @ mass
    pos_total = total > 0
    safe = torch.where(pos_total, total, torch.ones_like(total))
    subtree_com = torch.where(pos_total[:, None], wsum / safe[:, None],
                              d.xpos)
    rootid = K.i("body_rootid", lambda: model.body_rootid)
    origin = subtree_com[:, rootid]
    i0, h, _ = maths.spatial_inertia(mass, K.f("body_inertia"), d.xipos,
                                     d.ximat, origin)
    cdof = [None] * model.nv
    for j in range(model.njnt):
        jt = model.jnt_type[j]
        vadr = model.jnt_dofadr[j]
        b = model.jnt_bodyid[j]
        com = subtree_com[:, model.body_rootid[b]]
        if jt == JointType.FREE:
            z = torch.zeros_like(com)
            for i in range(3):
                e = torch.zeros_like(com)
                e[:, i] = 1.0
                cdof[vadr + i] = torch.cat([z, e], -1)
            offset = com - d.xpos[:, b]
            for i in range(3):
                ax = d.xmat[:, b, :, i]
                cdof[vadr + 3 + i] = torch.cat([ax, maths.cross(ax, offset)],
                                               -1)
        elif jt == JointType.BALL:
            offset = com - d.xanchor[:, j]
            for i in range(3):
                ax = d.xmat[:, b, :, i]
                cdof[vadr + i] = torch.cat([ax, maths.cross(ax, offset)], -1)
        elif jt == JointType.SLIDE:
            cdof[vadr] = torch.cat([torch.zeros_like(com), d.xaxis[:, j]],
                                   -1)
        else:
            offset = com - d.xanchor[:, j]
            ax = d.xaxis[:, j]
            cdof[vadr] = torch.cat([ax, maths.cross(ax, offset)], -1)
    cdof = (torch.stack(cdof, 1) if model.nv
            else d.qpos.new_zeros((d.qpos.shape[0], 0, 6)))
    return d.replace(subtree_com=subtree_com, cinert_i=i0, cinert_h=h,
                     cdof=cdof)


def crb(model: Model, d):
    """Composite rigid bodies -> dense joint-space inertia qM (mj_crb)."""
    if model.nv == 0:
        return d
    K = consts(model, d.qpos)
    subf = K.t("subtree_mask", lambda: subtree_mask(model))
    crb_i = torch.einsum("bc,ncij->nbij", subf, d.cinert_i)
    crb_h = torch.einsum("bc,nci->nbi", subf, d.cinert_h)
    crb_m = subf @ K.f("body_mass")
    db = K.i("dof_bodyid", lambda: model.dof_bodyid)
    f = maths.inertia_mul_motion(crb_i[:, db], crb_h[:, db], crb_m[db],
                                 d.cdof)
    m_full = torch.einsum("njk,nik->nij", d.cdof, f)
    anc = K.b("dof_ancestor", lambda: dof_ancestor_mask(model))
    zero = torch.zeros_like(m_full)
    qm = torch.where(anc, m_full, zero)
    qm = torch.where(anc.T, m_full.transpose(-1, -2), qm)
    qm = qm + torch.diag(K.f("dof_armature"))
    return d.replace(qM=qm)


def camera_lookat_mat(pos, target):
    """Target-mode camera orientation (columns x, y, z), batched."""
    vec = pos - target
    z = vec / torch.clamp(maths.norm(vec), min=1e-15)[:, None]
    up = torch.zeros_like(z)
    up[:, 2] = 1.0
    x = maths.cross(up, z)
    xn = maths.norm(x)
    alt = torch.zeros_like(z)
    alt[:, 0] = 1.0
    x = torch.where((xn > 1e-9)[:, None],
                    x / torch.clamp(xn, min=1e-15)[:, None], alt)
    y = maths.cross(z, x)
    return torch.stack([x, y, z], dim=-1)


def cam_light(model: Model, d):
    """Camera poses per mode (mj_camlight analog)."""
    if not model.ncam:
        return d
    K = consts(model, d.qpos)
    bsz = d.qpos.shape[0]
    poss, mats = [], []
    for i in range(model.ncam):
        mode = CamMode(model.cam_mode[i])
        b = model.cam_bodyid[i]
        if mode == CamMode.TRACK:
            pos = d.xpos[:, b] + K.f("cam_pos0")[i]
            mat = K.f("cam_mat0")[i].expand(bsz, 3, 3)
        elif mode == CamMode.TRACKCOM:
            pos = d.subtree_com[:, b] + K.f("cam_poscom0")[i]
            mat = K.f("cam_mat0")[i].expand(bsz, 3, 3)
        else:
            pos = d.xpos[:, b] + maths.matvec(d.xmat[:, b],
                                              K.f("cam_pos")[i])
            mat = d.xmat[:, b] @ K.t(
                "cam_mat", lambda: _quat_to_mat_np(model.cam_quat))[i]
            if mode in (CamMode.TARGETBODY, CamMode.TARGETBODYCOM):
                tb = model.cam_targetbodyid[i]
                target = (d.xpos[:, tb] if mode == CamMode.TARGETBODY
                          else d.subtree_com[:, tb])
                mat = camera_lookat_mat(pos, target)
        poss.append(pos)
        mats.append(mat)
    return d.replace(cam_xpos=torch.stack(poss, 1),
                     cam_xmat=torch.stack(mats, 1))


def com_vel(model: Model, d):
    """cvel and cdof_dot (mj_comVel analog)."""
    z6 = torch.zeros((d.qvel.shape[0], 6), dtype=d.qvel.dtype,
                     device=d.qvel.device)
    cvel = [z6] * model.nbody
    cdof_dot = [z6] * model.nv
    for b in range(1, model.nbody):
        v = cvel[model.body_parentid[b]]
        for j in body_joints(model, b):
            jt = model.jnt_type[j]
            vadr = model.jnt_dofadr[j]
            if jt == JointType.FREE:
                v = v + torch.einsum("ni,nij->nj", d.qvel[:, vadr:vadr + 3],
                                     d.cdof[:, vadr:vadr + 3])
                for i in range(3):
                    cdof_dot[vadr + 3 + i] = maths.motion_cross(
                        v, d.cdof[:, vadr + 3 + i])
                v = v + torch.einsum("ni,nij->nj",
                                     d.qvel[:, vadr + 3:vadr + 6],
                                     d.cdof[:, vadr + 3:vadr + 6])
            elif jt == JointType.BALL:
                for i in range(3):
                    cdof_dot[vadr + i] = maths.motion_cross(
                        v, d.cdof[:, vadr + i])
                v = v + torch.einsum("ni,nij->nj", d.qvel[:, vadr:vadr + 3],
                                     d.cdof[:, vadr:vadr + 3])
            else:
                cdof_dot[vadr] = maths.motion_cross(v, d.cdof[:, vadr])
                v = v + d.qvel[:, vadr:vadr + 1] * d.cdof[:, vadr]
        cvel[b] = v
    cvel = torch.stack(cvel, 1)
    cdof_dot = (torch.stack(cdof_dot, 1) if model.nv
                else d.qvel.new_zeros((d.qvel.shape[0], 0, 6)))
    return d.replace(cvel=cvel, cdof_dot=cdof_dot)


def _gravity_acc(model: Model, like):
    """[0; -g] (B, 6), the root's spatial acceleration."""
    g = (0.0, 0.0, 0.0) if model.opt.disable_gravity else model.opt.gravity
    a = torch.zeros((like.shape[0], 6), dtype=like.dtype, device=like.device)
    for i in range(3):
        if g[i] != 0.0:
            a[:, 3 + i] = -float(g[i])
    return a


def rne(model: Model, d):
    """qfrc_bias, the Coriolis, centrifugal and gravity forces (mj_rne
    with flg_acc = 0)."""
    K = consts(model, d.qpos)
    cacc = [_gravity_acc(model, d.qvel)]
    for b in range(1, model.nbody):
        a = cacc[model.body_parentid[b]]
        adr, num = model.body_dofadr[b], model.body_dofnum[b]
        if num:
            a = a + torch.einsum("ni,nij->nj", d.qvel[:, adr:adr + num],
                                 d.cdof_dot[:, adr:adr + num])
        cacc.append(a)
    cacc = torch.stack(cacc, 1)
    mass = K.f("body_mass")
    iv = maths.inertia_mul_motion(d.cinert_i, d.cinert_h, mass, d.cvel)
    ia = maths.inertia_mul_motion(d.cinert_i, d.cinert_h, mass, cacc)
    cfrc = ia + maths.force_cross(d.cvel, iv)
    subf = K.t("subtree_mask", lambda: subtree_mask(model))
    cfrc_total = torch.einsum("bc,nck->nbk", subf, cfrc)
    db = K.i("dof_bodyid", lambda: model.dof_bodyid)
    qfrc_bias = (d.cdof * cfrc_total[:, db]).sum(-1)
    return d.replace(qfrc_bias=qfrc_bias)


def passive(model: Model, d):
    """Joint springs, dof damping, tendon springs and dampers, and fluid
    forces (mj_passive analog)."""
    K = consts(model, d.qpos)
    cols = list(torch.zeros_like(d.qvel).unbind(1))
    stiff_all = np.asarray(model.jnt_stiffness, dtype=np.float64)
    qspring = K.f("qpos_spring")
    for j in range(model.njnt):
        stiff = float(stiff_all[j])
        jt = model.jnt_type[j]
        qadr = model.jnt_qposadr[j]
        vadr = model.jnt_dofadr[j]
        if jt in (JointType.HINGE, JointType.SLIDE):
            cols[vadr] = cols[vadr] + (-stiff * (d.qpos[:, qadr]
                                                 - qspring[qadr]))
        elif jt == JointType.BALL:
            dif = maths.quat_sub(d.qpos[:, qadr:qadr + 4],
                                 qspring[qadr:qadr + 4])
            for i in range(3):
                cols[vadr + i] = cols[vadr + i] + (-stiff * dif[:, i])
        else:
            dif = d.qpos[:, qadr:qadr + 3] - qspring[qadr:qadr + 3]
            difq = maths.quat_sub(d.qpos[:, qadr + 3:qadr + 7],
                                  qspring[qadr + 3:qadr + 7])
            for i in range(3):
                cols[vadr + i] = cols[vadr + i] + (-stiff * dif[:, i])
                cols[vadr + 3 + i] = cols[vadr + 3 + i] + (-stiff
                                                           * difq[:, i])
    qfrc = (torch.stack(cols, 1) if model.nv else torch.zeros_like(d.qvel))
    qfrc = qfrc - K.f("dof_damping") * d.qvel
    if model.ntendon:
        length, moment = tendon_length_moment(model, d)
        vel = (moment * d.qvel[:, None, :]).sum(-1)
        ls = K.f("tendon_lengthspring")
        lo, hi = ls[:, 0], ls[:, 1]
        zero = torch.zeros_like(length)
        disp = torch.where(length < lo, lo - length,
                           torch.where(length > hi, hi - length, zero))
        frc = K.f("tendon_stiffness") * disp - K.f("tendon_damping") * vel
        qfrc = qfrc + (moment * frc[:, :, None]).sum(1)
    if (model.opt.density != 0.0 or model.opt.viscosity != 0.0
            or any(w != 0.0 for w in model.opt.wind)):
        qfrc = qfrc + _fluid_forces(model, d)
    return d.replace(qfrc_passive=qfrc)


def _body_wrench_to_qfrc(model: Model, d, K, force, torque):
    """Generalized force of per-body world wrenches ``force, torque
    (B, nbody, 3)`` applied at the body coms."""
    rootid = K.i("body_rootid", lambda: model.body_rootid)
    arm = d.xipos - d.subtree_com[:, rootid]
    spatial = torch.cat([torque + maths.cross(arm, force), force], -1)
    mask = _bdm(model, K)
    proj = torch.einsum("nik,nbk->nbi", d.cdof, spatial)
    return (mask * proj).sum(1)


def _fluid_forces(model: Model, d):
    """mj_fluid analog: drag of each body's equivalent inertia box."""
    K = consts(model, d.qpos)
    rho = float(model.opt.density)
    eta = float(model.opt.viscosity)
    wind = torch.stack([torch.full_like(d.time, float(w))
                        for w in model.opt.wind], -1)
    mass_np = np.asarray(model.body_mass, dtype=np.float64)
    inert = K.f("body_inertia")
    mass = K.f("body_mass")
    forces, torques = [], []
    zero3 = torch.zeros((d.qpos.shape[0], 3), dtype=d.qpos.dtype,
                        device=d.qpos.device)
    for b in range(model.nbody):
        if b == 0 or mass_np[b] <= 0:
            forces.append(zero3)
            torques.append(zero3)
            continue
        I = inert[b]
        I_j = torch.stack([I[1], I[2], I[0]])
        I_k = torch.stack([I[2], I[0], I[1]])
        rbox = torch.sqrt(torch.clamp(1.5 * (I_j + I_k - I) / mass[b],
                                      min=1e-12))
        origin = d.subtree_com[:, model.body_rootid[b]]
        w_w = d.cvel[:, b, :3]
        v_w = d.cvel[:, b, 3:] + maths.cross(w_w, d.xipos[:, b] - origin) \
            - wind
        R = d.ximat[:, b]
        w_l = maths.matTvec(R, w_w)
        v_l = maths.matTvec(R, v_w)
        rbar = rbox.mean()
        f_l = torch.zeros_like(v_l)
        t_l = torch.zeros_like(w_l)
        if eta != 0.0:
            f_l = f_l - 6.0 * math.pi * eta * rbar * v_l
            t_l = t_l - 8.0 * math.pi * eta * rbar ** 3 * w_l
        if rho != 0.0:
            rj = torch.stack([rbox[1], rbox[2], rbox[0]])
            rk = torch.stack([rbox[2], rbox[0], rbox[1]])
            f_l = f_l - 2.0 * rho * rj * rk * torch.abs(v_l) * v_l
            t_l = t_l - 0.5 * rho * rbox * (rj ** 4 + rk ** 4) * (
                torch.abs(w_l) * w_l)
        forces.append(maths.matvec(R, f_l))
        torques.append(maths.matvec(R, t_l))
    return _body_wrench_to_qfrc(model, d, K, torch.stack(forces, 1),
                                torch.stack(torques, 1))


def _site_jacs(model, d, K, s):
    """(jacp, jacr) of site ``s``: (B, nv, 3) each."""
    b = model.site_bodyid[s]
    origin = d.subtree_com[:, model.body_rootid[b]]
    mask = _bdm(model, K)[b][:, None]
    ang = d.cdof[..., :3] * mask
    lin = d.cdof[..., 3:] * mask
    return lin + maths.cross(ang, (d.site_xpos[:, s] - origin)[:, None]), ang


def actuator_moments(model: Model, d):
    """(B, nu, nv) transmission moments and (B, nu) actuator lengths
    (mj_transmission analog)."""
    from .collision import max_contacts_per_pair

    K = consts(model, d.qpos)
    bsz = d.qpos.shape[0]
    gear_np = np.asarray(model.actuator_gear, dtype=np.float64)
    gear_t = K.f("actuator_gear")
    zrow = torch.zeros_like(d.qvel)
    zlen = torch.zeros_like(d.time)
    moments, lengths = [], []
    tjac = None
    for u in range(model.nu):
        trn = model.actuator_trntype[u]
        gear = gear_np[u]
        if trn == TrnType.TENDON:
            t = model.actuator_trnid[u]
            if tjac is None:
                tjac = tendon_length_moment(model, d)
            g0 = float(gear[0])
            moments.append(g0 * tjac[1][:, t])
            lengths.append(g0 * tjac[0][:, t])
            continue
        if trn == TrnType.BODY:
            b = model.actuator_trnid[u]
            row = zrow
            nactive = zlen
            lane = 0
            for (t1, t2, prs) in model.pair_groups:
                k = max_contacts_per_pair(t1, t2)
                for (ga, gb) in prs:
                    b1 = model.geom_bodyid[ga]
                    b2 = model.geom_bodyid[gb]
                    if b not in (b1, b2):
                        lane += k
                        continue
                    for kk in range(k):
                        li = lane + kk
                        n = d.contact.frame[:, li, 0]
                        p = d.contact.pos[:, li]
                        j1 = _point_jac_b(model, d, K, p, b1)
                        j2 = _point_jac_b(model, d, K, p, b2)
                        jn = ((j2 - j1) * n[:, None, :]).sum(-1)
                        act = (d.contact.dist[:, li]
                               < d.contact.includemargin[:, li])
                        row = row + torch.where(act[:, None], jn, zrow)
                        nactive = nactive + act.to(row.dtype)
                    lane += k
            moments.append(-row / torch.clamp(nactive, min=1.0)[:, None])
            lengths.append(zlen)
            continue
        if trn == TrnType.SITE:
            s = model.actuator_trnid[u]
            jacp, ang = _site_jacs(model, d, K, s)
            refid = (model.actuator_refid[u]
                     if getattr(model, "actuator_refid", ()) else -1)
            if refid < 0:
                wf = maths.matvec(d.site_xmat[:, s], gear_t[u, :3])
                wt = maths.matvec(d.site_xmat[:, s], gear_t[u, 3:])
                moments.append(maths.matvec(jacp, wf)
                               + maths.matvec(ang, wt))
                lengths.append(zlen)
                continue
            # refsite: pose of the site relative to the refsite, in the
            # refsite's frame, projected on the gear (mj_transmission)
            rjacp, rang = _site_jacs(model, d, K, refid)
            rmat = d.site_xmat[:, refid]
            dp = d.site_xpos[:, s] - d.site_xpos[:, refid]
            qs = maths.mat_to_quat(d.site_xmat[:, s])
            qr = maths.mat_to_quat(rmat)
            length_u = (maths.dot(maths.matTvec(rmat, dp), gear_t[u, :3])
                        + maths.dot(maths.quat_sub(qs, qr), gear_t[u, 3:]))
            jac_t = (jacp - rjacp + maths.cross(dp[:, None, :], rang)) @ rmat
            jac_r = (ang - rang) @ rmat
            moments.append(maths.matvec(jac_t, gear_t[u, :3])
                           + maths.matvec(jac_r, gear_t[u, 3:]))
            lengths.append(length_u)
            continue
        if trn != TrnType.JOINT:
            raise NotImplementedError("transmission type "
                                      f"{model.actuator_trntype[u]}")
        j = model.actuator_trnid[u]
        jt = model.jnt_type[j]
        qadr, vadr = model.jnt_qposadr[j], model.jnt_dofadr[j]
        row = np.zeros(model.nv)
        if jt in (JointType.HINGE, JointType.SLIDE):
            row[vadr] = gear[0]
            lengths.append(d.qpos[:, qadr] * float(gear[0]))
        elif jt == JointType.BALL:
            row[vadr:vadr + 3] = gear[:3]
            q = maths.quat_normalize(d.qpos[:, qadr:qadr + 4])
            expmap = maths.quat_sub(q, _ident_quat(q))
            lengths.append(maths.dot(expmap, gear_t[u, :3]))
        else:
            row[vadr:vadr + 6] = gear[:6]
            lengths.append(zlen)
        moments.append(K.t(f"joint_moment_{u}", lambda r=row: r).expand(
            bsz, model.nv))
    if not model.nu:
        return (d.qvel.new_zeros((bsz, 0, model.nv)),
                d.qvel.new_zeros((bsz, 0)))
    return torch.stack(moments, 1), torch.stack(lengths, 1)


def _clip_ctrl(model: Model, K, ctrl):
    lim = K.b("ctrllimited", lambda: np.asarray(model.actuator_ctrllimited,
                                                dtype=bool))
    cr = K.f("actuator_ctrlrange")
    return torch.where(lim, torch.minimum(torch.maximum(ctrl, cr[:, 0]),
                                          cr[:, 1]), ctrl)


def actuation(model: Model, d):
    """Actuator lengths, velocities, forces, activation derivatives and
    qfrc_actuator (mj_fwdActuation analog)."""
    from . import muscle as _muscle

    if model.nu == 0:
        return d.replace(qfrc_actuator=torch.zeros_like(d.qvel))
    K = consts(model, d.qpos)
    moments, lengths = actuator_moments(model, d)
    velocity = (moments * d.qvel[:, None, :]).sum(-1)
    ctrl = _clip_ctrl(model, K, d.ctrl)
    actadr = np.array(model.actuator_actadr)
    stateful = actadr >= 0
    dynprm = np.asarray(model.actuator_dynprm, dtype=np.float64)
    if model.na:
        act_u = d.act[:, K.i("act_of_u", lambda: np.maximum(actadr, 0))]
        dyntype = np.array(model.actuator_dyntype)
        tau = K.t("act_tau", lambda: np.maximum(dynprm[:, 0], 1e-15))
        integ = K.b("dyn_integrator", lambda: dyntype == DynType.INTEGRATOR)
        act_dot_u = torch.where(integ, ctrl, (ctrl - act_u) / tau)
        cols = list(act_dot_u.unbind(1))
        for u in np.flatnonzero(dyntype == DynType.MUSCLE):
            cols[u] = _muscle.muscle_dynamics(
                maths.TensorOps, ctrl[:, u], act_u[:, u],
                [float(x) for x in dynprm[u]])
        act_dot_u = torch.stack(cols, 1)
        act_dot = act_dot_u[:, K.i("u_of_act", lambda: _u_of_act(model))]
        force_input = torch.where(K.b("stateful", lambda: stateful), act_u,
                                  ctrl)
    else:
        act_dot = d.act
        force_input = ctrl
    gaintype = np.array(model.actuator_gaintype)
    biastype = np.array(model.actuator_biastype)
    gp = K.f("actuator_gainprm")
    bp = K.f("actuator_biasprm")
    gain = torch.where(
        K.b("gain_fixed", lambda: gaintype == GainType.FIXED),
        gp[:, 0].expand_as(lengths),
        gp[:, 0] + gp[:, 1] * lengths + gp[:, 2] * velocity)
    bias = torch.where(
        K.b("bias_none", lambda: biastype == BiasType.NONE),
        torch.zeros_like(lengths),
        bp[:, 0] + bp[:, 1] * lengths + bp[:, 2] * velocity)
    if np.any(gaintype == GainType.MUSCLE) or np.any(
            biastype == BiasType.MUSCLE):
        lr = np.asarray(model.actuator_lengthrange, dtype=np.float64)
        acc0 = np.asarray(model.actuator_acc0, dtype=np.float64)
        gpn = np.asarray(model.actuator_gainprm, dtype=np.float64)
        bpn = np.asarray(model.actuator_biasprm, dtype=np.float64)
        gcols = list(gain.unbind(1))
        bcols = list(bias.unbind(1))
        for u in np.flatnonzero(gaintype == GainType.MUSCLE):
            gcols[u] = _muscle.muscle_gain(
                maths.TensorOps, lengths[:, u], velocity[:, u],
                [float(x) for x in lr[u]],
                float(acc0[u]), [float(x) for x in gpn[u]])
        for u in np.flatnonzero(biastype == BiasType.MUSCLE):
            bcols[u] = _muscle.muscle_bias(
                maths.TensorOps, lengths[:, u],
                [float(x) for x in lr[u]],
                float(acc0[u]), [float(x) for x in bpn[u]])
        gain = torch.stack(gcols, 1)
        bias = torch.stack(bcols, 1)
    force = gain * force_input + bias
    fr = K.f("actuator_forcerange")
    force = torch.where(
        K.b("forcelimited", lambda: np.asarray(model.actuator_forcelimited,
                                               dtype=bool)),
        torch.minimum(torch.maximum(force, fr[:, 0]), fr[:, 1]), force)
    qfrc_actuator = (moments * force[:, :, None]).sum(1)
    return d.replace(actuator_length=lengths, actuator_velocity=velocity,
                     actuator_force=force, act_dot=act_dot,
                     qfrc_actuator=qfrc_actuator)


def _u_of_act(model: Model):
    """The actuator of each activation slot."""
    out = np.zeros(model.na, dtype=np.int64)
    for u, a in enumerate(model.actuator_actadr):
        if a >= 0:
            out[a] = u
    return out


def xfrc_accumulate(model: Model, d):
    """xfrc_applied ([force; torque] at body coms) as generalized forces
    (mj_xfrcAccumulate analog)."""
    K = consts(model, d.qpos)
    return _body_wrench_to_qfrc(model, d, K, d.xfrc_applied[..., :3],
                                d.xfrc_applied[..., 3:])


def fwd_acceleration(model: Model, d):
    """qfrc_smooth and qacc_smooth = M^-1 qfrc_smooth."""
    qfrc_smooth = (d.qfrc_passive - d.qfrc_bias + d.qfrc_actuator
                   + d.qfrc_applied + xfrc_accumulate(model, d))
    qacc_smooth = maths.solve_pd(d.qM, qfrc_smooth)
    return d.replace(qfrc_smooth=qfrc_smooth, qacc_smooth=qacc_smooth)
