"""Build-time structure helpers of the smooth-dynamics stage.

The port's numpy copies of the static helpers in
``oxide_control_tpu/physics/smooth.py`` that the scalar graph and the MJCF
compiler read: tree masks, joint lists and tendon paths, plus the numpy
form of the wrap geometry ``mjcf.compile`` evaluates at qpos0.  The
batched general-path stages (kinematics, CRB, RNE, passive, actuation) are
ROADMAP Queue A item 11 and are not ported yet.
"""

from __future__ import annotations

import numpy as np

from ..model import Model


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
