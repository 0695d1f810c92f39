"""Narrowphase collision: contact lanes of the candidate pairs, batched.

The port of ``oxide_control_tpu/physics/collision.py``: its lane counts
(``max_contacts_per_pair``, also read by the scalar graph), the contact
frame, every closed-form primitive pair (``_PRIMS``, plane-sphere through
box-box), Minkowski Portal Refinement with its perturbed-support manifold
lanes for the other convex pairs (meshes included), plane against mesh,
the height-field pairs (analytic for spheres and capsules, MPR against
the 18 triangle prisms of a 3x3 cell window for boxes, ellipsoids and
cylinders), the ``collision()`` dispatcher, ``contact_condims`` and
``geom_distance``.  Candidate pairs are fixed at compile time; every pair
owns a fixed number of lanes and a lane with ``dist >= includemargin`` is
inactive.  Each narrowphase takes world poses with any leading axes (the
env axis, then the pairs of one type group), where the reference
``vmap``s one pair or loops over them; the pairs of a group run as one
batch (meshes padded to the group's largest vertex count, height fields
as per-pair grid constants over the flat elevation data).  Every loop has
a fixed count and every selection is a mask or a device-side gather, so a
step captures in a CUDA graph.  Mesh against height field is rejected by
the compiler, as in the reference.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..model import GeomType, Model
from . import maths
from .consts import consts

_CONVEX_TYPES = (
    GeomType.SPHERE, GeomType.CAPSULE, GeomType.ELLIPSOID,
    GeomType.CYLINDER, GeomType.BOX, GeomType.MESH,
)

def max_contacts_per_pair(t1: int, t2: int) -> int:
    """Fixed contact-lane count per candidate pair of geom types."""
    pair = (GeomType(t1), GeomType(t2))
    if pair == (GeomType.PLANE, GeomType.CAPSULE):
        return 2
    if pair == (GeomType.PLANE, GeomType.BOX):
        return 8
    if pair == (GeomType.PLANE, GeomType.CYLINDER):
        return 4
    if pair == (GeomType.CAPSULE, GeomType.CAPSULE):
        return 1
    if pair == (GeomType.CAPSULE, GeomType.BOX):
        return 3
    if pair == (GeomType.BOX, GeomType.BOX):
        return 8
    if pair == (GeomType.PLANE, GeomType.MESH):
        return 4
    if pair == (GeomType.HFIELD, GeomType.CAPSULE):
        return 3
    if pair in ((GeomType.HFIELD, GeomType.BOX),
                (GeomType.HFIELD, GeomType.ELLIPSOID),
                (GeomType.HFIELD, GeomType.CYLINDER)):
        # 3x3 cell window x 2 triangle prisms, each with an MPR witness +
        # 4 perturbed-support manifold lanes (flat-face/ridge restings)
        return 90
    if (pair[0] in _CONVEX_TYPES and pair[1] in _CONVEX_TYPES
            and pair not in _PRIMS):
        return 5  # MPR + 4 perturbed-support manifold lanes
    return 1


def _vec(like, x, y, z):
    """(..., 3) constant vector shaped like ``like (..., 3)``."""
    out = torch.empty_like(like)
    out[..., 0] = x
    out[..., 1] = y
    out[..., 2] = z
    return out


def _w(cond, a, b):
    """torch.where with a trailing-axis broadcast of a (...,) condition."""
    while cond.dim() < max(a.dim() if isinstance(a, torch.Tensor) else 0,
                           b.dim() if isinstance(b, torch.Tensor) else 0):
        cond = cond[..., None]
    if not isinstance(a, torch.Tensor):
        a = torch.full_like(b, a)
    if not isinstance(b, torch.Tensor):
        b = torch.full_like(a, b)
    return torch.where(cond, a, b)


def make_frame(n: torch.Tensor) -> torch.Tensor:
    """Right-handed contact frame rows [n; t1; t2] from unit normals
    (mju_makeFrame: t1 from world y when |n_y| < 0.5, else world z)."""
    use_y = torch.abs(n[..., 1]) < 0.5
    seed = _w(use_y, _vec(n, 0.0, 1.0, 0.0), _vec(n, 0.0, 0.0, 1.0))
    t1 = seed - n * (n * seed).sum(-1, keepdim=True)
    t1 = t1 / maths.norm(t1)[..., None]
    t2 = maths.cross(n, t1)
    return torch.stack([n, t1, t2], dim=-2)


def _col(m, k):
    return m[..., :, k]


# ---------------------------------------------------------------------------
# primitives: world geometry of the pairs, any leading axes ->
# (dist (..., k), pos (..., k, 3), frame (..., k, 3, 3))
# ---------------------------------------------------------------------------


def _plane_sphere(ppos, pmat, psize, cpos, cmat, csize):
    n = _col(pmat, 2)
    r = csize[..., 0]
    dist = maths.dot(n, cpos - ppos) - r
    pos = cpos - n * (r + 0.5 * dist)[..., None]
    return dist[..., None], pos[..., None, :], make_frame(n)[..., None, :, :]


def _plane_capsule(ppos, pmat, psize, cpos, cmat, csize):
    n = _col(pmat, 2)
    r, hl = csize[..., 0], csize[..., 1]
    axis = _col(cmat, 2)
    ends = torch.stack([cpos + axis * hl[..., None],
                        cpos - axis * hl[..., None]], -2)       # (..., 2, 3)
    dist = (ends * n[..., None, :]).sum(-1) - maths.dot(n, ppos)[..., None] \
        - r[..., None]
    pos = ends - n[..., None, :] * (r[..., None] + 0.5 * dist)[..., None]
    t1 = axis - n * maths.dot(n, axis)[..., None]
    nrm = maths.norm(t1)
    x0 = _col(cmat, 0)
    alt = x0 - n * maths.dot(n, x0)[..., None]
    big = nrm > 1e-10
    t1 = _w(big, t1 / _w(big, nrm, 1.0)[..., None],
            alt / maths.norm(alt)[..., None])
    t2 = maths.cross(n, t1)
    frame = torch.stack([n, t1, t2], -2)
    return dist, pos, frame[..., None, :, :].expand(
        frame.shape[:-2] + (2, 3, 3))


_BOX_SIGNS = [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
              for sz in (-1, 1)]


def _plane_box(ppos, pmat, psize, bpos, bmat, bsize):
    n = _col(pmat, 2)
    signs = _box_signs(bpos)
    loc = signs * bsize[..., None, :]                           # (..., 8, 3)
    corners = bpos[..., None, :] + maths.matvec(bmat[..., None, :, :], loc)
    dist = (corners * n[..., None, :]).sum(-1) - maths.dot(n, ppos)[..., None]
    pos = corners - n[..., None, :] * (0.5 * dist)[..., None]
    f = make_frame(n)
    return dist, pos, f[..., None, :, :].expand(f.shape[:-2] + (8, 3, 3))


_SIGNS_CACHE: dict = {}


def _box_signs(like):
    key = (like.device, like.dtype)
    t = _SIGNS_CACHE.get(key)
    if t is None:
        t = _SIGNS_CACHE[key] = torch.tensor(_BOX_SIGNS, dtype=like.dtype,
                                             device=like.device)
    return t


def _sphere_sphere_raw(p1, r1, p2, r2):
    delta = p2 - p1
    d = maths.norm(delta)
    big = d > 1e-12
    n = _w(big, delta / _w(big, d, 1.0)[..., None], _vec(delta, 0, 0, 1.0))
    dist = d - r1 - r2
    pos = p1 + n * (r1 + 0.5 * dist)[..., None]
    return dist, pos, n


def _one(dist, pos, n):
    return dist[..., None], pos[..., None, :], make_frame(n)[..., None, :, :]


def _sphere_sphere(p1pos, p1mat, s1, p2pos, p2mat, s2):
    return _one(*_sphere_sphere_raw(p1pos, s1[..., 0], p2pos, s2[..., 0]))


def _closest_on_segment(a, b, p):
    ab = b - a
    denom = maths.dot(ab, ab)
    ok = denom > 1e-16
    t = _w(ok, maths.dot(p - a, ab) / _w(ok, denom, 1.0), 0.0)
    t = torch.clamp(t, 0.0, 1.0)
    return a + t[..., None] * ab


def _sphere_capsule(spos, smat, ssize, cpos, cmat, csize):
    r2, hl = csize[..., 0], csize[..., 1]
    axis = _col(cmat, 2)
    a = cpos - axis * hl[..., None]
    b = cpos + axis * hl[..., None]
    closest = _closest_on_segment(a, b, spos)
    return _one(*_sphere_sphere_raw(spos, ssize[..., 0], closest, r2))


def _segment_segment(a1, b1, a2, b2):
    d1 = b1 - a1
    d2 = b2 - a2
    r = a1 - a2
    a = maths.dot(d1, d1)
    e = maths.dot(d2, d2)
    f = maths.dot(d2, r)
    c = maths.dot(d1, r)
    b = maths.dot(d1, d2)
    denom = a * e - b * b
    okd = denom > 1e-14
    s = _w(okd, torch.clamp((b * f - c * e) / _w(okd, denom, 1.0), 0.0, 1.0),
           0.0)
    oke = e > 1e-14
    t = _w(oke, (b * s + f) / _w(oke, e, 1.0), 0.0)
    t_cl = torch.clamp(t, 0.0, 1.0)
    oka = a > 1e-14
    s = _w(torch.abs(t - t_cl) > 0,
           torch.clamp(_w(oka, (b * t_cl - c) / _w(oka, a, 1.0), 0.0),
                       0.0, 1.0), s)
    t = t_cl
    return a1 + s[..., None] * d1, a2 + t[..., None] * d2


def _capsule_capsule(c1pos, c1mat, s1, c2pos, c2mat, s2):
    r1, hl1 = s1[..., 0], s1[..., 1]
    r2, hl2 = s2[..., 0], s2[..., 1]
    ax1, ax2 = _col(c1mat, 2), _col(c2mat, 2)
    p1, p2 = _segment_segment(c1pos - ax1 * hl1[..., None],
                              c1pos + ax1 * hl1[..., None],
                              c2pos - ax2 * hl2[..., None],
                              c2pos + ax2 * hl2[..., None])
    return _one(*_sphere_sphere_raw(p1, r1, p2, r2))


def _sphere_box_raw(spos, r, bpos, bmat, bsize):
    local = maths.matTvec(bmat, spos - bpos)
    clamped = torch.minimum(torch.maximum(local, -bsize), bsize)
    inside = (torch.abs(local) < bsize).all(-1)
    closest_out = bpos + maths.matvec(bmat, clamped)
    delta = spos - closest_out
    dn = maths.norm(delta)
    big = dn > 1e-12
    n_out = _w(big, delta / _w(big, dn, 1.0)[..., None], _col(bmat, 2))
    dist_out = dn - r
    depth = bsize - torch.abs(local)
    ax = torch.argmin(depth, dim=-1)
    dsel = torch.gather(depth, -1, ax[..., None])[..., 0]
    lsel = torch.gather(local, -1, ax[..., None])[..., 0]
    axcol = torch.gather(bmat, -1, ax[..., None, None].expand(
        bmat.shape[:-1] + (1,)))[..., 0]
    n_in = torch.sign(lsel)[..., None] * axcol
    dist_in = -(dsel + r)
    dist = _w(inside, dist_in, dist_out)
    n = _w(inside, -n_in, -n_out)
    pos = spos + n * (r + 0.5 * dist)[..., None]
    return dist, pos, n


def _sphere_box(spos, smat, ssize, bpos, bmat, bsize):
    return _one(*_sphere_box_raw(spos, ssize[..., 0], bpos, bmat, bsize))


def _plane_ellipsoid(ppos, pmat, psize, epos, emat, esize):
    n = _col(pmat, 2)
    a = maths.matTvec(emat, n)
    w = (esize * esize) * a
    denom = torch.sqrt(torch.clamp(maths.dot(a, w), min=1e-20))
    x = epos - maths.matvec(emat, w / denom[..., None])
    dist = maths.dot(n, x - ppos)
    pos = x - n * (0.5 * dist)[..., None]
    return _one(dist, pos, n)


def _plane_cylinder(ppos, pmat, psize, cpos, cmat, csize):
    n = _col(pmat, 2)
    r, hl = csize[..., 0, None], csize[..., 1, None]
    axis = _col(cmat, 2)
    c = maths.dot(n, axis)[..., None]
    perp = n - c * axis
    plen = maths.norm(perp)
    x0 = _col(cmat, 0)
    alt = x0 - n * maths.dot(n, x0)[..., None]
    alt = alt / torch.clamp(maths.norm(alt), min=1e-12)[..., None]
    dir0 = _w(plen > 1e-10, -perp / torch.clamp(plen, min=1e-12)[..., None],
              alt)
    s = torch.where(c > 0, -torch.ones_like(c), torch.ones_like(c))
    cap_a = cpos + s * hl * axis
    cap_b = cpos - s * hl * axis
    cr = maths.cross(axis, dir0)
    h3 = math.sqrt(3.0) / 2.0
    dir120 = dir0 * (-0.5) + cr * h3
    dir240 = dir0 * (-0.5) - cr * h3
    points = torch.stack([cap_a + r * dir0, cap_a + r * dir120,
                          cap_a + r * dir240, cap_b + r * dir0], -2)
    dist = (points * n[..., None, :]).sum(-1) - maths.dot(n, ppos)[..., None]
    pos = points - n[..., None, :] * (0.5 * dist)[..., None]
    f = make_frame(n)
    return dist, pos, f[..., None, :, :].expand(f.shape[:-2] + (4, 3, 3))


def _sphere_cylinder(spos, smat, ssize, cpos, cmat, csize):
    rs = ssize[..., 0]
    r, hl = csize[..., 0], csize[..., 1]
    axis = _col(cmat, 2)
    rel = spos - cpos
    z = maths.dot(rel, axis)
    radial = rel - z[..., None] * axis
    rd = maths.norm(radial)
    rhat = _w(rd > 1e-12, radial / torch.clamp(rd, min=1e-12)[..., None],
              _col(cmat, 0))
    inside = (torch.abs(z) < hl) & (rd < r)
    closest = (cpos + torch.minimum(torch.maximum(z, -hl), hl)[..., None]
               * axis + torch.minimum(rd, r)[..., None] * rhat)
    delta = spos - closest
    dn = maths.norm(delta)
    n_out = _w(dn > 1e-12, delta / torch.clamp(dn, min=1e-12)[..., None],
               axis)
    dist_out = dn - rs
    side_pen = r - rd
    cap_pen = hl - torch.abs(z)
    use_cap = cap_pen < side_pen
    n_in = _w(use_cap, torch.sign(z)[..., None] * axis, rhat)
    dist_in = -(torch.where(use_cap, cap_pen, side_pen) + rs)
    dist = torch.where(inside, dist_in, dist_out)
    n_vec = _w(inside, -n_in, -n_out)
    pos = spos + n_vec * (rs + 0.5 * dist)[..., None]
    return _one(dist, pos, n_vec)


def _capsule_box(cpos, cmat, csize, bpos, bmat, bsize):
    r, hl = csize[..., 0], csize[..., 1]
    axis = _col(cmat, 2)
    a = cpos - axis * hl[..., None]
    b = cpos + axis * hl[..., None]
    t = torch.full_like(r, 0.5)
    for _ in range(8):
        p = a + t[..., None] * (b - a)
        q_local = torch.minimum(torch.maximum(
            maths.matTvec(bmat, p - bpos), -bsize), bsize)
        q = bpos + maths.matvec(bmat, q_local)
        seg = b - a
        denom = torch.clamp(maths.dot(seg, seg), min=1e-12)
        t = torch.clamp(maths.dot(q - a, seg) / denom, 0.0, 1.0)
    mid = a + t[..., None] * (b - a)
    outs = [_sphere_box_raw(point, r, bpos, bmat, bsize)
            for point in (a, b, mid)]
    dist = torch.stack([o[0] for o in outs], -1)
    pos = torch.stack([o[1] for o in outs], -2)
    frame = torch.stack([make_frame(o[2]) for o in outs], -3)
    redundant = dist[..., 2] >= torch.minimum(dist[..., 0],
                                              dist[..., 1]) - 1e-10
    d2 = torch.where(redundant, torch.full_like(dist[..., 2], 1e10),
                     dist[..., 2])
    dist = torch.cat([dist[..., :2], d2[..., None]], -1)
    return dist, pos, frame


def _take(x, idx):
    """x[..., idx, :] for a per-batch index ``idx (...)``."""
    return torch.gather(x, -2, idx[..., None, None].expand(
        idx.shape + (1, x.shape[-1])))[..., 0, :]


def _take1(x, idx):
    """x[..., idx] for a per-batch index ``idx (...)``."""
    return torch.gather(x, -1, idx[..., None])[..., 0]


def _box_box(p1, m1, s1, p2, m2, s2):
    """Box-box: SAT over the 6 face axes, the incident face clipped
    against the reference face, at most 8 lanes (see the reference's
    docstring); the top_k compaction keeps the lower index on ties, as
    JAX's does, through a stable sort."""
    d12 = p2 - p1
    axes = torch.cat([m1.transpose(-1, -2), m2.transpose(-1, -2)], -2)
    r1 = (torch.abs(axes @ m1) * s1[..., None, :]).sum(-1)
    r2 = (torch.abs(axes @ m2) * s2[..., None, :]).sum(-1)
    sep = torch.abs(maths.matvec(axes, d12))
    overlap = r1 + r2 - sep
    k = torch.argmin(overlap, dim=-1)
    ref_is_1 = k < 3
    nref = _take(axes, k)
    nd = maths.dot(nref, d12)
    sgn = torch.sign(torch.where(ref_is_1, nd, -nd))
    sgn = torch.where(sgn == 0, torch.ones_like(sgn), sgn)
    nref = nref * sgn[..., None]
    pr = _w(ref_is_1, p1, p2)
    mr = _w(ref_is_1, m1, m2)
    sr = _w(ref_is_1, s1, s2)
    pi_ = _w(ref_is_1, p2, p1)
    mi = _w(ref_is_1, m2, m1)
    si = _w(ref_is_1, s2, s1)
    kr = torch.where(ref_is_1, k, k - 3)
    iu = torch.where(kr == 0, torch.ones_like(kr), torch.zeros_like(kr))
    iv = torch.where(kr == 2, torch.ones_like(kr), 2 * torch.ones_like(kr))
    mrT = mr.transpose(-1, -2)
    u = _take(mrT, iu)
    v = _take(mrT, iv)
    su = _take1(sr, iu)
    sv = _take1(sr, iv)
    face_c = pr + nref * _take1(sr, kr)[..., None]
    miT = mi.transpose(-1, -2)
    dots = maths.matvec(miT, nref)
    ji = torch.argmax(torch.abs(dots), dim=-1)
    jsgn = -torch.sign(_take1(dots, ji))
    jsgn = torch.where(jsgn == 0, torch.ones_like(jsgn), jsgn)
    inc_n = _take(miT, ji) * jsgn[..., None]
    inc_c = pi_ + inc_n * _take1(si, ji)[..., None]
    ju = torch.where(ji == 0, torch.ones_like(ji), torch.zeros_like(ji))
    jv = torch.where(ji == 2, torch.ones_like(ji), 2 * torch.ones_like(ji))
    e1 = _take(miT, ju) * _take1(si, ju)[..., None]
    e2 = _take(miT, jv) * _take1(si, jv)[..., None]
    corners = torch.stack([inc_c + e1 + e2, inc_c + e1 - e2,
                           inc_c - e1 - e2, inc_c - e1 + e2], -2)
    rel = corners - face_c[..., None, :]
    qu = (rel * u[..., None, :]).sum(-1)
    qv = (rel * v[..., None, :]).sum(-1)
    qh = (rel * nref[..., None, :]).sum(-1)
    quad = torch.stack([qu, qv], -1)                            # (..., 4, 2)
    du1 = quad[..., 1, :] - quad[..., 0, :]
    du2 = quad[..., 3, :] - quad[..., 0, :]
    dh1 = qh[..., 1] - qh[..., 0]
    dh2 = qh[..., 3] - qh[..., 0]
    det = du1[..., 0] * du2[..., 1] - du1[..., 1] * du2[..., 0]
    safe_det = torch.where(torch.abs(det) > 1e-12, det, torch.ones_like(det))
    gu = (dh1 * du2[..., 1] - dh2 * du1[..., 1]) / safe_det
    gv = (dh2 * du1[..., 0] - dh1 * du2[..., 0]) / safe_det
    h0 = qh[..., 0] - gu * quad[..., 0, 0] - gv * quad[..., 0, 1]

    c1_valid = ((torch.abs(qu) <= (su + 1e-10)[..., None])
                & (torch.abs(qv) <= (sv + 1e-10)[..., None]))
    rect = torch.stack([torch.stack([su, sv], -1),
                        torch.stack([su, -sv], -1),
                        torch.stack([-su, -sv], -1),
                        torch.stack([-su, sv], -1)], -2)        # (..., 4, 2)
    # rectangle corners inside the quad (convex: cross products agree)
    cs = []
    for i in range(4):
        a = quad[..., i, None, :]
        b = quad[..., (i + 1) % 4, None, :]
        cs.append((b[..., 0] - a[..., 0]) * (rect[..., 1] - a[..., 1])
                  - (b[..., 1] - a[..., 1]) * (rect[..., 0] - a[..., 0]))
    cs = torch.stack(cs, -1)                                    # (..., 4, 4)
    c2_valid = (cs >= -1e-10).all(-1) | (cs <= 1e-10).all(-1)
    c3_pts, c3_valid = [], []
    for i in range(4):
        a = quad[..., i, :]
        b = quad[..., (i + 1) % 4, :]
        ab = b - a
        for j in range(4):
            c = rect[..., j, :]
            dd = rect[..., (j + 1) % 4, :]
            cd = dd - c
            den = ab[..., 0] * cd[..., 1] - ab[..., 1] * cd[..., 0]
            okd = torch.abs(den) > 1e-12
            safe = torch.where(okd, den, torch.ones_like(den))
            t = ((c[..., 0] - a[..., 0]) * cd[..., 1]
                 - (c[..., 1] - a[..., 1]) * cd[..., 0]) / safe
            sly = ((c[..., 0] - a[..., 0]) * ab[..., 1]
                   - (c[..., 1] - a[..., 1]) * ab[..., 0]) / safe
            ok = okd & (t >= 0) & (t <= 1) & (sly >= 0) & (sly <= 1)
            c3_pts.append(a + t[..., None] * ab)
            c3_valid.append(ok)
    pts = torch.cat([quad, rect, torch.stack(c3_pts, -2)], -2)  # (..., 24, 2)
    valid = torch.cat([c1_valid, c2_valid, torch.stack(c3_valid, -1)], -1)
    diff = pts[..., :, None, :] - pts[..., None, :, :]
    close = (diff * diff).sum(-1) < 1e-16
    earlier = torch.tril(torch.ones((24, 24), dtype=torch.bool,
                                    device=pts.device), diagonal=-1)
    dup = (close & earlier & valid[..., None, :]).any(-1)
    valid = valid & ~dup
    hs = h0[..., None] + gu[..., None] * pts[..., 0] + gv[..., None] \
        * pts[..., 1]
    # top_k(score, 8) with score = valid - 1e-6 * index: the valid
    # candidates in index order, then the invalid ones in index order
    key = torch.where(valid, torch.zeros_like(hs), torch.ones_like(hs))
    idx = torch.sort(key, dim=-1, stable=True).indices[..., :8]
    pts8 = _take_rows(pts, idx)
    hs8 = torch.gather(hs, -1, idx)
    val8 = torch.gather(valid, -1, idx)
    world = (face_c[..., None, :] + pts8[..., :1] * u[..., None, :]
             + pts8[..., 1:] * v[..., None, :]
             + hs8[..., None] * nref[..., None, :])
    dist = torch.where(val8, hs8, torch.full_like(hs8, 1e10))
    pos = world - nref[..., None, :] * (0.5 * hs8)[..., None]
    n_contact = torch.where(ref_is_1, torch.ones_like(nd),
                            -torch.ones_like(nd))[..., None] * nref
    f = make_frame(n_contact)
    frame = f[..., None, :, :].expand(f.shape[:-2] + (8, 3, 3))
    none_valid = ~val8.any(-1)
    deep = torch.argmin(qh, dim=-1)
    dpu = torch.minimum(torch.maximum(_take1(qu, deep), -su), su)
    dpv = torch.minimum(torch.maximum(_take1(qv, deep), -sv), sv)
    deep_h = _take1(qh, deep)
    deep_world = (face_c + dpu[..., None] * u + dpv[..., None] * v
                  + deep_h[..., None] * nref)
    d0 = torch.where(none_valid, deep_h, dist[..., 0])
    p0 = _w(none_valid, deep_world - nref * 0.5 * deep_h[..., None],
            pos[..., 0, :])
    dist = torch.cat([d0[..., None], dist[..., 1:]], -1)
    pos = torch.cat([p0[..., None, :], pos[..., 1:, :]], -2)
    return dist, pos, frame


def _take_rows(x, idx):
    """x[..., idx, :] for per-batch index vectors ``idx (..., k)``."""
    return torch.gather(x, -2, idx[..., None].expand(
        idx.shape + (x.shape[-1],)))


_PRIMS = {
    (GeomType.PLANE, GeomType.SPHERE): _plane_sphere,
    (GeomType.PLANE, GeomType.CAPSULE): _plane_capsule,
    (GeomType.PLANE, GeomType.BOX): _plane_box,
    (GeomType.PLANE, GeomType.CYLINDER): _plane_cylinder,
    (GeomType.PLANE, GeomType.ELLIPSOID): _plane_ellipsoid,
    (GeomType.SPHERE, GeomType.SPHERE): _sphere_sphere,
    (GeomType.SPHERE, GeomType.CAPSULE): _sphere_capsule,
    (GeomType.SPHERE, GeomType.BOX): _sphere_box,
    (GeomType.SPHERE, GeomType.CYLINDER): _sphere_cylinder,
    (GeomType.CAPSULE, GeomType.CAPSULE): _capsule_capsule,
    (GeomType.CAPSULE, GeomType.BOX): _capsule_box,
    (GeomType.BOX, GeomType.BOX): _box_box,
}


# ---------------------------------------------------------------------------
# convex-convex narrowphase: Minkowski Portal Refinement over support
# functions, for every convex pairing without a primitive above.  Fixed
# iteration counts and masked updates, so a step with MPR pairs captures
# in a CUDA graph as it is.  Every function takes any leading axes: the
# env axis, the pairs of one type group and, for the height field, its
# prisms and the manifold probes.
# ---------------------------------------------------------------------------


def _support_local(gtype: GeomType, size, verts, dl):
    """Support point of the geom in its local frame for local directions
    ``dl (..., 3)`` (need not be unit); ``size (..., 3)``, and for a mesh
    ``verts (..., V, 3)`` (padded with copies of vertex 0, which change
    neither the maximum nor the point: argmax keeps the first index)."""
    eps = 1e-12
    if gtype in (GeomType.SPHERE, GeomType.CAPSULE):
        n = dl / torch.clamp(maths.norm(dl), min=eps)[..., None]
        out = size[..., 0, None] * n
        if gtype == GeomType.SPHERE:
            return out
        cap = torch.sign(dl[..., 2]) * size[..., 1]
        return torch.stack([out[..., 0], out[..., 1], out[..., 2] + cap], -1)
    if gtype == GeomType.BOX:
        return torch.sign(dl) * size
    if gtype == GeomType.ELLIPSOID:
        sd = size * dl
        return size * sd / torch.clamp(maths.norm(sd), min=eps)[..., None]
    if gtype == GeomType.CYLINDER:
        r_xy = torch.sqrt(dl[..., 0] * dl[..., 0] + dl[..., 1] * dl[..., 1])
        safe = torch.clamp(r_xy, min=eps)
        big = r_xy > eps
        zero = torch.zeros_like(r_xy)
        rx = torch.where(big, dl[..., 0] / safe * size[..., 0], zero)
        ry = torch.where(big, dl[..., 1] / safe * size[..., 0], zero)
        return torch.stack([rx, ry, torch.sign(dl[..., 2]) * size[..., 1]],
                           -1)
    if gtype == GeomType.MESH:
        return _argmax_vertex(verts, dl)
    raise NotImplementedError(gtype)


def _argmax_vertex(verts, dw):
    """``verts[argmax(verts @ dw)]`` per leading index: ``verts (..., V,
    3)`` (broadcast to ``dw``'s leading axes), ``dw (..., 3)``."""
    verts = verts.expand(dw.shape[:-1] + verts.shape[-2:])
    idx = torch.argmax((verts * dw[..., None, :]).sum(-1), dim=-1)
    return _take(verts, idx)


class _Support:
    """World support map of one geom per leading index: ``pos (..., 3)``,
    ``mat (..., 3, 3)``, ``size (..., 3)``, ``verts (..., V, 3)`` for a
    mesh.  Directions may carry extra axes after the geom's (the manifold
    probes)."""

    def __init__(self, gtype, pos, mat, size, verts=None):
        self.gtype, self.pos, self.mat = gtype, pos, mat
        self.size, self.verts = size.expand_as(pos), verts

    def __call__(self, dw):
        pos, mat, size, verts = self.pos, self.mat, self.size, self.verts
        for _ in range(dw.dim() - pos.dim()):
            pos, size, mat = pos[..., None, :], size[..., None, :], \
                mat[..., None, :, :]
            verts = None if verts is None else verts[..., None, :, :]
        dl = maths.matTvec(mat, dw)
        return pos + maths.matvec(mat, _support_local(self.gtype, size,
                                                      verts, dl))


def _sel(c, xs, ys):
    """``(where(c, x, y) for x, y in zip(xs, ys))`` over (..., 3)."""
    return tuple(_w(c, x, y) for x, y in zip(xs, ys))


def _unit(v, eps=1e-12):
    return v / torch.clamp(maths.norm(v), min=eps)[..., None]


def _mpr(sup1, sup2, c1, c2, n_discover=8, n_refine=14):
    """Minkowski Portal Refinement on the CSO A - B (the reference's
    ``_mpr``: portal discovery, refinement, normal polish, witness).

    ``sup_i(d)``: world support points of geom i for world directions
    ``d (..., 3)``; ``c_i (..., 3)``: interior points.  Returns (dist,
    pos, normal) with dist < 0 on penetration, pos the witness midpoint
    and the normal from geom1 into geom2."""

    def cso(d):
        a = sup1(d)
        b = sup2(-d)
        return a - b, a, b

    v0 = c1 - c2
    v0 = _w(maths.norm(v0) < 1e-10, _vec(v0, 1e-5, 0.0, 0.0), v0)
    v1, a1, b1 = cso(-v0)
    d2 = maths.cross(v1, v0)
    # origin colinear with v0-v1: any direction perpendicular to v0 works
    alt = maths.cross(v0, _w(torch.abs(v0[..., 0]) < 0.9 * maths.norm(v0),
                             _vec(v0, 1.0, 0.0, 0.0),
                             _vec(v0, 0.0, 1.0, 0.0)))
    d2 = _w(maths.norm(d2) < 1e-12, alt, d2)
    v2, a2, b2 = cso(d2)
    d3 = maths.cross(v1 - v0, v2 - v0)
    flip = maths.dot(d3, v0) > 0
    d3 = _w(flip, -d3, d3)
    (v1, a1, b1), (v2, a2, b2) = (_sel(flip, (v2, a2, b2), (v1, a1, b1)),
                                  _sel(flip, (v1, a1, b1), (v2, a2, b2)))
    v3, a3, b3 = cso(d3)

    # portal discovery (masked, fixed iteration count)
    found = torch.zeros_like(flip)
    for _ in range(n_discover):
        out13 = maths.dot(maths.cross(v1, v3), v0) < 0
        out32 = maths.dot(maths.cross(v3, v2), v0) < 0
        step13 = ~found & out13
        step32 = ~found & ~out13 & out32
        found = found | (~out13 & ~out32)
        v2, a2, b2 = _sel(step13, (v3, a3, b3), (v2, a2, b2))
        v1, a1, b1 = _sel(step32, (v3, a3, b3), (v1, a1, b1))
        d = maths.cross(v1 - v0, v2 - v0)
        d = _w(maths.dot(d, v0) > 0, -d, d)
        v3, a3, b3 = _sel(found, (v3, a3, b3), cso(d))

    # portal refinement
    for _ in range(n_refine):
        n = maths.cross(v2 - v1, v3 - v1)
        n = _unit(_w(maths.dot(n, v1 - v0) < 0, -n, n))
        v4, a4, b4 = cso(n)
        c41 = maths.dot(maths.cross(v4, v1), v0) < 0
        c42 = maths.dot(maths.cross(v4, v2), v0) < 0
        c43 = maths.dot(maths.cross(v4, v3), v0) < 0
        rep1 = (c41 & c42) | (~c41 & ~c43)
        r2 = ~c41 & c43
        r3 = c41 & ~c42
        v1, a1, b1 = _sel(rep1, (v4, a4, b4), (v1, a1, b1))
        v2, a2, b2 = _sel(r2, (v4, a4, b4), (v2, a2, b2))
        v3, a3, b3 = _sel(r3, (v4, a4, b4), (v3, a3, b3))

    n = maths.cross(v2 - v1, v3 - v1)
    n = _unit(_w(maths.dot(n, v1 - v0) < 0, -n, n))

    # normal polish: minimize s(n) = n . support(n) over the unit sphere by
    # projected support descent, keeping the best iterate (the first
    # iterate's support is the starting one's)
    v4 = cso(n)[0]
    s_best = maths.dot(n, v4)
    n_best = n
    eta = 0.5
    for k in range(17):
        if k:
            v4 = cso(n)[0]
        s = maths.dot(n, v4)
        better = s < s_best
        s_best = torch.where(better, s, s_best)
        n_best = _w(better, n, n_best)
        if k == 16:
            break
        tang = v4 - maths.dot(v4, n)[..., None] * n
        scale = torch.clamp(maths.norm(v4), min=1e-9)
        n = _unit(n - (torch.full_like(scale, eta) / scale)[..., None] * tang)
        eta = eta * 0.85
    n = n_best

    # witness: the v0 -> origin ray through the portal plane, clamped
    # barycentrics in (v1, v2, v3)
    denom = maths.dot(n, -v0)
    t = maths.dot(n, v1 - v0) / torch.where(torch.abs(denom) > 1e-12, denom,
                                            torch.ones_like(denom))
    t = torch.clamp(t, 0.0, 2.0)
    q = v0 + t[..., None] * (-v0)
    nn = maths.cross(v2 - v1, v3 - v1)
    area = maths.dot(nn, nn)
    lam = torch.stack([maths.dot(maths.cross(v2 - q, v3 - q), nn),
                       maths.dot(maths.cross(v3 - q, v1 - q), nn),
                       maths.dot(maths.cross(v1 - q, v2 - q), nn)], -1)
    lam = lam / torch.where(area > 1e-18, area,
                            torch.ones_like(area))[..., None]
    lam = torch.clamp(lam, 0.0, 1.0)
    lam = lam / torch.clamp(lam.sum(-1), min=1e-12)[..., None]
    l1, l2, l3 = lam[..., 0, None], lam[..., 1, None], lam[..., 2, None]
    pa = l1 * a1 + l2 * a2 + l3 * a3
    pb = l1 * b1 + l2 * b2 + l3 * b3
    return -s_best, 0.5 * (pa + pb), n


MANIFOLD_EPS = 0.05


def min_extent(scale_min, eps=MANIFOLD_EPS):
    """The manifold probes' extent gate ``2 eps scale_min`` (numpy)."""
    return 2.0 * eps * np.asarray(scale_min, np.float64)


def _manifold_lanes(sup1, sup2, pos, n, frame, min_ext, eps=MANIFOLD_EPS):
    """Perturbed-support manifold probes around an MPR witness (the
    reference's ``_manifold_lanes``): both support maps under normals
    tilted toward one tangent direction t in (t1, -t1, t2, -t2), the four
    probes an axis before the last.  A probe is active (dist = its depth)
    where the overlap extends past ``min_ext`` (a tensor of
    :func:`min_extent`, broadcast to ``pos[..., 0]``), else at 1e10.
    Returns (..., 4), (..., 4, 3), (..., 4, 3, 3)."""
    tan1, tan2 = frame[..., 1, :], frame[..., 2, :]
    t = torch.stack([tan1, -tan1, tan2, -tan2], -2)
    nk = n[..., None, :]
    da = nk + eps * t
    da = da / maths.norm(da)[..., None]
    db = eps * t - nk
    db = db / maths.norm(db)[..., None]
    a = sup1(da)
    b = sup2(db)
    depth = maths.dot(nk, b - a)
    pk = pos[..., None, :]
    ext = torch.clamp(torch.minimum(maths.dot(t, a - pk),
                                    maths.dot(t, b - pk)), min=0.0)
    dist = torch.where(ext > min_ext[..., None], depth,
                       torch.full_like(depth, 1e10))
    return dist, pk + ext[..., None] * t, frame[..., None, :, :].expand(
        frame.shape[:-2] + (4, 3, 3))


def _with_manifold(sup1, sup2, dist, pos, n, min_ext):
    """The MPR lane then its four manifold lanes: (..., 5), (..., 5, 3),
    (..., 5, 3, 3)."""
    frame = make_frame(n)
    md, mp, mf = _manifold_lanes(sup1, sup2, pos, n, frame, min_ext)
    return (torch.cat([dist[..., None], md], -1),
            torch.cat([pos[..., None, :], mp], -2),
            torch.cat([frame[..., None, :, :], mf], -3))


def _mesh_verts(model: Model, K, geoms):
    """(verts (P, V, 3), valid (P, V)): the meshes of ``geoms``, padded to
    the largest vertex count with copies of vertex 0 (marked invalid)."""
    def padded():
        out = []
        for g in geoms:
            mid = model.geom_dataid[g]
            adr, num = model.mesh_vertadr[mid], model.mesh_vertnum[mid]
            out.append(np.asarray(model.mesh_vert, np.float64)[adr:adr + num])
        vmax = max(len(v) for v in out)
        return [np.concatenate([v, np.repeat(v[:1], vmax - len(v), 0)])
                for v in out], [[i < len(v) for i in range(vmax)]
                                for v in out]
    key = f"mesh_verts_{tuple(geoms)}"
    return (K.t(key, lambda: padded()[0]),
            K.b(key, lambda: padded()[1]))


def _group_geoms(model: Model, d, K, geoms):
    """The world poses and sizes of ``geoms``: (B, P, 3), (B, P, 3, 3),
    (B, P, 3)."""
    idx = K.i(f"geoms_{tuple(geoms)}", lambda: list(geoms))
    pos = d.geom_xpos[:, idx]
    return pos, d.geom_xmat[:, idx], K.f("geom_size")[idx].expand_as(pos)


def _geom_support(model: Model, d, K, geoms):
    """The :class:`_Support` of ``geoms`` (one geom type) and its pos."""
    gt = GeomType(model.geom_type[geoms[0]])
    pos, mat, size = _group_geoms(model, d, K, geoms)
    verts = _mesh_verts(model, K, geoms)[0] if gt == GeomType.MESH else None
    return _Support(gt, pos, mat, size, verts), pos


def _mpr_pair(model: Model, d, pairs):
    """The MPR lane and its four manifold lanes of every pair of one
    convex type group (the reference's ``_mpr_pair``, batched over the
    pairs): (B, P, 5), (B, P, 5, 3), (B, P, 5, 3, 3)."""
    K = consts(model, d.qpos)
    g1, g2 = [p[0] for p in pairs], [p[1] for p in pairs]
    sup1, c1 = _geom_support(model, d, K, g1)
    sup2, c2 = _geom_support(model, d, K, g2)
    dist, pos, n = _mpr(sup1, sup2, c1, c2)
    sizes = np.asarray(model.geom_size, np.float64)
    min_ext = K.t(f"mpr_extent_{tuple(pairs)}", lambda: min_extent(
        [max(min(np.max(sizes[a]), np.max(sizes[b])), 1e-6)
         for a, b in pairs]))
    return _with_manifold(sup1, sup2, dist, pos, n, min_ext)


# ---------------------------------------------------------------------------
# height field: the grid of each pair's field as per-pair tensors over the
# flat elevation data, so that the pairs of a group (which may use fields of
# different sizes) run as one batch
# ---------------------------------------------------------------------------


class HField(NamedTuple):
    """Per-pair height-field constants, (P,) each (``lift`` adds trailing
    axes), and the model's flat normalized elevation data."""

    sx: torch.Tensor
    sy: torch.Tensor
    sz: torch.Tensor
    zbot: torch.Tensor
    ncol1: torch.Tensor   # ncol - 1, float
    nrow1: torch.Tensor
    fx_hi: torch.Tensor   # ncol - 1 - 1e-6
    fy_hi: torch.Tensor
    ncol: torch.Tensor    # int64
    nrow: torch.Tensor
    adr: torch.Tensor
    i0_hi: torch.Tensor   # max(ncol - 4, 0)
    j0_hi: torch.Tensor
    data: torch.Tensor    # (sum nrow * ncol,)

    def lift(self, n: int) -> "HField":
        return HField(*[x.reshape(x.shape + (1,) * n) for x in self[:-1]],
                      self.data)

    def z(self, i, j):
        """Elevation of grid point (i, j) (column, row) times sz."""
        return self.data[self.adr + j * self.ncol + i] * self.sz


def hfield_consts(model: Model, K, hgeoms) -> HField:
    """The :class:`HField` of the height-field geoms ``hgeoms``."""
    hids = [model.geom_dataid[g] for g in hgeoms]
    key = f"hfield_{tuple(hids)}"
    size = np.asarray(model.hfield_size, np.float64).reshape(-1, 4)[hids]
    nrow = np.array([model.hfield_nrow[h] for h in hids], np.int64)
    ncol = np.array([model.hfield_ncol[h] for h in hids], np.int64)
    hs = K.t(key, lambda: size)
    f = K.t(f"{key}_grid", lambda: np.stack(
        [ncol - 1, nrow - 1, ncol - 1 - 1e-6, nrow - 1 - 1e-6], 1))
    i = K.i(f"{key}_index", lambda: np.stack(
        [ncol, nrow, [model.hfield_adr[h] for h in hids],
         np.maximum(ncol - 4, 0), np.maximum(nrow - 4, 0)], 1))
    return HField(hs[:, 0], hs[:, 1], hs[:, 2], -hs[:, 3], f[:, 0], f[:, 1],
                  f[:, 2], f[:, 3], i[:, 0], i[:, 1], i[:, 2], i[:, 3],
                  i[:, 4], K.f("hfield_data"))


def _hfield_surface(hf: HField, pl):
    """Signed distance of local points ``pl (..., 3)`` to the height-field
    surface and its upward unit normal: the triangle under the point, the
    lower (00, 10, 11) for u >= v, else the upper (00, 11, 01)."""
    sx, sy = hf.sx, hf.sy
    fx = (pl[..., 0] + sx) / (2 * sx) * hf.ncol1
    fy = (pl[..., 1] + sy) / (2 * sy) * hf.nrow1
    fx = torch.minimum(torch.clamp(fx, min=0.0), hf.fx_hi)
    fy = torch.minimum(torch.clamp(fy, min=0.0), hf.fy_hi)
    i = torch.floor(fx).to(torch.int64)
    j = torch.floor(fy).to(torch.int64)
    u = fx - i.to(fx.dtype)
    v = fy - j.to(fy.dtype)
    dx = 2 * sx / hf.ncol1
    dy = 2 * sy / hf.nrow1
    x0 = -sx + i.to(fx.dtype) * dx
    y0 = -sy + j.to(fy.dtype) * dy
    z00, z10 = hf.z(i, j), hf.z(i + 1, j)
    z01, z11 = hf.z(i, j + 1), hf.z(i + 1, j + 1)
    lower = u >= v
    a = torch.stack([x0, y0, z00], -1)
    b = _w(lower, torch.stack([x0 + dx, y0, z10], -1),
           torch.stack([x0 + dx, y0 + dy, z11], -1))
    cc = _w(lower, torch.stack([x0 + dx, y0 + dy, z11], -1),
            torch.stack([x0, y0 + dy, z01], -1))
    n = maths.cross(b - a, cc - a)
    n = _unit(n * torch.sign(n[..., 2, None]))
    return maths.dot(n, pl - a), n


def _hfield_point_at(hpos, hmat, hf, point):
    """(signed distance, world-up normal) of world points vs the field."""
    sd, nl = _hfield_surface(hf, maths.matTvec(hmat, point - hpos))
    return sd, maths.matvec(hmat, nl)


def _hfield_sphere_at(hpos, hmat, hf, center, r):
    dist, n = _hfield_point_at(hpos, hmat, hf, center)
    dist = dist - r
    return dist, center - n * (r + 0.5 * dist)[..., None], n


def _hfield_sphere(hpos, hmat, hf, cpos, cmat, csize):
    return _one(*_hfield_sphere_at(hpos, hmat, hf, cpos, csize[..., 0]))


def _hfield_capsule(hpos, hmat, hf, cpos, cmat, csize):
    """Sphere queries at the two end caps and the segment midpoint."""
    r, h = csize[..., 0, None], csize[..., 1]
    th = torch.stack([h, -h, h * 0.0], -1)
    ends = cpos[..., None, :] + th[..., None] * _col(cmat, 2)[..., None, :]
    dist, pos, n = _hfield_sphere_at(hpos[..., None, :],
                                     hmat[..., None, :, :], hf.lift(1), ends,
                                     r)
    return dist, pos, make_frame(n)


def _hfield_prism_mpr(hpos, hmat, hf, gsup, gpos, min_ext):
    """Convex geoms vs height fields through MuJoCo's prism decomposition:
    the 3x3 cell window around each geom's center splits into 18 triangle
    prisms, each run through MPR against the geom plus its four manifold
    probes.  The prisms are an axis (..., 18) and the window origin is a
    device index, so nothing reads back to the host.  ``gsup`` is the
    geoms' :class:`_Support` and ``gpos (..., 3)`` their centers;
    ``min_ext (P,)`` the manifold gate of each pair's prism scale.
    Returns (..., 90), (..., 90, 3), (..., 90, 3, 3): prism-major, the MPR
    lane then its four probes."""
    sx, sy = hf.sx, hf.sy
    dx = 2 * sx / hf.ncol1
    dy = 2 * sy / hf.nrow1
    pl = maths.matTvec(hmat, gpos - hpos)
    fx = (pl[..., 0] + sx) / (2 * sx) * hf.ncol1
    fy = (pl[..., 1] + sy) / (2 * sy) * hf.nrow1
    i0 = torch.minimum(torch.clamp(torch.floor(fx).to(torch.int64) - 1,
                                   min=0), hf.i0_hi)
    j0 = torch.minimum(torch.clamp(torch.floor(fy).to(torch.int64) - 1,
                                   min=0), hf.j0_hi)
    w = hf.lift(1)
    cell = torch.arange(9, device=i0.device)
    i = torch.minimum(i0[..., None] + cell % 3, w.ncol - 2)      # (..., 9)
    j = torch.minimum(j0[..., None] + cell // 3, w.nrow - 2)
    x0 = -w.sx + i.to(fx.dtype) * dx[..., None]
    y0 = -w.sy + j.to(fx.dtype) * dy[..., None]
    x1 = x0 + dx[..., None]
    y1 = y0 + dy[..., None]
    z00, z10 = w.z(i, j), w.z(i + 1, j)
    z01, z11 = w.z(i, j + 1), w.z(i + 1, j + 1)
    p00 = torch.stack([x0, y0, z00], -1)
    p10 = torch.stack([x1, y0, z10], -1)
    p11 = torch.stack([x1, y1, z11], -1)
    p01 = torch.stack([x0, y1, z01], -1)
    top = torch.stack([torch.stack([p00, p10, p11], -2),
                       torch.stack([p00, p11, p01], -2)], -3)
    top = top.reshape(top.shape[:-4] + (18, 3, 3))
    zb = hf.lift(2).zbot.expand(top.shape[:-1])
    bot = torch.stack([top[..., 0], top[..., 1], zb], -1)
    verts_l = torch.cat([top, bot], -2)                    # (..., 18, 6, 3)
    verts_w = (maths.matvec(hmat[..., None, None, :, :], verts_l)
               + hpos[..., None, None, :])

    def prism_sup(dw):
        vw = verts_w
        for _ in range(dw.dim() - vw.dim() + 1):
            vw = vw[..., None, :, :]
        return _argmax_vertex(vw, dw)

    # the geom's support broadcasts over the prism axis
    dist, pos, n = _mpr(prism_sup, gsup, verts_w.mean(-2),
                        gpos[..., None, :])
    dist, pos, frame = _with_manifold(prism_sup, gsup, dist, pos, n,
                                      min_ext[..., None])
    lead = dist.shape[:-2]
    return (dist.reshape(lead + (90,)), pos.reshape(lead + (90, 3)),
            frame.reshape(lead + (90, 3, 3)))


def _plane_mesh(ppos, pmat, mpos, mmat, verts, valid):
    """Plane vs convex mesh: lanes on the 4 deepest hull vertices (the
    reference's ``jax.lax.top_k`` keeps the lower index on ties, as the
    stable sort does; a face-down hull has such ties).  ``verts (..., V,
    3)`` padded, ``valid (..., V)`` marking the mesh's own vertices."""
    n = _col(pmat, 2)
    vw = mpos[..., None, :] + maths.matvec(mmat[..., None, :, :], verts)
    dist = ((vw - ppos[..., None, :]) * n[..., None, :]).sum(-1)
    dist = torch.where(valid, dist, torch.full_like(dist, math.inf))
    idx = torch.sort(dist, dim=-1, stable=True).indices[..., :4]
    dsel = torch.gather(dist, -1, idx)
    pos = _take_rows(vw, idx) - (0.5 * dsel)[..., None] * n[..., None, :]
    f = make_frame(n)
    return dsel, pos, f[..., None, :, :].expand(f.shape[:-2] + (4, 3, 3))


_HF = {GeomType.SPHERE: _hfield_sphere, GeomType.CAPSULE: _hfield_capsule}
_HF_PRISM = (GeomType.BOX, GeomType.ELLIPSOID, GeomType.CYLINDER)


def _hfield_pairs(model: Model, d, pairs):
    """Every (height field, geom) pair of one type group: the analytic
    sphere and capsule pairs, or the prism MPR for box, ellipsoid and
    cylinder."""
    K = consts(model, d.qpos)
    h = [p[0] for p in pairs]
    g = [p[1] for p in pairs]
    hf = hfield_consts(model, K, h)
    hpos, hmat, _ = _group_geoms(model, d, K, h)
    gt = GeomType(model.geom_type[g[0]])
    if gt in _HF:
        gpos, gmat, gsize = _group_geoms(model, d, K, g)
        return _HF[gt](hpos, hmat, hf, gpos, gmat, gsize)
    sup, gpos = _geom_support(model, d, K, g)
    return _hfield_prism_mpr(hpos, hmat, hf, sup, gpos, K.t(
        f"prism_extent_{tuple(pairs)}", lambda: min_extent(
            [_prism_scale(model, gh, gg) for gh, gg in pairs])))


def _prism_scale(model: Model, gh: int, gg: int) -> float:
    """The manifold gate's scale of a prism pair: the smaller of the grid
    cell and the geom's largest half-size (the reference's rule)."""
    hid = model.geom_dataid[gh]
    hs = np.asarray(model.hfield_size, np.float64).reshape(-1, 4)[hid]
    ncol, nrow = model.hfield_ncol[hid], model.hfield_nrow[hid]
    cell = max(2.0 * hs[0] / (ncol - 1), 2.0 * hs[1] / (nrow - 1))
    size = float(np.max(np.asarray(model.geom_size)[gg]))
    return float(max(min(cell, size), 1e-6))


def _group_lanes(model: Model, d, t1, t2, pairs):
    """The contact lanes of one pair group: (B, P, k), (B, P, k, 3),
    (B, P, k, 3, 3) (the reference's dispatcher)."""
    key = (GeomType(t1), GeomType(t2))
    K = consts(model, d.qpos)
    if key in _PRIMS:
        p1, m1, s1 = _group_geoms(model, d, K, [p[0] for p in pairs])
        p2, m2, s2 = _group_geoms(model, d, K, [p[1] for p in pairs])
        return _PRIMS[key](p1, m1, s1, p2, m2, s2)
    if key == (GeomType.PLANE, GeomType.MESH):
        p1, m1, _ = _group_geoms(model, d, K, [p[0] for p in pairs])
        g2 = [p[1] for p in pairs]
        p2, m2, _ = _group_geoms(model, d, K, g2)
        verts, valid = _mesh_verts(model, K, g2)
        return _plane_mesh(p1, m1, p2, m2, verts, valid)
    if key[0] == GeomType.HFIELD and (key[1] in _HF or key[1] in _HF_PRISM):
        return _hfield_pairs(model, d, pairs)
    if key[0] in _CONVEX_TYPES and key[1] in _CONVEX_TYPES:
        return _mpr_pair(model, d, pairs)
    raise NotImplementedError(f"collision {key[0].name}-{key[1].name}")


def collision(model: Model, d):
    """Narrowphase over every candidate pair: fixed contact lanes in the
    model's flattened pair order."""
    if model.npair == 0 or model.opt.disable_contact:
        return d
    K = consts(model, d.qpos)
    bsz = d.qpos.shape[0]
    dists, poss, frames = [], [], []
    for (t1, t2, pairs) in model.pair_groups:
        dist, pos, frame = _group_lanes(model, d, t1, t2, pairs)
        dists.append(dist.reshape(bsz, -1))
        poss.append(pos.reshape(bsz, -1, 3))
        frames.append(frame.reshape(bsz, -1, 3, 3))
    lane = K.i("lane_of_pair", lambda: _lane_of_pair(model))
    margin = K.t("lane_margin", lambda: (
        np.asarray(model.pair_margin, np.float64)
        - np.asarray(model.pair_gap, np.float64))[_lane_of_pair(model)])

    def per_lane(x):
        return x[lane].expand((bsz,) + x[lane].shape)

    contact = d.contact.replace(
        dist=torch.cat(dists, 1), pos=torch.cat(poss, 1),
        frame=torch.cat(frames, 1), includemargin=per_lane(margin),
        friction=per_lane(K.f("pair_friction")),
        solref=per_lane(K.f("pair_solref")),
        solimp=per_lane(K.f("pair_solimp")),
        geom1=per_lane(K.i("pair_geom1", lambda: model.pair_geom1)),
        geom2=per_lane(K.i("pair_geom2", lambda: model.pair_geom2)))
    return d.replace(contact=contact)


def _lane_of_pair(model: Model) -> np.ndarray:
    reps = [max_contacts_per_pair(t1, t2)
            for (t1, t2, pairs) in model.pair_groups for _ in pairs]
    return np.repeat(np.arange(model.npair), reps)


def contact_condims(model: Model) -> list[int]:
    """Static per-lane condim list, flattened in pair order."""
    out = []
    idx = 0
    for (t1, t2, pairs) in model.pair_groups:
        k = max_contacts_per_pair(t1, t2)
        for _ in pairs:
            out.extend([model.pair_condim[idx]] * k)
            idx += 1
    return out


def geom_distance(model: Model, d, g1: int, g2: int):
    """(dist (B,), p1 (B, 3), p2 (B, 3)): smallest signed distance between
    two geoms and the witness points on each surface (mj_geomDistance
    analog, serving the geomdist/geomnormal/geomfromto sensors): the
    primitive narrowphase where the type pair has one, MPR for the other
    convex pairs; a multi-lane narrowphase reports its nearest lane."""
    t1 = GeomType(model.geom_type[g1])
    t2 = GeomType(model.geom_type[g2])
    flip = False
    if (t1, t2) not in _PRIMS and (t2, t1) in _PRIMS:
        g1, g2, t1, t2, flip = g2, g1, t2, t1, True
    if (t1, t2) in _PRIMS:
        K = consts(model, d.qpos)
        p1, m1, s1 = _group_geoms(model, d, K, [g1])
        p2, m2, s2 = _group_geoms(model, d, K, [g2])
        dist, pos, frame = _PRIMS[(t1, t2)](p1, m1, s1, p2, m2, s2)
    elif t1 in _CONVEX_TYPES and t2 in _CONVEX_TYPES:
        dist, pos, frame = _mpr_pair(model, d, [(g1, g2)])
    else:
        raise NotImplementedError(
            f"geom distance for pair {t1.name}-{t2.name}")
    dist, pos, n = dist[:, 0], pos[:, 0], frame[:, 0, :, 0, :]
    k = torch.argmin(dist, dim=-1)
    dmin = _take1(dist, k)
    p = _take(pos, k)
    n = _take(n, k)
    p1 = p - 0.5 * dmin[:, None] * n
    p2 = p + 0.5 * dmin[:, None] * n
    if flip:
        p1, p2 = p2, p1
    return dmin, p1, p2
