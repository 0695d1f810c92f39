"""Narrowphase collision: contact lanes of the candidate pairs, batched.

The port of ``oxide_control_tpu/physics/collision.py``: its lane counts
(``max_contacts_per_pair``, also read by the scalar graph), the contact
frame, every closed-form primitive pair (``_PRIMS``, plane-sphere through
box-box), the ``collision()`` dispatcher, ``contact_condims`` and
``geom_distance`` on primitive pairs.  Candidate pairs are fixed at
compile time; every pair owns a fixed number of lanes and a lane with
``dist >= includemargin`` is inactive.  Each primitive takes world poses
with any leading axes (the env axis, then the pairs of one type group),
where the reference ``vmap``s one pair.

The MPR, height-field and mesh narrowphases are ROADMAP item 11b: a model
with such a pair raises ``NotImplementedError`` naming the row, never
dropping the contact.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..model import GeomType, Model
from . import maths
from .consts import consts

_CONVEX_TYPES = (
    GeomType.SPHERE, GeomType.CAPSULE, GeomType.ELLIPSOID,
    GeomType.CYLINDER, GeomType.BOX, GeomType.MESH,
)

LATER_ROW = ("ROADMAP Queue A item 11b (the MPR, height-field and mesh "
             "narrowphases of the general path)")


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


def unsupported_pairs(model: Model) -> list:
    """The pair groups the general path cannot collide yet (item 11b)."""
    return [(GeomType(t1).name, GeomType(t2).name)
            for (t1, t2, _) in model.pair_groups
            if (GeomType(t1), GeomType(t2)) not in _PRIMS]


def check_supported(model: Model) -> None:
    """Raise ``NotImplementedError`` naming ROADMAP item 11b for a model
    with an MPR, height-field or mesh pair."""
    if model.opt.disable_contact:
        return
    bad = unsupported_pairs(model)
    if bad:
        names = ", ".join(f"{a}-{b}" for a, b in bad)
        raise NotImplementedError(
            f"collision pairs {names} need a narrowphase the port's "
            f"general path does not have yet: {LATER_ROW}")


def collision(model: Model, d):
    """Narrowphase over every candidate pair: fixed contact lanes in the
    model's flattened pair order."""
    if model.npair == 0 or model.opt.disable_contact:
        return d
    check_supported(model)
    K = consts(model, d.qpos)
    bsz = d.qpos.shape[0]
    gsize = K.f("geom_size")
    dists, poss, frames = [], [], []
    for gi, (t1, t2, pairs) in enumerate(model.pair_groups):
        fn = _PRIMS[(GeomType(t1), GeomType(t2))]
        g1 = K.i(f"pair_g1_{gi}", lambda p=pairs: [q[0] for q in p])
        g2 = K.i(f"pair_g2_{gi}", lambda p=pairs: [q[1] for q in p])
        dist, pos, frame = fn(
            d.geom_xpos[:, g1], d.geom_xmat[:, g1],
            gsize[g1].expand(bsz, -1, -1),
            d.geom_xpos[:, g2], d.geom_xmat[:, g2],
            gsize[g2].expand(bsz, -1, -1))
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
    two geoms and the witness points (mj_geomDistance analog) for pairs
    with a primitive; other pairs raise (ROADMAP item 11b)."""
    t1 = GeomType(model.geom_type[g1])
    t2 = GeomType(model.geom_type[g2])
    flip = False
    if (t1, t2) not in _PRIMS and (t2, t1) in _PRIMS:
        g1, g2, t1, t2, flip = g2, g1, t2, t1, True
    if (t1, t2) not in _PRIMS:
        raise NotImplementedError(
            f"geom distance for pair {t1.name}-{t2.name}: {LATER_ROW}")
    K = consts(model, d.qpos)
    gsize = K.f("geom_size")
    bsz = d.qpos.shape[0]
    dist, pos, frame = _PRIMS[(t1, t2)](
        d.geom_xpos[:, g1], d.geom_xmat[:, g1], gsize[g1].expand(bsz, 3),
        d.geom_xpos[:, g2], d.geom_xmat[:, g2], gsize[g2].expand(bsz, 3))
    k = torch.argmin(dist, dim=-1)
    dmin = _take1(dist, k)
    p = _take(pos, k)
    n = _take(frame[..., 0, :], k)
    p1 = p - 0.5 * dmin[:, None] * n
    p2 = p + 0.5 * dmin[:, None] * n
    if flip:
        p1, p2 = p2, p1
    return dmin, p1, p2
