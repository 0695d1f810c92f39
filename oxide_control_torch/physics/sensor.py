"""Sensors: mj_sensorPos / mj_sensorVel / mj_sensorAcc analogs, batched.

The port of ``oxide_control_tpu/physics/sensor.py``: every sensor family
of the reference, each stage writing its sensors' slices of
``Data.sensordata (B, nsensordata)``.  The dispatch is a build-time loop
over the static sensor table, so a model without sensors runs none of it.
The geom-distance family runs on every convex pair, MPR pairs included
(``collision.geom_distance``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..model import GeomType, JointType, Model, ObjType, SensorType, TrnType
from . import maths
from .constraint import _lane_bodies, limit_row_map
from .consts import consts

_POS = (
    SensorType.JOINTPOS, SensorType.TENDONPOS, SensorType.ACTUATORPOS,
    SensorType.BALLQUAT, SensorType.FRAMEPOS, SensorType.FRAMEQUAT,
    SensorType.FRAMEXAXIS, SensorType.FRAMEYAXIS, SensorType.FRAMEZAXIS,
    SensorType.SUBTREECOM, SensorType.MAGNETOMETER, SensorType.CLOCK,
    SensorType.RANGEFINDER, SensorType.E_POTENTIAL,
    SensorType.GEOMDIST, SensorType.GEOMNORMAL, SensorType.GEOMFROMTO,
    SensorType.INSIDESITE, SensorType.CAMPROJECTION,
)
_VEL = (
    SensorType.VELOCIMETER, SensorType.GYRO, SensorType.JOINTVEL,
    SensorType.TENDONVEL, SensorType.ACTUATORVEL, SensorType.BALLANGVEL,
    SensorType.FRAMELINVEL, SensorType.FRAMEANGVEL,
    SensorType.SUBTREELINVEL, SensorType.SUBTREEANGMOM,
    SensorType.E_KINETIC,
)
_LIMIT_SENSORS = (
    SensorType.JOINTLIMITPOS, SensorType.JOINTLIMITVEL,
    SensorType.JOINTLIMITFRC, SensorType.TENDONLIMITPOS,
    SensorType.TENDONLIMITVEL, SensorType.TENDONLIMITFRC,
)
_ACC = (
    SensorType.TOUCH, SensorType.ACCELEROMETER, SensorType.FORCE,
    SensorType.TORQUE, SensorType.ACTUATORFRC, SensorType.JOINTACTFRC,
    SensorType.TENDONACTFRC, SensorType.FRAMELINACC, SensorType.FRAMEANGACC,
) + _LIMIT_SENSORS
_KINEMATIC_ACC = (SensorType.ACCELEROMETER, SensorType.FRAMELINACC,
                  SensorType.FRAMEANGACC)
_POSITIVE = (SensorType.TOUCH,)
_NO_CUTOFF = (
    SensorType.BALLQUAT, SensorType.FRAMEQUAT,
    SensorType.FRAMEXAXIS, SensorType.FRAMEYAXIS, SensorType.FRAMEZAXIS,
    SensorType.GEOMDIST, SensorType.GEOMNORMAL, SensorType.GEOMFROMTO,
    SensorType.INSIDESITE,
)
_RAY_BIG = 1e10


def _has_stage(model: Model, types) -> bool:
    return any(t in types for t in model.sensor_type)


def _cutoff(model: Model, i: int, val):
    st = SensorType(model.sensor_type[i])
    if st in _NO_CUTOFF:
        return val
    c = float(np.asarray(model.sensor_cutoff)[i])
    if c <= 0:
        return val
    if st in _POSITIVE:
        return torch.clamp(val, max=c)
    return torch.clamp(val, -c, c)


def _write(model: Model, sd, vals: dict):
    """sensordata with the slices of ``vals {sensor i: (B, dim)}``
    replaced."""
    if not vals:
        return sd
    cols = list(sd.unbind(1))
    for i, v in vals.items():
        adr = model.sensor_adr[i]
        v = _cutoff(model, i, v.to(sd.dtype))
        for k in range(v.shape[1]):
            cols[adr + k] = v[:, k]
    return torch.stack(cols, 1)


def _obj_pose(model: Model, d, objtype: int, objid: int):
    """(pos (B, 3), mat (B, 3, 3), bodyid) of a frame-sensor object."""
    ot = ObjType(objtype)
    if ot == ObjType.SITE:
        return (d.site_xpos[:, objid], d.site_xmat[:, objid],
                model.site_bodyid[objid])
    if ot == ObjType.GEOM:
        return (d.geom_xpos[:, objid], d.geom_xmat[:, objid],
                model.geom_bodyid[objid])
    if ot == ObjType.BODY:
        return d.xipos[:, objid], d.ximat[:, objid], objid
    return d.xpos[:, objid], d.xmat[:, objid], objid


def _obj_quat(model: Model, d, K, objtype: int, objid: int):
    ot = ObjType(objtype)
    if ot == ObjType.SITE:
        b = model.site_bodyid[objid]
        q = K.f("site_quat")[objid]
    elif ot == ObjType.GEOM:
        b = model.geom_bodyid[objid]
        q = K.f("geom_quat")[objid]
    elif ot == ObjType.BODY:
        b = objid
        q = K.f("body_iquat")[objid]
    else:
        return d.xquat[:, objid]
    return maths.quat_mul(d.xquat[:, b], q.expand_as(d.xquat[:, b]))


def _point_vel(model: Model, d, body: int, p):
    o = d.subtree_com[:, model.body_rootid[body]]
    w = d.cvel[:, body, :3]
    return w, d.cvel[:, body, 3:] + maths.cross(w, p - o)


def _cacc(model: Model, d):
    """Body spatial accelerations with gravity (the cacc of
    mj_rnePostConstraint, from the constrained qacc)."""
    from .smooth import _gravity_acc

    cacc = [_gravity_acc(model, d.qvel)] * model.nbody
    for b in range(1, model.nbody):
        a = cacc[model.body_parentid[b]]
        adr, num = model.body_dofadr[b], model.body_dofnum[b]
        for i in range(adr, adr + num):
            a = (a + d.cdof_dot[:, i] * d.qvel[:, i:i + 1]
                 + d.cdof[:, i] * d.qacc[:, i:i + 1])
        cacc[b] = a
    return torch.stack(cacc, 1)


def _point_acc(model: Model, d, cacc, body: int, p):
    o = d.subtree_com[:, model.body_rootid[body]]
    alpha = cacc[:, body, :3]
    a = cacc[:, body, 3:] + maths.cross(alpha, p - o)
    w, v = _point_vel(model, d, body, p)
    return alpha, a + maths.cross(w, v)


def _subtree_vel(model: Model, d):
    """(linvel, angmom) per body (mj_subtreeVel analog)."""
    from .smooth import subtree_mask

    K = consts(model, d.qpos)
    sub = K.t("subtree_mask", lambda: subtree_mask(model))
    rootid = K.i("body_rootid", lambda: model.body_rootid)
    o = d.subtree_com[:, rootid]
    w = d.cvel[..., :3]
    v = d.cvel[..., 3:] + maths.cross(w, d.xipos - o)
    m = K.f("body_mass")
    msub = sub @ m
    mom = m[:, None] * v
    linvel = (torch.einsum("bc,nci->nbi", sub, mom)
              / torch.clamp(msub, min=1e-12)[:, None])
    inertia = K.f("body_inertia")
    iw = torch.einsum("nbij,bj,nbkj->nbik", d.ximat, inertia, d.ximat)
    spin = maths.matvec(iw, w)
    rxv = maths.cross(d.xipos, mom)
    angmom = (torch.einsum("bc,nci->nbi", sub, spin + rxv)
              - maths.cross(d.subtree_com,
                            torch.einsum("bc,nci->nbi", sub, mom)))
    return linvel, angmom


# ---------------------------------------------------------------------------
# ray casting for rangefinders
# ---------------------------------------------------------------------------


def _ray_quadratic(a, b, c):
    """Smallest nonnegative root of a t^2 + 2 b t + c = 0, else BIG."""
    disc = b * b - a * c
    oka = a > 1e-15
    ok = (disc >= 0) & oka
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    sa = torch.where(oka, a, torch.ones_like(a))
    t0 = (-b - sq) / sa
    t1 = (-b + sq) / sa
    big = torch.full_like(t0, _RAY_BIG)
    t = torch.where(t0 >= 0, t0, torch.where(t1 >= 0, t1, big))
    return torch.where(ok, t, big)


def _ray_sphere_at(center, r, p, v):
    q = p - center
    return _ray_quadratic(maths.dot(v, v), maths.dot(q, v),
                          maths.dot(q, q) - r * r)


def _ray_geom(gtype: int, gpos, gmat, gsize, p, v):
    """Distance along the unit ray (p, v) to a geom's surface, BIG if the
    ray misses; gsize is a tuple of Python floats."""
    gt = GeomType(gtype)
    pl = maths.matTvec(gmat, p - gpos)
    vl = maths.matTvec(gmat, v)
    big = torch.full_like(pl[:, 0], _RAY_BIG)
    if gt == GeomType.SPHERE:
        return _ray_sphere_at(gpos, gsize[0], p, v)
    if gt == GeomType.PLANE:
        okz = torch.abs(vl[:, 2]) > 1e-15
        t = torch.where(okz, -pl[:, 2] / torch.where(
            okz, vl[:, 2], torch.ones_like(big)), big)
        hit = pl + t[:, None] * vl
        ok = (t >= 0) & (vl[:, 2] < 0)
        if gsize[0] > 0:
            ok = ok & (torch.abs(hit[:, 0]) <= gsize[0])
        if gsize[1] > 0:
            ok = ok & (torch.abs(hit[:, 1]) <= gsize[1])
        return torch.where(ok, t, big)
    if gt in (GeomType.CAPSULE, GeomType.CYLINDER):
        r, h = gsize[0], gsize[1]
        a = vl[:, 0] * vl[:, 0] + vl[:, 1] * vl[:, 1]
        b = pl[:, 0] * vl[:, 0] + pl[:, 1] * vl[:, 1]
        c = pl[:, 0] * pl[:, 0] + pl[:, 1] * pl[:, 1] - r * r
        t_side = _ray_quadratic(a, b, c)
        z = pl[:, 2] + t_side * vl[:, 2]
        t_side = torch.where(torch.abs(z) <= h, t_side, big)
        if gt == GeomType.CAPSULE:
            zc = torch.zeros_like(pl)
            zc[:, 2] = h
            cap_hi = _ray_sphere_at(zc, r, pl, vl)
            cap_lo = _ray_sphere_at(-zc, r, pl, vl)
            return torch.minimum(t_side, torch.minimum(cap_hi, cap_lo))
        t_cap = big
        okz = torch.abs(vl[:, 2]) > 1e-15
        sv = torch.where(okz, vl[:, 2], torch.ones_like(big))
        for sign in (1.0, -1.0):
            t = torch.where(okz, (sign * h - pl[:, 2]) / sv, big)
            hit = pl + t[:, None] * vl
            ok = (t >= 0) & (hit[:, 0] ** 2 + hit[:, 1] ** 2 <= r * r)
            t_cap = torch.minimum(t_cap, torch.where(ok, t, big))
        return torch.minimum(t_side, t_cap)
    if gt == GeomType.ELLIPSOID:
        ps = torch.stack([pl[:, k] / gsize[k] for k in range(3)], -1)
        vs = torch.stack([vl[:, k] / gsize[k] for k in range(3)], -1)
        return _ray_quadratic(maths.dot(vs, vs), maths.dot(ps, vs),
                              maths.dot(ps, ps) - 1.0)
    if gt == GeomType.BOX:
        t_best = big
        for axis in range(3):
            denom = vl[:, axis]
            okd = torch.abs(denom) > 1e-15
            sd = torch.where(okd, denom, torch.ones_like(denom))
            for sign in (1.0, -1.0):
                t = torch.where(okd, (sign * gsize[axis] - pl[:, axis]) / sd,
                                big)
                hit = pl + t[:, None] * vl
                o1, o2 = (axis + 1) % 3, (axis + 2) % 3
                ok = ((t >= 0) & (torch.abs(hit[:, o1]) <= gsize[o1])
                      & (torch.abs(hit[:, o2]) <= gsize[o2]))
                t_best = torch.minimum(t_best, torch.where(ok, t, big))
        return t_best
    return big


def _rangefinder(model: Model, d, site: int):
    p = d.site_xpos[:, site]
    v = d.site_xmat[:, site, :, 2]
    own = model.site_bodyid[site]
    gsize = np.asarray(model.geom_size, dtype=np.float64)
    t_min = torch.full_like(p[:, 0], _RAY_BIG)
    for g in range(model.ngeom):
        if model.geom_bodyid[g] == own:
            continue
        t = _ray_geom(model.geom_type[g], d.geom_xpos[:, g],
                      d.geom_xmat[:, g], tuple(float(x) for x in gsize[g]),
                      p, v)
        t_min = torch.minimum(t_min, t)
    return torch.where(t_min >= _RAY_BIG, -torch.ones_like(t_min), t_min)


def _energy_pos(model: Model, d):
    """Gravity potential plus joint and tendon spring energy."""
    from .smooth import tendon_length_moment

    K = consts(model, d.qpos)
    e = torch.zeros_like(d.time)
    if not model.opt.disable_gravity:
        g = model.opt.gravity
        xg = sum(d.xipos[..., i] * float(g[i]) for i in range(3))
        e = e - (K.f("body_mass") * xg).sum(-1)
    stiff = np.asarray(model.jnt_stiffness, dtype=np.float64)
    qs = K.f("qpos_spring")
    for j in range(model.njnt):
        k = float(stiff[j])
        jt = model.jnt_type[j]
        qadr = model.jnt_qposadr[j]
        if jt in (JointType.HINGE, JointType.SLIDE):
            dq = d.qpos[:, qadr] - qs[qadr]
            e = e + 0.5 * k * dq * dq
        elif jt == JointType.BALL:
            dif = maths.quat_sub(d.qpos[:, qadr:qadr + 4], qs[qadr:qadr + 4])
            e = e + 0.5 * k * maths.dot(dif, dif)
        else:
            dp = d.qpos[:, qadr:qadr + 3] - qs[qadr:qadr + 3]
            dq = maths.quat_sub(d.qpos[:, qadr + 3:qadr + 7],
                                qs[qadr + 3:qadr + 7])
            e = e + 0.5 * k * (maths.dot(dp, dp) + maths.dot(dq, dq))
    if model.ntendon:
        length, _ = tendon_length_moment(model, d)
        ls = K.f("tendon_lengthspring")
        lo, hi = ls[:, 0], ls[:, 1]
        zero = torch.zeros_like(length)
        disp = torch.where(length < lo, lo - length,
                           torch.where(length > hi, length - hi, zero))
        e = e + (0.5 * K.f("tendon_stiffness") * disp * disp).sum(-1)
    return e


def sensor_pos(model: Model, d):
    """Position-stage sensors (mj_sensorPos analog)."""
    if not _has_stage(model, _POS):
        return d
    from .smooth import actuator_moments, tendon_length_moment

    K = consts(model, d.qpos)
    ten_len = act_len = None
    if _has_stage(model, (SensorType.ACTUATORPOS,)):
        _, act_len = actuator_moments(model, d)
    vals = {}
    for i in range(model.nsensor):
        st = SensorType(model.sensor_type[i])
        if st not in _POS:
            continue
        oid = model.sensor_objid[i]
        rid = model.sensor_refid[i]
        rt = model.sensor_reftype[i]
        ot = model.sensor_objtype[i]
        if st == SensorType.JOINTPOS:
            q = model.jnt_qposadr[oid]
            val = d.qpos[:, q:q + 1]
        elif st == SensorType.TENDONPOS:
            if ten_len is None:
                ten_len, _ = tendon_length_moment(model, d)
            val = ten_len[:, oid:oid + 1]
        elif st == SensorType.ACTUATORPOS:
            val = act_len[:, oid:oid + 1]
        elif st == SensorType.BALLQUAT:
            q = model.jnt_qposadr[oid]
            val = maths.quat_normalize(d.qpos[:, q:q + 4])
        elif st == SensorType.FRAMEPOS:
            pos, _, _ = _obj_pose(model, d, ot, oid)
            if rid >= 0:
                rpos, rmat, _ = _obj_pose(model, d, rt, rid)
                val = maths.matTvec(rmat, pos - rpos)
            else:
                val = pos
        elif st == SensorType.FRAMEQUAT:
            q = _obj_quat(model, d, K, ot, oid)
            if rid >= 0:
                rq = _obj_quat(model, d, K, rt, rid)
                q = maths.quat_mul(maths.quat_conj(rq), q)
            val = maths.quat_normalize(q)
        elif st in (SensorType.FRAMEXAXIS, SensorType.FRAMEYAXIS,
                    SensorType.FRAMEZAXIS):
            col = int(st) - int(SensorType.FRAMEXAXIS)
            _, mat, _ = _obj_pose(model, d, ot, oid)
            axis = mat[..., :, col]
            if rid >= 0:
                _, rmat, _ = _obj_pose(model, d, rt, rid)
                axis = maths.matTvec(rmat, axis)
            val = axis
        elif st == SensorType.SUBTREECOM:
            val = d.subtree_com[:, oid]
        elif st == SensorType.MAGNETOMETER:
            mag = K.t("magnetic", lambda: model.opt.magnetic)
            val = maths.matTvec(d.site_xmat[:, oid], mag.expand(
                d.qpos.shape[0], 3))
        elif st == SensorType.RANGEFINDER:
            val = _rangefinder(model, d, oid)[:, None]
        elif st == SensorType.E_POTENTIAL:
            val = _energy_pos(model, d)[:, None]
        elif st in (SensorType.GEOMDIST, SensorType.GEOMNORMAL,
                    SensorType.GEOMFROMTO):
            val = _geom_distance_family(model, d, i, st)
        elif st == SensorType.INSIDESITE:
            val = _insidesite_sensor(model, d, i)[:, None]
        elif st == SensorType.CAMPROJECTION:
            cid = model.sensor_refid[i]
            t = maths.matTvec(d.cam_xmat[:, cid],
                              d.site_xpos[:, oid] - d.cam_xpos[:, cid])
            w_res, h_res = model.cam_resolution[cid]
            ssx, ssy = model.cam_sensorsize[cid]
            if ssx != 0.0 or ssy != 0.0:
                fx = model.cam_intrinsic[cid][0] / ssx * w_res
                fy = model.cam_intrinsic[cid][1] / ssy * h_res
            else:
                fovy = float(np.asarray(model.cam_fovy)[cid])
                fx = fy = 0.5 * h_res / math.tan(fovy * (math.pi / 180.0)
                                                 * 0.5)
            val = torch.stack([-t[:, 0] / t[:, 2] * fx + 0.5 * w_res,
                               t[:, 1] / t[:, 2] * fy + 0.5 * h_res], -1)
        else:  # CLOCK
            val = d.time[:, None]
        vals[i] = val
    return d.replace(sensordata=_write(model, d.sensordata, vals))


def sensor_vel(model: Model, d):
    """Velocity-stage sensors (mj_sensorVel analog)."""
    if not _has_stage(model, _VEL):
        return d
    from .smooth import actuator_moments, tendon_length_moment

    act_vel = sub_lin = sub_mom = None
    if _has_stage(model, (SensorType.ACTUATORVEL,)):
        mom, _ = actuator_moments(model, d)
        act_vel = (mom * d.qvel[:, None]).sum(-1)
    if _has_stage(model, (SensorType.SUBTREELINVEL,
                          SensorType.SUBTREEANGMOM)):
        sub_lin, sub_mom = _subtree_vel(model, d)
    vals = {}
    for i in range(model.nsensor):
        st = SensorType(model.sensor_type[i])
        if st not in _VEL:
            continue
        oid = model.sensor_objid[i]
        rid = model.sensor_refid[i]
        rt = model.sensor_reftype[i]
        if st == SensorType.JOINTVEL:
            v = model.jnt_dofadr[oid]
            val = d.qvel[:, v:v + 1]
        elif st == SensorType.TENDONVEL:
            _, tmom = tendon_length_moment(model, d)
            val = (tmom[:, oid] * d.qvel).sum(-1)[:, None]
        elif st == SensorType.ACTUATORVEL:
            val = act_vel[:, oid:oid + 1]
        elif st == SensorType.BALLANGVEL:
            v = model.jnt_dofadr[oid]
            val = d.qvel[:, v:v + 3]
        elif st in (SensorType.VELOCIMETER, SensorType.GYRO):
            b = model.site_bodyid[oid]
            w, v = _point_vel(model, d, b, d.site_xpos[:, oid])
            val = maths.matTvec(d.site_xmat[:, oid],
                                v if st == SensorType.VELOCIMETER else w)
        elif st in (SensorType.FRAMELINVEL, SensorType.FRAMEANGVEL):
            pos, _, b = _obj_pose(model, d, model.sensor_objtype[i], oid)
            w, v = _point_vel(model, d, b, pos)
            if rid >= 0:
                rpos, rmat, rb = _obj_pose(model, d, rt, rid)
                rw, rv = _point_vel(model, d, rb, rpos)
                if st == SensorType.FRAMELINVEL:
                    val = maths.matTvec(rmat, v - rv - maths.cross(
                        rw, pos - rpos))
                else:
                    val = maths.matTvec(rmat, w - rw)
            else:
                val = v if st == SensorType.FRAMELINVEL else w
        elif st == SensorType.SUBTREELINVEL:
            val = sub_lin[:, oid]
        elif st == SensorType.E_KINETIC:
            val = (0.5 * (d.qvel * maths.matvec(d.qM, d.qvel)).sum(-1))[
                :, None]
        else:  # SUBTREEANGMOM
            val = sub_mom[:, oid]
        vals[i] = val
    return d.replace(sensordata=_write(model, d.sensordata, vals))


def sensor_acc(model: Model, d, kinematic_only: bool = False):
    """Acceleration/force-stage sensors (mj_sensorAcc analog), after the
    constraint solve.  ``kinematic_only`` re-evaluates only the
    accelerometer/framelinacc/frameangacc family (the env layer's post-step
    refresh)."""
    if not _has_stage(model, _ACC):
        return d
    if kinematic_only and not _has_stage(model, _KINEMATIC_ACC):
        return d
    cacc = cfrc_int = touch = None
    ft = (SensorType.FORCE, SensorType.TORQUE)
    if _has_stage(model, _KINEMATIC_ACC) or (
            not kinematic_only and _has_stage(model, ft)):
        cacc = _cacc(model, d)
    if not kinematic_only and _has_stage(model, ft):
        cfrc_int = _cfrc_int(model, d, cacc)
    if not kinematic_only and _has_stage(model, (SensorType.TOUCH,)):
        touch = _touch_forces(model, d)
    vals = {}
    for i in range(model.nsensor):
        st = SensorType(model.sensor_type[i])
        if st not in _ACC or (kinematic_only and st not in _KINEMATIC_ACC):
            continue
        oid = model.sensor_objid[i]
        if st in _LIMIT_SENSORS:
            kind = "tendon" if st in (
                SensorType.TENDONLIMITPOS, SensorType.TENDONLIMITVEL,
                SensorType.TENDONLIMITFRC) else "joint"
            col = {SensorType.JOINTLIMITPOS: 0, SensorType.TENDONLIMITPOS: 0,
                   SensorType.JOINTLIMITVEL: 1, SensorType.TENDONLIMITVEL: 1,
                   SensorType.JOINTLIMITFRC: 2,
                   SensorType.TENDONLIMITFRC: 2}[st]
            keys = list(limit_row_map(model).keys())
            if (kind, oid) in keys:
                r = keys.index((kind, oid))
                val = d.efc_limit[:, r, col:col + 1]
            else:
                val = d.qpos.new_zeros((d.qpos.shape[0], 1))
        elif st == SensorType.ACTUATORFRC:
            val = d.actuator_force[:, oid:oid + 1]
        elif st == SensorType.JOINTACTFRC:
            v = model.jnt_dofadr[oid]
            val = d.qfrc_actuator[:, v:v + 1]
        elif st == SensorType.TENDONACTFRC:
            acc = torch.zeros_like(d.time)
            for u in range(model.nu):
                if (TrnType(model.actuator_trntype[u]) == TrnType.TENDON
                        and model.actuator_trnid[u] == oid):
                    acc = acc + d.actuator_force[:, u]
            val = acc[:, None]
        elif st == SensorType.ACCELEROMETER:
            b = model.site_bodyid[oid]
            _, a = _point_acc(model, d, cacc, b, d.site_xpos[:, oid])
            val = maths.matTvec(d.site_xmat[:, oid], a)
        elif st == SensorType.FRAMELINACC:
            pos, _, b = _obj_pose(model, d, model.sensor_objtype[i], oid)
            _, val = _point_acc(model, d, cacc, b, pos)
        elif st == SensorType.FRAMEANGACC:
            _, _, b = _obj_pose(model, d, model.sensor_objtype[i], oid)
            val = cacc[:, b, :3]
        elif st in ft:
            b = model.site_bodyid[oid]
            f = _site_wrench(model, d, cfrc_int, b, d.site_xpos[:, oid])
            val = maths.matTvec(d.site_xmat[:, oid],
                                f[:, 3:] if st == SensorType.FORCE
                                else f[:, :3])
        else:  # TOUCH
            val = touch[:, oid:oid + 1]
        vals[i] = val
    return d.replace(sensordata=_write(model, d.sensordata, vals))


# ---------------------------------------------------------------------------
# force/torque/touch machinery
# ---------------------------------------------------------------------------


def _body_ext_wrench(model: Model, d):
    """Per-body external wrench [torque; force] at each tree's com:
    xfrc_applied plus the contact forces."""
    K = consts(model, d.qpos)
    rootid = K.i("body_rootid", lambda: model.body_rootid)
    origin = d.subtree_com[:, rootid]
    frc = d.xfrc_applied[..., :3]
    trq = d.xfrc_applied[..., 3:] + maths.cross(d.xipos - origin, frc)
    w = list(torch.cat([trq, frc], -1).unbind(1))
    cf = d.contact_force
    con = d.contact
    for li, (b1, b2) in enumerate(_lane_bodies(model)):
        t, f = cf[:, li, :3], cf[:, li, 3:]
        t2 = t + maths.cross(con.pos[:, li]
                             - d.subtree_com[:, model.body_rootid[b2]], f)
        t1 = -t + maths.cross(con.pos[:, li]
                              - d.subtree_com[:, model.body_rootid[b1]], -f)
        w[b2] = w[b2] + torch.cat([t2, f], -1)
        w[b1] = w[b1] + torch.cat([t1, -f], -1)
    return torch.stack(w, 1)


def _cfrc_int(model: Model, d, cacc):
    """Interaction wrench each body receives from its parent."""
    ext = _body_ext_wrench(model, d)
    mass = consts(model, d.qpos).f("body_mass")
    iv = maths.inertia_mul_motion(d.cinert_i, d.cinert_h, mass, d.cvel)
    ia = maths.inertia_mul_motion(d.cinert_i, d.cinert_h, mass, cacc)
    net = ia + maths.force_cross(d.cvel, iv)
    cfrc = [net[:, b] - ext[:, b] for b in range(model.nbody)]
    for b in range(model.nbody - 1, 0, -1):
        p = model.body_parentid[b]
        cfrc[p] = cfrc[p] + cfrc[b]
    return torch.stack(cfrc, 1)


def _site_wrench(model: Model, d, cfrc_int, body: int, p):
    o = d.subtree_com[:, model.body_rootid[body]]
    f = cfrc_int[:, body]
    return torch.cat([f[:, :3] - maths.cross(p - o, f[:, 3:]), f[:, 3:]], -1)


def _inside_site(model: Model, d, sid: int, p):
    """World point p inside site ``sid``'s volume."""
    lp = maths.matTvec(d.site_xmat[:, sid], p - d.site_xpos[:, sid])
    s = [float(x) for x in np.asarray(model.site_size)[sid]]
    st = GeomType(model.site_type[sid])
    if st == GeomType.SPHERE:
        return maths.dot(lp, lp) <= s[0] * s[0]
    if st == GeomType.CAPSULE:
        zc = torch.clamp(lp[:, 2], -s[1], s[1])
        dv = torch.stack([lp[:, 0], lp[:, 1], lp[:, 2] - zc], -1)
        return maths.dot(dv, dv) <= s[0] * s[0]
    if st == GeomType.ELLIPSOID:
        q = torch.stack([lp[:, k] / max(s[k], 1e-12) for k in range(3)], -1)
        return maths.dot(q, q) <= 1.0
    if st == GeomType.CYLINDER:
        return (torch.abs(lp[:, 2]) <= s[1]) & (
            lp[:, 0] * lp[:, 0] + lp[:, 1] * lp[:, 1] <= s[0] * s[0])
    if st == GeomType.BOX:
        return ((torch.abs(lp[:, 0]) <= s[0]) & (torch.abs(lp[:, 1]) <= s[1])
                & (torch.abs(lp[:, 2]) <= s[2]))
    return torch.ones_like(lp[:, 0], dtype=torch.bool)


def _touch_forces(model: Model, d):
    """Per-site summed normal contact force of the touch sensors' sites."""
    cf = d.contact_force
    con = d.contact
    out = list(torch.zeros((d.qpos.shape[0], model.nsite),
                           dtype=d.qpos.dtype,
                           device=d.qpos.device).unbind(1))
    site_bodies = {model.sensor_objid[i]:
                   model.site_bodyid[model.sensor_objid[i]]
                   for i in range(model.nsensor)
                   if SensorType(model.sensor_type[i]) == SensorType.TOUCH}
    have_size = model.site_size is not None and len(model.site_type) > 0
    for li, (b1, b2) in enumerate(_lane_bodies(model)):
        fn = torch.abs(maths.dot(cf[:, li, 3:], con.frame[:, li, 0]))
        for sid, sb in site_bodies.items():
            if sb in (b1, b2):
                if have_size:
                    inside = _inside_site(model, d, sid, con.pos[:, li])
                    out[sid] = out[sid] + torch.where(inside, fn,
                                                      torch.zeros_like(fn))
                else:
                    out[sid] = out[sid] + fn
    return torch.stack(out, 1)


def _sensor_geoms(model: Model, objtype, objid):
    if objtype == ObjType.GEOM:
        return [objid]
    adr, num = model.body_geomadr[objid], model.body_geomnum[objid]
    return list(range(adr, adr + num))


def _geom_distance_family(model: Model, d, i: int, st):
    """geomdist / geomnormal / geomfromto over the objects' geom pairs."""
    from . import collision as _coll

    g1s = _sensor_geoms(model, model.sensor_objtype[i], model.sensor_objid[i])
    g2s = _sensor_geoms(model, model.sensor_reftype[i], model.sensor_refid[i])
    cutoff = float(np.asarray(model.sensor_cutoff)[i])
    best = torch.full_like(d.time, cutoff)
    bp1 = torch.zeros_like(d.qpos[:, :1]).expand(-1, 3)
    bp2 = bp1
    for ga in g1s:
        for gb in g2s:
            dist, p1, p2 = _coll.geom_distance(model, d, ga, gb)
            better = dist < best
            best = torch.where(better, dist, best)
            bp1 = torch.where(better[:, None], p1, bp1)
            bp2 = torch.where(better[:, None], p2, bp2)
    found = best < cutoff
    if st == SensorType.GEOMDIST:
        return torch.clamp(best, max=cutoff)[:, None]
    if st == SensorType.GEOMNORMAL:
        delta = bp2 - bp1
        nrm = maths.norm(delta)
        n = torch.where((nrm > 1e-15)[:, None],
                        delta / torch.clamp(nrm, min=1e-15)[:, None],
                        torch.zeros_like(delta))
        return torch.where(found[:, None], n, torch.zeros_like(n))
    ft = torch.cat([bp1, bp2], -1)
    return torch.where(found[:, None], ft, torch.zeros_like(ft))


def _insidesite_sensor(model: Model, d, i: int):
    """1.0 where the object's position lies inside the site's volume."""
    sid = model.sensor_refid[i]
    pos, _, _ = _obj_pose(model, d, model.sensor_objtype[i],
                          model.sensor_objid[i])
    local = maths.matTvec(d.site_xmat[:, sid], pos - d.site_xpos[:, sid])
    s = [float(x) for x in np.asarray(model.site_size)[sid]]
    stype = GeomType(model.site_type[sid])
    if stype == GeomType.SPHERE:
        inside = maths.norm(local) <= s[0]
    elif stype == GeomType.CAPSULE:
        z = torch.clamp(local[:, 2], -s[1], s[1])
        dv = torch.stack([local[:, 0], local[:, 1], local[:, 2] - z], -1)
        inside = maths.norm(dv) <= s[0]
    elif stype == GeomType.ELLIPSOID:
        inside = sum((local[:, k] / s[k]) ** 2 for k in range(3)) <= 1.0
    elif stype == GeomType.CYLINDER:
        inside = (torch.abs(local[:, 2]) <= s[1]) & (
            maths.norm(local[:, :2]) <= s[0])
    else:
        inside = ((torch.abs(local[:, 0]) <= s[0])
                  & (torch.abs(local[:, 1]) <= s[1])
                  & (torch.abs(local[:, 2]) <= s[2]))
    return inside.to(d.qpos.dtype)
