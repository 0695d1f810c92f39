"""Integrators: semi-implicit Euler (with implicit joint damping), RK4,
and implicit / implicitfast, batched.

The port of ``oxide_control_tpu/physics/integrate.py`` (MuJoCo's mj_Euler,
mj_RungeKutta and mj_implicit semantics).  Full ``implicit`` takes the RNE
Coriolis derivative by forward-mode AD through ``com_vel`` and ``rne``
(``torch.func.jvp``, one column per dof, where the reference takes
``jax.jacfwd``) and solves with LU.
"""

from __future__ import annotations

import numpy as np
import torch

from ..model import BiasType, DynType, GainType, JointType, Model
from . import maths, smooth
from .consts import consts


def advance_act(model: Model, act, act_dot, h: float):
    """mj_advance for activations: Euler for integrator/filter, the exact
    exponential for filterexact, then the actrange clamp."""
    if model.na == 0:
        return act
    K = consts(model, act)
    actadr = np.array(model.actuator_actadr)
    stateful = np.flatnonzero(actadr >= 0)
    dyn = np.array(model.actuator_dyntype)[stateful]
    limited = np.array(model.actuator_actlimited, dtype=bool)[stateful]
    tau = np.maximum(np.asarray(model.actuator_dynprm,
                                dtype=np.float64)[stateful, 0], 1e-15)
    tau_t = K.t("adv_tau", lambda: tau)
    exact = K.b("adv_exact", lambda: dyn == DynType.FILTEREXACT)
    # -h / tau as one division (torch takes c / x as reciprocal(x) * c)
    dt = torch.where(exact,
                     tau_t * -torch.expm1(torch.full_like(tau_t, -h) / tau_t),
                     torch.full_like(tau_t, h))
    act = act + act_dot * dt
    rng = K.f("actuator_actrange")[K.i("adv_stateful", lambda: stateful)]
    clipped = torch.minimum(torch.maximum(act, rng[:, 0]), rng[:, 1])
    return torch.where(K.b("adv_limited", lambda: limited), clipped, act)


def integrate_pos(model: Model, qpos, qvel, dt: float):
    """mj_integratePos: qpos += dt * qvel on the configuration manifold."""
    if all(t in (JointType.HINGE, JointType.SLIDE) for t in model.jnt_type):
        return qpos + dt * qvel
    cols = []
    for j in range(model.njnt):
        jt = model.jnt_type[j]
        qadr = model.jnt_qposadr[j]
        vadr = model.jnt_dofadr[j]
        if jt in (JointType.HINGE, JointType.SLIDE):
            cols.append(qpos[:, qadr:qadr + 1] + dt * qvel[:, vadr:vadr + 1])
        elif jt == JointType.BALL:
            cols.append(maths.quat_integrate(qpos[:, qadr:qadr + 4],
                                             qvel[:, vadr:vadr + 3], dt))
        else:
            cols.append(qpos[:, qadr:qadr + 3] + dt * qvel[:, vadr:vadr + 3])
            cols.append(maths.quat_integrate(qpos[:, qadr + 3:qadr + 7],
                                             qvel[:, vadr + 3:vadr + 6], dt))
    return torch.cat(cols, -1)


def euler(model: Model, d):
    """Semi-implicit Euler with implicit joint damping:
    (M + h diag(B)) dv = h (qfrc_smooth + qfrc_constraint)."""
    h = model.opt.timestep
    if (not model.opt.disable_eulerdamp) and model.any_damping:
        K = consts(model, d.qpos)
        mhb = d.qM + h * torch.diag(K.f("dof_damping"))
        dv = h * maths.solve_pd(mhb, d.qfrc_smooth + d.qfrc_constraint)
        qvel = d.qvel + dv
    else:
        qvel = d.qvel + h * d.qacc
    qpos = integrate_pos(model, d.qpos, qvel, h)
    act = advance_act(model, d.act, d.act_dot, h)
    return d.replace(qpos=qpos, qvel=qvel, act=act, time=d.time + h)


def _qderiv_actuation_damping(model: Model, d):
    """d qfrc_smooth / d qvel restricted to joint damping and the affine
    actuator gain/bias velocity terms (implicitfast's derivative)."""
    K = consts(model, d.qpos)
    deriv = -torch.diag(K.f("dof_damping"))
    if model.nu == 0:
        return deriv
    moments, _ = smooth.actuator_moments(model, d)
    ctrl = smooth._clip_ctrl(model, K, d.ctrl)
    actadr = np.array(model.actuator_actadr)
    if model.na:
        act_u = d.act[:, K.i("act_of_u", lambda: np.maximum(actadr, 0))]
        force_input = torch.where(K.b("stateful", lambda: actadr >= 0),
                                  act_u, ctrl)
    else:
        force_input = ctrl
    gaintype = np.array(model.actuator_gaintype)
    biastype = np.array(model.actuator_biastype)
    dgain = torch.where(K.b("gain_affine", lambda: gaintype
                            == GainType.AFFINE),
                        K.f("actuator_gainprm")[:, 2],
                        torch.zeros_like(K.f("actuator_gainprm")[:, 2]))
    dbias = torch.where(K.b("bias_affine", lambda: biastype
                            == BiasType.AFFINE),
                        K.f("actuator_biasprm")[:, 2],
                        torch.zeros_like(K.f("actuator_biasprm")[:, 2]))
    dfdv = dgain * force_input + dbias
    return deriv + moments.transpose(1, 2) @ (dfdv[:, :, None] * moments)


def _bias_jacobian(model: Model, d):
    """(B, nv, nv) d qfrc_bias / d qvel through com_vel and rne."""
    def bias_of(qvel):
        dd = d.replace(qvel=qvel)
        dd = smooth.com_vel(model, dd)
        return smooth.rne(model, dd).qfrc_bias

    cols = []
    for i in range(model.nv):
        e = torch.zeros_like(d.qvel)
        e[:, i] = 1.0
        cols.append(torch.func.jvp(bias_of, (d.qvel,), (e,))[1])
    return torch.stack(cols, -1)


def implicit(model: Model, d, fast: bool = True):
    """Implicit in velocity: (M - h D) dv = h (qfrc_smooth +
    qfrc_constraint), D = d qfrc_smooth / d qvel (implicitfast: damping
    and actuators, Cholesky; implicit: also -d qfrc_bias / d qvel, LU)."""
    h = model.opt.timestep
    deriv = _qderiv_actuation_damping(model, d)
    qfrc = d.qfrc_smooth + d.qfrc_constraint
    if fast:
        dv = h * maths.solve_pd(d.qM - h * deriv, qfrc)
    else:
        mhd = d.qM - h * (deriv - _bias_jacobian(model, d))
        dv = h * maths.solve_lu(mhd, qfrc)
    qvel = d.qvel + dv
    qpos = integrate_pos(model, d.qpos, qvel, h)
    act = advance_act(model, d.act, d.act_dot, h)
    return d.replace(qpos=qpos, qvel=qvel, act=act, time=d.time + h)


_RK4_A = ((0.5, 0.0, 0.0), (0.0, 0.5, 0.0), (0.0, 0.0, 1.0))
_RK4_B = (1.0 / 6.0, 1.0 / 3.0, 1.0 / 3.0, 1.0 / 6.0)


def rk4(model: Model, d, forward_fn):
    """mj_RungeKutta(N=4): ctrl and applied forces held over the stages,
    qpos integrated on the manifold at each stage."""
    h = model.opt.timestep
    qpos0, qvel0, act0 = d.qpos, d.qvel, d.act
    vels, accs, adots = [d.qvel], [d.qacc], [d.act_dot]
    for i in range(3):
        dq = sum(_RK4_A[i][j] * vels[j] for j in range(i + 1))
        dv = sum(_RK4_A[i][j] * accs[j] for j in range(i + 1))
        da = sum(_RK4_A[i][j] * adots[j] for j in range(i + 1))
        di = d.replace(qpos=integrate_pos(model, qpos0, dq, h),
                       qvel=qvel0 + h * dv, act=act0 + h * da)
        di = forward_fn(model, di)
        vels.append(di.qvel)
        accs.append(di.qacc)
        adots.append(di.act_dot)
    dq = sum(b * v for b, v in zip(_RK4_B, vels))
    dv = sum(b * a for b, a in zip(_RK4_B, accs))
    da = sum(b * a for b, a in zip(_RK4_B, adots))
    qpos = integrate_pos(model, qpos0, dq, h)
    qvel = qvel0 + h * dv
    act = advance_act(model, act0, da, h)
    return d.replace(qpos=qpos, qvel=qvel, act=act, time=d.time + h)
