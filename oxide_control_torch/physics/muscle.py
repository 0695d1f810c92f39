"""Muscle actuator model: mju_muscleDynamics / mju_muscleGain /
mju_muscleBias (the MuJoCo 3.x Millard-style FLV muscle).

The port's copy of ``oxide_control_tpu/physics/muscle.py:24-113``, written
against a scalar-graph backend ``bk`` (``where``, ``clip``, ``maximum``;
see ``ops.scalar_graph``) so that one function serves the torch backend and
the emitter of the rollout kernel.  The model's parameters are python
floats: every ``maximum(const, 1e-15)`` divisor folds at build time, so a
division by it is a division by a python scalar (which the emitter writes
as torch performs it), and only lengths, velocities, controls and
activations are traced.

Parameter vector (gainprm == biasprm, 9 entries):
  [range0, range1, force, scale, lmin, lmax, vmax, fpmax, fvmax]
force < 0 means "auto": force = scale / acc0 with acc0 the norm of the
unit-actuator joint acceleration at qpos0 (``Model.actuator_acc0``).
"""

from __future__ import annotations

_MINVAL = 1e-15


def _bump(bk, L, A, mid, B):
    """Smooth quadratic-spline bump: 0 at A and B, 1 at mid (mju_muscleGain
    helper); A, mid and B are constants."""
    left = 0.5 * (A + mid)
    right = 0.5 * (mid + B)

    xl = (L - A) / max(left - A, _MINVAL)
    yl = 0.5 * xl * xl
    xm_l = (mid - L) / max(mid - left, _MINVAL)
    ym_l = 1.0 - 0.5 * xm_l * xm_l
    xm_r = (L - mid) / max(right - mid, _MINVAL)
    ym_r = 1.0 - 0.5 * xm_r * xm_r
    xr = (B - L) / max(B - right, _MINVAL)
    yr = 0.5 * xr * xr

    out = bk.where(
        L < left, yl,
        bk.where(L < mid, ym_l, bk.where(L < right, ym_r, yr)),
    )
    return bk.where((L <= A) | (L >= B), 0.0, out)


def _norm_length(length, lengthrange, prm):
    r0, r1 = prm[0], prm[1]
    L0 = (lengthrange[1] - lengthrange[0]) / max(r1 - r0, _MINVAL)
    return r0 + (length - lengthrange[0]) / max(L0, _MINVAL), L0


def _eff_force(acc0, prm):
    force, scale = prm[2], prm[3]
    return scale / max(acc0, _MINVAL) if force < 0 else force


def muscle_gain(bk, length, vel, lengthrange, acc0, prm):
    """Active muscle gain: -force * FL(L) * FV(V) (mju_muscleGain)."""
    lmin, lmax, vmax, fvmax = prm[4], prm[5], prm[6], prm[8]
    L, L0 = _norm_length(length, lengthrange, prm)
    V = vel / max(L0 * vmax, _MINVAL)
    FL = _bump(bk, L, lmin, 1.0, lmax)
    y = fvmax - 1.0
    FV = bk.where(
        V <= -1.0, 0.0,
        bk.where(
            V <= 0.0, (V + 1.0) * (V + 1.0),
            bk.where(
                V <= y,
                fvmax - (y - V) * (y - V) / max(y, _MINVAL),
                fvmax,
            ),
        ),
    )
    return -_eff_force(acc0, prm) * FL * FV


def muscle_bias(bk, length, lengthrange, acc0, prm):
    """Passive muscle force: quadratic toe ramping to linear beyond
    b = 0.5*(1 + lmax) (mju_muscleBias)."""
    lmax, fpmax = prm[5], prm[7]
    L, _ = _norm_length(length, lengthrange, prm)
    b = 0.5 * (1.0 + lmax)
    x_mid = (L - 1.0) / max(b - 1.0, _MINVAL)
    x_hi = (L - b) / max(b - 1.0, _MINVAL)
    force = _eff_force(acc0, prm)
    return bk.where(
        L <= 1.0, 0.0,
        bk.where(
            L <= b,
            -force * fpmax * 0.5 * x_mid * x_mid,
            -force * fpmax * (0.5 + x_hi),
        ),
    )


def muscle_dynamics(bk, ctrl, act, prm):
    """Activation dynamics with activation-dependent time constants
    (mju_muscleDynamics); prm = [tau_act, tau_deact, tau_smooth]."""
    ctrlclamp = bk.clip(ctrl, 0.0, 1.0)
    actclamp = bk.clip(act, 0.0, 1.0)
    tau_act = prm[0] * (0.5 + 1.5 * actclamp)
    tau_deact = prm[1] / (0.5 + 1.5 * actclamp)
    dctrl = ctrlclamp - act
    tausmooth = prm[2]
    # hard switch (tausmooth == 0) or sigmoid blend over dctrl
    x = dctrl / max(tausmooth, _MINVAL) + 0.5
    xc = bk.clip(x, 0.0, 1.0)
    sig = xc * xc * xc * (3.0 * xc * (2.0 * xc - 5.0) + 10.0)  # mju_sigmoid
    blend = tau_deact + (tau_act - tau_deact) * sig
    tau = bk.where(tausmooth > 0, blend,
                   bk.where(dctrl > 0, tau_act, tau_deact))
    return dctrl / bk.maximum(tau, _MINVAL)
