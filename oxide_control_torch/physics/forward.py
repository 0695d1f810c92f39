"""Forward dynamics and the step: the port's ``mj_forward`` / ``mj_step``,
batched.

The port of ``oxide_control_tpu/physics/forward.py``.  ``forward``
recomputes every derived field of a batch ``Data`` from its core state;
``step`` also integrates, advancing time by ``opt.timestep``.
"""

from __future__ import annotations

from ..model import Integrator, Model
from . import collision as _collision
from . import constraint as _constraint
from . import integrate as _integrate
from . import sensor as _sensor
from . import smooth


def fwd_position(model: Model, d):
    """kinematics -> com quantities -> cameras -> CRB -> collision ->
    position sensors."""
    d = smooth.kinematics(model, d)
    d = smooth.com_pos(model, d)
    d = smooth.cam_light(model, d)
    d = smooth.crb(model, d)
    d = _collision.collision(model, d)
    return _sensor.sensor_pos(model, d)


def fwd_velocity(model: Model, d):
    d = smooth.com_vel(model, d)
    d = smooth.rne(model, d)
    d = smooth.passive(model, d)
    return _sensor.sensor_vel(model, d)


def forward(model: Model, d):
    """Full forward dynamics without integration (mj_forward)."""
    d = fwd_position(model, d)
    d = fwd_velocity(model, d)
    d = smooth.actuation(model, d)
    d = smooth.fwd_acceleration(model, d)
    d = _constraint.fwd_constraint(model, d)
    return _sensor.sensor_acc(model, d)


def sensor_refresh(model: Model, d):
    """sensordata at the current state (needs current kinematics):
    position and velocity sensors fresh, the kinematic acc family at the
    current pose with ``d.qacc``, force-stage sensors kept."""
    if not model.nsensor:
        return d
    d = smooth.com_pos(model, d)
    d = smooth.cam_light(model, d)
    d = _sensor.sensor_pos(model, d)
    d = smooth.com_vel(model, d)
    d = _sensor.sensor_vel(model, d)
    return _sensor.sensor_acc(model, d, kinematic_only=True)


def step(model: Model, d):
    """Advance every env by one timestep (mj_step)."""
    return integrate(model, forward(model, d))


def integrate(model: Model, d):
    """The integrator's update of a forward-filled ``d``."""
    integ = model.opt.integrator
    if integ == Integrator.EULER:
        return _integrate.euler(model, d)
    if integ == Integrator.RK4:
        return _integrate.rk4(model, d, forward)
    if integ == Integrator.IMPLICITFAST:
        return _integrate.implicit(model, d, fast=True)
    if integ == Integrator.IMPLICIT:
        return _integrate.implicit(model, d, fast=False)
    raise NotImplementedError(f"integrator {integ}")
