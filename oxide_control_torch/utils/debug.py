"""Numerical checks of the general path's step: the port of
``oxide_control_tpu/utils/debug.py``.

What remains to check in a step is NaN/Inf creation and f32 precision
loss.  The reference builds these on ``checkify`` and ``jax.debug.print``
inside the compiled step; here they are plain tensor checks between the
stages, which read one flag back to the host per check (so neither runs
under a CUDA-graph capture):

* :func:`checked_step` steps and raises on the first non-finite core
  output, naming the field;
* :func:`nan_debug_step` runs the step stage by stage and prints each
  stage's count of non-finite values, naming the first stage that made
  one (the development analog of MuJoCo's mj_warning stream).
"""

from __future__ import annotations

import torch

from ..model import Model
from ..physics import constraint as _constraint
from ..physics import forward as _forward
from ..physics import sensor as _sensor
from ..physics import smooth as _smooth

_CHECK_FIELDS = ("qpos", "qvel", "qacc", "qacc_smooth", "qfrc_constraint")

# (stage, function of (model, data), the fields it writes)
_STAGES = (
    ("position", _forward.fwd_position, ("xpos", "geom_xpos", "qM")),
    ("velocity", _forward.fwd_velocity,
     ("cvel", "qfrc_bias", "qfrc_passive")),
    ("actuation", _smooth.actuation, ("actuator_force", "qfrc_actuator")),
    ("acceleration", _smooth.fwd_acceleration, ("qacc_smooth",)),
    ("constraint", _constraint.fwd_constraint,
     ("qacc", "qfrc_constraint")),
    ("sensors", _sensor.sensor_acc, ("sensordata",)),
    ("integration", _forward.integrate, ("qpos", "qvel", "act")),
)


def _non_finite(d, fields) -> int:
    return int(sum((~torch.isfinite(getattr(d, f))).sum() for f in fields))


def checked_step(model: Model):
    """``fn(data) -> data``: one step of the general path that raises
    ``FloatingPointError`` naming the first core output with a NaN or
    Inf."""

    def fn(d):
        d = _forward.step(model, d)
        for name in _CHECK_FIELDS:
            if _non_finite(d, (name,)):
                raise FloatingPointError(f"non-finite {name} after step")
        return d

    return fn


def nan_debug_step(model: Model):
    """``fn(data) -> data``: one step run stage by stage, printing each
    stage's count of non-finite values in the fields it writes and the
    first stage that made one."""

    def fn(d):
        first = None
        for stage, run, fields in _STAGES:
            d = run(model, d)
            bad = _non_finite(d, fields)
            print(f"nan_debug: {stage} non-finite count = {bad}")
            if bad and first is None:
                first = stage
        if first is not None:
            print(f"nan_debug: first non-finite stage: {first}")
        return d

    return fn
