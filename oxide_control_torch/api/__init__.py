"""The port's API: environments, the single-env ``Physics`` handle and the
error types (the exports of ``oxide_control_tpu/api/__init__.py``)."""

from .environment import BatchedEnvironment, Environment, Task, TimeStep
from .errors import (
    ActuatorStatelessError,
    BodyNotMocapError,
    JointTypeError,
    ModelError,
    NameNotFoundError,
    OxideControlError,
    PhysicsDivergedError,
    UnsupportedFeatureError,
)
from .physics import MAXVAL, MINVAL, Actuators, Physics

__all__ = [
    "Actuators",
    "ActuatorStatelessError",
    "BatchedEnvironment",
    "BodyNotMocapError",
    "Environment",
    "JointTypeError",
    "MAXVAL",
    "MINVAL",
    "ModelError",
    "NameNotFoundError",
    "OxideControlError",
    "Physics",
    "PhysicsDivergedError",
    "Task",
    "TimeStep",
    "UnsupportedFeatureError",
]
