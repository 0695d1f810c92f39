"""Error vocabulary.

Mirrors the failure vocabulary of the reference's ``enum Error``
(oxide_control src/error.rs:3-15): model-compile errors, name lookup,
joint-type mismatch, physics divergence, stateless-actuator/plugin misuse and
non-mocap-body misuse — re-expressed as Python exceptions.  Divergence is
*also* surfaced vectorized (per-env flags) since lockstep batches cannot
raise; the rollout kernel counts them per env (``Trajectory.diverged``).
"""

from __future__ import annotations


class OxideControlError(Exception):
    """Base class for all engine errors."""


class ModelError(OxideControlError):
    """MJCF parse/compile failure (analog of Error::Mujoco / Error::Mjs,
    oxide_control src/error.rs:4-5)."""


class NameNotFoundError(OxideControlError, KeyError):
    """Name lookup failed (analog of Error::NameNotFound,
    oxide_control src/error.rs:6)."""

    def __init__(self, objtype: str, name: str):
        super().__init__(f"{objtype} name not found: {name!r}")
        self.objtype = objtype
        self.name = name


class PhysicsDivergedError(OxideControlError):
    """Host-side divergence signal (analog of Error::PhysicsDiverged,
    oxide_control src/error.rs:7). The batched engine reports divergence
    via per-env flags instead; this exception is raised only by host-side
    checking utilities."""


class JointTypeError(OxideControlError, TypeError):
    """Accessor used with the wrong joint type (analog of
    Error::JointTypeNotMatch, oxide_control src/error.rs:8)."""

    def __init__(self, expected: str, found: str, name: str = ""):
        super().__init__(
            f"joint type mismatch{f' for {name!r}' if name else ''}: "
            f"expected {expected}, found {found}"
        )


class ActuatorStatelessError(OxideControlError):
    """`act` accessor used on a stateless actuator (analog of
    Error::ActuatorStateless, oxide_control src/error.rs:9)."""


class PluginStatelessError(OxideControlError):
    """`plugin_state` accessor used on a stateless (or absent) plugin
    (analog of Error::PluginStateless, oxide_control src/error.rs:10).
    This engine compiles no MuJoCo engine plugins — MJCF ``<extension>``
    is rejected — so every plugin-state access raises this."""


class BodyNotMocapError(OxideControlError):
    """Mocap accessor used on a non-mocap body (analog of
    Error::BodyNotMocap, oxide_control src/error.rs:11)."""


class UnsupportedFeatureError(ModelError):
    """MJCF feature not yet implemented by this engine."""
