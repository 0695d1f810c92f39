"""Physics handle: one environment behind typed accessors.

The port of ``oxide_control_tpu/api/physics.py``, the analog of the
reference crate's ``struct Physics {model, data}`` (oxide_control
src/physics.rs:6-171): constructors from MJCF, the verbs ``step``,
``forward`` and ``reset``, name <-> id lookup, the ``Actuators``
write-proxy and the typed state accessors, with the same error types for
the same misuse (``api/errors.py``).

The handle holds a batch-of-one ``Data`` on its device (the current CUDA
device unless the caller passes ``device="cpu"``), steps it through the
general path (``physics.forward``) and returns the tensors of env 0; a
write replaces the written field with an updated copy.  Batched lockstep
simulation goes through ``api.environment``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import default_device
from ..model import DOF_WIDTH, QPOS_WIDTH, JointType, Model
from ..physics import forward as _forward
from ..state import Data, make_data, reset_data_keyframe
from ..utils.divergence import divergence_flags
from .errors import (
    ActuatorStatelessError,
    BodyNotMocapError,
    JointTypeError,
    NameNotFoundError,
    PluginStatelessError,
)

# divergence bounds, the mjMAXVAL / mjMINVAL the reference re-exports
MAXVAL = 1e10
MINVAL = 1e-15


class Actuators:
    """Write-proxy over a Physics exposing only control writes (the sole
    capability handed to an action, reference physics.rs:65-72)."""

    def __init__(self, physics: "Physics"):
        self._physics = physics

    def set(self, actuator, control) -> None:
        """Set one actuator's control by name or index."""
        self._physics.set_ctrl(actuator, control)

    def set_all(self, controls) -> None:
        """Vector write of the full ctrl array."""
        p = self._physics
        p._set("ctrl", slice(None), controls)


class Physics:
    """Single-env physics handle over (Model, Data)."""

    def __init__(self, model: Model, data: Data | None = None, device=None):
        self._model = model
        self.device = (data.qpos.device if data is not None and device is None
                       else default_device(device))
        self._data = data if data is not None else self._fresh()

    def _fresh(self) -> Data:
        return make_data(self._model, self.device, batch=1)

    # -- constructors (reference physics.rs:12-24) --------------------------

    @classmethod
    def from_xml(cls, path: str | os.PathLike, dtype=np.float64,
                 device=None) -> "Physics":
        from ..mjcf.compile import load_model

        return cls(load_model(path, dtype=dtype), device=device)

    @classmethod
    def from_xml_string(cls, xml: str, dtype=np.float64,
                        device=None) -> "Physics":
        from ..mjcf.compile import load_model_from_xml

        return cls(load_model_from_xml(xml, dtype=dtype), device=device)

    # -- raw access (reference physics.rs:26-42) ----------------------------

    @property
    def model(self) -> Model:
        return self._model

    @property
    def data(self) -> Data:
        """The batch-of-one Data (every tensor has an env axis of 1)."""
        return self._data

    @data.setter
    def data(self, value: Data) -> None:
        self._data = value

    # -- simulation verbs (reference physics.rs:44-54) ----------------------

    def step(self) -> None:
        """Advance one timestep (mj_step)."""
        self._data = _forward.step(self._model, self._data)

    def forward(self) -> None:
        """Recompute derived quantities without advancing time
        (mj_forward); use after manual state writes."""
        self._data = _forward.forward(self._model, self._data)

    def reset(self, keyframe: int | str | None = None) -> None:
        """Restore model defaults (mj_resetData), or load the model
        keyframe ``keyframe`` (mj_resetDataKeyframe)."""
        self._data = self._fresh()
        if keyframe is not None:
            self._data = reset_data_keyframe(self._model, self._data,
                                             keyframe)

    # -- name <-> id (reference physics.rs:56-62) ---------------------------

    def object_id(self, objtype: str, name: str) -> int | None:
        idx = self._model.name2id(objtype, name)
        return idx if idx >= 0 else None

    def object_name(self, objtype: str, idx: int) -> str:
        return self._model.id2name(objtype, idx)

    def _resolve(self, objtype: str, key) -> int:
        if isinstance(key, str):
            idx = self._model.name2id(objtype, key)
            if idx < 0:
                raise NameNotFoundError(objtype, key)
            return idx
        return int(key)

    def _set(self, field: str, index, value) -> None:
        """``data.<field>[0][index] = value`` on a copy of the field."""
        x = getattr(self._data, field).clone()
        x[0][index] = torch.as_tensor(value, dtype=x.dtype, device=x.device)
        self._data = self._data.replace(**{field: x})

    # -- actuators proxy (reference physics.rs:65-79) -----------------------

    def actuators(self) -> Actuators:
        return Actuators(self)

    # -- typed accessors (reference physics.rs:81-171) ----------------------

    @property
    def time(self):
        return self._data.time[0]

    def set_time(self, value) -> None:
        self._set("time", Ellipsis, value)

    def ctrl(self, actuator):
        return self._data.ctrl[0, self._resolve("actuator", actuator)]

    def set_ctrl(self, actuator, value) -> None:
        self._set("ctrl", self._resolve("actuator", actuator), value)

    def _act_adr(self, actuator) -> int:
        adr = self._model.actuator_actadr[self._resolve("actuator", actuator)]
        if adr < 0:
            raise ActuatorStatelessError(
                f"actuator {actuator!r} has no activation state")
        return adr

    def act(self, actuator):
        return self._data.act[0, self._act_adr(actuator)]

    def set_act(self, actuator, value) -> None:
        self._set("act", self._act_adr(actuator), value)

    def _joint_slices(self, joint):
        j = self._resolve("joint", joint)
        jt = JointType(self._model.jnt_type[j])
        qadr = self._model.jnt_qposadr[j]
        vadr = self._model.jnt_dofadr[j]
        return jt, slice(qadr, qadr + QPOS_WIDTH[jt]), slice(
            vadr, vadr + DOF_WIDTH[jt])

    @staticmethod
    def _typed(jt, val):
        return val[0] if jt in (JointType.HINGE, JointType.SLIDE) else val

    def qpos(self, joint, expect: str | None = None):
        """Typed generalized position: scalar (hinge/slide), quat (ball),
        7-vector (free).  ``expect`` asserts the joint type, raising
        JointTypeError on a mismatch."""
        jt, qsl, _ = self._joint_slices(joint)
        if expect is not None and jt.name.lower() != expect.lower():
            raise JointTypeError(expect, jt.name.lower(), str(joint))
        return self._typed(jt, self._data.qpos[0, qsl])

    def _set_width(self, field, joint, sl, value, what):
        val = torch.atleast_1d(torch.as_tensor(value, dtype=torch.float64))
        width = sl.stop - sl.start
        if tuple(val.shape) != (width,):
            raise JointTypeError(f"{what} width {width}",
                                 f"shape {tuple(val.shape)}", str(joint))
        self._set(field, sl, val)

    def set_qpos(self, joint, value) -> None:
        _, qsl, _ = self._joint_slices(joint)
        self._set_width("qpos", joint, qsl, value, "qpos")

    def qvel(self, joint):
        jt, _, vsl = self._joint_slices(joint)
        return self._typed(jt, self._data.qvel[0, vsl])

    def set_qvel(self, joint, value) -> None:
        _, _, vsl = self._joint_slices(joint)
        self._set_width("qvel", joint, vsl, value, "qvel")

    # plugin_state (physics.rs:125-131): the engine has no plugin system
    # (the MJCF compiler rejects <extension>), so these always raise, the
    # strict analog of the reference's PluginStateless

    def plugin_state(self, plugin):
        raise PluginStatelessError(
            f"plugin {plugin!r}: engine plugins are not supported "
            "(no plugin is ever compiled, so none has state)")

    def set_plugin_state(self, plugin, value) -> None:
        self.plugin_state(plugin)

    def qacc_warmstart(self, dof: int):
        return self._data.qacc_warmstart[0, dof]

    def set_qacc_warmstart(self, dof: int, value) -> None:
        self._set("qacc_warmstart", dof, value)

    def qfrc_applied(self, dof: int):
        return self._data.qfrc_applied[0, dof]

    def set_qfrc_applied(self, dof: int, value) -> None:
        self._set("qfrc_applied", dof, value)

    def xfrc_applied(self, body):
        return self._data.xfrc_applied[0, self._resolve("body", body)]

    def set_xfrc_applied(self, body, wrench) -> None:
        self._set("xfrc_applied", self._resolve("body", body), wrench)

    def eq_active(self, eq) -> bool:
        return bool(self._data.eq_active[0, self._resolve("equality", eq)])

    def set_eq_active(self, eq, value: bool) -> None:
        self._set("eq_active", self._resolve("equality", eq), bool(value))

    def _mocap_id(self, body) -> int:
        mid = self._model.body_mocapid[self._resolve("body", body)]
        if mid < 0:
            raise BodyNotMocapError(f"body {body!r} is not a mocap body")
        return mid

    def mocap_pos(self, body):
        return self._data.mocap_pos[0, self._mocap_id(body)]

    def set_mocap_pos(self, body, pos) -> None:
        self._set("mocap_pos", self._mocap_id(body), pos)

    def mocap_quat(self, body):
        return self._data.mocap_quat[0, self._mocap_id(body)]

    def set_mocap_quat(self, body, quat) -> None:
        self._set("mocap_quat", self._mocap_id(body), quat)

    # -- derived quantities ------------------------------------------------

    def body_xpos(self, body):
        return self._data.xpos[0, self._resolve("body", body)]

    def body_xquat(self, body):
        return self._data.xquat[0, self._resolve("body", body)]

    def geom_xpos(self, geom):
        return self._data.geom_xpos[0, self._resolve("geom", geom)]

    def site_xpos(self, site):
        return self._data.site_xpos[0, self._resolve("site", site)]

    def sensordata(self, sensor=None):
        """The sensordata vector, or the named/indexed sensor's slice
        (evaluated by forward/step)."""
        if sensor is None:
            return self._data.sensordata[0]
        idx = self._resolve("sensor", sensor)
        adr = self._model.sensor_adr[idx]
        return self._data.sensordata[0, adr:adr + self._model.sensor_dim[idx]]

    def diverged(self) -> bool:
        """Whether the state is non-finite or beyond MAXVAL (reads the
        flag back to the host)."""
        return bool(divergence_flags(self._model, self._data)[0])
