"""PyTorch port: the single-env ``Physics`` API against the reference's.

One script of verbs, writes and reads runs through the reference's
``api.physics.Physics`` and the port's (on the CPU, f64) on a model with
free, ball, hinge and slide joints, a motor and a stateful (filter)
actuator, a mocap body, a joint equality, sensors and a keyframe: every
value read agrees within 1e-12, and every misuse raises the same error
type in both.  The package exports and ``suite.load`` are checked beside
it.
"""

import numpy as np
import pytest
import torch

import oxide_control_tpu
from oxide_control_tpu import suite as rsuite
from oxide_control_tpu.api import physics as rphysics

import oxide_control_torch
from oxide_control_torch import api as papi
from oxide_control_torch import suite as psuite
from oxide_control_torch.api import physics as pphysics

XML = """
<mujoco>
  <option timestep="0.005" solver="Newton" iterations="20" tolerance="0"/>
  <worldbody>
    <body name="target" mocap="true" pos="0.5 0 1">
      <geom type="sphere" size="0.05" contype="0" conaffinity="0"/>
    </body>
    <body name="torso" pos="0 0 1">
      <freejoint name="root"/>
      <geom name="chest" type="box" size="0.1 0.1 0.1" mass="1"/>
      <site name="tip" pos="0 0 0.1"/>
      <body name="arm" pos="0.2 0 0">
        <joint name="hinge" type="hinge" axis="0 1 0" damping="0.1"/>
        <geom type="capsule" fromto="0 0 0 0.3 0 0" size="0.03" mass="0.3"/>
        <body name="wrist" pos="0.3 0 0">
          <joint name="ball" type="ball"/>
          <geom type="sphere" size="0.05" mass="0.2"/>
          <body name="finger" pos="0.1 0 0">
            <joint name="slide" type="slide" axis="1 0 0"/>
            <geom type="sphere" size="0.03" mass="0.1"/>
          </body>
        </body>
      </body>
    </body>
  </worldbody>
  <equality>
    <joint name="couple" joint1="hinge" joint2="slide"/>
  </equality>
  <actuator>
    <motor name="motor" joint="hinge" gear="2"/>
    <general name="filt" joint="slide" dyntype="filter" dynprm="0.1"
             gainprm="1"/>
  </actuator>
  <sensor>
    <jointpos name="hinge_pos" joint="hinge"/>
    <framepos name="tip_pos" objtype="site" objname="tip"/>
    <jointvel name="slide_vel" joint="slide"/>
  </sensor>
  <keyframe>
    <key name="bent" time="0.5"
         qpos="0 0 1.2 1 0 0 0 0.3 1 0 0 0 0.05"
         qvel="0 0 0 0 0 0.1 0.2 0 0 0 0"/>
  </keyframe>
</mujoco>
"""


def script(p):
    """The verbs, writes and reads, the same on both handles: a list of
    (label, value)."""
    out = []

    def read(label):
        out.extend([
            (f"{label} time", p.time),
            (f"{label} sensordata", p.sensordata()),
            (f"{label} tip_pos", p.sensordata("tip_pos")),
            (f"{label} hinge_pos", p.sensordata(0)),
            (f"{label} arm xpos", p.body_xpos("arm")),
            (f"{label} wrist xquat", p.body_xquat("wrist")),
            (f"{label} chest xpos", p.geom_xpos("chest")),
            (f"{label} tip xpos", p.site_xpos("tip")),
            (f"{label} warmstart", p.qacc_warmstart(1)),
        ])
        for j in ("root", "hinge", "ball", "slide"):
            out.append((f"{label} qpos {j}", p.qpos(j)))
            out.append((f"{label} qvel {j}", p.qvel(j)))
        out.extend([(f"{label} ctrl", p.ctrl("motor")),
                    (f"{label} act", p.act("filt")),
                    (f"{label} eq", p.eq_active("couple")),
                    (f"{label} mocap", p.mocap_pos("target")),
                    (f"{label} mocap quat", p.mocap_quat("target")),
                    (f"{label} xfrc", p.xfrc_applied("torso")),
                    (f"{label} qfrc", p.qfrc_applied(6)),
                    (f"{label} diverged", p.diverged())])

    p.set_qpos("hinge", 0.3)
    p.set_qpos("ball", [0.9, 0.1, 0.2, 0.3])
    p.set_qpos("root", [0.1, 0.0, 1.1, 1.0, 0.0, 0.0, 0.0])
    p.set_qpos("slide", 0.02)
    p.set_qvel("slide", 0.5)
    p.set_qvel("root", [0.1, 0.0, 0.0, 0.0, 0.3, 0.0])
    p.set_ctrl("motor", 0.2)
    p.actuators().set("filt", -0.4)
    p.set_act("filt", 0.1)
    p.set_qfrc_applied(6, 0.3)
    p.set_xfrc_applied("torso", [0.0, 0.0, 2.0, 0.0, 0.1, 0.0])
    p.set_mocap_pos("target", [0.4, 0.1, 0.9])
    p.set_mocap_quat("target", [0.0, 1.0, 0.0, 0.0])
    p.set_qacc_warmstart(1, 0.01)
    p.set_time(0.25)
    p.forward()
    read("forward")
    for _ in range(3):
        p.step()
    read("3 steps")
    p.set_eq_active("couple", False)
    p.step()
    read("equality off")
    p.reset("bent")
    read("keyframe")
    p.step()
    read("keyframe + step")
    p.reset()
    p.actuators().set_all([0.5, -0.5])
    read("reset")
    out.extend([("id arm", p.object_id("body", "arm")),
                ("id none", p.object_id("body", "nope")),
                ("name joint 2", p.object_name("joint", 2))])
    return out


@pytest.fixture(scope="module")
def runs():
    ref = rphysics.Physics.from_xml_string(XML)
    port = pphysics.Physics.from_xml_string(XML, device="cpu")
    return script(ref), script(port)


def value(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def test_script_matches_reference(runs):
    ref, port = runs
    assert [k for k, _ in ref] == [k for k, _ in port]
    for (label, w), (_, g) in zip(ref, port):
        w, g = value(w), value(g)
        assert w.shape == g.shape, label
        if w.dtype.kind in "fc":
            assert float(np.max(np.abs(w - g), initial=0.0)) < 1e-12, label
        else:
            assert (w == g).all(), label


def test_script_moves_the_state(runs):
    """The steps move the state, the keyframe loads, the equality turns
    off (the script exercises what it reads)."""
    got = dict(runs[1])
    assert float(got["3 steps time"]) == pytest.approx(0.265)
    assert float(got["keyframe time"]) == 0.5
    assert float(got["keyframe qpos hinge"]) == pytest.approx(0.3)
    assert not got["equality off eq"]
    assert float(got["3 steps act"]) != 0.1
    assert got["reset diverged"] is False


MISUSES = {
    "unknown name": lambda p: p.qpos("nope"),
    "joint type": lambda p: p.qpos("hinge", expect="ball"),
    "qpos width": lambda p: p.set_qpos("ball", [1.0, 0.0, 0.0]),
    "qvel width": lambda p: p.set_qvel("root", [1.0, 0.0]),
    "stateless act": lambda p: p.act("motor"),
    "stateless set_act": lambda p: p.set_act(0, 1.0),
    "plugin": lambda p: p.plugin_state(0),
    "set plugin": lambda p: p.set_plugin_state(0, 1.0),
    "not mocap": lambda p: p.mocap_pos("torso"),
    "unknown actuator": lambda p: p.actuators().set("nope", 1.0),
    "keyframe index": lambda p: p.reset(3),
    "keyframe name": lambda p: p.reset("nope"),
}


@pytest.mark.parametrize("misuse", sorted(MISUSES))
def test_misuse_raises_the_same_error(misuse):
    errors = []
    for mod, kw in ((rphysics, {}), (pphysics, {"device": "cpu"})):
        p = mod.Physics.from_xml_string(XML, **kw)
        with pytest.raises(Exception) as exc:
            MISUSES[misuse](p)
        errors.append(type(exc.value))
    ref, port = errors
    if misuse == "keyframe name":
        # the reference raises NameNotFoundError with one argument, so its
        # constructor fails with TypeError; the port raises the error the
        # reference means
        assert ref is TypeError, ref
        assert port is papi.errors.NameNotFoundError, port
        return
    assert ref.__name__ == port.__name__, (ref, port)
    # the error types come from each package's own api.errors
    if ref.__module__.endswith("api.errors"):
        assert port is getattr(papi.errors, port.__name__)


def test_exports_match_reference():
    from oxide_control_tpu import api as rapi

    assert set(oxide_control_torch.__all__) - {"default_device"} == set(
        oxide_control_tpu.__all__)
    assert set(papi.__all__) == set(rapi.__all__)
    for name in papi.__all__:
        assert getattr(papi, name) is not None


def test_suite_load_single_env():
    """``suite.load``: one env (a batch of one) in the requested dtype on
    the requested device, stepping as the batched env does."""
    env = psuite.load("cartpole", "swingup", device="cpu")
    assert isinstance(env, papi.Environment)
    assert env.model.nq == rsuite.load("cartpole", "swingup").model.nq
    data, obs = env.reset(torch.Generator().manual_seed(0))
    assert data.qpos.shape == (1, env.model.nq)
    assert data.qpos.dtype == torch.float64
    benv = psuite.load_batched("cartpole", "swingup", 1, dtype=np.float64,
                               device="cpu")
    action = torch.full((1, 1), 0.3, dtype=torch.float64)
    d1, ts1 = env.step(data, action)
    d2, ts2 = benv.step_envs(data, action)
    assert torch.equal(d1.qpos, d2.qpos) and torch.equal(ts1.reward,
                                                         ts2.reward)
    assert not torch.equal(d1.qpos, data.qpos)
