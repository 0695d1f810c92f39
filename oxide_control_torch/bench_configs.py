"""Bench configurations outside the control suite.

The port's copy of the reference bench's synthetic widening configs
(``bench.py:275-308`` ``_BenchTask``; ``bench.py:311-331`` ``_ARMS_XML``,
``bench.py:333-367`` ``_MUSCLE_WRAP_XML``, ``bench.py:369-393``
``_FOURBAR_XML`` and ``bench.py:398-410`` ``_CABLE_XML``, loaded as in
``bench.py:413-425``), of its cheetah-run-elliptic (the suite's
cheetah run with elliptic cones, ``bench.py:426-433``) and of its
walker-walk-tendon-sensors (walker walk with a knee-coupler tendon and an
IMU on the torso, observed through ``SensorObsWrapper``,
``bench.py:435-468``).  They are not suite tasks (the reference suite
has none of them).  Usage::

    benv = bench_configs.load_config("arm", "muscle-wrap", 4096)  # on cuda
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .api.environment import BatchedEnvironment
from .mjcf.compile import load_model_from_xml
from .model import ConeType, Model
from .state import Data
from .suite.common import (SensorObsWrapper, asset_path, time_limit_done,
                           uniform)

# bench.py:311-331: two arms on hinges, children of the world, whose
# capsules and tip spheres collide with each other and the floor
ARMS_XML = """
<mujoco>
  <option solver="Newton" iterations="8" tolerance="0"/>
  <worldbody>
    <geom name="floor" type="plane" size="5 5 .1"/>
    <body pos="0 0 0.5">
      <joint name="s1" type="hinge" axis="0 1 0" damping="0.05"/>
      <geom name="armA" type="capsule" fromto="0 0 0 0.4 0 0" size="0.05"
            mass="1"/>
      <geom name="tipA" type="sphere" pos="0.45 0 0" size="0.05" mass="0.1"/>
    </body>
    <body pos="0.25 0 0.62">
      <joint name="s2" type="hinge" axis="0 1 0" damping="0.05"/>
      <geom name="armB" type="capsule" fromto="0 0 0 0.4 0 0" size="0.05"
            mass="1"/>
      <geom name="tipB" type="sphere" pos="0.45 0 0" size="0.05" mass="0.1"/>
    </body>
  </worldbody>
  <actuator><motor joint="s1" gear="2"/><motor joint="s2" gear="2"/></actuator>
</mujoco>
"""

# bench.py:333-367: a muscle on a spatial tendon that wraps a sphere with a
# sidesite, a tendon spring/damper, a limited elbow and a motor
MUSCLE_WRAP_XML = """
<mujoco model="wrapped_tendon_arm">
  <option timestep="0.002" solver="Newton" iterations="8" tolerance="0"/>
  <worldbody>
    <site name="anchor" pos="-0.05 0 1.25"/>
    <body name="upper" pos="0 0 1">
      <joint name="shoulder" type="hinge" axis="0 1 0" damping="0.1"/>
      <geom name="ug" type="capsule" fromto="0 0 0 0.3 0 0" size="0.03"
            mass="1"/>
      <geom name="pulleyg" type="sphere" pos="0.3 0 0.0" size="0.05"
            mass="0.05" contype="0" conaffinity="0"/>
      <site name="pside" pos="0.3 0 0.08"/>
      <body name="lower" pos="0.3 0 0">
        <joint name="elbow" type="hinge" axis="0 1 0" damping="0.05"
               range="-150 0" limited="true"/>
        <geom name="lg" type="capsule" fromto="0 0 0 0.25 0 0" size="0.025"
              mass="0.5"/>
        <site name="tip" pos="0.25 0 0.02"/>
      </body>
    </body>
  </worldbody>
  <tendon>
    <spatial name="string" stiffness="15" damping="0.5" springlength="0.45">
      <site site="anchor"/>
      <geom geom="pulleyg" sidesite="pside"/>
      <site site="tip"/>
    </spatial>
  </tendon>
  <actuator>
    <muscle name="pull" tendon="string" ctrlrange="0 1"
            lengthrange="0.3 0.7"/>
    <motor name="drive" joint="shoulder" gear="1" ctrlrange="-1 1"/>
  </actuator>
</mujoco>
"""

# bench.py:369-393: a four-bar linkage closed by a connect equality, with
# a joint-polynomial equality coupling its two grounded hinges
FOURBAR_XML = """
<mujoco>
  <option solver="Newton" iterations="10" tolerance="0"/>
  <worldbody>
    <geom name="floor" type="plane" size="5 5 .1"/>
    <body pos="0 0 1">
      <joint name="a1" type="hinge" axis="0 1 0" damping="0.1"/>
      <geom type="capsule" fromto="0 0 0 0.4 0 0" size="0.03" mass="0.5"/>
      <body name="link2" pos="0.4 0 0">
        <joint name="a2" type="hinge" axis="0 1 0" damping="0.1"/>
        <geom type="capsule" fromto="0 0 0 0.4 0 0" size="0.03" mass="0.5"/>
      </body>
    </body>
    <body name="anchor" pos="0.8 0 1">
      <joint name="b1" type="hinge" axis="0 1 0" damping="0.05"/>
      <geom type="sphere" size="0.05" mass="0.3" contype="0" conaffinity="0"/>
    </body>
  </worldbody>
  <equality>
    <connect body1="link2" body2="anchor" anchor="0.4 0 0"/>
    <joint joint1="a1" joint2="b1" polycoef="0 0.5 0.1 0 0"/>
  </equality>
  <actuator><motor joint="a1" gear="1"/></actuator>
</mujoco>
"""


# bench.py:398-410: <composite type="cable">, six capsules on six ball
# joints (nq 24, nv 18), with a motor on the root ball joint
CABLE_XML = """
<mujoco>
  <option solver="Newton" iterations="8" tolerance="0"/>
  <worldbody>
    <composite type="cable" count="7" curve="s" size="0.7" offset="0 0 1"
               initial="ball">
      <geom type="capsule" size="0.012" density="900"/>
      <joint kind="main" damping="0.02" stiffness="0.3" armature="0.001"/>
    </composite>
  </worldbody>
  <actuator><motor joint="J_first" gear="0.4 0.2 0"/></actuator>
</mujoco>
"""


class BenchTask:
    """Minimal kernel-eligible task of the synthetic configs
    (``bench.py:275-308``): observation on raw coordinates, reward
    clip(qvel[0], 0, 1), uniform reset noise of 0.05 on every qpos, the
    quaternion coordinates of ball and free joints included."""

    discount = 1.0
    time_limit = 10.0

    def init_episode(self, model: Model, data: Data,
                     generator: torch.Generator) -> Data:
        qpos = data.qpos
        noise = 0.05 * uniform(generator, -1.0, 1.0, qpos.shape, qpos.dtype,
                               qpos.device)
        return data.replace(qpos=qpos + noise)

    def observe(self, model: Model, data: Data) -> torch.Tensor:
        return torch.cat([data.qpos, data.qvel], -1)

    def reward(self, model: Model, data: Data, obs, action):
        return torch.clamp(data.qvel[:, 0], 0.0, 1.0)

    def done(self, model: Model, data: Data, obs):
        return time_limit_done(data, self.time_limit)

    def kernel_hooks(self, model: Model):
        from .ops.megakernel import EnvHooks

        return EnvHooks(
            reward=lambda bk, q, v, c: bk.clip(v[0], 0.0, 1.0),
            time_limit=self.time_limit,
            reset_noise=0.05,
            observe=lambda bk, q, v: list(q) + list(v),
            n_obs=model.nq + model.nv,
        )


def cheetah_run_elliptic(dtype=np.float32):
    """(model, task): cheetah run with ``opt.cone = ELLIPTIC``
    (condim 3, impratio 1), as ``bench.py:426-433`` builds it."""
    from .suite import cheetah

    model, task = cheetah.run(dtype=dtype)
    return model.replace(opt=dataclasses.replace(
        model.opt, cone=ConeType.ELLIPTIC)), task


# bench.py:440-453: the knee coupler (a fixed tendon with friction loss)
# and gyro, accelerometer, velocimeter and framepos on the torso site
WALKER_TENDON_SENSORS = """
  <tendon>
    <fixed name="knee_coupler" frictionloss="0.05">
      <joint joint="left_knee" coef="0.5"/>
      <joint joint="right_knee" coef="-0.5"/>
    </fixed>
  </tendon>
  <sensor>
    <gyro site="torso_site"/>
    <accelerometer site="torso_site"/>
    <velocimeter site="torso_site"/>
    <framepos objtype="site" objname="torso_site"/>
  </sensor>
</mujoco>"""


def walker_walk_tendon_sensors(dtype=np.float32):
    """(model, task): walker walk with ``WALKER_TENDON_SENSORS``, the
    task observing the sensors through ``SensorObsWrapper``
    (``bench.py:435-468``)."""
    from .suite import walker

    with open(asset_path("walker")) as f:
        xml = f.read().replace("</mujoco>", WALKER_TENDON_SENSORS)
    model = load_model_from_xml(xml, dtype=dtype)
    _, task = walker.walk(model=model)
    return model, SensorObsWrapper(task)


def _bench_task(xml):
    return lambda dtype: (load_model_from_xml(xml, dtype=dtype), BenchTask())


# (model, task) builders by (domain, task); the XML configs run the bench
# task
CONFIGS = {
    ("arm", "muscle-wrap"): _bench_task(MUSCLE_WRAP_XML),
    ("fourbar", "equality"): _bench_task(FOURBAR_XML),
    ("arms", "self-collide"): _bench_task(ARMS_XML),
    ("cable", "swing"): _bench_task(CABLE_XML),
    ("cheetah", "run-elliptic"): cheetah_run_elliptic,
    ("walker", "walk-tendon-sensors"): walker_walk_tendon_sensors,
}


def load_config(domain: str, task: str, batch: int, dtype=np.float32,
                device=None) -> BatchedEnvironment:
    """A BatchedEnvironment of one of this module's configs, on ``device``
    (None: the current CUDA device; raises without one)."""
    if (domain, task) not in CONFIGS:
        raise ValueError(f"unknown bench config {domain}/{task}; available: "
                         + ", ".join("/".join(k) for k in CONFIGS))
    model, task_obj = CONFIGS[domain, task](dtype)
    tdtype = torch.from_numpy(np.zeros(0, dtype=dtype)).dtype
    return BatchedEnvironment(model, task_obj, batch, device=device,
                              dtype=tdtype)
