"""Smoke run of the PyTorch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Drives the port's main path -- ``FastRollout`` through the hand-written
CUDA rollout kernel on thirteen rows: cheetah-run@4096 and
cheetah-run-push@4096 (``FastRollout(applied_forces=True)``, a per-env
push on the torso drawn before each call), walker-walk@4096 (K = 200),
cartpole-swingup@1024 (K = 200, RK4),
arm-muscle-wrap@4096, fourbar-equality@4096 (connect and joint
equalities, eq_active lanes), arms-self-collide@4096 (capsule and sphere
pairs) and cable-swing@4096 (six ball joints, reset noise on every
quaternion coordinate), all K = 200 from
``oxide_control_torch.bench_configs``, cheetah-run-elliptic@4096 (K = 50,
elliptic cones), humanoid-run@8192 (K = 100, free root joint) with
uniform ctrl, and the in-kernel (64, 64) policy collecting trajectories
on cheetah (K = 200), humanoid (K = 100) and walker-walk-tendon-sensors@4096
(K = 50: the policy reads gyro, accelerometer, velocimeter and framepos
rows computed in the kernel, the accelerometer from the carried stage-1
qacc) -- after building every kernel from the sources in this checkout
and holding each against its plain PyTorch version.
Phases, each fatal on failure:

1. device: the card's name and power limit;
2. build: nvcc for sm_90a, one process per distinct source, all started
   at once in the background (seconds, emitted lines, registers, stack,
   spills of each);
3. Philox: the Random123 known-answer vectors, computed on the card;
4. plain: the plain version of every parity mode, run on the card while
   nvcc works;
5. parity: the kernel on the same inputs, through resets, against the
   plain version's outputs (bars below; every output is expected to be
   bit-identical, and a mode that is not fails), and each main-path row's
   kernel timed on its own parity inputs, plus the FMA-contracted cheetah
   build (the price of bit-exact parity) and the one-lane (G = 1) builds
   of cheetah-run, humanoid-run and humanoid-run-policy-obs, timed in
   turns with the rows' team builds;
6. main path: 1 warm-up + 10 timed calls of each row (CUDA events), with
   the kernel's launch count set to 0 before and read after those calls;
   then, outside the count, cheetah-run-push's push check: from one reset
   state and one generator state, one call pushed and one not, and the
   pushed envs must end displaced along their push;
7. the kernels line (JSON) and the last line (JSON).

Parity runs each main-path row at its own B and K; models without a
bench row at K = 200: pendulum-swingup@1024, walker-walk-tendon@4096
(walker with a fixed knee tendon carrying friction loss),
stateful-actuators@1024 (filter, filterexact and integrator actuators),
fourbar eq-toggle@4096 (the connect off on every other env through
eq_active), weld@1024, tendon-equality@1024, box-pairs@1024,
plane-box-cyl-ellipsoid@1024, box-stack@1024 (box-box SAT),
ball-limit-spring@1024, ball-free-actuators@1024, weld-ball@1024,
condim46@1024 (pyramidal torsional and rolling friction),
elliptic-condim4@1024 and elliptic-condim6@1024, sensors-all@1024
(a ball joint, every sensor type of the kernel family, observed and
collected), fluid-forces@1024 (density, viscosity and wind),
mocap-weld@1024 (per-env mocap poses and eq_active rows) and
applied-forces@1024 (per-env qfrc and xfrc on every body); and the two
options off the main path (exploration noise, Gaussian reset noise) at
K = 24.

Every kernel source is built at its team size G (``megakernel.team_rule``:
G lanes of one warp run one env, splitting the line search's row sums and
the MLP's outputs), and the plain version follows the same summation
order, so the two agree bit for bit at every G.

Needs one CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from oxide_control_torch import bench_configs, convert, suite
from oxide_control_torch.api.environment import BatchedEnvironment
from oxide_control_torch.mjcf.compile import load_model_from_xml
from oxide_control_torch.model import JointType
from oxide_control_torch.ops import megakernel as mk
from oxide_control_torch.parallel.rollout import FastRollout, mocap_rest_pose
from oxide_control_torch.policy import MLPPolicy
from oxide_control_torch.suite import walker
from oxide_control_torch.suite.common import SensorObsWrapper, asset_path

# two parity models without a bench row.  Filter, filterexact
# (act-limited) and integrator actuators on a two-link arm over a floor
# (tests/test_scalar_graph.py:184-205), run with the bench task:
STATEFUL_XML = """
    <mujoco>
      <option solver="Newton" iterations="4" tolerance="0"/>
      <worldbody>
        <geom name="floor" type="plane" size="5 5 .1"/>
        <body pos="0 0 0.5">
          <joint name="h1" type="hinge" axis="0 1 0"/>
          <geom type="capsule" fromto="0 0 0 0.3 0 0" size="0.04" mass="1"/>
          <body pos="0.3 0 0">
            <joint name="h2" type="hinge" axis="0 1 0" damping="0.2"/>
            <geom name="tip" type="sphere" size="0.05" mass="0.3"/>
          </body>
        </body>
      </worldbody>
      <actuator>
        <general joint="h1" dyntype="filter" dynprm="0.1" gainprm="4"/>
        <general joint="h2" dyntype="filterexact" dynprm="0.05" gainprm="2"
                 actrange="-0.5 0.5" actlimited="true"/>
        <general joint="h2" dyntype="integrator" gainprm="1"/>
      </actuator>
    </mujoco>
    """
# and walker-walk with bench.py:441-446's knee coupler, a fixed tendon with
# friction loss (the bench row's sensors are left out: they wait for
# in-kernel sensors, ROADMAP Queue A item 10.7)
WALKER_TENDON = """
  <tendon>
    <fixed name="knee_coupler" frictionloss="0.05">
      <joint joint="left_knee" coef="0.5"/>
      <joint joint="right_knee" coef="-0.5"/>
    </fixed>
  </tendon>
</mujoco>"""


# parity models of the equality and narrowphase pairs, run with the bench
# task without reset noise on quaternions: the reference tests' models
# (tests/test_scalar_graph.py:318-339, the weld, here with the blob on a
# free joint; WELD_BALL_XML below has the reference's ball joint; :703-732,
# :387-419, :740-785 and :926-957)
WELD_XML = """
    <mujoco>
      <option solver="Newton" iterations="10" tolerance="0"/>
      <worldbody>
        <body pos="0 0 1">
          <joint name="a1" type="hinge" axis="0 1 0" damping="0.1"/>
          <geom type="capsule" fromto="0 0 0 0.3 0 0" size="0.03" mass="0.5"/>
          <body name="tip" pos="0.3 0 0">
            <joint name="a2" type="hinge" axis="1 0 0" damping="0.1"/>
            <geom type="sphere" size="0.04" mass="0.2"/>
          </body>
        </body>
        <body name="blob" pos="0.3 0 1">
          <freejoint/>
          <geom type="sphere" size="0.05" mass="0.3" contype="0"
                conaffinity="0"/>
        </body>
      </worldbody>
      <equality><weld body1="tip" body2="blob"/></equality>
      <actuator><motor joint="a1" gear="1"/></actuator>
    </mujoco>
    """
TENDON_EQ_XML = """
    <mujoco>
      <option solver="Newton" iterations="10" tolerance="0"/>
      <worldbody>
        <geom name="floor" type="plane" size="5 5 .1"/>
        <body pos="0 0 0.6">
          <joint name="h1" type="hinge" axis="0 1 0" damping="0.1"/>
          <geom type="capsule" fromto="0 0 0 0.3 0 0" size="0.04" mass="1"/>
          <body pos="0.3 0 0">
            <joint name="h2" type="hinge" axis="0 1 0" damping="0.1"/>
            <geom type="sphere" size="0.05" mass="0.4"/>
          </body>
        </body>
        <body pos="0.8 0 0.6">
          <joint name="h3" type="hinge" axis="0 1 0" damping="0.05"/>
          <geom type="capsule" fromto="0 0 0 0.2 0 0" size="0.03"
                mass="0.5"/>
        </body>
      </worldbody>
      <tendon>
        <fixed name="tA">
          <joint joint="h1" coef="0.7"/><joint joint="h2" coef="-0.4"/>
        </fixed>
        <fixed name="tB"><joint joint="h3" coef="1.0"/></fixed>
      </tendon>
      <equality>
        <tendon tendon1="tA" tendon2="tB" polycoef="0 0.8 0.2 0 0"/>
      </equality>
      <actuator><motor joint="h1" gear="1"/></actuator>
    </mujoco>
    """
BOX_PAIRS_XML = """
    <mujoco>
      <option solver="Newton" iterations="8" tolerance="0"/>
      <worldbody>
        <body name="obstacle" pos="0.3 0 0.18">
          <joint name="bz" type="slide" axis="0 0 1" damping="0.5"/>
          <geom name="block" type="box" size="0.12 0.2 0.12" mass="2"/>
        </body>
        <body pos="0 0 0.42">
          <joint name="s1" type="hinge" axis="0 1 0" damping="0.05"/>
          <geom name="arm" type="capsule" fromto="0 0 0 0.4 0 0"
                size="0.05" mass="1"/>
          <geom name="tip" type="sphere" pos="0.47 0 0" size="0.06"
                mass="0.2"/>
        </body>
      </worldbody>
      <actuator><motor joint="s1" gear="2"/></actuator>
    </mujoco>
    """
PLANE_SHAPES_XML = """
    <mujoco>
      <option solver="Newton" iterations="10" tolerance="0"/>
      <worldbody>
        <geom name="floor" type="plane" size="5 5 .1" contype="1"
              conaffinity="2"/>
        <body pos="0 0 0.35">
          <joint name="h1" type="hinge" axis="0 1 0" damping="0.1"/>
          <joint name="s1" type="slide" axis="0 0 1" damping="0.1"/>
          <geom name="bx" type="box" size="0.12 0.1 0.08" mass="1"
                contype="2" conaffinity="1"/>
        </body>
        <body pos="0.6 0 0.3">
          <joint name="h2" type="hinge" axis="1 0 0" damping="0.1"/>
          <geom name="cyl" type="cylinder" size="0.08 0.12" mass="0.5"
                contype="2" conaffinity="1"/>
        </body>
        <body pos="1.2 0 0.3">
          <joint name="h3" type="hinge" axis="0 1 0" damping="0.1"/>
          <geom name="ell" type="ellipsoid" size="0.12 0.09 0.06"
                mass="0.4" contype="2" conaffinity="1"/>
        </body>
      </worldbody>
      <actuator>
        <motor joint="h1" gear="2"/><motor joint="h2" gear="2"/>
        <motor joint="h3" gear="2"/>
      </actuator>
    </mujoco>
    """
BOX_STACK_XML = """
    <mujoco>
      <option timestep="0.005" solver="Newton" iterations="12"
              tolerance="0"/>
      <worldbody>
        <geom name="floor" type="plane" size="5 5 .1"/>
        <body name="b1" pos="0 0 0.1">
          <freejoint/>
          <geom name="g1" type="box" size="0.1 0.12 0.1" mass="1"/>
        </body>
        <body name="b2" pos="0.03 0.02 0.31">
          <freejoint/>
          <geom name="g2" type="box" size="0.08 0.07 0.1" mass="0.6"/>
        </body>
      </worldbody>
    </mujoco>
    """

# parity models of ball joints, condim 4/6 and elliptic cones, run with the
# bench task (reset noise on every coordinate, quaternions included): the
# reference tests' models (tests/test_scalar_graph.py:641-697, a limited,
# sprung ball wrist under a hinge; :987-1040, actuators on a ball and a
# free joint; :318-339, the weld to a ball-jointed blob; :786-812, condim
# 4 and 6 pyramids; :1043-1074, elliptic cones at condim 4 and 6)
BALL_LIMIT_XML = """
    <mujoco>
      <option solver="Newton" iterations="8" tolerance="0"/>
      <worldbody>
        <geom name="floor" type="plane" size="5 5 .1"/>
        <body pos="0 0 0.8">
          <joint name="root" type="hinge" axis="0 1 0" damping="0.2"/>
          <geom type="capsule" fromto="0 0 0 0.25 0 0" size="0.04" mass="1"/>
          <body pos="0.25 0 0">
            <joint name="wrist" type="ball" damping="0.05" stiffness="1.5"
                   limited="true" range="0 50"/>
            <geom type="sphere" size="0.05" mass="0.3"/>
          </body>
        </body>
      </worldbody>
      <actuator><motor joint="root" gear="2"/></actuator>
    </mujoco>
    """
BALL_FREE_XML = """
    <mujoco>
      <option timestep="0.002" solver="Newton" iterations="6" tolerance="0"/>
      <worldbody>
        <body pos="0 0 1">
          <joint name="b" type="ball" damping="0.05"/>
          <geom type="capsule" fromto="0 0 0 0.3 0 0" size="0.03" mass="0.5"/>
        </body>
        <body pos="1 0 1">
          <joint name="f" type="free"/>
          <geom type="box" size="0.1 0.08 0.06" mass="1" pos="0.02 0 0"/>
        </body>
      </worldbody>
      <actuator>
        <motor joint="b" gear="1 0.5 0.2"/>
        <general joint="b" gear="0.3 1 0" biastype="affine"
                 biasprm="0 -2 -0.1"/>
        <motor joint="f" gear="0 0 4 0 0 0.5"/>
        <motor joint="f" gear="1 0 0 0.3 0 0"/>
      </actuator>
    </mujoco>
    """
WELD_BALL_XML = WELD_XML.replace(
    "<freejoint/>", '<joint type="ball" damping="0.05"/>')
CONDIM46_XML = """
    <mujoco>
      <option solver="Newton" iterations="10" tolerance="0"/>
      <worldbody>
        <geom name="floor" type="plane" size="5 5 .1"/>
        <body pos="0 0 0.12">
          <freejoint/>
          <geom type="sphere" size="0.12" mass="1" condim="6"
                friction="1 0.02 0.005"/>
        </body>
        <body pos="0.5 0 0.1">
          <freejoint/>
          <geom type="sphere" size="0.1" mass="0.5" condim="4"
                friction="0.8 0.05"/>
        </body>
      </worldbody>
    </mujoco>
    """
ELLIPTIC_XML = """
        <mujoco>
          <option timestep="0.002" solver="Newton" iterations="8"
                  tolerance="0" cone="elliptic" impratio="1.3"/>
          <worldbody>
            <geom name="floor" type="plane" size="5 5 .1"
                  friction="{fric}" condim="{condim}"/>
            <body pos="0 0 0.12">
              <freejoint/>
              <geom type="box" size="0.1 0.08 0.12" mass="0.6"
                    friction="{fric}" condim="{condim}"/>
            </body>
            <body pos="0.4 0 0.08">
              <freejoint/>
              <geom type="sphere" size="0.08" mass="0.3"
                    friction="{fric}" condim="{condim}"/>
            </body>
          </worldbody>
        </mujoco>
        """
ELLIPTIC4_XML = ELLIPTIC_XML.format(condim=4, fric="1 0.01 0.0001")
ELLIPTIC6_XML = ELLIPTIC_XML.format(condim=6, fric="1 0.008 0.002")

# the sensor parity model: every sensor type of the kernel family (frame
# sensors on sites, bodies, xbodies and geoms, with and without a
# reference frame; ball quaternion and angular velocity; tendon and
# actuator position and velocity, one actuator on the tendon; cutoffs on
# the gyro and the accelerometer) on a slide-hinge torso with a ball-
# jointed arm and a hinged hand, the torso's sphere on a floor; Euler
# (tests/test_torch_sensors.py steps it under RK4 too)
SENSORS_ALL_XML = """
<mujoco>
  <option timestep="0.005" solver="Newton" iterations="4" tolerance="0"/>
  <worldbody>
    <geom name="floor" type="plane" size="5 5 .1"/>
    <body name="torso" pos="0 0 0.6">
      <joint name="z" type="slide" axis="0 0 1" damping="0.1"/>
      <joint name="tilt" type="hinge" axis="0 1 0" range="-1 1"
             limited="true" damping="0.05"/>
      <geom name="core" type="sphere" size="0.12" mass="1"/>
      <site name="imu" pos="0.05 0 0.08" euler="0 20 10"/>
      <body name="arm" pos="0.15 0 0" euler="0 0 30">
        <joint name="shoulder" type="ball" damping="0.05" stiffness="0.5"/>
        <geom name="limb" type="capsule" fromto="0 0 0 0.25 0 0" size="0.04"
              mass="0.4" contype="0" conaffinity="0"/>
        <site name="tip" pos="0.25 0 0" euler="15 0 0"/>
        <body name="hand" pos="0.25 0 0">
          <joint name="wrist" type="hinge" axis="0 0 1" damping="0.02"/>
          <geom name="fist" type="box" size="0.05 0.03 0.02" pos="0.05 0 0"
                euler="10 20 30" mass="0.1" contype="0" conaffinity="0"/>
        </body>
      </body>
    </body>
  </worldbody>
  <tendon>
    <fixed name="coupler">
      <joint joint="tilt" coef="0.7"/>
      <joint joint="wrist" coef="-0.3"/>
    </fixed>
  </tendon>
  <actuator>
    <motor name="lift" joint="z" gear="10"/>
    <motor name="twist" joint="shoulder" gear="0.3 1 0.2"/>
    <motor name="pull" tendon="coupler" gear="2"/>
  </actuator>
  <sensor>
    <jointpos joint="tilt"/>
    <jointvel joint="wrist"/>
    <tendonpos tendon="coupler"/>
    <tendonvel tendon="coupler"/>
    <actuatorpos actuator="twist"/>
    <actuatorvel actuator="lift"/>
    <actuatorpos actuator="pull"/>
    <actuatorvel actuator="pull"/>
    <ballquat joint="shoulder"/>
    <ballangvel joint="shoulder"/>
    <framepos objtype="site" objname="tip"/>
    <framepos objtype="geom" objname="fist" reftype="body" refname="arm"/>
    <framequat objtype="body" objname="hand"/>
    <framequat objtype="geom" objname="fist" reftype="site" refname="imu"/>
    <framexaxis objtype="xbody" objname="arm"/>
    <frameyaxis objtype="site" objname="tip" reftype="xbody"
                refname="torso"/>
    <framezaxis objtype="geom" objname="limb"/>
    <framelinvel objtype="site" objname="tip"/>
    <framelinvel objtype="body" objname="hand" reftype="geom"
                 refname="core"/>
    <frameangvel objtype="geom" objname="fist"/>
    <frameangvel objtype="xbody" objname="hand" reftype="site"
                 refname="imu"/>
    <framelinacc objtype="site" objname="tip"/>
    <frameangacc objtype="body" objname="hand"/>
    <gyro site="imu" cutoff="1"/>
    <velocimeter site="tip"/>
    <accelerometer site="imu" cutoff="30"/>
    <magnetometer site="imu"/>
    <subtreecom body="arm"/>
    <clock/>
  </sensor>
</mujoco>
"""

# the fluid, mocap and applied-force parity models, run with the bench
# task (reset noise on every coordinate): the reference tests' models
# (tests/test_scalar_graph.py:959-985, :1075-1099 and :1158-1180)
FLUID_XML = """
    <mujoco>
      <option timestep="0.002" solver="Newton" iterations="8"
              tolerance="0" density="1.2" viscosity="0.02" wind="0.5 -0.3 0.1"/>
      <worldbody>
        <geom name="floor" type="plane" size="5 5 .1"/>
        <body pos="0 0 1">
          <freejoint/>
          <geom type="box" size="0.1 0.15 0.05" mass="0.4"/>
        </body>
        <body pos="0.5 0 0.6">
          <joint type="hinge" axis="0 1 0" damping="0.01"/>
          <geom type="capsule" fromto="0 0 0 0.3 0 0" size="0.03"
                mass="0.3"/>
        </body>
      </worldbody>
    </mujoco>
    """
MOCAP_WELD_XML = """
    <mujoco>
      <option timestep="0.002" solver="Newton" iterations="6" tolerance="0"/>
      <worldbody>
        <geom name="floor" type="plane" size="5 5 .1"/>
        <body name="target" mocap="true" pos="0.3 0 0.4">
          <geom type="box" size="0.1 0.1 0.02" contype="0" conaffinity="0"/>
        </body>
        <body name="box" pos="0 0 0.3">
          <freejoint/>
          <geom type="box" size="0.06 0.05 0.04" mass="0.5"/>
        </body>
      </worldbody>
      <equality>
        <weld body1="box" body2="target"/>
        <connect body1="box" body2="target" anchor="0 0 0" active="false"/>
      </equality>
    </mujoco>
    """
APPLIED_XML = """
    <mujoco>
      <option timestep="0.002" solver="Newton" iterations="6" tolerance="0"/>
      <worldbody>
        <geom name="floor" type="plane" size="5 5 .1"/>
        <body pos="0 0 0.3">
          <freejoint/>
          <geom type="box" size="0.06 0.05 0.04" mass="0.5"/>
          <body pos="0.1 0 0">
            <joint type="hinge" axis="0 1 0" damping="0.01"/>
            <geom type="capsule" fromto="0 0 0 0.15 0 0" size="0.02"
                  mass="0.1"/>
          </body>
        </body>
      </worldbody>
    </mujoco>
    """


class QuatSafeBenchTask(bench_configs.BenchTask):
    """The bench task without reset noise on quaternion coordinates (a
    free joint's orientation resets to qpos0's)."""

    def _mask(self, model):
        mask = [1.0] * model.nq
        for j in range(model.njnt):
            if model.jnt_type[j] == JointType.FREE:
                adr = model.jnt_qposadr[j]
                mask[adr + 3:adr + 7] = [0.0] * 4
        return mask

    def init_episode(self, model, data, generator):
        out = super().init_episode(model, data, generator)
        m = torch.tensor(self._mask(model), dtype=data.qpos.dtype,
                         device=data.qpos.device)
        return out.replace(qpos=data.qpos + m * (out.qpos - data.qpos))

    def kernel_hooks(self, model):
        return dataclasses.replace(super().kernel_hooks(model),
                                   reset_mask=self._mask(model))


def bench_env(xml, batch, device=None):
    return BatchedEnvironment(load_model_from_xml(xml, np.float32),
                              QuatSafeBenchTask(), batch, device=device)


def ball_env(xml, batch, device=None):
    """The bench task itself, reset noise on quaternions included."""
    return BatchedEnvironment(load_model_from_xml(xml, np.float32),
                              bench_configs.BenchTask(), batch,
                              device=device)


def sensors_env(xml, batch, device=None):
    """The bench task observing the model's sensors as well, reset noise
    on quaternions included."""
    return BatchedEnvironment(load_model_from_xml(xml, np.float32),
                              SensorObsWrapper(bench_configs.BenchTask()),
                              batch, device=device)


def walker_tendon_env(batch, device=None):
    with open(asset_path("walker")) as f:
        xml = f.read().replace("</mujoco>", WALKER_TENDON)
    model, task = walker.walk(model=load_model_from_xml(xml, np.float32))
    return BatchedEnvironment(model, task, batch, device=device)


def stateful_env(batch, device=None):
    return bench_env(STATEFUL_XML, batch, device)


# the environments at their batches (the reference bench's, bench.py:67-98)
ENVS = {
    "cheetah/run": lambda: suite.load_batched("cheetah", "run", 4096),
    "walker/walk": lambda: suite.load_batched("walker", "walk", 4096),
    "cartpole/swingup": lambda: suite.load_batched("cartpole", "swingup",
                                                   1024),
    "pendulum/swingup": lambda: suite.load_batched("pendulum", "swingup",
                                                   1024),
    "humanoid/run": lambda: suite.load_batched("humanoid", "run", 8192),
    "arm/muscle-wrap": lambda: bench_configs.load_config("arm", "muscle-wrap",
                                                         4096),
    "fourbar/equality": lambda: bench_configs.load_config(
        "fourbar", "equality", 4096),
    "arms/self-collide": lambda: bench_configs.load_config(
        "arms", "self-collide", 4096),
    "walker/walk-tendon": lambda: walker_tendon_env(4096),
    "stateful/actuators": lambda: stateful_env(1024),
    "weld": lambda: bench_env(WELD_XML, 1024),
    "tendon-equality": lambda: bench_env(TENDON_EQ_XML, 1024),
    "box-pairs": lambda: bench_env(BOX_PAIRS_XML, 1024),
    "plane-shapes": lambda: bench_env(PLANE_SHAPES_XML, 1024),
    "box-stack": lambda: bench_env(BOX_STACK_XML, 1024),
    "cable/swing": lambda: bench_configs.load_config("cable", "swing", 4096),
    "cheetah/run-elliptic": lambda: bench_configs.load_config(
        "cheetah", "run-elliptic", 4096),
    "ball-limit-spring": lambda: ball_env(BALL_LIMIT_XML, 1024),
    "ball-free-actuators": lambda: ball_env(BALL_FREE_XML, 1024),
    "weld-ball": lambda: ball_env(WELD_BALL_XML, 1024),
    "condim46": lambda: ball_env(CONDIM46_XML, 1024),
    "elliptic-condim4": lambda: ball_env(ELLIPTIC4_XML, 1024),
    "elliptic-condim6": lambda: ball_env(ELLIPTIC6_XML, 1024),
    "walker/walk-tendon-sensors": lambda: bench_configs.load_config(
        "walker", "walk-tendon-sensors", 4096),
    "sensors-all": lambda: sensors_env(SENSORS_ALL_XML, 1024),
    "fluid-forces": lambda: ball_env(FLUID_XML, 1024),
    "mocap-weld": lambda: ball_env(MOCAP_WELD_XML, 1024),
    "applied-forces": lambda: ball_env(APPLIED_XML, 1024),
}
# the main path's rows: (name, task, K, in-kernel policy + collection,
# applied forces: a per-env push drawn before each call)
ROWS = (
    ("cheetah-run@4096", "cheetah/run", 200, False, False),
    ("cheetah-run-push@4096", "cheetah/run", 200, False, True),
    ("run-policy-obs@4096", "cheetah/run", 200, True, False),
    ("walker-walk@4096", "walker/walk", 200, False, False),
    ("cartpole-swingup@1024", "cartpole/swingup", 200, False, False),
    ("arm-muscle-wrap@4096", "arm/muscle-wrap", 200, False, False),
    ("fourbar-equality@4096", "fourbar/equality", 200, False, False),
    ("arms-self-collide@4096", "arms/self-collide", 200, False, False),
    ("cable-swing@4096", "cable/swing", 200, False, False),
    ("cheetah-run-elliptic@4096", "cheetah/run-elliptic", 50, False, False),
    ("walker-walk-tendon-sensors@4096", "walker/walk-tendon-sensors", 50,
     True, False),
    ("humanoid-run@8192", "humanoid/run", 100, False, False),
    ("humanoid-run-policy-obs@8192", "humanoid/run", 100, True, False),
)
# parity modes beside the rows (each row is a mode at its own B and K):
# (label, task, K, variant)
EXTRA_MODES = (
    ("pendulum-swingup@1024", "pendulum/swingup", 200, "ctrl"),
    ("walker-walk-tendon@4096", "walker/walk-tendon", 200, "ctrl"),
    ("stateful-actuators@1024", "stateful/actuators", 200, "ctrl"),
    # the connect off on every other env through eq_active
    ("fourbar eq-toggle@4096", "fourbar/equality", 200, "toggle"),
    ("weld@1024", "weld", 200, "ctrl"),
    ("tendon-equality@1024", "tendon-equality", 200, "ctrl"),
    ("box-pairs@1024", "box-pairs", 200, "ctrl"),
    ("plane-box-cyl-ellipsoid@1024", "plane-shapes", 200, "ctrl"),
    ("box-stack@1024", "box-stack", 200, "ctrl"),
    ("ball-limit-spring@1024", "ball-limit-spring", 200, "ctrl"),
    ("ball-free-actuators@1024", "ball-free-actuators", 200, "ctrl"),
    ("weld-ball@1024", "weld-ball", 200, "ctrl"),
    ("condim46@1024", "condim46", 200, "ctrl"),
    ("elliptic-condim4@1024", "elliptic-condim4", 200, "ctrl"),
    ("elliptic-condim6@1024", "elliptic-condim6", 200, "ctrl"),
    # ctrl input, the observation (the sensor rows) collected
    ("sensors-all@1024", "sensors-all", 200, "collect"),
    ("fluid-forces@1024", "fluid-forces", 200, "ctrl"),
    # per-env mocap poses and eq_active rows
    ("mocap-weld@1024", "mocap-weld", 200, "mocap"),
    # per-env qfrc and xfrc on every body
    ("applied-forces@1024", "applied-forces", 200, "applied"),
    ("cheetah explore", "cheetah/run", 24, "explore"),
    ("cheetah gaussian_reset", "cheetah/run", 24, "gauss"),
)
# the rows also timed at G = 1, in turns with their team builds
SOLO_ROWS = ("cheetah-run@4096", "humanoid-run@8192",
             "humanoid-run-policy-obs@8192")
N_TIMED = 10
# peaks of one H100 SXM (NVIDIA data sheet, 700 W): 67 TFLOP/s f32 counts
# an FMA as two, so 33.5e12 separate lane-ops/s; special functions at 16
# per SM per clock (132 SMs, 1.98 GHz boost); 3.35 TB/s of HBM
LANE_OPS_PER_S = 33.5e12
SFU_OPS_PER_S = 132 * 16 * 1.98e9
BYTES_PER_S = 3.35e12
BARS = dict(qpos=1e-4, qvel=1e-3, act=1e-4, qacc=1e-3, reward_sum=1e-4,
            obs=1e-4, ctrls=1e-5)
T0 = time.perf_counter()


def log(*args):
    print(f"[{time.perf_counter() - T0:7.1f} s]", *args, flush=True)


def device_phase():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"device: {name}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    log(smi)
    return name, smi


def start_builds(fns):
    """One thread per kernel object, all at once: one nvcc for each
    distinct source (threads of one source wait for it and load its
    library from build/).  Returns the pool and the futures."""
    pool = ThreadPoolExecutor(len(fns))
    return pool, {label: pool.submit(fn.build) for label, fn in fns.items()}


def finish_builds(pool, futures, t_start):
    built = {label: f.result() for label, f in futures.items()}
    pool.shutdown()
    log(f"build: all sources built {time.perf_counter() - t_start:.2f} s "
        "after the start of the build phase")
    seen = set()
    for label, b in built.items():
        if b.so_path in seen:
            continue
        seen.add(b.so_path)
        nvcc_s = max(x.seconds for x in built.values()
                     if x.so_path == b.so_path)
        log(f"  {label}: nvcc {nvcc_s:.2f} s, {b.emitted_lines} emitted "
            f"lines, {b.registers} registers, {b.stack_bytes} B stack, "
            f"{b.spill_stores} B spill stores, {b.spill_loads} B spill "
            f"loads; team G={b.team}, step {b.step_ops} lane-ops per lane "
            f"({b.step_sfu_ops} special-function; {b.work_step_ops} at "
            "G=1)")
    # each library with the seconds of the one thread that ran its nvcc
    return {label: dataclasses.replace(b, seconds=max(
        x.seconds for x in built.values() if x.so_path == b.so_path))
        for label, b in built.items()}


def philox_phase():
    dev = torch.device("cuda")
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    ones = zero + 0xFFFFFFFF
    got = [
        [int(x) for x in mk.philox4x32((zero,) * 4, (0, 0))],
        [int(x) for x in mk.philox4x32((ones,) * 4,
                                       (0xFFFFFFFF, 0xFFFFFFFF))],
    ]
    want = [[0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8],
            [0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd]]
    if got != want:
        raise AssertionError(f"Philox known-answer mismatch: {got}")
    log("philox: known-answer vectors match on the card")


def draw_push(model, b, gen):
    """cheetah-run-push's per-env push, held for one call: on the torso a
    force along x and z, each uniform in [-30, 30] N, and a torque about
    y uniform in [-5, 5] N m; qfrc_applied uniform in [-1, 1] on every
    dof.  Returns (qfrc_applied (B, nv), xfrc_applied (B, nbody, 6))."""
    u = lambda lo, hi, *shape: torch.empty(shape, device="cuda").uniform_(
        lo, hi, generator=gen)
    torso = model.name2id("body", "torso")
    xfrc = torch.zeros((b, model.nbody, 6), device="cuda")
    xfrc[:, torso, 0] = u(-30.0, 30.0, b)
    xfrc[:, torso, 2] = u(-30.0, 30.0, b)
    xfrc[:, torso, 4] = u(-5.0, 5.0, b)
    return u(-1.0, 1.0, b, model.nv), xfrc


def parity_inputs(benv, fn, variant, seed=7):
    """``(args, kw)`` of one call: a reset batch whose step counters are
    spread over the episode, so that some envs cross the time limit
    inside the window, with the call's ctrl or policy weights and, for a
    model with equality constraints, its eq_active rows (eq_active0; with
    ``toggle`` the first equality off on every other env; with ``mocap``
    cycling through (1,0), (1,1), (0,0), (0,1)).  ``mocap`` also poses
    the mocap bodies per env (within 0.1 of rest, unit quaternions),
    ``applied`` draws per-env qfrc in [-0.5, 0.5] and xfrc (force in
    [-1, 1] N, torque in [-0.1, 0.1] N m) on every body but the world, ``push`` draws cheetah-run-push's push.  A
    carried qacc starts uniform in [-1, 1), so the first step's
    accelerometer reads it."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = benv.model
    b = fn.batch
    data = benv.reset(gen)
    n0 = torch.randint(0, fn.spec.limit_n, (b,), generator=gen,
                       device="cuda")
    # activations start inside [0, 0.5), so the act path runs from step 0
    act = torch.zeros((fn.na_rows, b), device="cuda")
    if fn.spec.na:
        act.uniform_(0.0, 0.5, generator=gen)
    state = (data.qpos.T.contiguous(), data.qvel.T.contiguous(), act,
             data.qacc_warmstart.T.contiguous(),
             (n0.to(torch.float32) * fn.spec.h)[None].contiguous())
    if fn.spec.carry_qacc:
        qacc = torch.empty((fn.spec.nv, b), device="cuda")
        state += (qacc.uniform_(-1.0, 1.0, generator=gen),)
    ctrl = params = None
    if fn.policy is None:
        ctrl = torch.empty((fn.steps, fn.spec.nu, b), device="cuda")
        ctrl.uniform_(-1.0, 1.0, generator=gen)
    else:
        params = fn.policy.kernel_params()
    eq_active = None
    if fn.spec.neq:
        eq_active = torch.tensor(
            [float(x) for x in model.eq_active0],
            device="cuda")[:, None].repeat(1, b)
        if variant == "toggle":
            eq_active[0, 0::2] = 0.0
        if variant == "mocap":
            cycle = torch.tensor([[1.0, 0.0], [1.0, 1.0], [0.0, 0.0],
                                  [0.0, 1.0]], device="cuda")
            eq_active = cycle.repeat(b // 4, 1).T.contiguous()
    kw = {}
    if fn.spec.nmocap:
        nm = fn.spec.nmocap
        rest = torch.as_tensor(mocap_rest_pose(model)[0], device="cuda",
                               dtype=torch.float32)
        pos = rest + torch.empty((b, nm, 3), device="cuda").uniform_(
            -0.1, 0.1, generator=gen)
        quat = torch.empty((b, nm, 4), device="cuda").uniform_(
            -1.0, 1.0, generator=gen)
        quat = quat / quat.norm(dim=2, keepdim=True)
        kw["mocap"] = convert.mocap_to_kernel(pos, quat)
    if fn.spec.applied:
        if variant == "push":
            qfrc, xfrc = draw_push(model, b, gen)
        else:
            qfrc = torch.empty((b, model.nv), device="cuda").uniform_(
                -0.5, 0.5, generator=gen)
            xfrc = torch.empty((b, model.nbody, 6), device="cuda").uniform_(
                -1.0, 1.0, generator=gen)
            # torques within 0.1 N m: at 1 N m a third of the envs spin
            # up and diverge within the 200 steps
            xfrc[:, :, 3:] *= 0.1
            xfrc[:, 0] = 0.0
        kw.update(qfrc=qfrc.T.contiguous(), xfrc=convert.xfrc_to_kernel(xfrc))
    args = state + (ctrl, torch.tensor([20261016], dtype=torch.int32,
                                       device="cuda"), params, eq_active)
    return args, kw


def resets_of(fn, args, out):
    """Time-limit crossings of the call plus divergence resets."""
    n_in = torch.round(args[4][0] / fn.spec.h)
    return int(((n_in + fn.steps) // fn.spec.limit_n).sum()
               + out[fn.n_state + 1].sum())


def time_kernel(fn, args, kw):
    """ms per call of the kernel alone, 1 warm-up + N_TIMED calls between
    CUDA events; returns (ms, the warm-up's outputs)."""
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(N_TIMED):
        fn(*args, **kw)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / N_TIMED, out


def max_errors(fn, ko, po):
    ns = fn.n_state
    e = dict(qpos=ko[0] - po[0], qvel=ko[1] - po[1], act=ko[2] - po[2],
             reward_sum=ko[ns] - po[ns])
    if fn.spec.carry_qacc:
        e["qacc"] = ko[5] - po[5]
    if fn.emit_obs:
        e["obs"] = ko[ns + 2] - po[ns + 2]
        if fn.policy is not None:
            e["ctrls"] = ko[ns + 5] - po[ns + 5]
    return {k: float(x.abs().max()) for k, x in e.items()}


def plain_phase(modes):
    """The plain version of every parity mode, on the card, with the
    wall time of each call between synchronizes (the first call of each
    mode, so its CUDA-graph capture of the step is included)."""
    res = {}
    for label, (benv, fn, variant) in modes.items():
        args, kw = parity_inputs(benv, fn, variant)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        po = fn.plain(*args, **kw)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        res[label] = dict(args=args, kw=kw, out=po, plain_ms=plain_ms)
        log(f"plain {label} (B={fn.batch}, K={fn.steps}): {plain_ms:.1f} "
            "ms with the graph capture")
    return res


def parity_phase(modes, plain):
    """Kernel vs plain version on the card, one mode at a time."""
    res = {}
    for label, (benv, fn, _) in modes.items():
        args, po = plain[label]["args"], plain[label]["out"]
        ko = fn(*args, **plain[label]["kw"])
        torch.cuda.synchronize()
        me = max_errors(fn, ko, po)
        dones = fn.n_state + 4
        if fn.emit_obs and not torch.equal(ko[dones], po[dones]):
            raise AssertionError(f"{label}: dones differ")
        resets = resets_of(fn, args, ko)
        same = all(torch.equal(a, b) for a, b in zip(ko, po))
        log(f"parity {label} (B={fn.batch}, K={fn.steps}, {resets} "
            "resets): " + ", ".join(f"{k} {v:.3e} (bar {BARS[k]:g})"
                                    for k, v in me.items())
            + f"; every output bit-identical: {same}")
        if resets == 0:
            raise AssertionError(f"{label}: no env crossed the time limit")
        if not same:
            raise AssertionError(f"{label}: the kernel's outputs are not "
                                 "bit-identical to the plain version's")
        for k, v in me.items():
            if not v <= BARS[k]:
                raise AssertionError(f"{label}: {k} error {v} over "
                                     f"{BARS[k]}")
        res[label] = dict(errs=me, resets=resets, same=same)
    # eq-toggle: the envs whose connect is off leave the fourbar row's
    # trajectories (same inputs but eq_active)
    tog = plain["fourbar eq-toggle@4096"]["out"][0]
    row = plain["fourbar-equality@4096"]["out"][0]
    if torch.equal(tog[:, 0::2], row[:, 0::2]):
        raise AssertionError("fourbar eq-toggle: turning the connect off "
                             "changed no trajectory")
    log("fourbar eq-toggle: connect-off envs left the row's trajectories; "
        "connect-on envs bit-identical to the row's: "
        f"{torch.equal(tog[:, 1::2], row[:, 1::2])}")
    return res


def timing_phase(rolls, plain, fma, solo):
    """Each main-path row's kernel on its own parity inputs, the
    FMA-contracted cheetah build on the cheetah-run inputs, and the rows
    of ``solo`` at G = 1 in turns with their team builds (team, G = 1,
    G = 1, team: each row's ms is the mean of its two turns)."""
    res = {}
    for row, roll in rolls.items():
        kern, args = roll.kernel, plain[row]["args"]
        ms, out = time_kernel(kern, args, plain[row]["kw"])
        res[row] = dict(ms=ms, resets=resets_of(kern, args, out))
        if row in solo:
            one = solo[row]
            turns = [ms, time_kernel(one, args, plain[row]["kw"])[0],
                     time_kernel(one, args, plain[row]["kw"])[0],
                     time_kernel(kern, args, plain[row]["kw"])[0]]
            res[row].update(ms=(turns[0] + turns[3]) / 2,
                            ms_team1=(turns[1] + turns[2]) / 2,
                            turns=turns)
            log(f"  {row}: team G={kern.team} {turns[0]:.4f} / "
                f"{turns[3]:.4f} ms, G=1 {turns[1]:.4f} / {turns[2]:.4f} "
                f"ms: {res[row]['ms_team1'] / res[row]['ms']:.3f}x")
        log(f"kernel {row}: {res[row]['ms']:.4f} ms per call "
            f"({res[row]['resets']} resets)")
        if row == "cheetah-run@4096":
            fo = fma(*args)
            fma_ms, _ = time_kernel(fma, args, {})
            log(f"  FMA-contracted build (not on the path): {fma_ms:.4f} ms "
                f"per call against {ms:.4f}; drift from the plain version: "
                + ", ".join(f"{k} {v:.3e}" for k, v in max_errors(
                    fma, fo, plain[row]["out"]).items()))
    return res


def run_row(roll, state, gen):
    """One call of a row; a row with applied forces draws its push from
    the row's generator first."""
    if not roll.applied_forces:
        return roll.run(state, gen)
    qfrc, xfrc = draw_push(roll.benv.model, roll.benv.num_envs, gen)
    return roll.run(state, gen, qfrc_applied=qfrc, xfrc_applied=xfrc)


def push_check(roll):
    """From one reset state and one generator state, a call pushed and
    one not (ctrl and seed drawn alike): over the envs, the mean of
    sign(Fx) * (rootx pushed - rootx unpushed) must be positive (the
    reference's tests/test_megakernel.py:822-823 check).  No env resets
    in the call: cheetah's time limit is 1000 steps."""
    model, b = roll.benv.model, roll.benv.num_envs
    gen = torch.Generator(device="cuda").manual_seed(2)
    state = roll.init(gen)
    qfrc, xfrc = draw_push(model, b, gen)
    saved = gen.get_state()
    pushed, tp = roll.run(state, gen, qfrc_applied=qfrc, xfrc_applied=xfrc)
    gen.set_state(saved)
    free, tf = roll.run(state, gen)
    torch.cuda.synchronize()
    k = roll.steps_per_call
    n_end = torch.round(torch.cat([pushed[4], free[4]]) / model.opt.timestep)
    if not bool((n_end == k).all()) or float(tp.diverged.sum()
                                             + tf.diverged.sum()):
        raise AssertionError("push check: an env reset inside the call")
    fx = xfrc[:, model.name2id("body", "torso"), 0]
    rootx = model.jnt_qposadr[model.name2id("joint", "rootx")]
    effect = float((torch.sign(fx) * (pushed[0][rootx]
                                      - free[0][rootx])).mean())
    log(f"push check: mean sign(Fx) * (rootx pushed - rootx unpushed) = "
        f"{effect:.6f} m over {b} envs, {k} steps")
    if not effect > 0.0:
        raise AssertionError("push check: the push moved no env along it")
    return effect


def main_path_phase(rolls):
    """FastRollout rows at full size; launches counted around the run."""
    rows = {}
    for name, roll in rolls.items():
        b, k = roll.benv.num_envs, roll.steps_per_call
        gen = torch.Generator(device="cuda").manual_seed(1)
        state = roll.init(gen)
        roll.kernel.launches = 0
        state, traj = run_row(roll, state, gen)  # warm-up
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        rew = torch.zeros(b, device="cuda")
        ndiv = torch.zeros(b, device="cuda")
        for _ in range(N_TIMED):
            state, traj = run_row(roll, state, gen)
            rew += traj.reward_sum
            ndiv += traj.diverged
        end.record()
        torch.cuda.synchronize()
        launches = roll.kernel.launches
        ms = start.elapsed_time(end) / N_TIMED
        if launches != N_TIMED + 1:
            raise AssertionError(f"{name}: {launches} kernel launches, "
                                 f"want {N_TIMED + 1}")
        if not bool(torch.isfinite(rew).all()):
            raise AssertionError(f"{name}: non-finite reward sums")
        for t in state:
            if not bool(torch.isfinite(t).all()):
                raise AssertionError(f"{name}: non-finite state")
        # muscle activations relax toward the clamped ctrl in [0, 1]
        if roll.kernel.spec.na and not bool(
                ((state[2] >= -1e-6) & (state[2] <= 1.0 + 1e-6)).all()):
            raise AssertionError(f"{name}: activations left [0, 1]")
        if roll.collect:
            if (tuple(traj.obs.shape) != (k, roll.n_obs, b)
                    or tuple(traj.ctrls.shape)
                    != (k, roll.kernel.spec.nu, b)):
                raise AssertionError(f"{name}: trajectory shapes")
            if not bool(torch.isfinite(traj.obs).all()):
                raise AssertionError(f"{name}: non-finite observations")
        rate = b * k / (ms * 1e-3)
        rows[name] = dict(launches=launches, rate=rate)
        if roll.applied_forces:
            rows[name]["push_effect_m"] = push_check(roll)
        log(f"main path {name}: {rate:.6e} env-steps/s ({ms:.4f} ms per "
            f"call of {b}x{k}), {launches} launches, "
            f"{int(ndiv.sum())} divergences, mean reward "
            f"{float(rew.mean()) / (N_TIMED * k):.4f}")
    return rows


def warps_per_sm(fn, built):
    """Warps one SM runs in a call: the one-warp blocks of the batch's
    B * G lanes spread over the SMs, at most as many as an SM holds."""
    n_params = (sum(t.numel() for t in fn.policy.kernel_params())
                if fn.policy is not None else 0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return min(fn.batch * built.team / 32 / sms,
               built.occupancy(fn.policy is not None, n_params))


def bound(fn, built, resets):
    """Least time of one call on this card: the larger of the lane-op,
    special-function and byte times for this call's work.  The work is the
    one-lane (G = 1) step's: a team's redundant lanes are not counted."""
    s, b, k = fn.spec, fn.batch, fn.steps
    env_steps = b * k
    ops = env_steps * (built.work_step_ops + built.env_ops)
    sfu = env_steps * built.work_step_sfu_ops
    if fn.policy is not None:
        d = fn.dims
        macs = sum(d[i] * d[i + 1] for i in range(len(d) - 1))
        units = sum(d[1:])
        ops += env_steps * (2 * macs + 2 * units)
        sfu += env_steps * units  # tanh
    # each reset draws n_draws Philox values (~100 integer ops per 4) and
    # nq + nv Box-Muller normals
    ops += resets * (built.reset_ops + 25 * s.n_draws + 8 * (s.nq + s.nv))
    sfu += resets * 3 * (s.nq + s.nv)
    nbytes = 4 * b * (2 * (s.nq + 2 * s.nv + fn.na_rows + 1) + 2
                      + sum(mk.input_rows(s).values())
                      + (2 * s.nv if s.carry_qacc else 0))
    if fn.policy is None:
        nbytes += 4 * k * s.nu * b
    else:
        nbytes += 4 * sum(t.numel() for t in fn.policy.kernel_params())
    if fn.emit_obs:
        nbytes += 4 * k * b * (s.n_obs + 2 + (s.nu if fn.policy else 0))
    t_ops, t_sfu, t_bytes = (ops / LANE_OPS_PER_S, sfu / SFU_OPS_PER_S,
                             nbytes / BYTES_PER_S)
    by = "operations" if max(t_ops, t_sfu) >= t_bytes else "bytes"
    return 1e3 * max(t_ops, t_sfu, t_bytes), by, dict(
        lane_ops=ops, sfu_ops=sfu, bytes=nbytes, resets=resets)


def main():
    name, smi = device_phase()
    gen = torch.Generator(device="cuda").manual_seed(0)
    benvs = {key: make() for key, make in ENVS.items()}
    policies = {}
    for key in ("cheetah/run", "humanoid/run", "walker/walk-tendon-sensors"):
        model = benvs[key].model
        policies[key] = MLPPolicy(
            benvs[key].task.kernel_hooks(model).n_obs, model.nu,
            hidden=(64, 64), generator=gen)
    rolls = {row: FastRollout(benvs[key], k,
                              policy=policies[key] if pol else None,
                              collect=pol, applied_forces=push)
             for row, key, k, pol, push in ROWS}
    cheetah = benvs["cheetah/run"]
    hooks = cheetah.task.kernel_hooks(cheetah.model)
    explorer = MLPPolicy(hooks.n_obs, cheetah.model.nu, hidden=(64, 64),
                         explore_sigma=0.3, generator=gen)
    gauss = dataclasses.replace(hooks, reset_qpos_sigma=[0.0] * 3 + [0.05] * 6,
                                reset_qvel_sigma=0.1)
    modes = {row: (roll.benv, roll.kernel,
                   "push" if roll.applied_forces else "row")
             for row, roll in rolls.items()}
    for label, key, k, variant in EXTRA_MODES:
        benv = benvs[key]
        modes[label] = (benv, mk.build_rollout(
            benv.model, benv.num_envs, k,
            gauss if variant == "gauss"
            else benv.task.kernel_hooks(benv.model),
            emit_obs=variant in ("explore", "gauss", "collect"),
            policy=explorer if variant == "explore" else None,
            applied_forces=variant == "applied"), variant)
    fma = mk.build_rollout(cheetah.model, 4096, 200, hooks, fmad=True)
    # the one-lane builds the team builds are timed against
    solo = {row: mk.build_rollout(
        roll.benv.model, roll.benv.num_envs, roll.steps_per_call,
        roll.kernel.hooks, emit_obs=roll.collect, policy=roll.policy,
        team=1) for row, roll in rolls.items() if row in SOLO_ROWS}

    t_build = time.perf_counter()
    pool, futures = start_builds(
        {**{label: fn for label, (_, fn, _) in modes.items()}, "fmad": fma,
         **{f"{row} G=1": fn for row, fn in solo.items()}})
    philox_phase()
    t = time.perf_counter()
    plain = plain_phase(modes)
    log(f"phase plain: {time.perf_counter() - t:.1f} s")
    built = finish_builds(pool, futures, t_build)
    t = time.perf_counter()
    par = parity_phase(modes, plain)
    timed = timing_phase(rolls, plain, fma, solo)
    log(f"phase parity + timing: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    rows = main_path_phase(rolls)
    log(f"phase main path: {time.perf_counter() - t:.1f} s")

    kernels = []
    for row, roll in rolls.items():
        kern, b, p = roll.kernel, built[row], par[row]
        b_ms, by, work = bound(kern, b, timed[row]["resets"])
        solo_ms = ({"ms_team1": timed[row]["ms_team1"]}
                   if "ms_team1" in timed[row] else {})
        kernels.append(dict(
            name=f"rollout[{row}]", route="cuda",
            source="oxide_control_torch/ops/csrc/rollout.cu",
            replaces=mk.REPLACES, launches=rows[row]["launches"],
            max_abs_err=max(p["errs"].values()), ms=timed[row]["ms"],
            plain_ms=plain[row]["plain_ms"], bound_ms=b_ms, bound_by=by,
            library_ms=None, env_steps_per_s=rows[row]["rate"],
            bit_identical=p["same"], registers=b.registers,
            stack_bytes=b.stack_bytes, spill_stores=b.spill_stores,
            spill_loads=b.spill_loads, build_s=b.seconds,
            emitted_lines=b.emitted_lines,
            step_lane_ops=b.work_step_ops + b.env_ops, team=b.team,
            warps_per_sm=warps_per_sm(kern, b),
            issued_lane_ops=b.team * (b.step_ops + b.env_ops), work=work,
            **solo_ms,
            **{k: v for k, v in rows[row].items() if k == "push_effect_m"},
        ))
        log(f"kernel {row}: {timed[row]['ms']:.4f} ms per call, bound "
            f"{b_ms:.4f} ms ({by}), plain version "
            f"{plain[row]['plain_ms']:.1f} ms per call, {work}")
    log(f"card: {smi}; whole run {time.perf_counter() - T0:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
