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
qacc) -- and the PPO and ES trainers (``oxide_control_torch.train``) on
cheetah-run at the reference's defaults, after building every kernel
from the sources in this checkout and holding each against its plain
PyTorch version; the env-axis mesh (``parallel.mesh``, ``multitask``,
``FastRollout(mesh=)``) runs at world size 1 over NCCL.
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
7. general: the general path (``physics.forward`` under
   ``BatchedEnvironment.step`` and ``jit_rollout``, batched torch ops, no
   kernel of its own): (a) the reference's hop model, started 2 cm above
   the floor so that every env lands, at B = 1024, K = 24, through resets
   and contacts, against the rollout kernel on the same ctrl (f32, the
   reference's bars: qpos 1e-4, qvel 1e-3, reward 1e-4); (b) cheetah-run,
   walker-walk-tendon-sensors and cheetah-run-elliptic at B = 256, 10
   f64 steps from seeded states, against the plain scalar-graph step on
   the card (qpos under 1e-6, qvel under 1e-4: their 4 Newton iterations
   do not converge), each with a nudge check for line-search ties, and
   the walker row at 50 Newton iterations for 5 steps (qpos and qvel
   under 1e-9); (c) five models outside the kernel class
   (walker under implicitfast with CG, full implicit, a PGS free body,
   elliptic condim 3 under CG, the refsite site transmission), 10 f64
   steps on the card against the port on the CPU (1e-6; the CPU's
   steps run in a spawned process from the end of the build), then one
   step captured in a CUDA graph against the eager step (bit for bit);
   (d) the
   reference bench's two GENERAL_ALSO rows, cheetah-run-elliptic@4096
   and walker-walk-tendon-sensors@4096 at K = 50 with uniform actions,
   through ``jit_rollout`` (one warm-up call with the graph capture, 10
   timed calls between CUDA events, cut to 3 where the phase would pass
   ~120 s), then, from one state and generator state, one captured call
   with a new generator (so a new capture) against one eager ``rollout``
   call, which is also the eager timing (qpos and reward within 1e-4);
   a ``general`` JSON line.  (a) and (d) run first, with the card to
   themselves; (b) runs beside phase 8's settles, (c) after them (its
   graph captures must not overlap another thread's launches);
8. narrowphase: the MPR, height-field and mesh narrowphases on the
   general path, with seven models of the reference's tests (MPR for
   ellipsoid-box, sphere-mesh and capsule-cylinder; the box on the
   ridged field, MPR against 18 prisms; the ball in the valley and the
   capsule on the flat field; the tetra on the plane) at B = 4096, f32,
   K = 50 from a numpy-seeded jitter of the free bodies, dropped 1 cm
   into their partners: one captured step against the eager one (qpos,
   qvel and every contact lane bit for bit), ``jit_rollout`` timed
   (a warm-up call with the capture, 2 calls between CUDA events) and 3
   eager steps timed; then, while the reference tests' settles (the
   valley ball after 3000 steps, the flat-field sphere and capsule after
   500, the tetra after 600, the box stacks on an ellipsoid and on a mesh
   after 2000; f64, B = 64 identical envs, one CUDA graph per model
   replayed on its own stream from a thread) run to their invariants with
   all 64 envs bit-identical: one f64 step of each model in contact on
   the card against the CPU (qpos, qvel and the active lanes' dist, pos
   and frame within 1e-12, an env past it only as a tie of MPR's normal
   polish: depths within 1e-15, nothing past sqrt(eps)), ops per step,
   ``Physics`` on the card (100
   steps and every accessor, held against env 0 of a batch-1
   ``BatchedEnvironment``) and a ``FastRollout`` state through
   ``utils.checkpoint`` (the next call bit-identical); then
   ``torch.profiler`` over one cheetah-run ``FastRollout.run`` and one
   captured step of the ridged-field box (the top five device
   operations of each on one line); a ``narrowphase`` JSON line;
9. parallel + train: (a) an NCCL group of one rank through
   ``parallel.mesh.multihost_initialize`` on a ``file://`` store; the
   sharded ``FastRollout(mesh=)`` of cheetah-run@4096 (K = 200) against
   the row's (``init`` from one generator state, then both kernels on one
   ctrl and seed: bit for bit) and its all-reduced mean against the local
   mean; the hop model's ``jit_rollout`` (B = 1024, K = 24) sharded
   against unsharded, bit for bit; ``multitask_rollout`` of
   pendulum-swingup and cartpole-balance at B = 4096 (K = 50) on the one
   rank, called twice with the same envs, the round-robin warning
   expected, each task bit for bit its solo ``jit_rollout`` from the same
   task generator, the second call capturing no graph; then
   ``dryrun_multichip(1)`` on the group, and again with the group taken
   down (it spawns one NCCL rank); a ``parallel`` JSON line; (b) PPO at the
   reference's defaults (``train.ppo``: 60 iterations, B = 2048, K =
   200, sigma 0.1) and (c) ES at its defaults (``train.es``: 30
   iterations, B = 4096, K = 200, 8 antithetic pairs), each clearing the
   reference's margin with its kernel launched once per rollout call (60
   and 510): a ``train`` JSON line with the curves, wall seconds and
   env-steps/s;
10. the kernels line (JSON; the two trainers' builds timed at their
   parity modes' K = 24 and at K = 200) and the last line (JSON).

Parity runs each main-path row at its own B and K; models without a
bench row at K = 25 (box-stack, condim46, elliptic-condim4/6), K = 50
(fluid-forces, walker-walk-tendon, weld, tendon-equality,
plane-box-cyl-ellipsoid, ball-free-actuators, mocap-weld and
applied-forces) or K = 100 (pendulum-swingup, stateful-actuators,
box-pairs, ball-limit-spring, weld-ball and sensors-all; the fourbar
eq-toggle keeps K = 200):
pendulum-swingup@1024, walker-walk-tendon@4096
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
applied-forces@1024 (per-env qfrc and xfrc on every body); the two
options off the main path (exploration noise, Gaussian reset noise) at
K = 24; and (d) the two trainers' builds at K = 24: ppo@2048 (the (64,
64) policy with exploration noise 0.1, collecting) and es@4096 (the
policy alone).

Every kernel source is built at its team size G (``megakernel.team_rule``:
G lanes of one warp run one env, splitting the line search's row sums and
the MLP's outputs), and the plain version follows the same summation
order, so the two agree bit for bit at every G.

Needs one CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import dataclasses
import json
import multiprocessing
import os
import shutil
import subprocess
import tempfile
import time
import warnings
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from oxide_control_torch import bench_configs, convert, suite
from oxide_control_torch.api import Physics
from oxide_control_torch.api.environment import BatchedEnvironment
from oxide_control_torch.mjcf.compile import load_model_from_xml
from oxide_control_torch.model import GeomType, JointType
from oxide_control_torch.ops import megakernel as mk
from oxide_control_torch.ops import scalar_graph as sg
from oxide_control_torch.parallel.rollout import (
    FastRollout,
    JitRollout,
    jit_rollout,
    mocap_rest_pose,
    rollout,
)
from oxide_control_torch.parallel import dryrun
from oxide_control_torch.parallel.mesh import (
    make_env_mesh,
    multihost_initialize,
    shard_env_state,
)
from oxide_control_torch.parallel.multitask import (
    multitask_rollout,
    task_generators,
)
from oxide_control_torch.physics import forward as pfwd
from oxide_control_torch.policy import MLPPolicy
from oxide_control_torch.train import es, ppo
from oxide_control_torch.suite import walker
from oxide_control_torch.state import make_data, tree_map
from oxide_control_torch.suite.common import (
    SensorObsWrapper,
    asset_path,
)
from oxide_control_torch.utils import checkpoint, profiling
from oxide_control_torch.utils.divergence import divergence_flags

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
    "cheetah/run@2048": lambda: suite.load_batched("cheetah", "run", 2048),
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
# (label, task, K, variant).  Cut to keep the smoke inside its time with
# the narrowphase and the parallel + train phases: the five slowest plain
# versions (box-stack, condim46, the elliptic condim 4/6 models and
# fluid-forces: 184 s of the plain phase at K = 200 on the H100) run
# K = 25 (fluid-forces K = 50; box-stack's episodes are 2000 steps, the
# others' 5000); the next seven (53 s at K = 200) K = 50 and six more
# K = 100; envs of each still cross the time limit inside the window (a
# mode where none does fails).  The fourbar eq-toggle keeps the row's
# K = 200: its check compares it with the row's trajectories.
EXTRA_MODES = (
    ("pendulum-swingup@1024", "pendulum/swingup", 100, "ctrl"),
    ("walker-walk-tendon@4096", "walker/walk-tendon", 50, "ctrl"),
    ("stateful-actuators@1024", "stateful/actuators", 100, "ctrl"),
    # the connect off on every other env through eq_active
    ("fourbar eq-toggle@4096", "fourbar/equality", 200, "toggle"),
    ("weld@1024", "weld", 50, "ctrl"),
    ("tendon-equality@1024", "tendon-equality", 50, "ctrl"),
    ("box-pairs@1024", "box-pairs", 100, "ctrl"),
    ("plane-box-cyl-ellipsoid@1024", "plane-shapes", 50, "ctrl"),
    ("box-stack@1024", "box-stack", 25, "ctrl"),
    ("ball-limit-spring@1024", "ball-limit-spring", 100, "ctrl"),
    ("ball-free-actuators@1024", "ball-free-actuators", 50, "ctrl"),
    ("weld-ball@1024", "weld-ball", 100, "ctrl"),
    ("condim46@1024", "condim46", 25, "ctrl"),
    ("elliptic-condim4@1024", "elliptic-condim4", 25, "ctrl"),
    ("elliptic-condim6@1024", "elliptic-condim6", 25, "ctrl"),
    # ctrl input, the observation (the sensor rows) collected
    ("sensors-all@1024", "sensors-all", 100, "collect"),
    ("fluid-forces@1024", "fluid-forces", 50, "ctrl"),
    # per-env mocap poses and eq_active rows
    ("mocap-weld@1024", "mocap-weld", 50, "mocap"),
    # per-env qfrc and xfrc on every body
    ("applied-forces@1024", "applied-forces", 50, "applied"),
    ("cheetah explore", "cheetah/run", 24, "explore"),
    ("cheetah gaussian_reset", "cheetah/run", 24, "gauss"),
    # the two trainers' builds at their batches: PPO's (64, 64) policy
    # with exploration noise and collection, ES's policy alone
    ("ppo@2048", "cheetah/run@2048", 24, "ppo"),
    ("es@4096", "cheetah/run", 24, "es"),
)
# the trainers' parity modes, named after the trainer and its batch
TRAINER_MODES = ("ppo@2048", "es@4096")
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


# ---------------------------------------------------------------------------
# the general path (physics.forward through BatchedEnvironment.step and
# jit_rollout): cross-path checks and the two GENERAL_ALSO rows
# ---------------------------------------------------------------------------

# the reference's hop model and its task without reset noise
# (tests/test_megakernel.py:24-68): contacts, a limit, a motor, Newton.
# The ball starts 2 cm above the floor (the reference's test starts it at
# 0.35 m, where it never lands within a 15-step episode), so that every
# env is in contact inside the window
def hop_env(batch):
    return dryrun.hop_env(batch, height=0.17, time_limit=0.15,
                          reset_noise=0.0)


HOP_B, HOP_K = 1024, 24
# the general path against the kernel, f32 (tests/test_megakernel.py:109-115)
HOP_BARS = dict(qpos=1e-4, qvel=1e-3, reward=1e-4)
# the general path against the plain version, f64
# (tests/test_scalar_graph.py:47-52), and the card against the CPU
F64_BAR = 1e-6
# The f64 rows' qvel bar.  Their models run 4 Newton iterations with
# tolerance 0, which do not converge: the general path's line search
# (exact, over the rows' breakpoints, or bisection to its own tolerance)
# and the plain step's 26-step bisection then end on different iterates,
# ~1e-6 apart in qvel after one step and up to ~5e-5 over 10 (the
# reference's two paths differ by as much).  The converged leg below
# (the walker row at 50 iterations) holds both paths to CONVERGED_BAR.
F64_QVEL_BAR = 1e-4
CONVERGED_BAR = 1e-9
# qpos scaled by 1 + NUDGE in the general path alone must move its qvel
# by less than NUDGE_BAR: a line-search tie in the window would move it
# as far as the cross-path error (ROADMAP Queue C)
NUDGE, NUDGE_BAR = 1e-14, 1e-9
F64_SEED = 9
GENERAL_B, GENERAL_K = 4096, 50


# models outside the kernel class (tests/test_golden.py:171-185, 257-276,
# 327-335 and the refsite model of ROADMAP Queue C), run on the card in
# f64 against the port on the CPU
PLANAR_WALKER_XML = """
<mujoco model="planar_walker">
  <option timestep="0.002" integrator="implicitfast" solver="CG"
          iterations="30" tolerance="0"/>
  <default>
    <joint damping="0.1" armature="0.01"/>
    <geom friction="0.7 0.005 0.0001" solref="0.02 1"
          solimp="0.9 0.95 0.001 0.5 2" contype="0" conaffinity="1"/>
  </default>
  <worldbody>
    <geom name="floor" type="plane" size="10 10 0.1" contype="1"
          conaffinity="0"/>
    <body name="torso" pos="0 0 0.7">
      <joint name="rootx" type="slide" axis="1 0 0" damping="0" armature="0"/>
      <joint name="rootz" type="slide" axis="0 0 1" damping="0" armature="0"/>
      <joint name="rooty" type="hinge" axis="0 1 0" damping="0" armature="0"/>
      <geom name="torso_geom" type="capsule" fromto="0 0 -0.15 0 0 0.15"
            size="0.05" mass="3"/>
      <body name="thigh" pos="0 0 -0.15">
        <joint name="hip" type="hinge" axis="0 1 0" range="-1.0 1.0"/>
        <geom name="thigh_geom" type="capsule" fromto="0 0 0 0 0 -0.25"
              size="0.04" mass="1"/>
        <body name="shin" pos="0 0 -0.25">
          <joint name="knee" type="hinge" axis="0 1 0" range="-1.5 0.1"/>
          <geom name="shin_geom" type="capsule" fromto="0 0 0 0 0 -0.25"
                size="0.03" mass="0.6"/>
        </body>
      </body>
      <body name="thigh2" pos="0 0 -0.15">
        <joint name="hip2" type="hinge" axis="0 1 0" range="-1.0 1.0"/>
        <geom name="thigh2_geom" type="capsule" fromto="0 0 0 0 0.02 -0.25"
              size="0.04" mass="1"/>
        <body name="shin2" pos="0 0.02 -0.25">
          <joint name="knee2" type="hinge" axis="0 1 0" range="-1.5 0.1"/>
          <geom name="shin2_geom" type="capsule" fromto="0 0 0 0 0 -0.25"
                size="0.03" mass="0.6"/>
        </body>
      </body>
    </body>
  </worldbody>
  <actuator>
    <motor joint="hip" gear="30" ctrlrange="-1 1"/>
    <motor joint="knee" gear="30" ctrlrange="-1 1"/>
    <motor joint="hip2" gear="30" ctrlrange="-1 1"/>
    <motor joint="knee2" gear="30" ctrlrange="-1 1"/>
  </actuator>
</mujoco>
"""
IMPLICIT_BALL_XML = """
<mujoco model="ball_pendulum">
  <option timestep="0.002" integrator="implicit"/>
  <worldbody>
    <body name="arm" pos="0 0 1">
      <joint name="swivel" type="ball" damping="0.05"/>
      <geom name="arm_geom" type="capsule" fromto="0 0 0 0.05 0.1 -0.4"
            size="0.02" mass="0.5"/>
    </body>
  </worldbody>
</mujoco>
"""
PGS_FREE_XML = """
<mujoco model="free_body">
  <option timestep="0.002" solver="PGS" iterations="30" tolerance="0"/>
  <worldbody>
    <geom name="floor" type="plane" size="5 5 0.1"/>
    <body name="ball" pos="0.1 -0.2 0.5">
      <freejoint name="root"/>
      <geom name="sphere_geom" type="sphere" size="0.12" mass="0.8"/>
    </body>
  </worldbody>
</mujoco>
"""
ELLIPTIC_CG_XML = """
<mujoco>
  <option cone="elliptic" impratio="1" solver="CG" iterations="30"
          tolerance="0" timestep="0.002"/>
  <worldbody>
    <geom name="floor" type="plane" size="5 5 .1" friction="0.4 0.1 0.01"/>
    <body pos="0 0 0.145">
      <freejoint/>
      <geom name="ball" type="sphere" size="0.15" mass="1"
            friction="0.4 0.3 0.05" condim="3"/>
    </body>
  </worldbody>
</mujoco>
"""
REFSITE_XML = """
<mujoco>
  <worldbody>
    <geom name="floor" type="plane" size="5 5 .1"/>
    <body name="a" pos="0 0 1">
      <joint name="h1" type="hinge" axis="0 1 0"/>
      <geom type="sphere" size="0.1 0.1 0.1"/>
      <site name="s1" pos="0.1 0 0"/>
      <body name="b" pos="0.3 0 0">
        <joint name="h2" type="hinge" axis="0 1 0"/>
        <geom type="capsule" size="0.05" fromto="0 0 0 0.2 0 0"/>
        <site name="s2" pos="0.2 0 0"/>
      </body>
    </body>
  </worldbody>
  <actuator><general site="s2" refsite="s1" gear="1 0 0 0 0 0"/></actuator>
</mujoco>
"""
# name -> (xml, seeded qpos noise, qvel noise, qpos offsets): the free
# bodies start in contact
OUTSIDE_MODELS = {
    "walker-implicitfast-cg": (PLANAR_WALKER_XML, 0.05, 0.5, {}),
    "ball-implicit": (IMPLICIT_BALL_XML, 0.3, 3.0, {}),
    "free-body-pgs": (PGS_FREE_XML, 0.05, 0.5, {2: -0.39}),
    "elliptic-condim3-cg": (ELLIPTIC_CG_XML, 0.01, 0.5, {2: -0.005}),
    "refsite": (REFSITE_XML, 0.5, 1.0, {}),
}
# the f64 cross-path rows: (name, loader, qpos offsets), from F64_SEED,
# with the nudge check for line-search ties (ROADMAP Queue C)
F64_ROWS = (
    ("cheetah-run", lambda: suite.load_batched(
        "cheetah", "run", 256, dtype=np.float64), {1: -0.1}),
    ("walker-walk-tendon-sensors", lambda: bench_configs.load_config(
        "walker", "walk-tendon-sensors", 256, dtype=np.float64), {0: -0.1}),
    ("cheetah-run-elliptic", lambda: bench_configs.load_config(
        "cheetah", "run-elliptic", 256, dtype=np.float64), {1: -0.1}),
)


# f64 steps of each outside model, card against CPU, of each f64 row and
# of the walker's converged leg (host-bound: ~4 s a step on the card for
# the elliptic CG model, ~7 s for the converged walker; the CPU's steps
# run in a process of their own beside the card's phases)
OUTSIDE_STEPS, F64_STEPS, CONVERGED_STEPS = 10, 10, 5


def seeded_data(model, b, device, dtype, seed, qn, vn, shift):
    """make_data with qpos0 + U(-qn, qn) (plus ``shift``), qvel U(-vn, vn)
    and ctrl U(-1, 1), from one numpy seed (the same on every device)."""
    rng = np.random.default_rng(seed)
    qpos = np.asarray(model.qpos0, np.float64)[None] + qn * rng.uniform(
        -1, 1, (b, model.nq))
    for i, off in shift.items():
        qpos[:, i] += off
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return make_data(model, device, dtype, batch=b).replace(
        qpos=t(qpos), qvel=t(vn * rng.uniform(-1, 1, (b, model.nv))),
        ctrl=t(rng.uniform(-1, 1, (b, model.nu))))


def general_hop_phase(fn):
    """BatchedEnvironment.step on the card against the rollout kernel, f32,
    the same ctrl, through resets."""
    benv = hop_env(HOP_B)
    model = benv.model
    gen = torch.Generator(device="cuda").manual_seed(3)
    data = benv.reset(gen)
    ctrl = torch.empty((HOP_K, HOP_B, model.nu), device="cuda").uniform_(
        -1.0, 1.0, generator=gen)
    state = (data.qpos.T.contiguous(), data.qvel.T.contiguous(),
             torch.zeros((1, HOP_B), device="cuda"),
             data.qacc_warmstart.T.contiguous(),
             data.time[None].contiguous())
    launches = fn.launches
    ko = fn(*state, ctrl.permute(0, 2, 1).contiguous(),
            torch.zeros((1,), dtype=torch.int32, device="cuda"))
    if fn.launches != launches + 1:
        raise AssertionError("general hop: the rollout kernel did not run")
    d, rew, dones = data, torch.zeros(HOP_B, device="cuda"), 0
    touched = torch.zeros(HOP_B, dtype=torch.bool, device="cuda")
    contact_steps = 0
    for k in range(HOP_K):
        d, ts = benv.step(d, ctrl[k], gen)
        rew += ts.reward
        dones += int(ts.done.sum())
        # the step's contact rows (an env reset at this step shows its
        # last step's rows in the next one's contact count only)
        active = d.nefc_active > 0
        touched |= active
        contact_steps += int(active.any())
    torch.cuda.synchronize()
    errs = dict(qpos=float((ko[0].T - d.qpos).abs().max()),
                qvel=float((ko[1].T - d.qvel).abs().max()),
                reward=float((ko[5][0] - rew).abs().max()))
    n_touched = int(touched.sum())
    log(f"general hop@{HOP_B} (K={HOP_K}, {dones} resets, {n_touched} envs "
        f"in contact, contact rows in {contact_steps} steps): general path "
        "vs rollout kernel, f32: " + ", ".join(
            f"{k} {v:.3e} (bar {HOP_BARS[k]:g})" for k, v in errs.items()))
    if dones == 0:
        raise AssertionError("general hop: no env reset in the window")
    if n_touched != HOP_B:
        raise AssertionError(f"general hop: only {n_touched} of {HOP_B} envs "
                             "touched the floor")
    for k, v in errs.items():
        if not v <= HOP_BARS[k]:
            raise AssertionError(f"general hop: {k} error {v} over "
                                 f"{HOP_BARS[k]}")
    return dict(errs, resets=dones, envs_in_contact=n_touched,
                steps_with_contact=contact_steps)


def f64_cross_path(model, b, shift, steps):
    """``steps`` f64 steps of the general path and of the plain
    scalar-graph step on the card from one seeded state: the worst qpos
    and qvel gaps, how far a nudge of qpos moves the general path's qvel,
    and the active constraint rows summed over the steps."""
    d = seeded_data(model, b, "cuda", torch.float64, F64_SEED, 0.1, 0.5,
                    shift)
    nudged = d.replace(qpos=d.qpos * (1.0 + NUDGE))
    step = sg.build_step(model, sg.TorchBackend(b, torch.float64, "cuda"))
    cols = lambda x: list(x.T.unbind(0))
    q, v, w, c = cols(d.qpos), cols(d.qvel), cols(d.qacc_warmstart), \
        cols(d.ctrl)
    a = cols(d.act)
    worst, rows = dict(qpos=0.0, qvel=0.0, nudge_qvel=0.0), 0
    for _ in range(steps):
        q, v, a, w = step(q, v, a, w, c)
        d = pfwd.step(model, d)
        nudged = pfwd.step(model, nudged)
        for k, x, y in (("qpos", torch.stack(q, 1), d.qpos),
                        ("qvel", torch.stack(v, 1), d.qvel),
                        ("nudge_qvel", nudged.qvel, d.qvel)):
            worst[k] = max(worst[k], float((x - y).abs().max()))
        rows += int(d.nefc_active.sum())
    return worst, rows


def general_f64_phase():
    """The general step against the plain scalar-graph step, both f64 on
    the card, F64_STEPS steps from seeded states (and the walker row's
    converged leg: 50 Newton iterations, CONVERGED_STEPS steps)."""
    out = {}
    for name, load, shift in F64_ROWS:
        benv = load()
        legs = [(name, benv.model, F64_STEPS, dict(qpos=F64_BAR,
                                            qvel=F64_QVEL_BAR))]
        if name.startswith("walker"):
            legs.append((f"{name} converged", benv.model.replace(
                opt=dataclasses.replace(benv.model.opt, iterations=50)),
                CONVERGED_STEPS,
                dict(qpos=CONVERGED_BAR, qvel=CONVERGED_BAR)))
        for leg, model, steps, bars in legs:
            worst, rows = f64_cross_path(model, benv.num_envs, shift, steps)
            torch.cuda.synchronize()
            log(f"general f64 {leg}@{benv.num_envs} ({steps} steps, "
                f"{model.opt.iterations} Newton iterations): general path "
                f"vs plain scalar-graph step on the card: qpos "
                f"{worst['qpos']:.3e} (bar {bars['qpos']:g}), qvel "
                f"{worst['qvel']:.3e} (bar {bars['qvel']:g}); the nudge "
                f"moves qvel {worst['nudge_qvel']:.3e} (bar {NUDGE_BAR:g}); "
                f"active constraint rows {rows}")
            for k, bar in bars.items():
                if not worst[k] < bar:
                    raise AssertionError(f"general f64 {leg}: {k} error "
                                         f"{worst[k]} over {bar}")
            if not worst["nudge_qvel"] < NUDGE_BAR:
                raise AssertionError(f"general f64 {leg}: a nudge of "
                                     f"{NUDGE} moves qvel "
                                     f"{worst['nudge_qvel']} (a tie)")
            out[leg] = dict(worst, constraint_rows=rows, steps=steps,
                            iterations=model.opt.iterations)
    return out


def env_gaps(a, b, lanes=None):
    """Per env, the worst gap of two states (on one device): qpos, qvel
    and the contact's dist, pos and frame on ``lanes (B, L)``, every lane
    where None."""
    gap = torch.maximum((a.qpos - b.qpos).abs().amax(1),
                        (a.qvel - b.qvel).abs().amax(1))
    for f in ("dist", "pos", "frame"):
        x = (getattr(a.contact, f) - getattr(b.contact, f)).abs()
        if x.numel() == 0:        # a model without contact lanes
            continue
        x = x.reshape(x.shape[:2] + (-1,)).amax(-1)
        if lanes is not None:
            x = torch.where(lanes, x, torch.zeros_like(x))
        gap = torch.maximum(gap, x.amax(1))
    return gap


def captured_step_gap(model, d):
    """One general step captured in a CUDA graph and replayed, against
    the same step run eagerly from ``d``: the worst gap of qpos, qvel and
    every contact lane (the dense solves of every solver and integrator,
    and the narrowphases, under capture)."""
    static = tree_map(lambda x: x.clone(), d)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        pfwd.step(model, static)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = pfwd.step(model, static)
    graph.replay()
    eager = pfwd.step(model, d)
    torch.cuda.synchronize()
    return float(env_gaps(out, eager).max())


def outside_cpu_steps():
    """The port on the CPU: OUTSIDE_STEPS f64 steps of each model outside
    the kernel class from the seeded state the card starts from ->
    ``{name: (qpos, qvel)}``.  Run in a process of its own, beside the
    card's phases."""
    out = {}
    for name, (xml, qn, vn, shift) in OUTSIDE_MODELS.items():
        model = load_model_from_xml(xml, np.float64)
        d = seeded_data(model, 64, "cpu", torch.float64, 13, qn, vn, shift)
        for _ in range(OUTSIDE_STEPS):
            d = pfwd.step(model, d)
        out[name] = (d.qpos, d.qvel)
    return out


def general_outside_phase(cpu):
    """Models outside the kernel class, OUTSIDE_STEPS f64 steps on the
    card against the same steps of the port on the CPU (``cpu``:
    :func:`outside_cpu_steps`), and one more step on the card captured in
    a CUDA graph against the eager step (bit for bit)."""
    out = {}
    for name, (xml, qn, vn, shift) in OUTSIDE_MODELS.items():
        model = load_model_from_xml(xml, np.float64)
        if sg.unsupported_reason(model) is None:
            raise AssertionError(f"{name}: the kernel admits the model")
        d = seeded_data(model, 64, "cuda", torch.float64, 13, qn, vn, shift)
        for _ in range(OUTSIDE_STEPS):
            d = pfwd.step(model, d)
        torch.cuda.synchronize()
        errs = {k: float((getattr(d, k).cpu() - x).abs().max())
                for k, x in zip(("qpos", "qvel"), cpu[name])}
        errs["captured_vs_eager"] = captured_step_gap(model, d)
        log(f"general outside the kernel class: {name} ({OUTSIDE_STEPS} f64 "
            "steps, B=64): "
            f"card vs CPU qpos {errs['qpos']:.3e}, qvel {errs['qvel']:.3e} "
            f"(bar {F64_BAR:g}), solver iterations "
            f"{float(d.solver_niter.double().mean()):.2f}; a captured "
            f"step vs the eager step {errs['captured_vs_eager']:.3e} "
            "(bar 0)")
        for k in ("qpos", "qvel"):
            if not errs[k] < F64_BAR:
                raise AssertionError(f"{name}: card vs CPU {k} {errs[k]}")
        if errs["captured_vs_eager"] != 0.0:
            raise AssertionError(f"{name}: the captured step parts from the "
                                 f"eager one by {errs['captured_vs_eager']}")
        out[name] = errs
    return out


class OpCount(TorchDispatchMode):
    """Counts torch operator calls (views included) by the innermost
    stage on ``stack``."""

    def __init__(self):
        super().__init__()
        self.stack = ["other"]
        self.by = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.by[self.stack[-1]] = self.by.get(self.stack[-1], 0) + 1
        return func(*args, **(kwargs or {}))


def count_step_ops(benv):
    """Torch operator calls of one general-path env step of ``benv`` (a
    CPU BatchedEnvironment; the ops a captured step replays), by stage,
    counted at its B: the count does not depend on B."""
    from oxide_control_torch.physics import constraint, forward

    gen = torch.Generator().manual_seed(0)
    data = benv.reset(gen)
    counter = OpCount()
    stages = ((forward, "fwd_position", "position"),
              (forward, "fwd_velocity", "velocity"),
              (constraint, "_linesearch", "line search"),
              (constraint, "fwd_constraint", "constraint"),
              (forward._integrate, "euler", "integrator"),
              (benv, "_reset_one", "auto-reset"))
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in stages]

    def wrap(fn, stage):
        def wrapped(*a, **k):
            counter.stack.append(stage)
            try:
                return fn(*a, **k)
            finally:
                counter.stack.pop()
        return wrapped

    try:
        for (mod, name, fn), (_, _, stage) in zip(saved, stages):
            setattr(mod, name, wrap(fn, stage))
        with counter:
            action = torch.empty((benv.num_envs, benv.model.nu)).uniform_(
                -1.0, 1.0, generator=gen)
            benv.step(data, action, gen)
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return dict(total=sum(counter.by.values()), **counter.by)


def general_rows_phase(rows, smi):
    """The two GENERAL_ALSO rows at B = 4096, K = 50, f32, through
    jit_rollout (captured) and rollout (eager), timed as bench_general
    times them: one warm-up call, then the timed calls between CUDA
    events after a synchronize."""
    out = {}
    t_phase = time.perf_counter()
    for row, (dom, task) in (
            ("cheetah-run-elliptic@4096", ("cheetah", "run-elliptic")),
            ("walker-walk-tendon-sensors@4096",
             ("walker", "walk-tendon-sensors"))):
        benv = bench_configs.load_config(dom, task, GENERAL_B)
        gen = torch.Generator(device="cuda").manual_seed(4)
        data = benv.reset(gen)
        jr = jit_rollout(benv, GENERAL_K)
        t_warm = time.perf_counter()
        data, (rew, dones), _ = jr(data, gen)  # warm-up with the capture
        torch.cuda.synchronize()
        call_s = time.perf_counter() - t_warm - jr.capture_s
        # ten timed calls, cut to 3 where the phase would pass ~120 s
        n = N_TIMED
        if time.perf_counter() - t_phase + 12 * call_s > 100:
            n = 3
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            data, (rew, dones), _ = jr(data, gen)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / n
        if not bool(torch.isfinite(rew).all()):
            raise AssertionError(f"general {row}: non-finite rewards")
        stats = dict(
            solver_niter_mean=float(data.solver_niter.double().mean()),
            solver_gradnorm_mean=float(data.solver_gradnorm.double()
                                       .mean()),
            diverged_envs=int(divergence_flags(benv.model, data).sum()))
        capture_s = jr.capture_s
        # the captured call against one eager call (timed) from the same
        # state and generator state; the new generator makes jit_rollout
        # capture the step again for it
        start_data = tree_map(lambda x: x.clone(), data)
        gen2 = torch.Generator(device="cuda").manual_seed(5)
        g_state = gen2.get_state()
        got, (rew_j, _), _ = jr(tree_map(lambda x: x.clone(), start_data),
                                gen2)
        if jr.generator is not gen2:
            raise AssertionError(f"general {row}: no capture for a new "
                                 "generator")
        qpos_j, rew_j = got.qpos.clone(), rew_j.clone()
        gen2.set_state(g_state)
        start.record()
        data, (rew_e, _), _ = rollout(benv, start_data, gen2, GENERAL_K)
        end.record()
        torch.cuda.synchronize()
        eager_ms = start.elapsed_time(end)
        agree = dict(qpos=float((qpos_j - data.qpos).abs().max()),
                     reward=float((rew_j - rew_e).abs().max()))
        agree["bit_identical"] = bool(torch.equal(qpos_j, data.qpos)
                                      and torch.equal(rew_j, rew_e))
        log(f"general {row}: jit_rollout (captured again for a new "
            f"generator) vs eager rollout, {GENERAL_K} steps from one state "
            f"and generator state: qpos {agree['qpos']:.3e} (bar "
            f"{HOP_BARS['qpos']:g}), reward {agree['reward']:.3e} (bar "
            f"{HOP_BARS['reward']:g}), bit-identical "
            f"{agree['bit_identical']}")
        for k in ("qpos", "reward"):
            if not agree[k] <= HOP_BARS[k]:
                raise AssertionError(f"general {row}: captured vs eager {k} "
                                     f"{agree[k]} over {HOP_BARS[k]}")
        env_steps = GENERAL_B * GENERAL_K
        ops = count_step_ops(bench_configs.load_config(dom, task, 4,
                                                       device="cpu"))
        out[row] = dict(
            torch_ops_per_step=ops,
            us_per_op=ms * 1e3 / GENERAL_K / ops["total"],
            env_steps_per_s=env_steps / (ms * 1e-3), call_ms=ms,
            timed_calls=n, eager_env_steps_per_s=env_steps
            / (eager_ms * 1e-3), eager_call_ms=eager_ms,
            capture_s=capture_s, captured_vs_eager=agree,
            kernel_env_steps_per_s=rows[row]["rate"], **stats)
        log(f"general {row} (K={GENERAL_K}): captured {ms:.3f} ms per call "
            f"({out[row]['env_steps_per_s']:.6e} env-steps/s, {n} timed "
            f"calls), eager {eager_ms:.3f} ms "
            f"({out[row]['eager_env_steps_per_s']:.6e}), capture "
            f"{capture_s:.2f} s, solver iterations "
            f"{stats['solver_niter_mean']:.3f}, diverged "
            f"{stats['diverged_envs']}; the kernel row "
            f"{rows[row]['rate']:.6e} env-steps/s; {ops['total']} torch ops "
            f"per step ({out[row]['us_per_op']:.3f} us each captured; line "
            f"search {ops.get('line search', 0)}, auto-reset "
            f"{ops.get('auto-reset', 0)})")
    return dict(rows=out, card=smi,
                timed_calls_cut=any(r["timed_calls"] < N_TIMED
                                    for r in out.values()))


# ---------------------------------------------------------------------------
# narrowphase phase: the MPR, height-field and mesh narrowphases on the
# general path.  The models are the reference's tests' (tests/test_mpr.py,
# tests/test_hfield.py, tests/test_mesh.py), copied here because those
# files import JAX.
# ---------------------------------------------------------------------------

ELLBOX_XML = """
<mujoco>
  <option timestep="0.002" solver="Newton" iterations="30" tolerance="0"/>
  <worldbody>
    <geom name="floor" type="plane" size="3 3 .1"/>
    <body name="bx" pos="0 0 0.1">
      <geom name="box" type="box" size="0.25 0.25 0.1" mass="2"/>
    </body>
    <body name="el" pos="0.05 0.02 0.5">
      <freejoint/>
      <geom name="ell" type="ellipsoid" size="0.1 0.12 0.08" mass="0.5"/>
    </body>
  </worldbody>
</mujoco>
"""
TET_MESH_XML = """
<mujoco>
  <option timestep="0.002" solver="Newton" iterations="30" tolerance="0"/>
  <asset>
    <mesh name="tet" vertex="0 0 0  0.3 0 0  0 0.3 0  0.15 0.15 0.35"/>
  </asset>
  <worldbody>
    <geom name="floor" type="plane" size="3 3 .1"/>
    <body name="base" pos="0 0 0.02">
      <geom name="mg" type="mesh" mesh="tet" mass="2"/>
    </body>
    <body name="ball" pos="0.14 0.12 0.8">
      <freejoint/>
      <geom name="bg" type="sphere" size="0.08" mass="0.3"/>
    </body>
  </worldbody>
</mujoco>
"""
CAPCYL_XML = """
<mujoco>
  <option timestep="0.002" solver="Newton" iterations="30" tolerance="0"/>
  <worldbody>
    <geom name="floor" type="plane" size="3 3 .1"/>
    <body name="cyl" pos="0 0 0.15">
      <geom name="cg" type="cylinder" size="0.12 0.15" mass="2"/>
    </body>
    <body name="cap" pos="0.02 0.01 0.5">
      <freejoint/>
      <geom name="kg" type="capsule" size="0.05 0.12" mass="0.4"
            euler="0 85 0"/>
    </body>
  </worldbody>
</mujoco>
"""
RIDGE_XML = """
<mujoco>
  <option timestep="0.002" solver="Newton" iterations="30" tolerance="0"/>
  <asset>
    <hfield name="terrain" nrow="9" ncol="9" size="1.5 1.5 0.18 0.1"
            elevation="0 .2 .4 .5 .4 .3 .2 .1 0
                       .1 .3 .5 .6 .5 .4 .3 .2 .1
                       .2 .4 .6 .8 .7 .5 .4 .3 .2
                       .3 .5 .8 1  .8 .6 .5 .4 .3
                       .2 .4 .7 .8 .6 .5 .4 .3 .2
                       .1 .3 .5 .6 .5 .4 .3 .2 .1
                       0 .2 .4 .5 .4 .3 .2 .1 0
                       0 .1 .2 .3 .2 .2 .1 0 0
                       0 0 .1 .2 .1 .1 0 0 0"/>
  </asset>
  <worldbody>
    <geom name="hf" type="hfield" hfield="terrain"/>
    <body name="box" pos="0.3 0.2 0.6">
      <joint type="free"/>
      <geom name="bx" type="box" size="0.12 0.1 0.08" mass="1"/>
    </body>
  </worldbody>
</mujoco>
"""
_FLAT_FIELD = """
  <asset>
    <hfield name="terrain" nrow="5" ncol="5" size="2 2 0.5 0.1"
            elevation="0 0 0 0 0  0 0 0 0 0  0 0 0 0 0  0 0 0 0 0  0 0 0 0 0"/>
  </asset>"""
FLAT_XML = f"""
<mujoco>{_FLAT_FIELD}
  <worldbody>
    <geom name="ground" type="hfield" hfield="terrain"/>
    <body name="ball" pos="0.3 0.2 0.5">
      <freejoint/>
      <geom name="bg" type="sphere" size="0.1" mass="0.5"/>
    </body>
  </worldbody>
</mujoco>
"""
VALLEY_XML = """
<mujoco>
  <asset>
    <hfield name="valley" nrow="3" ncol="5" size="2 2 0.4 0.1"
            elevation="1 0.5 0 0.5 1  1 0.5 0 0.5 1  1 0.5 0 0.5 1"/>
  </asset>
  <worldbody>
    <geom name="ground" type="hfield" hfield="valley"
          friction="0.01 0.001 0.0001"/>
    <body name="ball" pos="-1.2 0 0.8">
      <freejoint/>
      <geom name="bg" type="sphere" size="0.1" mass="0.5"
            friction="0.01 0.001 0.0001"/>
    </body>
  </worldbody>
</mujoco>
"""
CAPSULE_XML = f"""
<mujoco>{_FLAT_FIELD}
  <worldbody>
    <geom name="ground" type="hfield" hfield="terrain"/>
    <body name="pill" pos="0 0 0.4">
      <freejoint/>
      <geom name="pg" type="capsule" size="0.08 0.2" mass="0.5"
            euler="0 90 0"/>
    </body>
  </worldbody>
</mujoco>
"""
MESH_XML = """
<mujoco>
  <asset><mesh name="tetra" vertex="0 0 0  0.2 0 0  0 0.2 0  0.07 0.07 0.2"/>
  </asset>
  <worldbody>
    <geom name="floor" type="plane" size="2 2 0.1"/>
    <body name="b" pos="0 0 0.3">
      <freejoint/>
      <geom name="g" type="mesh" mesh="tetra" mass="0.3"
            friction="0.8 0.005 0.0001"/>
    </body>
  </worldbody>
</mujoco>
"""
_STACK = """
<mujoco>{asset}
  <option timestep="0.002" solver="Newton" iterations="30" tolerance="0"/>
  <worldbody>
    <geom type="plane" size="3 3 .1"/>
    <body pos="0 0 {z}">
      <joint type="free"/>
      <geom {base}/>
    </body>
    <body name="top" pos="0 0 {top}">
      <joint type="free"/>
      <geom type="box" size="0.12 0.1 0.1" mass="0.5"/>
    </body>
  </worldbody>
</mujoco>
"""
BOX_ON_ELLIPSOID_XML = _STACK.format(
    asset="", z=0.1, top=0.3,
    base='type="ellipsoid" size="0.25 0.2 0.1" mass="1"')
BOX_ON_MESH_XML = _STACK.format(
    asset='<asset><mesh name="slab" vertex="-0.4 -0.4 0  0.4 -0.4 0  '
          '0.4 0.4 0  -0.4 0.4 0  -0.3 -0.3 0.2  0.3 -0.3 0.2  0.3 0.3 0.2  '
          '-0.3 0.3 0.2"/></asset>', z=0.25, top=0.56,
    base='type="mesh" mesh="slab" mass="1"')

# the seven models of the phase's rows: MPR (ellipsoid-box, sphere-mesh,
# capsule-cylinder), the prism MPR (box on the ridged field, 90 lanes),
# the analytic height-field pairs (sphere, capsule) and plane-mesh; each
# with the z offset that drops its free body from the XML's pose to 1 cm
# into its partner (the jitter then spreads the envs over +-2 cm)
NARROW_ROWS = (
    ("ellipsoid-box", ELLBOX_XML, -0.23),
    ("sphere-mesh", TET_MESH_XML, -0.368),
    ("capsule-cylinder", CAPCYL_XML, -0.15),
    ("box-ridge-prisms", RIDGE_XML, -0.411),
    ("ball-valley", VALLEY_XML, -0.468),
    ("capsule-flat-field", CAPSULE_XML, -0.33),
    ("tetra-plane", MESH_XML, -0.31),
)
NARROW_B, NARROW_K, NARROW_TIMED, NARROW_EAGER_STEPS = 4096, 50, 2, 3
CARD_CPU_BAR = 1e-12
# a tie of MPR's normal polish: the depths agree to the rounding level,
# and nothing parts by sqrt(f64 eps)
DEPTH_BAR, FLAT_BAR = 1e-15, 2.0 ** -26


def jittered(model, b, device, dtype, seed, drop=0.0):
    """make_data with every free body lowered by ``drop`` and its position
    jittered by U(-0.02, 0.02), its velocity drawn U(-0.2, 0.2), from one
    numpy seed (the same on every device)."""
    rng = np.random.default_rng(seed)
    qpos = np.tile(np.asarray(model.qpos0, np.float64), (b, 1))
    qvel = np.zeros((b, model.nv))
    for j in range(model.njnt):
        if JointType(model.jnt_type[j]) == JointType.FREE:
            q, v = model.jnt_qposadr[j], model.jnt_dofadr[j]
            qpos[:, q + 2] += drop
            qpos[:, q:q + 3] += 0.02 * rng.uniform(-1, 1, (b, 3))
            qvel[:, v:v + 6] = 0.2 * rng.uniform(-1, 1, (b, 6))
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return make_data(model, device, dtype, batch=b).replace(
        qpos=t(qpos), qvel=t(qvel))


def active_lanes(d):
    """(B, L): the lanes that reach the solver (dist < includemargin)."""
    return d.contact.dist < d.contact.includemargin


def narrow_row(name, xml, drop):
    """One model at B = 4096, f32, K = 50, its envs starting in contact:
    one captured step against the eager step (qpos, qvel and every
    contact lane bit for bit), then jit_rollout timed (captured: a warm-up
    call with the capture, then NARROW_TIMED calls between CUDA events)
    and NARROW_EAGER_STEPS eager steps timed."""
    model = load_model_from_xml(xml, np.float32)
    benv = BatchedEnvironment(model, bench_configs.BenchTask(), NARROW_B)
    gen = torch.Generator(device="cuda").manual_seed(6)
    jit = jittered(model, NARROW_B, "cuda", torch.float32, 6, drop)
    data = benv.reset(gen).replace(qpos=jit.qpos, qvel=jit.qvel)
    touching = int(active_lanes(pfwd.step(model, data)).any(1).sum())
    if touching < NARROW_B // 4:
        raise AssertionError(f"narrowphase {name}: {touching} envs in "
                             f"contact at the start")
    gap = captured_step_gap(model, data)
    if gap != 0.0:
        raise AssertionError(f"narrowphase {name}: a captured step parts "
                             f"from the eager one by {gap}")
    jr = jit_rollout(benv, NARROW_K)
    t0 = time.perf_counter()
    out, (rew, _), _ = jr(tree_map(lambda x: x.clone(), data), gen)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(NARROW_TIMED):
        out, (rew, _), _ = jr(out, gen)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / NARROW_TIMED
    active = int((out.contact.dist < out.contact.includemargin).sum())
    diverged = int(divergence_flags(model, out).sum())
    if not bool(torch.isfinite(rew).all()):
        raise AssertionError(f"narrowphase {name}: non-finite rewards")
    start.record()
    rollout(benv, data, gen, NARROW_EAGER_STEPS)
    end.record()
    torch.cuda.synchronize()
    eager_ms = start.elapsed_time(end) / NARROW_EAGER_STEPS
    row = dict(pairs=[f"{GeomType(a).name}-{GeomType(b).name}"
                      for a, b, _ in model.pair_groups],
               lanes=int(out.contact.dist.shape[1]),
               env_steps_per_s=NARROW_B * NARROW_K / (ms * 1e-3),
               call_ms=ms, timed_calls=NARROW_TIMED,
               eager_env_steps_per_s=NARROW_B / (eager_ms * 1e-3),
               eager_step_ms=eager_ms, capture_s=jr.capture_s,
               first_call_s=warm_s, envs_in_contact_at_start=touching,
               active_lanes=active, diverged_envs=diverged,
               captured_vs_eager=gap)
    log(f"narrowphase {name}@{NARROW_B} (K={NARROW_K}, f32; "
        f"{', '.join(row['pairs'])}, {row['lanes']} lanes): captured "
        f"{ms:.3f} ms per call ({row['env_steps_per_s']:.6e} env-steps/s), "
        f"eager {eager_ms:.3f} ms per step "
        f"({row['eager_env_steps_per_s']:.6e}), capture {jr.capture_s:.2f} "
        f"s, {active} active lanes at the end, diverged {diverged}; "
        f"{touching} envs in contact at the start, a captured step vs the "
        f"eager step there (qpos, qvel, every contact lane) {gap:.3e} "
        f"(bar 0)")
    return row


def narrow_untimed(name, xml, drop, row):
    """The row's checks that read no device time, run while the settles
    replay: one f64 step card vs CPU at B = 64 from states in contact
    (qpos, qvel, and dist, pos and frame on the lanes that reach the
    solver on either side), and the ops per step (counted on the CPU at
    B = 4).  An env that parts by more than the bar is let pass only as
    a tie of MPR's normal polish: the polish keeps the iterate of least
    s(n) = -depth, and at a flat minimum iterates whose s ties at the
    rounding level differ in n by up to sqrt(eps); so its lanes' depths
    agree within DEPTH_BAR and nothing parts by FLAT_BAR, and at most a
    quarter of the envs in contact part.  Syncs the current stream
    only."""
    m64 = load_model_from_xml(xml, np.float64)
    card = pfwd.step(m64, jittered(m64, 64, "cuda", torch.float64, 7, drop))
    card = tree_map(lambda x: x.cpu(), card)
    ref = pfwd.step(m64, jittered(m64, 64, "cpu", torch.float64, 7, drop))
    lanes = active_lanes(card) | active_lanes(ref)
    touching = int(lanes.any(1).sum())
    gaps = env_gaps(card, ref, lanes)
    depth = torch.where(lanes, (card.contact.dist - ref.contact.dist).abs(),
                        torch.zeros_like(card.contact.dist)).amax(1)
    parted = torch.nonzero(gaps >= CARD_CPU_BAR)[:, 0].tolist()
    ties = [e for e in parted if depth[e] < DEPTH_BAR and gaps[e] < FLAT_BAR]
    held = gaps[[e for e in range(64) if e not in parted]]
    card_cpu = float(held.max()) if len(held) else float("nan")
    ops = count_step_ops(BatchedEnvironment(
        load_model_from_xml(xml, np.float32), bench_configs.BenchTask(), 4,
        device="cpu"))
    row.update(card_vs_cpu_f64=card_cpu, card_cpu_envs_in_contact=touching,
               card_cpu_active_lanes=int(lanes.sum()),
               card_cpu_parted={e: [float(gaps[e]), float(depth[e])]
                                for e in parted},
               torch_ops_per_step=ops["total"],
               us_per_op=row["call_ms"] * 1e3 / NARROW_K / ops["total"])
    log(f"narrowphase {name}: {ops['total']} torch ops per step "
        f"({row['us_per_op']:.3f} us each captured); one f64 step card vs "
        f"CPU at B=64 from {touching} envs in contact "
        f"({int(lanes.sum())} active lanes): {card_cpu:.3e} over the "
        f"{64 - len(parted)} envs held (bar {CARD_CPU_BAR:g}); parted envs "
        + (", ".join(f"{e} by {gaps[e]:.3e}, depths by {depth[e]:.3e} "
                     f"({'a polish tie' if e in ties else 'NOT a tie'})"
                     for e in parted) or "none"))
    if touching < 16 or len(ties) < len(parted) or len(parted) > touching // 4:
        raise AssertionError(f"narrowphase {name}: card vs CPU, {touching} "
                             f"envs in contact, parted {parted}, ties {ties}")


def _lowest_vertex(model, d):
    """The lowest world z of env 0's mesh vertices (the model's last geom,
    a mesh)."""
    from oxide_control_torch.physics import smooth

    d = smooth.kinematics(model, d)
    verts = torch.as_tensor(np.asarray(model.mesh_vert), dtype=d.qpos.dtype,
                            device=d.qpos.device)
    g = model.ngeom - 1
    return float((d.geom_xpos[0, g] + verts @ d.geom_xmat[0, g].T)[:, 2]
                 .min())


def _stack_holds(q, dz):
    return (abs(q[7]) < 1e-4 and abs(q[8]) < 1e-4 and abs(q[9] - 0.3) < dz
            and q[10] > 0.99999)


# name -> (xml, steps, initial qvel of the free body, invariant of env 0's
# final (qpos, qvel) and the model's lowest mesh vertex), the reference
# tests' settles (tests/test_hfield.py, test_mesh.py, test_mpr.py)
SETTLES = {
    "ball rolls to the valley": (
        VALLEY_XML, 3000, None,
        lambda q, v, low: abs(q[0]) < 0.6 and q[2] < 0.35),
    "sphere rests on the flat field": (
        FLAT_XML, 500, None, lambda q, v, low: abs(q[2] - 0.1) < 5e-3),
    "capsule rests on the flat field": (
        CAPSULE_XML, 500, None,
        lambda q, v, low: abs(q[2] - 0.08) < 5e-3 and max(map(abs, v)) < 0.05),
    "tetra settles on the plane": (
        MESH_XML, 600, [0.2, -0.1, -0.5],
        lambda q, v, low: max(map(abs, v)) < 0.05 and low > -5e-3),
    "box stack on an ellipsoid holds": (
        BOX_ON_ELLIPSOID_XML, 2000, None,
        lambda q, v, low: _stack_holds(q, 2e-3)),
    "box stack on a mesh holds": (
        BOX_ON_MESH_XML, 2000, None, lambda q, v, low: _stack_holds(q, 3e-3)),
}
SETTLE_B = 64


def start_settles():
    """The reference tests' settles at their own depths, f64, on B = 64
    identical envs: one step of each model captured in a CUDA graph, and
    every replay enqueued from a thread of its own, each model's on a
    stream of its own, a round at a time: the streams run side by side,
    and the host goes on.  Returns the cases, the start time and the
    thread's future."""
    cases = []
    for name, (xml, steps, qvel, _) in SETTLES.items():
        model = load_model_from_xml(xml, np.float64)
        d = make_data(model, "cuda", torch.float64, batch=SETTLE_B)
        if qvel is not None:
            d.qvel[:, :3] = torch.tensor(qvel, dtype=torch.float64)
        static = tree_map(lambda x: x.clone(), d)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            pfwd.step(model, static)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            tree_map(lambda dst, src: dst.copy_(src), static,
                     pfwd.step(model, static))
        cases.append((name, model, static, graph, steps, side))
    torch.cuda.synchronize()

    def replay():
        marks = []
        for k in range(max(c[4] for c in cases)):
            for _, _, _, graph, steps, stream in cases:
                if k < steps:
                    with torch.cuda.stream(stream):
                        graph.replay()
            # two rounds in flight at most: a full launch queue would also
            # hold the host's other launches (and the longest chain, the
            # first model's, bounds every stream's backlog)
            marks.append(torch.cuda.Event())
            marks[-1].record(cases[0][5])
            if len(marks) > 2:
                mark = marks.pop(0)
                while not mark.query():
                    time.sleep(2e-4)

    pool = ThreadPoolExecutor(1)
    t0 = time.perf_counter()
    future = pool.submit(replay)
    pool.shutdown(wait=False)
    return cases, t0, future


def finish_settles(cases, t0, future):
    """Waits for the settles' thread and streams; every invariant must
    hold and the 64 envs agree bit for bit."""
    future.result()
    for case in cases:
        case[5].synchronize()
    seconds = time.perf_counter() - t0
    out = {}
    for name, model, d, _, steps, _ in cases:
        q, v = d.qpos[0].tolist(), d.qvel[0].tolist()
        mesh_last = GeomType(model.geom_type[-1]) == GeomType.MESH
        low = _lowest_vertex(model, d) if mesh_last else 0.0
        same = bool((d.qpos == d.qpos[:1]).all() and (d.qvel == d.qvel[:1])
                    .all())
        ok = bool(np.isfinite(q).all()) and SETTLES[name][3](q, v, low)
        out[name] = dict(steps=steps, qpos=q, max_abs_qvel=max(map(abs, v)),
                         lowest_vertex=low, envs_bit_identical=same)
        log(f"settle: {name} ({steps} f64 steps, B={SETTLE_B}): qpos "
            f"{[round(x, 6) for x in q]}, max |qvel| {max(map(abs, v)):.3e}"
            + (f", lowest vertex {low:.3e}" if mesh_last else "")
            + f"; invariant {'holds' if ok else 'FAILS'}, {SETTLE_B} envs "
            f"bit-identical {same}")
        if not (ok and same):
            raise AssertionError(f"settle: {name} failed")
    log(f"settle: {sum(c[4] for c in cases)} steps of {len(cases)} models "
        f"side by side in {seconds:.2f} s")
    return dict(models=out, seconds=seconds)


def physics_api_check():
    """Physics on cuda: 100 eager steps of the sphere-on-mesh model from
    the ball resting into the mesh's apex (MPR contacts from the first
    step), every accessor read; its qpos equals env 0 of a batch-1
    BatchedEnvironment stepped 100 times from the same state.  Syncs the
    current stream only."""
    p = Physics.from_xml_string(TET_MESH_XML)
    p.set_qpos(0, [0.14, 0.12, 0.44, 1.0, 0.0, 0.0, 0.0])
    model = p.model
    benv = BatchedEnvironment(model, bench_configs.BenchTask(), 1,
                              dtype=torch.float64)
    d = make_data(model, "cuda", torch.float64, batch=1).replace(
        qpos=p.data.qpos.clone())
    for _ in range(100):
        p.step()
        d, _ = benv.step_envs(d, torch.zeros((1, 0), device="cuda"))
    same = bool(torch.equal(p.data.qpos, d.qpos))
    reads = dict(time=float(p.time), qpos=p.qpos(0).tolist(),
                 qvel=p.qvel(0).tolist(), body_xpos=p.body_xpos("ball")
                 .tolist(), body_xquat=p.body_xquat(2).tolist(),
                 geom_xpos=p.geom_xpos("bg").tolist(),
                 warmstart=float(p.qacc_warmstart(2)),
                 qfrc_applied=float(p.qfrc_applied(0)),
                 xfrc_applied=p.xfrc_applied("ball").tolist(),
                 sensordata=p.sensordata().tolist(), diverged=p.diverged(),
                 object_id=p.object_id("body", "ball"),
                 object_name=p.object_name("geom", 2))
    log(f"Physics on cuda: 100 steps of the sphere-on-mesh model; qpos "
        f"{[round(x, 6) for x in reads['qpos']]} equals env 0 of the "
        f"batch-1 BatchedEnvironment: {same}; time {reads['time']:.3f}, "
        f"diverged {reads['diverged']}")
    if not same or reads["diverged"] or reads["object_name"] != "bg":
        raise AssertionError("Physics on cuda parts from the batched path")
    return dict(reads, matches_batched=same)


def checkpoint_check(roll):
    """A FastRollout state saved with its generator and loaded resumes
    bit for bit for one more call."""
    path = "chiprun_out/narrowphase_ckpt.npz"
    gen = torch.Generator(device="cuda").manual_seed(11)
    state = roll.init(gen)
    state, _ = roll.run(state, gen)
    checkpoint.save(path, roll.unpack(state), generator=gen)
    data, gen2 = checkpoint.load(path, roll.benv.model)
    s1, t1 = roll.run(state, gen)
    s2, t2 = roll.run(roll.pack(data), gen2)
    same = all(torch.equal(a, b) for a, b in zip(s1, s2)) and torch.equal(
        t1.reward_sum, t2.reward_sum)
    log(f"checkpoint: a {roll.benv.num_envs}-env FastRollout state saved, "
        f"loaded and run one more call: bit-identical {same}")
    if not same:
        raise AssertionError("checkpoint: the resumed call parts")
    return same


def _top_device_ops(prof, skip, n=5):
    """The n operations with the most device time, the annotated span
    ``skip`` left out: (name, ms)."""
    def dev_us(e):
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(e, attr):
                return getattr(e, attr)
        return 0.0
    rows = sorted((e for e in prof.key_averages() if e.key != skip),
                  key=dev_us, reverse=True)[:n]
    return [(e.key[:60], dev_us(e) * 1e-3) for e in rows]


def profiler_check(roll):
    """torch.profiler on the card: one FastRollout.run of cheetah-run and
    one captured general step of the ridged-field box (graph replay)."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    state = roll.init(gen)
    roll.run(state, gen)
    with profiling.trace("chiprun_out/profile_cheetah") as prof:
        with profiling.annotate("FastRollout.run"):
            roll.run(state, gen)
    kernel_top = _top_device_ops(prof, "FastRollout.run")
    model = load_model_from_xml(RIDGE_XML, np.float32)
    benv = BatchedEnvironment(model, bench_configs.BenchTask(), NARROW_B)
    jr = jit_rollout(benv, 1)
    data = benv.reset(gen)
    data, _, _ = jr(data, gen)
    with profiling.trace("chiprun_out/profile_ridge") as prof:
        with profiling.annotate("captured general step"):
            jr(data, gen)
    general_top = _top_device_ops(prof, "captured general step")
    tops = (("cheetah-run@4096 FastRollout.run", kernel_top),
            ("box-ridge-prisms@4096 captured step", general_top))
    log("profiler, the five device operations with the most time: "
        + " | ".join(f"{label}: " + "; ".join(
            f"{k} {ms:.3f} ms" for k, ms in top) for label, top in tops))
    if not kernel_top or kernel_top[0][1] <= 0.0:
        raise AssertionError("profiler: no device time recorded")
    return dict(fast_rollout=kernel_top, captured_general_step=general_top)


def narrowphase_phase(rolls, smi, beside):
    """The seven rows (timed, the card to themselves), then the settles on
    their own streams with the untimed checks beside them (``beside()``,
    the general path's f64 checks, which capture no graph; card vs CPU,
    ops per step, Physics, a checkpoint), then the profiler: the
    ``narrowphase`` JSON line's dict and what ``beside`` returned."""
    rows = {name: narrow_row(name, xml, drop)
            for name, xml, drop in NARROW_ROWS}
    cases, t0, future = start_settles()
    extra = beside()
    for name, xml, drop in NARROW_ROWS:
        narrow_untimed(name, xml, drop, rows[name])
    physics = physics_api_check()
    ckpt_ok = checkpoint_check(rolls["cheetah-run@4096"])
    log(f"narrowphase: the untimed checks done "
        f"{time.perf_counter() - t0:.1f} s into the settles")
    settles = finish_settles(cases, t0, future)
    prof = profiler_check(rolls["cheetah-run@4096"])
    return dict(rows=rows, settles=settles, physics=physics,
                checkpoint_bit_identical=ckpt_ok, profiler=prof,
                card=smi), extra


# ---------------------------------------------------------------------------
# the parallel + train phase: the env-axis mesh at world size 1 over NCCL
# and the two trainers on the rollout kernel
# ---------------------------------------------------------------------------

MESH_ROW = "cheetah-run@4096"
MESH_HOP_B, MESH_HOP_K = 1024, 24
TASKS = (("pendulum", "swingup"), ("cartpole", "balance"))
TASKS_B, TASKS_K = 4096, 50


def same_outputs(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def mesh_cheetah_check(mesh, roll):
    """The sharded FastRollout of cheetah-run@4096 (K = 200) against the
    row's: init from one generator state, then the two kernels on one
    ctrl and seed; then one sharded run, its all-reduced mean against the
    local mean."""
    benv, k = roll.benv, roll.steps_per_call
    sharded = FastRollout(benv, k, mesh=mesh)
    s_state = sharded.init(torch.Generator(device="cuda").manual_seed(11))
    u_state = roll.init(torch.Generator(device="cuda").manual_seed(11))
    gen = torch.Generator(device="cuda").manual_seed(12)
    ctrl = torch.empty((k, benv.model.nu, benv.num_envs),
                       device="cuda").uniform_(-1.0, 1.0, generator=gen)
    seed = torch.tensor([20261018], dtype=torch.int32, device="cuda")
    before = sharded.kernel.launches
    so = sharded.kernel(*s_state, ctrl, seed)
    uo = roll.kernel(*u_state, ctrl, seed)
    torch.cuda.synchronize()
    if sharded.kernel.launches != before + 1:
        raise AssertionError("mesh: the sharded kernel did not launch")
    init_same = same_outputs(s_state, u_state)
    kernel_same = same_outputs(so, uo)
    _, traj = sharded.run(s_state, gen)
    mean = float(sharded.mean_return(traj))
    local = float(traj.reward_sum.sum() / benv.num_envs)
    log(f"mesh {MESH_ROW} (world 1, B/world = {sharded.hi - sharded.lo}, "
        f"K = {k}): init bit-identical {init_same}, sharded kernel "
        f"bit-identical to the row's {kernel_same}; all-reduced mean "
        f"{mean!r} vs local {local!r}")
    if not (init_same and kernel_same):
        raise AssertionError("mesh: the sharded kernel's outputs differ")
    if mean != local:
        raise AssertionError("mesh: the all-reduced mean differs")
    return dict(init_bit_identical=init_same,
                kernel_bit_identical=kernel_same, mean_return=mean,
                local_mean=local)


def mesh_hop_check(mesh):
    """The hop model's jit_rollout (general path, captured) sharded and
    unsharded from one state and one generator state."""
    benv = hop_env(MESH_HOP_B)
    data = benv.reset(torch.Generator(device="cuda").manual_seed(13))
    outs = []
    for m in (None, mesh):
        d = data if m is None else shard_env_state(m, data)
        fn = jit_rollout(benv, MESH_HOP_K, mesh=m)
        d, (rew, dones), ret = fn(
            d, torch.Generator(device="cuda").manual_seed(14))
        torch.cuda.synchronize()
        outs.append((d.qpos.clone(), d.qvel.clone(), rew, dones,
                     float(ret)))
    same = same_outputs(outs[0][:4], outs[1][:4])
    resets = int(outs[0][3].sum())
    log(f"mesh hop@{MESH_HOP_B} jit_rollout (K = {MESH_HOP_K}, {resets} "
        f"resets): sharded bit-identical to unsharded {same}; mean return "
        f"{outs[1][4]!r} (all-reduced) vs {outs[0][4]!r}")
    if not same:
        raise AssertionError("mesh: the sharded jit_rollout differs")
    if resets == 0:
        raise AssertionError("mesh hop: no env reset in the window")
    return dict(bit_identical=same, resets=resets,
                mean_return=outs[1][4], unsharded_mean=outs[0][4])


def multitask_check(mesh):
    """Two tasks round-robin on the one rank, called twice with the same
    envs (generators seeded 15, then 16): each task against its solo
    jit_rollout from the same task generator, and the second call
    captures no graph (it replays the first call's)."""
    benvs = [suite.load_batched(d, t, TASKS_B) for d, t in TASKS]
    captures = []
    capture = JitRollout._capture

    def counted(self, *args):
        captures.append(self)
        return capture(self, *args)

    out = {}
    for call, seed in enumerate((15, 16)):
        t0 = time.perf_counter()
        JitRollout._capture = counted
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                got = multitask_rollout(benvs, torch.Generator(
                    device="cuda").manual_seed(seed), TASKS_K, mesh=mesh)
            torch.cuda.synchronize()
        finally:
            JitRollout._capture = capture
        wall = time.perf_counter() - t0
        n_captures = len(captures)
        captures.clear()
        warned = any("round-robin" in str(w.message) for w in caught)
        gens = task_generators(
            torch.Generator(device="cuda").manual_seed(seed), len(benvs))
        res = {}
        for (dom, task), benv, g, (data, ret) in zip(TASKS, benvs, gens,
                                                     got):
            solo, _, sret = jit_rollout(benv, TASKS_K)(benv.reset(g), g)
            torch.cuda.synchronize()
            same = (torch.equal(data.qpos, solo.qpos)
                    and torch.equal(data.qvel, solo.qvel))
            res[f"{dom}-{task}"] = dict(bit_identical=same, mean_return=ret,
                                        solo_mean=float(sret))
            log(f"multitask call {call} {dom}-{task}@{TASKS_B} (K = "
                f"{TASKS_K}): state bit-identical to its solo jit_rollout "
                f"{same}; mean return {ret!r} vs solo {float(sret)!r}")
            if not same or abs(ret - float(sret)) > 1e-6 * max(1.0,
                                                               abs(ret)):
                raise AssertionError(f"multitask {dom}-{task}: differs "
                                     "from its solo rollout")
        log(f"multitask call {call}: {len(benvs)} tasks in {wall:.2f} s, "
            f"{n_captures} graph captures; round-robin warning {warned}")
        if not warned:
            raise AssertionError("multitask: no round-robin warning")
        if call and n_captures:
            raise AssertionError("multitask: the second call captured "
                                 f"{n_captures} graphs")
        out[f"call {call}"] = dict(tasks=res, wall_s=wall,
                                   graph_captures=n_captures, warned=warned)
    return out


def parallel_phase(rolls):
    """(a): NCCL at world size 1 through multihost_initialize on a file
    store, then the mesh checks, multitask and dryrun_multichip(1) on
    that group; then, the group taken down, dryrun_multichip(1) again,
    which spawns its own NCCL rank."""
    store = tempfile.mkdtemp(prefix="oxc-nccl-")
    try:
        t0 = time.perf_counter()
        multihost_initialize(backend="nccl",
                             init_method="file://" + os.path.join(store, "s"),
                             rank=0, world_size=1)
        mesh = make_env_mesh()
        log(f"parallel: NCCL group of {mesh.world_size} on {mesh.device} in "
            f"{time.perf_counter() - t0:.2f} s")
        out = dict(world_size=mesh.world_size, backend=dist.get_backend(),
                   cheetah=mesh_cheetah_check(mesh, rolls[MESH_ROW]),
                   hop=mesh_hop_check(mesh), multitask=multitask_check(mesh))
        t = time.perf_counter()
        dryrun.dryrun_multichip(1)
        torch.cuda.synchronize()
        out["dryrun_s"] = time.perf_counter() - t
        log(f"dryrun_multichip(1): three stages in {out['dryrun_s']:.2f} s")
        dist.destroy_process_group()
        # with no group up, the entry point spawns its own NCCL rank
        t = time.perf_counter()
        dryrun.dryrun_multichip(1)
        out["dryrun_spawned_s"] = time.perf_counter() - t
        log("dryrun_multichip(1) with no group up: one spawned NCCL rank, "
            f"three stages in {out['dryrun_spawned_s']:.2f} s")
    finally:
        shutil.rmtree(store, ignore_errors=True)
    return out


def train_phase(smi):
    """(b), (c): PPO and ES at the reference's defaults on the card;
    each must clear its margin (the trainer raises otherwise) and launch
    its kernel once per rollout call."""
    out = {}
    for name, mod, per_iter in (("ppo", ppo, lambda c: 1),
                                ("es", es, lambda c: 2 * c.pop + 1)):
        cfg = mod.config_from_env({})
        h = mod.train(config=cfg, log=log)
        want = cfg.iters * per_iter(cfg)
        log(f"train {name}: {h['launches']} launches (want {want}), "
            f"{h['wall_s']:.2f} s, {h['steps_per_s']:.6e} env-steps/s, "
            f"first-3 {h['first3']:.3f} -> last-3 {h['last3']:.3f} "
            f"(margin {h['margin']:.3f})")
        if h["launches"] != want:
            raise AssertionError(f"train {name}: {h['launches']} kernel "
                                 f"launches, want {want}")
        out[name] = h
    out["card"] = smi
    return out


def trainer_kernels(modes, plain, par, built, trained):
    """The trainers' rows of the kernels line: time, bound and plain
    version at the parity mode's K = 24, and the kernel alone at the
    trainer's K = 200 on the same kind of inputs."""
    rows = []
    for label in TRAINER_MODES:
        benv, fn, _ = modes[label]
        args, kw = plain[label]["args"], plain[label]["kw"]
        ms, out = time_kernel(fn, args, kw)
        b_ms, by, work = bound(fn, built[label], resets_of(fn, args, out))
        name = label.split("@")[0]
        h = trained[name]
        k200 = mk.build_rollout(benv.model, benv.num_envs, h["steps"],
                                fn.hooks, emit_obs=fn.emit_obs,
                                policy=fn.policy)
        a200, kw200 = parity_inputs(benv, k200, "row")
        ms200, out200 = time_kernel(k200, a200, kw200)
        b200, by200, _ = bound(k200, built[label],
                               resets_of(k200, a200, out200))
        rows.append(dict(
            name=f"rollout[{label}]", route="cuda",
            source="oxide_control_torch/ops/csrc/rollout.cu",
            replaces=mk.REPLACES, launches=h["launches"],
            max_abs_err=max(par[label]["errs"].values()), ms=ms,
            plain_ms=plain[label]["plain_ms"], bound_ms=b_ms, bound_by=by,
            library_ms=None, steps=fn.steps, bit_identical=par[label]["same"],
            env_steps_per_s=h["steps_per_s"], team=built[label].team,
            ms_k200=ms200, bound_ms_k200=b200, bound_by_k200=by200,
            work=work))
        log(f"kernel {label}: {ms:.4f} ms per call at K = {fn.steps} "
            f"(bound {b_ms:.4f} ms, {by}; plain {plain[label]['plain_ms']:.1f}"
            f" ms), {ms200:.4f} ms at K = {h['steps']} (bound {b200:.4f} ms,"
            f" {by200}); {h['launches']} launches in training")
    return rows



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
    # the trainers' policies: PPO's explores with its sigma, ES's does not
    trainer_policies = {
        "ppo": MLPPolicy(hooks.n_obs, cheetah.model.nu, hidden=(64, 64),
                         explore_sigma=ppo.Config().sigma, generator=gen),
        "es": MLPPolicy(hooks.n_obs, cheetah.model.nu, hidden=(64, 64),
                        generator=gen)}
    for label, key, k, variant in EXTRA_MODES:
        benv = benvs[key]
        modes[label] = (benv, mk.build_rollout(
            benv.model, benv.num_envs, k,
            gauss if variant == "gauss"
            else benv.task.kernel_hooks(benv.model),
            emit_obs=variant in ("explore", "gauss", "collect", "ppo"),
            policy=(explorer if variant == "explore"
                    else trainer_policies.get(variant)),
            applied_forces=variant == "applied"), variant)
    fma = mk.build_rollout(cheetah.model, 4096, 200, hooks, fmad=True)
    # the one-lane builds the team builds are timed against
    solo = {row: mk.build_rollout(
        roll.benv.model, roll.benv.num_envs, roll.steps_per_call,
        roll.kernel.hooks, emit_obs=roll.collect, policy=roll.policy,
        team=1) for row, roll in rolls.items() if row in SOLO_ROWS}

    hop_benv = hop_env(HOP_B)
    hop = mk.build_rollout(hop_benv.model, HOP_B, HOP_K,
                           hop_benv.task.kernel_hooks(hop_benv.model))
    # dryrun_multichip's two hop sources, built here with the rest
    dry = {}
    for sensors in (False, True):
        denv = dryrun.hop_env(2, "cuda", sensors=sensors)
        dhooks = denv.task.kernel_hooks(denv.model)
        pol = (MLPPolicy(dhooks.n_obs, denv.model.nu, hidden=(4,))
               if sensors else None)
        dry[f"dryrun hop{' sensors' if sensors else ''}"] = mk.build_rollout(
            denv.model, 2, 2, dhooks, emit_obs=sensors, policy=pol)

    t_build = time.perf_counter()
    pool, futures = start_builds(
        {**{label: fn for label, (_, fn, _) in modes.items()}, "fmad": fma,
         **{f"{row} G=1": fn for row, fn in solo.items()},
         "general hop": hop, **dry})
    philox_phase()
    t = time.perf_counter()
    plain = plain_phase(modes)
    log(f"phase plain: {time.perf_counter() - t:.1f} s")
    built = finish_builds(pool, futures, t_build)
    # the outside models' CPU steps, in a process of their own from here
    cpu_pool = ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    cpu_steps = cpu_pool.submit(outside_cpu_steps)
    t = time.perf_counter()
    par = parity_phase(modes, plain)
    timed = timing_phase(rolls, plain, fma, solo)
    log(f"phase parity + timing: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    rows = main_path_phase(rolls)
    log(f"phase main path: {time.perf_counter() - t:.1f} s")
    # the general and narrowphase phases, their timed rows first (the card
    # to themselves), then the untimed checks: the f64 ones beside the
    # settles, the outside models (which capture graphs) after them
    t = time.perf_counter()
    hop_errs = general_hop_phase(hop)
    general = general_rows_phase(rows, smi)
    log(f"phase general (hop, rows): {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    narrow, f64 = narrowphase_phase(rolls, smi, general_f64_phase)
    outside = general_outside_phase(cpu_steps.result())
    cpu_pool.shutdown()
    general.update(hop=hop_errs, f64=f64, outside=outside)
    log(f"phase narrowphase + general f64 and outside: "
        f"{time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    parallel = parallel_phase(rolls)
    trained = train_phase(smi)
    log(f"phase parallel + train: {time.perf_counter() - t:.1f} s")

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
    kernels += trainer_kernels(modes, plain, par, built, trained)
    log(f"card: {smi}; whole run {time.perf_counter() - T0:.1f} s")
    print(json.dumps({"general": general}), flush=True)
    print(json.dumps({"narrowphase": narrow}), flush=True)
    print(json.dumps({"parallel": dict(parallel, card=smi)}), flush=True)
    print(json.dumps({"train": trained}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
