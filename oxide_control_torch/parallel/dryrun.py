"""A multi-device dry run of the sharded paths: ``dryrun_multichip(n)``.

The port of the reference's ``__graft_entry__.dryrun_multichip``.  Three
stages over an env mesh of ``n`` ranks, on tiny shapes:

1. cheetah-run at B = 2n, 2 steps of the sharded general-path ``rollout``
   (its mean return all-reduced over the mesh);
2. the hop model (a slide + hinge ball on a plane: contacts, a limit, a
   motor, Newton, Euler) through ``FastRollout(mesh=)``, K = 2;
3. the hop model observed through ``SensorObsWrapper`` (gyro,
   accelerometer with the qacc carry, framepos) with an in-kernel
   ``MLPPolicy((4,))`` and ``collect=True``: the trajectory's shapes and
   finiteness.

It runs on the current process group (its first ``n`` ranks, each on its
card), or, when no group is up, spawns ``n`` processes that form a
group through a ``file://`` store: NCCL ranks, one per card (it raises
with fewer than ``n`` cards), or gloo ranks on the CPU where the caller
passes ``device='cpu'``.  Run it as ``python -m
oxide_control_torch.parallel.dryrun N [--device cpu]``.

The module also holds the hop model that the port's tests and
``chip_smoke.py`` drive (``hop_env``).
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from .. import default_device, suite
from ..api.environment import BatchedEnvironment
from ..mjcf.compile import load_model_from_xml
from ..ops.megakernel import EnvHooks
from ..policy import MLPPolicy
from ..suite.common import SensorObsWrapper, time_limit_done
from .mesh import make_env_mesh, multihost_initialize, shard_env_state
from .rollout import FastRollout, rollout

# seconds a spawned rank may take (the cheetah's plain steps on the CPU
# take a few seconds; a card's rank builds the two hop kernels)
SPAWN_TIMEOUT_S = 600


def hop_xml(height: float = 0.5, sensors: bool = False) -> str:
    """The reference's hop model (``tests/test_sharding.py:_HOP_XML``): a
    ball on a slide and a limited hinge above a plane, a motor, Newton;
    the ball starts ``height`` m up.  With ``sensors``, an IMU site with a
    gyro, an accelerometer and a framepos."""
    site = sense = ""
    if sensors:
        site = '\n      <site name="imu" pos="0 0 0.1"/>'
        sense = """
  <sensor>
    <gyro site="imu"/>
    <accelerometer site="imu"/>
    <framepos objtype="site" objname="imu"/>
  </sensor>"""
    return f"""
<mujoco>
  <option timestep="0.01" solver="Newton" iterations="4" tolerance="0"/>
  <worldbody>
    <geom name="floor" type="plane" size="5 5 .1"/>
    <body name="ball" pos="0 0 {height}">
      <joint name="z" type="slide" axis="0 0 1"/>
      <joint name="tilt" type="hinge" axis="0 1 0" range="-1 1"
             limited="true"/>
      <geom name="b" type="sphere" size="0.15" mass="1"/>{site}
    </body>
  </worldbody>
  <actuator><motor joint="z" gear="10"/></actuator>{sense}
</mujoco>
"""


class HopTask:
    """Reward clip(qpos[0], 0, 1), episodes of ``time_limit`` s, the
    kernel's reset noise ``reset_noise``.  With ``init_noise`` an episode
    starts at a height moved by U(-init_noise, init_noise), drawn from
    the caller's generator, so that the envs differ."""

    discount = 1.0

    def __init__(self, time_limit: float = 0.5, reset_noise: float = 0.01,
                 init_noise: float = 0.0):
        self.time_limit = time_limit
        self.reset_noise = reset_noise
        self.init_noise = init_noise

    def init_episode(self, model, data, generator):
        if not self.init_noise:
            return data
        qpos = data.qpos.clone()
        qpos[:, 0] += torch.empty_like(qpos[:, 0]).uniform_(
            -self.init_noise, self.init_noise, generator=generator)
        return data.replace(qpos=qpos)

    def observe(self, model, data):
        return torch.cat([data.qpos, data.qvel], -1)

    def reward(self, model, data, obs, action):
        return torch.clamp(data.qpos[:, 0], 0.0, 1.0)

    def done(self, model, data, obs):
        return time_limit_done(data, self.time_limit)

    def kernel_hooks(self, model):
        return EnvHooks(
            reward=lambda bk, q, v, c: bk.clip(q[0], 0.0, 1.0),
            time_limit=self.time_limit, reset_noise=self.reset_noise,
            observe=lambda bk, q, v: list(q) + list(v),
            n_obs=model.nq + model.nv)


def hop_env(batch: int, device=None, sensors: bool = False,
            height: float = 0.5, **task) -> BatchedEnvironment:
    """The hop model's batch (f32) with a :class:`HopTask` of ``task``'s
    fields; with ``sensors``, the IMU's readings appended to the
    observation."""
    hop = HopTask(**task)
    return BatchedEnvironment(
        load_model_from_xml(hop_xml(height, sensors), np.float32),
        SensorObsWrapper(hop) if sensors else hop, batch, device=device)


def _check(ok, what):
    if not ok:
        raise AssertionError(f"dryrun_multichip: {what}")


def run_stages(mesh) -> None:
    """The three stages on ``mesh``."""
    dev, world = mesh.device, mesh.world_size
    batch = 2 * world
    local = batch // world
    gen = lambda s: torch.Generator(device=dev).manual_seed(s)

    benv = suite.load_batched("cheetah", "run", batch, device=dev)
    data = shard_env_state(mesh, benv.reset(gen(0)))
    _, (rew, _), ret = rollout(benv, data, gen(1), 2, mesh=mesh)
    _check(rew.shape == (2, local), f"rewards of shape {tuple(rew.shape)}")
    _check(bool(torch.isfinite(ret)), "a non-finite mean return")

    roll = FastRollout(hop_env(batch, dev), 2, mesh=mesh)
    _, traj = roll.run(roll.init(gen(2)), gen(3))
    _check(traj.reward_sum.shape == (local,), "reward_sum's shape")
    _check(bool(torch.isfinite(roll.mean_return(traj))),
           "a non-finite mean return")

    sens = hop_env(batch, dev, sensors=True)
    n_obs = sens.task.kernel_hooks(sens.model).n_obs
    pol = MLPPolicy(n_obs, sens.model.nu, hidden=(4,), generator=gen(4),
                    device=dev)
    roll2 = FastRollout(sens, 2, policy=pol, collect=True, mesh=mesh)
    _, traj2 = roll2.run(roll2.init(gen(5)), gen(6))
    _check(traj2.obs.shape == (2, n_obs, local), "obs's shape")
    _check(traj2.ctrls.shape == (2, sens.model.nu, local), "ctrls's shape")
    _check(bool(torch.isfinite(traj2.obs).all()), "non-finite observations")


def _worker(rank: int, n: int, store: str, backend: str):
    if backend == "nccl":
        torch.cuda.set_device(rank)
    multihost_initialize(backend=backend, init_method=f"file://{store}",
                         rank=rank, world_size=n)
    try:
        run_stages(make_env_mesh(device="cpu" if backend == "gloo"
                                 else None))
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device=None) -> None:
    """The three stages over ``n_devices`` ranks: the first ``n_devices``
    of the current process group (every rank of it must call; ``device``
    as in ``make_env_mesh``), or, when no group is up, ``n_devices``
    spawned processes: NCCL ranks on cards 0 .. n - 1 (raises with fewer
    cards), or gloo ranks on the CPU with ``device='cpu'``.  Raises if a
    stage fails on any rank."""
    if dist.is_initialized():
        mesh = make_env_mesh(n_devices, device=device)
        if mesh is not None:
            run_stages(mesh)
        return
    if device is None:
        default_device()
        if torch.cuda.device_count() < n_devices:
            raise RuntimeError(f"dryrun_multichip({n_devices}): "
                               f"{torch.cuda.device_count()} CUDA devices")
        backend = "nccl"
    elif torch.device(device).type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"device {device!r}: None (one card per rank) or "
                         "'cpu'")
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_worker,
                             args=(r, n_devices, store, backend))
                 for r in range(n_devices)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(SPAWN_TIMEOUT_S)
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join()
        codes = [p.exitcode for p in procs]
    if alive or any(codes):
        raise RuntimeError(f"dryrun_multichip({n_devices}): the ranks "
                           f"exited {codes}")


if __name__ == "__main__":
    parser = argparse.ArgumentParser(
        description="the sharded paths' three-stage dry run over N ranks")
    parser.add_argument("n", type=int, nargs="?", default=2)
    parser.add_argument("--device", default=None,
                        help="'cpu': gloo ranks on the CPU (default: one "
                             "NCCL rank per card)")
    args = parser.parse_args()
    dryrun_multichip(args.n, args.device)
