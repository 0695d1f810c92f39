"""The two tasks, as the configurations state them, on the reference's
physics.

* ``cheetah`` run: the observation is ``qpos[1:]`` then ``qvel``; the
  reward is dm_control's ``tolerance`` of the root's forward velocity
  ``qvel[0]`` with bounds (10, inf), margin 10, linear, 0 at the margin.
* ``humanoid`` run: the observation is ``qpos[2:]`` then ``qvel``; the
  reward is the product of standing (the head body's height, bounds
  (1.4, inf), margin 0.35, Gaussian, 0.1 at the margin), upright (the
  torso frame's z-z entry, bounds (0.9, inf), margin 1.9, linear), small
  control ((4 + mean over the action of a quadratic tolerance, margin
  1) / 5) and move ((5 m + 1) / 6, m the tolerance of the root's
  horizontal speed with bounds (10, inf), margin 10, linear).

Both end at their time limit.  A new episode, on the general path, is
drawn from the caller's generator with the draws the configuration's
``reset_noise`` names, in float32 on the generator's device: the qpos
noise (uniform in [-1, 1) times ``qpos_uniform``, or normal times
``qpos_normal``) on every coordinate but ``keep_qpos``, then, if
``qvel_normal``, the qvel noise.
"""

from __future__ import annotations

import math

import torch

from . import mjcf
from .physics import Model, kinematics

TASKS = {
    "cheetah": {"obs_skip": 1},
    "humanoid": {"obs_skip": 2, "head": "head", "torso": "torso",
                 "stand_height": 1.4, "speed": 10.0},
}


def tolerance(x, lower: float, upper: float, margin: float,
              sigmoid: str, value_at_margin: float):
    """dm_control's ``rewards.tolerance``: 1 within the bounds, falling
    off outside through ``sigmoid`` to ``value_at_margin`` at a distance
    of ``margin``."""
    inside = (x >= lower) & (x <= upper)
    d = torch.where(x < lower, lower - x, x - upper) / margin
    if sigmoid == "gaussian":
        scale = math.sqrt(-2.0 * math.log(value_at_margin))
        v = torch.exp(-0.5 * (d * scale) ** 2)
    elif sigmoid == "linear":
        s = d * (1.0 - value_at_margin)
        v = torch.where(s.abs() < 1.0, 1.0 - s, torch.zeros_like(s))
    elif sigmoid == "quadratic":
        s = d * math.sqrt(1.0 - value_at_margin)
        v = torch.where(s.abs() < 1.0, 1.0 - s * s, torch.zeros_like(s))
    else:
        raise ValueError(sigmoid)
    return torch.where(inside, torch.ones_like(v), v)


class Task:
    """The task of ``config`` (its ``domain``) on a reference model."""

    def __init__(self, config: dict, device):
        self.domain = config["domain"]
        self.info = TASKS[self.domain]
        self.model = Model(mjcf.load(self.domain), device)
        self.obs_skip = self.info["obs_skip"]
        if self.obs_skip != int(config["obs_skip_qpos"]):
            raise ValueError("the configuration's observation is not the "
                             "task's")
        self.config = config

    def observe(self, qpos, qvel):
        return torch.cat([qpos[:, self.obs_skip:], qvel], -1)

    def reward(self, qpos, qvel, action):
        if self.domain == "cheetah":
            return tolerance(qvel[:, 0], 10.0, math.inf, 10.0, "linear", 0.0)
        info, spec = self.info, self.model.spec
        kin = kinematics(self.model, qpos)
        head_z = kin["xpos"][:, spec.body_id(info["head"]), 2]
        torso_zz = kin["xmat"][:, spec.body_id(info["torso"]), 2, 2]
        h = info["stand_height"]
        standing = tolerance(head_z, h, math.inf, h / 4, "gaussian", 0.1)
        upright = tolerance(torso_zz, 0.9, math.inf, 1.9, "linear", 0.0)
        small = tolerance(action.to(qpos.dtype), 0.0, 0.0, 1.0,
                          "quadratic", 0.0).mean(-1)
        small = (4.0 + small) / 5.0
        speed = torch.sqrt((qvel[:, 0:2] ** 2).sum(-1))
        move = tolerance(speed, info["speed"], math.inf, info["speed"],
                         "linear", 0.0)
        move = (5.0 * move + 1.0) / 6.0
        return small * standing * upright * move

    def episode(self, generator: torch.Generator, batch: int, device):
        """New episodes of the general path, float32 (qpos, qvel), from
        ``generator``."""
        noise = self.config["reset_noise"]
        m = self.model
        f32 = torch.float32
        qpos0 = m.qpos0.to(device, f32).expand(batch, m.nq)
        draw = torch.empty((batch, m.nq), dtype=f32, device=device)
        if noise["qpos_uniform"]:
            draw.uniform_(-1.0, 1.0, generator=generator)
            draw = noise["qpos_uniform"] * draw
        else:
            draw.normal_(generator=generator)
            draw = noise["qpos_normal"] * draw
        draw[:, noise["keep_qpos"]] = 0.0
        qvel = torch.zeros((batch, m.nv), dtype=f32, device=device)
        if noise["qvel_normal"]:
            qvel = qvel.normal_(generator=generator) * noise["qvel_normal"]
        return qpos0 + draw, qvel
