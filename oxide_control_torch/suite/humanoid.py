"""Humanoid stand / walk / run (BASELINE.md config 3)."""

from __future__ import annotations

import math

import numpy as np
import torch

from ..model import Model
from ..ops.scalar_graph import sum_scalars
from ..state import Data
from . import rewards
from .common import load_asset, normal, time_limit_done

_STAND_HEIGHT = 1.4
_WALK_SPEED = 1.0
_RUN_SPEED = 10.0
_TIME_LIMIT = 25.0


class _Humanoid:
    """Keep the head high and the torso upright with small controls, and
    move horizontally at ``move_speed`` (stand: stay put).  Head height
    and torso uprightness come from the step's FK (``EnvHooks.needs_fk``)."""

    discount = 1.0

    def __init__(self, model: Model, move_speed: float,
                 time_limit: float = _TIME_LIMIT):
        self.move_speed = move_speed
        self.time_limit = time_limit
        self._head = model.name2id("body", "head")
        self._torso = model.name2id("body", "torso")

    def init_episode(self, model: Model, data: Data,
                     generator: torch.Generator) -> Data:
        """Batched: qpos ~ qpos0 + N(0, 0.01^2) with the root quaternion
        (qpos[3:7]) untouched, qvel ~ N(0, 0.01^2)."""
        noise = 0.01 * normal(generator, data.qpos.shape, data.qpos.dtype,
                              data.qpos.device)
        noise[:, 3:7] = 0.0
        qvel = 0.01 * normal(generator, data.qvel.shape, data.qvel.dtype,
                             data.qvel.device)
        return data.replace(qpos=data.qpos + noise, qvel=qvel)

    def observe(self, model: Model, data: Data) -> torch.Tensor:
        """qpos[2:] and qvel: root x/y are translation-invariant."""
        return torch.cat([data.qpos[:, 2:], data.qvel], -1)

    def reward(self, model: Model, data: Data, obs, action):
        standing = rewards.tolerance(
            None, data.xpos[:, self._head, 2],
            bounds=(_STAND_HEIGHT, math.inf), margin=_STAND_HEIGHT / 4)
        upright = rewards.tolerance(
            None, data.xmat[:, self._torso, 2, 2], bounds=(0.9, math.inf),
            margin=1.9, value_at_margin=0.0, sigmoid="linear")
        stand_reward = standing * upright
        action = torch.as_tensor(action, dtype=data.qpos.dtype,
                                 device=data.qpos.device)
        small_control = rewards.tolerance(
            None, action, margin=1.0, value_at_margin=0.0,
            sigmoid="quadratic").mean(-1)
        small_control = (4.0 + small_control) / 5.0
        if self.move_speed == 0:
            dont_move = rewards.tolerance(None, data.qvel[:, 0:2],
                                          margin=2.0).mean(-1)
            return small_control * stand_reward * dont_move
        horiz = torch.sqrt((data.qvel[:, 0:2] ** 2).sum(-1))
        move = rewards.tolerance(
            None, horiz, bounds=(self.move_speed, math.inf),
            margin=self.move_speed, value_at_margin=0.0, sigmoid="linear")
        move = (5.0 * move + 1.0) / 6.0
        return small_control * stand_reward * move

    def done(self, model: Model, data: Data, obs):
        return time_limit_done(data, self.time_limit)

    def kernel_hooks(self, model: Model):
        """In-kernel env layer (ops/megakernel.py); resets follow
        init_episode's distribution exactly."""
        from ..ops.megakernel import EnvHooks

        head, torso = self._head, self._torso
        move_speed = self.move_speed

        def reward(bk, q, v, ctrl, fk):
            standing = rewards.tolerance(
                bk, fk["xpos"][head][2], bounds=(_STAND_HEIGHT, math.inf),
                margin=_STAND_HEIGHT / 4)
            # torso z-axis . world z
            upright = rewards.tolerance(
                bk, fk["xmat"][torso][8], bounds=(0.9, math.inf),
                margin=1.9, value_at_margin=0.0, sigmoid="linear")
            stand_reward = standing * upright
            sc = sum_scalars([
                rewards.tolerance(bk, c, margin=1.0, value_at_margin=0.0,
                                  sigmoid="quadratic") for c in ctrl])
            small_control = (4.0 + sc / len(ctrl)) / 5.0
            if move_speed == 0:
                dont_move = 0.5 * (rewards.tolerance(bk, v[0], margin=2.0)
                                   + rewards.tolerance(bk, v[1], margin=2.0))
                return small_control * stand_reward * dont_move
            horiz = bk.sqrt(v[0] * v[0] + v[1] * v[1])
            move = rewards.tolerance(
                bk, horiz, bounds=(move_speed, math.inf), margin=move_speed,
                value_at_margin=0.0, sigmoid="linear")
            move = (5.0 * move + 1.0) / 6.0
            return small_control * stand_reward * move

        def observe(bk, q, v):
            # qpos[2:] + qvel: root x/y are translation-invariant
            return list(q[2:]) + list(v)

        sigma = np.full(model.nq, 0.01)
        sigma[3:7] = 0.0  # the root quaternion stays at qpos0's
        return EnvHooks(
            reward=reward,
            time_limit=self.time_limit,
            reset_qpos_sigma=sigma,
            reset_qvel_sigma=0.01,
            observe=observe,
            n_obs=(model.nq - 2) + model.nv,
            needs_fk=True,
        )


def _make(speed):
    def factory(model: Model | None = None, dtype=np.float32, **kw):
        m = model if model is not None else load_asset("humanoid",
                                                       dtype=dtype)
        return m, _Humanoid(m, move_speed=speed, **kw)

    return factory


stand = _make(0.0)
walk = _make(_WALK_SPEED)
run = _make(_RUN_SPEED)
