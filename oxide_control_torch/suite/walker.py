"""Planar walker stand / walk / run (BASELINE.md config 2)."""

from __future__ import annotations

import math

import numpy as np
import torch

from ..model import Model
from ..state import Data
from . import rewards
from .common import (load_asset, normal, randomize_limited_joints,
                     time_limit_done)

_STAND_HEIGHT = 1.2
_WALK_SPEED = 1.0
_RUN_SPEED = 8.0
_TIME_LIMIT = 25.0


class _Walker:
    """Stand tall and upright, and move forward at ``move_speed``: the
    torso's height and uprightness come from the step's FK
    (``EnvHooks.needs_fk``)."""

    discount = 1.0

    def __init__(self, model: Model, move_speed: float,
                 time_limit: float = _TIME_LIMIT):
        self.move_speed = move_speed
        self.time_limit = time_limit
        self._torso = model.name2id("body", "torso")

    def init_episode(self, model: Model, data: Data,
                     generator: torch.Generator) -> Data:
        """Batched: limited joints uniform within 10% of their range around
        its midpoint, qvel ~ N(0, 0.01^2)."""
        qpos = randomize_limited_joints(model, data.qpos, generator,
                                        fraction=0.1)
        qvel = 0.01 * normal(generator, data.qvel.shape, data.qvel.dtype,
                             data.qvel.device)
        return data.replace(qpos=qpos, qvel=qvel)

    def observe(self, model: Model, data: Data) -> torch.Tensor:
        """[1.3 + rootz], qpos[2:] and qvel."""
        return torch.cat([data.qpos[:, :1] + 1.3, data.qpos[:, 2:],
                          data.qvel], -1)

    def reward(self, model: Model, data: Data, obs, action):
        standing = rewards.tolerance(
            None, data.xpos[:, self._torso, 2],
            bounds=(_STAND_HEIGHT, math.inf), margin=_STAND_HEIGHT / 2)
        upright = (1.0 + data.xmat[:, self._torso, 2, 2]) / 2.0
        stand = (3.0 * standing + upright) / 4.0
        if self.move_speed == 0:
            return stand
        move = rewards.tolerance(
            None, data.qvel[:, 1], bounds=(self.move_speed, math.inf),
            margin=self.move_speed / 2, value_at_margin=0.5,
            sigmoid="linear")
        return stand * (5.0 * move + 1.0) / 6.0

    def done(self, model: Model, data: Data, obs):
        return time_limit_done(data, self.time_limit)

    def kernel_hooks(self, model: Model):
        """In-kernel env layer (ops/megakernel.py).  The reward reads the
        torso frame from ``scalar_graph.build_fk``; resets follow
        init_episode's distribution exactly."""
        from ..ops.megakernel import EnvHooks

        move_speed = self.move_speed
        torso = self._torso

        def reward(bk, q, v, ctrl, fk):
            standing = rewards.tolerance(
                bk, fk["xpos"][torso][2], bounds=(_STAND_HEIGHT, math.inf),
                margin=_STAND_HEIGHT / 2)
            upright = (1.0 + fk["xmat"][torso][8]) / 2.0
            stand = (3.0 * standing + upright) / 4.0
            if move_speed == 0:
                return stand
            move = rewards.tolerance(
                bk, v[1], bounds=(move_speed, math.inf),
                margin=move_speed / 2, value_at_margin=0.5, sigmoid="linear")
            return stand * (5.0 * move + 1.0) / 6.0

        def observe(bk, q, v):
            # [1.3 + rootz] + qpos[2:] + qvel: rootx is translation-invariant
            return [1.3 + q[0]] + list(q[2:]) + list(v)

        mask = np.zeros(model.nq)
        qpos0 = np.asarray(model.qpos0, dtype=np.float64).copy()
        jnt_range = np.asarray(model.jnt_range, dtype=np.float64)
        for j in range(model.njnt):
            if model.jnt_limited[j]:
                adr = model.jnt_qposadr[j]
                lo, hi = jnt_range[j]
                mask[adr] = 0.05 * float(hi - lo)
                # randomize_limited_joints centers on the range midpoint
                qpos0[adr] = 0.5 * float(lo + hi)
        return EnvHooks(
            reward=reward,
            time_limit=self.time_limit,
            reset_noise=1.0,  # per-coordinate amplitude carried by the mask
            reset_mask=mask,
            reset_qpos0=qpos0,
            reset_qvel_sigma=0.01,
            observe=observe,
            n_obs=1 + (model.nq - 2) + model.nv,
            needs_fk=True,
        )


def _make(speed):
    def factory(model: Model | None = None, dtype=np.float32, **kw):
        m = model if model is not None else load_asset("walker", dtype=dtype)
        return m, _Walker(m, move_speed=speed, **kw)

    return factory


stand = _make(0.0)
walk = _make(_WALK_SPEED)
run = _make(_RUN_SPEED)
