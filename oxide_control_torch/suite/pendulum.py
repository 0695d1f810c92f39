"""Pendulum swingup (BASELINE.md config 0)."""

from __future__ import annotations

import math

import numpy as np
import torch

from ..model import Model
from ..state import Data
from . import rewards
from .common import load_asset, time_limit_done, uniform

_TIME_LIMIT = 20.0


class SwingUp:
    """Swing the pole upright and balance (dm_control pendulum.swingup
    style: reward = tolerance(cos(angle), (0.95, 1), margin=1.95))."""

    discount = 1.0

    def __init__(self, model: Model, time_limit: float = _TIME_LIMIT):
        self.time_limit = time_limit
        self._hinge_qadr = model.jnt_qposadr[model.name2id("joint", "hinge")]

    def init_episode(self, model: Model, data: Data,
                     generator: torch.Generator) -> Data:
        """Batched: the hinge angle ~ U(-pi, pi)."""
        qpos = data.qpos.clone()
        qpos[:, self._hinge_qadr] = uniform(
            generator, -math.pi, math.pi, qpos.shape[:1], qpos.dtype,
            qpos.device)
        return data.replace(qpos=qpos)

    def observe(self, model: Model, data: Data) -> torch.Tensor:
        """[cos(theta), sin(theta), qvel[0]]."""
        theta = data.qpos[:, self._hinge_qadr]
        return torch.stack([torch.cos(theta), torch.sin(theta),
                            data.qvel[:, 0]], -1)

    def reward(self, model: Model, data: Data, obs, action):
        return rewards.tolerance(None, obs[:, 0], bounds=(0.95, 1.0),
                                 margin=1.95)

    def done(self, model: Model, data: Data, obs):
        return time_limit_done(data, self.time_limit)

    def kernel_hooks(self, model: Model):
        """In-kernel env layer (ops/megakernel.py): reward =
        tolerance(cos(theta), (0.95, 1), margin=1.95); resets draw the
        hinge uniformly over [-pi, pi] as init_episode does."""
        from ..ops.megakernel import EnvHooks

        qadr = self._hinge_qadr

        def reward(bk, q, v, ctrl):
            return rewards.tolerance(bk, bk.cos(q[qadr]), bounds=(0.95, 1.0),
                                     margin=1.95)

        def observe(bk, q, v):
            # [cos(theta), sin(theta), qvel[0]]
            return [bk.cos(q[qadr]), bk.sin(q[qadr]), v[0]]

        mask = np.zeros(model.nq)
        mask[qadr] = np.pi
        return EnvHooks(
            reward=reward,
            time_limit=self.time_limit,
            reset_noise=1.0,
            reset_mask=mask,
            observe=observe,
            n_obs=3,
        )


def swingup(model: Model | None = None, dtype=np.float32, **kw):
    model = model if model is not None else load_asset("pendulum",
                                                       dtype=dtype)
    return model, SwingUp(model, **kw)
