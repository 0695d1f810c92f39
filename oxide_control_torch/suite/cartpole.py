"""Cartpole balance / swingup (BASELINE.md config 1)."""

from __future__ import annotations

import math

import numpy as np
import torch

from ..model import Model
from ..state import Data
from . import rewards
from .common import load_asset, normal, time_limit_done, uniform

_TIME_LIMIT = 10.0


class _Cartpole:
    """Swing the pole up (swingup: it starts hanging down) or keep it up
    (balance), with dm_control's smooth reward: upright * small_control *
    small_velocity * centered."""

    discount = 1.0

    def __init__(self, model: Model, swing_up: bool,
                 time_limit: float = _TIME_LIMIT):
        self.swing_up = swing_up
        self.time_limit = time_limit
        self._slider = model.jnt_qposadr[model.name2id("joint", "slider")]
        self._hinge = model.jnt_qposadr[model.name2id("joint", "hinge")]

    def init_episode(self, model: Model, data: Data,
                     generator: torch.Generator) -> Data:
        """Batched: swingup x ~ N(0, 0.01^2), theta ~ pi + N(0, 0.01^2);
        balance x ~ U(-0.1, 0.1), theta ~ U(-0.034, 0.034); both
        qvel ~ N(0, 0.01^2)."""
        qpos = data.qpos.clone()
        b, dt, dev = qpos.shape[0], qpos.dtype, qpos.device
        if self.swing_up:
            qpos[:, self._slider] = 0.01 * normal(generator, (b,), dt, dev)
            qpos[:, self._hinge] = math.pi + 0.01 * normal(generator, (b,),
                                                           dt, dev)
        else:
            qpos[:, self._slider] = uniform(generator, -0.1, 0.1, (b,), dt,
                                            dev)
            qpos[:, self._hinge] = uniform(generator, -0.034, 0.034, (b,),
                                           dt, dev)
        qvel = 0.01 * normal(generator, data.qvel.shape, dt, dev)
        return data.replace(qpos=qpos, qvel=qvel)

    def observe(self, model: Model, data: Data) -> torch.Tensor:
        """[x, cos(theta), sin(theta)] and qvel."""
        theta = data.qpos[:, self._hinge]
        return torch.cat([torch.stack([data.qpos[:, self._slider],
                                       torch.cos(theta), torch.sin(theta)],
                                      -1), data.qvel], -1)

    def reward(self, model: Model, data: Data, obs, action):
        upright = (obs[:, 1] + 1.0) / 2.0
        centered = (1.0 + rewards.tolerance(None, obs[:, 0],
                                            margin=2.0)) / 2.0
        action = torch.as_tensor(action, dtype=data.qpos.dtype,
                                 device=data.qpos.device)
        small_control = (4.0 + rewards.tolerance(
            None, action.reshape(action.shape[0], -1)[:, 0], margin=1.0,
            value_at_margin=0.0, sigmoid="quadratic")) / 5.0
        small_velocity = (1.0 + rewards.tolerance(None, data.qvel[:, 1],
                                                  margin=5.0)) / 2.0
        return upright * small_control * small_velocity * centered

    def done(self, model: Model, data: Data, obs):
        return time_limit_done(data, self.time_limit)

    def kernel_hooks(self, model: Model):
        """In-kernel env layer (ops/megakernel.py): the reward reads
        qpos/qvel/ctrl only; resets follow init_episode's distribution."""
        from ..ops.megakernel import EnvHooks

        slider, hinge = self._slider, self._hinge

        def reward(bk, q, v, ctrl):
            upright = (bk.cos(q[hinge]) + 1.0) / 2.0
            centered = (1.0 + rewards.tolerance(bk, q[slider],
                                                margin=2.0)) / 2.0
            small_control = (4.0 + rewards.tolerance(
                bk, ctrl[0], margin=1.0, value_at_margin=0.0,
                sigmoid="quadratic")) / 5.0
            small_velocity = (1.0 + rewards.tolerance(bk, v[1],
                                                      margin=5.0)) / 2.0
            return upright * small_control * small_velocity * centered

        def observe(bk, q, v):
            # [x, cos(theta), sin(theta), qvel...]
            return [q[slider], bk.cos(q[hinge]), bk.sin(q[hinge])] + list(v)

        qpos0 = np.asarray(model.qpos0, dtype=np.float64).copy()
        mask = np.zeros(model.nq)
        sigma = np.zeros(model.nq)
        if self.swing_up:
            qpos0[hinge] = np.pi
            sigma[slider] = 0.01
            sigma[hinge] = 0.01
        else:
            mask[slider] = 0.1
            mask[hinge] = 0.034
        return EnvHooks(
            reward=reward,
            time_limit=self.time_limit,
            reset_noise=1.0,  # per-coordinate amplitude carried by the mask
            reset_mask=mask,
            reset_qpos0=qpos0,
            reset_qpos_sigma=sigma,
            reset_qvel_sigma=0.01,
            observe=observe,
            n_obs=3 + model.nv,
        )


def balance(model: Model | None = None, dtype=np.float32, **kw):
    model = model if model is not None else load_asset("cartpole",
                                                       dtype=dtype)
    return model, _Cartpole(model, swing_up=False, **kw)


def swingup(model: Model | None = None, dtype=np.float32, **kw):
    model = model if model is not None else load_asset("cartpole",
                                                       dtype=dtype)
    return model, _Cartpole(model, swing_up=True, **kw)
