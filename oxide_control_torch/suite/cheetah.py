"""Cheetah run (BASELINE.md config 2; the flagship benchmark model)."""

from __future__ import annotations

import numpy as np
import torch

from ..model import Model
from ..state import Data
from .common import load_asset

_RUN_SPEED = 10.0
_TIME_LIMIT = 10.0


class Run:
    """Run forward as fast as possible (dm_control cheetah.run style:
    reward = tolerance(forward speed, (10, inf), margin=10, linear))."""

    discount = 1.0

    def __init__(self, model: Model, time_limit: float = _TIME_LIMIT):
        self.time_limit = time_limit

    def init_episode(self, model: Model, data: Data,
                     generator: torch.Generator) -> Data:
        """Batched: 0.1 * U(-1, 1) on the leg joints of every env; the
        root pose stays (the feet start above the floor)."""
        qpos = data.qpos
        noise = torch.empty(qpos.shape, dtype=qpos.dtype,
                            device=qpos.device)
        noise.uniform_(-1.0, 1.0, generator=generator)
        noise = 0.1 * noise
        noise[..., :3] = 0.0  # keep root pose
        return data.replace(qpos=qpos + noise)

    def kernel_hooks(self, model: Model):
        """In-kernel env layer: reward, observation and reset of this
        task on scalar-graph values (ops/megakernel.py)."""
        from ..ops.megakernel import EnvHooks

        mask = np.ones(model.nq)
        mask[:3] = 0.0  # init_episode keeps the root pose

        def reward(bk, q, v, ctrl):
            # tolerance(speed, (RUN_SPEED, inf), margin=RUN_SPEED,
            # value_at_margin=0, sigmoid=linear) == clip(speed/RUN_SPEED,
            # 0, 1)
            return bk.clip(v[0] / _RUN_SPEED, 0.0, 1.0)

        def observe(bk, q, v):
            # concat(qpos[1:], qvel): rootx is translation-invariant
            return list(q[1:]) + list(v)

        return EnvHooks(
            reward=reward,
            time_limit=self.time_limit,
            reset_noise=0.1,
            reset_mask=mask,
            observe=observe,
            n_obs=(model.nq - 1) + model.nv,
        )


def run(model: Model | None = None, dtype=np.float32, **kw):
    model = model if model is not None else load_asset("cheetah", dtype=dtype)
    return model, Run(model, **kw)
