"""Control suite: dm_control-style tasks over the port's engine.

The reference's whole suite (BASELINE.json's config ladder): pendulum
swingup, cartpole balance/swingup, cheetah run, walker stand/walk/run and
humanoid stand/walk/run.  Usage::

    env = suite.load("cheetah", "run")                  # one env, on cuda
    benv = suite.load_batched("cheetah", "run", 4096)   # on cuda
"""

from __future__ import annotations

import numpy as np
import torch

from ..api.environment import BatchedEnvironment, Environment
from . import cartpole, cheetah, humanoid, pendulum, walker
from .common import asset_path, load_asset

_REGISTRY = {
    ("pendulum", "swingup"): pendulum.swingup,
    ("cartpole", "balance"): cartpole.balance,
    ("cartpole", "swingup"): cartpole.swingup,
    ("cheetah", "run"): cheetah.run,
    ("walker", "stand"): walker.stand,
    ("walker", "walk"): walker.walk,
    ("walker", "run"): walker.run,
    ("humanoid", "stand"): humanoid.stand,
    ("humanoid", "walk"): humanoid.walk,
    ("humanoid", "run"): humanoid.run,
}

ALL_TASKS = tuple(sorted(_REGISTRY))


def _make(domain: str, task: str, dtype, kwargs):
    try:
        factory = _REGISTRY[(domain, task)]
    except KeyError:
        raise ValueError(
            f"unknown task {domain}/{task}; available: {ALL_TASKS}"
        ) from None
    model, task_obj = factory(dtype=dtype, **kwargs)
    return model, task_obj, torch.from_numpy(np.zeros(0, dtype=dtype)).dtype


def load(domain: str, task: str, dtype=np.float64, device=None,
         **kwargs) -> Environment:
    """Build one Environment on ``device`` (None: the current CUDA device;
    raises without one)."""
    model, task_obj, tdtype = _make(domain, task, dtype, kwargs)
    return Environment(model, task_obj, device=device, dtype=tdtype)


def load_batched(domain: str, task: str, num_envs: int, dtype=np.float32,
                 device=None, **kwargs) -> BatchedEnvironment:
    """Build a lockstep BatchedEnvironment on ``device`` (None: the
    current CUDA device; raises without one)."""
    model, task_obj, tdtype = _make(domain, task, dtype, kwargs)
    return BatchedEnvironment(model, task_obj, num_envs, device=device,
                              dtype=tdtype)
