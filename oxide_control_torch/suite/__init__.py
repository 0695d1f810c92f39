"""Control suite: dm_control-style tasks, ported slice by slice.

This slice has cheetah run; the rest of the reference's suite is ROADMAP
Queue A item 9.  Usage::

    benv = suite.load_batched("cheetah", "run", 4096)   # on cuda
"""

from __future__ import annotations

import numpy as np
import torch

from ..api.environment import BatchedEnvironment
from . import cheetah
from .common import asset_path, load_asset

_REGISTRY = {
    ("cheetah", "run"): cheetah.run,
}
# the reference's other tasks, each waiting for its ROADMAP row
_LATER = {
    ("pendulum", "swingup"), ("cartpole", "balance"), ("cartpole", "swingup"),
    ("walker", "stand"), ("walker", "walk"), ("walker", "run"),
    ("humanoid", "stand"), ("humanoid", "walk"), ("humanoid", "run"),
}

ALL_TASKS = tuple(sorted(_REGISTRY))


def load_batched(domain: str, task: str, num_envs: int, dtype=np.float32,
                 device=None, **kwargs) -> BatchedEnvironment:
    """Build a lockstep BatchedEnvironment on ``device`` (None: the
    current CUDA device; raises without one)."""
    if (domain, task) in _LATER:
        raise NotImplementedError(
            f"{domain}/{task} is not ported yet: ROADMAP Queue A item 9 "
            f"(the rest of the suite); available: {ALL_TASKS}")
    try:
        factory = _REGISTRY[(domain, task)]
    except KeyError:
        raise ValueError(
            f"unknown task {domain}/{task}; available: {ALL_TASKS}"
        ) from None
    model, task_obj = factory(dtype=dtype, **kwargs)
    tdtype = torch.from_numpy(np.zeros(0, dtype=dtype)).dtype
    return BatchedEnvironment(model, task_obj, num_envs, device=device,
                              dtype=tdtype)
