"""Batched environment: the port's analog of the reference's L3 layer.

``BatchedEnvironment`` ties a compiled model, a task and a batch size to
one device.  This slice ports its ``reset``: a batch of fresh core states
with the task's episode randomization, which is all the rollout kernel
reads (``parallel.rollout.FastRollout.init``).  The reference's ``reset``
also runs the general-path ``forward`` to fill derived quantities; the
kernel state does not read them, so it is skipped here.  ``step`` comes
with the general path (ROADMAP Queue A items 11-12).
"""

from __future__ import annotations

import torch

from .. import default_device
from ..model import Model
from ..state import Data, make_data


class BatchedEnvironment:
    """Lockstep batch of environments on one device (``device=None``:
    the current CUDA device; raises without one)."""

    def __init__(self, model: Model, task, num_envs: int, device=None,
                 dtype: torch.dtype = torch.float32):
        self._model = model
        self._task = task
        self.num_envs = num_envs
        self.device = default_device(device)
        self.dtype = dtype

    @property
    def model(self) -> Model:
        return self._model

    @property
    def task(self):
        return self._task

    def reset(self, generator: torch.Generator) -> Data:
        """Batched reset: fresh core state + ``task.init_episode``."""
        data = make_data(self._model, self.device, self.dtype,
                         batch=self.num_envs)
        return self._task.init_episode(self._model, data, generator)
