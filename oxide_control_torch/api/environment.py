"""Environment and Task: the port's analog of the reference's L3 layer.

The port of ``oxide_control_tpu/api/environment.py``.  A ``Task`` is an
object of batched methods (``init_episode``, ``observe``, ``reward``,
``done``) and a ``discount``; the action is the ctrl argument of
``step``; ``TimeStep`` is a struct of tensors with a ``done`` mask.
``BatchedEnvironment`` ties a model, a task and a batch size to one
device: ``reset`` draws a batch of episodes and runs ``forward``;
``step`` runs the general path (``physics.forward.step``), refreshes the
observed quantities, evaluates the task and re-initializes finished or
diverged envs in place (masked auto-reset over every field of ``Data``),
reporting the pre-reset ``TimeStep``.  ``Environment`` is the same on a
batch of one env.  Everything runs on the batch's device: the current
CUDA device unless the caller passes ``device='cpu'``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Protocol

import torch

from .. import default_device
from ..model import Model
from ..physics import forward as _forward
from ..physics import smooth as _smooth
from ..state import Data, make_data, tree_map
from ..utils.divergence import divergence_flags


class Task(Protocol):
    """Episode logic over a batch (reference trait Task)."""

    discount: float

    def init_episode(self, model: Model, data: Data,
                     generator: torch.Generator) -> Data:
        """A fresh episode's core state for every env of ``data``."""
        ...

    def observe(self, model: Model, data: Data) -> torch.Tensor:
        """(B, n_obs) observation of the state."""
        ...

    def reward(self, model: Model, data: Data, obs, action) -> torch.Tensor:
        """(B,) reward."""
        ...

    def done(self, model: Model, data: Data, obs) -> torch.Tensor:
        """(B,) bool termination."""
        ...


@dataclasses.dataclass
class TimeStep:
    """Struct-of-tensors TimeStep: ``done`` lanes are terminal (discount
    0), the others carry the task's discount."""

    observation: Any
    reward: torch.Tensor
    discount: torch.Tensor
    done: torch.Tensor


class BatchedEnvironment:
    """Lockstep batch of environments on one device (``device=None``:
    the current CUDA device; raises without one) with masked auto-reset."""

    def __init__(self, model: Model, task, num_envs: int, device=None,
                 dtype: torch.dtype = torch.float32,
                 auto_reset: bool = True):
        self._model = model
        self._task = task
        self.num_envs = num_envs
        self.device = default_device(device)
        self.dtype = dtype
        self.auto_reset = auto_reset
        self._template = None

    @property
    def model(self) -> Model:
        return self._model

    @property
    def task(self):
        return self._task

    def _fresh(self) -> Data:
        """The reset state of every env (mj_resetData), made once."""
        if self._template is None:
            self._template = make_data(self._model, self.device, self.dtype,
                                       batch=self.num_envs)
        return self._template

    def _episode(self, generator: torch.Generator) -> Data:
        """New episodes' core state for every env (``task.init_episode``
        from the reset state)."""
        return self._task.init_episode(self._model, self._fresh(), generator)

    def reset(self, generator: torch.Generator) -> Data:
        """A batch of new episodes (``task.init_episode``) with every
        derived field filled by ``forward``."""
        return _forward.forward(self._model, self._episode(generator))

    def observe(self, data: Data) -> torch.Tensor:
        return self._task.observe(self._model, data)

    def _reset_one(self, generator: torch.Generator) -> Data:
        """The auto-reset state of every env: a fresh core state, with
        sensordata refreshed at it (pos/vel fresh, the acc family on the
        zero qacc) when the model has sensors; the next step's forward
        recomputes the rest."""
        data = self._episode(generator)
        if self._model.nsensor:
            data = _smooth.kinematics(self._model, data)
            data = _forward.sensor_refresh(self._model, data)
        return data

    def step_envs(self, data: Data, action) -> tuple[Data, TimeStep]:
        """One control step of every env without auto-reset: apply ctrl,
        step the physics, refresh the observed quantities, then observe,
        reward and terminate (the reference's ordering)."""
        model, task = self._model, self._task
        data = data.replace(ctrl=torch.as_tensor(action, dtype=self.dtype,
                                                  device=self.device))
        data = _forward.step(model, data)
        data = _smooth.kinematics(model, data)
        data = _forward.sensor_refresh(model, data)
        obs = task.observe(model, data)
        reward = task.reward(model, data, obs, action)
        done = task.done(model, data, obs) | divergence_flags(model, data)
        discount = torch.where(done, torch.zeros_like(data.time),
                               torch.full_like(data.time, task.discount))
        return data, TimeStep(observation=obs, reward=reward.to(self.dtype),
                              discount=discount, done=done)

    def step(self, data: Data, action, generator: torch.Generator):
        """Batched step with masked auto-reset: ``(new_data, TimeStep)``.
        The TimeStep reports the pre-reset observation and reward; envs
        that finished start a new episode in ``new_data``."""
        data, ts = self.step_envs(data, action)
        if self.auto_reset:
            fresh = self._reset_one(generator)
            done = ts.done

            def pick(new, old):
                m = done.reshape((-1,) + (1,) * (old.dim() - 1))
                return torch.where(m, new, old)

            data = tree_map(pick, fresh, data)
        return data, ts


class Environment:
    """One environment: a batch-of-one view of :class:`BatchedEnvironment`
    (reference Environment); every tensor keeps its env axis of size 1."""

    def __init__(self, model: Model, task, device=None,
                 dtype: torch.dtype = torch.float32):
        self._benv = BatchedEnvironment(model, task, 1, device=device,
                                        dtype=dtype, auto_reset=False)

    @property
    def model(self) -> Model:
        return self._benv.model

    @property
    def task(self):
        return self._benv.task

    def reset(self, generator: torch.Generator) -> tuple[Data, Any]:
        """init_episode + forward, and the observation."""
        data = self._benv.reset(generator)
        return data, self._benv.observe(data)

    def step(self, data: Data, action) -> tuple[Data, TimeStep]:
        """apply ctrl -> physics step -> observe -> reward -> terminate."""
        return self._benv.step_envs(data, action)
