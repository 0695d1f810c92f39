"""K environment steps per GPU call through the rollout kernel.

The port of ``oxide_control_tpu/parallel/rollout.py:74-372`` on one GPU
(the env-axis mesh is ROADMAP Queue A item 13): ``FastRollout`` packs the
batch into the kernel's coordinate-major state and runs
``ops.megakernel.build_rollout`` once per call, with actions either drawn
uniformly on the device (outside the kernel) or produced by an in-kernel
``MLPPolicy``.
"""

from __future__ import annotations

import torch

from ..api.environment import BatchedEnvironment
from ..ops import megakernel as mk
from ..ops import scalar_graph as sg
from ..state import Data


def fast_rollout_supported(benv: BatchedEnvironment) -> bool:
    """True if (model, task) qualify for the rollout kernel: the model is
    in the port's scalar-graph class and the task has in-kernel hooks."""
    return sg.supports(benv.model) and hasattr(benv.task, "kernel_hooks")


class Trajectory:
    """Per-call rollout outputs (struct of tensors, time-major).

    Always: ``reward_sum (B,)`` (per-env sum over the K steps) and
    ``diverged (B,)`` (divergence-triggered auto-resets).  A diverged step
    contributes reward 0 and sets the done flag.  With ``collect=True``:
    ``obs (K, n_obs, B)`` (the pre-step observation the policy acted on),
    ``rewards (K, B)``, ``dones (K, B)`` and, with an in-kernel policy,
    ``ctrls (K, nu, B)``.
    """

    def __init__(self, reward_sum, diverged, obs=None, rewards=None,
                 dones=None, ctrls=None):
        self.reward_sum = reward_sum
        self.diverged = diverged
        self.obs = obs
        self.rewards = rewards
        self.dones = dones
        self.ctrls = ctrls


class FastRollout:
    """K environment steps per call, all inside one kernel launch on the
    batch's device (a CPU batch runs the kernel's plain version).

    Usage::

        roll = FastRollout(benv, steps_per_call=200, policy=pol,
                           collect=True)
        gen = torch.Generator(device=benv.device).manual_seed(0)
        state = roll.init(gen)
        state, traj = roll.run(state, gen)
    """

    def __init__(self, benv: BatchedEnvironment, steps_per_call: int,
                 policy=None, collect: bool = False):
        if not fast_rollout_supported(benv):
            reason = sg.unsupported_reason(benv.model) or \
                "the task has no kernel_hooks"
            raise ValueError(f"model/task not kernel-eligible: {reason}")
        model = benv.model
        self.benv = benv
        self.device = benv.device
        self.steps_per_call = steps_per_call
        self.policy = policy
        self.collect = collect
        hooks = benv.task.kernel_hooks(model)
        self.n_obs = hooks.n_obs
        self.kernel = mk.build_rollout(
            model, benv.num_envs, steps_per_call, hooks, emit_obs=collect,
            policy=policy,
        )

    def init(self, generator: torch.Generator):
        """Batched reset -> coordinate-major kernel state."""
        return self.pack(self.benv.reset(generator))

    def pack(self, data: Data):
        """Env-major Data -> kernel state ``(qpos (nq,B), qvel (nv,B),
        act (max(na,1),B), warmstart (nv,B), time (1,B))``; na == 0
        models carry one zero act row."""
        b = data.qpos.shape[0]
        act = data.act.T
        if act.shape[0] == 0:
            act = torch.zeros((1, b), dtype=data.qpos.dtype,
                              device=data.qpos.device)
        return tuple(x.contiguous() for x in (
            data.qpos.T, data.qvel.T, act, data.qacc_warmstart.T,
            data.time[None, :],
        ))

    def run(self, state, generator: torch.Generator):
        """One K-step kernel call -> ``(new_state, Trajectory)``.  The
        policy's current weights are the call's inputs."""
        model = self.benv.model
        b = self.benv.num_envs
        dtype = state[0].dtype
        ctrl = params = None
        if self.policy is None:
            ctrl = torch.empty((self.steps_per_call, max(model.nu, 1), b),
                               dtype=dtype, device=self.device)
            ctrl.uniform_(-1.0, 1.0, generator=generator)
        else:
            params = self.policy.kernel_params()
        seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                             device=self.device, dtype=torch.int32)
        out = self.kernel(*state, ctrl, seed, params)
        traj = Trajectory(reward_sum=out[5][0], diverged=out[6][0])
        if self.collect:
            traj.obs, traj.rewards, traj.dones = out[7:10]
            if self.policy is not None:
                traj.ctrls = out[10]
        return tuple(out[:5]), traj
