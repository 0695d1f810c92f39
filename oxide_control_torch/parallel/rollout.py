"""K environment steps per GPU call through the rollout kernel.

The port of ``oxide_control_tpu/parallel/rollout.py:74-372`` on one GPU
(the env-axis mesh is ROADMAP Queue A item 13): ``FastRollout`` packs the
batch into the kernel's coordinate-major state and runs
``ops.megakernel.build_rollout`` once per call, with actions either drawn
uniformly on the device (outside the kernel) or produced by an in-kernel
``MLPPolicy``.  Per call it also takes the mocap poses, the eq_active
rows and, with ``applied_forces``, the applied forces of every env.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import convert
from ..api.environment import BatchedEnvironment
from ..ops import megakernel as mk
from ..ops import scalar_graph as sg
from ..state import Data


def unsupported_reason(benv: BatchedEnvironment) -> str | None:
    """Why (model, task) cannot run in the rollout kernel (None if they
    can): the model must be in the port's scalar-graph class, the task
    must have in-kernel hooks, and a task that observes sensors needs
    every sensor in the kernel family."""
    reason = sg.unsupported_reason(benv.model)
    if reason is not None:
        return reason
    if not hasattr(benv.task, "kernel_hooks"):
        return "the task has no kernel_hooks"
    if benv.task.kernel_hooks(benv.model).needs_sensors:
        reason = sg.unsupported_sensor_reason(benv.model)
        if reason is not None:
            return f"the task observes sensors: {reason}"
    return None


def fast_rollout_supported(benv: BatchedEnvironment) -> bool:
    """True if (model, task) qualify for the rollout kernel (see
    :func:`unsupported_reason`)."""
    return unsupported_reason(benv) is None


def mocap_rest_pose(model):
    """(pos (nmocap, 3), quat (nmocap, 4)): the mocap bodies' rest poses,
    their body_pos and body_quat in mocap order (Data.mocap_pos/quat at
    reset)."""
    ids = np.argsort(model.body_mocapid)[model.nbody - model.nmocap:]
    return np.asarray(model.body_pos)[ids], np.asarray(model.body_quat)[ids]


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

    ``applied_forces=True`` builds the kernel that takes per-env
    ``qfrc_applied``/``xfrc_applied`` at each call (push randomization).
    """

    def __init__(self, benv: BatchedEnvironment, steps_per_call: int,
                 policy=None, collect: bool = False,
                 applied_forces: bool = False):
        reason = unsupported_reason(benv)
        if reason is not None:
            # there is no general path to fall back to yet (ROADMAP Queue A
            # item 11)
            raise ValueError(f"model/task not kernel-eligible: {reason}")
        model = benv.model
        self.benv = benv
        self.device = benv.device
        self.steps_per_call = steps_per_call
        self.policy = policy
        self.collect = collect
        hooks = benv.task.kernel_hooks(model)
        self.n_obs = hooks.n_obs
        self.applied_forces = bool(applied_forces)
        self.kernel = mk.build_rollout(
            model, benv.num_envs, steps_per_call, hooks, emit_obs=collect,
            policy=policy, applied_forces=applied_forces,
        )
        # the mocap bodies' rest poses (body_pos, body_quat), in mocap order
        self._mocap_rest = tuple(torch.as_tensor(a, device=self.device)
                                 for a in mocap_rest_pose(model))
        # an accelerometer-family sensor observation carries the previous
        # step's stage-1 qacc as a sixth state element
        self._carry_qacc = self.kernel.spec.carry_qacc
        self._n_state = self.kernel.n_state

    def init(self, generator: torch.Generator):
        """Batched reset -> coordinate-major kernel state."""
        return self.pack(self.benv.reset(generator))

    def pack(self, data: Data):
        """Env-major Data -> kernel state ``(qpos (nq,B), qvel (nv,B),
        act (max(na,1),B), warmstart (nv,B), time (1,B)[, qacc (nv,B)])``;
        na == 0 models carry one zero act row, and a task that observes an
        accelerometer-family sensor carries ``data.qacc``."""
        b = data.qpos.shape[0]
        act = data.act.T
        if act.shape[0] == 0:
            act = torch.zeros((1, b), dtype=data.qpos.dtype,
                              device=data.qpos.device)
        state = (data.qpos.T, data.qvel.T, act, data.qacc_warmstart.T,
                 data.time[None, :])
        if self._carry_qacc:
            state += (data.qacc.T,)
        return tuple(x.contiguous() for x in state)

    def run(self, state, generator: torch.Generator, eq_active=None, *,
            mocap_pos=None, mocap_quat=None, qfrc_applied=None,
            xfrc_applied=None):
        """One K-step kernel call -> ``(new_state, Trajectory)``.  The
        policy's current weights are the call's inputs.  A model with
        equality constraints takes ``eq_active (B, neq)``, 0/1 per env and
        equality (Data.eq_active; default the model's eq_active0); a model
        with mocap bodies takes ``mocap_pos (B, nmocap, 3)`` and
        ``mocap_quat (B, nmocap, 4)`` (default the rest pose); with
        ``applied_forces`` the call takes ``qfrc_applied (B, nv)`` and
        ``xfrc_applied (B, nbody, 6)`` (default zero).  Every one is
        constant over the K steps.  Each raises where the model or the
        build does not take it: for mocap poses on a model without mocap
        bodies the reference crashes instead (its default pose is None)."""
        model = self.benv.model
        b = self.benv.num_envs
        dtype = state[0].dtype
        if model.nmocap == 0 and (mocap_pos is not None
                                  or mocap_quat is not None):
            raise ValueError("mocap_pos/mocap_quat given for a model "
                             "without mocap bodies")
        if not self.applied_forces and (qfrc_applied is not None
                                        or xfrc_applied is not None):
            raise ValueError("pass applied_forces=True to FastRollout to "
                             "use qfrc_applied/xfrc_applied")

        def rows(x, default, shape):
            x = default.expand(shape) if x is None else torch.as_tensor(
                x, device=self.device)
            if tuple(x.shape) != shape:
                raise ValueError(f"want shape {shape}, not "
                                 f"{tuple(x.shape)}")
            return x.to(dtype)

        mocap = qfrc = xfrc = None
        if model.nmocap:
            pos0, quat0 = self._mocap_rest
            mocap = convert.mocap_to_kernel(
                rows(mocap_pos, pos0, (b, model.nmocap, 3)),
                rows(mocap_quat, quat0, (b, model.nmocap, 4)), dtype)
        if self.applied_forces:
            zero = torch.zeros((), dtype=dtype, device=self.device)
            qfrc = rows(qfrc_applied, zero, (b, model.nv)).T.contiguous()
            xfrc = convert.xfrc_to_kernel(
                rows(xfrc_applied, zero, (b, model.nbody, 6)), dtype)
        if model.neq == 0 and eq_active is not None:
            raise ValueError("eq_active given for a model without equality "
                             "constraints")
        if model.neq:
            if eq_active is None:
                eq_active = torch.tensor(
                    [float(x) for x in model.eq_active0], dtype=dtype,
                    device=self.device).expand(b, -1)
            if tuple(eq_active.shape) != (b, model.neq):
                raise ValueError(f"eq_active must have shape "
                                 f"{(b, model.neq)}, not "
                                 f"{tuple(eq_active.shape)}")
            eq_active = convert.eq_active_to_kernel(eq_active, dtype,
                                                    self.device)
        ctrl = params = None
        if self.policy is None:
            ctrl = torch.empty((self.steps_per_call, max(model.nu, 1), b),
                               dtype=dtype, device=self.device)
            ctrl.uniform_(-1.0, 1.0, generator=generator)
        else:
            params = self.policy.kernel_params()
        seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                             device=self.device, dtype=torch.int32)
        out = self.kernel(*state, ctrl, seed, params, eq_active,
                          mocap=mocap, qfrc=qfrc, xfrc=xfrc)
        ns = self._n_state
        traj = Trajectory(reward_sum=out[ns][0], diverged=out[ns + 1][0])
        if self.collect:
            traj.obs, traj.rewards, traj.dones = out[ns + 2:ns + 5]
            if self.policy is not None:
                traj.ctrls = out[ns + 5]
        return tuple(out[:ns]), traj
