"""Faults planted under the timed path, to show that ``correct`` sees
them: the CPU tests plant them at tiny sizes, ``benchmark.probe`` at a
cell's own size on the card.

* ``unchanged``: every step returns its state unchanged;
* ``half``: half of the batch left out (its envs keep their input state
  and store nothing);
* ``altered``: an answer altered where it is produced (the returned
  velocities, the stored observations and the rewards 1% off);
* ``every8``: the same 1% in every eighth env only;
* ``tail32``: the same 1% in the last thirty-second of the batch only.

:func:`planted` patches the port's entry point (``FastRollout.run`` or
``JitRollout.__call__``) for as long as it is open.
"""

from __future__ import annotations

import contextlib
from unittest import mock

import torch

KINDS = ("unchanged", "half", "altered", "every8", "tail32")


def _envs(kind: str, batch: int, device):
    """The envs a fault alters (a bool mask over the batch)."""
    idx = torch.arange(batch, device=device)
    if kind == "every8":
        return idx % 8 == 0
    if kind == "tail32":
        return idx >= batch - max(1, batch // 32)
    return torch.ones(batch, dtype=torch.bool, device=device)


def _scale(x, envs):
    """``x`` (env axis last) with the ``envs`` 1% off."""
    return torch.where(envs, x * 1.01, x)


def kernel_fault(kind: str, state, new, traj):
    """The ``(new state, trajectory)`` of a ``FastRollout.run`` call with
    the fault ``kind``."""
    if kind == "unchanged":
        if traj.obs is not None:
            traj.obs[:] = traj.obs[0]
        return tuple(x.clone() for x in state), traj
    if kind == "half":
        h = state[0].shape[1] // 2
        out = tuple(x.clone() for x in new)
        for o, s in zip(out, state):
            o[:, h:] = s[:, h:]
        traj.reward_sum[h:] = 0.0
        if traj.obs is not None:
            for t in (traj.obs, traj.rewards, traj.dones):
                t[..., h:] = 0.0
        return out, traj
    envs = _envs(kind, new[0].shape[1], new[0].device)
    out = list(new)
    out[1] = _scale(new[1], envs)
    for name in ("obs", "rewards"):
        t = getattr(traj, name)
        if t is not None:
            t.copy_(_scale(t, envs))
    traj.reward_sum.copy_(_scale(traj.reward_sum, envs))
    return tuple(out), traj


def general_fault(kind: str, roll, data_in: dict, out):
    """The result of a ``JitRollout.__call__`` with the fault ``kind``;
    the policy's record of the observations is altered with it."""
    data, (rewards, dones), mean = out
    rec = roll.policy.record          # (K, B, n_obs)
    if kind == "unchanged":
        rec[:] = rec[0]
        for f in ("qpos", "qvel"):
            getattr(data, f).copy_(data_in[f])
    elif kind == "half":
        h = rewards.shape[1] // 2
        rec[:, h:] = rec[0, h:]
        for f in ("qpos", "qvel"):
            getattr(data, f)[h:] = data_in[f][h:]
        rewards[:, h:] = 0.0
    else:
        envs = _envs(kind, rewards.shape[1], rewards.device)
        data.qvel.copy_(_scale(data.qvel.T, envs).T)
        rewards.copy_(_scale(rewards, envs))
        rec.copy_(_scale(rec.transpose(1, 2), envs).transpose(1, 2))
    return data, (rewards, dones), mean


@contextlib.contextmanager
def planted(kind: str):
    """Plant the fault ``kind`` under both entry points of the port."""
    from oxide_control_torch.parallel.rollout import FastRollout, JitRollout
    run, call = FastRollout.run, JitRollout.__call__

    def broken_run(self, state, generator, *a, **kw):
        new, traj = run(self, state, generator, *a, **kw)
        return kernel_fault(kind, state, new, traj)

    def broken_call(self, data, generator):
        data_in = {f: getattr(data, f).clone() for f in ("qpos", "qvel")}
        return general_fault(kind, self, data_in,
                             call(self, data, generator))

    with mock.patch.object(FastRollout, "run", broken_run), \
            mock.patch.object(JitRollout, "__call__", broken_call):
        yield
