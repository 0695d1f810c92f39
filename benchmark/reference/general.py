"""The plain reference of a ``jit_rollout`` call.

``jit_rollout(benv, K, policy)`` steps ``BatchedEnvironment.step`` K
times: the policy acts on the observation the step reported last (the
pre-reset one after an auto-reset), the step applies the action, runs the
physics, observes, rewards and terminates (time limit on the float32
clock, or divergence), and re-draws the episode of every finished env
from the caller's generator (the draw is made at every step, for every
env, and kept where an env finished).  :class:`GeneralCallReference`
does the same with the reference's physics and task, from the call's
input state, the observation the program handed the policy first, and
the caller's generator at its state before the call, so that it draws
the same numbers.

``lowp=True`` is the control: the state, the observation and the policy
held in bfloat16 (rounded at every step).
"""

from __future__ import annotations

import torch

from .kernel_env import diverged, mlp, replay
from .physics import F64
from .physics import step as physics_step


class NoisyMLP:
    """The benchmark's torch policy: ``tanh MLP(obs) + sigma * N(0, 1)``,
    the noise drawn from the caller's generator.  With ``record`` (a
    ``(K, B, n_obs)`` buffer) it keeps the observation of each step of a
    call at the index its device counter ``step`` holds (set to 0 before
    each call), as a collecting trainer keeps them."""

    def __init__(self, layers, sigma: float, record=None, lowp=False):
        self.layers, self.sigma, self.lowp = layers, float(sigma), lowp
        self.record = record
        self.step = None
        if record is not None:
            self.step = torch.zeros(1, dtype=torch.int64,
                                    device=record.device)

    def __call__(self, generator, obs):
        if self.record is not None:
            k = torch.remainder(self.step, self.record.shape[0])
            self.record.index_copy_(0, k, obs[None])
            self.step.add_(1)
        a = mlp(self.layers, obs, self.lowp)
        noise = torch.empty_like(a).normal_(generator=generator)
        return a + self.sigma * noise


class GeneralCallReference:
    """K steps of ``jit_rollout`` worked out again on the reference's
    physics and task (``task``, a :class:`.tasks.Task`), for a batch of
    ``batch`` envs, the policy ``layers`` with exploration ``sigma``, and
    the time limit ``time_limit``."""

    def __init__(self, task, batch: int, steps: int, layers, sigma: float,
                 time_limit: float):
        self.task, self.model = task, task.model
        self.B, self.K = batch, steps
        self.layers, self.sigma = layers, float(sigma)
        self.limit = float(time_limit) - 1e-6
        self.graphs, self.statics = {}, {}

    def _static(self):
        m, B, K, dev = self.model, self.B, self.K, self.model.device
        f = lambda *s, t=torch.float32: torch.zeros(  # noqa: E731
            s, dtype=t, device=dev)
        n_obs = m.nq - self.task.obs_skip + m.nv
        return {"qpos": f(B, m.nq, t=F64), "qvel": f(B, m.nv, t=F64),
                "ws": f(B, m.nv, t=F64), "time": f(B), "obs": f(B, n_obs),
                "k": f(1, t=torch.int64), "noise": f(K, B, m.nu),
                "fresh_q": f(K, B, m.nq), "fresh_v": f(K, B, m.nv),
                "forced": f(K, n_obs, B), "prog_dones": f(K, B),
                "seen": f(K, n_obs, B), "rewards": f(K, B, t=F64),
                "dones": f(K, B, t=F64)}

    def _step(self, st, lowp: bool, forced: bool):
        m, skip, k = self.model, self.task.obs_skip, st["k"]
        rnd = (lambda x: x.to(torch.bfloat16).to(x.dtype)) if lowp else (
            lambda x: x)
        qpos, qvel, ws = rnd(st["qpos"]), rnd(st["qvel"]), rnd(st["ws"])
        # what the policy sees: the observation the step before reported
        # (with ``forced``, the reference's prediction of the program's)
        obs = rnd(st["obs"])
        st["seen"].index_copy_(0, k, obs.T[None])
        if forced:
            # the policy saw the program's observation; the state is the
            # one it shows, unless the program reset the env a step before
            # (it then showed the pre-reset one) or this is the first step
            f = st["forced"].index_select(0, k)[0].T          # (B, n_obs)
            back = (k - 1).clamp_min(0)
            keep = ((k == 0) | (st["prog_dones"].index_select(0, back)[0]
                                > 0))[:, None]
            f64 = f.to(F64)
            qpos = torch.where(keep, qpos, torch.cat(
                [qpos[:, :skip], f64[:, :m.nq - skip]], 1))
            qvel = torch.where(keep, qvel, f64[:, m.nq - skip:])
            obs = f
        action = mlp(self.layers, obs, lowp) + self.sigma * st[
            "noise"].index_select(0, k)[0]
        qpos, qvel, qacc = physics_step(m, qpos, qvel, action.to(F64), ws)
        time = st["time"] + m.h
        reward = self.task.reward(qpos, qvel, action)
        done = (time > self.limit) | diverged(qpos, qvel)
        st["obs"].copy_(self.task.observe(qpos, qvel).to(torch.float32))
        d = done[:, None]
        st["qpos"].copy_(torch.where(
            d, st["fresh_q"].index_select(0, k)[0].to(F64), qpos))
        st["qvel"].copy_(torch.where(
            d, st["fresh_v"].index_select(0, k)[0].to(F64), qvel))
        st["ws"].copy_(torch.where(d, torch.zeros_like(qacc), qacc))
        st["time"].copy_(torch.where(done, torch.zeros_like(time), time))
        st["rewards"].index_copy_(0, k, reward[None])
        st["dones"].index_copy_(0, k, done.to(F64)[None])
        k.add_(1)

    def call(self, state: dict, obs0, gen_state, lowp: bool = False,
             forced=None):
        """The outputs of one ``jit_rollout`` call, env axis last: ``qpos
        (nq, B)``, ``qvel``, ``time (B,)``, ``rewards (K, B)``, ``dones
        (K, B)`` and ``obs (K, n_obs, B)`` (what the policy saw at each
        step).

        ``state`` holds the call's input ``qpos (B, nq)``, ``qvel``,
        ``qacc_warmstart`` and ``time``; ``obs0`` the observation the
        program handed the policy first; ``gen_state`` the caller's
        generator before the call.  ``forced``, the program's ``(obs,
        dones)`` of the call, starts each step k >= 1 from the state the
        program's policy saw (``obs[k]`` is ``qpos[obs_skip:]`` then
        ``qvel``; the root coordinates it leaves out are the reference's
        own), unless the program reset that env at step k - 1: the policy
        then saw the pre-reset observation, and the step starts from the
        reference's own reset state; ``obs`` then holds the reference's
        prediction of each step's observation, made by the step before."""
        m, dev = self.model, self.model.device
        key = (lowp, forced is not None)
        if key not in self.statics:
            self.statics[key] = self._static()
        st = self.statics[key]
        # the caller's draws, in the order the call makes them: at each
        # step the policy's noise, then every env's new episode
        gen = torch.Generator(device=dev)
        gen.set_state(gen_state)
        draws = []
        for _ in range(self.K):
            noise = torch.empty((self.B, m.nu), dtype=torch.float32,
                                device=dev).normal_(generator=gen)
            draws.append((noise,) + self.task.episode(gen, self.B, dev))

        def load(st):
            st["qpos"].copy_(state["qpos"].to(dev, F64))
            st["qvel"].copy_(state["qvel"].to(dev, F64))
            st["ws"].copy_(state["qacc_warmstart"].to(dev, F64))
            st["time"].copy_(state["time"].to(dev, torch.float32))
            st["obs"].copy_(obs0)
            st["k"].zero_()
            for i, name in enumerate(("noise", "fresh_q", "fresh_v")):
                st[name].copy_(torch.stack([d[i] for d in draws]))
            if forced is not None:
                st["forced"].copy_(forced[0])
                st["prog_dones"].copy_(forced[1])

        replay(self.graphs, key, st,
               lambda s: self._step(s, lowp, forced is not None), self.K,
               load)
        return {"qpos": st["qpos"].T.clone(), "qvel": st["qvel"].T.clone(),
                "time": st["time"].clone(), "rewards": st["rewards"].clone(),
                "dones": st["dones"].clone(), "obs": st["seen"].clone()}
