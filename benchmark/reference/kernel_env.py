"""The plain reference of a ``FastRollout`` call.

``FastRollout`` runs K steps of the rollout kernel's env layer: the
physics step, the task's observation and reward, an integer step counter
with the time limit, divergence (a non-finite or huge qpos/qvel: reward
0, counted, reset), masked auto-reset with Philox4x32-10 noise, and,
with a policy, a tanh MLP whose ctrl gets Box-Muller exploration noise.
:class:`KernelCallReference` works each of those out again from the
call's inputs: its state, its ctrl (the uniform draw of the caller's
generator) or its policy weights, and its Philox seed (one ``randint`` of
the caller's generator after the ctrl draw).  The physics and the task
are the reference's own (:mod:`.physics`, :mod:`.tasks`), in float64;
the env layer's draws and the policy in float32, as the kernel states
them.

``lowp=True`` is the control: the same reference with its state,
ctrl, observation and MLP held in bfloat16 (rounded at every step), the
step that would tempt a change to the program.
"""

from __future__ import annotations

import math

import torch

from .physics import F64
from .physics import step as physics_step
from .tasks import Task

_MASK32 = 0xFFFFFFFF
PHILOX_M0, PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
PHILOX_W0, PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
SALT_RESET, SALT_EXPLORE = 7, 13
MAXVAL = 1e10


# ---------------------------------------------------------------------------
# Philox4x32-10 (Salmon et al., SC'11) on int64 tensors holding uint32
# ---------------------------------------------------------------------------


def _mulhilo(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit halves of ``a * b``, ``b`` split into 16-bit limbs
    so that every partial product fits in int64."""
    p0 = a * (b & 0xFFFF)
    p1 = a * (b >> 16)
    mid = p0 + ((p1 & 0xFFFF) << 16)
    return (p1 >> 16) + (mid >> 32), mid & _MASK32


def philox4x32(counter, key):
    """Ten rounds of Philox4x32 on four int64 counter tensors and two
    int64 key tensors (broadcastable); returns four tensors in
    [0, 2^32)."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + PHILOX_W0) & _MASK32
        k1 = (k1 + PHILOX_W1) & _MASK32
    return c0, c1, c2, c3


def draw_signed(seed, salt: int, step, count: int, env: torch.Tensor,
                dtype) -> torch.Tensor:
    """(count, B) values in [-1, 1] of the stream (seed, salt) at
    ``step``: value j is lane j % 4 of the block with counter (env, step,
    j // 4, 0), as the int32 value of its bits times 2^-31.  ``seed`` and
    ``step`` are int64 tensors of one element."""
    n_blk = (count + 3) // 4
    envs = env.expand(n_blk, -1)
    zero = torch.zeros_like(envs)
    blk = torch.arange(n_blk, dtype=torch.int64, device=env.device)[:, None]
    out = philox4x32((envs, zero + step, zero + blk, zero),
                     (seed & _MASK32, torch.full_like(seed, salt)))
    bits = torch.stack(out, dim=1).reshape(4 * n_blk, -1)[:count]
    signed = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return signed.to(dtype) * (2.0 ** -31)


def box_muller(s1: torch.Tensor, s2: torch.Tensor) -> torch.Tensor:
    """Standard normals from two values in [-1, 1), u1 kept from 0."""
    u1 = torch.clamp_min(0.5 * (1.0 - s1), 1e-12)
    u2 = 0.5 * (s2 + 1.0)
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * u2)


# ---------------------------------------------------------------------------
# the policy
# ---------------------------------------------------------------------------


def make_mlp_weights(seed: int, dims, device, dtype=torch.float32):
    """Xavier-uniform weights and zero biases of a tanh MLP with layer
    sizes ``dims``, drawn on ``device`` from ``seed``: ``[(W (out, in),
    b (out,)), ...]``."""
    gen = torch.Generator(device=device).manual_seed(2 * int(seed))
    layers = []
    for i in range(len(dims) - 1):
        lim = math.sqrt(6.0 / (dims[i] + dims[i + 1]))
        w = torch.empty((dims[i + 1], dims[i]), dtype=dtype, device=device)
        w.uniform_(-lim, lim, generator=gen)
        layers.append((w, torch.zeros(dims[i + 1], dtype=dtype,
                                      device=device)))
    return layers


def mlp(layers, x: torch.Tensor, lowp: bool = False) -> torch.Tensor:
    """tanh MLP on ``x (..., n_in)``; ``lowp`` computes it in bfloat16."""
    if lowp:
        x = x.to(torch.bfloat16)
    for w, b in layers:
        if lowp:
            w, b = w.to(torch.bfloat16), b.to(torch.bfloat16)
        x = torch.tanh(x @ w.T + b)
    return x.to(torch.float32)



# ---------------------------------------------------------------------------
# the reference of one FastRollout call
# ---------------------------------------------------------------------------


def replay(graphs: dict, key, st: dict, step, steps: int, load):
    """``steps`` calls of ``step(st)`` on the static state ``st`` after
    ``load(st)``.  On a CUDA device one step is captured in a CUDA graph
    (kept in ``graphs`` under ``key``: the step index and every input are
    device tensors of ``st``, so one capture serves every call) and
    replayed; on the CPU it runs eagerly."""
    if st["k"].device.type != "cuda":
        load(st)
        for _ in range(steps):
            step(st)
        return st
    if key not in graphs:
        load(st)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step(st)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        load(st)
        with torch.cuda.graph(graph):
            step(st)
        graphs[key] = graph
    load(st)
    for _ in range(steps):
        graphs[key].replay()
    return st


def diverged(qpos, qvel):
    """(B,) bool: a non-finite or huge coordinate or velocity."""
    return ((~torch.isfinite(qpos)).any(-1) | (qpos.abs() > MAXVAL).any(-1)
            | (~torch.isfinite(qvel)).any(-1) | (qvel.abs() > MAXVAL).any(-1))


class KernelCallReference:
    """K env steps of the rollout kernel's env layer, worked out again.

    ``config`` is the configuration's file (its ``domain``,
    ``time_limit_s`` and ``reset_noise``); ``batch`` and ``steps`` the
    call's B and K; ``layers`` the policy's weights (None: ctrl input)
    and ``sigma`` its exploration noise."""

    def __init__(self, config: dict, batch: int, steps: int, device,
                 layers=None, sigma: float = 0.0):
        self.task = Task(config, device)
        m = self.model = self.task.model
        self.B, self.K, self.device = batch, steps, torch.device(device)
        self.layers, self.sigma = layers, float(sigma)
        self.h = float(m.h)
        self.limit_n = int(math.floor((config["time_limit_s"] - 1e-6)
                                      / self.h)) + 1
        noise = config["reset_noise"]
        keep = set(noise["keep_qpos"])
        f32 = lambda a: torch.tensor(a, dtype=torch.float32,  # noqa: E731
                                     device=self.device)[:, None]
        self.qpos0 = m.qpos0.to(torch.float32)[:, None]
        self.uamp = f32([0.0 if i in keep else noise["qpos_uniform"]
                         for i in range(m.nq)])
        self.qsig = f32([0.0 if i in keep else noise["qpos_normal"]
                         for i in range(m.nq)])
        self.vsig = float(noise["qvel_normal"])
        self.n_draws = m.nq + 2 * (m.nq + m.nv)
        self.obs_skip = self.task.obs_skip
        self.n_obs = m.nq - self.obs_skip + m.nv
        self.env = torch.arange(batch, dtype=torch.int64,
                                device=self.device)[None, :]
        self.graphs, self.statics = {}, {}

    def _reset(self, seed, k):
        """(qpos, qvel), coordinate-major float32, of the kernel's reset
        draw at step ``k``."""
        m = self.model
        s = draw_signed(seed, SALT_RESET, k, self.n_draws, self.env,
                        torch.float32)
        nn_ = m.nq + m.nv
        z = box_muller(s[m.nq:m.nq + nn_], s[m.nq + nn_:])
        return (self.qpos0 + self.uamp * s[:m.nq] + self.qsig * z[:m.nq],
                self.vsig * z[m.nq:])

    def _static(self, forced: bool):
        m, B, K, dev = self.model, self.B, self.K, self.device
        f = lambda *s, t=torch.float32: torch.zeros(  # noqa: E731
            s, dtype=t, device=dev)
        return {"qpos": f(B, m.nq, t=F64), "qvel": f(B, m.nv, t=F64),
                "ws": f(B, m.nv, t=F64), "n": f(B, t=torch.int64),
                "k": f(1, t=torch.int64), "seed": f(1, t=torch.int64),
                "forced": f(K, self.n_obs, B) if forced else None,
                "ctrls": f(K, m.nu, B), "obs": f(K, self.n_obs, B),
                "rewards": f(K, B), "dones": f(K, B),
                "reward_sum": f(B, t=F64), "diverged": f(B, t=F64)}

    def _step(self, st, policy: bool, lowp: bool):
        """One env step of the static state ``st``, in place.  With
        ``st["forced"]`` the step starts from the observed state the
        program stored for it (its root coordinates, which the observation
        leaves out, are the reference's own; the warmstart is the
        reference's acceleration of the step before), and the observation
        stored is the reference's prediction of it, made by the step
        before."""
        m, k, skip = self.model, st["k"], self.obs_skip
        rnd = (lambda x: x.to(torch.bfloat16).to(x.dtype)) if lowp else (
            lambda x: x)
        qpos, qvel, ws = rnd(st["qpos"]), rnd(st["qvel"]), rnd(st["ws"])
        st["obs"].index_copy_(
            0, k, rnd(self.task.observe(qpos, qvel).to(torch.float32)).T[
                None])
        if st["forced"] is not None:
            f = st["forced"].index_select(0, k)[0].to(F64)   # (n_obs, B)
            qpos = torch.cat([qpos[:, :skip], f[:m.nq - skip].T], 1)
            qvel = f[m.nq - skip:].T
        if policy:
            obs = rnd(self.task.observe(qpos, qvel).to(torch.float32))
            c = mlp(self.layers, obs, lowp)                   # (B, nu)
            if self.sigma > 0.0:
                bits = draw_signed(st["seed"], SALT_EXPLORE, k, 2 * m.nu,
                                   self.env, torch.float32)
                c = c + self.sigma * box_muller(bits[:m.nu],
                                                bits[m.nu:]).T
            st["ctrls"].index_copy_(0, k, c.T[None])
        else:
            c = st["ctrls"].index_select(0, k)[0].T
        c = rnd(c)
        qpos, qvel, qacc = physics_step(m, qpos, qvel, c.to(F64), ws)
        reward = self.task.reward(qpos, qvel, c)
        n = st["n"] + 1
        bad = diverged(qpos, qvel)
        done = bad | (n >= self.limit_n)
        rew = torch.where(bad, torch.zeros_like(reward), reward)
        st["reward_sum"].add_(rew)
        st["diverged"].add_(bad.to(F64))
        st["rewards"].index_copy_(0, k, rew.to(torch.float32)[None])
        st["dones"].index_copy_(0, k, done.to(torch.float32)[None])
        q_reset, v_reset = self._reset(st["seed"], k)
        d = done[:, None]
        st["qpos"].copy_(torch.where(d, q_reset.T.to(F64), qpos))
        st["qvel"].copy_(torch.where(d, v_reset.T.to(F64), qvel))
        st["ws"].copy_(torch.where(d, torch.zeros_like(qacc), qacc))
        st["n"].copy_(torch.where(done, torch.zeros_like(n), n))
        k.add_(1)

    def call(self, state, seed: int, ctrls=None, lowp: bool = False,
             forced=None):
        """The outputs of one call from the kernel state ``state`` (qpos
        (nq, B), qvel, act, warmstart, time (1, B)) with Philox seed
        ``seed``: ``ctrls (K, nu, B)`` are the actions of each step (the
        ctrl input, or the program's ctrls to step with); ``ctrls=None``
        with a policy runs the reference's own policy.  ``forced (K,
        n_obs, B)``, the observations the program stored, starts each step
        from the program's state, and ``obs`` then holds the reference's
        prediction of each step's observation.  Returns a dict of the
        kernel's outputs (``qpos``, ``qvel``, ``time``, ``reward_sum``,
        ``diverged``, ``obs``, ``rewards``, ``dones``, ``ctrls``), env
        axis last, on this reference's device."""
        policy = ctrls is None
        key = (policy, lowp, forced is not None)
        if key not in self.statics:
            self.statics[key] = self._static(forced is not None)
        st = self.statics[key]

        def load(st):
            dev = self.device
            st["qpos"].copy_(state[0].to(dev, F64).T)
            st["qvel"].copy_(state[1].to(dev, F64).T)
            st["ws"].copy_(state[3].to(dev, F64).T)
            st["n"].copy_(torch.round(state[4][0].to(dev, F64) / self.h).to(
                torch.int64))
            st["k"].zero_()
            st["seed"].fill_(int(seed))
            if ctrls is not None:
                st["ctrls"].copy_(ctrls)
            if forced is not None:
                st["forced"].copy_(forced)
            for name in ("reward_sum", "diverged", "rewards", "dones",
                         "obs"):
                st[name].zero_()

        replay(self.graphs, key, st,
               lambda s: self._step(s, policy, lowp), self.K, load)
        time = (st["n"].to(torch.float32) * self.h)[None]
        out = {name: st[name].clone() for name in
               ("obs", "ctrls", "rewards", "dones", "reward_sum",
                "diverged")}
        return dict(out, qpos=st["qpos"].T.clone(),
                    qvel=st["qvel"].T.clone(), time=time)

    def ctrls_of(self, obs: torch.Tensor, seed: int) -> torch.Tensor:
        """The policy's ctrls ``(K, nu, B)`` for the observations ``obs
        (K, n_obs, B)`` that the program stored, with the call's
        exploration noise."""
        nu = self.model.nu
        c = mlp(self.layers, obs.to(self.device).transpose(1, 2))  # K,B,nu
        c = c.transpose(1, 2)
        if self.sigma > 0.0:
            sd = torch.full((1,), int(seed), dtype=torch.int64,
                            device=self.device)
            for k in range(self.K):
                step = torch.full((1,), k, dtype=torch.int64,
                                  device=self.device)
                bits = draw_signed(sd, SALT_EXPLORE, step, 2 * nu, self.env,
                                   torch.float32)
                c[k] = c[k] + self.sigma * box_muller(bits[:nu], bits[nu:])
        return c

    def init(self, generator: torch.Generator):
        """The packed state of ``FastRollout.init`` from ``generator``:
        (qpos, qvel, act, warmstart, time), coordinate-major float32 (the
        warmstart the program's reset derives is not an answer: zero)."""
        qpos, qvel = self.task.episode(generator, self.B, self.device)
        z = torch.zeros((1, self.B), dtype=torch.float32, device=self.device)
        return (qpos.T.contiguous(), qvel.T.contiguous(), z,
                torch.zeros_like(qvel.T), z.clone())
