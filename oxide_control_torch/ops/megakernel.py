"""The K-step rollout kernel: hand-written CUDA shell + emitted step body.

Replaces the TPU kernel ``oxide_control_tpu/ops/megakernel.py:build_rollout``
(one ``pl.pallas_call`` holding the whole engine).  Per call it runs K env
steps for every env of the batch: pre-step observe, ctrl input or
in-kernel tanh-MLP policy (with optional Gaussian exploration), ``mj_step``,
reward, time limit, divergence test, and masked auto-reset -- the ordering
of the reference's ``Environment::step`` (observe -> ctrl -> step -> reward
-> terminate).

Two versions of one function, chosen by where the state lies:

* CUDA tensors: the kernel ``ops/csrc/rollout.cu``, one thread per env over
  the coordinate-major ``(rows, B)`` layout, the K loop inside the kernel,
  the MLP weights in shared memory.  Its per-model parts (the step body,
  observation, reward and reset expressions) are C emitted by
  ``ops.emit`` from ``ops.scalar_graph`` and the task's :class:`EnvHooks`;
  ``ops.build`` compiles it with nvcc for ``sm_90a`` at first use.
* CPU tensors: the plain PyTorch version -- the same scalar graph on
  ``(B,)`` tensors in a Python K loop, the same env layer, Philox stream
  and MLP.  ``RolloutFn.plain`` runs it on any device, which is how the
  kernel is compared with it on the card.

Random numbers are counter-based Philox4x32-10 keyed on ``(seed, salt)``
with counter ``(env, step, block, 0)``: reset noise (salt 7) and
exploration noise (salt 13) are the same bits in both versions.  The TPU
kernel's hardware PRNG, its VMEM tile sizing and its interpret-mode
threefry path have no counterpart here.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Callable, Sequence

import numpy as np
import torch

from ..model import Model
from . import scalar_graph as sg

# the TPU kernel this replaces: build_rollout's pl.pallas_call
REPLACES = "oxide_control_tpu/ops/megakernel.py:672"

# Philox4x32-10 constants (Salmon et al., SC'11; Random123)
PHILOX_M0, PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
PHILOX_W0, PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF
SALT_RESET = 7
SALT_EXPLORE = 13

# kernel limits: MLP layers and widths the per-thread buffers hold
MAX_LAYERS = 4
MAX_WIDTH = 64


@dataclasses.dataclass(frozen=True)
class EnvHooks:
    """Task env-layer spec the kernel inlines.

    ``reward(bk, q, v, ctrl)`` -> one value: reward on the *post-step*
    state.  ``observe(bk, q, v)`` -> ``n_obs`` values: the observation on
    the *pre-step* state (the policy input).  Both receive lists of backend
    values and the backend ``bk`` (see ``ops.scalar_graph``), so the same
    hook runs in the plain version and is emitted into the kernel.

    Reset distribution: qpos[i] resets to
    ``reset_qpos0[i] + U(-u_i, u_i) + N(0, s_i^2)`` with
    ``u = reset_noise * reset_mask`` and ``s = reset_qpos_sigma``; qvel
    resets to ``N(0, reset_qvel_sigma^2)`` per dof.
    """

    reward: Callable
    time_limit: float
    reset_noise: float = 0.0
    reset_mask: Sequence[float] | None = None
    reset_qpos0: Sequence[float] | None = None
    reset_qpos_sigma: Sequence[float] | None = None
    reset_qvel_sigma: float = 0.0
    observe: Callable | None = None
    n_obs: int = 0


@dataclasses.dataclass(frozen=True)
class EnvSpec:
    """Build-time constants of the env layer (python floats)."""

    nq: int
    nv: int
    nu: int
    n_obs: int
    h: float
    limit_n: int
    qpos0: tuple
    uamp: tuple
    qsig: tuple
    vsig: float

    @property
    def n_draws(self) -> int:
        """Philox values per reset: nq uniforms + 2 per Box-Muller normal
        for the nq + nv normals (the TPU kernel's layout)."""
        return self.nq + 2 * (self.nq + self.nv)


def env_spec(model: Model, hooks: EnvHooks) -> EnvSpec:
    nq = model.nq
    h = float(model.opt.timestep)
    qpos0 = [float(x) for x in np.asarray(model.qpos0)]
    if hooks.reset_qpos0 is not None:
        qpos0 = [float(x) for x in hooks.reset_qpos0]
    # integer step-count limit: f32 `t += h` drifts over thousands of
    # steps, so the step count is exact and t = n * h is reconstructed
    limit_n = int(math.floor((hooks.time_limit - 1e-6) / h)) + 1
    mask = ([1.0] * nq if hooks.reset_mask is None
            else [float(x) for x in hooks.reset_mask])
    uamp = [float(hooks.reset_noise) * m for m in mask]
    qsig = ([0.0] * nq if hooks.reset_qpos_sigma is None
            else [float(x) for x in hooks.reset_qpos_sigma])
    return EnvSpec(nq=nq, nv=model.nv, nu=model.nu, n_obs=hooks.n_obs, h=h,
                   limit_n=limit_n, qpos0=tuple(qpos0), uamp=tuple(uamp),
                   qsig=tuple(qsig), vsig=float(hooks.reset_qvel_sigma))


def reset_values(spec: EnvSpec, uni, z):
    """(q_reset, v_reset) from nq uniforms in [-1, 1) and nq + nv standard
    normals; written with python operators so it runs on tensors and on
    emitter symbols alike."""
    q = [
        spec.qpos0[i]
        + (spec.uamp[i] * uni[i] if spec.uamp[i] else 0.0)
        + (spec.qsig[i] * z[i] if spec.qsig[i] else 0.0)
        for i in range(spec.nq)
    ]
    v = [spec.vsig * z[spec.nq + i] if spec.vsig else 0.0
         for i in range(spec.nv)]
    return q, v


# ---------------------------------------------------------------------------
# Philox4x32-10 and Box-Muller, plain version (int64 tensors, 16-bit limbs)
# ---------------------------------------------------------------------------


def _mulhilo(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit halves of a * b for a 32-bit constant ``a`` and
    int64 ``b`` in [0, 2^32): b is split into 16-bit limbs so every
    partial product fits int64 (torch has no uint32 multiply-high)."""
    p0 = a * (b & 0xFFFF)                  # < 2^48
    p1 = a * (b >> 16)                     # < 2^48
    mid = p0 + ((p1 & 0xFFFF) << 16)       # < 2^49
    return (p1 >> 16) + (mid >> 32), mid & _MASK32


def philox4x32(counter, key):
    """Philox4x32-10 on int64 tensors holding uint32 values.

    ``counter``: four int64 tensors (broadcastable); ``key``: two python
    ints.  Returns four int64 tensors in [0, 2^32)."""
    c0, c1, c2, c3 = counter
    k0, k1 = int(key[0]) & _MASK32, int(key[1]) & _MASK32
    for _ in range(10):
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + PHILOX_W0) & _MASK32
        k1 = (k1 + PHILOX_W1) & _MASK32
    return c0, c1, c2, c3


def philox_bits(seed: int, salt: int, step: int, count: int,
                env: torch.Tensor) -> torch.Tensor:
    """(count, B) uint32 values (in int64) of the stream (seed, salt) at
    ``step`` for each env: value j is lane j % 4 of the Philox block with
    counter (env, step, j // 4, 0)."""
    n_blk = (count + 3) // 4
    env = env.expand(n_blk, -1)
    zero = torch.zeros_like(env)
    blk = torch.arange(n_blk, dtype=env.dtype, device=env.device)[:, None]
    out = philox4x32((env, zero + step, zero + blk, zero), (seed, salt))
    return torch.stack(out, dim=1).reshape(4 * n_blk, -1)[:count]


def signed_unit(bits: torch.Tensor, dtype) -> torch.Tensor:
    """uint32 bits -> the int32 value times 2^-31, in [-1, 1]."""
    signed = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return signed.to(dtype) * (2.0 ** -31)


def box_muller(s1: torch.Tensor, s2: torch.Tensor) -> torch.Tensor:
    """Standard normals from two [-1, 1) values.  u1 is clamped away from
    0: s = bits * 2^-31 rounds to exactly 1.0 in f32 for bits near 2^31,
    and log(0) = -inf would poison the sample."""
    u1 = torch.clamp_min(0.5 * (1.0 - s1), 1e-12)   # (0, 1]
    u2 = 0.5 * (s2 + 1.0)                           # [0, 1)
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * u2)


def mlp_forward(layers, x: torch.Tensor) -> torch.Tensor:
    """tanh MLP on (n_in, B) columns in the kernel's order: per layer the
    dot product accumulates input by input (``acc = acc + w_i * x_i``),
    then the bias is added and tanh taken."""
    for (wl, bl) in layers:
        acc = torch.zeros((wl.shape[0], x.shape[1]), dtype=x.dtype,
                          device=x.device)
        for i in range(wl.shape[1]):
            acc = acc + wl[:, i:i + 1] * x[i:i + 1]
        x = torch.tanh(acc + bl.reshape(-1, 1))
    return x


# ---------------------------------------------------------------------------
# emitted kernel source
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class KernelSource:
    text: str
    step_ops: int        # dynamic lane-ops of one emitted step
    step_sfu_ops: int    # of which special-function ops
    reset_ops: int       # lane-ops of one masked reset (emitted part)
    env_ops: int         # observe + reward lane-ops per env-step


def kernel_source(model: Model, hooks: EnvHooks,
                  ctype: str = "float") -> KernelSource:
    """The per-model C header the CUDA shell includes: sizes, env-layer
    constants and the emitted ``oxc_step`` / ``oxc_observe`` /
    ``oxc_reward`` / ``oxc_reset`` functions."""
    from .emit import PRELUDE, Emitter

    if hooks.observe is None:
        raise ValueError("the rollout kernel needs EnvHooks.observe")
    spec = env_spec(model, hooks)
    nq, nv, nu, n_obs = spec.nq, spec.nv, spec.nu, spec.n_obs
    T = ctype
    parts = []

    em = Emitter(ctype)
    step = sg.build_step(model, em)
    q, v = em.load("q", nq), em.load("v", nv)
    w, c = em.load("w", nv), em.load("c", nu)
    qn, vn, _, wn = step(q, v, [], w, c)
    em.store("q_out", qn)
    em.store("v_out", vn)
    em.store("w_out", wn)
    parts.append(em.function(
        f"void oxc_step(const {T}* q, const {T}* v, const {T}* w, "
        f"const {T}* c, {T}* q_out, {T}* v_out, {T}* w_out)"))
    step_ops, step_sfu = em.ops, em.sfu_ops

    eo = Emitter(ctype)
    q, v = eo.load("q", nq), eo.load("v", nv)
    rows = list(hooks.observe(eo, q, v))
    if len(rows) != n_obs:
        raise ValueError(f"observe gave {len(rows)} rows, n_obs={n_obs}")
    eo.store("obs", rows)
    parts.append(eo.function(
        f"void oxc_observe(const {T}* q, const {T}* v, {T}* obs)"))

    er = Emitter(ctype)
    q, v, c = er.load("q", nq), er.load("v", nv), er.load("c", nu)
    er.ret(hooks.reward(er, q, v, c))
    parts.append(er.function(
        f"{T} oxc_reward(const {T}* q, const {T}* v, const {T}* c)"))

    ez = Emitter(ctype)
    uni, z = ez.load("uni", nq), ez.load("z", nq + nv)
    q_reset, v_reset = reset_values(spec, uni, z)
    ez.store("q_out", q_reset)
    ez.store("v_out", v_reset)
    parts.append(ez.function(
        f"void oxc_reset(const {T}* uni, const {T}* z, {T}* q_out, "
        f"{T}* v_out)"))

    lit = Emitter(ctype).lit
    defines = "\n".join([
        f"#define OXC_NQ {nq}",
        f"#define OXC_NV {nv}",
        f"#define OXC_NU {nu}",
        f"#define OXC_NOBS {n_obs}",
        f"#define OXC_NDRAW {spec.n_draws}",
        f"#define OXC_LIMIT_N {spec.limit_n}",
        f"#define OXC_H {lit(spec.h)}",
        f"#define OXC_INV_H {lit(1.0 / spec.h)}",
    ])
    text = (f"/* emitted by oxide_control_torch.ops.megakernel.kernel_source"
            f" ({ctype}): do not edit */\n#pragma once\n" + PRELUDE + "\n"
            + defines + "\n\n" + "\n".join(parts))
    return KernelSource(text=text, step_ops=step_ops, step_sfu_ops=step_sfu,
                        reset_ops=ez.ops, env_ops=eo.ops + er.ops)


# ---------------------------------------------------------------------------
# the rollout function: kernel on CUDA tensors, plain version on the CPU
# ---------------------------------------------------------------------------


def _pack_params(params, dims, device, dtype):
    """Flatten (W_1, b_1, ..., W_L, b_L) into one contiguous buffer in the
    kernel's layout: per layer W (out, in) row-major, then b (out)."""
    flat = []
    for i in range(len(dims) - 1):
        w, b = params[2 * i], params[2 * i + 1]
        if tuple(w.shape) != (dims[i + 1], dims[i]):
            raise ValueError(f"layer {i}: W shape {tuple(w.shape)}, "
                             f"want {(dims[i + 1], dims[i])}")
        flat.append(w.reshape(-1))
        flat.append(b.reshape(-1))
    return torch.cat(flat).to(device=device, dtype=dtype).contiguous()


class RolloutFn:
    """``fn(qpos (nq,B), qvel (nv,B), act (max(na,1),B), ws (nv,B),
    time (1,B), ctrl (K,nu,B) | None, seed (1,) int32, params=None)``.

    Without a policy ``ctrl`` is required; with one, ``params`` is the
    list (W_1, b_1, ..., W_L, b_L) with W (out, in) and b (out, 1) and
    ``ctrl`` is None.  Returns ``(qpos', qvel', act', ws', time',
    reward_sum (1,B), diverged (1,B))`` plus, with ``emit_obs``,
    ``obs (K,n_obs,B), rewards (K,B), dones (K,B)`` and, with a policy,
    ``ctrls (K,nu,B)``.

    CUDA tensors launch the kernel (``launches`` counts each launch);
    CPU tensors run :meth:`plain`.  No failure of the kernel falls back
    to the plain version.
    """

    def __init__(self, model: Model, batch: int, steps_per_call: int,
                 hooks: EnvHooks, emit_obs: bool = False, policy=None,
                 fmad: bool = False):
        reason = sg.unsupported_reason(model)
        if reason is not None:
            raise ValueError(f"model not kernel-eligible: {reason}")
        if hooks.observe is None:
            raise ValueError("the rollout kernel needs EnvHooks.observe")
        self.model = model
        self.hooks = hooks
        self.spec = env_spec(model, hooks)
        self.batch = batch
        self.steps = steps_per_call
        self.emit_obs = emit_obs
        self.policy = policy
        self.fmad = fmad
        self.na_rows = max(model.na, 1)
        if policy is not None:
            self.dims = [self.spec.n_obs, *policy.hidden, self.spec.nu]
            if len(self.dims) - 1 > MAX_LAYERS or max(self.dims) > MAX_WIDTH:
                raise ValueError(
                    f"policy dims {self.dims}: the kernel holds at most "
                    f"{MAX_LAYERS} layers of width <= {MAX_WIDTH}")
            self.explore_sigma = float(policy.explore_sigma)
        else:
            self.dims = []
            self.explore_sigma = 0.0
        self.launches = 0
        self._lib = None
        self._plain_steps = {}

    # ----- shared checks -----
    def _check(self, qpos, qvel, act, ws, time, ctrl, seed, params):
        s, B, K = self.spec, self.batch, self.steps
        want = dict(qpos=(s.nq, B), qvel=(s.nv, B), act=(self.na_rows, B),
                    ws=(s.nv, B), time=(1, B))
        dev, dtype = qpos.device, qpos.dtype
        for name, t in zip(want, (qpos, qvel, act, ws, time)):
            if tuple(t.shape) != want[name]:
                raise ValueError(f"{name} shape {tuple(t.shape)}, want "
                                 f"{want[name]}")
            if t.device != dev or t.dtype != dtype:
                raise ValueError(f"{name} must be {dtype} on {dev}")
        if self.policy is None:
            if ctrl is None or tuple(ctrl.shape) != (K, s.nu, B):
                raise ValueError(f"ctrl must have shape {(K, s.nu, B)}")
            if ctrl.device != dev or ctrl.dtype != dtype:
                raise ValueError(f"ctrl must be {dtype} on {dev}")
        elif params is None or len(params) != 2 * (len(self.dims) - 1):
            raise ValueError("a policy rollout needs params "
                             "(W_1, b_1, ..., W_L, b_L)")
        if seed is None or seed.numel() != 1 or seed.device != dev:
            raise ValueError(f"seed must be one int32 on {dev}")

    def _alloc(self, like):
        s, B, K = self.spec, self.batch, self.steps
        dev, dtype = like.device, like.dtype
        e = lambda *shape: torch.empty(shape, device=dev, dtype=dtype)
        out = [e(s.nq, B), e(s.nv, B), e(self.na_rows, B), e(s.nv, B),
               e(1, B), e(1, B), e(1, B)]
        if self.emit_obs:
            out += [e(K, s.n_obs, B), e(K, B), e(K, B)]
            if self.policy is not None:
                out.append(e(K, s.nu, B))
        return out

    def __call__(self, qpos, qvel, act, ws, time, ctrl=None, seed=None,
                 params=None):
        if qpos.is_cuda:
            return self._launch(qpos, qvel, act, ws, time, ctrl, seed,
                                params)
        if qpos.device.type != "cpu":
            raise ValueError(f"no rollout for device {qpos.device}")
        return self.plain(qpos, qvel, act, ws, time, ctrl, seed, params)

    # ----- the kernel -----
    def build(self):
        """Emit the model's C and build the kernel library (cached under
        build/ by source hash); returns ``ops.build.Built``."""
        if self._lib is None:
            from . import build
            src = kernel_source(self.model, self.hooks, "float")
            self._lib = build.build_rollout_library(src, fmad=self.fmad)
        return self._lib

    def _launch(self, qpos, qvel, act, ws, time, ctrl, seed, params):
        self._check(qpos, qvel, act, ws, time, ctrl, seed, params)
        if qpos.dtype != torch.float32:
            raise ValueError("the rollout kernel takes float32 state")
        ins = [qpos, qvel, act, ws, time]
        if ctrl is not None:
            ins.append(ctrl)
        for t in ins:
            if not t.is_contiguous():
                raise ValueError("the rollout kernel takes contiguous "
                                 "tensors")
        if seed.dtype != torch.int32:
            raise ValueError("seed must be int32")
        built = self.build()
        out = self._alloc(qpos)
        if self.policy is not None:
            packed = _pack_params(params, self.dims, qpos.device,
                                  torch.float32)
            n_params = packed.numel()
        else:
            packed, n_params = None, 0
        dims = (ctypes.c_int * (MAX_LAYERS + 1))(
            *(self.dims + [0] * (MAX_LAYERS + 1 - len(self.dims))))
        ptr = lambda t: ctypes.c_void_p(t.data_ptr() if t is not None
                                        else 0)
        obs = rews = dones = ctrls = None
        if self.emit_obs:
            obs, rews, dones = out[7:10]
            if self.policy is not None:
                ctrls = out[10]
        stream = torch.cuda.current_stream(qpos.device).cuda_stream
        err = built.launch(
            ptr(qpos), ptr(qvel), ptr(act), ptr(ws), ptr(time),
            ptr(ctrl), ptr(seed), ptr(packed), ctypes.c_int(n_params),
            ctypes.c_int(max(len(self.dims) - 1, 0)), dims,
            ctypes.c_float(self.explore_sigma),
            *(ptr(t) for t in out[:7]),
            ptr(obs), ptr(rews), ptr(dones), ptr(ctrls),
            ctypes.c_int(self.batch), ctypes.c_int(self.steps),
            ctypes.c_void_p(stream))
        if err != 0:
            raise RuntimeError(f"rollout kernel launch failed: CUDA error "
                               f"{err} ({built.error_string(err)})")
        self.launches += 1
        return tuple(out)

    # ----- the plain version -----
    def plain(self, qpos, qvel, act, ws, time, ctrl=None, seed=None,
              params=None):
        """The plain PyTorch version on ``qpos.device``: the scalar graph
        on (B,) tensors in a Python K loop."""
        self._check(qpos, qvel, act, ws, time, ctrl, seed, params)
        s, B, K = self.spec, self.batch, self.steps
        dev, dtype = qpos.device, qpos.dtype
        key = (dev, dtype)
        if key not in self._plain_steps:
            bk = sg.TorchBackend(B, dtype, dev)
            self._plain_steps[key] = (bk, sg.build_step(self.model, bk))
        bk, step = self._plain_steps[key]
        hooks = self.hooks
        seed_i = int(seed.reshape(-1)[0].item())
        env = torch.arange(B, device=dev, dtype=torch.int64)
        h = s.h

        q = [qpos[i] for i in range(s.nq)]
        v = [qvel[i] for i in range(s.nv)]
        w = [ws[i] for i in range(s.nv)]
        a_out = act.clone()
        n = torch.round(time[0] * (1.0 / h)).to(torch.int32)
        rew = torch.zeros(B, device=dev, dtype=dtype)
        ndiv = torch.zeros(B, device=dev, dtype=dtype)
        outs = self._alloc(qpos)
        if self.policy is not None:
            layers = [(params[2 * i].to(dtype), params[2 * i + 1].to(dtype))
                      for i in range(len(self.dims) - 1)]
        for k in range(K):
            obs = torch.stack([bk.full(o) for o in hooks.observe(bk, q, v)])
            if self.policy is not None:
                cmat = mlp_forward(layers, obs)
                if self.explore_sigma > 0.0:
                    bits = signed_unit(
                        philox_bits(seed_i, SALT_EXPLORE, k, 2 * s.nu, env),
                        dtype)
                    cmat = cmat + self.explore_sigma * box_muller(
                        bits[:s.nu], bits[s.nu:])
                c = [cmat[u] for u in range(s.nu)]
            else:
                cmat = None
                c = [ctrl[k, u] for u in range(s.nu)]
            if self.emit_obs:
                outs[7][k] = obs
                if self.policy is not None:
                    outs[10][k] = cmat

            q, v, _, w = step(q, v, [], w, c)
            n = n + 1
            # divergence + time limit (bad before the reward, so a NaN
            # reward from a diverged state is masked, not accumulated)
            bad = torch.zeros(B, device=dev, dtype=torch.bool)
            for val in list(q) + list(v):
                if not sg._is_const(val):
                    bad = bad | ~torch.isfinite(val) | (torch.abs(val) > 1e10)
            done = bad | (n >= s.limit_n)
            ndiv = ndiv + bad.to(dtype)
            rew_t = torch.where(bad, 0.0, bk.full(hooks.reward(bk, q, v, c)))
            rew = rew + rew_t
            if self.emit_obs:
                outs[8][k] = rew_t
                outs[9][k] = done.to(dtype)

            sbits = signed_unit(
                philox_bits(seed_i, SALT_RESET, k, s.n_draws, env), dtype)
            nn_ = s.nq + s.nv
            z = box_muller(sbits[s.nq:s.nq + nn_], sbits[s.nq + nn_:])
            q_reset, v_reset = reset_values(s, sbits[:s.nq], z)
            q = [torch.where(done, bk.full(q_reset[i]), bk.full(q[i]))
                 for i in range(s.nq)]
            v = [torch.where(done, bk.full(v_reset[i]), bk.full(v[i]))
                 for i in range(s.nv)]
            w = [torch.where(done, 0.0, bk.full(w[i])) for i in range(s.nv)]
            n = torch.where(done, 0, n)

        outs[0].copy_(torch.stack(q))
        outs[1].copy_(torch.stack(v))
        outs[2].copy_(a_out)
        outs[3].copy_(torch.stack(w))
        outs[4][0] = n.to(dtype) * h
        outs[5][0] = rew
        outs[6][0] = ndiv
        return tuple(outs)


def build_rollout(model: Model, batch: int, steps_per_call: int,
                  hooks: EnvHooks, emit_obs: bool = False,
                  policy=None, fmad: bool = False) -> RolloutFn:
    """The K-step rollout function for ``model`` (see :class:`RolloutFn`);
    ``policy`` is an ``MLPPolicy`` whose layer sizes and exploration sigma
    the kernel takes at run time (its weights are call inputs).  ``fmad``
    builds the kernel with FMA contraction: faster, but it no longer
    rounds as the plain version does (see ``ops.build``)."""
    return RolloutFn(model, batch, steps_per_call, hooks, emit_obs=emit_obs,
                     policy=policy, fmad=fmad)
