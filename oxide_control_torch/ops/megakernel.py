"""The K-step rollout kernel: hand-written CUDA shell + emitted step body.

Replaces the TPU kernel ``oxide_control_tpu/ops/megakernel.py:build_rollout``
(one ``pl.pallas_call`` holding the whole engine).  Per call it runs K env
steps for every env of the batch: pre-step observe, ctrl input or
in-kernel tanh-MLP policy (with optional Gaussian exploration), ``mj_step``,
reward, time limit, divergence test, and masked auto-reset -- the ordering
of the reference's ``Environment::step`` (observe -> ctrl -> step -> reward
-> terminate).

Two versions of one function, chosen by where the state lies:

* CUDA tensors: the kernel ``ops/csrc/rollout.cu``, a team of G lanes of
  one warp per env (:func:`team_rule`) over the coordinate-major
  ``(rows, B)`` layout, the K loop inside the kernel; the team splits the
  line search's row sums and the MLP's outputs.  Its per-model parts (the
  step body,
  observation, reward and reset expressions) are C emitted by
  ``ops.emit`` from ``ops.scalar_graph`` and the task's :class:`EnvHooks`;
  ``ops.build`` compiles it with nvcc for ``sm_90a`` at first use.
* CPU tensors: the plain PyTorch version -- the same scalar graph on
  ``(B,)`` tensors in a Python K loop, the same env layer, Philox stream
  and MLP, summing the line search's rows in the team's order, so the
  two agree bit for bit.  ``RolloutFn.plain`` runs it on any device,
  which is how the kernel is compared with it on the card.

Random numbers are counter-based Philox4x32-10 keyed on ``(seed, salt)``
with counter ``(env, step, block, 0)``: reset noise (salt 7) and
exploration noise (salt 13) are the same bits in both versions.  The TPU
kernel's hardware PRNG, its VMEM tile sizing and its interpret-mode
threefry path have no counterpart here.
"""

from __future__ import annotations

import ctypes
import dataclasses
import inspect
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

    With ``needs_fk`` the reward also receives a keyword argument ``fk``:
    ``scalar_graph.build_fk`` of the post-step q (body frames and site
    positions from the same expressions the step computes).  ``observe``
    receives ``fk`` of the pre-step q only if its signature takes it, so
    a task may read frames in its reward while observing raw coordinates.

    With ``needs_sensors`` ``observe`` also receives ``sensordata``: the
    model's ``nsensordata`` rows from ``scalar_graph.build_sensors`` at the
    pre-step state, computed in the kernel (every sensor must be in the
    kernel family, ``scalar_graph.sensors_supported``).  The clock reads
    the step counter times h; the accelerometer family reads the previous
    step's stage-1 qacc, which the kernel then carries as state (zero at
    a reset, as after the general path's reset).

    Reset distribution: qpos[i] resets to
    ``reset_qpos0[i] + U(-u_i, u_i) + N(0, s_i^2)`` with
    ``u = reset_noise * reset_mask`` and ``s = reset_qpos_sigma``; qvel
    resets to ``N(0, reset_qvel_sigma^2)`` per dof.  Quaternion
    coordinates take the noise like any other, without normalization, as
    the reference's reset does: the step reads a ball or free joint's
    quaternion through normalizing or scale-free maps.
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
    needs_fk: bool = False
    needs_sensors: bool = False


@dataclasses.dataclass(frozen=True)
class EnvSpec:
    """Build-time constants of the env layer (python floats)."""

    nq: int
    nv: int
    nu: int
    na: int
    n_obs: int
    h: float
    limit_n: int
    qpos0: tuple
    uamp: tuple
    qsig: tuple
    vsig: float
    neq: int = 0
    nsensordata: int = 0   # sensor rows observe reads (0: no sensors)
    carry_qacc: bool = False  # an accelerometer-family sensor reads qacc
    nmocap: int = 0        # mocap bodies, posed by the (7*nmocap, B) input
    applied: bool = False  # takes the qfrc (nv, B), xfrc (6*nbody, B) inputs
    nbody: int = 0         # bodies: xfrc has 6 rows per body

    @property
    def n_draws(self) -> int:
        """Philox values per reset: nq uniforms + 2 per Box-Muller normal
        for the nq + nv normals (the TPU kernel's layout)."""
        return self.nq + 2 * (self.nq + self.nv)


def env_spec(model: Model, hooks: EnvHooks,
             applied_forces: bool = False) -> EnvSpec:
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
    nsens, carry_qacc = 0, False
    if hooks.needs_sensors:
        reason = sg.unsupported_sensor_reason(model)
        if reason is not None:
            raise ValueError(f"the task observes sensors: {reason}")
        nsens = model.nsensordata
        carry_qacc = any(sg.SensorType(t) in sg._ACC_SENSORS
                         for t in model.sensor_type)
    return EnvSpec(nq=nq, nv=model.nv, nu=model.nu, na=model.na,
                   n_obs=hooks.n_obs, h=h, limit_n=limit_n,
                   qpos0=tuple(qpos0), uamp=tuple(uamp), qsig=tuple(qsig),
                   vsig=float(hooks.reset_qvel_sigma), neq=model.neq,
                   nsensordata=nsens, carry_qacc=carry_qacc,
                   nmocap=model.nmocap, applied=bool(applied_forces),
                   nbody=model.nbody)


def _observe_reads_fk(hooks: EnvHooks) -> bool:
    """Whether ``observe`` receives ``fk``: with ``needs_fk``, if its
    signature takes it."""
    if not hooks.needs_fk or hooks.observe is None:
        return False
    params = inspect.signature(hooks.observe).parameters.values()
    return any(p.kind == p.VAR_KEYWORD or p.name == "fk" for p in params)


def _hooks_read_mocap(model: Model, hooks: EnvHooks):
    """(observe, reward): whether each hook reads the mocap poses, i.e.
    the model has mocap bodies and the hook reads the FK or sensors."""
    if not model.nmocap:
        return False, False
    return (_observe_reads_fk(hooks) or hooks.needs_sensors,
            hooks.needs_fk)


def bind_hooks(model: Model, hooks: EnvHooks, bk):
    """``(observe(q, v, qacc=None, time=None, mocap=None),
    reward(q, v, c, mocap=None))``: the task's hooks on backend ``bk``,
    with ``fk`` and ``sensordata`` passed as :class:`EnvHooks` says (the
    reference's rule, ``oxide_control_tpu/ops/megakernel.py:160-177`` and
    ``:442-452``, ``:473``; ``qacc`` and ``time`` feed the sensors, and
    ``mocap`` poses the mocap bodies of the FK and the sensors).  The
    plain version and the emitted kernel both call the hooks through
    this, so they evaluate the same expressions in the same order."""
    fk = sg.build_fk(model, bk) if hooks.needs_fk else None
    sens = sg.build_sensors(model, bk) if hooks.needs_sensors else None
    obs_fk = _observe_reads_fk(hooks)

    def observe(q, v, qacc=None, time=None, mocap=None):
        kw = {"fk": fk(q, mocap=mocap)} if obs_fk else {}
        if sens is not None:
            kw["sensordata"] = sens(q, v, qacc=qacc, time=time, mocap=mocap)
        return list(hooks.observe(bk, q, v, **kw))

    def reward(q, v, c, mocap=None):
        kw = {"fk": fk(q, mocap=mocap)} if fk is not None else {}
        return hooks.reward(bk, q, v, c, **kw)

    return observe, reward


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
    step_ops: int        # dynamic lane-ops of one emitted step, per lane
    step_sfu_ops: int    # of which special-function ops
    reset_ops: int       # lane-ops of one masked reset (emitted part)
    env_ops: int         # observe + reward lane-ops per env-step
    team: int            # lanes per env (OXC_TEAM)
    work_step_ops: int   # lane-ops of the G = 1 step: the work the
    work_step_sfu_ops: int  # algorithm needs, which the bound counts
    line_search_terms: int  # rows + cone rows each dphi sums


# the team rule, fixed from tools/team_sweep.py's table (PERF.md): a
# model whose line search sums fewer than TEAM_MIN_TERMS terms gains
# nothing from a team; among the rest, a G = 1 step of at most
# TEAM_SMALL_OPS lane-ops keeps its state in registers and takes 8 lanes,
# one of at most TEAM_LARGE_OPS spills a stack frame of some 2 KB, which
# every lane of a team holds, so 4 lanes fill the L1 before 8 help; a
# larger one (a dense mass matrix, a stack frame of 7-12 KB) runs its
# step slower on any team and keeps G = 1, unless it runs the policy,
# whose MLP the team splits: then 2 lanes
TEAM_MIN_TERMS = 16
TEAM_SMALL_OPS = 100_000
TEAM_LARGE_OPS = 200_000


def team_rule(src: KernelSource, policy: bool = False) -> int:
    """The team size G of a model from its G = 1 source's counts -- the
    line-search terms (rows + cone rows) and the step's lane-ops -- and
    whether the rollout runs the in-kernel policy."""
    if src.line_search_terms < TEAM_MIN_TERMS:
        return 1
    if src.work_step_ops > TEAM_LARGE_OPS:
        return 2 if policy else 1
    return 8 if src.work_step_ops <= TEAM_SMALL_OPS else 4


def default_team(model: Model, hooks: EnvHooks, applied_forces: bool = False,
                 policy: bool = False) -> int:
    """The team size the kernel of ``model`` runs at (:func:`team_rule`)."""
    return team_rule(_emit_source(model, hooks, "float", applied_forces, 1),
                     policy)


def kernel_source(model: Model, hooks: EnvHooks, ctype: str = "float",
                  applied_forces: bool = False,
                  team: int | None = None) -> KernelSource:
    """The per-model C header the CUDA shell includes: sizes, env-layer
    constants and the emitted ``oxc_step`` / ``oxc_observe`` /
    ``oxc_reward`` / ``oxc_reset`` functions.

    The inputs that are constant over a call -- the mocap poses
    (``mc``, 7 * nmocap rows) and, with ``applied_forces``, the applied
    forces (``qf``, nv rows; ``xf``, 6 * nbody rows) -- are pointers into
    the env's column of the (rows, B) input, element i at ``i * ld``, read
    where the step uses them; a function takes them only when the model
    (or the flag) has them, so every other source is unchanged.

    ``team`` is the number of lanes that run one env (``OXC_TEAM``; the
    line search's team, see ``scalar_graph._linesearch_scalar``); None
    takes :func:`team_rule`'s (without a policy) for the kernel's float
    source and 1 for the host checks' double source, which runs on the
    host, one lane per env.  A G = 1 source is the one-thread-per-env
    source, byte for byte."""
    base = _emit_source(model, hooks, ctype, applied_forces, 1)
    if team is None:
        team = team_rule(base) if ctype == "float" else 1
    if team == 1:
        return base
    src = _emit_source(model, hooks, ctype, applied_forces, team)
    return dataclasses.replace(src, work_step_ops=base.step_ops,
                               work_step_sfu_ops=base.step_sfu_ops)


def _emit_source(model: Model, hooks: EnvHooks, ctype: str,
                 applied_forces: bool, team: int) -> KernelSource:
    from .emit import PRELUDE, TEAM_PRELUDE, Emitter

    if hooks.observe is None:
        raise ValueError("the rollout kernel needs EnvHooks.observe")
    spec = env_spec(model, hooks, applied_forces)
    nq, nv, nu, na, n_obs = spec.nq, spec.nv, spec.nu, spec.na, spec.n_obs
    T = ctype
    parts = []
    mc_arg = f"const {T}* mc, int ld, "
    obs_mc, rew_mc = _hooks_read_mocap(model, hooks)

    em = Emitter(ctype, team)
    step = sg.build_step(model, em, want_qacc=spec.carry_qacc, team=team)
    q, v, a = em.load("q", nq), em.load("v", nv), em.load("a", na)
    w, c = em.load("w", nv), em.load("c", nu)
    # a model with equality constraints takes one bool lane per equality
    eq = em.load("eq", spec.neq, "b") if spec.neq else None
    ext, ext_arg = {}, ""
    if spec.nmocap:
        ext["mocap"] = em.load("mc", 7 * spec.nmocap, stride="ld")
        ext_arg += f"const {T}* mc, "
    if spec.applied:
        ext["qfrc_ext"] = em.load("qf", nv, stride="ld")
        ext["xfrc_ext"] = em.load("xf", 6 * spec.nbody, stride="ld")
        ext_arg += f"const {T}* qf, const {T}* xf, "
    if ext:
        ext_arg += "int ld, "
    outs = step(q, v, a, w, c, eq, **ext)
    for name, xs in zip(("q_out", "v_out", "a_out", "w_out", "qa_out"),
                        outs):
        em.store(name, xs)
    eq_arg = "const bool* eq, " if spec.neq else ""
    # the stage-1 qacc the accelerometer family reads at the next step
    qa_arg = f", {T}* qa_out" if spec.carry_qacc else ""
    # a team's lane index and lane mask
    team_arg = ", int tl, unsigned tm" if team > 1 else ""
    parts.append(em.function(
        f"void oxc_step(const {T}* q, const {T}* v, const {T}* a, "
        f"const {T}* w, const {T}* c, {eq_arg}{ext_arg}{T}* q_out, "
        f"{T}* v_out, {T}* a_out, {T}* w_out{qa_arg}{team_arg})"))
    step_ops, step_sfu = em.ops, em.sfu_ops

    eo = Emitter(ctype)
    q, v = eo.load("q", nq), eo.load("v", nv)
    mc = eo.load("mc", 7 * spec.nmocap, stride="ld") if obs_mc else None
    if spec.nsensordata:
        # the sensors read the carried qacc (when an acceleration sensor
        # is present) and the clock n * h
        qa = eo.load("qa", nv) if spec.carry_qacc else None
        rows = bind_hooks(model, hooks, eo)[0](q, v, qa, eo.load("clk", 1)[0],
                                               mocap=mc)
        sens_args = f"const {T}* qa, const {T}* clk, "
    else:
        rows = bind_hooks(model, hooks, eo)[0](q, v, mocap=mc)
        sens_args = ""
    if len(rows) != n_obs:
        raise ValueError(f"observe gave {len(rows)} rows, n_obs={n_obs}")
    eo.store("obs", rows)
    parts.append(eo.function(
        f"void oxc_observe(const {T}* q, const {T}* v, {sens_args}"
        f"{mc_arg if obs_mc else ''}{T}* obs)"))

    er = Emitter(ctype)
    q, v, c = er.load("q", nq), er.load("v", nv), er.load("c", nu)
    mc = er.load("mc", 7 * spec.nmocap, stride="ld") if rew_mc else None
    er.ret(bind_hooks(model, hooks, er)[1](q, v, c, mocap=mc))
    parts.append(er.function(
        f"{T} oxc_reward(const {T}* q, const {T}* v, const {T}* c"
        f"{', ' + mc_arg[:-2] if rew_mc else ''})"))

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
        f"#define OXC_NA {na}",
        f"#define OXC_NOBS {n_obs}",
        f"#define OXC_NDRAW {spec.n_draws}",
        f"#define OXC_LIMIT_N {spec.limit_n}",
        f"#define OXC_H {lit(spec.h)}",
        f"#define OXC_INV_H {lit(1.0 / spec.h)}",
    ] + ([f"#define OXC_NEQ {spec.neq}"] if spec.neq else [])
      + ([f"#define OXC_NSENSORDATA {spec.nsensordata}"]
         if spec.nsensordata else [])
      + (["#define OXC_CARRY_QACC 1"] if spec.carry_qacc else [])
      + ([f"#define OXC_NMOCAP {spec.nmocap}"] if spec.nmocap else [])
      + (["#define OXC_OBS_MOCAP 1"] if obs_mc else [])
      + (["#define OXC_REW_MOCAP 1"] if rew_mc else [])
      + (["#define OXC_APPLIED 1"] if spec.applied else [])
      + ([f"#define OXC_TEAM {team}"] if team > 1 else []))
    text = (f"/* emitted by oxide_control_torch.ops.megakernel.kernel_source"
            f" ({ctype}): do not edit */\n#pragma once\n" + PRELUDE
            + (TEAM_PRELUDE if team > 1 else "") + "\n"
            + defines + "\n\n" + "\n".join(parts))
    return KernelSource(text=text, step_ops=step_ops, step_sfu_ops=step_sfu,
                        reset_ops=ez.ops, env_ops=eo.ops + er.ops, team=team,
                        work_step_ops=step_ops, work_step_sfu_ops=step_sfu,
                        line_search_terms=em.line_search_terms)


# ---------------------------------------------------------------------------
# the rollout function: kernel on CUDA tensors, plain version on the CPU
# ---------------------------------------------------------------------------


def _pack_params(params, dims, device, dtype, transpose: bool = False):
    """Flatten (W_1, b_1, ..., W_L, b_L) into one contiguous buffer in the
    kernel's layout: per layer W (out, in) row-major, then b (out); with
    ``transpose`` (the layout a team reads) W^T (in, out) row-major."""
    flat = []
    for i in range(len(dims) - 1):
        w, b = params[2 * i], params[2 * i + 1]
        if tuple(w.shape) != (dims[i + 1], dims[i]):
            raise ValueError(f"layer {i}: W shape {tuple(w.shape)}, "
                             f"want {(dims[i + 1], dims[i])}")
        flat.append((w.t() if transpose else w).reshape(-1))
        flat.append(b.reshape(-1))
    return torch.cat(flat).to(device=device, dtype=dtype).contiguous()


# the inputs that are constant over one call, in the reference kernel's
# order (oxide_control_tpu/ops/megakernel.py:143-146)
CALL_INPUTS = ("mocap", "eq_active", "qfrc", "xfrc")


def input_rows(spec: EnvSpec) -> dict:
    """Rows of each call input the spec takes (0: it takes none)."""
    return dict(mocap=7 * spec.nmocap, eq_active=spec.neq,
                qfrc=spec.nv if spec.applied else 0,
                xfrc=6 * spec.nbody if spec.applied else 0)


def _step_inputs(ins):
    """The step's lanes of the call inputs ``(mocap, eq_active, qfrc,
    xfrc)``: ``(eq_act, dict of keywords)``, None for an input absent or
    of 0 rows; eq_active's lanes are the kernel's ``eq_active != 0``."""
    lanes = [None if x is None or not len(x) else list(x) for x in ins]
    mocap, eqa, qf, xf = lanes
    if eqa is not None:
        eqa = [row != 0 for row in eqa]
    return eqa, dict(mocap=mocap, qfrc_ext=qf, xfrc_ext=xf)


class _GraphedStep:
    """The plain step captured once as a CUDA graph and replayed.

    One step is some 1e4 (cartpole) to 2e5 (humanoid) small torch ops, and
    on the card the host's launch cost (about 9 us per op) paces them.  A
    replay runs the same kernels in the same order on the same inputs, so
    it returns the eager step's results bit for bit, without that cost."""

    def __init__(self, bk, step, spec: EnvSpec):
        dev = bk.device
        # the call inputs (mocap, eq_active, qfrc, xfrc) are input buffers
        # too: nothing is copied from the host while the graph is captured
        rows = input_rows(spec)
        self.ins = [torch.zeros((n, bk.batch), device=dev, dtype=bk.dtype)
                    for n in (spec.nq, spec.nv, spec.na, spec.nv, spec.nu,
                              *(rows[k] for k in CALL_INPUTS))]

        def run():
            q, v, a, w, c = (list(x) for x in self.ins[:5])
            eqa, ext = _step_inputs(self.ins[5:])
            outs = step(q, v, a, w, c, eqa, **ext)
            return [torch.stack([bk.full(x) for x in xs]) if xs else None
                    for xs in outs]

        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            run()  # warm-up outside the capture
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        # thread_local: other threads may use CUDA meanwhile (chip_smoke
        # loads freshly built kernel libraries while this captures)
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self.outs = run()

    def __call__(self, q, v, a, w, c, ins):
        for buf, xs in zip(self.ins, (q, v, a, w, c)):
            if xs:
                buf.copy_(torch.stack(xs))
        for buf, x in zip(self.ins[5:], ins):
            if x is not None:
                buf.copy_(x)
        self.graph.replay()
        return tuple([] if o is None else list(o.clone())
                     for o in self.outs)


class RolloutFn:
    """``fn(qpos (nq,B), qvel (nv,B), act (max(na,1),B), ws (nv,B),
    time (1,B)[, qacc (nv,B)], ctrl (K,nu,B) | None, seed (1,) int32,
    params=None, eq_active=None, *, mocap=None, qfrc=None, xfrc=None)``.

    Without a policy ``ctrl`` is required (a model without actuators may
    pass one unused row, ``(K, 1, B)``, as the reference's callers do);
    with one, ``params`` is the list (W_1, b_1, ..., W_L, b_L) with W
    (out, in) and b (out, 1) and ``ctrl`` is None.  The call inputs are
    constant over the call, each ``(rows, B)`` in the state's dtype on
    its device, and required exactly when the model or the build takes
    them: ``mocap (7*nmocap,B)``, (pos3, quat4) per mocap body
    (Data.mocap_pos/mocap_quat), for a model with mocap bodies;
    ``eq_active (neq,B)``, 0/1 per env and equality (Data.eq_active), for
    a model with equality constraints; ``qfrc (nv,B)`` and
    ``xfrc (6*nbody,B)`` (Data.qfrc_applied, xfrc_applied: force then
    torque per body) with ``applied_forces``.
    A task that observes an accelerometer-family sensor carries the
    stage-1 ``qacc`` as a sixth state element, after time (``n_state``
    is 6, as in the reference).
    Returns ``(qpos', qvel', act', ws', time'[, qacc'],
    reward_sum (1,B), diverged (1,B))`` plus, with ``emit_obs``,
    ``obs (K,n_obs,B), rewards (K,B), dones (K,B)`` and, with a policy,
    ``ctrls (K,nu,B)``.

    CUDA tensors launch the kernel (``launches`` counts each launch);
    CPU tensors run :meth:`plain`.  No failure of the kernel falls back
    to the plain version.
    """

    def __init__(self, model: Model, batch: int, steps_per_call: int,
                 hooks: EnvHooks, emit_obs: bool = False, policy=None,
                 fmad: bool = False, applied_forces: bool = False,
                 team: int | None = None):
        reason = sg.unsupported_reason(model)
        if reason is not None:
            raise ValueError(f"model not kernel-eligible: {reason}")
        if hooks.observe is None:
            raise ValueError("the rollout kernel needs EnvHooks.observe")
        self.model = model
        self.hooks = hooks
        self.spec = env_spec(model, hooks, applied_forces)
        self.n_state = 6 if self.spec.carry_qacc else 5
        self.batch = batch
        self.steps = steps_per_call
        self.emit_obs = emit_obs
        self.policy = policy
        self.fmad = fmad
        if team is not None and team not in sg.TEAM_SIZES:
            raise ValueError(f"team must be one of {sg.TEAM_SIZES}")
        self._team = team
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

    @property
    def team(self) -> int:
        """Lanes per env of the kernel, and the team order of the plain
        version's line search (:func:`default_team` unless given)."""
        if self._team is None:
            self._team = default_team(self.model, self.hooks,
                                      self.spec.applied,
                                      self.policy is not None)
        return self._team

    # ----- shared checks -----
    def _bind(self, args, kw):
        """``(state, ctrl, seed, params, mocap, eq_active, qfrc, xfrc)``
        of a call: the first ``n_state`` arguments are the state, then
        ctrl, seed, params and eq_active by position or name; mocap, qfrc
        and xfrc by name."""
        n = self.n_state
        if len(args) < n:
            raise ValueError(f"the rollout takes {n} state tensors, got "
                             f"{len(args)}")
        names = ("ctrl", "seed", "params", "eq_active")
        if len(args) > n + len(names) or set(kw) - set(names + CALL_INPUTS):
            raise TypeError("arguments after the state: ctrl, seed, "
                            "params, eq_active; by name mocap, qfrc, xfrc")
        rest = dict(zip(names, args[n:]))
        for k, x in kw.items():
            if k in rest:
                raise TypeError(f"{k} given twice")
            rest[k] = x
        return (tuple(args[:n]),) + tuple(
            rest.get(k) for k in ("ctrl", "seed", "params") + CALL_INPUTS)

    def _check(self, state, ctrl, seed, params, mocap=None, eq_active=None,
               qfrc=None, xfrc=None):
        s, B, K = self.spec, self.batch, self.steps
        want = dict(qpos=(s.nq, B), qvel=(s.nv, B), act=(self.na_rows, B),
                    ws=(s.nv, B), time=(1, B), qacc=(s.nv, B))
        dev, dtype = state[0].device, state[0].dtype
        for name, t in zip(want, state):
            if tuple(t.shape) != want[name]:
                raise ValueError(f"{name} shape {tuple(t.shape)}, want "
                                 f"{want[name]}")
            if t.device != dev or t.dtype != dtype:
                raise ValueError(f"{name} must be {dtype} on {dev}")
        if self.policy is None:
            shapes = {(K, s.nu, B), (K, max(s.nu, 1), B)}
            if ctrl is None or tuple(ctrl.shape) not in shapes:
                raise ValueError(f"ctrl must have shape {(K, s.nu, B)}")
            if ctrl.device != dev or ctrl.dtype != dtype:
                raise ValueError(f"ctrl must be {dtype} on {dev}")
        elif params is None or len(params) != 2 * (len(self.dims) - 1):
            raise ValueError("a policy rollout needs params "
                             "(W_1, b_1, ..., W_L, b_L)")
        if seed is None or seed.numel() != 1 or seed.device != dev:
            raise ValueError(f"seed must be one int32 on {dev}")
        what = dict(mocap="mocap bodies", eq_active="equality constraints",
                    qfrc="applied forces", xfrc="applied forces")
        for (name, rows), x in zip(input_rows(s).items(),
                                   (mocap, eq_active, qfrc, xfrc)):
            if not rows and x is not None:
                raise ValueError(f"{name} given for a rollout without "
                                 f"{what[name]}")
            if rows and (x is None or tuple(x.shape) != (rows, B)
                         or x.device != dev or x.dtype != dtype):
                raise ValueError(f"a rollout with {what[name]} needs "
                                 f"{name} of shape {(rows, B)}, {dtype} "
                                 f"on {dev}")

    def _alloc(self, like):
        s, B, K = self.spec, self.batch, self.steps
        dev, dtype = like.device, like.dtype
        e = lambda *shape: torch.empty(shape, device=dev, dtype=dtype)
        out = [e(s.nq, B), e(s.nv, B), e(self.na_rows, B), e(s.nv, B),
               e(1, B)]
        if s.carry_qacc:
            out.append(e(s.nv, B))
        out += [e(1, B), e(1, B)]
        if self.emit_obs:
            out += [e(K, s.n_obs, B), e(K, B), e(K, B)]
            if self.policy is not None:
                out.append(e(K, s.nu, B))
        return out

    def __call__(self, *args, **kw):
        call = self._bind(args, kw)
        qpos = call[0][0]
        if qpos.is_cuda:
            return self._launch(*call)
        if qpos.device.type != "cpu":
            raise ValueError(f"no rollout for device {qpos.device}")
        return self._plain(*call)

    # ----- the kernel -----
    def build(self):
        """Emit the model's C and build the kernel library (cached under
        build/ by source hash); returns ``ops.build.Built``."""
        if self._lib is None:
            from . import build
            src = kernel_source(self.model, self.hooks, "float",
                                self.spec.applied, self.team)
            self._lib = build.build_rollout_library(src, fmad=self.fmad)
        return self._lib

    def _launch(self, state, ctrl, seed, params, mocap=None, eq_active=None,
                qfrc=None, xfrc=None):
        ins = (mocap, eq_active, qfrc, xfrc)
        self._check(state, ctrl, seed, params, *ins)
        if state[0].dtype != torch.float32:
            raise ValueError("the rollout kernel takes float32 state")
        for t in state + tuple(t for t in (ctrl,) + ins if t is not None):
            if not t.is_contiguous():
                raise ValueError("the rollout kernel takes contiguous "
                                 "tensors")
        if seed.dtype != torch.int32:
            raise ValueError("seed must be int32")
        built = self.build()
        out = self._alloc(state[0])
        if self.policy is not None:
            packed = _pack_params(params, self.dims, state[0].device,
                                  torch.float32, transpose=self.team > 1)
            n_params = packed.numel()
        else:
            packed, n_params = None, 0
        dims = (ctypes.c_int * (MAX_LAYERS + 1))(
            *(self.dims + [0] * (MAX_LAYERS + 1 - len(self.dims))))
        ptr = lambda t: ctypes.c_void_p(t.data_ptr() if t is not None
                                        else 0)
        ns = self.n_state
        qacc = qacc_o = None
        if self.spec.carry_qacc:
            qacc, qacc_o = state[5], out[5]
        obs = rews = dones = ctrls = None
        if self.emit_obs:
            obs, rews, dones = out[ns + 2:ns + 5]
            if self.policy is not None:
                ctrls = out[ns + 5]
        stream = torch.cuda.current_stream(state[0].device).cuda_stream
        err = built.launch(
            *(ptr(t) for t in state[:5]), ptr(qacc),
            ptr(ctrl), ptr(seed), ptr(packed), ctypes.c_int(n_params),
            *(ptr(t) for t in ins),
            ctypes.c_int(max(len(self.dims) - 1, 0)), dims,
            ctypes.c_float(self.explore_sigma),
            *(ptr(t) for t in out[:5]), ptr(qacc_o),
            *(ptr(t) for t in out[ns:ns + 2]),
            ptr(obs), ptr(rews), ptr(dones), ptr(ctrls),
            ctypes.c_int(self.batch), ctypes.c_int(self.steps),
            ctypes.c_void_p(stream))
        if err != 0:
            raise RuntimeError(f"rollout kernel launch failed: CUDA error "
                               f"{err} ({built.error_string(err)})")
        self.launches += 1
        return tuple(out)

    # ----- the plain version -----
    def plain(self, *args, **kw):
        """The plain PyTorch version on the state's device: the scalar
        graph on (B,) tensors in a Python K loop (on a card, its step
        replayed from a CUDA graph: see :class:`_GraphedStep`)."""
        return self._plain(*self._bind(args, kw))

    def _plain(self, state, ctrl, seed, params, mocap=None, eq_active=None,
               qfrc=None, xfrc=None):
        ins = (mocap, eq_active, qfrc, xfrc)
        self._check(state, ctrl, seed, params, *ins)
        s, B, K = self.spec, self.batch, self.steps
        qpos, qvel, act, ws, time = state[:5]
        dev, dtype = qpos.device, qpos.dtype
        key = (dev, dtype)
        if key not in self._plain_steps:
            bk = sg.TorchBackend(B, dtype, dev)
            step = sg.build_step(self.model, bk, want_qacc=s.carry_qacc,
                                 team=self.team)
            if dev.type == "cuda":
                step = _GraphedStep(bk, step, s)
            else:
                def step(q, v, a, w, c, ins, f=step):
                    eqa, ext = _step_inputs(ins)
                    return f(q, v, a, w, c, eqa, **ext)
            self._plain_steps[key] = (bk, step,
                                      *bind_hooks(self.model, self.hooks, bk))
        bk, step, observe, reward = self._plain_steps[key]
        seed_i = int(seed.reshape(-1)[0].item())
        env = torch.arange(B, device=dev, dtype=torch.int64)
        h = s.h

        q = [qpos[i] for i in range(s.nq)]
        v = [qvel[i] for i in range(s.nv)]
        a = [act[i] for i in range(s.na)]
        w = [ws[i] for i in range(s.nv)]
        qa = [state[5][i] for i in range(s.nv)] if s.carry_qacc else None
        # the hooks read the mocap poses where they read the FK
        moc = _step_inputs(ins)[1]["mocap"]
        n = torch.round(time[0] * (1.0 / h)).to(torch.int32)
        rew = torch.zeros(B, device=dev, dtype=dtype)
        ndiv = torch.zeros(B, device=dev, dtype=dtype)
        outs = self._alloc(qpos)
        ns = self.n_state
        if self.policy is not None:
            layers = [(params[2 * i].to(dtype), params[2 * i + 1].to(dtype))
                      for i in range(len(self.dims) - 1)]
        for k in range(K):
            # the clock reads the step counter, as the kernel does
            clk = n.to(dtype) * h if s.nsensordata else None
            obs = torch.stack([bk.full(o)
                               for o in observe(q, v, qa, clk, mocap=moc)])
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
                outs[ns + 2][k] = obs
                if self.policy is not None:
                    outs[ns + 5][k] = cmat

            q, v, a, w, *qa1 = step(q, v, a, w, c, ins)
            n = n + 1
            # divergence + time limit (bad before the reward, so a NaN
            # reward from a diverged state is masked, not accumulated)
            bad = torch.zeros(B, device=dev, dtype=torch.bool)
            for val in list(q) + list(v):
                if not sg._is_const(val):
                    bad = bad | ~torch.isfinite(val) | (torch.abs(val) > 1e10)
            done = bad | (n >= s.limit_n)
            ndiv = ndiv + bad.to(dtype)
            rew_t = torch.where(bad, 0.0, bk.full(reward(q, v, c,
                                                         mocap=moc)))
            rew = rew + rew_t
            if self.emit_obs:
                outs[ns + 3][k] = rew_t
                outs[ns + 4][k] = done.to(dtype)

            sbits = signed_unit(
                philox_bits(seed_i, SALT_RESET, k, s.n_draws, env), dtype)
            nn_ = s.nq + s.nv
            z = box_muller(sbits[s.nq:s.nq + nn_], sbits[s.nq + nn_:])
            q_reset, v_reset = reset_values(s, sbits[:s.nq], z)
            q = [torch.where(done, bk.full(q_reset[i]), bk.full(q[i]))
                 for i in range(s.nq)]
            v = [torch.where(done, bk.full(v_reset[i]), bk.full(v[i]))
                 for i in range(s.nv)]
            a = [torch.where(done, 0.0, bk.full(a[i])) for i in range(s.na)]
            w = [torch.where(done, 0.0, bk.full(w[i])) for i in range(s.nv)]
            if s.carry_qacc:
                # reset lanes: the qacc carry is zero, as after a reset
                qa = [torch.where(done, 0.0, bk.full(x)) for x in qa1[0]]
            n = torch.where(done, 0, n)

        outs[0].copy_(torch.stack(q))
        outs[1].copy_(torch.stack(v))
        # na == 0 models carry one act row, passed through
        outs[2].copy_(torch.stack(a) if s.na else act)
        outs[3].copy_(torch.stack(w))
        outs[4][0] = n.to(dtype) * h
        if s.carry_qacc:
            outs[5].copy_(torch.stack(qa))
        outs[ns][0] = rew
        outs[ns + 1][0] = ndiv
        return tuple(outs)


def build_rollout(model: Model, batch: int, steps_per_call: int,
                  hooks: EnvHooks, emit_obs: bool = False,
                  policy=None, fmad: bool = False,
                  applied_forces: bool = False,
                  team: int | None = None) -> RolloutFn:
    """The K-step rollout function for ``model`` (see :class:`RolloutFn`);
    ``policy`` is an ``MLPPolicy`` whose layer sizes and exploration sigma
    the kernel takes at run time (its weights are call inputs).  ``fmad``
    builds the kernel with FMA contraction: faster, but it no longer
    rounds as the plain version does (see ``ops.build``).
    ``applied_forces`` adds the qfrc and xfrc call inputs
    (Data.qfrc_applied, xfrc_applied), as the reference's flag does.
    ``team`` sets the lanes per env (:func:`default_team` by default): the
    kernel and the plain version both follow its summation order, so
    they agree bit for bit at every G."""
    return RolloutFn(model, batch, steps_per_call, hooks, emit_obs=emit_obs,
                     policy=policy, fmad=fmad, applied_forces=applied_forces,
                     team=team)
