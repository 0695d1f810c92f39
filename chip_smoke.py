"""Smoke run of the PyTorch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Drives the port's main path -- ``FastRollout`` on cheetah-run at 4096 envs,
200 steps per call, with uniform ctrl and with the in-kernel (64, 64)
policy collecting trajectories -- through the hand-written CUDA rollout
kernel, after building it from the sources in this checkout and holding it
against its plain PyTorch version.  Phases, each fatal on failure:

1. device: the card's name and power limit;
2. build: nvcc for sm_90a, every distinct source at once, with seconds,
   emitted lines, registers, spills;
3. Philox: the Random123 known-answer vectors, computed on the card;
4. parity: kernel vs plain version through resets, at the main path's
   shapes (B = 4096, K = 200) with ctrl input and with the policy +
   collection, and at B = 4096, K = 24 for two options off the main path
   (exploration noise, Gaussian reset noise); the two main-path modes also
   time the kernel and the plain version on the same inputs, and the
   kernel built with FMA contraction (the price of bit-exact parity);
5. main path: 1 warm-up + 10 timed calls of each row (CUDA events), with
   the kernel's launch count set to 0 before and read after those calls;
6. the kernels line (JSON) and the last line (JSON).

Needs one CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from oxide_control_torch import suite
from oxide_control_torch.ops import megakernel as mk
from oxide_control_torch.parallel.rollout import FastRollout
from oxide_control_torch.policy import MLPPolicy

B, K = 4096, 200     # the main path's shapes
K_OPTION = 24        # parity depth of the options off the main path
N_TIMED = 10
ROWS = (("cheetah-run@4096", "ctrl"), ("run-policy-obs@4096", "policy"))
# peaks of one H100 SXM (NVIDIA data sheet, 700 W): 67 TFLOP/s f32 counts
# an FMA as two, so 33.5e12 separate lane-ops/s; special functions at 16
# per SM per clock (132 SMs, 1.98 GHz boost); 3.35 TB/s of HBM
LANE_OPS_PER_S = 33.5e12
SFU_OPS_PER_S = 132 * 16 * 1.98e9
BYTES_PER_S = 3.35e12
BARS = dict(qpos=1e-4, qvel=1e-3, reward_sum=1e-4, obs=1e-4, ctrls=1e-5)


def log(*args):
    print(*args, flush=True)


def device_phase():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"device: {name}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    log(smi)
    return name, smi


def build_phase(fns):
    """Build every kernel at once: one nvcc for each distinct source (the
    others wait for it and load its library from build/)."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(fns)) as pool:
        built = dict(zip(fns, pool.map(lambda fn: fn.build(),
                                       fns.values())))
    log(f"build: {time.perf_counter() - t0:.2f} s with emission")
    for label, b in built.items():
        log(f"  {label}: nvcc {b.seconds:.2f} s (cached: {b.cached}), "
            f"{b.emitted_lines} emitted lines, {b.registers} registers, "
            f"{b.stack_bytes} B stack, {b.spill_stores} B spill stores, "
            f"{b.spill_loads} B spill loads; step {b.step_ops} lane-ops "
            f"({b.step_sfu_ops} special-function)")
    # the main path's library, with the seconds of the one thread that ran
    # nvcc for its source
    main = built["ctrl"]
    return dataclasses.replace(main, seconds=max(
        b.seconds for b in built.values() if b.so_path == main.so_path))


def philox_phase():
    dev = torch.device("cuda")
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    ones = zero + 0xFFFFFFFF
    got = [
        [int(x) for x in mk.philox4x32((zero,) * 4, (0, 0))],
        [int(x) for x in mk.philox4x32((ones,) * 4,
                                       (0xFFFFFFFF, 0xFFFFFFFF))],
    ]
    want = [[0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8],
            [0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd]]
    if got != want:
        raise AssertionError(f"Philox known-answer mismatch: {got}")
    log("philox: known-answer vectors match on the card")


def parity_inputs(benv, fn, gen):
    """A reset batch whose step counters are spread over the episode, so
    that some envs cross the time limit inside the window, with the
    call's ctrl or policy weights."""
    data = benv.reset(gen)
    n0 = torch.randint(0, fn.spec.limit_n, (B,), generator=gen,
                       device="cuda")
    state = (data.qpos.T.contiguous(), data.qvel.T.contiguous(),
             torch.zeros((1, B), device="cuda"),
             data.qacc_warmstart.T.contiguous(),
             (n0.to(torch.float32) * fn.spec.h)[None].contiguous())
    seed = torch.tensor([20261016], dtype=torch.int32, device="cuda")
    ctrl = params = None
    if fn.policy is None:
        ctrl = torch.empty((fn.steps, fn.spec.nu, B), device="cuda")
        ctrl.uniform_(-1.0, 1.0, generator=gen)
    else:
        params = fn.policy.kernel_params()
    return state + (ctrl, seed, params)


def time_kernel(fn, args):
    """ms per call of the kernel alone, 1 warm-up + N_TIMED calls between
    CUDA events."""
    fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(N_TIMED):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / N_TIMED


def max_errors(ko, po, collect):
    e = dict(qpos=ko[0] - po[0], qvel=ko[1] - po[1],
             reward_sum=ko[5] - po[5])
    if collect:
        e["obs"] = ko[7] - po[7]
        if len(ko) > 10:
            e["ctrls"] = ko[10] - po[10]
    return {k: float(x.abs().max()) for k, x in e.items()}


def parity_phase(benv, fns, fma):
    """Kernel vs plain version on the card, one mode at a time; for the
    main path's two modes also the kernel's and the plain version's time
    on the same inputs, and the FMA-contracted build's time and drift."""
    res = {}
    for mode, fn in fns.items():
        gen = torch.Generator(device="cuda").manual_seed(7)
        args = parity_inputs(benv, fn, gen)
        ko = fn(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        po = fn.plain(*args)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        me = max_errors(ko, po, fn.emit_obs)
        if fn.emit_obs and not torch.equal(ko[9], po[9]):
            raise AssertionError(f"{mode}: dones differ")
        n_in = torch.round(args[4][0] / fn.spec.h)
        resets = int(((n_in + fn.steps) // fn.spec.limit_n).sum()
                     + ko[6].sum())
        same = all(torch.equal(a, b) for a, b in zip(ko, po))
        log(f"parity {mode} (B={fn.batch}, K={fn.steps}, {resets} resets): "
            + ", ".join(f"{k} {v:.3e} (bar {BARS[k]:g})"
                        for k, v in me.items())
            + f"; every output bit-identical: {same}; plain version "
            f"{plain_ms:.1f} ms")
        if resets == 0:
            raise AssertionError(f"{mode}: no env crossed the time limit")
        for k, v in me.items():
            if not v <= BARS[k]:
                raise AssertionError(f"{mode}: {k} error {v} over "
                                     f"{BARS[k]}")
        res[mode] = dict(errs=me, plain_ms=plain_ms, resets=resets)
        if fn.steps == K:
            res[mode]["ms"] = time_kernel(fn, args)
            log(f"  kernel {res[mode]['ms']:.4f} ms per call on these "
                "inputs")
        if mode == "ctrl":
            fo = fma(*args)
            fma_ms = time_kernel(fma, args)
            log(f"  FMA-contracted build (not on the path): {fma_ms:.4f} ms "
                f"per call against {res[mode]['ms']:.4f}; drift from the "
                "plain version: "
                + ", ".join(f"{k} {v:.3e}"
                            for k, v in max_errors(fo, po, False).items()))
    return res


def main_path_phase(benv, rolls):
    """FastRollout rows at full size; launches counted around the run."""
    rows = {}
    for name, roll in rolls.items():
        gen = torch.Generator(device="cuda").manual_seed(1)
        state = roll.init(gen)
        roll.kernel.launches = 0
        state, traj = roll.run(state, gen)  # warm-up
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        rew = torch.zeros(B, device="cuda")
        ndiv = torch.zeros(B, device="cuda")
        for _ in range(N_TIMED):
            state, traj = roll.run(state, gen)
            rew += traj.reward_sum
            ndiv += traj.diverged
        end.record()
        torch.cuda.synchronize()
        launches = roll.kernel.launches
        ms = start.elapsed_time(end) / N_TIMED
        if launches != N_TIMED + 1:
            raise AssertionError(f"{name}: {launches} kernel launches, "
                                 f"want {N_TIMED + 1}")
        if not bool(torch.isfinite(rew).all()):
            raise AssertionError(f"{name}: non-finite reward sums")
        for t in state:
            if not bool(torch.isfinite(t).all()):
                raise AssertionError(f"{name}: non-finite state")
        if roll.collect:
            if (tuple(traj.obs.shape) != (K, roll.n_obs, B)
                    or tuple(traj.ctrls.shape)
                    != (K, roll.kernel.spec.nu, B)):
                raise AssertionError(f"{name}: trajectory shapes")
            if not bool(torch.isfinite(traj.obs).all()):
                raise AssertionError(f"{name}: non-finite observations")
        rate = B * K / (ms * 1e-3)
        rows[name] = dict(launches=launches, rate=rate)
        log(f"main path {name}: {rate:.6e} env-steps/s ({ms:.4f} ms per "
            f"call of {B}x{K}), {launches} launches, "
            f"{int(ndiv.sum())} divergences, mean reward "
            f"{float(rew.mean()) / (N_TIMED * K):.4f}")
    return rows


def bound(fn, built, resets):
    """Least time of one call on this card: the larger of the lane-op,
    special-function and byte times for this call's work."""
    s, b, k = fn.spec, fn.batch, fn.steps
    env_steps = b * k
    ops = env_steps * (built.step_ops + built.env_ops)
    sfu = env_steps * built.step_sfu_ops
    if fn.policy is not None:
        d = fn.dims
        macs = sum(d[i] * d[i + 1] for i in range(len(d) - 1))
        units = sum(d[1:])
        ops += env_steps * (2 * macs + 2 * units)
        sfu += env_steps * units  # tanh
    # each reset draws n_draws Philox values (~100 integer ops per 4) and
    # nq + nv Box-Muller normals
    ops += resets * (built.reset_ops + 25 * s.n_draws + 8 * (s.nq + s.nv))
    sfu += resets * 3 * (s.nq + s.nv)
    nbytes = 4 * b * (2 * (s.nq + 2 * s.nv + fn.na_rows + 1) + 2)
    if fn.policy is None:
        nbytes += 4 * k * s.nu * b
    else:
        nbytes += 4 * sum(t.numel() for t in fn.policy.kernel_params())
    if fn.emit_obs:
        nbytes += 4 * k * b * (s.n_obs + 2 + (s.nu if fn.policy else 0))
    t_ops, t_sfu, t_bytes = (ops / LANE_OPS_PER_S, sfu / SFU_OPS_PER_S,
                             nbytes / BYTES_PER_S)
    by = "operations" if max(t_ops, t_sfu) >= t_bytes else "bytes"
    return 1e3 * max(t_ops, t_sfu, t_bytes), by, dict(
        lane_ops=ops, sfu_ops=sfu, bytes=nbytes, resets=resets)


def main():
    name, smi = device_phase()
    benv = suite.load_batched("cheetah", "run", B)
    model = benv.model
    gen = torch.Generator(device="cuda").manual_seed(0)
    hooks = benv.task.kernel_hooks(model)
    policy = MLPPolicy(hooks.n_obs, model.nu, hidden=(64, 64), generator=gen)
    explorer = MLPPolicy(hooks.n_obs, model.nu, hidden=(64, 64),
                         explore_sigma=0.3, generator=gen)
    gauss = dataclasses.replace(hooks, reset_qpos_sigma=[0.0] * 3 + [0.05] * 6,
                                reset_qvel_sigma=0.1)
    rolls = {row: FastRollout(benv, K, policy=policy if mode == "policy"
                              else None, collect=mode == "policy")
             for row, mode in ROWS}
    fns = {
        "ctrl": rolls["cheetah-run@4096"].kernel,
        "policy": rolls["run-policy-obs@4096"].kernel,
        "explore": mk.build_rollout(model, B, K_OPTION, hooks, emit_obs=True,
                                    policy=explorer),
        "gaussian_reset": mk.build_rollout(model, B, K_OPTION, gauss,
                                           emit_obs=True),
    }
    fma = mk.build_rollout(model, B, K, hooks, fmad=True)

    built = build_phase({**fns, "fmad": fma})
    philox_phase()
    par = parity_phase(benv, fns, fma)
    rows = main_path_phase(benv, rolls)

    kernels = []
    for row, mode in ROWS:
        fn, p = fns[mode], par[mode]
        b_ms, by, work = bound(fn, built, p["resets"])
        kernels.append(dict(
            name=f"rollout[{row}]", route="cuda",
            source="oxide_control_torch/ops/csrc/rollout.cu",
            replaces=mk.REPLACES, launches=rows[row]["launches"],
            max_abs_err=max(p["errs"].values()), ms=p["ms"],
            plain_ms=p["plain_ms"], bound_ms=b_ms, bound_by=by,
            library_ms=None, env_steps_per_s=rows[row]["rate"],
            registers=built.registers, spill_stores=built.spill_stores,
            spill_loads=built.spill_loads, build_s=built.seconds, work=work,
        ))
        log(f"kernel {row}: {p['ms']:.4f} ms per call, bound {b_ms:.4f} ms "
            f"({by}), plain version {p['plain_ms']:.1f} ms per call, "
            f"{work}")
    log(f"card: {smi}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
