"""The least time of a rollout's work on one H100, from frozen counts.

The peaks are those of one NVIDIA H100 SXM (NVIDIA's data sheet, at its
700 W limit): 132 SMs of 128 FP32 lanes at a 1.98 GHz boost clock issue
33.5e12 lane-ops/s, their 16 special-function units per SM 4.18e12 ops/s,
and HBM3 moves 3.35e12 bytes/s.

The work of an env-step is the configuration file's ``work`` block: the
lane-ops and special-function ops of the one-lane (G = 1) physics step
and of the env layer (observation and reward), the ops of one masked
reset, as the emitter counted them when the benchmark was made (see the
block's ``how``).  The policy's and the random draws' ops, and every
byte, follow from the shapes here.  Nothing is read from the program, so
the yardstick stays put whatever computes the step.
"""

from __future__ import annotations

LANE_OPS_PER_S = 33.5e12
SFU_OPS_PER_S = 132 * 16 * 1.98e9
BYTES_PER_S = 3.35e12
F32 = 4


def mlp_ops(dims):
    """(lane-ops, special-function ops) of one tanh MLP evaluation: a
    multiply and an add per weight, a bias add and a tanh per unit."""
    macs = sum(dims[i] * dims[i + 1] for i in range(len(dims) - 1))
    units = sum(dims[1:])
    return 2 * macs + 2 * units, units


def call_work(config: dict, traffic: dict, batch: int, steps: int,
              resets: float) -> dict:
    """Lane-ops, special-function ops and bytes of one rollout call of
    ``batch`` envs and ``steps`` steps with ``resets`` env resets."""
    w = config["work"]
    nq, nv, nu, n_obs = (config[k] for k in ("nq", "nv", "nu", "n_obs"))
    na_rows = max(config["na"], 1)
    env_steps = batch * steps
    ops = env_steps * (w["step_lane_ops"] + w["env_lane_ops"])
    sfu = env_steps * w["step_sfu_ops"]
    pol = traffic["policy"]
    if pol is not None:
        dims = [n_obs, *pol["hidden"], nu]
        m_ops, m_sfu = mlp_ops(dims)
        ops += env_steps * m_ops
        sfu += env_steps * m_sfu
        if pol["explore_sigma"] > 0:
            # 2 nu Philox values (~100 integer ops per 4), nu Box-Muller
            # normals (8 ops and 3 special-function ops each)
            ops += env_steps * (25 * 2 * nu + 8 * nu)
            sfu += env_steps * 3 * nu
    n_draws = nq + 2 * (nq + nv)
    ops += resets * (w["reset_lane_ops"] + 25 * n_draws + 8 * (nq + nv))
    sfu += resets * 3 * (nq + nv)
    # the state in and out, the reward sum and divergence count out
    nbytes = F32 * batch * (2 * (nq + 2 * nv + na_rows + 1) + 2)
    if pol is None:
        nbytes += F32 * steps * nu * batch                 # ctrl in
    else:
        dims = [n_obs, *pol["hidden"], nu]
        nbytes += F32 * sum(dims[i] * dims[i + 1] + dims[i + 1]
                            for i in range(len(dims) - 1))
    if traffic.get("collect"):
        nbytes += F32 * steps * batch * (n_obs + 2 + (nu if pol else 0))
    return {"lane_ops": ops, "sfu_ops": sfu, "bytes": nbytes}


def least_time(work: dict):
    """(seconds, the bound: ``lane_ops``, ``sfu_ops`` or ``bytes``)."""
    times = {"lane_ops": work["lane_ops"] / LANE_OPS_PER_S,
             "sfu_ops": work["sfu_ops"] / SFU_OPS_PER_S,
             "bytes": work["bytes"] / BYTES_PER_S}
    by = max(times, key=times.get)
    return times[by], by
