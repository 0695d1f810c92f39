"""The ranks of ``test_torch_sharding.py``'s spawned gloo world, and the
inputs both sides build from numpy seeds.

Each rank brings the group up through ``parallel.mesh`` on a ``file://``
store, runs its shard of every check on the CPU and saves what it got
(``rank<r>.pt``) for the test to hold against the unsharded port and the
reference.  Nothing here imports JAX.
"""

import math

import numpy as np
import torch
import torch.distributed as dist

from oxide_control_torch import bench_configs, suite
from oxide_control_torch.parallel import dryrun
from oxide_control_torch.parallel.mesh import (
    fold_in,
    make_env_mesh,
    multihost_initialize,
    shard_env_state,
)
from oxide_control_torch.parallel.multitask import multitask_rollout
from oxide_control_torch.parallel.rollout import (
    FastRollout,
    ShardedEnvironment,
    rollout,
)
from oxide_control_torch.policy import MLPPolicy
from oxide_control_torch.state import make_data

WORLD = 2
B = 16
ROLLOUT_STEPS = 5
HOP_K = 6
TASK_B = 8

def fourbar_env(batch=B):
    """The bench's fourbar: a connect and a joint equality."""
    return bench_configs.load_config("fourbar", "equality", batch,
                                     device="cpu")


def fourbar_eq_active(benv):
    """(B, neq) rows: every equality on, the first off on odd envs."""
    eq = torch.ones((B, benv.model.neq))
    eq[1::2, 0] = 0.0
    return eq


def hop_env(batch=B):
    """The reference test's hop task (episodes of 0.15 s, no reset noise
    in the kernel), its episodes started at a height drawn in [-0.05,
    0.05] of the model's, so that the envs differ."""
    return dryrun.hop_env(batch, "cpu", time_limit=0.15, reset_noise=0.0,
                          init_noise=0.05)


def cartpole_inputs():
    """(qpos, qvel, actions) of B cartpole envs, f64: the slider near 0,
    the pole near upright-down pi, actions spread over [-1, 1]."""
    rng = np.random.default_rng(0)
    qpos = np.stack([0.1 * rng.uniform(-1, 1, B),
                     math.pi + 0.3 * rng.uniform(-1, 1, B)], -1)
    qvel = 0.5 * rng.uniform(-1, 1, (B, 2))
    return qpos, qvel, np.linspace(-1.0, 1.0, B)[:, None]


def pendulum_inputs():
    """(qpos, qvel, W): B pendulum states and the deterministic policy
    tanh(obs @ W)."""
    rng = np.random.default_rng(1)
    return (rng.uniform(-math.pi, math.pi, (B, 1)),
            rng.uniform(-1, 1, (B, 1)), rng.uniform(-1, 1, (3, 1)))


def hop_ctrl():
    return np.random.default_rng(2).uniform(
        -1, 1, (HOP_K, 1, B)).astype(np.float32)


def port_data(model, qpos, qvel):
    """The port's batch at (qpos, qvel), the rest at the reset state."""
    data = make_data(model, "cpu", torch.float64, batch=qpos.shape[0])
    return data.replace(qpos=torch.from_numpy(qpos),
                        qvel=torch.from_numpy(qvel))


def tanh_policy(w):
    w = torch.from_numpy(w)
    return lambda generator, obs: torch.tanh(obs @ w)


def task_envs():
    return [suite.load_batched("pendulum", "swingup", TASK_B,
                               dtype=np.float64, device="cpu"),
            suite.load_batched("cartpole", "balance", TASK_B,
                               dtype=np.float64, device="cpu")]


def run(rank, store, out):
    # one thread a rank: the shards are tiny, and the test process compiles
    # the reference beside them
    torch.set_num_threads(1)
    multihost_initialize(backend="gloo", init_method=f"file://{store}",
                         rank=rank, world_size=WORLD)
    try:
        torch.save(checks(make_env_mesh(device="cpu")),
                   f"{out}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def checks(mesh):
    res = {}
    gen = lambda s: torch.Generator().manual_seed(s)

    # one cartpole step of this rank's rows
    benv = suite.load_batched("cartpole", "swingup", B, dtype=np.float64,
                              device="cpu")
    qpos, qvel, actions = cartpole_inputs()
    local = ShardedEnvironment(benv, mesh)
    data = shard_env_state(mesh, port_data(benv.model, qpos, qvel))
    data, ts = local.step(data, torch.from_numpy(actions[local.lo:local.hi]),
                          gen(1))
    res["cartpole"] = dict(qpos=data.qpos, qvel=data.qvel,
                           obs=ts.observation, reward=ts.reward)

    # the pendulum rollout's all-reduced mean return
    benv = suite.load_batched("pendulum", "swingup", B, dtype=np.float64,
                              device="cpu")
    qpos, qvel, w = pendulum_inputs()
    data = shard_env_state(mesh, port_data(benv.model, qpos, qvel))
    data, (rew, _), ret = rollout(benv, data, gen(2), ROLLOUT_STEPS,
                                  policy=tanh_policy(w), mesh=mesh)
    res["pendulum"] = dict(qpos=data.qpos, rewards=rew, mean_return=ret)

    # the hop kernel (its plain version here): init, one call on the test's
    # ctrl, one run and its all-reduced mean
    roll = FastRollout(hop_env(), HOP_K, mesh=mesh)
    state = roll.init(gen(3))
    ctrl = torch.from_numpy(hop_ctrl()[:, :, roll.lo:roll.hi]).contiguous()
    out = roll.kernel(*state, ctrl, torch.zeros(1, dtype=torch.int32))
    _, traj = roll.run(state, gen(4))
    res["hop"] = dict(init=state, out=out, reward_sum=traj.reward_sum,
                      mean_return=roll.mean_return(traj))

    # a policy's weights reach every rank from rank 0
    benv = hop_env()
    pol = MLPPolicy(benv.model.nq + benv.model.nv, benv.model.nu, (4,),
                    generator=gen(10 + mesh.rank), device="cpu")
    before = torch.cat([p.detach().reshape(-1).clone()
                        for p in pol.parameters()])
    roll = FastRollout(benv, 2, policy=pol, mesh=mesh)
    roll.run(roll.init(gen(5)), gen(6))
    res["policy"] = dict(before=before, after=torch.cat(
        [p.detach().reshape(-1) for p in pol.parameters()]))

    # per-env inputs (eq_active rows of the whole batch) cut to the rank's
    # rows, and the rank's own ctrl and seed stream: run() against the
    # kernel called with what run() should have drawn
    benv = fourbar_env()
    roll = FastRollout(benv, 4, mesh=mesh)
    state = roll.init(gen(8))
    eq = fourbar_eq_active(benv)
    new, traj = roll.run(state, gen(9), eq_active=eq)
    g = fold_in(gen(9), mesh.rank)
    ctrl = torch.empty((4, benv.model.nu, roll.hi - roll.lo))
    ctrl.uniform_(-1.0, 1.0, generator=g)
    seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=g,
                         dtype=torch.int32)
    want = roll.kernel(*state, ctrl, seed, None,
                       eq[roll.lo:roll.hi].T.contiguous())
    res["fourbar"] = dict(same=all(torch.equal(a, b) for a, b in zip(
        new + (traj.reward_sum[None], traj.diverged[None]), want)),
        init=state[0], reward_sum=traj.reward_sum)

    # two tasks, one rank each, called twice with the same envs: the
    # second call makes no process group
    envs, made = task_envs(), []
    new_group = dist.new_group
    dist.new_group = lambda *a, **k: made.append(a) or new_group(*a, **k)
    try:
        res["multitask"] = multitask_rollout(envs, gen(7), ROLLOUT_STEPS,
                                             mesh=mesh)
        first = len(made)
        res["multitask_again"] = multitask_rollout(envs, gen(11),
                                                   ROLLOUT_STEPS, mesh=mesh)
    finally:
        dist.new_group = new_group
    res["multitask_groups_made"] = (first, len(made) - first)
    return res
