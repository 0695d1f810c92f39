"""PyTorch port: env-axis sharding over ``torch.distributed``.

The analog of the reference's ``tests/test_sharding.py`` (an 8-device
virtual mesh) with one process per rank: a gloo world of two spawned CPU
processes, spawned once for the file (``torch_sharding_worker.py``), whose
shards are held against the unsharded port and the reference:

* one cartpole step on 16 f64 envs: the shards equal the unsharded step
  bit for bit, and the unsharded step the reference's ``benv.step``
  within 1e-12;
* ``rollout`` on pendulum-swingup, 16 f64 envs, 5 steps, a deterministic
  policy: the all-reduced mean return equals the unsharded one and the
  reference's within 1e-12, the shards' rewards and states the
  unsharded ones bit for bit;
* the hop model through ``FastRollout(mesh=)`` (B = 16, K = 6, no reset
  noise): ``init`` and one kernel call on the same ctrl equal the
  unsharded columns bit for bit (the kernel's plain version on the CPU);
  its all-reduced mean; a policy's weights broadcast from rank 0; the
  fourbar's ``run`` with the whole batch's ``eq_active`` rows equals its
  kernel on the rank's rows and the rank's own ctrl and seed stream;
* ``multitask_rollout`` with two tasks over the two ranks, and over a
  world of one in this process (round-robin, with the reference's
  warning), each task equal to its solo ``jit_rollout``; a second call
  with the same envs makes no process group and equals the solo runs
  from its own generator.

The reference's interpret-mode build of the hop kernel is left out: its
compile alone would take most of the file's time budget.  In-process:
``shard_env_state``, ``env_sharding``, ``submesh``,
``partition_devices``, ``fold_in``, ``multihost_initialize`` and
``dryrun_multichip``'s refusal to run without a card unless asked for
the CPU.
"""

import multiprocessing

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_sharding_worker as w
from oxide_control_tpu import suite as rsuite
from oxide_control_tpu.parallel.rollout import rollout as ref_rollout
from oxide_control_tpu.state import make_data as ref_make_data

from oxide_control_torch import suite
from oxide_control_torch.parallel import dryrun
from oxide_control_torch.parallel import mesh as pmesh
from oxide_control_torch.parallel.multitask import (
    multitask_rollout,
    partition_devices,
    task_generators,
)
from oxide_control_torch.parallel.rollout import (
    FastRollout,
    jit_rollout,
    rollout,
)

REF_BAR = 1e-12


class Ranks:
    """The spawned world: started at once, joined at the first ``get``
    (so the first test computes its reference while the ranks run)."""

    def __init__(self, tmp):
        self.tmp = tmp
        ctx = multiprocessing.get_context("spawn")
        self.procs = [ctx.Process(target=w.run, args=(r, str(tmp / "store"),
                                                      str(tmp)))
                      for r in range(w.WORLD)]
        for p in self.procs:
            p.start()
        self.results = None

    def get(self):
        if self.results is None:
            for p in self.procs:
                p.join(120)
            codes = [p.exitcode for p in self.procs]
            assert codes == [0] * w.WORLD, codes
            self.results = [torch.load(self.tmp / f"rank{r}.pt",
                                       weights_only=False)
                            for r in range(w.WORLD)]
        return self.results

    def close(self):
        for p in self.procs:
            if p.is_alive():
                p.kill()
            p.join()


@pytest.fixture(scope="module")
def world_of_two(tmp_path_factory):
    ranks = Ranks(tmp_path_factory.mktemp("mesh"))
    try:
        yield ranks
    finally:
        ranks.close()


def joined(ranks, check, key, dim=0):
    return torch.cat([r[check][key] for r in ranks], dim)


def ref_data(rm, qpos, qvel):
    """The reference's batch at (qpos, qvel), inside the caller's jit (the
    eager make_data compiles op by op)."""
    return jax.vmap(lambda q, v: ref_make_data(rm).replace(qpos=q, qvel=v))(
        qpos, qvel)


def test_world_of_two_starts(world_of_two):
    """Spawns the two ranks (they run while the in-process tests below
    and the first test's reference compile do)."""
    assert all(p.pid is not None for p in world_of_two.procs)
    assert all(p.exitcode in (None, 0) for p in world_of_two.procs)


@pytest.fixture
def world_of_one(tmp_path):
    """A gloo group of one rank in this process, taken down after."""
    assert not dist.is_initialized()
    pmesh.multihost_initialize(backend="gloo",
                               init_method=f"file://{tmp_path / 'store'}",
                               rank=0, world_size=1)
    try:
        yield tmp_path
    finally:
        dist.destroy_process_group()


def test_multihost_initialize_twice_is_a_no_op(world_of_one):
    group = dist.group.WORLD
    pmesh.multihost_initialize(backend="gloo", rank=0, world_size=1,
                               init_method=f"file://{world_of_one / 'b'}")
    assert dist.group.WORLD is group and dist.get_world_size() == 1
    mesh = pmesh.make_env_mesh(device="cpu")
    assert (mesh.rank, mesh.world_size, mesh.device) == (
        0, 1, torch.device("cpu"))


def test_submesh_of_the_whole_world_is_the_default_group(world_of_one):
    mesh = pmesh.submesh([0], device="cpu")
    assert (mesh.rank, mesh.world_size, mesh.group) == (0, 1, None)
    with pytest.raises(ValueError, match="n_devices"):
        pmesh.make_env_mesh(2, device="cpu")


def test_dryrun_needs_a_card_unless_asked_for_the_cpu():
    assert not dist.is_initialized()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dryrun.dryrun_multichip(2)
    with pytest.raises(ValueError, match="'cpu'"):
        dryrun.dryrun_multichip(2, device="meta")
    assert not dist.is_initialized()


def test_multitask_over_one_rank(world_of_one):
    benvs = w.task_envs()
    mesh = pmesh.make_env_mesh(device="cpu")
    with pytest.warns(UserWarning, match="round-robin"):
        got = multitask_rollout(benvs, torch.Generator().manual_seed(8),
                                w.ROLLOUT_STEPS, mesh=mesh)
    for (data, ret), (sdata, sret) in zip(
            got, solo_runs(benvs, 8, w.ROLLOUT_STEPS)):
        assert torch.equal(data.qpos, sdata.qpos)
        assert abs(ret - sret) < REF_BAR


@pytest.mark.parametrize("kw", [dict(rank=2, world_size=2),
                                dict(rank=-1, world_size=2),
                                dict(rank=0, world_size=0)])
def test_multihost_initialize_rejects_bad_ranks(kw, tmp_path):
    assert not dist.is_initialized()
    with pytest.raises(ValueError):
        pmesh.multihost_initialize(
            backend="gloo", init_method=f"file://{tmp_path / 's'}", **kw)
    assert not dist.is_initialized()


def test_make_env_mesh_needs_a_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="multihost_initialize"):
        pmesh.make_env_mesh(device="cpu")


def test_shards_cover_the_batch():
    benv = suite.load_batched("cheetah", "run", 12, device="cpu")
    data = benv.reset(torch.Generator().manual_seed(0))
    shards = [pmesh.shard_env_state(
        pmesh.EnvMesh(rank=r, world_size=4, group=None,
                      device=torch.device("cpu")), data) for r in range(4)]
    assert [s.qpos.shape[0] for s in shards] == [3] * 4
    for f in ("qpos", "qvel", "time", "xpos", "qM"):
        assert torch.equal(torch.cat([getattr(s, f) for s in shards]),
                           getattr(data, f)), f
    mesh = pmesh.EnvMesh(rank=0, world_size=5, group=None,
                         device=torch.device("cpu"))
    with pytest.raises(ValueError, match="does not divide"):
        pmesh.env_sharding(mesh, 12)
    assert pmesh.replicated(mesh, data) is data


def test_partition_devices():
    assert partition_devices(2, 8) == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert partition_devices(3, 8) == [[0, 1], [2, 3], [4, 5]]
    with pytest.warns(UserWarning, match="round-robin"):
        assert partition_devices(3, 2) == [[0], [1], [0]]


def test_fold_in_streams():
    draws = {}
    for index in (0, 1):
        g = torch.Generator().manual_seed(5)
        a = pmesh.fold_in(g, index)
        # the caller's generator advanced by one draw, whatever the index
        ref = torch.Generator().manual_seed(5)
        pmesh.draw_seed(ref)
        assert torch.equal(g.get_state(), ref.get_state())
        draws[index] = torch.rand(4, generator=a)
        again = pmesh.fold_in(torch.Generator().manual_seed(5), index)
        assert torch.equal(torch.rand(4, generator=again), draws[index])
    assert not torch.equal(draws[0], draws[1])


def unsharded_cartpole_step():
    qpos, qvel, actions = w.cartpole_inputs()
    benv = suite.load_batched("cartpole", "swingup", w.B, dtype=np.float64,
                              device="cpu")
    data, ts = benv.step(w.port_data(benv.model, qpos, qvel),
                         torch.from_numpy(actions),
                         torch.Generator().manual_seed(1))
    assert not bool(ts.done.any())
    return dict(qpos=data.qpos, qvel=data.qvel, obs=ts.observation,
                reward=ts.reward)


def test_cartpole_step_matches_reference():
    qpos, qvel, actions = w.cartpole_inputs()
    rbenv = rsuite.load_batched("cartpole", "swingup", w.B,
                                dtype=np.float64)
    rd, rts = jax.jit(lambda q, v, a, k: rbenv.step(
        ref_data(rbenv.model, q, v), a, k))(qpos, qvel, actions,
                                            jax.random.PRNGKey(1))
    ref = dict(qpos=rd.qpos, qvel=rd.qvel, obs=rts.observation,
               reward=rts.reward)
    for k, x in unsharded_cartpole_step().items():
        assert np.abs(np.asarray(ref[k]) - x.numpy()).max() < REF_BAR, k


def test_sharded_cartpole_step(world_of_two):
    ranks = world_of_two.get()
    for k, x in unsharded_cartpole_step().items():
        assert torch.equal(joined(ranks, "cartpole", k), x), k


def test_sharded_rollout_mean_return(world_of_two):
    qpos, qvel, wt = w.pendulum_inputs()
    benv = suite.load_batched("pendulum", "swingup", w.B, dtype=np.float64,
                              device="cpu")
    data, (rew, _), ret = rollout(
        benv, w.port_data(benv.model, qpos, qvel),
        torch.Generator().manual_seed(2), w.ROLLOUT_STEPS,
        policy=w.tanh_policy(wt))
    rbenv = rsuite.load_batched("pendulum", "swingup", w.B,
                                dtype=np.float64)
    _, _, rret = jax.jit(lambda q, v, k: ref_rollout(
        rbenv, ref_data(rbenv.model, q, v), k, w.ROLLOUT_STEPS,
        policy=lambda key, obs: jnp.tanh(obs @ jnp.asarray(wt))))(
        qpos, qvel, jax.random.PRNGKey(2))
    ranks = world_of_two.get()
    for r in ranks:
        got = float(r["pendulum"]["mean_return"])
        assert got == float(ranks[0]["pendulum"]["mean_return"])
        assert abs(got - float(ret)) < REF_BAR
        assert abs(got - float(rret)) < REF_BAR
    assert torch.equal(joined(ranks, "pendulum", "rewards", 1), rew)
    assert torch.equal(joined(ranks, "pendulum", "qpos"), data.qpos)


def test_sharded_hop_kernel_equals_unsharded(world_of_two):
    ranks = world_of_two.get()
    roll = FastRollout(w.hop_env(), w.HOP_K)
    state = roll.init(torch.Generator().manual_seed(3))
    out = roll.kernel(*state, torch.from_numpy(w.hop_ctrl()),
                      torch.zeros(1, dtype=torch.int32))
    for i, x in enumerate(state):
        assert torch.equal(torch.cat([r["hop"]["init"][i] for r in ranks],
                                     1), x), i
    for i, x in enumerate(out):
        assert torch.equal(torch.cat([r["hop"]["out"][i] for r in ranks],
                                     -1), x), i
    sums = [r["hop"]["reward_sum"].sum() for r in ranks]
    assert torch.isfinite(joined(ranks, "hop", "reward_sum")).all()
    for r in ranks:
        assert torch.equal(r["hop"]["mean_return"],
                           (sums[0] + sums[1]) / w.B)


def test_fastrollout_mesh_run_cuts_per_env_inputs(world_of_two):
    ranks = world_of_two.get()
    assert all(r["fourbar"]["same"] for r in ranks)
    # the shards' reset is the unsharded reset; the calls differ (each
    # rank draws its own stream) but both ran
    roll = FastRollout(w.fourbar_env(), 4)
    state = roll.init(torch.Generator().manual_seed(8))
    assert torch.equal(joined(ranks, "fourbar", "init", 1), state[0])
    assert torch.isfinite(joined(ranks, "fourbar", "reward_sum")).all()


def test_policy_weights_broadcast_from_rank_0(world_of_two):
    ranks = world_of_two.get()
    p0, p1 = (r["policy"] for r in ranks)
    assert not torch.equal(p0["before"], p1["before"])
    assert torch.equal(p0["after"], p0["before"])
    assert torch.equal(p1["after"], p0["before"])


def solo_runs(benvs, seed, steps):
    """Each task's reset and jit_rollout alone, from the task generators
    ``multitask_rollout`` derives from a generator seeded ``seed``."""
    out = []
    for benv, gen in zip(benvs, task_generators(
            torch.Generator().manual_seed(seed), len(benvs))):
        data = benv.reset(gen)
        data, _, ret = jit_rollout(benv, steps)(data, gen)
        out.append((data, float(ret)))
    return out


def test_multitask_over_two_ranks(world_of_two):
    ranks = world_of_two.get()
    solo = solo_runs(w.task_envs(), 7, w.ROLLOUT_STEPS)
    for rank, r in enumerate(ranks):
        for task, ((data, ret), (sdata, sret)) in enumerate(
                zip(r["multitask"], solo)):
            assert abs(ret - sret) < REF_BAR
            if task == rank:
                assert torch.equal(data.qpos, sdata.qpos)
                assert torch.equal(data.qvel, sdata.qvel)
            else:
                assert data is None


def test_multitask_keeps_its_groups(world_of_two):
    ranks = world_of_two.get()
    solo = solo_runs(w.task_envs(), 11, w.ROLLOUT_STEPS)
    for rank, r in enumerate(ranks):
        # the first call makes the two one-rank groups, the second none
        assert r["multitask_groups_made"] == (2, 0)
        (data, ret), (sdata, sret) = r["multitask_again"][rank], solo[rank]
        assert torch.equal(data.qpos, sdata.qpos)
        assert abs(r["multitask_again"][1 - rank][1] - solo[1 - rank][1]) \
            < REF_BAR
        assert abs(ret - sret) < REF_BAR
