"""PyTorch port: cheetah-run through FastRollout's plain version, and the
env layer's invariants (ROADMAP Queue C).

* cheetah-run with the (64, 64) policy, K = 4, no resets: against the
  reference scalar-graph step + ``Run.kernel_hooks`` + ``MLPPolicy.apply``;
* the masked reset (root pose kept, legs within the 0.1 noise, velocity,
  warmstart and time zeroed), the integer step counter, the masked reward
  and divergence count of a diverged env, the exploration noise;
* Philox4x32-10 against the Random123 known-answer vectors and a plain
  Python-int implementation; the Box-Muller clamp at the extreme bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oxide_control_tpu.ops import scalar_graph as rsg
from oxide_control_tpu.policy import MLPPolicy as RefMLPPolicy
from oxide_control_tpu.suite import cheetah as ref_cheetah
from oxide_control_tpu.suite.common import load_asset as ref_load_asset

from oxide_control_torch import convert, suite
from oxide_control_torch.ops import megakernel as mk
from oxide_control_torch.parallel.rollout import FastRollout

B = 8
SEED = torch.zeros(1, dtype=torch.int32)


@pytest.fixture(scope="module")
def benv():
    return suite.load_batched("cheetah", "run", B, device="cpu")


def _cheetah_state(model, rng):
    qpos = np.tile(np.asarray(model.qpos0, np.float32)[:, None], (1, B))
    qpos[3:] += rng.uniform(-0.1, 0.1, (model.nq - 3, B))
    qvel = rng.uniform(-0.5, 0.5, (model.nv, B))
    return tuple(a.astype(np.float32) for a in (
        qpos, qvel, np.zeros((1, B)), np.zeros((model.nv, B)),
        np.zeros((1, B))))


def test_cheetah_policy_rollout_matches_reference(benv):
    k_steps = 4
    model = benv.model
    mr = ref_load_asset("cheetah", np.float32)
    hooks_r = ref_cheetah.Run(mr).kernel_hooks(mr)
    rpol = RefMLPPolicy(hidden=(64, 64))
    params = rpol.init_params(jax.random.PRNGKey(3), hooks_r.n_obs, mr.nu,
                              dtype=jnp.float32)
    state = _cheetah_state(model, np.random.default_rng(0))

    step = rsg.build_step(mr)
    q = [jnp.asarray(x) for x in state[0]]
    v = [jnp.asarray(x) for x in state[1]]
    w = [jnp.asarray(x) for x in state[3]]
    obs_r, ctrl_r, rew_r = [], [], []
    for _ in range(k_steps):
        obs = jnp.stack(hooks_r.observe(q, v))                  # (n_obs, B)
        ctrl = rpol.apply(params, obs.T).T                      # (nu, B)
        q, v, _, w = step(q, v, [], w, list(ctrl))
        obs_r.append(obs)
        ctrl_r.append(ctrl)
        rew_r.append(hooks_r.reward(q, v, list(ctrl)))

    pol = convert.policy_params_from_numpy(
        [(np.asarray(a), np.asarray(b)) for a, b in params], "cpu")
    roll = FastRollout(benv, k_steps, policy=pol, collect=True)
    out = roll.kernel(*convert.state_from_numpy(state, "cpu"), None, SEED,
                      pol.kernel_params())
    assert float(out[9].sum()) == 0.0  # no resets in the window
    np.testing.assert_allclose(out[10].numpy(), np.stack(ctrl_r), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(out[7].numpy(), np.stack(obs_r), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(out[8].numpy(), np.stack(rew_r), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(out[0].numpy(), np.stack(q), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(out[1].numpy(), np.stack(v), rtol=0,
                               atol=1e-3)


def test_fast_rollout_runs_on_cpu(benv):
    gen = torch.Generator().manual_seed(0)
    roll = FastRollout(benv, 3)
    state = roll.init(gen)
    assert [tuple(t.shape) for t in state] == [
        (9, B), (9, B), (1, B), (9, B), (1, B)]
    state, traj = roll.run(state, gen)
    assert tuple(traj.reward_sum.shape) == (B,)
    assert bool(torch.isfinite(traj.reward_sum).all())
    np.testing.assert_allclose(state[4].numpy(), 0.03, rtol=1e-6)
    assert roll.kernel.launches == 0  # the plain version launches nothing


def test_reset_path(benv):
    """Envs one step before the time limit all reset: root coordinates
    back to qpos0, the legs within +-0.1 of it, qvel/warmstart/time 0."""
    model = benv.model
    fn = mk.build_rollout(model, B, 1, benv.task.kernel_hooks(model))
    state = list(convert.state_from_numpy(
        _cheetah_state(model, np.random.default_rng(1)), "cpu"))
    state[4] = torch.full((1, B), (fn.spec.limit_n - 1) * fn.spec.h,
                          dtype=torch.float32)
    out = fn(*state, torch.zeros((1, model.nu, B)), torch.tensor(
        [1234], dtype=torch.int32))
    qpos0 = np.asarray(model.qpos0, np.float32)[:, None]
    q = out[0].numpy()
    np.testing.assert_array_equal(q[:3], np.broadcast_to(qpos0[:3], (3, B)))
    assert np.all(np.abs(q[3:] - qpos0[3:]) <= 0.1 + 1e-7)
    assert np.std(q[3:]) > 0.01  # the noise is drawn, not zero
    for t in (out[1], out[3], out[4]):
        assert float(t.abs().max()) == 0.0


def test_integer_step_counter(benv):
    """Done exactly at limit_n steps, from a start time many steps into the
    episode; the returned time is n * h with n counted exactly."""
    model = benv.model
    k_steps = 5
    fn = mk.build_rollout(model, B, k_steps, benv.task.kernel_hooks(model),
                          emit_obs=True)
    state = list(convert.state_from_numpy(
        _cheetah_state(model, np.random.default_rng(2)), "cpu"))
    n0 = fn.spec.limit_n - 3
    state[4] = torch.full((1, B), np.float32(n0) * np.float32(fn.spec.h))
    out = fn(*state, torch.zeros((k_steps, model.nu, B)), SEED)
    dones = out[9].numpy()
    np.testing.assert_array_equal(dones[:, 0], [0, 0, 1, 0, 0])
    np.testing.assert_array_equal(
        out[4].numpy(), np.float32(2) * np.float32(fn.spec.h))


@pytest.mark.parametrize("value", [float("nan"), 1e11])
def test_divergence_masks_reward_and_counts(benv, value):
    model = benv.model
    fn = mk.build_rollout(model, B, 2, benv.task.kernel_hooks(model),
                          emit_obs=True)
    state = list(convert.state_from_numpy(
        _cheetah_state(model, np.random.default_rng(3)), "cpu"))
    state[1] = state[1].clone()
    state[1][0, 0] = value  # env 0 diverges in its first step
    out = fn(*state, torch.zeros((2, model.nu, B)), SEED)
    assert float(out[9][0, 0]) == 1.0       # done
    assert float(out[8][0, 0]) == 0.0       # reward masked
    assert float(out[6][0, 0]) == 1.0       # one divergence
    assert float(out[6][0, 1:].sum()) == 0.0
    assert bool(torch.isfinite(out[5]).all())
    for t in out[:5]:
        assert bool(torch.isfinite(t).all())


def _philox_int(ctr, key):
    """Philox4x32-10 in plain Python ints (Random123 reference form)."""
    m = 0xFFFFFFFF
    c, k = list(ctr), list(key)
    for _ in range(10):
        p0 = 0xD2511F53 * c[0]
        p1 = 0xCD9E8D57 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k[0], p1 & m, (p0 >> 32) ^ c[3] ^ k[1],
             p0 & m]
        k = [(k[0] + 0x9E3779B9) & m, (k[1] + 0xBB67AE85) & m]
    return c


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF),
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
])
def test_philox_known_answers(ctr, key, want):
    got = mk.philox4x32(tuple(torch.tensor([c]) for c in ctr), key)
    assert tuple(int(x) for x in got) == want
    assert tuple(_philox_int(ctr, key)) == want


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_philox_matches_python_ints(seed):
    rng = np.random.default_rng(seed)
    ctr = rng.integers(0, 2 ** 32, (4, 64), dtype=np.uint64).astype(np.int64)
    key = [int(x) for x in rng.integers(0, 2 ** 32, 2, dtype=np.uint64)]
    got = mk.philox4x32(tuple(torch.from_numpy(c) for c in ctr), key)
    got = np.stack([g.numpy() for g in got])
    want = np.array([_philox_int([int(c[i]) for c in ctr], key)
                     for i in range(64)]).T
    np.testing.assert_array_equal(got, want)


def test_philox_bits_layout():
    """Value j of an env's draw is lane j % 4 of the Philox block with
    counter (env, step, j // 4, 0) under key (seed, salt)."""
    env = torch.tensor([0, 5, 2 ** 20])
    got = mk.philox_bits(77, mk.SALT_RESET, 3, 10, env).numpy()
    for col, e in enumerate(env.tolist()):
        want = [_philox_int((e, 3, j // 4, 0), (77, mk.SALT_RESET))[j % 4]
                for j in range(10)]
        np.testing.assert_array_equal(got[:, col], want)


def test_box_muller_clamp_is_finite():
    """bits 0x7FFFFFFF map to exactly 1.0 in f32, so 1 - s = 0: the clamp
    keeps log(u1) finite."""
    bits = torch.tensor([0x7FFFFFFF, 0x80000000, 0, 0xFFFFFFFF])
    s = mk.signed_unit(bits, torch.float32)
    assert float(s[0]) == 1.0 and float(s[1]) == -1.0
    z = mk.box_muller(s, s.flip(0))
    assert bool(torch.isfinite(z).all())


def test_exploration_noise(benv):
    """explore_sigma adds N(0, sigma^2) Philox noise to the policy's ctrl:
    same weights, same seed, the difference has the right spread."""
    from oxide_control_torch.policy import MLPPolicy

    gen = torch.Generator().manual_seed(4)
    base = MLPPolicy(17, 6, generator=gen, device="cpu")
    noisy = MLPPolicy(17, 6, explore_sigma=0.5, device="cpu")
    noisy.load_state_dict(base.state_dict())
    state = convert.state_from_numpy(
        _cheetah_state(benv.model, np.random.default_rng(5)), "cpu")
    outs = []
    for pol in (base, noisy):
        fn = mk.build_rollout(benv.model, B, 1,
                              benv.task.kernel_hooks(benv.model),
                              emit_obs=True, policy=pol)
        outs.append(fn(*state, None, SEED, pol.kernel_params())[10])
    noise = (outs[1] - outs[0]).numpy()
    assert np.all(np.isfinite(noise)) and np.all(noise != 0.0)
    assert 0.25 < float(noise.std()) < 0.75


def test_gaussian_reset_noise(benv):
    """reset_qpos_sigma / reset_qvel_sigma draw Box-Muller normals from
    the Philox stream: finite, with about the requested spread."""
    import dataclasses

    model = benv.model
    hooks = dataclasses.replace(benv.task.kernel_hooks(model),
                                reset_noise=0.0,
                                reset_qpos_sigma=[0.0] * 3 + [0.05] * 6,
                                reset_qvel_sigma=0.2)
    n = 256
    fn = mk.build_rollout(model, n, 1, hooks)
    state = [torch.zeros((model.nq, n)), torch.zeros((model.nv, n)),
             torch.zeros((1, n)), torch.zeros((model.nv, n)),
             torch.full((1, n), (fn.spec.limit_n - 1) * fn.spec.h)]
    out = fn(*state, torch.zeros((1, model.nu, n)),
             torch.tensor([99], dtype=torch.int32))
    q, v = out[0].numpy(), out[1].numpy()
    assert np.all(np.isfinite(q)) and np.all(np.isfinite(v))
    np.testing.assert_array_equal(q[:3], 0.0)
    assert 0.04 < float(q[3:].std()) < 0.06
    assert 0.17 < float(v.std()) < 0.23
