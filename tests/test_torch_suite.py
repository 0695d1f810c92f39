"""PyTorch port: the control suite's tasks against the reference's.

* ``rewards.tolerance`` with every sigmoid, bounds and margins;
* for the nine tasks beside cheetah: the port's ``observe`` and ``reward``
  hooks (the reward with ``fk`` from the port's ``build_fk``) against the
  reference's ``kernel_hooks`` and ``build_fk`` on the same q, v, ctrl;
* each task's reset spec against the reference's ``EnvHooks`` fields, and
  the torch ``init_episode`` moments against that spec (the bands of
  ``tests/test_megakernel.py::test_kernel_hooks_reset_distribution_parity``);
* the plain rollout of walker-walk with the (64, 64) policy and of
  cartpole-swingup with ctrl, against the reference step + hooks loop;
* the observe-hook kwargs invariant and the quaternion reset rule.

All in f64 except the rollouts (f32, at the reference kernel's bars).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oxide_control_tpu import suite as ref_suite
from oxide_control_tpu.ops import scalar_graph as rsg
from oxide_control_tpu.policy import MLPPolicy as RefMLPPolicy
from oxide_control_tpu.suite import rewards as ref_rewards

from oxide_control_torch import convert, suite
from oxide_control_torch.ops import megakernel as mk
from oxide_control_torch.ops import scalar_graph as sg
from oxide_control_torch.parallel.rollout import FastRollout
from oxide_control_torch.state import make_data
from oxide_control_torch.suite import rewards

B = 8
TASKS = [("pendulum", "swingup"), ("cartpole", "balance"),
         ("cartpole", "swingup"), ("walker", "stand"), ("walker", "walk"),
         ("walker", "run"), ("humanoid", "stand"), ("humanoid", "walk"),
         ("humanoid", "run")]
SIGMOIDS = ["gaussian", "hyperbolic", "long_tail", "reciprocal", "cosine",
            "linear", "quadratic", "tanh_squared"]


def _task_pair(domain, task, dtype=np.float64):
    """(port model, port task, reference model, reference task)."""
    m, t = suite._REGISTRY[(domain, task)](dtype=dtype)
    mr, tr = ref_suite._REGISTRY[(domain, task)](dtype=dtype)
    return m, t, mr, tr


@pytest.mark.parametrize("sigmoid", SIGMOIDS)
def test_tolerance_matches_reference(sigmoid):
    x = np.random.default_rng(0).uniform(-4.0, 4.0, 64)
    bk = sg.TorchBackend(x.size, torch.float64, "cpu")
    vam = 0.0 if sigmoid in ("linear", "quadratic", "cosine") else 0.3
    for bounds, margin in (((0.0, 0.0), 1.5), ((-0.5, 1.0), 2.0),
                           ((1.2, np.inf), 0.6), ((-np.inf, -1.0), 0.25),
                           ((-1.0, 1.0), 0.0)):
        kw = dict(bounds=bounds, margin=margin, sigmoid=sigmoid,
                  value_at_margin=vam)
        want = np.asarray(ref_rewards.tolerance(jnp.asarray(x), **kw))
        for got in (rewards.tolerance(bk, torch.tensor(x), **kw),
                    rewards.tolerance(None, torch.tensor(x), **kw)):
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=1e-12, err_msg=str(kw))


def _hook_inputs(m, seed):
    rng = np.random.default_rng(seed)
    q = np.tile(np.asarray(m.qpos0, np.float64), (B, 1)) + rng.uniform(
        -1.5, 1.5, (B, m.nq))
    if m.nq != m.nv:  # unit root quaternion, as the kernel state keeps it
        q[:, 3:7] /= np.linalg.norm(q[:, 3:7], axis=1, keepdims=True)
    v = rng.uniform(-3.0, 3.0, (B, m.nv))
    c = rng.uniform(-1.5, 1.5, (B, m.nu))
    return q, v, c


@pytest.mark.parametrize("domain,task", TASKS)
def test_hooks_match_reference(domain, task):
    m, t, mr, tr = _task_pair(domain, task)
    hooks, hooks_r = t.kernel_hooks(m), tr.kernel_hooks(mr)
    assert hooks.needs_fk == hooks_r.needs_fk
    assert hooks.n_obs == hooks_r.n_obs
    q, v, c = _hook_inputs(m, seed=len(task))
    bk = sg.TorchBackend(B, torch.float64, "cpu")
    T = lambda a: [torch.tensor(a[:, i]) for i in range(a.shape[1])]
    J = lambda a: [jnp.asarray(a[:, i]) for i in range(a.shape[1])]
    kw, kw_r = {}, {}
    if hooks.needs_fk:
        kw = dict(fk=sg.build_fk(m, bk)(T(q)))
        kw_r = dict(fk=rsg.build_fk(mr)(J(q)))
    got = bk.full(hooks.reward(bk, T(q), T(v), T(c), **kw))
    want = hooks_r.reward(J(q), J(v), J(c), **kw_r)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-12)
    assert float(got.std()) > 0.0  # the inputs reach the reward's slopes
    obs = [np.broadcast_to(bk.full(o).numpy(), (B,))
           for o in hooks.observe(bk, T(q), T(v))]
    obs_r = [np.broadcast_to(np.asarray(o), (B,))
             for o in hooks_r.observe(J(q), J(v))]
    np.testing.assert_allclose(np.stack(obs), np.stack(obs_r), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("domain,task", TASKS + [("cheetah", "run")])
def test_reset_spec_matches_reference(domain, task):
    """env_spec equals the reference EnvHooks' reset fields, and the torch
    init_episode draws sit within the reference test's bands around the
    spec's moments (N = 4000)."""
    m, t, mr, tr = _task_pair(domain, task)
    hooks, hooks_r = t.kernel_hooks(m), tr.kernel_hooks(mr)
    spec = mk.env_spec(m, hooks)
    nq = mr.nq
    target = np.asarray(hooks_r.reset_qpos0 if hooks_r.reset_qpos0
                        is not None else mr.qpos0, np.float64)
    mask = (np.ones(nq) if hooks_r.reset_mask is None
            else np.asarray(hooks_r.reset_mask))
    uamp = mask * hooks_r.reset_noise
    sig = (np.zeros(nq) if hooks_r.reset_qpos_sigma is None
           else np.asarray(hooks_r.reset_qpos_sigma))
    np.testing.assert_array_equal(spec.qpos0, target)
    np.testing.assert_array_equal(spec.uamp, uamp)
    np.testing.assert_array_equal(spec.qsig, sig)
    assert spec.vsig == hooks_r.reset_qvel_sigma
    assert hooks.time_limit == hooks_r.time_limit

    # the draws alone: reset's forward moves no qpos or qvel
    n = 4000
    data = t.init_episode(m, make_data(m, "cpu", torch.float64, batch=n),
                          torch.Generator().manual_seed(17))
    qpos, qvel = data.qpos.numpy(), data.qvel.numpy()
    std_spec = np.sqrt(uamp ** 2 / 3.0 + sig ** 2)
    tol = 6.0 * std_spec / np.sqrt(n) + 1e-9
    assert np.all(np.abs(qpos.mean(axis=0) - target) < tol)
    np.testing.assert_allclose(qpos.std(axis=0), std_spec, rtol=0.1,
                               atol=1e-9)
    np.testing.assert_allclose(qvel.std(axis=0),
                               np.full(m.nv, hooks_r.reset_qvel_sigma),
                               rtol=0.1, atol=1e-9)


def test_quaternion_reset_amplitude_raises():
    """A reset amplitude on the humanoid's root quaternion (qpos[3:7]),
    uniform or Gaussian, no longer raises: the reference's reset adds it
    to the quaternion coordinates like any other and the step reads the
    quaternion normalized, so env_spec keeps it and the reset values are
    qpos0 + amplitude x noise, unnormalized."""
    m, t = suite.humanoid.run(dtype=np.float64)
    hooks = t.kernel_hooks(m)
    mk.env_spec(m, hooks)
    gauss = np.full(m.nq, 0.01)
    spec = mk.env_spec(m, dataclasses.replace(hooks, reset_qpos_sigma=gauss))
    assert spec.qsig[3:7] == (0.01,) * 4
    mask = np.zeros(m.nq)
    mask[5] = 1.0
    spec = mk.env_spec(m, dataclasses.replace(hooks, reset_noise=0.1,
                                              reset_mask=mask))
    assert spec.uamp[5] == 0.1 and spec.uamp[3] == 0.0
    uni = torch.linspace(-1.0, 1.0, m.nq, dtype=torch.float64)
    z = torch.ones(m.nq + m.nv, dtype=torch.float64)
    q, _ = mk.reset_values(spec, uni, z)
    assert float(q[5]) == spec.qpos0[5] + 0.1 * float(uni[5])
    assert q[3] == spec.qpos0[3]


def test_observe_kwargs_invariant():
    """A task that sets needs_fk for its reward while its observe takes no
    fk builds and runs (reference fault at megakernel.py:160-177, the
    humanoid-run-policy-obs regression); an observe that takes fk gets
    the pre-step frames."""
    benv = suite.load_batched("walker", "walk", B, device="cpu")
    model = benv.model
    hooks = benv.task.kernel_hooks(model)
    assert hooks.needs_fk
    mk.kernel_source(model, hooks, "double")
    gen = torch.Generator().manual_seed(0)
    roll = FastRollout(benv, 2, collect=True)
    state, traj = roll.run(roll.init(gen), gen)
    assert bool(torch.isfinite(traj.rewards).all())

    def observe_fk(bk, q, v, fk):
        return [fk["xpos"][1][2]] + list(q)

    with_fk = dataclasses.replace(hooks, observe=observe_fk,
                                  n_obs=1 + model.nq)
    mk.kernel_source(model, with_fk, "double")
    fn = mk.build_rollout(model, B, 1, with_fk, emit_obs=True)
    out = fn(*state, torch.zeros((1, model.nu, B)),
             torch.zeros(1, dtype=torch.int32))
    bk = sg.TorchBackend(B, torch.float32, "cpu")
    want = sg.build_fk(model, bk)(list(state[0]))["xpos"][1][2]
    assert torch.equal(out[7][0, 0], want)


def test_every_task_loads():
    assert set(suite.ALL_TASKS) == set(ref_suite.ALL_TASKS)
    for domain, task in suite.ALL_TASKS:
        benv = suite.load_batched(domain, task, 2, device="cpu")
        assert sg.supports(benv.model)


def _ref_loop(step, hooks_r, fk_r, q, v, ctrl_of, k_steps):
    """The reference step and hooks for ``k_steps`` steps, with
    ``ctrl_of(k, obs)`` giving step k's ctrl; returns the per-step obs and
    rewards and the final state."""
    w = [jnp.zeros_like(q[0]) for _ in v]
    obs, rew = [], []
    for k in range(k_steps):
        obs.append(jnp.stack(hooks_r.observe(q, v)))
        c = list(ctrl_of(k, obs[-1]))
        q, v, _, w = step(q, v, [], w, c)
        kw = dict(fk=fk_r(q)) if hooks_r.needs_fk else {}
        rew.append(hooks_r.reward(q, v, c, **kw))
    return obs, rew, q, v


def _state(m, rng, qvel_amp):
    qpos = np.tile(np.asarray(m.qpos0, np.float32)[:, None], (1, B))
    qvel = rng.uniform(-qvel_amp, qvel_amp, (m.nv, B))
    return tuple(a.astype(np.float32) for a in (
        qpos, qvel, np.zeros((1, B)), np.zeros((m.nv, B)),
        np.zeros((1, B))))


def test_walker_policy_rollout_matches_reference():
    k_steps = 4
    m, t, mr, tr = _task_pair("walker", "walk", np.float32)
    hooks_r = tr.kernel_hooks(mr)
    rpol = RefMLPPolicy(hidden=(64, 64))
    rng = np.random.default_rng(3)
    params = [(rng.uniform(-0.3, 0.3, (o, i)).astype(np.float32),
               rng.uniform(-0.1, 0.1, (o, 1)).astype(np.float32))
              for o, i in rpol.layer_sizes(hooks_r.n_obs, mr.nu)]
    state = _state(m, rng, 0.5)
    ctrl_r = []

    def act(k, obs):
        ctrl_r.append(rpol.apply([(jnp.asarray(w), jnp.asarray(b))
                                  for w, b in params], obs.T).T)
        return ctrl_r[-1]

    obs_r, rew_r, q, v = _ref_loop(
        rsg.build_step(mr), hooks_r, rsg.build_fk(mr),
        [jnp.asarray(x) for x in state[0]], [jnp.asarray(x) for x in state[1]],
        act, k_steps)

    benv = suite.load_batched("walker", "walk", B, device="cpu")
    pol = convert.policy_params_from_numpy(params, "cpu")
    roll = FastRollout(benv, k_steps, policy=pol, collect=True)
    out = roll.kernel(*convert.state_from_numpy(state, "cpu"), None,
                      torch.zeros(1, dtype=torch.int32), pol.kernel_params())
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


def test_cartpole_ctrl_rollout_matches_reference():
    k_steps = 24
    m, t, mr, tr = _task_pair("cartpole", "swingup", np.float32)
    hooks_r = tr.kernel_hooks(mr)
    rng = np.random.default_rng(1)
    state = _state(m, rng, 1.0)
    state[0][1] += np.float32(np.pi)  # the pole starts down
    ctrl = rng.uniform(-1, 1, (k_steps, m.nu, B)).astype(np.float32)
    obs_r, rew_r, q, v = _ref_loop(
        rsg.build_step(mr), hooks_r, None,
        [jnp.asarray(x) for x in state[0]], [jnp.asarray(x) for x in state[1]],
        lambda k, obs: jnp.asarray(ctrl[k]), k_steps)

    benv = suite.load_batched("cartpole", "swingup", B, device="cpu")
    fn = FastRollout(benv, k_steps, collect=True).kernel
    out = fn(*convert.state_from_numpy(state, "cpu"), torch.tensor(ctrl),
             torch.zeros(1, dtype=torch.int32))
    np.testing.assert_allclose(out[7].numpy(), np.stack(obs_r), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(out[8].numpy(), np.stack(rew_r), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(out[0].numpy(), np.stack(q), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(out[1].numpy(), np.stack(v), rtol=0,
                               atol=1e-3)
