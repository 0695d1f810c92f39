"""PyTorch port: the PPO and ES trainers (``oxide_control_torch.train``).

Held against the reference's ``examples/train_ppo.py`` and
``examples/train_es.py``, in f64 on the CPU:

* ``critic_apply`` and ``gaussian_logp``, imported from the reference's
  script (its top level only imports), against the port's ``Critic`` and
  ``gaussian_logp`` (1e-12);
* GAE and the loss, closures of the reference's ``main()`` transcribed
  here, against the port's (1e-12), and the loss's gradient from autograd
  against ``jax.grad`` (1e-10);
* two clipped Adam updates against ``optax.chain(clip_by_global_norm(0.5),
  adam(3e-4))`` (1e-10), with the clip triggered and not;
* the antithetic ES estimate against the reference's formula (1e-12),
  and ``flat``/``unflat`` (``parameters_to_vector`` /
  ``vector_to_parameters``) against the reference's layout;
* two iterations of each trainer on the CPU at B = 16 (the kernel's plain
  version), finite, with one ``FastRollout.run`` per iteration (PPO) and
  2 * pop + 1 (ES).  ES runs K = 5 and one pair to keep the test under
  10 s: each plain cheetah step takes ~0.18 s here.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.nn.utils import parameters_to_vector, vector_to_parameters

from oxide_control_tpu.policy import MLPPolicy as RefMLPPolicy

from oxide_control_torch import convert
from oxide_control_torch.parallel.rollout import FastRollout, Trajectory
from oxide_control_torch.policy import MLPPolicy
from oxide_control_torch.train import es, ppo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BAR = 1e-12
N_OBS, NU, HIDDEN = 5, 2, (4,)
K, B = 7, 6


@pytest.fixture(scope="module")
def ref_ppo():
    """The reference's PPO script as a module (not run)."""
    spec = importlib.util.spec_from_file_location(
        "ref_train_ppo", os.path.join(REPO, "examples", "train_ppo.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ref_gae(rewards, dones, values, gamma=0.99, lam=0.95):
    """examples/train_ppo.py:main.gae, transcribed."""
    nonterm = 1.0 - dones
    v_next = jnp.concatenate([values[1:], values[-1:]], axis=0)

    def bwd(adv, x):
        r, nt, v, vn = x
        delta = r + gamma * vn * nt - v
        adv = delta + gamma * lam * nt * adv
        return adv, adv

    _, advs = jax.lax.scan(bwd, jnp.zeros_like(values[0]),
                           (rewards, nonterm, values, v_next), reverse=True)
    return advs


def ref_mu_apply(params, obs):
    """examples/train_ppo.py:main.mu_apply, transcribed."""
    x = obs
    for (w, b) in params:
        x = jnp.tanh(x @ w.T + b[:, 0])
    return x


def ref_loss_fn(ref, params, mb, sigma, clip=0.2):
    """examples/train_ppo.py:main.loss_fn, transcribed."""
    actor_p, critic_p = params
    obs, act, adv, target, logp_old = mb
    logp = ref.gaussian_logp(ref_mu_apply(actor_p, obs), act, sigma)
    ratio = jnp.exp(jnp.clip(logp - logp_old, -20.0, 20.0))
    surr = jnp.minimum(ratio * adv,
                       jnp.clip(ratio, 1.0 - clip, 1.0 + clip) * adv)
    v = ref.critic_apply(critic_p, obs)
    return -jnp.mean(surr) + 0.5 * jnp.mean((v - target) ** 2)


def modules(seed=0):
    """(actor, critic) in f64 on the CPU, and the reference's params
    ((W, b (out, 1)) pairs; the critic's b (out,))."""
    gen = torch.Generator().manual_seed(seed)
    actor = MLPPolicy(N_OBS, NU, HIDDEN, explore_sigma=0.1, generator=gen,
                      device="cpu", dtype=torch.float64)
    critic = ppo.Critic(N_OBS, HIDDEN, generator=gen, device="cpu",
                        dtype=torch.float64)
    with torch.no_grad():
        for p in list(actor.parameters()) + list(critic.parameters()):
            p.add_(0.1 * torch.randn(p.shape, generator=gen,
                                     dtype=p.dtype))
    a = [(jnp.asarray(w.detach().numpy().copy()),
          jnp.asarray(b.detach().numpy()[:, None].copy()))
         for w, b in zip(*[iter(actor.parameters())] * 2)]
    c = [(jnp.asarray(w.detach().numpy().copy()),
          jnp.asarray(b.detach().numpy().copy()))
         for w, b in zip(*[iter(critic.parameters())] * 2)]
    return actor, critic, (a, c)


def minibatch(seed=1, n=12):
    rng = np.random.default_rng(seed)
    obs = rng.normal(size=(n, N_OBS)) * 3.0
    obs[0, 0], obs[1, 1] = 250.0, -180.0   # beyond the critic's clip
    return (obs, rng.uniform(-1, 1, (n, NU)), rng.normal(size=n),
            rng.normal(size=n), rng.normal(size=n) - 2.0)


def test_critic_and_logp_match_reference(ref_ppo):
    actor, critic, (_, c) = modules()
    obs, act, *_ = minibatch()
    want = np.asarray(ref_ppo.critic_apply(c, jnp.asarray(obs)))
    got = critic(torch.from_numpy(obs)).detach().numpy()
    assert np.abs(got - want).max() < BAR
    mu = actor(torch.from_numpy(obs)).detach()
    want = np.asarray(ref_ppo.gaussian_logp(jnp.asarray(mu.numpy()),
                                            jnp.asarray(act), 0.1))
    got = ppo.gaussian_logp(mu, torch.from_numpy(act), 0.1).numpy()
    assert np.abs(got - want).max() < BAR


def test_gae_matches_reference():
    rng = np.random.default_rng(2)
    rewards, values = rng.normal(size=(K, B)), rng.normal(size=(K, B))
    dones = (rng.uniform(size=(K, B)) < 0.2).astype(np.float64)
    dones[-1, 0] = 1.0
    want = np.asarray(ref_gae(*map(jnp.asarray, (rewards, dones, values))))
    got = ppo.gae(*map(torch.from_numpy, (rewards, dones, values))).numpy()
    assert np.abs(got - want).max() < BAR


def test_loss_and_gradient_match_reference(ref_ppo):
    actor, critic, params = modules()
    mb = minibatch()
    want, grads = jax.value_and_grad(
        lambda p: ref_loss_fn(ref_ppo, p, tuple(map(jnp.asarray, mb)),
                              0.1))(params)
    loss = ppo.loss_fn(actor, critic, tuple(map(torch.from_numpy, mb)), 0.1)
    assert abs(loss.item() - float(want)) < BAR
    loss.backward()
    ref_leaves = [np.asarray(x).reshape(-1)
                  for x in jax.tree.leaves(grads)]
    port = [p.grad.numpy().reshape(-1)
            for p in list(actor.parameters()) + list(critic.parameters())]
    for g, r in zip(port, ref_leaves):
        assert np.abs(g - r).max() < 1e-10


@pytest.mark.parametrize("scale", [10.0, 0.01], ids=["clipped", "unclipped"])
def test_clipped_adam_matches_optax(scale):
    actor, critic, _ = modules()
    params = list(actor.parameters()) + list(critic.parameters())
    # copies: on the CPU jnp.asarray may share the numpy buffer, which the
    # port's in-place step then moves
    ref = [jnp.asarray(p.detach().numpy().copy()) for p in params]
    opt = torch.optim.Adam(params, lr=ppo.LR, eps=ppo.ADAM_EPS)
    ropt = optax.chain(optax.clip_by_global_norm(ppo.MAX_GRAD_NORM),
                       optax.adam(ppo.LR))
    rstate = ropt.init(ref)

    @jax.jit
    def ref_step(g, state, params):
        upd, state = ropt.update(g, state, params)
        return optax.apply_updates(params, upd), state

    rng = np.random.default_rng(3)
    norms = []
    for _ in range(2):
        grads = [scale * rng.normal(size=p.shape) for p in params]
        for p, g in zip(params, grads):
            p.grad = torch.from_numpy(g.copy())
        norms.append(float(ppo.clip_by_global_norm_(params)))
        opt.step()
        ref, rstate = ref_step([jnp.asarray(g) for g in grads], rstate, ref)
        for p, r in zip(params, ref):
            assert np.abs(p.detach().numpy() - np.asarray(r)).max() < 1e-10
    assert all((n > ppo.MAX_GRAD_NORM) == (scale > 1.0) for n in norms)


def test_es_estimate_matches_reference_formula():
    rng = np.random.default_rng(4)
    pop, n = 3, 11
    scores = rng.normal(size=2 * pop)
    eps = rng.normal(size=(pop, n))
    adv = (scores - scores.mean()) / max(scores.std(), 1e-8)
    want = np.asarray(jnp.einsum("p,pn->n", jnp.asarray(adv[0::2]
                                                        - adv[1::2]),
                                 jnp.asarray(eps)) / (2 * pop * es.SIGMA))
    got = es.antithetic_gradient(scores, torch.from_numpy(eps)).numpy()
    assert np.abs(got - want).max() < BAR


def test_flat_and_unflat_follow_the_reference_layout():
    ref = RefMLPPolicy(hidden=(64, 64)).init_params(jax.random.PRNGKey(0),
                                                    17, 6, jnp.float64)
    flat = np.concatenate([np.asarray(x).ravel() for wb in ref for x in wb])
    pol = convert.policy_params_from_numpy(ref, "cpu", torch.float64)
    vec = parameters_to_vector(pol.parameters())
    assert torch.equal(vec, torch.from_numpy(flat))
    vector_to_parameters(2.0 * vec, pol.parameters())
    i = 0
    for t, (w, b) in zip(pol.kernel_params()[0::2], ref):
        assert torch.equal(t, torch.from_numpy(
            2.0 * flat[i:i + w.size].reshape(w.shape)))
        i += w.size + b.size


@pytest.fixture
def counted_runs(monkeypatch):
    calls = []
    run = FastRollout.run

    def counted(self, state, generator, *args, **kw):
        before = generator.get_state()
        out = run(self, state, generator, *args, **kw)
        calls.append((before, out[1]))
        return out

    monkeypatch.setattr(FastRollout, "run", counted)
    return calls


def test_ppo_runs_two_iterations_on_the_cpu(counted_runs):
    h = ppo.train(device="cpu", config=ppo.Config(iters=2, batch=16,
                                                  steps=10),
                  log=lambda *a: None)
    assert len(counted_runs) == 2 and len(h["curve"]) == 2
    assert all(isinstance(t, Trajectory) and t.obs.shape == (10, 17, 16)
               for _, t in counted_runs)
    assert np.isfinite(h["curve"]).all() and h["env_steps"] == 2 * 16 * 10


def test_es_runs_two_iterations_on_the_cpu(counted_runs):
    h = es.train(device="cpu", config=es.Config(iters=2, batch=16, steps=5,
                                                pop=1),
                 log=lambda *a: None)
    assert len(counted_runs) == 2 * 3 and len(h["curve"]) == 2
    assert np.isfinite(h["curve"]).all()
    assert h["env_steps"] == 2 * 3 * 16 * 5
    # common random numbers: a pair's two calls start from one generator
    # state; the update's call goes on from there
    states = [g for g, _ in counted_runs]
    assert torch.equal(states[0], states[1])
    assert not torch.equal(states[1], states[2])


def test_trainers_read_the_reference_variables():
    assert ppo.config_from_env({}) == ppo.Config(60, 2048, 200, 0.1, 4)
    assert es.config_from_env({}) == es.Config(30, 4096, 200, 8)
    assert ppo.config_from_env({"PPO_ITERS": "3"}).iters == 3
    assert es.config_from_env({"ES_POP": "2"}).pop == 2
