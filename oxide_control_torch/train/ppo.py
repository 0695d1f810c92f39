"""PPO on the rollout kernel's collected trajectories (cheetah-run).

The port of the reference's ``examples/train_ppo.py``.  Each iteration is
one ``FastRollout(policy=actor, collect=True)`` call: K steps of physics,
observation, the tanh-MLP actor, exploration noise, reward and
auto-reset inside one kernel launch, returning the (obs, action, reward,
done) trajectory.  Then GAE advantages bootstrap-masked by the dones
(the auto-reset boundaries), a Gaussian log-prob over the kernel's
exploration noise (action = actor(obs) + sigma * eps, recorded after the
noise), and Adam updates of the actor and the critic, their gradients
clipped to a global norm of 0.5 as ``optax.clip_by_global_norm`` does.
The actor's weights are the kernel's call inputs, so the loop never
rebuilds it.  Gradients come from autograd on the two modules.

Configuration from the environment, as the reference reads it:
``PPO_ITERS`` (60), ``PPO_BATCH`` (2048), ``PPO_STEPS`` (200),
``PPO_SIGMA`` (0.1), ``PPO_EPOCHS`` (4).  Run on the card with::

    python -m oxide_control_torch.train.ppo [--out curve.json]

The learning curve is written only where ``--out`` asks.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time

import torch
from torch import nn

from .. import default_device, suite
from ..parallel.rollout import FastRollout
from ..policy import MLPPolicy

GAMMA, LAM = 0.99, 0.95
CLIP = 0.2
MINIBATCHES = 8
LR = 3e-4
ADAM_EPS = 1e-8
MAX_GRAD_NORM = 0.5
UPDATE_DATA = ("obs", "act", "adv", "target", "logp")


@dataclasses.dataclass
class Config:
    iters: int = 60
    batch: int = 2048
    steps: int = 200
    sigma: float = 0.1
    epochs: int = 4


def config_from_env(environ=None) -> Config:
    """The reference's environment variables, with its defaults."""
    env = os.environ if environ is None else environ
    return Config(iters=int(env.get("PPO_ITERS", "60")),
                  batch=int(env.get("PPO_BATCH", "2048")),
                  steps=int(env.get("PPO_STEPS", "200")),
                  sigma=float(env.get("PPO_SIGMA", "0.1")),
                  epochs=int(env.get("PPO_EPOCHS", "4")))


class Critic(nn.Module):
    """Value function: a tanh MLP with a linear output, its input clipped
    to +-100 (a lane heading for divergence before its auto-reset can
    emit huge observations: the actor's tanh saturates harmlessly, a
    linear critic would poison the value loss).  Xavier-uniform weights,
    zero biases, as the reference's ``critic_init``."""

    def __init__(self, n_obs: int, hidden=(64, 64),
                 generator: torch.Generator | None = None, device=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        device = default_device(device)
        dims = [n_obs, *hidden, 1]
        self.layers = nn.ModuleList(
            nn.Linear(dims[i], dims[i + 1], device=device, dtype=dtype)
            for i in range(len(dims) - 1))
        with torch.no_grad():
            for layer in self.layers:
                out, inp = layer.weight.shape
                lim = math.sqrt(6.0 / (inp + out))
                layer.weight.uniform_(-lim, lim, generator=generator)
                layer.bias.zero_()

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        """obs (..., n_obs) -> value (...)."""
        x = torch.clamp(obs, -100.0, 100.0)
        for layer in self.layers[:-1]:
            x = torch.tanh(x @ layer.weight.T + layer.bias)
        last = self.layers[-1]
        return (x @ last.weight.T + last.bias)[..., 0]


def gaussian_logp(mu, a, sigma):
    """log N(a; mu, sigma^2) summed over the last axis, up to a constant."""
    return -0.5 * torch.sum(((a - mu) / sigma) ** 2, dim=-1)


def gae(rewards, dones, values, gamma=GAMMA, lam=LAM):
    """Advantages of (K, B) rewards, dones and values: the last step
    bootstraps from its own value (a truncation, not a termination), and
    a done step stops the bootstrap across the auto-reset."""
    nonterm = 1.0 - dones
    v_next = torch.cat([values[1:], values[-1:]], dim=0)
    advs = torch.empty_like(values)
    adv = torch.zeros_like(values[0])
    for t in range(values.shape[0] - 1, -1, -1):
        delta = rewards[t] + gamma * v_next[t] * nonterm[t] - values[t]
        adv = delta + gamma * lam * nonterm[t] * adv
        advs[t] = adv
    return advs


@torch.no_grad()
def prepare(actor, critic, traj, sigma):
    """A call's trajectory -> the update's flat (K*B, ...) data: obs,
    actions, normalized advantages, value targets and the behaviour
    log-probs."""
    obs = traj.obs.transpose(1, 2)      # (K, n_obs, B) -> (K, B, n_obs)
    act = traj.ctrls.transpose(1, 2)    # (K, nu, B) -> (K, B, nu)
    values = critic(obs)
    adv = gae(traj.rewards, traj.dones, values)
    target = adv + values
    # jnp.std: the population deviation
    adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    logp_old = gaussian_logp(actor(obs), act, sigma)
    n = values.numel()
    return tuple(x.reshape((n,) + x.shape[2:])
                 for x in (obs, act, adv, target, logp_old))


def loss_fn(actor, critic, mb, sigma):
    """The clipped surrogate plus half the value MSE; the log-ratio is
    clamped to +-20 (with a small fixed sigma a few epochs of drift can
    push exp() to inf on off-policy samples)."""
    obs, act, adv, target, logp_old = mb
    logp = gaussian_logp(actor(obs), act, sigma)
    ratio = torch.exp(torch.clamp(logp - logp_old, -20.0, 20.0))
    surr = torch.minimum(ratio * adv,
                         torch.clamp(ratio, 1.0 - CLIP, 1.0 + CLIP) * adv)
    v_loss = torch.mean((critic(obs) - target) ** 2)
    return -torch.mean(surr) + 0.5 * v_loss


@torch.no_grad()
def clip_by_global_norm_(params, max_norm: float = MAX_GRAD_NORM):
    """``optax.clip_by_global_norm`` on the params' gradients, in place:
    with the global norm n of all of them, each g becomes (g / n) *
    max_norm unless n < max_norm.  (``nn.utils.clip_grad_norm_`` divides
    by n + 1e-6, and so does not compute the reference's update.)
    Returns n."""
    grads = [p.grad for p in params]
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm) * max_norm))
    return norm


def update(actor, critic, opt, data, sigma, epochs, generator):
    """``epochs`` passes over ``data`` in MINIBATCHES minibatches of a
    fresh permutation each (``torch.randperm`` on ``generator``)."""
    params = [p for group in opt.param_groups for p in group["params"]]
    n = data[0].shape[0]
    size = n // MINIBATCHES
    for _ in range(epochs):
        perm = torch.randperm(n, generator=generator,
                              device=data[0].device)
        for i in range(MINIBATCHES):
            idx = perm[i * size:(i + 1) * size]
            opt.zero_grad()
            loss_fn(actor, critic, tuple(x[idx] for x in data),
                    sigma).backward()
            clip_by_global_norm_(params)
            opt.step()


def margin(history):
    """(first-3 mean, last-3 mean, the improvement the last must clear)."""
    first = sum(history[:3]) / len(history[:3])
    last = sum(history[-3:]) / len(history[-3:])
    return first, last, 0.25 * abs(first) + 1.0


def train(device=None, config: Config | None = None,
          out: str | None = None, log=print) -> dict:
    """Train for ``config.iters`` iterations (``config_from_env()`` by
    default) on ``device`` (None: the current card; raises without one).
    Returns the history: the curve, wall seconds, env-steps/s with the
    optimization included, and the kernel's launches.  Writes it as JSON
    to ``out`` when given, then, with 20 or more iterations, raises
    unless the last three returns beat the first three by the reference's
    margin."""
    cfg = config or config_from_env()
    dev = default_device(device)
    benv = suite.load_batched("cheetah", "run", cfg.batch, device=dev)
    model = benv.model
    n_obs = benv.task.kernel_hooks(model).n_obs
    # one generator seeded 0 draws everything, as the reference's
    # PRNGKey(0) does
    gen = torch.Generator(device=dev).manual_seed(0)
    actor = MLPPolicy(n_obs, model.nu, hidden=(64, 64),
                      explore_sigma=cfg.sigma, generator=gen, device=dev)
    critic = Critic(n_obs, generator=gen, device=dev)
    roll = FastRollout(benv, cfg.steps, policy=actor, collect=True)
    state = roll.init(gen)
    opt = torch.optim.Adam(list(actor.parameters())
                           + list(critic.parameters()), lr=LR, eps=ADAM_EPS)
    log(f"[ppo] cheetah-run  batch={cfg.batch} steps/call={cfg.steps} "
        f"sigma={cfg.sigma} iters={cfg.iters} on {dev}")
    history = []
    t0 = time.perf_counter()
    for it in range(cfg.iters):
        state, traj = roll.run(state, gen)
        ret = float(traj.reward_sum.mean())
        if not math.isfinite(ret):
            raise RuntimeError(f"training diverged at iter {it}")
        history.append(ret)
        data = prepare(actor, critic, traj, cfg.sigma)
        for name, x in zip(UPDATE_DATA, data):
            if not bool(torch.isfinite(x).all()):
                raise RuntimeError(f"non-finite {name} in update data at "
                                   f"iter {it}")
        update(actor, critic, opt, data, cfg.sigma, cfg.epochs, gen)
        if not all(bool(torch.isfinite(p).all())
                   for p in actor.parameters()):
            raise RuntimeError(f"actor params non-finite after iter {it} "
                               "update")
        log(f"[ppo] iter {it:3d}  mean return/call {ret:9.2f}  diverged "
            f"{int(traj.diverged.sum())}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    env_steps = cfg.iters * cfg.batch * cfg.steps
    first, last, need = margin(history)
    log(f"[ppo] {env_steps:.3g} env-steps in {wall:.1f}s "
        f"({env_steps / wall:.3g} steps/s incl. optimization); mean "
        f"return/call: first-3 {first:.2f} -> last-3 {last:.2f}")
    result = dict(domain="cheetah-run", device=str(dev),
                  **dataclasses.asdict(cfg), curve=history,
                  env_steps=env_steps, wall_s=wall,
                  steps_per_s=env_steps / wall,
                  launches=roll.kernel.launches, first3=first, last3=last,
                  margin=need)
    if out is not None:
        with open(out, "w") as f:
            json.dump({"ppo": result}, f, indent=1)
    if cfg.iters >= 20 and not last > first + need:
        raise AssertionError(
            f"PPO did not clear the improvement margin: {first:.2f} -> "
            f"{last:.2f} (needed +{need:.2f})")
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="write the curve's JSON here")
    args = ap.parse_args(argv)
    train(out=args.out)


if __name__ == "__main__":
    main()
