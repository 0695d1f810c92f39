"""Antithetic evolution strategies on the rollout kernel (cheetah-run).

The port of the reference's ``examples/train_es.py``.  Every fitness
evaluation is one ``FastRollout.run`` call with the in-kernel tanh-MLP
policy: K steps of physics, observation, policy, reward and auto-reset
inside one kernel launch.  Each iteration draws ``pop`` perturbations
eps, scores theta + sigma * eps and theta - sigma * eps with common
random numbers (the generator's state is saved before the + call and
restored before the - call, so both draw the same kernel seed; the
kernel state carries from call to call), normalizes the scores, steps
theta along the antithetic estimate, and scores the new theta.  The
policy's weights are the kernel's call inputs, so nothing is rebuilt.

Configuration from the environment, as the reference reads it:
``ES_ITERS`` (30), ``ES_BATCH`` (4096), ``ES_STEPS`` (200), ``ES_POP``
(8 antithetic pairs); sigma 0.05 and the step 0.02 are fixed.  Run on
the card with::

    python -m oxide_control_torch.train.es [--out curve.json]

The learning curve is written only where ``--out`` asks.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time

import numpy as np
import torch
from torch.nn.utils import parameters_to_vector, vector_to_parameters

from .. import default_device, suite
from ..parallel.rollout import FastRollout
from ..policy import MLPPolicy
from .ppo import margin

SIGMA = 0.05    # perturbation scale
LR = 0.02


@dataclasses.dataclass
class Config:
    iters: int = 30
    batch: int = 4096
    steps: int = 200
    pop: int = 8    # antithetic pairs


def config_from_env(environ=None) -> Config:
    """The reference's environment variables, with its defaults."""
    env = os.environ if environ is None else environ
    return Config(iters=int(env.get("ES_ITERS", "30")),
                  batch=int(env.get("ES_BATCH", "4096")),
                  steps=int(env.get("ES_STEPS", "200")),
                  pop=int(env.get("ES_POP", "8")))


def antithetic_gradient(scores: np.ndarray, eps: torch.Tensor,
                        sigma: float = SIGMA) -> torch.Tensor:
    """The search gradient of ``scores`` (2 * pop,), (+, -) per pair, for
    perturbations ``eps (pop, n)``: the scores normalized to zero mean and
    unit (population) deviation, then sum_p (adv_p+ - adv_p-) eps_p /
    (2 pop sigma)."""
    adv = (scores - scores.mean()) / max(scores.std(), 1e-8)
    diff = torch.as_tensor(adv[0::2] - adv[1::2], dtype=eps.dtype,
                           device=eps.device)
    return torch.einsum("p,pn->n", diff, eps) / (2 * eps.shape[0] * sigma)


def train(device=None, config: Config | None = None,
          out: str | None = None, log=print) -> dict:
    """Train for ``config.iters`` iterations (``config_from_env()`` by
    default) on ``device`` (None: the current card; raises without one).
    Returns the history: the curve, wall seconds, env-steps/s with the
    host loop included, and the kernel's launches (iters * (2 pop + 1)).
    Writes it as JSON to ``out`` when given, then, with 12 or more
    iterations, raises unless the last three scores beat the first three
    by the reference's margin."""
    cfg = config or config_from_env()
    dev = default_device(device)
    benv = suite.load_batched("cheetah", "run", cfg.batch, device=dev)
    model = benv.model
    n_obs = benv.task.kernel_hooks(model).n_obs
    # one generator seeded 0 draws everything, as the reference's
    # PRNGKey(0) does
    gen = torch.Generator(device=dev).manual_seed(0)
    policy = MLPPolicy(n_obs, model.nu, hidden=(64, 64), generator=gen,
                       device=dev)
    roll = FastRollout(benv, cfg.steps, policy=policy)
    state = roll.init(gen)
    params = list(policy.parameters())
    theta = parameters_to_vector(params).detach().clone()
    log(f"[es] cheetah-run  batch={cfg.batch} steps/call={cfg.steps} "
        f"pop={2 * cfg.pop}  params={theta.numel()} on {dev}")

    def fitness(state, vec):
        # the mean per-env return over the K steps (auto-reset lanes keep
        # accumulating, as a throughput consumer sees them)
        vector_to_parameters(vec, params)
        state, traj = roll.run(state, gen)
        return state, float(traj.reward_sum.mean())

    history = []
    t0 = time.perf_counter()
    for it in range(cfg.iters):
        eps = torch.randn((cfg.pop, theta.numel()), generator=gen,
                          device=dev, dtype=theta.dtype)
        scores = np.zeros(2 * cfg.pop)
        for p in range(cfg.pop):
            # common random numbers: the same kernel seed for +eps and
            # -eps, so the difference reflects the perturbation rather
            # than the reset noise
            saved = gen.get_state()
            for s, sign in ((2 * p, 1.0), (2 * p + 1, -1.0)):
                gen.set_state(saved)
                state, scores[s] = fitness(state,
                                           theta + sign * SIGMA * eps[p])
        theta = theta + LR * antithetic_gradient(scores, eps)
        state, score = fitness(state, theta)
        if not math.isfinite(score):
            raise RuntimeError(f"training diverged at iter {it}")
        history.append(score)
        log(f"[es] iter {it:3d}  mean return/call {score:9.2f}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    env_steps = cfg.iters * (2 * cfg.pop + 1) * cfg.batch * cfg.steps
    first, last, need = margin(history)
    log(f"[es] {env_steps:.3g} env-steps in {wall:.1f}s "
        f"({env_steps / wall:.3g} steps/s incl. host loop); mean "
        f"return/call: first-3 {first:.2f} -> last-3 {last:.2f}")
    result = dict(domain="cheetah-run", device=str(dev),
                  **dataclasses.asdict(cfg), curve=history,
                  env_steps=env_steps, wall_s=wall,
                  steps_per_s=env_steps / wall,
                  launches=roll.kernel.launches, first3=first, last3=last,
                  margin=need)
    if out is not None:
        with open(out, "w") as f:
            json.dump({"es": result}, f, indent=1)
    if cfg.iters >= 12 and not last > first + need:
        raise AssertionError(
            f"ES did not clear the improvement margin: {first:.2f} -> "
            f"{last:.2f} (needed +{need:.2f})")
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="write the curve's JSON here")
    args = ap.parse_args(argv)
    train(out=args.out)


if __name__ == "__main__":
    main()
