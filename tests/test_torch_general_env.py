"""PyTorch port, general path: the environment layer and the rollouts.

``BatchedEnvironment.step`` (f32, B = 4, 24 steps, uniform ctrl drawn with
numpy) is held against the reference's on cheetah-run-elliptic and
walker-walk-tendon-sensors (observed through ``SensorObsWrapper``): each
step's TimeStep (reward within 1e-4, the observation within 1e-3, done
and discount equal) and the final state (qpos 1e-4, qvel 1e-3), the
reference's own bars (tests/test_megakernel.py:109-115), with episodes of
15 steps so that every env resets inside the window.  Both sides start
every episode at the model's reset state (an ``init_episode`` without
noise), as the reference's kernel test does, because the two draw their
noise from different generators.  The reference's elliptic cheetah step
takes over a minute to trace and compile here: the one slow fixture.

Also: the refsite site-transmission model, which the rollout kernel
refuses (ROADMAP Queue C), runs on the port's general path and matches
the reference's general path (one f64 step within 1e-8); the general
path's entry points raise without a card unless given ``device='cpu'``;
``rollout`` and ``jit_rollout`` (eager on the CPU) agree with a loop of
``step``; ``Environment`` is a batch-of-one view; divergence flags mask
non-finite and out-of-range states; and FastRollout still refuses a
model outside the kernel class, naming the general path.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oxide_control_tpu.api.environment import (
    BatchedEnvironment as RefBatchedEnvironment,
)
from oxide_control_tpu.model import ConeType as RefConeType
from oxide_control_tpu.suite import cheetah as rcheetah
from oxide_control_tpu.suite import walker as rwalker
from oxide_control_tpu.suite.common import (
    SensorObsWrapper as RefSensorObsWrapper,
)
from oxide_control_tpu.physics import forward as rfwd
from oxide_control_tpu.state import make_data as ref_make_data
from test_torch_general_smooth import err, models, seeded, suite_xml
from test_torch_model import _REFUSED

from oxide_control_torch import bench_configs, suite
from oxide_control_torch.api.environment import (
    BatchedEnvironment,
    Environment,
)
from oxide_control_torch.mjcf.compile import load_model_from_xml
from oxide_control_torch.model import ConeType
from oxide_control_torch.parallel.rollout import (
    FastRollout,
    jit_rollout,
    rollout,
)
from oxide_control_torch.physics import forward as pfwd
from oxide_control_torch.suite import cheetah, walker
from oxide_control_torch.suite.common import SensorObsWrapper
from oxide_control_torch.utils.divergence import divergence_flags

B, K = 4, 24
# episodes of 15 steps: every env resets inside the 24-step window
LIMIT_STEPS = 15
BARS = dict(qpos=1e-4, qvel=1e-3, reward=1e-4, obs=1e-3)


def _fixed_start(task):
    """The task with an init_episode that keeps the reset state."""
    task.init_episode = lambda model, data, rng: data
    return task


def _cheetah_elliptic():
    from oxide_control_tpu.mjcf.compile import load_model

    rm = load_model(suite_xml_path("cheetah"), dtype=np.float32)
    rm = rm.replace(opt=dataclasses.replace(rm.opt,
                                            cone=RefConeType.ELLIPTIC))
    pm, _ = bench_configs.cheetah_run_elliptic(np.float32)
    assert pm.opt.cone == ConeType.ELLIPTIC
    limit = LIMIT_STEPS * pm.opt.timestep
    return (rm, _fixed_start(rcheetah.Run(rm, time_limit=limit)),
            pm, _fixed_start(cheetah.Run(pm, time_limit=limit)))


def _walker_tendon_sensors():
    from oxide_control_tpu.mjcf.compile import load_model_from_xml as rload

    xml = suite_xml("walker", bench_configs.WALKER_TENDON_SENSORS)
    rm = rload(xml, dtype=np.float32)
    pm = load_model_from_xml(xml, dtype=np.float32)
    limit = LIMIT_STEPS * pm.opt.timestep
    rt = RefSensorObsWrapper(_fixed_start(rwalker._Walker(
        rm, move_speed=1.0, time_limit=limit)))
    pt = SensorObsWrapper(_fixed_start(walker._Walker(
        pm, move_speed=1.0, time_limit=limit)))
    return rm, rt, pm, pt


def suite_xml_path(name):
    from oxide_control_torch.suite.common import asset_path

    return asset_path(name)


ROWS = {"cheetah-run-elliptic": _cheetah_elliptic,
        "walker-walk-tendon-sensors": _walker_tendon_sensors}


@pytest.fixture(scope="module", params=sorted(ROWS))
def env_rollouts(request):
    rm, rt, pm, pt = ROWS[request.param]()
    ctrl = np.random.default_rng(4).uniform(-1, 1, (K, B, pm.nu)).astype(
        np.float32)
    benv = BatchedEnvironment(pm, pt, B, device="cpu")
    gen = torch.Generator().manual_seed(0)
    pd = benv.reset(gen)
    # the reference starts from the port's reset state (its core fields:
    # step recomputes every derived field), which spares compiling the
    # reference's reset: its elliptic step alone takes over a minute to
    # trace and compile on this class of CPU
    core = {k: jnp.asarray(getattr(pd, k).numpy()) for k in (
        "qpos", "qvel", "act", "ctrl", "qacc_warmstart", "time")}
    rd = jax.vmap(lambda c: ref_make_data(rm).replace(**c))(core)
    rbenv = RefBatchedEnvironment(rm, rt, B)
    step_j = jax.jit(rbenv.step)
    ref = []
    for k in range(K):
        rd, ts = step_j(rd, jnp.asarray(ctrl[k]), jax.random.PRNGKey(k))
        ref.append(ts)
    port = []
    for k in range(K):
        pd, ts = benv.step(pd, torch.from_numpy(ctrl[k]), gen)
        port.append(ts)
    return request.param, (rd, ref), (pd, port)


def test_env_steps_match_reference(env_rollouts):
    name, (rd, ref), (pd, port) = env_rollouts
    for k, (r, p) in enumerate(zip(ref, port)):
        assert err(r.reward, p.reward) < BARS["reward"], (name, k)
        assert err(r.observation, p.observation) < BARS["obs"], (name, k)
        np.testing.assert_array_equal(np.asarray(r.done), p.done.numpy())
        np.testing.assert_array_equal(np.asarray(r.discount),
                                      p.discount.numpy())
    assert err(rd.qpos, pd.qpos) < BARS["qpos"], name
    assert err(rd.qvel, pd.qvel) < BARS["qvel"], name


def test_every_env_resets_in_the_window(env_rollouts):
    _, _, (_, port) = env_rollouts
    dones = torch.stack([ts.done for ts in port])
    assert bool(dones.any(0).all())
    assert dones.dtype == torch.bool and dones.shape == (K, B)


def test_refsite_model_on_the_general_path():
    """The refsite site transmission: the kernel refuses the model, the
    general path runs it and matches the reference's general path."""
    rm, pm = models(_REFUSED["refsite"])
    rd, pd = seeded(rm, pm, seed=1, qnoise=0.5, vnoise=1.0)
    rs = jax.jit(jax.vmap(lambda d: rfwd.step(rm, d)))(rd)
    ps = pfwd.step(pm, pd)
    assert err(rs.qpos, ps.qpos) < 1e-8 and err(rs.qvel, ps.qvel) < 1e-8
    benv = BatchedEnvironment(pm, bench_configs.BenchTask(), 2,
                              device="cpu", dtype=torch.float64)
    with pytest.raises(ValueError, match="jit_rollout"):
        FastRollout(benv, 2)
    data, (rew, done), _ = rollout(benv, benv.reset(
        torch.Generator().manual_seed(0)), torch.Generator().manual_seed(1),
        3)
    assert bool(torch.isfinite(data.qpos).all()) and rew.shape == (3, 2)


def test_entry_points_need_a_card_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        suite.load_batched("cheetah", "run", 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_configs.load_config("walker", "walk-tendon-sensors", 2)
    model, task = cheetah.run()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Environment(model, task)


def test_rollout_and_jit_rollout_equal_a_step_loop():
    benv = suite.load_batched("cheetah", "run", 3, device="cpu")
    data = benv.reset(torch.Generator().manual_seed(0))
    out = [rollout(benv, data, torch.Generator().manual_seed(5), 4),
           jit_rollout(benv, 4)(data, torch.Generator().manual_seed(5))]
    gen = torch.Generator().manual_seed(5)
    d, rews = data, []
    for _ in range(4):
        a = torch.empty((3, benv.model.nu)).uniform_(-1.0, 1.0,
                                                      generator=gen)
        d, ts = benv.step(d, a, gen)
        rews.append(ts.reward)
    for fd, (r, dn), mean in out:
        assert torch.equal(fd.qpos, d.qpos) and torch.equal(
            r, torch.stack(rews))
        assert dn.shape == (4, 3)
        assert torch.allclose(mean, torch.stack(rews).sum(0).mean())


def test_environment_is_a_batch_of_one():
    model, task = cheetah.run()
    env = Environment(model, task, device="cpu")
    data, obs = env.reset(torch.Generator().manual_seed(0))
    assert data.qpos.shape == (1, model.nq) and obs.shape == (1, 17)
    data, ts = env.step(data, torch.zeros((1, model.nu)))
    assert ts.reward.shape == (1,) and not bool(ts.done[0])
    assert float(ts.discount[0]) == 1.0
    assert torch.allclose(data.time, torch.full((1,), model.opt.timestep))


def test_divergence_flags():
    benv = suite.load_batched("cheetah", "run", 4, device="cpu")
    data = benv.reset(torch.Generator().manual_seed(0))
    qpos = data.qpos.clone()
    qpos[1, 3] = float("nan")
    qvel = data.qvel.clone()
    qvel[2, 0] = 2e10
    flags = divergence_flags(benv.model, data.replace(qpos=qpos, qvel=qvel))
    assert flags.tolist() == [False, True, True, False]

