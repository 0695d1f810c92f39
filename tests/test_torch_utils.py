"""PyTorch port: ``utils`` (checkpoint, debug, profiling) against the
reference's behaviour.

Checkpoints: the port's save and load resume bit for bit (state and
generator), a ``FastRollout`` state round-trips through ``unpack``, and a
file the reference saved resumes in the port within 1e-12 of the
reference's own continuation.  ``checked_step`` and ``nan_debug_step``
on an injected NaN, and ``StepRateMeter`` on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oxide_control_tpu import suite as rsuite
from oxide_control_tpu.state import make_data as rmake
from oxide_control_tpu.utils import checkpoint as rckpt

from oxide_control_torch import suite as psuite
from oxide_control_torch.parallel.rollout import FastRollout
from oxide_control_torch.state import make_data
from oxide_control_torch.utils import checkpoint as ckpt
from oxide_control_torch.utils.debug import checked_step, nan_debug_step
from oxide_control_torch.utils.profiling import (
    StepRateMeter,
    annotate,
    trace,
)

F64 = torch.float64


def test_checkpoint_exact_resume(tmp_path):
    env = psuite.load("cartpole", "swingup", device="cpu")
    gen = torch.Generator().manual_seed(0)
    data, _ = env.reset(gen)
    for _ in range(5):
        data, _ = env.step(data, torch.full((1, 1), 0.3, dtype=F64))
    path = str(tmp_path / "ck.npz")
    ckpt.save(path, data, generator=gen)
    restored, gen2 = ckpt.load(path, env.model, device="cpu")
    assert torch.equal(torch.rand(4, generator=gen),
                       torch.rand(4, generator=gen2))
    d1, ts1 = env.step(data, torch.full((1, 1), -0.2, dtype=F64))
    d2, ts2 = env.step(restored, torch.full((1, 1), -0.2, dtype=F64))
    for f in ("qpos", "qvel", "time"):
        assert torch.equal(getattr(d1, f), getattr(d2, f)), f
    assert torch.equal(ts1.observation, ts2.observation)


def test_fast_rollout_state_round_trip(tmp_path):
    """A FastRollout state through unpack, save, load and pack, and one
    more call from it (the plain version, on the CPU) bit for bit."""
    benv = psuite.load_batched("cartpole", "swingup", 8, device="cpu")
    roll = FastRollout(benv, 4)
    gen = torch.Generator().manual_seed(1)
    state = roll.init(gen)
    state, _ = roll.run(state, gen)
    path = str(tmp_path / "roll.npz")
    ckpt.save(path, roll.unpack(state), generator=gen)
    data, gen2 = ckpt.load(path, benv.model, device="cpu")
    state2 = roll.pack(data)
    for a, b in zip(state, state2):
        assert torch.equal(a, b)
    s1, t1 = roll.run(state, gen)
    s2, t2 = roll.run(state2, gen2)
    for a, b in zip(s1, s2):
        assert torch.equal(a, b)
    assert torch.equal(t1.reward_sum, t2.reward_sum)


def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    """The reference saves a single-env cartpole state (seeded, moving);
    the port loads it (a batch of one) and its next step agrees with the
    reference's within 1e-12.  The JAX key has no torch counterpart."""
    ref = rsuite.load("cartpole", "swingup")
    rstep = jax.jit(ref.step)
    rng = np.random.default_rng(0)
    data = rmake(ref.model).replace(
        qpos=jnp.asarray(rng.uniform(-0.5, 0.5, ref.model.nq)),
        qvel=jnp.asarray(rng.uniform(-1, 1, ref.model.nv)),
        time=jnp.asarray(0.3))
    path = str(tmp_path / "ref.npz")
    rckpt.save(path, data, rng=jax.random.PRNGKey(42))
    want, _ = rstep(data, jnp.ones(1) * -0.2)

    env = psuite.load("cartpole", "swingup", device="cpu")
    restored, gen = ckpt.load(path, env.model, device="cpu")
    assert gen is None and restored.qpos.shape == (1, env.model.nq)
    got, _ = env.step(restored, torch.full((1, 1), -0.2, dtype=F64))
    for f in ("qpos", "qvel", "time"):
        w = np.asarray(getattr(want, f))
        assert np.abs(w - getattr(got, f)[0].numpy()).max() < 1e-12, f


def _pendulum():
    benv = psuite.load_batched("pendulum", "swingup", 2, dtype=np.float64,
                               device="cpu")
    return benv.model, make_data(benv.model, "cpu", F64, batch=2)


def test_checked_step_flags_nan():
    model, d = _pendulum()
    step = checked_step(model)
    step(d)                                  # clean: no error
    bad = d.replace(qvel=d.qvel.clone())
    bad.qvel[1, 0] = float("nan")
    with pytest.raises(FloatingPointError, match="non-finite"):
        step(bad)


def test_nan_debug_step_names_the_stage(capsys):
    """A NaN in ctrl first shows in the actuation stage's outputs."""
    model, d = _pendulum()
    bad = d.replace(ctrl=d.ctrl.clone())
    bad.ctrl[0, 0] = float("nan")
    out = nan_debug_step(model)(bad)
    text = capsys.readouterr().out
    assert "nan_debug: position non-finite count = 0" in text
    assert "first non-finite stage: actuation" in text
    assert not bool(torch.isfinite(out.qpos).all())
    nan_debug_step(model)(d)
    assert "first non-finite" not in capsys.readouterr().out


def test_step_rate_meter_and_trace(tmp_path):
    m = StepRateMeter("cpu")
    m.add(1000)
    assert m.rate > 0
    with trace(str(tmp_path)) as prof:
        with annotate("work"):
            torch.ones(64).sum()
    names = {e.key for e in prof.key_averages()}
    assert "work" in names
    assert (tmp_path / "trace.json").exists()


def test_step_rate_meter_defaults_to_the_card():
    """With no device the meter times on the current CUDA device, as every
    entry point does; without a card it raises instead of falling back to
    the host clock."""
    if torch.cuda.is_available():
        assert StepRateMeter().cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            StepRateMeter()
