"""PyTorch port: the rollout function's plain version against the
reference Pallas kernel (interpret mode) on the hopper model of
test_megakernel.py, at the reference's own bars: the whole env layer
(step, reward, time limit, auto-reset) and the collected trajectory.  The
in-kernel policy case is in test_torch_rollout_policy.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oxide_control_tpu.mjcf.compile import (
    load_model_from_xml as ref_load_model_from_xml,
)
from oxide_control_tpu.ops import megakernel as rmk
from test_megakernel import _XML as HOPPER_XML, _HopTask

from oxide_control_torch import convert
from oxide_control_torch.mjcf.compile import load_model_from_xml
from oxide_control_torch.ops import megakernel as mk

B, K = 8, 24


def _port_hooks(model):
    """_HopTask.kernel_hooks on the port's backend interface."""
    return mk.EnvHooks(
        reward=lambda bk, q, v, c: bk.clip(q[0], 0.0, 1.0),
        time_limit=_HopTask.time_limit,
        observe=lambda bk, q, v: list(q) + list(v),
        n_obs=model.nq + model.nv,
    )


def _state(model):
    return (
        np.tile(np.asarray(model.qpos0, np.float32)[:, None], (1, B)),
        np.zeros((model.nv, B), np.float32),
        np.zeros((1, B), np.float32),
        np.zeros((model.nv, B), np.float32),
        np.zeros((1, B), np.float32),
    )


@pytest.fixture(scope="module")
def models():
    return (load_model_from_xml(HOPPER_XML, dtype=np.float32),
            ref_load_model_from_xml(HOPPER_XML, dtype=np.float32))


@pytest.fixture(scope="module")
def ctrl_run(models):
    """One reference call with emit_obs (it also returns the base
    outputs) and the port's plain version on the same inputs."""
    m, mr = models
    ctrl = np.random.default_rng(1).uniform(
        -1.0, 1.0, (K, m.nu, B)).astype(np.float32)
    kern = rmk.build_rollout(mr, B, K, tile=B,
                             hooks=_HopTask().kernel_hooks(mr),
                             interpret=True, emit_obs=True)
    ref = kern(*(jnp.asarray(a) for a in _state(mr)), jnp.asarray(ctrl),
               jnp.zeros((1,), jnp.int32))
    fn = mk.build_rollout(m, B, K, _port_hooks(m), emit_obs=True)
    out = fn(*convert.state_from_numpy(_state(m), "cpu"),
             torch.as_tensor(ctrl), torch.zeros(1, dtype=torch.int32))
    return [np.asarray(x) for x in ref], [x.numpy() for x in out]


def test_rollout_matches_reference(ctrl_run):
    ref, out = ctrl_run
    assert ref[9].sum() > 0, "the time limit resets envs inside the window"
    np.testing.assert_allclose(out[0], ref[0], rtol=0, atol=1e-4)  # qpos
    np.testing.assert_allclose(out[1], ref[1], rtol=0, atol=1e-3)  # qvel
    np.testing.assert_allclose(out[4], ref[4], rtol=0, atol=1e-5)  # time
    np.testing.assert_allclose(out[5], ref[5], rtol=0, atol=1e-4)  # reward
    np.testing.assert_array_equal(out[6], ref[6])                  # diverged


def test_rollout_obs_trajectory_matches_reference(ctrl_run):
    ref, out = ctrl_run
    np.testing.assert_allclose(out[7], ref[7], rtol=0, atol=1e-4)  # obs
    np.testing.assert_allclose(out[8], ref[8], rtol=0, atol=1e-4)  # rewards
    np.testing.assert_array_equal(out[9], ref[9])                  # dones
    np.testing.assert_allclose(out[5][0], out[8].sum(axis=0), rtol=0,
                               atol=1e-4)


def test_state_numpy_round_trip(models):
    m, _ = models
    arrays = _state(m)
    back = convert.state_to_numpy(convert.state_from_numpy(arrays, "cpu"))
    for a, b in zip(arrays, back):
        np.testing.assert_array_equal(a, b)
