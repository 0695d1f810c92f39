"""PyTorch port: the in-kernel tanh-MLP policy, plain version against the
reference Pallas kernel (interpret mode) on the hopper model, with the
reference's weights carried across by ``convert`` (reference bars of
test_megakernel.py::test_megakernel_inkernel_policy)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oxide_control_tpu.ops import megakernel as rmk
from oxide_control_tpu.policy import MLPPolicy as RefMLPPolicy
from test_megakernel import _HopTask
from test_torch_rollout import B, K, _port_hooks, _state, models  # noqa: F401

from oxide_control_torch import convert
from oxide_control_torch.ops import megakernel as mk


@pytest.fixture(scope="module")
def policy_run(models):
    m, mr = models
    rpol = RefMLPPolicy(hidden=(8,))
    params = rpol.init_params(jax.random.PRNGKey(5), m.nq + m.nv, m.nu,
                              dtype=jnp.float32)
    kern = rmk.build_rollout(mr, B, K, tile=B,
                             hooks=_HopTask().kernel_hooks(mr),
                             interpret=True, emit_obs=True, policy=rpol)
    ref = kern(*(jnp.asarray(a) for a in _state(mr)),
               jnp.zeros((1,), jnp.int32),
               *[leaf for wb in params for leaf in wb])
    pol = convert.policy_params_from_numpy(
        [(np.asarray(w), np.asarray(b)) for w, b in params], "cpu")
    fn = mk.build_rollout(m, B, K, _port_hooks(m), emit_obs=True, policy=pol)
    out = fn(*convert.state_from_numpy(_state(m), "cpu"), None,
             torch.zeros(1, dtype=torch.int32), pol.kernel_params())
    return [np.asarray(x) for x in ref], [x.numpy() for x in out]


def test_rollout_policy_matches_reference(policy_run):
    ref, out = policy_run
    np.testing.assert_allclose(out[10], ref[10], rtol=0, atol=1e-5)  # ctrls
    np.testing.assert_allclose(out[8], ref[8], rtol=0, atol=1e-4)
    np.testing.assert_allclose(out[7], ref[7], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(out[9], ref[9])
    np.testing.assert_allclose(out[0], ref[0], rtol=0, atol=1e-4)
    np.testing.assert_allclose(out[1], ref[1], rtol=0, atol=1e-3)
