"""PyTorch port, general path: the suite tasks' hooks on Data.

``observe``, ``reward`` and ``done`` of all ten suite tasks, the general
path's task layer, against the reference's on the same seeded states
(f64, kinematics current, times on both sides of each task's limit):
observations and rewards within 1e-10, dones equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_general_smooth import err, seeded

from oxide_control_torch import suite

@pytest.mark.parametrize("domain,task", [
    ("pendulum", "swingup"), ("cartpole", "balance"), ("cartpole", "swingup"),
    ("cheetah", "run"), ("walker", "stand"), ("walker", "walk"),
    ("walker", "run"), ("humanoid", "stand"), ("humanoid", "walk"),
    ("humanoid", "run")])
def test_suite_task_hooks_match_reference(domain, task):
    """observe, reward and done of every suite task on Data, f64 within
    1e-10, from seeded states (kinematics current, times on both sides
    of the limit)."""
    from oxide_control_tpu import suite as rsuite
    from oxide_control_tpu.physics import smooth as rsmooth
    from oxide_control_torch.physics import smooth as psmooth

    rm, rt = rsuite._REGISTRY[(domain, task)](dtype=np.float64)
    pm, pt = suite._REGISTRY[(domain, task)](dtype=np.float64)
    rd, pd = seeded(rm, pm, seed=6, qnoise=0.3, vnoise=2.0, b=6)
    time = np.float64(rt.time_limit) + np.array([-1, -1e-3, 0, 0, 1e-3, 1])
    rd = rd.replace(time=jnp.asarray(time))
    pd = pd.replace(time=torch.from_numpy(time))

    def hooks(d):
        d = rsmooth.kinematics(rm, d)
        obs = rt.observe(rm, d)
        return obs, rt.reward(rm, d, obs, d.ctrl), rt.done(rm, d, obs)

    robs, rrew, rdone = jax.jit(jax.vmap(hooks))(rd)
    pk = psmooth.kinematics(pm, pd)
    pobs = pt.observe(pm, pk)
    assert err(robs, pobs) < 1e-10
    assert err(rrew, pt.reward(pm, pk, pobs, pd.ctrl)) < 1e-10
    np.testing.assert_array_equal(np.asarray(rdone),
                                  pt.done(pm, pk, pobs).numpy())
