"""PyTorch port: the humanoid (free root joint, 21 hinges, 17 contact
pairs) against the reference, in f64.

* one scalar-graph step on the torch backend against the reference
  ``build_step``, with the feet brought into contact, at 1e-8;
* ``build_fk`` (body positions and frames, site positions) against the
  reference's at 1e-12, on denormalized root quaternions.

The step's inputs are a seed whose Newton line searches meet no tie on
the bisection grid (see test_torch_scalar_graph.py and ROADMAP Queue C).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oxide_control_tpu.ops import scalar_graph as rsg
from oxide_control_tpu.suite.common import load_asset as ref_load_asset

from oxide_control_torch.ops import scalar_graph as sg
from oxide_control_torch.suite.common import load_asset

B = 4


@pytest.fixture(scope="module")
def models():
    return load_asset("humanoid"), ref_load_asset("humanoid")


def _cols(a, mod):
    return [mod(a[:, i]) for i in range(a.shape[1])]


def _stack(xs):
    return np.stack([np.broadcast_to(np.asarray(x), (B,)) for x in xs],
                    axis=1)


def _state(m, seed, unit_quat=True):
    rng = np.random.default_rng(seed)
    qpos = np.tile(np.asarray(m.qpos0), (B, 1))
    qvel = rng.uniform(-1, 1, (B, m.nv))
    qpos[:, 7:] += rng.uniform(-0.1, 0.1, (B, m.nq - 7))
    quat = rng.normal(size=(B, 4))
    quat[:, 0] += 4.0  # near upright
    if unit_quat:
        quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    qpos[:, 3:7] = quat
    qpos[:, 2] -= 0.25  # the feet into contact
    ctrl = rng.uniform(-1, 1, (B, m.nu))
    return qpos, qvel, ctrl


def test_humanoid_step_matches_reference(models):
    m, mr = models
    qpos, qvel, ctrl = _state(m, seed=2)
    ws = np.zeros((B, m.nv))
    step = sg.build_step(m, sg.TorchBackend(B, torch.float64, "cpu"))
    T = lambda a: _cols(a, torch.tensor)
    J = lambda a: _cols(a, jnp.asarray)
    q, v, _, w = step(T(qpos), T(qvel), [], T(ws), T(ctrl))
    qr, vr, _, wr = rsg.build_step(mr)(J(qpos), J(qvel), [], J(ws), J(ctrl))
    for got, want in ((q, qr), (v, vr), (w, wr)):
        np.testing.assert_allclose(_stack(got), _stack(want), rtol=0,
                                   atol=1e-8)


def test_humanoid_fk_matches_reference(models):
    m, mr = models
    qpos, _, _ = _state(m, seed=3, unit_quat=False)
    bk = sg.TorchBackend(B, torch.float64, "cpu")
    fk = sg.build_fk(m, bk)(_cols(qpos, torch.tensor))
    fk_r = rsg.build_fk(mr)(_cols(qpos, jnp.asarray))
    for key in ("xpos", "xmat", "site_xpos"):
        assert len(fk[key]) == len(fk_r[key]) > 1
        for got, want in zip(fk[key], fk_r[key]):
            np.testing.assert_allclose(_stack(got), _stack(want), rtol=0,
                                       atol=1e-12, err_msg=key)
