"""PyTorch port: the scalar-graph step on the torch backend.

The torch backend (the kernel's plain version) against the reference
``build_step`` run eagerly, in f64, and the quaternion helpers against the
reference's; the emitted C is checked in test_torch_emit.py and the
humanoid in test_torch_humanoid.py.

The bar is 1e-8 on q, v and the warmstart.  The reference's line search
is a fixed doubling + bisection grid, so a Newton step whose root sits
exactly on a grid point (alpha = 1 after a converged step) is decided by
the last bit of ``dphi``: there a 1e-15 difference moves qacc by
2^-25 |p| (ROADMAP Queue C).  The walker's inputs are a seed whose five
steps meet no such tie.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oxide_control_tpu.mjcf.compile import (
    load_model_from_xml as ref_load_model_from_xml,
)
from oxide_control_tpu.ops import scalar_graph as rsg
from oxide_control_tpu.suite.common import load_asset as ref_load_asset
from test_megakernel import _XML as HOPPER_XML

from oxide_control_torch.mjcf.compile import load_model_from_xml
from oxide_control_torch.ops import scalar_graph as sg
from oxide_control_torch.suite.common import load_asset

B = 8
# the free sphere of tests/test_megakernel.py::test_free_joint_megakernel_
# interpret (it falls into contact within the 10 steps); the sprung variant
# exercises the free joint's linear and quaternion springs
FREE_SPHERE = """
<mujoco>
  <option timestep="0.01" solver="Newton" iterations="4" tolerance="0"/>
  <worldbody>
    <geom name="floor" type="plane" size="3 3 .1"/>
    <body name="ball" pos="0 0 0.12">
      <joint type="free" stiffness="{stiffness}"/>
      <geom name="b" type="sphere" size="0.1" mass="0.5"/>
    </body>
  </worldbody>
</mujoco>
"""
SPINS = np.array([[0.2, 0.0, -0.3, 2.0, 1.0, 0.5],
                  [-0.1, 0.15, 0.1, -1.0, 3.0, -2.0]])
# bring feet (cheetah: rootz) / the ball (hopper: z) into contact range
CONTACT_SHIFT = {"cheetah": 1, "hopper": 0}
SEEDS = {"walker": 6}


def _models(name):
    if name == "hopper":
        return (load_model_from_xml(HOPPER_XML),
                ref_load_model_from_xml(HOPPER_XML))
    if name.startswith("free_sphere"):
        xml = FREE_SPHERE.format(stiffness=2.0 if "spring" in name else 0.0)
        return load_model_from_xml(xml), ref_load_model_from_xml(xml)
    return load_asset(name), ref_load_asset(name)


def _inputs(name, m, seed):
    """(qpos, qvel, ws, ctrl), each (batch, n)."""
    if name.startswith("free_sphere"):
        b = len(SPINS)
        return (np.tile(np.asarray(m.qpos0), (b, 1)), SPINS,
                np.zeros((b, m.nv)), np.zeros((b, m.nu)))
    rng = np.random.default_rng(SEEDS.get(name, seed))
    qpos = np.tile(np.asarray(m.qpos0), (B, 1)) + rng.uniform(
        -0.1, 0.1, (B, m.nq))
    if name in CONTACT_SHIFT:
        qpos[:, CONTACT_SHIFT[name]] -= 0.3
    qvel = rng.uniform(-1, 1, (B, m.nv))
    ctrl = rng.uniform(-1, 1, (B, m.nu))
    ws = np.zeros((B, m.nv))
    return qpos, qvel, ws, ctrl


def _cols(a, mod):
    return [mod(a[:, i]) for i in range(a.shape[1])]


def _stack(xs):
    return np.stack([np.asarray(x) for x in xs], axis=1)


@pytest.mark.parametrize("name,nsteps", [
    ("cheetah", 5), ("hopper", 10), ("walker", 5), ("cartpole", 10),
    ("pendulum", 10), ("free_sphere", 10), ("free_sphere_spring", 10),
])
def test_torch_backend_matches_reference_step(name, nsteps):
    """Euler (cheetah, hopper, walker), RK4 (cartpole, pendulum) and the
    free joint (the sphere: quaternion FK, free cdof and velocity stage,
    manifold integration, springs)."""
    m, mr = _models(name)
    qpos, qvel, ws, ctrl = _inputs(name, m, seed=0)
    b = len(qpos)
    step = sg.build_step(m, sg.TorchBackend(b, torch.float64, "cpu"))
    step_ref = rsg.build_step(mr)
    T = lambda a: _cols(a, torch.tensor)
    J = lambda a: _cols(a, jnp.asarray)
    q, v, w, c = T(qpos), T(qvel), T(ws), T(ctrl)
    qr, vr, wr, cr = J(qpos), J(qvel), J(ws), J(ctrl)
    ar = [jnp.zeros(b) for _ in range(mr.na)]
    for _ in range(nsteps):
        q, v, _, w = step(q, v, [], w, c)
        qr, vr, ar, wr = step_ref(qr, vr, ar, wr, cr)
        np.testing.assert_allclose(_stack(q), _stack(qr), rtol=0, atol=1e-8)
        np.testing.assert_allclose(_stack(v), _stack(vr), rtol=0, atol=1e-8)
        np.testing.assert_allclose(_stack(w), _stack(wr), rtol=0, atol=1e-8)


def _rand(rng, *shape):
    return rng.uniform(-1.0, 1.0, shape)


@pytest.mark.parametrize("fn", [
    "qmul", "qrot", "quat_to_mat", "qnormalize", "quat_integrate_scalar",
    "atan2_sg", "quat_sub_scalar", "axis_angle_quat",
])
def test_quat_helpers_match_reference(fn):
    rng = np.random.default_rng(4)
    bk = sg.TorchBackend(B, torch.float64, "cpu")
    q1, q2, v3 = _rand(rng, 4, B), _rand(rng, 4, B), _rand(rng, 3, B)
    T = lambda a: tuple(torch.tensor(x) for x in a)
    J = lambda a: tuple(jnp.asarray(x) for x in a)
    if fn == "qmul":
        got, want = sg.qmul(T(q1), T(q2)), rsg.qmul(J(q1), J(q2))
    elif fn == "qrot":
        got, want = sg.qrot(T(q1), T(v3)), rsg.qrot(J(q1), J(v3))
    elif fn == "quat_to_mat":
        got, want = sg.quat_to_mat(T(q1)), rsg.quat_to_mat(J(q1))
    elif fn == "qnormalize":
        got, want = sg.qnormalize(bk, T(q1)), rsg.qnormalize(J(q1))
    elif fn == "quat_integrate_scalar":
        got = sg.quat_integrate_scalar(bk, T(q1), T(v3), 0.01)
        want = rsg.quat_integrate_scalar(J(q1), J(v3), 0.01)
    elif fn == "atan2_sg":
        got = (sg.atan2_sg(bk, torch.tensor(v3[0]), torch.tensor(v3[1])),)
        want = (np.arctan2(v3[0], v3[1]),)
    elif fn == "quat_sub_scalar":
        got = sg.quat_sub_scalar(bk, T(q1), T(q2))
        want = rsg.quat_sub_scalar(J(q1), J(q2))
    else:
        got = sg.axis_angle_quat(bk, (0.0, 0.6, 0.8), torch.tensor(v3[0]))
        want = rsg.axis_angle_quat((0.0, 0.6, 0.8), jnp.asarray(v3[0]))
    np.testing.assert_allclose(
        np.stack([np.broadcast_to(np.asarray(x), (B,)) for x in got]),
        np.stack([np.broadcast_to(np.asarray(x), (B,)) for x in want]),
        rtol=0, atol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_stacked_dphi_is_bit_identical_to_per_row(dtype):
    """The torch backend's line-search derivative over (rows, B) stacks
    equals the per-row form the emitter writes, bit for bit, with constant
    and tensor coefficients mixed as the contact and limit rows give them,
    and friction-loss rows (box-bounded force) among them."""
    rng = np.random.default_rng(5)
    bk = sg.TorchBackend(B, dtype, "cpu")
    T = lambda *shape: torch.tensor(rng.normal(size=shape), dtype=dtype)
    rows = [dict(D=T(B) if i % 3 else 0.75,
                 exists=(T(B) > 0) if i % 4 else True) for i in range(9)]
    rows[2:2] = [dict(D=0.75, exists=True, kind="fri", floss=0.3),
                 dict(D=T(B).abs(), exists=True, kind="fri", floss=0.05)]
    rows.append(dict(D=2.5, exists=True, kind="fri", floss=1.0))
    jar = [T(B) for _ in rows]
    jp = [T(B) if i != 4 else 0.0 for i in range(len(rows))]
    d0, slope = T(B), T(B)
    stacked = sg._dphi_stacked(bk, rows, jar, jp, d0, slope)
    for alpha in (T(B), bk.full(0.0), bk.full(4.0 ** 12)):
        want = d0 + alpha * slope
        for r, jr, jpr in zip(rows, jar, jp):
            f_a, _ = sg._row_force_act(bk, r, jr + alpha * jpr)
            want = want - f_a * jpr
        assert torch.equal(stacked(alpha), want)
