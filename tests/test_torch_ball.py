"""PyTorch port: ball joints and the reset noise on quaternion coordinates.

The reference's ball-joint models (tests/test_scalar_graph.py's limited,
sprung ball wrist, its actuators on a ball and a free joint, its weld to a
ball-jointed blob, and bench.py's cable) are stepped once in f64 by the
port's torch backend and the reference ``build_step`` and must agree
within 1e-8 on q, v and the warmstart.  The wrist starts past its 50
degree limit from quaternions off the unit sphere (scaled by 0.9-1.1, as
a reset with noise leaves them), under Euler and under RK4.  These seeds
meet no line-search tie (ROADMAP Queue C): a 1e-14 relative nudge of qpos
moves the port's own result by less than 1e-10.  The quaternion tangent
and the weld's forward-mode tangent are held against the reference's
within 1e-12, and the repaired reset against its formula.  The wrist's
rollout is not held against the reference's interpret-mode kernel here:
that build takes 95 s of XLA compile and 29 s of run on this class of CPU
(B = 8, K = 24), over the per-test budget; the kernel is held against
the plain version through resets on the card (chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oxide_control_tpu.mjcf.compile import (
    load_model_from_xml as ref_load_model_from_xml,
)
from oxide_control_tpu.ops import scalar_graph as rsg
from oxide_control_tpu.physics import smooth as rsmooth
from test_torch_equality import _stack
from test_torch_tendon import _xml_of
import test_scalar_graph as rtests

import chip_smoke
from oxide_control_torch import bench_configs, convert
from oxide_control_torch.mjcf.compile import load_model_from_xml
from oxide_control_torch.ops import megakernel as mk
from oxide_control_torch.ops import scalar_graph as sg
from oxide_control_torch.physics import smooth

B = 8

XMLS = {
    "ball_limit": chip_smoke.BALL_LIMIT_XML,
    "ball_limit_rk4": chip_smoke.BALL_LIMIT_XML.replace(
        '<option solver="Newton"', '<option integrator="RK4" '
        'solver="Newton"'),
    "ball_free": chip_smoke.BALL_FREE_XML,
    "weld_ball": chip_smoke.WELD_BALL_XML,
    "cable": bench_configs.CABLE_XML,
}


def _quat_joints(m):
    """qpos addresses of the ball and free joints' quaternions."""
    return [m.jnt_qposadr[j] + (3 if m.jnt_type[j] == 0 else 0)
            for j in range(m.njnt) if m.jnt_type[j] in (0, 1)]


def _state(m, seed, tilt=None):
    """qpos0 +- 0.1 with every quaternion a random rotation scaled by
    0.9-1.1 (off the unit sphere); ``tilt`` (radians) sets the rotation
    angles of the ball joints (else up to 0.3)."""
    rng = np.random.default_rng(seed)
    qpos = np.tile(np.asarray(m.qpos0), (B, 1)) + rng.uniform(
        -0.1, 0.1, (B, m.nq))
    for a in _quat_joints(m):
        axis = rng.normal(size=(B, 3))
        axis /= np.linalg.norm(axis, axis=1, keepdims=True)
        ang = rng.uniform(0.0, 0.3, B) if tilt is None else rng.uniform(
            *tilt, B)
        q = np.concatenate([np.cos(ang / 2)[:, None],
                            np.sin(ang / 2)[:, None] * axis], 1)
        qpos[:, a:a + 4] = q * rng.uniform(0.9, 1.1, (B, 1))
    return (qpos, rng.uniform(-3, 3, (B, m.nv)),
            rng.uniform(-1, 1, (B, m.nu)))


def step_parity(xml, seed=0, tilt=None, eq_on=False):
    m, mr = load_model_from_xml(xml), ref_load_model_from_xml(xml)
    assert sg.unsupported_reason(m) is None and rsg.supports(mr)
    qpos, qvel, ctrl = _state(m, seed, tilt)
    ws, act = np.zeros((B, m.nv)), np.zeros((B, m.na))
    cols = lambda a, f: [f(a[:, i]) for i in range(a.shape[1])]
    q, v, a, w, c = (cols(x, torch.tensor) for x in (qpos, qvel, act, ws,
                                                     ctrl))
    qr, vr, ar, wr, cr = (cols(x, jnp.asarray) for x in (qpos, qvel, act,
                                                         ws, ctrl))
    ea, kw = None, {}
    if eq_on:
        ea = [torch.ones(B, dtype=torch.bool) for _ in range(m.neq)]
        kw = dict(eq_act=[jnp.ones(B, bool) for _ in range(m.neq)])
    q, v, a, w = sg.build_step(m, sg.TorchBackend(B, torch.float64, "cpu"))(
        q, v, a, w, c, ea)
    qr, vr, ar, wr = rsg.build_step(mr)(qr, vr, ar, wr, cr, **kw)[:4]
    for got, want in ((q, qr), (v, vr), (w, wr)):
        np.testing.assert_allclose(_stack(got), _stack(want), rtol=0,
                                   atol=1e-8)
    return m, qpos


@pytest.mark.parametrize("name", ["ball_limit", "ball_limit_rk4"])
def test_ball_limit_spring_step_matches_reference(name):
    """Past the 50 degree limit (55-80 degrees): the limit rows exist."""
    m, qpos = step_parity(XMLS[name], seed=3, tilt=(0.96, 1.4))
    quat = qpos[:, 1:5] / np.linalg.norm(qpos[:, 1:5], axis=1,
                                         keepdims=True)
    angle = 2 * np.arctan2(np.linalg.norm(quat[:, 1:], axis=1), quat[:, 0])
    assert (np.degrees(angle) > 50).all()
    assert not np.allclose(np.linalg.norm(qpos[:, 1:5], axis=1), 1.0)


@pytest.mark.parametrize("name", ["ball_free", "weld_ball", "cable"])
def test_ball_models_step_match_reference(name):
    """Actuators on a ball joint (an affine bias reads its expmap length)
    and a free joint; the weld with its eq lanes on; the bench's cable
    (six ball joints, springs, a motor on the root ball)."""
    step_parity(XMLS[name], seed=1, eq_on=name == "weld_ball")


def test_ball_qpos_tangent_matches_reference():
    m = load_model_from_xml(XMLS["ball_free"])
    mr = ref_load_model_from_xml(XMLS["ball_free"])
    qpos, qvel, _ = _state(m, 5)
    got = sg._qpos_tangent_sg(m, [torch.tensor(qpos[:, i])
                                  for i in range(m.nq)],
                              [torch.tensor(qvel[:, i])
                               for i in range(m.nv)])
    want = rsg._qpos_tangent_sg(mr, [jnp.asarray(qpos[:, i])
                                     for i in range(m.nq)],
                                [jnp.asarray(qvel[:, i])
                                 for i in range(m.nv)])
    np.testing.assert_allclose(_stack(got), _stack(want), rtol=0,
                               atol=1e-12)


def test_weld_ball_dual_tangent_matches_jax_jvp():
    """The weld's rows J qvel and Jdot qvel from the port's Dual FK (the
    ball's quaternion normalized on the Duals) against jax.jvp of the
    reference's rows."""
    xml = XMLS["weld_ball"]
    m, mr = load_model_from_xml(xml), ref_load_model_from_xml(xml)
    qpos, qvel, _ = _state(m, 3)
    mc, mcr = sg._ModelConsts(m), rsg._ModelConsts(mr)
    bk = sg.TorchBackend(B, torch.float64, "cpu")
    q = [torch.tensor(qpos[:, i]) for i in range(m.nq)]
    v = [torch.tensor(qvel[:, i]) for i in range(m.nv)]
    fk_d = sg._fk_chain(sg.DualBackend(bk), m, mc, smooth.subtree_mask(m),
                        sg._qpos_duals(m, q, v))
    rows = sg._eq_cw_rows_sg(m, mc, fk_d, smooth.body_dof_mask(m), [0])
    vel = [sg._jdotv(J, v) for (J, _, _) in rows[0]]
    acc = sg.tangents(vel)
    vel = [sg._primal(x) for x in vel]

    sub_r, bd_r = rsmooth.subtree_mask(mr), rsmooth.body_dof_mask(mr)
    vr = [jnp.asarray(qvel[:, i]) for i in range(m.nv)]

    def rowvels(qp):
        fk = rsg._fk_chain(mr, mcr, sub_r, list(qp))
        rr = rsg._eq_cw_rows_sg(mr, mcr, fk, bd_r)
        return tuple(rsg._jdotv(J, vr) for (J, _, _) in rr[0])

    qr = tuple(jnp.asarray(qpos[:, i]) for i in range(m.nq))
    qd = tuple(rsg._qpos_tangent_sg(mr, list(qr), vr))
    want_v, want_a = jax.jvp(rowvels, (qr,), (qd,))
    np.testing.assert_allclose(_stack(vel), _stack(want_v), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(_stack(acc), _stack(want_a), rtol=0,
                               atol=1e-12)
    assert np.abs(_stack(acc)).max() > 1e-3


def test_reset_noise_on_quaternions():
    """env_spec takes reset noise on ball and free quaternion coordinates
    (the parent refused both with a ValueError); the plain version resets
    qpos to qpos0 + 0.05 uni, coordinate by coordinate, from the kernel's
    Philox values, without normalizing the quaternions."""
    for xml in (XMLS["ball_free"], XMLS["cable"]):
        m = load_model_from_xml(xml, np.float32)
        spec = mk.env_spec(m, bench_configs.BenchTask().kernel_hooks(m))
        assert spec.uamp == (0.05,) * m.nq
    m = load_model_from_xml(XMLS["ball_free"], np.float32)
    hooks = bench_configs.BenchTask().kernel_hooks(m)
    fn = mk.build_rollout(m, B, 1, hooks)
    h = np.float32(fn.spec.h)
    # every env is at its last step: the one step of the call resets it
    state = convert.state_from_numpy((
        np.tile(np.asarray(m.qpos0, np.float32)[:, None], (1, B)),
        np.zeros((m.nv, B), np.float32), np.zeros((1, B), np.float32),
        np.zeros((m.nv, B), np.float32),
        np.full((1, B), (fn.spec.limit_n - 1) * h, np.float32)), "cpu")
    seed = 4242
    out = fn(*state, torch.zeros((1, m.nu, B)),
             torch.tensor([seed], dtype=torch.int32))
    uni = mk.signed_unit(mk.philox_bits(
        seed, mk.SALT_RESET, 0, fn.spec.n_draws,
        torch.arange(B, dtype=torch.int64)), torch.float32)[:m.nq]
    want = torch.stack([fn.spec.qpos0[i] + 0.05 * uni[i]
                        for i in range(m.nq)])
    assert torch.equal(out[0], want)
    for a in _quat_joints(m):
        norms = out[0][a:a + 4].norm(dim=0)
        assert (norms - 1.0).abs().max() > 1e-3


def test_parity_models_copy_the_reference_tests():
    """chip_smoke.py's ball-joint models are the reference tests' own."""
    assert chip_smoke.BALL_LIMIT_XML == _xml_of(
        rtests.test_ball_limit_spring_scalar_graph)
    assert chip_smoke.BALL_FREE_XML == _xml_of(
        rtests.test_ball_free_actuators_scalar_graph)
    assert chip_smoke.WELD_BALL_XML == _xml_of(
        rtests.test_equality_weld_scalar_graph)
