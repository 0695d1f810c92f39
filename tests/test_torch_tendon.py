"""PyTorch port: stateful and muscle actuators, fixed and spatial tendons
(sphere and cylinder wraps, pulleys) and friction loss.

The reference's own models of these features (the XMLs of
tests/test_scalar_graph.py's stateful, tendon-friction-loss, tendon/site
transmission, muscle and pulley tests, test_golden's spatial-tendon and
wrapped arms, and bench.py's arm-muscle-wrap) are compiled by both
packages and must agree field for field; the port's torch backend then
steps them in f64 against the reference ``build_step`` within 1e-8 on q,
v, act and the warmstart; so are a motor on a free joint and the
tendon-friction-loss model started with its limited tendon past its range
(the tendon-limit rows active).  The seeds' steps meet no line-search tie
(ROADMAP Queue C): with these inputs the two agree to 5.7e-14 over the
two steps.  The inside-sidesite regime of the wrap (the tournament and
golden section), which none of those models reaches, is held against the
reference's wrap function directly, and a sidesite whose side the model
fixes (on the wrap geom's body) against the per-lane test.
"""

import inspect
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import chip_smoke
import test_golden
import test_scalar_graph as rtests
from oxide_control_tpu.mjcf.compile import (
    load_model_from_xml as ref_load_model_from_xml,
)
from oxide_control_tpu.ops import scalar_graph as rsg
from test_torch_model import _assert_models_equal
from test_torch_scalar_graph import FREE_SPHERE

from oxide_control_torch import bench_configs
from oxide_control_torch.mjcf.compile import load_model_from_xml
from oxide_control_torch.ops import scalar_graph as sg
from oxide_control_torch.parallel.rollout import FastRollout

B = 8


def _xml_of(test_fn):
    """The ``xml = \"\"\"...\"\"\"`` literal of a reference test."""
    return re.search(r'xml = """(.*?)"""', inspect.getsource(test_fn),
                     re.S).group(1)


XMLS = {
    "stateful": _xml_of(rtests.test_stateful_actuators_scalar_graph),
    "tendon_frictionloss": _xml_of(
        rtests.test_tendon_frictionloss_scalar_graph),
    "tendon_site": _xml_of(rtests.test_tendon_site_transmission_scalar_graph),
    "muscle": _xml_of(rtests.test_muscle_scalar_graph),
    "spatial": test_golden.SPATIAL_TENDON_XML,
    "pulley": _xml_of(rtests.test_spatial_tendon_pulley_scalar_graph),
    "wrap_arm": test_golden.WRAP_ARM_XML,
    "arm": bench._MUSCLE_WRAP_XML,
    # a motor on a free joint: a force along z and a torque about it
    "free_motor": FREE_SPHERE.format(stiffness=0.0).replace(
        '<joint type="free"', '<joint name="root" type="free"').replace(
        "</mujoco>", '<actuator><motor joint="root" gear="0 0 1 0 0 0.5"/>'
        "</actuator></mujoco>"),
}
# step cases: each XML from qpos0 +- 0.1, and the tendon-friction-loss
# model with h1 = +-0.5, which puts lim_t (h1 + 0.5 h2, range +-0.4) past
# either end of its range
STEP_CASES = list(XMLS) + ["tendon_limit"]


@pytest.mark.parametrize("name,dtype", [(n, np.float64) for n in XMLS]
                         + [("arm", np.float32)])
def test_model_matches_reference(name, dtype):
    """Every field, the compiled ones (actuator_acc0 and lengthrange,
    tendon_length0, invweight0 and lengthspring) included."""
    _assert_models_equal(load_model_from_xml(XMLS[name], dtype=dtype),
                         ref_load_model_from_xml(XMLS[name], dtype=dtype))


@pytest.mark.parametrize("name", list(XMLS))
def test_supported(name):
    assert sg.unsupported_reason(load_model_from_xml(XMLS[name])) is None


def _cols(a, mod):
    return [mod(a[:, i]) for i in range(a.shape[1])]


def _stack(xs):
    return np.stack([np.asarray(x) for x in xs], axis=1)


@pytest.mark.parametrize("name", STEP_CASES)
def test_torch_backend_matches_reference_step(name):
    """Two f64 steps from a random state with random activations (the
    reference step is eager jnp, 0.3-0.8 s a step here)."""
    xml = XMLS["tendon_frictionloss" if name == "tendon_limit" else name]
    m, mr = load_model_from_xml(xml), ref_load_model_from_xml(xml)
    rng = np.random.default_rng(0)
    qpos = np.tile(np.asarray(m.qpos0), (B, 1)) + rng.uniform(
        -0.1, 0.1, (B, m.nq))
    if name == "tendon_limit":
        qpos[:, 0] = np.where(np.arange(B) % 2, 0.5, -0.5)
        lim = qpos[:, 0] + 0.5 * qpos[:, 1]
        assert (np.abs(lim) > 0.4).all()
    if name == "free_motor":
        qpos[:, 3:] /= np.linalg.norm(qpos[:, 3:], axis=1, keepdims=True)
    qvel = rng.uniform(-1, 1, (B, m.nv))
    ctrl = rng.uniform(-1, 1, (B, m.nu))
    act = rng.uniform(-0.3, 0.3, (B, m.na))
    ws = np.zeros((B, m.nv))
    step = sg.build_step(m, sg.TorchBackend(B, torch.float64, "cpu"))
    step_ref = rsg.build_step(mr)
    q, v, a, w, c = (_cols(x, torch.tensor)
                     for x in (qpos, qvel, act, ws, ctrl))
    qr, vr, ar, wr, cr = (_cols(x, jnp.asarray)
                          for x in (qpos, qvel, act, ws, ctrl))
    for _ in range(2):
        q, v, a, w = step(q, v, a, w, c)
        qr, vr, ar, wr = step_ref(qr, vr, ar, wr, cr)
        for got, want in ((q, qr), (v, vr), (a, ar), (w, wr)):
            if want:
                np.testing.assert_allclose(_stack(got), _stack(want),
                                           rtol=0, atol=1e-8)


@pytest.mark.parametrize("kind,side", [
    ("sphere", "inside"), ("cylinder", "inside"), ("sphere", "outside"),
])
def test_wrap_segment_matches_reference(kind, side):
    """``_wrap_segment_sg`` (and through it ``_wrap_circle2d_sg``) in f64
    against the reference's, with sidesites inside the wrap geom (the
    tournament and golden-section regime) and outside it.

    Outside, the two agree to 1e-12.  Inside, the touch point is the argmin
    of a path length that is flat at its minimum: a relative change of
    eps ~ 1e-16 in the length moves the golden section's answer by about
    sqrt(eps) ~ 1e-8 rad, and the two differ by one rounding in some
    inputs (torch takes ``r2 / sq`` as a reciprocal and a multiply), so
    the bar there is 1e-8 x radius."""
    rng = np.random.default_rng(11)
    radius = 0.05
    gpos = tuple(rng.uniform(-0.1, 0.1, 3))
    q = rng.normal(size=4)
    gmat = tuple(float(x) for x in sg.quat_to_mat(
        tuple(q / np.linalg.norm(q))))
    p1 = rng.uniform(-0.3, 0.3, (3, B)) + np.asarray(gpos)[:, None]
    p2 = rng.uniform(-0.3, 0.3, (3, B)) + np.asarray(gpos)[:, None]
    scale = 0.5 * radius if side == "inside" else 2.0 * radius
    dirs = rng.normal(size=(3, B))
    side_w = np.asarray(gpos)[:, None] + scale * dirs / np.linalg.norm(
        dirs, axis=0)
    is_cyl = kind == "cylinder"
    bk = sg.TorchBackend(B, torch.float64, "cpu")
    T = lambda a: tuple(torch.tensor(x) for x in a)
    J = lambda a: tuple(jnp.asarray(x) for x in a)
    got = sg._wrap_segment_sg(bk, T(p1), T(p2), gpos, gmat, radius, is_cyl,
                              T(side_w))
    want = rsg._wrap_segment_sg(
        J(p1), J(p2), gpos, gmat, radius, is_cyl, J(side_w),
        lambda x: jnp.full((B,), float(x)) if rsg._is_const(x) else x)
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(
            np.stack([np.broadcast_to(np.asarray(x), (B,)) for x in
                      (g if isinstance(g, tuple) else (g,))]),
            np.stack([np.broadcast_to(np.asarray(x), (B,)) for x in
                      (w if isinstance(w, tuple) else (w,))]),
            rtol=0, atol=1e-8 * radius if side == "inside" else 1e-12)


@pytest.mark.parametrize("kind,side", [
    ("sphere", "inside"), ("sphere", "outside"), ("cylinder", "inside"),
    ("cylinder", "outside"),
])
def test_fixed_sidesite_side_matches_per_lane_test(kind, side):
    """A wrap whose sidesite side is a build-time constant (the sidesite on
    the geom's body) builds only that regime, and gives what the per-lane
    test gives, bit for bit."""
    rng = np.random.default_rng(13)
    radius = 0.05
    gpos = tuple(rng.uniform(-0.1, 0.1, 3))
    q = rng.normal(size=4)
    gmat = tuple(float(x) for x in sg.quat_to_mat(
        tuple(q / np.linalg.norm(q))))
    p1 = rng.uniform(-0.3, 0.3, (3, B)) + np.asarray(gpos)[:, None]
    p2 = rng.uniform(-0.3, 0.3, (3, B)) + np.asarray(gpos)[:, None]
    # the sidesite in the geom's frame, at 0.5 or 2 radii from its axis
    # (cylinder) or center (sphere)
    scale = 0.5 * radius if side == "inside" else 2.0 * radius
    loc = rng.normal(size=(3, B))
    if kind == "cylinder":
        loc[:2] *= scale / np.linalg.norm(loc[:2], axis=0)
    else:
        loc *= scale / np.linalg.norm(loc, axis=0)
    side_w = np.asarray(gpos)[:, None] + np.asarray(gmat).reshape(3, 3) @ loc
    bk = sg.TorchBackend(B, torch.float64, "cpu")
    T = lambda a: tuple(torch.tensor(x) for x in a)
    args = (bk, T(p1), T(p2), gpos, gmat, radius, kind == "cylinder",
            T(side_w))
    per_lane = sg._wrap_segment_sg(*args)
    fixed = sg._wrap_segment_sg(*args, side == "inside")
    flat = lambda r: [bk.full(x) for x in (r[0], *r[1], *r[2], r[3])]
    assert all(torch.equal(a, b) for a, b in zip(flat(fixed),
                                                 flat(per_lane)))


@pytest.mark.parametrize("pside,want", [
    ('<site name="pside" pos="0.3 0 0.08"/>', False),  # the bench's arm
    ('<site name="pside" pos="0.3 0 0.02"/>', True),
    ('<site name="pside" pos="0.3 0 0.0502"/>', None),  # on the surface
    (None, None),                                 # on another body
])
def test_sidesite_side_folds_at_build_time(pside, want):
    """``_sidesite_inside`` on the arm: a sidesite on the wrap geom's body
    and clear of its surface fixes the regime; near the surface, or on
    another body, the step tests it per lane."""
    xml = bench._MUSCLE_WRAP_XML
    site = '<site name="pside" pos="0.3 0 0.08"/>'
    if pside is None:
        xml = xml.replace(site, "").replace(
            '<site name="tip"', '<site name="pside" pos="0 0 0.08"/>\n'
            '        <site name="tip"')
    else:
        xml = xml.replace(site, pside)
    m = load_model_from_xml(xml, dtype=np.float64)
    side, g = m.name2id("site", "pside"), m.name2id("geom", "pulleyg")
    assert sg._sidesite_inside(m, sg._ModelConsts(m), side, g) is want


def test_sphere_sphere_narrowphase_matches_reference():
    """The pulley XML's sphere-sphere pair: distance, point and normal,
    coincident centers (the fallback normal) included."""
    rng = np.random.default_rng(12)
    p1, p2 = rng.uniform(-1, 1, (3, B)), rng.uniform(-1, 1, (3, B))
    p2[:, 0] = p1[:, 0]
    bk = sg.TorchBackend(B, torch.float64, "cpu")
    got = sg._np_sphere_sphere_sg(bk, tuple(torch.tensor(x) for x in p1),
                                  0.05, tuple(torch.tensor(x) for x in p2),
                                  0.08)
    want = rsg._np_sphere_sphere_sg(tuple(jnp.asarray(x) for x in p1), 0.05,
                                    tuple(jnp.asarray(x) for x in p2), 0.08)
    flat = lambda r: np.stack([np.broadcast_to(np.asarray(x), (B,)) for x in
                               (r[0], *r[1], *r[2])])
    np.testing.assert_allclose(flat(got), flat(want), rtol=0, atol=1e-14)


def test_bench_configs_copy_the_reference_bench():
    """The arm XML is bench.py's; the smoke's stateful XML is the reference
    test's; its walker tendon is bench.py's knee coupler without its
    sensors."""
    assert bench_configs.MUSCLE_WRAP_XML == bench._MUSCLE_WRAP_XML
    assert chip_smoke.STATEFUL_XML == XMLS["stateful"]
    tendon = chip_smoke.WALKER_TENDON.split("</tendon>")[0]
    assert tendon.strip() and tendon in inspect.getsource(bench.load_config)
    m = chip_smoke.walker_tendon_env(B, device="cpu").model
    assert m.ntendon == 1
    assert m.tendon_frictionloss[0] == np.float32(0.05)
    assert sg.supports(m)
    assert sg.supports(chip_smoke.stateful_env(B, device="cpu").model)


def test_arm_fastrollout_on_the_cpu():
    """The bench task's reset (qpos0 + U(-0.05, 0.05)) and one K = 8 call
    of FastRollout on the CPU (the plain version): the muscle's activation
    starts at 0 and stays inside [0, 1]."""
    benv = bench_configs.load_config("arm", "muscle-wrap", B, device="cpu")
    roll = FastRollout(benv, 8)
    gen = torch.Generator().manual_seed(0)
    state = roll.init(gen)
    q0 = torch.as_tensor(np.asarray(benv.model.qpos0), dtype=torch.float32)
    assert float((state[0] - q0[:, None]).abs().max()) <= 0.05
    assert tuple(state[2].shape) == (1, B) and not state[2].any()
    state, traj = roll.run(state, gen)
    assert roll.kernel.launches == 0
    assert bool(torch.isfinite(traj.reward_sum).all())
    assert bool(((state[2] >= 0.0) & (state[2] <= 1.0)).all())
    assert float(state[2].max()) > 0.0
