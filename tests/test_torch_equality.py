"""PyTorch port: equality rows (connect, weld, joint, tendon) and runtime
eq_active.

Each model is compiled by both packages and stepped twice in f64 by the
port's torch backend and the reference ``build_step``, with ``eq_act``
lanes, within 1e-8 on q, v and the warmstart.  The states start with the
equalities violated (qpos0 +- 0.1).  These seeds meet no line-search tie
(ROADMAP Queue C): a 1e-14 relative nudge of qpos moves the port's own
result by at most ~1e-11 in the warmstart.  The forward-mode tangent
(``Dual``) is held against ``jax.jvp`` of the reference's row velocities
within 1e-12.
"""

import dataclasses
import inspect
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import test_scalar_graph as rtests
from oxide_control_tpu.mjcf.compile import (
    load_model_from_xml as ref_load_model_from_xml,
)
from oxide_control_tpu.ops import scalar_graph as rsg
from oxide_control_tpu.physics import smooth as rsmooth

from oxide_control_torch import bench_configs, convert
from oxide_control_torch.mjcf.compile import load_model_from_xml
from oxide_control_torch.ops import scalar_graph as sg
from oxide_control_torch.parallel.rollout import FastRollout
from oxide_control_torch.physics import smooth

B = 8


def _xml_of(test_fn):
    return re.search(r'xml = """(.*?)"""', inspect.getsource(test_fn),
                     re.S).group(1)


FOURBAR = bench_configs.FOURBAR_XML
XMLS = {
    "fourbar": FOURBAR,
    # the connect inactive at build time, turned on in half the envs
    "fourbar_inactive": FOURBAR.replace(
        'anchor="0.4 0 0"/>', 'anchor="0.4 0 0" active="false"/>'),
    "joint_single": FOURBAR.replace(
        '<connect body1="link2" body2="anchor" anchor="0.4 0 0"/>', ""
    ).replace('joint2="b1" polycoef="0 0.5 0.1 0 0"',
              'polycoef="0.2 0 0 0 0"'),
    "connect_world": FOURBAR.replace('body2="anchor" anchor', "anchor"),
    "tendon": _xml_of(rtests.test_tendon_equality_scalar_graph),
    "weld": _xml_of(rtests.test_equality_weld_scalar_graph).replace(
        '<joint type="ball" damping="0.05"/>', "<freejoint/>"),
}
XMLS["tendon_single"] = XMLS["tendon"].replace(
    'tendon2="tB" polycoef="0 0.8 0.2 0 0"', 'polycoef="0.1 0 0 0 0"')


def _state(m, seed):
    rng = np.random.default_rng(seed)
    qpos = np.tile(np.asarray(m.qpos0), (B, 1)) + rng.uniform(
        -0.1, 0.1, (B, m.nq))
    for j in range(m.njnt):
        if m.jnt_type[j] == 0:  # free: a unit quaternion
            a = m.jnt_qposadr[j] + 3
            qpos[:, a:a + 4] /= np.linalg.norm(qpos[:, a:a + 4], axis=1,
                                               keepdims=True)
    return qpos, rng.uniform(-1, 1, (B, m.nv)), rng.uniform(-1, 1,
                                                           (B, m.nu))


def _stack(xs):
    return np.stack([np.broadcast_to(np.asarray(x), (B,)) for x in xs], 1)


def step_parity(xml, eq, seed=0, nsteps=2):
    """Two f64 steps of port and reference from one state; ``eq`` is
    (B, neq) 0/1 or None (the equalities active at build time)."""
    m, mr = load_model_from_xml(xml), ref_load_model_from_xml(xml)
    assert sg.unsupported_reason(m) is None
    qpos, qvel, ctrl = _state(m, seed)
    ws, act = np.zeros((B, m.nv)), np.zeros((B, m.na))
    cols = lambda a, f: [f(a[:, i]) for i in range(a.shape[1])]
    q, v, a, w, c = (cols(x, torch.tensor) for x in (qpos, qvel, act, ws,
                                                     ctrl))
    qr, vr, ar, wr, cr = (cols(x, jnp.asarray) for x in (qpos, qvel, act,
                                                         ws, ctrl))
    ea = None if eq is None else [torch.tensor(eq[:, e] != 0)
                                  for e in range(m.neq)]
    kw = {} if eq is None else dict(eq_act=[jnp.asarray(eq[:, e] != 0)
                                            for e in range(m.neq)])
    step = sg.build_step(m, sg.TorchBackend(B, torch.float64, "cpu"))
    step_ref = rsg.build_step(mr)
    for _ in range(nsteps):
        q, v, a, w = step(q, v, a, w, c, ea)
        qr, vr, ar, wr = step_ref(qr, vr, ar, wr, cr, **kw)[:4]
        for got, want in ((q, qr), (v, vr), (w, wr)):
            np.testing.assert_allclose(_stack(got), _stack(want), rtol=0,
                                       atol=1e-8)


@pytest.mark.parametrize("name,lanes", [
    ("fourbar", "on"), ("fourbar", None), ("fourbar_inactive", "half"),
    ("joint_single", "on"), ("connect_world", "on"), ("tendon", "on"),
    ("tendon_single", "on"), ("weld", "on"),
])
def test_torch_backend_matches_reference_step(name, lanes):
    m = load_model_from_xml(XMLS[name])
    eq = None
    if lanes is not None:
        eq = np.ones((B, m.neq))
        if lanes == "half":
            eq[::2, 0] = 0.0
    step_parity(XMLS[name], eq)


@pytest.mark.parametrize("name", ["fourbar", "weld"])
def test_dual_tangent_matches_jax_jvp(name):
    """Each connect/weld row's J qvel and its time derivative Jdot qvel,
    from the port's Dual FK, against jax.jvp of the reference's rows."""
    xml = XMLS[name]
    m, mr = load_model_from_xml(xml), ref_load_model_from_xml(xml)
    qpos, qvel, _ = _state(m, 3)
    cw = [e for e in range(m.neq) if m.eq_type[e] in (0, 1)]
    mc, mcr = sg._ModelConsts(m), rsg._ModelConsts(mr)
    bk = sg.TorchBackend(B, torch.float64, "cpu")
    q = [torch.tensor(qpos[:, i]) for i in range(m.nq)]
    v = [torch.tensor(qvel[:, i]) for i in range(m.nv)]
    fk_d = sg._fk_chain(sg.DualBackend(bk), m, mc, smooth.subtree_mask(m),
                        sg._qpos_duals(m, q, v))
    rows = sg._eq_cw_rows_sg(m, mc, fk_d, smooth.body_dof_mask(m), cw)
    vel = [sg._jdotv(J, v) for e in cw for (J, _, _) in rows[e]]
    acc = sg.tangents(vel)
    vel = [sg._primal(x) for x in vel]

    sub_r, bd_r = rsmooth.subtree_mask(mr), rsmooth.body_dof_mask(mr)
    vr = [jnp.asarray(qvel[:, i]) for i in range(m.nv)]

    def rowvels(qp):
        fk = rsg._fk_chain(mr, mcr, sub_r, list(qp))
        rr = rsg._eq_cw_rows_sg(mr, mcr, fk, bd_r)
        return tuple(rsg._jdotv(J, vr) for e in cw for (J, _, _) in rr[e])

    qr = tuple(jnp.asarray(qpos[:, i]) for i in range(m.nq))
    qd = tuple(rsg._qpos_tangent_sg(mr, list(qr), vr))
    want_v, want_a = jax.jvp(rowvels, (qr,), (qd,))
    np.testing.assert_allclose(_stack(vel), _stack(want_v), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(_stack(acc), _stack(want_a), rtol=0,
                               atol=1e-12)
    assert np.abs(_stack(acc)).max() > 1e-3  # the term is not trivially 0


def test_fastrollout_eq_active_on_the_cpu():
    """FastRollout.run takes eq_active (B, neq) for fourbar (default
    eq_active0), raises for a wrong shape and for a model without
    equality."""
    benv = bench_configs.load_config("fourbar", "equality", B,
                                     device="cpu")
    roll = FastRollout(benv, 4)
    gen = torch.Generator().manual_seed(0)
    state = roll.init(gen)
    st_def, _ = roll.run(state, torch.Generator().manual_seed(1))
    on = torch.ones((B, 2))
    st_on, _ = roll.run(state, torch.Generator().manual_seed(1), on)
    assert all(torch.equal(a, b) for a, b in zip(st_def, st_on))
    off = on.clone()
    off[::2, 0] = 0.0
    st_off, traj = roll.run(state, torch.Generator().manual_seed(1), off)
    assert bool(torch.isfinite(traj.reward_sum).all())
    assert not torch.equal(st_off[0][:, ::2], st_on[0][:, ::2])
    assert torch.equal(st_off[0][:, 1::2], st_on[0][:, 1::2])
    with pytest.raises(ValueError, match="shape"):
        roll.run(state, gen, torch.ones((B, 3)))
    arms = FastRollout(bench_configs.load_config(
        "arms", "self-collide", B, device="cpu"), 2)
    with pytest.raises(ValueError, match="without equality"):
        arms.run(arms.init(gen), gen, torch.ones((B, 1)))
    assert convert.eq_active_from_kernel(
        convert.eq_active_to_kernel(off)).eq(off != 0).all()


def test_bench_configs_copy_the_reference_bench():
    """The XMLs, cheetah-run-elliptic built as bench.py:426-433 builds
    it (the suite's cheetah with elliptic cones) and
    walker-walk-tendon-sensors as bench.py:435-468 builds it (walker
    with the knee coupler and the torso IMU, the sensors observed), every
    field equal."""
    from oxide_control_tpu.model import ConeType as RefConeType
    from oxide_control_tpu.suite import cheetah as ref_cheetah
    from test_torch_model import _assert_models_equal

    assert bench_configs.FOURBAR_XML == bench._FOURBAR_XML
    assert bench_configs.ARMS_XML == bench._ARMS_XML
    assert bench_configs.CABLE_XML == bench._CABLE_XML
    ref, _ = ref_cheetah.run(dtype=np.float32)
    ref = ref.replace(opt=dataclasses.replace(ref.opt,
                                              cone=RefConeType.ELLIPTIC))
    _assert_models_equal(bench_configs.cheetah_run_elliptic()[0], ref)
    ref_env = bench.load_config("walker", "walk-tendon-sensors", 8)
    model, task = bench_configs.walker_walk_tendon_sensors()
    _assert_models_equal(model, ref_env.model)
    hooks = task.kernel_hooks(model)
    ref_hooks = ref_env.task.kernel_hooks(ref_env.model)
    assert hooks.needs_sensors and ref_hooks.needs_sensors
    assert hooks.n_obs == ref_hooks.n_obs == 17 + model.nsensordata
