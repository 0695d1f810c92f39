"""PyTorch port: fluid forces, mocap poses and applied forces.

The reference tests' three models (tests/test_scalar_graph.py:959-985,
:1075-1099, :1158-1180; chip_smoke.py runs them as parity modes) are
compiled by both packages and stepped in f64 by the port's torch backend
and the reference's ``build_step`` within 1e-8 on q, v and the
warmstart: two Euler steps each, and one RK4 step of the mocap and the
applied-force models (four forward passes, each reading the inputs).
The mocap model steps with per-env mocap and eq_act lanes, the
applied-force model with qfrc_ext/xfrc_ext.  These seeds meet no
line-search tie (ROADMAP Queue C): a 1e-14 relative nudge of qpos moves
the port's own result by less than 1e-10.  The reference's eager step
takes 2-3 s per Euler pass on this class of CPU, so the RK4 cases take
one step.  ``build_fk`` and ``build_sensors`` with ``mocap=`` agree with
the reference's within 1e-12; the plain rollouts of the reference's
``test_megakernel_mocap_eq_runtime_inputs`` and
``test_fastrollout_applied_forces`` (tests/test_megakernel.py:720,
:793) agree with the reference's general path at its bars, qpos 2e-5
and qvel 2e-4 in f32 (the reference's interpret-mode kernel takes over
a minute to build here).
"""

import inspect
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_megakernel as rmk_tests
import test_scalar_graph as rtests
from oxide_control_tpu.mjcf.compile import (
    load_model_from_xml as ref_load_model_from_xml,
)
from oxide_control_tpu.ops import scalar_graph as rsg
from oxide_control_tpu.physics import forward as rfwd
from oxide_control_tpu.state import make_data as ref_make_data
from test_megakernel import _XML as HOPPER_XML
from test_torch_sensors import _PortHopTask

import chip_smoke
from oxide_control_torch import convert, suite
from oxide_control_torch.api.environment import BatchedEnvironment
from oxide_control_torch.mjcf.compile import load_model_from_xml
from oxide_control_torch.ops import megakernel as mk
from oxide_control_torch.ops import scalar_graph as sg
from oxide_control_torch.parallel.rollout import FastRollout

B = 8


def _xml_of(test_fn):
    return re.search(r'xml = """(.*?)"""', inspect.getsource(test_fn),
                     re.S).group(1)


XMLS = {
    "fluid": _xml_of(rtests.test_fluid_forces_scalar_graph),
    "mocap": _xml_of(rtests.test_mocap_eq_active_scalar_graph),
    "applied": _xml_of(rtests.test_applied_forces_scalar_graph),
}
# the mocap model with sensors that read the mocap body's frame
MOCAP_SENSORS = XMLS["mocap"].replace("</equality>", """</equality>
      <sensor>
        <framepos objtype="body" objname="target"/>
        <framequat objtype="xbody" objname="target" reftype="body"
                   refname="box"/>
        <framelinvel objtype="body" objname="box" reftype="xbody"
                     refname="target"/>
        <subtreecom body="target"/>
      </sensor>""")


def _cols(a, f=torch.tensor):
    return [f(a[:, i]) for i in range(a.shape[1])]


def _stack(xs):
    return np.stack([np.broadcast_to(np.asarray(x), (B,)) for x in xs], 1)


def _inputs(m, seed):
    """(qpos, qvel, {port lanes}, {reference lanes}) of one f64 step: qpos0
    +- 0.1 (free quaternions normalized), qvel in [-1, 1]; the mocap model
    gets per-env poses (within 0.1 of rest, random unit quaternions scaled
    off the unit sphere) and eq lanes cycling (1,0), (1,1), (0,0), (0,1);
    every model gets qfrc in [-0.5, 0.5] and xfrc in [-1, 1] per body."""
    rng = np.random.default_rng(seed)
    qpos = np.tile(np.asarray(m.qpos0), (B, 1)) + rng.uniform(
        -0.1, 0.1, (B, m.nq))
    for j in range(m.njnt):
        if m.jnt_type[j] == 0:
            a = m.jnt_qposadr[j] + 3
            qpos[:, a:a + 4] /= np.linalg.norm(qpos[:, a:a + 4], axis=1,
                                               keepdims=True)
    qvel = rng.uniform(-1, 1, (B, m.nv))
    lanes = {}
    if m.nmocap:
        pos = np.asarray(m.body_pos)[1] + rng.uniform(-0.1, 0.1, (B, 3))
        quat = rng.uniform(-1, 1, (B, 4))
        quat *= rng.uniform(0.9, 1.1, (B, 1)) / np.linalg.norm(
            quat, axis=1, keepdims=True)
        lanes["mocap"] = np.concatenate([pos, quat], 1)
        lanes["eq_act"] = np.tile([[1, 0], [1, 1], [0, 0], [0, 1]],
                                  (B // 4, 1)) != 0
    lanes["qfrc_ext"] = rng.uniform(-0.5, 0.5, (B, m.nv))
    lanes["xfrc_ext"] = rng.uniform(-1.0, 1.0, (B, 6 * m.nbody))
    return qpos, qvel, lanes


def _step_parity(name, integrator, seed, nsteps, applied):
    xml = XMLS[name].replace("<option ", f'<option integrator="{integrator}" ')
    m, mr = load_model_from_xml(xml), ref_load_model_from_xml(xml)
    assert sg.unsupported_reason(m) is None and rsg.supports(mr)
    qpos, qvel, lanes = _inputs(m, seed)
    if not applied:
        del lanes["qfrc_ext"], lanes["xfrc_ext"]
    kw = {k: _cols(x) for k, x in lanes.items()}
    kwr = {k: _cols(x, jnp.asarray) for k, x in lanes.items()}
    eqa = kw.pop("eq_act", None)
    ws = np.zeros((B, m.nv))
    q, v, w = (_cols(x) for x in (qpos, qvel, ws))
    qr, vr, wr = (_cols(x, jnp.asarray) for x in (qpos, qvel, ws))
    step = sg.build_step(m, sg.TorchBackend(B, torch.float64, "cpu"))
    step_ref = rsg.build_step(mr)
    for _ in range(nsteps):
        q, v, _, w = step(q, v, [], w, [], eqa, **kw)
        qr, vr, _, wr = step_ref(qr, vr, [], wr, [], **kwr)[:4]
        for got, want in ((q, qr), (v, vr), (w, wr)):
            np.testing.assert_allclose(_stack(got), _stack(want), rtol=0,
                                       atol=1e-8)


@pytest.mark.parametrize("name,integrator,nsteps", [
    ("fluid", "Euler", 2), ("mocap", "Euler", 2), ("applied", "Euler", 2),
    ("mocap", "RK4", 1), ("applied", "RK4", 1),
])
def test_step_matches_reference(name, integrator, nsteps):
    _step_parity(name, integrator, seed=0, nsteps=nsteps,
                 applied=name == "applied")


def test_fluid_block_needs_density_or_viscosity():
    """Wind alone exerts no force: the fluid block emits nothing without
    density and viscosity, and the fluid model's step differs from the
    still-air model's."""
    from oxide_control_torch.ops.emit import Emitter

    def ops(xml):
        m = load_model_from_xml(xml)
        em = Emitter("double")
        sg.build_step(m, em)(em.load("q", m.nq), em.load("v", m.nv), [],
                             em.load("w", m.nv), [])
        return em.ops

    wind_only = re.sub(r'density="[^"]*" viscosity="[^"]*" ', "",
                       XMLS["fluid"])
    still = re.sub(r'wind="[^"]*"', "", wind_only)
    assert "density" not in wind_only and "wind" not in still
    assert ops(wind_only) == ops(still) < ops(XMLS["fluid"])


def test_fk_and_sensors_with_mocap_match_reference():
    """build_fk and build_sensors with per-env mocap poses (quaternions
    off the unit sphere) within 1e-12 of the reference's; without
    ``mocap`` the bodies keep their rest pose."""
    m, mr = (f(MOCAP_SENSORS) for f in (load_model_from_xml,
                                        ref_load_model_from_xml))
    assert sg.sensors_supported(m) and rsg.sensors_supported(mr)
    qpos, qvel, lanes = _inputs(m, 3)
    bk = sg.TorchBackend(B, torch.float64, "cpu")
    moc, moc_r = _cols(lanes["mocap"]), _cols(lanes["mocap"], jnp.asarray)
    q, qr = _cols(qpos), _cols(qpos, jnp.asarray)
    fk, fk_r = sg.build_fk(m, bk)(q, mocap=moc), rsg.build_fk(mr)(
        qr, mocap=moc_r)
    for key in ("xpos", "xquat", "xmat", "xipos"):
        for b in range(m.nbody):
            np.testing.assert_allclose(_stack(fk[key][b]),
                                       _stack(fk_r[key][b]), rtol=0,
                                       atol=1e-12, err_msg=key)
    # the mocap body (body 1) sits at the given position
    np.testing.assert_array_equal(_stack(fk["xpos"][1]),
                                  lanes["mocap"][:, :3])
    rest = sg.build_fk(m, bk)(q)["xpos"][1]
    assert all(float(x) == float(y) for x, y in zip(rest, m.body_pos[1]))
    sens = sg.build_sensors(m, bk)(q, _cols(qvel), mocap=moc)
    want = rsg.build_sensors(mr)(qr, _cols(qvel, jnp.asarray), mocap=moc_r)
    np.testing.assert_allclose(_stack(sens), _stack(want), rtol=0,
                               atol=1e-12)


def test_plain_rollout_with_mocap_matches_general_path():
    """The reference's test_megakernel_mocap_eq_runtime_inputs on the
    port's plain rollout: per-env mocap targets and eq_active rows, nu =
    0 with one unused ctrl row, K = 10 in f32, against the reference's
    general path (Data.mocap_pos/mocap_quat/eq_active)."""
    xml = _xml_of(rmk_tests.test_megakernel_mocap_eq_runtime_inputs)
    m = load_model_from_xml(xml, np.float32)
    mr = ref_load_model_from_xml(xml, np.float32)
    B4, K = 4, 10
    rng = np.random.default_rng(7)
    qpos = np.tile(np.asarray(m.qpos0), (B4, 1)).astype(np.float32)
    qpos[:, :3] += rng.uniform(-0.05, 0.05, (B4, 3)).astype(np.float32)
    qvel = rng.uniform(-0.2, 0.2, (B4, m.nv)).astype(np.float32)
    mocap_pos = (np.array([0.3, 0, 0.4], np.float32)[None, None]
                 + rng.uniform(-0.1, 0.1, (B4, 1, 3))).astype(np.float32)
    mq = rng.uniform(-1, 1, (B4, 1, 4)).astype(np.float32)
    mq /= np.linalg.norm(mq, axis=-1, keepdims=True)
    eq_act = np.array([[1, 0], [1, 1], [0, 0], [0, 1]], np.float32)

    d0 = ref_make_data(mr)
    dB = jax.vmap(lambda q, v, mp, mqt, ea: d0.replace(
        qpos=q, qvel=v, mocap_pos=mp, mocap_quat=mqt,
        eq_active=ea.astype(bool)))(qpos, qvel, mocap_pos, mq, eq_act)
    step_ref = jax.jit(jax.vmap(lambda x: rfwd.step(mr, x)))
    for _ in range(K):
        dB = step_ref(dB)

    hooks = mk.EnvHooks(reward=lambda bk, q, v, c: q[2], time_limit=100.0,
                        observe=lambda bk, q, v: list(q), n_obs=m.nq)
    fn = mk.build_rollout(m, B4, K, hooks)
    state = convert.state_from_numpy(
        [qpos.T, qvel.T, np.zeros((1, B4)), np.zeros((m.nv, B4)),
         np.zeros((1, B4))], "cpu")
    out = fn(*state, torch.zeros((K, 1, B4)),  # nu = 0: one unused row
             torch.zeros(1, dtype=torch.int32),
             eq_active=convert.eq_active_to_kernel(eq_act),
             mocap=convert.mocap_to_kernel(mocap_pos, mq))
    np.testing.assert_allclose(out[0].numpy().T, np.asarray(dB.qpos),
                               rtol=0, atol=2e-5)
    np.testing.assert_allclose(out[1].numpy().T, np.asarray(dB.qvel),
                               rtol=0, atol=2e-4)


def test_fast_rollout_applied_forces_match_general_path():
    """The reference's test_fastrollout_applied_forces on the port: an
    upward xfrc on the ball lifts every env against the unpushed run
    from the same generator state, and the plain rollout with the same
    qfrc/xfrc matches the general path over K = 6 steps (no resets) at
    qpos 2e-5 and qvel 2e-4 in f32."""
    m = load_model_from_xml(HOPPER_XML, np.float32)
    mr = ref_load_model_from_xml(HOPPER_XML, np.float32)
    K = 6
    benv = BatchedEnvironment(m, _PortHopTask(), B, device="cpu")
    roll = FastRollout(benv, K, applied_forces=True)
    rng = np.random.default_rng(41)
    qfrc = rng.uniform(-0.5, 0.5, (B, m.nv)).astype(np.float32)
    xfrc = np.zeros((B, m.nbody, 6), np.float32)
    xfrc[:, 1, 2] = rng.uniform(30.0, 50.0, B)
    state = roll.init(torch.Generator().manual_seed(0))
    free, _ = roll.run(state, torch.Generator().manual_seed(1))
    pushed, _ = roll.run(state, torch.Generator().manual_seed(1),
                         qfrc_applied=torch.as_tensor(qfrc),
                         xfrc_applied=torch.as_tensor(xfrc))
    assert bool((pushed[0][0] > free[0][0]).all())

    d0 = ref_make_data(mr)
    dB = jax.vmap(lambda q, v, qf, xf: d0.replace(
        qpos=q, qvel=v, qfrc_applied=qf, xfrc_applied=xf))(
        np.asarray(state[0]).T, np.asarray(state[1]).T, qfrc, xfrc)
    step_ref = jax.jit(jax.vmap(lambda x: rfwd.step(mr, x)))
    for _ in range(K):
        dB = step_ref(dB)
    out = roll.kernel(*state, torch.zeros((K, m.nu, B)),
                      torch.zeros(1, dtype=torch.int32),
                      qfrc=torch.as_tensor(qfrc.T.copy()),
                      xfrc=convert.xfrc_to_kernel(xfrc))
    np.testing.assert_allclose(out[0].numpy().T, np.asarray(dB.qpos),
                               rtol=0, atol=2e-5)
    np.testing.assert_allclose(out[1].numpy().T, np.asarray(dB.qvel),
                               rtol=0, atol=2e-4)


def test_fast_rollout_refuses_inputs_the_model_does_not_take():
    """Mocap poses on a model without mocap bodies raise ValueError (the
    reference crashes there, ADVICE r5), as do applied forces without
    ``applied_forces=True``; the kernel wrapper refuses a missing or
    misshapen call input."""
    benv = suite.load_batched("cheetah", "run", B, device="cpu")
    roll = FastRollout(benv, 2)
    gen = torch.Generator().manual_seed(0)
    state = roll.init(gen)
    for kw in (dict(mocap_pos=torch.zeros((B, 1, 3))),
               dict(mocap_quat=torch.zeros((B, 1, 4)))):
        with pytest.raises(ValueError, match="without mocap bodies"):
            roll.run(state, gen, **kw)
    for kw in (dict(qfrc_applied=torch.zeros((B, 9))),
               dict(xfrc_applied=torch.zeros((B, 8, 6)))):
        with pytest.raises(ValueError, match="applied_forces=True"):
            roll.run(state, gen, **kw)
    pushed = FastRollout(benv, 2, applied_forces=True)
    with pytest.raises(ValueError, match="shape"):
        pushed.run(state, gen, qfrc_applied=torch.zeros((B, 8)))
    ctrl = torch.zeros((2, 6, B))
    seed = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="needs qfrc"):
        pushed.kernel(*state, ctrl, seed)
    with pytest.raises(ValueError, match="xfrc given"):
        roll.kernel(*state, ctrl, seed, xfrc=torch.zeros((48, B)))
    mocap_env = BatchedEnvironment(
        load_model_from_xml(chip_smoke.MOCAP_WELD_XML, np.float32),
        chip_smoke.bench_configs.BenchTask(), B, device="cpu")
    moc = FastRollout(mocap_env, 2)
    st = moc.init(gen)
    with pytest.raises(ValueError, match="shape"):
        moc.run(st, gen, mocap_pos=torch.zeros((B, 2, 3)))
    # the default pose is the rest pose, given or not
    g1, g2 = (torch.Generator().manual_seed(3) for _ in range(2))
    rest = torch.as_tensor(np.asarray(mocap_env.model.body_pos)[1:2])
    a, _ = moc.run(st, g1)
    b, _ = moc.run(st, g2, mocap_pos=rest.expand(B, 1, 3))
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_launch_passes_each_call_input_to_its_c_parameter(monkeypatch):
    """The wrapper's ctypes call, recorded on the CPU, hands the mocap,
    eq_active, qfrc and xfrc rows to the parameters of
    ``oxc_rollout_launch`` that name them."""
    from pathlib import Path

    import oxide_control_torch.ops as ops

    m = load_model_from_xml(chip_smoke.MOCAP_WELD_XML, np.float32)
    hooks = chip_smoke.bench_configs.BenchTask().kernel_hooks(m)
    fn = mk.build_rollout(m, B, 3, hooks, applied_forces=True)
    cu = (Path(ops.__file__).parent / "csrc" / "rollout.cu").read_text()
    sig = re.search(r'extern "C" int oxc_rollout_launch\((.*?)\)', cu,
                    re.S).group(1)
    params = [p.split()[-1].lstrip("*") for p in sig.split(",")]
    calls = []

    class FakeBuilt:
        def launch(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(fn, "build", FakeBuilt)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0}))
    state = convert.state_from_numpy(
        [np.zeros(s) for s in ((m.nq, B), (m.nv, B), (1, B), (m.nv, B),
                               (1, B))], "cpu")
    rows = mk.input_rows(fn.spec)
    ins = {k: torch.zeros((rows[k], B)) for k in mk.CALL_INPUTS}
    fn._launch(state, torch.zeros((3, 1, B)), torch.zeros(
        1, dtype=torch.int32), None, **ins)
    args = dict(zip(params, calls[0]))
    assert len(calls[0]) == len(params)
    for name, t in ins.items():
        assert args[name].value == t.data_ptr(), name
