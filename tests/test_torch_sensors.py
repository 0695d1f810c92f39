"""PyTorch port: in-kernel sensors and the qacc carry.

The port's ``build_sensors`` (torch backend, f64) is held against the
reference's ``build_sensors`` on the same (qpos, qvel, qacc, time) and
against the reference general path's ``sensordata`` after ``forward``,
within 1e-10 (the reference's own bar, tests/test_megakernel.py:553-582),
on the reference test's sensor model and on chip_smoke.py's sensors-all
model (every sensor type of the kernel family, a ball joint, cutoffs).
``build_step(want_qacc=True)``'s stage-1 qacc is held against the
reference's within 1e-8 under Euler (the sensor model) and RK4
(sensors-all, which the chip runs under Euler), on seeds without a
line-search tie (ROADMAP Queue C).
The plain rollout of a task observing sensors through
``SensorObsWrapper`` (B = 8, K = 24, time limit 0.15, so resets fall
inside the window) is held against the reference's general path at obs
2e-4 with equal dones, as tests/test_megakernel.py:584 holds the
reference kernel: the reference's interpret-mode build of that kernel
takes some 80 s of trace and XLA compile on this class of CPU, over the
per-test budget, and its general path about 12 s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oxide_control_tpu.api.environment import (
    BatchedEnvironment as RefBatchedEnvironment,
)
from oxide_control_tpu.mjcf.compile import (
    load_model_from_xml as ref_load_model_from_xml,
)
from oxide_control_tpu.ops import scalar_graph as rsg
from oxide_control_tpu.physics import forward as rfwd
from oxide_control_tpu.state import make_data as ref_make_data
from oxide_control_tpu.suite.common import (
    SensorObsWrapper as RefSensorObsWrapper,
)
from test_megakernel import _SENSOR_XML, _HopTask
from test_torch_model import _assert_models_equal

import chip_smoke
from oxide_control_torch import bench_configs, convert
from oxide_control_torch.api.environment import BatchedEnvironment
from oxide_control_torch.mjcf.compile import load_model_from_xml
from oxide_control_torch.model import SensorType
from oxide_control_torch.ops import megakernel as mk
from oxide_control_torch.ops import scalar_graph as sg
from oxide_control_torch.parallel.rollout import (
    FastRollout,
    fast_rollout_supported,
)
from oxide_control_torch.suite.common import SensorObsWrapper, asset_path

B = 4


def _walker_xml():
    with open(asset_path("walker")) as f:
        return f.read().replace("</mujoco>",
                                bench_configs.WALKER_TENDON_SENSORS)


XMLS = {"sensor": _SENSOR_XML, "sensors_all": chip_smoke.SENSORS_ALL_XML}
# sensors-all under RK4 (the chip runs it under Euler)
SENSORS_ALL_RK4 = chip_smoke.SENSORS_ALL_XML.replace(
    '<option timestep="0.005"', '<option timestep="0.005" integrator="RK4"')


class _PortHopTask:
    """The reference test's ``_HopTask`` in the port's hook idiom: reward
    clip(q[0], 0, 1), the coordinates observed, no reset noise."""

    time_limit = _HopTask.time_limit

    def init_episode(self, model, data, generator):
        return data

    def kernel_hooks(self, model):
        return mk.EnvHooks(
            reward=lambda bk, q, v, c: bk.clip(q[0], 0.0, 1.0),
            time_limit=self.time_limit,
            observe=lambda bk, q, v: list(q) + list(v),
            n_obs=model.nq + model.nv)


def _cols(a, f=torch.tensor):
    return [f(a[:, i]) for i in range(a.shape[1])]


def _stack(xs):
    return np.stack([np.broadcast_to(np.asarray(x), (B,)) for x in xs], 1)


@pytest.mark.parametrize("name", ["sensor", "sensors_all", "walker"])
def test_sensor_model_fields_match_reference(name):
    """The compiled sensor tables (types, objects, reference frames,
    addresses, cutoffs) and every other field equal the reference's."""
    xml = _walker_xml() if name == "walker" else XMLS[name]
    m = load_model_from_xml(xml)
    _assert_models_equal(m, ref_load_model_from_xml(xml))
    assert m.nsensor and sg.sensors_supported(m)
    if name == "sensors_all":
        assert {SensorType(t) for t in m.sensor_type} == set(
            sg._KERNEL_SENSORS)


@pytest.mark.parametrize("name", list(XMLS))
def test_build_sensors_matches_reference(name):
    xml = XMLS[name]
    m, mr = load_model_from_xml(xml), ref_load_model_from_xml(xml)
    assert rsg.sensors_supported(mr)
    rng = np.random.default_rng(3)
    qpos = np.tile(np.asarray(m.qpos0), (B, 1)) + rng.uniform(
        -0.4, 0.4, (B, m.nq))
    qvel = rng.uniform(-2.0, 2.0, (B, m.nv))
    forward = jax.jit(lambda d: rfwd.forward(mr, d))
    fw = [forward(ref_make_data(mr).replace(
        qpos=jnp.asarray(qpos[b]), qvel=jnp.asarray(qvel[b]),
        time=jnp.asarray(0.25 * b))) for b in range(B)]
    qacc = np.stack([np.asarray(d.qacc) for d in fw])
    time = 0.25 * np.arange(B)
    sens = sg.build_sensors(m, sg.TorchBackend(B, torch.float64, "cpu"))
    got = _stack(sens(_cols(qpos), _cols(qvel), qacc=_cols(qacc),
                      time=torch.tensor(time)))
    want_fw = np.stack([np.asarray(d.sensordata) for d in fw])
    np.testing.assert_allclose(got, want_fw, rtol=0, atol=1e-10)
    rsens = rsg.build_sensors(mr)
    want = _stack(rsens(_cols(qpos, jnp.asarray), _cols(qvel, jnp.asarray),
                        qacc=_cols(qacc, jnp.asarray),
                        time=jnp.asarray(time)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
    if name == "sensors_all":
        # the gyro's cutoff of 1 clips some of these states
        gyro = m.sensor_adr[list(m.sensor_type).index(SensorType.GYRO)]
        assert (np.abs(got[:, gyro:gyro + 3]) == 1.0).any()
    # no mocap body: the mocap input poses nothing (test_torch_slice7
    # holds mocap poses against the reference's)
    np.testing.assert_array_equal(_stack(sens(
        _cols(qpos), _cols(qvel), qacc=_cols(qacc), time=torch.tensor(time),
        mocap=[])), got)


# seeds without a line-search tie: a 1e-14 relative nudge of qpos moves
# the port's own result by less than 1e-10
QACC_CASES = {"sensor_euler": (_SENSOR_XML, 1),
              "sensors_all_rk4": (SENSORS_ALL_RK4, 0)}


@pytest.mark.parametrize("case", list(QACC_CASES))
def test_stage1_qacc_matches_reference(case):
    xml, seed = QACC_CASES[case]
    m, mr = load_model_from_xml(xml), ref_load_model_from_xml(xml)
    rng = np.random.default_rng(seed)
    qpos = np.tile(np.asarray(m.qpos0), (B, 1)) + rng.uniform(
        -0.2, 0.2, (B, m.nq))
    qvel = rng.uniform(-1.0, 1.0, (B, m.nv))
    ctrl = rng.uniform(-1.0, 1.0, (B, m.nu))
    ws = np.zeros((B, m.nv))
    bk = sg.TorchBackend(B, torch.float64, "cpu")
    args = [_cols(x) for x in (qpos, qvel)] + [[]] + [
        _cols(x) for x in (ws, ctrl)]
    got = sg.build_step(m, bk, want_qacc=True)(*args)
    rargs = [_cols(x, jnp.asarray) for x in (qpos, qvel)] + [[]] + [
        _cols(x, jnp.asarray) for x in (ws, ctrl)]
    want = rsg.build_step(mr, want_qacc=True)(*rargs)
    assert len(got) == len(want) == 5
    for i in (0, 1, 3, 4):
        np.testing.assert_allclose(_stack(got[i]), _stack(want[i]), rtol=0,
                                   atol=1e-8)
    # the step without the qacc output is the same step
    plain = sg.build_step(m, bk)(*args)
    assert all(torch.equal(bk.full(x), bk.full(y))
               for xs, ys in zip(plain, got[:4]) for x, y in zip(xs, ys))
    if case.endswith("rk4"):
        # RK4: stage 1's qacc is not the warmstart (stage 4's)
        assert np.abs(_stack(got[4]) - _stack(got[3])).max() > 1e-3


@pytest.fixture(scope="module")
def sensor_obs_run():
    """The port's plain rollout of the sensor-observing task and the
    reference's general path on the same reset and ctrl (f32)."""
    K = 24
    m = load_model_from_xml(_SENSOR_XML, dtype=np.float32)
    mr = ref_load_model_from_xml(_SENSOR_XML, dtype=np.float32)
    task = RefSensorObsWrapper(_HopTask())
    benv = RefBatchedEnvironment(mr, task, 2 * B)
    data, _ = jax.jit(benv.reset)(jax.random.PRNGKey(0))
    ctrl = np.random.default_rng(1).uniform(
        -1.0, 1.0, (K, 2 * B, m.nu)).astype(np.float32)
    step = jax.jit(benv.step)
    observe = jax.jit(jax.vmap(lambda d: task.observe(mr, d)))
    obs = np.zeros((K, m.nq + m.nv + m.nsensordata, 2 * B), np.float32)
    dones = np.zeros((K, 2 * B), np.float32)
    d = data
    for k in range(K):
        obs[k] = np.asarray(observe(d)).T
        d, ts = step(d, jnp.asarray(ctrl[k]), jax.random.PRNGKey(2))
        dones[k] = np.asarray(ts.done, np.float32)
    hooks = SensorObsWrapper(_PortHopTask()).kernel_hooks(m)
    fn = mk.build_rollout(m, 2 * B, K, hooks, emit_obs=True)
    assert fn.n_state == 6 and hooks.n_obs == obs.shape[1]
    state = [np.array(x).T for x in (data.qpos, data.qvel)] + [
        np.zeros((1, 2 * B), np.float32), np.array(data.qacc_warmstart).T,
        np.array(data.time)[None], np.array(data.qacc).T]
    out = fn(*convert.state_from_numpy(state, "cpu"),
             torch.as_tensor(ctrl.transpose(0, 2, 1).copy()),
             torch.zeros(1, dtype=torch.int32))
    return (obs, dones, np.asarray(d.qpos).T), [x.numpy() for x in out]


def test_sensor_obs_rollout_matches_reference(sensor_obs_run):
    (obs, dones, qpos), out = sensor_obs_run
    assert dones.sum() > 0, "the window crosses a reset"
    np.testing.assert_allclose(out[8], obs, rtol=0, atol=2e-4)
    np.testing.assert_array_equal(out[10], dones)
    np.testing.assert_allclose(out[0], qpos, rtol=0, atol=1e-4)


def test_fast_rollout_sensor_task_end_to_end():
    """FastRollout carries qacc as the sixth state element, collects the
    sensor observation, and refuses a sensor outside the kernel family."""
    m = load_model_from_xml(_SENSOR_XML, dtype=np.float32)
    task = SensorObsWrapper(_PortHopTask())
    benv = BatchedEnvironment(m, task, 8, device="cpu")
    roll = FastRollout(benv, steps_per_call=5, collect=True)
    assert roll._carry_qacc and roll._n_state == 6
    gen = torch.Generator().manual_seed(0)
    state = roll.init(gen)
    # the reset runs forward, as the reference's does: the carried qacc
    # starts at the reset state's constrained acceleration
    want = benv.reset(torch.Generator().manual_seed(0)).qacc
    assert len(state) == 6 and torch.equal(state[5], want.T)
    assert bool(state[5].abs().max() > 0)
    state, traj = roll.run(state, gen)
    assert len(state) == 6
    assert tuple(traj.obs.shape) == (5, task.kernel_hooks(m).n_obs, 8)
    assert bool(torch.isfinite(traj.obs).all())

    rf = load_model_from_xml(_SENSOR_XML.replace(
        '<actuatorpos actuator="lift"/>', '<rangefinder site="imu"/>'),
        dtype=np.float32)
    benv_rf = BatchedEnvironment(rf, SensorObsWrapper(_PortHopTask()), 8,
                                 device="cpu")
    assert not fast_rollout_supported(benv_rf)
    with pytest.raises(ValueError, match="RANGEFINDER.*item 11"):
        FastRollout(benv_rf, steps_per_call=5)


def test_clock_reads_the_step_counter():
    """The clock row is n * h of the env's integer step counter (reset to
    0 with the env), not an accumulated time."""
    xml = """
<mujoco><option timestep="0.01"/><worldbody>
  <body pos="0 0 1"><joint name="z" type="slide" axis="0 0 1"/>
    <geom size="0.1" mass="1"/><site name="s"/></body>
</worldbody><sensor><clock/><accelerometer site="s"/></sensor></mujoco>"""
    m = load_model_from_xml(xml, dtype=np.float32)
    hooks = SensorObsWrapper(_PortHopTask()).kernel_hooks(m)
    K = 20
    fn = mk.build_rollout(m, 2, K, hooks, emit_obs=True)
    n0 = np.array([0, 9], np.float32)
    h = np.float32(0.01)
    state = [np.zeros((1, 2), np.float32) + 1.0, np.zeros((1, 2)),
             np.zeros((1, 2)), np.zeros((1, 2)), (n0 * h)[None],
             np.zeros((1, 2))]
    out = fn(*convert.state_from_numpy(state, "cpu"),
             torch.zeros((K, 0, 2)), torch.zeros(1, dtype=torch.int32))
    n = n0.astype(np.int64)[None] + np.arange(K)[:, None]
    n = n % fn.spec.limit_n  # the time limit (0.15 s: 15 steps) resets
    np.testing.assert_array_equal(out[8][:, 2], n.astype(np.float32) * h)
    # the accelerometer reads the previous step's qacc: free fall after
    # the first step, zero qacc (and so gravity's reaction) at each reset
    acc_z = out[8][:, 5]
    np.testing.assert_allclose(acc_z[0], 9.81, atol=1e-5)
    np.testing.assert_allclose(acc_z[n[:, 0] != 0, 0], 0.0, atol=1e-5)


@pytest.mark.parametrize("carry", [True, False])
def test_launch_passes_each_buffer_to_its_c_parameter(carry, monkeypatch):
    """The wrapper's ctypes call, recorded on the CPU, hands every input
    and output tensor to the parameter of ``oxc_rollout_launch`` that
    names it (the qacc rows after time, null without the carry)."""
    import re
    from pathlib import Path

    import oxide_control_torch.ops as ops

    m = load_model_from_xml(_SENSOR_XML, dtype=np.float32)
    task = SensorObsWrapper(_PortHopTask()) if carry else _PortHopTask()
    fn = mk.build_rollout(m, 8, 3, task.kernel_hooks(m), emit_obs=True)
    assert fn.spec.carry_qacc == carry
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
        [np.zeros(s) for s in ((m.nq, 8), (m.nv, 8), (1, 8), (m.nv, 8),
                               (1, 8), (m.nv, 8))][:fn.n_state], "cpu")
    ctrl = torch.zeros((3, m.nu, 8))
    seed = torch.zeros(1, dtype=torch.int32)
    out = fn._launch(state, ctrl, seed, None, None)
    args = dict(zip(params, calls[0]))
    assert len(calls[0]) == len(params)
    ptr = lambda a: a.value or 0
    ins = dict(qpos=state[0], qvel=state[1], act=state[2], ws=state[3],
               time_in=state[4], ctrl=ctrl, seed=seed)
    outs = ["qpos_o", "qvel_o", "act_o", "ws_o", "time_o"] + (
        ["qacc_o"] if carry else []) + ["reward_sum", "diverged", "obs_o",
                                         "rewards_o", "dones_o"]
    for name, t in list(ins.items()) + list(zip(outs, out)):
        assert ptr(args[name]) == t.data_ptr(), name
    for name in ("qacc_in", "qacc_o"):
        assert (ptr(args[name]) != 0) == carry, name
    assert ptr(args["ctrls_o"]) == 0 and ptr(args["eq_active"]) == 0
    for name in ("mocap", "qfrc", "xfrc"):
        assert ptr(args[name]) == 0, name
