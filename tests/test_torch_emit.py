"""PyTorch port: the C the emitter writes for the CUDA rollout kernel.

The emitted model header -- the same source the card compiles -- is built
here by g++ in double and held against the torch backend (the plain
version): the Euler step (hopper, cheetah), the RK4 step (cartpole), the
free joint (the sphere), the muscle on a wrapped spatial tendon (the arm),
fixed tendons with friction loss and limits, stateful actuators,
equality rows and the narrowphase pairs, ball joints (the cable),
elliptic cones, walker's reward, which reads the FK, the sensor
rows with the qacc carry, and fluid forces, mocap poses and applied
forces (the call inputs).  Every kernel source the smoke builds is pinned
by its hash, so porting a later part leaves the earlier ones
byte-identical.  Its float form is checked for stray
double literals and for the Newton/line-search and wrap-search loops that
keep it small.
"""

import ctypes
import re
import subprocess
import time

import numpy as np
import pytest
import torch

from test_megakernel import _XML as HOPPER_XML
from test_torch_scalar_graph import FREE_SPHERE, SPINS
from test_torch_tendon import XMLS as TENDON_XMLS

from oxide_control_torch.mjcf.compile import load_model_from_xml
from oxide_control_torch import suite
from oxide_control_torch.ops import megakernel as mk
from oxide_control_torch.ops import scalar_graph as sg
from oxide_control_torch.ops.emit import PRELUDE, Emitter
from oxide_control_torch.suite.common import load_asset

B = 8


def _model(name):
    if name == "hopper":
        return load_model_from_xml(HOPPER_XML)
    if name == "free_sphere":
        return load_model_from_xml(FREE_SPHERE.format(stiffness=0.0))
    if name in TENDON_XMLS:
        return load_model_from_xml(TENDON_XMLS[name])
    if name == "arm_side_lower":  # the sidesite on another body
        return load_model_from_xml(TENDON_XMLS["arm"].replace(
            '<site name="pside" pos="0.3 0 0.08"/>', "").replace(
            '<site name="tip"', '<site name="pside" pos="0.01 0 0.02"/>'
            '<site name="tip"'))
    return load_asset(name)


def _inputs(m, seed):
    if m.nq == 7:  # the free sphere, B = 2 spins
        return (np.tile(np.asarray(m.qpos0), (len(SPINS), 1)), SPINS,
                np.zeros(SPINS.shape), np.zeros((len(SPINS), 0)))
    rng = np.random.default_rng(seed)
    qpos = np.tile(np.asarray(m.qpos0), (B, 1)) + rng.uniform(
        -0.1, 0.1, (B, m.nq))
    # bring feet (cheetah: rootz) / the ball (hopper: z) into contact range
    qpos[:, 1 if m.nq == 9 else 0] -= 0.3
    qvel = rng.uniform(-1, 1, (B, m.nv))
    ctrl = rng.uniform(-1, 1, (B, m.nu))
    ws = np.zeros((B, m.nv))
    return qpos, qvel, ws, ctrl


def _cols(a):
    return [torch.tensor(a[:, i]) for i in range(a.shape[1])]


def _stack(xs):
    return np.stack([np.asarray(x) for x in xs], axis=1)


def _hooks(m):
    return mk.EnvHooks(
        reward=lambda bk, q, v, c: bk.clip(v[0] * 0.1, 0.0, 1.0),
        time_limit=10.0,
        observe=lambda bk, q, v: list(q) + list(v),
        n_obs=m.nq + m.nv,
    )


def _gxx_step(m, tmp_path):
    """The emitted model header in double, wrapped in a host loop over
    envs and built by g++ into a ctypes library."""
    src = mk.kernel_source(m, _hooks(m), "double").text + r"""
extern "C" void step_batch(const double* q, const double* v, const double* a,
                           const double* w, const double* c, double* qo,
                           double* vo, double* ao, double* wo, int n) {
  for (int b = 0; b < n; ++b)
    oxc_step(q + b * OXC_NQ, v + b * OXC_NV, a + b * OXC_NA, w + b * OXC_NV,
             c + b * OXC_NU, qo + b * OXC_NQ, vo + b * OXC_NV,
             ao + b * OXC_NA, wo + b * OXC_NV);
}
"""
    return _gxx(src, tmp_path)


def _gxx(src, tmp_path):
    cpp = tmp_path / "body.cpp"
    so = tmp_path / "body.so"
    cpp.write_text(src)
    t0 = time.perf_counter()
    subprocess.run(["g++", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
                    "-w", "-o", str(so), str(cpp)], check=True,
                   capture_output=True, timeout=120)
    return ctypes.CDLL(str(so)), time.perf_counter() - t0


@pytest.mark.parametrize("name,nsteps", [
    ("hopper", 10), ("cheetah", 5), ("cartpole", 10), ("free_sphere", 10),
    ("arm", 10), ("tendon_frictionloss", 10), ("stateful", 10),
])
def test_emitted_body_matches_torch_backend(name, nsteps, tmp_path):
    """g++ -O1 builds the cheetah body in about 4 s on this class of CPU,
    so the models run through it; act is compared where the model has
    activations."""
    m = _model(name)
    lib, _ = _gxx_step(m, tmp_path)
    qpos, qvel, ws, ctrl = _inputs(m, seed=1)
    b = len(qpos)
    act = np.random.default_rng(3).uniform(0.0, 0.4, (b, m.na))
    step = sg.build_step(m, sg.TorchBackend(b, torch.float64, "cpu"))
    q, v, a, w, c = (_cols(x) for x in (qpos, qvel, act, ws, ctrl))
    cq, cv, ca, cw, cc = (np.ascontiguousarray(x)
                          for x in (qpos, qvel, act, ws, ctrl))
    ptr = lambda x: x.ctypes.data_as(ctypes.c_void_p)
    for _ in range(nsteps):
        q, v, a, w = step(q, v, a, w, c)
        qo, vo, ao, wo = (np.zeros_like(x) for x in (cq, cv, ca, cw))
        lib.step_batch(ptr(cq), ptr(cv), ptr(ca), ptr(cw), ptr(cc), ptr(qo),
                       ptr(vo), ptr(ao), ptr(wo), ctypes.c_int(b))
        cq, cv, ca, cw = qo, vo, ao, wo
        np.testing.assert_allclose(cq, _stack(q), rtol=0, atol=1e-9)
        np.testing.assert_allclose(cv, _stack(v), rtol=0, atol=1e-9)
        np.testing.assert_allclose(cw, _stack(w), rtol=0, atol=1e-9)
        if m.na:
            np.testing.assert_allclose(ca, _stack(a), rtol=0, atol=1e-9)


def test_emitted_fk_reward_matches_torch_backend(tmp_path):
    """walker-walk's reward, which reads the torso frame from build_fk:
    the emitted C in double against the torch backend."""
    benv = suite.load_batched("walker", "walk", B, dtype=np.float64,
                              device="cpu")
    m, hooks = benv.model, benv.task.kernel_hooks(benv.model)
    em = Emitter("double")
    q, v, c = em.load("q", m.nq), em.load("v", m.nv), em.load("c", m.nu)
    em.ret(mk.bind_hooks(m, hooks, em)[1](q, v, c))
    src = PRELUDE + em.function(
        "double reward(const double* q, const double* v, const double* c)")
    src += r"""
extern "C" void reward_batch(const double* q, const double* v,
                             const double* c, double* r, int n) {
  for (int b = 0; b < n; ++b)
    r[b] = reward(q + b * %d, v + b * %d, c + b * %d);
}
""" % (m.nq, m.nv, m.nu)
    lib, _ = _gxx(src, tmp_path)
    rng = np.random.default_rng(2)
    qpos = np.asarray(m.qpos0) + rng.uniform(-0.5, 0.5, (B, m.nq))
    qvel = rng.uniform(-3.0, 3.0, (B, m.nv))
    ctrl = rng.uniform(-1.0, 1.0, (B, m.nu))
    bk = sg.TorchBackend(B, torch.float64, "cpu")
    want = bk.full(mk.bind_hooks(m, hooks, bk)[1](
        _cols(qpos), _cols(qvel), _cols(ctrl))).numpy()
    got = np.zeros(B)
    ptr = lambda a: np.ascontiguousarray(a).ctypes.data_as(ctypes.c_void_p)
    lib.reward_batch(ptr(qpos), ptr(qvel), ptr(ctrl), ptr(got),
                     ctypes.c_int(B))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    assert want.std() > 0.0


def test_float_source_has_no_double_literal():
    """In the kernel's float source every floating literal carries the f
    suffix, so no expression is promoted to double."""
    m = load_asset("cheetah", np.float32)
    text = mk.kernel_source(m, _hooks(m), "float").text
    body = text[text.index("OXC_HD void oxc_step"):]
    lits = re.findall(r"(?<![\w.])(\d+\.\d*(?:e[+-]?\d+)?f?)", body)
    assert lits and all(x.endswith("f") for x in lits), \
        [x for x in lits if not x.endswith("f")][:5]


def test_newton_and_linesearch_are_loops():
    """The 4 Newton iterations and the 12 + 26 line-search steps are C
    loops; the emitter counts the unrolled work."""
    m = load_asset("cheetah", np.float32)
    em = Emitter("float")
    step = sg.build_step(m, em)
    step(em.load("q", m.nq), em.load("v", m.nv), [], em.load("w", m.nv),
         em.load("c", m.nu))
    src = "\n".join(em._lines)
    assert re.search(r"< 4; \+\+i", src)
    assert re.search(r"< 12; \+\+i", src) and re.search(r"< 26; \+\+i", src)
    n_stmt = src.count("const ")
    assert em.ops > 5 * n_stmt  # loops: far more work than source


def test_wrap_search_is_loops():
    """The inside-sidesite wrap search -- 31 more tournament angles and 60
    golden-section steps -- is two C loops in the emitted step where the
    sidesite may lie inside the sphere (moved to the lower arm, it is
    tested per lane), and is not emitted for the bench's arm, whose
    sidesite sits outside the sphere on the sphere's own body."""
    for name, searched in (("arm_side_lower", True), ("arm", False)):
        m = _model(name)
        em = Emitter("float")
        step = sg.build_step(m, em)
        step(em.load("q", m.nq), em.load("v", m.nv), em.load("a", m.na),
             em.load("w", m.nv), em.load("c", m.nu))
        src = "\n".join(em._lines)
        loops = [bool(re.search(r"< %d; \+\+i" % n, src)) for n in (31, 60)]
        assert loops == [searched, searched], name
        assert len(em._lines) < 2000


@pytest.mark.parametrize("lit,want", [
    (1.25, "1.25e+00f"), (-2.0, "(-2.e+00f)"), (0.1, "1.e-01f"),
    (1e10, "1.e+10f"),
])
def test_emitter_literals(lit, want):
    assert Emitter("float").lit(lit) == want


@pytest.mark.parametrize("name", ["fourbar", "arms", "box_stack"])
def test_emitted_equality_and_pairs_match_torch_backend(name, tmp_path):
    """The equality rows (fourbar, with its eq lanes mixed: the connect
    off in every other env) and the new narrowphase pairs (arms, box-box
    on box-stack) through g++ in double, within 1e-9 of the torch
    backend over 3 steps."""
    from test_torch_pairs import XMLS as PAIR_XMLS

    from oxide_control_torch import bench_configs

    xml = dict(PAIR_XMLS, fourbar=bench_configs.FOURBAR_XML)[name]
    m = load_model_from_xml(xml)
    neq = m.neq
    src = mk.kernel_source(m, _hooks(m), "double").text
    eq_arg = "eq + b * OXC_NEQ, " if neq else ""
    src += r"""
extern "C" void step_batch(const double* q, const double* v, const double* a,
                           const double* w, const double* c, const bool* eq,
                           double* qo, double* vo, double* ao, double* wo,
                           int n) {
  for (int b = 0; b < n; ++b)
    oxc_step(q + b * OXC_NQ, v + b * OXC_NV, a + b * OXC_NA, w + b * OXC_NV,
             c + b * OXC_NU, %s qo + b * OXC_NQ, vo + b * OXC_NV,
             ao + b * OXC_NA, wo + b * OXC_NV);
}
""" % eq_arg
    lib, _ = _gxx(src, tmp_path)
    rng = np.random.default_rng(5)
    qpos = np.tile(np.asarray(m.qpos0), (B, 1)) + rng.uniform(
        -0.05, 0.05, (B, m.nq))
    for j in range(m.njnt):
        if m.jnt_type[j] == 0:
            a = m.jnt_qposadr[j] + 3
            qpos[:, a:a + 4] /= np.linalg.norm(qpos[:, a:a + 4], axis=1,
                                               keepdims=True)
    qvel = rng.uniform(-1, 1, (B, m.nv))
    ctrl = rng.uniform(-1, 1, (B, m.nu))
    act, ws = np.zeros((B, m.na)), np.zeros((B, m.nv))
    eq = np.ones((B, max(neq, 1)), dtype=bool)
    eq[::2, 0] = False
    step = sg.build_step(m, sg.TorchBackend(B, torch.float64, "cpu"))
    lanes = ([torch.tensor(eq[:, e]) for e in range(neq)] if neq
             else None)
    q, v, a, w, c = (_cols(x) for x in (qpos, qvel, act, ws, ctrl))
    cq, cv, ca, cw, cc = (np.ascontiguousarray(x)
                          for x in (qpos, qvel, act, ws, ctrl))
    ce = np.ascontiguousarray(eq)
    ptr = lambda x: x.ctypes.data_as(ctypes.c_void_p)
    for _ in range(3):
        q, v, a, w = step(q, v, a, w, c, lanes)
        qo, vo, ao, wo = (np.zeros_like(x) for x in (cq, cv, ca, cw))
        lib.step_batch(ptr(cq), ptr(cv), ptr(ca), ptr(cw), ptr(cc),
                       ptr(ce), ptr(qo), ptr(vo), ptr(ao), ptr(wo),
                       ctypes.c_int(B))
        cq, cv, ca, cw = qo, vo, ao, wo
        np.testing.assert_allclose(cq, _stack(q), rtol=0, atol=1e-9)
        np.testing.assert_allclose(cv, _stack(v), rtol=0, atol=1e-9)
        np.testing.assert_allclose(cw, _stack(w), rtol=0, atol=1e-9)


@pytest.mark.parametrize("name", ["cable", "cheetah_elliptic", "elliptic6"])
def test_emitted_ball_and_cone_bodies_match_torch_backend(name, tmp_path):
    """Ball joints (the bench's cable, from quaternions off the unit
    sphere) and elliptic cones (cheetah at condim 3, the reference's
    condim 6 model) through g++ in double, within 1e-9 of the torch
    backend over 3 steps."""
    import chip_smoke
    from test_torch_ball import _state

    from oxide_control_torch import bench_configs

    if name == "cheetah_elliptic":
        m = bench_configs.cheetah_run_elliptic(np.float64)[0]
        qpos, qvel, ws, ctrl = _inputs(m, seed=1)
    else:
        m = load_model_from_xml(dict(
            cable=bench_configs.CABLE_XML,
            elliptic6=chip_smoke.ELLIPTIC6_XML)[name])
        qpos, qvel, ctrl = _state(m, 2)
        ws = np.zeros((B, m.nv))
    lib, _ = _gxx_step(m, tmp_path)
    act = np.zeros((B, m.na))
    step = sg.build_step(m, sg.TorchBackend(B, torch.float64, "cpu"))
    q, v, a, w, c = (_cols(x) for x in (qpos, qvel, act, ws, ctrl))
    cq, cv, ca, cw, cc = (np.ascontiguousarray(x)
                          for x in (qpos, qvel, act, ws, ctrl))
    ptr = lambda x: x.ctypes.data_as(ctypes.c_void_p)
    for _ in range(3):
        q, v, a, w = step(q, v, a, w, c)
        qo, vo, ao, wo = (np.zeros_like(x) for x in (cq, cv, ca, cw))
        lib.step_batch(ptr(cq), ptr(cv), ptr(ca), ptr(cw), ptr(cc), ptr(qo),
                       ptr(vo), ptr(ao), ptr(wo), ctypes.c_int(B))
        cq, cv, ca, cw = qo, vo, ao, wo
        np.testing.assert_allclose(cq, _stack(q), rtol=0, atol=1e-9)
        np.testing.assert_allclose(cv, _stack(v), rtol=0, atol=1e-9)
        np.testing.assert_allclose(cw, _stack(w), rtol=0, atol=1e-9)


def _sensor_env(name):
    """(model in f64, task) of a sensor-observing source."""
    from test_torch_sensors import SENSORS_ALL_RK4

    from oxide_control_torch import bench_configs
    from oxide_control_torch.suite.common import SensorObsWrapper

    if name == "walker-walk-tendon-sensors":
        return bench_configs.walker_walk_tendon_sensors(np.float64)
    return (load_model_from_xml(SENSORS_ALL_RK4),
            SensorObsWrapper(bench_configs.BenchTask()))


@pytest.mark.parametrize("name", ["walker-walk-tendon-sensors",
                                  "sensors-all-rk4"])
def test_emitted_sensor_sources_match_torch_backend(name, tmp_path):
    """Sensor-observing sources through g++ in double (the walker row:
    Euler, gyro, accelerometer, velocimeter, framepos; the smoke's
    sensors-all model under RK4: every sensor of the kernel family): the
    step with its stage-1 qacc output and the observation with its
    sensor rows, read from the carried qacc and the clock, within 1e-9
    of the torch backend over 3 steps."""
    m, task = _sensor_env(name)
    hooks = task.kernel_hooks(m)
    src = mk.kernel_source(m, hooks, "double").text + r"""
extern "C" void run_batch(const double* q, const double* v, const double* a,
                          const double* w, const double* c, const double* qa,
                          const double* clk, double* qo, double* vo,
                          double* ao, double* wo, double* qao, double* obs,
                          int n) {
  for (int b = 0; b < n; ++b) {
    oxc_observe(q + b * OXC_NQ, v + b * OXC_NV, qa + b * OXC_NV, clk + b,
                obs + b * OXC_NOBS);
    oxc_step(q + b * OXC_NQ, v + b * OXC_NV, a + b * OXC_NA, w + b * OXC_NV,
             c + b * OXC_NU, qo + b * OXC_NQ, vo + b * OXC_NV,
             ao + b * OXC_NA, wo + b * OXC_NV, qao + b * OXC_NV);
  }
}
"""
    assert "#define OXC_CARRY_QACC 1" in src
    lib, _ = _gxx(src, tmp_path)
    rng = np.random.default_rng(4)
    qpos = np.tile(np.asarray(m.qpos0), (B, 1)) + rng.uniform(
        -0.1, 0.1, (B, m.nq))
    qvel, qacc = (rng.uniform(-1, 1, (B, m.nv)) for _ in range(2))
    ctrl = rng.uniform(-1, 1, (B, m.nu))
    clk = rng.integers(0, 500, B) * float(m.opt.timestep)
    bk = sg.TorchBackend(B, torch.float64, "cpu")
    step = sg.build_step(m, bk, want_qacc=True)
    observe = mk.bind_hooks(m, hooks, bk)[0]
    q, v, w, qa, c = (_cols(x) for x in (qpos, qvel, np.zeros((B, m.nv)),
                                         qacc, ctrl))
    cq, cv, cw, cqa, cc = (np.ascontiguousarray(x) for x in (
        qpos, qvel, np.zeros((B, m.nv)), qacc, ctrl))
    ca = np.zeros((B, m.na))
    ptr = lambda x: x.ctypes.data_as(ctypes.c_void_p)
    # a value the graph folded to a constant is a python float
    rows = lambda xs: np.stack([np.broadcast_to(np.asarray(x, float), (B,))
                                for x in xs], axis=1)
    for _ in range(3):
        obs = observe(q, v, qa, torch.tensor(clk))
        q, v, _, w, qa = step(q, v, [], w, c)
        qo, vo, wo, qao = (np.zeros_like(x) for x in (cq, cv, cw, cqa))
        cobs = np.zeros((B, hooks.n_obs))
        lib.run_batch(ptr(cq), ptr(cv), ptr(ca), ptr(cw), ptr(cc), ptr(cqa),
                      ptr(np.ascontiguousarray(clk)), ptr(qo), ptr(vo),
                      ptr(ca), ptr(wo), ptr(qao), ptr(cobs), ctypes.c_int(B))
        np.testing.assert_allclose(cobs, rows(obs), rtol=0, atol=1e-9)
        cq, cv, cw, cqa = qo, vo, wo, qao
        for got, want in ((cq, q), (cv, v), (cw, w), (cqa, qa)):
            np.testing.assert_allclose(got, rows(want), rtol=0, atol=1e-9)
        clk = clk + float(m.opt.timestep)


# sha256 (first 16 hex digits) of the float kernel source of each distinct
# (model, hooks) pair the smoke builds (ENVS keys of chip_smoke.py, and
# cheetah with Gaussian reset noise, and cheetah-run-push's cheetah with
# applied forces): porting a later part of the kernel (ball joints and
# cones, then sensors and the qacc carry, then fluid forces, mocap poses
# and applied forces) changed no earlier model's kernel.  The three
# elliptic sources are pinned as of the cone Hessian's one-rounding
# division of mub2 by D0.  The sources whose team size is above 1
# (megakernel.team_rule: 4 or 8 lanes per env) are pinned at that size;
# those at G = 1 keep their one-thread-per-env source byte for byte.
EARLIER_SOURCES = {
    "cheetah/run": "29622534892d5ba7", "walker/walk": "bd96885f7601f346",
    "cartpole/swingup": "be1ba6dc20524d50",
    "pendulum/swingup": "d7f0fe6c0460f134",
    "humanoid/run": "9a408c8f154d8947", "arm/muscle-wrap": "8540a01de71941f5",
    "fourbar/equality": "c45fceb36f47e1cd",
    "arms/self-collide": "4caeb053282d72de",
    "walker/walk-tendon": "50cb353367653429",
    "stateful/actuators": "4b55a35a9d39913f", "weld": "c377d519be9dea83",
    "tendon-equality": "1d205d85d18ed32e", "box-pairs": "4d8ddb8eb4da95b2",
    "plane-shapes": "e4c7f0fb6f4974b7", "box-stack": "acee84fa680f70ea",
    "cheetah gauss": "9c5b084649a095d2",
    "cable/swing": "3630b1bc3c4ee3e7",
    "cheetah/run-elliptic": "8b7f8e33ad432ec1",
    "ball-limit-spring": "cc982416e2865b9b",
    "ball-free-actuators": "178e8c627c2576b3",
    "weld-ball": "9330091a94e55467", "condim46": "9e8a391a4788926d",
    "elliptic-condim4": "891fe049dceca13f",
    "elliptic-condim6": "b0496f702c2c2ec0",
    "walker/walk-tendon-sensors": "5f3b2014656b3509",
    "sensors-all": "b0099d692b878ee2",
    "cheetah push": "67dc3f92a8a331de", "fluid-forces": "f9d4b6101d41ad3e",
    "mocap-weld": "ce4bff52350420ff", "applied-forces": "9ddfcba359a209cd",
}


@pytest.mark.parametrize("key", list(EARLIER_SOURCES))
def test_earlier_kernel_sources_are_byte_identical(key, monkeypatch):
    import dataclasses
    import hashlib

    import chip_smoke

    import oxide_control_torch.api.environment as environment

    # the smoke's environments, built on the CPU
    monkeypatch.setattr(environment, "default_device",
                        lambda device=None: torch.device("cpu"))
    benv = chip_smoke.ENVS["cheetah/run" if key.startswith("cheetah ")
                           else key]()
    hooks = benv.task.kernel_hooks(benv.model)
    if key == "cheetah gauss":
        hooks = dataclasses.replace(
            hooks, reset_qpos_sigma=[0.0] * 3 + [0.05] * 6,
            reset_qvel_sigma=0.1)
    applied = key in ("cheetah push", "applied-forces")
    text = mk.kernel_source(benv.model, hooks, "float", applied).text
    assert hashlib.sha256(text.encode()).hexdigest()[:16] == \
        EARLIER_SOURCES[key]


def _slice7_env(name):
    """(model in f64, hooks, applied_forces) of a source with call
    inputs: the smoke's three parity models and cheetah-run-push."""
    import chip_smoke

    from oxide_control_torch import bench_configs

    if name == "cheetah-push":
        m = load_asset("cheetah")
        return m, suite.cheetah.run(model=m)[1].kernel_hooks(m), True
    xml = dict(fluid=chip_smoke.FLUID_XML, mocap=chip_smoke.MOCAP_WELD_XML,
               applied=chip_smoke.APPLIED_XML)[name]
    m = load_model_from_xml(xml)
    return (m, bench_configs.BenchTask().kernel_hooks(m),
            name == "applied")


@pytest.mark.parametrize("name", ["fluid", "mocap", "applied",
                                  "cheetah-push"])
def test_emitted_call_input_sources_match_torch_backend(name, tmp_path):
    """The sources with fluid forces, mocap poses (with eq lanes) and
    applied forces through g++ in double, within 1e-9 of the torch
    backend over 3 steps: the call inputs are read through a per-env
    pointer with stride ``ld`` (1 here: env-major rows)."""
    m, hooks, applied = _slice7_env(name)
    src = mk.kernel_source(m, hooks, "double", applied).text
    rows = mk.input_rows(mk.env_spec(m, hooks, applied))
    assert ("#define OXC_NMOCAP 1" in src) == (name == "mocap")
    assert ("#define OXC_APPLIED 1" in src) == applied
    args = "".join(f"{n} + b * {rows[k]}, " for n, k in (
        ("eq", "eq_active"), ("mc", "mocap"), ("qf", "qfrc"),
        ("xf", "xfrc")) if rows[k]) + ("1, " if rows["mocap"] or applied
                                         else "")
    src += r"""
extern "C" void step_batch(const double* q, const double* v, const double* a,
                           const double* w, const double* c, const bool* eq,
                           const double* mc, const double* qf,
                           const double* xf, double* qo, double* vo,
                           double* ao, double* wo, int n) {
  for (int b = 0; b < n; ++b)
    oxc_step(q + b * OXC_NQ, v + b * OXC_NV, a + b * OXC_NA, w + b * OXC_NV,
             c + b * OXC_NU, %s qo + b * OXC_NQ, vo + b * OXC_NV,
             ao + b * OXC_NA, wo + b * OXC_NV);
}
""" % args
    lib, _ = _gxx(src, tmp_path)
    if name == "cheetah-push":
        qpos, qvel, ws, ctrl = _inputs(m, seed=1)
    else:
        from test_torch_ball import _state

        qpos, qvel, ctrl = _state(m, 2)
        ws = np.zeros((B, m.nv))
    rng = np.random.default_rng(6)
    ins = {k: rng.uniform(-1.0, 1.0, (B, n)) for k, n in rows.items()}
    ins["eq_active"] = np.tile([[1, 0], [1, 1], [0, 0], [0, 1]],
                               (B // 4, 1))[:, :rows["eq_active"]] != 0
    if rows["mocap"]:
        ins["mocap"][:, :3] *= 0.1
        ins["mocap"][:, :3] += np.asarray(m.body_pos)[1]
    eqa, ext = mk._step_inputs([torch.tensor(ins[k].T.copy())
                                for k in mk.CALL_INPUTS])
    act = np.zeros((B, m.na))
    step = sg.build_step(m, sg.TorchBackend(B, torch.float64, "cpu"))
    q, v, a, w, c = (_cols(x) for x in (qpos, qvel, act, ws, ctrl))
    cq, cv, ca, cw, cc = (np.ascontiguousarray(x)
                          for x in (qpos, qvel, act, ws, ctrl))
    ptr = lambda x: np.ascontiguousarray(x).ctypes.data_as(ctypes.c_void_p)
    held = [np.ascontiguousarray(ins[k]) for k in mk.CALL_INPUTS]
    for _ in range(3):
        q, v, a, w = step(q, v, a, w, c, eqa, **ext)
        qo, vo, ao, wo = (np.zeros_like(x) for x in (cq, cv, ca, cw))
        lib.step_batch(ptr(cq), ptr(cv), ptr(ca), ptr(cw), ptr(cc),
                       ptr(held[1]), ptr(held[0]), ptr(held[2]),
                       ptr(held[3]), ptr(qo), ptr(vo), ptr(ao), ptr(wo),
                       ctypes.c_int(B))
        cq, cv, ca, cw = qo, vo, ao, wo
        np.testing.assert_allclose(cq, _stack(q), rtol=0, atol=1e-9)
        np.testing.assert_allclose(cv, _stack(v), rtol=0, atol=1e-9)
        np.testing.assert_allclose(cw, _stack(w), rtol=0, atol=1e-9)
