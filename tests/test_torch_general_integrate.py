"""PyTorch port, general path: the integrators and the sensors.

From numpy-seeded states (f64, B = 4), one ``physics.forward.step`` of the
port is held against the reference's (one ``jit(vmap)`` per model) within
1e-8 in qpos, qvel and act under Euler (with implicit damping), RK4,
implicitfast and full implicit (whose RNE Coriolis derivative the port
takes by forward-mode AD), on seeds without a line-search tie (ROADMAP
Queue C); and ``sensordata`` after ``forward`` within 1e-10 on the
reference's sensor-test models, which cover every sensor family: the
position, velocity and acceleration families with cutoffs (the sensor
arm), touch/force/torque through the contact forces, rangefinders on
every geom type, and the joint and tendon limit sensors.
"""

import jax
import pytest
from test_sensors import ARM_XML, LIMIT_XML, RANGE_XML, TOUCH_XML
from test_torch_general_smooth import err, models, seeded

import chip_smoke
import fixtures
from oxide_control_tpu.physics import forward as rfwd
from oxide_control_torch.model import Integrator
from oxide_control_torch.physics import forward as pfwd

STEP_BAR = 1e-8
SENSOR_BAR = 1e-10

# name -> (xml, integrator it runs, qpos noise, qvel noise, qpos offsets)
MODELS = {
    "sensor_arm_euler": (ARM_XML, Integrator.EULER, 0.3, 0.5, None),
    "ball_limit_rk4": (chip_smoke.BALL_LIMIT_XML.replace(
        '<option solver="Newton"', '<option integrator="RK4" '
        'solver="Newton"'), Integrator.RK4, 0.3, 0.5, None),
    "walker_implicitfast": (fixtures.PLANAR_WALKER.replace(
        'solver="CG"', 'integrator="implicitfast" solver="CG"'),
        Integrator.IMPLICITFAST, 0.05, 0.5, None),
    "ball_implicit": (fixtures.BALL_JOINT.replace(
        '<option timestep="0.002"/>',
        '<option timestep="0.002" integrator="implicit"/>'),
        Integrator.IMPLICIT, 0.3, 3.0, None),
    "touch": (TOUCH_XML, Integrator.EULER, 0.05, 0.5, {2: -0.21}),
    "range": (RANGE_XML, Integrator.EULER, 1.0, 0.5, None),
    "limits": (LIMIT_XML, Integrator.EULER, 0.7, 0.5, None),
}


@pytest.fixture(scope="module", params=sorted(MODELS))
def stepped(request):
    xml, integ, qn, vn, shift = MODELS[request.param]
    rm, pm = models(xml)
    assert pm.opt.integrator == integ
    rd, pd = seeded(rm, pm, seed=2, qnoise=qn, vnoise=vn, shift=shift)
    ref = jax.jit(jax.vmap(lambda d: (rfwd.forward(rm, d),
                                      rfwd.step(rm, d))))(rd)
    return (request.param, pm, ref, (pfwd.forward(pm, pd),
                                     pfwd.step(pm, pd)))


@pytest.mark.parametrize("field", ["qpos", "qvel", "act", "time"])
def test_one_step_matches_reference(stepped, field):
    name, _, (_, rs), (_, ps) = stepped
    e = err(getattr(rs, field), getattr(ps, field))
    assert e < STEP_BAR, (name, field, e)


def test_sensordata_matches_reference(stepped):
    name, pm, (rf, _), (pf, _) = stepped
    e = err(rf.sensordata, pf.sensordata)
    assert e < SENSOR_BAR, (name, e)


def test_sensor_models_engage():
    """The seeded states exercise what the sensor models test: contacts
    under the touch site, rangefinder hits and misses, limits active."""
    out = {}
    for name in ("touch", "range", "limits"):
        xml, _, qn, vn, shift = MODELS[name]
        rm, pm = models(xml)
        _, pd = seeded(rm, pm, seed=2, qnoise=qn, vnoise=vn, shift=shift)
        out[name] = pfwd.forward(pm, pd)
    assert int(out["touch"].nefc_active.sum()) > 0
    rng = out["range"].sensordata[:, 0]
    assert bool((rng < 0).any()) and bool((rng > 0).any())
    assert int(out["limits"].nefc_active.sum()) > 0
