"""PyTorch port, general path: the smooth stages against the reference.

The same numpy-seeded states (B = 4 envs, f64) go through the reference's
``forward`` (``jax.jit(jax.vmap(...))``, once per model in a module-scope
fixture) and the port's batched ``physics.forward.forward``; every stage's
fields must agree within 1e-10 (the reference's ``test_smooth`` bar):
kinematics, com/CRB/qM, velocities and RNE, passive forces, actuation and
the smooth acceleration.  The models: cheetah (hinges, slides, motors),
walker with the knee-coupler tendon and torso sensors, the bench's
muscle arm (a spatial tendon wrapping a sphere with a sidesite, a muscle),
the fluid model (density, viscosity, wind, a ball joint) and the
stateful-actuator arm (filter, filterexact, integrator).

The helpers here are shared by the other ``test_torch_general_*`` files.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oxide_control_tpu.mjcf.compile import (
    load_model_from_xml as ref_load_model_from_xml,
)
from oxide_control_tpu.physics import forward as rfwd
from oxide_control_tpu.state import make_data as ref_make_data

import chip_smoke
from oxide_control_torch import bench_configs
from oxide_control_torch.mjcf.compile import load_model_from_xml
from oxide_control_torch.physics import forward as pfwd
from oxide_control_torch.state import make_data
from oxide_control_torch.suite.common import asset_path

B = 4
BAR = 1e-10


def suite_xml(name, extra=None):
    with open(asset_path(name)) as f:
        xml = f.read()
    return xml if extra is None else xml.replace("</mujoco>", extra)


def models(xml, modify=None):
    """(reference model, port model), both f64."""
    rm = ref_load_model_from_xml(xml, dtype=np.float64)
    pm = load_model_from_xml(xml, dtype=np.float64)
    if modify is not None:
        rm, pm = modify(rm), modify(pm)
    return rm, pm


def seeded(rm, pm, seed=0, qnoise=0.05, vnoise=0.5, b=B, dtype=np.float64,
           shift=None):
    """(reference Data, port Data): qpos0 + U(-qnoise, qnoise) (plus the
    offsets ``shift {qpos index: offset}``), qvel, ctrl and act drawn from
    one numpy seed, on B envs."""
    rng = np.random.default_rng(seed)
    qpos = np.asarray(rm.qpos0)[None] + qnoise * rng.uniform(-1, 1,
                                                             (b, rm.nq))
    for i, off in (shift or {}).items():
        qpos[:, i] += off
    qvel = vnoise * rng.uniform(-1, 1, (b, rm.nv))
    ctrl = rng.uniform(-1, 1, (b, rm.nu))
    act = rng.uniform(0, 0.5, (b, rm.na))
    arrs = [a.astype(dtype) for a in (qpos, qvel, ctrl, act)]
    rd = jax.vmap(lambda q, v, c, a: ref_make_data(rm).replace(
        qpos=q, qvel=v, ctrl=c, act=a))(*map(jnp.asarray, arrs))
    pd = make_data(pm, "cpu", torch.from_numpy(arrs[0]).dtype, batch=b)
    pd = pd.replace(**{k: torch.from_numpy(a) for k, a in zip(
        ("qpos", "qvel", "ctrl", "act"), arrs)})
    return rd, pd


def ref_batched(rm, fn):
    """The reference's ``jit(vmap(fn(model, d)))``."""
    return jax.jit(jax.vmap(lambda d: fn(rm, d)))


def err(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = b.detach().numpy().astype(np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max()) if a.size else 0.0


MODELS = {
    "cheetah": lambda: suite_xml("cheetah"),
    "walker_ts": lambda: suite_xml("walker",
                                   bench_configs.WALKER_TENDON_SENSORS),
    "arm": lambda: bench_configs.MUSCLE_WRAP_XML,
    "fluid": lambda: chip_smoke.FLUID_XML,
    "stateful": lambda: chip_smoke.STATEFUL_XML,
}

STAGES = {
    "kinematics": ("xpos", "xquat", "xmat", "xipos", "ximat", "xanchor",
                   "xaxis", "geom_xpos", "geom_xmat", "site_xpos",
                   "site_xmat"),
    "com_crb": ("subtree_com", "cinert_i", "cinert_h", "cdof", "qM"),
    "rne": ("cvel", "cdof_dot", "qfrc_bias"),
    "passive": ("qfrc_passive",),
    "actuation": ("actuator_length", "actuator_velocity", "actuator_force",
                  "act_dot", "qfrc_actuator"),
    "smooth_acc": ("qfrc_smooth", "qacc_smooth"),
}


@pytest.fixture(scope="module", params=sorted(MODELS))
def forward_pair(request):
    """(name, models, reference forward Data, port forward Data) of one
    model: the reference compiles once per model."""
    rm, pm = models(MODELS[request.param]())
    rd, pd = seeded(rm, pm, seed=3)
    return (request.param, (rm, pm), ref_batched(rm, rfwd.forward)(rd),
            pfwd.forward(pm, pd))


@pytest.mark.parametrize("stage", sorted(STAGES))
def test_stage_matches_reference(forward_pair, stage):
    name, _, rf, pf = forward_pair
    for field in STAGES[stage]:
        e = err(getattr(rf, field), getattr(pf, field))
        assert e < BAR, (name, field, e)


def test_tendon_lengths_and_moments(forward_pair):
    """Tendon lengths and moments (the arm's spatial tendon wraps a sphere
    past a sidesite; walker's is fixed) within the bar."""
    from oxide_control_tpu.physics import smooth as rsmooth
    from oxide_control_torch.physics import smooth as psmooth

    name, (rm, pm), rf, pf = forward_pair
    if not pm.ntendon:
        assert not rm.ntendon
        return
    rl, rmom = jax.vmap(lambda d: rsmooth.tendon_length_moment(rm, d))(rf)
    pl, pmom = psmooth.tendon_length_moment(pm, pf)
    assert err(rl, pl) < BAR and err(rmom, pmom) < BAR, name
