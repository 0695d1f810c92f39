"""PyTorch port, general path: the analytic narrowphase.

The contact lanes (dist, pos, frame, margins) of the port's batched
``physics.collision.collision`` against the reference's, f64, within 1e-10,
from numpy-seeded poses (the reference's kinematics + collision under one
``jit(vmap)`` per model): every plane pair (sphere, capsule, box,
cylinder, ellipsoid), sphere-sphere/capsule/box/cylinder, capsule-capsule,
capsule-box and box-box (SAT and face clipping, whose top_k compaction the
port reproduces with a stable sort).  ``geom_distance`` on primitive pairs
is held to the same bar.  A model with an MPR, height-field or mesh pair
resets and collides, its lanes equal to the reference's eager
``collision()`` (the narrowphases themselves are held to the reference in
``test_torch_mpr.py``, ``test_torch_hfield.py`` and
``test_torch_mesh.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oxide_control_tpu.mjcf.compile import (
    load_model_from_xml as ref_load_model_from_xml,
)
from oxide_control_tpu.physics import collision as rcoll
from oxide_control_tpu.physics import smooth as rsmooth
from oxide_control_tpu.state import make_data as ref_make_data
from test_hfield import FLAT_XML
from test_mpr import ELLBOX_XML, TET_MESH_XML
from test_torch_general_smooth import err, models, seeded

import chip_smoke
from oxide_control_torch import bench_configs
from oxide_control_torch.api.environment import BatchedEnvironment
from oxide_control_torch.bench_configs import BenchTask
from oxide_control_torch.mjcf.compile import load_model_from_xml
from oxide_control_torch.physics import collision as pcoll
from oxide_control_torch.physics import smooth as psmooth

BAR = 1e-10

# sphere-capsule, sphere-sphere, sphere-cylinder and capsule-capsule
# beside the plane pairs (the drum meets the second ball only: a capsule-
# cylinder pair would need the MPR narrowphase)
PRIM_XML = """
<mujoco>
  <worldbody>
    <geom name="floor" type="plane" size="5 5 .1"/>
    <geom name="rod" type="capsule" fromto="-0.3 0 0.1 0.3 0 0.1"
          size="0.05"/>
    <geom name="drum" type="cylinder" pos="0.8 0 0.1" size="0.1 0.1"
          contype="2" conaffinity="2"/>
    <body pos="0 0 0.22">
      <freejoint/>
      <geom name="ball" type="sphere" size="0.08" mass="1"/>
    </body>
    <body pos="0.2 0 0.27">
      <freejoint/>
      <geom name="pill" type="capsule" size="0.05 0.12" mass="1"/>
    </body>
    <body pos="0.8 0 0.27">
      <freejoint/>
      <geom name="ball2" type="sphere" size="0.08" mass="1" contype="3"
            conaffinity="3"/>
    </body>
  </worldbody>
</mujoco>
"""

# model -> (xml, amplitude of the seeded qpos noise)
MODELS = {
    "box_pairs": (lambda: chip_smoke.BOX_PAIRS_XML, 0.6),
    # the three bodies lowered to the floor
    "plane_shapes": (lambda: chip_smoke.PLANE_SHAPES_XML.replace(
        'pos="0 0 0.35"', 'pos="0 0 0.1"').replace(
        'pos="0.6 0 0.3"', 'pos="0.6 0 0.12"').replace(
        'pos="1.2 0 0.3"', 'pos="1.2 0 0.1"'), 0.3),
    "box_stack": (lambda: chip_smoke.BOX_STACK_XML, 0.08),
    "arms": (lambda: bench_configs.ARMS_XML, 0.3),
    "prims": (lambda: PRIM_XML, 0.15),
}


def _ref_collide(rm):
    return jax.jit(jax.vmap(lambda d: rcoll.collision(
        rm, rsmooth.kinematics(rm, d)).contact))


@pytest.fixture(scope="module", params=sorted(MODELS))
def contacts(request):
    xml, qnoise = MODELS[request.param]
    rm, pm = models(xml())
    rd, pd = seeded(rm, pm, seed=11, qnoise=qnoise, b=8)
    pc = pcoll.collision(pm, psmooth.kinematics(pm, pd)).contact
    return request.param, (rm, pm), (rd, pd), _ref_collide(rm)(rd), pc


def test_pair_groups_are_primitives(contacts):
    _, (rm, pm), _, _, _ = contacts
    assert pm.pair_groups and all(
        (pcoll.GeomType(t1), pcoll.GeomType(t2)) in pcoll._PRIMS
        for (t1, t2, _) in pm.pair_groups)


@pytest.mark.parametrize("field", ["dist", "pos", "frame", "includemargin",
                                   "friction", "solref", "solimp"])
def test_contact_lanes_match_reference(contacts, field):
    name, _, _, rc, pc = contacts
    e = err(getattr(rc, field), getattr(pc, field))
    assert e < BAR, (name, field, e)


def test_some_lanes_are_active(contacts):
    """The seeded poses put some pairs in contact (the bar is not met on
    inactive lanes alone)."""
    name, _, _, rc, pc = contacts
    active = (pc.dist < pc.includemargin).sum().item()
    assert active > 0, name
    assert active == int(np.sum(np.asarray(rc.dist)
                                < np.asarray(rc.includemargin)))


def test_geom_distance_matches_reference(contacts):
    """geom_distance on every primitive pair of the model."""
    name, (rm, pm), (rd, pd), _, _ = contacts
    rk = jax.jit(jax.vmap(lambda d: rsmooth.kinematics(rm, d)))(rd)
    pk = psmooth.kinematics(pm, pd)
    for (t1, t2, pairs) in pm.pair_groups:
        for (g1, g2) in pairs[:2]:
            want = jax.jit(jax.vmap(
                lambda d: rcoll.geom_distance(rm, d, g1, g2)))(rk)
            got = pcoll.geom_distance(pm, pk, g1, g2)
            for w, g in zip(want, got):
                assert err(w, g) < BAR, (name, g1, g2)


@pytest.mark.parametrize("xml", [ELLBOX_XML, TET_MESH_XML, FLAT_XML],
                         ids=["mpr", "mesh", "hfield"])
def test_mpr_hfield_mesh_pairs_raise(xml):
    """Models with MPR, mesh and height-field pairs, which raised before
    their narrowphases were ported: ``reset`` runs, and ``collision`` on
    the reset state gives the reference's lanes."""
    model = load_model_from_xml(xml, dtype=np.float64)
    rm = ref_load_model_from_xml(xml, dtype=np.float64)
    benv = BatchedEnvironment(model, BenchTask(), 2, device="cpu",
                              dtype=torch.float64)
    data = benv.reset(torch.Generator().manual_seed(0))
    got = pcoll.collision(model, data).contact
    for e in range(2):
        d = ref_make_data(rm).replace(
            geom_xpos=jnp.asarray(data.geom_xpos[e].numpy()),
            geom_xmat=jnp.asarray(data.geom_xmat[e].numpy()))
        want = rcoll.collision(rm, d).contact
        for f in ("dist", "pos", "frame", "includemargin", "friction"):
            assert err(getattr(want, f), getattr(got, f)[e]) < BAR, f
