"""PyTorch port, general path: meshes against the reference and MuJoCo.

``_plane_mesh`` (the 4 deepest hull vertices as lanes) against the
reference's on a hull resting face down, whose four bottom vertices tie
(the port's stable sort must keep the reference's ``top_k`` lane order),
and on tilted poses; two meshes of different vertex counts in one
plane-mesh group through ``collision()`` (the port pads the group's
meshes); and the port's compiler on meshes: the hull mass properties
against MuJoCo 3.10.0 and the binary STL round trip (the reference's
``tests/test_mesh.py``, ported).  f64, within 1e-10.
"""

import struct

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from oxide_control_tpu.physics import collision as rc
from test_mesh import MESH_XML, TETRA_VERTS
from test_torch_general_smooth import err, models
from test_torch_mpr import SLAB, pose_data, quat_mats

from oxide_control_torch.mjcf.compile import load_model_from_xml
from oxide_control_torch.physics import collision as pc

BAR = 1e-10
F64 = torch.float64


def t(a):
    return torch.as_tensor(np.array(a), dtype=F64)


def test_plane_mesh_face_down_tie_order():
    """The slab resting on its bottom face (four vertices at one depth)
    and seeded tilts: dist, pos and frame of the 4 lanes, in the
    reference's order."""
    rng = np.random.default_rng(0)
    b = 6
    mpos = np.concatenate([rng.uniform(-0.5, 0.5, (b, 2)),
                           rng.uniform(-0.02, 0.05, (b, 1))], 1)
    mmat = quat_mats(rng, b, tilt=0.3)
    mmat[:2] = np.eye(3)                      # face down: four-way ties
    mpos[0, 2] = 0.0
    ppos, pmat = np.zeros(3), np.eye(3)
    want = jax.vmap(lambda p, m: rc._plane_mesh(
        jnp.asarray(ppos), jnp.asarray(pmat), p, m, jnp.asarray(SLAB)))(
        jnp.asarray(mpos), jnp.asarray(mmat))
    verts = np.concatenate([SLAB, np.repeat(SLAB[:1], 3, 0)])
    valid = torch.tensor([True] * 8 + [False] * 3)
    got = pc._plane_mesh(t(ppos).expand(b, 3), t(pmat).expand(b, 3, 3),
                         t(mpos), t(mmat), t(verts), valid)
    for w, g in zip(want, got):
        assert err(w, g) < BAR
    # env 0: the bottom face's four vertices, in index order, at depth 0
    np.testing.assert_array_equal(got[0][0].numpy(), 0.0)
    np.testing.assert_allclose(got[1][0].numpy(), SLAB[:4] + mpos[0],
                               atol=1e-15)


TWO_MESH_XML = f"""
<mujoco>
  <asset>
    <mesh name="tetra" vertex="{TETRA_VERTS}"/>
    <mesh name="slab" vertex="{' '.join(f'{v:g}' for v in SLAB.ravel())}"/>
  </asset>
  <worldbody>
    <geom name="floor" type="plane" size="2 2 0.1" contype="3"
          conaffinity="3"/>
    <body name="a" pos="0 0 0.3">
      <freejoint/>
      <geom type="mesh" mesh="tetra" mass="0.3"/>
    </body>
    <body name="b" pos="1 0 0.3">
      <freejoint/>
      <geom type="mesh" mesh="slab" mass="1" contype="2" conaffinity="2"/>
    </body>
  </worldbody>
</mujoco>
"""


def test_plane_mesh_group_of_two_meshes():
    """One plane-mesh group over a tetrahedron (4 vertices) and a slab
    (8), both near the floor, through ``collision()``."""
    rm, pm = models(TWO_MESH_XML)
    (t1, t2, pairs), = pm.pair_groups
    assert len(pairs) == 2
    rng = np.random.default_rng(1)
    rd, pd = pose_data(rm, pm, 1, rng, [0.0, 0.0, 0.05], 0.05, b=4)
    pd.geom_xpos[:, 2] = t([1.0, 0.0, 0.1]) + 0.05 * t(rng.uniform(
        -1, 1, (4, 3)))
    pd.geom_xmat[:, 2] = t(quat_mats(rng, 4, tilt=0.3))
    rd = rd.replace(geom_xpos=jnp.asarray(pd.geom_xpos.numpy()),
                    geom_xmat=jnp.asarray(pd.geom_xmat.numpy()))
    want = jax.vmap(lambda d: rc.collision(rm, d).contact)(rd)
    got = pc.collision(pm, pd).contact
    for f in ("dist", "pos", "frame", "includemargin"):
        assert err(getattr(want, f), getattr(got, f)) < BAR, f
    assert bool((got.dist < 0).any())


def test_mesh_mass_properties_golden():
    """Hull volume/com/principal inertia against the oracle."""
    ref = mujoco.MjModel.from_xml_string(MESH_XML)
    m = load_model_from_xml(MESH_XML)
    np.testing.assert_allclose(float(m.body_mass[1]), ref.body_mass[1],
                               rtol=1e-9)
    np.testing.assert_allclose(np.asarray(m.body_inertia[1]),
                               ref.body_inertia[1], rtol=1e-7)
    np.testing.assert_allclose(np.asarray(m.body_ipos[1]), ref.body_ipos[1],
                               atol=1e-10)
    assert m.nmesh == 1 and m.geom_dataid == (-1, 0)
    assert m.mesh_vertnum == (4,)
    assert np.linalg.norm(np.mean(np.asarray(m.mesh_vert), axis=0)) < 0.2


def test_mesh_stl_roundtrip(tmp_path):
    """Binary STL loading gives the same hull as inline vertices."""
    verts = np.array(TETRA_VERTS.split(), dtype=float).reshape(-1, 3)
    faces = [(0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3)]
    path = tmp_path / "tetra.stl"
    with open(path, "wb") as f:
        f.write(b"\x00" * 80)
        f.write(struct.pack("<I", len(faces)))
        for face in faces:
            f.write(struct.pack("<3f", 0, 0, 1))
            for vi in face:
                f.write(struct.pack("<3f", *verts[vi]))
            f.write(struct.pack("<H", 0))
    xml = f"""
<mujoco>
  <asset><mesh name="t" file="{path}"/></asset>
  <worldbody>
    <body name="b" pos="0 0 1"><freejoint/>
      <geom type="mesh" mesh="t" mass="0.3"/></body>
  </worldbody>
</mujoco>
"""
    m_stl = load_model_from_xml(xml)
    m_inl = load_model_from_xml(MESH_XML)
    np.testing.assert_allclose(np.asarray(m_stl.body_inertia[1]),
                               np.asarray(m_inl.body_inertia[1]), rtol=1e-6)
