"""PyTorch port, general path: the height-field narrowphases against the
reference.

``_hfield_surface``, the two analytic height-field pairs that the
dispatcher runs (sphere, capsule) and the box's prism MPR on the
reference's ridged field (``_RIDGE_XML`` of ``tests/test_hfield.py``: 18
prisms x 5 lanes = 90 lanes) against the reference's functions and its
``collision()``, all run eagerly (the reference's ``jit`` step of this
model compiles for over two minutes), f64, within 1e-10, from
numpy-seeded poses over the field, its edges included (the window clamps
there).  A group of pairs over two fields of different grids, one of
them turned, runs as one batch against the reference's per-pair loop.
Plus the port's compiler on height fields: normalization, the storage
convention against MuJoCo 3.10.0, and the rejection of mesh against
height field.
"""

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from oxide_control_tpu.physics import collision as rc
from test_hfield import FLAT_XML, VALLEY_XML, _RIDGE_XML
from test_torch_general_smooth import err, models
from test_torch_mpr import pose_data, quat_mats

from oxide_control_torch.api.errors import UnsupportedFeatureError
from oxide_control_torch.mjcf.compile import load_model_from_xml
from oxide_control_torch.physics import collision as pc
from oxide_control_torch.physics.consts import consts

BAR = 1e-10
B = 8
F64 = torch.float64


def t(a):
    return torch.as_tensor(np.array(a), dtype=F64)


@pytest.fixture(scope="module")
def ridge():
    """(reference model, port model, the reference's field arguments,
    the port's HField of geom 0)."""
    rm, pm = models(_RIDGE_XML)
    nrow, ncol = rm.hfield_nrow[0], rm.hfield_ncol[0]
    data = jnp.asarray(rm.hfield_data).reshape(nrow, ncol)
    hsize = jnp.asarray(rm.hfield_size[0])
    hf = pc.hfield_consts(pm, consts(pm, torch.zeros(1, dtype=F64)), [0])
    return rm, pm, (hsize, nrow, ncol, data), hf


def test_hfield_surface_matches_reference(ridge):
    """Signed distance and normal over the whole field and past its edges
    (clamped), both triangles of the cells."""
    _, _, (hsize, nrow, ncol, data), hf = ridge
    rng = np.random.default_rng(0)
    pl = np.concatenate([rng.uniform(-1.7, 1.7, (64, 2)),
                         rng.uniform(-0.1, 0.4, (64, 1))], 1)
    want = jax.vmap(lambda p: rc._hfield_surface(hsize, nrow, ncol, data,
                                                 p))(jnp.asarray(pl))
    got = pc._hfield_surface(hf, t(pl))
    for w, g in zip(want, got):
        assert err(w, g) < BAR


# the analytic pairs of the dispatcher (box, ellipsoid and cylinder go
# through the prism MPR)
SIZES = {"sphere": [0.1, 0, 0], "capsule": [0.06, 0.3, 0]}


@pytest.mark.parametrize("kind", sorted(SIZES))
def test_hfield_pair_matches_reference(ridge, kind):
    """The analytic pair functions on seeded poses over the field (some
    below the surface, some above, some near the edges)."""
    _, _, (hsize, nrow, ncol, data), hf = ridge
    rng = np.random.default_rng(1)
    cpos = np.concatenate([rng.uniform(-1.6, 1.6, (B, 2)),
                           rng.uniform(0.0, 0.3, (B, 1))], 1)
    cmat = quat_mats(rng, B)
    hpos, hmat = np.zeros(3), np.eye(3)
    size = np.array(SIZES[kind])
    rfn = getattr(rc, f"_hfield_{kind}")
    want = jax.vmap(lambda p, m: rfn(
        jnp.asarray(hpos), jnp.asarray(hmat), hsize, nrow, ncol, data, p, m,
        jnp.asarray(size)))(jnp.asarray(cpos), jnp.asarray(cmat))
    got = getattr(pc, f"_hfield_{kind}")(
        t(hpos).expand(B, 3), t(hmat).expand(B, 3, 3), hf, t(cpos), t(cmat),
        t(size).expand(B, 3))
    for w, g in zip(want, got):
        assert err(w, g) < BAR, kind
    assert 0 < int(np.sum(np.asarray(want[0]) < 0)) < want[0].size, kind


def lanes(c):
    """A contact's lanes as (..., L, 13): dist, pos, frame."""
    dist = np.asarray(c.dist)
    return np.concatenate([dist[..., None], np.asarray(c.pos),
                           np.asarray(c.frame).reshape(dist.shape + (9,))],
                          -1)


def nudged(pd, rng, rel=1e-12):
    """``pd`` with its geoms' poses scaled by 1 + U(-rel, rel)."""
    jig = lambda x: x * (1 + rel * t(rng.uniform(-1, 1, x.shape)))
    return pd.replace(geom_xpos=jig(pd.geom_xpos),
                      geom_xmat=jig(pd.geom_xmat))


def ref_pose(rd, pd, i=0):
    """Env ``i`` of the reference's Data with the port's geom poses."""
    return jax.tree.map(lambda x: x[0], rd).replace(
        geom_xpos=jnp.asarray(pd.geom_xpos[i].numpy()),
        geom_xmat=jnp.asarray(pd.geom_xmat[i].numpy()))


# (x, y, z) of the box over the ridged field: near its peak, and at its
# edge (where the 3x3 window clamps)
PRISM_POSES = {"inner": [-0.3, 0.4, 0.1], "edge": [1.45, -0.9, 0.05]}


def prism_pose(where):
    rm, pm = models(_RIDGE_XML)
    rd, pd = pose_data(rm, pm, 1, np.random.default_rng(2), [0, 0, 0],
                       0.0, b=1)
    pd.geom_xpos[:, 1] = t([PRISM_POSES[where]])
    return rm, pm, rd, pd


@pytest.mark.parametrize("where", sorted(PRISM_POSES))
def test_hfield_prism_mpr_matches_reference(where):
    """The 90 lanes of the box's prism MPR through ``collision()`` (the
    3x3 window's 18 prisms, each MPR lane and its four manifold probes):
    every lane, separated prisms and probes included, within 1e-10 of the
    reference's eager ``collision()`` (one pose: 1.3-6 s there), with
    penetrating lanes among them."""
    rm, pm, rd, pd = prism_pose(where)
    got = pc.collision(pm, pd).contact
    want = rc.collision(rm, ref_pose(rd, pd)).contact
    for f in ("dist", "pos", "frame"):
        assert err(getattr(want, f), getattr(got, f)[0]) < BAR, (where, f)
    assert int((got.dist[0] < 0).sum()) > 0, where


def test_hfield_prism_ties_move_both_sides():
    """Why the two-field test below lets separated prisms part: MPR
    against a prism switches its support between vertices
    discontinuously, and both its converged portal refinement and the
    separated prisms' normal polish end on such switches.  One 1e-12
    relative nudge of the poses at the edge pose (where every lane agrees
    unnudged) moves lanes by far more than 1e-10 on each side, the
    reference's as well as the port's."""
    rm, pm, rd, pd = prism_pose("edge")
    pn = nudged(pd, np.random.default_rng(0))
    port = [lanes(pc.collision(pm, d).contact)[0] for d in (pd, pn)]
    ref = [lanes(rc.collision(rm, ref_pose(rd, d)).contact) for d in (pd, pn)]
    moves = [float(np.abs(a - b).max()) for a, b in (port, ref)]
    assert min(moves) > 1e-6, moves


# a second field beside the ridge: another grid (5 x 7 cells), turned
# about z; each box collides with its own field (contype/conaffinity), so
# one pair group holds the pairs (ridge, box 1) and (bumps, box 2)
_RIDGE_ASSET = _RIDGE_XML[_RIDGE_XML.index("<asset>"):
                          _RIDGE_XML.index("</asset>")]
_TWO_FIELDS = """
<mujoco>
  {asset}
    <hfield name="bumps" nrow="5" ncol="7" size="1 0.8 0.3 0.05"
            elevation="0 .3 .1 .6 .2 0 .4  .5 .1 .9 .3 .7 .2 0
                       .2 .8 .4 1 .5 .1 .3  .6 .2 .7 .1 .4 .9 .2
                       0 .4 .3 .5 .2 .6 .1"/>
  </asset>
  <worldbody>
    <geom name="h1" type="hfield" hfield="terrain" pos="-1.6 0 0"
          contype="1" conaffinity="0"/>
    <geom name="h2" type="hfield" hfield="bumps" pos="1.2 0 0"
          euler="0 0 30" contype="2" conaffinity="0"/>
    <body name="b1" pos="-1.3 0.2 0.6">
      <freejoint/>
      <geom name="g1" {geom1} contype="0" conaffinity="1"/>
    </body>
    <body name="b2" pos="1.2 0.1 0.5">
      <freejoint/>
      <geom name="g2" {geom2} contype="0" conaffinity="2"/>
    </body>
  </worldbody>
</mujoco>
"""


def two_fields(geom1, geom2):
    """(reference model, port model) of the two fields, each with its own
    free geom; their one pair group spans both fields."""
    rm, pm = models(_TWO_FIELDS.format(asset=_RIDGE_ASSET, geom1=geom1,
                                       geom2=geom2))
    (_, _, pairs), = pm.pair_groups
    assert pairs == ((0, 2), (1, 3))
    return rm, pm


def two_field_poses(rm, pm, rng, local1, local2, b):
    """The free geoms at the field-local points ``local1``/``local2 (b,
    3)``, seeded rotations."""
    rd, pd = pose_data(rm, pm, 2, rng, [0, 0, 0], 0.0, b=b)
    for g, h, loc in ((2, 0, local1), (3, 1, local2)):
        pd.geom_xpos[:, g] = pd.geom_xpos[:, h] + (
            pd.geom_xmat[:, h] @ t(loc)[..., None])[..., 0]
        pd.geom_xmat[:, g] = t(quat_mats(rng, b))
    rd = rd.replace(geom_xpos=jnp.asarray(pd.geom_xpos.numpy()),
                    geom_xmat=jnp.asarray(pd.geom_xmat.numpy()))
    return rd, pd


def test_hfield_sphere_group_over_two_fields():
    """The analytic sphere pairs of one group over two fields of different
    grids and sizes, one turned, batched over the pairs: every lane within
    1e-10 of the reference's per-pair dispatch, on seeded points all over
    both fields."""
    rm, pm = two_fields('type="sphere" size="0.1" mass="1"',
                        'type="sphere" size="0.06" mass="1"')
    rng = np.random.default_rng(4)
    loc1 = np.concatenate([rng.uniform(-1.5, 1.5, (B, 2)),
                           rng.uniform(0.0, 0.3, (B, 1))], 1)
    loc2 = np.concatenate([rng.uniform(-1, 1, (B, 1)),
                           rng.uniform(-0.8, 0.8, (B, 1)),
                           rng.uniform(0.0, 0.35, (B, 1))], 1)
    rd, pd = two_field_poses(rm, pm, rng, loc1, loc2, B)
    want = jax.vmap(lambda d: rc.collision(rm, d).contact)(rd)
    got = pc.collision(pm, pd).contact
    for f in ("dist", "pos", "frame", "includemargin"):
        assert err(getattr(want, f), getattr(got, f)) < BAR, f
    assert bool((got.dist[:, 0] < 0).any() and (got.dist[:, 1] < 0).any())


def test_hfield_prism_group_over_two_fields():
    """Two boxes of different sizes, each on its own field (9 x 9 and a
    turned 5 x 7), in one prism group: each pair's 90 lanes, batched,
    equal the pair run alone bit for bit (per-pair grid, data offset and
    manifold gate), and every active lane (dist < includemargin on either
    side) of both pairs is within 1e-10 of the reference's per-pair
    ``collision()``, as is every lane but a few separated ones, whose
    normal polish ends on a rounding-level tie (the test above).  On some
    other seeded rotations a lane ~15 cm deep parts as well: there the
    portal itself sits on such a tie."""
    rm, pm = two_fields('type="box" size="0.12 0.1 0.08" mass="1"',
                        'type="box" size="0.05 0.07 0.04" mass="1"')
    rd, pd = two_field_poses(rm, pm, np.random.default_rng(1),
                             [[-0.3, 0.4, 0.1]], [[0.1, 0.2, 0.1]], 1)
    pairs = ((0, 2), (1, 3))
    both = pc._hfield_pairs(pm, pd, pairs)
    for i, pair in enumerate(pairs):
        for x, y in zip(both, pc._hfield_pairs(pm, pd, [pair])):
            assert torch.equal(x[:, i], y[:, 0]), pair
    c = pc.collision(pm, pd).contact
    got = lanes(c)[0]
    want_c = rc.collision(rm, ref_pose(rd, pd)).contact
    want = lanes(want_c)
    margin = c.includemargin[0].numpy()
    active = (got[:, 0] < margin) | (want[:, 0] < margin)
    parted = np.abs(got - want).max(-1) >= BAR
    assert not (parted & active).any(), np.flatnonzero(parted & active)
    assert parted.sum() <= 10, np.flatnonzero(parted)
    pen = (got[:, 0] < 0).reshape(2, 90)
    assert pen[0].any() and pen[1].any()


def test_hfield_compiles_and_normalizes():
    m = load_model_from_xml(VALLEY_XML)
    assert m.nhfield == 1
    assert m.hfield_nrow == (3,) and m.hfield_ncol == (5,)
    data = np.asarray(m.hfield_data).reshape(3, 5)
    assert data.max() == 1.0 and data.min() == 0.0
    assert m.geom_dataid[0] == 0
    ref = mujoco.MjModel.from_xml_string(VALLEY_XML)
    np.testing.assert_allclose(data.reshape(-1), ref.hfield_data,
                               atol=1e-12)


def test_hfield_storage_convention_golden():
    """Inline elevation rows are stored reversed (first line = max y), as
    MuJoCo stores them."""
    ref = mujoco.MjModel.from_xml_string(_RIDGE_XML)
    m = load_model_from_xml(_RIDGE_XML)
    np.testing.assert_allclose(np.asarray(m.hfield_data),
                               ref.hfield_data.ravel(), atol=1e-12)


def test_hfield_mesh_pair_rejected():
    """Mesh against height field stays the compiler's loud rejection."""
    xml = """
<mujoco>
  <asset>
    <hfield name="h" nrow="3" ncol="3" size="1 1 0.2 0.1"
            elevation="0 0 0 0 1 0 0 0 0"/>
    <mesh name="tet" vertex="0 0 0  0.1 0 0  0 0.1 0  0 0 0.1"/>
  </asset>
  <worldbody>
    <geom type="hfield" hfield="h"/>
    <body pos="0 0 1"><freejoint/>
      <geom type="mesh" mesh="tet" mass="0.2"/></body>
  </worldbody>
</mujoco>
"""
    with pytest.raises(UnsupportedFeatureError):
        load_model_from_xml(xml)


def test_flat_field_lanes_match_reference():
    """The sphere on the flat field through ``collision()``."""
    rm, pm = models(FLAT_XML)
    rd, pd = pose_data(rm, pm, 1, np.random.default_rng(0),
                       [0.3, 0.2, 0.08], 0.1)
    want = jax.vmap(lambda d: rc.collision(rm, d).contact)(rd)
    got = pc.collision(pm, pd).contact
    for f in ("dist", "pos", "frame", "includemargin"):
        assert err(getattr(want, f), getattr(got, f)) < BAR, f
