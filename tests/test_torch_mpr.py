"""PyTorch port, general path: the MPR narrowphase against the reference.

``_support_local`` for the six convex types, ``_mpr``, ``_manifold_lanes``
and ``_mpr_pair`` of the port's ``physics.collision`` against the
reference's functions, run eagerly under ``jax.vmap`` (no ``jit``) on the
same numpy-seeded poses, f64, within 1e-10; ``geom_distance`` and the
geomdist / geomnormal / geomfromto sensors on MPR pairs to the same bar;
the reference's static contact parity against MuJoCo 3.10.0
(``tests/test_mpr.py``), ported; and one f64 env step of the
ellipsoid-on-box and sphere-on-mesh models against the reference's
``jit`` step within 1e-8, from tie-free seeds.  One group of two mesh
pairs of different vertex counts runs as one batch against the
reference's per-pair ``_mpr_pair``.  Every seed is checked tie-free on
both sides: a 1e-12 nudge of its poses moves neither side's result.
"""

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from oxide_control_tpu.model import GeomType
from oxide_control_tpu.physics import collision as rc
from oxide_control_tpu.physics import forward as rfwd
from oxide_control_tpu.physics import sensor as rsensor
from oxide_control_tpu.state import make_data as rmake
from test_mpr import CAPCYL_XML, ELLBOX_XML, TET_MESH_XML
from test_torch_general_smooth import err, models, seeded

from oxide_control_torch.mjcf.compile import load_model_from_xml
from oxide_control_torch.physics import collision as pc
from oxide_control_torch.physics import forward as pfwd
from oxide_control_torch.physics import sensor as psensor
from oxide_control_torch.state import make_data

BAR = 1e-10
B = 8
F64 = torch.float64

TET = np.array([[0, 0, 0], [0.3, 0, 0], [0, 0.3, 0], [0.15, 0.15, 0.35]])
# a slab: flat faces, and vertices tied along the axes
SLAB = np.array([[-0.4, -0.4, 0], [0.4, -0.4, 0], [0.4, 0.4, 0],
                 [-0.4, 0.4, 0], [-0.3, -0.3, 0.2], [0.3, -0.3, 0.2],
                 [0.3, 0.3, 0.2], [-0.3, 0.3, 0.2]])


def t(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


def quat_mats(rng, b, tilt=1.0):
    """b rotation matrices from seeded quaternions (tilt scales the
    vector part)."""
    q = np.concatenate([np.ones((b, 1)), tilt * rng.uniform(-1, 1, (b, 3))],
                       1)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x * x + y * y)], -1)], 1)


def directions(rng, n=16):
    """Seeded directions with the degenerate ones a support map must
    handle: zero, zero z (sign 0), zero xy (the cylinder's axis)."""
    dl = rng.normal(size=(n, 3))
    dl[0] = 0.0
    dl[1, 2] = 0.0
    dl[2, :2] = 0.0
    dl[3] = [1.0, 0.0, 0.0]      # ties the slab's vertices along x
    return dl


def padded(verts, v=10):
    return np.concatenate([verts, np.repeat(verts[:1], v - len(verts), 0)])


GTYPES = [GeomType.SPHERE, GeomType.CAPSULE, GeomType.ELLIPSOID,
          GeomType.CYLINDER, GeomType.BOX, GeomType.MESH]


@pytest.mark.parametrize("gtype", GTYPES, ids=lambda g: g.name.lower())
def test_support_local_matches_reference(gtype):
    rng = np.random.default_rng(int(gtype))
    size = rng.uniform(0.05, 0.3, 3)
    dl = directions(rng)
    want = jax.vmap(lambda d: rc._support_local(
        gtype, jnp.asarray(size), jnp.asarray(SLAB), d))(jnp.asarray(dl))
    got = pc._support_local(gtype, t(size).expand(len(dl), 3),
                            t(padded(SLAB)), t(dl))
    assert err(want, got) < BAR


def ref_support(gtype, size, verts, pos, mat):
    def sup(dw):
        return pos + mat @ rc._support_local(gtype, size, verts, mat.T @ dw)
    return sup


# (type1, size1, type2, size2, center and spread of geom1's position,
# seed).  Tie-free seeds: MPR over a polytope's support switches vertices
# discontinuously, and on some poses a rounding-level nudge of the input
# moves the result by up to 1e-1, on both sides; on these it does not
# (``test_mpr_seeds_are_nudge_stable``).
PAIRS = {
    "ellipsoid-box": (GeomType.ELLIPSOID, [0.1, 0.12, 0.08], GeomType.BOX,
                      [0.25, 0.25, 0.1], [0, 0, 0.2], 0.2, 5),
    "sphere-mesh": (GeomType.SPHERE, [0.08, 0, 0], GeomType.MESH,
                    [0.1, 0.1, 0.1], [0.1, 0.1, 0.2], 0.2, 13),
    "capsule-cylinder": (GeomType.CAPSULE, [0.05, 0.12, 0],
                         GeomType.CYLINDER, [0.12, 0.15, 0], [0, 0, 0],
                         0.25, 1),
    "box-mesh": (GeomType.BOX, [0.12, 0.1, 0.1], GeomType.MESH,
                 [0.4, 0.4, 0.2], [0, 0, 0.3], 0.3, 3),
    "cylinder-ellipsoid": (GeomType.CYLINDER, [0.1, 0.1, 0],
                           GeomType.ELLIPSOID, [0.2, 0.15, 0.1], [0, 0, 0.1],
                           0.25, 0),
}


@pytest.fixture(scope="module", params=sorted(PAIRS))
def mpr_case(request):
    """Seeded poses of geom1 around geom2, both support maps, and the
    reference's MPR on them."""
    t1, s1, t2, s2, center, spread, seed = PAIRS[request.param]
    rng = np.random.default_rng(seed)
    verts = TET if request.param == "sphere-mesh" else SLAB
    p1 = spread * rng.uniform(-1, 1, (B, 3)) + center
    m1 = quat_mats(rng, B)
    p2 = np.tile([0.0, 0.0, -0.05], (B, 1))
    m2 = quat_mats(rng, B, tilt=0.2)

    def ref(p1, m1, p2, m2):
        a = ref_support(t1, jnp.asarray(s1, jnp.float64), jnp.asarray(verts),
                        p1, m1)
        b = ref_support(t2, jnp.asarray(s2, jnp.float64), jnp.asarray(verts),
                        p2, m2)
        return a, b

    want = jax.vmap(lambda *x: rc._mpr(*ref(*x), x[0], x[2], jnp.float64))(
        *map(jnp.asarray, (p1, m1, p2, m2)))
    sup1 = pc._Support(t1, t(p1), t(m1), t(s1), t(padded(verts)))
    sup2 = pc._Support(t2, t(p2), t(m2), t(s2), t(padded(verts)))
    return request.param, ref, (p1, m1, p2, m2), want, (sup1, sup2)


def test_mpr_matches_reference(mpr_case):
    name, _, (p1, _, p2, _), want, (sup1, sup2) = mpr_case
    got = pc._mpr(sup1, sup2, t(p1), t(p2))
    for w, g in zip(want, got):
        assert err(w, g) < BAR, name
    # the seeds put some pairs in contact and leave some apart
    assert 0 < int(np.sum(np.asarray(want[0]) < 0)) < B, name


# what a 1e-12 relative nudge of the poses may move a tie-free MPR by: it
# is continuous there, if not well conditioned (up to ~4e-10 seen on the
# ellipsoid-box seeds); on a tie it moves by 1e-4 to 1e-1
TIE = 1e-8


def nudge(rng, *xs, rel=1e-12):
    """Each array scaled by 1 + U(-rel, rel): a rounding-level nudge."""
    return [x * (1 + rel * rng.uniform(-1, 1, np.shape(x))) for x in xs]


def moved(a, b):
    """The largest gap of two arrays or tensors of one shape."""
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


def test_mpr_seeds_are_nudge_stable(mpr_case):
    """The seeds above are tie-free on both sides: a 1e-12 relative nudge
    of every pose moves neither the reference's MPR nor the port's by
    ``TIE``."""
    name, ref, poses, want, (sup1, sup2) = mpr_case
    p1, m1, p2, m2 = nudge(np.random.default_rng(0), *poses)
    want1 = jax.vmap(lambda *x: rc._mpr(*ref(*x), x[0], x[2], jnp.float64))(
        *map(jnp.asarray, (p1, m1, p2, m2)))
    got0 = pc._mpr(sup1, sup2, t(poses[0]), t(poses[2]))
    got1 = pc._mpr(pc._Support(sup1.gtype, t(p1), t(m1), sup1.size,
                               sup1.verts),
                   pc._Support(sup2.gtype, t(p2), t(m2), sup2.size,
                               sup2.verts), t(p1), t(p2))
    for w0, w1, g0, g1 in zip(want, want1, got0, got1):
        assert moved(w0, w1) < TIE, name
        assert moved(g0, g1) < TIE, name


def test_manifold_lanes_match_reference(mpr_case):
    name, ref, poses, (dist, pos, n), (sup1, sup2) = mpr_case
    scale = 0.1

    def one(p1, m1, p2, m2, pos, n):
        return rc._manifold_lanes(*ref(p1, m1, p2, m2), pos, n,
                                  rc.make_frame(n), scale)

    want = jax.vmap(one)(*map(jnp.asarray, poses), pos, n)
    n_t = t(n)
    got = pc._manifold_lanes(sup1, sup2, t(pos), n_t, pc.make_frame(n_t),
                             t(pc.min_extent(scale)).expand(B))
    assert err(jnp.stack(want[0], -1), got[0]) < BAR, name
    assert err(jnp.stack(want[1], -2), got[1]) < BAR, name
    assert err(jnp.stack(want[2], -3), got[2]) < BAR, name


def pose_data(rm, pm, g, rng, center, spread, b=B):
    """(reference Data (vmapped), port Data (B envs)) of the model's rest
    geom poses with geom ``g`` moved to seeded poses around ``center``."""
    rd0 = rmake(rm)
    xpos = np.repeat(np.asarray(rd0.geom_xpos)[None], b, 0)
    xmat = np.repeat(np.asarray(rd0.geom_xmat)[None], b, 0)
    pd = pfwd.fwd_position(pm, make_data(pm, "cpu", F64, batch=1))
    xpos[:] = pd.geom_xpos[0].numpy()
    xmat[:] = pd.geom_xmat[0].numpy()
    xpos[:, g] = np.asarray(center) + spread * rng.uniform(-1, 1, (b, 3))
    xmat[:, g] = quat_mats(rng, b)
    rd = jax.vmap(lambda p, m: rd0.replace(geom_xpos=p, geom_xmat=m))(
        jnp.asarray(xpos), jnp.asarray(xmat))
    pdb = make_data(pm, "cpu", F64, batch=b).replace(
        geom_xpos=t(xpos), geom_xmat=t(xmat))
    return rd, pdb


# model -> (xml, moved geom, center, spread)
PAIR_MODELS = {
    "ellbox": (ELLBOX_XML, 2, [0.05, 0.02, 0.27], 0.08),
    "tet": (TET_MESH_XML, 2, [0.12, 0.1, 0.38], 0.08),
    "capcyl": (CAPCYL_XML, 2, [0.02, 0.01, 0.33], 0.06),
}


@pytest.mark.parametrize("name", sorted(PAIR_MODELS))
def test_mpr_pair_matches_reference(name):
    xml, g, center, spread = PAIR_MODELS[name]
    rm, pm = models(xml)
    rd, pd = pose_data(rm, pm, g, np.random.default_rng(3), center, spread)
    (t1, t2, pairs), = [grp for grp in pm.pair_groups
                        if GeomType.PLANE not in grp[:2]]
    (g1, g2), = pairs
    want = jax.vmap(lambda d: rc._mpr_pair(rm, d, g1, g2))(rd)
    got = pc._mpr_pair(pm, pd, pairs)
    for w, gt in zip(want, got):
        assert err(w, gt[:, 0]) < BAR, name
    assert bool((got[0][:, 0, 0] < 0).any()), name


# two static meshes of 4 and 8 vertices (the tetrahedron padded to the
# slab's count in the batch), one turned, and a free ellipsoid: one
# ELLIPSOID-MESH group of two pairs
TWO_MESH_XML = """
<mujoco>
  <asset>
    <mesh name="tet" vertex="0 0 0  0.3 0 0  0 0.3 0  0.15 0.15 0.35"/>
    <mesh name="slab" vertex="-0.4 -0.4 0  0.4 -0.4 0  0.4 0.4 0  -0.4 0.4 0
                              -0.3 -0.3 0.2  0.3 -0.3 0.2  0.3 0.3 0.2
                              -0.3 0.3 0.2"/>
  </asset>
  <worldbody>
    <geom name="tg" type="mesh" mesh="tet" pos="-0.3 0 0"/>
    <geom name="sg" type="mesh" mesh="slab" pos="0.45 0 0" euler="0 0 20"/>
    <body name="e" pos="0 0 0.5">
      <freejoint/>
      <geom name="eg" type="ellipsoid" size="0.12 0.1 0.07" mass="1"/>
    </body>
  </worldbody>
</mujoco>
"""


def test_mpr_group_of_two_meshes_matches_reference():
    """The two pairs of one MPR group batched: each pair's lanes equal the
    pair run alone bit for bit (the tetrahedron padded with copies of its
    vertex 0), and every lane is within 1e-10 of the reference's per-pair
    ``_mpr_pair``, on a seed that puts the ellipsoid into each mesh in
    some envs and where a 1e-12 nudge moves neither side by ``TIE``."""
    rm, pm = models(TWO_MESH_XML)
    (_, _, pairs), = pm.pair_groups
    assert pairs == ((2, 0), (2, 1))
    rng = np.random.default_rng(22)
    rd, pd = pose_data(rm, pm, 2, rng, [0.1, 0.0, 0.27], 0.0)
    pd.geom_xpos[:, 2] = t(np.array([0.1, 0.0, 0.27]) + np.array(
        [0.45, 0.15, 0.08]) * rng.uniform(-1, 1, (B, 3)))
    rd = rd.replace(geom_xpos=jnp.asarray(pd.geom_xpos.numpy()))
    xpos, xmat = nudge(np.random.default_rng(0), pd.geom_xpos.numpy(),
                       pd.geom_xmat.numpy())
    pdn = pd.replace(geom_xpos=t(xpos), geom_xmat=t(xmat))
    rdn = rd.replace(geom_xpos=jnp.asarray(xpos), geom_xmat=jnp.asarray(xmat))
    both, both_n = pc._mpr_pair(pm, pd, pairs), pc._mpr_pair(pm, pdn, pairs)
    for i, pair in enumerate(pairs):
        ref = jax.vmap(lambda d: rc._mpr_pair(rm, d, *pair))
        want, want_n = ref(rd), ref(rdn)
        alone = pc._mpr_pair(pm, pd, [pair])
        for x, y, xn, w, wn in zip(both, alone, both_n, want, want_n):
            assert torch.equal(x[:, i], y[:, 0]), pair
            assert err(w, x[:, i]) < BAR, pair
            assert moved(x[:, i], xn[:, i]) < TIE, pair
            assert moved(w, wn) < TIE, pair
        assert bool((both[0][:, i, 0] < 0).any()), pair


# model -> (center and spread of the moved geom, seed): poses in and out
# of contact, tie-free (``test_geom_distance_seeds_are_nudge_stable``)
DISTANCE_CASES = {
    "ellbox": ([0.05, 0.02, 0.27], 0.16, 1),
    "tet": ([0.12, 0.1, 0.42], 0.08, 8),
    "capcyl": ([0.02, 0.01, 0.33], 0.12, 0),
}


@pytest.mark.parametrize("name", sorted(PAIR_MODELS))
def test_geom_distance_on_mpr_pairs(name):
    xml, g, _, _ = PAIR_MODELS[name]
    center, spread, seed = DISTANCE_CASES[name]
    rm, pm = models(xml)
    rd, pd = pose_data(rm, pm, g, np.random.default_rng(seed), center,
                       spread)
    for g1, g2 in ((g, 1), (1, g)):
        want = jax.vmap(lambda d: rc.geom_distance(rm, d, g1, g2))(rd)
        got = pc.geom_distance(pm, pd, g1, g2)
        for w, gt in zip(want, got):
            assert err(w, gt) < BAR, (name, g1, g2)
    assert 0 < int((got[0] < 0).sum()) < B, name


@pytest.mark.parametrize("name", sorted(PAIR_MODELS))
def test_geom_distance_seeds_are_nudge_stable(name):
    """The distance seeds are tie-free on both sides: a 1e-12 relative
    nudge of the geom poses moves neither side's ``geom_distance`` by
    ``TIE``."""
    xml, g, _, _ = PAIR_MODELS[name]
    center, spread, seed = DISTANCE_CASES[name]
    rm, pm = models(xml)
    rd, pd = pose_data(rm, pm, g, np.random.default_rng(seed), center,
                       spread)
    xpos, xmat = nudge(np.random.default_rng(0), pd.geom_xpos.numpy(),
                       pd.geom_xmat.numpy())
    rdn = rd.replace(geom_xpos=jnp.asarray(xpos), geom_xmat=jnp.asarray(xmat))
    pdn = pd.replace(geom_xpos=t(xpos), geom_xmat=t(xmat))
    ref = jax.vmap(lambda d: rc.geom_distance(rm, d, g, 1))
    for w0, w1 in zip(ref(rd), ref(rdn)):
        assert moved(w0, w1) < TIE, name
    for g0, g1 in zip(pc.geom_distance(pm, pd, g, 1),
                      pc.geom_distance(pm, pdn, g, 1)):
        assert moved(g0, g1) < TIE, name


SENSOR_XML = TET_MESH_XML.replace("</mujoco>", """
  <sensor>
    <distance geom1="bg" geom2="mg" cutoff="0.5"/>
    <normal geom1="bg" geom2="mg" cutoff="0.1"/>
    <fromto geom1="mg" geom2="bg" cutoff="0.1"/>
    <distance body1="ball" body2="base" cutoff="0.1"/>
  </sensor>
</mujoco>""")


def test_geom_sensors_on_mpr_pairs():
    """geomdist, geomnormal and geomfromto on the sphere-mesh pair, some
    poses beyond a cutoff (zero normal and fromto)."""
    rm, pm = models(SENSOR_XML)
    rd, pd = pose_data(rm, pm, 2, np.random.default_rng(1),
                       [0.12, 0.1, 0.5], 0.08)
    want = jax.vmap(lambda d: rsensor.sensor_pos(rm, d).sensordata)(rd)
    got = psensor.sensor_pos(pm, pd).sensordata
    assert err(want, got) < BAR
    assert 0 < int(np.sum(np.asarray(want[:, -1]) < 0.1)) < B


def _static_contact_parity(xml, qpos_list, tol_dist, tol_norm, pair_name):
    """The reference's static parity (tests/test_mpr.py) on the port:
    push geom2 into geom1 at several poses; dist and normal must match
    MuJoCo's convex narrowphase."""
    ref = mujoco.MjModel.from_xml_string(xml)
    rd = mujoco.MjData(ref)
    m = load_model_from_xml(xml, dtype=np.float64)
    d0 = make_data(m, "cpu", F64, batch=1)
    checked = 0
    for qpos in qpos_list:
        rd.qpos[:] = qpos
        mujoco.mj_forward(ref, rd)
        d = pfwd.fwd_position(m, d0.replace(qpos=t([qpos])))
        dist = d.contact.dist[0].numpy()
        g1 = d.contact.geom1[0].numpy()
        g2 = d.contact.geom2[0].numpy()
        types = [(m.geom_type[a], m.geom_type[b]) for a, b in zip(g1, g2)]
        li = next(i for i, ty in enumerate(types) if 0 not in ty)
        mj = [(c.dist, c.frame[:3].copy(), {c.geom1, c.geom2})
              for c in [rd.contact[i] for i in range(rd.ncon)]]
        want = {int(g1[li]), int(g2[li])}
        cands = [x for x in mj if x[2] == want]
        if not cands:
            assert dist[li] > -1e-4, (pair_name, dist[li])
            continue
        mj_dist, mj_n, _ = min(cands, key=lambda x: x[0])
        assert abs(dist[li] - mj_dist) < tol_dist, (pair_name, qpos,
                                                    dist[li], mj_dist)
        ours_n = d.contact.frame[0, li, 0].numpy()
        mj_geom1 = next(
            rd.contact[i].geom1 for i in range(rd.ncon)
            if {rd.contact[i].geom1, rd.contact[i].geom2} == want
            and rd.contact[i].dist == mj_dist)
        if int(mj_geom1) != int(g1[li]):
            mj_n = -mj_n
        assert np.linalg.norm(ours_n - mj_n) < tol_norm, (pair_name, qpos,
                                                          ours_n, mj_n)
        checked += 1
    assert checked >= 2, f"{pair_name}: too few penetrating poses checked"


def test_ellipsoid_box_static_parity():
    poses = [
        [0.05, 0.02, 0.26, 1, 0, 0, 0],
        [0.1, -0.05, 0.24, 1, 0, 0, 0],
        [0.0, 0.0, 0.27, 0.97, 0.17, 0.17, 0.0],
    ]
    _static_contact_parity(ELLBOX_XML, poses, 2e-3, 0.1, "ell-box")


def test_sphere_mesh_static_parity():
    poses = [
        [0.14, 0.12, 0.40, 1, 0, 0, 0],
        [0.10, 0.10, 0.38, 1, 0, 0, 0],
    ]
    _static_contact_parity(TET_MESH_XML, poses, 3e-3, 0.15, "sphere-mesh")


# model -> (xml, seed, qpos offsets putting the free body in contact)
STEP_MODELS = {
    "ellbox": (ELLBOX_XML, 1, {2: -0.235}),
    "tet": (TET_MESH_XML, 1, {2: -0.42}),
}


@pytest.mark.parametrize("name", sorted(STEP_MODELS))
def test_step_matches_reference(name):
    """One f64 env step (kinematics, MPR contacts, Newton, Euler) from
    seeded states in contact against the reference's jit step."""
    xml, seed, shift = STEP_MODELS[name]
    rm, pm = models(xml)
    rd, pd = seeded(rm, pm, seed=seed, qnoise=0.02, vnoise=0.3, b=2,
                    shift=shift)
    step = jax.jit(lambda d: rfwd.step(rm, d))
    want = [step(jax.tree.map(lambda x: x[i], rd)) for i in range(2)]
    got = pfwd.step(pm, pd)
    assert bool((got.contact.dist < 0).any()), name
    for f in ("qpos", "qvel"):
        w = np.stack([np.asarray(getattr(x, f)) for x in want])
        assert err(w, getattr(got, f)) < 1e-8, (name, f)
    # the seeds are tie-free on both sides: a 1e-12 relative nudge of
    # qpos moves neither side's step by TIE
    qpos, = nudge(np.random.default_rng(0), pd.qpos.numpy())
    want_n = [step(jax.tree.map(lambda x: x[i], rd).replace(
        qpos=jnp.asarray(qpos[i]))) for i in range(2)]
    got_n = pfwd.step(pm, pd.replace(qpos=t(qpos)))
    for f in ("qpos", "qvel"):
        w0, w1 = (np.stack([np.asarray(getattr(x, f)) for x in xs])
                  for xs in (want, want_n))
        assert moved(w0, w1) < TIE, (name, f)
        assert moved(getattr(got, f), getattr(got_n, f)) < TIE, (name, f)
