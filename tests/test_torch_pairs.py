"""PyTorch port: the narrowphase pairs of the scalar graph (sphere- and
capsule-capsule, plane-box/ellipsoid/cylinder, sphere-box, capsule-box,
box-box SAT) and ``bk.sign``.

The reference tests' models (bench.py's arms, tests/test_scalar_graph.py's
box pairs and plane shapes) are stepped twice in f64 against the reference
``build_step`` within 1e-8, from states in contact (these seeds meet no
line-search tie: a 1e-14 nudge of qpos moves the port by ~1e-12).  Each
narrowphase function is held against the reference's lane for lane within
1e-12 on random poses: spheres inside boxes (the inside branch), capsules
across box edges (the mid lane), face-face and tilted box pairs.
"""

import ctypes
import inspect
import re
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_scalar_graph as rtests
from oxide_control_tpu.ops import scalar_graph as rsg
from test_torch_equality import step_parity

from oxide_control_torch import bench_configs
from oxide_control_torch.mjcf.compile import load_model_from_xml
from oxide_control_torch.model import GeomType as GT
from oxide_control_torch.ops import scalar_graph as sg
from oxide_control_torch.ops.emit import PRELUDE, Emitter

B = 16


def _xml_of(test_fn):
    return re.search(r'xml = """(.*?)"""', inspect.getsource(test_fn),
                     re.S).group(1)


XMLS = {
    "arms": bench_configs.ARMS_XML,
    "box_pairs": _xml_of(rtests.test_box_pairs_scalar_graph),
    "plane_shapes": _xml_of(
        rtests.test_plane_box_cylinder_ellipsoid_scalar_graph),
    "box_stack": _xml_of(rtests.test_box_box_scalar_graph),
}


@pytest.mark.parametrize("name,pairs", [
    ("arms", {(GT.CAPSULE, GT.CAPSULE), (GT.SPHERE, GT.CAPSULE)}),
    ("box_pairs", {(GT.SPHERE, GT.BOX), (GT.CAPSULE, GT.BOX)}),
    ("plane_shapes", {(GT.PLANE, GT.BOX), (GT.PLANE, GT.CYLINDER),
                      (GT.PLANE, GT.ELLIPSOID)}),
])
def test_torch_backend_matches_reference_step(name, pairs):
    m = load_model_from_xml(XMLS[name])
    assert pairs <= {(GT(a), GT(b)) for (a, b, _) in m.pair_groups}
    step_parity(XMLS[name], None)


def test_box_stack_is_supported():
    m = load_model_from_xml(XMLS["box_stack"])
    assert sg.unsupported_reason(m) is None
    assert (GT.BOX, GT.BOX) in {(GT(a), GT(b)) for (a, b, _) in
                                m.pair_groups}


def _rot(rng, tilt):
    q = np.array([1.0, 0, 0, 0]) + tilt * rng.normal(size=4)
    return tuple(float(x) for x in sg.quat_to_mat(tuple(q / np.linalg.norm(
        q))))


def _lanes(fn_port, fn_ref, args_port, args_ref):
    flat = lambda L: np.stack([np.broadcast_to(np.asarray(x, float), (B,))
                               for x in L])
    return flat(fn_port(*args_port)), flat(fn_ref(*args_ref))


def _T(a):
    return tuple(torch.tensor(x) for x in a)


def _J(a):
    return tuple(jnp.asarray(x) for x in a)


@pytest.mark.parametrize("tilt", [0.0, 0.3])
def test_box_box_matches_reference(tilt):
    """Face-face (tilt 0) and tilted boxes overlapping by up to a few cm."""
    rng = np.random.default_rng(int(tilt * 10) + 21)
    s1, s2 = [0.1, 0.12, 0.1], [0.08, 0.07, 0.1]
    p1 = rng.uniform(-0.02, 0.02, (3, B))
    p2 = p1 + np.array([0.03, 0.02, 0.19])[:, None] + rng.uniform(
        -0.02, 0.02, (3, B))
    m1, m2 = _rot(rng, tilt), _rot(rng, tilt)
    bk = sg.TorchBackend(B, torch.float64, "cpu")
    flat = lambda r: [x for (d, p, n, _) in r for x in (d, *p, *n)]
    got, want = _lanes(
        lambda *a: flat(sg._np_box_box_sg(bk, *a)),
        lambda *a: flat(rsg._np_box_box_sg(*a)),
        (_T(p1), m1, s1, _T(p2), m2, s2), (_J(p1), m1, s1, _J(p2), m2, s2))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert (got[0::7] < 0).any()  # some lane is a contact


@pytest.mark.parametrize("inside", [True, False])
def test_sphere_box_matches_reference(inside):
    rng = np.random.default_rng(31 + inside)
    bsize, bmat = [0.12, 0.2, 0.12], _rot(rng, 0.4)
    bpos = (0.1, 0.0, 0.2)
    scale = 0.1 if inside else 0.3
    spos = np.asarray(bpos)[:, None] + rng.uniform(-scale, scale, (3, B))
    bk = sg.TorchBackend(B, torch.float64, "cpu")
    got, want = _lanes(
        lambda *a: [x for r in sg._np_sphere_box_sg(bk, *a)
                    for x in (r if isinstance(r, tuple) else (r,))],
        lambda *a: [x for r in rsg._np_sphere_box_sg(*a)
                    for x in (r if isinstance(r, tuple) else (r,))],
        (_T(spos), 0.06, bpos, bmat, bsize),
        (_J(spos), 0.06, bpos, bmat, bsize))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_segment_pairs_match_reference():
    """_np_seg_seg_sg (clamping order, parallel segments included) and
    _np_seg_closest_sg."""
    rng = np.random.default_rng(41)
    a1, b1, a2, b2, p = (rng.uniform(-0.3, 0.3, (3, B)) for _ in range(5))
    b2[:, :3] = a2[:, :3] + (b1[:, :3] - a1[:, :3])  # parallel
    bk = sg.TorchBackend(B, torch.float64, "cpu")
    got, want = _lanes(
        lambda *a: [x for r in sg._np_seg_seg_sg(bk, *a) for x in r],
        lambda *a: [x for r in rsg._np_seg_seg_sg(*a) for x in r],
        tuple(_T(x) for x in (a1, b1, a2, b2)),
        tuple(_J(x) for x in (a1, b1, a2, b2)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    got, want = _lanes(
        lambda *a: list(sg._np_seg_closest_sg(bk, *a)),
        lambda *a: list(rsg._np_seg_closest_sg(*a)),
        tuple(_T(x) for x in (a1, b1, p)), tuple(_J(x) for x in (a1, b1, p)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


SIGN_IN = np.array([0.0, -0.0, 1.0, -1.0, 1e-300, -1e-300, np.inf, -np.inf,
                    np.nan])


def test_sign_torch_backend_and_emitted_c(tmp_path):
    """bk.sign is torch.sign: sign(+-0) = +0, and a NaN gives 0 (torch's
    (0 < x) - (x < 0); jnp.sign keeps the NaN); the emitted C agrees bit
    for bit, through g++ in double."""
    bk = sg.TorchBackend(len(SIGN_IN), torch.float64, "cpu")
    want = bk.sign(torch.tensor(SIGN_IN)).numpy()
    np.testing.assert_array_equal(
        want, [0, 0, 1, -1, 1, -1, 1, -1, 0])
    assert not np.signbit(want).any() or np.signbit(want).tolist() == [
        False, False, False, True, False, True, False, True, False]
    em = Emitter("double")
    em.ret(em.sign(em.load("x", 1)[0]))
    src = PRELUDE + em.function("double sgn(const double* x)") + r"""
extern "C" void sgn_batch(const double* x, double* y, int n) {
  for (int i = 0; i < n; ++i) y[i] = sgn(x + i);
}
"""
    cpp, so = tmp_path / "s.cpp", tmp_path / "s.so"
    cpp.write_text(src)
    subprocess.run(["g++", "-O1", "-shared", "-fPIC", "-w", "-o", str(so),
                    str(cpp)], check=True, capture_output=True, timeout=60)
    got = np.zeros(len(SIGN_IN))
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    ctypes.CDLL(str(so)).sgn_batch(ptr(np.ascontiguousarray(SIGN_IN)),
                                   ptr(got), ctypes.c_int(len(SIGN_IN)))
    assert got.tobytes() == want.tobytes()
    assert [sg.TorchBackend(1, torch.float64, "cpu").sign(x)
            for x in (0.0, -0.0, 2.0, -2.0)] == [0.0, 0.0, 1.0, -1.0]
