"""PyTorch port: elliptic cones and condim 4/6 (ROADMAP Queue A item 10.4).

Cheetah run with elliptic cones (impratio 1, as the bench row, and 1.5),
the reference tests' condim 4/6 pyramids and elliptic cones at condim 4
and 6 (tests/test_scalar_graph.py:786-812 and :1043-1074) are stepped once
in f64 by the port's torch backend and the reference ``build_step``, with
their contacts active, and must agree within 1e-8 on q, v and the
warmstart; these seeds meet no line-search tie (ROADMAP Queue C).
Elliptic cheetah's seed 5 once parted from the reference by 6e-7 in qvel:
the cone Hessian's ``mub2 / D0`` rounded twice (torch takes a scalar over
a tensor as reciprocal times scalar), which flipped the sign of a
line-search derivative that lies within an ulp of zero; it now rounds
once, as the reference's division, and agrees within 2e-12.
The cone force, cost and Hessian are held against the reference's within
1e-12 on residuals that reach the bottom, zero and middle zones at condim
3, 4 and 6, and the torch backend's stacked line-search derivative
against the per-row form the emitter writes, bit for bit.
"""

import dataclasses
import inspect
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oxide_control_tpu.mjcf.compile import (
    load_model_from_xml as ref_load_model_from_xml,
)
from oxide_control_tpu.model import ConeType as RefConeType
from oxide_control_tpu.ops import scalar_graph as rsg
from oxide_control_tpu.suite.common import load_asset as ref_load_asset
from test_torch_equality import _stack
from test_torch_tendon import _xml_of
import test_scalar_graph as rtests

import chip_smoke
from oxide_control_torch.mjcf.compile import load_model_from_xml
from oxide_control_torch.model import ConeType
from oxide_control_torch.ops import scalar_graph as sg
from oxide_control_torch.suite.common import load_asset

B = 8
# seeds whose step meets no line-search tie; cheetah_1_seed5 is ROADMAP
# Queue C's repaired case
SEEDS = {"cheetah_1": 0, "cheetah_1.5": 3, "cheetah_1_seed5": 5}


def _models(name):
    if name.startswith("cheetah"):
        impratio = float(name.split("_")[1])
        m, mr = load_asset("cheetah"), ref_load_asset("cheetah")
        return (m.replace(opt=dataclasses.replace(
                    m.opt, cone=ConeType.ELLIPTIC, impratio=impratio)),
                mr.replace(opt=dataclasses.replace(
                    mr.opt, cone=RefConeType.ELLIPTIC, impratio=impratio)))
    xml = dict(condim46=chip_smoke.CONDIM46_XML,
               elliptic4=chip_smoke.ELLIPTIC4_XML,
               elliptic6=chip_smoke.ELLIPTIC6_XML)[name]
    return load_model_from_xml(xml), ref_load_model_from_xml(xml)


@pytest.mark.parametrize("name", ["cheetah_1", "cheetah_1.5", "condim46",
                                  "elliptic4", "elliptic6",
                                  "cheetah_1_seed5"])
def test_step_matches_reference(name, monkeypatch):
    m, mr = _models(name)
    assert sg.unsupported_reason(m) is None and rsg.supports(mr)
    rng = np.random.default_rng(SEEDS.get(name, 2))
    qpos = np.tile(np.asarray(m.qpos0), (B, 1)) + rng.uniform(
        -0.1, 0.1, (B, m.nq))
    if name.startswith("cheetah"):
        qpos[:, 1] -= 0.3  # the feet into contact
    qvel = rng.uniform(-1, 1, (B, m.nv))
    ctrl = rng.uniform(-1, 1, (B, m.nu))
    ws = np.zeros((B, m.nv))
    seen = []
    assemble = sg._assemble_rows
    monkeypatch.setattr(sg, "_assemble_rows", lambda *a, **k: seen.append(
        assemble(*a, **k)) or seen[-1])
    cols = lambda a, f: [f(a[:, i]) for i in range(a.shape[1])]
    q, v, w, c = (cols(x, torch.tensor) for x in (qpos, qvel, ws, ctrl))
    qr, vr, wr, cr = (cols(x, jnp.asarray) for x in (qpos, qvel, ws, ctrl))
    q, v, _, w = sg.build_step(m, sg.TorchBackend(B, torch.float64, "cpu"))(
        q, v, [], w, c)
    qr, vr, _, wr = rsg.build_step(mr)(qr, vr, [], wr, cr)[:4]
    for got, want in ((q, qr), (v, vr), (w, wr)):
        np.testing.assert_allclose(_stack(got), _stack(want), rtol=0,
                                   atol=1e-8)
    rows, cones = seen[0]
    if name == "condim46":
        assert not cones and any(bool(r["exists"].any()) for r in rows)
        return
    assert sum(int(cn["exists"].sum()) for cn in cones) >= B  # in contact
    assert {len(cn["J"]) for cn in cones} == {
        dict(elliptic4=4, elliptic6=6).get(name, 3)}
    # the contacts push: some normal force is positive
    assert any(bool((cn["force"][0] > 0).any()) for cn in cones)


def _cone(rng, dim, n):
    """A cone group of ``dim`` rows over ``n`` envs and its residuals,
    one third each in the bottom, zero and middle zones."""
    mu = tuple(float(x) for x in rng.uniform(0.05, 1.2, dim - 1))
    c = dict(J=[{}] * dim, mu=mu, mu0=mu[0],
             impratio=float(rng.uniform(1.0, 2.0)),
             D=[rng.uniform(0.5, 50.0, n) for _ in range(dim)],
             exists=rng.uniform(size=n) < 0.8)
    jar = rng.normal(size=(dim, n)) * 0.1
    k = n // 3
    jar[0, :k] = -rng.uniform(5.0, 10.0, k)            # bottom: g0 >> gT
    jar[0, k:2 * k] = rng.uniform(5.0, 10.0, k)        # zero: t <= 0
    jar[0, 2 * k:] = -rng.uniform(0.0, 0.02, n - 2 * k)  # middle
    return c, jar


def _zones(c, jar):
    g = -np.asarray(c["D"]) * jar
    gt = np.sqrt(sum((g[i + 1] / mu) ** 2 for i, mu in enumerate(c["mu"])))
    mub2 = c["mu0"] ** 2 / c["impratio"]
    t = (g[0] + mub2 * gt) / (1 + mub2)
    bottom = g[0] >= gt
    zero = ~bottom & (t <= 0)
    return bottom, zero, ~bottom & ~zero


@pytest.mark.parametrize("dim", [3, 4, 6])
def test_cone_functions_match_reference(dim):
    n = 30
    rng = np.random.default_rng(dim)
    c, jar = _cone(rng, dim, n)
    assert all(z.sum() >= 5 for z in _zones(c, jar))
    bk = sg.TorchBackend(n, torch.float64, "cpu")
    ct = dict(c, D=[torch.tensor(d) for d in c["D"]],
              exists=torch.tensor(c["exists"]))
    cr = dict(c, D=[jnp.asarray(d) for d in c["D"]],
              exists=jnp.asarray(c["exists"]))
    jt = [torch.tensor(x) for x in jar]
    jr = [jnp.asarray(x) for x in jar]
    close = lambda a, b: np.testing.assert_allclose(
        np.asarray(a), np.asarray(b), rtol=0, atol=1e-12)
    f, g = sg._cone_force_sg(bk, ct, jt)
    fr, gr = rsg._cone_force_sg(cr, jr)
    for x, y in zip(f + g, fr + gr):
        close(x, y)
    close(sg._cone_cost_sg(bk, ct, jt), rsg._cone_cost_sg(cr, jr))
    h, hr = sg._cone_hess_sg(bk, ct, jt), rsg._cone_hess_sg(cr, jr)
    for i in range(dim):
        for j in range(dim):
            close(bk.full(h[i][j]), jnp.broadcast_to(hr[i][j], (n,)))
    assert float(np.abs(np.asarray(f[1])).max()) > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_stacked_dphi_with_cones_is_bit_identical(dtype):
    """Rows, then cone groups of condim 3 (two sharing their mu) and 6,
    through the stacked form and the per-row form the emitter writes."""
    rng = np.random.default_rng(11)
    bk = sg.TorchBackend(B, dtype, "cpu")
    T = lambda *shape: torch.tensor(rng.normal(size=shape), dtype=dtype)
    rows = [dict(D=T(B).abs(), exists=T(B) > 0) for _ in range(3)]
    rows.append(dict(D=0.5, exists=True, kind="fri", floss=0.2))
    cones = []
    for dim, mu in ((3, (0.9, 0.9)), (6, (1.0, 0.8, 0.02, 0.005, 0.004)),
                    (3, (0.9, 0.9))):
        cones.append(dict(J=[{}] * dim, mu=mu, mu0=mu[0], impratio=1.3,
                          D=[T(B).abs() + 0.1 for _ in range(dim)],
                          exists=T(B) > -0.5))
    jar = [T(B) for _ in rows]
    jp = [T(B) for _ in rows]
    cjar = [[T(B) for _ in cn["J"]] for cn in cones]
    cjp = [[T(B) for _ in cn["J"]] for cn in cones]
    d0, slope = T(B), T(B)
    for rs in (rows, []):
        stacked = sg._dphi_stacked(bk, rs, jar[:len(rs)], jp[:len(rs)], d0,
                                   slope, cones, cjar, cjp)
        for alpha in (T(B), bk.full(0.0), bk.full(4.0 ** 12)):
            want = d0 + alpha * slope
            for r, jr, jpr in zip(rs, jar, jp):
                f_a, _ = sg._row_force_act(bk, r, jr + alpha * jpr)
                want = want - f_a * jpr
            for cn, j3, p3 in zip(cones, cjar, cjp):
                f_a, _ = sg._cone_force_sg(
                    bk, cn, [a + alpha * b for a, b in zip(j3, p3)])
                for fi, pi in zip(f_a, p3):
                    want = want - fi * pi
            assert torch.equal(stacked(alpha), want)


def test_parity_models_copy_the_reference_tests():
    """chip_smoke.py's condim 4/6 and elliptic models are the reference
    tests' own."""
    assert chip_smoke.CONDIM46_XML == _xml_of(
        rtests.test_condim46_scalar_graph)
    src = inspect.getsource(rtests.test_elliptic_condim46_scalar_graph)
    assert chip_smoke.ELLIPTIC_XML == re.search(
        r'xml = f"""(.*?)"""', src, re.S).group(1)
    assert '(4, "1 0.01 0.0001"), (6, "1 0.008 0.002")' in src
    assert chip_smoke.ELLIPTIC4_XML == chip_smoke.ELLIPTIC_XML.format(
        condim=4, fric="1 0.01 0.0001")
