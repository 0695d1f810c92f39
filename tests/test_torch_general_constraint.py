"""PyTorch port, general path: constraint rows and the three solvers.

From numpy-seeded states (f64, B = 4), the port's ``make_efc`` rows (J,
pos, aref, D, the exists mask) and the solved qacc, constraint force and
solver cost of ``forward`` are held against the reference's (one
``jit(vmap)`` per model) within 1e-10: joint and tendon limits, dof and
tendon friction loss, joint/tendon/connect/weld equality (the connect and
weld rows' Jdot qvel from the forward-mode tangent), pyramidal contacts at
condim 3/4/6 and elliptic cones; Newton, CG and PGS.
"""

import jax
import numpy as np
import pytest
from test_golden import _ELLIPTIC_SPHERE
from test_torch_general_smooth import err, models, seeded, suite_xml

import chip_smoke
import fixtures
from oxide_control_tpu.physics import constraint as rcon
from oxide_control_tpu.physics import forward as rfwd
from oxide_control_torch import bench_configs
from oxide_control_torch.physics import constraint as pcon
from oxide_control_torch.physics import forward as pfwd

BAR = 1e-10

# name -> (xml, seeded qpos noise, seeded qvel noise[, qpos offsets])
MODELS = {
    # Newton, pyramidal condim 3, joint limits; the torso lowered so the
    # feet touch the floor
    "cheetah": (lambda: suite_xml("cheetah"), 0.1, 0.5, {1: -0.05}),
    # Newton, tendon friction loss, limits
    "walker_ts": (lambda: suite_xml("walker",
                                    bench_configs.WALKER_TENDON_SENSORS),
                  0.05, 0.5),
    # connect + joint equality
    "fourbar": (lambda: bench_configs.FOURBAR_XML, 0.05, 0.5),
    # weld
    "weld": (lambda: chip_smoke.WELD_XML, 0.05, 0.5),
    # tendon equality
    "tendon_eq": (lambda: chip_smoke.TENDON_EQ_XML, 0.05, 0.5),
    # pyramidal condim 4 and 6
    "condim46": (lambda: chip_smoke.CONDIM46_XML, 0.02, 0.5),
    # CG, planar walker on the floor
    "walker_cg": (lambda: fixtures.PLANAR_WALKER, 0.05, 0.5),
    # PGS, a free body
    "free_pgs": (lambda: fixtures.FREE_BODY.replace(
        'solver="CG" iterations="30"', 'solver="PGS" iterations="30"'),
        0.05, 0.5, {2: -0.39}),
    # elliptic cones, condim 6, Newton and condim 3, CG
    "elliptic_newton": (lambda: _ELLIPTIC_SPHERE.format(
        ir=2.0, solver="Newton", condim=6), 0.01, 0.5),
    "elliptic_cg": (lambda: _ELLIPTIC_SPHERE.format(
        ir=1.0, solver="CG", condim=3), 0.01, 0.5),
    # a limited ball joint
    "ball_limit": (lambda: fixtures.BALL_LIMIT, 0.3, 0.5),
}

EFC = ("J", "pos", "aref", "D", "exists")
SOLVED = ("qacc", "qfrc_constraint", "solver_cost", "nefc_active")


def _ref_fn(rm):
    def fn(d):
        dp = rfwd.fwd_position(rm, d)
        efc = rcon.make_efc(rm, dp)
        return {k: efc[k] for k in EFC}, rfwd.forward(rm, d)

    return jax.jit(jax.vmap(fn))


@pytest.fixture(scope="module", params=sorted(MODELS))
def solved(request):
    xml, qn, vn, *shift = MODELS[request.param]
    rm, pm = models(xml())
    rd, pd = seeded(rm, pm, seed=5, qnoise=qn, vnoise=vn,
                    shift=shift[0] if shift else None)
    refc, rf = _ref_fn(rm)(rd)
    pefc = pcon.make_efc(pm, pfwd.fwd_position(pm, pd))
    return request.param, refc, rf, pefc, pfwd.forward(pm, pd)


@pytest.mark.parametrize("field", EFC)
def test_efc_rows_match_reference(solved, field):
    name, refc, _, pefc, _ = solved
    e = err(refc[field], pefc[field])
    assert e < BAR, (name, field, e)


@pytest.mark.parametrize("field", SOLVED)
def test_solution_matches_reference(solved, field):
    """Within 1e-10; the solver cost (up to ~1e5 here) relative to
    max(1, |cost|)."""
    name, _, rf, _, pf = solved
    want = np.asarray(getattr(rf, field))
    scale = max(1.0, float(np.abs(want).max())) if field == "solver_cost" \
        else 1.0
    e = err(want, getattr(pf, field))
    assert e < BAR * scale, (name, field, e)


def test_constraints_are_active(solved):
    """The seeded states engage constraint rows on every model."""
    name, _, _, pefc, pf = solved
    assert int(pf.nefc_active.sum()) > 0, name


def test_static_row_layout():
    """nefc and the limit rows' map equal the reference's (the
    reference's ``nefc`` has no tendon-equality entry, so the tendon_eq
    model is left out of this count)."""
    for name, (xml, *_) in MODELS.items():
        if name == "tendon_eq":
            continue
        rm, pm = models(xml())
        assert pcon.nefc(pm) == rcon.nefc(rm), name
        assert pcon.limit_row_map(pm) == rcon.limit_row_map(rm), name
