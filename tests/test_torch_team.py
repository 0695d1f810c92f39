"""PyTorch port: the team line search (a team of G lanes runs one env).

The rollout kernel runs each env on a team of G lanes of one warp; the
line search's dphi sums over the constraint rows are split across the
team (``scalar_graph.team_deal``, ``_dphi_team``): each lane sums its
slots in slot order and the team adds the G partials pairwise.  Here, on
the CPU: the deal gives every row and cone group exactly one slot, with
one sequence of slot kinds on every lane; a padding slot contributes
exactly +0.0; the team dphi of the torch backend -- the per-slot form
the emitter writes and the stacked form the plain version runs -- equals
a sum written out by hand (each lane's partial over its rows' per-row
terms, then the pairwise tree), bit for bit, on cheetah (contact rows),
fourbar (``eq`` rows), walker with the knee coupler (``fri`` rows) and
elliptic cheetah (cone groups); the f64 step at each model's chosen G
stays within the reference's 1e-8 on the tie-free seeds of the existing
step tests (ROADMAP Queue C); and the transposed weight layout a team's
MLP reads gives ``mlp_forward``'s outputs bit for bit.
"""

import dataclasses

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

import chip_smoke
from oxide_control_torch import bench_configs
from oxide_control_torch.mjcf.compile import load_model_from_xml
from oxide_control_torch.model import ConeType
from oxide_control_torch.ops import megakernel as mk
from oxide_control_torch.ops import scalar_graph as sg
from oxide_control_torch.suite.common import asset_path, load_asset

B = 8
TEAMS = (2, 4, 8)
MODELS = ("cheetah", "fourbar", "walker_tendon", "cheetah_elliptic")


def _elliptic(m, cone_type):
    return m.replace(opt=dataclasses.replace(m.opt, cone=cone_type,
                                             impratio=1.0))


def _xml(name):
    if name in ("fourbar", "arms"):
        return dict(fourbar=bench_configs.FOURBAR_XML,
                    arms=bench_configs.ARMS_XML)[name]
    with open(asset_path("walker")) as f:
        return f.read().replace("</mujoco>", chip_smoke.WALKER_TENDON)


def _models(name):
    """(port model, reference model) in f64."""
    if name in ("cheetah", "walker"):
        return load_asset(name), ref_load_asset(name)
    if name == "cheetah_elliptic":
        return (_elliptic(load_asset("cheetah"), ConeType.ELLIPTIC),
                _elliptic(ref_load_asset("cheetah"), RefConeType.ELLIPTIC))
    return load_model_from_xml(_xml(name)), ref_load_model_from_xml(
        _xml(name))


def _state(name, m, seed):
    """(qpos, qvel, ctrl), each (B, n): the existing step tests' draws
    (test_torch_scalar_graph, test_torch_equality and test_torch_pairs,
    test_torch_cones), contacts active."""
    rng = np.random.default_rng(seed)
    qpos = np.tile(np.asarray(m.qpos0), (B, 1)) + rng.uniform(
        -0.1, 0.1, (B, m.nq))
    if name.startswith("cheetah"):
        qpos[:, 1] -= 0.3  # the feet into contact
    qvel = rng.uniform(-1, 1, (B, m.nv))
    return qpos, qvel, rng.uniform(-1, 1, (B, m.nu))


def _cols(a, f):
    return [f(a[:, i]) for i in range(a.shape[1])]


def _stack(xs):
    return np.stack([np.broadcast_to(np.asarray(x), (B,)) for x in xs], 1)


def _line_search_args(name, dtype, monkeypatch):
    """The arguments of the first line search of one G = 1 step (Newton
    iteration 1): (rows, jar, jp, d0, sg, cones, cjar, cjp)."""
    m, _ = _models(name)
    qpos, qvel, ctrl = _state(name, m, 0)
    seen = []
    ls = sg._linesearch_scalar
    monkeypatch.setattr(sg, "_linesearch_scalar", lambda bk, *a, **k: (
        seen.append(a[:8]), ls(bk, *a, **k))[1])
    T = lambda a: _cols(a, lambda x: torch.tensor(x, dtype=dtype))
    na = [torch.zeros(B, dtype=dtype) for _ in range(m.na)]
    sg.build_step(m, sg.TorchBackend(B, dtype, "cpu"))(
        T(qpos), T(qvel), na, T(np.zeros((B, m.nv))), T(ctrl))
    return seen[0]


def _kind(r):
    return r.get("kind") if r.get("kind") in ("fri", "eq") else "uni"


def _cone_key(c):
    return (len(c["J"]), c["mu"], c["mu0"], c["impratio"])


@pytest.mark.parametrize("name", MODELS)
def test_deal_gives_each_row_one_slot(name, monkeypatch):
    rows, _, _, _, _, cones, _, _ = _line_search_args(
        name, torch.float64, monkeypatch)
    want_kinds = {"cheetah": {"uni"}, "fourbar": {"uni", "eq"},
                  "walker_tendon": {"uni", "fri"},
                  "cheetah_elliptic": {"uni"}}[name]
    assert {_kind(r) for r in rows} == want_kinds
    assert bool(cones) == (name == "cheetah_elliptic")
    for team in TEAMS:
        deal = sg.team_deal(rows, cones, team)
        seen_rows, seen_cones = [], []
        for kind, members in deal:
            assert len(members) == team
            for i in members:
                if i is None:
                    continue
                if isinstance(kind, tuple):
                    assert _cone_key(cones[i]) == kind
                    seen_cones.append(i)
                else:
                    assert _kind(rows[i]) == kind
                    seen_rows.append(i)
        assert sorted(seen_rows) == list(range(len(rows)))
        assert sorted(seen_cones) == list(range(len(cones)))
        # one kind sequence on every lane: R = ceil(n / G) slots per kind,
        # in blocks, a lane's padding only after its real slots
        kinds = [k for k, _ in deal]
        for k in set(kinds):
            n = sum(1 for r in rows if _kind(r) == k) if isinstance(
                k, str) else sum(1 for c in cones if _cone_key(c) == k)
            first = kinds.index(k)
            assert kinds.count(k) == -(-n // team)
            assert kinds[first:first + kinds.count(k)] == [k] * kinds.count(k)
        for lane in range(team):
            for k in set(kinds):
                col = [m[lane] for kk, m in deal if kk == k]
                real = [i for i in col if i is not None]
                assert col == real + [None] * (len(col) - len(real))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_padding_slot_contributes_plus_zero(dtype):
    """A padding slot (jar 0, jp 0, D 0, exists false) of every kind adds
    exactly +0.0 to its lane's partial at any step: never -0.0 or NaN."""
    bk = sg.TorchBackend(5, dtype, "cpu")
    alphas = [bk.full(0.0), bk.full(1.0), bk.full(-3.5),
              torch.tensor([0.0, 1e30, -1e30, 2.5, -0.0], dtype=dtype)]
    kinds = ["uni", "fri", "eq", (3, (1.0, 1.0), 1.0, 1.0),
             (6, (0.9, 0.9, 0.01, 0.002, 0.002), 0.9, 1.5)]
    for team in TEAMS:
        for kind in kinds:
            fields = sg._team_fields([], [], [], [], [], [], kind,
                                     [None] * team)
            v = dict(zip(fields, bk.team_lanes(list(fields.values()))))
            for alpha in alphas:
                terms = sg._team_terms(bk, kind, v, alpha)
                assert len(terms) == (kind[0] if isinstance(kind, tuple)
                                      else 1)
                for t in terms:
                    assert t.shape == (team, 5)
                    assert torch.equal(t, torch.zeros_like(t))
                    assert not bool(torch.signbit(t).any()), (team, kind)


def _hand_dphi(rows, jar, jp, d0, sgv, cones, cjar, cjp, team, alpha):
    """dphi summed by hand: the per-row terms of the G = 1 graph
    (``_row_force_act``, ``_cone_force_sg``), lane l summing the members
    s * G + l of each kind in order (rows by kind uni, fri, eq; then cone
    groups by key, in order of appearance), padding as +0.0; then the
    pairwise tree over the G partials."""
    bk = sg.TorchBackend(len(d0), d0.dtype, "cpu")

    def row_terms(i):
        f, _ = sg._row_force_act(bk, rows[i], jar[i] + alpha * jp[i])
        return [f * jp[i]]

    def cone_terms(j):
        f, _ = sg._cone_force_sg(bk, cones[j], [
            x + alpha * y for x, y in zip(cjar[j], cjp[j])])
        return [fi * pi for fi, pi in zip(f, cjp[j])]

    blocks = [([i for i, r in enumerate(rows) if _kind(r) == k], row_terms,
               1) for k in ("uni", "fri", "eq")]
    keys = list(dict.fromkeys(_cone_key(c) for c in cones))
    blocks += [([j for j, c in enumerate(cones) if _cone_key(c) == k],
                cone_terms, k[0]) for k in keys]
    zero = torch.zeros_like(d0)
    part = [None] * team
    for idx, terms, width in blocks:
        for s in range(-(-len(idx) // team)):
            for lane in range(team):
                k = s * team + lane
                ts = terms(idx[k]) if k < len(idx) else [zero] * width
                for t in ts:
                    part[lane] = t if part[lane] is None else part[lane] + t
    while len(part) > 1:
        part = [a + b for a, b in zip(part[0::2], part[1::2])]
    return (d0 + alpha * sgv) - part[0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", MODELS)
def test_team_dphi_matches_hand_sum(name, dtype, monkeypatch):
    args = _line_search_args(name, dtype, monkeypatch)
    bk = sg.TorchBackend(B, dtype, "cpu")
    rng = np.random.default_rng(1)
    alphas = [bk.full(0.0), bk.full(1.0), bk.full(0.37), bk.full(4.0 ** 6),
              torch.tensor(rng.uniform(0.0, 2.0, B), dtype=dtype)]
    for team in TEAMS:
        per_slot = sg._dphi_team(bk, *args, team)
        stacked = sg._dphi_team_stacked(bk, *args, team)
        for alpha in alphas:
            want = _hand_dphi(*args, team, alpha)
            assert want.shape == (B,) and want.dtype == dtype
            assert torch.equal(per_slot(alpha), want), (team, alpha)
            assert torch.equal(stacked(alpha), want), (team, alpha)


# model: (seed, steps, its team size): the existing f64 step tests'
# tie-free draws at the team size the rule gives the model
STEP_CASES = {
    "cheetah": (0, 3, 4), "walker": (6, 3, 4), "fourbar": (0, 2, 8),
    "arms": (0, 2, 4), "cheetah_elliptic": (0, 1, 4),
}


def _hooks(m):
    return mk.EnvHooks(reward=lambda bk, q, v, c: v[0], time_limit=10.0,
                       observe=lambda bk, q, v: list(q), n_obs=m.nq)


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_step_at_chosen_team_matches_reference(name):
    m, mr = _models(name)
    seed, nsteps, team = STEP_CASES[name]
    assert mk.default_team(m, _hooks(m)) == team
    qpos, qvel, ctrl = _state(name, m, seed)
    ws = np.zeros((B, m.nv))
    step = sg.build_step(m, sg.TorchBackend(B, torch.float64, "cpu"),
                         team=team)
    step_ref = rsg.build_step(mr)
    q, v, w, c = (_cols(x, torch.tensor) for x in (qpos, qvel, ws, ctrl))
    qr, vr, wr, cr = (_cols(x, jnp.asarray) for x in (qpos, qvel, ws, ctrl))
    a, ar = [], []
    eq = {}
    if m.neq:
        eq = dict(eq_act=[torch.ones(B, dtype=torch.bool)] * m.neq)
    eq_r = {k: [jnp.asarray(x.numpy()) for x in xs] for k, xs in eq.items()}
    for _ in range(nsteps):
        q, v, a, w = step(q, v, a, w, c, **eq)
        qr, vr, ar, wr = step_ref(qr, vr, ar, wr, cr, **eq_r)[:4]
        for got, want in ((q, qr), (v, vr), (w, wr)):
            np.testing.assert_allclose(_stack(got), _stack(want), rtol=0,
                                       atol=1e-8)


def test_team_mlp_layout_matches_plain():
    """The layout a team's MLP reads (``_pack_params(transpose=True)``:
    per layer W^T (in, out), then b) and the kernel's indexing of it --
    output o of a layer accumulates ``p[i * nout + o] * x[i]`` input by
    input, then adds ``p[nin * nout + o]`` -- give ``mlp_forward``'s
    outputs bit for bit."""
    rng = np.random.default_rng(3)
    dims = [17, 64, 64, 6]
    params = []
    for nin, nout in zip(dims, dims[1:]):
        params += [torch.tensor(rng.normal(size=(nout, nin)) * 0.3,
                                dtype=torch.float32),
                   torch.tensor(rng.normal(size=(nout, 1)) * 0.1,
                                dtype=torch.float32)]
    obs = torch.tensor(rng.normal(size=(dims[0], 5)), dtype=torch.float32)
    want = mk.mlp_forward(list(zip(params[0::2], params[1::2])), obs)
    p = mk._pack_params(params, dims, "cpu", torch.float32, transpose=True)
    x, off = obs, 0
    for nin, nout in zip(dims, dims[1:]):
        y = []
        for o in range(nout):
            acc = torch.zeros(obs.shape[1])
            for i in range(nin):
                acc = acc + p[off + i * nout + o] * x[i]
            y.append(torch.tanh(acc + p[off + nin * nout + o]))
        x, off = torch.stack(y), off + nout * nin + nout
    assert off == p.numel()
    assert torch.equal(x, want)


@pytest.mark.parametrize("name,teams", [
    ("cheetah", (4, 4)), ("humanoid", (1, 2)), ("cartpole", (1, 1)),
])
def test_team_rule_with_and_without_policy(name, teams):
    """The rule's team without and with the in-kernel policy: a large
    body keeps one lane unless the team splits the MLP; a model without a
    line search to split keeps one lane either way."""
    m = load_asset(name)
    assert tuple(mk.default_team(m, _hooks(m), policy=p)
                 for p in (False, True)) == teams
