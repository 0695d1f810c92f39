"""The reference's physics on its own: against MuJoCo where MuJoCo is
installed (a witness that neither the reference nor the program wrote),
and nothing in it taken from the program."""

from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import spec
from benchmark.reference import mjcf, physics

MODELS = ["cheetah", "humanoid"]


def random_states(name, n, seed):
    """float64 (qpos, qvel, ctrl) of ``n`` envs, many of them touching the
    floor or past a joint limit."""
    m = physics.Model(mjcf.load(name), "cpu")
    g = torch.Generator().manual_seed(seed)
    u = lambda *s: torch.rand(s, generator=g, dtype=torch.float64)  # noqa
    q = m.qpos0.expand(n, -1).clone()
    if name == "cheetah":
        q[:, 1] = 0.3 * u(n) - 0.35
        q[:, 2:] = u(n, 7) - 0.5
    else:
        q[:, 2] = 0.5 * u(n)
        quat = torch.randn(n, 4, generator=g, dtype=torch.float64)
        q[:, 3:7] = quat / quat.norm(dim=1, keepdim=True)
        q[:, 7:] = u(n, 21) - 0.5
    v = torch.randn(n, m.nv, generator=g, dtype=torch.float64)
    c = 2.4 * u(n, m.nu) - 1.2
    return m, q, v, c


def mujoco_step(mujoco, mm, d, q, v, c, warm):
    mujoco.mj_resetData(mm, d)
    d.qpos[:], d.qvel[:] = q.numpy(), v.numpy()
    d.ctrl[:], d.qacc_warmstart[:] = c.numpy(), warm.numpy()
    mujoco.mj_forward(mm, d)
    full = np.zeros((mm.nv, mm.nv))
    try:
        mujoco.mj_fullM(mm, d, full)
    except TypeError:    # an older MuJoCo takes the packed matrix
        mujoco.mj_fullM(mm, full, d.qM)
    before = full, d.qfrc_bias.copy(), d.ncon
    mujoco.mj_step(mm, d)
    return before


@pytest.mark.parametrize("iterations", [None, 100])
@pytest.mark.parametrize("name", MODELS)
def test_one_step_is_mujocos(name, iterations):
    """The model's own solver (4 Newton iterations from a warmstart), and
    the same solved to convergence, against MuJoCo's."""
    mujoco = pytest.importorskip("mujoco")
    m, q, v, c = random_states(name, 16, 1)
    mm = mujoco.MjModel.from_xml_path(str(Path(mjcf.ASSETS)
                                          / f"{name}.xml"))
    if iterations:
        m.iterations = mm.opt.iterations = iterations
    assert mm.opt.iterations == m.iterations and mm.opt.tolerance == 0.0
    d = mujoco.MjData(mm)
    # a warmstart near the solution, as the step before leaves it
    g = torch.Generator().manual_seed(5)
    iterations, m.iterations = m.iterations, 100
    _, _, warm = physics.step(m, q, v, c, torch.zeros_like(v))
    m.iterations = iterations
    warm = warm * (1.0 + 0.1 * torch.randn(warm.shape, generator=g,
                                           dtype=torch.float64))
    q2, v2, acc = physics.step(m, q, v, c, warm)
    kin = physics.kinematics(m, q)
    M = physics.mass_matrix(m, kin)
    bias = physics.bias_force(m, kin, v)
    contacts = 0
    for i in range(q.shape[0]):
        full, qfrc_bias, ncon = mujoco_step(mujoco, mm, d, q[i], v[i], c[i],
                                            warm[i])
        np.testing.assert_allclose(M[i].numpy(), full, atol=1e-10)
        np.testing.assert_allclose(bias[i].numpy(), qfrc_bias, atol=1e-9)
        contacts += ncon
        np.testing.assert_allclose(v2[i].numpy(), d.qvel, atol=1e-7)
        np.testing.assert_allclose(q2[i].numpy(), d.qpos, atol=1e-9)
        np.testing.assert_allclose(acc[i].numpy(), d.qacc_warmstart,
                                   atol=1e-5)
    assert contacts >= q.shape[0]


def test_the_reference_shares_no_code_with_the_port():
    port = spec.ROOT / "oxide_control_torch"
    theirs = {p.read_bytes() for p in port.rglob("*.py")}
    mine = list((spec.HERE / "reference").rglob("*.py"))
    assert mine
    for path in mine:
        if path.name != "__init__.py":
            assert path.read_bytes() not in theirs, path


@pytest.mark.parametrize("name", MODELS)
def test_the_port_runs_the_asset_the_reference_reads(name):
    port = spec.ROOT / "oxide_control_torch" / "suite" / "assets"
    mine = Path(mjcf.ASSETS) / f"{name}.xml"
    assert (port / f"{name}.xml").read_bytes() == mine.read_bytes()
