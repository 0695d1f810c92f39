"""PyTorch port: the C the emitter writes for the CUDA rollout kernel.

The emitted model header -- the same source the card compiles -- is built
here by g++ in double and held against the torch backend (the plain
version); its float form is checked for stray double literals and for the
Newton/line-search loops that keep it small.
"""

import ctypes
import re
import subprocess
import time

import numpy as np
import pytest
import torch

from test_megakernel import _XML as HOPPER_XML

from oxide_control_torch.mjcf.compile import load_model_from_xml
from oxide_control_torch.ops import megakernel as mk
from oxide_control_torch.ops import scalar_graph as sg
from oxide_control_torch.ops.emit import Emitter
from oxide_control_torch.suite.common import load_asset

B = 8


def _model(name):
    if name == "hopper":
        return load_model_from_xml(HOPPER_XML)
    return load_asset(name)


def _inputs(m, seed):
    rng = np.random.default_rng(seed)
    qpos = np.tile(np.asarray(m.qpos0), (B, 1)) + rng.uniform(
        -0.1, 0.1, (B, m.nq))
    # bring feet (cheetah: rootz) / the ball (hopper: z) into contact range
    qpos[:, 1 if m.nq == 9 else 0] -= 0.3
    qvel = rng.uniform(-1, 1, (B, m.nv))
    ctrl = rng.uniform(-1, 1, (B, m.nu))
    ws = np.zeros((B, m.nv))
    return qpos, qvel, ws, ctrl


def _cols(a):
    return [torch.tensor(a[:, i]) for i in range(a.shape[1])]


def _stack(xs):
    return np.stack([np.asarray(x) for x in xs], axis=1)


def _hooks(m):
    return mk.EnvHooks(
        reward=lambda bk, q, v, c: bk.clip(v[0] * 0.1, 0.0, 1.0),
        time_limit=10.0,
        observe=lambda bk, q, v: list(q) + list(v),
        n_obs=m.nq + m.nv,
    )


def _gxx_step(m, tmp_path):
    """The emitted model header in double, wrapped in a host loop over
    envs and built by g++ into a ctypes library."""
    src = mk.kernel_source(m, _hooks(m), "double").text + r"""
extern "C" void step_batch(const double* q, const double* v, const double* w,
                           const double* c, double* qo, double* vo,
                           double* wo, int n) {
  for (int b = 0; b < n; ++b)
    oxc_step(q + b * OXC_NQ, v + b * OXC_NV, w + b * OXC_NV, c + b * OXC_NU,
             qo + b * OXC_NQ, vo + b * OXC_NV, wo + b * OXC_NV);
}
"""
    cpp = tmp_path / "body.cpp"
    so = tmp_path / "body.so"
    cpp.write_text(src)
    t0 = time.perf_counter()
    subprocess.run(["g++", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
                    "-w", "-o", str(so), str(cpp)], check=True,
                   capture_output=True, timeout=120)
    return ctypes.CDLL(str(so)), time.perf_counter() - t0


@pytest.mark.parametrize("name,nsteps", [("hopper", 10), ("cheetah", 5)])
def test_emitted_body_matches_torch_backend(name, nsteps, tmp_path):
    """g++ -O1 builds the cheetah body in about 4 s on this class of CPU,
    so both models run through it."""
    m = _model(name)
    lib, _ = _gxx_step(m, tmp_path)
    qpos, qvel, ws, ctrl = _inputs(m, seed=1)
    step = sg.build_step(m, sg.TorchBackend(B, torch.float64, "cpu"))
    q, v, w, c = _cols(qpos), _cols(qvel), _cols(ws), _cols(ctrl)
    cq, cv, cw, cc = (np.ascontiguousarray(a) for a in (qpos, qvel, ws, ctrl))
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    for _ in range(nsteps):
        q, v, _, w = step(q, v, [], w, c)
        qo, vo, wo = np.zeros_like(cq), np.zeros_like(cv), np.zeros_like(cw)
        lib.step_batch(ptr(cq), ptr(cv), ptr(cw), ptr(cc), ptr(qo), ptr(vo),
                       ptr(wo), ctypes.c_int(B))
        cq, cv, cw = qo, vo, wo
        np.testing.assert_allclose(cq, _stack(q), rtol=0, atol=1e-9)
        np.testing.assert_allclose(cv, _stack(v), rtol=0, atol=1e-9)
        np.testing.assert_allclose(cw, _stack(w), rtol=0, atol=1e-9)


def test_float_source_has_no_double_literal():
    """In the kernel's float source every floating literal carries the f
    suffix, so no expression is promoted to double."""
    m = load_asset("cheetah", np.float32)
    text = mk.kernel_source(m, _hooks(m), "float").text
    body = text[text.index("OXC_HD void oxc_step"):]
    lits = re.findall(r"(?<![\w.])(\d+\.\d*(?:e[+-]?\d+)?f?)", body)
    assert lits and all(x.endswith("f") for x in lits), \
        [x for x in lits if not x.endswith("f")][:5]


def test_newton_and_linesearch_are_loops():
    """The 4 Newton iterations and the 12 + 26 line-search steps are C
    loops; the emitter counts the unrolled work."""
    m = load_asset("cheetah", np.float32)
    em = Emitter("float")
    step = sg.build_step(m, em)
    step(em.load("q", m.nq), em.load("v", m.nv), [], em.load("w", m.nv),
         em.load("c", m.nu))
    src = "\n".join(em._lines)
    assert re.search(r"< 4; \+\+i", src)
    assert re.search(r"< 12; \+\+i", src) and re.search(r"< 26; \+\+i", src)
    n_stmt = src.count("const ")
    assert em.ops > 5 * n_stmt  # loops: far more work than source


@pytest.mark.parametrize("lit,want", [
    (1.25, "1.25e+00f"), (-2.0, "(-2.e+00f)"), (0.1, "1.e-01f"),
    (1e10, "1.e+10f"),
])
def test_emitter_literals(lit, want):
    assert Emitter("float").lit(lit) == want
