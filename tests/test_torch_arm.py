"""PyTorch port: arm-muscle-wrap's rollout against the reference kernel.

The plain version of the port's rollout function on bench.py's arm (a
muscle on a spatial tendon that wraps a sphere with a sidesite; the
muscle's activation carried through the steps and zeroed on reset) against
the reference Pallas kernel in interpret mode, at B = 8, K = 24, with start
times that cross the time limit inside the window, at the reference's bars
(tests/test_megakernel.py:109-115) and act 1e-4.  Reset noise is 0 on both
sides: the reference's interpret mode draws threefry where the port draws
Philox; the noise path is held on the card against the plain version.

The reference program takes about 8 s to trace and 30 s to compile on
this class of CPU whatever K is (its wrap search and Newton line search are
unrolled), so it is built once, with XLA's backend optimizations off: it
runs once, and its build is nearly all of this file's time.  Its compile
goes through JAX's persistent compilation cache in the checkout's
``.jax_cache`` (ignored by git), set for this build alone: a later run in
the same checkout loads the program in about 6 s instead of compiling it.
"""

import contextlib
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from oxide_control_tpu.mjcf.compile import (
    load_model_from_xml as ref_load_model_from_xml,
)
from oxide_control_tpu.ops import megakernel as rmk

from oxide_control_torch import bench_configs, convert
from oxide_control_torch.mjcf.compile import load_model_from_xml
from oxide_control_torch.ops import megakernel as mk

B, K = 8, 24
CACHE = Path(__file__).resolve().parents[1] / ".jax_cache"


@contextlib.contextmanager
def _persistent_cache():
    """JAX's persistent compilation cache in ``CACHE`` for the compiles
    inside the block, and as it was after it."""
    from jax.experimental.compilation_cache import compilation_cache as cc

    old = jax.config.jax_compilation_cache_dir
    jax.config.update("jax_compilation_cache_dir", str(CACHE))
    cc.reset_cache()
    try:
        yield
    finally:
        jax.config.update("jax_compilation_cache_dir", old)
        cc.reset_cache()


@pytest.fixture(scope="module")
def arm_run():
    xml = bench_configs.MUSCLE_WRAP_XML
    m = load_model_from_xml(xml, dtype=np.float32)
    mr = ref_load_model_from_xml(xml, dtype=np.float32)
    fn = mk.build_rollout(m, B, K, dataclasses.replace(
        bench_configs.BenchTask().kernel_hooks(m), reset_noise=0.0),
        emit_obs=True)
    rng = np.random.default_rng(1)
    limit_n = fn.spec.limit_n
    n0 = np.array([0, 10, limit_n - 3, limit_n - 12, 100, limit_n - 1,
                   2000, limit_n - 20])
    state = (
        (np.asarray(m.qpos0)[:, None]
         + rng.uniform(-0.05, 0.05, (m.nq, B))).astype(np.float32),
        rng.uniform(-0.5, 0.5, (m.nv, B)).astype(np.float32),
        rng.uniform(0.0, 0.5, (m.na, B)).astype(np.float32),
        np.zeros((m.nv, B), np.float32),
        (n0 * np.float32(fn.spec.h)).astype(np.float32)[None],
    )
    ctrl = rng.uniform(-1.0, 1.0, (K, m.nu, B)).astype(np.float32)
    kern = rmk.build_rollout(mr, B, K, tile=B, hooks=dataclasses.replace(
        bench._BenchTask().kernel_hooks(mr), reset_noise=0.0),
        interpret=True, emit_obs=True)
    args = [jnp.asarray(a) for a in state] + [
        jnp.asarray(ctrl), jnp.zeros((1,), jnp.int32)]
    with _persistent_cache():
        compiled = kern.lower(*args).compile(
            compiler_options={"xla_backend_optimization_level": 0})
    ref = [np.asarray(x) for x in compiled(*args)]
    out = fn(*convert.state_from_numpy(state, "cpu"), torch.as_tensor(ctrl),
             torch.zeros(1, dtype=torch.int32))
    return ref, [x.numpy() for x in out]


def test_arm_rollout_matches_reference(arm_run):
    ref, out = arm_run
    assert ref[9].sum() >= 4, "the time limit resets envs inside the window"
    np.testing.assert_allclose(out[0], ref[0], rtol=0, atol=1e-4)  # qpos
    np.testing.assert_allclose(out[1], ref[1], rtol=0, atol=1e-3)  # qvel
    np.testing.assert_allclose(out[2], ref[2], rtol=0, atol=1e-4)  # act
    np.testing.assert_allclose(out[4], ref[4], rtol=0, atol=1e-5)  # time
    np.testing.assert_allclose(out[5], ref[5], rtol=0, atol=1e-4)  # reward
    np.testing.assert_array_equal(out[6], ref[6])                  # diverged


def test_arm_rollout_obs_trajectory_matches_reference(arm_run):
    ref, out = arm_run
    np.testing.assert_allclose(out[7], ref[7], rtol=0, atol=1e-4)  # obs
    np.testing.assert_allclose(out[8], ref[8], rtol=0, atol=1e-4)  # rewards
    np.testing.assert_array_equal(out[9], ref[9])                  # dones
