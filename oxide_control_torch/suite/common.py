"""Shared helpers for the control suite tasks."""

from __future__ import annotations

import dataclasses
import functools
import inspect
import os

import numpy as np
import torch

from ..api.errors import UnsupportedFeatureError
from ..mjcf.compile import load_model
from ..model import JointType, Model

ASSET_DIR = os.path.join(os.path.dirname(__file__), "assets")


@functools.lru_cache(maxsize=None)
def _load_cached(name: str, dtype_str: str) -> Model:
    return load_model(asset_path(name), dtype=np.dtype(dtype_str))


def load_asset(name: str, dtype=np.float64) -> Model:
    """Load and compile a suite asset model, cached per (name, dtype)."""
    return _load_cached(name, np.dtype(dtype).name)


def asset_path(name: str) -> str:
    path = os.path.join(ASSET_DIR, f"{name}.xml")
    if not os.path.exists(path):
        have = sorted(f[:-4] for f in os.listdir(ASSET_DIR)
                      if f.endswith(".xml"))
        raise UnsupportedFeatureError(
            f"no suite asset {name!r}; available: {', '.join(have)}")
    return path


def uniform(generator: torch.Generator, lo: float, hi: float, shape,
            dtype: torch.dtype, device) -> torch.Tensor:
    """U(lo, hi) of ``shape`` drawn from ``generator``."""
    u = torch.empty(shape, dtype=dtype, device=device)
    u.uniform_(0.0, 1.0, generator=generator)
    return lo + (hi - lo) * u


def normal(generator: torch.Generator, shape, dtype: torch.dtype,
           device) -> torch.Tensor:
    """Standard normals of ``shape`` drawn from ``generator``."""
    z = torch.empty(shape, dtype=dtype, device=device)
    return z.normal_(generator=generator)


def randomize_limited_joints(model: Model, qpos: torch.Tensor,
                             generator: torch.Generator,
                             fraction: float = 1.0) -> torch.Tensor:
    """Batched ``qpos (B, nq)`` with every limited hinge/slide joint drawn
    uniformly within ``fraction`` of its range around the range's
    midpoint (dm_control's randomize_limited_and_rotational_joints idiom
    for limited scalar joints)."""
    qpos = qpos.clone()
    for j in range(model.njnt):
        if not model.jnt_limited[j] or model.jnt_type[j] not in (
                JointType.HINGE, JointType.SLIDE):
            continue
        adr = model.jnt_qposadr[j]
        lo, hi = (float(x) for x in np.asarray(model.jnt_range)[j])
        half = 0.5 * (hi - lo) * fraction
        qpos[:, adr] = 0.5 * (lo + hi) + uniform(
            generator, -half, half, qpos.shape[:1], qpos.dtype, qpos.device)
    return qpos


def time_limit_done(data, time_limit: float) -> torch.Tensor:
    """(B,) bool: the episode's time limit is reached."""
    return data.time > time_limit - 1e-6


class SensorObsWrapper:
    """Task wrapper that appends the model's sensordata to the
    observation on both paths: ``data.sensordata`` (refreshed after each
    step by the env layer) on the general path, and in the rollout kernel
    the sensor rows computed at the pre-step state
    (``EnvHooks.needs_sensors``).  The port of the reference's
    ``suite/common.py:SensorObsWrapper``.

    The base task must have ``kernel_hooks``; every sensor of the model
    must be in the kernel family (``scalar_graph.sensors_supported``), or
    ``FastRollout`` refuses the task."""

    def __init__(self, base):
        self._base = base

    def __getattr__(self, name):
        return getattr(self._base, name)

    def observe(self, model: Model, data) -> torch.Tensor:
        return torch.cat([self._base.observe(model, data), data.sensordata],
                         -1)

    def kernel_hooks(self, model: Model):
        base = self._base.kernel_hooks(model)
        base_obs = base.observe
        base_params = (set(inspect.signature(base_obs).parameters)
                       if base_obs is not None else set())

        def observe(bk, q, v, sensordata, **kw):
            # pass fk (or any other keyword) on only if the base takes it
            kw = {k: x for k, x in kw.items() if k in base_params}
            rows = base_obs(bk, q, v, **kw) if base_obs is not None else []
            return list(rows) + list(sensordata)

        return dataclasses.replace(
            base, observe=observe, n_obs=base.n_obs + model.nsensordata,
            needs_sensors=True)
